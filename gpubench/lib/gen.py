"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module turns into inputs, from ``--seed``.

Audio is white noise at the mix's ``audio_rms`` (the weights are random, so
no audio means more than another); it is drawn on the card in one call and
kept on the host, where a user's audio would come from.

  * ``batch`` mixes: a pool of ``pool`` batches of ``audios`` 30 s windows,
    each with its rows' prompts (``prompt``: row i takes ``lengths[i %
    len]`` ids drawn uniformly from [low, high)); call i of the window takes
    batch ``i % pool``.
  * ``serve`` mixes: Poisson arrivals at ``rate_per_s`` with clip lengths
    drawn lognormal (``clip_s``: median, sigma, clipped to [min, max]).  The
    gaps and lengths are drawn once from the mix's ``base_seed``, so every
    seed offers the same work in the same time; ``--seed`` orders them and
    draws the audio.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .weights import group_seed

SAMPLE_RATE = 16_000
WINDOW = 30 * SAMPLE_RATE


def _noise(n: int, seed: int, stream: int, rms: float, device) -> torch.Tensor:
    """[n] float32 noise on the host, drawn on ``device`` in one call."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, 10_000 + stream))
    return (torch.randn(n, generator=gen, device=device) * rms).cpu()


@dataclasses.dataclass
class Batch:
    audio: torch.Tensor  # [A, 480000] float32, host
    prompts: List[Optional[List[int]]]  # one a row (None: unprompted)


def batch_pool(traffic: dict, seed: int, device) -> List[Batch]:
    A = traffic["audios"]
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    out = []
    for p in range(traffic["pool"]):
        audio = _noise(A * WINDOW, seed, p, traffic["audio_rms"], device).view(A, WINDOW)
        spec = traffic.get("prompt")
        if spec is None:
            prompts = [None] * A
        else:
            lengths = spec["lengths"]
            prompts = [rng.integers(spec["low"], spec["high"], size=lengths[i % len(lengths)])
                       .tolist() for i in range(A)]
        out.append(Batch(audio, prompts))
    return out


@dataclasses.dataclass
class Requests:
    due_s: np.ndarray  # [n] offsets from the window's start, ascending
    clips: List[torch.Tensor]  # [n] float32 clips, views of one host buffer


def _clip_samples(clip: dict, u: np.ndarray) -> np.ndarray:
    seconds = np.clip(clip["median"] * np.exp(clip["sigma"] * u), clip["min"], clip["max"])
    return (seconds * SAMPLE_RATE).astype(np.int64)


def serve_requests(traffic: dict, seed: int, seconds: float, device) -> Requests:
    """The requests due in a window of ``seconds``."""
    base = np.random.default_rng(traffic["base_seed"])
    rate = traffic["rate_per_s"]
    n_max = int(rate * seconds * 2 + 100)
    gaps = base.exponential(1.0 / rate, size=n_max)
    lengths = _clip_samples(traffic["clip_s"], base.standard_normal(n_max))
    n = int(np.searchsorted(np.cumsum(gaps), seconds))  # arrivals before the window closes
    order = np.random.default_rng([int(seed) % 2**63, 2]).permutation(n)
    due = np.cumsum(gaps[:n][order])
    samples = lengths[:n][np.random.default_rng([int(seed) % 2**63, 3]).permutation(n)]
    audio = _noise(int(samples.sum()), seed, 0, traffic["audio_rms"], device)
    return Requests(due, list(torch.split(audio, samples.tolist())))


def warm_requests(traffic: dict, seed: int, device) -> List[torch.Tensor]:
    """Clips of the mix's lengths for the set-up's warm round (not timed)."""
    n = traffic["warm_requests"]
    rng = np.random.default_rng([int(seed) % 2**63, 4])
    samples = _clip_samples(traffic["clip_s"], rng.standard_normal(n))
    audio = _noise(int(samples.sum()), seed, 1, traffic["audio_rms"], device)
    return list(torch.split(audio, samples.tolist()))
