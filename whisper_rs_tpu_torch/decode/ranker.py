"""Sequence ranking by cumulative logprob with optional length penalty
(counterpart of ``whisper_rs_tpu/decode/ranker.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .loop import BIG_NEG, DecodeResult


def candidate_lengths(candidates: torch.Tensor, sample_begin: int, eot: int) -> torch.Tensor:
    """[n_audio, C] sampled-token count per candidate: first EOT index minus
    sample_begin."""
    n_ctx = candidates.shape[-1]
    idx = torch.arange(n_ctx, device=candidates.device)
    first_eot = torch.where(candidates == eot, idx, n_ctx).amin(dim=-1)
    return first_eot - sample_begin


def rank_max_likelihood(
    result: DecodeResult, sample_begin: int, eot: int, length_penalty: Optional[float]
):
    """Returns (selected [n_audio], avg_logprob [n_audio] f32,
    lengths [n_audio, C])."""
    lengths = candidate_lengths(result.candidates, sample_begin, eot)
    safe_len = lengths.clamp(min=1).float()
    if length_penalty is None:
        penalty = safe_len
    else:
        penalty = ((5.0 + safe_len) / 6.0) ** length_penalty
    score = result.scores / penalty
    score = torch.where(result.scores <= BIG_NEG / 2, float("-inf"), score)
    selected = score.argmax(dim=-1)
    sel_score = result.scores.gather(1, selected[:, None])[:, 0]
    sel_len = lengths.gather(1, selected[:, None])[:, 0]
    avg_logprob = sel_score / (sel_len.float() + 1.0)
    return selected, avg_logprob, lengths
