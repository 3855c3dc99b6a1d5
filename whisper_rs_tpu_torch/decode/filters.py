"""Batched logit filters (counterpart of ``whisper_rs_tpu/decode/filters.py``).

Every filter is a ``logits -> logits`` function over the whole [B, vocab]
batch, built from broadcast masks.  Order: SuppressBlank, SuppressTokens,
TimestampRules.  The position is a 0-d tensor on the logits' device, as
the JAX function takes a traced ``pos``: every rule that depends on it is
a mask (``torch.where``, ``index_select``), so a step reads nothing on the
host and can be captured as a CUDA graph; the suppress mask is made on the
device once for each configuration and device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Static filter configuration (token ids and switches)."""

    n_vocab: int
    token_id_eot: int
    token_id_space: int
    token_id_ts_begin: int
    token_id_no_timestamps: int
    suppress_blank: bool = True
    timestamps: bool = True
    # user list ∪ non-speech tokens; empty = off
    suppress_ids: Tuple[int, ...] = ()
    # round(max_initial_timestamp / 0.02) or None
    max_initial_timestamp_index: Optional[int] = None

    def suppress_mask(self) -> np.ndarray:
        """Additive [vocab] mask, -inf at suppressed ids."""
        m = np.zeros((self.n_vocab,), np.float32)
        if self.suppress_ids:
            m[np.asarray(self.suppress_ids, np.int64)] = NEG_INF
        return m


@functools.lru_cache(maxsize=None)
def suppress_mask_on(cfg: FilterConfig, device: torch.device) -> torch.Tensor:
    """``cfg.suppress_mask()`` as a [vocab] tensor on ``device``, made once
    (the step adds it, and never copies it from the host)."""
    return torch.from_numpy(cfg.suppress_mask()).to(device)


def apply_filters(
    cfg: FilterConfig,
    logits: torch.Tensor,  # [B, vocab] f32, last-position logits
    tokens: torch.Tensor,  # [B, n_ctx] token buffer
    pos,  # number of tokens so far (next write slot): 0-d int64 tensor, or an int
    sample_begin: int,
) -> torch.Tensor:
    """Run the configured filter stack for one decode step (returns a new
    tensor; ``logits`` is not modified)."""
    B, V = logits.shape
    dev = logits.device
    if not torch.is_tensor(pos):
        pos = torch.full((), int(pos), dtype=torch.int64, device=dev)
    col = torch.arange(V, device=dev)
    n_sampled = pos - sample_begin  # 0 at the first sampled position
    at_begin = n_sampled == 0

    if cfg.suppress_blank:
        blank = (col == cfg.token_id_space) | (col == cfg.token_id_eot)
        logits = logits.masked_fill(at_begin & blank[None, :], NEG_INF)

    if cfg.suppress_ids:
        logits = logits + suppress_mask_on(cfg, dev)[None, :]

    if cfg.timestamps:
        ts_begin = cfg.token_id_ts_begin
        is_ts = col >= ts_begin
        is_text = col < cfg.token_id_eot

        logits = logits.masked_fill((col == cfg.token_id_no_timestamps)[None, :], NEG_INF)

        # pairing rule on the last two sampled tokens
        n_ctx = tokens.shape[1]
        last = tokens.index_select(1, (pos - 1).clamp(0, n_ctx - 1).view(1))[:, 0]
        second_last = tokens.index_select(1, (pos - 2).clamp(0, n_ctx - 1).view(1))[:, 0]
        last_was_ts = (last >= ts_begin) & (n_sampled >= 1)
        second_last_was_ts = (second_last >= ts_begin) | (n_sampled < 2)
        ban_ts = last_was_ts & second_last_was_ts
        ban_text = last_was_ts & ~second_last_was_ts
        logits = logits.masked_fill(ban_ts[:, None] & is_ts[None, :], NEG_INF)
        logits = logits.masked_fill(ban_text[:, None] & is_text[None, :], NEG_INF)

        # first sampled position: force a timestamp, optionally capped
        logits = logits.masked_fill(at_begin & ~is_ts[None, :], NEG_INF)
        if cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + cfg.max_initial_timestamp_index
            logits = logits.masked_fill(at_begin & (col > last_allowed)[None, :], NEG_INF)

        # if P(any timestamp) > max P(text token), force a timestamp
        logprobs = log_softmax(logits)
        ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts[None, :], NEG_INF), dim=-1)
        max_text = logprobs.masked_fill(is_ts[None, :], NEG_INF).amax(dim=-1)
        force_ts = ts_logprob > max_text
        logits = logits.masked_fill(force_ts[:, None] & ~is_ts[None, :], NEG_INF)

    return logits


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log_softmax that tolerates fully -inf rows without NaN."""
    m = x.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    shifted = x - m
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
