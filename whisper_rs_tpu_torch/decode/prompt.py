"""Prefill buckets and end-aligned per-row prompts (counterpart of
``whisper_rs_tpu/decode/prompt.py``).

A prompted row is ``[<|startofprev|>] + prompt[-(n_text_ctx//2 - 1):] +
sot_sequence``; rows are packed END-aligned into one static bucket, and the
zero left-padding of shorter rows is masked out of attention via
``key_start``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Static prefill widths: the smallest >= sample_begin is chosen.
PREFILL_BUCKETS = (8, 64, 128, 232)


def prefill_bucket(sample_begin: int) -> int:
    for b in PREFILL_BUCKETS:
        if sample_begin <= b:
            return b
    raise ValueError(f"prompt too long: sample_begin={sample_begin}")


def build_batch_prompts(
    prompts,  # list[Optional[Sequence[int]]], one per utterance
    sot_sequence: Sequence[int],
    token_id_sot: int,
    token_id_startofprev: int,
    n_text_ctx: int = 448,
):
    """Returns (tokens [B, P] int32, key_start [B] int32, sample_begin=P,
    sot_idx); sot_idx is shared because the sot sequence sits at the end."""
    sot_sequence = list(sot_sequence)
    rows = []
    for p in prompts:
        if p is not None and len(p) > 0:
            max_prompt = n_text_ctx // 2 - 1
            rows.append([token_id_startofprev] + list(p)[-max_prompt:] + sot_sequence)
        else:
            rows.append(list(sot_sequence))
    P = prefill_bucket(max(len(r) for r in rows))
    tokens = np.zeros((len(rows), P), np.int32)
    key_start = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        tokens[i, P - len(r) :] = r
        key_start[i] = P - len(r)
    sot_idx = P - len(sot_sequence)
    return tokens, key_start, P, sot_idx
