"""Greedy single-window decode at temperature 0 (counterpart of
``whisper_rs_tpu/decode/loop.py``): encoder, cross K/V precompute, prompt
prefill, then a host loop of incremental decoder steps with the logit
filters, argmax and EOT bookkeeping, in phases of growing attention window.

The loop checks ``finished.all()`` on the host once a step.  Temperature
sampling is not ported: the reference draws its noise from JAX's threefry
generator, which torch cannot reproduce.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import GreedyMode
from ..models.whisper import CrossKV, KVCache, Whisper, precompute_cross_kv
from .filters import FilterConfig, apply_filters, log_softmax

BIG_NEG = -1e9  # finite stand-in for -inf in scores


@dataclasses.dataclass
class DecodeResult:
    """Outputs of one window decode (per audio)."""

    candidates: torch.Tensor  # [n_audio, n_cand, n_ctx] int64, EOT-terminated
    scores: torch.Tensor  # [n_audio, n_cand] f32 cumulative logprob
    no_speech_probs: torch.Tensor  # [n_audio] f32
    audio_features: torch.Tensor  # [n_audio, n_audio_ctx, n_state]
    steps: int = 0  # incremental decoder steps run after the prefill


def _encode_and_prefill(
    model: Whisper, mel, initial_tokens, sample_begin: int, sot_idx: int, group: int,
    cfg: FilterConfig, no_speech_id: int, key_start, kernels: bool,
):
    """Encoder forward, group repeat, prefill pass.  Returns (tokens
    [B, n_ctx], first-step filtered logits [B, V], cache, cross_kv,
    no_speech_probs [n_audio], audio features, key_start)."""
    dims = model.dims
    xa = model.encoder(mel.to(model.dtype), kernels=kernels)
    if group > 1:
        initial_tokens = initial_tokens.repeat_interleave(group, dim=0)
        if key_start is not None:
            key_start = key_start.repeat_interleave(group, dim=0)
    B = initial_tokens.shape[0]

    cross_kv = precompute_cross_kv(model, xa)
    cache = KVCache.init(dims, B, xa.dtype, xa.device)

    # only the SOT row (no-speech probability) and the last prompt row (the
    # first sampled position) need logits
    positions = torch.tensor([sot_idx, sample_begin - 1], device=xa.device)
    logits = model.decoder(
        initial_tokens, 0, cross_kv, cache, key_start=key_start,
        logit_positions=positions, cross_group=group, kernels=kernels,
    )  # [B, 2, V] f32
    no_speech = torch.softmax(logits[:, 0], dim=-1)[:, no_speech_id]
    no_speech_probs = no_speech[::group]

    tokens = torch.zeros((B, dims.n_text_ctx), dtype=torch.long, device=xa.device)
    tokens[:, : initial_tokens.shape[1]] = initial_tokens
    filtered = apply_filters(cfg, logits[:, 1], tokens, sample_begin, sample_begin)
    return tokens, filtered, cache, cross_kv, no_speech_probs, xa, key_start


def _step_logits(
    model: Whisper, tokens, pos: int, cross_kv: CrossKV, cache: KVCache,
    cfg: FilterConfig, sample_begin: int, key_start, group: int, ctx_window: int,
    kernels: bool,
):
    """One incremental step: feed the token at pos-1, return the filtered
    logits for position pos (the cache is updated in place)."""
    logits = model.decoder(
        tokens[:, pos - 1 : pos], pos - 1, cross_kv, cache, key_start=key_start,
        cross_group=group, ctx_window=ctx_window, kernels=kernels,
    )
    return apply_filters(cfg, logits[:, 0], tokens, pos, sample_begin)


def _phase_windows(n_ctx: int, prefill_width: int, sample_len: int) -> tuple:
    """Cache-window schedule (128 -> 256 -> n_ctx): a step at position pos
    attends only the first W >= pos + 1 slots.  Phases the position can
    never reach are dropped."""
    max_pos = min(n_ctx, prefill_width + sample_len + 1)
    wins = []
    for W in (128, 256, n_ctx):
        if W < prefill_width or W <= (wins[-1] if wins else 0):
            continue
        wins.append(W)
        if W >= max_pos:
            break
    return tuple(wins)


def _greedy_update(logits, tokens, pos: int, sum_logprobs, finished, eot: int):
    """Argmax next token; accumulate its logprob for live rows; pin
    finished rows to EOT.  Writes ``tokens[:, pos]`` in place."""
    next_tok = logits.argmax(dim=-1)
    cur_lp = log_softmax(logits).gather(1, next_tok[:, None])[:, 0]
    sum_logprobs = sum_logprobs + torch.where(finished, torch.zeros_like(cur_lp), cur_lp)
    next_tok = torch.where(finished, torch.full_like(next_tok, eot), next_tok)
    finished = finished | (next_tok == eot)
    tokens[:, pos] = next_tok
    return sum_logprobs, finished


def decode_greedy(
    model: Whisper,
    mel: torch.Tensor,  # [n_audio, n_mels, 3000] on the model's device
    initial_tokens,  # [n_audio, P] prompt (array or tensor)
    sample_begin: int,
    sot_idx: int,
    cfg: FilterConfig,
    mode: GreedyMode,
    sample_len: int,
    no_speech_id: int,
    key_start=None,  # [n_audio] first valid prompt slot per row
    kernels: bool = True,
) -> DecodeResult:
    """Greedy decode of one batch of 30 s windows.  ``kernels=False`` runs
    every kernel's plain version instead (the reference path on the card)."""
    if mode.temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported: the reference's noise comes from "
            "JAX threefry (fold_in by row and step), which torch cannot reproduce"
        )
    dev = model.device
    dims = model.dims
    eot = cfg.token_id_eot
    n_ctx = dims.n_text_ctx
    group = mode.group_size
    initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
    if key_start is not None:
        key_start = torch.as_tensor(key_start, dtype=torch.long, device=dev)

    tokens, logits, cache, cross_kv, no_speech, feats, key_start = _encode_and_prefill(
        model, mel.to(dev), initial_tokens, sample_begin, sot_idx, group, cfg,
        no_speech_id, key_start, kernels,
    )
    B = tokens.shape[0]
    n_audio = B // group

    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp, finished = _greedy_update(logits, tokens, sample_begin, sum_lp, finished, eot)

    step, pos = 1, sample_begin + 1
    for W in _phase_windows(n_ctx, initial_tokens.shape[1], sample_len):
        while step < sample_len and pos < W and not bool(finished.all()):
            logits = _step_logits(
                model, tokens, pos, cross_kv, cache, cfg, sample_begin, key_start,
                group, W, kernels,
            )
            sum_lp, finished = _greedy_update(logits, tokens, pos, sum_lp, finished, eot)
            step, pos = step + 1, pos + 1

    # finalize: rows that never emitted EOT get one appended
    write_pos = min(pos, n_ctx - 1)
    tokens[:, write_pos] = torch.where(
        finished, tokens[:, write_pos], torch.full_like(tokens[:, write_pos], eot)
    )
    return DecodeResult(
        candidates=tokens.reshape(n_audio, group, n_ctx),
        scores=sum_lp.reshape(n_audio, group),
        no_speech_probs=no_speech,
        audio_features=feats,
        steps=step - 1,
    )
