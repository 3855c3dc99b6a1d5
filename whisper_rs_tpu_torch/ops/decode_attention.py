"""Decode-step attention kernels and their plain versions (counterpart of
``whisper_rs_tpu/ops/decode_attention.py``).

``self_attention_append_step`` (``csrc/self_attention.cu``): one greedy
step's self-attention.  It writes this step's K/V column into the ctx-major
cache ``[L, B, H, n_ctx, dh]`` at slot ``pos`` of layer ``layer``, in place,
then attends slots ``key_start[b] <= j <= pos`` of the first ``window``.
Math, as in the Pallas kernel: f32 scores of the pre-scaled q, masked slots
at the finite NEG, ``w = e / sum(e)`` kept in f32 (never rounded to the
cache dtype), ``w V`` accumulated in f32 and cast to the query dtype.

``cross_attention_step`` (``csrc/cross_attention.cu``): G query rows per
audio share one encoder K/V, read from the fused layout
``kv [L, A, H, 2, dh, Tk]`` (K^T and V^T planes, see ``models.whisper.
CrossKV``) at layer ``layer``.  Math, as in the Pallas kernel: f32 scores,
no mask, ``w = e / sum(e)`` in f32, ``w`` cast to the K/V dtype, then
``w V`` accumulated in f32 and cast to the query dtype.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .build import I, P, check, kernel_function

HEAD_DIM = 64
MAX_GROUP = 8
NEG = -1e9  # finite mask value, as in the Pallas kernels


def _check_append_args(name, q, k_all, layer: int, pos: int, window: int):
    L, B, H, n_ctx, dh = k_all.shape
    if q.shape != (B, H, dh):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if not 0 <= pos < window <= n_ctx:
        raise ValueError(f"{name}: needs 0 <= pos ({pos}) < window ({window}) <= n_ctx ({n_ctx})")


def self_attention_append_step_plain(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_all: torch.Tensor,
    v_all: torch.Tensor, layer: int, pos: int, key_start=None, *, window: int,
) -> torch.Tensor:
    """Plain version: writes ``k_new``/``v_new`` [B, H, dh] into slot ``pos``
    of ``k_all``/``v_all`` [L, B, H, n_ctx, dh] at ``layer`` in place;
    returns the attention output [B, H, dh] of the pre-scaled q."""
    _check_append_args("self_attention_append_step", q, k_all, layer, pos, window)
    k_all[layer, :, :, pos] = k_new
    v_all[layer, :, :, pos] = v_new
    k = k_all[layer, :, :, :window].float()  # [B, H, W, dh]
    v = v_all[layer, :, :, :window].float()
    s = torch.einsum("bhd,bhwd->bhw", q.float(), k)
    ids = torch.arange(window, device=q.device)
    visible = ids[None, :] <= pos
    if key_start is not None:
        visible = visible & (ids[None, :] >= key_start[:, None])
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhw,bhwd->bhd", w, v).to(q.dtype)


def self_attention_append_step(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_all: torch.Tensor,
    v_all: torch.Tensor, layer: int, pos: int, key_start=None, *, window: int,
) -> torch.Tensor:
    """One greedy step's self-attention at ``layer``, with this step's K/V
    column written into the cache in place: the kernel on the card, the
    plain version on the CPU.  q, k_new, v_new [B, H, dh] (q pre-scaled);
    caches [L, B, H, n_ctx, dh]; ``key_start`` [B] int64 or None (zeros)."""
    if q.device.type == "cpu":
        return self_attention_append_step_plain(
            q, k_new, v_new, k_all, v_all, layer, pos, key_start, window=window
        )
    name = "self_attention_append_step"
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_append_args(name, q, k_all, layer, pos, window)
    L, B, H, n_ctx, dh = k_all.shape
    if dh != HEAD_DIM or k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"{name}: q, k_new, v_new must be [B, H, {HEAD_DIM}] alike")
    if v_all.shape != k_all.shape:
        raise ValueError(f"{name}: k_all {tuple(k_all.shape)} vs v_all {tuple(v_all.shape)}")
    tensors = (q, k_new, v_new, k_all, v_all)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}")
    if key_start is not None and (key_start.dtype != torch.int64 or key_start.shape != (B,)):
        raise ValueError(f"{name}: key_start must be int64 [{B}]")
    for t in tensors + (() if key_start is None else (key_start,)):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned")
    out = torch.empty_like(q)
    symbol = "self_attention_append_bf16" if q.dtype == torch.bfloat16 else "self_attention_append_f32"
    fn = kernel_function("self_attention", symbol, (P, P, P, P, P, P, P, I, I, I, I, I, I, P))
    err = fn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
        None if key_start is None else key_start.data_ptr(), out.data_ptr(),
        B, H, n_ctx, int(layer), int(pos), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check("self_attention", symbol, err)
    LAUNCHES["self_attention_append_step"] += 1
    return out


def _no_int8(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 cross K/V (k_scale/v_scale) waits for the quantisation slice"
        )


def cross_attention_step_plain(
    q: torch.Tensor, kv_all: torch.Tensor, layer: int, *, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Plain version: q [A, G, H, dh] (pre-scaled) -> [A, G, H, dh]."""
    _no_int8(k_scale, v_scale)
    k_t = kv_all[layer, :, :, 0].float()  # [A, H, dh, Tk]
    v_t = kv_all[layer, :, :, 1].float()
    qk = torch.einsum("aghd,ahdk->aghk", q.float(), k_t)
    e = torch.exp(qk - qk.amax(dim=-1, keepdim=True))
    w = (e / e.sum(dim=-1, keepdim=True)).to(kv_all.dtype).float()
    return torch.einsum("aghk,ahdk->aghd", w, v_t).to(q.dtype)


def cross_attention_step(
    q: torch.Tensor, kv_all: torch.Tensor, layer: int, *, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Cross-attention for one decode step at ``layer``: the kernel on the
    card, the plain version on the CPU.  q [A, G, H, dh] pre-scaled."""
    _no_int8(k_scale, v_scale)
    if q.device.type == "cpu":
        return cross_attention_step_plain(q, kv_all, layer)
    if not q.is_cuda:
        raise ValueError(f"cross_attention_step: unsupported device {q.device}")
    A, G, H, dh = q.shape
    L, A2, H2, two, dh2, Tk = kv_all.shape
    if (A2, H2, two, dh2) != (A, H, 2, dh) or dh != HEAD_DIM:
        raise ValueError(
            f"cross_attention_step: q {tuple(q.shape)} vs kv {tuple(kv_all.shape)} "
            f"(head dim must be {HEAD_DIM})"
        )
    if not 0 <= layer < L:
        raise ValueError(f"cross_attention_step: layer {layer} outside [0, {L})")
    if not 1 <= G <= MAX_GROUP or Tk % 4:
        raise ValueError(f"cross_attention_step: needs 1 <= G <= {MAX_GROUP}, Tk % 4 == 0")
    if q.dtype != kv_all.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_attention_step: dtypes {q.dtype}, {kv_all.dtype}")
    if kv_all.device != q.device:
        raise ValueError("cross_attention_step: q and kv on different devices")
    for t in (q, kv_all):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("cross_attention_step: q and kv must be contiguous, 16-byte aligned")
    out = torch.empty_like(q)
    symbol = "cross_attention_bf16" if q.dtype == torch.bfloat16 else "cross_attention_f32"
    fn = kernel_function("cross_attention", symbol, (P, P, P, I, I, I, I, I, P))
    err = fn(
        q.data_ptr(), kv_all.data_ptr(), out.data_ptr(), A, G, H, Tk, int(layer),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check("cross_attention", symbol, err)
    LAUNCHES["cross_attention_step"] += 1
    return out
