"""Encoder self-attention on the merged [B, T, D] layout: CUDA kernel
(``csrc/encoder_attention.cu``) and its plain version (counterpart of
``whisper_rs_tpu/ops/encoder_attention_pallas.py::encoder_attention_merged``).

Math, as in the Pallas kernel: per head, f32 scores ``q k^T * sm_scale``,
keys ``j >= n_valid`` masked, ``p = exp(s - max)``, the output
``(p cast to the input dtype) @ v`` divided by the f32 row sum ``sum(p)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES
from .build import F, I, P, check, kernel_function

HEAD_DIM = 64
_PLAIN_BATCH = 8  # batch rows per chunk: bounds the plain version's f32 scores


def encoder_attention_merged_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: [B, T, D] q/k/v (unscaled) -> [B, T, D], taken in
    chunks of batch rows so the [b, H, T, T] f32 scores stay bounded."""
    B, T, D = q.shape
    dh = D // n_head
    out = torch.empty_like(q)

    def split(x):
        return x.reshape(x.shape[0], T, n_head, dh).transpose(1, 2).float()

    for b0 in range(0, B, _PLAIN_BATCH):
        sl = slice(b0, b0 + _PLAIN_BATCH)
        s = (split(q[sl]) @ split(k[sl]).transpose(-1, -2)) * sm_scale
        if n_valid is not None and n_valid < T:
            s[..., n_valid:] = float("-inf")
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = (p.to(q.dtype).float() @ split(v[sl])) / p.sum(dim=-1, keepdim=True)
        out[sl] = o.transpose(1, 2).reshape(-1, T, D).to(q.dtype)
    return out


def encoder_attention_merged(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Non-causal attention over merged heads: the kernel on the card
    (head dim 64, bf16 on the tensor cores or f32 on the FMA pipes), the
    plain version on the CPU."""
    if q.device.type == "cpu":
        return encoder_attention_merged_plain(q, k, v, n_head, sm_scale, n_valid)
    if not q.is_cuda:
        raise ValueError(f"encoder_attention_merged: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError(f"encoder_attention_merged wants [B, T, D], got {tuple(q.shape)}")
    B, T, D = q.shape
    if D != n_head * HEAD_DIM:
        raise ValueError(
            f"encoder_attention_merged kernel takes head dim {HEAD_DIM}, got {D}/{n_head}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encoder_attention_merged: unsupported dtype {q.dtype}")
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("encoder_attention_merged: q, k, v must match")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("encoder_attention_merged: q, k, v must be contiguous, 16-byte aligned")
    nv = T if n_valid is None else int(n_valid)
    if not 1 <= nv <= T:
        raise ValueError(f"encoder_attention_merged: n_valid {nv} outside [1, {T}]")
    out = torch.empty_like(q)
    symbol = "encoder_attention_bf16" if q.dtype == torch.bfloat16 else "encoder_attention_f32"
    fn = kernel_function("encoder_attention", symbol, (P, P, P, P, I, I, I, I, F, I, P))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, D, n_head,
        float(sm_scale), nv, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check("encoder_attention", symbol, err)
    LAUNCHES["encoder_attention_merged"] += 1
    return out
