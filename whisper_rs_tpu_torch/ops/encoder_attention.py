"""Encoder self-attention: the CUDA kernel of ``csrc/encoder_attention.cu``
on two layouts, and their plain versions (counterparts of
``whisper_rs_tpu/ops/encoder_attention_pallas.py``):

  * ``encoder_attention_merged`` on the merged [B, T, D] layout, head dim
    64 (``encoder_attention_merged``, row 4);
  * ``encoder_attention_split`` on the split [B, H, T, dh] layout, head dim
    16 or 64, at any strides with contiguous rows, so the encoder passes its
    merged projections' heads as views (``encoder_attention_pallas``,
    row 6).

Math, as in the Pallas kernels: per head, f32 scores ``q k^T * sm_scale``,
keys ``j >= n_valid`` masked, ``p = exp(s - max)``, the output
``(p cast to the input dtype) @ v`` divided by the f32 row sum ``sum(p)``.

``merged_kernel_takes`` is the encoder's route (the JAX
``models/whisper.py`` predicate): head dim 64 and an even head count take
the merged kernel, every other shape splits heads and takes
``encoder_attention_split``, whose own predicate ``split_kernel_takes``
names the head dims the kernel is built for; on the card any other raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, use_kernel
from .build import F, I, I64, P, check, kernel_function

HEAD_DIM = 64  # the merged kernel's
SPLIT_HEAD_DIMS = (16, 64)  # the split kernel's instances: the golden dims', the registry's
_PLAIN_ROWS = 64  # (batch, head) rows per chunk: bounds the plain version's f32 scores


def merged_kernel_takes(n_head: int, head_dim: int) -> bool:
    """Whether the encoder takes the merged-layout kernel (row 4): head dim
    64 and an even head count, as the JAX encoder routes it; every other
    shape splits heads for ``encoder_attention_split``."""
    return head_dim == HEAD_DIM and n_head % 2 == 0


def split_kernel_takes(head_dim: int) -> bool:
    """Whether the split-layout kernel (row 6) takes this head dim."""
    return head_dim in SPLIT_HEAD_DIMS


def encoder_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: [B, H, T, dh] q/k/v (unscaled, at any strides) ->
    [B, H, T, dh] contiguous, taken in chunks of (batch, head) rows so the
    [rows, T, T] f32 scores stay bounded."""
    B, H, T, dh = q.shape
    qf, kf, vf = (t.reshape(B * H, T, dh) for t in (q, k, v))
    out = torch.empty_like(qf)
    for r0 in range(0, B * H, _PLAIN_ROWS):
        sl = slice(r0, r0 + _PLAIN_ROWS)
        s = (qf[sl].float() @ kf[sl].float().transpose(-1, -2)) * sm_scale
        if n_valid is not None and n_valid < T:
            s[..., n_valid:] = float("-inf")
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = (p.to(q.dtype).float() @ vf[sl].float()) / p.sum(dim=-1, keepdim=True)
        out[sl] = o.to(q.dtype)
    return out.view(B, H, T, dh)


def encoder_attention_merged_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: [B, T, D] q/k/v (unscaled) -> [B, T, D], through the
    split layout's."""
    B, T, D = q.shape

    def split(x):
        return x.reshape(B, T, n_head, D // n_head).transpose(1, 2)

    out = encoder_attention_split_plain(split(q), split(k), split(v), sm_scale, n_valid)
    return out.transpose(1, 2).reshape(B, T, D)


def _check_kernel_tensors(name: str, q, k, v, n_valid, T: int, strided: bool = False) -> int:
    """q, k, v alike in shape, dtype and device, 16-byte aligned, and
    contiguous; or, ``strided``, at the same strides with each last-dim row
    contiguous and every row start 16-byte aligned."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must match")
        if strided:
            if (t.stride() != q.stride() or t.stride(-1) != 1 or t.data_ptr() % 16
                    or any(st * t.element_size() % 16 for st in t.stride()[:-1])):
                raise ValueError(f"{name}: q, k, v must share strides, with contiguous "
                                 f"16-byte aligned rows; got {[x.stride() for x in (q, k, v)]}")
        elif not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be contiguous, 16-byte aligned")
    nv = T if n_valid is None else int(n_valid)
    if not 1 <= nv <= T:
        raise ValueError(f"{name}: n_valid {nv} outside [1, {T}]")
    return nv


def encoder_attention_merged(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Non-causal attention over merged heads: the kernel on the card
    (head dim 64, bf16 on the tensor cores or f32 on the FMA pipes), the
    plain version on the CPU."""
    if q.device.type == "cpu":
        return encoder_attention_merged_plain(q, k, v, n_head, sm_scale, n_valid)
    name = "encoder_attention_merged"
    if not q.is_cuda:
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != 3:
        raise ValueError(f"{name} wants [B, T, D], got {tuple(q.shape)}")
    B, T, D = q.shape
    if D != n_head * HEAD_DIM:
        raise ValueError(f"{name} kernel takes head dim {HEAD_DIM}, got {D}/{n_head}")
    nv = _check_kernel_tensors(name, q, k, v, n_valid, T)
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


def encoder_attention_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
    n_valid: Optional[int] = None,
) -> torch.Tensor:
    """Non-causal attention over split heads, [B, H, T, dh] q/k/v (unscaled)
    -> [B, H, T, dh]: the kernel on the card (``split_kernel_takes``: head
    dim 16 or 64; any other raises; bf16 on the tensor cores or f32 on the
    FMA pipes), the plain version on the CPU.  On the card q, k and v may be
    views at any common strides whose rows of dh are contiguous (the heads
    of a [B, T, D] tensor, ``split_heads``); the output has their strides,
    so ``merge_heads`` of it is a view too."""
    name = "encoder_attention_split"
    if q.ndim != 4:
        raise ValueError(f"{name} wants [B, H, T, dh], got {tuple(q.shape)}")
    B, H, T, dh = q.shape
    if not use_kernel(name, split_kernel_takes(dh), q.device):
        return encoder_attention_split_plain(q, k, v, sm_scale, n_valid)
    nv = _check_kernel_tensors(name, q, k, v, n_valid, T, strided=True)
    out = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype, device=q.device)
    sb, sh, sr, _ = q.stride()
    symbol = f"{name}_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}"
    fn = kernel_function("encoder_attention", symbol,
                         (P, P, P, P, I, I, I, I, I64, I64, I, F, I, P))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, dh, sb, sh, sr,
        float(sm_scale), nv, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check("encoder_attention", symbol, err)
    LAUNCHES[name] += 1
    return out
