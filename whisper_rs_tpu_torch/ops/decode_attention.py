"""One decode step's cross-attention: CUDA kernel
(``csrc/cross_attention.cu``) and its plain version (counterpart of
``whisper_rs_tpu/ops/decode_attention.py::cross_attention_step``).

G query rows per audio share one encoder K/V, read from the fused layout
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
