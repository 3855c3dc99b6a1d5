"""One decode step's MLP: CUDA kernel (``csrc/decoder_mlp.cu``) and its plain
version (counterpart of ``whisper_rs_tpu/ops/decoder_mlp_fused.py::
decoder_mlp_step``).

  decoder_mlp_step(h, w1, b1, w2) -> gelu(h w1^T + b1) w2^T   # no fc2 bias

h [B, D] in the compute dtype; w1 = ``mlp.0.weight`` [4D, D], b1 [4D],
w2 = ``mlp.2.weight`` [D, 4D], read in place (no packing).  Rounding
points, as in the Pallas kernel: fc1 summed in f32 with b1, rounded to the
compute dtype; GELU (exact erf in f32, the tanh form in half precision)
computed in f32 and rounded; fc2 summed in f32 and cast.  The caller adds
the fc2 bias in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, use_kernel
from .build import I, P, check, kernel_function

ROWS_A_BLOCK = 8  # weight rows a block of the kernel: 4 warps of 2


def mlp_kernel_takes(d_model: int) -> bool:
    """Whether the MLP kernel takes this width: D a multiple of 8 (whole
    blocks of rows over D and 4D; a D that is not a multiple of the
    kernel's 128-wide chunks takes its tail instance)."""
    return d_model >= ROWS_A_BLOCK and d_model % ROWS_A_BLOCK == 0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in f32/f64; the tanh approximation in half precision,
    as the JAX reference does."""
    exact = x.dtype in (torch.float32, torch.float64)
    return F.gelu(x, approximate="none" if exact else "tanh")


def decoder_mlp_step_plain(h, w1, b1, w2) -> torch.Tensor:
    """Plain version: h [B, D] -> [B, D], without the fc2 bias."""
    a = (h.float() @ w1.float().T + b1.float()).to(h.dtype)
    return (gelu(a).float() @ w2.float().T).to(h.dtype)


def decoder_mlp_step(h, w1, b1, w2) -> torch.Tensor:
    """The decode step's MLP without the fc2 bias: the kernel on the card
    (``mlp_kernel_takes``: D a multiple of 8; any other raises), the plain
    version on the CPU."""
    name = "decoder_mlp_step"
    if not use_kernel(name, mlp_kernel_takes(h.shape[-1]), h.device):
        return decoder_mlp_step_plain(h, w1, b1, w2)
    B, D = h.shape
    if w1.shape != (4 * D, D) or b1.shape != (4 * D,) or w2.shape != (D, 4 * D):
        raise ValueError(
            f"{name}: h {tuple(h.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"w2 {tuple(w2.shape)}"
        )
    tensors = (h, w1, b1, w2)
    if h.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != h.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}")
    for t in tensors:
        if t.device != h.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned")
    g = torch.empty((B, 4 * D), dtype=h.dtype, device=h.device)
    out = torch.empty_like(h)
    symbol = "decoder_mlp_bf16" if h.dtype == torch.bfloat16 else "decoder_mlp_f32"
    fn = kernel_function("decoder_mlp", symbol, (P, P, P, P, P, P, I, I, P))
    err = fn(
        h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g.data_ptr(), out.data_ptr(),
        B, D, torch.cuda.current_stream(h.device).cuda_stream,
    )
    check("decoder_mlp", symbol, err)
    LAUNCHES["decoder_mlp_step"] += 1
    return out
