"""Triton source of the encoder's row LayerNorm, with an optional residual add.

Replaces: whisper_rs_tpu/ops/encoder_fused.py::residual_ln (kernel body
_residual_ln_kernel) and ::ln_fused (_ln_kernel).  One source serves both:
``HAS_RESIDUAL`` selects ``y = x + delta; ln = LN(y)`` or ``ln = LN(x)``.

Bound on the H100: bytes.  Each row is read once and written once or
twice, with a handful of operations per element, so the kernel can at best
stream at the card's memory rate.

Design: one program per row of the [rows, D] view; the whole row sits in
registers as one block of BLOCK_D (the power of two at or above D) with a
mask, so the add, the f32 mean and variance and the normalise happen in
one pass over memory, and y and LN(y) leave in the input dtype.

Loaded by ``whisper_rs_tpu_torch/ops/encoder_fused.py`` inside its launch
function, since importing this file imports ``triton``.
"""

import triton
import triton.language as tl


@triton.jit
def layer_norm_rows(
    X, DELTA, SCALE, BIAS, Y, LN, D, eps,
    HAS_RESIDUAL: tl.constexpr, BLOCK_D: tl.constexpr,
):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    offs = row.to(tl.int64) * D + cols
    x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_RESIDUAL:
        x = x + tl.load(DELTA + offs, mask=mask, other=0.0).to(tl.float32)
        tl.store(Y + offs, x.to(Y.dtype.element_ty), mask=mask)
    mean = tl.sum(x, axis=0) / D
    diff = tl.where(mask, x - mean, 0.0)
    var = tl.sum(diff * diff, axis=0) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    scale = tl.load(SCALE + cols, mask=mask, other=0.0).to(tl.float32)
    bias = tl.load(BIAS + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(LN + offs, (diff * rstd * scale + bias).to(LN.dtype.element_ty), mask=mask)
