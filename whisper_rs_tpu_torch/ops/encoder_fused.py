"""Row LayerNorm, with an optional residual add before it: the CUDA kernel
(``csrc/layer_norm.cu``) and plain versions (counterpart of
``whisper_rs_tpu/ops/encoder_fused.py``).

  residual_ln(x, delta, scale, bias) -> (y, ln)   # y = x + delta, ln = LN(y)
  ln_fused(x, scale, bias)           -> ln        # plain row LN

Both view [..., D] as [rows, D]; the math is f32 (mean, variance, eps 1e-5)
and the outputs take the input dtype.  LN(y) is taken from the f32 sum, not
from y rounded to the input dtype, as in the Pallas kernel.  The encoder
runs both a layer; every other LayerNorm of the model (the decoder's three
a layer and its last, the encoder's ``ln_post``) is ``ln_fused``.

The kernel's plan (``ln_launch_plan``): a warp a row with the row in
registers where a warp's registers hold it, else a block a row with the
row staged in shared memory.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import count_launch, use_kernel
from .build import F, I, P, check, kernel_function

EPS = 1e-5
SMS = 132  # the H100's streaming multiprocessors
VEC_BYTES = 16  # one vector load a lane
WARP_ITERS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)  # vectors a lane holds: the built instances
MAX_HELD = 64  # f32 values a lane of the warp variant holds
BLOCK_THREADS = 256  # threads of the block variant, and the most of a warp-variant block
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use


@dataclasses.dataclass(frozen=True)
class LnPlan:
    """How ``csrc/layer_norm.cu`` covers [rows, D]: ``variant`` "warp" (a
    warp a row, ``rows_per_block`` rows a block, lane l holding vectors
    ``i * 32 + l`` for i < ``iters``) or "block" (a block of ``threads`` a
    row, thread t walking vectors ``t + k * threads``, the f32 row in
    ``smem`` bytes of shared memory); a vector is ``vec`` elements."""

    variant: str
    vec: int
    iters: int
    rows_per_block: int
    threads: int
    grid: int
    smem: int


def _vec(D: int, itemsize: int, aligned: bool) -> int:
    full = VEC_BYTES // itemsize
    return full if aligned and D % full == 0 else 1


def ln_kernel_takes(D: int) -> bool:
    """Whether the kernel takes rows of width D: any D whose f32 row (and
    the block variant's 64 partials) fits in a block's shared memory."""
    return 1 <= D and (D + 64) * 4 <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def ln_launch_plan(rows: int, D: int, dtype: torch.dtype, aligned: bool = True) -> LnPlan:
    """The kernel's plan for ``rows`` rows of width ``D`` in ``dtype``;
    ``aligned``: every pointer a multiple of 16 bytes (else 1-element
    vectors).  The warp variant where a lane's share of the row fits in
    ``MAX_HELD`` registers, at as many rows a block (1 to 8; 4 where a lane
    holds more than 16 values, whose registers would leave one block an
    SM) as still leave at least a block an SM; else the block variant."""
    vec = _vec(D, torch.tensor([], dtype=dtype).element_size(), aligned)
    chunks = D // vec
    need = -(-chunks // 32)
    iters = next((i for i in WARP_ITERS if i >= need and i * vec <= MAX_HELD), None)
    if iters is None:
        threads = BLOCK_THREADS
        return LnPlan("block", vec, -(-chunks // threads), 1, threads, rows, (D + 64) * 4)
    cap = 8 if iters * vec <= 16 else 4
    per_block = max([r for r in (1, 2, 4, 8) if r <= cap and -(-rows // r) >= SMS] or [1])
    return LnPlan("warp", vec, iters, per_block, 32 * per_block, -(-rows // per_block), 0)


def _ln_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def residual_ln_plain(x, delta, scale, bias, eps: float = EPS):
    y = x.float() + delta.float()
    return y.to(x.dtype), _ln_f32(y, scale, bias, eps).to(x.dtype)


def ln_fused_plain(x, scale, bias, eps: float = EPS):
    return _ln_f32(x.float(), scale, bias, eps).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *others):
    if not x.is_cuda:
        raise ValueError(f"layer norm kernel: unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer norm kernel: unsupported dtype {x.dtype}")
    for t in (x,) + others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("layer norm kernel: x and delta must match in shape, dtype, device")
        if not t.is_contiguous():
            raise ValueError("layer norm kernel: inputs must be contiguous")
    for p in (scale, bias):
        if p.shape != (D,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"layer norm kernel: scale/bias must be contiguous [{D}]")
        if p.dtype != x.dtype:
            raise ValueError(f"layer norm kernel: scale/bias must be {x.dtype}, as x")


def _launch(x, delta, scale, bias, y, ln, eps, residual: bool, plan=None) -> None:
    """One launch over [rows, D] at ``plan`` (default ``ln_launch_plan``'s);
    without a residual, ``delta`` and ``y`` are never read or written."""
    D = x.shape[-1]
    rows = x.numel() // D
    if plan is None:
        aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, delta, scale, bias, y, ln))
        plan = ln_launch_plan(rows, D, x.dtype, aligned)
    fn = kernel_function("layer_norm", "layer_norm_rows",
                         (P, P, P, P, P, P, I, I, F, I, I, I, I, I, I, P))
    err = fn(
        x.data_ptr(), delta.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        ln.data_ptr(), rows, D, eps, int(x.dtype == torch.bfloat16), int(residual), plan.vec,
        plan.iters, plan.rows_per_block, int(plan.variant == "block"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check("layer_norm", "layer_norm_rows", err)


def residual_ln(x, delta, scale, bias, eps: float = EPS):
    """(x + delta, LN(x + delta)) in one pass: the kernel on the card
    (``ln_kernel_takes``: any D whose f32 row fits in shared memory; any
    other raises), the plain version on the CPU."""
    name = "residual_ln"
    if not use_kernel(name, ln_kernel_takes(x.shape[-1]), x.device):
        return residual_ln_plain(x, delta, scale, bias, eps)
    _check(x, scale, bias, delta)
    y = torch.empty_like(x)
    ln = torch.empty_like(x)
    if x.numel():
        _launch(x, delta, scale, bias, y, ln, eps, residual=True)
        count_launch(name)
    return y, ln


def ln_fused(x, scale, bias, eps: float = EPS):
    """Row LayerNorm: the kernel on the card (``ln_kernel_takes``), the
    plain version on the CPU."""
    name = "ln_fused"
    if not use_kernel(name, ln_kernel_takes(x.shape[-1]), x.device):
        return ln_fused_plain(x, scale, bias, eps)
    _check(x, scale, bias)
    ln = torch.empty_like(x)
    if x.numel():
        _launch(x, x, scale, bias, ln, ln, eps, residual=False)
        count_launch(name)
    return ln
