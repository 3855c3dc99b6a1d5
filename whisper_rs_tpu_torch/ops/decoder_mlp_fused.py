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

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import count_launch, use_kernel
from .build import I, P, check, kernel_function

ROWS_A_BLOCK = 8  # weight rows a block of the f32 kernel: 4 warps of 2

# The bf16 kernel's tiling (csrc/decoder_mlp.cu): a block takes 64 weight
# rows, up to 6 tiles of 8 batch columns, and one split of K, in stages 64
# deep; the splits of a tile are the blocks of one cluster (at most 8, the
# portable cluster size).  Splits are taken only where the tiles alone give
# fewer than TILES_ENOUGH blocks, and then as few as give BLOCKS_AIM, each
# at least SPLIT_CHUNKS stages deep: the cluster's barriers and exchange
# cost more than the extra blocks gain beyond that (measured on the H100 at
# every path shape, PERF.md).
TILE_ROWS = 64
TILE_DEPTH = 64
MAX_N8 = 6
MAX_SPLITS = 8
TILES_ENOUGH = 32
BLOCKS_AIM = 96
SPLIT_CHUNKS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GemmPlan(NamedTuple):
    """How the bf16 kernel launches one product out[b, j] = sum_k x[b, k]
    w[j, k] of ``rows`` outputs j, ``batch`` rows b and depth ``depth``:
    ``mtiles`` tiles of TILE_ROWS rows, ``ntiles`` tiles of ``nt`` x 8
    batch columns, and ``splits`` blocks (one cluster) over the ``chunks``
    stages of TILE_DEPTH; split s takes the chunks from s chunks // splits
    up to (s + 1) chunks // splits."""
    rows: int
    depth: int
    batch: int
    mtiles: int
    nt: int
    ntiles: int
    chunks: int
    splits: int


def gemm_plan(rows: int, depth: int, batch: int) -> GemmPlan:
    """Batch tiles of at most MAX_N8 x 8 columns, balanced; no split of K
    where the tiles number TILES_ENOUGH, else the fewest splits that give
    BLOCKS_AIM blocks, at most MAX_SPLITS and SPLIT_CHUNKS chunks deep or
    more, so none is empty."""
    mtiles, chunks, n8 = _cdiv(rows, TILE_ROWS), _cdiv(depth, TILE_DEPTH), _cdiv(batch, 8)
    nt = _cdiv(n8, _cdiv(n8, MAX_N8))
    ntiles = _cdiv(n8, nt)
    tiles = mtiles * ntiles
    deepest = max(1, min(MAX_SPLITS, chunks // SPLIT_CHUNKS))
    splits = 1 if tiles >= TILES_ENOUGH else min(deepest, _cdiv(BLOCKS_AIM, tiles))
    return GemmPlan(rows, depth, batch, mtiles, nt, ntiles, chunks, splits)


def mlp_launch_plan(batch: int, d_model: int) -> tuple:
    """(fc1, fc2) plans of the bf16 kernel: fc1 is [4D] rows deep D, fc2 [D]
    rows deep 4D."""
    return gemm_plan(4 * d_model, d_model, batch), gemm_plan(d_model, 4 * d_model, batch)


def mlp_kernel_takes(d_model: int) -> bool:
    """Whether the MLP kernel takes this width: D a multiple of 8 (the f32
    kernel's whole blocks of rows over D and 4D, with a tail instance for a
    D that is not a multiple of its 128-wide chunks; the bf16 kernel's
    16-byte rows for TMA, zeros past the edges)."""
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
    (``mlp_kernel_takes``: D a multiple of 8; any other raises; bf16 at the
    plan of ``mlp_launch_plan``), the plain version on the CPU."""
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
    pointers = (h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g.data_ptr(),
                out.data_ptr(), B, D)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if h.dtype == torch.bfloat16:
        symbol = "decoder_mlp_bf16"
        plan = [n for p in mlp_launch_plan(B, D) for n in (p.nt, p.ntiles, p.splits)]
        fn = kernel_function("decoder_mlp", symbol, (P,) * 6 + (I,) * 8 + (P,))
        err = fn(*pointers, *plan, stream)
    else:
        symbol = "decoder_mlp_f32"
        fn = kernel_function("decoder_mlp", symbol, (P,) * 6 + (I, I, P))
        err = fn(*pointers, stream)
    check("decoder_mlp", symbol, err)
    count_launch("decoder_mlp_step")
    return out
