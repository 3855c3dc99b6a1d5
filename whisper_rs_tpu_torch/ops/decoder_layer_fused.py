"""The whole incremental decoder step, every layer, in one kernel launch
(counterpart of ``whisper_rs_tpu/ops/decoder_layer_fused.py``; CUDA source
``csrc/decoder_layer.cu``).

  decoder_step_fused(x, weights, cross_kv, k_cache, v_cache, pos, key_start,
                     n_head=, group=, window=) -> x after the last layer

x [B, D] is the step's embedded token in the compute dtype; ``cross_kv``
the fused cross K/V ``[L, A, H, 2, dh, Tk]`` (``models.whisper.CrossKV``);
the caches the port's ctx-major ``[L, B, H, n_ctx, dh]``, into which each
layer's K/V column is written at slot ``pos`` in place.  (The JAX caller
writes the columns after the call; the caches end the same.)  Rounding
points, as in the Pallas kernel: LayerNorm in f32; every product summed in
f32 and rounded to the compute dtype before its bias is added; the
self-attention's weights kept in f32 and the sum divided after P V, over
the cache slots ``key_start[b] <= j <= pos`` (this step's column
included); the cross-attention's weights rounded to the compute dtype
before P V; GELU exact in f32 and the tanh form in half precision; the
residual stream in the compute dtype between sub-blocks.

The weights argument, ``DecoderStepWeights``, is built once per decode
(``decode_greedy`` does it before its step loop): a device table of
pointers into the model's own parameters, and the parameters themselves
for the plain version.  A table and not a packed copy: the TPU kernel
packed the weights into one [L, 2, n, 8n] stream because one wide DMA ran
1.5x faster there, but on Hopper a warp reads any contiguous weight row at
full rate, and the copy would take 705 MB more device memory at medium.en
bf16 and a copy pass per decode.

In bf16 the kernel streams each projection's weights on the tensor cores
by a static plan, ``layer_launch_plan``: each projection is cut into tiles
of 8 output features and ``ks`` K-slices, and each block of the grid
takes one slice of a run of tiles, so that every block streams about the
same weight bytes in each phase; the slices' f32 partials are summed in
slice order by the block of slice 0.  The plan also lays out the block's
shared memory (the weight ring, the staged rows, the cross ring).  The f32
instance, the parity variant, needs no plan.

``layer_kernel_takes`` is the kernel's routing predicate, in the place of
the TPU's VMEM gate (``layer_fused_ok``): where it refuses a shape, the
decoder runs that step through the append route instead, as the JAX loop
runs the layered step (``models.whisper.TextDecoder.forward`` counts it under
``"decoder_step_fused:append"``).  The wrapper itself raises on a shape the
predicate refuses, and never falls back to the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from . import count_launch
from .build import F, I, P, check, kernel_function
from .decode_attention import NEG, _write_slot, step_pos, write_column
from .decoder_mlp_fused import gelu
from .encoder_fused import ln_fused_plain

HEAD_DIM = 64  # the whole-step kernel's only head dim
MAX_ROWS = 16  # rows a launch takes (one warp a row in the LayerNorms)
GROUPS = (1, 2, 4, 8)  # rows an audio in the cross-attention
SMEM_LIMIT = 220 * 1024  # dynamic shared memory a block may take, bytes

# The bf16 kernel's layout (csrc/decoder_layer.cu).  A weight tile is 8
# output features (the mma's N; the rows of x are its M); a ring stage
# holds 512 columns of its 8 rows, each row padded by 16 bytes; the
# consumers are 8 warps, whose f32 tiles [16, 8] are summed in shared
# memory (two sets, used in turns) into the block's tile sums (at most
# MAX_TILES tiles a block a phase).  A block stages the activations' K-slice
# for 8 rows (16 above 8), at most STAGED_BYTES of them (K-slices are
# multiples of 16 columns, the mma's depth), and a LayerNorm phase's scale
# and offset (LN_BYTES) and input rows [B, D], D <= MAX_WIDTH.  A K-slicing
# is scored by the ring chunks of its busiest block, and a split by
# MERGE_CHUNKS more: the merge's round trips through L2 cost about as much
# as streaming that many chunks (measured on the H100, PERF.md); among the
# scores within FEWER_SLICES of the best, the fewest slices.
# The cross ring's stages are 8 rows of a [64, Tk] plane.  The weight ring
# takes what the largest phase leaves, MIN_STAGES at least; the cross ring
# is as deep as leaves WANT_STAGES weight stages, up to MAX_CROSS_STAGES.
TILE_FEATURES = 8
STAGE_COLS = 512
STAGE_BYTES = TILE_FEATURES * (2 * STAGE_COLS + 16)
CONSUMER_WARPS = 8
TILE_SUM_BYTES = 16 * TILE_FEATURES * 4
RED_BYTES = CONSUMER_WARPS * TILE_SUM_BYTES
MAX_TILES = 16
MERGE_CHUNKS = 4
FEWER_SLICES = 1.07
SLICE_STEP = 16
STAGED_BYTES = 64 * 1024
MAX_SLICES = 16
MAX_WIDTH = 2048
LN_BYTES = 2 * MAX_WIDTH * 2
CROSS_ROWS = 8
MIN_STAGES, WANT_STAGES, MAX_STAGES = 4, 12, 16
MIN_CROSS_STAGES, MAX_CROSS_STAGES = 2, 4
# the six projections of a layer, in the kernel's order
PROJECTIONS = ("qkv", "out", "cross_q", "cross_out", "fc1", "fc2")

# per layer, in the column order of the kernel's table (csrc/decoder_layer.cu)
WEIGHT_NAMES = (
    "attn_ln.weight", "attn_ln.bias",
    "attn.query.weight", "attn.query.bias", "attn.key.weight",
    "attn.value.weight", "attn.value.bias", "attn.out.weight", "attn.out.bias",
    "cross_attn_ln.weight", "cross_attn_ln.bias",
    "cross_attn.query.weight", "cross_attn.query.bias",
    "cross_attn.out.weight", "cross_attn.out.bias",
    "mlp_ln.weight", "mlp_ln.bias",
    "mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias",
)


@dataclasses.dataclass
class DecoderStepWeights:
    """Every decoder layer's step weights: ``layers[l]`` the tensors of
    ``WEIGHT_NAMES`` (the model's own parameters, not copies); ``table``
    [L, 21] int64 their device addresses, for the kernel.  Holding the
    tensors keeps the addresses valid."""

    layers: tuple
    table: torch.Tensor


def decoder_step_weights(blocks) -> DecoderStepWeights:
    """The step weights of the decoder's ``blocks`` (an ``nn.ModuleList``
    of ``ResidualAttentionBlock``), read in place.  Checked here, once, for
    what the kernel takes: one dtype and one device, every tensor
    contiguous and 16-byte aligned."""
    layers = []
    for block in blocks:
        params = dict(block.named_parameters())
        layers.append(tuple(params[name].detach() for name in WEIGHT_NAMES))
    first = layers[0][0]
    for t in (t for layer in layers for t in layer):
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError("decoder_step_weights: the weights differ in dtype or device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decoder_step_weights: weights must be contiguous, 16-byte aligned")
    table = torch.tensor(
        [[t.data_ptr() for t in layer] for layer in layers], dtype=torch.int64
    ).to(first.device)
    return DecoderStepWeights(tuple(layers), table)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PhasePlan(NamedTuple):
    """One projection of the bf16 kernel: ``features`` outputs (N) of depth
    ``depth`` (K), cut into N / 8 tiles and ``slices`` K-slices of
    ``width`` columns; ``blocks[j]`` = (slice, t0, t1): block j takes
    columns slice * width .. + width of tiles t0 .. t1 - 1.  The blocks of
    slice s are a run, and among them the tiles [0, N / 8) are split in
    runs, so each slice covers every tile once."""
    name: str
    features: int
    depth: int
    slices: int
    width: int
    blocks: tuple


class LayerPlan(NamedTuple):
    """The bf16 kernel's launch: the six projections' plans, the weight
    ring's stages, the cross ring's, the staged rows' pitch (bytes), the
    dynamic shared memory, and the sizes of the split-K partials (floats)
    and their flags."""
    phases: tuple
    stages: int
    cross_stages: int
    act_pitch: int
    smem: int
    partial_floats: int
    flags: int


def _staged_rows(rows: int) -> int:
    return 8 if rows <= 8 else 16


def _slice_cols_max(rows: int) -> int:
    """The widest K-slice whose staged rows fit STAGED_BYTES."""
    return STAGED_BYTES // (2 * _staged_rows(rows))


def _phase_plan(name: str, N: int, K: int, blocks: int, rows: int) -> PhasePlan:
    """The fewest K-slices whose score (the busiest block's ring chunks,
    tiles a block times chunks a slice, and MERGE_CHUNKS for a split) is
    within FEWER_SLICES of the least, each slice a multiple of SLICE_STEP
    and its staged rows within STAGED_BYTES, every slice given blocks of
    its own, at most MAX_TILES tiles a block."""
    T = N // TILE_FEATURES
    options = []
    for ks in range(1, min(MAX_SLICES, blocks) + 1):
        if K % (SLICE_STEP * ks) or K // ks > _slice_cols_max(rows):
            continue
        groups = [blocks * (s + 1) // ks - blocks * s // ks for s in range(ks)]
        tiles = _cdiv(T, min(groups))
        if tiles <= MAX_TILES:
            score = tiles * _cdiv(K // ks, STAGE_COLS) + (MERGE_CHUNKS if ks > 1 else 0)
            options.append((score, ks, groups))
    if not options:
        raise ValueError(f"layer_launch_plan: no K-slices of {K} fit {blocks} blocks")
    least = min(o[0] for o in options)
    _, ks, groups = next(o for o in options if o[0] <= FEWER_SLICES * least)
    # runs of ceil(i T / m): where the tiles are fewer than the blocks, the
    # last blocks of a slice idle and block 0 (the phase clock's) works
    assign = tuple((s, _cdiv(i * T, m), _cdiv((i + 1) * T, m)) for s, m in enumerate(groups)
                   for i in range(m))
    return PhasePlan(name, N, K, ks, K // ks, assign)


def _region_bytes(rows: int, width: int, widest: int, tiles: int, group: int, Tk: int,
                  n_ctx: int, cross_stages: int) -> int:
    """The shared memory after the weight ring: the largest of the staged
    rows (``widest`` columns) with the warps' two sets of f32 tiles, the
    LayerNorm's scale and offset, its input rows [B, D] and the block's
    ``tiles`` tile sums, the self scores [n_ctx] f32 with a head's V rows
    [n_ctx, 64] bf16, and the cross ring with the cross scores [G, Tk]
    f32."""
    act = (_staged_rows(rows) * (2 * widest + 16) + 2 * RED_BYTES + LN_BYTES + rows * width * 2
           + tiles * TILE_SUM_BYTES)
    cross = cross_stages * CROSS_ROWS * Tk * 2 + group * Tk * 4
    return max(act, 16 * _cdiv(n_ctx, 4) + 128 * n_ctx, cross)


@functools.lru_cache(maxsize=None)
def layer_launch_plan(rows: int, d_model: int, blocks: int, group: int, Tk: int,
                      n_ctx: int) -> LayerPlan:
    """The bf16 kernel's plan for a step of ``rows`` rows at width
    ``d_model`` on a grid of ``blocks`` (one a SM)."""
    D = d_model
    shapes = ((3 * D, D), (D, D), (D, D), (D, D), (4 * D, D), (D, 4 * D))
    phases = tuple(_phase_plan(name, N, K, blocks, rows)
                   for name, (N, K) in zip(PROJECTIONS, shapes))
    widest = max(ph.width for ph in phases)
    tiles = max(t1 - t0 for ph in phases for _, t0, t1 in ph.blocks)
    cross_stages = MIN_CROSS_STAGES
    for c in range(MAX_CROSS_STAGES, MIN_CROSS_STAGES, -1):
        if (SMEM_LIMIT - _region_bytes(rows, D, widest, tiles, group, Tk, n_ctx, c)
                >= WANT_STAGES * STAGE_BYTES):
            cross_stages = c
            break
    region = _region_bytes(rows, D, widest, tiles, group, Tk, n_ctx, cross_stages)
    stages = min(MAX_STAGES, (SMEM_LIMIT - region) // STAGE_BYTES)
    if stages < MIN_STAGES:
        raise ValueError(f"layer_launch_plan: {region} bytes leave no room for the weight ring")
    return LayerPlan(
        phases, stages, cross_stages, 2 * widest + 16, stages * STAGE_BYTES + region,
        max(ph.features * ph.slices for ph in phases) * rows,
        max(ph.features // TILE_FEATURES * ph.slices for ph in phases),
    )


def _smem_bytes(rows: int, d_model: int, itemsize: int, group: int, Tk: int, n_ctx: int) -> int:
    """The kernel's dynamic shared memory at its least.  f32: the largest of
    the staged rows [B, 4D], the cross scores [G, Tk] f32 and the self
    scores [n_ctx] f32.  bf16: MIN_STAGES of the weight ring and the
    largest phase's region at the widest K-slice, the most tiles a block
    and the shallowest cross ring (a plan takes no more)."""
    if itemsize == 4:
        return max(rows * 4 * d_model * itemsize, group * Tk * 4, n_ctx * 4)
    return MIN_STAGES * STAGE_BYTES + _region_bytes(
        rows, d_model, _slice_cols_max(rows), MAX_TILES, group, Tk, n_ctx, MIN_CROSS_STAGES)


def layer_kernel_takes(rows: int, group: int, head_dim: int, Tk: int, n_ctx: int,
                       d_model: int, itemsize: int) -> bool:
    """Whether the whole-step kernel takes a step of ``rows`` rows in groups
    of ``group``: head dim 64, at most 16 rows, groups of 1, 2, 4 or 8,
    Tk % 4 = 0, its shared memory within a block's, and in bf16 a width of
    at most MAX_WIDTH."""
    return (head_dim == HEAD_DIM and rows <= MAX_ROWS and group in GROUPS and Tk % 4 == 0
            and (itemsize == 4 or d_model <= MAX_WIDTH)
            and _smem_bytes(rows, d_model, itemsize, group, Tk, n_ctx) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def _device_plan(rows: int, d_model: int, group: int, Tk: int, n_ctx: int, device):
    """The plan for the device's SMs and its int32 table on the device:
    [6][2] (slices, width), then [6][blocks][3] (slice, t0, t1)."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    plan = layer_launch_plan(rows, d_model, blocks, group, Tk, n_ctx)
    table = [v for ph in plan.phases for v in (ph.slices, ph.width)]
    table += [v for ph in plan.phases for block in ph.blocks for v in block]
    return blocks, plan, torch.tensor(table, dtype=torch.int32, device=device)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, K] times w [N, K] (an ``nn.Linear`` weight) transposed, summed
    in f32 and rounded to a's dtype (the Pallas kernel's ``_dot``)."""
    return (a.float() @ w.float().T).to(a.dtype)


def _check_args(name, x, weights, cross_kv, k_cache, v_cache, pos, key_start, n_head, group,
                window):
    B, D = x.shape
    L, B2, H, n_ctx, dh = k_cache.shape
    if (B2, H, dh) != (B, n_head, D // n_head) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, caches {tuple(k_cache.shape)} and "
            f"{tuple(v_cache.shape)}, n_head {n_head}"
        )
    if group < 1 or B % group:
        raise ValueError(f"{name}: {B} rows are not groups of {group}")
    A = B // group
    if cross_kv.shape[:5] != (L, A, H, 2, dh):
        raise ValueError(f"{name}: cross_kv {tuple(cross_kv.shape)}, want ({L}, {A}, {H}, 2, "
                         f"{dh}, Tk)")
    if len(weights.layers) != L:
        raise ValueError(f"{name}: {len(weights.layers)} layers of weights for {L} of cache")
    if not 1 <= window <= n_ctx:
        raise ValueError(f"{name}: needs 1 <= window ({window}) <= n_ctx ({n_ctx})")
    if not torch.is_tensor(pos) and not 0 <= pos < window:
        raise ValueError(f"{name}: needs 0 <= pos ({pos}) < window ({window})")
    if key_start is not None and key_start.shape != (B,):
        raise ValueError(f"{name}: key_start {tuple(key_start.shape)}, want ({B},)")
    return step_pos(pos, x.device)


def decoder_step_fused_plain(
    x: torch.Tensor, weights: DecoderStepWeights, cross_kv: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos, key_start=None, *,
    n_head: int, group: int, window: int,
) -> torch.Tensor:
    """Plain version, layer by layer, rounding where the kernel rounds;
    writes each layer's K/V column into the caches at ``pos`` (an int or a
    0-d int64 tensor) in place and returns the final x [B, D].  A tensor
    ``pos`` outside [0, window) is no step: nothing is written, and x comes
    back as it went in, as from the kernel."""
    at = _check_args("decoder_step_fused", x, weights, cross_kv, k_cache, v_cache, pos,
                     key_start, n_head, group, window)
    slot = _write_slot(at, window)
    x_in = x
    B, D = x.shape
    H, dh = n_head, D // n_head
    A = B // group
    scale = dh**-0.5
    ids = torch.arange(window, device=x.device)
    visible = (ids <= at).expand(B, window)
    if key_start is not None:
        visible = visible & (ids[None, :] >= key_start[:, None])
    visible = visible | (ids == at)  # this step's column is always seen
    for layer, (ln1_w, ln1_b, wq, bq, wk, wv, bv, wo, bo, ln2_w, ln2_b, wcq, bcq, wco, bco,
                ln3_w, ln3_b, w1, b1, w2, b2) in enumerate(weights.layers):
        h = ln_fused_plain(x, ln1_w, ln1_b)
        q = (_dot(h, wq) + bq) * scale
        write_column(k_cache, layer, slot, _dot(h, wk).view(B, H, dh))
        write_column(v_cache, layer, slot, (_dot(h, wv) + bv).view(B, H, dh))
        kk = k_cache[layer, :, :, :window].float()  # [B, H, W, dh]
        vv = v_cache[layer, :, :, :window].float()
        s = torch.einsum("bhd,bhwd->bhw", q.view(B, H, dh).float(), kk)
        s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhw,bhwd->bhd", e, vv) / e.sum(dim=-1)[..., None]
        x = x + (_dot(o.to(x.dtype).reshape(B, D), wo) + bo)

        h = ln_fused_plain(x, ln2_w, ln2_b)
        c = ((_dot(h, wcq) + bcq) * scale).view(A, group, H, dh)
        kv = cross_kv[layer]  # [A, H, 2, dh, Tk]
        s = torch.einsum("aghd,ahdk->aghk", c.float(), kv[:, :, 0].float())
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = (e / e.sum(dim=-1, keepdim=True)).to(x.dtype).float()
        o = torch.einsum("aghk,ahdk->aghd", w, kv[:, :, 1].float()).to(x.dtype)
        x = x + (_dot(o.reshape(B, D), wco) + bco)

        h = ln_fused_plain(x, ln3_w, ln3_b)
        x = x + (_dot(gelu(_dot(h, w1) + b1), w2) + b2)
    return torch.where((at >= 0) & (at < window), x, x_in)


def decoder_step_fused(
    x: torch.Tensor, weights: DecoderStepWeights, cross_kv: torch.Tensor,
    k_cache: torch.Tensor, v_cache: torch.Tensor, pos, key_start=None, *,
    n_head: int, group: int, window: int, clock=None,
) -> torch.Tensor:
    """One incremental step through every decoder layer: the kernel on the
    card (one launch), the plain version on the CPU.  Writes each layer's
    K/V column into the caches at ``pos`` in place; returns x [B, D].
    ``pos``, an int or a 0-d int64 tensor on x's device, is read by the
    kernel from device memory (a captured step reads its replay's); a
    tensor outside [0, window) is no step (nothing written, x returned).
    ``clock`` (card only, for measurements): an int64 tensor [8 L + 1]
    that receives the GPU clock in ns at the kernel's start and at the end
    of each of its eight phases a layer."""
    if x.device.type == "cpu":
        return decoder_step_fused_plain(
            x, weights, cross_kv, k_cache, v_cache, pos, key_start, n_head=n_head,
            group=group, window=window,
        )
    name = "decoder_step_fused"
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    at = _check_args(name, x, weights, cross_kv, k_cache, v_cache, pos, key_start, n_head,
                     group, window)
    B, D = x.shape
    L, _, H, n_ctx, dh = k_cache.shape
    Tk = cross_kv.shape[-1]
    if not layer_kernel_takes(B, group, dh, Tk, n_ctx, D, x.element_size()):
        raise ValueError(
            f"{name}: the kernel takes head dim {HEAD_DIM}, at most {MAX_ROWS} rows, groups of "
            f"{GROUPS}, Tk % 4 == 0, bf16 widths up to {MAX_WIDTH} and {SMEM_LIMIT} bytes of "
            f"shared memory a block; got D {D}, dh "
            f"{dh}, {B} rows, group {group}, Tk {Tk}, "
            f"{_smem_bytes(B, D, x.element_size(), group, Tk, n_ctx)} bytes"
        )
    tensors = [x, cross_kv, k_cache, v_cache]  # the weights were checked once, when built
    dtypes = [t.dtype for t in tensors] + [weights.layers[0][0].dtype]
    if x.dtype not in (torch.float32, torch.bfloat16) or any(d != x.dtype for d in dtypes):
        raise ValueError(f"{name}: every tensor must be f32 or bf16 alike, got {dtypes}")
    if key_start is not None and key_start.dtype != torch.int64:
        raise ValueError(f"{name}: key_start must be int64")
    if weights.table.shape != (L, len(WEIGHT_NAMES)) or weights.table.dtype != torch.int64:
        raise ValueError(f"{name}: weight table {tuple(weights.table.shape)}")
    if clock is not None and (clock.shape != (8 * L + 1,) or clock.dtype != torch.int64):
        raise ValueError(f"{name}: clock must be int64 [{8 * L + 1}]")
    extra = [t for t in (key_start, clock) if t is not None]
    for t in tensors + [weights.table] + extra:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned")

    out = x.clone()
    q = torch.empty_like(x)
    att = torch.empty_like(x)
    hid = torch.empty((B, 4 * D), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (
        weights.table.data_ptr(), cross_kv.data_ptr(),
        None if key_start is None else key_start.data_ptr(), out.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), q.data_ptr(), att.data_ptr(), hid.data_ptr(),
    )
    shape = (B, D, H, L, int(group), Tk, n_ctx, at.data_ptr(), int(window), dh**-0.5)
    if x.dtype == torch.bfloat16:
        blocks, plan, table = _device_plan(B, D, int(group), Tk, n_ctx, x.device)
        bar = torch.zeros(1 + plan.flags, dtype=torch.int32, device=x.device)  # and the flags
        part = torch.empty(plan.partial_floats, dtype=torch.float32, device=x.device)
        symbol = "decoder_step_bf16"
        fn = kernel_function("decoder_layer", symbol,
                             (P,) * 13 + (I,) * 7 + (P, I, F) + (I,) * 5 + (P,))
        err = fn(*args, bar.data_ptr(), None if clock is None else clock.data_ptr(),
                 part.data_ptr(), table.data_ptr(), *shape, blocks, plan.stages,
                 plan.cross_stages, plan.act_pitch, plan.smem, stream)
    else:
        bar = torch.zeros(1, dtype=torch.int32, device=x.device)
        symbol = "decoder_step_f32"
        fn = kernel_function("decoder_layer", symbol, (P,) * 11 + (I,) * 7 + (P, I, F, P))
        err = fn(*args, bar.data_ptr(), None if clock is None else clock.data_ptr(), *shape,
                 stream)
    check("decoder_layer", symbol, err)
    count_launch("decoder_step_fused")
    return out
