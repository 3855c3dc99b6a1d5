"""Whisper encoder and KV-cached decoder as ``nn.Module``s (counterpart of
``whisper_rs_tpu/models/whisper.py``).

Module and parameter names follow OpenAI's checkpoints
(``encoder.blocks.3.attn.query.weight``, ``mlp.0``/``mlp.2``, ...), so an
OpenAI state dict loads as it is.  The numerics are the JAX reference's:

  * LayerNorm in f32, cast back to the compute dtype;
  * GELU exact (erf) in f32 and the tanh form in half precision;
  * the conv stem as three shifted matmuls (no cuDNN, hence no TF32);
  * the attention scale ``head_dim**-0.5`` folded into q only;
  * f32 softmax; logits in f32 from an f32 cast of x and of the tied
    token embedding.

Every LayerNorm (the encoder's, with its residual adds, ``ln_post``, the
decoder's three a layer and its last) and the encoder's self-attention run
through the kernel wrappers of ``ops/`` (the plain versions when
``kernels=False``); every width-1 decoder pass takes the cross-attention
kernel of ``ops/decode_attention.py``.  An incremental greedy step
(``incremental=True``) takes one of three routes, ``step_kernel``:

  * ``"append"`` (the default): the append self-attention kernel, which
    writes the step's K/V column and masks by ``pos`` and ``key_start``
    itself (no additive mask is built), and the fused MLP kernel of
    ``ops/decoder_mlp_fused.py``;
  * ``"ctx"``: torch writes the K/V column, then the read-only fused
    self-attention kernel attends over the cache; the MLP as above (the
    JAX package's ``WHISPER_FUSED_SELF=ctx``);
  * ``"layer"``: after the embedding, one launch of the whole-step kernel
    of ``ops/decoder_layer_fused.py`` runs every layer, then the final
    LayerNorm and the logits (the JAX ``WHISPER_PALLAS_DECODE=layer``); a
    step whose shape ``layer_kernel_takes`` refuses takes the append route
    instead, as the JAX loop takes the layered step.

The encoder's self-attention takes the merged-layout kernel where
``ops.encoder_attention.merged_kernel_takes`` the shape, else the
split-layout one; on the card a kernel wrapper raises on a shape its
predicate refuses, and never runs its plain version (``ops/__init__.py``).

A beam step (``ancestors`` given) takes the beam self-attention kernel in
the append kernel's place: it writes the column the same way and reads
each slot from the row that the ancestor table names (gather at read; the
cache never moves); the other two routes are greedy only, as in the JAX
package.  Projections, the logits, the prefill's self-attention,
cross-attention and MLP stay ``torch.matmul``, as the JAX package left
them to XLA.

int8, as in the JAX package: ``models.quantize.quantize_params`` puts
``QuantLinear`` in every attention and MLP linear and ``QuantEmbedding``
for the token table (the MLP of a step then stays the two int8 linears
and GELU: the JAX package never sends int8 weights to its MLP kernel);
``KVCache.init(..., quantize=True)`` and ``precompute_cross_kv(...,
quantize=True)`` keep int8 K/V with f32 per-position scales
(``quantize_kv``).  With ``WHISPER_INT8_MATMUL=1`` (the JAX package's
switch, off by default, read at every call) an int8 linear also quantises
its input rows (``quantize_rows``) and runs an s8×s8→s32 product
(``int8_mm``: ``torch._int_mm`` on the card, exact integer sums on the
CPU), both scales in an f32 epilogue (``int8_dot``); the encoder's q, k
and v share one quantisation of their input.  The prefill and a beam step
write their quantised K/V and scales with ``KVCache.write``; a greedy step
hands its K/V column to
``self_attention_step`` (row 10) in the append kernel's place, which
quantises and writes it, then reads the int8 cache; a beam step reads it
through the beam kernel's int8 read; both take the cross kernel's int8
branch.  The ctx and layer
routes take no int8 cache, and the layer route no int8 weights: the JAX
package switches them off there.

Tensor parallelism (``parallel.sharding.shard_model``, the JAX package's
Megatron rules): each rank of the model group holds its shard of the
weights as plain tensors, and the modules call the collectives of
``parallel/collectives.py`` where GSPMD puts them.  q, k, v and fc1 are
split by output rows (heads and the 4D hidden split; their biases and int8
scales follow), attention out and fc2 by input columns, each followed by
one sum over the group (``row_linear``); conv1 by output channels and
conv2 by input channels, summed before its GELU; the tied token table by
vocab rows (padded to a multiple of the group), its lookup masked to the
rank's rows and summed, its logits gathered to the whole vocab before the
filters.  Head counts are the shard's
(``MultiHeadAttention.n_head``), never ``dims``'; the layer route takes no
split model.  ``AudioEncoder.stage_layers`` marks an encoder that holds one
pipeline stage's blocks (``parallel/pipeline.py`` runs it).

The KV cache is updated in place.  Its planes are ctx-major
``[L, B, H, n_ctx, dh]``; the cross K/V keeps the JAX fused layout
``[L, B, H, 2, dh, Tk]`` that the cross kernel reads.

An incremental step takes its position as a 0-d int64 tensor on the
device (an int is made into one), as the JAX loop's step takes a traced
``pos``: the positional row comes by ``index_select``, the torch column
writes by ``index_copy_`` (``ops.decode_attention.write_column``), and the
step kernels read the slot from device memory, so that nothing on the step
reads a device value on the host and the decode loop can capture the step
as a CUDA graph.  A position outside ``[0, n_ctx)`` (the decode loop's -1
for a step its termination test has turned off) writes no cache column;
that step's logits mean nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelDims
from ..ops.decode_attention import (
    beam_self_attention_step,
    beam_self_attention_step_plain,
    cross_attention_step,
    cross_attention_step_plain,
    quantize_kv,
    self_attention_append_step,
    self_attention_append_step_plain,
    self_attention_fused_step,
    self_attention_fused_step_plain,
    self_attention_step,
    step_pos,
    write_column,
    self_attention_step_plain,
)
from ..ops import count_launch
from ..ops.decoder_layer_fused import (
    decoder_step_fused,
    decoder_step_fused_plain,
    decoder_step_weights,
    layer_kernel_takes,
)
from ..ops.decoder_mlp_fused import decoder_mlp_step, decoder_mlp_step_plain, gelu
from ..ops.encoder_attention import (
    encoder_attention_merged,
    encoder_attention_merged_plain,
    encoder_attention_split,
    encoder_attention_split_plain,
    merged_kernel_takes,
)
from ..ops.encoder_fused import ln_fused, ln_fused_plain, residual_ln, residual_ln_plain
from ..parallel.collectives import all_gather_model, all_reduce_model


STEP_KERNELS = ("append", "ctx", "layer")  # an incremental greedy step's routes

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Sin/cos positional table, concatenated (not interleaved)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, dh]"""
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, dh] -> [B, T, D]"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def conv1d_mm(x: torch.Tensor, conv: nn.Conv1d, stride: int, bias: bool = True) -> torch.Tensor:
    """k=3, pad=1 conv1d as three shifted matmuls: x [B, T, C_in] ->
    [B, T // stride, C_out]; tap j adds ``shift(x, j - 1) @ W[:, :, j].T``;
    the bias last (none with ``bias=False``)."""
    w = conv.weight.to(x.dtype)  # [C_out, C_in, 3]
    T = x.shape[1]
    T_out = T // stride
    xp = F.pad(x, (0, 0, 1, 1))  # [B, T + 2, C_in]
    y = None
    for j in range(3):
        xj = xp[:, j : j + T : stride][:, :T_out]
        part = xj @ w[:, :, j].T
        y = part if y is None else y + part
    return y + conv.bias.to(x.dtype) if bias else y


def attend(q, k, v, mask, k_scale=None, v_scale=None) -> torch.Tensor:
    """q [B, H, Tq, dh] (scaled), k/v [B, H, Tk, dh], additive f32 mask
    broadcastable to [B, H, Tq, Tk]; f32 softmax, weights cast to q.dtype.
    int8 k/v take f32 per-position scales [B, H, Tk] (the JAX ``_attend``):
    the K scale on the scores before the mask, the V scale on the f32
    weights before their cast."""
    s = (q @ k.to(q.dtype).transpose(-1, -2)).float()
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    w = torch.softmax(s + mask, dim=-1)
    if v_scale is not None:
        w = w * v_scale[:, :, None, :]
    return w.to(q.dtype) @ v.to(q.dtype)


def attend_grouped(q, k_t, v_t, group: int, k_scale=None, v_scale=None) -> torch.Tensor:
    """Cross-attention where ``group`` rows per audio share one K/V:
    q [A*G, H, Tq, dh] (scaled), k_t/v_t [A, H, dh, Tk] (both transposed);
    int8 k_t/v_t take f32 per-position scales [A, H, Tk], applied as in
    ``attend``."""
    AG, H, Tq, dh = q.shape
    A = k_t.shape[0]
    qg = q.reshape(A, AG // A, H, Tq, dh)
    qk = torch.einsum("aghqd,ahdk->aghqk", qg, k_t.to(q.dtype)).float()
    if k_scale is not None:
        qk = qk * k_scale[:, None, :, None, :]
    w = torch.softmax(qk, dim=-1)
    if v_scale is not None:
        w = w * v_scale[:, None, :, None, :]
    w = w.to(q.dtype)
    return torch.einsum("aghqk,ahdk->aghqd", w, v_t.to(q.dtype)).reshape(AG, H, Tq, dh)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Static-shape self-attention cache, updated in place: k, v
    [L, B, H, n_ctx, dh], in the compute dtype, or int8 with f32
    per-position scales k_scale, v_scale [L, B, H, n_ctx]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(dims: ModelDims, batch: int, dtype, device, quantize: bool = False,
             n_head: Optional[int] = None) -> "KVCache":
        """Zeros in ``dtype``, or (``quantize``) int8 zeros with scales of
        one, as in the JAX package; ``n_head`` heads (a tensor-parallel
        shard's, ``TextDecoder.n_head``), by default ``dims.n_text_head``."""
        shape = (dims.n_text_layer, batch, n_head or dims.n_text_head, dims.n_text_ctx,
                 dims.head_dim)
        if not quantize:
            return KVCache(
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device),
            )
        planes = (torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2))
        scales = (torch.ones(shape[:-1], device=device) for _ in range(2))
        return KVCache(*planes, *scales)

    def reset(self) -> None:
        """Back to ``init``'s values, in place: zeros, and scales of one."""
        self.k.zero_()
        self.v.zero_()
        if self.quantized:
            self.k_scale.fill_(1.0)
            self.v_scale.fill_(1.0)

    def write(self, layer: int, start, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write k, v [B, H, T, dh] at slots ``start .. start + T`` of
        ``layer``; an int8 cache takes them quantised (``quantize_kv``),
        with their scales.  ``start`` a 0-d int64 tensor on the device (a
        step's, T = 1) writes by ``write_column``, and nothing where it lies
        outside [0, n_ctx)."""
        if torch.is_tensor(start):
            if k.shape[2] != 1:
                raise ValueError(f"a device start writes one column, not {k.shape[2]}")
            for plane, scale, new in ((self.k, self.k_scale, k), (self.v, self.v_scale, v)):
                new = new[:, :, 0]
                if self.quantized:
                    new, s = quantize_kv(new)
                    write_column(scale, layer, start, s)
                write_column(plane, layer, start, new)
            return
        slots = slice(start, start + k.shape[2])
        if self.quantized:
            k, self.k_scale[layer, :, :, slots] = quantize_kv(k)
            v, self.v_scale[layer, :, :, slots] = quantize_kv(v)
        self.k[layer, :, :, slots] = k
        self.v[layer, :, :, slots] = v


@dataclasses.dataclass
class CrossKV:
    """Per-window cross-attention K/V, computed once from the encoder
    output: ``kv [L, B, H, 2, dh, n_audio_ctx]``, plane 0 K^T, plane 1 V^T;
    int8 with f32 per-position scales k_scale, v_scale [L, B, H,
    n_audio_ctx], or in the compute dtype without them."""

    kv: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# torch._int_mm on the card refuses M <= 16 in some releases: fewer rows are
# padded with zero rows to this many (their int32 sums are exact and dropped)
INT_MM_MIN_ROWS = 17


def int8_matmul_enabled() -> bool:
    """``WHISPER_INT8_MATMUL=1``: the int8 linears run s8×s8→s32 products on
    dynamically quantised activation rows instead of casting their weights
    (the JAX ``_int8_matmul_enabled``; off by default until
    ``tools.validate_checkpoint`` passes its ΔWER gate on real weights)."""
    return os.environ.get("WHISPER_INT8_MATMUL", "0") == "1"


def quantize_rows(x: torch.Tensor):
    """[..., K] -> (int8 [..., K], f32 scale [..., 1]): one symmetric scale a
    row, ``s = max(amax |row|, 1e-8) / 127`` and ``clip(round(x / s), -127,
    127)`` rounded half to even (the JAX ``_quantize_rows``, which is
    ``quantize_kv`` with the scale's trailing 1)."""
    xq, scale = quantize_kv(x)
    return xq, scale[..., None]


def int8_mm_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq int8 [M, K] @ w int8 [N, K]^T -> int32 [M, N], exactly: a float64
    product, whose sums of at most 127^2 K stay below 2^53."""
    return (xq.double() @ w.double().T).to(torch.int32)


def int8_mm(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The s8×s8→s32 product of ``int8_mm_plain``: on the card
    ``torch._int_mm(xq, w.T)`` (cuBLASLt; ``w.T`` is the column-major [K, N]
    operand it takes, no copy), with fewer than INT_MM_MIN_ROWS rows padded
    by zero rows; on the CPU the plain version.  Raises on the card where K
    or N is not a multiple of 8, and on any other device."""
    if xq.device.type == "cpu":
        return int8_mm_plain(xq, w)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_mm: unsupported device {xq.device}")
    if xq.shape[1] % 8 or w.shape[0] % 8:
        raise ValueError(f"int8_mm: K {xq.shape[1]} and N {w.shape[0]} must be multiples of 8 "
                         "on the card")
    return int_mm_rows(xq, w)


def int_mm_rows(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(xq, w.T)``, fewer than INT_MM_MIN_ROWS rows padded with
    zero rows and sliced off again."""
    M = xq.shape[0]
    if M < INT_MM_MIN_ROWS:
        return torch._int_mm(F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - M)), w.T)[:M]
    return torch._int_mm(xq, w.T)


def int8_dot(xq: torch.Tensor, s_x: torch.Tensor, lin: "QuantLinear",
             out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 linear on quantised rows (``quantize_rows``): the int32 sums
    of ``int8_mm``, then ``acc * s_x * s_w (+ b)`` in f32, in the JAX
    ``_int8_dot``'s order, cast to ``out_dtype``."""
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), lin.weight)
    y = acc.view(*xq.shape[:-1], -1).float() * s_x * lin.scale.float()
    if lin.bias is not None:
        y = y + lin.bias.float()
    return y.to(out_dtype)


class QuantLinear(nn.Module):
    """An int8 weight-only linear, in ``nn.Linear``'s place where
    ``models.quantize.quantize_params`` puts it (the JAX ``linear`` with an
    ``"s"`` leaf): ``weight`` int8 [out, in], ``scale`` [out], one per
    output channel, and ``bias`` in the compute dtype, all parameters
    without gradient (``.to(dtype)`` leaves the weight int8).  In the JAX
    order: ``x @ w.to(x.dtype).T``, then ``* s.to(x.dtype)``, then
    ``+ b.to(x.dtype)``; with ``int8_matmul_enabled()``, ``int8_dot`` on
    ``x``'s quantised rows."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = _frozen(torch.empty(out_features, in_features, dtype=torch.int8))
        self.scale = _frozen(torch.empty(out_features))
        self.bias = _frozen(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if int8_matmul_enabled():
            return int8_dot(*quantize_rows(x), self, x.dtype)
        y = (x @ self.weight.to(x.dtype).T) * self.scale.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class QuantEmbedding(nn.Module):
    """The int8 token table in ``nn.Embedding``'s place (the JAX
    ``token_emb`` with ``token_emb_scale``): ``weight`` int8 [V, D] and
    ``scale`` [V], one per row; ``TextDecoder`` reads both."""

    def __init__(self, n_vocab: int, n_state: int):
        super().__init__()
        self.weight = _frozen(torch.empty(n_vocab, n_state, dtype=torch.int8))
        self.scale = _frozen(torch.empty(n_vocab))


def row_linear(lin: nn.Module, x: torch.Tensor, mesh) -> torch.Tensor:
    """A linear split by input columns over the model group of ``mesh``: the
    rank's partial product, then the sum over the group.  The bias of an
    ``nn.Linear`` joins the first rank's product (``F.linear`` with it, so
    one rank gives the unsplit linear bit for bit); an int8 linear takes
    its scale and bias after the sum (GSPMD's order: the psum right after
    the dot), and under ``int8_matmul_enabled()`` quantises x's rows with
    their amax over the whole row (a max over the group) and sums the exact
    int32 products, which gives the unsplit linear's result bit for bit.
    Without a group (``mesh`` None, or one rank and no group) it is
    ``lin(x)``."""
    if mesh is None or (mesh.n_model == 1 and mesh.model_group is None):
        return lin(x)
    if not isinstance(lin, QuantLinear):
        return all_reduce_model(F.linear(x, lin.weight, lin.bias if mesh.model == 0 else None),
                                mesh)
    if int8_matmul_enabled():
        xf = x.float()
        s_x = all_reduce_model(xf.abs().amax(dim=-1), mesh, op="max").clamp(min=1e-8) / 127.0
        xq = torch.round(xf / s_x[..., None]).clamp(-127, 127).to(torch.int8)
        acc = all_reduce_model(int8_mm(xq.reshape(-1, xq.shape[-1]), lin.weight), mesh)
        y = acc.view(*x.shape[:-1], -1).float() * s_x[..., None] * lin.scale.float()
        if lin.bias is not None:
            y = y + lin.bias.float()
        return y.to(x.dtype)
    y = all_reduce_model(x @ lin.weight.to(x.dtype).T, mesh) * lin.scale.to(x.dtype)
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head  # a tensor-parallel shard's own (parallel.sharding)
        self.head_dim = n_state // n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def encoder_self(self, x_ln: torch.Tensor, kernels: bool, tp=None) -> torch.Tensor:
        """Full non-causal self-attention (the encoder's), routed as the JAX
        encoder routes it: on merged heads where ``merged_kernel_takes`` the
        shape (head dim 64, an even head count), else on split heads
        ([B, T, D] -> [B, H, T, dh] and back; views, which the split kernel
        reads at their strides).  Int8 q, k and v linears under
        ``int8_matmul_enabled()`` share one quantisation of ``x_ln`` (the
        JAX ``_int8_qkv``).  Under tensor parallelism (``tp``, the mesh) the
        heads are the shard's and the out projection is ``row_linear``."""
        H, dh = self.n_head, self.head_dim
        qkv = (self.query, self.key, self.value)
        if all(isinstance(m, QuantLinear) for m in qkv) and int8_matmul_enabled():
            xq, s_x = quantize_rows(x_ln)
            q, k, v = (int8_dot(xq, s_x, m, x_ln.dtype) for m in qkv)
        else:
            q, k, v = (m(x_ln) for m in qkv)
        if merged_kernel_takes(H, dh):
            fn = encoder_attention_merged if kernels else encoder_attention_merged_plain
            return row_linear(self.out, fn(q, k, v, H, dh**-0.5), tp)
        fn = encoder_attention_split if kernels else encoder_attention_split_plain
        out = fn(*(split_heads(t, H) for t in (q, k, v)), dh**-0.5)
        return row_linear(self.out, merge_heads(out), tp)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        self.cross_attn = MultiHeadAttention(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = nn.LayerNorm(n_state) if cross_attention else None
        self.mlp = nn.Sequential(
            nn.Linear(n_state, 4 * n_state), nn.GELU(), nn.Linear(4 * n_state, n_state)
        )
        self.mlp_ln = nn.LayerNorm(n_state)
        self.tp = None  # the mesh, where the block is split (parallel.sharding)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return row_linear(self.mlp[2], gelu(self.mlp[0](h)), self.tp)

    def encoder_forward(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        """Encoder block: LN kernel, merged-head attention kernel, fused
        residual+LN kernel, then the MLP (JAX ``encoder_block_fn``)."""
        ln, res_ln = (ln_fused, residual_ln) if kernels else (ln_fused_plain, residual_ln_plain)
        a = ln(x, self.attn_ln.weight, self.attn_ln.bias)
        x, h = res_ln(
            x, self.attn.encoder_self(a, kernels, self.tp), self.mlp_ln.weight, self.mlp_ln.bias
        )
        return x + self._mlp(h)

    def decoder_forward(
        self, x, layer: int, pos_offset, mask, window: int, cross_kv: CrossKV,
        cache: KVCache, cross_group: int, kernels: bool, key_start=None, anc_local=None,
        step_kernel: str = "append", cross_logits: Optional[dict] = None,
    ) -> torch.Tensor:
        """One decoder block.  ``mask`` None marks an incremental step: the
        append kernel (the beam kernel with ``anc_local``, [B, n_ctx] int32
        beam-local ancestors; over an int8 cache ``self_attention_step``,
        which quantises it) writes the K/V column and masks by
        ``pos_offset`` and ``key_start``, or (``step_kernel="ctx"``, or a
        beam step over an int8 cache) torch writes the column and a
        read-only kernel attends (the fused kernel, or the beam kernel's
        int8 read); the MLP takes the fused kernel unless its weights are
        int8.  A prefill pass whose ``cross_logits`` holds ``layer`` sets it
        to the block's pre-softmax cross-attention logits [B, H, T, Tk] from
        f32 products (q and k upcast, as ``preferred_element_type=f32``)."""
        B, T, _ = x.shape
        H, dh = self.attn.n_head, self.attn.head_dim
        scale = dh**-0.5
        scales = {"k_scale": cache.k_scale, "v_scale": cache.v_scale} if cache.quantized else {}

        ln = ln_fused if kernels else ln_fused_plain
        # self-attention over the cache (this step's K/V written first)
        h = ln(x, self.attn_ln.weight, self.attn_ln.bias)
        if mask is None:
            hs = h[:, 0]
            q = (self.attn.query(hs) * scale).view(B, H, dh)
            k_new, v_new = self.attn.key(hs).view(B, H, dh), self.attn.value(hs).view(B, H, dh)
            read = (q, cache.k, cache.v, layer, pos_offset, key_start)
            if (cache.quantized and anc_local is not None) or step_kernel == "ctx":
                cache.write(layer, pos_offset, k_new[:, :, None], v_new[:, :, None])
            if anc_local is not None:
                fn = beam_self_attention_step if kernels else beam_self_attention_step_plain
                new = (None, None) if cache.quantized else (k_new, v_new)
                attn = fn(q, *new, *read[1:], anc_local, cross_group, window=window, **scales)
            elif cache.quantized:
                fn = self_attention_step if kernels else self_attention_step_plain
                attn = fn(*read, window=window, **scales, k_new=k_new, v_new=v_new)
            elif step_kernel == "ctx":
                fn = self_attention_fused_step if kernels else self_attention_fused_step_plain
                attn = fn(*read, window=window)
            else:
                fn = self_attention_append_step if kernels else self_attention_append_step_plain
                attn = fn(q, k_new, v_new, *read[1:], window=window)
            attn = attn.reshape(B, 1, H * dh)
        else:
            q = split_heads(self.attn.query(h), H) * scale
            cache.write(layer, pos_offset, split_heads(self.attn.key(h), H),
                        split_heads(self.attn.value(h), H))
            attn = merge_heads(attend(
                q, cache.k[layer, :, :, :window], cache.v[layer, :, :, :window], mask,
                **{k: s[layer, :, :, :window] for k, s in scales.items()},
            ))
        x = x + row_linear(self.attn.out, attn, self.tp)

        # cross-attention against the precomputed encoder K/V
        h = ln(x, self.cross_attn_ln.weight, self.cross_attn_ln.bias)
        qx = split_heads(self.cross_attn.query(h), H) * scale
        cross_scales = {}
        if cross_kv.k_scale is not None:
            cross_scales = {"k_scale": cross_kv.k_scale, "v_scale": cross_kv.v_scale}
        if T == 1:
            fn = cross_attention_step if kernels else cross_attention_step_plain
            attn = fn(
                qx[:, :, 0, :].reshape(B // cross_group, cross_group, H, dh).contiguous(),
                cross_kv.kv, layer, **cross_scales,
            ).reshape(B, H, 1, dh)
        else:
            kv = cross_kv.kv[layer]
            if cross_logits is not None and layer in cross_logits:
                cross_logits[layer] = torch.einsum("bhqd,bhdk->bhqk", qx.float(),
                                                   kv[:, :, 0].float())
            attn = attend_grouped(qx, kv[:, :, 0], kv[:, :, 1], cross_group,
                                  **{k: s[layer] for k, s in cross_scales.items()})
        x = x + row_linear(self.cross_attn.out, merge_heads(attn), self.tp)

        h = ln(x, self.mlp_ln.weight, self.mlp_ln.bias)
        if mask is not None or isinstance(self.mlp[0], QuantLinear):
            return x + self._mlp(h)
        fn = decoder_mlp_step if kernels else decoder_mlp_step_plain
        out = fn(h[:, 0], self.mlp[0].weight, self.mlp[0].bias, self.mlp[2].weight)
        out = all_reduce_model(out, self.tp)
        return x + (out + self.mlp[2].bias.to(out.dtype))[:, None, :]


class AudioEncoder(nn.Module):
    def __init__(self, n_mels: int, n_ctx: int, n_state: int, n_head: int, n_layer: int):
        super().__init__()
        self.conv1 = nn.Conv1d(n_mels, n_state, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(n_state, n_state, kernel_size=3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding", torch.from_numpy(sinusoids(n_ctx, n_state)),
            persistent=False,
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(n_state, n_head) for _ in range(n_layer)
        )
        self.ln_post = nn.LayerNorm(n_state)
        self.tp = None  # the mesh, where the stem is split (parallel.sharding)
        self.stage_layers = None  # (first, end) of a pipeline stage's blocks

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, 3000] -> [B, 1500, n_state]: the conv stem (conv2's
        partial sums summed over the model group, before its bias and
        GELU, where it is split) and the positional table."""
        x = mel.transpose(1, 2)  # [B, 3000, n_mels]
        x = gelu(conv1d_mm(x, self.conv1, stride=1))
        if self.tp is None:
            x = gelu(conv1d_mm(x, self.conv2, stride=2))
        else:
            x = all_reduce_model(conv1d_mm(x, self.conv2, stride=2, bias=False), self.tp)
            x = gelu(x + self.conv2.bias.to(x.dtype))
        return (x + self.positional_embedding.to(x.dtype)).contiguous()

    def forward(self, mel: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """[B, n_mels, 3000] log-mel -> [B, 1500, n_state]."""
        if self.stage_layers is not None:
            raise ValueError(f"this encoder holds the blocks {self.stage_layers} of one pipeline "
                             "stage: run it with parallel.pipeline.encoder_forward_pp")
        x = self.stem(mel)
        for block in self.blocks:
            x = block.encoder_forward(x, kernels)
        ln = ln_fused if kernels else ln_fused_plain
        return ln(x, self.ln_post.weight, self.ln_post.bias)


class TextDecoder(nn.Module):
    def __init__(self, n_vocab: int, n_ctx: int, n_state: int, n_head: int, n_layer: int):
        super().__init__()
        self.token_embedding = nn.Embedding(n_vocab, n_state)
        self.positional_embedding = nn.Parameter(torch.empty(n_ctx, n_state))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(n_state, n_head, cross_attention=True)
            for _ in range(n_layer)
        )
        self.ln = nn.LayerNorm(n_state)
        self.n_vocab = n_vocab
        self.tp = None  # the mesh, where the decoder is split (parallel.sharding)

    @property
    def n_head(self) -> int:
        """Heads a layer holds: a tensor-parallel shard's own."""
        return self.blocks[0].attn.n_head

    def embed(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """Token embeddings [..., D] in ``dtype`` (an int8 table dequantised
        row by row).  A vocab-split table looks up the rank's own rows,
        zeros elsewhere, and sums over the model group: exactly one rank
        holds each token."""
        W = self.token_embedding.weight
        scale = getattr(self.token_embedding, "scale", None)  # int8 table
        if self.tp is not None:
            local = tokens - self.tp.model * W.shape[0]
            inside = (local >= 0) & (local < W.shape[0])
            tokens = local.clamp(0, W.shape[0] - 1)
        emb = W[tokens].to(dtype)
        if scale is not None:
            emb = emb * scale[tokens][..., None].to(dtype)
        if self.tp is None:
            return emb
        return all_reduce_model(torch.where(inside[..., None], emb, torch.zeros_like(emb)),
                                self.tp)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits ``x @ W^T`` of the tied table (an int8 table's rows
        scaled after the product); a vocab-split table's are gathered over
        the model group and cut to ``n_vocab`` (its pad rows dropped)."""
        W = self.token_embedding.weight
        scale = getattr(self.token_embedding, "scale", None)
        logits = x.float() @ W.float().T
        if scale is not None:
            logits = logits * scale.float()
        if self.tp is None:
            return logits
        return all_gather_model(logits, self.tp, dim=-1)[..., : self.n_vocab]

    @staticmethod
    def _mask(q_pos: torch.Tensor, W: int, key_start) -> torch.Tensor:
        """Additive f32 mask [1 or B, 1, T, W] of the prefill path."""
        key_idx = torch.arange(W, device=q_pos.device)
        visible = key_idx[None, :] <= q_pos[:, None]  # [T, W]
        if key_start is not None:
            visible = visible[None] & (
                (key_idx[None, None, :] >= key_start[:, None, None])
                | (key_idx[None, :] == q_pos[:, None])[None]
            )
            visible = visible[:, None]  # [B, 1, T, W]
        else:
            visible = visible[None, None]  # [1, 1, T, W]
        return torch.zeros(visible.shape, dtype=torch.float32, device=q_pos.device).masked_fill(
            ~visible, float("-inf")
        )

    def check_route(self, step_kernel: str, *, incremental: bool = True, beam: bool = False,
                    int8_kv: bool = False) -> None:
        """Raise ``ValueError`` where a pass cannot take ``step_kernel``: an
        unknown route; ctx or layer outside an incremental greedy step, or
        over int8 K/V; layer over int8 weights or a tensor-parallel model.  The JAX package
        switches both routes off under int8 K/V and the layer route under
        int8 weights (``decode/loop.py``, ``models/whisper.py``)."""
        if step_kernel not in STEP_KERNELS:
            raise ValueError(f"step_kernel must be one of {STEP_KERNELS}, not {step_kernel!r}")
        if step_kernel == "append":
            return
        if not incremental:
            raise ValueError(f"step_kernel {step_kernel!r} is an incremental step's route")
        if beam:
            raise ValueError(f"step_kernel {step_kernel!r} is greedy only: a beam step "
                             "(ancestors) takes the append route")
        if int8_kv:
            raise ValueError(f"step_kernel {step_kernel!r} takes no int8 K/V: an int8 cache "
                             "takes the append route")
        if step_kernel == "layer" and any(
                isinstance(m, QuantLinear) for m in self.blocks.modules()):
            raise ValueError("step_kernel 'layer' takes no int8 weights (quantize_params)")
        if step_kernel == "layer" and self.tp is not None:
            raise ValueError("step_kernel 'layer' takes no tensor-parallel model: the whole-step "
                             "kernel cannot sum a layer's partial products over the model group")

    def forward(
        self,
        tokens: torch.Tensor,  # [B, T] (prefill width T, or 1 for a step)
        pos_offset,  # absolute position of tokens[:, 0]; a step's: int or 0-d int64 tensor
        cross_kv: CrossKV,
        cache: KVCache,
        *,
        key_start: Optional[torch.Tensor] = None,  # [B] first valid cache slot
        logit_positions: Optional[torch.Tensor] = None,  # [K] rows of T to project
        cross_group: int = 1,
        ctx_window: Optional[int] = None,  # cap on attended cache slots
        kernels: bool = True,
        incremental: bool = False,  # a step: the append (or beam) and MLP kernels
        ancestors: Optional[torch.Tensor] = None,  # [B, n_ctx] int32 beam-local (beam)
        step_kernel: str = "append",  # an incremental step's route: append, ctx, layer
        step_weights=None,  # DecoderStepWeights of the "layer" route, built once
        cross_logits: Optional[dict] = None,  # layer -> a prefill's f32 cross logits
    ) -> torch.Tensor:
        """One decoder pass; returns f32 logits [B, T (or K), n_vocab] and
        updates ``cache`` in place.

        A query at absolute position p sees cache slots <= p.  With
        ``key_start`` (end-aligned per-row prompts) slots below it are
        hidden, each row's positional index shifts so its first real token
        sits at 0, and a pad query keeps its own slot visible so its softmax
        row is never empty (no NaN).  An ``incremental`` step (T = 1, after
        the prefill, so ``pos_offset >= key_start``) builds no mask: the
        append kernel masks by position itself.

        ``ancestors`` (an incremental beam step, rows in groups of
        ``cross_group`` beams) names for each row b and slot j the beam of
        b's audio whose row holds that K/V (physical row ``b - b % G +
        ancestors[b, j]``); its column ``pos_offset`` must be ``b % G``.
        The step then takes the beam kernel, which masks by the key_start
        of each audio's first row.

        ``step_kernel`` picks an incremental greedy step's route (see the
        module docstring): ``"append"``, ``"ctx"`` or ``"layer"``; the last
        reads ``step_weights`` (``ops.decoder_layer_fused.
        decoder_step_weights`` of ``self.blocks``), built here when None,
        and takes the append route where ``layer_kernel_takes`` refuses the
        step's shape (counted under ``"decoder_step_fused:append"`` when
        ``kernels`` on the card).
        Over an int8 cache the append route takes ``self_attention_step``
        in the append kernel's place, which quantises and writes the
        step's column itself; ctx and layer refuse it (``check_route``).

        An int8 token table (``QuantEmbedding``) is dequantised row by row
        for the embedding, and the logits ``x @ W^T`` of its int8 values
        are scaled per token after the product, in f32.

        A prefill given ``cross_logits`` (a dict keyed by layer) fills in
        each of those layers' pre-softmax cross-attention logits [B, H, T,
        Tk], from f32 products: the word aligner's teacher-forced pass."""
        B, T = tokens.shape
        dev = tokens.device
        n_ctx = self.positional_embedding.shape[0]
        W = n_ctx if ctx_window is None else min(ctx_window, n_ctx)
        if incremental:
            if T != 1:
                raise ValueError(f"an incremental step takes one token per row, not {T}")
            # the step's position on the device: its positional row by
            # index_select, never a read on the host
            pos_offset = step_pos(pos_offset, dev)
            if key_start is not None:
                pos_idx = (pos_offset - key_start).clamp(0, n_ctx - 1)  # [B]
                pos = self.positional_embedding.index_select(0, pos_idx)[:, None]
            else:
                pos = self.positional_embedding.index_select(
                    0, pos_offset.clamp(0, n_ctx - 1).view(1))
            mask = None
        else:
            q_pos = pos_offset + torch.arange(T, device=dev)
            if key_start is not None:
                pos_idx = (q_pos[None, :] - key_start[:, None]).clamp(min=0)  # [B, T]
                pos = self.positional_embedding[pos_idx]
            else:
                pos = self.positional_embedding[pos_offset : pos_offset + T]
            mask = self._mask(q_pos, W, key_start)
        if ancestors is not None and not incremental:
            raise ValueError("ancestors are read by an incremental step only")
        self.check_route(step_kernel, incremental=incremental, beam=ancestors is not None,
                         int8_kv=cache.quantized or cross_kv.k_scale is not None)

        dtype = self.positional_embedding.dtype
        x = self.embed(tokens, dtype) + pos.to(dtype)
        D = x.shape[-1]
        if step_kernel == "layer" and not layer_kernel_takes(
                B, cross_group, self.blocks[0].attn.head_dim, cross_kv.kv.shape[-1],
                cache.k.shape[3], D, x.element_size()):
            if kernels and dev.type != "cpu":
                count_launch("decoder_step_fused:append")
            step_kernel = "append"
        if step_kernel == "layer":
            if step_weights is None:
                step_weights = decoder_step_weights(self.blocks)
            fn = decoder_step_fused if kernels else decoder_step_fused_plain
            x = fn(
                x[:, 0].contiguous(), step_weights, cross_kv.kv, cache.k, cache.v, pos_offset,
                key_start, n_head=self.blocks[0].attn.n_head, group=cross_group, window=W,
            )[:, None]
        else:
            for layer, block in enumerate(self.blocks):
                x = block.decoder_forward(
                    x, layer, pos_offset, mask, W, cross_kv, cache, cross_group, kernels,
                    key_start, ancestors, step_kernel, cross_logits,
                )
        if logit_positions is not None:
            x = x[:, logit_positions]  # a copy: contiguous, as ln_fused takes it
        ln = ln_fused if kernels else ln_fused_plain
        return self.logits(ln(x, self.ln.weight, self.ln.bias))


class Whisper(nn.Module):
    def __init__(self, dims: ModelDims):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(
            dims.n_mels, dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head,
            dims.n_audio_layer,
        )
        self.decoder = TextDecoder(
            dims.n_vocab, dims.n_text_ctx, dims.n_text_state, dims.n_text_head,
            dims.n_text_layer,
        )
        self.mesh = None  # the process mesh (parallel.sharding.shard_model)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.positional_embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device


# ---------------------------------------------------------------------------
# functional entry points (names of the JAX counterparts)
# ---------------------------------------------------------------------------


def encoder_forward(model: Whisper, mel: torch.Tensor, *, kernels: bool = True,
                    encoder_fn=None) -> torch.Tensor:
    """[B, n_mels, 3000] log-mel -> [B, 1500, n_state] audio features;
    ``encoder_fn(model, mel, kernels)`` in the encoder's place where given
    (``parallel``'s pipeline and Ulysses encoders)."""
    if encoder_fn is not None:
        return encoder_fn(model, mel, kernels)
    return model.encoder(mel, kernels=kernels)


def precompute_cross_kv(model: Whisper, xa: torch.Tensor, *, quantize: bool = False,
                        out: Optional[CrossKV] = None) -> CrossKV:
    """xa [B, Tk, D] -> the stacked cross K/V of every decoder layer; with
    ``quantize``, int8 with f32 per-position scales, each K and V
    quantised per position before the transpose (``quantize_kv``).  With
    ``out`` (a decode window's static buffers) it writes into those and
    returns them."""
    B, Tk, _ = xa.shape
    blocks = model.decoder.blocks
    H, dh = blocks[0].cross_attn.n_head, blocks[0].cross_attn.head_dim
    shape = (len(blocks), B, H, 2, dh, Tk)
    dtype = torch.int8 if quantize else xa.dtype
    if out is None:
        kv = torch.empty(shape, dtype=dtype, device=xa.device)
        k_scale = v_scale = None
        if quantize:
            k_scale, v_scale = torch.empty((2, len(blocks), B, H, Tk), device=xa.device)
    else:
        if (tuple(out.kv.shape) != shape or out.kv.dtype != dtype
                or (out.k_scale is not None) != quantize):
            raise ValueError(f"cross K/V buffers {tuple(out.kv.shape)} {out.kv.dtype} for "
                             f"{shape} {dtype}")
        kv, k_scale, v_scale = out.kv, out.k_scale, out.v_scale
    for layer, block in enumerate(blocks):
        for plane, proj in enumerate((block.cross_attn.key, block.cross_attn.value)):
            t = split_heads(proj(xa), H)  # [B, H, Tk, dh]
            if quantize:
                scale = (k_scale, v_scale)[plane]
                t, scale[layer] = quantize_kv(t)
            kv[layer, :, :, plane] = t.transpose(-1, -2)
    return CrossKV(kv) if k_scale is None else CrossKV(kv, k_scale, v_scale)


def decoder_forward(
    model: Whisper, tokens: torch.Tensor, pos_offset: int, cross_kv: CrossKV,
    cache: KVCache, **kwargs,
) -> torch.Tensor:
    """One decoder pass (see ``TextDecoder.forward``); updates ``cache``."""
    return model.decoder(tokens, pos_offset, cross_kv, cache, **kwargs)
