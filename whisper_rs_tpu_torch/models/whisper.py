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

The encoder's LayerNorms, residual adds and self-attention run through the
kernel wrappers of ``ops/`` (the plain versions when ``kernels=False``);
every width-1 decoder pass takes the cross-attention kernel of
``ops/decode_attention.py``.  An incremental greedy step
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
    LayerNorm and the logits (the JAX ``WHISPER_PALLAS_DECODE=layer``).

A beam step (``ancestors`` given) takes the beam self-attention kernel in
the append kernel's place: it writes the column the same way and reads
each slot from the row that the ancestor table names (gather at read; the
cache never moves); the other two routes are greedy only, as in the JAX
package.  Projections, the logits, the prefill's self-attention,
cross-attention and MLP stay ``torch.matmul``, as the JAX package left
them to XLA.

The KV cache is updated in place.  Its planes are ctx-major
``[L, B, H, n_ctx, dh]``; the cross K/V keeps the JAX fused layout
``[L, B, H, 2, dh, Tk]`` that the cross kernel reads.
"""

from __future__ import annotations

import dataclasses
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
    self_attention_append_step,
    self_attention_append_step_plain,
    self_attention_fused_step,
    self_attention_fused_step_plain,
)
from ..ops.decoder_layer_fused import (
    decoder_step_fused,
    decoder_step_fused_plain,
    decoder_step_weights,
)
from ..ops.decoder_mlp_fused import decoder_mlp_step, decoder_mlp_step_plain, gelu
from ..ops.encoder_attention import encoder_attention_merged, encoder_attention_merged_plain
from ..ops.encoder_fused import ln_fused, ln_fused_plain, residual_ln, residual_ln_plain


STEP_KERNELS = ("append", "ctx", "layer")  # an incremental greedy step's routes

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32, cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


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


def conv1d_mm(x: torch.Tensor, conv: nn.Conv1d, stride: int) -> torch.Tensor:
    """k=3, pad=1 conv1d as three shifted matmuls: x [B, T, C_in] ->
    [B, T // stride, C_out]; tap j adds ``shift(x, j - 1) @ W[:, :, j].T``."""
    w = conv.weight.to(x.dtype)  # [C_out, C_in, 3]
    T = x.shape[1]
    T_out = T // stride
    xp = F.pad(x, (0, 0, 1, 1))  # [B, T + 2, C_in]
    y = None
    for j in range(3):
        xj = xp[:, j : j + T : stride][:, :T_out]
        part = xj @ w[:, :, j].T
        y = part if y is None else y + part
    return y + conv.bias.to(x.dtype)


def attend(q, k, v, mask) -> torch.Tensor:
    """q [B, H, Tq, dh] (scaled), k/v [B, H, Tk, dh], additive f32 mask
    broadcastable to [B, H, Tq, Tk]; f32 softmax, weights cast to q.dtype."""
    w = torch.softmax((q @ k.transpose(-1, -2)).float() + mask, dim=-1)
    return w.to(q.dtype) @ v


def attend_grouped(q, k_t, v_t, group: int) -> torch.Tensor:
    """Cross-attention where ``group`` rows per audio share one K/V:
    q [A*G, H, Tq, dh] (scaled), k_t/v_t [A, H, dh, Tk] (both transposed)."""
    AG, H, Tq, dh = q.shape
    A = k_t.shape[0]
    qg = q.reshape(A, AG // A, H, Tq, dh)
    qk = torch.einsum("aghqd,ahdk->aghqk", qg, k_t).float()
    w = torch.softmax(qk, dim=-1).to(q.dtype)
    return torch.einsum("aghqk,ahdk->aghqd", w, v_t).reshape(AG, H, Tq, dh)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Static-shape self-attention cache, updated in place: k, v
    [L, B, H, n_ctx, dh]."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def init(dims: ModelDims, batch: int, dtype, device) -> "KVCache":
        shape = (dims.n_text_layer, batch, dims.n_text_head, dims.n_text_ctx, dims.head_dim)
        return KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )


@dataclasses.dataclass
class CrossKV:
    """Per-window cross-attention K/V, computed once from the encoder
    output: ``kv [L, B, H, 2, dh, n_audio_ctx]``, plane 0 K^T, plane 1 V^T."""

    kv: torch.Tensor


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def encoder_self(self, x_ln: torch.Tensor, kernels: bool) -> torch.Tensor:
        """Full non-causal self-attention on merged heads (the encoder's)."""
        dh = x_ln.shape[-1] // self.n_head
        fn = encoder_attention_merged if kernels else encoder_attention_merged_plain
        out = fn(self.query(x_ln), self.key(x_ln), self.value(x_ln), self.n_head, dh**-0.5)
        return self.out(out)


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

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return self.mlp[2](gelu(self.mlp[0](h)))

    def encoder_forward(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        """Encoder block: LN kernel, merged-head attention kernel, fused
        residual+LN kernel, then the MLP (JAX ``encoder_block_fn``)."""
        ln, res_ln = (ln_fused, residual_ln) if kernels else (ln_fused_plain, residual_ln_plain)
        a = ln(x, self.attn_ln.weight, self.attn_ln.bias)
        x, h = res_ln(
            x, self.attn.encoder_self(a, kernels), self.mlp_ln.weight, self.mlp_ln.bias
        )
        return x + self._mlp(h)

    def decoder_forward(
        self, x, layer: int, pos_offset: int, mask, window: int, cross_kv: CrossKV,
        cache: KVCache, cross_group: int, kernels: bool, key_start=None, anc_local=None,
        step_kernel: str = "append",
    ) -> torch.Tensor:
        """One decoder block.  ``mask`` None marks an incremental step: the
        append kernel (the beam kernel with ``anc_local``, [B, n_ctx] int32
        beam-local ancestors) writes the K/V column and masks by
        ``pos_offset`` and ``key_start``, or (``step_kernel="ctx"``) torch
        writes the column and the fused kernel only reads; the MLP takes
        the fused kernel."""
        B, T, D = x.shape
        H = self.attn.n_head
        dh = D // H
        scale = dh**-0.5

        # self-attention over the cache (this step's K/V written first)
        h = layer_norm(x, self.attn_ln)
        if mask is None:
            hs = h[:, 0]
            q = (self.attn.query(hs) * scale).view(B, H, dh)
            k_new, v_new = self.attn.key(hs).view(B, H, dh), self.attn.value(hs).view(B, H, dh)
            if step_kernel == "ctx":
                cache.k[layer, :, :, pos_offset] = k_new
                cache.v[layer, :, :, pos_offset] = v_new
                fn = self_attention_fused_step if kernels else self_attention_fused_step_plain
                attn = fn(q, cache.k, cache.v, layer, pos_offset, key_start, window=window)
            else:
                args = (q, k_new, v_new, cache.k, cache.v, layer, pos_offset, key_start)
                if anc_local is None:
                    fn = self_attention_append_step if kernels else self_attention_append_step_plain
                    attn = fn(*args, window=window)
                else:
                    fn = beam_self_attention_step if kernels else beam_self_attention_step_plain
                    attn = fn(*args, anc_local, cross_group, window=window)
            attn = attn.reshape(B, 1, D)
        else:
            q = split_heads(self.attn.query(h), H) * scale
            cache.k[layer, :, :, pos_offset : pos_offset + T] = split_heads(self.attn.key(h), H)
            cache.v[layer, :, :, pos_offset : pos_offset + T] = split_heads(self.attn.value(h), H)
            attn = merge_heads(
                attend(q, cache.k[layer, :, :, :window], cache.v[layer, :, :, :window], mask)
            )
        x = x + self.attn.out(attn)

        # cross-attention against the precomputed encoder K/V
        h = layer_norm(x, self.cross_attn_ln)
        qx = split_heads(self.cross_attn.query(h), H) * scale
        if T == 1:
            fn = cross_attention_step if kernels else cross_attention_step_plain
            attn = fn(
                qx[:, :, 0, :].reshape(B // cross_group, cross_group, H, dh).contiguous(),
                cross_kv.kv, layer,
            ).reshape(B, H, 1, dh)
        else:
            kv = cross_kv.kv[layer]
            attn = attend_grouped(qx, kv[:, :, 0], kv[:, :, 1], cross_group)
        x = x + self.cross_attn.out(merge_heads(attn))

        h = layer_norm(x, self.mlp_ln)
        if mask is not None:
            return x + self._mlp(h)
        fn = decoder_mlp_step if kernels else decoder_mlp_step_plain
        out = fn(h[:, 0], self.mlp[0].weight, self.mlp[0].bias, self.mlp[2].weight)
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

    def forward(self, mel: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """[B, n_mels, 3000] log-mel -> [B, 1500, n_state]."""
        x = mel.transpose(1, 2)  # [B, 3000, n_mels]
        x = gelu(conv1d_mm(x, self.conv1, stride=1))
        x = gelu(conv1d_mm(x, self.conv2, stride=2))
        x = (x + self.positional_embedding.to(x.dtype)).contiguous()
        for block in self.blocks:
            x = block.encoder_forward(x, kernels)
        return layer_norm(x, self.ln_post)


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

    def forward(
        self,
        tokens: torch.Tensor,  # [B, T] (prefill width T, or 1 for a step)
        pos_offset: int,  # absolute position of tokens[:, 0]
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
        decoder_step_weights`` of ``self.blocks``), built here when None."""
        B, T = tokens.shape
        dev = tokens.device
        n_ctx = self.positional_embedding.shape[0]
        W = n_ctx if ctx_window is None else min(ctx_window, n_ctx)
        q_pos = pos_offset + torch.arange(T, device=dev)
        if key_start is not None:
            pos_idx = (q_pos[None, :] - key_start[:, None]).clamp(min=0)  # [B, T]
            pos = self.positional_embedding[pos_idx]
        else:
            pos = self.positional_embedding[pos_offset : pos_offset + T]
        if incremental:
            if T != 1:
                raise ValueError(f"an incremental step takes one token per row, not {T}")
            mask = None
        else:
            mask = self._mask(q_pos, W, key_start)
        if ancestors is not None and not incremental:
            raise ValueError("ancestors are read by an incremental step only")
        if step_kernel not in STEP_KERNELS:
            raise ValueError(f"step_kernel must be one of {STEP_KERNELS}, not {step_kernel!r}")
        if step_kernel != "append" and not incremental:
            raise ValueError(f"step_kernel {step_kernel!r} is an incremental step's route")
        if step_kernel != "append" and ancestors is not None:
            raise ValueError(f"step_kernel {step_kernel!r} is greedy only: a beam step "
                             "(ancestors) takes the append route")

        dtype = self.positional_embedding.dtype
        x = self.token_embedding.weight[tokens].to(dtype) + pos.to(dtype)
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
                    key_start, ancestors, step_kernel,
                )
        if logit_positions is not None:
            x = x[:, logit_positions]
        x = layer_norm(x, self.ln)
        return x.float() @ self.token_embedding.weight.float().T


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

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.positional_embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.positional_embedding.device


# ---------------------------------------------------------------------------
# functional entry points (names of the JAX counterparts)
# ---------------------------------------------------------------------------


def encoder_forward(model: Whisper, mel: torch.Tensor, *, kernels: bool = True) -> torch.Tensor:
    """[B, n_mels, 3000] log-mel -> [B, 1500, n_state] audio features."""
    return model.encoder(mel, kernels=kernels)


def precompute_cross_kv(model: Whisper, xa: torch.Tensor) -> CrossKV:
    """xa [B, Tk, D] -> the stacked cross K/V of every decoder layer."""
    B, Tk, D = xa.shape
    blocks = model.decoder.blocks
    H = blocks[0].cross_attn.n_head
    kv = torch.empty((len(blocks), B, H, 2, D // H, Tk), dtype=xa.dtype, device=xa.device)
    for layer, block in enumerate(blocks):
        kv[layer, :, :, 0] = split_heads(block.cross_attn.key(xa), H).transpose(-1, -2)
        kv[layer, :, :, 1] = split_heads(block.cross_attn.value(xa), H).transpose(-1, -2)
    return CrossKV(kv)


def decoder_forward(
    model: Whisper, tokens: torch.Tensor, pos_offset: int, cross_kv: CrossKV,
    cache: KVCache, **kwargs,
) -> torch.Tensor:
    """One decoder pass (see ``TextDecoder.forward``); updates ``cache``."""
    return model.decoder(tokens, pos_offset, cross_kv, cache, **kwargs)
