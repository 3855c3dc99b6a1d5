"""Ulysses sequence parallelism for the audio encoder (counterpart of
``whisper_rs_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses,
arXiv:2309.14509).

The ranks of the model group hold the encoder's weights whole and split
its 1500 frames: activations are sequence-split ``[B, T/n, D]``, so the
LayerNorms (the LayerNorm kernels at ``[B, T/n, D]``), the projections and
the MLP work on the rank's frames alone.  Attention needs every frame of a
head, so q, k and v each take one ``all_to_all`` over the group
(``[B, H, T/n, dh] -> [B, H/n, T, dh]``: heads scattered, frames
gathered), the split-layout attention kernel (``encoder_attention_split``,
row 6) runs on the rank's heads, and one ``all_to_all`` takes the output
back.  The conv stem and the positional table run whole on every rank;
after the blocks the frames are gathered and ``ln_post`` runs on every
rank, which returns the whole ``[B, 1500, D]``.

The JAX package pads 1500 to 1536 for its flash kernel's 128-row blocks;
the port's kernels take 1500 as it is, so the sequence is padded only where
n does not divide it (1500 divides by 2, 3, 4, 5 and 6), and the padded
keys are masked by ``n_valid``.  n must divide the head count.

The decode takes it through the same seam as the pipeline:
``DecodeTask(..., encoder_fn=ulysses_encoder_fn(mesh))``, on a model
whose weights are whole on the model group (``shard_model(model, mesh,
tensor_parallel=False)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.whisper import merge_heads, split_heads
from ..ops.encoder_attention import encoder_attention_split, encoder_attention_split_plain
from ..ops.encoder_fused import ln_fused, ln_fused_plain, residual_ln, residual_ln_plain
from .collectives import all_gather_model, all_to_all_model
from .mesh import Mesh


def _block_forward(block, x: torch.Tensor, mesh: Mesh, n_valid: Optional[int],
                   kernels: bool) -> torch.Tensor:
    """One encoder block on this rank's frames x [B, Tp/n, D]."""
    ln, res_ln = (ln_fused, residual_ln) if kernels else (ln_fused_plain, residual_ln_plain)
    attn = block.attn
    H, dh = attn.n_head, attn.head_dim
    a = ln(x, block.attn_ln.weight, block.attn_ln.bias)
    # heads scattered, frames gathered: [B, H, T/n, dh] -> [B, H/n, T, dh]
    q, k, v = (all_to_all_model(split_heads(m(a), H), mesh, split_axis=1, concat_axis=2)
               for m in (attn.query, attn.key, attn.value))
    fn = encoder_attention_split if kernels else encoder_attention_split_plain
    out = fn(q, k, v, dh**-0.5, n_valid)
    out = all_to_all_model(out, mesh, split_axis=2, concat_axis=1)  # and back
    x, h = res_ln(x, attn.out(merge_heads(out)), block.mlp_ln.weight, block.mlp_ln.bias)
    return x + block._mlp(h)


def encoder_forward_ulysses(model, mel: torch.Tensor, mesh: Optional[Mesh] = None,
                            kernels: bool = True) -> torch.Tensor:
    """[B, n_mels, 3000] -> [B, 1500, n_state], sequence-parallel over the
    model group of ``mesh`` (default ``model.mesh``); the result of
    ``encoder_forward`` up to f32 summation order.  Raises ``ValueError``
    where the group does not divide the head count, or the weights are
    split (tensor parallelism)."""
    mesh = mesh or model.mesh
    enc = model.encoder
    n, H = mesh.n_model, model.dims.n_audio_head
    if H % n:
        raise ValueError(f"Ulysses needs n_head ({H}) divisible by the model group ({n})")
    if enc.tp is not None:
        raise ValueError("Ulysses takes whole weights on the model group: shard the model "
                         "with tensor_parallel=False")
    x = enc.stem(mel)
    T = x.shape[1]
    Tp = math.ceil(T / n) * n
    n_valid = T if Tp != T else None
    if Tp != T:
        x = F.pad(x, (0, 0, 0, Tp - T))
    per = Tp // n
    x = x[:, mesh.model * per : (mesh.model + 1) * per].contiguous()
    for block in enc.blocks:
        x = _block_forward(block, x, mesh, n_valid, kernels)
    x = all_gather_model(x, mesh, dim=1)[:, :T].contiguous()
    ln = ln_fused if kernels else ln_fused_plain
    return ln(x, enc.ln_post.weight, enc.ln_post.bias)


def ulysses_encoder_fn(mesh: Optional[Mesh] = None):
    """The ``encoder_fn(model, mel, kernels)`` of the decode and the drivers
    that routes their encoder through Ulysses."""

    def fn(model, mel, kernels=True):
        return encoder_forward_ulysses(model, mel, mesh, kernels=kernels)

    return fn
