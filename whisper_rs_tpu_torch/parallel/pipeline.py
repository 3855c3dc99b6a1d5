"""Pipeline parallelism (GPipe) over the encoder's blocks (counterpart of
``whisper_rs_tpu/parallel/pipeline.py``).

Each stage of the mesh holds ``n_audio_layer / n_stage`` contiguous
encoder blocks (``parallel.sharding.shard_model`` keeps them and drops the
rest).  The conv stem and the positional table run on every rank before
the pipeline, ``ln_post`` after it; the decoder stays whole on every
stage.  The batch is cut into ``n_micro`` microbatches: stage 0 takes them
from the stem, every other stage receives each from the stage before
(``recv_stage``), runs its blocks on it and sends it on (``send_stage``),
so stage s works on microbatch i at tick i + s of ``n_micro + S - 1``
ticks (the JAX ``fori_loop`` with ``ppermute``); the last stage collects
the results and broadcasts the ``[B, 1500, D]`` output to every stage of
its pipeline.  Inside a stage the blocks run as they do without a
pipeline, tensor-parallel over the model group where the model is split,
on the rank's block of the batch where the mesh has data ranks.

Bubble fraction: (S - 1) / (n_micro + S - 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.encoder_fused import ln_fused, ln_fused_plain
from .collectives import broadcast_stage, recv_stage, send_stage
from .mesh import Mesh


def _default_n_micro(B: int, S: int) -> int:
    """Largest microbatch count <= 2*S that divides the batch."""
    for k in range(min(B, 2 * S), 0, -1):
        if B % k == 0:
            return k
    return 1


def encoder_forward_pp(model, mel: torch.Tensor, mesh: Optional[Mesh] = None,
                       n_micro: Optional[int] = None, kernels: bool = True) -> torch.Tensor:
    """[B, n_mels, 3000] -> [B, 1500, n_state] through the pipeline of
    ``mesh`` (default ``model.mesh``), the encoder of ``model`` cut to this
    rank's stage by ``shard_model``; every rank returns the whole output.
    Raises ``ValueError`` where the stages do not divide the layers, the
    model is not cut to this mesh's stages, or ``n_micro`` does not divide
    the batch."""
    mesh = mesh or model.mesh
    enc = model.encoder
    S, L = mesh.n_stage, model.dims.n_audio_layer
    if L % S:
        raise ValueError(f"n_audio_layer={L} not divisible by {S} stages")
    if len(enc.blocks) != L // S:
        raise ValueError(f"the encoder holds {len(enc.blocks)} blocks, not a stage's {L // S}: "
                         "cut it with parallel.sharding.shard_model on this mesh")
    B = mel.shape[0]
    n_micro = n_micro or _default_n_micro(B, S)
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    x = enc.stem(mel)
    mb, s = B // n_micro, mesh.stage
    last = s == S - 1
    outs = torch.empty_like(x) if last else None
    for i in range(n_micro):
        rows = slice(i * mb, (i + 1) * mb)
        a = x[rows] if s == 0 else recv_stage(x[rows], mesh, s - 1)
        for block in enc.blocks:
            a = block.encoder_forward(a, kernels)
        if last:
            outs[rows] = a
        else:
            send_stage(a, mesh, s + 1)
    out = broadcast_stage(outs if last else torch.empty_like(x), mesh, S - 1)
    ln = ln_fused if kernels else ln_fused_plain
    return ln(out, enc.ln_post.weight, enc.ln_post.bias)


def pp_encoder_fn(mesh: Optional[Mesh] = None, n_micro: Optional[int] = None):
    """The ``encoder_fn(model, mel, kernels)`` of ``DecodeTask``,
    ``decode_greedy``/``decode_beam`` and the drivers that routes their
    encoder through the pipeline (the CLI's ``--pp``)."""

    def fn(model, mel, kernels=True):
        return encoder_forward_pp(model, mel, mesh, n_micro=n_micro, kernels=kernels)

    return fn
