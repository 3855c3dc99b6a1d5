"""Sharding rules: tensor-parallel weights, pipeline stages and the
data-parallel batch (counterpart of ``whisper_rs_tpu/parallel/sharding.py``).

The rules are the JAX package's Megatron rules, on the port's parameter
names (weights ``[out, in]``, so JAX's output axis is dim 0 here):

  * q, k, v (self and cross) and fc1 (``mlp.0``) split by output rows:
    heads and the 4D hidden split, head_dim stays whole; their biases and
    int8 scales follow the rows;
  * attention out and fc2 (``mlp.2``) split by input columns: a sum over
    the model group follows (``models.whisper.row_linear``); their biases
    and int8 scales stay whole;
  * conv1 split by output channels (its bias follows), conv2 by input
    channels (a sum before its GELU; its bias whole);
  * the tied token table (and its int8 scale) split by vocab rows, padded
    with zero rows to a multiple of the group;
  * LayerNorms and the positional tables whole.

On a mesh with stages each rank keeps its stage's ``n_audio_layer /
n_stage`` contiguous encoder blocks and drops the rest (the JAX package
shards the stacked L axis over 'stage'); the decoder stays whole on every
stage.  ``shard_model`` cuts each rank's shard in place, each a contiguous
copy, so the whole tensors are freed.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch
from torch import nn

from .mesh import Mesh

_COLUMN = re.compile(r"\.(attn|cross_attn)\.(query|key|value)\.|\.mlp\.0\.")
_ROW = re.compile(r"\.(attn|cross_attn)\.out\.|\.mlp\.2\.")


def split_dim(name: str) -> Optional[int]:
    """The dim that tensor parallelism splits parameter ``name`` along, or
    None where every rank keeps it whole."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("decoder.token_embedding."):
        return 0
    if name.startswith("encoder.conv1."):
        return 0
    if name.startswith("encoder.conv2."):
        return 1 if leaf == "weight" else None
    if _COLUMN.search(name):
        return 0
    if _ROW.search(name):
        return 1 if leaf == "weight" else None
    return None


def param_shardings(mesh: Optional[Mesh], model: nn.Module) -> dict:
    """For each parameter name of ``model``, the dim tensor parallelism
    splits (``split_dim``), or None; every entry None where the mesh has
    one model rank."""
    tp = mesh is not None and mesh.n_model > 1
    return {name: split_dim(name) if tp else None for name, _ in model.named_parameters()}


def stage_layers(n_layer: int, mesh: Mesh) -> tuple:
    """(first, end) of the encoder blocks of this rank's stage."""
    if n_layer % mesh.n_stage:
        raise ValueError(f"n_audio_layer={n_layer} not divisible by {mesh.n_stage} stages")
    per = n_layer // mesh.n_stage
    return mesh.stage * per, (mesh.stage + 1) * per


def _check_divisible(model, n: int) -> None:
    dims = model.dims
    for what, size in (("n_audio_head", dims.n_audio_head), ("n_text_head", dims.n_text_head),
                       ("n_audio_state", dims.n_audio_state)):
        if size % n:
            raise ValueError(f"tensor parallelism over {n} ranks needs {what} ({size}) "
                             f"divisible by {n}")


def shard_model(model: nn.Module, mesh: Mesh, *, tensor_parallel: bool = True) -> nn.Module:
    """Cut ``model`` (a ``Whisper``) to this rank's shard of ``mesh``, in
    place, and return it: with ``tensor_parallel`` (and more than one model
    rank) each split parameter becomes this rank's contiguous slice
    (``split_dim``), the attention modules' head counts the shard's, and
    the modules call the model group's collectives; on a mesh with stages
    the encoder keeps this stage's blocks.  ``model.mesh`` is set either
    way: the decode splits its batch over the data ranks by it.  Without
    ``tensor_parallel`` the weights stay whole on the model group (the
    Ulysses encoder's layout)."""
    model.mesh = mesh
    if mesh.n_stage > 1:
        first, end = stage_layers(model.dims.n_audio_layer, mesh)
        enc = model.encoder
        enc.blocks = nn.ModuleList(enc.blocks[first:end])
        enc.stage_layers = (first, end)
    n, m = mesh.n_model, mesh.model
    if not tensor_parallel or (n == 1 and mesh.model_group is None):
        return model
    _check_divisible(model, n)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            dim = split_dim(name)
            if dim is None:
                continue
            size = p.shape[dim]
            if size % n:  # the vocab: zero rows up to a multiple of the group
                pad = math.ceil(size / n) * n - size
                p = torch.cat([p, p.new_zeros((pad, *p.shape[1:]))], dim=dim)
                size += pad
            part = size // n
            shard = p.narrow(dim, m * part, part).clone(memory_format=torch.contiguous_format)
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            owner._parameters[leaf] = nn.Parameter(shard, requires_grad=False)
    for module in model.modules():
        if hasattr(module, "n_head") and hasattr(module, "head_dim"):
            module.n_head //= n
        if hasattr(module, "tp"):
            module.tp = mesh
    return model


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This data rank's contiguous block of ``x``'s rows (the batch padded
    with repeats of its last row to a multiple of the data ranks)."""
    if mesh is None or (mesh.n_data == 1 and mesh.data_group is None):
        return x
    per = math.ceil(x.shape[0] / mesh.n_data)
    x = pad_rows(x, per * mesh.n_data)
    return x[mesh.data * per : (mesh.data + 1) * per]


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with its last row repeated up to ``rows`` rows."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x[-1:].expand(rows - x.shape[0], *x.shape[1:])], dim=0)
