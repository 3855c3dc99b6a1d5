"""The process mesh (counterpart of ``whisper_rs_tpu/parallel/mesh.py``).

The JAX mesh lays devices out as ``('stage', 'data', 'model')``; here each
rank is one process, and rank ``(s * n_data + d) * n_model + m`` sits at
stage ``s``, data index ``d`` and model index ``m``: the model group is
the fastest-varying axis and the stage the slowest, as in JAX.  A ``Mesh``
holds this rank's coordinates, the sizes, and one process group for each
axis through this rank (``model``: the ranks of one model replica, which
split its heads, hidden and vocab; ``data``: the ranks that split the
batch; ``stage``: the ranks of one pipeline).  Every rank creates every
group, in one order, as ``torch.distributed.new_group`` asks.

One process (no process group) gives the 1 x 1 x 1 mesh, on which every
collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``n_stage x n_data x n_model`` mesh and the
    process group of each axis through it (None on an axis of size 1)."""

    n_stage: int = 1
    n_data: int = 1
    n_model: int = 1
    stage: int = 0
    data: int = 0
    model: int = 0
    stage_group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    backend: Optional[str] = None

    def __repr__(self) -> str:
        return (f"Mesh(stage {self.stage}/{self.n_stage}, data {self.data}/{self.n_data}, "
                f"model {self.model}/{self.n_model}, backend {self.backend})")


def rank_of(mesh: Mesh, s: int, d: int, m: int) -> int:
    return (s * mesh.n_data + d) * mesh.n_model + m


def make_mesh(n_model: int = 1, n_data: Optional[int] = None, n_stage: int = 1) -> Mesh:
    """The mesh over every rank of the default process group (one rank
    without one): ``n_model`` ranks a model replica (TP, or Ulysses),
    ``n_stage`` pipeline stages, and the rest data-parallel.  Raises
    ``ValueError`` where the ranks do not divide, as the JAX ``make_mesh``
    does."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world % (n_model * n_stage) != 0:
        raise ValueError(f"{world} ranks not divisible by n_model*n_stage={n_model}*{n_stage}")
    if n_data is None:
        n_data = world // (n_model * n_stage)
    if n_stage * n_data * n_model != world:
        raise ValueError(f"mesh {n_stage}x{n_data}x{n_model} != {world} ranks")
    s, rest = divmod(rank, n_data * n_model)
    d, m = divmod(rest, n_model)
    coords = dict(n_stage=n_stage, n_data=n_data, n_model=n_model, stage=s, data=d, model=m)
    if world == 1:
        return Mesh(**coords)
    probe = Mesh(**coords)
    grid = [(s_, d_, m_) for s_ in range(n_stage) for d_ in range(n_data) for m_ in range(n_model)]
    groups = {}
    # every rank creates every group of each axis, in the same order; a
    # group's ranks ascend along its axis
    for axis, size, others in (("model", n_model, (0, 1)), ("data", n_data, (0, 2)),
                               ("stage", n_stage, (1, 2))):
        if size == 1:
            continue
        members: dict = {}
        for c in grid:
            members.setdefault(tuple(c[i] for i in others), []).append(rank_of(probe, *c))
        for ranks in members.values():
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[f"{axis}_group"] = group
    return Mesh(**coords, **groups, backend=dist.get_backend())


def make_pipeline_mesh(n_stages: int, n_data: int = 1, n_model: int = 1) -> Mesh:
    """The ``n_stages x n_data x n_model`` mesh; every rank of the default
    group must be on it (a process per mesh slot)."""
    return make_mesh(n_model=n_model, n_data=n_data, n_stage=n_stages)
