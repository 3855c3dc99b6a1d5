"""Every collective of the port, in one place (counterpart of
``whisper_rs_tpu/parallel/collectives.py``).

The JAX package annotates shardings and XLA inserts the collectives; the
port has no partitioner, so each rank calls these at the seams where GSPMD
puts them:

  * ``all_reduce_model``: the partial sums of a row-split linear (attention
    out, fc2, conv2) and of the vocab-split embedding lookup;
  * ``all_gather_model``: the vocab-split logits before the filters, the
    alignment heads' cross logits, the Ulysses sequence at the end;
  * ``all_to_all_model``: Ulysses' head-scatter / sequence-gather;
  * ``send_stage`` / ``recv_stage`` and ``broadcast_stage``: the GPipe
    hops and the last stage's result;
  * ``all_gather_data``: the data-parallel decode's outputs;
  * ``broadcast_world`` / ``broadcast_object``: the serving leader's call
    inputs.

Routes (``route``): under NCCL a tensor on the card is reduced on the card;
under gloo a CPU tensor is used as it is, and a CUDA tensor is staged
explicitly through a pinned host buffer (gloo has no CUDA all-to-all,
all-gather or send/recv), every collective the same way.  ``STATS`` counts
the collectives and the bytes staged (both ways), for the smoke run's
report; ``reset_stats`` sets both to 0.  On an axis of size 1 without a
group every function returns its input and counts nothing (a group of one
rank, such as a one-card NCCL group, still runs the collective).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

STATS = {"collectives": 0, "bytes_staged": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def route(device_type: str, backend: str) -> str:
    """How a tensor on ``device_type`` takes a collective of ``backend``:
    ``"device"`` (NCCL on the card), ``"host"`` (gloo on a CPU tensor) or
    ``"stage"`` (gloo on a CUDA tensor: through a pinned host buffer).
    NCCL takes no CPU tensor."""
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError(f"NCCL takes CUDA tensors, not {device_type} tensors")
        return "device"
    if device_type == "cpu":
        return "host"
    if device_type == "cuda":
        return "stage"
    raise ValueError(f"no collective route for {device_type} tensors under {backend}")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=torch.cuda.is_available())
    buf.copy_(x)  # blocking: the device's work on x is done
    STATS["bytes_staged"] += x.numel() * x.element_size()
    return buf


def _to_device(buf: torch.Tensor, device) -> torch.Tensor:
    STATS["bytes_staged"] += buf.numel() * buf.element_size()
    return buf.to(device, non_blocking=True)


def _run(x: torch.Tensor, backend: str, fn) -> torch.Tensor:
    """``fn(tensor) -> tensor`` on ``x`` by its route; the result on x's
    device."""
    STATS["collectives"] += 1
    if route(x.device.type, backend) != "stage":
        return fn(x.contiguous())
    return _to_device(fn(_to_host(x)), x.device)


def _idle(n: int, group) -> bool:
    """Whether an axis of ``n`` ranks with ``group`` takes no collective."""
    return n == 1 and group is None


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def all_reduce_model(x: torch.Tensor, mesh: Optional[Mesh], op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over the model group."""
    if mesh is None or _idle(mesh.n_model, mesh.model_group):
        return x

    def fn(t):
        t = t.clone()
        dist.all_reduce(t, op=_reduce_op(op), group=mesh.model_group)
        return t

    return _run(x, mesh.backend, fn)


def _all_gather(x: torch.Tensor, group, n: int, backend: str, dim: int) -> torch.Tensor:
    def fn(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    return _run(x, backend, fn)


def all_gather_model(x: torch.Tensor, mesh: Optional[Mesh], dim: int) -> torch.Tensor:
    """Every model rank's ``x``, concatenated along ``dim`` in rank order."""
    if mesh is None or _idle(mesh.n_model, mesh.model_group):
        return x
    return _all_gather(x, mesh.model_group, mesh.n_model, mesh.backend, dim)


def all_gather_data(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every data rank's ``x``, concatenated along ``dim`` in rank order."""
    if mesh is None or _idle(mesh.n_data, mesh.data_group):
        return x
    return _all_gather(x, mesh.data_group, mesh.n_data, mesh.backend, dim)


def all_to_all_model(x: torch.Tensor, mesh: Optional[Mesh], split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """Ulysses' exchange over the model group: ``x`` cut into n equal parts
    along ``split_axis``, part j sent to model rank j, and the parts
    received concatenated along ``concat_axis`` in rank order ([B, H, T/n,
    dh] <-> [B, H/n, T, dh]); the JAX ``all_to_all(tiled=True)``."""
    if mesh is None or _idle(mesh.n_model, mesh.model_group):
        return x
    n = mesh.n_model
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"{n} ways")

    def fn(t):
        src = t.movedim(split_axis, 0).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=mesh.model_group)
        parts = out.chunk(n, dim=0)  # part i came from rank i
        return torch.cat([p.movedim(0, split_axis) for p in parts], dim=concat_axis)

    return _run(x, mesh.backend, fn)


def send_stage(x: torch.Tensor, mesh: Mesh, stage: int) -> None:
    """Send ``x`` to this rank's counterpart at ``stage`` (same data and
    model index)."""
    from .mesh import rank_of

    dst = rank_of(mesh, stage, mesh.data, mesh.model)

    def fn(t):
        dist.send(t, dst)
        return t

    STATS["collectives"] += 1
    if route(x.device.type, mesh.backend) == "stage":
        fn(_to_host(x))
    else:
        fn(x.contiguous())


def recv_stage(like: torch.Tensor, mesh: Mesh, stage: int) -> torch.Tensor:
    """Receive a tensor shaped and typed as ``like`` from this rank's
    counterpart at ``stage``, on like's device."""
    from .mesh import rank_of

    src = rank_of(mesh, stage, mesh.data, mesh.model)
    STATS["collectives"] += 1
    if route(like.device.type, mesh.backend) == "stage":
        buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=torch.cuda.is_available())
        dist.recv(buf, src)
        return _to_device(buf, like.device)
    out = torch.empty_like(like)
    dist.recv(out, src)
    return out


def broadcast_stage(x: torch.Tensor, mesh: Mesh, stage: int) -> torch.Tensor:
    """``x`` of the rank at ``stage`` on every stage of this pipeline (each
    rank passes a tensor of the same shape and dtype)."""
    if _idle(mesh.n_stage, mesh.stage_group):
        return x
    from .mesh import rank_of

    src = rank_of(mesh, stage, mesh.data, mesh.model)

    def fn(t):
        t = t.clone()
        dist.broadcast(t, src, group=mesh.stage_group)
        return t

    return _run(x, mesh.backend, fn)


def broadcast_world(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` of rank ``src`` on every rank of the default group (each rank
    passes a tensor of the same shape and dtype)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x

    def fn(t):
        t = t.clone()
        dist.broadcast(t, src)
        return t

    return _run(x, dist.get_backend(), fn)


def broadcast_object(obj=None, src: int = 0):
    """A picklable ``obj`` of rank ``src`` on every rank of the default
    group (the others pass None); small control data only."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    device = None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    STATS["collectives"] += 1
    dist.broadcast_object_list(box, src, device=device)
    return box[0]
