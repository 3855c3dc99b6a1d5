"""Parallelism on ``torch.distributed`` (counterpart of
``whisper_rs_tpu/parallel``), one process per rank: the mesh
(``mesh``), the start-up (``distributed``, ``launch``), every collective
(``collectives``), tensor and data parallelism (``sharding``), the
pipeline-parallel and the Ulysses sequence-parallel encoders
(``pipeline``, ``ulysses``), and the batch driver (``batch``).

The names below are imported on first use: ``models.whisper`` imports
``collectives``, which must not pull in the drivers that import the
model."""

from importlib import import_module

_NAMES = {
    "BatchTranscriber": "batch",
    "Mesh": "mesh",
    "make_mesh": "mesh",
    "make_pipeline_mesh": "mesh",
    "initialize_multihost": "distributed",
    "Ranks": "launch",
    "run_ranks": "launch",
    "param_shardings": "sharding",
    "shard_model": "sharding",
    "shard_batch": "sharding",
    "encoder_forward_pp": "pipeline",
    "pp_encoder_fn": "pipeline",
    "encoder_forward_ulysses": "ulysses",
    "ulysses_encoder_fn": "ulysses",
}

__all__ = sorted(_NAMES)


def __getattr__(name: str):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f".{_NAMES[name]}", __name__), name)
