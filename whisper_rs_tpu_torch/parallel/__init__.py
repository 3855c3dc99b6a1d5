"""Drivers over many files: the batched transcriber.  The JAX package's
mesh, sharding, pipeline and sequence parallelism are not ported yet."""

from .batch import BatchTranscriber

__all__ = ["BatchTranscriber"]
