"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel wrapper here has one predicate beside it,
``*_kernel_takes(shape...)``, which says by shape alone whether its kernel
takes a call.  A wrapper takes its plain version for a tensor on the CPU; a
tensor on the card launches the kernel, or raises where the predicate
refuses the shape.  No wrapper falls back to its plain version on the card.
The callers route by the predicates between kernels: the encoder between
the merged and the split attention kernels, the layer route to the append
route where the whole-step kernel refuses a step.

``LAUNCHES`` counts the launches of each wrapper, so a run can show that the
main path went through the kernels; the wrapper adds one right after its
launch (``count_launch``) and nowhere else.  ``"decoder_step_fused:append"``
counts the layer route's steps that took the append route instead.  The
count is taken under a lock: the serving engine launches the mel kernel on
its clients' threads while its own thread decodes.

A CUDA graph capture launches nothing: while a thread captures, its
wrappers' counts go to the capture's own record (``recorded_launches``),
and each replay of the graph adds them (``add_launches``), so the counts
stay the kernels' launches on the card.
"""

from __future__ import annotations

import contextlib
import threading

LAUNCHES = {
    "log_mel": 0,
    "ln_fused": 0,
    "residual_ln": 0,
    "encoder_attention_merged": 0,
    "cross_attention_step": 0,
    "self_attention_append_step": 0,
    "beam_self_attention_step": 0,
    "decoder_mlp_step": 0,
    "self_attention_fused_step": 0,
    "decoder_step_fused": 0,
    "self_attention_step": 0,
    "encoder_attention_split": 0,
    "decoder_step_fused:append": 0,  # the layer route's steps on the append route
}


_COUNT_LOCK = threading.Lock()


_CAPTURING = threading.local()  # .counts: a dict while this thread captures a graph


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``; a read-modify-write, so under a lock.
    While this thread captures a graph (``recorded_launches``) the launch
    is recorded for the replays instead: the capture launches nothing."""
    counts = getattr(_CAPTURING, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def recorded_launches():
    """Around a stream capture on this thread: yields a dict that collects
    the counts of the captured wrappers (a replay's launches) in place of
    ``LAUNCHES``; other threads count as before."""
    counts: dict = {}
    _CAPTURING.counts = counts
    try:
        yield counts
    finally:
        _CAPTURING.counts = None


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``counts`` (``recorded_launches``') ``times`` over: the launches
    of that many replays of a captured graph."""
    with _COUNT_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n * times


def use_kernel(name: str, kernel_takes: bool, device) -> bool:
    """Whether wrapper ``name`` launches its kernel: False for a tensor on
    the CPU (the plain version runs), True on the card; raises off the CPU
    where its predicate refused the shape (``kernel_takes`` False), and on
    any device but the CPU and the card."""
    if device.type == "cpu":
        return False
    if not kernel_takes:
        raise ValueError(f"{name}: the kernel does not take this shape (see its predicate)")
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True
