"""Logging, wall-clock spans, tensor statistics and the profiler
(counterpart of ``whisper_rs_tpu/utils/debug.py``, without JAX):

  * ``step_timer``: a logged wall-clock span;
  * ``tensor_dbg``: a tensor's shape, mean and absmax, logged only with
    ``WHISPER_DEBUG_TENSORS=1`` in the environment (read at import);
  * ``profiler_trace``: a named span (``torch.profiler.record_function``)
    that shows in a trace;
  * ``start_profiler`` / ``stop_profiler``: a ``torch.profiler.profile``
    of the CPU and the card (where present) between the two calls, written
    to ``logdir`` as a Chrome trace;
  * ``enable_nan_checks`` / ``disable_nan_checks``: forward hooks on every
    module that raise at the first output that is not finite, naming the
    module (the JAX ``jax_debug_nans``).  Each check reads the output on
    the host, so while they are on the decode loop runs its steps eagerly
    (``decode.loop.eager_reason``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time
import weakref

import torch

log = logging.getLogger("whisper_rs_tpu_torch")
if not log.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(_handler)
    log.setLevel(os.environ.get("WHISPER_LOG", "INFO"))

_DEBUG_TENSORS = os.environ.get("WHISPER_DEBUG_TENSORS") == "1"
_PROFILE: dict = {}
_NAN_CHECKS: dict = {}  # "hook": the global forward hook's handle, while on
_MODULE_NAMES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@contextlib.contextmanager
def step_timer(name: str, audio_seconds: float | None = None, device=None):
    """Logs the wall-clock seconds of the span, with audio-seconds/s where
    ``audio_seconds`` is given.  On a CUDA ``device`` the span starts and
    ends with ``torch.cuda.synchronize``, so it times the device's work and
    not its enqueueing."""
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if audio_seconds is not None and dt > 0:
        log.info("%s: %.3fs (%.1f audio-s/s)", name, dt, audio_seconds / dt)
    else:
        log.info("%s: %.3fs", name, dt)


def tensor_dbg(name: str, x: torch.Tensor) -> None:
    """Log ``x``'s shape, mean and absmax (a host sync); nothing unless
    ``WHISPER_DEBUG_TENSORS=1``."""
    if not _DEBUG_TENSORS:
        return
    xf = x.detach().float()
    log.info("%s: shape=%s mean=%s absmax=%s", name, tuple(x.shape), xf.mean().item(),
             xf.abs().max().item())


@contextlib.contextmanager
def profiler_trace(name: str):
    """A named span in a ``torch.profiler`` trace."""
    with torch.profiler.record_function(name):
        yield


def start_profiler(logdir: str) -> None:
    """Start profiling the CPU and, where present, the card; the trace is
    written by ``stop_profiler``."""
    if _PROFILE:
        raise RuntimeError("the profiler is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE.update(prof=prof, logdir=pathlib.Path(logdir))


def stop_profiler() -> pathlib.Path:
    """Stop the profiler of ``start_profiler`` and write its Chrome trace to
    ``<logdir>/trace-<pid>.json``; returns the path."""
    if not _PROFILE:
        raise RuntimeError("the profiler is not running")
    prof, logdir = _PROFILE.pop("prof"), _PROFILE.pop("logdir")
    prof.stop()
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    return path


def _finite_or_raise(module, inputs, output) -> None:
    outs = output if isinstance(output, (tuple, list)) else (output,)
    for t in outs:
        if torch.is_tensor(t) and t.is_floating_point() and not bool(torch.isfinite(t).all()):
            name = _MODULE_NAMES.get(module, type(module).__name__)
            raise FloatingPointError(f"non-finite output of module {name} "
                                     f"({type(module).__name__}, shape {tuple(t.shape)})")


def enable_nan_checks(model=None) -> None:
    """Turn on a forward hook on every module (``torch.nn.modules.module.
    register_module_forward_hook``) that raises ``FloatingPointError`` at
    the first module whose output holds a NaN or an infinity, naming it:
    by its path in ``model`` (``decoder.blocks.0.attn.query``) for the
    modules of a ``model`` given here or in an earlier call, else by its
    class.  The counterpart of the JAX ``enable_nan_checks``
    (``jax_debug_nans``).  Each check is a host read, so decodes take the
    eager loop while it is on."""
    if model is not None:
        for name, module in model.named_modules():
            _MODULE_NAMES[module] = name or type(module).__name__
    if "hook" not in _NAN_CHECKS:
        _NAN_CHECKS["hook"] = torch.nn.modules.module.register_module_forward_hook(
            _finite_or_raise)


def disable_nan_checks() -> None:
    """Remove the hook of ``enable_nan_checks``, if it is on."""
    hook = _NAN_CHECKS.pop("hook", None)
    if hook is not None:
        hook.remove()


def nan_checks_enabled() -> bool:
    return "hook" in _NAN_CHECKS
