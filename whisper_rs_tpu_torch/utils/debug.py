"""Logging and wall-clock spans for the command line (the parts of
``whisper_rs_tpu/utils/debug.py`` that the CLI uses, without JAX)."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("whisper_rs_tpu_torch")
if not log.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(_handler)
    log.setLevel(os.environ.get("WHISPER_LOG", "INFO"))


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
