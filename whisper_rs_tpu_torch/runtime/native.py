"""ctypes binding for the native audio runtime (``audio_native.cpp``), the
counterpart of ``whisper_rs_tpu/runtime/native.py``.

The library is built at first use with the Makefile beside the source into
``build/native/libwhisper_audio-<digest>.so`` under the checkout (the
digest covers the source and the Makefile, so an edited source is rebuilt),
never into the package directory.  Where no toolchain builds it,
``available()`` is False and ``audio.io.load_audio(use_native=True)``
raises; its default is the pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib = None
_build_attempted = False


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in ("audio_native.cpp", "Makefile"):
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libwhisper_audio-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    """make into a temporary name, then rename: concurrent builds never
    load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["make", "-s", "-C", str(_DIR), f"OUT={tmp}"], check=True,
                   capture_output=True)
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists() and not _build_attempted:
            _build_attempted = True
            try:
                _build(path)
            except (OSError, subprocess.CalledProcessError):
                return None
        if not path.exists():
            return None
        lib = ctypes.CDLL(str(path))
        lib.wr_load_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wr_load_audio.restype = ctypes.c_int
        lib.wr_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wr_resample.restype = ctypes.c_int
        lib.wr_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.wr_free.restype = None
        lib.wr_last_error.argtypes = []
        lib.wr_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_audio(path: str) -> Optional[np.ndarray]:
    """Decode and resample to 16 kHz mono through the native library; None
    where it is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wr_load_audio(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"native audio decode failed: {lib.wr_last_error().decode()}")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.wr_free(out)


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> Optional[np.ndarray]:
    """The native windowed-sinc resampler; None where it is unavailable."""
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.wr_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), audio.size, sr_in, sr_out,
        ctypes.byref(out), ctypes.byref(n),
    )
    if rc != 0:
        raise RuntimeError(f"native resample failed: {lib.wr_last_error().decode()}")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.wr_free(out)
