"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/torch_kernels/lib<name>-<digest>.so`` under the checkout,
where the digest covers the source, the shared header and the flags, so an
edited source is rebuilt and an unchanged one is reused.  ``build_all``
starts one nvcc per source at once and waits for all of them.  ptxas
reports each kernel's registers, shared memory and spills (``-Xptxas -v``);
the report is kept beside the library, and ``ptxas_report`` reads it.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int`` (strides that may pass 2^31 as
``c_longlong``), launches on that stream and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.

Threads of one process may ask for a library at once (the serving engine
runs the mel kernel on its clients' threads): ``build_all`` and
``_library`` run under one lock, so a library is compiled once and loaded
once, and each temporary output is named by process and thread.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = (
    "mel", "encoder_attention", "cross_attention", "self_attention", "decoder_mlp",
    "decoder_layer", "layer_norm",
)
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_LOCK = threading.RLock()  # one build-and-load at a time in this process
_LOADED: dict = {}  # name -> ctypes.CDLL


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, all nvcc processes at
    once.  Returns {name: seconds} for what was compiled; raises with the
    compiler's output if any build fails."""
    with _LOCK:
        return _build(names)


def _build(names) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report(name: str) -> list:
    """(kernel, registers, spill stores, spill loads, stack bytes) of every
    kernel of source ``name`` as ptxas reported them when it was built
    (mangled names); empty where the report is missing."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, kernel, spills = [], None, (0, 0, 0)
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            spills = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), *spills))
            kernel, spills = None, (0, 0, 0)
    return rows


def _library(name: str) -> ctypes.CDLL:
    """``lib<name>``, built where missing and loaded once in this process."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
        return _LOADED[name]


@functools.lru_cache(maxsize=None)
def kernel_function(library: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``lib<library>``, typed; built and
    loaded at first use."""
    fn = getattr(_library(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(library: str, symbol: str, err: int) -> None:
    if err != 0:
        msg = _library(library).kernel_error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} ({msg})")


P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_longlong
F = ctypes.c_float
