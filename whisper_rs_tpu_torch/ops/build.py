"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``build/torch_kernels/lib<name>-<digest>.so`` under the checkout,
where the digest covers the source, the shared header and the flags, so an
edited source is rebuilt and an unchanged one is reused.  ``build_all``
starts one nvcc per source at once and waits for all of them.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``, launches on that stream and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("mel", "encoder_attention", "cross_attention", "self_attention", "decoder_mlp")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, all nvcc processes at
    once.  Returns {name: seconds} for what was compiled; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
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
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


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
F = ctypes.c_float
