"""Log-mel frontend: CUDA kernel, its plain version, the router
``log_mel_frontend`` for 30 s windows and the whole-file ``log_mel_file``
(counterpart of ``whisper_rs_tpu/ops/mel_pallas.py``).

``raw_log10_mel`` is the kernel (``csrc/mel.cu``): reflect-padded audio
rows [B, 480400] (a row pitch of its own, so the overlapping chunks of one
padded file are a strided view) -> log10 mel [B, n_mels, 3000], before the
dynamic-range floor.  The reflect padding and the ``max - 8`` floor and
``(x+4)/4`` scale stay plain PyTorch around it: per utterance for windows,
over the whole file for ``log_mel_file``.

The kernel runs a 400-point real FFT as a 200-point complex one, in f32,
and a sparse mel projection.  What it computes with is made here, on the
host, so the CPU tests can run the same plan: ``fft_table`` (the Hann
window, the butterflies' constants and every stage's twiddles, computed in
float64 and rounded to f32 once) and ``mel_runs`` (each filter of the
filterbank as one run of contiguous bins and its weights).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..audio.constants import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from ..audio.mel import _dft_basis, hann_window, log_mel_spectrogram, mel_filterbank, reflect_pad
from ..device import resolve_device
from . import count_launch
from .build import I, P, check, kernel_function

PADDED_LEN = N_SAMPLES + N_FFT  # 480400 samples after centred reflect padding

# The kernel's FFT plan (csrc/mel.cu holds the same constants).  A frame's
# 400 real samples x, windowed, are packed as M = 200 complex ones
# z[m] = x[2m] + i x[2m + 1]; a Stockham FFT of radices FFT_RADICES, in that
# order, gives Z = DFT_M(z) in natural order; the post-pass splits Z into
# the 201 bins of the real DFT.  Stage s of radix R after a stride Ns (the
# product of the radices before it) takes, for j in [0, M / R), the inputs
# v[r] = in[j + r M / R], multiplies v[r] by exp(-2 pi i r k / (Ns R)) with
# k = j % Ns, runs a DFT of size R on v and writes out[(j // Ns) Ns R + k +
# r Ns] = V[r].
FFT_M = N_FFT // 2
FFT_RADICES = (8, 5, 5)
# fft_table's layout in f32 words (complex values as (re, im) pairs):
# the window; W8 = exp(-2 pi i / 8); cos(2 pi / 5), cos(4 pi / 5),
# sin(2 pi / 5), sin(4 pi / 5); the twiddles of stages 2 and 3 at
# [k (R - 1) + r - 1] for k < Ns, r in 1..R-1 (stage 1 has Ns = 1, no
# twiddle); the post-pass's W400^k = exp(-2 pi i k / 400), k in 0..100.
TABLE_WINDOW, TABLE_W8, TABLE_C5 = 0, N_FFT, N_FFT + 2
TABLE_TW2 = TABLE_C5 + 4
TABLE_TW3 = TABLE_TW2 + 2 * 8 * 4
TABLE_POST = TABLE_TW3 + 2 * 40 * 4
TABLE_LEN = TABLE_POST + 2 * (FFT_M // 2 + 1)
MAX_MELS = 128  # the kernel's room for filters
MAX_MEL_WEIGHTS = 512  # and for their nonzero weights


def _cis(turns) -> np.ndarray:
    """exp(-2 pi i turns) in float64, as (re, im) pairs rounded to f32."""
    a = -2.0 * np.pi * np.asarray(turns, np.float64)
    return np.stack([np.cos(a), np.sin(a)], -1).astype(np.float32)


def stage_twiddles(radix: int, ns: int) -> np.ndarray:
    """[ns, radix - 1, 2] f32: exp(-2 pi i r k / (ns radix)) for r >= 1."""
    k, r = np.arange(ns)[:, None], np.arange(1, radix)[None, :]
    return _cis(r * k / (ns * radix))


@functools.lru_cache(maxsize=1)
def fft_table() -> np.ndarray:
    """[TABLE_LEN] f32, the constants of the kernel's FFT (layout above)."""
    t = np.zeros(TABLE_LEN, np.float32)
    t[TABLE_WINDOW:TABLE_W8] = hann_window(N_FFT)
    t[TABLE_W8:TABLE_C5] = _cis(1 / 8)
    ang = 2.0 * np.pi * np.array([1, 2]) / 5
    t[TABLE_C5:TABLE_TW2] = np.concatenate([np.cos(ang), np.sin(ang)]).astype(np.float32)
    t[TABLE_TW2:TABLE_TW3] = stage_twiddles(5, 8).ravel()
    t[TABLE_TW3:TABLE_POST] = stage_twiddles(5, 40).ravel()
    t[TABLE_POST:] = _cis(np.arange(FFT_M // 2 + 1) / N_FFT).ravel()
    return t


class MelRuns(NamedTuple):
    """A filterbank as one run of contiguous bins a filter: ``runs`` [n_mels,
    3] int32 (first bin, length, offset of its weights), ``weights`` f32,
    the runs' weights one after another."""
    runs: np.ndarray
    weights: np.ndarray


def mel_runs(fb: np.ndarray) -> MelRuns:
    """The runs of filterbank ``fb`` [n_mels, 201]: each filter's nonzeros,
    which must be contiguous bins (raises otherwise), in ascending order."""
    runs, weights = [], []
    offset = 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        first = int(nz[0]) if nz.size else 0
        if nz.size and nz[-1] - first + 1 != nz.size:
            raise ValueError(f"mel_runs: filter {m}'s nonzero bins are not contiguous")
        runs.append((first, nz.size, offset))
        weights.append(row[nz])
        offset += nz.size
    return MelRuns(np.asarray(runs, np.int32).reshape(-1, 3),
                   np.concatenate(weights).astype(np.float32))


def kernel_flops_per_frame(n_mels: int) -> int:
    """The f32 operations the kernel does a frame (a fused multiply-add
    counts 2): the window (400 multiplies); the radix-8 stage, 25
    butterflies of 56; the two radix-5 stages, 40 butterflies each of 24 for
    the twiddles and 48 for the DFT; the real-split post-pass, 101 pairs of
    22; the sparse projection, 2 a weight."""
    weights = int(mel_runs(mel_filterbank(n_mels)).weights.size)
    return N_FFT + 25 * 56 + 2 * 40 * (24 + 48) + (FFT_M // 2 + 1) * 22 + 2 * weights


@functools.lru_cache(maxsize=4)
def basis_constants(n_mels: int) -> tuple:
    """(wcos [400, 201], wsin [400, 201], fb [n_mels, 201]) f32: the Hann
    window folded into the DFT basis, and the mel filterbank."""
    cos_b, sin_b = _dft_basis(N_FFT)
    win = hann_window(N_FFT)[:, None]
    return (
        np.ascontiguousarray(win * cos_b, np.float32),
        np.ascontiguousarray(win * sin_b, np.float32),
        mel_filterbank(n_mels),
    )


def _constants_on(device: torch.device, n_mels: int):
    return tuple(torch.from_numpy(c).to(device) for c in basis_constants(n_mels))


@functools.lru_cache(maxsize=8)
def _kernel_constants(device: torch.device, n_mels: int) -> tuple:
    """(fft_table, runs, weights) of ``n_mels`` on ``device``, made once."""
    runs = mel_runs(mel_filterbank(n_mels))
    if n_mels > MAX_MELS or runs.weights.size > MAX_MEL_WEIGHTS:
        raise ValueError(f"raw_log10_mel: the kernel holds at most {MAX_MELS} filters of "
                         f"{MAX_MEL_WEIGHTS} weights in all, not {n_mels} of {runs.weights.size}")
    return tuple(torch.from_numpy(a).to(device) for a in (fft_table(), runs.runs, runs.weights))


def raw_log10_mel_plain(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Plain version of the kernel: [B, 480400] f32 -> [B, n_mels, 3000]."""
    wcos, wsin, fb = _constants_on(padded.device, n_mels)
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :N_FRAMES]  # [B, 3000, 400]
    re = frames @ wcos
    im = frames @ wsin
    mel = (re * re + im * im) @ fb.T
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def raw_log10_mel(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """log10 mel of reflect-padded 30 s windows, [B, 480400] f32 ->
    [B, n_mels, 3000] f32: the kernel on the card, the plain version on the
    CPU.  The rows may be a strided view with unit stride along a row
    (overlapping rows included)."""
    if padded.device.type == "cpu":
        return raw_log10_mel_plain(padded, n_mels)
    if not padded.is_cuda:
        raise ValueError(f"raw_log10_mel: unsupported device {padded.device}")
    if padded.dtype != torch.float32 or padded.ndim != 2 or padded.shape[1] != PADDED_LEN:
        raise ValueError(
            f"raw_log10_mel wants [B, {PADDED_LEN}] float32, got "
            f"{tuple(padded.shape)} {padded.dtype}"
        )
    if padded.stride(1) != 1 or padded.stride(0) < 1:
        raise ValueError("raw_log10_mel: each row of padded audio must be contiguous")
    if padded.data_ptr() % 16 or padded.stride(0) % 4:
        raise ValueError("raw_log10_mel: rows must start 16-byte aligned (the kernel copies "
                         "them in 16-byte pieces)")
    table, runs, weights = _kernel_constants(padded.device, n_mels)
    B = padded.shape[0]
    out = torch.empty((B, n_mels, N_FRAMES), dtype=torch.float32, device=padded.device)
    fn = kernel_function("mel", "log_mel_f32", (P, P, P, P, P, I, I, I, P))
    err = fn(
        padded.data_ptr(), table.data_ptr(), runs.data_ptr(), weights.data_ptr(),
        out.data_ptr(), B, n_mels, padded.stride(0),
        torch.cuda.current_stream(padded.device).cuda_stream,
    )
    check("mel", "log_mel_f32", err)
    count_launch("log_mel")
    return out


def _floor_and_scale(log_spec: torch.Tensor, dtype) -> torch.Tensor:
    """Per-utterance dynamic-range floor at max - 8, then (x + 4) / 4."""
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return ((torch.maximum(log_spec, floor) + 4.0) / 4.0).to(dtype)


def log_mel_windows(audio: torch.Tensor, n_mels: int = 80, *, dtype=torch.float32):
    """[B, 480000] (or [480000]) -> [B, n_mels, 3000] through
    ``raw_log10_mel`` (counterpart of ``log_mel_pallas``)."""
    squeeze = audio.ndim == 1
    a = audio.float()
    if squeeze:
        a = a[None]
    if a.shape[-1] != N_SAMPLES:
        raise ValueError(f"log_mel_windows expects 30 s windows, got {a.shape[-1]} samples")
    out = _floor_and_scale(raw_log10_mel(reflect_pad(a).contiguous(), n_mels), dtype)
    return out[0] if squeeze else out


def log_mel_file(
    audio, n_mels: int = 80, *, dtype=torch.float32, device=None, kernels: bool = True
) -> torch.Tensor:
    """Whole-file log-mel [n_samples] (numpy or tensor) -> [n_mels,
    n_samples // 160] on ``device`` (``cuda`` unless named), as the JAX
    ``log_mel_file`` computes it: the file zero-padded to a whole number C
    of 30 s buckets and reflect-padded once; C chunks of 480400 samples cut
    from it with true-sample halos (chunk c is ``padded[c 480000 :
    c 480000 + 480400]``, a strided view, so a chunk's last frames read the
    next chunk's samples and only the file's two ends are reflected); one
    batch of C through ``raw_log10_mel`` (the kernel when ``kernels`` on the
    card); the floor at the whole file's max - 8 and the scale; then the
    true frame count."""
    dev = resolve_device(device)
    a = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    if a.ndim != 1:
        raise ValueError(f"log_mel_file takes one file [n_samples], got {tuple(a.shape)}")
    n = a.shape[0]
    C = max(1, -(-n // N_SAMPLES))
    buf = torch.zeros(C * N_SAMPLES, dtype=torch.float32, device=dev)
    buf[:n] = a
    padded = reflect_pad(buf[None])[0]  # [C 480000 + 400]
    chunks = padded.as_strided((C, PADDED_LEN), (N_SAMPLES, 1))
    raw = (raw_log10_mel if kernels else raw_log10_mel_plain)(chunks, n_mels)
    mel = raw.transpose(0, 1).reshape(n_mels, C * N_FRAMES)
    floor = mel.amax() - 8.0  # over every bucket frame of the file
    return ((torch.maximum(mel, floor) + 4.0) / 4.0).to(dtype)[:, : n // HOP_LENGTH]


def log_mel_frontend(
    audio, n_mels: int = 80, *, dtype=torch.float32, device=None, kernels: bool = True
) -> torch.Tensor:
    """Audio (numpy or tensor, [B, n] or [n]) -> log-mel on ``device``
    (``cuda`` unless named).  Exact 30 s windows go through the mel kernel
    when ``kernels``; other lengths, or ``kernels=False``, take the plain
    ``log_mel_spectrogram``."""
    dev = resolve_device(device)
    a = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    if kernels and a.shape[-1] == N_SAMPLES:
        return log_mel_windows(a, n_mels, dtype=dtype)
    return log_mel_spectrogram(a, n_mels, dtype=dtype)
