"""Log-mel frontend: CUDA kernel, its plain version, the router
``log_mel_frontend`` for 30 s windows and the whole-file ``log_mel_file``
(counterpart of ``whisper_rs_tpu/ops/mel_pallas.py``).

``raw_log10_mel`` is the kernel (``csrc/mel.cu``): reflect-padded audio
rows [B, 480400] (a row pitch of its own, so the overlapping chunks of one
padded file are a strided view) -> log10 mel [B, n_mels, 3000], before the
dynamic-range floor.  The reflect padding and the ``max - 8`` floor and
``(x+4)/4`` scale stay plain PyTorch around it: per utterance for windows,
over the whole file for ``log_mel_file``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio.constants import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from ..audio.mel import _dft_basis, hann_window, log_mel_spectrogram, mel_filterbank, reflect_pad
from ..device import resolve_device
from . import LAUNCHES
from .build import I, P, check, kernel_function

PADDED_LEN = N_SAMPLES + N_FFT  # 480400 samples after centred reflect padding


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
    wcos, wsin, fb = _constants_on(padded.device, n_mels)
    B = padded.shape[0]
    out = torch.empty((B, n_mels, N_FRAMES), dtype=torch.float32, device=padded.device)
    fn = kernel_function("mel", "log_mel_f32", (P, P, P, P, P, I, I, I, P))
    err = fn(
        padded.data_ptr(), wcos.data_ptr(), wsin.data_ptr(), fb.data_ptr(),
        out.data_ptr(), B, n_mels, padded.stride(0),
        torch.cuda.current_stream(padded.device).cuda_stream,
    )
    check("mel", "log_mel_f32", err)
    LAUNCHES["log_mel"] += 1
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
