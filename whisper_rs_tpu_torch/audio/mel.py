"""Log-mel spectrogram, plain PyTorch (counterpart of
``whisper_rs_tpu/audio/mel.py``).

Same math as the JAX reference: slaney-scale area-normalised filterbank;
centred reflect-padded STFT (n_fft 400, hop 160, periodic Hann) as two f32
matmuls against a cos/sin DFT basis; drop the last frame; power; mel
projection; log10 with a 1e-10 clamp; floor at the per-utterance max - 8;
then (x + 4) / 4.  The matmuls run in full f32: a float32 matmul on the
card does so unless ``torch.backends.cuda.matmul.allow_tf32`` is set, and
TF32's three digits would wreck the log-floor bins.

This is the plain version; ``ops/mel.py`` holds the CUDA kernel for exact
30 s windows and the router ``log_mel_frontend``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .constants import HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f_sp = 200.0 / 3.0
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freqs >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = N_MELS, sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT
) -> np.ndarray:
    """[n_mels, n_fft//2+1] slaney-normalised triangular filterbank (f32)."""
    fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, fmax, n_fft // 2 + 1)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(0.0)),
        _hz_to_mel_slaney(np.array(fmax)),
        n_mels + 2,
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_basis(n_fft: int = N_FFT) -> tuple:
    """(cos, sin) each [n_fft, n_fft//2+1]: re = x @ cos, im = x @ sin is the
    one-sided DFT of frame x (im negated, which power ignores)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window`` default)."""
    n = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)


def pad_or_trim(x: torch.Tensor, length: int, dim: int = -1) -> torch.Tensor:
    """Zero-pad or trim ``dim`` to exactly ``length``."""
    size = x.shape[dim]
    if size > length:
        return x.narrow(dim, 0, length)
    if size < length:
        shape = list(x.shape)
        shape[dim] = length - size
        return torch.cat([x, x.new_zeros(shape)], dim=dim)
    return x


def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """[B, n] -> [B, n + n_fft] centred reflect padding (torch.stft center=True)."""
    pad = N_FFT // 2
    return F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def log_mel_spectrogram(
    audio: torch.Tensor, n_mels: int = N_MELS, *, dtype=torch.float32
) -> torch.Tensor:
    """[n_samples] or [B, n_samples] audio -> [(B,) n_mels, n_frames], on the
    audio's device.  The max - 8 floor is per utterance."""
    squeeze = audio.ndim == 1
    a = audio.float()
    if squeeze:
        a = a[None]
    dev = a.device
    window = torch.from_numpy(hann_window()).to(dev)
    cos_b, sin_b = (torch.from_numpy(m).to(dev) for m in _dft_basis())
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

    frames = reflect_pad(a).unfold(-1, N_FFT, HOP_LENGTH)  # [B, 1 + n//hop, 400]
    frames = frames[:, :-1] * window  # the reference drops the last frame
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ fb.T  # [B, n_frames, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    out = ((log_spec + 4.0) / 4.0).transpose(1, 2).to(dtype)
    return out[0] if squeeze else out
