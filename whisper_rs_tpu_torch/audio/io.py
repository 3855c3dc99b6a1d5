"""Host-side audio ingest: container decode, mono downmix, 16 kHz resample
(a copy of ``whisper_rs_tpu/audio/io.py``, which the port keeps so that it
imports nothing of the JAX package):

  * WAV (PCM 8/16/24/32-bit and IEEE float) parsed here (the native C++
    runtime, ``runtime/native.py``, decodes on request: ``use_native``);
    FLAC through
    ``audio/flac.py``, MP3 through ``audio/mp3.py`` (libmpg123);
  * mono downmix by channel mean;
  * resampling to 16 kHz by polyphase filtering (scipy): band-limited
    16 kHz mono out.

Output: 1-D float32 numpy array of 16 kHz samples.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Tuple

import numpy as np

from .constants import SAMPLE_RATE


def _parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser -> (float32 [n, channels], sample_rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    sub_format = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if len(body) >= 40:
                # WAVE_FORMAT_EXTENSIBLE: SubFormat GUID at fmt offset 24
                # (2B valid-bits + 4B channel mask precede it); data1 of
                # KSDATAFORMAT_SUBTYPE_PCM is 1, _IEEE_FLOAT is 3
                (sub_format,) = struct.unpack_from("<I", body, 24)
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError("missing fmt/data chunk")

    audio_fmt, n_ch, sr, _brate, _align, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        if sub_format not in (1, 3):
            raise ValueError(
                f"unsupported WAVE_FORMAT_EXTENSIBLE SubFormat {sub_format}"
            )
        audio_fmt = sub_format

    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(samples, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(samples, "u1").reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
                1 << 23
            )
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        x = np.frombuffer(samples, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_fmt}")

    n = (len(x) // n_ch) * n_ch
    return x[:n].reshape(-1, n_ch), sr


def resample_to_16k(x: np.ndarray, sr: int) -> np.ndarray:
    """Band-limited polyphase resample to 16 kHz mono."""
    if sr == SAMPLE_RATE:
        return x.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(SAMPLE_RATE, sr)
    return resample_poly(x, SAMPLE_RATE // g, sr // g).astype(np.float32)


def load_audio(path, use_native: bool = False) -> np.ndarray:
    """Decode an audio file -> float32 [n] mono 16 kHz.

    The pure-Python path by default, so that a transcript never depends on
    whether the host builds the native library; ``use_native`` takes the
    native C++ runtime instead (its windowed-sinc resampler differs from
    scipy's polyphase filter off 16 kHz) and raises where it is not built.
    """
    path = pathlib.Path(path)
    if use_native:
        from ..runtime import native

        out = native.load_audio(str(path))
        if out is None:
            raise RuntimeError("the native audio library is not built (no C++ toolchain)")
        return out

    data = path.read_bytes()
    if data[:4] == b"fLaC":
        from .flac import decode_flac

        x, sr = decode_flac(data)
    elif data[:4] != b"RIFF":
        from .mp3 import decode_mp3, is_mp3

        if not is_mp3(data):
            raise ValueError(f"unrecognized audio container: {path}")
        x, sr = decode_mp3(str(path))
    else:
        x, sr = _parse_wav(data)
    mono = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
    return resample_to_16k(mono, sr)


def write_wav(path, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """PCM16 WAV writer (test fixture support)."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    pathlib.Path(path).write_bytes(hdr + pcm)
