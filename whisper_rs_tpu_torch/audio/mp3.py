"""mp3 decode (and test-fixture encode) via ctypes-dlopened system codecs
(a copy of ``whisper_rs_tpu/audio/mp3.py``, which the port keeps so that
it imports nothing of the JAX package).

The fast path is the native C++ runtime (``runtime/audio_native.cpp``,
which dlopens libmpg123); this module is the pure-Python fallback using
the same library, so mp3 ingest works even when the C++ runtime isn't
built.  Both paths fail loudly when libmpg123 is absent rather than
silently mis-decoding.

``encode_mp3`` (libmp3lame) exists for test fixtures, mirroring
``flac.encode_flac``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11


def _dlopen(*names) -> Optional[ctypes.CDLL]:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def is_mp3(data: bytes) -> bool:
    """Sniff an mp3: ID3v2 tag or an MPEG audio frame sync."""
    if data[:3] == b"ID3":
        return True
    return len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an mp3 file -> (float32 [n, channels], sample_rate).

    Raises RuntimeError when libmpg123 is unavailable or decode fails —
    never silently returns wrong samples.
    """
    lib = _dlopen("libmpg123.so.0", "libmpg123.so")
    if lib is None:
        raise RuntimeError(
            "mp3 decode requires libmpg123 (not found); convert to wav/flac"
        )
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed")
    h = ctypes.c_void_p(h)
    try:
        # Force float32 output BEFORE open — mpg123_format after open does
        # not take effect for the already-negotiated stream, which silently
        # yields s16 bytes reinterpreted as floats.
        # MPG123_ADD_FLAGS=2, MPG123_FORCE_FLOAT=0x400.
        lib.mpg123_param.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double
        ]
        lib.mpg123_param(h, 2, 0x400, 0.0)
        if lib.mpg123_open(h, path.encode()) != 0:
            raise RuntimeError(f"mpg123 failed to open {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc)
        ) != 0:
            raise RuntimeError("mpg123_getformat failed")
        if enc.value != _MPG123_ENC_FLOAT_32:
            raise RuntimeError(
                f"mpg123 did not negotiate float32 output (enc={enc.value:#x})"
            )

        buf = (ctypes.c_ubyte * (1 << 16))()
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            r = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                n = done.value // 4
                chunks.append(
                    np.frombuffer(bytes(buf)[: done.value], "<f4", count=n)
                )
            if r == _MPG123_DONE:
                break
            if r not in (0, _MPG123_NEW_FORMAT) and not done.value:
                break
            done.value = 0
        if not chunks:
            raise RuntimeError("mp3 decode produced no samples")
        x = np.concatenate(chunks)
        ch = max(channels.value, 1)
        n = (len(x) // ch) * ch
        return x[:n].reshape(-1, ch), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def encode_mp3(path: str, audio: np.ndarray, sr: int = 16000,
               bitrate_kbps: int = 128) -> None:
    """Mono mp3 encoder via libmp3lame — test-fixture support only.

    Raises RuntimeError when libmp3lame is unavailable.
    """
    lame = _dlopen("libmp3lame.so.0", "libmp3lame.so")
    if lame is None:
        raise RuntimeError("mp3 encode requires libmp3lame (not found)")
    lame.lame_init.restype = ctypes.c_void_p
    gf = ctypes.c_void_p(lame.lame_init())
    if not gf:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gf, sr)
        lame.lame_set_out_samplerate(gf, sr)
        lame.lame_set_num_channels(gf, 1)
        lame.lame_set_mode(gf, 3)  # MONO
        lame.lame_set_brate(gf, bitrate_kbps)
        if lame.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")

        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
        n = len(pcm)
        out_size = int(1.25 * n + 7200)
        out = (ctypes.c_ubyte * out_size)()
        wrote = lame.lame_encode_buffer(
            gf,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            None,
            n,
            out,
            out_size,
        )
        if wrote < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({wrote})")
        data = bytes(out)[:wrote]
        wrote = lame.lame_encode_flush(gf, out, out_size)
        if wrote > 0:
            data += bytes(out)[:wrote]
        with open(path, "wb") as f:
            f.write(data)
    finally:
        lame.lame_close(gf)
