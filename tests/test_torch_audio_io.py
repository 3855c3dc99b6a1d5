"""Audio file input of the port (whisper_rs_tpu_torch.audio.io, flac, mp3 and
runtime.native) against the JAX package's loaders on the CPU: WAV (int16,
float32, 24-bit, WAVE_FORMAT_EXTENSIBLE, stereo, 44.1 kHz), FLAC (mono,
stereo 44.1 kHz, 24-bit) and MP3 decode bit-equal, through the
pure-Python path and through the native library (built by the port into
``build/native``); the native and the Python path equal where nothing is
resampled, and within the JAX tests' 0.02 where two resamplers differ; bad
files raise the same errors.  MP3 cases skip where libmp3lame or libmpg123
is absent, as tests/test_mp3.py does."""

import struct

import numpy as np
import pytest

from whisper_rs_tpu.audio import flac as jax_flac
from whisper_rs_tpu.audio import io as jax_io
from whisper_rs_tpu.audio import mp3 as jax_mp3
from whisper_rs_tpu.runtime import native as jax_native
from whisper_rs_tpu_torch.audio import flac, io, mp3
from whisper_rs_tpu_torch.runtime import native

_HAVE_MP3 = (mp3._dlopen("libmp3lame.so.0", "libmp3lame.so") is not None
             and mp3._dlopen("libmpg123.so.0", "libmpg123.so") is not None)


def _signal(sr, secs, channels=1, seed=0):
    t = np.arange(int(sr * secs)) / sr
    x = 0.4 * np.sin(2 * np.pi * 440.0 * t)[:, None] * np.ones(channels)
    x = x + 0.05 * np.random.default_rng(seed).standard_normal(x.shape)
    return x.astype(np.float32)


def _wav(path, x, sr, kind):
    """PCM16 / float32 / PCM24 / extensible int32 WAV of [n, channels]."""
    ch = x.shape[1]
    if kind == "pcm16":
        tag, bits, data = 1, 16, (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    elif kind == "float32":
        tag, bits, data = 3, 32, x.astype("<f4").tobytes()
    elif kind == "pcm24":
        v = (np.clip(x, -1, 1) * 8388607).astype("<i4").reshape(-1)
        tag, bits = 1, 24
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1).astype("u1").tobytes()
    else:  # extensible, 32-bit int PCM by its SubFormat GUID
        tag, bits, data = 0xFFFE, 32, (np.clip(x, -1, 1) * 2147483647.0).astype("<i4").tobytes()
    align = ch * bits // 8
    fmt = struct.pack("<HHIIHH", tag, ch, sr, sr * align, align, bits)
    if tag == 0xFFFE:
        fmt += struct.pack("<HHII", 22, 32, 0, 1) + bytes.fromhex("000000001000800000aa00389b71")
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


CASES = {
    "wav_pcm16_mono_16k": (16000, 1, "pcm16"),
    "wav_float32_mono_16k": (16000, 1, "float32"),
    "wav_pcm24_mono_16k": (16000, 1, "pcm24"),
    "wav_extensible_int32_16k": (16000, 1, "extensible"),
    "wav_pcm16_stereo_16k": (16000, 2, "pcm16"),
    "wav_pcm16_stereo_44k1": (44100, 2, "pcm16"),
    "wav_float32_mono_22k05": (22050, 1, "float32"),
    "flac_mono_16k": (16000, 1, "flac16"),
    "flac_stereo_44k1": (44100, 2, "flac16"),
    "flac_24bit_mono_16k": (16000, 1, "flac24"),
}


def _write(tmp_path, name):
    sr, ch, kind = CASES[name]
    x = _signal(sr, 0.7, ch, seed=len(name))
    path = tmp_path / (name + (".flac" if kind.startswith("flac") else ".wav"))
    if kind.startswith("flac"):
        path.write_bytes(flac.encode_flac(x if ch > 1 else x[:, 0], sr,
                                          bps=24 if kind == "flac24" else 16))
    else:
        _wav(path, x, sr, kind)
    return path, sr


@pytest.mark.parametrize("name", sorted(CASES))
def test_python_path_is_bit_equal_to_jax(tmp_path, name):
    path, _ = _write(tmp_path, name)
    got = io.load_audio(path, use_native=False)
    want = jax_io.load_audio(path, use_native=False)
    assert got.dtype == np.float32 and got.ndim == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_path_is_bit_equal_to_jax_and_agrees_with_python(tmp_path, name):
    if not (native.available() and jax_native.available()):
        pytest.skip("no C++ toolchain: the native library is not built")
    path, sr = _write(tmp_path, name)
    got = native.load_audio(str(path))
    np.testing.assert_array_equal(got, jax_native.load_audio(str(path)))
    np.testing.assert_array_equal(io.load_audio(path, use_native=True), got)
    np.testing.assert_array_equal(io.load_audio(path), io.load_audio(path, use_native=False))
    py = io.load_audio(path, use_native=False)
    if sr == 16000:
        np.testing.assert_array_equal(got, py)
    else:  # two band-limited interpolators (the JAX tests' bound)
        n = min(len(got), len(py))
        assert abs(len(got) - len(py)) <= 2
        assert np.abs(got[200 : n - 200] - py[200 : n - 200]).max() < 0.02


def test_native_library_is_built_under_build(tmp_path):
    if not native.available():
        pytest.skip("no C++ toolchain: the native library is not built")
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parents[1].name == "build"
    x = _signal(22050, 0.3)[:, 0]
    np.testing.assert_array_equal(native.resample(x, 22050, 16000),
                                  jax_native.resample(x, 22050, 16000))


def test_flac_codec_matches_jax():
    x = _signal(44100, 0.3, 2)
    for order in (0, 1, 2, 3):
        blob = flac.encode_flac(x, 44100, fixed_order=order)
        assert blob == jax_flac.encode_flac(x, 44100, fixed_order=order)
        got, want = flac.decode_flac(blob), jax_flac.decode_flac(blob)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 44100


@pytest.mark.skipif(not _HAVE_MP3, reason="system mp3 codecs unavailable")
def test_mp3_is_bit_equal_to_jax(tmp_path):
    path = tmp_path / "tone.mp3"
    mp3.encode_mp3(str(path), _signal(16000, 1.0)[:, 0], sr=16000)
    assert mp3.is_mp3(path.read_bytes())
    got, want = mp3.decode_mp3(str(path)), jax_mp3.decode_mp3(str(path))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(io.load_audio(path, use_native=False),
                                  jax_io.load_audio(path, use_native=False))
    if native.available() and jax_native.available():
        np.testing.assert_array_equal(io.load_audio(path), jax_io.load_audio(path))


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("native_path", [False, None])
@pytest.mark.parametrize("bad", ["garbage.wav", "junk.mp3", "no_data.wav", "truncated.flac",
                                 "bits12.wav", "missing.wav"])
def test_bad_files_raise_the_same_errors(tmp_path, bad, native_path):
    path = tmp_path / bad
    if bad == "garbage.wav":
        path.write_bytes(b"this is not audio at all, just bytes" * 4)
    elif bad == "junk.mp3":
        path.write_bytes(b"\x00\x01\x02\x03 not audio at all")
    elif bad == "no_data.wav":
        path.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"WAVE")
    elif bad == "truncated.flac":
        path.write_bytes(flac.encode_flac(_signal(16000, 0.2)[:, 0], 16000)[:60])
    elif bad == "bits12.wav":
        _wav(path, _signal(16000, 0.1), 16000, "pcm16")
        data = bytearray(path.read_bytes())
        data[34:36] = struct.pack("<H", 12)  # bits per sample
        path.write_bytes(bytes(data))
    got = _raised(io.load_audio, path, use_native=native_path)
    want = _raised(jax_io.load_audio, path, use_native=native_path)
    assert got == want
