"""The plan that row 1's kernel (``csrc/mel.cu``) runs, emulated stage by
stage in numpy float32 from the constants ``ops/mel.py`` hands the kernel:
the window, the radix-8 and radix-5 butterflies, the Stockham index maps,
the f32 twiddles, the real-split post-pass and the sparse mel runs.  The
emulation is held against the plain version ``raw_log10_mel_plain`` and
against the JAX Pallas kernel in interpret mode at 1e-4 (the kernel's
tolerance on the card), on a seeded 2-window batch and on
``log_mel_file``'s strided 2-chunk view.  The sparse filter table rebuilds
the filterbank bit for bit and refuses a filter whose bins are not
contiguous."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.ops.mel_pallas import log_mel_file_pallas, log_mel_pallas
from whisper_rs_tpu_torch.audio import N_SAMPLES, mel_filterbank
from whisper_rs_tpu_torch.audio.constants import HOP_LENGTH, N_FFT, N_FRAMES
from whisper_rs_tpu_torch.ops import mel as ops_mel
from whisper_rs_tpu_torch.ops.mel import (
    FFT_M,
    FFT_RADICES,
    PADDED_LEN,
    fft_table,
    kernel_flops_per_frame,
    log_mel_file,
    mel_runs,
    raw_log10_mel_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _pairs(lo: int, hi: int) -> np.ndarray:
    """fft_table[lo:hi] as complex64."""
    t = fft_table()[lo:hi]
    return (t[0::2] + 1j * t[1::2]).astype(np.complex64)


def _dft8(v, c):
    """The kernel's radix-8 butterfly (csrc/mel.cu::dft8), f32."""
    a = [v[r] + v[r + 4] for r in range(4)]
    b = [v[r] - v[r + 4] for r in range(4)]
    neg_i = lambda x: (x.imag - 1j * x.real).astype(np.complex64)  # noqa: E731
    b[1] = (c * (b[1].real + b[1].imag) + 1j * (c * (b[1].imag - b[1].real))).astype(np.complex64)
    b[2] = neg_i(b[2])
    b[3] = (c * (b[3].imag - b[3].real) + 1j * (-c * (b[3].real + b[3].imag))).astype(
        np.complex64)
    y = [None] * 8
    for u, par in ((a, 0), (b, 1)):
        c0, c1, c2, c3 = u[0] + u[2], u[0] - u[2], u[1] + u[3], neg_i(u[1] - u[3])
        y[par], y[4 + par], y[2 + par], y[6 + par] = c0 + c2, c0 - c2, c1 + c3, c1 - c3
    return y


def _dft5(v, k5):
    """The kernel's radix-5 butterfly (csrc/mel.cu::dft5), f32."""
    c1, c2, s1, s2 = k5
    t1, t2, t3, t4 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
    a1 = v[0] + c1 * t1 + c2 * t2
    a2 = v[0] + c2 * t1 + c1 * t2
    b1 = s1 * t3 + s2 * t4
    b2 = s2 * t3 - s1 * t4
    ib1, ib2 = 1j * b1, 1j * b2
    return [v[0] + (t1 + t2), a1 - ib1, a2 - ib2, a2 + ib2, a1 + ib1]


def _stage(z, radix, ns, dft, tw=None):
    """One Stockham stage over frames z [F, M]: inputs v[r] = z[j + r M/R]
    times the twiddles tw[k, r - 1] (k = j % ns), a DFT of size R, outputs
    at (j // ns) ns R + k + r ns."""
    J = FFT_M // radix
    j = np.arange(J)
    k = j % ns
    v = [z[:, j + r * J] for r in range(radix)]
    if tw is not None:
        v = [v[0]] + [(v[r] * tw[k, r - 1]).astype(np.complex64) for r in range(1, radix)]
    y = dft(v)
    out = np.empty_like(z)
    base = (j // ns) * ns * radix + k
    for r in range(radix):
        out[:, base + r * ns] = y[r]
    return out


def emulated_power(frames: np.ndarray) -> np.ndarray:
    """[F, 400] f32 frames -> [F, 201] f32 powers, as the kernel computes
    them from fft_table."""
    t = fft_table()
    x = frames * t[ops_mel.TABLE_WINDOW:ops_mel.TABLE_W8]
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    assert FFT_RADICES == (8, 5, 5)
    k5 = [np.float32(c) for c in t[ops_mel.TABLE_C5:ops_mel.TABLE_TW2]]
    z = _stage(z, 8, 1, lambda v: _dft8(v, np.float32(t[ops_mel.TABLE_W8])))
    tw2 = _pairs(ops_mel.TABLE_TW2, ops_mel.TABLE_TW3).reshape(8, 4)
    tw3 = _pairs(ops_mel.TABLE_TW3, ops_mel.TABLE_POST).reshape(40, 4)
    z = _stage(z, 5, 8, lambda v: _dft5(v, k5), tw2)
    z = _stage(z, 5, 40, lambda v: _dft5(v, k5), tw3)
    k = np.arange(FFT_M // 2 + 1)
    za, zb = z[:, k], z[:, (FFT_M - k) % FFT_M]
    e = za + np.conj(zb)
    o = ((za.imag + zb.imag) + 1j * (zb.real - za.real)).astype(np.complex64)
    tt = (o * _pairs(ops_mel.TABLE_POST, ops_mel.TABLE_LEN)).astype(np.complex64)
    xp, xm = e + tt, e - tt
    power = np.empty((len(frames), FFT_M + 1), np.float32)
    power[:, FFT_M - k] = np.float32(0.25) * (xm.real * xm.real + xm.imag * xm.imag)
    power[:, k] = np.float32(0.25) * (xp.real * xp.real + xp.imag * xp.imag)
    return power


def emulated_raw_mel(padded: np.ndarray, n_mels: int) -> np.ndarray:
    """Rows of padded audio [B, >= 480240] -> [B, n_mels, 3000] log10 mel,
    the kernel's plan: FFT powers, each filter's run summed in ascending
    bin order, log10 of the clamped sum."""
    runs = mel_runs(mel_filterbank(n_mels))
    out = np.empty((len(padded), n_mels, N_FRAMES), np.float32)
    for b, row in enumerate(padded):
        frames = np.lib.stride_tricks.sliding_window_view(row, N_FFT)[::HOP_LENGTH][:N_FRAMES]
        power = emulated_power(np.ascontiguousarray(frames, np.float32))
        for m, (first, length, offset) in enumerate(runs.runs):
            acc = np.zeros(N_FRAMES, np.float32)
            for j in range(length):
                acc = acc + power[:, first + j] * runs.weights[offset + j]
            out[b, m] = np.log10(np.maximum(acc, np.float32(1e-10)))
    return out


def mel_dense(runs) -> np.ndarray:
    """The filterbank [n_mels, 201] f32 that the runs describe."""
    fb = np.zeros((len(runs.runs), N_FFT // 2 + 1), np.float32)
    for m, (first, length, offset) in enumerate(runs.runs):
        fb[m, first:first + length] = runs.weights[offset:offset + length]
    return fb


def _floor(raw: np.ndarray, axes) -> np.ndarray:
    floor = raw.max(axis=axes, keepdims=True) - 8.0
    return (np.maximum(raw, floor) + 4.0) / 4.0


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2, N_SAMPLES)) * 0.3).astype(np.float32)


def test_fft_plan_matches_numpy_rfft():
    """The emulated plan is the real DFT: powers of seeded frames against
    numpy's float64 rfft of the same windowed frames."""
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((64, N_FFT)).astype(np.float32)
    want = np.abs(np.fft.rfft(frames.astype(np.float64) * fft_table()[:N_FFT], axis=-1)) ** 2
    np.testing.assert_allclose(emulated_power(frames), want, rtol=2e-5, atol=2e-4)


def test_fft_table_constants():
    """Twiddles and butterfly constants are float64 values rounded to f32
    once; the window is the reference's periodic Hann window."""
    t = fft_table()
    assert t.dtype == np.float32 and t.size == ops_mel.TABLE_LEN
    np.testing.assert_array_equal(t[:N_FFT], ops_mel.hann_window(N_FFT))
    tw3 = _pairs(ops_mel.TABLE_TW3, ops_mel.TABLE_POST).reshape(40, 4)
    k, r = np.arange(40)[:, None], np.arange(1, 5)[None, :]
    want = np.exp(-2j * np.pi * r * k / 200)
    np.testing.assert_array_equal(tw3.real, want.real.astype(np.float32))
    np.testing.assert_array_equal(tw3.imag, want.imag.astype(np.float32))


def test_emulated_plan_matches_plain_and_pallas(windows):
    """A seeded 2-window batch: the emulated kernel plan against the plain
    version (raw log10 mel) and, after the per-utterance floor, against
    ``log_mel_pallas`` in interpret mode."""
    padded = ops_mel.reflect_pad(torch.from_numpy(windows)).numpy()
    got = emulated_raw_mel(padded, 80)
    plain = raw_log10_mel_plain(torch.from_numpy(padded), 80).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    want = np.asarray(log_mel_pallas(jnp.asarray(windows), interpret=True))
    np.testing.assert_allclose(_floor(got, (1, 2)), want, **TOL)


def test_emulated_plan_on_the_file_chunks():
    """``log_mel_file``'s strided view of a 35 s file's two overlapping
    chunks (row pitch 480000): the emulated plan against the plain version,
    and after the whole-file floor against ``log_mel_file_pallas`` in
    interpret mode and the port's ``log_mel_file``."""
    rng = np.random.default_rng(12)
    n = 35 * 16000
    audio = (rng.standard_normal(n) * 0.2).astype(np.float32)
    buf = torch.zeros(2 * N_SAMPLES)
    buf[:n] = torch.from_numpy(audio)
    padded = ops_mel.reflect_pad(buf[None])[0]
    chunks = padded.as_strided((2, PADDED_LEN), (N_SAMPLES, 1))
    got = emulated_raw_mel(chunks.numpy(), 80)
    np.testing.assert_allclose(got, raw_log10_mel_plain(chunks, 80).numpy(), **TOL)
    file_mel = _floor(got.transpose(1, 0, 2).reshape(80, -1), None)[:, : n // HOP_LENGTH]
    want = np.asarray(log_mel_file_pallas(audio, interpret=True))
    np.testing.assert_allclose(file_mel, want, **TOL)
    np.testing.assert_allclose(file_mel, log_mel_file(audio, device="cpu").numpy(), **TOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_runs_rebuild_the_filterbank(n_mels):
    """One run of contiguous bins a filter rebuilds ``mel_filterbank`` bit for
    bit; every weight is a nonzero and the runs fit the kernel's room."""
    fb = mel_filterbank(n_mels)
    runs = mel_runs(fb)
    np.testing.assert_array_equal(mel_dense(runs), fb)
    assert runs.weights.size == np.count_nonzero(fb) <= ops_mel.MAX_MEL_WEIGHTS
    assert runs.runs.shape == (n_mels, 3) and runs.runs.dtype == np.int32
    assert (runs.runs[1:, 2] == np.cumsum(runs.runs[:, 1])[:-1]).all()
    assert kernel_flops_per_frame(n_mels) < 12_000  # against 2 * 2 * 400 * 201 direct


def test_mel_runs_refuse_a_split_filter():
    fb = mel_filterbank(80).copy()
    bins = np.flatnonzero(fb[79])
    assert bins.size >= 3
    fb[79, bins[1]] = 0.0  # a hole inside the last filter
    with pytest.raises(ValueError, match="not contiguous"):
        mel_runs(fb)


def test_fft_plan_is_nearer_the_exact_dft_than_the_f32_matmul(windows):
    """On a seeded window, the kernel's plan (f32 FFT, sparse f32 mel sums)
    lands nearer the float64 log10 mel than the plain version (f32 matmuls
    against its f32 basis and filterbank) does."""
    padded = ops_mel.reflect_pad(torch.from_numpy(windows[:1])).numpy()
    frames = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(padded[0], N_FFT)[::HOP_LENGTH][:N_FRAMES])
    exact = np.fft.rfft(frames.astype(np.float64) * fft_table()[:N_FFT], axis=-1)
    fb = mel_filterbank(80).astype(np.float64)

    def log_mel(power):
        return np.log10(np.maximum(power.astype(np.float64) @ fb.T, 1e-10))

    want = log_mel(exact.real ** 2 + exact.imag ** 2)
    fft_err = np.abs(emulated_raw_mel(padded, 80)[0].T.astype(np.float64) - want).max()
    plain = raw_log10_mel_plain(torch.from_numpy(padded), 80).numpy()[0].T
    plain_err = np.abs(plain.astype(np.float64) - want).max()
    assert fft_err < plain_err
