"""The port's mel frontend (whisper_rs_tpu_torch.audio.mel, ops.mel) against
the JAX package: the plain log-mel against ``log_mel_spectrogram``, the
kernel path (its plain version on the CPU) against ``log_mel_pallas`` in
interpret mode, and both against the reference CSV fixtures, at 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.audio import log_mel_spectrogram as jax_log_mel
from whisper_rs_tpu.audio import mel_filterbank as jax_filterbank
from whisper_rs_tpu.ops.mel_pallas import log_mel_pallas
from whisper_rs_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram, mel_filterbank, pad_or_trim
from whisper_rs_tpu_torch.ops import LAUNCHES
from whisper_rs_tpu_torch.ops.mel import log_mel_frontend, log_mel_windows

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, N_SAMPLES)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_matches_jax(n_mels):
    np.testing.assert_allclose(mel_filterbank(n_mels), jax_filterbank(n_mels), rtol=1e-6, atol=1e-9)


def test_filterbank_golden_csv(ref_mel_filter_8x8):
    np.testing.assert_allclose(mel_filterbank(80)[:8, :8], ref_mel_filter_8x8, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("seconds", [2.0, 30.0])
def test_plain_log_mel_matches_jax(seconds):
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(int(16000 * seconds)) * 0.2).astype(np.float32)
    want = np.asarray(jax_log_mel(jnp.asarray(audio)))
    got = log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_path_matches_pallas_interpret(windows):
    want = np.asarray(log_mel_pallas(jnp.asarray(windows), interpret=True))
    before = dict(LAUNCHES)
    got = log_mel_windows(torch.from_numpy(windows)).numpy()
    assert got.shape == want.shape == (2, 80, 3000)
    np.testing.assert_allclose(got, want, **TOL)
    assert LAUNCHES == before  # the CPU path launches no kernel


def test_frontend_routes_and_agrees(windows):
    """30 s windows take the kernel route, other lengths the plain one; on
    30 s windows the two agree, and the output is cast to ``dtype``."""
    k = log_mel_frontend(windows, device="cpu")
    p = log_mel_frontend(windows, device="cpu", kernels=False)
    np.testing.assert_allclose(k.numpy(), p.numpy(), **TOL)
    short = log_mel_frontend(windows[:, :32000], device="cpu")
    assert short.shape == (2, 80, 200)
    bf = log_mel_frontend(windows[0], device="cpu", dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.shape == (80, 3000)


def test_golden_spectrogram_contract(ref_mel_spectrogram, windows):
    """The reference CSV fixes the output contract: 80 mel rows, values at
    most 2 and within 2 of the row maximum after the max - 8 floor; the
    port's output holds the same contract."""
    got = log_mel_frontend(windows[0], device="cpu").numpy()
    for spec in (ref_mel_spectrogram, got):
        assert spec.shape[0] == 80
        assert spec.max() <= 2.0 + 1e-6
        assert spec.max() - spec.min() <= 2.0 + 1e-6


def test_pad_or_trim():
    x = torch.ones(80, 1234)
    assert pad_or_trim(x, 3000).shape == (80, 3000)
    assert float(pad_or_trim(x, 3000)[:, 1234:].sum()) == 0.0
    assert pad_or_trim(x, 1000).shape == (80, 1000)
