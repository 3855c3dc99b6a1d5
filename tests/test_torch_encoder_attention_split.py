"""Row 6, the split-head encoder attention: the port's plain version (what
``encoder_attention_split`` runs on the CPU) against the Pallas
``encoder_attention_pallas`` in interpret mode at head dims 16, 32 and 64,
an odd head count and ``n_valid < T`` (f32 within 1e-5; bf16 within the
bf16 tolerance ``chip_smoke.py`` holds row 4 and row 6 to on the card), and
the encoder routed by ``merged_kernel_takes`` against the JAX encoder at
head dim 16 and at an odd head count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import encoder_forward as jax_encoder_forward
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.ops.encoder_attention_pallas import encoder_attention_pallas
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import encoder_forward, params_from_jax
from whisper_rs_tpu_torch.ops import LAUNCHES
from whisper_rs_tpu_torch.ops.encoder_attention import (
    encoder_attention_split,
    encoder_attention_split_plain,
    merged_kernel_takes,
    split_kernel_takes,
)

TOL_BF16 = dict(atol=2e-3, rtol=1e-2)  # chip_smoke.TOL_BF16["encoder_attention_merged"]


def _inputs(B, H, T, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("n_valid", [None, 203])
def test_split_plain_matches_pallas_f32(dh, n_valid):
    B, H, T = 2, 3, 256
    q, k, v = _inputs(B, H, T, dh, seed=dh)
    scale = dh**-0.5
    want = np.asarray(encoder_attention_pallas(
        *map(jnp.asarray, (q, k, v)), scale, n_valid=n_valid, block_q=128, interpret=True))
    before = dict(LAUNCHES)
    got = encoder_attention_split(*map(torch.from_numpy, (q, k, v)), scale, n_valid)
    assert LAUNCHES == before  # the CPU takes the plain version, uncounted
    assert got.shape == (B, H, T, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dh", [16, 64])
def test_split_plain_matches_pallas_bf16(dh):
    B, H, T, n_valid = 1, 5, 256, 230
    q, k, v = _inputs(B, H, T, dh, seed=7 + dh)
    scale = dh**-0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(encoder_attention_pallas(jq, jk, jv, scale, n_valid=n_valid, block_q=128,
                                               interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = encoder_attention_split_plain(tq, tk, tv, scale, n_valid)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL_BF16)


@pytest.mark.parametrize("n_valid", [None, 203])
def test_split_takes_the_heads_of_merged_tensors(n_valid):
    """The encoder hands row 6 the heads of its [B, T, D] projections as
    views (``split_heads``, no copy); on those strides the result equals
    the one on contiguous copies."""
    from whisper_rs_tpu_torch.models.whisper import split_heads

    B, T, H, dh = 2, 256, 4, 16
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H * dh)).astype(np.float32))
               for _ in range(3))
    views = [split_heads(t, H) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = encoder_attention_split(*views, dh**-0.5, n_valid)
    want = encoder_attention_split(*(t.contiguous() for t in views), dh**-0.5, n_valid)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_routes():
    """The encoder's route is the JAX one; the split kernel's instances are
    16 and 64."""
    assert merged_kernel_takes(8, 64) and merged_kernel_takes(20, 64)
    assert not merged_kernel_takes(5, 64)  # odd head count: split
    assert not merged_kernel_takes(4, 16)  # the golden dims: split
    assert [d for d in (8, 16, 24, 32, 48, 64, 80, 96, 128, 256) if split_kernel_takes(d)] == [
        16, 64]


def _dims(state, head):
    return dict(
        n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=state,
        n_audio_head=head, n_audio_layer=2, n_text_ctx=448, n_text_state=state,
        n_text_head=head, n_text_layer=2,
    )


@pytest.mark.parametrize("state,head", [(64, 4), (192, 3)], ids=["dh16", "dh64-odd-heads"])
def test_routed_encoder_matches_jax(state, head, monkeypatch):
    """Both shapes take the split route in the port and in the JAX encoder
    (XLA on the CPU); the port's result equals the JAX one at 2e-4, as the
    encoder test holds the merged route."""
    assert not merged_kernel_takes(head, state // head)
    jdims = JaxDims(**_dims(state, head))
    params = init_params(jax.random.PRNGKey(7), jdims)
    mel = (np.random.default_rng(4).standard_normal((1, 80, 3000)) * 0.3).astype(np.float32)
    monkeypatch.setenv("WHISPER_PALLAS_ENCODER", "0")
    want = np.asarray(jax_encoder_forward(params, jnp.asarray(mel), jdims))
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**_dims(state, head)),
                            device="cpu")
    got = encoder_forward(model, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
