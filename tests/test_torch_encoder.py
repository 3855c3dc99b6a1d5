"""The port's encoder kernels (their plain versions on the CPU) and
``encoder_forward`` against the JAX package: residual_ln/ln_fused and the
merged-head attention against the Pallas kernels in interpret mode at 2e-5,
the whole encoder at 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import encoder_forward as jax_encoder_forward
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.ops.encoder_attention_pallas import (
    encoder_attention_merged as jax_attention_merged,
)
from whisper_rs_tpu.ops.encoder_fused import ln_fused as jax_ln_fused
from whisper_rs_tpu.ops.encoder_fused import residual_ln as jax_residual_ln
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import encoder_forward, params_from_jax
from whisper_rs_tpu_torch.ops.encoder_attention import encoder_attention_merged
from whisper_rs_tpu_torch.ops.encoder_fused import ln_fused, residual_ln


def _np(x):
    return np.asarray(x, np.float32)


# the encoder's shapes, then the decoder step's rows (5 and 40 rows of width 1)
@pytest.mark.parametrize("shape", [(3, 64, 128), (1, 40, 512), (5, 1, 64), (40, 1, 384)])
def test_residual_ln_and_ln_match_pallas(shape):
    rng = np.random.default_rng(2)
    D = shape[-1]
    x, d = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    scale, bias = (rng.standard_normal(D).astype(np.float32) for _ in range(2))

    jy, jln = jax_residual_ln(*map(jnp.asarray, (x, d, scale, bias)), interpret=True)
    ty, tln = residual_ln(*map(torch.from_numpy, (x, d, scale, bias)))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tln.numpy(), _np(jln), rtol=2e-5, atol=2e-5)

    jl = jax_ln_fused(*map(jnp.asarray, (x, scale, bias)), interpret=True)
    tl = ln_fused(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_valid", [None, 200])
def test_merged_attention_matches_pallas(n_valid):
    B, H, T, dh = 2, 2, 256, 64
    D = H * dh
    rng = np.random.default_rng(5)
    q, k, v = ((rng.standard_normal((B, T, D)) * 0.5).astype(np.float32) for _ in range(3))
    scale = dh**-0.5
    want = _np(
        jax_attention_merged(
            *map(jnp.asarray, (q, k, v)), H, scale, n_valid=n_valid, block_q=128,
            interpret=True,
        )
    )
    got = encoder_attention_merged(*map(torch.from_numpy, (q, k, v)), H, scale, n_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _dims(state, head):
    return dict(
        n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=state,
        n_audio_head=head, n_audio_layer=2, n_text_ctx=448, n_text_state=state,
        n_text_head=head, n_text_layer=2,
    )


@pytest.mark.parametrize(
    "state,head,pallas_env",
    [(64, 4, "0"), (128, 2, "interpret")],
    ids=["xla-dh16", "pallas-interpret-dh64"],
)
def test_encoder_forward_matches_jax(state, head, pallas_env, monkeypatch):
    """Tiny widths (the golden-test dims), and head dim 64 with the JAX
    encoder on its Pallas kernels in interpret mode."""
    jdims = JaxDims(**_dims(state, head))
    params = init_params(jax.random.PRNGKey(7), jdims)
    rng = np.random.default_rng(4)
    mel = (rng.standard_normal((1, 80, 3000)) * 0.3).astype(np.float32)
    monkeypatch.setenv("WHISPER_PALLAS_ENCODER", pallas_env)
    want = _np(jax_encoder_forward(params, jnp.asarray(mel), jdims))

    model = params_from_jax(
        jax.tree.map(np.asarray, params), ModelDims(**_dims(state, head)), device="cpu"
    )
    got = encoder_forward(model, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
