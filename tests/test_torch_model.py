"""The port's model (whisper_rs_tpu_torch.models) against the JAX package:
primitives (GELU in f32 and bf16, the conv stem, sinusoids), the cross K/V
precompute, and decoder prefill and step logits at 1e-4 (the tolerances of
tests/test_model_parity.py), with and without per-row ``key_start``; the
port's incremental decode against its own full prefill; and the dtype
check of int8 weights on load."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import KVCache as JaxKVCache
from whisper_rs_tpu.models import decoder_forward as jax_decoder_forward
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.models import precompute_cross_kv as jax_precompute_cross_kv
from whisper_rs_tpu.models import whisper as jax_whisper
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import (
    KVCache,
    decoder_forward,
    params_from_jax,
    precompute_cross_kv,
)
from whisper_rs_tpu_torch.models import whisper as port_whisper

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    params = init_params(jax.random.PRNGKey(7), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    rng = np.random.default_rng(3)
    xa = (rng.standard_normal((4, 1500, 64)) * 0.5).astype(np.float32)
    return params, model, xa


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    """Exact erf GELU in f32, the tanh form in bf16."""
    x = np.linspace(-5, 5, 2001, dtype=np.float32)
    want = np.asarray(jax_whisper.gelu(jnp.asarray(x, dtype)), np.float32)
    got = port_whisper.gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == "bfloat16":  # the tanh form, not erf, in half precision
        exact = np.asarray(jax_whisper.gelu(jnp.asarray(x)))
        assert np.abs(got - exact).max() > 0


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_stem_matches_jax(stride, models):
    params, model, _ = models
    conv = "conv1" if stride == 1 else "conv2"
    c_in = 80 if stride == 1 else 64
    x = np.random.default_rng(stride).standard_normal((2, 3000, c_in)).astype(np.float32)
    want = np.asarray(jax_whisper._conv1d_mm(jnp.asarray(x), params["encoder"][conv], stride))
    got = port_whisper.conv1d_mm(torch.from_numpy(x), getattr(model.encoder, conv), stride)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sinusoids_match_jax():
    np.testing.assert_array_equal(port_whisper.sinusoids(1500, 64), jax_whisper.sinusoids(1500, 64))


def test_cross_kv_matches_jax(models):
    params, model, xa = models
    want = np.asarray(jax_precompute_cross_kv(params, jnp.asarray(xa), JDIMS).kv)
    got = precompute_cross_kv(model, torch.from_numpy(xa)).kv
    assert got.shape == want.shape == (2, 4, 4, 2, 16, 1500)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _jax_prefill(params, xa, tokens, key_start=None, group=1):
    ckv = jax_precompute_cross_kv(params, jnp.asarray(xa), JDIMS)
    cache = JaxKVCache.init(JDIMS, tokens.shape[0])
    ks = None if key_start is None else jnp.asarray(key_start)
    logits, cache = jax_decoder_forward(
        params, jnp.asarray(tokens), jnp.int32(0), ckv, cache, JDIMS, key_start=ks,
        cross_group=group,
    )
    return ckv, cache, np.asarray(logits)


def _port_prefill(model, xa, tokens, key_start=None, group=1):
    ckv = precompute_cross_kv(model, torch.from_numpy(xa))
    cache = KVCache.init(DIMS, tokens.shape[0], torch.float32, "cpu")
    ks = None if key_start is None else torch.from_numpy(key_start).long()
    logits = decoder_forward(
        model, torch.from_numpy(tokens).long(), 0, ckv, cache, key_start=ks, cross_group=group
    )
    return ckv, cache, logits.numpy()


@pytest.mark.parametrize(
    "key_start,group", [(None, 1), (np.array([0, 2, 0, 3], np.int32), 1), (None, 2)],
    ids=["plain", "key_start", "group2"],
)
def test_decoder_prefill_and_step_match_jax(models, key_start, group):
    params, model, xa = models
    rng = np.random.default_rng(4)
    B = 4
    xa = xa[: B // group]
    tokens = rng.integers(0, 900, (B, 5)).astype(np.int32)
    step_tok = rng.integers(0, 900, (B, 1)).astype(np.int32)

    jckv, jcache, jlogits = _jax_prefill(params, xa, tokens, key_start, group)
    pckv, pcache, plogits = _port_prefill(model, xa, tokens, key_start, group)
    live = slice(None) if key_start is None else np.s_[:, 3:]  # real rows of every prompt
    np.testing.assert_allclose(plogits[live], jlogits[live], **TOL)

    ks_j = None if key_start is None else jnp.asarray(key_start)
    ks_p = None if key_start is None else torch.from_numpy(key_start).long()
    jstep, _ = jax_decoder_forward(
        params, jnp.asarray(step_tok), jnp.int32(5), jckv, jcache, JDIMS, key_start=ks_j,
        cross_group=group, ctx_window=128,
    )
    pstep = decoder_forward(
        model, torch.from_numpy(step_tok).long(), 5, pckv, pcache, key_start=ks_p,
        cross_group=group, ctx_window=128,
    )
    np.testing.assert_allclose(pstep.numpy(), np.asarray(jstep), **TOL)


def test_logit_positions_select_rows(models):
    _, model, xa = models
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 900, (2, 6))).long()
    ckv = precompute_cross_kv(model, torch.from_numpy(xa[:2]))
    full = decoder_forward(model, tokens, 0, ckv, KVCache.init(DIMS, 2, torch.float32, "cpu"))
    sel = decoder_forward(
        model, tokens, 0, ckv, KVCache.init(DIMS, 2, torch.float32, "cpu"),
        logit_positions=torch.tensor([0, 5]),
    )
    np.testing.assert_allclose(sel.numpy(), full[:, [0, 5]].numpy(), rtol=1e-5, atol=1e-5)


def test_incremental_decode_equals_full_prefill(models):
    _, model, xa = models
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, 900, (2, 7))).long()
    ckv = precompute_cross_kv(model, torch.from_numpy(xa[:2]))
    full = decoder_forward(model, tokens, 0, ckv, KVCache.init(DIMS, 2, torch.float32, "cpu"))
    cache = KVCache.init(DIMS, 2, torch.float32, "cpu")
    steps = [decoder_forward(model, tokens[:, :3], 0, ckv, cache)]
    for p in range(3, 7):
        steps.append(decoder_forward(model, tokens[:, p : p + 1], p, ckv, cache, ctx_window=128))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **TOL)


def test_int8_params_raise(models):
    """A quantised JAX tree loads with its weights int8 and their scales
    beside them; an int8 weight handed as floats (or floats as int8) raises
    instead of loading values without their int8 meaning."""
    from whisper_rs_tpu.models.quantize import quantize_params

    params, _, _ = models
    tree = jax.tree.map(np.asarray, quantize_params(params))
    model = params_from_jax(tree, DIMS, device="cpu")
    assert model.decoder.blocks[1].cross_attn.value.weight.dtype == torch.int8
    assert model.decoder.token_embedding.scale.dtype == torch.float32
    for leaf in ("w", "s"):
        bad = jax.tree.map(np.copy, tree)
        mlp = bad["decoder"]["blocks"]["mlp"]["fc1"]
        mlp[leaf] = mlp[leaf].astype(np.float32 if leaf == "w" else np.int8)
        with pytest.raises(ValueError, match="int8"):
            params_from_jax(bad, DIMS, device="cpu")
