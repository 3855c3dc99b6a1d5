"""The port's append self-attention step (``ops/decode_attention.py``, its
plain version on the CPU) against the JAX Pallas
``self_attention_append_step`` in interpret mode: out within 1e-5, both
caches equal exactly (the port's ctx-major planes transposed and
lane-padded to the JAX layout).  Then the greedy loop that engages it and
the fused MLP on every incremental step: ``decode_greedy`` against the JAX
loop with both Pallas kernels interpreted, prompted with per-row
``key_start`` across the 128 -> 256 window phases, token-exact with
scores within 1e-4; each new wrapper is called ``n_text_layer x steps``
times, and never by the prefill."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.ops.decode_attention import append_ctx_pad
from whisper_rs_tpu.ops.decode_attention import self_attention_append_step as jax_append
from whisper_rs_tpu_torch.config import GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import FilterConfig, build_batch_prompts, decode_greedy
from whisper_rs_tpu_torch.models import KVCache, decoder_forward, params_from_jax
from whisper_rs_tpu_torch.models import precompute_cross_kv
from whisper_rs_tpu_torch.models import whisper as port_whisper
from whisper_rs_tpu_torch.ops.decode_attention import (
    self_attention_append_step,
    self_attention_append_step_plain,
)


def _to_jax_plane(c: np.ndarray) -> np.ndarray:
    """Port [L, B, H, n_ctx, dh] -> JAX [L, B, H, dh, ctx_pad], zero pad."""
    n_ctx = c.shape[3]
    t = np.swapaxes(c, -1, -2)
    return np.pad(t, ((0, 0),) * 4 + ((0, append_ctx_pad(n_ctx) - n_ctx),))


CASES = {
    # the cases of tests/test_decode_attention.py: key_start per row, pos
    # past the first 128 block; B = 1 with pos on a 128 boundary
    "key_start": dict(L=3, B=4, H=8, n_ctx=448, pos=130, W=256, layer=1, ks=[0, 3, 5, 0]),
    "single_row_pos128": dict(L=2, B=1, H=4, n_ctx=256, pos=128, W=256, layer=0, ks=None),
    # the full window, key_start up to pos (only the own slot visible)
    "full_window": dict(L=2, B=3, H=4, n_ctx=448, pos=447, W=448, layer=1, ks=[0, 200, 447]),
    "first_slot": dict(L=1, B=2, H=2, n_ctx=448, pos=0, W=128, layer=0, ks=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_append_step_matches_pallas(case):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    L, B, H, n_ctx, dh = c["L"], c["B"], c["H"], c["n_ctx"], 64
    k_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    v_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    q, k_new, v_new = ((rng.standard_normal((B, H, dh)) * 0.3).astype(np.float32) for _ in range(3))
    ks = None if c["ks"] is None else np.asarray(c["ks"])

    out_j, k_j, v_j = jax_append(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(_to_jax_plane(k_all)), jnp.asarray(_to_jax_plane(v_all)),
        jnp.int32(c["layer"]), jnp.int32(c["pos"]),
        None if ks is None else jnp.asarray(ks, jnp.int32), window=c["W"], interpret=True,
    )
    kt, vt = torch.from_numpy(k_all), torch.from_numpy(v_all)
    out = self_attention_append_step(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new), kt, vt,
        c["layer"], c["pos"], None if ks is None else torch.from_numpy(ks), window=c["W"],
    )
    assert out.shape == (B, H, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_to_jax_plane(kt.numpy()), np.asarray(k_j))
    np.testing.assert_array_equal(_to_jax_plane(vt.numpy()), np.asarray(v_j))


def test_append_step_bf16_keeps_weights_f32():
    """In bf16 the softmax weights stay f32 into the value product, as in the
    Pallas kernel: the port agrees with it within 2e-3 (about one bf16 ulp
    of the output here), where weights rounded to bf16 first, as the prefill
    path's ``attend`` does, miss by more."""
    rng = np.random.default_rng(11)
    L, B, H, n_ctx, dh, pos, W = 1, 2, 4, 256, 64, 200, 256
    k_all = rng.standard_normal((L, B, H, n_ctx, dh)).astype(np.float32)
    v_all = rng.standard_normal((L, B, H, n_ctx, dh)).astype(np.float32)
    q = (rng.standard_normal((B, H, dh)) * 0.5).astype(np.float32)
    k_new, v_new = (rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(2))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out_j = jax_append(
        bf(q), bf(k_new), bf(v_new), bf(_to_jax_plane(k_all)), bf(_to_jax_plane(v_all)),
        jnp.int32(0), jnp.int32(pos), None, window=W, interpret=True,
    )[0]
    want = np.asarray(out_j, np.float32)
    t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    kt, vt = t(k_all), t(v_all)
    got = self_attention_append_step(t(q), t(k_new), t(v_new), kt, vt, 0, pos, window=W)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-3)

    s = torch.einsum("bhd,bhwd->bhw", t(q).float(), kt[0, :, :, : pos + 1].float())
    w = torch.softmax(s, dim=-1).bfloat16()
    rounded = torch.einsum("bhw,bhwd->bhd", w.float(), vt[0, :, :, : pos + 1].float())
    assert np.abs(rounded.bfloat16().float().numpy() - want).max() > 2e-3


def test_append_step_rejects_pos_outside_window():
    k = torch.zeros(1, 1, 2, 16, 64)
    q = torch.zeros(1, 2, 64)
    for fn in (self_attention_append_step, self_attention_append_step_plain):
        with pytest.raises(ValueError, match="pos"):
            fn(q, q, q, k, k.clone(), 0, 8, window=8)


# ---------------------------------------------------------------------------
# the decoder's incremental branch and the greedy loop
# ---------------------------------------------------------------------------

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(
    n_vocab=1000, token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
    token_id_no_timestamps=599, suppress_blank=True, timestamps=True,
    suppress_ids=(3, 5), max_initial_timestamp_index=50,
)
SOT, SOP, NO_SPEECH = 501, 503, 502


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(7), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    mel = (np.random.default_rng(0).standard_normal((3, 80, 3000)) * 0.3).astype(np.float32)
    return params, model, mel


def test_incremental_step_equals_masked_step(setup):
    """The kernel branch of one decoder step (no additive mask, append
    attention, fused MLP) gives the logits and cache of the masked path,
    within 1e-5."""
    _, model, _ = setup
    rng = np.random.default_rng(4)
    xa = torch.from_numpy((rng.standard_normal((3, 1500, 64)) * 0.5).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 900, (3, 6)))
    key_start = torch.tensor([0, 2, 4])
    ckv = precompute_cross_kv(model, xa)
    caches = [KVCache.init(DIMS, 3, torch.float32, "cpu") for _ in range(2)]
    outs = []
    for cache, incremental in zip(caches, (False, True)):
        decoder_forward(model, tokens[:, :5], 0, ckv, cache, key_start=key_start)
        outs.append(decoder_forward(
            model, tokens[:, 5:], 5, ckv, cache, key_start=key_start, ctx_window=128,
            incremental=incremental,
        ))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-5, atol=1e-5)
    # layer 0's column comes from the same input: written exactly; later
    # layers' inputs went through the other MLP summation order
    for a, b in ((caches[1].k, caches[0].k), (caches[1].v, caches[0].v)):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.fixture
def counted(monkeypatch):
    """Count the decoder's calls of the two step wrappers (on the CPU they
    take their plain versions, so ``ops.LAUNCHES`` stays 0)."""
    calls = {"self_attention_append_step": 0, "decoder_mlp_step": 0}
    for name in calls:
        fn = getattr(port_whisper, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_whisper, name, wrapped)
    return calls


def test_decode_greedy_with_step_kernels_matches_jax(setup, counted, monkeypatch):
    params, model, mel = setup
    rng = np.random.default_rng(3)
    prompts = [None, list(rng.integers(10, 400, 20)), list(rng.integers(10, 400, 50))]
    initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    monkeypatch.setenv("WHISPER_FUSED_SELF", "append-interpret")
    monkeypatch.setenv("WHISPER_PALLAS_MLP", "interpret")
    jres = jax_decode_greedy(
        params, jnp.asarray(mel), jnp.asarray(initial), jnp.int32(sample_begin),
        jnp.int32(sot_idx), JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(), 100,
        no_speech_id=NO_SPEECH, key_start=jnp.asarray(key_start),
    )
    tres = decode_greedy(
        model, torch.from_numpy(mel), initial, sample_begin, sot_idx, FilterConfig(**CFG_KW),
        GreedyMode(), 100, NO_SPEECH, key_start=key_start,
    )
    assert tres.steps > 128 - sample_begin  # reached the 256 phase
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    expect = DIMS.n_text_layer * tres.steps
    assert counted == {"self_attention_append_step": expect, "decoder_mlp_step": expect}
