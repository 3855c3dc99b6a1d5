"""The port's quantisation against the JAX package, on the same seeded numpy
inputs, at the dims of tests/test_quantize.py (D 64, 4 heads, 2 + 2
layers, vocab 1000), on the CPU (the kernel wrappers take their plain
versions there):

  * ``quantize_params`` and ``quantize_kv``: int8 values and scales
    bit-equal to the JAX ones on the same f32 (and bf16) input, halves
    rounded to even;
  * ``params_from_jax`` of a JAX-quantised tree gives the port-quantised
    model exactly (the int8 ``.npz`` is in tests/test_torch_checkpoint.py);
  * ``QuantLinear`` within 1e-6 of the JAX ``linear`` with an ``"s"`` leaf;
  * row 10 (``self_attention_step``), the int8 branch of row 5
    (``cross_attention_step``) and of row 9 (``beam_self_attention_step``)
    against the Pallas kernels in interpret mode, within 1e-5, the port's
    ctx-major K transposed for JAX; row 10 with this step's k_new/v_new
    against the JAX int8 step (``_quantize_kv``, ``dynamic_update_slice``
    of the column and scales, then the Pallas kernel): the written int8
    column and scales bit-equal, the output within 1e-5;
  * one int8 decoder step's logits, and ``decode_greedy`` and
    ``decode_beam`` with ``quantize_kv=True``, against the JAX package with
    its Pallas kernels interpreted (``WHISPER_PALLAS_DECODE=interpret``);
  * the routes that refuse int8, the wrappers an int8 step calls, and the
    int8 greedy step's column left to row 10 (no ``KVCache.write``)."""

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import BeamSearchMode as JaxBeamSearchMode
from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_beam as jax_decode_beam
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.models import whisper as jax_whisper
from whisper_rs_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_rs_tpu.ops.decode_attention import beam_self_attention_step as jax_beam_step
from whisper_rs_tpu.ops.decode_attention import cross_attention_step as jax_cross_step
from whisper_rs_tpu.ops.decode_attention import self_attention_step as jax_self_step
from whisper_rs_tpu_torch.config import BeamSearchMode, GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import (
    FilterConfig,
    build_batch_prompts,
    decode_beam,
    decode_greedy,
)
from whisper_rs_tpu_torch.models import (
    KVCache,
    QuantLinear,
    decoder_forward,
    params_from_jax,
    precompute_cross_kv,
    quantize_kv,
    quantize_params,
)
from whisper_rs_tpu_torch.models import whisper as port_whisper
from whisper_rs_tpu_torch.ops.decode_attention import (
    beam_self_attention_step,
    cross_attention_step,
    self_attention_step,
)

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(
    n_vocab=1000, token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
    token_id_no_timestamps=599,
)
SOT, SOP, NO_SPEECH = 501, 503, 502


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX-quantised params, the port model of the former,
    port-quantised)."""
    params = init_params(jax.random.PRNGKey(0), JDIMS)
    qparams = jax_quantize_params(params)
    model = quantize_params(params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu"))
    return params, qparams, model


# ---------------------------------------------------------------------------
# the quantisation itself
# ---------------------------------------------------------------------------


def _jax_linears(tree: dict, prefix: str, cross: bool):
    """(port module name, JAX leaf dict, layer) of every linear of a block stack."""
    blocks = tree["blocks"]
    for i in range(blocks["attn_ln"]["scale"].shape[0]):
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            for n in ("query", "key", "value", "out"):
                yield f"{prefix}.blocks.{i}.{attn}.{n}", blocks[attn][n], i
        yield f"{prefix}.blocks.{i}.mlp.0", blocks["mlp"]["fc1"], i
        yield f"{prefix}.blocks.{i}.mlp.2", blocks["mlp"]["fc2"], i


def test_quantize_params_bit_equal_to_jax(weights):
    _, qparams, model = weights
    sd = model.state_dict()
    n = 0
    for side, cross in (("encoder", False), ("decoder", True)):
        for name, leaf, i in _jax_linears(qparams[side], side, cross):
            assert sd[f"{name}.weight"].dtype == torch.int8
            assert sd[f"{name}.scale"].dtype == torch.float32
            np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), np.asarray(leaf["w"][i]).T)
            np.testing.assert_array_equal(sd[f"{name}.scale"].numpy(), np.asarray(leaf["s"][i]))
            n += 1
    assert n == 2 * 6 + 2 * 10
    dec = qparams["decoder"]
    np.testing.assert_array_equal(sd["decoder.token_embedding.weight"].numpy(),
                                  np.asarray(dec["token_emb"]))
    np.testing.assert_array_equal(sd["decoder.token_embedding.scale"].numpy(),
                                  np.asarray(dec["token_emb_scale"]))
    # the conv stem, the LayerNorms and the positional embedding stay as they were
    for name in ("encoder.conv1.weight", "encoder.blocks.0.attn_ln.weight",
                 "decoder.positional_embedding", "decoder.blocks.1.mlp_ln.bias"):
        assert sd[name].dtype == torch.float32, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """In f32 whatever the input dtype; exact halves (a row of amax 127 has
    scale 1) round to even, as jnp.round does."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 100, 64)).astype(np.float32)
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]
    jx = jnp.asarray(x, dtype)
    jq, js = jax_whisper._quantize_kv(jx)
    q, s = quantize_kv(torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[..., 0])
    assert q[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 2, 0]


def test_params_from_quantized_jax_tree(weights):
    """A JAX-quantised tree loads with its int8 leaves int8: the same model
    as quantising in the port."""
    _, qparams, model = weights
    loaded = params_from_jax(jax.tree.map(np.asarray, qparams), DIMS, device="cpu")
    want = model.state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert isinstance(loaded.decoder.blocks[0].mlp[0], QuantLinear)


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax(bias):
    from whisper_rs_tpu.models.quantize import _quantize_linear

    rng = np.random.default_rng(0)
    w = rng.standard_normal((32, 16)).astype(np.float32) * 0.3  # JAX [in, out]
    b = rng.standard_normal(16).astype(np.float32) * 0.1
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    leaf = _quantize_linear({"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})})
    want = np.asarray(jax_whisper.linear(jnp.asarray(x), leaf))
    lin = QuantLinear(32, 16, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(np.asarray(leaf["w"]).T))
        lin.scale.copy_(torch.tensor(np.asarray(leaf["s"])))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert lin.to(torch.bfloat16).weight.dtype == torch.int8


# ---------------------------------------------------------------------------
# the three kernel pieces' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _int8_planes(rng, shape):
    """Quantised unit-scale planes: (int8 values, f32 scales [...])."""
    q, s = quantize_kv(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    return q.numpy(), s.numpy()


SELF_CASES = {
    "w128_bf16_cache": dict(B=3, H=4, pos=100, W=128, ks=None, int8=False),
    "w256_int8_key_start": dict(B=4, H=4, pos=255, W=256, ks=[0, 3, 231, 17], int8=True),
    "w448_int8_key_start": dict(B=2, H=2, pos=400, W=448, ks=[1, 231], int8=True),
    "w448_cache_key_start": dict(B=2, H=2, pos=400, W=448, ks=[5, 100], int8=False),
}


@pytest.mark.parametrize("case", list(SELF_CASES))
def test_self_attention_step_matches_pallas(case):
    c = SELF_CASES[case]
    rng = np.random.default_rng(len(case))
    L, B, H, n_ctx, dh, layer = 2, c["B"], c["H"], 448, 64, 1
    q = (rng.standard_normal((B, H, dh)) * dh**-0.5).astype(np.float32)
    ks = None if c["ks"] is None else np.asarray(c["ks"])
    if c["int8"]:
        (k, k_s), (v, v_s) = (_int8_planes(rng, (L, B, H, n_ctx, dh)) for _ in range(2))
        scales = dict(k_scale=jnp.asarray(k_s[..., None]), v_scale=jnp.asarray(v_s[..., None]))
        port_scales = dict(k_scale=torch.from_numpy(k_s), v_scale=torch.from_numpy(v_s))
    else:
        k, v = (rng.standard_normal((L, B, H, n_ctx, dh)).astype(np.float32) for _ in range(2))
        scales, port_scales = {}, {}
    want = jax_self_step(
        jnp.asarray(q), jnp.asarray(np.swapaxes(k, -1, -2)), jnp.asarray(v), jnp.int32(layer),
        jnp.int32(c["pos"]), None if ks is None else jnp.asarray(ks, jnp.int32), window=c["W"],
        interpret=True, **scales,
    )
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = self_attention_step(
        torch.from_numpy(q), kt, vt, layer, c["pos"], None if ks is None else torch.from_numpy(ks),
        window=c["W"], **port_scales,
    )
    assert got.shape == (B, H, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kt.numpy(), k)  # read only
    np.testing.assert_array_equal(vt.numpy(), v)


WRITE_CASES = {
    "w256_key_start": dict(B=4, H=4, dh=64, pos=255, W=256, ks=[0, 3, 231, 17]),
    "w448_key_start": dict(B=2, H=2, dh=64, pos=400, W=448, ks=[1, 231]),
    "w448_empty_window": dict(B=2, H=2, dh=64, pos=400, W=448, ks=[401, 5]),
    "dh16_w128": dict(B=3, H=4, dh=16, pos=100, W=128, ks=None),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_self_attention_step_column_write_matches_jax(case):
    """Row 10 given this step's k_new/v_new over an int8 cache, as the
    greedy step calls it, against the JAX int8 step (models/whisper.py):
    ``_quantize_kv`` of the column, ``dynamic_update_slice`` of it (K
    transposed) and of its scales, then the Pallas ``self_attention_step``
    interpreted.  The caches and scales afterwards bit-equal, the output
    within 1e-5; a row whose key_start is past pos still writes its column."""
    c = WRITE_CASES[case]
    rng = np.random.default_rng(len(case) + 40)
    L, B, H, n_ctx, dh, layer, pos = 2, c["B"], c["H"], 448, c["dh"], 1, c["pos"]
    q = (rng.standard_normal((B, H, dh)) * dh**-0.5).astype(np.float32)
    (k, k_s), (v, v_s) = (_int8_planes(rng, (L, B, H, n_ctx, dh)) for _ in range(2))
    k_new, v_new = (rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(2))
    ks = None if c["ks"] is None else np.asarray(c["ks"])

    jk, jk_s = jax_whisper._quantize_kv(jnp.asarray(k_new)[:, :, None])  # [B, H, 1, dh], [.., 1]
    jv, jv_s = jax_whisper._quantize_kv(jnp.asarray(v_new)[:, :, None])
    at = (layer, 0, 0, pos, 0)
    k_t = lax.dynamic_update_slice(jnp.asarray(np.swapaxes(k, -1, -2)), jk.swapaxes(-1, -2)[None],
                                   (layer, 0, 0, 0, pos))
    v_j = lax.dynamic_update_slice(jnp.asarray(v), jv[None], at)
    ks_j = lax.dynamic_update_slice(jnp.asarray(k_s[..., None]), jk_s[None], at)
    vs_j = lax.dynamic_update_slice(jnp.asarray(v_s[..., None]), jv_s[None], at)
    want = jax_self_step(
        jnp.asarray(q), k_t, v_j, jnp.int32(layer), jnp.int32(pos),
        None if ks is None else jnp.asarray(ks, jnp.int32), window=c["W"], k_scale=ks_j,
        v_scale=vs_j, interpret=True,
    )

    kt, vt, kst, vst = (torch.from_numpy(a.copy()) for a in (k, v, k_s, v_s))
    got = self_attention_step(
        torch.from_numpy(q), kt, vt, layer, pos, None if ks is None else torch.from_numpy(ks),
        window=c["W"], k_scale=kst, v_scale=vst, k_new=torch.from_numpy(k_new),
        v_new=torch.from_numpy(v_new),
    )
    np.testing.assert_array_equal(kt.numpy(), np.swapaxes(np.asarray(k_t), -1, -2))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(kst.numpy(), np.asarray(ks_j)[..., 0])
    np.testing.assert_array_equal(vst.numpy(), np.asarray(vs_j)[..., 0])
    assert not np.array_equal(kt.numpy()[layer, :, :, pos], k[layer, :, :, pos])  # written
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_self_attention_step_refuses_a_misplaced_column():
    """k_new and v_new go together, and only with an int8 cache (a cache in
    q's dtype takes its column through the append step)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    (k, k_s), (v, v_s) = (_int8_planes(rng, (1, 2, 4, 448, 64)) for _ in range(2))
    int8 = dict(k_scale=torch.from_numpy(k_s), v_scale=torch.from_numpy(v_s))
    planes = (torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(ValueError, match="go together"):
        self_attention_step(q, *planes, 0, 3, window=8, k_new=q, **int8)
    floats = torch.zeros(1, 2, 4, 448, 64)
    with pytest.raises(ValueError, match="int8 cache"):
        self_attention_step(q, floats, floats.clone(), 0, 3, window=8, k_new=q, v_new=q)


@pytest.mark.parametrize("G", [1, 5])
def test_cross_attention_int8_matches_pallas(G):
    rng = np.random.default_rng(G)
    L, A, H, Tk, dh, layer = 2, 2, 4, 96, 64, 1
    q = (rng.standard_normal((A, G, H, dh)) * dh**-0.5).astype(np.float32)
    (k, k_s), (v, v_s) = (_int8_planes(rng, (L, A, H, Tk, dh)) for _ in range(2))
    kv = np.stack([np.swapaxes(k, -1, -2), np.swapaxes(v, -1, -2)], axis=3)  # [L, A, H, 2, dh, Tk]
    want = jax_cross_step(
        jnp.asarray(q), jnp.asarray(kv), jnp.int32(layer), k_scale=jnp.asarray(k_s[..., None]),
        v_scale=jnp.asarray(v_s[..., None]), interpret=True,
    )
    got = cross_attention_step(torch.from_numpy(q), torch.from_numpy(kv), layer,
                               k_scale=torch.from_numpy(k_s), v_scale=torch.from_numpy(v_s))
    assert got.shape == (A, G, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("W,pos", [(256, 200), (448, 400)])
def test_beam_attention_int8_matches_pallas(W, pos):
    """Ancestors planted to differ within each audio, and scales that differ
    between the rows: slot j's scales come from its ancestor's row."""
    rng = np.random.default_rng(W)
    L, A, G, H, n_ctx, dh, layer = 2, 2, 3, 4, 448, 64, 1
    B = A * G
    q = (rng.standard_normal((B, H, dh)) * dh**-0.5).astype(np.float32)
    (k, k_s), (v, v_s) = (_int8_planes(rng, (L, B, H, n_ctx, dh)) for _ in range(2))
    assert (k_s[layer, 0] != k_s[layer, 1]).all() and (v_s[layer, 0] != v_s[layer, 1]).all()
    anc = rng.integers(0, G, (B, n_ctx)).astype(np.int32)
    anc[:, pos] = np.arange(B) % G
    assert (anc[0, :pos] != anc[1, :pos]).any()
    ks = np.asarray([3, 7, 0, 9, 1, 20])
    want = jax_beam_step(
        jnp.asarray(q), jnp.asarray(np.swapaxes(k, -1, -2)), jnp.asarray(v), jnp.int32(layer),
        jnp.int32(pos), jnp.asarray(ks, jnp.int32), jnp.asarray(anc), G, window=W,
        k_scale=jnp.asarray(k_s[..., None]), v_scale=jnp.asarray(v_s[..., None]), interpret=True,
    )
    got = beam_self_attention_step(
        torch.from_numpy(q), None, None, torch.from_numpy(k), torch.from_numpy(v), layer, pos,
        torch.from_numpy(ks), torch.from_numpy(anc), G, window=W, k_scale=torch.from_numpy(k_s),
        v_scale=torch.from_numpy(v_s),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the int8 decoder pass and the decode loops against the JAX package
# ---------------------------------------------------------------------------


def test_int8_prefill_and_step_logits_match_jax(weights, monkeypatch):
    """int8 weights and K/V: the prefill (per-row key_start) and one step at
    f32; the JAX step through its Pallas kernels (row 10 and row 5's int8
    branch, interpreted), the port's through their plain versions.  Logits
    within 1e-4, the tolerance of tests/test_model_parity.py; the cross
    K/V equal, the cache's int8 values equal and its scales within 1e-6
    relative (the two frameworks' f32 projections differ by an ulp)."""
    monkeypatch.setenv("WHISPER_PALLAS_DECODE", "interpret")
    _, qparams, model = weights
    rng = np.random.default_rng(4)
    B, P = 3, 6
    xa = (rng.standard_normal((B, 1500, 64)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, 900, (B, P)).astype(np.int32)
    step_tok = rng.integers(0, 900, (B, 1)).astype(np.int32)
    key_start = np.asarray([0, 2, 4], np.int32)

    jckv = jax_whisper.precompute_cross_kv(qparams, jnp.asarray(xa), JDIMS, quantize=True)
    jcache = jax_whisper.KVCache.init(JDIMS, B, quantize=True)
    jpre, jcache = jax_whisper.decoder_forward(qparams, jnp.asarray(tokens), jnp.int32(0), jckv,
                                               jcache, JDIMS, key_start=jnp.asarray(key_start))
    jstep, jcache = jax_whisper.decoder_forward(qparams, jnp.asarray(step_tok), jnp.int32(P),
                                                jckv, jcache, JDIMS, ctx_window=128,
                                                key_start=jnp.asarray(key_start))

    ckv = precompute_cross_kv(model, torch.from_numpy(xa), quantize=True)
    cache = KVCache.init(DIMS, B, torch.float32, "cpu", quantize=True)
    ks = torch.from_numpy(key_start).long()
    pre = decoder_forward(model, torch.from_numpy(tokens).long(), 0, ckv, cache, key_start=ks)
    step = decoder_forward(model, torch.from_numpy(step_tok).long(), P, ckv, cache, key_start=ks,
                           ctx_window=128, incremental=True)
    np.testing.assert_array_equal(ckv.kv.numpy(), np.asarray(jckv.kv))
    np.testing.assert_array_equal(ckv.k_scale.numpy(), np.asarray(jckv.k_scale)[..., 0])
    np.testing.assert_allclose(pre.numpy()[:, 4:], np.asarray(jpre)[:, 4:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
    np.testing.assert_array_equal(cache.k.numpy(), np.swapaxes(np.asarray(jcache.k), -1, -2))
    for got, want in ((cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("prompted", [False, True], ids=["unprompted", "prompted"])
def test_decode_greedy_int8_matches_jax(weights, prompted, monkeypatch):
    """int8 weights and int8 K/V through the whole greedy loop at f32, the
    JAX side with its Pallas kernels interpreted: tokens equal and scores
    within 1e-4 (no row's JAX top-2 margin comes near that here)."""
    monkeypatch.setenv("WHISPER_PALLAS_DECODE", "interpret")
    _, qparams, model = weights
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    if prompted:
        prompts = [list(rng.integers(10, 400, 9)), None]
        initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    else:
        initial, key_start, sample_begin, sot_idx = np.full((2, 1), SOT), None, 1, 0
    jres = jax_decode_greedy(
        qparams, jnp.asarray(mel), jnp.asarray(initial, jnp.int32), jnp.int32(sample_begin),
        jnp.int32(sot_idx), JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(), 8,
        no_speech_id=NO_SPEECH, key_start=None if key_start is None else jnp.asarray(key_start),
        quantize_kv=True,
    )
    tres = decode_greedy(
        model, torch.from_numpy(mel), initial, sample_begin, sot_idx, FilterConfig(**CFG_KW),
        GreedyMode(), 8, NO_SPEECH, key_start=key_start, quantize_kv=True,
    )
    assert tres.steps == 7
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tres.no_speech_probs.numpy(), np.asarray(jres.no_speech_probs),
                               rtol=1e-5, atol=1e-5)


def test_decode_beam_int8_kv_matches_jax(weights, monkeypatch):
    """Beam 3 with int8 K/V (f32 weights, as the int8-KV beam path runs),
    the JAX side through its Pallas beam kernel's int8 branch (ancestor
    table): candidates equal, scores within 1e-4."""
    monkeypatch.setenv("WHISPER_PALLAS_DECODE", "interpret")
    monkeypatch.setenv("WHISPER_BEAM_ANCESTOR", "1")
    params, _, _ = weights
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    mel = (np.random.default_rng(2).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    initial = np.full((2, 1), SOT)
    jres = jax_decode_beam(
        params, jnp.asarray(mel), jnp.asarray(initial, jnp.int32), jnp.int32(1), jnp.int32(0),
        JDIMS, JaxFilterConfig(**CFG_KW), JaxBeamSearchMode(beam_size=3), 8,
        no_speech_id=NO_SPEECH, quantize_kv=True,
    )
    tres = decode_beam(model, torch.from_numpy(mel), initial, 1, 0, FilterConfig(**CFG_KW),
                       BeamSearchMode(beam_size=3), 8, NO_SPEECH, quantize_kv=True)
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# refusals and the wrappers an int8 step calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ctx_int8_kv", "layer_int8_kv", "layer_int8_weights"])
def test_routes_refuse_int8(weights, case):
    """As in the JAX package: ctx and layer take no int8 K/V, and layer no
    int8 weights; decode_greedy refuses before the encoder runs."""
    params, _, qmodel = weights
    route = case.split("_")[0]
    int8_kv = case.endswith("kv")
    model = qmodel if not int8_kv else params_from_jax(
        jax.tree.map(np.asarray, params), DIMS, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        decode_greedy(model, torch.zeros(1, 80, 3000), np.full((1, 1), SOT), 1, 0,
                      FilterConfig(**CFG_KW), GreedyMode(), 4, NO_SPEECH, step_kernel=route,
                      quantize_kv=int8_kv)
    cache = KVCache.init(DIMS, 1, torch.float32, "cpu", quantize=int8_kv)
    ckv = precompute_cross_kv(model, torch.zeros(1, 1500, 64), quantize=int8_kv)
    with pytest.raises(ValueError, match="int8"):
        decoder_forward(model, torch.zeros(1, 1, dtype=torch.long), 3, ckv, cache,
                        incremental=True, step_kernel=route)


WRAPPERS = ("self_attention_step", "cross_attention_step", "beam_self_attention_step",
            "self_attention_append_step", "self_attention_fused_step", "decoder_mlp_step",
            "decoder_step_fused")


@pytest.fixture
def counted(monkeypatch):
    """Calls of each step wrapper through models/whisper.py."""
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        fn = getattr(port_whisper, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_whisper, name, wrapped)
    return calls


@pytest.mark.parametrize("path", ["greedy_int8_weights", "beam_int8_kv"])
def test_int8_steps_call_their_wrappers(weights, counted, path):
    """Greedy over int8 weights and K/V: row 10 and row 5 (int8) once a
    layer a step (row 5 also on the one-token prefill), the MLP as two int8
    linears (no MLP kernel); beam over int8 K/V with float weights: the
    beam wrapper's int8 read, row 5 and the MLP kernel.  Never the append,
    fused or whole-step kernels."""
    params, _, qmodel = weights
    mel = torch.from_numpy((np.random.default_rng(3).standard_normal((2, 80, 3000)) * 0.3)
                           .astype(np.float32))
    args = (np.full((2, 1), SOT), 1, 0, FilterConfig(**CFG_KW))
    if path == "greedy_int8_weights":
        res = decode_greedy(qmodel, mel, *args, GreedyMode(), 6, NO_SPEECH, quantize_kv=True)
        step_calls = {"self_attention_step": 1, "decoder_mlp_step": 0}
    else:
        model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
        res = decode_beam(model, mel, *args, BeamSearchMode(beam_size=3), 6, NO_SPEECH,
                          quantize_kv=True)
        step_calls = {"beam_self_attention_step": 1, "decoder_mlp_step": 1}
    L, steps = DIMS.n_text_layer, res.steps
    assert steps == 5
    want = dict.fromkeys(WRAPPERS, 0)
    want.update({k: L * steps * n for k, n in step_calls.items()})
    want["cross_attention_step"] = L * (steps + 1)  # and the one-token prefill
    assert counted == want


def test_int8_greedy_step_leaves_its_column_to_row_10(weights, monkeypatch):
    """On the int8 greedy path torch writes the cache only in the prefill
    (``KVCache.write`` once a layer); each step hands its K/V column to
    row 10, which quantises and writes it."""
    _, _, qmodel = weights
    writes, columns = [], []
    write = port_whisper.KVCache.write
    step = port_whisper.self_attention_step

    def counting_write(cache, layer, start, k, v):
        writes.append(k.shape[2])
        return write(cache, layer, start, k, v)

    def counting_step(*a, k_new=None, v_new=None, **kw):
        columns.append(k_new is not None and v_new is not None)
        return step(*a, k_new=k_new, v_new=v_new, **kw)

    monkeypatch.setattr(port_whisper.KVCache, "write", counting_write)
    monkeypatch.setattr(port_whisper, "self_attention_step", counting_step)
    mel = torch.from_numpy((np.random.default_rng(4).standard_normal((2, 80, 3000)) * 0.3)
                           .astype(np.float32))
    res = decode_greedy(qmodel, mel, np.full((2, 1), SOT), 1, 0, FilterConfig(**CFG_KW),
                        GreedyMode(), 6, NO_SPEECH, quantize_kv=True)
    assert writes == [1] * DIMS.n_text_layer  # the one-token prefill's, a layer
    assert columns == [True] * (DIMS.n_text_layer * res.steps) and res.steps == 5
