"""The port's two greedy-step variants against the JAX package, on the CPU
(the kernel wrappers take their plain versions there):

  * ``decoder_step_fused`` (``ops/decoder_layer_fused.py``, the whole
    decoder step in one launch on the card) through ``TextDecoder.forward(
    step_kernel="layer")`` against the JAX megakernel branch of
    ``decoder_forward`` (``WHISPER_PALLAS_DECODE=layer``, Pallas interpret
    mode): logits within 2e-5 and the caches, with the written K/V column,
    within 1e-5, on the same prefilled cache and cross K/V;
  * ``self_attention_fused_step`` against the JAX Pallas
    ``self_attention_fused_step(interpret=True)`` within 1e-5;
  * ``decode_greedy(step_kernel="layer" | "ctx")`` against the JAX
    ``decode_greedy`` in the same mode: candidates token-exact, scores
    within 1e-4, unprompted and prompted with per-row ``key_start``; each
    route calls its kernel wrappers as often as it should;
  * a beam step (``ancestors``) refuses both routes.

Dims of ``tests/test_layer_fused.py``: D 128, 2 heads, 3 layers, vocab
1000 (the JAX megakernel's gate needs D % 128 == 0)."""

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
from whisper_rs_tpu.models.whisper import KVCache as JaxKVCache
from whisper_rs_tpu.models.whisper import decoder_forward as jax_decoder_forward
from whisper_rs_tpu.models.whisper import encoder_forward as jax_encoder_forward
from whisper_rs_tpu.models.whisper import precompute_cross_kv as jax_precompute_cross_kv
from whisper_rs_tpu.ops.decode_attention import self_attention_fused_step as jax_fused_step
from whisper_rs_tpu_torch.config import GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import FilterConfig, build_batch_prompts, decode_greedy
from whisper_rs_tpu_torch.models import CrossKV, KVCache, decoder_forward, params_from_jax
from whisper_rs_tpu_torch.models import whisper as port_whisper
from whisper_rs_tpu_torch.ops.decode_attention import (
    self_attention_fused_step,
    self_attention_fused_step_plain,
)

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=3,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(
    n_vocab=1000, token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
    token_id_no_timestamps=599, suppress_blank=True, timestamps=True,
    suppress_ids=(3, 5), max_initial_timestamp_index=50,
)
SOT, SOP, NO_SPEECH = 501, 503, 502


@pytest.fixture(scope="module")
def weights():
    params = init_params(jax.random.PRNGKey(0), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    return params, model


def _prefilled(params, group: int, batch: int, prompt: int, seed: int = 0):
    """The JAX side's prefilled cache, cross K/V and the step's token, as in
    tests/test_layer_fused.py."""
    rng = np.random.default_rng(seed)
    mel = jnp.asarray(rng.standard_normal((batch // group, 80, 3000)).astype(np.float32) * 0.3)
    ckv = jax_precompute_cross_kv(params, jax_encoder_forward(params, mel, JDIMS), JDIMS)
    cache = JaxKVCache.init(JDIMS, batch, dtype=jnp.float32)
    toks = jnp.asarray(rng.integers(0, 900, (batch, prompt)), jnp.int32)
    _, cache = jax_decoder_forward(params, toks, jnp.int32(0), ckv, cache, JDIMS, cross_group=group)
    tok1 = jnp.asarray(rng.integers(0, 900, (batch, 1)), jnp.int32)
    return ckv, cache, tok1


STEP_CASES = {
    "g1_w128_key_start": (1, 128, [0, 1, 2, 0], 4, 5),
    "g2_full_window_key_start": (2, None, [0, 1, 2, 0], 4, 5),
    "g1_no_key_start": (1, None, None, 2, 3),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_layer_step_matches_jax_megakernel(weights, case, monkeypatch):
    """One incremental step through the port's ``step_kernel="layer"``
    route and the JAX megakernel, from the same prefilled cache (the JAX
    K transposed to the port's ctx-major planes) and cross K/V."""
    group, window, ks, batch, prompt = STEP_CASES[case]
    params, model = weights
    ckv, cache, tok1 = _prefilled(params, group, batch, prompt)
    monkeypatch.setenv("WHISPER_PALLAS_DECODE", "layer")
    jlogits, jcache = jax_decoder_forward(
        params, tok1, jnp.int32(prompt), ckv, cache._replace(k=cache.k.swapaxes(-1, -2)), JDIMS,
        key_start=None if ks is None else jnp.asarray(ks, jnp.int32), cross_group=group,
        ctx_window=window, k_ctx_major=True,
    )
    pcache = KVCache(
        torch.from_numpy(np.ascontiguousarray(np.asarray(cache.k).swapaxes(-1, -2))),
        torch.from_numpy(np.array(cache.v)),
    )
    plogits = decoder_forward(
        model, torch.from_numpy(np.asarray(tok1, np.int64)), prompt,
        CrossKV(torch.from_numpy(np.array(ckv.kv))), pcache,
        key_start=None if ks is None else torch.tensor(ks), cross_group=group,
        ctx_window=window, incremental=True, step_kernel="layer",
    )
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
    # the JAX megakernel's K comes back ctx-major, the port's layout
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pcache.v.numpy(), np.asarray(jcache.v), rtol=1e-5, atol=1e-5)
    assert np.abs(pcache.k[:, :, :, prompt].numpy()).min() > 0  # the column was written


FUSED_CASES = {
    "key_start": dict(L=3, B=4, H=8, n_ctx=448, pos=130, W=256, layer=1, ks=[0, 3, 5, 0]),
    "full_window": dict(L=2, B=3, H=4, n_ctx=448, pos=447, W=448, layer=1, ks=[0, 200, 447]),
    "first_slot": dict(L=1, B=2, H=2, n_ctx=448, pos=0, W=128, layer=0, ks=None),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_step_matches_pallas(case):
    """Row 11 reads the ctx-major planes as they are and writes nothing."""
    c = FUSED_CASES[case]
    rng = np.random.default_rng(len(case))
    L, B, H, n_ctx, dh = c["L"], c["B"], c["H"], c["n_ctx"], 64
    k_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    v_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    q = (rng.standard_normal((B, H, dh)) * 0.3).astype(np.float32)
    ks = None if c["ks"] is None else np.asarray(c["ks"])
    want = jax_fused_step(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all), jnp.int32(c["layer"]),
        jnp.int32(c["pos"]), None if ks is None else jnp.asarray(ks, jnp.int32), window=c["W"],
        interpret=True,
    )
    kt, vt = torch.from_numpy(k_all), torch.from_numpy(v_all)
    for fn in (self_attention_fused_step, self_attention_fused_step_plain):
        got = fn(torch.from_numpy(q), kt, vt, c["layer"], c["pos"],
                 None if ks is None else torch.from_numpy(ks), window=c["W"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kt.numpy(), k_all)
    np.testing.assert_array_equal(vt.numpy(), v_all)


@pytest.fixture
def counted(monkeypatch):
    """Count the decoder's calls of the step wrappers (on the CPU they take
    their plain versions, so ``ops.LAUNCHES`` stays 0)."""
    names = ("self_attention_append_step", "self_attention_fused_step", "decoder_mlp_step",
             "cross_attention_step", "decoder_step_fused")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(port_whisper, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_whisper, name, wrapped)
    return calls


ROUTE_ENV = {
    "layer": {"WHISPER_PALLAS_DECODE": "layer"},
    "ctx": {"WHISPER_PALLAS_DECODE": "0", "WHISPER_FUSED_SELF": "interpret"},
}


@pytest.mark.parametrize("prompted", [False, True], ids=["unprompted", "prompted"])
@pytest.mark.parametrize("route", ["layer", "ctx"])
def test_decode_greedy_route_matches_jax(weights, route, prompted, counted, monkeypatch):
    params, model = weights
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((3, 80, 3000)) * 0.3).astype(np.float32)
    if prompted:
        prompts = [None, list(rng.integers(10, 400, 9)), list(rng.integers(10, 400, 20))]
        initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    else:
        initial, key_start, sample_begin, sot_idx = np.full((3, 1), SOT), None, 1, 0
    for name, value in ROUTE_ENV[route].items():
        monkeypatch.setenv(name, value)
    jres = jax_decode_greedy(
        params, jnp.asarray(mel), jnp.asarray(initial, jnp.int32), jnp.int32(sample_begin),
        jnp.int32(sot_idx), JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(), 8,
        no_speech_id=NO_SPEECH, key_start=None if key_start is None else jnp.asarray(key_start),
    )
    tres = decode_greedy(
        model, torch.from_numpy(mel), initial, sample_begin, sot_idx, FilterConfig(**CFG_KW),
        GreedyMode(), 8, NO_SPEECH, key_start=key_start, step_kernel=route,
    )
    assert tres.steps == 7
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    L, steps = DIMS.n_text_layer, tres.steps
    one_token_prefill = 1 if sample_begin == 1 else 0  # a width-1 pass takes the cross kernel
    if route == "layer":
        expect = {"decoder_step_fused": steps, "self_attention_fused_step": 0,
                  "cross_attention_step": L * one_token_prefill, "decoder_mlp_step": 0}
    else:
        expect = {"decoder_step_fused": 0, "self_attention_fused_step": L * steps,
                  "cross_attention_step": L * (steps + one_token_prefill),
                  "decoder_mlp_step": L * steps}
    assert counted == {"self_attention_append_step": 0, **expect}


@pytest.mark.parametrize("route", ["layer", "ctx"])
def test_beam_step_refuses_greedy_routes(weights, route):
    """The two routes are greedy only, as in the JAX package: a step with an
    ancestor table raises, and so does a prefill pass asking for them."""
    _, model = weights
    B = 2
    cache = KVCache.init(DIMS, B, torch.float32, "cpu")
    ckv = CrossKV(torch.zeros(3, 1, 2, 2, 64, 1500))
    anc = torch.zeros(B, DIMS.n_text_ctx, dtype=torch.int32)
    with pytest.raises(ValueError, match="greedy only"):
        decoder_forward(model, torch.zeros(B, 1, dtype=torch.long), 3, ckv, cache, cross_group=B,
                        incremental=True, ancestors=anc, step_kernel=route)
    with pytest.raises(ValueError, match="incremental step"):
        decoder_forward(model, torch.zeros(B, 3, dtype=torch.long), 0, ckv, cache, cross_group=B,
                        step_kernel=route)


def test_decode_greedy_rejects_unknown_route(weights):
    _, model = weights
    with pytest.raises(ValueError, match="step_kernel"):
        decode_greedy(model, torch.zeros(1, 80, 3000), np.full((1, 1), SOT), 1, 0,
                      FilterConfig(**CFG_KW), GreedyMode(), 4, NO_SPEECH, step_kernel="fast")


# ---- the bf16 kernel's launch plan (ops/decoder_layer_fused.py) -------------

# (model, rows, rows an audio): the layer route's path, large-v3's and
# base.en's greedy batches cut to the kernel's 16 rows, and 16 rows
PLAN_SHAPES = {
    "medium.en b8": ("medium.en", 8, 1),
    "large-v3 b12": ("large-v3", 12, 1),
    "base.en b16": ("base.en", 16, 1),
    "medium.en b16 G2": ("medium.en", 16, 2),
}
H100_SMS = 132


def _plan(case, blocks=H100_SMS):
    from whisper_rs_tpu_torch.config import dims_for
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import layer_launch_plan

    model, rows, group = PLAN_SHAPES[case]
    dims = dims_for(model)
    return dims, layer_launch_plan(rows, dims.n_text_state, blocks, group, dims.n_audio_ctx,
                                   dims.n_text_ctx)


@pytest.mark.parametrize("case", list(PLAN_SHAPES))
def test_layer_plan_covers_every_feature_once_in_every_slice(case):
    """Each projection's K-slices are exact and non-empty (ks x width = K,
    widths on the mma's 16-deep steps), the blocks take the slices in
    order, and within each slice every output feature is some block's,
    exactly once."""
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import SLICE_STEP, TILE_FEATURES

    dims, plan = _plan(case)
    D = dims.n_text_state
    want = {"qkv": (3 * D, D), "out": (D, D), "cross_q": (D, D), "cross_out": (D, D),
            "fc1": (4 * D, D), "fc2": (D, 4 * D)}
    assert [ph.name for ph in plan.phases] == list(want)
    for ph in plan.phases:
        assert (ph.features, ph.depth) == want[ph.name]
        assert ph.slices * ph.width == ph.depth and ph.width > 0 and ph.width % SLICE_STEP == 0
        assert len(ph.blocks) == H100_SMS
        slices = [s for s, _, _ in ph.blocks]
        assert slices == sorted(slices) and set(slices) == set(range(ph.slices))
        for s in range(ph.slices):
            covered = np.zeros(ph.features, int)
            for slice_, t0, t1 in ph.blocks:
                assert 0 <= t0 <= t1 <= ph.features // TILE_FEATURES
                if slice_ == s:
                    covered[t0 * TILE_FEATURES:t1 * TILE_FEATURES] += 1
            assert (covered == 1).all(), (ph.name, s)


@pytest.mark.parametrize("case", list(PLAN_SHAPES))
def test_layer_plan_spreads_the_weights_over_every_block(case):
    """Every block streams weights in every layer; in each projection the
    blocks of a slice take runs of tiles that differ by one tile at most,
    and the slices have blocks that differ by one at most."""
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import TILE_FEATURES

    _, plan = _plan(case)
    per_block = np.zeros(H100_SMS)
    for ph in plan.phases:
        cols = np.array([(t1 - t0) * ph.width for _, t0, t1 in ph.blocks])
        assert cols.sum() == ph.features // TILE_FEATURES * ph.depth
        sizes = np.bincount([s for s, _, _ in ph.blocks])
        assert sizes.max() - sizes.min() <= 1, ph.name
        for s in range(ph.slices):
            tiles = [t1 - t0 for slice_, t0, t1 in ph.blocks if slice_ == s]
            assert max(tiles) - min(tiles) <= 1, (ph.name, s)
        per_block += cols
    assert (per_block > 0).all()


@pytest.mark.parametrize("case", list(PLAN_SHAPES))
def test_layer_plan_fits_shared_memory(case):
    """The plan's shared memory (the weight ring, then the largest phase's
    region) stays within a block's, with the rings at least as deep as the
    kernel needs, and its scratch holds the widest phase's partials."""
    from whisper_rs_tpu_torch.ops import decoder_layer_fused as dlf

    dims, plan = _plan(case)
    _, rows, group = PLAN_SHAPES[case]
    assert dlf.MIN_STAGES <= plan.stages <= dlf.MAX_STAGES
    assert dlf.MIN_CROSS_STAGES <= plan.cross_stages <= dlf.MAX_CROSS_STAGES
    assert plan.act_pitch % 32 == 16  # staged rows on distinct banks for ldmatrix
    widest = max(ph.width for ph in plan.phases)
    tiles = max(t1 - t0 for ph in plan.phases for _, t0, t1 in ph.blocks)
    assert tiles <= dlf.MAX_TILES
    region = dlf._region_bytes(rows, dims.n_text_state, widest, tiles, group, dims.n_audio_ctx,
                               dims.n_text_ctx, plan.cross_stages)
    assert plan.smem == plan.stages * dlf.STAGE_BYTES + region <= dlf.SMEM_LIMIT
    assert dlf.layer_kernel_takes(rows, group, 64, dims.n_audio_ctx, dims.n_text_ctx,
                                  dims.n_text_state, 2)
    for ph in plan.phases:
        assert ph.features * ph.slices * rows <= plan.partial_floats
        assert ph.features // dlf.TILE_FEATURES * ph.slices <= plan.flags


def test_layer_plan_split_sums_match_the_plain_product():
    """The kernel's split-K arithmetic, emulated: each slice's f32 sum, then
    the slices added in order, rounded once, agrees with the plain
    version's product to within one bf16 ulp of each output, at the
    medium.en b16 plan's fc2 (two slices of 2048) and the large-v3 b12
    plan's (five of 1024)."""
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import _dot

    rng = np.random.default_rng(5)
    for case, index in (("medium.en b16 G2", 5), ("large-v3 b12", 5)):
        ph = _plan(case)[1].phases[index]
        assert ph.slices > 1
        a = torch.from_numpy(rng.standard_normal((8, ph.depth)).astype(np.float32)).bfloat16()
        w = torch.from_numpy((rng.standard_normal((ph.features, ph.depth)) * ph.depth**-0.5)
                             .astype(np.float32)).bfloat16()
        total = torch.zeros(8, ph.features)
        for s in range(ph.slices):
            cols = slice(s * ph.width, (s + 1) * ph.width)
            total = total + a[:, cols].float() @ w[:, cols].float().T
        got, want = total.bfloat16().float(), _dot(a, w).float()
        assert ((got - want).abs() <= 2**-7 * want.abs() + 1e-6).all(), ph.name
