"""The port's greedy decode (whisper_rs_tpu_torch.decode) against the JAX
package: logit filters on seeded logits (masks exact), the phase-window
schedule, prompt packing, ranking, and ``decode_greedy`` end to end,
unprompted and prompted with per-row ``key_start`` across the 128 -> 256
window phases: candidates token-exact, scores 1e-4, no-speech 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import apply_filters as jax_apply_filters
from whisper_rs_tpu.decode import build_batch_prompts as jax_build_batch_prompts
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.decode.loop import _phase_windows as jax_phase_windows
from whisper_rs_tpu.decode.prompt import prefill_bucket as jax_prefill_bucket
from whisper_rs_tpu.decode.ranker import rank_max_likelihood as jax_rank
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu_torch.config import GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import (
    FilterConfig,
    apply_filters,
    build_batch_prompts,
    decode_greedy,
    prefill_bucket,
    rank_max_likelihood,
)
from whisper_rs_tpu_torch.decode.loop import _phase_windows
from whisper_rs_tpu_torch.models import params_from_jax

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
SOT, EOT, SOP, NO_SPEECH = 501, 500, 503, 502


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(7), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    mel = (np.random.default_rng(0).standard_normal((3, 80, 3000)) * 0.3).astype(np.float32)
    return params, model, mel


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("pos", [4, 5, 6, 9])
def test_apply_filters_matches_jax(pos, timestamps):
    rng = np.random.default_rng(pos)
    kw = dict(CFG_KW, timestamps=timestamps)
    logits = (rng.standard_normal((6, 1000)) * 3).astype(np.float32)
    logits[0, 600:] += 8.0  # a row where the timestamp mass wins
    tokens = np.zeros((6, 448), np.int32)
    tokens[:, :4] = [SOP, 17, 23, SOT]
    # sampled history mixing text and timestamp tokens
    tokens[:, 4:pos] = rng.choice([12, 99, 610, 640], size=(6, pos - 4))
    want = np.asarray(
        jax_apply_filters(
            JaxFilterConfig(**kw), jnp.asarray(logits), jnp.asarray(tokens), jnp.int32(pos),
            jnp.int32(4),
        )
    )
    got = apply_filters(
        FilterConfig(**kw), torch.from_numpy(logits), torch.from_numpy(tokens).long(), pos, 4
    ).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prefill,sample_len", [(1, 224), (8, 12), (64, 100), (232, 216), (128, 300)])
def test_phase_windows_match_jax(prefill, sample_len):
    assert _phase_windows(448, prefill, sample_len) == jax_phase_windows(448, prefill, sample_len)


def test_prompt_packing_matches_jax():
    rng = np.random.default_rng(1)
    prompts = [None, list(rng.integers(10, 400, 20)), list(rng.integers(10, 400, 300))]
    want = jax_build_batch_prompts(prompts, [SOT, 7], SOT, SOP)
    got = build_batch_prompts(prompts, [SOT, 7], SOT, SOP)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for n in (1, 8, 9, 64, 200, 232):
        assert prefill_bucket(n) == jax_prefill_bucket(n)
    with pytest.raises(ValueError):
        prefill_bucket(233)


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tres.no_speech_probs.numpy(), np.asarray(jres.no_speech_probs), rtol=1e-5, atol=1e-5
    )


def test_decode_greedy_unprompted_matches_jax(setup):
    params, model, mel = setup
    initial = np.full((2, 1), SOT, np.int32)
    jres = jax_decode_greedy(
        params, jnp.asarray(mel[:2]), jnp.asarray(initial), jnp.int32(1), jnp.int32(0),
        JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(), 24, no_speech_id=NO_SPEECH,
    )
    tres = decode_greedy(
        model, torch.from_numpy(mel[:2]), initial, 1, 0, FilterConfig(**CFG_KW),
        GreedyMode(), 24, NO_SPEECH,
    )
    _compare(jres, tres)

    # the ranker on the same result
    jsel, javg, jlen = jax_rank(jres, jnp.int32(1), EOT, None)
    tsel, tavg, tlen = rank_max_likelihood(tres, 1, EOT, None)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tavg.numpy(), np.asarray(javg), rtol=1e-4, atol=1e-5)


def test_decode_greedy_prompted_key_start_matches_jax(setup):
    """Per-row prompts of different lengths in the 64 bucket (key_start per
    row), decoding on past position 128 into the second window phase."""
    params, model, mel = setup
    rng = np.random.default_rng(3)
    prompts = [None, list(rng.integers(10, 400, 20)), list(rng.integers(10, 400, 50))]
    initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    assert sample_begin == 64
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
    _compare(jres, tres)


def test_bf16_model_casts_mel_to_compute_dtype(setup):
    params, _, mel = setup
    model16 = params_from_jax(
        jax.tree.map(np.asarray, params), DIMS, dtype=torch.bfloat16, device="cpu"
    )
    res = decode_greedy(
        model16, torch.from_numpy(mel[:1]), np.full((1, 1), SOT), 1, 0,
        FilterConfig(**CFG_KW), GreedyMode(), 3, NO_SPEECH,
    )
    assert res.audio_features.dtype == torch.bfloat16
    assert res.scores.dtype == torch.float32 and torch.isfinite(res.scores).all()
