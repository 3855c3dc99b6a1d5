"""The port's beam search against the JAX package, on the same seeded numpy
inputs:

  * the beam self-attention step (``ops/decode_attention.py``, its plain
    version on the CPU) against the JAX Pallas ``beam_self_attention_step``
    in interpret mode, the port's ctx-major planes transposed to the JAX
    layout: out within 1e-5;
  * ``_beam_step`` alone on planted f32 logits with ties inside and across
    beams, EOT candidates above and below the beam-th unfinished one, and a
    finished buffer that overflows: every output exactly equal;
  * ``decode_beam`` end to end, unprompted and prompted across the
    128 -> 256 window phases, at beam 3 and 5, against the JAX loop with
    the Pallas beam kernel interpreted (ancestor table) and with its
    default physical cache reorder: candidates equal, scores within 1e-4,
    and the ranked pick equal with and without a length penalty;
  * the beam step calls the beam wrapper ``n_text_layer x steps`` times and
    the append wrapper never;
  * malformed arguments raise, int8 scales among them (the int8 branch is
    held against Pallas in tests/test_torch_quantize.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import BeamSearchMode as JaxBeamSearchMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_beam as jax_decode_beam
from whisper_rs_tpu.decode.loop import _BeamState as JaxBeamState
from whisper_rs_tpu.decode.loop import _beam_step as jax_beam_step
from whisper_rs_tpu.decode.ranker import rank_max_likelihood as jax_rank
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.ops.decode_attention import beam_self_attention_step as jax_beam_attention
from whisper_rs_tpu_torch.config import BeamSearchMode, ModelDims
from whisper_rs_tpu_torch.decode import (
    FilterConfig,
    build_batch_prompts,
    decode_beam,
    rank_max_likelihood,
)
from whisper_rs_tpu_torch.decode.loop import _BeamState, _beam_step
from whisper_rs_tpu_torch.models import params_from_jax
from whisper_rs_tpu_torch.models import whisper as port_whisper
from whisper_rs_tpu_torch.ops import LAUNCHES
from whisper_rs_tpu_torch.ops.decode_attention import beam_self_attention_step

# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

ATTENTION_CASES = {
    # key_start differs within each audio: the audio's first row masks
    "key_start_within_audio": dict(L=2, A=2, G=5, H=4, pos=200, W=256, layer=1,
                                   ks=[3, 7, 0, 9, 1, 20, 2, 5, 5, 30]),
    "single_beam": dict(L=2, A=3, G=1, H=4, pos=130, W=256, layer=0, ks=[0, 5, 9]),
    "full_window": dict(L=1, A=1, G=5, H=2, pos=400, W=448, layer=0,
                        ks=[231, 1, 100, 17, 2]),
    "first_block": dict(L=1, A=2, G=3, H=2, pos=100, W=128, layer=0, ks=None),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_beam_attention_matches_pallas(case):
    c = ATTENTION_CASES[case]
    rng = np.random.default_rng(len(case))
    L, A, G, H, n_ctx, dh, pos = c["L"], c["A"], c["G"], c["H"], 448, 64, c["pos"]
    B = A * G
    k_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    v_all = (rng.standard_normal((L, B, H, n_ctx, dh)) * 0.3).astype(np.float32)
    q, k_new, v_new = ((rng.standard_normal((B, H, dh)) * 0.3).astype(np.float32) for _ in range(3))
    ks = None if c["ks"] is None else np.asarray(c["ks"])
    # random ancestors that differ between the rows of an audio; slot pos
    # is each row's own (the decode loop sets that column to the identity)
    anc = rng.integers(0, G, (B, n_ctx)).astype(np.int32)
    anc[:, pos] = np.arange(B) % G
    if G > 1:
        assert (anc[0, :pos] != anc[1, :pos]).any()

    # the JAX kernel reads the cache with this step's column written
    k_written, v_written = k_all.copy(), v_all.copy()
    k_written[c["layer"], :, :, pos] = k_new
    v_written[c["layer"], :, :, pos] = v_new
    want = jax_beam_attention(
        jnp.asarray(q), jnp.asarray(np.swapaxes(k_written, -1, -2)), jnp.asarray(v_written),
        jnp.int32(c["layer"]), jnp.int32(pos), None if ks is None else jnp.asarray(ks, jnp.int32),
        jnp.asarray(anc), G, window=c["W"], interpret=True,
    )
    kt, vt = torch.from_numpy(k_all), torch.from_numpy(v_all)
    got = beam_self_attention_step(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new), kt, vt,
        c["layer"], pos, None if ks is None else torch.from_numpy(ks), torch.from_numpy(anc), G,
        window=c["W"],
    )
    assert got.shape == (B, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kt.numpy(), k_written)
    np.testing.assert_array_equal(vt.numpy(), v_written)


def test_beam_attention_rejects_bad_arguments():
    q = torch.zeros(4, 2, 64)
    k = torch.zeros(1, 4, 2, 16, 64)
    anc = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="groups of 3"):
        beam_self_attention_step(q, q, q, k, k.clone(), 0, 3, None, anc, 3, window=8)
    with pytest.raises(ValueError, match="anc_local"):
        beam_self_attention_step(q, q, q, k, k.clone(), 0, 3, None, anc[:, :8], 2, window=8)
    k8, scale = k.to(torch.int8), torch.ones(1, 4, 2, 16)
    with pytest.raises(ValueError, match="int8"):  # the JAX scale shape, with a trailing 1
        beam_self_attention_step(q, None, None, k8, k8.clone(), 0, 3, None, anc, 2, window=8,
                                 k_scale=scale[..., None], v_scale=scale[..., None])
    with pytest.raises(ValueError, match="int8"):  # an int8 cache is written by the caller
        beam_self_attention_step(q, q, q, k8, k8.clone(), 0, 3, None, anc, 2, window=8,
                                 k_scale=scale, v_scale=scale)


# ---------------------------------------------------------------------------
# one beam update on planted logits
# ---------------------------------------------------------------------------

EOT = 500
N_CTX = 448
STEP_POS = 12


def _planted(case):
    """(beam, patience, logits [A*beam, V], sum_logprobs, fin_count).  Each
    row has one largest logit and every other at least 110 below it, so the
    other terms of the softmax sum underflow to 0 in f32 and the log-probs,
    and with integer sums every cumulative score, are exact in both
    frameworks: equal scores are exact ties."""
    V = 1000
    if case == "random_ties_beam5":
        rng = np.random.default_rng(9)
        beam, A = 5, 3
        logits = rng.choice(np.float32([-120, -121, -122, -1000]), (A * beam, V))
        logits[np.arange(A * beam), rng.integers(0, V, A * beam)] = 0.0
        logits[::2, EOT] = 0.0  # EOT on top of every other beam
        logits[::2][logits[::2, :] == 0.0] = -120.0
        logits[::2, EOT] = 0.0
        sum_lp = np.repeat(rng.integers(-4, 0, (A, 3)), [2, 2, 1], axis=1).reshape(-1)
        return beam, 1.0, logits, sum_lp.astype(np.float32), np.array([0, 3, 4])
    beam, A = 3, 2
    logits = np.full((A * beam, V), -1000.0, np.float32)
    # audio 0: beams 0 and 1 identical (every candidate ties across them);
    # EOT on top, then tokens 2, 3, 9 tied inside each beam
    logits[0:2, EOT] = 0.0
    logits[0:2, [2, 3, 9]] = -120.0
    logits[2, 1] = 0.0
    # audio 1: EOT in beam 0's top four but below the third unfinished
    # candidate; token 9 tied across beams 1 and 2
    logits[3, 5] = 0.0
    logits[3, 6] = -120.0
    logits[3, EOT] = -125.0
    logits[4:6, 9] = 0.0
    sum_lp = np.array([-1.0, -1.0, -300.0, -1.0, -2.0, -2.0], np.float32)
    cap = max(beam, int(round((2.0 if case == "overflow_patience2" else 1.0) * beam)))
    # audio 0 has one free slot for its two eligible EOTs: one is dropped
    fin_count = np.array([cap - 1, 0])
    return beam, cap / beam, logits, sum_lp, fin_count


@pytest.mark.parametrize("case", ["ties_patience1", "overflow_patience2", "random_ties_beam5"])
def test_beam_step_matches_jax(case):
    beam, patience, logits, sum_lp, fin_count = _planted(case)
    cap = max(beam, int(round(patience * beam)))
    B = logits.shape[0]
    A = B // beam
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 400, (B, N_CTX)).astype(np.int32)
    tokens[:, STEP_POS:] = 0
    first = np.arange(B)[:, None] // beam * beam
    anc = (first + rng.integers(0, beam, (B, N_CTX))).astype(np.int32)
    fin_tokens = rng.integers(0, 400, (A, cap, N_CTX)).astype(np.int32)
    fin_scores = rng.standard_normal((A, cap)).astype(np.float32) - 10

    j = jax_beam_step(
        jnp.asarray(logits),
        JaxBeamState(
            step=jnp.int32(0), pos=jnp.int32(STEP_POS), tokens=jnp.asarray(tokens),
            sum_logprobs=jnp.asarray(sum_lp), cache=None, fin_tokens=jnp.asarray(fin_tokens),
            fin_scores=jnp.asarray(fin_scores), fin_count=jnp.asarray(fin_count, jnp.int32),
            anc=jnp.asarray(anc),
        ),
        beam, cap, EOT,
    )
    pad = lambda a: np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)  # noqa: E731
    t = _beam_step(
        torch.from_numpy(logits),
        _BeamState(
            tokens=torch.from_numpy(tokens).long(), sum_logprobs=torch.from_numpy(sum_lp),
            fin_tokens=torch.from_numpy(pad(fin_tokens)).long(),
            fin_scores=torch.from_numpy(pad(fin_scores)),
            fin_count=torch.from_numpy(fin_count).long(),
            anc=torch.from_numpy(anc - first).int(),  # the port's table is beam-local
        ),
        STEP_POS, beam, cap, EOT,
    )
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.sum_logprobs.numpy(), np.asarray(j.sum_logprobs))
    np.testing.assert_array_equal(t.anc.numpy() + first, np.asarray(j.anc))
    np.testing.assert_array_equal(t.fin_tokens[:, :cap].numpy(), np.asarray(j.fin_tokens))
    np.testing.assert_array_equal(t.fin_scores[:, :cap].numpy(), np.asarray(j.fin_scores))
    np.testing.assert_array_equal(t.fin_count.numpy(), np.asarray(j.fin_count))
    if case != "random_ties_beam5":
        # the planted situations happened: audio 0 filled its last slot and
        # dropped its second EOT; audio 1's EOT ranked too low to count
        np.testing.assert_array_equal(t.fin_count.numpy(), [cap, 0])
        np.testing.assert_array_equal(t.tokens[:3, STEP_POS].numpy(), [2, 3, 9])
        np.testing.assert_array_equal(t.anc[:3].numpy() + first[:3], anc[[0, 0, 0]])
        np.testing.assert_array_equal(t.tokens[3:, STEP_POS].numpy(), [5, 9, 9])
        np.testing.assert_array_equal(t.anc[3:].numpy() + first[3:], anc[3:])


# ---------------------------------------------------------------------------
# decode_beam end to end
# ---------------------------------------------------------------------------

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(
    n_vocab=1000, token_id_eot=EOT, token_id_space=7, token_id_ts_begin=600,
    token_id_no_timestamps=599, suppress_blank=True, timestamps=True,
    suppress_ids=(3, 5), max_initial_timestamp_index=50,
)
SOT, SOP, NO_SPEECH = 501, 503, 502


@pytest.fixture(scope="module")
def models():
    """Two weight sets from one seed: as drawn (the beams run to the end of
    the budget), and with the EOT embedding moved halfway to that of a
    timestamp the model favours, so that beams finish at several lengths
    within ten steps."""
    base = jax.tree.map(np.array, init_params(jax.random.PRNGKey(7), JDIMS))
    eot_mix = jax.tree.map(np.copy, base)
    emb = eot_mix["decoder"]["token_emb"]
    emb[EOT] = 0.5 * emb[662] + 0.5 * emb[EOT]
    out = {}
    for name, p in (("base", base), ("eot_mix", eot_mix)):
        out[name] = (jax.tree.map(jnp.asarray, p), params_from_jax(p, DIMS, device="cpu"))
    mel = (np.random.default_rng(0).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    return out, mel


def _inputs(prompted: bool):
    """(weights, initial tokens, key_start, sample_begin, sot_idx, sample_len)."""
    if not prompted:
        return "eot_mix", np.full((2, 1), SOT, np.int32), None, 1, 0, 10
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(10, 400, 20)), list(rng.integers(10, 400, 50))]
    initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    assert sample_begin == 64
    return "base", initial, key_start, sample_begin, sot_idx, 72


_PORT_RESULTS = {}


def _port_decode(models, beam: int, prompted: bool):
    """The port's result, computed once per (beam, prompted) for the module."""
    key = (beam, prompted)
    if key not in _PORT_RESULTS:
        weights, initial, key_start, sample_begin, sot_idx, sample_len = _inputs(prompted)
        (_, model), mel = models[0][weights], models[1]
        _PORT_RESULTS[key] = decode_beam(
            model, torch.from_numpy(mel), initial, sample_begin, sot_idx,
            FilterConfig(**CFG_KW), BeamSearchMode(beam_size=beam), sample_len, NO_SPEECH,
            key_start=key_start,
        )
    return _PORT_RESULTS[key]


@pytest.mark.parametrize("jax_path", ["ancestor_kernel", "physical_reorder"])
@pytest.mark.parametrize("prompted", [False, True], ids=["unprompted", "prompted"])
@pytest.mark.parametrize("beam", [3, 5])
def test_decode_beam_matches_jax(models, beam, prompted, jax_path, monkeypatch):
    if jax_path == "ancestor_kernel":
        monkeypatch.setenv("WHISPER_PALLAS_DECODE", "interpret")
        monkeypatch.setenv("WHISPER_BEAM_ANCESTOR", "1")
    weights, initial, key_start, sample_begin, sot_idx, sample_len = _inputs(prompted)
    params, mel = models[0][weights][0], models[1]
    jres = jax_decode_beam(
        params, jnp.asarray(mel), jnp.asarray(initial), jnp.int32(sample_begin),
        jnp.int32(sot_idx), JDIMS, JaxFilterConfig(**CFG_KW), JaxBeamSearchMode(beam_size=beam),
        sample_len, no_speech_id=NO_SPEECH,
        key_start=None if key_start is None else jnp.asarray(key_start),
    )
    tres = _port_decode(models, beam, prompted)
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tres.no_speech_probs.numpy(), np.asarray(jres.no_speech_probs), rtol=1e-5, atol=1e-5
    )
    lengths = (tres.candidates.numpy() == EOT).argmax(-1) - sample_begin
    if prompted:
        assert tres.steps > 128 - sample_begin  # reached the 256 phase
    else:
        # beams finished at several lengths inside the budget
        assert len(np.unique(lengths)) > 1
    for penalty in (None, 1.0):
        jsel, javg, jlen = jax_rank(jres, jnp.int32(sample_begin), EOT, penalty)
        tsel, tavg, tlen = rank_max_likelihood(tres, sample_begin, EOT, penalty)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        np.testing.assert_allclose(tavg.numpy(), np.asarray(javg), rtol=1e-4, atol=1e-5)


def test_beam_step_takes_the_beam_kernel_only(models, monkeypatch):
    """Every beam step calls the beam self-attention wrapper once a layer;
    the append wrapper is never called (and on the CPU nothing launches)."""
    calls = {"beam_self_attention_step": 0, "self_attention_append_step": 0}
    for name in calls:
        fn = getattr(port_whisper, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_whisper, name, wrapped)
    before = dict(LAUNCHES)
    _, model = models[0]["base"]
    res = decode_beam(
        model, torch.from_numpy(models[1]), np.full((2, 1), SOT), 1, 0, FilterConfig(**CFG_KW),
        BeamSearchMode(beam_size=3), 6, NO_SPEECH,
    )
    assert res.steps == 5
    assert calls == {
        "beam_self_attention_step": DIMS.n_text_layer * res.steps,
        "self_attention_append_step": 0,
    }
    assert LAUNCHES == before
