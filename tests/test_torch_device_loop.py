"""The decode window on the device (``whisper_rs_tpu_torch/decode/loop.py``):
one step body on static buffers, ``pos`` a 0-d tensor, every write gated by
the termination test computed on the device, as the JAX ``lax.while_loop``
runs it.  On the CPU the body runs eagerly, which is what these tests hold
to the JAX package:

  * the loop at check intervals k = 1, 3, 8 against the JAX ``decode_greedy``
    (unprompted; prompted with per-row key_start; sampled at T > 0 with a
    temperature override) and ``decode_beam`` (beam 2, prompted);
  * steps past the end are bit-exact no-ops on every buffer of the window;
  * the step body reads nothing on the host (``item``, ``__bool__``,
    ``__int__``, ``__float__``, ``tolist`` and ``numpy`` patched to raise):
    the CPU's proof that the card can capture it;
  * ``apply_filters`` with a device ``pos``; the plain step kernels (rows 7,
    9 and its int8 branch, 10, 11, 12) with a device ``pos`` against their
    int ``pos`` results and the Pallas kernels in interpret mode, and a
    ``pos`` outside the window as no step;
  * ``DecodeTask``'s window cache (one window a prefill bucket, dropped by
    ``close``) and ``warmup``, ``ServingEngine.warmup`` and ``close``;
  * ``enable_nan_checks`` and the rules that keep the eager loop on the card,
    read at every call: a captured window runs eagerly while the checks are
    on.

2 + 2 layers at width 64, at most 8 tokens a window; both packages' decodes
take the same seeded audio features in the encoder's place (``encoder_fn``),
since the encoder is not what these tests are about.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import BeamSearchMode as JaxBeamMode
from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import apply_filters as jax_apply_filters
from whisper_rs_tpu.decode import decode_beam as jax_decode_beam
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.ops.decode_attention import append_ctx_pad
from whisper_rs_tpu.ops.decode_attention import beam_self_attention_step as jax_beam_attention
from whisper_rs_tpu.ops.decode_attention import self_attention_append_step as jax_append
from whisper_rs_tpu.ops.decode_attention import self_attention_fused_step as jax_fused
from whisper_rs_tpu.ops.decode_attention import self_attention_step as jax_self_step
from whisper_rs_tpu_torch import ServingEngine
from whisper_rs_tpu_torch.config import (
    BeamSearchMode,
    DecodeOptions,
    GreedyMode,
    ModelDims,
    TranscribeOptions,
)
from whisper_rs_tpu_torch.decode import (
    PREFILL_BUCKETS,
    DecodeTask,
    FilterConfig,
    apply_filters,
    build_batch_prompts,
    decode_beam,
    decode_greedy,
    rng,
)
from whisper_rs_tpu_torch.decode import loop as decode_loop
from whisper_rs_tpu_torch.models import params_from_jax
from whisper_rs_tpu_torch.ops.decode_attention import (
    beam_self_attention_step_plain,
    quantize_kv,
    self_attention_append_step_plain,
    self_attention_fused_step_plain,
    self_attention_step_plain,
)
from whisper_rs_tpu_torch.ops.decoder_layer_fused import (
    decoder_step_fused_plain,
    decoder_step_weights,
)
from whisper_rs_tpu_torch.parallel.mesh import Mesh
from whisper_rs_tpu_torch.utils import debug

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
SAMPLE_LEN = 8
MARGIN_TOL = 1e-4  # a sampled row may part from JAX's only at a near-tie this close


XA = (np.random.default_rng(6).standard_normal((2, 1500, 64)) * 0.5).astype(np.float32)


def jax_features(params, mel, dims):
    return jnp.asarray(XA[: mel.shape[0]])


def port_features(model, mel, kernels):
    return torch.from_numpy(XA[: mel.shape[0]]).to(model.dtype)


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(11), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    mel = (np.random.default_rng(5).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    return params, model, mel


def _prompted():
    rng_ = np.random.default_rng(8)
    prompts = [[int(t) for t in rng_.integers(10, 400, 3)], None]
    initial, key_start, sample_begin, sot_idx = build_batch_prompts(prompts, [SOT], SOT, SOP)
    assert sample_begin == 8 and key_start.tolist() != [0, 0]
    return initial, key_start, sample_begin, sot_idx


# the JAX result of each case, computed once for every k
_JAX: dict = {}


def _jax_result(case, params, mel):
    if case not in _JAX:
        cfg = JaxFilterConfig(**CFG_KW)
        if case == "unprompted":
            _JAX[case] = jax_decode_greedy(
                params, jnp.asarray(mel), jnp.full((2, 1), SOT, jnp.int32), jnp.int32(1),
                jnp.int32(0), JDIMS, cfg, JaxGreedyMode(), SAMPLE_LEN, no_speech_id=NO_SPEECH,
                encoder_fn=jax_features)
        elif case == "sampled":
            _JAX[case] = jax_decode_greedy(
                params, jnp.asarray(mel), jnp.full((2, 1), SOT, jnp.int32), jnp.int32(1),
                jnp.int32(0), JDIMS, cfg, JaxGreedyMode(group_size=2), SAMPLE_LEN,
                no_speech_id=NO_SPEECH, temperature=jnp.float32(0.7),
                rng_key=jax.random.PRNGKey(3), encoder_fn=jax_features)
        else:
            initial, key_start, sample_begin, sot_idx = _prompted()
            args = (params, jnp.asarray(mel), jnp.asarray(initial), jnp.int32(sample_begin),
                    jnp.int32(sot_idx), JDIMS, cfg)
            if case == "prompted":
                _JAX[case] = jax_decode_greedy(*args, JaxGreedyMode(), SAMPLE_LEN,
                                               no_speech_id=NO_SPEECH,
                                               key_start=jnp.asarray(key_start),
                                               encoder_fn=jax_features)
            else:
                _JAX[case] = jax_decode_beam(*args, JaxBeamMode(beam_size=2), SAMPLE_LEN,
                                             no_speech_id=NO_SPEECH,
                                             key_start=jnp.asarray(key_start),
                                             encoder_fn=jax_features)
    return _JAX[case]


def _port_result(case, model, mel, k, **kw):
    """The port's decode of ``case``, its loop reading the termination test
    every ``k`` steps (``decode.loop.CHECK_EVERY``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode_loop, "CHECK_EVERY", k)
        return _port_decode(case, model, mel, **kw)


def _port_decode(case, model, mel, **kw):
    cfg = FilterConfig(**CFG_KW)
    mel = torch.from_numpy(mel)
    kw = dict(encoder_fn=port_features, **kw)
    if case == "unprompted":
        return decode_greedy(model, mel, np.full((2, 1), SOT), 1, 0, cfg, GreedyMode(),
                             SAMPLE_LEN, NO_SPEECH, **kw)
    if case == "sampled":
        return decode_greedy(model, mel, np.full((2, 1), SOT), 1, 0, cfg,
                             GreedyMode(group_size=2), SAMPLE_LEN, NO_SPEECH,
                             temperature=0.7, rng_key=rng.PRNGKey(3), **kw)
    initial, key_start, sample_begin, sot_idx = _prompted()
    if case == "prompted":
        return decode_greedy(model, mel, initial, sample_begin, sot_idx, cfg, GreedyMode(),
                             SAMPLE_LEN, NO_SPEECH, key_start=key_start, **kw)
    return decode_beam(model, mel, initial, sample_begin, sot_idx, cfg,
                       BeamSearchMode(beam_size=2), SAMPLE_LEN, NO_SPEECH, key_start=key_start,
                       **kw)


def _greedy_steps(candidates: np.ndarray, sample_begin: int) -> int:
    """The incremental steps the JAX greedy loop took: until every row's
    first EOT, or the budget."""
    rows = candidates.reshape(-1, candidates.shape[-1])[:, sample_begin:]
    first = [int(np.nonzero(r == EOT)[0][0]) for r in rows]
    return min(SAMPLE_LEN - 1, max(first))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", ["unprompted", "prompted", "sampled", "beam"])
def test_device_loop_matches_jax(setup, case, k, monkeypatch):
    params, model, mel = setup
    want = _jax_result(case, params, mel)
    margins = []
    if case == "sampled":
        sample = rng.categorical

        def recording(keys, scaled):
            top = (rng.gumbel(keys, scaled.shape[-1:]) + scaled).topk(2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).numpy())
            return sample(keys, scaled)

        monkeypatch.setattr(rng, "categorical", recording)
    got = _port_result(case, model, mel, k)
    assert got.loop == "eager (the CPU)" and got.syncs <= -(-got.steps // k) + 2
    sample_begin = 1 if case in ("unprompted", "sampled") else 8
    gc, wc = got.candidates.numpy(), np.asarray(want.candidates)
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(want.no_speech_probs),
                               rtol=1e-5, atol=1e-5)
    if case == "sampled":
        for r in range(gc.shape[0] * gc.shape[1]):
            a, g = divmod(r, gc.shape[1])
            diff = np.nonzero(gc[a, g] != wc[a, g])[0]
            if diff.size:  # only at a near-tie of the draw
                assert margins[int(diff[0]) - sample_begin][r] < MARGIN_TOL
                continue
            assert abs(got.scores.numpy()[a, g] - np.asarray(want.scores)[a, g]) <= 1e-4
    else:
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                                   rtol=1e-4, atol=1e-4)
    if case == "beam":  # beam steps are the k = 1 loop's, as the loop stood before
        _JAX.setdefault("beam steps", got.steps if k == 1 else _port_result(case, model, mel,
                                                                            1).steps)
        assert got.steps == _JAX["beam steps"]
    elif case != "sampled" or np.array_equal(gc, wc):
        assert got.steps == _greedy_steps(wc, sample_begin)
    # the bodies past the end are the rest of the last check interval
    assert got.steps <= got.bodies <= got.steps + k - 1


def _window_after_decode(model, mel, case, monkeypatch):
    """A decode of ``case`` (prompted; greedy and sampled in groups of two;
    k = 3) on a window the test keeps (its ``WindowCache``), ended; returns
    the window."""
    monkeypatch.setattr(decode_loop, "CHECK_EVERY", 3)
    windows = decode_loop.WindowCache()
    cfg = FilterConfig(**CFG_KW)
    initial, key_start, sample_begin, sot_idx = _prompted()
    kw = dict(key_start=key_start, windows=windows, encoder_fn=port_features)
    if case == "beam":
        decode_beam(model, torch.from_numpy(mel), initial, sample_begin, sot_idx, cfg,
                    BeamSearchMode(beam_size=2), SAMPLE_LEN, NO_SPEECH, **kw)
    else:
        decode_greedy(model, torch.from_numpy(mel), initial, sample_begin, sot_idx, cfg,
                      GreedyMode(group_size=2, temperature=0.5 if case == "sampled" else 0.0),
                      SAMPLE_LEN, NO_SPEECH, **kw)
    (win,) = windows._windows.values()
    return win


def _buffers(win) -> dict:
    """Every buffer of the window's state."""
    out = {"k": win.cache.k, "v": win.cache.v, "cross": win.cross_kv.kv, "tokens": win.tokens,
           "sum_lp": win.sum_lp, "pos": win.pos, "step": win.step}
    if win.shape.beam:
        s = win.beam_state
        out.update(fin_tokens=s.fin_tokens, fin_scores=s.fin_scores, fin_count=s.fin_count,
                   anc=s.anc)
    else:
        out["finished"] = win.finished
    if win.keys is not None:
        out.update(keys=win.keys, divisor=win.divisor)
    return {name: t.clone() for name, t in out.items()}


@pytest.mark.parametrize("case", ["greedy", "sampled", "beam"])
def test_steps_past_the_end_leave_every_buffer_bit_equal(setup, case, monkeypatch):
    _, model, mel = setup
    win = _window_after_decode(model, mel, case, monkeypatch)
    before = _buffers(win)
    for W in win.phases:
        for _ in range(2):
            win.body(W)
    after = _buffers(win)
    for name, t in before.items():
        assert torch.equal(t, after[name]), name


@pytest.mark.parametrize("case", ["greedy", "sampled", "beam"])
def test_step_body_reads_nothing_on_the_host(setup, case, monkeypatch):
    """A live step (its window rewound to the first incremental step) runs
    with every host read of a tensor refused: what the card can capture."""
    _, model, mel = setup
    win = _window_after_decode(model, mel, case, monkeypatch)
    win.step.fill_(1)
    win.pos.fill_(win.shape.sample_begin + 1)
    if win.shape.beam:
        win.beam_state.fin_count.zero_()
    else:
        win.finished.zero_()
    at = win.shape.sample_begin + 1
    win.tokens[:, at] = -1

    def refused(*a, **kw):
        raise AssertionError("a host read on the step")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    win.body(win.phases[0])
    monkeypatch.undo()
    assert int(win.step) == 2 and int(win.pos) == win.shape.sample_begin + 2
    assert (win.tokens[:, at] >= 0).all()  # the step wrote its token


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("pos", [4, 5, 6, 9])
def test_apply_filters_with_a_device_pos_matches_jax(pos, timestamps):
    rng_ = np.random.default_rng(pos)
    kw = dict(CFG_KW, timestamps=timestamps)
    logits = (rng_.standard_normal((6, 1000)) * 3).astype(np.float32)
    logits[0, 600:] += 8.0
    tokens = np.zeros((6, 448), np.int32)
    tokens[:, :4] = [SOP, 17, 23, SOT]
    tokens[:, 4:pos] = rng_.choice([12, 99, 610, 640], size=(6, pos - 4))
    want = np.asarray(jax_apply_filters(JaxFilterConfig(**kw), jnp.asarray(logits),
                                        jnp.asarray(tokens), jnp.int32(pos), jnp.int32(4)))
    args = (FilterConfig(**kw), torch.from_numpy(logits), torch.from_numpy(tokens).long())
    got = apply_filters(*args, torch.tensor(pos), 4).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, apply_filters(*args, pos, 4).numpy())


def _jax_plane(c: np.ndarray) -> np.ndarray:
    """Port [L, B, H, n_ctx, dh] -> the JAX append kernel's [L, B, H, dh,
    ctx_pad]."""
    t = np.swapaxes(c, -1, -2)
    return np.pad(t, ((0, 0),) * 4 + ((0, append_ctx_pad(c.shape[3]) - c.shape[3]),))


def _int8(rng_, shape):
    x = rng_.standard_normal(shape).astype(np.float32)
    q, s = quantize_kv(torch.from_numpy(x))
    return q.numpy(), s.numpy()


ROWS = ["append", "beam", "beam_int8", "step_int8", "fused", "layer"]


@pytest.mark.parametrize("row", ROWS)
def test_plain_step_kernels_take_a_device_pos(row):
    """Rows 7, 9 (and its int8 branch), 10, 11 and 12: a 0-d tensor ``pos``
    gives the int ``pos``'s output and caches bit for bit; rows 7-11 match
    the Pallas kernels interpreted; a ``pos`` outside the window writes
    nothing and returns zeros (row 12: x as it came)."""
    rng_ = np.random.default_rng(ROWS.index(row))
    L, A, G, H, n_ctx, layer, pos, W = 2, 2, 2, 4, 448, 1, 140, 256
    dh = 16 if row == "layer" else 64  # row 12 at the model's width, 4 heads of 16
    B = A * G
    q = (rng_.standard_normal((B, H, dh)) * dh**-0.5).astype(np.float32)
    new = [rng_.standard_normal((B, H, dh)).astype(np.float32) for _ in range(2)]
    ks = np.asarray([0, 3, 5, 1])
    anc = rng_.integers(0, G, (B, n_ctx)).astype(np.int32)
    anc[:, pos] = np.arange(B) % G
    if row in ("beam_int8", "step_int8"):
        (k, k_s), (v, v_s) = (_int8(rng_, (L, B, H, n_ctx, dh)) for _ in range(2))
    else:
        k, v = (rng_.standard_normal((L, B, H, n_ctx, dh)).astype(np.float32) for _ in range(2))
        k_s = v_s = None
    if row == "layer":
        blocks = params_from_jax(jax.tree.map(np.asarray, init_params(
            jax.random.PRNGKey(2), JDIMS)), DIMS, device="cpu").decoder.blocks
        weights = decoder_step_weights(blocks)
        x = torch.from_numpy(rng_.standard_normal((B, H * dh)).astype(np.float32))
        kv = torch.from_numpy(rng_.standard_normal((L, A, H, 2, dh, 96)).astype(np.float32))

    def run(p):
        kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        sc = {} if k_s is None else dict(k_scale=torch.from_numpy(k_s.copy()),
                                         v_scale=torch.from_numpy(v_s.copy()))
        qt, kn, vn, kst = (torch.from_numpy(x) for x in (q, *new, ks))
        if row == "append":
            out = self_attention_append_step_plain(qt, kn, vn, kt, vt, layer, p, kst, window=W)
        elif row in ("beam", "beam_int8"):
            fresh = (None, None) if row == "beam_int8" else (kn, vn)
            out = beam_self_attention_step_plain(qt, *fresh, kt, vt, layer, p, kst,
                                                 torch.from_numpy(anc), G, window=W, **sc)
        elif row == "step_int8":
            out = self_attention_step_plain(qt, kt, vt, layer, p, kst, window=W, **sc,
                                            k_new=kn, v_new=vn)
        elif row == "fused":
            out = self_attention_fused_step_plain(qt, kt, vt, layer, p, kst, window=W)
        else:
            out = decoder_step_fused_plain(x, weights, kv, kt, vt, p, kst, n_head=H, group=G,
                                           window=W)
            return out, x, kt, vt, sc
        return out, None, kt, vt, sc

    want = run(pos)
    got = run(torch.tensor(pos))
    for a, b in zip(want[2:4] + tuple(want[4].values()), got[2:4] + tuple(got[4].values())):
        assert torch.equal(a, b)
    assert torch.equal(want[0], got[0])

    dead = run(torch.tensor(-1))
    assert torch.equal(dead[2], torch.from_numpy(k)) and torch.equal(dead[3], torch.from_numpy(v))
    for name, s in dead[4].items():
        assert torch.equal(s, torch.from_numpy(k_s if name == "k_scale" else v_s))
    if row == "layer":
        assert torch.equal(dead[0], dead[1])
        return
    assert not dead[0].any()

    jks = jnp.asarray(ks, jnp.int32)
    if row == "append":
        ref = jax_append(jnp.asarray(q), *(jnp.asarray(x) for x in new),
                         jnp.asarray(_jax_plane(k)), jnp.asarray(_jax_plane(v)),
                         jnp.int32(layer), jnp.int32(pos), jks, window=W, interpret=True)[0]
    elif row == "fused":
        ref = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
                        jnp.int32(pos), jks, window=W, interpret=True)
    elif row == "beam":
        k_w, v_w = k.copy(), v.copy()
        k_w[layer, :, :, pos], v_w[layer, :, :, pos] = new
        ref = jax_beam_attention(jnp.asarray(q), jnp.asarray(np.swapaxes(k_w, -1, -2)),
                                 jnp.asarray(v_w), jnp.int32(layer), jnp.int32(pos), jks,
                                 jnp.asarray(anc), G, window=W, interpret=True)
    elif row == "beam_int8":
        ref = jax_beam_attention(jnp.asarray(q), jnp.asarray(np.swapaxes(k, -1, -2)),
                                 jnp.asarray(v), jnp.int32(layer), jnp.int32(pos), jks,
                                 jnp.asarray(anc), G, window=W,
                                 k_scale=jnp.asarray(k_s[..., None]),
                                 v_scale=jnp.asarray(v_s[..., None]), interpret=True)
    else:  # row 10 read after its own column write: the written planes
        kt, vt, sc = got[2], got[3], got[4]
        ref = jax_self_step(jnp.asarray(q), jnp.asarray(np.swapaxes(kt.numpy(), -1, -2)),
                            jnp.asarray(vt.numpy()), jnp.int32(layer), jnp.int32(pos), jks,
                            window=W, k_scale=jnp.asarray(sc["k_scale"].numpy()[..., None]),
                            v_scale=jnp.asarray(sc["v_scale"].numpy()[..., None]),
                            interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


class _Tok:
    token_id_sot, token_id_eot, token_id_no_speech = SOT, EOT, NO_SPEECH
    token_id_startofprev, token_id_no_timestamps, token_id_ts_begin = SOP, 599, 600
    token_id_space, token_id_translate, token_id_transcribe = 7, 504, 505
    token_id_prev = SOP

    def sequence_sot(self):
        return [SOT]

    def non_speech_tokens(self):
        return (3, 5)

    def decode(self, toks):
        return " ".join(str(int(t)) for t in toks)

    def encode(self, text):
        return [10 + (ord(c) % 50) for c in text]


def test_decode_task_warmup_then_run_equals_run_and_reuses_its_window(setup):
    _, model, mel = setup
    opts = DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN)
    fresh = DecodeTask(model, _Tok(), opts).run(torch.from_numpy(mel))
    task = DecodeTask(model, _Tok(), opts)
    task.warmup(batch_sizes=(2,), with_prompts=True)
    assert len(task.windows) == 0  # on the CPU there is nothing to capture
    first = task.run(torch.from_numpy(mel))
    (win,) = task.windows._windows.values()
    again = task.run(torch.from_numpy(mel))
    assert len(task.windows) == 1 and next(iter(task.windows._windows.values())) is win
    for a, b, c in zip(fresh, first, again, strict=True):
        assert a.tokens.tolist() == b.tokens.tolist() == c.tokens.tolist()
        assert a.avg_logprob == b.avg_logprob == c.avg_logprob
        assert a.no_speech_prob == b.no_speech_prob == c.no_speech_prob


def test_serving_engine_warmup_delegates(setup):
    _, model, _ = setup
    opts = TranscribeOptions(decode=DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN))
    calls = []
    with ServingEngine(model, _Tok(), opts, batch_size=3) as engine:
        engine.decode_task.warmup = lambda **kw: calls.append(kw)
        engine.warmup()
    assert calls == [{"batch_sizes": (3,), "with_prompts": engine._condition}]


def test_enable_nan_checks_names_the_planted_module(setup):
    params, _, mel = setup
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    with torch.no_grad():
        model.decoder.blocks[1].attn.query.weight[3, 5] = float("nan")
    args = (model, torch.from_numpy(mel), np.full((2, 1), SOT), 1, 0, FilterConfig(**CFG_KW),
            GreedyMode(), 4, NO_SPEECH)
    assert torch.isfinite(decode_greedy(*args).candidates.float()).all()  # off: no check
    debug.enable_nan_checks(model)
    try:
        assert debug.nan_checks_enabled()
        with pytest.raises(FloatingPointError, match=r"decoder\.blocks\.1\.attn\.query"):
            decode_greedy(*args)
    finally:
        debug.disable_nan_checks()
    assert not debug.nan_checks_enabled()


def test_eager_rules_are_decided_from_the_configuration():
    card = types.SimpleNamespace(device=torch.device("cuda"), mesh=None)
    assert decode_loop.eager_reason(card, graphs=True) is None
    assert decode_loop.eager_reason(card, graphs=False) == "graphs=False"
    assert decode_loop.eager_reason(types.SimpleNamespace(device=torch.device("cpu"), mesh=None),
                                    graphs=True) == "the CPU"
    card.mesh = Mesh(n_model=2, model=0, model_group=object(), backend="gloo")
    assert decode_loop.eager_reason(card, graphs=True) == "collectives through gloo"
    card.mesh = Mesh(n_model=2, model=0, model_group=object(), backend="nccl")
    assert decode_loop.eager_reason(card, graphs=True) is None  # NCCL is captured
    card.mesh = Mesh(n_data=2, data=1, data_group=object(), backend="gloo")
    assert decode_loop.eager_reason(card, graphs=True) is None  # no collective on the step
    card.mesh = None
    debug.enable_nan_checks()
    try:
        assert decode_loop.eager_reason(card, graphs=True) == "enable_nan_checks"
    finally:
        debug.disable_nan_checks()


class _Graph:
    """Stands in for a captured phase: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_captured_window_runs_eagerly_while_nan_checks_are_on(setup, monkeypatch):
    """The loop is decided at every call (``DecodeWindow.prepare``): a window
    captured before ``enable_nan_checks`` runs its bodies eagerly while the
    checks are on, and replays its graphs again, without a new capture,
    once they are off.  The window is made on the CPU, then shown a model
    on the card, and its capture stands in by a graph that counts replays."""
    _, model, _ = setup
    shape, _ = decode_loop.greedy_shape(GreedyMode(), 2, 1, 1, SAMPLE_LEN, False,
                                        FilterConfig(**CFG_KW), kernels=False)
    win = decode_loop.DecodeWindow(model, shape)
    win.model = types.SimpleNamespace(device=torch.device("cuda"), mesh=None)
    graph, captures, bodies = _Graph(), [], []

    def capture():
        captures.append(1)
        win.graphs = {W: (graph, {}) for W in win.phases}

    monkeypatch.setattr(win, "_capture_all", capture)
    monkeypatch.setattr(win, "body", lambda W: bodies.append(W))
    W = win.phases[0]
    assert win.prepare(graphs=True) and win.eager is None
    win.run_phase_steps(W, 2)
    assert (graph.replays, len(bodies)) == (2, 0)
    debug.enable_nan_checks()
    try:
        assert not win.prepare(graphs=True) and win.eager == "enable_nan_checks"
        win.run_phase_steps(W, 3)
        assert (graph.replays, len(bodies)) == (2, 3)
    finally:
        debug.disable_nan_checks()
    assert not win.prepare(graphs=True) and win.eager is None
    win.run_phase_steps(W, 1)
    assert (graph.replays, len(bodies), len(captures)) == (3, 3, 1)
    assert not win.prepare(graphs=False) and win.eager == "graphs=False"


def test_window_cache_holds_one_window_a_prefill_bucket(setup):
    """One window a shape, captured or eager alike; at most one a prefill
    bucket, the least recently used dropped; ``clear`` drops them all."""
    _, model, _ = setup
    cfg = FilterConfig(**CFG_KW)
    windows = decode_loop.WindowCache()
    assert windows.SIZE == len(PREFILL_BUCKETS)
    shapes = [decode_loop.greedy_shape(GreedyMode(), 1, width, width, SAMPLE_LEN, True, cfg,
                                       kernels=False)[0] for width in PREFILL_BUCKETS]
    made = [windows.get(model, sh) for sh in shapes]
    assert [windows.get(model, sh) for sh in shapes] == made and len(windows) == len(shapes)
    extra = decode_loop.beam_shape(BeamSearchMode(beam_size=2), 1, 8, 8, SAMPLE_LEN, True, cfg,
                                   kernels=False)
    windows.get(model, extra)
    assert len(windows) == windows.SIZE and shapes[0] not in {k[1] for k in windows._windows}
    windows.clear()
    assert len(windows) == 0


def test_decode_task_and_serving_engine_close_drop_their_windows(setup):
    _, model, mel = setup
    opts = DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN)
    task = DecodeTask(model, _Tok(), opts)
    task.run(torch.from_numpy(mel))
    assert len(task.windows) == 1
    task.close()
    assert len(task.windows) == 0
    engine = ServingEngine(model, _Tok(), TranscribeOptions(decode=opts), batch_size=2)
    engine.decode_task.run(torch.from_numpy(mel))
    sampling = engine._sampling_task()
    sampling.run(torch.from_numpy(mel), temperature=0.5)
    assert len(engine.decode_task.windows) == len(sampling.windows) == 1
    engine.close()
    assert len(engine.decode_task.windows) == len(sampling.windows) == 0
