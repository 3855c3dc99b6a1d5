"""The port's ServingEngine (whisper_rs_tpu_torch.serve) on the CPU, mirroring
tests/test_serve.py at the dims of tests/test_torch_batch.py: every
request's output equal to the port's sequential TranscribeTask exactly and
to the JAX ServingEngine on the same weights and audio (plain, with the
temperature ladder forced off rung 0, and with word timestamps);
mid-flight admission with no drain barrier; per-request error isolation;
an unreadable input rejected at submit; stats and partial segments; every
decode call padded to batch_size; close(), drain(timeout) and the queue's
bound."""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.serve import ServingEngine as JaxServingEngine
from whisper_rs_tpu_torch import RequestHandle, ServingEngine, TranscribeTask
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import params_from_jax

from test_torch_batch import FIELDS, SmallTokenizer, _opts

CASES = {
    "plain": {},
    "ladder": dict(temperatures=(0.0, 0.5), logprob_threshold=1.0),
    "words": dict(word_timestamps=True),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops run thousands of small torch ops; on one thread they
    do not contend with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(JAX params, the port model of them, three seeded files of 12, 8 and
    5 s: at these weights each window advances 2.52 s, so 5, 4 and 2
    windows, and the shorter files retire first)."""
    params = init_params(jax.random.PRNGKey(21), JaxDims(**FIELDS))
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS), device="cpu")
    rng = np.random.default_rng(9)
    audios = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (12, 8, 5)]
    return params, model, audios


@pytest.fixture(scope="module")
def want(setup):
    """Per case, each file's transcription by the port's sequential
    TranscribeTask and by the JAX ServingEngine (batch 2)."""
    params, model, audios = setup
    tok = SmallTokenizer()
    out = {}
    for case, kw in CASES.items():
        sequential = [TranscribeTask(model, tok, _opts(**kw)).run(a) for a in audios]
        with JaxServingEngine(params, JaxDims(**FIELDS), tok, _opts(True, **kw),
                              batch_size=2) as engine:
            handles = [engine.submit(a) for a in audios]
            jax_outs = [h.result(timeout=600) for h in handles]
        out[case] = (sequential, jax_outs)
    return out


@pytest.fixture(scope="module")
def served(setup):
    """Per case, one run of the port's engine at batch 2 over the three
    files submitted at once: (outputs, handles, stats after the drain, the
    (rows, prompts) of every decode call of the primary task)."""
    _, model, audios = setup
    runs = {}

    def run(case):
        if case not in runs:
            engine = ServingEngine(model, SmallTokenizer(), _opts(**CASES[case]), batch_size=2)
            calls = []
            run_batch = engine.decode_task.run_batch

            def spy(mel, prompts, **kw):
                calls.append((mel.shape[0], len(prompts)))
                return run_batch(mel, prompts, **kw)

            engine.decode_task.run_batch = spy
            with engine:
                handles = [engine.submit(a) for a in audios]
                assert engine.drain(timeout=600)
                outs = [h.result(timeout=1) for h in handles]
                stats = engine.stats()
                assert (engine._sampling_task_cache is not None) == (case == "ladder")
            runs[case] = (outs, handles, stats, calls)
        return runs[case]

    return run


def _assert_same(got, seq, jax_out, words=False):
    """Tokens, text and segments equal to the sequential task's and the JAX
    engine's; avg_logprobs within 1e-6 of the sequential task's (a batch of
    2 sums in another order than a batch of 1) and 1e-4 of the JAX
    engine's (tests/test_torch_batch.py)."""
    assert got.text == seq.text == jax_out.text
    np.testing.assert_array_equal(got.tokens, seq.tokens)
    assert got.tokens.tolist() == jax_out.tokens.tolist()
    assert [(s.seek, s.start_time, s.end_time, s.text) for s in got.segments] == [
        (s.seek, s.start_time, s.end_time, s.text) for s in seq.segments]
    assert [(s.seek, s.text) for s in got.segments] == [(s.seek, s.text)
                                                        for s in jax_out.segments]
    np.testing.assert_allclose(got.avg_logprobs, seq.avg_logprobs, atol=1e-6)
    np.testing.assert_allclose(got.no_speech_probs, seq.no_speech_probs, atol=1e-6)
    np.testing.assert_allclose(got.avg_logprobs, jax_out.avg_logprobs, atol=1e-4)
    if words:
        for gs, ss, js in zip(got.segments, seq.segments, jax_out.segments, strict=True):
            for other in (ss, js):
                assert [w.word for w in gs.words or []] == [w.word for w in other.words or []]
                for gw, ow in zip(gs.words or [], other.words or []):
                    assert gw.start == pytest.approx(ow.start) and gw.end == pytest.approx(ow.end)


@pytest.mark.parametrize("case", list(CASES))
def test_serving_matches_sequential_and_jax(want, served, case):
    """Plain; the ladder with every window forced off rung 0 (avg logprobs
    are always below 1.0), so the sampling task must engage; word
    timestamps, word by word."""
    outs = served(case)[0]
    for got, seq, jax_out in zip(outs, *want[case], strict=True):
        _assert_same(got, seq, jax_out, words=case == "words")
    if case == "words":
        assert any(s.words for o in outs for s in o.segments)


def test_continuous_admission_no_drain_barrier(setup, want):
    """A request submitted while the engine is mid-utterance joins the next
    round beside it, not after a drain; its output is unchanged."""
    _, model, audios = setup
    engine = ServingEngine(model, SmallTokenizer(), _opts(), batch_size=2)
    rounds = []
    run_batch = engine.decode_task.run_batch
    started = threading.Event()

    def spy(mel, prompts, **kw):
        rounds.append(sorted(j.handle.request_id for j in engine._active if j is not None))
        started.set()
        return run_batch(mel, prompts, **kw)

    engine.decode_task.run_batch = spy
    try:
        h_long = engine.submit(audios[0])  # 5 windows: 5 rounds
        assert started.wait(timeout=600)
        h_late = engine.submit(audios[2])  # 2 windows, submitted mid-flight
        out_long, out_late = h_long.result(timeout=600), h_late.result(timeout=600)
    finally:
        engine.close()
    assert [r for r in rounds if len(r) == 2], rounds
    assert rounds[0] == [h_long.request_id]
    (seq, jax_outs) = want["plain"]
    _assert_same(out_long, seq[0], jax_outs[0])
    _assert_same(out_late, seq[2], jax_outs[2])


def test_error_isolation_per_request(setup, want):
    """A request whose window fails the decode (a simulated device error on
    any call holding its NaN window) fails alone; its batchmate completes
    with its sequential output."""
    _, model, audios = setup
    engine = ServingEngine(model, SmallTokenizer(), _opts(), batch_size=2)

    class Boom(Exception):
        pass

    run_batch = engine.decode_task.run_batch

    def flaky(mel, prompts, **kw):
        if torch.isnan(mel).any():
            raise Boom("device error")
        return run_batch(mel, prompts, **kw)

    engine.decode_task.run_batch = flaky
    try:
        h_good = engine.submit(audios[1])
        h_bad = engine.submit(np.full(16000 * 5, np.nan, np.float32))
        out = h_good.result(timeout=600)
        with pytest.raises(Boom):
            h_bad.result(timeout=600)
    finally:
        engine.close()
    _assert_same(out, want["plain"][0][1], want["plain"][1][1])
    s = engine.stats()
    assert s["completed"] == 1 and s["failed"] == 1


def test_unreadable_audio_rejected_at_submit(setup, want):
    """An input the mel refuses (not one file) fails its own handle at submit;
    an empty file resolves either way (as the JAX engine's); the engine
    stays up."""
    _, model, audios = setup
    with ServingEngine(model, SmallTokenizer(), _opts(), batch_size=2) as engine:
        h_bad = engine.submit(np.zeros((2, 16000), np.float32))
        assert h_bad.done() and isinstance(h_bad._error, ValueError)
        with pytest.raises(ValueError):
            h_bad.result(timeout=1)
        h_empty = engine.submit(np.zeros((0,), np.float32))
        h_good = engine.submit(audios[2])
        _assert_same(h_good.result(timeout=600), want["plain"][0][2], want["plain"][1][2])
        h_empty._done.wait(600)
        assert h_empty.done()
        s = engine.stats()
    assert s["submitted"] == 3 and s["failed"] >= 1


def test_stats_and_partial_segments(want, served):
    outs, handles, s, _ = served("plain")
    assert s["submitted"] == 3 and s["completed"] == 3 and s["failed"] == 0
    assert s["queued"] == 0 and s["active"] == 0
    assert s["windows_decoded"] == 11  # 5 + 4 + 2 windows, one rung each
    assert s["batch_utilization"] == pytest.approx(11 / (2 * s["window_batches"]))
    assert s["throughput_audio_s_per_s"] > 0.0 and s["audio_seconds_done"] == 25.0
    assert s["latency_p50"] is not None and s["latency_p95"] is not None
    for h, out, seq, jax_out in zip(handles, outs, *want["plain"], strict=True):
        assert isinstance(h, RequestHandle) and h.latency > 0.0
        assert h.segments_so_far() == out.segments
        _assert_same(out, seq, jax_out)


def test_every_call_padded_to_batch_size(served):
    """Every decode call holds batch_size rows: once a file retires, its row
    is padded with repeats, and the padded rows are dropped (the counts
    show some were)."""
    _, _, s, calls = served("plain")
    assert len(calls) == s["window_batches"] and all(c == (2, 2) for c in calls), calls
    assert s["batch_utilization"] < 1.0


def test_close_drain_timeout_and_queue_bound(setup, want):
    """drain(timeout) returns False while a call is in flight and True once
    it is done; a full queue and a closed engine refuse submit; close()
    joins the engine thread."""
    _, model, audios = setup
    engine = ServingEngine(model, SmallTokenizer(), _opts(), batch_size=1, max_queue=1)
    release, entered = threading.Event(), threading.Event()
    run_batch = engine.decode_task.run_batch

    def held(mel, prompts, **kw):
        entered.set()
        assert release.wait(timeout=600)
        return run_batch(mel, prompts, **kw)

    engine.decode_task.run_batch = held
    try:
        h1 = engine.submit(audios[2])
        assert entered.wait(timeout=600)  # h1 holds the only row
        h2 = engine.submit(audios[1])  # queued
        with pytest.raises(RuntimeError, match="queue full"):
            engine.submit(audios[2])
        assert not engine.drain(timeout=0.05)
    finally:
        release.set()
    assert engine.drain(timeout=600)
    engine.close(timeout=60)
    assert not engine._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(audios[2])
    _assert_same(h1.result(timeout=1), want["plain"][0][2], want["plain"][1][2])
    _assert_same(h2.result(timeout=1), want["plain"][0][1], want["plain"][1][1])


def test_warmup_touches_no_counter_and_the_sampling_task_inherits_int8_kv(setup):
    _, model, _ = setup
    opts = dataclasses.replace(_opts(temperatures=(0.0, 0.5)), initial_prompt_text="hi")
    with ServingEngine(model, SmallTokenizer(), opts, batch_size=2) as engine:
        calls = []
        run_batch = engine.decode_task.run_batch
        engine.decode_task.run_batch = lambda mel, prompts, **kw: (
            calls.append((mel.shape[0], prompts)) or run_batch(mel, prompts, **kw))
        engine.warmup()
        stats = engine.stats()
        engine.decode_task.quantize_kv = True
        assert engine._sampling_task().quantize_kv
    # conditioned: an unprompted call and one at the widest prefill bucket
    assert [(n, len(p[0] or ())) for n, p in calls] == [(2, 0), (2, 224)]
    assert stats["window_batches"] == stats["windows_decoded"] == stats["submitted"] == 0
