"""The port's BatchTranscriber (whisper_rs_tpu_torch.parallel.batch) on the
CPU: equal to the port's sequential TranscribeTask on the same model, with
plain greedy, with the temperature fallback ladder (every window forced off
rung 0), with the no-speech skip and with word timestamps; equal to the JAX
BatchTranscriber on the same weights and audio (plain and with the ladder);
a failing utterance isolated from its batchmates; every decode call padded
to the batch size (mirrors tests/test_batch_transcriber.py)."""

import jax
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import DecodeOptions as JaxDecodeOptions
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.config import TranscribeOptions as JaxTranscribeOptions
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.parallel.batch import BatchTranscriber as JaxBatchTranscriber
from whisper_rs_tpu_torch import TranscribeTask
from whisper_rs_tpu_torch.config import DecodeOptions, GreedyMode, ModelDims, TranscribeOptions
from whisper_rs_tpu_torch.models import params_from_jax
from whisper_rs_tpu_torch.parallel import BatchTranscriber

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops here run thousands of small torch ops; on torch's
    default pool, under the suite's parallel workers, its threads contend
    with the other workers' (one test took 650 s against 30 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SmallTokenizer:
    """Duck-typed tokenizer with ids inside the tiny test vocab."""

    token_id_sot = 501
    token_id_eot = 500
    token_id_no_speech = 502
    token_id_startofprev = 503
    token_id_startoflm = 504
    token_id_no_timestamps = 599
    token_id_ts_begin = 600
    token_id_space = 7

    def decode(self, toks):
        return "".join(f" w{int(t)}" for t in toks if int(t) < 500)

    def encode(self, text):
        return [9, 8]

    def sequence_sot(self):
        return [self.token_id_sot]

    def non_speech_tokens(self):
        return (3, 5)


OPTS = dict(sample_len=8, max_initial_timestamp=1.0)


def _opts(jax_side=False, **kw):
    if jax_side:
        return JaxTranscribeOptions(decode=JaxDecodeOptions(mode=JaxGreedy(), **OPTS), **kw)
    return TranscribeOptions(decode=DecodeOptions(mode=GreedyMode(), **OPTS), **kw)


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(21), JaxDims(**FIELDS))
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS), device="cpu")
    rng = np.random.default_rng(9)
    # ~35 s and ~20 s: different window counts, the shorter retires first
    audios = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (35, 20)]
    return params, model, audios


def _assert_same(got, want, words=False):
    assert got.text == want.text
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(got.segments) == len(want.segments)
    for gs, ws in zip(got.segments, want.segments):
        assert (gs.seek, gs.text) == (ws.seek, ws.text)
        assert gs.start_time == pytest.approx(ws.start_time)
        assert gs.end_time == pytest.approx(ws.end_time)
        if words:
            assert (gs.words is None) == (ws.words is None)
            assert [w.word for w in gs.words or []] == [w.word for w in ws.words or []]
            for gw, ww in zip(gs.words or [], ws.words or []):
                assert gw.start == pytest.approx(ww.start) and gw.end == pytest.approx(ww.end)
    np.testing.assert_allclose(got.avg_logprobs, want.avg_logprobs, atol=1e-6)
    np.testing.assert_allclose(got.no_speech_probs, want.no_speech_probs, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "ladder"])
def test_batch_matches_sequential_and_jax(setup, case):
    """The ladder case sets logprob_threshold 1.0 (avg logprobs are always
    negative), so every window falls through to the sampling rung."""
    params, model, audios = setup
    tok = SmallTokenizer()
    kw = dict(temperatures=(0.0, 0.5), logprob_threshold=1.0) if case == "ladder" else {}
    batch = BatchTranscriber(model, tok, _opts(**kw), batch_size=2)
    outs = batch.run(audios)
    assert (batch._sampling_task_cache is not None) == (case == "ladder")
    for audio, got in zip(audios, outs):
        _assert_same(got, TranscribeTask(model, tok, _opts(**kw)).run(audio))
    want = JaxBatchTranscriber(params, JaxDims(**FIELDS), tok, _opts(True, **kw),
                               batch_size=2).run(audios)
    for got, w in zip(outs, want, strict=True):
        assert got.text == w.text and got.tokens.tolist() == w.tokens.tolist()
        assert [(s.seek, s.text) for s in got.segments] == [(s.seek, s.text) for s in w.segments]
        np.testing.assert_allclose(got.avg_logprobs, w.avg_logprobs, atol=1e-4)


def test_batch_no_speech_skip(setup):
    """Every window silent (threshold -1) and low-confidence (threshold
    +1): no segments, the quality metrics still recorded, as sequentially."""
    _, model, audios = setup
    tok = SmallTokenizer()
    opts = _opts(no_speech_threshold=-1.0, logprob_threshold=1.0)
    outs = BatchTranscriber(model, tok, opts, batch_size=2).run(audios)
    for audio, got in zip(audios, outs):
        want = TranscribeTask(model, tok, opts).run(audio)
        assert got.text == want.text == "" and got.segments == want.segments == []
        assert got.no_speech_probs == pytest.approx(want.no_speech_probs)
        assert len(got.no_speech_probs) == -(-len(audio) // 480_000)


def test_batch_word_timestamps_match_sequential(setup):
    _, model, audios = setup
    tok = SmallTokenizer()
    opts = _opts(word_timestamps=True, temperatures=(0.0, 0.5), logprob_threshold=1.0)
    outs = BatchTranscriber(model, tok, opts, batch_size=2).run(audios)
    for audio, got in zip(audios, outs):
        _assert_same(got, TranscribeTask(model, tok, opts).run(audio), words=True)
    words = [w for o in outs for s in o.segments for w in (s.words or [])]
    assert words and all(0.0 <= w.start <= w.end for w in words)


def test_error_isolation(setup):
    """A failing utterance (a simulated device error on any batch holding
    its NaN window) yields None with raise_on_error=False; its batchmate is
    transcribed; raise_on_error=True surfaces the error."""
    _, model, audios = setup
    batch = BatchTranscriber(model, SmallTokenizer(), _opts(), batch_size=2)
    bad = np.full(16000 * 5, np.nan, np.float32)

    class Boom(Exception):
        pass

    run_batch = batch.decode_task.run_batch

    def flaky(mel, prompts, **kw):
        if torch.isnan(mel).any():
            raise Boom("device error")
        return run_batch(mel, prompts, **kw)

    batch.decode_task.run_batch = flaky
    outs = batch.run([audios[1], bad], raise_on_error=False)
    assert outs[0] is not None and outs[0].text and outs[1] is None
    with pytest.raises(Boom):
        batch.run([audios[1], bad])


def test_batch_padded_to_static_size(setup):
    """Every decode call sees batch_size rows: as utterances retire the
    batch is padded with repeats, and the padded rows are dropped."""
    _, model, audios = setup
    batch = BatchTranscriber(model, SmallTokenizer(), _opts(), batch_size=3)
    seen = []
    run_batch = batch.decode_task.run_batch

    def spy(mel, prompts, **kw):
        seen.append((mel.shape[0], len(prompts)))
        return run_batch(mel, prompts, **kw)

    batch.decode_task.run_batch = spy
    outs = batch.run(audios)
    assert len(outs) == 2 and outs[0].text and outs[1].text
    assert len(seen) >= 2 and all(s == (3, 3) for s in seen), seen


def test_sampling_task_inherits_quantize_kv(setup):
    _, model, _ = setup
    batch = BatchTranscriber(model, SmallTokenizer(), _opts(temperatures=(0.0, 0.5)))
    batch.decode_task.quantize_kv = True
    assert batch._sampling_task().quantize_kv
    assert batch._sampling_task().options.mode == GreedyMode(group_size=1)
