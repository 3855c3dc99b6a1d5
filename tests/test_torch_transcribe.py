"""The transcription slice of the port against the JAX package, on the CPU:
``log_mel_file`` (whole-file floor, chunks with true-sample halos) at 1, 30,
35 and 61.3 s; the transcribe helpers and the seek loop on planted token
sequences (consecutive timestamps, a lone trailing timestamp, none, a
degenerate zero pair, a skipped silent window); ``DecodeTask.run_batch``
greedy and beam 3 with mixed prompts; ``detect_language``; and both frozen
end-to-end goldens (``tests/data/goldens/e2e.json``,
``e2e_multilingual.json``) reproduced by the port's ``TranscribeTask`` and
``DecodeTask`` with weights from the JAX ``init_params`` (tokens and texts
exact, floats within the goldens' 1e-3); and the six-rung temperature
fallback ladder against the JAX ``TranscribeTask`` (the same rungs, tokens,
segments and avg logprobs), with its stubbed retry."""

import json
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_rs_tpu.transcribe as jax_transcribe
from whisper_rs_tpu.audio import log_mel_file as jax_log_mel_file
from whisper_rs_tpu.audio import pad_or_trim as jax_pad_or_trim
from whisper_rs_tpu.config import BeamSearchMode as JaxBeam
from whisper_rs_tpu.config import DecodeOptions as JaxDecodeOptions
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.config import TranscribeOptions as JaxTranscribeOptions
from whisper_rs_tpu.decode import DecodeTask as JaxDecodeTask
from whisper_rs_tpu.decode.language import detect_language as jax_detect_language
from whisper_rs_tpu.decode.task import DecodeOutput as JaxDecodeOutput
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.tokenize import Tokenizer as JaxTokenizer
import whisper_rs_tpu_torch.transcribe as port_transcribe
from whisper_rs_tpu_torch import (
    DecodeOutput,
    DecodeTask,
    Task,
    Tokenizer,
    TranscribeTask,
    detect_language,
    log_mel_file,
)
from whisper_rs_tpu_torch.audio.constants import N_FRAMES
from whisper_rs_tpu_torch.audio.mel import pad_or_trim
from whisper_rs_tpu_torch.config import (
    BeamSearchMode,
    DecodeOptions,
    GreedyMode,
    ModelDims,
    TranscribeOptions,
)
from whisper_rs_tpu_torch.models import params_from_jax
from whisper_rs_tpu_torch.ops import LAUNCHES

GOLDENS = pathlib.Path(__file__).parent / "data" / "goldens"
FIELDS = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
MULTI_FIELDS = dict(FIELDS, n_vocab=51865)
SAMPLE_LEN = 16


def _port_model(seed: int, fields: dict):
    params = init_params(jax.random.PRNGKey(seed), JaxDims(**fields))
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**fields), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def en_stack():
    params, model = _port_model(7, FIELDS)
    audio = (np.random.default_rng(11).standard_normal(16000 * 35) * 0.1).astype(np.float32)
    return params, model, audio


@pytest.fixture(scope="module")
def multilingual_json(tmp_path_factory):
    """The real GPT-2 file with <|endoftext|> moved to 50257, as
    tests/test_golden_multilingual.py builds it."""
    src = pathlib.Path(__file__).parents[1] / "whisper_rs_tpu" / "assets" / "gpt2.json"
    tok = json.loads(src.read_text())
    vocab = tok["model"]["vocab"]
    assert vocab["<|endoftext|>"] == 50256
    vocab["<|endoftext|>"] = 50257
    vocab["<|filler50256|>"] = 50256
    path = tmp_path_factory.mktemp("mtok") / "gpt2_multi.json"
    path.write_text(json.dumps(tok))
    return str(path)


# -- whole-file mel -----------------------------------------------------------


@pytest.mark.parametrize("seconds", [1.0, 30.0, 35.0, 61.3])
def test_log_mel_file_matches_jax(seconds):
    audio = (np.random.default_rng(int(seconds * 10)).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    audio[: 16000 // 2] *= 20  # a loud start sets the whole file's floor
    want = np.asarray(jax_log_mel_file(audio))
    before = dict(LAUNCHES)
    got = log_mel_file(audio, device="cpu")
    assert LAUNCHES == before
    assert got.shape == want.shape == (80, int(16000 * seconds) // 160)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = log_mel_file(audio, device="cpu", kernels=False)
    assert torch.equal(plain, got)


def test_log_mel_file_floors_over_the_whole_file():
    """A loud first window and a quiet second one: the quiet window's floor
    is the file's max - 8, not its own."""
    rng = np.random.default_rng(0)
    audio = np.concatenate([rng.standard_normal(480_000) * 3.0,
                            rng.standard_normal(480_000) * 1e-4]).astype(np.float32)
    mel = log_mel_file(audio, device="cpu")
    floor = (mel.max() - 2.0).item()  # (max - 8 + 4) / 4 in the scaled units
    quiet = mel[:, 3002:]  # frames 3000 and 3001 still reach the loud samples
    assert quiet.min().item() == pytest.approx(floor, abs=1e-6)
    assert quiet.max().item() < mel.max().item() - 1.0


# -- transcribe helpers and the seek loop --------------------------------------

TS, EOT = 600, 500  # the planted tokenizer's ts_begin and EOT


class PlantedTokenizer:
    token_id_sot = 501
    token_id_eot = EOT
    token_id_no_speech = 502
    token_id_startofprev = 503
    token_id_no_timestamps = 599
    token_id_ts_begin = TS
    token_id_space = 7

    def decode(self, toks):
        return "".join(f"<{int(t)}>" for t in toks if int(t) < TS)

    def encode(self, text):
        return [9, 8]


class PlantedDecodeTask:
    """Returns queued windows (tokens, no-speech prob, avg logprob) as the
    package's ``DecodeOutput``; records the prompts it was given."""

    def __init__(self, windows, output_cls):
        self.windows, self.output_cls, self.prompts = list(windows), output_cls, []

    def set_prompt(self, prompt):
        self.prompts.append(list(prompt) if prompt is not None else None)

    def run(self, mel, temperature=None):
        assert tuple(mel.shape) == (80, N_FRAMES)
        toks, no_speech, avg = self.windows.pop(0)
        toks = np.asarray(toks, np.int64)
        return [self.output_cls(tokens=toks, text=PlantedTokenizer().decode(toks),
                                avg_logprob=avg, no_speech_prob=no_speech)]


PLANTED = {
    "consecutive_then_lone_trailing": [
        ([TS, 10, 11, TS + 50, TS + 50, 12, TS + 100, TS + 100], 0.1, -0.5),
        ([TS, 13, TS + 60], 0.1, -0.5),
    ],
    "single_trailing_then_none": [
        ([TS + 3, 20, 21, TS + 700], 0.1, -0.5),
        ([20, 21, 22], 0.1, -0.5),
    ],
    "no_timestamps": [([30, 31, 32], 0.2, -0.4), ([33], 0.2, -0.4)],
    "zero_pair": [([TS, TS], 0.1, -0.5), ([TS, 44, TS + 30], 0.1, -0.5)],
    "silent_window_skipped": [
        ([TS, 10, TS + 40, TS + 40], 0.9, -2.0),
        ([TS, 11, TS + 20, TS + 20, 12, TS + 500], 0.1, -0.5),
        ([TS, 13], 0.95, -1.5),
    ],
}


def _run_planted(module, options, windows, output_cls, n_frames, task_kw):
    task = module.TranscribeTask.__new__(module.TranscribeTask)
    task.dims = JaxDims(**FIELDS) if module is jax_transcribe else ModelDims(**FIELDS)
    task.tokenizer = PlantedTokenizer()
    task.options = options
    task.decode_task = PlantedDecodeTask(windows, output_cls)
    task._aligner = None
    for k, v in task_kw.items():
        setattr(task, k, v)
    mel = np.zeros((80, n_frames), np.float32)
    out = task.run(None, mel=mel if module is jax_transcribe else torch.from_numpy(mel))
    return out, task.decode_task.prompts


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_seek_loop_matches_jax_on_planted_windows(case):
    """The same planted windows through the JAX and the port seek loops:
    the same segments, tokens, text, per-window metrics and prompts."""
    windows = PLANTED[case]
    skip = case == "silent_window_skipped"
    # the last window starts before n_frames and leaves the seek past it
    n_frames = N_FRAMES * (len(windows) - 1) + (30 if skip else 100)
    jax_opts = JaxTranscribeOptions(no_speech_threshold=0.6 if skip else None,
                                    initial_prompt_text="hi" if case == "no_timestamps" else None)
    opts = TranscribeOptions(no_speech_threshold=0.6 if skip else None,
                             initial_prompt_text="hi" if case == "no_timestamps" else None)
    want, want_prompts = _run_planted(jax_transcribe, jax_opts, windows, JaxDecodeOutput,
                                      n_frames, {})
    got, got_prompts = _run_planted(port_transcribe, opts, windows, DecodeOutput, n_frames,
                                    {"model": SimpleNamespace(device=torch.device("cpu")),
                                     "kernels": False})
    assert got_prompts == want_prompts
    assert got.tokens.tolist() == want.tokens.tolist()
    assert got.text == want.text
    assert got.avg_logprobs == want.avg_logprobs and got.no_speech_probs == want.no_speech_probs
    assert [(s.seek, s.start_token, s.end_token, s.text) for s in got.segments] == [
        (s.seek, s.start_token, s.end_token, s.text) for s in want.segments]
    for g, w in zip(got.segments, want.segments, strict=True):
        assert g.start_time == pytest.approx(w.start_time)
        assert g.end_time == pytest.approx(w.end_time)
    if skip:
        assert len(want.avg_logprobs) == 3 and {s.seek for s in got.segments} == {N_FRAMES}


@pytest.mark.parametrize("tokens", [
    [TS, 10, 11, TS + 50, TS + 50, 12, TS + 100, TS + 100],  # consecutive timestamps
    [TS + 5, 10, 11, TS + 77],  # a single trailing timestamp
    [10, 11, 12],  # none
    [TS, 10, TS + 33, TS + 33, 11],  # a pair, then text to the end
])
@pytest.mark.parametrize("seek", [0, 1234])
def test_process_window_result_matches_jax(tokens, seek):
    toks = np.asarray(tokens, np.int64)
    out = {}
    for module in (jax_transcribe, port_transcribe):
        acc, segs = [7, 7], []
        new_seek = module.process_window_result(acc, segs, toks, "text", seek, TS, 2, 0.02,
                                                PlantedTokenizer().decode)
        out[module] = (new_seek, acc, [(s.seek, round(s.start_time, 9), round(s.end_time, 9),
                                        s.start_token, s.end_token, s.text) for s in segs])
    assert out[port_transcribe] == out[jax_transcribe]


def test_quality_helpers_match_jax():
    texts = ["", "hello there", "la " * 40, "the cat sat on the mat " * 3]
    for text in texts:
        assert port_transcribe.compression_ratio(text) == jax_transcribe.compression_ratio(text)
    for thr in (None, 0.5):
        jax_opts = JaxTranscribeOptions(no_speech_threshold=thr)
        opts = TranscribeOptions(no_speech_threshold=thr)
        for text in texts:
            for avg in (-2.0, -0.5):
                for ns in (None, 0.2, 0.9):
                    assert port_transcribe.needs_fallback(opts, text, avg, ns) == \
                        jax_transcribe.needs_fallback(jax_opts, text, avg, ns)
                    if ns is not None:
                        assert port_transcribe.should_skip_no_speech(opts, ns, avg) == \
                            jax_transcribe.should_skip_no_speech(jax_opts, ns, avg)


def test_sub_frame_audio_yields_empty_output(en_stack):
    _, model, _ = en_stack
    out = TranscribeTask(model, Tokenizer()).run(np.zeros(100, np.float32))
    assert out.segments == [] and out.text == "" and out.tokens.size == 0


# -- DecodeTask and language identification -----------------------------------


@pytest.mark.parametrize("mode", ["greedy", "beam3"])
def test_decode_task_run_batch_matches_jax(en_stack, mode):
    """Three windows, unprompted and with a short and a long prompt
    (end-aligned into the 64 bucket, per-row key_start)."""
    params, model, audio = en_stack
    jax_tok, tok = JaxTokenizer(), Tokenizer()
    rng = np.random.default_rng(3)
    mels = np.stack([np.asarray(jax_pad_or_trim(jax_log_mel_file(
        audio[i * 16000:] * np.float32(1 + i)), 3000)) for i in range(3)])
    long_prompt = rng.integers(300, 40_000, size=40).tolist()
    prompts = [None, tok.encode(" previous window text"), long_prompt]
    jax_mode, port_mode = ((JaxGreedy(), GreedyMode()) if mode == "greedy"
                           else (JaxBeam(beam_size=3), BeamSearchMode(beam_size=3)))
    want = JaxDecodeTask(params, JaxDims(**FIELDS), jax_tok,
                         JaxDecodeOptions(mode=jax_mode, sample_len=SAMPLE_LEN)
                         ).run_batch(mels, prompts)
    got = DecodeTask(model, tok, DecodeOptions(mode=port_mode, sample_len=SAMPLE_LEN)
                     ).run_batch(torch.from_numpy(mels), prompts)
    for g, w in zip(got, want, strict=True):
        assert g.tokens.tolist() == w.tokens.tolist()
        assert g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-5


def test_detect_language_matches_jax(multilingual_json):
    params, model = _port_model(13, MULTI_FIELDS)
    audio = (np.random.default_rng(17).standard_normal(16000 * 30) * 0.1).astype(np.float32)
    mel = np.stack([np.asarray(jax_log_mel_file(audio * np.float32(s))) for s in (1.0, 3.0)])
    jax_tok = JaxTokenizer(tokenizer_json=multilingual_json)
    tok = Tokenizer(tokenizer_json=multilingual_json)
    want = jax_detect_language(params, mel, JaxDims(**MULTI_FIELDS), jax_tok)
    got = detect_language(model, torch.from_numpy(mel), tok)
    for g, w in zip(got, want, strict=True):
        assert list(g)[0] == list(w)[0] and set(g) == set(w) and len(g) == 99
        np.testing.assert_allclose([g[c] for c in w], list(w.values()), atol=1e-6)


def test_layer_route_at_head_dim_16_decodes_as_the_append_route(en_stack):
    """The whole-step kernel refuses head dim 16, so a greedy DecodeTask
    with step_kernel="layer" takes the append route, as the JAX loop takes
    the layered step: the same outputs, bit for bit."""
    _, model, audio = en_stack
    tok = Tokenizer()
    mel = pad_or_trim(log_mel_file(audio, device="cpu"), 3000)[None]
    opts = DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN)
    want = DecodeTask(model, tok, opts).run(mel)[0]
    got = DecodeTask(model, tok, opts, step_kernel="layer").run(mel)[0]
    assert got.tokens.tolist() == want.tokens.tolist() and got.avg_logprob == want.avg_logprob


def test_unported_options_raise(en_stack):
    """What still raises: a temperature override on a beam-search task (the
    ladder samples with its own best-of-N greedy task).  The ladder, word
    timestamps, ``keep_audio_features`` and a greedy override all run."""
    _, model, _ = en_stack
    tok = Tokenizer()
    with pytest.raises(ValueError, match="greedy"):
        DecodeTask(model, tok, DecodeOptions(sample_len=2)).run(torch.zeros(80, 3000),
                                                               temperature=0.0)
    with pytest.raises(ValueError, match="greedy"):
        DecodeTask(model, tok, DecodeOptions(sample_len=2)).run(torch.zeros(80, 3000),
                                                               temperature=0.5)
    task = DecodeTask(model, tok, DecodeOptions(mode=GreedyMode(), sample_len=2),
                      keep_audio_features=True)
    out = task.run(torch.zeros(80, 3000), temperature=0.5)[0]
    assert out.audio_features.shape == (1500, 64)
    assert TranscribeTask(model, tok, TranscribeOptions(temperatures=(0.0, 0.2),
                                                        word_timestamps=True))._aligner


# -- the temperature fallback ladder --------------------------------------------

LADDER = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@pytest.fixture
def one_torch_thread():
    """The ladder runs thousands of small torch ops; on torch's default
    pool, under the suite's parallel workers, its threads contend with the
    other workers' (the ladder test took 650 s against 30 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record_rungs(monkeypatch, cls):
    """The temperature (None: the primary task) of every window decode."""
    rungs = []
    run = cls.run

    def recording(self, mel, temperature=None):
        rungs.append(temperature)
        return run(self, mel, temperature=temperature)

    monkeypatch.setattr(cls, "run", recording)
    return rungs


@pytest.mark.usefixtures("one_torch_thread")
def test_temperature_ladder_matches_jax(en_stack, monkeypatch):
    """OpenAI's six-rung ladder over the 35 s file, beam 3 at rung 0 and
    best-of-3 sampling above it, against the JAX TranscribeTask on the same
    weights and audio: the same rungs taken, tokens, segments and avg
    logprobs.  Random weights decode at an avg logprob near -7, far under
    the -1 threshold, so every window climbs the whole ladder."""
    params, model, audio = en_stack
    jax_opts = JaxTranscribeOptions(
        decode=JaxDecodeOptions(mode=JaxBeam(beam_size=3), sample_len=SAMPLE_LEN),
        temperatures=LADDER, no_speech_threshold=0.6)
    opts = TranscribeOptions(
        decode=DecodeOptions(mode=BeamSearchMode(beam_size=3), sample_len=SAMPLE_LEN),
        temperatures=LADDER, no_speech_threshold=0.6)
    jax_rungs = _record_rungs(monkeypatch, JaxDecodeTask)
    want = jax_transcribe.TranscribeTask(params, JaxDims(**FIELDS), JaxTokenizer(),
                                         jax_opts).run(audio)
    rungs = _record_rungs(monkeypatch, DecodeTask)
    task = TranscribeTask(model, Tokenizer(), opts)
    got = task.run(audio)
    assert rungs == jax_rungs == [None, *LADDER[1:]] * len(got.avg_logprobs)
    assert task._fallback_tasks["sampling"].options.mode == \
        GreedyMode(group_size=3)
    assert got.tokens.tolist() == want.tokens.tolist()
    assert got.text == want.text
    assert [(s.seek, s.start_token, s.end_token, s.text) for s in got.segments] == [
        (s.seek, s.start_token, s.end_token, s.text) for s in want.segments]
    for g, w in zip(got.segments, want.segments, strict=True):
        assert g.start_time == pytest.approx(w.start_time)
        assert g.end_time == pytest.approx(w.end_time)
    np.testing.assert_allclose(got.avg_logprobs, want.avg_logprobs, atol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs, want.no_speech_probs, atol=1e-5)


def test_temperature_ladder_retries():
    """Mirrors tests/test_sampling_and_ckpt.py::test_temperature_ladder_retries:
    a window failing the quality checks is decoded again at the next rung by
    the sampling task, which takes the rung at run time."""
    calls = []

    class StubTask:
        def __init__(self, temperature, outputs):
            self.temperature, self.outputs = temperature, outputs

        def set_prompt(self, p):
            pass

        def run(self, mel, temperature=None):
            calls.append(self.temperature if temperature is None else temperature)
            return [self.outputs.pop(0)]

    bad = DecodeOutput(tokens=np.asarray([600, 10], np.int64), text="x", avg_logprob=-5.0,
                       no_speech_prob=0.0)
    good = DecodeOutput(tokens=np.asarray([600, 11], np.int64), text="fine words",
                        avg_logprob=-0.2, no_speech_prob=0.0)
    task = TranscribeTask.__new__(TranscribeTask)
    task.dims = ModelDims(**FIELDS)
    task.model = SimpleNamespace(device=torch.device("cpu"))
    task.kernels = False
    task.tokenizer = SimpleNamespace(token_id_ts_begin=600, decode=lambda toks: "t",
                                     encode=lambda s: [1])
    task.options = TranscribeOptions(temperatures=(0.0, 0.4), condition_on_prev_text=False)
    task.decode_task = StubTask(0.0, [bad])
    task._fallback_tasks = {"sampling": StubTask(None, [good])}
    task._aligner = None
    out = task.run(None, mel=torch.zeros(80, 100))
    assert calls == [0.0, 0.4]
    assert out.avg_logprobs == [-0.2]


# -- the frozen end-to-end goldens ---------------------------------------------


def test_port_reproduces_golden_e2e(en_stack):
    """tests/test_golden_e2e.py's runs through the port: the greedy seek
    loop over 35 s (two windows, the second prompted with the first's
    tokens), and beam 3 on the first 30 s, unprompted and prompted."""
    _, model, audio = en_stack
    want = json.loads((GOLDENS / "e2e.json").read_text())
    tok = Tokenizer()
    task = TranscribeTask(model, tok, TranscribeOptions(
        decode=DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN)))
    res = task.run(audio)
    w = want["transcribe_greedy"]
    assert res.tokens.tolist() == w["tokens"]
    for g_seg, w_seg in zip(res.segments, w["segments"], strict=True):
        assert g_seg.seek == w_seg[0] and g_seg.text == w_seg[3]
        assert abs(g_seg.start_time - w_seg[1]) < 1e-3 and abs(g_seg.end_time - w_seg[2]) < 1e-3
    np.testing.assert_allclose(res.avg_logprobs, w["avg_logprobs"], atol=1e-3)

    beam = DecodeTask(model, tok, DecodeOptions(mode=BeamSearchMode(beam_size=3),
                                                sample_len=SAMPLE_LEN))
    mel = pad_or_trim(log_mel_file(audio[: 16000 * 30], device="cpu"), 3000)
    prompt = tok.encode(" previous window text")
    results = beam.run_batch(mel[None].repeat(2, 1, 1), [None, prompt])
    for r, key in zip(results, ("beam_unprompted", "beam_prompted"), strict=True):
        assert r.tokens.tolist() == want[key]["tokens"], key
        assert abs(r.avg_logprob - want[key]["avg_logprob"]) < 1e-3


def test_port_reproduces_golden_multilingual(multilingual_json):
    """tests/test_golden_multilingual.py's runs through the port: translate
    from German over the seek loop, and German transcription with beam 3."""
    _, model = _port_model(13, MULTI_FIELDS)
    audio = (np.random.default_rng(17).standard_normal(16000 * 35) * 0.1).astype(np.float32)
    want = json.loads((GOLDENS / "e2e_multilingual.json").read_text())

    tok_translate = Tokenizer(task=Task.TRANSLATE, tokenizer_json=multilingual_json,
                              language="de")
    assert tok_translate.is_multilingual
    assert tok_translate.sequence_sot() == want["sot_sequence_translate_de"]
    res = TranscribeTask(model, tok_translate, TranscribeOptions(
        decode=DecodeOptions(mode=GreedyMode(), sample_len=SAMPLE_LEN))).run(audio)
    w = want["transcribe_translate_de"]
    assert res.tokens.tolist() == w["tokens"]
    for g_seg, w_seg in zip(res.segments, w["segments"], strict=True):
        assert g_seg.seek == w_seg[0] and g_seg.text == w_seg[3]
        assert abs(g_seg.start_time - w_seg[1]) < 1e-3 and abs(g_seg.end_time - w_seg[2]) < 1e-3
    np.testing.assert_allclose(res.avg_logprobs, w["avg_logprobs"], atol=1e-3)

    tok_de = Tokenizer(task=Task.TRANSCRIBE, tokenizer_json=multilingual_json, language="de")
    assert tok_de.sequence_sot() == want["sot_sequence_transcribe_de"]
    beam = DecodeTask(model, tok_de, DecodeOptions(mode=BeamSearchMode(beam_size=3),
                                                   sample_len=SAMPLE_LEN))
    mel = pad_or_trim(log_mel_file(audio[: 16000 * 30], device="cpu"), 3000)
    r = beam.run_batch(mel[None], [None])[0]
    assert r.tokens.tolist() == want["beam_transcribe_de"]["tokens"]
    assert abs(r.avg_logprob - want["beam_transcribe_de"]["avg_logprob"]) < 1e-3
