"""Word timestamps of the port (whisper_rs_tpu_torch.decode.align) against
the JAX package on the CPU: ``dtw`` and ``_dtw_fast`` (paths equal at
several shapes), ``median_filter``, ``split_words`` on the real tokenizer
(English, CJK fragments, emoji) equal; ``_alignment_qk`` within 1e-4 in
f32; ``WordAligner.align_window`` gives the same words (text equal, times
within one 0.02 s frame); ``TranscribeTask(word_timestamps=True)`` matches
the JAX one, and words are off by default (mirrors tests/test_align.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import DecodeOptions as JaxDecodeOptions
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.config import TranscribeOptions as JaxTranscribeOptions
from whisper_rs_tpu.decode import align as jax_align
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.tokenize import Tokenizer as JaxTokenizer
from whisper_rs_tpu.transcribe import TranscribeTask as JaxTranscribeTask
from whisper_rs_tpu_torch import Tokenizer, TranscribeTask
from whisper_rs_tpu_torch.config import DecodeOptions, GreedyMode, ModelDims, TranscribeOptions
from whisper_rs_tpu_torch.decode import align
from whisper_rs_tpu_torch.models import params_from_jax
from whisper_rs_tpu_torch.transcribe import TranscribeSegment

FIELDS = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
FRAME = align.TIME_PER_FRAME  # word times may move by one frame where DTW meets a near-tie


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops here run thousands of small torch ops; on torch's
    default pool, under the suite's parallel workers, its threads contend
    with the other workers' (one test took 650 s against 30 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stack():
    params = init_params(jax.random.PRNGKey(7), JaxDims(**FIELDS))
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS), device="cpu")
    audio = (np.random.default_rng(11).standard_normal(16000 * 35) * 0.1).astype(np.float32)
    return params, model, audio


@pytest.mark.parametrize("shape", [(5, 7), (12, 12), (30, 90), (3, 40), (1, 9), (9, 1)])
def test_dtw_matches_jax(shape):
    cost = np.random.default_rng(sum(shape)).standard_normal(shape)
    for port_fn, jax_fn in ((align.dtw, jax_align.dtw), (align._dtw_fast, jax_align._dtw_fast)):
        for g, w in zip(port_fn(cost), jax_fn(cost), strict=True):
            np.testing.assert_array_equal(g, w)


def test_median_filter_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 6, 33))
    for width in (1, 3, 7):
        np.testing.assert_array_equal(align.median_filter(x, width),
                                      jax_align.median_filter(x, width))
    short = x[..., :3]  # no longer than the pad: returned as it is
    np.testing.assert_array_equal(align.median_filter(short, 7), short)


@pytest.mark.parametrize("text,lang", [
    (" hello there, wonderful world.", "en"),
    (" 日本語のテスト", "ja"),
    (" 日本語のテスト", "en"),
    (" nice 👍 ok", "en"),
    (" Él dijo: ¡hola! 'sí'", "es"),
])
def test_split_words_matches_jax(text, lang):
    tok, jax_tok = Tokenizer(), JaxTokenizer()
    ids = list(tok.encode(text))
    assert ids == list(jax_tok.encode(text))
    got = align.split_words(ids, tok.decode, lang)
    want = jax_align.split_words(ids, jax_tok.decode, lang)
    assert got == [(w, list(t)) for w, t in want]
    assert [t for _, tl in got for t in tl] == ids and "".join(w for w, _ in got) == text


def test_alignment_heads_default_to_the_upper_half():
    dims = ModelDims(**dict(FIELDS, n_text_layer=4, n_text_head=3))
    assert align.default_alignment_heads(dims) == jax_align.default_alignment_heads(
        JaxDims(**dict(FIELDS, n_text_layer=4, n_text_head=3)))


def _window(params, model, audio, tokenizer):
    from whisper_rs_tpu.audio import log_mel_file as jax_log_mel_file
    from whisper_rs_tpu.audio import pad_or_trim as jax_pad_or_trim
    from whisper_rs_tpu.models.whisper import encoder_forward

    mel = np.asarray(jax_pad_or_trim(jax_log_mel_file(audio[: 16000 * 30]), 3000))
    xa = np.asarray(encoder_forward(params, jnp.asarray(mel)[None], JaxDims(**FIELDS)))[0]
    words = tokenizer.encode(" the quick brown fox jumps over the lazy dog, again.")
    ts = tokenizer.token_id_ts_begin
    return xa, [ts, *words[:6], ts + 150, ts + 150, *words[6:], ts + 700]


@pytest.mark.parametrize("heads", [None, ((0, 1), (1, 3))])
def test_alignment_qk_matches_jax(stack, heads):
    params, model, audio = stack
    tok = Tokenizer()
    xa, _ = _window(params, model, audio, tok)
    heads = heads or align.default_alignment_heads(model.dims)
    tokens = np.full(64, tok.token_id_eot, np.int64)
    tokens[:20] = np.random.default_rng(1).integers(0, 50_000, 20)
    want = np.asarray(jax_align._alignment_qk(params, jnp.asarray(tokens, jnp.int32),
                                              jnp.asarray(xa), JaxDims(**FIELDS), heads))
    got = align._alignment_qk(model, torch.from_numpy(tokens), torch.from_numpy(xa), heads)
    assert got.dtype == torch.float32 and got.shape == want.shape == (len(heads), 64, 1500)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _assert_words_match(got, want):
    assert [w.word for w in got] == [w.word for w in want]
    for g, w in zip(got, want, strict=True):
        assert abs(g.start - w.start) <= FRAME + 1e-9 and abs(g.end - w.end) <= FRAME + 1e-9


@pytest.mark.parametrize("content", [1500, 700])
def test_align_window_matches_jax(stack, content):
    params, model, audio = stack
    tok, jax_tok = Tokenizer(), JaxTokenizer()
    xa, tokens = _window(params, model, audio, tok)
    want = jax_align.WordAligner(params, JaxDims(**FIELDS), jax_tok).align_window(
        tokens, xa, 12.5, content)
    got = align.WordAligner(model, tok).align_window(tokens, torch.from_numpy(xa), 12.5, content)
    assert len(got) >= 8
    _assert_words_match(got, want)
    assert all(12.5 <= w.start <= w.end <= 12.5 + content * FRAME for w in got)
    assert align.WordAligner(model, tok).align_window(
        [tok.token_id_ts_begin, tok.token_id_eot], torch.from_numpy(xa), 0.0, content) == []


def test_alignment_pass_runs_in_bf16(stack):
    """bf16 weights: q and k are upcast before the product, the logits f32
    and finite, close to the f32 pass."""
    params, model, audio = stack
    xa, _ = _window(params, model, audio, Tokenizer())
    m16 = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS),
                          dtype=torch.bfloat16, device="cpu")
    tokens = torch.arange(64) + 300
    heads = align.default_alignment_heads(m16.dims)
    got = align._alignment_qk(m16, tokens, torch.from_numpy(xa), heads)
    want = align._alignment_qk(model, tokens, torch.from_numpy(xa), heads)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max() < 0.1 * want.abs().max()


def test_transcribe_word_timestamps_match_jax(stack):
    """tests/test_align.py's run through both packages: greedy, 12 tokens a
    window, over the 35 s file (each window prompted by the ones before)."""
    params, model, audio = stack
    jax_opts = JaxTranscribeOptions(decode=JaxDecodeOptions(mode=JaxGreedy(), sample_len=12),
                                    word_timestamps=True)
    opts = TranscribeOptions(decode=DecodeOptions(mode=GreedyMode(), sample_len=12),
                             word_timestamps=True)
    want = JaxTranscribeTask(params, JaxDims(**FIELDS), JaxTokenizer(), jax_opts).run(audio)
    got = TranscribeTask(model, Tokenizer(), opts).run(audio)
    assert got.tokens.tolist() == want.tokens.tolist()
    assert len(got.segments) == len(want.segments) > 0
    by_window: dict = {}
    for g, w in zip(got.segments, want.segments, strict=True):
        assert (g.words is None) == (w.words is None)
        _assert_words_match(g.words or [], w.words or [])
        by_window.setdefault(g.seek, []).extend(g.words or [])
    words = [w for ws in by_window.values() for w in ws]
    assert words and all(w.word.strip() and 0.0 <= w.start <= w.end <= 35.0 for w in words)
    # monotone within a window (the next window starts at the last
    # timestamp pair, before the end of this window's words)
    for ws in by_window.values():
        assert all(a.start <= b.start + 1e-9 for a, b in zip(ws, ws[1:]))


def test_word_timestamps_off_by_default(stack):
    _, model, audio = stack
    assert TranscribeSegment(0, 0.0, 1.0, 0, 1, "x").words is None
    out = TranscribeTask(model, Tokenizer(), TranscribeOptions(
        decode=DecodeOptions(mode=GreedyMode(), sample_len=4))).run(audio[: 16000 * 3])
    assert out.segments and all(s.words is None for s in out.segments)
