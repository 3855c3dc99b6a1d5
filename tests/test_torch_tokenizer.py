"""The port's pure-Python tokenizer against the JAX package's ``Tokenizer``
(Hugging Face ``tokenizers`` over the same vendored GPT-2 file), for 99 and
100 languages and for the synthetic multilingual vocabulary of
``tests/test_golden_multilingual.py``: ``encode``/``decode`` on text with
Unicode classes the GPT-2 pattern tells apart, special tokens inside the
text, random-id ``decode`` (cut-off UTF-8 replaced as Rust's
``from_utf8_lossy`` does), every special id, ``non_speech_tokens``,
``sequence_sot``, ``token_id_space`` and ``decode_with_timestamps``."""

import json
import pathlib

import numpy as np
import pytest

from whisper_rs_tpu.tokenize import Task as JaxTask
from whisper_rs_tpu.tokenize import Tokenizer as JaxTokenizer
from whisper_rs_tpu_torch.tokenize import Task, Tokenizer
from whisper_rs_tpu_torch.tokenize.tokenizer import _pre_tokenize

CORPUS = {
    "ascii": "Hello world, this is a test.",
    "contractions": "don't I'm we'll they've she'd it's 'twas '''ll ?'s 'S",
    "runs_of_spaces": "  two  spaces   three    four ",
    "newlines_tabs": "line one\nline two\n\n  indented\tand\ttabs\r\n",
    "only_spaces": "     ",
    "trailing_space": "ends with a space ",
    "superscript_and_fraction": "x² + ½ = ¾ of 10³",
    "arabic_indic_digits": "٣٤٥ and ۱۲۳ and 123",
    "combining_marks": "naïve café ńo áb ë",
    "cjk": "日本語のテキスト、中文字符，한국어",
    "emoji": "emoji 😀👍🏽 done 🇩🇪",
    "other_spaces": "nbsp em ideo　nel\u0085end",
    "control_separators": "\x1cfile\x1dgroup line para",
    "zero_width": "zero​width‍joiner",
    "symbols": "A--B---C ((x)) [[y]] {{z}} <<w>> ♪♪ ♫ ♩ 「x」『y』",
    "digits_letters": "mix3d numb3rs 3rd 1234567 Ⅻ ① ⑳",
    "titlecase_modifiers": "ǅ ʰ ˆ Ŧ",
    "specials_inside": "<|endoftext|>hi<|en|> <|notimestamps|>x<|startofprev|><|de|>",
    "partial_specials": "<|en| <|endoftext <|0.00|> |>",
    "empty": "",
}


@pytest.fixture(scope="module")
def multilingual_json(tmp_path_factory):
    """The real GPT-2 file with <|endoftext|> moved to 50257, as the
    multilingual golden test builds it."""
    src = pathlib.Path(__file__).parents[1] / "whisper_rs_tpu" / "assets" / "gpt2.json"
    tok = json.loads(src.read_text())
    vocab = tok["model"]["vocab"]
    vocab["<|endoftext|>"] = 50257
    vocab["<|filler50256|>"] = 50256
    path = tmp_path_factory.mktemp("mtok") / "gpt2_multi.json"
    path.write_text(json.dumps(tok))
    return str(path)


@pytest.fixture(scope="module", params=["99", "100", "multilingual"])
def pair(request, multilingual_json):
    if request.param == "multilingual":
        kw = dict(tokenizer_json=multilingual_json)
    else:
        kw = dict(num_languages=int(request.param))
    return JaxTokenizer(**kw), Tokenizer(**kw)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_encode_decode_match(pair, name):
    jax_tok, tok = pair
    text = CORPUS[name]
    ids = tok.encode(text)
    assert ids == jax_tok.encode(text)
    assert tok.decode(ids) == jax_tok.decode(ids)


def test_random_id_decode_matches(pair):
    """Random ids: cut-off UTF-8 sequences, special and timestamp ids."""
    jax_tok, tok = pair
    rng = np.random.default_rng(0)
    top = tok.token_id_ts_begin + 50
    for _ in range(3000):
        ids = rng.integers(0, top, size=int(rng.integers(1, 16))).tolist()
        assert tok.decode(ids) == jax_tok.decode(ids), ids
    # single byte tokens, every one of the 256 and a few sequences of them
    byte_ids = list(range(256))
    assert tok.decode(byte_ids) == jax_tok.decode(byte_ids)
    for _ in range(500):
        ids = rng.integers(0, 256, size=int(rng.integers(1, 6))).tolist()
        assert tok.decode(ids) == jax_tok.decode(ids), ids


def test_special_ids_match(pair):
    jax_tok, tok = pair
    for attr in ("token_id_sot", "token_id_eot", "token_id_translate", "token_id_transcribe",
                 "token_id_no_timestamps", "token_id_no_speech", "token_id_startofprev",
                 "token_id_startoflm", "token_id_ts_begin", "token_id_space"):
        assert getattr(tok, attr) == getattr(jax_tok, attr), attr
    assert tok.is_multilingual == jax_tok.is_multilingual
    assert tok.language_codes == jax_tok.language_codes
    for code in tok.language_codes:
        assert tok.token_to_id(f"<|{code}|>") == jax_tok._tk.token_to_id(f"<|{code}|>")
    for t in range(tok.token_id_eot, tok.token_id_ts_begin):  # every special id decodes to ""
        assert tok.decode([t]) == jax_tok.decode([t])


def test_non_speech_tokens_match(pair):
    jax_tok, tok = pair
    assert tok.non_speech_tokens() == jax_tok.non_speech_tokens()


@pytest.mark.parametrize("task,language", [("transcribe", "en"), ("transcribe", "de"),
                                           ("translate", "de"), ("translate", "en")])
def test_sequence_sot_matches(multilingual_json, task, language):
    for kw in (dict(), dict(num_languages=100), dict(tokenizer_json=multilingual_json)):
        jax_tok = JaxTokenizer(JaxTask(task), language=language, **kw)
        tok = Tokenizer(Task(task), language=language, **kw)
        assert tok.sequence_sot() == jax_tok.sequence_sot()


def test_decode_with_timestamps_matches(pair):
    jax_tok, tok = pair
    ts = tok.token_id_ts_begin
    seqs = [
        [ts, *tok.encode(" hello there"), ts + 57, ts + 57, *tok.encode(" again"), ts + 1500],
        [*tok.encode(" no timestamps at all")],
        [ts + 3, ts + 4, tok.token_id_eot],
        [],
    ]
    for ids in seqs:
        assert tok.decode_with_timestamps(ids) == jax_tok.decode_with_timestamps(ids)


def test_pre_tokenize_splits_as_the_gpt2_pattern():
    """The scanner's pieces, at the cases the pattern's alternatives and its
    look-ahead decide."""
    assert _pre_tokenize("a  b") == ["a", " ", " b"]
    assert _pre_tokenize("a \n b") == ["a", " \n", " b"]
    assert _pre_tokenize("x   ") == ["x", "   "]
    assert _pre_tokenize("\nx") == ["\n", "x"]
    assert _pre_tokenize("I'm don't ?'s") == ["I", "'m", " don", "'t", " ?'", "s"]
    assert _pre_tokenize(" 42x²") == [" 42", "x", "²"]
    assert _pre_tokenize("\x1cz") == ["\x1c", "z"]  # a separator Python's isspace takes


@pytest.mark.parametrize("model", ["base.en", "large-v3"])
def test_for_dims_picks_the_language_count(model):
    from whisper_rs_tpu.config import dims_for as jax_dims_for
    from whisper_rs_tpu_torch.config import dims_for

    tok, jax_tok = Tokenizer.for_dims(dims_for(model)), JaxTokenizer.for_dims(jax_dims_for(model))
    assert tok.num_languages == jax_tok.num_languages == (100 if model == "large-v3" else 99)
    assert tok.token_id_ts_begin == jax_tok.token_id_ts_begin
