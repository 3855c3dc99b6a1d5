"""The port's evaluation pieces on the CPU: ``utils.wer`` (``wer``,
``edit_distance``, ``iter_librispeech``) and ``utils.csvio`` equal to the JAX
package's on the same inputs, and the two tools' ``main`` with ``--device
cpu`` on a synthetic LibriSpeech split and a seeded tiny checkpoint, as
tests/test_eval_wer_smoke.py and tests/test_validate_checkpoint.py run the
JAX tools: ``eval_wer`` prints a WER and exits 0; ``validate_checkpoint``
prints a verdict with the JAX tool's keys and exits 3 (random weights fail
the quality gates)."""

import importlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from whisper_rs_tpu.utils import csvio as jax_csvio
from whisper_rs_tpu_torch.audio.flac import encode_flac
from whisper_rs_tpu_torch.tools import eval_wer, validate_checkpoint
from whisper_rs_tpu_torch.utils import (
    edit_distance,
    iter_librispeech,
    read_csv_2d,
    wer,
    write_csv_2d,
)

# the modules, which the packages' ``wer`` functions shadow as attributes
jax_wer = importlib.import_module("whisper_rs_tpu.utils.wer")
port_wer = importlib.import_module("whisper_rs_tpu_torch.utils.wer")

# the JAX tool's verdict (tools/validate_checkpoint.py:217-294), every key
VERDICT_KEYS = {
    "checkpoint", "model_dims", "n_utterances", "decode", "dtype", "recipe", "wer",
    "audio_s_per_s", "wer_ok", "wer_int8", "delta_wer_int8", "int8_ok", "wer_int8_kv",
    "delta_wer_int8_kv", "int8_kv_ok", "wer_int8_matmul", "delta_wer_int8_matmul",
    "int8_matmul_ok", "word_timing", "language_id", "ok",
}
WORD_TIMING_KEYS = {"n_segments", "n_words", "has_words", "words_nonempty", "monotone",
                    "spans_valid", "inside_audio", "ok"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def librispeech_dir(tmp_path_factory):
    """Two seeded 2 s FLACs and their transcript, in LibriSpeech's layout."""
    root = tmp_path_factory.mktemp("librispeech")
    d = root / "test-clean" / "19" / "198"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        utt = f"19-198-{i:04d}"
        audio = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
        (d / f"{utt}.flac").write_bytes(encode_flac(audio, 16000))
        lines.append(f"{utt} HELLO WORLD NUMBER {i}")
    (d / "19-198.trans.txt").write_text("\n".join(lines))
    return root / "test-clean"


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A seeded OpenAI-format checkpoint at the golden test's dims (D 64,
    2 + 2 layers, the English vocab)."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from torch_oracle import make_random_state_dict

    from whisper_rs_tpu.config import ModelDims

    fields = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
                  n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                  n_text_head=4, n_text_layer=2)
    p = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save({"dims": fields,
                "model_state_dict": make_random_state_dict(ModelDims(**fields), seed=0)}, str(p))
    return p


TEXTS = [
    ("HELLO WORLD", "hello world"),
    ("THE CAT SAT ON THE MAT", "the cat sat on mat"),
    ("A B C", "a x c d"),
    ("IT'S A TEST", "its a test!"),
    ("", "extra words"),
    ("ONE TWO", ""),
    ("Punctuation, is; STRIPPED.", "punctuation is stripped"),
]


def test_wer_and_edit_distance_equal_jax():
    for ref, hyp in TEXTS:
        assert port_wer._normalize(hyp) == jax_wer._normalize(hyp)
        r, h = port_wer._normalize(ref), port_wer._normalize(hyp)
        assert edit_distance(r, h) == jax_wer.edit_distance(r, h)
        assert wer([ref], [hyp]) == jax_wer.wer([ref], [hyp])
    refs, hyps = zip(*TEXTS)
    assert wer(refs, hyps) == jax_wer.wer(refs, hyps)
    rng = np.random.default_rng(1)
    for _ in range(20):
        r = [str(w) for w in rng.integers(0, 5, rng.integers(0, 9))]
        h = [str(w) for w in rng.integers(0, 5, rng.integers(0, 9))]
        assert edit_distance(r, h) == jax_wer.edit_distance(r, h)


def test_iter_librispeech_equals_jax(librispeech_dir, tmp_path):
    # a second speaker with a WAV, an utterance without audio, a stray file
    d = tmp_path / "split" / "7" / "8"
    d.mkdir(parents=True)
    (d / "7-8-0000.wav").write_bytes(b"RIFF")
    (d / "7-8.trans.txt").write_text("7-8-0000 FIRST ONE\n7-8-0001 NO AUDIO HERE")
    (d / "notes.txt").write_text("not a transcript")
    for root in (librispeech_dir, tmp_path / "split"):
        got = list(iter_librispeech(str(root)))
        assert got == list(jax_wer.iter_librispeech(str(root))) and got
    assert [t for _, t in iter_librispeech(str(tmp_path / "split"))] == ["FIRST ONE"]


def test_csv_helpers_equal_jax(tmp_path):
    a = np.random.default_rng(2).standard_normal((5, 3))
    write_csv_2d(tmp_path / "port.csv", a)
    jax_csvio.write_csv_2d(tmp_path / "jax.csv", a)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    for name in ("port.csv", "jax.csv"):
        np.testing.assert_array_equal(read_csv_2d(tmp_path / name),
                                      jax_csvio.read_csv_2d(tmp_path / name))
    (tmp_path / "row.csv").write_text("1,2,3\n")  # one row stays 2-d
    assert read_csv_2d(tmp_path / "row.csv").shape == (1, 3)


def test_eval_wer_one_liner(librispeech_dir, tiny_checkpoint, capsys):
    """Without the recipe (one pass a window) and with int8 weights and K/V,
    greedy, batch 2: the WER line and exit 0."""
    rc = eval_wer.main([
        "--checkpoint", str(tiny_checkpoint), "--librispeech", str(librispeech_dir),
        "--greedy", "--batch", "2", "--dtype", "float32", "--no-recipe", "--quant", "int8kv",
        "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "WER:" in out and "over 2 utterances" in out and "audio-s/s" in out


def test_eval_wer_empty_split(tmp_path, tiny_checkpoint, capsys):
    rc = eval_wer.main(["--checkpoint", str(tiny_checkpoint), "--librispeech", str(tmp_path),
                        "--device", "cpu", "--dtype", "float32"])
    assert rc == 1 and "no utterances found" in capsys.readouterr().err


def test_validate_checkpoint_one_liner(librispeech_dir, tiny_checkpoint, capsys, monkeypatch):
    """The recipe (the default), greedy, batch 2, sample_len 8: every key of
    the JAX tool's verdict, rc 3; the int8×int8 run sets the switch and
    restores it."""
    monkeypatch.delenv("WHISPER_INT8_MATMUL", raising=False)
    rc = validate_checkpoint.main([
        "--checkpoint", str(tiny_checkpoint), "--librispeech", str(librispeech_dir),
        "--greedy", "--batch", "2", "--dtype", "float32", "--sample-len", "8", "--device", "cpu",
    ])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(verdict) == VERDICT_KEYS
    assert set(verdict["word_timing"]) == WORD_TIMING_KEYS
    assert verdict["n_utterances"] == 2 and verdict["recipe"] == "openai"
    assert verdict["decode"] == "greedy" and verdict["dtype"] == "float32"
    assert 0.0 <= verdict["wer"] and verdict["word_timing"]["n_segments"] >= 1
    for key in ("int8", "int8_kv", "int8_matmul"):
        assert verdict[f"delta_wer_{key}"] == pytest.approx(verdict[f"wer_{key}"] - verdict["wer"],
                                                            abs=1e-4)
    assert verdict["language_id"] == {"skipped": "english-only checkpoint"}
    assert not verdict["ok"] and rc == 3
    assert "WHISPER_INT8_MATMUL" not in os.environ


def test_validate_checkpoint_skip_quant(librispeech_dir, tiny_checkpoint, capsys):
    rc = validate_checkpoint.main([
        "--checkpoint", str(tiny_checkpoint), "--librispeech", str(librispeech_dir),
        "--greedy", "--batch", "2", "--dtype", "float32", "--sample-len", "6", "--skip-quant",
        "--device", "cpu",
    ])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["int8_ok"] is None and verdict["int8_kv_ok"] is None
    assert verdict["int8_matmul_ok"] is None and "wer_int8" not in verdict
    assert "wer" in verdict and "word_timing" in verdict and rc == 3


def test_int8_matmul_switch_is_restored(monkeypatch):
    monkeypatch.setenv("WHISPER_INT8_MATMUL", "0")
    with validate_checkpoint.int8_matmul(True):
        assert os.environ["WHISPER_INT8_MATMUL"] == "1"
    assert os.environ["WHISPER_INT8_MATMUL"] == "0"
    monkeypatch.delenv("WHISPER_INT8_MATMUL")
    with pytest.raises(KeyError), validate_checkpoint.int8_matmul(True):
        raise KeyError
    assert "WHISPER_INT8_MATMUL" not in os.environ
