"""The port's command line (whisper_rs_tpu_torch.cli) against the JAX CLI on
the CPU, on a tiny OpenAI-format checkpoint written here (the real GPT-2
vocab size, 2 + 2 layers of width 64) and seeded WAV files, f32: OpenAI's
recipe (the six-rung ladder, the no-speech threshold, word timestamps) as
JSON equal to the JAX CLI's; ``--format srt|vtt|txt`` equal; ``--batch 2``
equal to the JAX ``--batch 2`` and to the port's own sequential run; a
missing file (exit 1, the other files still transcribed); ``--tp 2`` and
``--pp 2`` refused in one process (exit 2, naming torchrun); ``--tp 2`` on
two gloo processes under torchrun equal to one process;
``python -m whisper_rs_tpu_torch.cli``."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_rs_tpu.cli import main as jax_main
from whisper_rs_tpu_torch.audio.io import write_wav
from whisper_rs_tpu_torch.cli import main

RECIPE = ["--temperatures", "0,0.2,0.4,0.6,0.8,1.0", "--no-speech-threshold", "0.6",
          "--word-timestamps"]


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
def files(tmp_path_factory):
    from torch_oracle import make_random_state_dict

    from whisper_rs_tpu.config import ModelDims

    root = tmp_path_factory.mktemp("cli")
    fields = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
                  n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                  n_text_head=4, n_text_layer=2)
    ckpt = root / "tiny_test.pt"
    torch.save({"dims": fields,
                "model_state_dict": make_random_state_dict(ModelDims(**fields), seed=0)}, ckpt)
    rng = np.random.default_rng(0)
    wavs = []
    for i, secs in enumerate((34, 3)):
        wavs.append(root / f"a{i}.wav")
        write_wav(wavs[-1], (rng.standard_normal(16000 * secs) * 0.1).astype(np.float32))
    return str(ckpt), [str(w) for w in wavs]


def _run(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr()


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _assert_payloads_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert (g["file"], g["language"], g["text"]) == (w["file"], w["language"], w["text"])
        assert len(g["segments"]) == len(w["segments"])
        for gs, ws in zip(g["segments"], w["segments"], strict=True):
            assert gs.keys() == ws.keys() and gs["text"] == ws["text"]
            assert gs["start"] == pytest.approx(ws["start"]) and gs["end"] == pytest.approx(
                ws["end"])
            for gw, ww in zip(gs.get("words", []), ws.get("words", []), strict=True):
                assert gw["word"] == ww["word"]
                # one 0.02 s frame: DTW may break a near-tie the other way
                assert abs(gw["start"] - ww["start"]) <= 0.02 + 1e-9
                assert abs(gw["end"] - ww["end"]) <= 0.02 + 1e-9


def test_recipe_json_matches_jax(files, capsys):
    ckpt, wavs = files
    argv = [wavs[0], "--checkpoint", ckpt, "--beam", "2", "--sample-len", "8", "--dtype",
            "float32", "--json", *RECIPE]
    rc_j, want = _run(jax_main, argv, capsys)
    rc, got = _run(main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_j == 0
    payloads = _json_lines(got.out)
    _assert_payloads_equal(payloads, _json_lines(want.out))
    segs = payloads[0]["segments"]
    assert len({s["start"] // 30 for s in segs}) >= 2  # two windows at least
    assert all("words" in s for s in segs) and any(s["words"] for s in segs)
    for s in segs:  # a segment's words in time order, each of positive or zero length
        assert all(w["start"] <= w["end"] for w in s["words"])
        assert all(a["end"] <= b["start"] + 1e-9 for a, b in zip(s["words"], s["words"][1:]))


@pytest.mark.parametrize("fmt", ["srt", "vtt", "txt"])
def test_formats_match_jax(files, capsys, fmt):
    ckpt, wavs = files
    argv = [wavs[1], "--checkpoint", ckpt, "--greedy", "--sample-len", "6", "--dtype",
            "float32", "--format", fmt]
    rc_j, want = _run(jax_main, argv, capsys)
    rc, got = _run(main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_j == 0 and got.out == want.out and got.out.strip()
    if fmt == "srt":
        assert got.out.startswith("1\n00:00:")
    elif fmt == "vtt":
        assert got.out.startswith("WEBVTT\n\n00:00:")


def test_batch_matches_jax_and_the_sequential_run(files, capsys):
    ckpt, wavs = files
    argv = [*wavs, "--checkpoint", ckpt, "--greedy", "--sample-len", "6", "--dtype", "float32",
            "--json", "--language", "en", "--temperatures", "0,0.5"]
    rc_j, want = _run(jax_main, argv + ["--batch", "2"], capsys)
    rc, got = _run(main, argv + ["--batch", "2", "--device", "cpu"], capsys)
    rc_s, seq = _run(main, argv + ["--device", "cpu"], capsys)
    assert rc == rc_j == rc_s == 0
    _assert_payloads_equal(_json_lines(got.out), _json_lines(want.out))
    _assert_payloads_equal(_json_lines(got.out), _json_lines(seq.out))


def test_missing_file_fails_alone(files, capsys):
    ckpt, wavs = files
    for extra in ([], ["--batch", "2"]):
        rc, out = _run(main, ["/nonexistent.wav", wavs[1], "--checkpoint", ckpt, "--greedy",
                              "--sample-len", "4", "--dtype", "float32", "--json",
                              "--device", "cpu", *extra], capsys)
        assert rc == 1
        assert "/nonexistent.wav: failed to load" in out.err
        assert [p["file"] for p in _json_lines(out.out)] == [wavs[1]]


@pytest.mark.parametrize("flag", ["--tp", "--pp"])
def test_parallel_flags_are_refused(files, capsys, monkeypatch, flag):
    """--tp 2 or --pp 2 in one process, with no process group: exit 2 and a
    message that names torchrun, which starts a process a rank."""
    ckpt, wavs = files
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rc, out = _run(main, [wavs[1], "--checkpoint", ckpt, flag, "2", "--device", "cpu"], capsys)
    assert rc == 2 and "torchrun --nproc-per-node 2" in out.err and out.out == ""


def test_tp_under_torchrun_matches_one_process(files, capsys):
    """``torchrun --nproc-per-node 2 -m whisper_rs_tpu_torch.cli ... --tp 2
    --dist-backend gloo``: exit 0, and rank 0 alone prints the JSON of the
    one-process CLI."""
    import os
    import pathlib

    ckpt, wavs = files
    argv = [*wavs, "--checkpoint", ckpt, "--greedy", "--sample-len", "6", "--dtype", "float32",
            "--json", "--language", "en", "--device", "cpu"]
    rc, want = _run(main, argv, capsys)
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "whisper_rs_tpu_torch.cli", *argv, "--tp", "2", "--dist-backend", "gloo"],
        capture_output=True, text=True, timeout=240, cwd=root, env=env)
    assert rc == 0 and proc.returncode == 0, proc.stderr[-2000:]
    assert len(_json_lines(proc.stdout)) == len(wavs)
    _assert_payloads_equal(_json_lines(proc.stdout), _json_lines(want.out))


def test_runs_as_a_module(files):
    proc = subprocess.run([sys.executable, "-m", "whisper_rs_tpu_torch.cli", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout and "--temperatures" in proc.stdout
