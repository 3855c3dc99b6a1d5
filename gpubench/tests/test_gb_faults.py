"""Whole runs of the tiny cells on the CPU (the look for a chip skipped),
with the timed path broken underneath: the check must come out false for
each fault a decode can have.

  * a token altered where it is produced (the loop's token write, or the
    beam step's new tokens);
  * a step that returns its state unchanged: the step's K/V column never
    reaches the cache;
  * an answer altered after its window was decoded (serving);
  * a request that fails;
  * a wrong token choice scored as the decode scores its own
    (``lib/faults.py``): greedy's second-best token, a beam that keeps the
    next-best candidates;
  * a repeated call that returns other tokens than its pool batch's first.
"""

import time

import numpy as np
import pytest
import torch

from gb_helpers import SEED, run_tiny, tiny
from gpubench.lib import cell as cell_mod, faults

CELLS = ["tiny.tiny-greedy", "tiny.tiny-beam", "tiny.tiny-serve"]


def _seconds(name):
    return 2.0 if "serve" in name else 0.5


def _alter_tokens(monkeypatch):
    import whisper_rs_tpu_torch.decode.loop as loop

    write, beam_step = loop._write_token, loop._beam_step

    def write_token(tokens, pos, values, live=None):
        if tokens.dtype == torch.long and values.dtype == torch.long and tokens.shape[1] == 448:
            values = torch.where(torch.as_tensor(pos) % 5 == 3, (values + 7) % 50000, values)
        return write(tokens, pos, values, live)

    def beam(logits, s, pos, *args):
        new = beam_step(logits, s, pos, *args)
        slot = loop.step_pos(pos, logits.device).view(1)
        bump = torch.where(slot % 5 == 3, 7, 0)
        new.tokens.index_copy_(1, slot, (new.tokens.index_select(1, slot) + bump) % 50000)
        return new

    monkeypatch.setattr(loop, "_write_token", write_token)
    monkeypatch.setattr(loop, "_beam_step", beam)


def _state_unchanged(monkeypatch):
    import whisper_rs_tpu_torch.models.whisper as whisper

    def keep_cache(fn):
        def step(*args, **kwargs):
            k_all, v_all, layer = args[3], args[4], args[5]
            saved = k_all[layer].clone(), v_all[layer].clone()
            out = fn(*args, **kwargs)
            k_all[layer].copy_(saved[0])
            v_all[layer].copy_(saved[1])
            return out
        return step

    for name in ("self_attention_append_step", "self_attention_append_step_plain",
                 "beam_self_attention_step", "beam_self_attention_step_plain"):
        monkeypatch.setattr(whisper, name, keep_cache(getattr(whisper, name)))


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged], ids=["token", "state"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(name, seconds=_seconds(name))
    assert not r["correct"]
    assert r["failed"] == 0  # refused by a compared number over its limit
    assert any(v["value"] > v["limit"] for n, v in r["checked"].items() if n in cell_mod.COMPARED)


def test_a_failed_request_is_not_correct(monkeypatch):
    from whisper_rs_tpu_torch import serve

    calls = [0]
    submit = serve.ServingEngine.submit

    def flaky(self, audio):
        calls[0] += 1
        if calls[0] == 7:  # one request of the window refused
            raise RuntimeError("queue full (test)")
        return submit(self, audio)

    monkeypatch.setattr(serve.ServingEngine, "submit", flaky)
    r = run_tiny("tiny.tiny-serve", seconds=2.0)
    assert r["failed"] == 1 and not r["correct"]
    assert r["metrics"]["request_p95_s"]["value"] >= 0


def test_an_answer_altered_after_its_window_is_not_correct(monkeypatch):
    from whisper_rs_tpu_torch import transcribe

    output = transcribe.Utterance.output

    def altered(self, tokenizer):
        out = output(self, tokenizer)
        if len(out.tokens):
            out.tokens = out.tokens.copy()
            out.tokens[-1] = (out.tokens[-1] + 7) % 50000
        return out

    monkeypatch.setattr(transcribe.Utterance, "output", altered)
    r = run_tiny("tiny.tiny-serve", seconds=2.0)
    assert r["failed"] == 0 and not r["correct"]
    assert r["checked"]["unlike_their_window"]["value"] > 0


def test_a_request_is_held_to_what_its_window_keeps():
    ts = 50364
    whole = np.array([50364, 11, 12, 50390])  # one lone pair of timestamps apart: kept whole
    cut = np.array([50364, 11, 50380, 50380, 13, 14])  # a pair: kept up to it
    assert cell_mod._returns_its_window(whole, whole, ts)
    assert cell_mod._returns_its_window(np.array([50364, 11, 50380, 50380, 9, 9]), cut, ts)
    assert cell_mod._returns_its_window(cut[:4], cut, ts)
    assert not cell_mod._returns_its_window(cut[:3], cut, ts)
    assert not cell_mod._returns_its_window(np.array([50364, 12, 50380, 50380]), cut, ts)


@pytest.mark.parametrize("name,fault", [("tiny.tiny-greedy", "greedy-second-best"),
                                        ("tiny.tiny-serve", "greedy-second-best"),
                                        ("tiny.tiny-beam", "beam-keeps-the-next")])
def test_a_wrong_choice_scored_alike_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        r = run_tiny(name, seconds=_seconds(name))
    assert not r["correct"] and r["failed"] == 0
    numbers = r["checked"]
    # the score agrees with the tokens chosen: only the choice numbers see it
    assert numbers["rms_avg_logprob_gap"]["value"] <= numbers["rms_avg_logprob_gap"]["limit"]
    assert numbers["mean_gap_logit"]["value"] > numbers["mean_gap_logit"]["limit"]


def test_a_repeated_call_unlike_its_first_is_not_correct(monkeypatch):
    from whisper_rs_tpu_torch.decode import task as task_mod

    run_batch, calls = task_mod.DecodeTask.run_batch, [0]

    def drifting(self, *args, **kwargs):  # every call after the window's first drifts
        outs = run_batch(self, *args, **kwargs)
        calls[0] += 1
        if calls[0] > 2:  # the warm-up call and the window's first
            outs[0].tokens = (np.asarray(outs[0].tokens) + 1) % 50000
        return outs

    monkeypatch.setattr(task_mod.DecodeTask, "run_batch", drifting)
    c = tiny("tiny.tiny-greedy")
    c.traffic = {**c.traffic, "pool": 1}  # every call of the window repeats the first
    r = cell_mod.run_cell(c, SEED, 8.0, False, "cpu", time.perf_counter())
    assert r["attempted"] >= 2 * 2, "the window ran one call"
    assert not r["correct"] and r["checked"]["unlike_first_call"]["value"] > 0
