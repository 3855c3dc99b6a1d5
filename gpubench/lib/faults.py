"""Faults planted in the port's token choice, for proving that the check
refuses them: the CPU tests (``tests/test_gb_faults.py``) run the tiny
cells under each, and ``tools/readings.py --fault <name>`` reads the
compared numbers under each on the card at a cell's own size.

Each is a context manager that patches the decode loop's module while it
is open (enter it before the program's window is captured, so that the
captured steps run the fault).  Both keep the decode's score consistent
with the tokens it chose, so only a number that looks at the choice itself
can see them:

  * ``greedy_second_best``: every greedy step takes the second-best token
    (the best where only one is allowed) and scores it from the step's own
    log-softmax, as the loop scores its argmax;
  * ``beam_keeps_the_next``: every beam update ranks the beam × (beam + 1)
    candidates with the best ``beam`` moved to the end, so the next-best
    unfinished candidates continue (and EOTs finish by that order), each
    with its true cumulative score.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def greedy_second_best():
    import whisper_rs_tpu_torch.decode.loop as loop

    saved = loop._greedy_update

    def update(logits, tokens, pos, sum_logprobs, finished, eot, temperature=None, keys=None,
               live=None):
        if temperature is not None:
            return saved(logits, tokens, pos, sum_logprobs, finished, eot, temperature, keys, live)
        top = logits.topk(2, dim=-1)
        next_tok = torch.where(torch.isfinite(top.values[:, 1]), top.indices[:, 1],
                               top.indices[:, 0])
        cur_lp = loop.log_softmax(logits).gather(1, next_tok[:, None])[:, 0]
        sum_logprobs = sum_logprobs + torch.where(finished, torch.zeros_like(cur_lp), cur_lp)
        next_tok = torch.where(finished, torch.full_like(next_tok, eot), next_tok)
        finished = finished | (next_tok == eot)
        loop._write_token(tokens, loop.step_pos(pos, tokens.device), next_tok, live)
        return sum_logprobs, finished

    loop._greedy_update = update
    try:
        yield
    finally:
        loop._greedy_update = saved


@contextlib.contextmanager
def beam_keeps_the_next():
    import whisper_rs_tpu_torch.decode.loop as loop

    saved_step, saved_sort = loop._beam_step, loop._sort_desc

    def step(logits, s, pos, beam, *args):
        sorts = [0]

        def sort(x):  # the second sort of a step ranks the candidates
            sorts[0] += 1
            values, order = saved_sort(x)
            if sorts[0] != 2:
                return values, order
            return values.roll(-beam, -1), order.roll(-beam, -1)

        loop._sort_desc = sort
        try:
            return saved_step(logits, s, pos, beam, *args)
        finally:
            loop._sort_desc = saved_sort

    loop._beam_step = step
    try:
        yield
    finally:
        loop._beam_step = saved_step


FAULTS = {"greedy-second-best": greedy_second_best, "beam-keeps-the-next": beam_keeps_the_next}
