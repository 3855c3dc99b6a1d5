"""``chip_smoke.beam_ranking``, on which the int8 K/V beam parity holds
every ranking of the kernel path to the plain step's: on the CPU, its
codes are the decisions ``decode_loop._beam_step`` takes (the continuing
beams' sources and tokens in order, the finished candidates in order), and
its gap is the smallest change of the scores that alters them."""

import importlib
import pathlib
import sys

import pytest
import torch

from whisper_rs_tpu_torch.decode import loop as decode_loop
from whisper_rs_tpu_torch.decode.filters import log_softmax

ROOT = pathlib.Path(__file__).resolve().parent.parent
BEAM, N_AUDIO, V, N_CTX, EOT, POS = 4, 3, 40, 6, 7, 3


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


def _state(seed: int, eot_boost: float):
    """Logits [N_AUDIO BEAM, V] and a beam state whose token rows hold
    their own row index at slot 0, so a step's gather shows its sources;
    ``eot_boost`` raises EOT so that finished candidates enter."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(N_AUDIO * BEAM, V, generator=gen) * 3
    logits[:, EOT] += eot_boost
    B = N_AUDIO * BEAM
    tokens = torch.zeros(B, N_CTX, dtype=torch.long)
    tokens[:, 0] = torch.arange(B)
    s = decode_loop._BeamState(
        tokens=tokens,
        sum_logprobs=torch.randn(B, generator=gen) * 2,
        fin_tokens=torch.zeros(N_AUDIO, BEAM + 1, N_CTX, dtype=torch.long),
        fin_scores=torch.full((N_AUDIO, BEAM + 1), decode_loop.BIG_NEG),
        fin_count=torch.zeros(N_AUDIO, dtype=torch.long),
        anc=torch.zeros(B, N_CTX, dtype=torch.int32),
    )
    return logits, s


@pytest.mark.parametrize("seed, eot_boost", [(0, 0.0), (1, 4.0), (2, 6.0)])
def test_beam_ranking_codes_are_the_beam_steps_decisions(chip_smoke, seed, eot_boost):
    logits, s = _state(seed, eot_boost)
    code, gap = chip_smoke.beam_ranking(logits, s, BEAM, EOT)
    new = decode_loop._beam_step(logits, s, POS, BEAM, BEAM, EOT)
    assert (gap > 0).all()
    for a in range(N_AUDIO):
        ranked = code[a][code[a] >= 0]
        src, tok = ranked // V, ranked % V
        rows = slice(a * BEAM, (a + 1) * BEAM)
        # the continuing beams: the unfinished candidates, in score order
        assert torch.equal(src[tok != EOT], new.tokens[rows, 0] - a * BEAM)
        assert torch.equal(tok[tok != EOT], new.tokens[rows, POS])
        # the finished ones, in score order, in the finished buffer
        n_fin = int(new.fin_count[a])
        assert n_fin == int((tok == EOT).sum())
        assert torch.equal(new.fin_tokens[a, :n_fin, 0] - a * BEAM, src[tok == EOT])
    if eot_boost:
        assert new.fin_count.sum() > 0


def test_beam_ranking_changes_only_past_its_gap(chip_smoke):
    """Raising the logit of the first candidate past the ranked ones moves
    every score by less than that rise, so a rise under the gap leaves the
    codes; a rise well past the boundary gap brings it into the ranking."""
    logits, s = _state(3, 0.0)
    code, gap = chip_smoke.beam_ranking(logits, s, BEAM, EOT)
    # audio 0's ranking: the first candidate after the ranked ones
    cum = (s.sum_logprobs[:, None] + log_softmax(logits)).view(N_AUDIO, BEAM, V)
    top, tok = (t[..., : BEAM + 1] for t in decode_loop._sort_desc(cum))
    score, order = decode_loop._sort_desc(top.reshape(N_AUDIO, -1))
    n_ranked = int((code[0] >= 0).sum())
    k = int(order[0, n_ranked])
    row, tid = k // (BEAM + 1), int(tok[0].reshape(-1)[k])
    boundary = float(score[0, n_ranked - 1] - score[0, n_ranked])
    # the smallest gap between consecutive ranked scores and the next one
    assert float(gap[0]) == float((score[0, :n_ranked] - score[0, 1 : n_ranked + 1]).min())
    assert boundary >= float(gap[0])
    for lift, changes in ((0.5 * float(gap[0]), False), (boundary + 1.0, True)):
        bumped = logits.clone()
        bumped[row, tid] += lift  # raises that candidate by about lift
        got, _ = chip_smoke.beam_ranking(bumped, s, BEAM, EOT)
        assert (not torch.equal(got[0], code[0])) == changes
