"""Row 5's launch plan (``ops/decode_attention.py::cross_launch_plan``) and
the split-key computation the cross kernel runs (``csrc/cross_attention.cu``),
on the CPU: the plan covers the keys exactly once in splits that start on
multiples of 4, within the cluster and shared-memory limits, at every path
shape; an emulation of the kernel's split softmax (global max and sum
agreed over the cluster, partial P V summed in rank order) agrees with the
plain version, and ``chip_smoke``'s bf16 tolerance fails the same
emulation with one split's keys dropped, or with each split normalised by
its own max."""

import importlib
import pathlib
import sys

import pytest
import torch

from whisper_rs_tpu_torch.ops.decode_attention import (
    CROSS_MAX_SPLITS,
    CROSS_MAX_STAGES,
    SMEM_LIMIT,
    cross_attention_step_plain,
    cross_launch_plan,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (A, G, H) of every path shape the cross kernel runs or is checked at:
# the transcription (base.en, A 1, beam 5), medium.en b8 beam 5 (bf16 and
# int8 K/V), base.en b128, large-v3 b12, the golden dims greedy and beam 3,
# and medium.en beam 10 (G > 8, two chunks of rows)
SHAPES = {
    "transcription": (1, 5, 8),
    "medium.en beam": (8, 5, 16),
    "base.en b128": (128, 1, 8),
    "large-v3 b12": (12, 1, 20),
    "golden dims": (1, 1, 4),
    "golden dims beam 3": (2, 3, 4),
    "medium.en beam 10": (4, 10, 16),
}


@pytest.mark.parametrize("Tk", [1500, 1504])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cross_plan_covers_the_keys_once(shape, Tk):
    A, G, H = SHAPES[shape]
    for dh in (16, 64):
        for itemsize in (1, 2, 4):
            plan = cross_launch_plan(A, G, H, Tk, dh, itemsize)
            assert 1 <= plan.splits <= CROSS_MAX_SPLITS
            assert plan.chunk % 4 == 0
            covered = torch.zeros(Tk, dtype=torch.int64)
            for lo, hi in plan.bounds():
                assert lo % 4 == 0 and hi > lo
                covered[lo:hi] += 1
            assert (covered == 1).all()
            assert 2 <= plan.stages <= CROSS_MAX_STAGES and plan.smem <= SMEM_LIMIT
            assert plan.rows % 8 == 0 and dh % plan.rows == 0


def test_cross_plan_splits_only_where_the_heads_do_not_fill_the_card():
    """base.en b128 (1024 blocks) and large-v3 b12 (240) fill the card
    without a split; batch 1 takes the largest cluster; medium.en b8 beam 5
    (128 blocks) a few splits; a head of the golden dims (head dim 16, 96
    KB of bf16 K/V) is not split, in bf16 or int8."""
    assert cross_launch_plan(128, 1, 8, 1500).splits == 1
    assert cross_launch_plan(12, 1, 20, 1500).splits == 1
    assert cross_launch_plan(1, 5, 8, 1500).splits == CROSS_MAX_SPLITS
    assert 1 < cross_launch_plan(8, 5, 16, 1500).splits < CROSS_MAX_SPLITS
    for A, G in ((1, 1), (2, 3)):
        for itemsize in (1, 2):
            assert cross_launch_plan(A, G, 4, 1500, 16, itemsize).splits == 1


def split_emulation(q, kv, layer: int, fault: str = ""):
    """The kernel's split computation in torch: scores per split, the max and
    the sum agreed over the splits in rank order, weights rounded to the
    K/V dtype, partial P V per split summed in rank order.  ``fault``:
    "drop" leaves out one split's keys; "local max" normalises each split
    by its own max instead of the cluster's."""
    A, G, H, dh = q.shape
    Tk = kv.shape[-1]
    plan = cross_launch_plan(A, G, H, Tk)
    k_t, v_t = kv[layer, :, :, 0].float(), kv[layer, :, :, 1].float()
    s = torch.einsum("aghd,ahdk->aghk", q.float(), k_t)
    bounds = plan.bounds()
    if fault == "drop":
        bounds = bounds[:2] + bounds[3:]
    maxes = [s[..., lo:hi].amax(-1, keepdim=True) for lo, hi in bounds]
    gmax = torch.stack(maxes).amax(0)
    es = [torch.exp(s[..., lo:hi] - (m if fault == "local max" else gmax))
          for (lo, hi), m in zip(bounds, maxes)]
    total = sum(e.sum(-1, keepdim=True) for e in es)
    out = 0
    for (lo, hi), e in zip(bounds, es):
        w = (e / total).to(kv.dtype).float()
        out = out + torch.einsum("aghk,ahdk->aghd", w, v_t[..., lo:hi])
    return out.to(q.dtype)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


def _inputs(A: int, G: int, H: int, seed: int):
    """chip_smoke's unit-scale bf16 inputs of check_cross: q pre-scaled,
    kv [2, A, H, 2, 64, 1500]."""
    gen = torch.Generator().manual_seed(seed)
    dh, Tk = 64, 1500
    q = (torch.randn(A, G, H, dh, generator=gen) * dh**-0.5).bfloat16()
    kv = torch.randn(2, A, H, 2, dh, Tk, generator=gen).bfloat16()
    return q, kv


@pytest.mark.parametrize("shape", ["transcription", "medium.en beam 10"])
def test_split_emulation_matches_plain(chip_smoke, shape):
    """The split computation, right, is within the bf16 tolerance of the
    plain version (the one the kernel is held against on the card)."""
    q, kv = _inputs(*SHAPES[shape], seed=4)
    name = "cross_attention_step"
    chip_smoke.compare(name, (split_emulation(q, kv, 1),), (cross_attention_step_plain(q, kv, 1),),
                       chip_smoke.tolerance(name, torch.bfloat16))


@pytest.mark.parametrize("fault", ["drop", "local max"])
def test_chip_smoke_bf16_tolerance_rejects_faulty_splits(chip_smoke, fault):
    """At the transcription's shape (8 splits of 188 keys), dropping one
    split's keys or normalising each split by its local max fails the
    bf16 tolerance of the cross kernel's check."""
    q, kv = _inputs(*SHAPES["transcription"], seed=5)
    name = "cross_attention_step"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (split_emulation(q, kv, 1, fault),),
                           (cross_attention_step_plain(q, kv, 1),),
                           chip_smoke.tolerance(name, torch.bfloat16))
