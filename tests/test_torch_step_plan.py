"""The step kernels' launch plan (``ops/decode_attention.py::
step_launch_plan``) and the arithmetic of their one kernel body
(``csrc/self_attention.cu``, ``attend_window``), on the CPU: at every path
shape the append, beam, fused and read-only kernels (rows 7, 9, 11, 10)
run or are checked at, the plan's lane groups read the visible slots
exactly once, in order, within the kernel's block and shared-memory
limits; an emulation of the kernel in torch (each lane group's slots in
batches with a running max and sum, the rescale of each batch, then the
lane groups of a warp and the warps of the block merged in order) agrees
with each kernel's plain version in f32 at ``chip_smoke``'s f32
tolerance: the append and beam steps over a cache in the query dtype and
(beam) over an int8 one, the fused step, and the read-only step over a
cache in the query dtype, over an int8 one, and over an int8 one with its
column quantised and written first; with a key_start past pos the window
is uniform over the W slots; and ``chip_smoke``'s bf16 tolerance fails
the emulation with one batch's rescale skipped, with one warp's part
dropped, or with each warp's part normalised by its own max, over a bf16
cache and over an int8 one."""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from whisper_rs_tpu_torch.models import quantize_kv
from whisper_rs_tpu_torch.ops.decode_attention import (
    SMEM_LIMIT,
    SMS,
    STEP_GROUP_ROWS,
    STEP_MAX_WARPS,
    STEP_MIN_WARPS,
    STEP_UNROLL,
    STEP_WARPS_PER_SM,
    beam_self_attention_step_plain,
    self_attention_append_step_plain,
    self_attention_fused_step_plain,
    self_attention_step_plain,
    step_lanes,
    step_launch_plan,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (B, H, head dim, G; 0 for the greedy kernels) of every path shape the
# step kernels run or are checked at: the transcription (base.en, one
# audio, beam 5), medium.en b8 beam 5 (bf16 and int8 K/V), base.en b128
# (and int8), large-v3 b12 (and int8), medium.en b8 greedy (the append and
# ctx routes: B H 128), and the golden dims, greedy and beam 3 (head dim 16)
SHAPES = {
    "transcription": (5, 8, 64, 5),
    "medium.en beam 5": (40, 16, 64, 5),
    "base.en b128": (128, 8, 64, 0),
    "large-v3 b12": (12, 20, 64, 0),
    "medium.en b8": (8, 16, 64, 0),
    "golden dims": (1, 4, 16, 0),
    "golden dims beam 3": (6, 4, 16, 3),
}
# (W, pos, key_start) of the checks: the timed window, and W 448 at pos 400
# with each audio's first row starting at 37 b % 231 + 1 (b its first row),
# as chip_smoke checks them; "empty": row 0's key_start past pos
WINDOWS = {"W 256": (256, 255, False), "W 448 key_start": (448, 400, True),
           "W 448 empty": (448, 400, "empty")}


def _itemsizes(G: int) -> tuple:
    return (1, 2, 4)  # int8 caches take the beam kernel and row 10


def _visible(W: int, pos: int, key_start) -> tuple:
    """lo..hi of a row whose key_start is ``key_start``: the empty window is
    the W slots."""
    lo = min(max(int(key_start), 0), pos + 1)
    return (0, W - 1) if lo > pos else (lo, pos)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_step_plan_reads_the_visible_slots_once(shape, window):
    B, H, dh, G = SHAPES[shape]
    W, pos, ks = WINDOWS[window]
    starts = [401] if ks == "empty" else ([37 * b % 231 + 1 for b in range(B)] if ks else [0])
    for itemsize in _itemsizes(G):
        plan = step_launch_plan(B, H, pos + 1, W, dh, itemsize, beam=G > 0)
        warps = plan.threads // 32
        assert plan.threads % 32 == 0 and STEP_MIN_WARPS <= warps <= STEP_MAX_WARPS
        assert warps & (warps - 1) == 0
        assert plan.smem <= SMEM_LIMIT
        lanes = step_lanes(dh, itemsize)
        assert 32 % lanes == 0 and plan.threads % lanes == 0
        for start in starts:
            lo, hi = _visible(W, pos, start)
            read = plan.group_slots(lo, hi, lanes)
            assert len(read) == plan.threads // lanes
            assert sorted(j for slots in read for j in slots) == list(range(lo, hi + 1))
            assert all(slots == sorted(slots) for slots in read)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_step_plan_keeps_one_wave_and_rows_to_read_ahead(shape):
    """The warps a block: the most (a power of two, 2 to 8) that keep the
    grid within STEP_WARPS_PER_SM warps an SM and give each lane group
    STEP_GROUP_ROWS slots; the many-block shapes take 2 warps, large-v3
    b12 and the transcription 8."""
    B, H, dh, G = SHAPES[shape]
    for itemsize in _itemsizes(G):
        plan = step_launch_plan(B, H, 256, 256, dh, itemsize, beam=G > 0)
        warps, groups = plan.threads // 32, plan.threads // step_lanes(dh, itemsize)
        if warps > STEP_MIN_WARPS:
            assert B * H * warps <= STEP_WARPS_PER_SM * SMS
            assert -(-256 // groups) >= STEP_GROUP_ROWS
        if 2 * warps <= STEP_MAX_WARPS:  # twice the warps would break a limit
            assert (B * H * 2 * warps > STEP_WARPS_PER_SM * SMS
                    or -(-256 // (2 * groups)) < STEP_GROUP_ROWS)
    want = {"medium.en beam 5": 64, "base.en b128": 64, "large-v3 b12": 256,
            "transcription": 256, "medium.en b8": 256, "golden dims": 128,
            "golden dims beam 3": 128}
    assert step_launch_plan(B, H, 256, 256, dh, 2, beam=G > 0).threads == want[shape]
    # int8 caches: row 9's at the beam shapes, row 10's at the greedy ones
    want_int8 = dict(want, **{"medium.en b8": 256})
    assert step_launch_plan(B, H, 256, 256, dh, 1, beam=G > 0).threads == want_int8[shape]


def _case(shape: str, window: str, itemsize: int, seed: int, kernel: str = ""):
    """chip_smoke's step inputs at one layer, from numpy: q pre-scaled
    [B, H, dh] f32; k_new, v_new; caches [1, B, H, W, dh] (bf16 values, or
    int8 with f32 scales); the beam's random ancestors (a row's own at
    slot pos); key_start [B] (None at W 256).  ``kernel``: "append" or
    "beam" (the default, by the shape), "fused" (row 11, read only) or
    "step" (row 10: read only, or over an int8 cache "step write", which
    takes k_new and v_new in f32 and quantises them)."""
    B, H, dh, G = SHAPES[shape]
    W, pos, ks = WINDOWS[window]
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), dtype=np.float32) * dh**-0.5)
    kv = torch.from_numpy(rng.standard_normal((2, 1, B, H, W, dh), dtype=np.float32))
    new = torch.from_numpy(rng.standard_normal((2, B, H, dh), dtype=np.float32))
    kernel = kernel or ("beam" if G else "append")
    case = {"q": q, "pos": pos, "W": W, "kernel": kernel}
    if itemsize == 1:
        planes, scales = quantize_kv(kv)
        written = kernel == "step write"
        case.update(k_all=planes[0], v_all=planes[1], k_scale=scales[0], v_scale=scales[1],
                    k_new=new[0] if written else None, v_new=new[1] if written else None)
    else:
        kv = kv.bfloat16().float()  # the kernels' bf16 values, the plain math in f32
        written = kernel in ("append", "beam")
        case.update(k_all=kv[0].clone(), v_all=kv[1].clone(), k_scale=None, v_scale=None,
                    k_new=new[0].bfloat16().float() if written else None,
                    v_new=new[1].bfloat16().float() if written else None)
    key_start = None
    if ks:
        key_start = torch.from_numpy(np.arange(B) * 37 % 231 + 1)
        if ks == "empty":
            key_start[0] = pos + 1
    case["key_start"] = key_start
    if G:
        anc = torch.from_numpy(rng.integers(0, G, (B, W), dtype=np.int32))
        anc[:, pos] = torch.arange(B, dtype=torch.int32) % G
        case["anc"], case["G"] = anc, G
    return case


def _plain(case):
    """The plain version of the case's kernel on copies of the caches."""
    c = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in case.items()}
    args = (c["q"], c["k_new"], c["v_new"], c["k_all"], c["v_all"], 0, c["pos"], c["key_start"])
    read = (c["q"], c["k_all"], c["v_all"], 0, c["pos"], c["key_start"])
    if c["kernel"] == "beam":
        return beam_self_attention_step_plain(*args, c["anc"], c["G"], window=c["W"],
                                              k_scale=c["k_scale"], v_scale=c["v_scale"])
    if c["kernel"] == "append":
        return self_attention_append_step_plain(*args, window=c["W"])
    if c["kernel"] == "fused":
        return self_attention_fused_step_plain(*read, window=c["W"])
    return self_attention_step_plain(*read, window=c["W"], k_scale=c["k_scale"],
                                     v_scale=c["v_scale"], k_new=c["k_new"], v_new=c["v_new"])


def window_emulation(case, plan, lanes: int, fault: str = "") -> torch.Tensor:
    """The kernel's computation in torch f32: each row's visible slots (its
    ancestors' rows for the beam, slot pos from the fresh column, which an
    int8 cache takes quantised with its scales, or from the cache where the
    caller wrote it), lane
    group g taking slots lo + g + t groups in batches of STEP_UNROLL with a
    running max and sum, each batch rescaling the sum and acc; then the
    lane groups of a warp rescaled to their max and summed, and the warps
    of the block in order.  ``fault``: "skip rescale" leaves out the second
    batch's rescale; "drop" leaves out warp 1's part; "local max" adds the
    warps' parts each at its own max."""
    q, pos, W = case["q"], case["pos"], case["W"]
    B, H, dh = q.shape
    k_all, v_all = case["k_all"][0].clone(), case["v_all"][0].clone()
    k_scale, v_scale = (None, None) if case["k_scale"] is None else (
        case["k_scale"][0].clone(), case["v_scale"][0].clone())
    if case["k_new"] is not None:  # the fresh column, which the kernel reads from k_new
        if k_scale is None:
            k_all[:, :, pos], v_all[:, :, pos] = case["k_new"], case["v_new"]
        else:  # quantised, staged with its scales
            k_all[:, :, pos], k_scale[:, :, pos] = quantize_kv(case["k_new"])
            v_all[:, :, pos], v_scale[:, :, pos] = quantize_kv(case["v_new"])
    G = case.get("G", 1)
    first = torch.arange(B) // G * G
    ks = case["key_start"]
    lo = torch.zeros(B, dtype=torch.int64) if ks is None else ks[first].clamp(0, pos + 1)
    empty = lo > pos
    lo = torch.where(empty, 0, lo)
    n = torch.where(empty, W, pos + 1 - lo)  # [B]
    groups = plan.threads // lanes
    steps = -(-int(n.max()) // groups)
    i = torch.arange(steps * groups)
    valid = i[None, :] < n[:, None]  # [B, I]
    j = (lo[:, None] + i[None, :]).clamp(max=W - 1)
    src = (first[:, None] + case["anc"].long().gather(1, j)) if "anc" in case else (
        torch.arange(B)[:, None].expand(B, i.numel()))
    heads = torch.arange(H)[None, :, None]
    k = k_all[src[:, None, :], heads, j[:, None, :]].float()  # [B, H, I, dh]
    v = v_all[src[:, None, :], heads, j[:, None, :]].float()
    s = torch.einsum("bhd,bhid->bhi", q, k)
    if k_scale is not None:
        s = s * k_scale[src[:, None, :], heads, j[:, None, :]]
        v = v * v_scale[src[:, None, :], heads, j[:, None, :]][..., None]
    s = torch.where(empty[:, None, None], 0.0, s)
    s = torch.where(valid[:, None, :], s, -torch.inf)
    # slot lo + t groups + g: [B, H, steps, groups]
    s, v = s.view(B, H, steps, groups), v.view(B, H, steps, groups, dh)
    m = torch.full((B, H, groups), -torch.inf)
    ell = torch.zeros(B, H, groups)
    acc = torch.zeros(B, H, groups, dh)
    for batch, t0 in enumerate(range(0, steps, STEP_UNROLL)):
        sb, vb = s[:, :, t0:t0 + STEP_UNROLL], v[:, :, t0:t0 + STEP_UNROLL]
        mn = torch.maximum(m, sb.amax(2))
        a = torch.where(m == mn, 1.0, torch.exp(m - mn))
        if not (fault == "skip rescale" and batch == 1):
            ell, acc = ell * a, acc * a[..., None]
        e = torch.where(sb == -torch.inf, 0.0, torch.exp(sb - mn[:, :, None]))
        ell = ell + e.sum(2)
        acc = acc + torch.einsum("bhug,bhugd->bhgd", e, vb)
        m = mn
    per_warp = 32 // lanes  # lane groups a warp
    m, ell = m.view(B, H, -1, per_warp), ell.view(B, H, -1, per_warp)
    acc = acc.view(B, H, -1, per_warp, dh)
    mx = m.amax(-1)
    f = torch.where(m == -torch.inf, 0.0, torch.exp(m - mx[..., None]))
    ell, acc = (ell * f).sum(-1), (acc * f[..., None]).sum(-2)  # each warp's part
    if fault == "drop":
        keep = [w for w in range(mx.shape[-1]) if w != 1]
        mx, ell, acc = mx[..., keep], ell[..., keep], acc[..., keep, :]
    bm = mx.amax(-1, keepdim=True)
    fw = torch.where(mx == -torch.inf, 0.0, torch.exp(mx - bm))
    if fault == "local max":
        fw = torch.ones_like(fw)
    return ((acc * fw[..., None]).sum(-2) / (ell * fw).sum(-1)[..., None]).to(q.dtype)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("shape,window,cache", [
    (shape, window, cache) for shape in SHAPES for window in WINDOWS
    for cache in ("compute dtype", "int8") if cache != "int8" or SHAPES[shape][3]])
def test_window_emulation_matches_plain(chip_smoke, shape, window, cache):
    """The kernel's batches, running max and merge order, in f32, agree
    with the plain version at the f32 tolerance chip_smoke holds the
    kernels to, under the plan of the bf16 (or int8) instance; an int8
    cache takes the beam kernel only."""
    B, H, dh, G = SHAPES[shape]
    itemsize = 1 if cache == "int8" else 2
    case = _case(shape, window, itemsize, seed=3)
    W, pos = case["W"], case["pos"]
    plan = step_launch_plan(B, H, pos + 1, W, dh, itemsize, beam=G > 0)
    name = "beam_self_attention_step" if G else "self_attention_append_step"
    chip_smoke.compare(f"{name} {shape} {window} {cache}",
                       (window_emulation(case, plan, step_lanes(dh, itemsize)),), (_plain(case),),
                       chip_smoke.TOL_F32)


@pytest.mark.parametrize("fault", ["skip rescale", "drop", "local max"])
def test_chip_smoke_bf16_tolerance_rejects_faulty_merges(chip_smoke, fault):
    """At the transcription's shape (8 warps a block, 2 batches a lane
    group at W 256), a skipped rescale, a dropped warp, or warps merged
    each at its own max fail the bf16 tolerance of row 9's check."""
    B, H, dh, G = SHAPES["transcription"]
    case = _case("transcription", "W 256", 2, seed=5)
    plan = step_launch_plan(B, H, case["pos"] + 1, case["W"], dh, 2, beam=True)
    assert plan.threads == 256
    name = "beam_self_attention_step"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (window_emulation(case, plan, step_lanes(dh, 2), fault),),
                           (_plain(case),), chip_smoke.tolerance(name, torch.bfloat16))


# Rows 11 and 10 at their path shapes: (shape, kernel, cache).  Row 11 (the
# fused step) on medium.en b8's ctx route and at the golden dims; row 10
# over an int8 cache with its column write (the greedy path's call), read
# only over it, and read only over a cache in the query dtype, at base.en
# b128 and large-v3 b12 (int8 paths) and the golden dims
READ_CASES = [("medium.en b8", "fused", "compute dtype"), ("golden dims", "fused", "compute dtype")]
READ_CASES += [(shape, "step", cache) for shape in ("base.en b128", "large-v3 b12", "golden dims")
               for cache in ("int8 write", "int8", "compute dtype")]


@pytest.mark.parametrize("shape,kernel,cache,window", [
    case + (window,) for case in READ_CASES for window in WINDOWS])
def test_read_window_emulation_matches_plain(chip_smoke, shape, kernel, cache, window):
    """Rows 11 and 10 on the window body: slot pos from the cache (or, with
    the column write, quantised from k_new and v_new), int8 K/V with their
    per-slot scales, under the plan of the bf16 (or int8) instance, agree
    with the plain version at the f32 tolerance; with row 0's key_start past
    pos its output is V's mean over the W slots (after the write)."""
    B, H, dh, _ = SHAPES[shape]
    itemsize = 2 if cache == "compute dtype" else 1
    case = _case(shape, window, itemsize, seed=7,
                 kernel="step write" if cache == "int8 write" else kernel)
    W, pos = case["W"], case["pos"]
    plan = step_launch_plan(B, H, pos + 1, W, dh, itemsize)
    name = "self_attention_fused_step" if kernel == "fused" else "self_attention_step"
    got = window_emulation(case, plan, step_lanes(dh, itemsize))
    chip_smoke.compare(f"{name} {shape} {window} {cache}", (got,), (_plain(case),),
                       chip_smoke.TOL_F32)
    if WINDOWS[window][2] == "empty":
        v = case["v_all"][0, 0].float()  # row 0, [H, W, dh]
        if case["v_scale"] is not None:
            v = v * case["v_scale"][0, 0][..., None]
            if case["v_new"] is not None:
                v8, s8 = quantize_kv(case["v_new"][0])
                v[:, pos] = v8.float() * s8[:, None]
        chip_smoke.compare(f"{name} {shape} {cache}: row 0 uniform over W", (got[0],),
                           (v.mean(dim=1),), chip_smoke.TOL_F32)


@pytest.mark.parametrize("fault", ["skip rescale", "drop", "local max"])
def test_chip_smoke_bf16_tolerance_rejects_faulty_int8_merges(chip_smoke, fault):
    """Row 10's int8 read with its column write at large-v3 b12 (8 warps a
    block, 2 batches a lane group at W 256): a skipped rescale, a dropped
    warp, or warps merged each at its own max fail the bf16 tolerance of
    row 10's check."""
    B, H, dh, _ = SHAPES["large-v3 b12"]
    case = _case("large-v3 b12", "W 256", 1, seed=5, kernel="step write")
    plan = step_launch_plan(B, H, case["pos"] + 1, case["W"], dh, 1)
    assert plan.threads == 256
    assert -(-case["W"] // (plan.threads // step_lanes(dh, 1))) == 2 * STEP_UNROLL
    name = "self_attention_step"
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare(name, (window_emulation(case, plan, step_lanes(dh, 1), fault),),
                           (_plain(case),), chip_smoke.tolerance(name, torch.bfloat16))
