"""Rows 2 and 3 (``ops/encoder_fused.py``: ``residual_ln``, ``ln_fused``) on
the CPU, where the wrappers take their plain versions:

  * every LayerNorm of the model goes through row 3's wrapper (row 2's for
    the encoder's residual adds) when ``kernels`` is on, and none when it is
    off: 3 n_text_layer + 1 a decoder pass on the layered routes (prefill,
    append, ctx, beam, int8 K/V, the word aligner's teacher-forced pass),
    1 on the ``layer`` route (the whole-step kernel keeps its own),
    n_audio_layer + 1 an encoder call (the blocks' and ``ln_post``), on the
    one-process encoder, the pipeline's and Ulysses';
  * ``ln_launch_plan`` covers every element of every row exactly once, at
    every registry width and every width the tests use, f32 and bf16, from
    one row to base.en b128's encoder (192,000 rows), as the CUDA kernel
    indexes them.

The parity of the wrappers with the Pallas kernels, at the encoder's and
the decoder step's shapes, is ``tests/test_torch_encoder.py``."""

import numpy as np
import pytest
import torch

from whisper_rs_tpu_torch.config import MODEL_REGISTRY, ModelDims
from whisper_rs_tpu_torch.decode import align
from whisper_rs_tpu_torch.models import KVCache, init_random, precompute_cross_kv
from whisper_rs_tpu_torch.models import whisper as port_whisper
from whisper_rs_tpu_torch.ops import encoder_fused
from whisper_rs_tpu_torch.ops.encoder_fused import (
    MAX_HELD,
    ln_fused_plain,
    ln_launch_plan,
    residual_ln_plain,
)
from whisper_rs_tpu_torch.parallel import pipeline, ulysses
from whisper_rs_tpu_torch.parallel.mesh import Mesh

# D 128 and 2 heads: head dim 64, which the layer route's kernel takes
DIMS = ModelDims(n_mels=80, n_vocab=300, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
                 n_audio_layer=2, n_text_ctx=16, n_text_state=128, n_text_head=2, n_text_layer=2)
TK = 16  # cross K/V frames of the decoder's passes (the encoder's 1500 are not needed)


@pytest.fixture(scope="module")
def model():
    return init_random(DIMS, seed=0, device="cpu")


@pytest.fixture
def counted(monkeypatch):
    """Counts of the calls of ``ln_fused`` and ``residual_ln`` wherever the
    model's modules bind them; each call still computes the plain value."""
    counts = {"ln_fused": 0, "residual_ln": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for module in (port_whisper, pipeline, ulysses):
        for name, fn in (("ln_fused", ln_fused_plain), ("residual_ln", residual_ln_plain)):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, counting(name, fn))
    return counts


def _decoder_pass(model, route: str, kernels: bool):
    """One prefill of 3 tokens, then (unless ``route`` is "prefill") one
    incremental step on ``route`` after it; returns the step's logits.
    Route "align": the word aligner's pass over 8 tokens instead; returns
    its cross logits."""
    torch.manual_seed(0)
    if route == "align":
        xa = torch.randn(TK, DIMS.n_audio_state) * 0.5
        tokens = torch.randint(0, DIMS.n_vocab, (8,))
        heads = align.default_alignment_heads(DIMS)
        return align._alignment_qk(model, tokens, xa, heads, kernels=kernels)
    group = 2 if route == "beam" else 1
    B, int8 = 4, route == "int8"
    xa = torch.randn(B // group, TK, DIMS.n_audio_state) * 0.5
    cross_kv = precompute_cross_kv(model, xa, quantize=int8)
    cache = KVCache.init(DIMS, B, torch.float32, "cpu", quantize=int8)
    tokens = torch.randint(0, DIMS.n_vocab, (B, 3))
    logits = model.decoder(tokens, 0, cross_kv, cache, cross_group=group, kernels=kernels)
    if route == "prefill":
        return logits
    ancestors = None
    if route == "beam":
        ancestors = (torch.arange(B, dtype=torch.int32) % group)[:, None].repeat(
            1, DIMS.n_text_ctx)
    step_kernel = route if route in ("ctx", "layer") else "append"
    return model.decoder(tokens[:, -1:], 3, cross_kv, cache, cross_group=group, kernels=kernels,
                         incremental=True, ancestors=ancestors, step_kernel=step_kernel)


@pytest.mark.parametrize("route", ["append", "ctx", "layer", "beam", "int8", "align"])
def test_every_decoder_layer_norm_goes_through_row_3(model, counted, route):
    """The prefill and the step each take 3 n_text_layer + 1 LayerNorms
    through ``ln_fused`` (the layer route's step: its final one only; the
    aligner's pass is one such prefill and no step), and ``kernels=False``
    takes none; the values are the same both ways."""
    L = DIMS.n_text_layer
    with torch.no_grad():
        want = _decoder_pass(model, route, kernels=False)
        assert counted == {"ln_fused": 0, "residual_ln": 0}
        got = _decoder_pass(model, route, kernels=True)
    step = {"layer": 1, "align": 0}.get(route, 3 * L + 1)
    assert counted == {"ln_fused": 3 * L + 1 + step, "residual_ln": 0}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("encoder", ["model", "pipeline", "ulysses"])
def test_every_encoder_layer_norm_goes_through_rows_2_and_3(model, counted, encoder):
    """An encoder call, one process (the pipeline's and Ulysses' on the
    1 x 1 x 1 mesh, where every collective is the identity): ``ln_fused``
    n_audio_layer + 1 times (each block's first LayerNorm and ``ln_post``),
    ``residual_ln`` n_audio_layer times; none with ``kernels=False``."""
    run = {
        "model": lambda mel, k: model.encoder(mel, kernels=k),
        "pipeline": lambda mel, k: pipeline.encoder_forward_pp(model, mel, Mesh(), kernels=k),
        "ulysses": lambda mel, k: ulysses.encoder_forward_ulysses(model, mel, Mesh(), kernels=k),
    }[encoder]
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 80, 3000),
                                                                     dtype=np.float32))
    with torch.no_grad():
        want = run(mel, False)
        assert counted == {"ln_fused": 0, "residual_ln": 0}
        got = run(mel, True)
    L = DIMS.n_audio_layer
    assert counted == {"ln_fused": L + 1, "residual_ln": L}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# every registry width, and the widths of the tests and of the checks on the
# card (the golden dims' 64, the test models' 128, odd and tiny widths, and
# widths that only the block variant takes)
WIDTHS = sorted({d.n_text_state for d in MODEL_REGISTRY.values()}
                | {d.n_audio_state for d in MODEL_REGISTRY.values()}
                | {1, 7, 60, 64, 100, 128, 513, 2048, 2052, 4096, 5000})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_ln_launch_plan_covers_every_element_once(dtype, aligned):
    """Each plan, as ``csrc/layer_norm.cu`` indexes it: the blocks' rows
    (warp w of block b takes row b * rows_per_block + w; the block variant
    one row a block) cover rows 0..rows-1 once, with no block past the
    end; the vectors of one row (lane l's c = i * 32 + l, i < iters; the
    block's thread t's c = t + k * threads) cover 0..D-1 once, each vector
    ``vec`` elements whole inside the row, and a lane holds at most
    MAX_HELD values.  Vectors are 16 bytes where D and the pointers allow."""
    isz = torch.tensor([], dtype=dtype).element_size()
    for D in WIDTHS:
        for rows in (1, 5, 40, 128, 192_000):
            plan = ln_launch_plan(rows, D, dtype, aligned)
            full = 16 // isz
            assert plan.vec == (full if aligned and D % full == 0 else 1)
            assert D % plan.vec == 0
            chunks = D // plan.vec
            if plan.variant == "warp":
                assert plan.threads == 32 * plan.rows_per_block <= 256
                assert plan.iters * plan.vec <= MAX_HELD and plan.smem == 0
                row_of = (np.arange(plan.grid)[:, None] * plan.rows_per_block
                          + np.arange(plan.rows_per_block)[None])
                c = np.arange(plan.iters)[:, None] * 32 + np.arange(32)[None]
            else:
                assert plan.grid == rows and plan.rows_per_block == 1
                assert plan.smem == (D + 64) * 4 and plan.threads == 256
                row_of = np.arange(plan.grid)[:, None]
                c = np.arange(plan.iters)[:, None] * plan.threads + np.arange(plan.threads)[None]
                # more vectors than a warp's registers hold: why a block takes it
                assert -(-chunks // 32) * plan.vec > MAX_HELD or -(-chunks // 32) > 16
            row_of = row_of[row_of < rows]
            assert np.array_equal(np.sort(row_of), np.arange(rows))
            assert plan.grid == -(-rows // plan.rows_per_block)
            c = c[c < chunks]
            elems = (c[:, None] * plan.vec + np.arange(plan.vec)[None]).ravel()
            assert np.array_equal(np.sort(elems), np.arange(D)), (D, rows, plan)


def _scale_loads_early(plan) -> bool:
    """Whether the instance ``plan`` launches loads scale and bias with the
    row (``csrc/layer_norm.cu``'s EARLY: 16-byte vectors, at most
    EARLY_ITERS = 5 of them a lane)."""
    return plan.variant == "warp" and plan.vec > 1 and plan.iters <= 5


def test_ln_launch_plan_spreads_the_step_rows():
    """The decoder step's rows (5-128) take one warp a block, a block an SM
    or fewer; the encoder's (1500 a window) take 8 rows a block (4 where a
    lane holds more than 16 values).  Scale and bias load with the row at
    every registry width in bf16, not where a lane holds more vectors or
    1-element ones."""
    widths = (384, 512, 768, 1024, 1280)
    for rows in (5, 8, 12, 40, 128):
        for D in widths:
            plan = ln_launch_plan(rows, D, torch.bfloat16)
            assert plan.rows_per_block == 1 and _scale_loads_early(plan)
    for rows in (1500, 192_000):
        assert ln_launch_plan(rows, 512, torch.bfloat16).rows_per_block == 8
        assert ln_launch_plan(rows, 1024, torch.bfloat16).rows_per_block == 4
        assert all(_scale_loads_early(ln_launch_plan(rows, D, torch.bfloat16)) for D in widths)
    assert not _scale_loads_early(ln_launch_plan(8, 1280, torch.float32))  # 10 vectors a lane
    assert not _scale_loads_early(ln_launch_plan(8, 512, torch.bfloat16, aligned=False))
    assert ln_launch_plan(12, 1280, torch.bfloat16) == encoder_fused.LnPlan(
        "warp", 8, 5, 1, 32, 12, 0)
