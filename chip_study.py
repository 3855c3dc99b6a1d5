"""Studies on one NVIDIA GPU that back choices and numbers in PERF.md.

    python3 chip_study.py plans [PARENT [LABEL]]
    python3 chip_study.py parity-seeds [TREE]
    python3 chip_study.py layer [PARENT]
    python3 chip_study.py step [PARENT [LABEL]]
    python3 chip_study.py transcribe PARENT
    python3 chip_study.py loop
    python3 chip_study.py ln [PARENT]
    python3 chip_study.py steps PARENT

``plans``: the cross kernel (row 5, ``csrc/cross_attention.cu``) at every
path shape of ``chip_smoke.py`` (the golden dims' included) under every
launch plan near the one ``cross_launch_plan`` picks (splits of the keys,
rows a tile, ring depth), bf16 and int8 K/V, each launched through the
wrapper's own binding, timed as ``chip_smoke.check_cross`` times it (a
CUDA graph of 20 calls rotating through the layers) and held to its
tolerance against the plain version.  The chosen plan is marked ``*``.
With PARENT, a checkout of an earlier tree (``git archive``), the cross
kernel of that tree is built from its source and timed in the same way
beside them, where its C interface is the one without plan arguments
(A, G, H, Tk, layer, dh, stream).  With LABEL, only the shapes whose
label starts with it.

``parity-seeds``: the int8 K/V beam parity of ``chip_smoke.py``
(``parity_beam``, medium.en cut to 4 + 4 layers, f32) at the script's own
audio seed and at three others, each reported pass or fail, run by the
``chip_smoke.py`` of the checkout at TREE (default: this one).

``layer``: the whole-step kernel (row 12, ``csrc/decoder_layer.cu``) in
bf16 at medium.en b8, W 256, pos 255 and W 448, pos 400, and at large-v3
b12, W 256, pos 255 (G 1, seeded random decoders, ``chip_smoke.
random_decoder``): first held to its plain version at
``chip_smoke.LAYER_BF16_DEPTH`` layers and called twice for the same bits,
then timed at full depth (CUDA events around 20 back-to-back launches,
each with its wrapper's allocations), with the mean time of each of its
eight phases over the layers from one launch with its phase clock; the
position is read from device memory.  With PARENT, a checkout of the tree
before the kernel read the position from device memory, that tree's
kernel is built from its source with this tree's nvcc flags, held to this
one (their outputs' largest difference) and timed the same way in turns
(parent, this, this, parent) through its own C interface (the position by
value, the same launch plan).

``step``: the step self-attention kernels (``csrc/self_attention.cu``,
one body, ``attend_window``): the append (row 7), beam (row 9, bf16 and
int8 K/V), fused (row 11) and read-only (row 10, over an int8 cache with
its column write, and over a bf16 cache) kernels in bf16 at every path
shape of ``chip_smoke.py`` (the transcription and the golden dims
included), with ``chip_smoke``'s inputs: first held to the plain version at
W 256, pos 255, at W 448, pos 400 with a key_start, and with one row's
key_start past pos (the empty window), and called twice for the same
bits; then timed as ``chip_smoke`` times them (a CUDA graph of 50 calls
rotating through the layers, so each finds its K/V cold in L2) at W 256,
pos 255, under the plan ``step_launch_plan`` picks (marked ``*``) and at
the other thread counts a block, beside the floor of such a graph (one
torch add on one element); the position is read from device memory.
With PARENT (``-`` for none), a checkout of the tree before the kernels
read the position from device memory, its kernels are built from their
source with this tree's nvcc flags, held to this tree's at the same plan
(their outputs' largest difference: 0 is bit-identical) and timed the same
way in turns (parent, this, this, parent) through their C interface (the
position by value); row 10 over an int8 cache as the greedy path runs it
(with its column write) and read only.
At the beam shapes the chosen plan is also timed with every row of an
audio on one ancestor row and with every row on its own, beside the
random ancestors: how the time follows the distinct rows read.  With
LABEL, only the shapes whose label starts with it.  The registers and
spills of every instance come first, from the build.

``transcribe``: the main transcription path of ``chip_smoke.py``
(``transcribe_main_path``: base.en, beam 5, the seeded 95 s file, f32
against the plain versions, then bf16 timed and profiled) of PARENT, a
checkout of an earlier tree, and of this tree in turns (parent, this,
this, parent), each in a process of its own started in its tree, on one
card: its audio-s/s and idle share apart from the rest of a
``chip_smoke.py`` run.

``loop``: the decode loop's check interval k (``decode.loop.CHECK_EVERY``)
at base.en b128 and large-v3 b12 greedy and medium.en b8 beam 5, bf16, the
step captured: ms a step, host syncs and no-op bodies at each k of
LOOP_KS, every k's decode held equal to the default's.

``ln``: rows 2 and 3 (``csrc/layer_norm.cu``: ``residual_ln``,
``ln_fused``) at every shape of PERF.md's table, the encoder's [B, T, D]
and the decoder's rows [rows, 1, D] of each path and one prefill, in bf16
(base.en b128's encoder in f32 too): held to the plain version at
``chip_smoke``'s tolerance, then timed as ``chip_smoke.check_ln_pair``
times them (a CUDA graph of 20 calls, each allocating its outputs, as the
wrapper does) under the plan ``ln_launch_plan`` picks (marked ``*``) and
at the warp variant's other rows a block (1, 2, 4, 8), beside the plain
chain, ``F.layer_norm`` and the byte bound; the plan's time is also taken
LN_REPEATS times over, each as ``chip_smoke`` takes it once (one replay),
to show its spread.  With PARENT, a checkout of
the tree that ran them in Triton (``csrc/layer_norm.py``), that kernel is
held to this one (their largest difference) and timed in turns (parent,
this, this, parent) through its own launch.

``steps``: the captured step of each decode path of ``chip_smoke.py``
(base.en b128 and large-v3 b12 greedy, medium.en b8 beam 5, and medium.en
b8 greedy prompted on the append, ctx and layer routes; bf16, seeded
weights, a PROFILE_STEPS budget) in PARENT and in this tree, each in a
process of its own started in its tree, in turns (parent, this, this,
parent): one replayed step's device launches and torch MeanOps launches
(a plain LayerNorm takes two) under torch.profiler, and ms a step
captured and eager (the mel, encoder and prefill taken out as in
``chip_smoke.e2e``).

Exits nonzero, printing no result, where CUDA is absent.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import itertools
import pathlib
import subprocess
import time
import sys

import numpy as np
import torch


def parent_cross(parent: pathlib.Path):
    """The bf16 and int8-bf16 entry points of PARENT's cross kernel, built
    into build/study/ with this tree's nvcc flags."""
    from whisper_rs_tpu_torch.ops import build

    src = parent / "whisper_rs_tpu_torch" / "csrc" / "cross_attention.cu"
    out = pathlib.Path(__file__).resolve().parent / "build" / "study" / "parent_cross.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    bf16, int8 = lib.cross_attention_bf16, lib.cross_attention_int8_bf16
    bf16.argtypes, int8.argtypes = [P] * 3 + [I] * 6 + [P], [P] * 5 + [I] * 6 + [P]
    return bf16, int8


def parent_layer(parent: pathlib.Path):
    """The bf16 entry point of PARENT's whole-step kernel, built into
    build/study/ with this tree's nvcc flags, with its C interface as the
    tree before the position was read from device memory has it (the
    position by value after n_ctx; the plan's table, grid, rings and
    shared memory as ``layer_launch_plan`` lays them out)."""
    from whisper_rs_tpu_torch.ops import build

    src = parent / "whisper_rs_tpu_torch" / "csrc" / "decoder_layer.cu"
    out = pathlib.Path(__file__).resolve().parent / "build" / "study" / "parent_layer.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).decoder_step_bf16
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 13 + [I] * 9 + [ctypes.c_float] + [I] * 5 + [P]
    fn.restype = I
    return fn


def layer(cs, parent=None) -> None:
    from whisper_rs_tpu_torch.config import dims_for
    from whisper_rs_tpu_torch.ops.decoder_layer_fused import (
        _device_plan,
        decoder_step_fused,
        decoder_step_fused_plain,
        decoder_step_weights,
        layer_launch_plan,
    )

    old = parent_layer(pathlib.Path(parent).resolve()) if parent else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    name = "decoder_step_fused"
    # (label, model, rows, window, pos)
    shapes = [("medium.en b8 W 256", "medium.en", 8, 256, 255),
              ("medium.en b8 W 448", "medium.en", 8, 448, 400),
              ("large-v3 b12 W 256", "large-v3", 12, 256, 255)]
    for label, model, B, W, pos in shapes:
        dims = dims_for(model)
        L, H, D = dims.n_text_layer, dims.n_text_head, dims.n_text_state
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = layer_launch_plan(B, D, blocks, 1, dims.n_audio_ctx, dims.n_text_ctx)
        print(f"[layer] {label}: plan " + "; ".join(
            f"{ph.name} {ph.slices}x{ph.width}" for ph in plan.phases)
            + f"; ring {plan.stages} stages, cross ring {plan.cross_stages}", flush=True)
        ks = torch.arange(B, device=dev) * 37 % 231 + 1
        depth = cs.LAYER_BF16_DEPTH
        dec = cs.random_decoder(dims, depth, torch.bfloat16, gen, dev)
        weights = decoder_step_weights(dec.blocks)
        x, kv, kc, vc = cs.layer_step_case(dims, depth, B, 1, torch.bfloat16, gen, dev)
        got = cs.layer_step(decoder_step_fused, weights, x, kv, (kc.clone(), vc.clone()), pos, ks,
                            H, 1, W)
        want = cs.layer_step(decoder_step_fused_plain, weights, x, kv, (kc.clone(), vc.clone()),
                             pos, ks, H, 1, W)
        cs.compare(f"{name} {label}, {depth} layers", got, want, cs.tolerance(name, torch.bfloat16))
        cs.check_deterministic(name, lambda: decoder_step_fused(
            x, weights, kv, kc, vc, pos, ks, n_head=H, group=1, window=W), {})
        del dec, weights, x, kv, kc, vc, got, want
        torch.cuda.empty_cache()

        dec = cs.random_decoder(dims, L, torch.bfloat16, gen, dev)
        weights = decoder_step_weights(dec.blocks)
        x, kv, kc, vc = cs.layer_step_case(dims, L, B, 1, torch.bfloat16, gen, dev)
        stream = torch.cuda.current_stream().cuda_stream

        at = torch.full((), pos, dtype=torch.int64, device=dev)  # read from device memory

        def new(clock=None):
            return decoder_step_fused(x, weights, kv, kc, vc, at, None, n_head=H, group=1,
                                      window=W, clock=clock)

        grid, lplan, table = _device_plan(B, D, 1, dims.n_audio_ctx, dims.n_text_ctx, dev)

        def parent_call(clock=None):
            out = x.clone()
            q, att = torch.empty_like(x), torch.empty_like(x)
            hid = torch.empty(B, 4 * D, dtype=x.dtype, device=dev)
            bar = torch.zeros(1 + lplan.flags, dtype=torch.int32, device=dev)
            part = torch.empty(lplan.partial_floats, dtype=torch.float32, device=dev)
            err = old(weights.table.data_ptr(), kv.data_ptr(), None, out.data_ptr(),
                      kc.data_ptr(), vc.data_ptr(), q.data_ptr(), att.data_ptr(), hid.data_ptr(),
                      bar.data_ptr(), None if clock is None else clock.data_ptr(),
                      part.data_ptr(), table.data_ptr(), B, D, H, L, 1, dims.n_audio_ctx,
                      dims.n_text_ctx, pos, W, 64**-0.5, grid, lplan.stages, lplan.cross_stages,
                      lplan.act_pitch, lplan.smem, stream)
            if err:
                raise RuntimeError(f"parent whole-step kernel launch failed: {err}")
            return out

        if old is not None:
            diff = (parent_call().float() - new().float()).abs().max().item()
            print(f"  parent vs this kernel, full depth: max abs diff {diff:.3e}", flush=True)
        kernels = [("this", new)] if old is None else [
            ("parent", parent_call), ("this", new), ("this", new), ("parent", parent_call)]
        times = {}
        for who, fn in kernels:
            times.setdefault(who, []).append(cs.timed_ms(fn, 20))
        spans = {}
        for who, fn in kernels[:2]:
            clock = torch.zeros(8 * L + 1, dtype=torch.int64, device=dev)
            fn(clock)
            torch.cuda.synchronize()
            spans[who] = ((clock[1:] - clock[:-1]).view(L, 8).double().mean(dim=0) / 1e3).tolist()
        isz = 2
        phase_bytes = cs.layer_phase_bytes(dims, B, 1, pos)
        bounds = [n * isz / cs.MEM_BW * 1e6 for n in phase_bytes]
        print(f"  ms at full depth ({L} layers), in turns: " + "; ".join(
            f"{who} " + ", ".join(f"{t:.4f}" for t in ts) for who, ts in times.items()),
            flush=True)
        for who, us in spans.items():
            print(f"  phases ({who}), mean us over {L} layers [bound us]: " + "; ".join(
                f"{ph} {u:.2f} [{b:.2f}]" for ph, u, b in zip(cs.PHASES, us, bounds)), flush=True)
        del dec, weights, x, kv, kc, vc
        torch.cuda.empty_cache()


def plans(cs, parent=None, only=None) -> None:
    from whisper_rs_tpu_torch.config import dims_for
    from whisper_rs_tpu_torch.models import quantize_kv
    from whisper_rs_tpu_torch.ops.decode_attention import (
        CROSS_MAX_STAGES,
        SMEM_LIMIT,
        CrossPlan,
        _cross_launch,
        _cross_smem,
        cross_attention_step_plain,
        cross_launch_plan,
    )

    old = parent_cross(pathlib.Path(parent).resolve()) if parent else None
    gen = torch.Generator(device="cuda").manual_seed(9)
    # (label, dims, audios, rows an audio)
    shapes = [("golden dims", cs.GOLDEN_DIMS, 1, 1), ("golden dims beam 3", cs.GOLDEN_DIMS, 2, 3),
              ("transcription", dims_for("base.en"), 1, 5),
              ("medium.en beam 5", dims_for("medium.en"), 8, 5),
              ("base.en b128", dims_for("base.en"), 128, 1),
              ("large-v3 b12", dims_for("large-v3"), 12, 1),
              ("medium.en beam 10", dims_for("medium.en"), 4, 10)]
    for label, dims, A, G in shapes:
        if only and not label.startswith(only):
            continue
        L, H, dh, T = dims.n_text_layer, dims.n_text_head, dims.head_dim, dims.n_audio_ctx
        for int8 in (False, True):
            q = (torch.randn(A, G, H, dh, generator=gen, device="cuda") * dh**-0.5).bfloat16()
            if int8:
                planes, s = quantize_kv(torch.randn(L, A, H, 2, T, dh, generator=gen,
                                                    device="cuda"))
                kv = planes.transpose(-1, -2).contiguous()
                s = s.permute(3, 0, 1, 2, 4).contiguous()
                scales = {"k_scale": s[0], "v_scale": s[1]}
                del planes
            else:
                kv = torch.randn(L, A, H, 2, dh, T, generator=gen, device="cuda").bfloat16()
                scales = {}
            isz = kv.element_size()
            chosen = cross_launch_plan(A, G, H, T, dh, isz)
            want = cross_attention_step_plain(q, kv, L - 1, **scales)
            tol = cs.tolerance("cross_attention_step", torch.bfloat16)
            out = torch.empty_like(q)
            results = []
            if old is not None:
                layers = itertools.cycle(range(L))

                def call_old():
                    ptrs = (q, kv, s[0], s[1], out) if int8 else (q, kv, out)
                    fn = old[1] if int8 else old[0]
                    err = fn(*(t.data_ptr() for t in ptrs), A, G, H, T, next(layers), dh,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"parent cross kernel launch failed: {err}")

                results.append(f"parent {cs.timed_ms(call_old, 20, graph=True) * 1e3:.1f}")
            for splits in sorted({1, 2, 4, 8, chosen.splits}):
                chunk = 4 * -(-(T // 4) // splits)
                splits = -(-T // chunk)
                for rows in (8, 16, 32, 64):
                    for stages in sorted({min(3, 2 * dh // rows), min(CROSS_MAX_STAGES,
                                                                      2 * dh // rows)}):
                        smem = _cross_smem(dh, isz, G, chunk, rows, stages)
                        if dh % rows or stages < 2 or smem > SMEM_LIMIT:
                            continue
                        plan = CrossPlan(splits, chunk, rows, stages, smem, T)
                        layers = itertools.cycle(range(L))

                        def call(layer=None, plan=plan):
                            return _cross_launch(q, kv, out, next(layers) if layer is None
                                                 else layer, plan, **scales)

                        call(L - 1)
                        cs.compare(f"{label} {plan}", (out.clone(),), (want,), tol)
                        ms = cs.timed_ms(call, 20, graph=True)
                        mark = "*" if plan == chosen else ""
                        results.append(f"S{splits}/r{rows}/st{stages}{mark} {ms * 1e3:.1f}")
            nbytes = A * H * 2 * dh * T * isz + (A * H * T * 8 if int8 else 0)
            print(f"[plans] {label}{', int8 K/V' if int8 else ''} (A {A}, G {G}, H {H}, dh {dh}; "
                  f"bound {nbytes / cs.MEM_BW * 1e6:.2f} us), us: " + " | ".join(results),
                  flush=True)
            del kv, want
            torch.cuda.empty_cache()


def parent_step(parent: pathlib.Path) -> dict:
    """PARENT's bf16 step entry points, built from its self-attention source
    into build/study/ with this tree's nvcc flags, with their C interface as
    the tree before the position was read from device memory has it: the
    position passed by value, every entry point taking a plan (threads),
    row 10 this step's column (k_new, v_new, or null)."""
    from whisper_rs_tpu_torch.ops import build

    src = parent / "whisper_rs_tpu_torch" / "csrc" / "self_attention.cu"
    out = pathlib.Path(__file__).resolve().parent / "build" / "study" / "parent_self.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {"append": lib.self_attention_append_bf16, "beam": lib.beam_self_attention_bf16,
           "beam int8": lib.beam_self_attention_int8_bf16, "fused": lib.self_attention_fused_bf16,
           "step": lib.self_attention_step_bf16}
    fns["append"].argtypes = [P] * 7 + [I] * 8 + [P]
    for key in ("beam", "beam int8"):
        fns[key].argtypes = [P] * 7 + [I, P] + [I] * 8 + [P]
    fns["fused"].argtypes = [P] * 5 + [I] * 8 + [P]
    fns["step"].argtypes = [P] * 9 + [I] * 8 + [P]
    for fn in fns.values():
        fn.restype = I
    return fns


# (label, model or None for the golden dims, audios, rows an audio, the
# kernel: append (row 7), beam (row 9), fused (row 11) or step (row 10),
# int8 K/V)
STEP_SHAPES = [
    ("base.en b128", "base.en", 128, 1, "append", False),
    ("large-v3 b12", "large-v3", 12, 1, "append", False),
    ("golden dims", None, 1, 1, "append", False),
    ("medium.en beam 5", "medium.en", 8, 5, "beam", False),
    ("medium.en beam 5, int8 K/V", "medium.en", 8, 5, "beam", True),
    ("transcription", "base.en", 1, 5, "beam", False),
    ("golden dims beam 3", None, 2, 3, "beam", False),
    ("golden dims beam 3, int8 K/V", None, 2, 3, "beam", True),
    ("row 11, medium.en b8 ctx", "medium.en", 8, 1, "fused", False),
    ("row 11, golden dims", None, 1, 1, "fused", False),
    ("row 10, base.en b128 int8", "base.en", 128, 1, "step", True),
    ("row 10, large-v3 b12 int8", "large-v3", 12, 1, "step", True),
    ("row 10, golden dims int8", None, 1, 1, "step", True),
    ("row 10, base.en b128 bf16 cache", "base.en", 128, 1, "step", False),
]


def step(cs, parent=None, only=None) -> None:
    from whisper_rs_tpu_torch.config import dims_for
    from whisper_rs_tpu_torch.ops.build import ptxas_report
    from whisper_rs_tpu_torch.ops.decode_attention import (
        StepPlan,
        _window_launch,
        beam_self_attention_step,
        beam_self_attention_step_plain,
        quantize_kv,
        self_attention_append_step,
        self_attention_append_step_plain,
        self_attention_fused_step,
        self_attention_fused_step_plain,
        self_attention_step,
        self_attention_step_plain,
        step_launch_plan,
    )

    wrappers = {
        "append": ("self_attention_append_step", self_attention_append_step,
                   self_attention_append_step_plain),
        "beam": ("beam_self_attention_step", beam_self_attention_step,
                 beam_self_attention_step_plain),
        "fused": ("self_attention_fused_step", self_attention_fused_step,
                  self_attention_fused_step_plain),
        "step": ("self_attention_step", self_attention_step, self_attention_step_plain),
    }
    old = parent_step(pathlib.Path(parent).resolve()) if parent else None
    for kernel, regs, stores, loads, _ in ptxas_report("self_attention"):
        print(f"[step] ptxas {kernel[-60:]}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    one = torch.zeros(1, device=dev)
    print(f"[step] the graph's floor: one torch add on one element, "
          f"{cs.timed_ms(lambda: one.add_(1), 50, graph=True) * 1e3:.2f} us", flush=True)
    for label, model, A, G, kind, int8 in STEP_SHAPES:
        if only and not label.startswith(only):
            continue
        dims = cs.GOLDEN_DIMS if model is None else dims_for(model)
        L, H, dh, n_ctx = dims.n_text_layer, dims.n_text_head, dims.head_dim, dims.n_text_ctx
        B, beam = A * G, kind == "beam"
        name, kernel, plain = wrappers[kind]
        q = (torch.randn(B, H, dh, generator=gen, device=dev) * dh**-0.5).bfloat16()
        if int8:
            planes, s = quantize_kv(torch.randn(2, L, B, H, n_ctx, dh, generator=gen, device=dev))
            k_all, v_all = planes[0], planes[1]
            scales = {"k_scale": s[0], "v_scale": s[1]}
        else:
            k_all, v_all = (torch.randn(L, B, H, n_ctx, dh, generator=gen, device=dev).bfloat16()
                            for _ in range(2))
            scales = {}
        fresh = tuple(torch.randn(B, H, dh, generator=gen, device=dev).bfloat16()
                      for _ in range(2))
        # the path's call takes this step's column: the append and beam
        # kernels over a bf16 cache, row 10 over an int8 one
        writes = kind in ("append", "beam") and not int8 or kind == "step" and int8
        rows = torch.arange(B, device=dev)
        ancs = {}
        if beam:
            anc = torch.randint(0, G, (B, n_ctx), generator=gen, device=dev, dtype=torch.int32)
            ancs = {"random": anc, "one row an audio": torch.zeros_like(anc),
                    "own rows": (rows % G).to(torch.int32)[:, None].expand(B, n_ctx).contiguous()}
            for a in ancs.values():
                a[:, [255, 400]] = (rows % G).to(torch.int32)[:, None]
        extra = (ancs["random"], G) if beam else ()

        def run(fn, pos, ks, W, at=L - 1, extra=extra):
            if kind in ("append", "beam"):
                new = fresh if writes else (None, None)
                return fn(q, *new, k_all, v_all, at, pos, ks, *extra, window=W, **scales)
            column = {"k_new": fresh[0], "v_new": fresh[1]} if writes else {}
            return fn(q, k_all, v_all, at, pos, ks, window=W, **scales, **column)

        ks = rows * 37 % 231 + 1
        empty = ks.clone()
        empty[0] = 401  # past pos: row 0 (its audio, for the beam) attends uniformly
        tol = cs.tolerance(name, torch.bfloat16)
        for W, pos, k in ((256, 255, None), (448, 400, ks), (448, 400, empty)):
            what = f"{label} W {W} pos {pos}" + ("" if k is None else
                                                 " empty window" if k is empty else " key_start")
            cs.compare(f"{name} {what}", (run(kernel, pos, k, W),),
                       (run(plain, pos, k, W),), tol)
        cs.check_deterministic(name, lambda: run(kernel, 255, ks, 256), {})

        W, pos = 256, 255
        # the wrappers' plan is taken at the window (n = W); at W 256, pos 255
        # it is the plan the position gave while it was passed by value
        chosen = step_launch_plan(B, H, W, W, dh, k_all.element_size(), beam)
        at = torch.full((), pos, dtype=torch.int64, device=dev)  # read from device memory
        out = torch.empty_like(q)
        nxt = cs.rotating(L)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (the capture's)
        entry = {"append": "self_attention_append", "fused": "self_attention_fused",
                 "step": "self_attention_step",
                 "beam": "beam_self_attention_int8" if int8 else "beam_self_attention"}[kind]

        def call(plan, anc=extra[0] if beam else None, layer=None, column=writes):
            new = fresh if column else (None, None)
            return _window_launch(entry, plan, nxt() if layer is None else layer, at, W, G,
                                  q=q, k_new=new[0], v_new=new[1], k_all=k_all, v_all=v_all,
                                  key_start=None, anc_local=anc, out=out, **scales)

        plans = {chosen} | {StepPlan(threads, chosen.smem) for threads in (64, 96, 128, 192, 256)}
        results = []
        if old is not None:
            fn = old["beam int8" if beam and int8 else kind]

            def call_old(layer=None, column=writes):
                at_layer = nxt() if layer is None else layer
                new = fresh if column else (None, None)
                ksc, vsc = scales.get("k_scale"), scales.get("v_scale")
                anc = extra[0] if beam else None
                ptrs = {"append": (q, *fresh, k_all, v_all, None, out),
                        "beam": (q, *fresh, k_all, v_all, None, anc),
                        "fused": (q, k_all, v_all, None, out),
                        "step": (q, *new, k_all, v_all, ksc, vsc, None, out)}[kind]
                if beam and int8:
                    ptrs = (q, k_all, v_all, ksc, vsc, None, anc)
                ptrs = [None if t is None else t.data_ptr() for t in ptrs]
                sizes = (B, H, n_ctx, at_layer, pos, W, dh, chosen.threads)
                err = (fn(*ptrs, G, out.data_ptr(), *sizes, stream()) if beam
                       else fn(*ptrs, *sizes, stream()))
                if err:
                    raise RuntimeError(f"parent {name} launch failed: {err}")

            call(chosen, layer=L - 1)
            want = out.clone()
            call_old(L - 1)
            print(f"  parent vs this kernel: max abs diff "
                  f"{(out.float() - want.float()).abs().max().item():.3e}", flush=True)
            turns = [("parent", call_old), ("this", lambda: call(chosen)),
                     ("this", lambda: call(chosen)), ("parent", call_old)]
            results.append("in turns (the parent: the position by value) " + ", ".join(
                f"{who} {cs.timed_ms(fn, 50, graph=True) * 1e3:.2f}" for who, fn in turns))
            if kind == "step" and writes:
                turns = [("parent", lambda: call_old(column=False)),
                         ("this", lambda: call(chosen, column=False)),
                         ("this", lambda: call(chosen, column=False)),
                         ("parent", lambda: call_old(column=False))]
                results.append("read only, in turns " + ", ".join(
                    f"{who} {cs.timed_ms(fn, 50, graph=True) * 1e3:.2f}" for who, fn in turns))
        for plan in sorted(plans):
            ms = cs.timed_ms(lambda plan=plan: call(plan), 50, graph=True)
            mark = "*" if plan == chosen else ""
            results.append(f"t{plan.threads}{mark} {ms * 1e3:.2f}")
        n = pos + 1
        ids = torch.arange(n, device=dev)
        first = rows // G * G
        for key, anc in ancs.items():
            kv_rows = torch.unique((first[:, None] + anc[:, :n].long()) * n + ids).numel()
            ms = cs.timed_ms(lambda anc=anc: call(chosen, anc), 50, graph=True)
            results.append(f"{key} ancestors ({kv_rows / (B * n):.2f} of reads distinct) "
                           f"{ms * 1e3:.2f}")
        kv_rows = B * n if not beam else torch.unique(
            (first[:, None] + ancs["random"][:, :n].long()) * n + ids).numel()
        row_bytes = 2 * H * dh * k_all.element_size() + (2 * H * 4 if int8 else 0)
        # q in, out; k_new, v_new in where the call writes its column, and
        # (bf16) the column out beside the rows read
        vectors = 2 + (2 if writes else 0) + (2 if writes and not int8 else 0)
        nbytes = kv_rows * row_bytes + vectors * B * H * dh * 2 + (B * n * 4 if beam else 0)
        print(f"[step] {label} (B {B}, G {G}, H {H}, dh {dh}; bound "
              f"{nbytes / cs.MEM_BW * 1e6:.2f} us), us: " + " | ".join(results), flush=True)
        del k_all, v_all
        if int8:
            del planes, s
        torch.cuda.empty_cache()


def transcribe(parent) -> None:
    trees = {"parent": pathlib.Path(parent).resolve(),
             "this": pathlib.Path(__file__).resolve().parent}
    code = ("import sys; sys.path.insert(0, '.'); import torch; import chip_smoke as cs; "
            "from whisper_rs_tpu_torch.ops.build import build_all; build_all(); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; cs.transcribe_main_path()")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    for who in ("parent", "this", "this", "parent"):
        run = subprocess.run([sys.executable, "-c", code], cwd=trees[who], capture_output=True,
                             text=True)
        if run.returncode:
            raise RuntimeError(f"{who}'s transcription path failed:\n{run.stderr[-2000:]}")
        lines = [line.strip() for line in run.stdout.splitlines()
                 if "bf16: 4 windows" in line or "idle share" in line]
        print(f"[transcribe] {who}: " + " | ".join(lines), flush=True)


def parity_seeds(cs) -> None:
    from whisper_rs_tpu_torch.config import dims_for

    dims = dataclasses.replace(dims_for("medium.en"), n_audio_layer=4, n_text_layer=4)
    own = cs.parity_audio
    for seed in (None, 101, 202, 303):
        if seed is not None:
            def audio(seed=seed):
                rng = np.random.default_rng(seed)
                return rng, np.stack([
                    rng.standard_normal(480_000).astype(np.float32) * np.float32(0.05 * (i + 1))
                    for i in range(cs.PARITY_WINDOWS)])
            cs.parity_audio = audio
        else:
            cs.parity_audio = own
        what = "the script's seed" if seed is None else f"seed {seed}"
        try:
            cs.parity_beam(dims, f"medium.en 4 + 4 layers, {what}", 5, int8_kv=True)
            print(f"[parity-seeds] {what}: pass", flush=True)
        except AssertionError as e:
            print(f"[parity-seeds] {what}: fail ({e})", flush=True)
    cs.parity_audio = own


LOOP_KS = (1, 2, 4, 8, 16, 32)


def loop(cs) -> None:
    """The decode loop's check interval k (``decode_loop.CHECK_EVERY``): the
    captured loop of base.en b128 greedy (unprompted), large-v3 b12 greedy
    and medium.en b8 beam 5 (prompted as BENCH_PROMPTED) at their full
    budgets, bf16, at each k of LOOP_KS, the window captured once and its
    results held equal at every k; two timed runs a k (the median of two,
    in turns from the smallest k to the largest and back), the steps'
    share of the wall (the mel, encoder and prefill taken out as in
    ``chip_smoke.e2e``), the host's syncs, and the bodies run past the end.
    A k costs at most k - 1 no-op steps at the end of a window that every
    row finishes early, each at the ms a step printed."""
    from whisper_rs_tpu_torch.config import BeamSearchMode, GreedyMode, dims_for
    from whisper_rs_tpu_torch.decode import decode_beam, decode_greedy
    from whisper_rs_tpu_torch.decode.loop import (
        WindowCache,
        _encode_and_prefill,
        beam_shape,
        greedy_shape,
    )

    for name, batch, beam in (("base.en", 128, 0), ("large-v3", 12, 0), ("medium.en", 8, 5)):
        dims = dims_for(name)
        model = cs.e2e_model(dims)
        cfg = cs.filter_config(dims)
        rng = np.random.default_rng(0)
        audio = rng.standard_normal((batch, 480_000)).astype(np.float32) * np.float32(0.1)
        if beam:
            initial, key_start, sample_begin, sot_idx = cs.bench_prompts(rng, batch,
                                                                         dims.n_text_ctx)
            sample_len = min(cs.SAMPLE_LEN, dims.n_text_ctx - sample_begin)
            mode, decode = BeamSearchMode(beam_size=beam, patience=1.0), decode_beam
        else:
            initial, key_start, sample_begin, sot_idx = (np.full((batch, 1), cs.SOT), None, 1,
                                                         0)
            sample_len, mode, decode = cs.SAMPLE_LEN, GreedyMode(), decode_greedy
        windows = WindowCache()
        mel = cs.log_mel_frontend(audio, dims.n_mels, dtype=torch.bfloat16)

        chosen = cs.decode_loop.CHECK_EVERY

        def run(k):
            cs.decode_loop.CHECK_EVERY = k
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = decode(model, mel, initial, sample_begin, sot_idx, cfg, mode, sample_len,
                             cs.NO_SPEECH, key_start=key_start, windows=windows)
                torch.cuda.synchronize()
            finally:
                cs.decode_loop.CHECK_EVERY = chosen
            return res, time.perf_counter() - t0

        want, _ = run(chosen)  # makes the window: its phases captured
        # the prefill alone, into that window's buffers (as the decode runs it)
        with_ks = key_start is not None
        P = np.asarray(initial).shape[1]
        shape = (beam_shape(mode, batch, P, sample_begin, sample_len, with_ks, cfg, True)
                 if beam else greedy_shape(mode, batch, P, sample_begin, sample_len, with_ks,
                                           cfg, True)[0])
        win = windows.get(model, shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks = None if key_start is None else torch.as_tensor(key_start, device="cuda")
        _encode_and_prefill(win, mel, torch.as_tensor(initial, device="cuda"), sot_idx,
                            cs.NO_SPEECH, ks)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        times = {k: [] for k in LOOP_KS}
        out = {}
        for k in LOOP_KS + LOOP_KS[::-1]:
            res, t = run(k)
            if not cs.same_decode(res, want):
                raise AssertionError(f"loop {name}: k {k} gives another decode")
            times[k].append(t)
            out[k] = res
        print(f"[loop] {cs.card_line()}: {name} b{batch}" + (f" beam {beam}" if beam else "")
              + f", {want.steps} steps, mel+encoder+prefill {t_pre * 1e3:.1f} ms: " + "; ".join(
                  f"k {k}: {(np.median(times[k]) - t_pre) / want.steps * 1e3:.3f} ms a step, "
                  f"{out[k].syncs} syncs, {out[k].bodies - want.steps} bodies past the end"
                  for k in LOOP_KS), flush=True)
        del model, windows, win, mel
        cs.e2e_model.cache_clear()
        torch.cuda.empty_cache()


LN_SHAPES = (  # (label, shape): the encoder's, then the decoder's rows and a prefill
    ("base.en b128", (128, 1500, 512)), ("large-v3 b12", (12, 1500, 1280)),
    ("medium.en b8", (8, 1500, 1024)), ("transcription b1", (1, 1500, 512)),
    ("golden dims", (1, 1500, 64)), ("CLI --batch 2", (2, 1500, 512)),
    ("serve b4", (4, 1500, 512)), ("TP 2 b8", (8, 1500, 512)),
    ("Ulysses 2 b8", (8, 750, 512)),
    ("step base.en b128", (128, 1, 512)), ("step large-v3 b12", (12, 1, 1280)),
    ("step medium.en b8", (8, 1, 1024)), ("step medium.en beam 5", (40, 1, 1024)),
    ("step transcription", (5, 1, 512)), ("step serve", (20, 1, 512)),
    ("step CLI --batch 2", (10, 1, 512)), ("step golden dims", (1, 1, 64)),
    ("prefill medium.en beam 5", (40, 232, 1024)),
)
LN_REPEATS = 9


def parent_triton(parent: pathlib.Path):
    """PARENT's Triton row LayerNorm (``csrc/layer_norm.py``) as its wrapper
    launched it: one program a row, the row as one block of the power of
    two at or above D; returns (ln, y) for (x, delta, scale, bias,
    residual), allocating its outputs as the wrapper did."""
    import importlib.util

    import triton

    spec = importlib.util.spec_from_file_location(
        "parent_layer_norm", parent / "whisper_rs_tpu_torch" / "csrc" / "layer_norm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(x, delta, scale, bias, residual: bool):
        D = x.shape[-1]
        block_d = triton.next_power_of_2(D)
        ln = torch.empty_like(x)
        y = torch.empty_like(x) if residual else ln
        mod.layer_norm_rows[(x.numel() // D,)](
            x, delta if residual else x, scale, bias, y, ln, D, 1e-5, HAS_RESIDUAL=residual,
            BLOCK_D=block_d, num_warps=4 if block_d <= 1024 else 8)
        return (y, ln) if residual else ln

    return run


def ln(cs, parent=None) -> None:
    import torch.nn.functional as F

    from whisper_rs_tpu_torch.ops import encoder_fused as ef

    triton_ln = parent_triton(pathlib.Path(parent).resolve()) if parent else None
    gen = torch.Generator(device="cuda").manual_seed(17)
    for label, shape in LN_SHAPES:
        for dtype in ((torch.float32, torch.bfloat16) if label == "base.en b128"
                      else (torch.bfloat16,)):
            D, tag = shape[-1], "f32" if dtype == torch.float32 else "bf16"
            isz = torch.tensor([], dtype=dtype).element_size()
            x, d = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
            s, b = (torch.randn(D, generator=gen, device="cuda").to(dtype) for _ in range(2))
            plan = ef.ln_launch_plan(x.numel() // D, D, dtype)
            for name, residual in (("ln_fused", False), ("residual_ln", True)):
                args = (x, d, s, b) if residual else (x, s, b)
                kernel = getattr(ef, name)
                plain = getattr(ef, f"{name}_plain")
                want, got = plain(*args), kernel(*args)
                err, share = cs.compare(f"{name} {tag} {label} {list(shape)}",
                                        got if residual else (got,),
                                        want if residual else (want,), cs.tolerance(name, dtype))
                reps = 20
                nbytes = ((4 if residual else 2) * x.numel() + 2 * D) * isz
                bound_us = nbytes / cs.MEM_BW * 1e6
                us = lambda fn, n=reps: cs.timed_ms(fn, n, graph=True) * 1e3  # noqa: E731
                line = (f"[ln] {name} {tag} {label} {list(shape)}: plan {plan.variant} vec "
                        f"{plan.vec} iters {plan.iters} rows/block {plan.rows_per_block} grid "
                        f"{plan.grid}; bound {bound_us:.3f} us")
                if triton_ln is not None:
                    tri = (lambda: triton_ln(x, d, s, b, True)) if residual else (
                        lambda: triton_ln(x, x, s, b, False))
                    other = tri()
                    diff = max((p.float() - q.float()).abs().max().item() for p, q in zip(
                        other if residual else (other,), got if residual else (got,)))
                    turns = [us(tri), us(lambda: kernel(*args)), us(lambda: kernel(*args)),
                             us(tri)]
                    line += (f"; Triton (parent) {turns[0]:.3f}, this {turns[1]:.3f}, this "
                             f"{turns[2]:.3f}, Triton {turns[3]:.3f} us (max |diff| {diff:.3e})")
                else:
                    line += f"; this {us(lambda: kernel(*args)):.3f} us"
                if plan.variant == "warp":
                    out = torch.empty_like(x)
                    y = torch.empty_like(x) if residual else out
                    sweep = []
                    for r in (1, 2, 4, 8):
                        p = dataclasses.replace(plan, rows_per_block=r, threads=32 * r,
                                                grid=-(-plan.grid * plan.rows_per_block // r))
                        t = us(lambda p=p: ef._launch(x, d if residual else x, s, b, y, out,
                                                      1e-5, residual, p))
                        sweep.append(f"{r}{'*' if r == plan.rows_per_block else ''} {t:.3f}")
                    line += f"; rows a block (outputs preallocated): {', '.join(sweep)} us"
                again = sorted(us(lambda: kernel(*args)) for _ in range(LN_REPEATS))
                line += (f"; this {LN_REPEATS} times: min {again[0]:.3f}, median "
                         f"{again[LN_REPEATS // 2]:.3f}, max {again[-1]:.3f} us")
                lib = (lambda: F.layer_norm(x + d, (D,), s, b, 1e-5)) if residual else (
                    lambda: F.layer_norm(x, (D,), s, b, 1e-5))
                line += (f"; plain {us(lambda: plain(*args), 5):.3f} us; F.layer_norm "
                         f"{us(lib):.3f} us; max_abs_err {err:.3e} (share {share:.3f})")
                print(line, flush=True)
            del x, d
            torch.cuda.empty_cache()


def steps_here(cs) -> None:
    """The ``steps`` measurement in the tree of ``cs``: one line a path."""
    import json

    from torch.profiler import ProfilerActivity, profile, schedule

    from whisper_rs_tpu_torch.config import BeamSearchMode, GreedyMode, dims_for
    from whisper_rs_tpu_torch.decode import decode_beam, decode_greedy
    from whisper_rs_tpu_torch.decode.loop import WindowCache, _encode_and_prefill

    budget = cs.PROFILE_STEPS
    for name, batch, beam, routes in (("base.en", 128, 0, ("append",)),
                                      ("large-v3", 12, 0, ("append",)),
                                      ("medium.en", 8, 5, ("beam",)),
                                      ("medium.en", 8, 0, ("append", "ctx", "layer"))):
        dims = dims_for(name)
        model = cs.e2e_model(dims)
        cfg = cs.filter_config(dims)
        rng = np.random.default_rng(0)
        audio = rng.standard_normal((batch, 480_000)).astype(np.float32) * np.float32(0.1)
        prompted = beam or len(routes) > 1
        if prompted:
            initial, key_start, sample_begin, sot_idx = cs.bench_prompts(rng, batch,
                                                                         dims.n_text_ctx)
        else:
            initial, key_start, sample_begin, sot_idx = (np.full((batch, 1), cs.SOT), None, 1,
                                                         0)
        mel = cs.log_mel_frontend(audio, dims.n_mels, dtype=torch.bfloat16)
        for route in routes:
            windows = WindowCache()
            if beam:
                mode = BeamSearchMode(beam_size=beam, patience=1.0)
                decode = lambda g, m=mode: decode_beam(  # noqa: E731
                    model, mel, initial, sample_begin, sot_idx, cfg, m, budget, cs.NO_SPEECH,
                    key_start=key_start, graphs=g, windows=windows if g else None)
            else:
                mode = GreedyMode()
                decode = lambda g, r=route, m=mode: decode_greedy(  # noqa: E731
                    model, mel, initial, sample_begin, sot_idx, cfg, m, budget, cs.NO_SPEECH,
                    key_start=key_start, step_kernel=r, graphs=g,
                    windows=windows if g else None)

            def timed(graphs: bool):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = decode(graphs)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            decode(False)  # warm-up: kernel libraries, cuBLAS
            decode(True)  # makes the window: its phases captured
            captured = [timed(True) for _ in range(2)]
            eager = timed(False)
            win = next(iter(windows._windows.values()))  # the one window: its phases captured
            ks = None if key_start is None else torch.as_tensor(key_start, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _encode_and_prefill(win, mel, torch.as_tensor(initial, device="cuda"), sot_idx,
                                cs.NO_SPEECH, ks)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=2, active=1, repeat=1)) as prof:
                for _ in range(3):
                    win.run_phase_steps(win.phases[-1], 1)
                    torch.cuda.synchronize()
                    prof.step()
            events = cs.device_events(prof)
            res = captured[-1][0]
            row = {
                "path": f"{name} b{batch}" + (f" beam {beam}" if beam else "")
                + (" prompted" if prompted else "") + f" {route}",
                "step_launches": sum(n for _, n in events.values()),
                "step_mean_ops": sum(n for k, (_, n) in events.items() if "MeanOps" in k),
                "ms_step_captured": (min(t for _, t in captured) - t_pre) / res.steps * 1e3,
                "ms_step_eager": (eager[1] - t_pre) / eager[0].steps * 1e3,
                "steps": res.steps, "prefill_ms": t_pre * 1e3,
            }
            print("[steps] " + json.dumps(row), flush=True)
            del windows, win
        del model
        cs.e2e_model.cache_clear()
        torch.cuda.empty_cache()


def steps(parent) -> None:
    trees = {"parent": pathlib.Path(parent).resolve(),
             "this": pathlib.Path(__file__).resolve().parent}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    for who in ("parent", "this", "this", "parent"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(trees["this"] / "chip_study.py"),
                              "steps-here", str(trees[who])], cwd=trees[who],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{who}'s steps failed:\n{run.stderr[-3000:]}")
        for line in run.stdout.splitlines():
            if line.startswith("[steps]"):
                print(f"[steps] {who}: {line[8:]}", flush=True)
        print(f"[steps] {who}: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_study: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2 or sys.argv[1] not in ("plans", "parity-seeds", "layer", "step",
                                                 "transcribe", "loop", "ln", "steps",
                                                 "steps-here"):
        print(__doc__, file=sys.stderr)
        return 2
    arg = sys.argv[2] if len(sys.argv) > 2 else None
    if sys.argv[1] in ("transcribe", "steps"):
        if not arg:
            print(__doc__, file=sys.stderr)
            return 2
        (transcribe if sys.argv[1] == "transcribe" else steps)(arg)
        return 0
    tree = pathlib.Path(__file__).resolve().parent
    if sys.argv[1] in ("parity-seeds", "steps-here") and arg:
        tree = pathlib.Path(arg).resolve()
    sys.path.insert(0, str(tree))
    cs = importlib.import_module("chip_smoke")
    from whisper_rs_tpu_torch.ops.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {cs.card_line()} | tree {cs.__file__}", flush=True)
    build_all()
    if sys.argv[1] == "plans":
        plans(cs, arg, sys.argv[3] if len(sys.argv) > 3 else None)
    elif sys.argv[1] == "layer":
        layer(cs, arg)
    elif sys.argv[1] == "step":
        step(cs, None if arg == "-" else arg, sys.argv[3] if len(sys.argv) > 3 else None)
    elif sys.argv[1] == "loop":
        loop(cs)
    elif sys.argv[1] == "ln":
        ln(cs, arg)
    elif sys.argv[1] == "steps-here":
        steps_here(cs)
    else:
        parity_seeds(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
