"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any mismatch raises and the script exits nonzero:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once); the seconds are printed;
  3. kernels  each kernel wrapper at the base.en batch-128 shapes of the main
              path, in f32 and bf16 (mel: f32 only), against its plain
              PyTorch version: max abs/rel error against the kernel's
              tolerance, kernel ms, plain ms, bound ms (the larger of bytes
              over 3.35 TB/s and operations over the peak rate of their type)
              and library ms (one PyTorch call for the same function, timed
              only as a yardstick);
  4. parity   base.en at full width, seeded weights, 4 seeded 30 s windows,
              log_mel_frontend -> decode_greedy (224 steps) in f32 through
              the kernels and through the plain versions: first-step
              filtered logits within 1e-3, tokens equal per row unless the
              plain path's top-2 margin at the first divergent step is below
              1e-3;
  5. e2e      the main path, bf16, batch 128, 224-step budget, timed 3 times,
              with every launch count set to 0 just before each run and read
              just after: each kernel launched, the cross kernel 6 times a
              step; audio-s/s of the median run;
  6. profile  one more e2e run under torch.profiler: its idle share and
              where its device time goes;
  7. the kernels line (JSON), the card line, and last the contract line.

Exits nonzero, printing no result, where CUDA is absent.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from whisper_rs_tpu_torch.audio.constants import HOP_LENGTH, N_FFT, N_SAMPLES
from whisper_rs_tpu_torch.audio.mel import hann_window, mel_filterbank, reflect_pad
from whisper_rs_tpu_torch.config import GreedyMode, dims_for
from whisper_rs_tpu_torch.decode import FilterConfig, apply_filters, decode_greedy
from whisper_rs_tpu_torch.decode.loop import _encode_and_prefill
from whisper_rs_tpu_torch.models import KVCache, init_random, precompute_cross_kv
from whisper_rs_tpu_torch.ops import LAUNCHES, reset_launches
from whisper_rs_tpu_torch.ops.build import build_all
from whisper_rs_tpu_torch.ops.decode_attention import (
    cross_attention_step,
    cross_attention_step_plain,
)
from whisper_rs_tpu_torch.ops.encoder_attention import (
    encoder_attention_merged,
    encoder_attention_merged_plain,
)
from whisper_rs_tpu_torch.ops.encoder_fused import (
    ln_fused,
    ln_fused_plain,
    residual_ln,
    residual_ln_plain,
)
from whisper_rs_tpu_torch.ops.mel import log_mel_frontend, raw_log10_mel, raw_log10_mel_plain

MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s, no TF32
MODEL = "base.en"
BATCH = 128
SAMPLE_LEN = 224
PARITY_WINDOWS = 4
E2E_REPS = 3
# (atol, rtol) of |kernel - plain| <= atol + rtol |plain|.  In bf16 the rtol
# covers one bf16 ulp of the output (2^-7 relative) where the two round an
# f32 value on either side of a boundary.  The attention atol covers the
# bf16 rounding of the softmax weights and stays well under the output's
# typical size (~0.04) at the unit-scale inputs of kernel_checks, so a
# dropped key tile or a wrong Q.K weighting fails.
TOL_F32 = (1e-4, 1e-4)
TOL_BF16 = {
    "ln_fused": (1e-3, 1e-2),
    "residual_ln": (1e-3, 1e-2),
    "encoder_attention_merged": (2e-3, 1e-2),
    "cross_attention_step": (2e-3, 1e-2),
}


def tolerance(name: str, dtype) -> tuple:
    return TOL_F32 if dtype == torch.float32 else TOL_BF16[name]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean ms per call on the card, CUDA events around ``reps`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, tol: tuple) -> tuple:
    """Elementwise |got - want| <= atol + rtol * |want| over every output;
    returns the max abs error and the largest share of its tolerance that
    any element uses (above 1 fails)."""
    atol, rtol = tol
    worst_abs, worst_rel, share = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{name}: non-finite output")
        err = (g - w).abs()
        worst_abs = max(worst_abs, err.max().item())
        worst_rel = max(worst_rel, (err.max() / w.abs().max().clamp(min=1e-30)).item())
        share = max(share, (err / (atol + rtol * w.abs())).max().item())
    print(
        f"  {name}: max_abs_err {worst_abs:.3e} max_rel_err {worst_rel:.3e} "
        f"(tolerance |d| <= {atol:g} + {rtol:g}|plain|; largest share used {share:.3f})",
        flush=True,
    )
    if share > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst_abs, share


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / MEM_BW, flops / PEAK[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, dtype, kernel, plain, library, nbytes, flops, reps):
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = tolerance(name, dtype)
    err, share = compare(f"{name} {str(dtype).split('.')[-1]}", got, want, tol)
    row = {
        "max_abs_err": err,
        "atol": tol[0],
        "rtol": tol[1],
        "tol_share": share,
        "ms": timed_ms(kernel, reps),
        "plain_ms": timed_ms(plain, max(1, reps // 4)),
        "library_ms": timed_ms(library, reps),
    }
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    print(
        f"    kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
        f"library {row['library_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})",
        flush=True,
    )
    return row


def kernel_checks(dims) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, T, D, H = BATCH, dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head
    dh, L, n_mels = D // H, dims.n_text_layer, dims.n_mels
    rows = {}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    print("[kernels] log_mel (f32)", flush=True)
    audio = randn(B, N_SAMPLES, scale=0.1)
    padded = reflect_pad(audio).contiguous()
    window = torch.from_numpy(hann_window()).to(dev)
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

    def stft_mel():
        spec = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, return_complex=True)
        return torch.log10(torch.clamp(fb @ spec[..., :-1].abs().square(), min=1e-10))

    n_frames = N_SAMPLES // HOP_LENGTH
    rows["log_mel"] = {"f32": check_kernel(
        "log_mel", torch.float32,
        lambda: raw_log10_mel(padded, n_mels), lambda: raw_log10_mel_plain(padded, n_mels),
        stft_mel,
        nbytes=padded.numel() * 4 + B * n_mels * n_frames * 4 + (2 * N_FFT + n_mels) * 201 * 4,
        flops=B * n_frames * (2 * 2 * N_FFT * 201 + 2 * 201 * n_mels),
        reps=10,
    )}
    del audio, padded

    for name in ("ln_fused", "residual_ln", "encoder_attention_merged", "cross_attention_step"):
        rows[name] = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.tensor([], dtype=dtype).element_size()
        print(f"[kernels] LayerNorm pair ({tag})", flush=True)
        x, d = randn(B, T, D, dtype=dtype), randn(B, T, D, dtype=dtype)
        s, b = randn(D, dtype=dtype), randn(D, dtype=dtype)
        rows["ln_fused"][tag] = check_kernel(
            "ln_fused", dtype, lambda: ln_fused(x, s, b), lambda: ln_fused_plain(x, s, b),
            lambda: F.layer_norm(x, (D,), s, b, 1e-5),
            nbytes=2 * x.numel() * isz + 2 * D * isz, flops=8 * x.numel(), reps=20,
        )
        rows["residual_ln"][tag] = check_kernel(
            "residual_ln", dtype, lambda: residual_ln(x, d, s, b),
            lambda: residual_ln_plain(x, d, s, b),
            lambda: F.layer_norm(x + d, (D,), s, b, 1e-5),
            nbytes=4 * x.numel() * isz + 2 * D * isz, flops=9 * x.numel(), reps=20,
        )
        del x, d

        # unit-scale q and k: scores of std 1 after the d^-0.5 scale, so the
        # softmax is peaked and the Q.K part of the kernel matters
        print(f"[kernels] encoder_attention_merged ({tag})", flush=True)
        q, k, v = (randn(B, T, D, dtype=dtype) for _ in range(3))
        scale = dh**-0.5

        def sdpa():
            split = lambda t: t.view(B, T, H, dh).transpose(1, 2)
            return F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale)

        rows["encoder_attention_merged"][tag] = check_kernel(
            "encoder_attention_merged", dtype,
            lambda: encoder_attention_merged(q, k, v, H, scale),
            lambda: encoder_attention_merged_plain(q, k, v, H, scale),
            sdpa, nbytes=4 * q.numel() * isz, flops=4 * B * T * T * D,
            reps=3 if dtype == torch.float32 else 10,
        )
        del q, k, v

        print(f"[kernels] cross_attention_step ({tag})", flush=True)
        qx = randn(B, 1, H, dh, dtype=dtype, scale=scale)  # pre-scaled: scores of std 1
        kv = randn(L, B, H, 2, dh, T, dtype=dtype)
        layer = L - 1

        def sdpa_cross():
            kt, vt = kv[layer, :, :, 0], kv[layer, :, :, 1]
            return F.scaled_dot_product_attention(
                qx.transpose(1, 2), kt.transpose(-1, -2), vt.transpose(-1, -2), scale=1.0
            )

        rows["cross_attention_step"][tag] = check_kernel(
            "cross_attention_step", dtype,
            lambda: cross_attention_step(qx, kv, layer),
            lambda: cross_attention_step_plain(qx, kv, layer),
            sdpa_cross, nbytes=(B * H * 2 * dh * T + 2 * qx.numel()) * isz,
            flops=4 * B * H * dh * T, reps=20,
        )
        del qx, kv
        torch.cuda.empty_cache()
    return rows


def filter_config(dims):
    return FilterConfig(
        n_vocab=dims.n_vocab, token_id_eot=50256, token_id_space=220,
        token_id_ts_begin=50363, token_id_no_timestamps=50362, suppress_blank=True,
        timestamps=True, suppress_ids=(1, 2, 7), max_initial_timestamp_index=50,
    )


SOT, NO_SPEECH = 50257, 50361


def plain_margin(model, mel, row: int, tokens, pos: int, cfg) -> float:
    """Top-2 margin of the plain path's filtered logits for the token at
    ``pos`` of ``row``, from a full prefill of ``tokens[:pos]``."""
    xa = model.encoder(mel[row : row + 1], kernels=False)
    cache = KVCache.init(model.dims, 1, xa.dtype, xa.device)
    prefix = tokens[None, :pos]
    logits = model.decoder(
        prefix, 0, precompute_cross_kv(model, xa), cache,
        logit_positions=torch.tensor([pos - 1], device=xa.device), kernels=False,
    )
    filt = apply_filters(cfg, logits[:, 0], tokens[None], pos, 1)
    top = filt[0].topk(2).values
    return (top[0] - top[1]).item()


def parity(dims) -> None:
    print(f"[parity] {MODEL} full width, f32, {PARITY_WINDOWS} windows, {SAMPLE_LEN} steps",
          flush=True)
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    cfg = filter_config(dims)
    rng = np.random.default_rng(2)
    audio = np.stack([
        rng.standard_normal(480_000).astype(np.float32) * np.float32(0.05 * (i + 1))
        for i in range(PARITY_WINDOWS)
    ])
    initial = np.full((PARITY_WINDOWS, 1), SOT, np.int64)
    out = {}
    reset_launches()
    for kernels in (True, False):
        mel = log_mel_frontend(audio, dims.n_mels, kernels=kernels)
        first = _encode_and_prefill(
            model, mel, torch.as_tensor(initial, device="cuda"), 1, 0, 1, cfg,
            NO_SPEECH, None, kernels,
        )[1]
        res = decode_greedy(
            model, mel, initial, 1, 0, cfg, GreedyMode(), SAMPLE_LEN, NO_SPEECH,
            kernels=kernels,
        )
        out[kernels] = (mel, first, res)
        if kernels:
            print(f"  kernel-path launches: {dict(LAUNCHES)}", flush=True)
    torch.cuda.synchronize()

    (_, first_k, res_k), (mel_p, first_p, res_p) = out[True], out[False]
    if not torch.equal(torch.isfinite(first_k), torch.isfinite(first_p)):
        raise AssertionError("first-step filtered logits: masks differ")
    fin = torch.isfinite(first_p)
    d = (first_k[fin] - first_p[fin]).abs().max().item()
    print(f"  first-step filtered logits: max_abs_err {d:.3e} (tolerance 1e-3)", flush=True)
    if d > 1e-3:
        raise AssertionError("first-step filtered logits differ beyond 1e-3")
    dn = (res_k.no_speech_probs - res_p.no_speech_probs).abs().max().item()
    print(f"  no-speech probs: max_abs_err {dn:.3e} (tolerance 1e-5)", flush=True)
    if dn > 1e-5:
        raise AssertionError("no-speech probabilities differ beyond 1e-5")

    tk, tp = res_k.candidates[:, 0], res_p.candidates[:, 0]
    for r in range(PARITY_WINDOWS):
        diff = (tk[r] != tp[r]).nonzero()
        n_tok = int((tp[r] != 0).sum())
        if diff.numel() == 0:
            print(f"  row {r}: {n_tok} tokens, identical", flush=True)
            continue
        pos = int(diff[0])
        margin = plain_margin(model, mel_p, r, tp[r], pos, cfg)
        print(f"  row {r}: diverges at position {pos}; plain top-2 margin {margin:.3e}",
              flush=True)
        if margin >= 1e-3:
            raise AssertionError(f"row {r} diverges at {pos} with margin {margin:.3e} >= 1e-3")
    del model
    torch.cuda.empty_cache()


def e2e(dims) -> dict:
    print(f"[e2e] {MODEL} bf16 batch {BATCH}, {SAMPLE_LEN}-step budget, {E2E_REPS} timed runs",
          flush=True)
    model = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")
    cfg = filter_config(dims)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((BATCH, 480_000)).astype(np.float32) * np.float32(0.1)
    initial = np.full((BATCH, 1), SOT, np.int64)

    def run(a):
        mel = log_mel_frontend(a, dims.n_mels, dtype=torch.bfloat16)
        res = decode_greedy(model, mel, initial, 1, 0, cfg, GreedyMode(), SAMPLE_LEN, NO_SPEECH)
        torch.cuda.synchronize()
        return res

    run(audio + np.float32(0.001))  # warm-up: Triton compile, cuBLAS set-up
    times = []
    for _ in range(E2E_REPS):
        reset_launches()
        t0 = time.perf_counter()
        res = run(audio)
        times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        # the one-token prefill is a decoder step of width 1, so it takes
        # the cross kernel too
        n_steps = res.steps + 1
        expect = {
            "log_mel": 1,
            "ln_fused": dims.n_audio_layer,
            "residual_ln": dims.n_audio_layer,
            "encoder_attention_merged": dims.n_audio_layer,
            "cross_attention_step": dims.n_text_layer * n_steps,
        }
        if res.steps < 1 or launches != expect:
            raise AssertionError(f"e2e: launches {launches}, expected {expect}")

    cand = res.candidates[:, 0]
    if cand.shape != (BATCH, dims.n_text_ctx) or not torch.isfinite(res.scores).all():
        raise AssertionError("e2e: malformed decode result")
    if not ((cand[:, 0] == SOT).all() and (cand[:, 1] >= cfg.token_id_ts_begin).all()):
        raise AssertionError("e2e: prompt or forced first timestamp missing")
    if not (0 <= res.no_speech_probs).all() or not (res.no_speech_probs <= 1).all():
        raise AssertionError("e2e: no-speech probabilities outside [0, 1]")
    elapsed = float(np.median(times))
    print(f"  steps {res.steps}; runs {', '.join(f'{t:.3f}' for t in times)} s; "
          f"median {elapsed:.3f} s, {BATCH * 30.0 / elapsed:.2f} audio-s/s", flush=True)
    print(f"  launches of each run: {launches}", flush=True)
    print(f"  cross_attention_step: {launches['cross_attention_step'] / n_steps:g} a step "
          f"over {n_steps} width-1 decoder passes", flush=True)

    # split of the run: the frontend and encoder alone, the rest is the
    # prefill and the step loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.encoder(log_mel_frontend(audio, dims.n_mels, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    print(f"  split: mel+encoder {t_enc:.3f} s; prefill+steps {elapsed - t_enc:.3f} s "
          f"({(elapsed - t_enc) / n_steps * 1e3:.2f} ms a decoder pass)", flush=True)
    profile_run(run, audio)
    return launches


# substrings of the device kernel names of the port's own kernels
OWN_KERNELS = {
    "log_mel_kernel": "log_mel",
    "layer_norm_rows": "ln_fused/residual_ln",
    "attn_bf16_kernel": "encoder_attention_merged",
    "cross_attn_kernel": "cross_attention_step",
}


def device_kind(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return f"port kernel: {label}"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "library: matmul"
    if any(s in low for s in ("reduce", "softmax", "argmax")):
        return "library: reductions/softmax"
    if any(s in low for s in ("memcpy", "copy", "cat", "index", "scatter", "gather")):
        return "library: copies/indexing"
    return "library: elementwise/other"


def profile_run(run, audio) -> None:
    """One more run of the e2e batch under torch.profiler: its wall time, its
    device busy time (the sum of kernel durations; one stream, so kernels do
    not overlap) and idle share, device time by kind, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(audio)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events, less the profiler's own buffer bookkeeping
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "Activity Buffer Request"
    ]
    if not events:
        print("[profile] the trace holds no device time: not measured", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] one e2e run under torch.profiler: wall {wall_ms:.1f} ms; "
          f"device busy {busy_ms:.1f} ms; idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    by_kind: dict = {}
    for e in events:
        t, n = by_kind.get(device_kind(e.key), (0.0, 0))
        by_kind[device_kind(e.key)] = (t + e.self_device_time_total, n + e.count)
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:40s} {t / 1e3:9.2f} ms {n:7d} launches")
    print("  top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")


KERNELS = {
    "log_mel": ("cuda", "whisper_rs_tpu_torch/csrc/mel.cu",
                "whisper_rs_tpu/ops/mel_pallas.py:129"),
    "ln_fused": ("triton", "whisper_rs_tpu_torch/csrc/layer_norm.py",
                 "whisper_rs_tpu/ops/encoder_fused.py:99"),
    "residual_ln": ("triton", "whisper_rs_tpu_torch/csrc/layer_norm.py",
                    "whisper_rs_tpu/ops/encoder_fused.py:70"),
    "encoder_attention_merged": ("cuda", "whisper_rs_tpu_torch/csrc/encoder_attention.cu",
                                 "whisper_rs_tpu/ops/encoder_attention_pallas.py:139"),
    "cross_attention_step": ("cuda", "whisper_rs_tpu_torch/csrc/cross_attention.cu",
                             "whisper_rs_tpu/ops/decode_attention.py:748"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[device] {card} | torch: {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall, per source "
          f"{ {k: round(v, 1) for k, v in built.items()} }", flush=True)

    dims = dims_for(MODEL)
    rows = kernel_checks(dims)
    parity(dims)
    launches = e2e(dims)

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name].get("bf16", rows[name].get("f32"))
        line.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "atol": r["atol"], "rtol": r["rtol"], "tol_share": r["tol_share"],
            "max_abs_err_f32": rows[name]["f32"]["max_abs_err"],
            "dtype": "bf16" if "bf16" in rows[name] else "f32",
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
