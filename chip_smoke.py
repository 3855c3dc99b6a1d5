"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Two configurations of the main path: base.en at batch 128 and large-v3 at
batch 12 (full width and depth: 128 mel bins, D 1280, 20 heads, 32 + 32
layers, vocab 51866), seeded random weights, unprompted, 224-token budget.
Phases, in order; any mismatch raises and the script exits nonzero:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once); the seconds are printed;
  3. kernels  each kernel wrapper at the shapes each configuration's main
              path gives it, against its plain PyTorch version: at base.en
              b128 in f32 and bf16 (mel: f32 only, 80 bins); at large-v3 b12
              mel (f32, 128 bins) and the rest in bf16, the two step kernels
              in f32 too.  Printed: max abs/rel error against the kernel's
              tolerance, kernel ms, plain ms, bound ms (the larger of bytes
              over 3.35 TB/s and operations over the peak rate of their type)
              and library ms (one PyTorch call for the same function, timed
              only as a yardstick).  Calls shorter than a millisecond are
              timed as CUDA graphs of many calls, so the host's launch time
              stays out of the device time;
  4. parity   base.en at full width, and large-v3 at full width with the depth
              cut to 4 + 4 layers, seeded weights, 4 seeded 30 s windows,
              log_mel_frontend -> decode_greedy (224 steps) in f32 through
              the kernels and through the plain versions: first-step
              filtered logits within 1e-3, tokens equal per row unless the
              plain path's top-2 margin at the first divergent step is below
              1e-3;
  5. e2e      each configuration in bf16, timed 3 times, with every launch
              count set to 0 just before each run and read just after: each
              kernel launched as expected (cross attention n_text_layer times
              a width-1 decoder pass, the append self-attention and the fused
              MLP n_text_layer times an incremental step); audio-s/s of the
              median run, and the mel+encoder / prefill+steps split;
  6. profile  one more e2e run of each under torch.profiler: its idle share
              and where its device time goes;
  7. the kernels line (JSON), the card line, and last the contract line.

Every phase prints its seconds.  Exits nonzero, printing no result, where
CUDA is absent.
"""

from __future__ import annotations

import dataclasses
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
    self_attention_append_step,
    self_attention_append_step_plain,
)
from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step, decoder_mlp_step_plain
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
CONFIGS = (("base.en", 128), ("large-v3", 12))  # (model, batch) of the main path
PARITY_DEPTH = {"large-v3": 4}  # encoder and decoder layers kept in the parity phase
SAMPLE_LEN = 224
PARITY_WINDOWS = 4
E2E_REPS = 3
STEP_WINDOW = 256  # the append kernel is timed at W = 256, pos = W - 1
# (atol, rtol) of |kernel - plain| <= atol + rtol |plain|.  In bf16 the rtol
# covers one bf16 ulp of the output (2^-7 relative) where the two round an
# f32 value on either side of a boundary.  The attention atol covers the
# bf16 rounding of the softmax weights and stays well under the output's
# typical size (~0.04) at the unit-scale inputs of kernel_checks, so a
# dropped key tile or a wrong Q.K weighting fails.  The append attention
# keeps its weights f32 (no rounding of its own) and takes the attention
# tolerance; the MLP's error is the last bf16 rounding of its output, one
# ulp (2^-8 relative) where the two sums land on either side of a boundary,
# and a GELU value rounded on the other side now and then.
TOL_F32 = (1e-4, 1e-4)
TOL_BF16 = {
    "ln_fused": (1e-3, 1e-2),
    "residual_ln": (1e-3, 1e-2),
    "encoder_attention_merged": (2e-3, 1e-2),
    "cross_attention_step": (2e-3, 1e-2),
    "self_attention_append_step": (2e-3, 1e-2),
    "decoder_mlp_step": (1e-3, 1e-2),
}


def tolerance(name: str, dtype) -> tuple:
    return TOL_F32 if dtype == torch.float32 else TOL_BF16[name]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int, graph: bool = False) -> float:
    """Mean ms per call on the card, CUDA events around ``reps`` calls after
    one warm-up call.  With ``graph`` the calls are captured once as a CUDA
    graph and the events time one replay, so the host's time per call
    (Python, argument checks, launch) is not counted."""
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, reps_run = g.replay, 1
    else:
        reps_run = reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps_run):
        run()
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


def check_kernel(name, dtype, kernel, plain, library, nbytes, flops, reps, graph=True,
                 checked=None):
    """Compare the kernel with its plain version (or take ``checked``, the
    (max abs error, tolerance share) of a comparison made by the caller),
    then time the kernel, the plain version and the library call."""
    tol = tolerance(name, dtype)
    if checked is None:
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        checked = compare(f"{name} {str(dtype).split('.')[-1]}", got, want, tol)
    err, share = checked
    row = {
        "max_abs_err": err,
        "atol": tol[0],
        "rtol": tol[1],
        "tol_share": share,
        "ms": timed_ms(kernel, reps, graph),
        "plain_ms": timed_ms(plain, max(1, reps // 4), graph),
        "library_ms": timed_ms(library, reps, graph),
    }
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    print(
        f"    kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
        f"library {row['library_ms']:.4f} ms | bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})",
        flush=True,
    )
    return row


def kernel_checks(dims, B: int, dtypes) -> dict:
    """Every kernel at the shapes of ``dims`` at batch ``B``: the encoder
    and cross kernels in ``dtypes``, mel in f32, the two step kernels in f32
    and bf16.  Returns {kernel: {"f32" | "bf16": row}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    T, D, H = dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head
    dh, L, n_mels = D // H, dims.n_text_layer, dims.n_mels
    rows = {name: {} for name in KERNELS}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    print(f"[kernels] log_mel ({n_mels} bins, f32)", flush=True)
    audio = randn(B, N_SAMPLES, scale=0.1)
    padded = reflect_pad(audio).contiguous()
    window = torch.from_numpy(hann_window()).to(dev)
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

    def stft_mel():
        spec = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, return_complex=True)
        return torch.log10(torch.clamp(fb @ spec[..., :-1].abs().square(), min=1e-10))

    n_frames = N_SAMPLES // HOP_LENGTH
    rows["log_mel"]["f32"] = check_kernel(
        "log_mel", torch.float32,
        lambda: raw_log10_mel(padded, n_mels), lambda: raw_log10_mel_plain(padded, n_mels),
        stft_mel,
        nbytes=padded.numel() * 4 + B * n_mels * n_frames * 4 + (2 * N_FFT + n_mels) * 201 * 4,
        flops=B * n_frames * (2 * 2 * N_FFT * 201 + 2 * 201 * n_mels),
        reps=10, graph=False,
    )
    del audio, padded

    for dtype in dtypes:
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
            reps=3 if dtype == torch.float32 else 10, graph=False,
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

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] self_attention_append_step ({tag})", flush=True)
        rows["self_attention_append_step"][tag] = check_append(dims, B, dtype, randn)
        print(f"[kernels] decoder_mlp_step ({tag})", flush=True)
        rows["decoder_mlp_step"][tag] = check_mlp(dims, B, dtype, randn)
        torch.cuda.empty_cache()
    return rows


def check_append(dims, B: int, dtype, randn) -> dict:
    """The append self-attention at the step shapes: q, k_new, v_new
    [B, H, 64] (q pre-scaled, unit-scale scores), caches [L, B, H, 448, 64]
    of unit-scale values.  Checked at W = 256, pos = 255 and at W = 448
    with non-zero key_start, both outputs against the plain version and
    both caches: the kernel's slot pos equals k_new and v_new, and no other
    slot changed.  Timed at W = 256, pos = 255."""
    H, dh, L, n_ctx = dims.n_text_head, dims.head_dim, dims.n_text_layer, dims.n_text_ctx
    isz = torch.tensor([], dtype=dtype).element_size()
    layer = L - 1
    q = randn(B, H, dh, dtype=dtype, scale=dh**-0.5)
    k_new, v_new = randn(B, H, dh, dtype=dtype), randn(B, H, dh, dtype=dtype)
    k_all, v_all = randn(L, B, H, n_ctx, dh, dtype=dtype), randn(L, B, H, n_ctx, dh, dtype=dtype)
    ks_nonzero = torch.arange(B, device=q.device) * 37 % 299 + 1  # in 1..299
    tol = tolerance("self_attention_append_step", dtype)
    tag = str(dtype).split(".")[-1]
    worst = (0.0, 0.0)
    for W, pos, ks in ((STEP_WINDOW, STEP_WINDOW - 1, None), (n_ctx, 400, ks_nonzero)):
        before = (k_all.clone(), v_all.clone())
        plain_caches = (k_all.clone(), v_all.clone())
        got = self_attention_append_step(q, k_new, v_new, k_all, v_all, layer, pos, ks, window=W)
        want = self_attention_append_step_plain(
            q, k_new, v_new, *plain_caches, layer, pos, ks, window=W
        )
        err = compare(f"self_attention_append_step {tag} W {W} pos {pos}"
                      f"{' key_start 1..299' if ks is not None else ''}", (got,), (want,), tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        for cache, new, old, plain in zip((k_all, v_all), (k_new, v_new), before, plain_caches):
            if not torch.equal(cache[layer, :, :, pos], new):
                raise AssertionError("self_attention_append_step: slot pos is not k_new/v_new")
            cache_rest, old_rest = cache.clone(), old.clone()
            cache_rest[layer, :, :, pos] = 0
            old_rest[layer, :, :, pos] = 0
            if not torch.equal(cache_rest, old_rest) or not torch.equal(cache, plain):
                raise AssertionError("self_attention_append_step: a slot other than pos changed")
        del before, plain_caches
    print("  cache write: slot pos equals k_new and v_new exactly; no other slot changed",
          flush=True)

    W, pos = STEP_WINDOW, STEP_WINDOW - 1
    ids = torch.arange(W, device=q.device)
    mask = (ids <= pos)[None, None, None, :].expand(B, 1, 1, W)

    def sdpa():  # the attention alone, over the window, without the write
        return F.scaled_dot_product_attention(
            q[:, :, None], k_all[layer, :, :, :W], v_all[layer, :, :, :W], attn_mask=mask,
            scale=1.0,
        )

    n = pos + 1  # visible slots of every row
    return check_kernel(
        "self_attention_append_step", dtype,
        lambda: self_attention_append_step(q, k_new, v_new, k_all, v_all, layer, pos, window=W),
        lambda: self_attention_append_step_plain(
            q, k_new, v_new, k_all, v_all, layer, pos, window=W
        ),
        sdpa, nbytes=(2 * B * H * n * dh + 6 * B * H * dh) * isz, flops=4 * B * H * n * dh,
        reps=50, checked=worst,
    )


def check_mlp(dims, B: int, dtype, randn) -> dict:
    """The fused decode MLP at the step shapes: unit-scale h [B, D],
    weights N(0, 1/n_in) as in init_random, b1 N(0, 0.1^2)."""
    D = dims.n_text_state
    isz = torch.tensor([], dtype=dtype).element_size()
    h = randn(B, D, dtype=dtype)
    w1 = randn(4 * D, D, dtype=dtype, scale=D**-0.5)
    b1 = randn(4 * D, dtype=dtype, scale=0.1)
    w2 = randn(D, 4 * D, dtype=dtype, scale=(4 * D) ** -0.5)
    approximate = "none" if dtype == torch.float32 else "tanh"

    def three_calls():  # F.linear -> F.gelu -> F.linear
        return F.linear(F.gelu(F.linear(h, w1, b1), approximate=approximate), w2)

    return check_kernel(
        "decoder_mlp_step", dtype,
        lambda: decoder_mlp_step(h, w1, b1, w2), lambda: decoder_mlp_step_plain(h, w1, b1, w2),
        three_calls, nbytes=(8 * D * D + 4 * D + 2 * B * D) * isz, flops=16 * B * D * D,
        reps=50,
    )


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


def parity(dims, label: str) -> None:
    print(f"[parity] {label}, f32, {PARITY_WINDOWS} windows, {SAMPLE_LEN} steps", flush=True)
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


def e2e(dims, name: str, batch: int) -> dict:
    print(f"[e2e] {name} bf16 batch {batch}, {SAMPLE_LEN}-step budget, {E2E_REPS} timed runs",
          flush=True)
    t0 = time.perf_counter()
    model = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")
    print(f"  init_random {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = filter_config(dims)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((batch, 480_000)).astype(np.float32) * np.float32(0.1)
    initial = np.full((batch, 1), SOT, np.int64)

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
        # the one-token prefill is a decoder pass of width 1, so it takes
        # the cross kernel too, but not the two incremental-step kernels
        n_steps = res.steps + 1
        expect = {
            "log_mel": 1,
            "ln_fused": dims.n_audio_layer,
            "residual_ln": dims.n_audio_layer,
            "encoder_attention_merged": dims.n_audio_layer,
            "cross_attention_step": dims.n_text_layer * n_steps,
            "self_attention_append_step": dims.n_text_layer * res.steps,
            "decoder_mlp_step": dims.n_text_layer * res.steps,
        }
        if res.steps < 1 or launches != expect:
            raise AssertionError(f"e2e: launches {launches}, expected {expect}")

    cand = res.candidates[:, 0]
    if cand.shape != (batch, dims.n_text_ctx) or not torch.isfinite(res.scores).all():
        raise AssertionError("e2e: malformed decode result")
    if not ((cand[:, 0] == SOT).all() and (cand[:, 1] >= cfg.token_id_ts_begin).all()):
        raise AssertionError("e2e: prompt or forced first timestamp missing")
    if not (0 <= res.no_speech_probs).all() or not (res.no_speech_probs <= 1).all():
        raise AssertionError("e2e: no-speech probabilities outside [0, 1]")
    elapsed = float(np.median(times))
    print(f"  steps {res.steps}; runs {', '.join(f'{t:.3f}' for t in times)} s; "
          f"median {elapsed:.3f} s, {batch * 30.0 / elapsed:.2f} audio-s/s", flush=True)
    print(f"  launches of each run: {launches}", flush=True)
    print(f"  cross_attention_step: {launches['cross_attention_step'] / n_steps:g} a pass "
          f"over {n_steps} width-1 decoder passes; the append and MLP kernels "
          f"{launches['decoder_mlp_step'] / res.steps:g} a step over {res.steps} steps",
          flush=True)

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
    del model
    torch.cuda.empty_cache()
    return launches


# substrings of the device kernel names of the port's own kernels
OWN_KERNELS = {
    "log_mel_kernel": "log_mel",
    "layer_norm_rows": "ln_fused/residual_ln",
    "attn_bf16_kernel": "encoder_attention_merged",
    "cross_attn_kernel": "cross_attention_step",
    "self_append_kernel": "self_attention_append_step",
    "mlp_fc1_gelu_kernel": "decoder_mlp_step (fc1 + GELU)",
    "mlp_fc2_kernel": "decoder_mlp_step (fc2)",
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
    "self_attention_append_step": ("cuda", "whisper_rs_tpu_torch/csrc/self_attention.cu",
                                   "whisper_rs_tpu/ops/decode_attention.py:525"),
    "decoder_mlp_step": ("cuda", "whisper_rs_tpu_torch/csrc/decoder_mlp.cu",
                         "whisper_rs_tpu/ops/decoder_mlp_fused.py:121"),
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

    def phase_done(phase: str, t0: float) -> None:
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s", flush=True)

    rows, launches = {}, {}
    for m, b in CONFIGS:
        t0 = time.perf_counter()
        dtypes = (torch.float32, torch.bfloat16) if m == "base.en" else (torch.bfloat16,)
        rows[m] = kernel_checks(dims_for(m), b, dtypes)
        phase_done(f"kernels {m} b{b}", t0)
    for m, _ in CONFIGS:
        t0 = time.perf_counter()
        dims, label = dims_for(m), f"{m} full width"
        if m in PARITY_DEPTH:
            n = PARITY_DEPTH[m]
            dims = dataclasses.replace(dims, n_audio_layer=n, n_text_layer=n)
            label += f", depth cut to {n} + {n} layers (dataclasses.replace: {dims})"
        parity(dims, label)
        phase_done(f"parity {m}", t0)
    for m, b in CONFIGS:
        t0 = time.perf_counter()
        launches[m] = e2e(dims_for(m), m, b)
        phase_done(f"e2e {m} b{b}", t0)

    main_model = CONFIGS[-1][0]  # large-v3 b12: the slice's flagship path
    line = []
    for name, (route, source, replaces) in KERNELS.items():
        by_config = {}
        for m, b in CONFIGS:
            r = rows[m][name].get("bf16", rows[m][name].get("f32"))
            by_config[f"{m} b{b}"] = {
                "dtype": "bf16" if "bf16" in rows[m][name] else "f32",
                "launches": launches[m][name],
                **{k: r[k] for k in ("max_abs_err", "atol", "rtol", "tol_share", "ms",
                                     "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "f32": {k: v for k, v in rows[m][name].get("f32", {}).items()
                        if k in ("max_abs_err", "tol_share", "ms", "plain_ms", "bound_ms",
                                 "library_ms")},
            }
        main = by_config[f"{main_model} b{CONFIGS[-1][1]}"]
        line.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "config": f"{main_model} b{CONFIGS[-1][1]}",
            **{k: main[k] for k in ("launches", "max_abs_err", "atol", "rtol", "tol_share",
                                    "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "by_config": by_config,
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
