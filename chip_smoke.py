"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Eight paths, seeded random weights: greedy decode of base.en at batch 128
and of large-v3 at batch 12 (full width and depth: 128 mel bins, D 1280, 20
heads, 32 + 32 layers, vocab 51866), unprompted, 224-token budget; beam
search (beam 5, patience 1.0) of medium.en at batch 8 (full width and
depth: 80 mel bins, D 1024, 16 heads, 24 + 24 layers, vocab 51864; 40
decoder rows), prompted as bench.py's BENCH_PROMPTED builds its prompts
(232-wide prefill, window phases 256 and 448, the 224-token budget capped
by the context at 216 steps); greedy decode of medium.en at batch 8,
prompted the same way, through each of the incremental step's three
routes (``decode_greedy(step_kernel=...)``): ``layer``, the whole decoder
step in one launch of the megakernel; ``ctx``, torch's column write and
the read-only fused self-attention; ``append``, the default; and the two
int8 paths (``INT8_PATHS``): base.en b128 greedy, unprompted, with int8
weights (``quantize_params``) and int8 K/V (``quantize_kv=True``), whose
steps read the cache through row 10 (``self_attention_step``) and the
cross kernel's int8 branch; and medium.en b8 beam 5, prompted, with int8
K/V and bf16 weights (the beam kernel's and the cross kernel's int8
branches, the MLP kernel); and two transcription paths, files through
``TranscribeTask`` and ``DecodeTask`` with the vendored GPT-2 tokenizer:
the golden test's dims (``GOLDEN_DIMS``: D 64, 4 heads, head dim 16, whose
encoder splits heads for row 6, ``encoder_attention_split``, and whose
steps run the step, cross and MLP kernels' head-dim-16 and D-64
instances), and the slice's main path, base.en
at full width and depth with ``TranscribeOptions()`` defaults (beam 5,
timestamps, conditioned on the previous text) over a seeded 95 s file;
and the CLI's transcription path with OpenAI's recipe, base.en at full
width and depth: the temperature fallback ladder (beam 5 at rung 0,
best-of-5 sampling with the JAX package's threefry noise above it), the
no-speech threshold and word timestamps, over a seeded FLAC file read back
by the port's ``load_audio``, through ``TranscribeTask`` and through
``cli.main`` (``--batch 2``, ``--format srt``) on a seeded OpenAI-format
checkpoint written by the script (base.en's width, its depth cut to
CLI_DEPTH + CLI_DEPTH layers); the serving engine (``ServingEngine``,
continuous batching at batch 4) at base.en; base.en b128 greedy with int8
weights and K/V under the int8×int8 matmuls (``WHISPER_INT8_MATMUL=1``);
and the evaluation tools (``tools.validate_checkpoint``, ``tools.eval_wer``)
on a synthetic split; and the parallel layer (``parallel``): base.en on two
ranks that share the card through gloo, tensor, sequence (Ulysses),
pipeline and data parallel, the TP 2 serving engine, TP 1 on NCCL and the
command line under torchrun.
Phases, in order; any mismatch raises and the script exits nonzero:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc builds every CUDA kernel from csrc/ (one process per
              source, all at once); the seconds are printed, each
              kernel's registers and spills as ptxas reported them (each
              instance of rows 2, 3, 7 and 9-12, a summary for the rest), and
              the whole-step kernel's tensor-core instructions in its
              SASS (cuobjdump);
  3. rng      the sampler's noise (decode/rng.py) on the card against the
              CPU at [5, 51865]: keys, bits and uniforms bit for bit, the
              Gumbel noise within GUMBEL_ULPS ulps, the drawn tokens equal;
              the draw's device launches and wall ms a call;
  4. kernels  each kernel wrapper at the shapes each path gives it, against
              its plain PyTorch version: at base.en b128 in f32 and bf16
              (mel: f32 only, 80 bins); at large-v3 b12 and medium.en b8
              mel (f32) and the encoder kernels in bf16; the cross kernel
              (G = 5 rows an audio on the beam path) and the step kernels
              in f32 and bf16 everywhere: the append self-attention on the
              greedy paths, the beam self-attention on the beam path; on
              the routes' path the fused self-attention, the cross kernel
              and the MLP at 8 rows, and the whole-step kernel (f32 at full
              depth, bf16 at LAYER_BF16_DEPTH layers, there also at 16 rows
              and at 8 rows of one audio, and bit-identical call to call;
              beside its time the layered step's as a CUDA graph).  Printed: max abs/rel error
              against the kernel's tolerance, kernel ms, plain ms, bound ms
              (the larger of bytes over 3.35 TB/s and operations over the
              peak rate of their type) and library ms (one PyTorch call for
              the same function, timed only as a yardstick; none for the
              whole step, which also prints the mean time of each of its
              eight phases from one launch with its phase clock).  Calls
              shorter than a millisecond are timed as CUDA graphs of many
              calls, so the host's launch time stays out of the device
              time.  The beam path also times its per-step candidate
              ranking (a stable sort over the vocab).  The int8 paths: row 10
              with int8 scales and over a bf16 cache at base.en b128 and
              large-v3 b12, over the int8 cache also with its column write
              (k_new, v_new: the int8 column and scales it writes must
              equal quantize_kv's exactly; timed so, beside its read-only
              call and the torch column write), the cross kernel's int8 branch at both int8
              paths' shapes (G = 1 and 5), the beam kernel's int8 read at
              the beam shapes; their library call is the dequantising
              multiply and SDPA as one CUDA graph (the beam's after a
              gather of the ancestors' rows and scales).  The transcription
              paths: row 6 at SPLIT_SHAPES (base.en b128, large-v3 b12's
              Ulysses per-card shape, the golden dims) in f32 and bf16,
              with n_valid < T checked, its library call SDPA on the same
              split tensors and on the heads of merged [B, T, D] tensors
              (views); on the golden-dims path the mel kernel on a 35 s
              file's two overlapping chunks, the LayerNorm pair at D 64, and
              every step kernel's head-dim-16 instance (the cross kernel at 1
              and 3 rows an audio, the append and beam kernels, the MLP at D
              64; off the path, the fused and read-only steps and the int8
              branches); on the main path every kernel at base.en batch 1,
              beam 5, and the mel kernel on the 95 s file's 4 chunks;
              row 4 is also compared with n_valid < T; rows 7, 9 (and
              9's int8 branch), 10 and 11 also with one row's (audio's)
              key_start past pos, an empty window, and their launch plan
              is kept; rows 1, 4, 5 (bf16 and int8), 6, 7, 8, 9 (bf16 and
              int8), 10 (both caches) and 11 in bf16 are called twice on
              the same inputs and must give bit-identical outputs; row 5 is also
              checked at 4 audios of 10 rows (medium.en beam 10), past one
              chunk of rows; row 8 is timed hot and cold in L2 (rotating
              through n_text_layer weight sets, its library call the same
              way) and checked at 129 rows of base.en, past its widest
              batch tile; the recipe's sampling rungs (the cross kernel at
              greedy A 1, G 5, the append kernel at 5 rows with a
              key_start a row, the MLP at 5 rows) and the CLI's --batch 2
              (every kernel at base.en batch 2, beam 5, and the append
              kernel at 10 rows); the serving engine's (every kernel at
              base.en batch 4, beam 5: the cross and beam kernels at A 4,
              G 5, the MLP at 20 rows; the append kernel at 20 rows); the
              LayerNorm pair at every path's decoder rows (LN_STEP_ROWS,
              [rows, 1, D]) and at one prefill's (LN_PREFILL), f32 and
              bf16, row 3 bit-identical call to call;
  5. parity   f32, 4 seeded 30 s windows, through the kernels and through
              the plain versions: base.en at full width, and large-v3 at
              full width with the depth cut to 4 + 4 layers, log_mel_frontend
              -> decode_greedy (224 steps): first-step filtered logits within
              1e-3, tokens equal per row unless the plain path's top-2 margin
              at the first divergent step is below 1e-3; medium.en cut to
              4 + 4 layers, prompted, log_mel_frontend -> decode_beam (beam
              5): the filtered logits of the steps at positions 233, 255,
              256 and 400, plain against kernel on the kernel path's state,
              within 1e-3; candidates equal, scores within 1e-4 +
              2e-6|plain| and no-speech probabilities within 1e-5, unless
              the plain path's selection margin (the beam-th unfinished
              candidate's score less the next one's) of that audio fell
              below 1e-3 at some step; medium.en cut to 4 + 4 layers,
              prompted, decode_greedy through the layer and ctx routes: the
              same four steps' filtered logits within 1e-3, tokens equal per
              row unless the plain path's top-2 margin at the first
              divergent position is below 1e-3; the int8 paths, base.en at
              full width (greedy, INT8_GREEDY_CHECK_POS) and medium.en beam
              cut to 4 + 4 layers, the same checks at INT8_LOGIT_TOL, with
              the int8 values of each checked step's column that the two
              paths rounded apart counted; on that beam path, whose two
              runs drift apart through such values, every ranking of the
              kernel path is also held on its own state to the plain
              step's (the same candidates in the same order unless a plain
              gap there is below INT8_LOGIT_TOL), and candidates that
              differ at the end pass only where all of them held; the
              golden-dims transcription,
              f32, through the kernels and through the plain versions:
              TranscribeTask greedy (sample_len 16) over a 35 s file and
              DecodeTask beam 3, unprompted and prompted, each window's
              tokens equal and avg_logprobs within 1e-3 (unless the plain
              path's margin fell below 1e-3, where comparing stops), then
              the segments; row 6 launched n_audio_layer times an encoder
              call, row 4 never, the cross, MLP and append (greedy) or beam
              kernels n_text_layer times a step;
  6. e2e      each path in bf16 (weights drawn on the card, e2e_model),
              timed 3 times (large-v3, the ctx and the
              append routes once each, E2E_REPS_CUT), after a 4-token
              warm-up run and a first call that captures (timed apart),
              with every launch count set to 0 just before each run and
              read just after: each kernel launched as expected
              (row 3 n_audio_layer + 1 times an encoder call and
              3 n_text_layer + 1 times a prefill or a layered step, once a
              layer-route step: every LayerNorm of the model, ln_launches;
              cross attention n_text_layer times a width-1 decoder pass,
              the step self-attention and the fused MLP n_text_layer times
              an incremental step, the beam kernel and never the append
              kernel on the beam path; on the layer route the whole-step
              kernel once a step and none of the layered step's kernels;
              on the int8 paths row 10 or the beam kernel once a layer a
              step, never the append, fused or whole-step kernels, and no
              MLP kernel under int8 weights);
              audio-s/s of the median run, and the mel+encoder / prefill /
              steps split; the beam path prints each audio's selected
              candidate; on every path, one incremental step (a replay of
              the captured body; on the routes' path each route's) under
              torch.profiler gives its device launches a step, and each
              profiled run its torch MeanOps launches (2 a plain
              LayerNorm: 0 expected); on the int8-weight path, the device time of one step's
              int8 weight casts alone.  Then the main transcription path:
              the whole-file mel through row 1 against its plain version;
              f32 on the file's first TRANSCRIBE_PARITY_SECONDS through
              the kernels against the plain versions, window
              by window as above, with the kernel run's launch counts
              checked; bf16 through the kernels, timed
              (E2E_REPS_CUT), each run's launch counts checked (every
              kernel of the path, and no other), audio-s/s, windows,
              ms a step; one window under torch.profiler (launches, idle
              share).  Then OpenAI's recipe (transcribe_recipe): f32 at
              RECIPE_PARITY_DEPTH + RECIPE_PARITY_DEPTH layers through the
              kernels against the plain versions call by call
              (each rung of each window; tokens equal unless the plain
              margin, for a sampling rung the top-2 gap of logits / T +
              noise times T, is below 1e-3), then the segments and each
              word (text equal, times within WORD_TIME_TOL), the launch
              counts of the kernel run; bf16 timed, its launch counts
              checked, with windows, the rungs of each, steps by rung
              kind, the draw's cost and the alignment pass's ms a window;
              it fails where no window sampled.  Then the CLI (cli_phase):
              --batch 2 on a WAV and a FLAC with the recipe and --json,
              exit 0, one entry a file, every kernel of the path launched;
              --format srt for one file, well-formed cues.  Then the serving
              engine (serve_phase): bf16, six requests, four at once and two
              from a second client thread, every call of 4 rows, a round
              holding a late request beside an early one, stats and
              launch counts checked, audio-s/s, latency p50/p95, ms a step;
              f32 with a two-rung ladder, each call replayed through the
              plain path and each request held to the sequential
              TranscribeTask on the card (compare_calls).  Then the
              int8×int8 matmuls (int8_matmul_phase): the int8 linear
              bit-equal to its plain version at base.en's shapes (M <= 16
              too), timed beside _int_mm, the cast-and-matmul and F.linear;
              the int8 path with the switch on, f32 parity at full depth and
              bf16 timed and profiled beside the path without it.  Then the
              evaluation tools (eval_phase): validate_checkpoint exits 3 with
              the JAX tool's verdict keys, eval_wer exits 0 with a WER.  Then
              the parallel layer (parallel_phase; its kernels at their
              sharded shapes in the kernels phase, kernel_checks_parallel):
              two ranks (run_ranks, gloo, on the one card), f32 greedy
              base.en b8 on TP 2, Ulysses 2, PP 2 and DP 2 against the
              single-process kernel path (encoder output, tokens by the
              margin rule, each rank's launches), the bf16 TP 2 serving
              engine against the unsharded sequential task (compare_calls),
              TP 1 on a one-card NCCL group against the unsharded model,
              and the CLI under torchrun (--tp 2 --dist-backend gloo)
              against the unsharded CLI; each path's launches, collectives
              a step, bytes staged and ms a step;
  7. profile  one more e2e run of each under torch.profiler (the first three
              paths cut to PROFILE_STEPS tokens, which keeps the trace's
              processing short; the layer route in full; the trace read
              raw, device_events): its idle share
              and where its device time goes;
  8. graphs   every decode path above runs the decode loop as it runs for
              a user: each phase's step captured as a CUDA graph and
              replayed, ``decode.loop.CHECK_EVERY`` (k) steps between two
              reads of the termination test (the parity phases and the
              plain paths, whose margins are read at every step, take
              ``graphs=False``; the gloo meshes of [parallel] the eager
              loop by rule).  Each decode path (the e2e paths and routes,
              the recipe's rungs, serving at batch 4, TP 1 on NCCL) also
              runs with ``graphs=False``, the same kernels, and its
              candidates, scores, no-speech probabilities and steps must be
              bit-equal to the captured loop's (the e2e paths at a cut
              budget, LOOP_CMP_STEPS, that crosses the first phase
              boundary; serving's first SERVE_EAGER_CALLS calls and the
              recipe's first window's rung 0 and first sampled rung on
              their inputs: the eager loop costs the script's time, and a
              slow host's most); the [graphs] lines print ms a step both
              ways, the
              host's syncs a window (at most ceil(steps / k) + 3 captured),
              its runtime launch calls over a PROFILE_STEPS-token window
              (torch.profiler), the captures and their seconds, k, and the
              memory the cached window adds; serving prints its first
              request's latency with and without ``warmup()``;
  9. the [graphs] summary (JSON), the kernels line (JSON), the card line,
     and last the contract line.

Every phase prints its seconds.  Exits nonzero, printing no result, where
CUDA is absent.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import itertools
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from whisper_rs_tpu_torch import (
    DecodeTask,
    ServingEngine,
    Tokenizer,
    TranscribeTask,
    cli,
    log_mel_file,
)
from whisper_rs_tpu_torch.audio.flac import encode_flac
from whisper_rs_tpu_torch.audio.io import load_audio, write_wav
from whisper_rs_tpu_torch.audio.constants import HOP_LENGTH, N_FFT, N_SAMPLES
from whisper_rs_tpu_torch.audio.mel import hann_window, mel_filterbank, pad_or_trim, reflect_pad
from whisper_rs_tpu_torch.config import (
    BeamSearchMode,
    DecodeOptions,
    GreedyMode,
    ModelDims,
    TranscribeOptions,
    dims_for,
)
from whisper_rs_tpu_torch.decode import (
    PREFILL_BUCKETS,
    FilterConfig,
    apply_filters,
    build_batch_prompts,
    decode_beam,
    decode_greedy,
    rank_max_likelihood,
)
from whisper_rs_tpu_torch.decode import align as decode_align
from whisper_rs_tpu_torch.decode import loop as decode_loop
from whisper_rs_tpu_torch.decode import rng as decode_rng
from whisper_rs_tpu_torch.decode import task as decode_task_module
from whisper_rs_tpu_torch.decode.filters import log_softmax
from whisper_rs_tpu_torch.decode.loop import (
    DecodeWindow,
    WindowCache,
    _encode_and_prefill,
    beam_shape,
    greedy_shape,
)
from whisper_rs_tpu_torch.models import (
    CrossKV,
    KVCache,
    TextDecoder,
    init_random,
    precompute_cross_kv,
    quantize_kv,
    quantize_params,
)
from whisper_rs_tpu_torch.models.params import _empty_model
from whisper_rs_tpu_torch.ops import LAUNCHES, reset_launches
from whisper_rs_tpu_torch.ops.build import SOURCES, _nvcc, build_all, library_path, ptxas_report
from whisper_rs_tpu_torch.ops.decode_attention import (
    beam_self_attention_step,
    beam_self_attention_step_plain,
    cross_attention_step,
    cross_attention_step_plain,
    cross_kernel_smem,
    cross_launch_plan,
    self_attention_append_step,
    self_attention_append_step_plain,
    self_attention_fused_step,
    self_attention_fused_step_plain,
    self_attention_step,
    self_attention_step_plain,
    step_launch_plan,
)
from whisper_rs_tpu_torch.ops.decoder_layer_fused import (
    decoder_step_fused,
    decoder_step_fused_plain,
    decoder_step_weights,
)
from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step, decoder_mlp_step_plain
from whisper_rs_tpu_torch.ops.encoder_attention import (
    encoder_attention_merged,
    encoder_attention_merged_plain,
    encoder_attention_split,
    encoder_attention_split_plain,
)
from whisper_rs_tpu_torch.ops.encoder_fused import (
    ln_fused,
    ln_fused_plain,
    residual_ln,
    residual_ln_plain,
)
from whisper_rs_tpu_torch.ops.mel import fft_table as mel_fft_table
from whisper_rs_tpu_torch.transcribe import rung_key
from whisper_rs_tpu_torch.ops.mel import (
    kernel_flops_per_frame,
    log_mel_frontend,
    mel_runs,
    raw_log10_mel,
    raw_log10_mel_plain,
)

MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s, no TF32
# (model, audios a batch, beam size; 0 for greedy) of each path
PATHS = (("base.en", 128, 0), ("large-v3", 12, 0), ("medium.en", 8, 5))
# the greedy-step routes' path: medium.en, audios a batch, prompted; the
# append route is the default and the yardstick of the other two
ROUTES_PATH = ("medium.en", 8)
ROUTES = ("layer", "ctx", "append")
# the int8 paths: (model, audios a batch, beam size (0: greedy), int8 weights
# too); both keep int8 K/V
INT8_PATHS = (("base.en", 128, 0, True), ("medium.en", 8, 5, False))
INT8_GREEDY_CHECK_POS = (2, 127, 128, 200)  # unprompted greedy steps checked plain vs kernel
# The int8 parities' tolerances, set from their f32 runs on the H100
# (PERF.md).  Where the two paths' f32 projections differ by an ulp, a K or
# V value can round to the neighbouring int8 step (1/127 of its position's
# amax): on the beam path 1 or 2 values of a step's column did, and the
# checked steps' logits then differed by up to 5.2e-6 (7.2e-7 on the greedy
# path, where none did).  The logit tolerance is about 20 times that.  The
# beam scores, f32 sums of 216 log-probs near -1,350 where one f32 step is
# 1.2e-4, then round apart now and then: a walk of up to 4.5e-3 (3.4e-6
# relative) was measured, and the int8 score tolerance takes 1e-5 |plain|,
# about 3 times that.
INT8_LOGIT_TOL = 1e-4
INT8_SCORE_RTOL = 1e-5
# The int8×int8 parity's tolerances (WHISPER_INT8_MATMUL=1 on the int8
# greedy path).  Every linear also quantises its input rows, so where the
# two paths' f32 activations differ by an ulp next to a rounding boundary,
# an activation rounds to the neighbouring int8 step (1/127 of its row's
# amax), which the int8-weight path never does.  The first run on the H100
# measured step logits 1.98e-3 and 6.77e-3 apart at positions 128 and 200
# (275 int8 values of the second step's K/V column rounded apart) and
# 6e-7 at positions 2 and 127: 20 and 68 times INT8_LOGIT_TOL; every row
# then left the plain path at a top-2 margin of 3.1e-4 to 9.1e-3.  The logit
# tolerance is about 3 times the worst; a dropped key tile or a wrong
# scale moves the logits by 0.1 or more.  The no-speech probabilities
# (1.1e-7 apart) keep 1e-5.
INT8X8_LOGIT_TOL = 2e-2
GREEDY_CHECK_POS = (233, 255, 256, 400)  # steps checked plain vs kernel, routes parity
LAYER_BF16_DEPTH = 4  # decoder layers of the whole-step kernel's bf16 check
# the whole-step kernel's phases, in order (csrc/decoder_layer.cu)
PHASES = ("ln1+qkv", "self-attention", "out-proj", "ln2+cross-q", "cross-attention",
          "cross-out", "ln3+fc1+gelu", "fc2")
PROFILE_STEPS = 48  # incremental steps of the profiled run of the first three paths
# The budget of the comparison of a path's captured loop with graphs=False
# (the eager loop costs the script's time, and a slow host's most): enough
# tokens to cross the first phase boundary, unprompted (128) or prompted
# at the 232 bucket (256), so that every phase's graph is compared
LOOP_CMP_STEPS = {"unprompted": 136, "prompted": 40}
PARITY_DEPTH = {"large-v3": 4, "medium.en": 4}  # layers kept in the parity phase
SAMPLE_LEN = 224
PARITY_WINDOWS = 4
# beam parity: positions whose incremental step runs both ways on the kernel
# path's state (the first step, both ends of the 256 phase, one at 448)
BEAM_CHECK_POS = (233, 255, 256, 400)
SCORE_RTOL = 2e-6  # beam parity scores: |d| <= 1e-4 + SCORE_RTOL |plain|
E2E_REPS = 3
# timed e2e runs of a path where E2E_REPS is more than the script's time
# allows: large-v3 takes 13 s a run and is compared with nothing in the run;
# the recipe's file (40 s then) took 69-109 s a run (H100 80GB HBM3, 700 W).  The
# serving, int8×int8 and evaluation phases (128 s) took the time of two more
# runs of the medium.en beam paths (9-12 s a run), of the 95 s transcription
# (about 11 s a run) and of base.en b128 with and without int8 (3-6 s)
E2E_REPS_CUT = {"large-v3": 1, "base.en b1 recipe": 1, "medium.en": 1, "medium.en int8 KV": 1,
                "base.en b1 beam5 transcribe": 1, "base.en": 1, "base.en int8": 1}
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
# The whole-step kernel's bf16 check runs LAYER_BF16_DEPTH layers: the
# residual is rounded to bf16 after every sub-block, so a sum taken in
# another order that lands on the other side of a rounding boundary moves
# x by one bf16 ulp, and that step feeds every later layer.  At 4 layers
# of the check's inputs |x| reaches about 6.5, where one ulp is 2^-5 =
# 0.031, and the kernel differs from its plain version by up to 2 such
# ulps (0.0625, measured on the H100; plain versions that differ only in
# the order of their sums do the same on the CPU,
# tests/test_torch_package.py).  The atol is 3 of them, the rtol one ulp
# of each element.  A step that skips one layer's cross-attention misses
# by 3.5 times the tolerance or more, one that masks from key_start + 1 by
# 1.3 times at W 448 and 3.4 times at W 256.
TOL_LAYER_BF16 = (3 * 2**-5, 1e-2)
TOL_BF16 = {
    "ln_fused": (1e-3, 1e-2),
    "residual_ln": (1e-3, 1e-2),
    "encoder_attention_merged": (2e-3, 1e-2),
    "cross_attention_step": (2e-3, 1e-2),
    "self_attention_append_step": (2e-3, 1e-2),
    "beam_self_attention_step": (2e-3, 1e-2),
    "decoder_mlp_step": (1e-3, 1e-2),
    "self_attention_fused_step": (2e-3, 1e-2),
    "decoder_step_fused": TOL_LAYER_BF16,
    "self_attention_step": (2e-3, 1e-2),
    "encoder_attention_split": (2e-3, 1e-2),
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


def rotating(n_layer: int):
    """A function that returns the layers 0, 1, ..., n_layer - 1, 0, ... one a
    call.  The attention kernels are timed rotating through the layers, so
    each call finds its layer's K/V cold in the card's 50 MB L2, as a decode
    step does (the same layer replayed stays resident where its K/V fits)."""
    layers = itertools.cycle(range(n_layer))
    return lambda: next(layers)


def device_pos(pos: int) -> torch.Tensor:
    """A step kernel's slot as the decode loop hands it over: a 0-d int64
    tensor on the card, which the kernel reads from device memory."""
    return torch.full((), pos, dtype=torch.int64, device="cuda")


def check_kernel(name, dtype, kernel, plain, library, nbytes, flops, reps, graph=True,
                 checked=None, library_call=None, plain_graph=None):
    """Compare the kernel with its plain version (or take ``checked``, the
    (max abs error, tolerance share) of a comparison made by the caller),
    then time the kernel, the plain version and the library call (None
    where no one PyTorch call computes the function; ``library_call`` says
    what it is where it takes more than one call); ``plain_graph`` (default
    ``graph``) times the plain version as a CUDA graph or not."""
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
        "plain_ms": timed_ms(plain, max(1, reps // 4), graph if plain_graph is None else plain_graph),
        "library_ms": None if library is None else timed_ms(library, reps, graph),
    }
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
    if library_call:
        row["library_call"] = library_call
    lib = "none" if library is None else f"{row['library_ms']:.4f} ms"
    lib += f" ({library_call})" if library_call else ""
    print(
        f"    kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
        f"library {lib} | bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
        flush=True,
    )
    return row


def kernel_checks(dims, B: int, dtypes, group: int = 1) -> dict:
    """Every kernel of one path at its shapes: ``B`` windows through mel
    (f32) and the encoder kernels (in ``dtypes``); the cross kernel with
    ``group`` rows an audio and the step kernels at ``B * group`` rows, in
    f32 and bf16 (the append self-attention when ``group`` is 1, else the
    beam self-attention).  Returns {kernel: {"f32" | "bf16": row}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    T, D, H = dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head
    dh, L, n_mels = D // H, dims.n_text_layer, dims.n_mels
    rows = {name: {} for name in KERNELS}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    print(f"[kernels] log_mel ({n_mels} bins, f32, {B} windows)", flush=True)
    padded = reflect_pad(randn(B, N_SAMPLES, scale=0.1)).contiguous()
    rows["log_mel"]["f32"] = check_mel(padded, n_mels, padded.numel() * 4)
    del padded

    for dtype in dtypes:
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] LayerNorm pair ({tag})", flush=True)
        rows["ln_fused"][tag], rows["residual_ln"][tag] = check_ln_pair((B, T, D), dtype, randn)
        print(f"[kernels] encoder_attention_merged ({tag})", flush=True)
        rows["encoder_attention_merged"][tag] = check_merged(B, T, H, dh, dtype, randn)

    step = "self_attention_append_step" if group == 1 else "beam_self_attention_step"
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] cross_attention_step ({tag}, {group} rows an audio)", flush=True)
        rows["cross_attention_step"][tag] = check_cross(dims, B, group, dtype, randn)
        print(f"[kernels] {step} ({tag})", flush=True)
        rows[step][tag] = check_step_attention(dims, B, group, dtype, randn, gen)
        print(f"[kernels] decoder_mlp_step ({tag})", flush=True)
        rows["decoder_mlp_step"][tag] = check_mlp(dims, B * group, dtype, randn)
        torch.cuda.empty_cache()
    if group > 1:
        time_beam_ranking(dims, B, group, randn)
    return rows


def check_ln_pair(shape, dtype, randn) -> tuple:
    """Rows 3 and 2 (``ln_fused``, ``residual_ln``) on x [..., D] of
    ``shape`` against their plain versions; the library call is
    F.layer_norm (of x + delta for the residual kernel)."""
    D = shape[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    x, d = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
    s, b = randn(D, dtype=dtype), randn(D, dtype=dtype)
    ln = check_kernel(
        "ln_fused", dtype, lambda: ln_fused(x, s, b), lambda: ln_fused_plain(x, s, b),
        lambda: F.layer_norm(x, (D,), s, b, 1e-5),
        nbytes=2 * x.numel() * isz + 2 * D * isz, flops=8 * x.numel(), reps=20,
    )
    res = check_kernel(
        "residual_ln", dtype, lambda: residual_ln(x, d, s, b),
        lambda: residual_ln_plain(x, d, s, b),
        lambda: F.layer_norm(x + d, (D,), s, b, 1e-5),
        nbytes=4 * x.numel() * isz + 2 * D * isz, flops=9 * x.numel(), reps=20,
    )
    return ln, res


# The decoder's LayerNorm rows on each path (batch x beams, D): every step
# body takes 3 n_text_layer + 1 of them (the layer route's one), and the
# prefill as many at its width; medium.en b8 beam 5's prefill stands for the
# prefill shapes (232 tokens, bench_prompts' bucket)
LN_STEP_ROWS = (
    (("base.en b128",), (128, 512)),
    (("large-v3 b12",), (12, 1280)),
    (("medium.en b8 beam5",), (40, 1024)),
    # the greedy routes (the layer route's step takes only the last LayerNorm)
    (("medium.en b8 greedy prompted, layer", "medium.en b8 greedy prompted, ctx"), (8, 1024)),
    (("base.en b1 beam5 transcribe",), (5, 512)),
    (("base.en serve b4 beam5",), (20, 512)),
)
LN_PREFILL = ("medium.en b8 beam5", (40, 232, 1024))
STEP_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "tol_share")


def kernel_checks_ln_steps(rows: dict) -> None:
    """Rows 3 and 2 at each path's decoder rows [rows, 1, D] (``LN_STEP_ROWS``)
    and at one prefill shape, f32 and bf16, each against its plain version at
    its tolerance and timed (``check_ln_pair``); row 3 in bf16 also called
    twice for the same bits.  Each result goes into the path's row of its
    dtype as ``step`` (``prefill``); where the path's config has no row 3
    (the greedy routes'), the step's rows are its rows."""
    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    shapes = [(configs, "step", (n, 1, D)) for configs, (n, D) in LN_STEP_ROWS]
    shapes.append(((LN_PREFILL[0],), "prefill", LN_PREFILL[1]))
    owned = {config for configs, _, _ in shapes for config in configs
             if not rows[config]["ln_fused"]}
    for configs, key, shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            print(f"[kernels] LayerNorm pair ({tag}, {key} {list(shape)}, {configs[0]})",
                  flush=True)
            pair = check_ln_pair(shape, dtype, randn)
            if dtype == torch.bfloat16 and key == "step":
                x = randn(*shape, dtype=dtype)
                s, b = randn(shape[-1], dtype=dtype), randn(shape[-1], dtype=dtype)
                check_deterministic("ln_fused", lambda: ln_fused(x, s, b), pair[0])
            for config, (name, row) in itertools.product(configs,
                                                          zip(("ln_fused", "residual_ln"), pair)):
                target = rows[config][name]
                if config in owned:
                    if name == "ln_fused":
                        target[tag] = row
                elif tag in target:
                    target[tag][key] = {"shape": list(shape),
                                        **{k: row[k] for k in STEP_KEYS + ("bit_identical",)
                                           if k in row}}


def check_merged(B: int, T: int, H: int, dh: int, dtype, randn) -> dict:
    """Row 4 on merged q, k, v [B, T, H * dh] against its plain version,
    also with n_valid < T (compared, not timed); the library call is SDPA
    on the heads of the same tensors.  In bf16 also two calls
    bit-identical."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    isz = torch.tensor([], dtype=dtype).element_size()
    D = H * dh
    # unit-scale q and k: scores of std 1 after the d^-0.5 scale, so the
    # softmax is peaked and the Q.K part of the kernel matters
    q, k, v = (randn(B, T, D, dtype=dtype) for _ in range(3))
    scale = dh**-0.5

    def sdpa():
        split = lambda t: t.view(B, T, H, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale)

    # keys past n_valid masked: compared, not timed
    nv = T - 37
    masked = compare(f"encoder_attention_merged {tag} n_valid {nv}",
                     (encoder_attention_merged(q, k, v, H, scale, nv),),
                     (encoder_attention_merged_plain(q, k, v, H, scale, nv),),
                     tolerance("encoder_attention_merged", dtype))
    row = check_kernel(
        "encoder_attention_merged", dtype,
        lambda: encoder_attention_merged(q, k, v, H, scale),
        lambda: encoder_attention_merged_plain(q, k, v, H, scale),
        sdpa, nbytes=4 * q.numel() * isz, flops=4 * B * T * T * D,
        reps=3 if dtype == torch.float32 else 10, graph=False,
    )
    row["max_abs_err"] = max(row["max_abs_err"], masked[0])
    row["tol_share"] = max(row["tol_share"], masked[1])
    if dtype == torch.bfloat16:
        check_deterministic("encoder_attention_merged",
                            lambda: encoder_attention_merged(q, k, v, H, scale), row)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def check_mel(rows, n_mels: int, in_bytes: int) -> dict:
    """Row 1 on reflect-padded rows [B, 480400] (contiguous windows, or the
    overlapping chunks of one file as a strided view; ``in_bytes`` the
    distinct samples they hold) against its plain version; the library call
    is torch.stft on the same rows (no centring: they are padded already),
    the mel matmul and log10.  The bound counts the FFT kernel's own
    operations (ops/mel.py::kernel_flops_per_frame); the direct DFT's
    count, the bound of the direct-DFT kernel before it, is printed beside
    it.  The kernel and the library call are timed as CUDA graphs where the
    rows are few (under a millisecond), the plain version eagerly.  Two
    calls bit-identical."""
    dev = rows.device
    B = rows.shape[0]
    window = torch.from_numpy(hann_window()).to(dev)
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)

    def stft_mel():
        spec = torch.stft(rows, N_FFT, HOP_LENGTH, window=window, center=False,
                          return_complex=True)
        return torch.log10(torch.clamp(fb @ spec[..., :-1].abs().square(), min=1e-10))

    frames = B * (N_SAMPLES // HOP_LENGTH)
    table = mel_fft_table().nbytes + sum(a.nbytes for a in mel_runs(mel_filterbank(n_mels)))
    row = check_kernel(
        "log_mel", torch.float32, lambda: raw_log10_mel(rows, n_mels),
        lambda: raw_log10_mel_plain(rows, n_mels), stft_mel,
        nbytes=in_bytes + frames * n_mels * 4 + table,
        flops=frames * kernel_flops_per_frame(n_mels), reps=10, graph=B <= 4,
        plain_graph=False,  # it copies its constants to the card every call
    )
    direct = frames * (2 * 2 * N_FFT * (N_FFT // 2 + 1) + 2 * (N_FFT // 2 + 1) * n_mels)
    row["direct_dft_bound_ms"] = direct / PEAK[torch.float32] * 1e3
    print(f"    operations {frames * kernel_flops_per_frame(n_mels):.4g} (the direct DFT's "
          f"{direct:.4g}, bound {row['direct_dft_bound_ms']:.4f} ms)", flush=True)
    check_deterministic("log_mel", lambda: raw_log10_mel(rows, n_mels), row)
    return row


def check_cross(dims, A: int, G: int, dtype, randn, int8: bool = False) -> dict:
    """The cross kernel at the step shapes: pre-scaled q [A, G, H, 64] of
    unit-scale scores against unit-scale kv [L, A, H, 2, 64, 1500], last
    layer; with ``int8`` the kv quantised per position as
    ``precompute_cross_kv(quantize=True)`` does, with its f32 scales, and
    the library call the dequantising multiply of the layer's K/V and SDPA
    as one CUDA graph.  Timed rotating through the layers (``rotating``)."""
    T, H, L = dims.n_audio_ctx, dims.n_text_head, dims.n_text_layer
    dh = dims.head_dim
    isz = torch.tensor([], dtype=dtype).element_size()
    qx = randn(A, G, H, dh, dtype=dtype, scale=dh**-0.5)
    layer = L - 1
    scales = {}
    if int8:
        planes, s = quantize_kv(randn(L, A, H, 2, T, dh))  # per position, before the transpose
        kv = planes.transpose(-1, -2).contiguous()
        s = s.permute(3, 0, 1, 2, 4).contiguous()  # [2, L, A, H, T]
        scales = {"k_scale": s[0], "v_scale": s[1]}
        del planes
        deq = torch.empty(A, H, 2, dh, T, dtype=dtype, device=kv.device)
    else:
        kv = randn(L, A, H, 2, dh, T, dtype=dtype)

    def sdpa_cross(at):
        if int8:
            torch.mul(kv[at], s[:, at].permute(1, 2, 0, 3)[:, :, :, None], out=deq)
        kt, vt = (deq[:, :, 0], deq[:, :, 1]) if int8 else (kv[at, :, :, 0], kv[at, :, :, 1])
        return F.scaled_dot_product_attention(
            qx.transpose(1, 2), kt.transpose(-1, -2), vt.transpose(-1, -2), scale=1.0
        )

    name = "cross_attention_step"
    checked = compare(f"{name} {str(dtype).split('.')[-1]}" + (", int8 K/V" if int8 else ""),
                      (cross_attention_step(qx, kv, layer, **scales),),
                      (cross_attention_step_plain(qx, kv, layer, **scales),),
                      tolerance(name, dtype))
    kv_bytes = A * H * 2 * dh * T * (1 if int8 else isz) + (2 * A * H * T * 4 if int8 else 0)
    nxt = rotating(L)
    row = check_kernel(
        name, dtype,
        lambda: cross_attention_step(qx, kv, nxt(), **scales),
        lambda: cross_attention_step_plain(qx, kv, nxt(), **scales),
        lambda: sdpa_cross(nxt()), nbytes=kv_bytes + 2 * qx.numel() * isz,
        flops=4 * A * G * H * dh * T, reps=20, checked=checked,
        library_call=("the dequantising multiply of the layer's K/V (one torch.mul) and "
                      "F.scaled_dot_product_attention, two calls as one CUDA graph")
        if int8 else None,
    )
    if dtype == torch.bfloat16:
        check_deterministic(name + (" int8 K/V" if int8 else ""),
                            lambda: cross_attention_step(qx, kv, layer, **scales), row)
    plan = cross_launch_plan(A, G, H, T, dh, kv.element_size())
    built = cross_kernel_smem(plan, G, dh, kv.element_size())
    if built != plan.smem:
        raise AssertionError(f"{name}: the plan counts {plan.smem} bytes of shared memory a "
                             f"block, the built kernel {built}")
    row["plan"] = plan._asdict()
    return row


def check_step_attention(dims, A: int, G: int, dtype, randn, gen, fused: bool = False) -> dict:
    """The step self-attention at the step shapes of A audios of G rows: the
    append kernel (G = 1), the read-only fused kernel (G = 1, ``fused``) or
    the beam kernel, with random ancestors in [0, G) that differ between the
    rows of an audio (the row's own at slot pos, as the decode loop sets
    it).  q, k_new, v_new [A G, H, 64] (q pre-scaled, unit-scale scores),
    caches [L, A G, H, 448, 64] of unit-scale values.  Checked at W = 256,
    pos = 255 and at W = 448, pos = 400 with a non-zero key_start (in
    1..299 for the append kernel; in 1..231, the prefill's range, for the
    fused kernel at both, and varied within each audio for the beam kernel,
    so that masking by the row's own fails) and with row 0's key_start past
    pos (its audio's window empty), against the plain version, and both
    caches: slot pos equals k_new and v_new, and no other slot changed (the
    fused kernel changes none).  Timed at W = 256, pos = 255, rotating
    through the layers; in bf16 two calls must give the same bits."""
    H, dh, L, n_ctx = dims.n_text_head, dims.head_dim, dims.n_text_layer, dims.n_text_ctx
    B = A * G
    dev = torch.device("cuda")
    isz = torch.tensor([], dtype=dtype).element_size()
    layer = L - 1
    q = randn(B, H, dh, dtype=dtype, scale=dh**-0.5)
    k_new, v_new = randn(B, H, dh, dtype=dtype), randn(B, H, dh, dtype=dtype)
    k_all, v_all = randn(L, B, H, n_ctx, dh, dtype=dtype), randn(L, B, H, n_ctx, dh, dtype=dtype)
    new, extra = (k_new, v_new), ()
    if fused:
        name, kernel, plain = (
            "self_attention_fused_step", self_attention_fused_step,
            self_attention_fused_step_plain,
        )
        new, ks_top = (), 231
    elif G == 1:
        name, kernel, plain = (
            "self_attention_append_step", self_attention_append_step,
            self_attention_append_step_plain,
        )
        ks_top = 299
    else:
        name, kernel, plain = (
            "beam_self_attention_step", beam_self_attention_step, beam_self_attention_step_plain,
        )
        anc = torch.randint(0, G, (B, n_ctx), generator=gen, device=dev, dtype=torch.int32)
        anc[:, [STEP_WINDOW - 1, 400]] = (torch.arange(B, device=dev) % G).to(torch.int32)[:, None]
        extra, ks_top = (anc, G), 231
    ks_nonzero = torch.arange(B, device=dev) * 37 % ks_top + 1
    ks_empty = ks_nonzero.clone()  # row 0's key_start past pos: its window (its audio's) is empty
    ks_empty[0] = 401
    checks = ((STEP_WINDOW, STEP_WINDOW - 1, ks_nonzero if fused else None),
              (n_ctx, 400, ks_nonzero), (n_ctx, 400, ks_empty))

    def run(fn, caches, pos, ks, W, at=layer):
        return fn(q, *new, *caches, at, pos, ks, *extra, window=W)

    tol = tolerance(name, dtype)
    tag = str(dtype).split(".")[-1]
    worst = (0.0, 0.0)
    for W, pos, ks in checks:
        before = (k_all.clone(), v_all.clone())
        plain_caches = (k_all.clone(), v_all.clone())
        got = run(kernel, (k_all, v_all), pos, ks, W)
        want = run(plain, plain_caches, pos, ks, W)
        what = "" if ks is None else (f" key_start 1..{ks_top}" if ks.max() <= ks_top else
                                      " row 0's key_start past pos (empty window)")
        err = compare(f"{name} {tag} W {W} pos {pos}{what}", (got,), (want,), tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        for cache, old, plain_cache in zip((k_all, v_all), before, plain_caches):
            cache_rest, old_rest = cache.clone(), old.clone()
            if new:
                if not torch.equal(cache[layer, :, :, pos], new[0 if cache is k_all else 1]):
                    raise AssertionError(f"{name}: slot pos is not k_new/v_new")
                cache_rest[layer, :, :, pos] = 0
                old_rest[layer, :, :, pos] = 0
            if not torch.equal(cache_rest, old_rest) or not torch.equal(cache, plain_cache):
                raise AssertionError(f"{name}: a cache slot changed that should not")
        del before, plain_caches
    print("  cache: " + ("unchanged" if fused else
                         "slot pos equals k_new and v_new exactly; no other slot changed"),
          flush=True)

    W, pos = STEP_WINDOW, STEP_WINDOW - 1
    ids = torch.arange(W, device=dev)
    mask = (ids <= pos)[None, None, None, :].expand(B, 1, 1, W)
    first = torch.arange(B, device=dev) // G * G

    def sdpa(at):  # the attention alone over the window, without the write;
        # for the beam kernel after resolving the ancestors by a gather
        if G == 1:
            k, v = k_all[at, :, :, :W], v_all[at, :, :, :W]
        else:
            src = first[:, None] + anc[:, :W].long()
            k = k_all[at][src, :, ids].transpose(1, 2)
            v = v_all[at][src, :, ids].transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask, scale=1.0)

    n = pos + 1  # visible slots of every row
    if G == 1:
        kv_rows, table = B * n, 0
    else:
        # rows of one audio that share an ancestor at a slot share its K/V
        # row: the function needs each distinct (source row, slot) read once
        kv_rows = torch.unique((first[:, None] + anc[:, :n].long()) * n + ids[:n]).numel()
        table = B * n * 4
        print(f"  bound: {kv_rows} distinct (source row, slot) pairs of this run's "
              f"ancestors, of {B * n} (row, slot) reads", flush=True)
    vectors = 2 if fused else 6  # q in, out; and k_new, v_new in, the column out
    nxt = rotating(L)
    at = device_pos(pos)  # read by the kernel from device memory, as the decode loop's
    row = check_kernel(
        name, dtype,
        lambda: run(kernel, (k_all, v_all), at, None, W, nxt()),
        lambda: run(plain, (k_all, v_all), at, None, W, nxt()),
        lambda: sdpa(nxt()),
        nbytes=(2 * kv_rows * H * dh + vectors * B * H * dh) * isz + table,
        flops=4 * B * H * n * dh, reps=50, checked=worst,
    )
    row["plan"] = step_launch_plan(B, H, W, W, dh, isz, beam=G > 1)._asdict()
    if dtype == torch.bfloat16:
        check_deterministic(name, lambda: run(kernel, (k_all, v_all), at, ks_nonzero, W), row)
    return row


def check_read_step(dims, A: int, G: int, dtype, randn, gen, int8: bool = True) -> dict:
    """Row 10 (G = 1) or the beam kernel's int8 read (G > 1) at the step
    shapes of A audios of G rows: q [A G, H, 64] pre-scaled (unit-scale
    scores); caches [L, A G, H, 448, 64] of unit-scale values, quantised
    per position (``quantize_kv``, K and V from one tensor so that one
    multiply dequantises both in the library call) or, for row 10 without
    ``int8``, in q's dtype; the beam's random ancestors as in
    check_step_attention.  Checked at W 256, pos 255, at W 448, pos 400,
    key_start in 1..231 (varied within each audio for the beam), and with
    row 0's (its audio's) key_start past pos, an empty window, against the
    plain version; the read-only calls leave the caches unchanged.  Row 10
    over an int8 cache is also checked the way the greedy path calls it,
    with this step's k_new and v_new [A, H, 64] (q's dtype): its written
    int8 column and scales must equal ``quantize_kv`` of them exactly, and
    nothing else may change.  Timed at W 256, pos 255, without key_start,
    rotating through the layers (row 10 over an int8 cache with its column
    write, the path's call; the read-only call beside it); the library call
    is the dequantising multiply and SDPA as one CUDA graph (the beam's
    after a gather of the ancestors' rows and scales; row 10's after the
    torch column write, quantize_kv and four slice writes, which is also
    timed alone).  In bf16 two calls must give the same bits."""
    H, dh, L, n_ctx = dims.n_text_head, dims.head_dim, dims.n_text_layer, dims.n_text_ctx
    B = A * G
    dev = torch.device("cuda")
    isz = torch.tensor([], dtype=dtype).element_size()
    layer = L - 1
    q = randn(B, H, dh, dtype=dtype, scale=dh**-0.5)
    if int8:
        planes, s = quantize_kv(randn(2, L, B, H, n_ctx, dh))
    else:
        planes, s = randn(2, L, B, H, n_ctx, dh, dtype=dtype), None
    first = torch.arange(B, device=dev) // G * G
    write = int8 and G == 1  # row 10 with its column write, the greedy path's call
    if G == 1:
        name, kernel, plain, extra = (
            "self_attention_step", self_attention_step, self_attention_step_plain, ())
        new = {"k_new": randn(B, H, dh, dtype=dtype),
               "v_new": randn(B, H, dh, dtype=dtype)} if write else {}
    else:
        name, kernel, plain = (
            "beam_self_attention_step", beam_self_attention_step, beam_self_attention_step_plain)
        anc = torch.randint(0, G, (B, n_ctx), generator=gen, device=dev, dtype=torch.int32)
        anc[:, [STEP_WINDOW - 1, 400]] = (torch.arange(B, device=dev) % G).to(torch.int32)[:, None]
        extra, new = (anc, G), {}
    ks = torch.arange(B, device=dev) * 37 % 231 + 1
    ks_empty = ks.clone()
    ks_empty[0] = 401

    def run(fn, pos, ks, W, at=layer, caches=(planes, s), writes=False):
        p, sc = caches
        scales = {"k_scale": sc[0], "v_scale": sc[1]} if int8 else {}
        args = (q, None, None) if G > 1 else (q,)
        return fn(*args, p[0], p[1], at, pos, ks, *extra, window=W, **scales,
                  **(new if writes else {}))

    tol = tolerance(name, dtype)
    dtag = str(dtype).split(".")[-1]
    tag = f"{dtag}, {'int8' if int8 else dtag} cache"
    worst = (0.0, 0.0)
    before = (planes.clone(), None if s is None else s.clone())
    checks = [(STEP_WINDOW, STEP_WINDOW - 1, ks, " key_start 1..231"),
              (n_ctx, 400, ks, " key_start 1..231"),
              (n_ctx, 400, ks_empty, " row 0's (audio 0's) key_start past pos (empty window)")]
    for W, pos, k, what in checks:
        err = compare(f"{name} {tag} W {W} pos {pos}{what}",
                      (run(kernel, pos, k, W),), (run(plain, pos, k, W),), tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
    if not torch.equal(planes, before[0]) or (int8 and not torch.equal(s, before[1])):
        raise AssertionError(f"{name}: the read-only step changed the cache")
    print("  cache: unchanged by the read-only calls", flush=True)
    if write:
        want_k, want_v = quantize_kv(new["k_new"]), quantize_kv(new["v_new"])
        for W, pos, k, what in checks:
            got_c = (before[0].clone(), before[1].clone())
            want_c = (before[0].clone(), before[1].clone())
            err = compare(f"{name} {tag} with its column write, W {W} pos {pos}{what}",
                          (run(kernel, pos, k, W, caches=got_c, writes=True),),
                          (run(plain, pos, k, W, caches=want_c, writes=True),), tol)
            worst = (max(worst[0], err[0]), max(worst[1], err[1]))
            (k8, v8), (k_s, v_s) = got_c[0][:, layer, :, :, pos], got_c[1][:, layer, :, :, pos]
            if not (torch.equal(k8, want_k[0]) and torch.equal(v8, want_v[0])
                    and torch.equal(k_s, want_k[1]) and torch.equal(v_s, want_v[1])):
                raise AssertionError(f"{name}: the written int8 column or its scales differ from "
                                     "quantize_kv's")
            if not (torch.equal(got_c[0], want_c[0]) and torch.equal(got_c[1], want_c[1])):
                raise AssertionError(f"{name}: a cache slot changed that should not")
            del got_c, want_c
        print("  column write: the int8 column and scales at slot pos equal quantize_kv's "
              "exactly; no other slot changed", flush=True)
    del before

    W, pos = STEP_WINDOW, STEP_WINDOW - 1
    ids = torch.arange(W, device=dev)
    mask = (ids <= pos)[None, None, None, :].expand(B, 1, 1, W)
    deq = torch.empty(2, B, H, W, dh, dtype=dtype, device=dev)
    src = first[:, None] + anc[:, :W].long() if G > 1 else None

    def column_write(at):  # KVCache.write of one step's column
        for plane, new_x in enumerate((new["k_new"], new["v_new"])):
            planes[plane, at, :, :, pos], s[plane, at, :, :, pos] = quantize_kv(new_x)

    def library(at):  # one multiply dequantises K and V of the window, then SDPA
        if G == 1:
            if write:
                column_write(at)
            window = planes[:, at, :, :, :W]
            kv = torch.mul(window, s[:, at, :, :, :W, None], out=deq) if int8 else window
        else:  # the gather of the ancestors' rows and scales first
            rows = planes[:, at][:, src, :, ids].permute(2, 0, 3, 1, 4)  # [2, B, H, W, dh]
            kv = torch.mul(rows, s[:, at][:, src, :, ids].permute(2, 0, 3, 1)[..., None],
                           out=deq)
        return F.scaled_dot_product_attention(q[:, :, None], kv[0], kv[1], attn_mask=mask,
                                              scale=1.0)

    n = pos + 1  # visible slots of every row
    if G == 1:
        kv_rows, table = B * n, 0
    else:
        kv_rows = torch.unique((first[:, None] + anc[:, :n].long()) * n + ids[:n]).numel()
        table = B * n * 4
        print(f"  bound: {kv_rows} distinct (source row, slot) pairs of this run's "
              f"ancestors, of {B * n} (row, slot) reads", flush=True)
    row_bytes = 2 * H * dh * (1 if int8 else isz) + (2 * H * 4 if int8 else 0)  # K, V (scales)
    # q in, out; with the write also k_new, v_new in (slot pos's K/V and
    # scales counted once, as written)
    vectors = 4 if write else 2
    nxt = rotating(L)
    at = device_pos(pos)  # read by the kernel from device memory, as the decode loop's
    row = check_kernel(
        name, dtype, lambda: run(kernel, at, None, W, nxt(), writes=write),
        lambda: run(plain, at, None, W, nxt(), writes=write), lambda: library(nxt()),
        nbytes=kv_rows * row_bytes + vectors * B * H * dh * isz + table,
        flops=4 * B * H * n * dh, reps=50, checked=worst,
        library_call=None if not int8 else (
            "the torch column write (quantize_kv of k_new and v_new, four slice writes), the "
            "dequantising multiply of the window's K and V (one torch.mul) and "
            "F.scaled_dot_product_attention, as one CUDA graph" if G == 1 else
            "the gather of the ancestors' K/V rows and of their scales, the dequantising "
            "multiply and F.scaled_dot_product_attention, four calls as one CUDA graph"),
    )
    if write:
        row["read_only_ms"] = timed_ms(lambda: run(kernel, at, None, W, nxt()), 50, graph=True)
        row["column_write_ms"] = timed_ms(lambda: column_write(nxt()), 50, graph=True)
        print(f"    the kernel read only (the caller's column) {row['read_only_ms']:.4f} ms | "
              f"the torch column write alone {row['column_write_ms']:.4f} ms", flush=True)
    row["plan"] = step_launch_plan(B, H, W, W, dh, 1 if int8 else isz, beam=G > 1)._asdict()
    if dtype == torch.bfloat16:
        check_deterministic(f"{name} ({'int8' if int8 else 'bf16'} cache)",
                            lambda: run(kernel, at, ks, W, writes=write), row)
    return row


def kernel_checks_int8(rows: dict) -> None:
    """The kernel pieces of the int8 paths, in f32 and bf16, into ``rows``
    under the labels of main(): row 10 over an int8 cache and over a bf16
    one at base.en b128 and large-v3 b12; the cross kernel's int8 branch
    at both int8 paths' shapes; the beam kernel's int8 read at the beam
    shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    for m, b, beam, _ in INT8_PATHS:
        dims, G = dims_for(m), max(beam, 1)
        label = int8_label(m, b, beam)
        rows.setdefault(label, {name: {} for name in KERNELS})
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            print(f"[kernels] cross_attention_step ({tag}, int8 K/V, {G} rows an audio)",
                  flush=True)
            rows[label]["cross_attention_step"][tag] = check_cross(dims, b, G, dtype, randn,
                                                                   int8=True)
            if beam:
                print(f"[kernels] beam_self_attention_step ({tag}, int8 cache)", flush=True)
                rows[label]["beam_self_attention_step"][tag] = check_read_step(
                    dims, b, G, dtype, randn, gen)
            torch.cuda.empty_cache()
    for m, b in (("base.en", 128), ("large-v3", 12)):
        for int8 in (True, False):
            label = f"{m} b{b} " + ("int8" if int8 else "bf16 cache")
            rows.setdefault(label, {name: {} for name in KERNELS})
            for dtype in (torch.float32, torch.bfloat16):
                tag = "f32" if dtype == torch.float32 else "bf16"
                print(f"[kernels] self_attention_step ({tag}, {m} b{b}, "
                      f"{'int8' if int8 else 'compute-dtype'} cache)", flush=True)
                rows[label]["self_attention_step"][tag] = check_read_step(
                    dims_for(m), b, 1, dtype, randn, gen, int8=int8)
                torch.cuda.empty_cache()


def time_beam_ranking(dims, A: int, G: int, randn) -> None:
    """Device time of the beam step's ranking of each beam's candidates: a
    stable descending sort of the cumulative log-probs [A, G, vocab] f32
    (torch.topk gives no order for ties on the card; the sort gives the
    reference's, the lower index first), and torch.topk beside it."""
    cum = randn(A, G, dims.n_vocab)
    ms_sort = timed_ms(lambda: decode_loop._sort_desc(cum), reps=50)
    ms_topk = timed_ms(lambda: cum.topk(G + 1, dim=-1), reps=50)
    print(f"[kernels] beam ranking over [{A}, {G}, {dims.n_vocab}] f32: stable sort "
          f"{ms_sort:.4f} ms a step (eager; torch.topk {ms_topk:.4f} ms)", flush=True)


def check_deterministic(name: str, kernel, row: dict) -> None:
    """Two calls of ``kernel`` on the same inputs must give bit-identical
    outputs (the redesigned kernels sum in a fixed order, with no atomics);
    recorded in ``row`` as ``bit_identical``."""
    a, b = kernel(), kernel()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    row["bit_identical"] = True
    print(f"  {name}: two calls bit-identical", flush=True)


def check_mlp(dims, B: int, dtype, randn, hidden: int | None = None) -> dict:
    """The fused decode MLP at the step shapes: unit-scale h [B, D],
    weights N(0, 1/n_in) as in init_random, b1 N(0, 0.1^2), the hidden
    width ``hidden`` (default 4D; a tensor-parallel shard's 4D / tp, whose
    partial fc2 sums the caller adds over the model group).  In bf16 also
    two calls bit-identical, and the kernel and the library calls timed
    cold in L2 (``cold_ms``, ``library_cold_ms``): rotating through
    n_text_layer weight sets, as a decode step finds a layer's weights (a
    medium.en layer's 16.8 MB and a large-v3 layer's 26 MB stay resident in
    the 50 MB L2 when one set is replayed)."""
    D, L = dims.n_text_state, dims.n_text_layer
    Fh = hidden or 4 * D
    isz = torch.tensor([], dtype=dtype).element_size()
    h = randn(B, D, dtype=dtype)
    layers = [(randn(Fh, D, dtype=dtype, scale=D**-0.5), randn(Fh, dtype=dtype, scale=0.1),
               randn(D, Fh, dtype=dtype, scale=Fh**-0.5))
              for _ in range(L if dtype == torch.bfloat16 else 1)]
    w1, b1, w2 = layers[0]
    approximate = "none" if dtype == torch.float32 else "tanh"

    def three_calls(w1=w1, b1=b1, w2=w2):  # F.linear -> F.gelu -> F.linear
        return F.linear(F.gelu(F.linear(h, w1, b1), approximate=approximate), w2)

    row = check_kernel(
        "decoder_mlp_step", dtype,
        lambda: decoder_mlp_step(h, w1, b1, w2), lambda: decoder_mlp_step_plain(h, w1, b1, w2),
        three_calls, nbytes=(2 * Fh * D + Fh + 2 * B * D) * isz, flops=4 * B * D * Fh,
        reps=50,
    )
    if dtype == torch.bfloat16:
        check_deterministic("decoder_mlp_step", lambda: decoder_mlp_step(h, w1, b1, w2), row)
        layer = rotating(L)
        row["cold_ms"] = timed_ms(lambda: decoder_mlp_step(h, *layers[layer()]), 50, True)
        row["library_cold_ms"] = timed_ms(lambda: three_calls(*layers[layer()]), 50, True)
        print(f"    cold in L2 (rotating {L} weight sets): kernel {row['cold_ms']:.4f} ms | "
              f"library {row['library_cold_ms']:.4f} ms", flush=True)
    return row


def random_decoder(dims, n_layer: int, dtype, gen, device) -> TextDecoder:
    """A ``TextDecoder`` of ``dims``' width with ``n_layer`` layers of seeded
    random weights drawn on ``device``: linear weights N(0, 1/n_in),
    embeddings N(0, 0.02^2), biases and LayerNorm offsets N(0, 0.1^2) and
    LayerNorm scales 1 + N(0, 0.1^2), so that a bias or a LayerNorm
    parameter a kernel drops or misplaces shows."""
    with torch.device("meta"):
        dec = TextDecoder(dims.n_vocab, dims.n_text_ctx, dims.n_text_state, dims.n_text_head,
                          n_layer)
    dec = dec.to_empty(device=device)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            r = torch.randn(p.shape, generator=gen, device=device)
            if "embedding" in name:
                p.copy_(r * 0.02)
            elif p.dim() == 2:
                p.copy_(r * p.shape[1] ** -0.5)
            else:
                p.copy_(r * 0.1 + (1.0 if name.endswith("ln.weight") else 0.0))
    return dec.to(dtype)


def layer_step_case(dims, n_layer: int, B: int, G: int, dtype, gen, device):
    """Inputs of one whole-decoder step of B rows in groups of G: x [B, D]
    (the embedded token), the cross K/V [L, B / G, H, 2, 64, Tk] and both
    caches [L, B, H, n_ctx, 64], all of unit scale."""
    D, H, n_ctx = dims.n_text_state, dims.n_text_head, dims.n_text_ctx

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (randn(B, D), randn(n_layer, B // G, H, 2, 64, dims.n_audio_ctx),
            randn(n_layer, B, H, n_ctx, 64), randn(n_layer, B, H, n_ctx, 64))


def layer_step(fn, weights, x, kv, caches, pos: int, ks, H: int, G: int, W: int) -> tuple:
    """One whole-decoder step by ``fn`` (the kernel's wrapper or its plain
    version) on ``caches``, written in place: (x out, the K columns
    [L, B, H, 64] and the V columns written at pos)."""
    kc, vc = caches
    out = fn(x, weights, kv, kc, vc, pos, ks, n_head=H, group=G, window=W)
    return out, kc[:, :, :, pos].clone(), vc[:, :, :, pos].clone()


def layer_phase_bytes(dims, B: int, G: int, pos: int) -> list:
    """Elements each of the whole-step kernel's eight phases must move in
    one layer (PHASES): the weights of its projections, the visible window
    of the self K/V (slots 0..pos of every row and head), the cross K/V."""
    D, H = dims.n_text_state, dims.n_text_head
    return [3 * D * D, 2 * B * H * (pos + 1) * 64, D * D, D * D,
            B // G * H * 2 * 64 * dims.n_audio_ctx, D * D, 4 * D * D, 4 * D * D]


# the whole-step kernel's checks against its plain version: (rows, rows an
# audio, window, pos); the bf16 check adds B 16 (the second n8 tile of rows
# and the widest split-K plan) and G 8 (the cross phase's widest instance)
LAYER_CASES = ((None, 1, STEP_WINDOW, STEP_WINDOW - 1), (None, 1, 448, 400), (None, 2, 448, 400))
LAYER_BF16_CASES = ((16, 2, 448, 400), (8, 8, 448, 400))


def check_layer_step(dims, B: int, dtype, gen) -> dict:
    """The whole-decoder-step kernel against its plain version on seeded
    random decoders (``random_decoder``) and unit-scale inputs: in f32 at
    full depth, in bf16 at LAYER_BF16_DEPTH layers (see TOL_BF16); at W 256,
    pos 255 and W 448, pos 400 with key_start in 1..231, and once with
    G = 2 (B / 2 audios of 2 rows) at W 448, pos 400; in bf16 also at 16
    rows (G 2) and at G 8 (one audio of 8 rows), both at W 448, pos 400
    (LAYER_BF16_CASES), and two calls bit-identical.  Compared: x out and
    every K/V column written; every other cache slot unchanged.  Timed at
    full depth, W 256, pos 255, no key_start, with CUDA events around
    back-to-back launches (a cooperative launch is not captured in a
    graph here); beside it the port's layered step as a CUDA graph (one
    incremental ``TextDecoder.forward``, ``step_kernel="append"``, at the
    same state) and the layer route's forward (this kernel with the
    embedding, the final LayerNorm and the logits around it)."""
    dev = torch.device("cuda")
    L, H, D, n_ctx = dims.n_text_layer, dims.n_text_head, dims.n_text_state, dims.n_text_ctx
    Tk = dims.n_audio_ctx
    isz = torch.tensor([], dtype=dtype).element_size()
    tag = str(dtype).split(".")[-1]
    name = "decoder_step_fused"
    tol = tolerance(name, dtype)
    depth = L if dtype == torch.float32 else LAYER_BF16_DEPTH
    dec = random_decoder(dims, depth, dtype, gen, dev)
    weights = decoder_step_weights(dec.blocks)
    worst, identical = (0.0, 0.0), {}
    cases = LAYER_CASES + (LAYER_BF16_CASES if dtype == torch.bfloat16 else ())
    for rows, G, W, pos in cases:
        rows = rows or B
        ks = torch.arange(rows, device=dev) * 37 % 231 + 1
        x, kv, kc, vc = layer_step_case(dims, depth, rows, G, dtype, gen, dev)
        before = (kc.clone(), vc.clone())
        plain_caches = (kc.clone(), vc.clone())
        got = layer_step(decoder_step_fused, weights, x, kv, (kc, vc), pos, ks, H, G, W)
        want = layer_step(decoder_step_fused_plain, weights, x, kv, plain_caches, pos, ks, H, G,
                          W)
        err = compare(f"{name} {tag} {depth} layers B {rows} G {G} W {W} pos {pos} key_start "
                      f"1..231 (x, K and V columns)", got, want, tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        for cache, old in zip((kc, vc), before):
            rest, old_rest = cache.clone(), old.clone()
            rest[:, :, :, pos] = 0
            old_rest[:, :, :, pos] = 0
            if not torch.equal(rest, old_rest):
                raise AssertionError(f"{name}: a cache slot other than pos changed")
        if dtype == torch.bfloat16 and (rows, G, W) == (B, 1, STEP_WINDOW):
            check_deterministic(name, lambda: decoder_step_fused(
                x, weights, kv, kc, vc, pos, ks, n_head=H, group=G, window=W), identical)
        del x, kv, kc, vc, before, plain_caches
    print("  cache: only slot pos of each layer written", flush=True)

    if depth != L:
        del dec, weights
        torch.cuda.empty_cache()
        dec = random_decoder(dims, L, dtype, gen, dev)
        weights = decoder_step_weights(dec.blocks)
    W, pos = STEP_WINDOW, STEP_WINDOW - 1
    x, kv, kc, vc = layer_step_case(dims, L, B, 1, dtype, gen, dev)
    tokens = torch.randint(0, dims.n_vocab, (B, 1), generator=gen, device=dev)

    def forward(route):
        return dec(tokens, pos, CrossKV(kv), KVCache(kc, vc), ctx_window=W, incremental=True,
                   step_kernel=route, step_weights=weights)

    layered_ms = timed_ms(lambda: forward("append"), reps=10, graph=True)
    route_ms = timed_ms(lambda: forward("layer"), reps=20)
    nbytes = (sum(t.numel() for layer in weights.layers for t in layer) + kv.numel()
              + 2 * L * B * H * (pos + 1) * 64 + 2 * L * B * D + 2 * B * D) * isz
    flops = 2 * B * 14 * D * D * L + 4 * B * H * 64 * ((pos + 1) + Tk) * L
    at = device_pos(pos)  # read by the kernel from device memory, as the decode loop's
    row = check_kernel(
        name, dtype,
        lambda: decoder_step_fused(x, weights, kv, kc, vc, at, None, n_head=H, group=1,
                                   window=W),
        lambda: decoder_step_fused_plain(x, weights, kv, kc, vc, at, None, n_head=H, group=1,
                                         window=W),
        None, nbytes=nbytes, flops=flops, reps=20, graph=False, checked=worst,
    )
    row["layered_step_ms"], row["layer_route_forward_ms"] = layered_ms, route_ms
    row.update(identical)
    print(f"    layered step (step_kernel=\"append\", one TextDecoder.forward, CUDA graph) "
          f"{layered_ms:.4f} ms | layer route forward {route_ms:.4f} ms", flush=True)

    # one more launch with the kernel's phase clock: the mean time of each
    # phase over the layers (block 0's view, its barrier wait included)
    clock = torch.zeros(8 * L + 1, dtype=torch.int64, device=dev)
    decoder_step_fused(x, weights, kv, kc, vc, pos, None, n_head=H, group=1, window=W,
                       clock=clock)
    torch.cuda.synchronize()
    spans = ((clock[1:] - clock[:-1]).view(L, 8).double().mean(dim=0) / 1e3).tolist()  # us
    phase_bytes = [n * isz for n in layer_phase_bytes(dims, B, 1, pos)]
    row["phase_us"] = dict(zip(PHASES, spans))
    row["phase_bound_us"] = {ph: n / MEM_BW * 1e6 for ph, n in zip(PHASES, phase_bytes)}
    row["phase_gbps"] = {ph: n / us / 1e3 for ph, us, n in zip(PHASES, spans, phase_bytes)}
    print(f"    phases, mean over {L} layers of one clocked launch "
          f"({(clock[-1] - clock[0]).item() / 1e6:.4f} ms in all): " + "; ".join(
              f"{ph} {us:.2f} us (bound {row['phase_bound_us'][ph]:.2f}; "
              f"{row['phase_gbps'][ph]:.0f} GB/s)" for ph, us in zip(PHASES, spans)), flush=True)
    del dec, weights, x, kv, kc, vc
    torch.cuda.empty_cache()
    return row


def kernel_checks_routes(dims, B: int) -> dict:
    """The kernels of the two greedy-step routes at their shapes (B rows,
    G = 1), in f32 and bf16: on the ctx route the read-only fused
    self-attention, the cross kernel and the MLP; on the layer route the
    whole-decoder-step kernel.  Returns {kernel: {"f32" | "bf16": row}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {name: {} for name in KERNELS}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] self_attention_fused_step ({tag})", flush=True)
        rows["self_attention_fused_step"][tag] = check_step_attention(
            dims, B, 1, dtype, randn, gen, fused=True
        )
        print(f"[kernels] cross_attention_step ({tag}, 1 row an audio)", flush=True)
        rows["cross_attention_step"][tag] = check_cross(dims, B, 1, dtype, randn)
        print(f"[kernels] decoder_mlp_step ({tag})", flush=True)
        rows["decoder_mlp_step"][tag] = check_mlp(dims, B, dtype, randn)
        print(f"[kernels] decoder_step_fused ({tag})", flush=True)
        rows["decoder_step_fused"][tag] = check_layer_step(dims, B, dtype, gen)
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


def parity_audio():
    """(the rng, for the prompts after it; PARITY_WINDOWS seeded 30 s
    windows of noise, each louder than the last)."""
    rng = np.random.default_rng(2)
    return rng, np.stack([
        rng.standard_normal(480_000).astype(np.float32) * np.float32(0.05 * (i + 1))
        for i in range(PARITY_WINDOWS)
    ])


def parity(dims, label: str) -> None:
    print(f"[parity] {label}, f32, {PARITY_WINDOWS} windows, {SAMPLE_LEN} steps", flush=True)
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    cfg = filter_config(dims)
    _, audio = parity_audio()
    initial = np.full((PARITY_WINDOWS, 1), SOT, np.int64)
    out = {}
    reset_launches()
    for kernels in (True, False):
        mel = log_mel_frontend(audio, dims.n_mels, kernels=kernels)
        # the first step's logits from the prefill of the window the decode
        # then runs on
        windows = WindowCache()
        win = windows.get(model, greedy_shape(GreedyMode(), PARITY_WINDOWS, 1, 1, SAMPLE_LEN,
                                              False, cfg, kernels)[0])
        first = _encode_and_prefill(win, mel, torch.as_tensor(initial, device="cuda"), 0,
                                    NO_SPEECH, None)[0]
        res = decode_greedy(
            model, mel, initial, 1, 0, cfg, GreedyMode(), SAMPLE_LEN, NO_SPEECH,
            kernels=kernels, graphs=kernels, windows=windows,
        )
        del windows, win
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


SOP = 50360  # <|startofprev|>


def bench_prompts(rng, n_audio: int, n_text_ctx: int):
    """Per-audio prompts of 200..221 tokens, as bench.py's BENCH_PROMPTED
    builds them: they fill the 232-wide prefill bucket.  Returns
    (initial tokens, key_start, sample_begin, sot_idx)."""
    prompts = [rng.integers(300, 40_000, size=int(200 + (i % 4) * 7)).tolist()
               for i in range(n_audio)]
    initial, key_start, sample_begin, sot_idx = build_batch_prompts(
        prompts, [SOT], SOT, SOP, n_text_ctx=n_text_ctx
    )
    assert sample_begin == 232, sample_begin
    return initial.astype(np.int64), key_start.astype(np.int64), sample_begin, sot_idx


def selection_margins(logits, s, beam: int, eot: int) -> torch.Tensor:
    """[n_audio] one beam step's selection margin: the gap between the
    score of the beam-th unfinished candidate, in the order the step ranks
    them, and the next candidate's.  A swap there changes which candidates
    continue."""
    n_audio = logits.shape[0] // beam
    cum = (s.sum_logprobs[:, None] + log_softmax(logits)).view(n_audio, beam, -1)
    top, tok = (t[..., : beam + 1] for t in decode_loop._sort_desc(cum))
    score, order = decode_loop._sort_desc(top.reshape(n_audio, -1))
    tok = tok.reshape(n_audio, -1).gather(1, order)
    last = ((tok != eot).cumsum(dim=-1) < beam).sum(dim=-1, keepdim=True)  # the beam-th unfinished
    gap = score.gather(1, last) - score.gather(1, last + 1)
    return gap[:, 0].nan_to_num(nan=float("inf"))


def beam_ranking(logits, s, beam: int, eot: int):
    """One beam step's ranking as ``decode_loop._beam_step`` makes it: per
    audio, the candidates in score order through the beam-th unfinished one
    (each coded source beam * V + token, -1 past it), and the smallest gap
    between consecutive scores among them and the next one.  Two rankings
    with equal codes continue the same beams with the same tokens, in the
    same slots, and finish the same candidates in the same order."""
    n_audio, V = logits.shape[0] // beam, logits.shape[-1]
    cum = (s.sum_logprobs[:, None] + log_softmax(logits)).view(n_audio, beam, V)
    top, tok = (t[..., : beam + 1] for t in decode_loop._sort_desc(cum))
    score, order = decode_loop._sort_desc(top.reshape(n_audio, -1))
    tok = tok.reshape(n_audio, -1).gather(1, order)
    code = order // (beam + 1) * V + tok
    last = ((tok != eot).cumsum(dim=-1) < beam).sum(dim=-1, keepdim=True)  # the beam-th unfinished
    at = torch.arange(code.shape[1], device=code.device)
    code = torch.where(at <= last, code, -1)
    gaps = (score[:, :-1] - score[:, 1:]).nan_to_num(nan=float("inf"))
    gap = torch.where(at[:-1] <= last, gaps, float("inf")).amin(dim=-1)
    return code, gap


def clone_cache(cache: KVCache) -> KVCache:
    """A copy of ``cache``, its int8 scales included."""
    return KVCache(*(None if t is None else t.clone()
                     for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))


def checking_step_logits(logits_fn, check_pos, diffs: list, plain: dict | None = None):
    """A stand-in for ``decode_loop._step_logits`` on the kernel path: at
    the positions ``check_pos`` it runs the plain step on a copy of the
    kernel path's own state (tokens, caches and their scales, the ancestor
    table), then the kernel step, and appends to ``diffs`` (pos, the max
    abs difference of their filtered logits, the int8 values of the
    column the step wrote that the two rounded apart).  With ``plain`` it
    does so at every position, and leaves the plain step's filtered logits
    in ``plain["logits"]``."""

    def checking(model, tokens, pos, cross_kv, cache, *args, **kw):
        at = int(pos)  # the eager loop's device pos, read on the host here
        if at not in check_pos and plain is None:
            return logits_fn(model, tokens, pos, cross_kv, cache, *args, **kw)
        *head, kernels = args
        plain_cache = clone_cache(cache)
        plain_kw = {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}
        want = logits_fn(model, tokens, pos, cross_kv, plain_cache, *head, False, **plain_kw)
        got = logits_fn(model, tokens, pos, cross_kv, cache, *args, **kw)
        if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
            raise AssertionError(f"step at position {pos}: filtered-logit masks differ")
        if at in check_pos:
            fin = torch.isfinite(want)
            flips = 0
            if cache.quantized:
                flips = sum(int((a[:, :, :, at - 1] != b[:, :, :, at - 1]).sum())
                            for a, b in ((cache.k, plain_cache.k), (cache.v, plain_cache.v)))
            diffs.append((at, (got[fin] - want[fin]).abs().max().item(), flips))
        if plain is not None:
            plain["logits"] = want
        return got

    return checking


def report_step_diffs(what: str, diffs: list, tol: float, check_pos) -> None:
    for pos, d, flips in diffs:
        print(f"  {what} step at position {pos}, on the kernel path's state: filtered logits "
              f"max_abs_err {d:.3e} (tolerance {tol:g})"
              + (f"; int8 values of its column rounded apart: {flips}" if flips else ""),
              flush=True)
    if not diffs or diffs[0][0] != check_pos[0] or max(d for _, d, _ in diffs) > tol:
        raise AssertionError(f"{what}: step logits {diffs} (tolerance {tol:g})")


def parity_beam(dims, label: str, beam: int, int8_kv: bool = False) -> None:
    """Beam search through the kernels and through the plain versions, f32,
    prompted as BENCH_PROMPTED (``int8_kv``: with int8 K/V, whose logit
    tolerance is INT8_LOGIT_TOL, its scores' INT8_SCORE_RTOL): the steps at
    BEAM_CHECK_POS plain against kernel on the kernel path's state;
    candidates equal, scores within 1e-4 + SCORE_RTOL |plain|, unless the
    plain path's selection margin of that audio fell below the logit
    tolerance at some step; no-speech probabilities within 1e-5.

    With int8 K/V the two runs' states drift apart: a column that the two
    paths compute a few ulps apart rounds apart in an int8 value now and
    then (counted at the checked steps), and the scores walk up to a few
    1e-3 apart (INT8_SCORE_RTOL), past selection margins far above the
    logit tolerance.  So the kernel path's every ranking is also held, on
    its own state, to the plain step's on a copy of that state (at every
    incremental step; its first step, on the prefill's logits, to the plain
    run's first): the same candidates in the same order unless the plain
    ranking has a gap below the logit tolerance there.  Where that holds at
    every step, candidates that differ at the end come from the drift, not
    from a ranking the kernels got wrong."""
    tol, score_rtol = (INT8_LOGIT_TOL, INT8_SCORE_RTOL) if int8_kv else (1e-3, SCORE_RTOL)
    print(f"[parity] {label}, f32, {PARITY_WINDOWS} windows, prompted, beam {beam}"
          + (", int8 K/V" if int8_kv else ""), flush=True)
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    cfg = filter_config(dims)
    eot = cfg.token_id_eot
    rng, audio = parity_audio()
    initial, key_start, sample_begin, sot_idx = bench_prompts(rng, PARITY_WINDOWS, dims.n_text_ctx)
    sample_len = min(SAMPLE_LEN, dims.n_text_ctx - sample_begin)
    mode = BeamSearchMode(beam_size=beam, patience=1.0)
    dev = model.device
    margins = torch.full((PARITY_WINDOWS,), float("inf"), device=dev)
    n_close = torch.zeros(PARITY_WINDOWS, dtype=torch.long, device=dev)
    step_fn, logits_fn = decode_loop._beam_step, decode_loop._step_logits
    step_diffs = []
    # the kernel path's rankings against the plain step's on its state
    plain = {} if int8_kv else None
    first = {}  # each run's first ranking (codes, gaps), on the prefill's logits
    n_ranked, n_near = 0, torch.zeros(PARITY_WINDOWS, dtype=torch.long, device=dev)
    wrong = torch.zeros(PARITY_WINDOWS, dtype=torch.long, device=dev)

    def recording_step(logits, s, *args):
        # the plain path's selection margins, read from each step's inputs
        nonlocal margins, n_close
        m = selection_margins(logits, s, beam, eot)
        margins, n_close = torch.minimum(margins, m), n_close + (m < tol)
        first.setdefault(False, beam_ranking(logits, s, beam, eot))
        return step_fn(logits, s, *args)

    def ranking_step(logits, s, *args):
        nonlocal n_ranked, n_near, wrong
        want = plain.pop("logits", None)
        if want is None:
            first.setdefault(True, beam_ranking(logits, s, beam, eot))
        else:
            (got, _), (exp, gap) = (beam_ranking(x, s, beam, eot) for x in (logits, want))
            near = gap < tol
            n_ranked, n_near = n_ranked + 1, n_near + near
            wrong = wrong + ((got != exp).any(dim=-1) & ~near)
        return step_fn(logits, s, *args)

    out = {}
    reset_launches()
    for kernels in (True, False):
        mel = log_mel_frontend(audio, dims.n_mels, kernels=kernels)
        if kernels:
            decode_loop._step_logits = checking_step_logits(logits_fn, BEAM_CHECK_POS, step_diffs,
                                                             plain)
            if int8_kv:
                decode_loop._beam_step = ranking_step
        else:
            decode_loop._beam_step = recording_step
        try:
            out[kernels] = decode_beam(
                model, mel, initial, sample_begin, sot_idx, cfg, mode, sample_len, NO_SPEECH,
                key_start=key_start, kernels=kernels, quantize_kv=int8_kv, graphs=False,
            )
        finally:
            decode_loop._beam_step, decode_loop._step_logits = step_fn, logits_fn
        if kernels:
            n_plain = n_ranked if int8_kv else len(step_diffs)
            print(f"  kernel-path launches: {dict(LAUNCHES)} (with {n_plain} plain "
                  f"steps of the logits check, which launch no kernel)", flush=True)
    torch.cuda.synchronize()
    report_step_diffs("beam", step_diffs, tol, BEAM_CHECK_POS)
    if int8_kv:
        (got, _), (exp, gap) = first[True], first[False]
        wrong = wrong + ((got != exp).any(dim=-1) & (gap >= tol))
        print(f"  rankings of the kernel path, each on its own state against the plain step's: "
              f"{n_ranked} steps and the first; plain gaps below {tol:g} at "
              f"{n_near.tolist()} steps an audio; different where the gap was not: "
              f"{wrong.tolist()}", flush=True)
        if wrong.any():
            raise AssertionError(f"beam rankings differ from the plain step's on the kernel "
                                 f"path's state where its gap was at least {tol:g}: "
                                 f"{wrong.tolist()} steps an audio")

    res_k, res_p = out[True], out[False]
    print(f"  steps: kernel path {res_k.steps}, plain path {res_p.steps}", flush=True)
    dn = (res_k.no_speech_probs - res_p.no_speech_probs).abs().max().item()
    print(f"  no-speech probs: max_abs_err {dn:.3e} (tolerance 1e-5)", flush=True)
    if dn > 1e-5:
        raise AssertionError("no-speech probabilities differ beyond 1e-5")
    # scores are f32 sums of up to 216 log-probs, near -1,200 at random
    # weights, where one f32 step is 1.2e-4: a flat 1e-4 is less than one
    # step there, so the tolerance adds 2e-6 |plain|, some 20 steps
    for a in range(PARITY_WINDOWS):
        m, close = margins[a].item(), int(n_close[a])
        margin = (f"smallest plain selection margin {m:.3e} (below {tol:g} at {close} of "
                  f"{res_p.steps + 1} steps)")
        if torch.equal(res_k.candidates[a], res_p.candidates[a]):
            d = (res_k.scores[a] - res_p.scores[a]).abs()
            share = (d / (1e-4 + score_rtol * res_p.scores[a].abs())).max().item()
            print(f"  audio {a}: {beam} candidates identical; scores max_abs_err "
                  f"{d.max().item():.3e} (tolerance 1e-4 + {score_rtol:g}|plain|, share used "
                  f"{share:.3f}); {margin}", flush=True)
            if share > 1:
                raise AssertionError(f"audio {a}: scores differ beyond the tolerance")
            continue
        print(f"  audio {a}: candidates differ; {margin}"
              + ("; every ranking of the kernel path agreed with the plain step's on its state"
                 if int8_kv else ""), flush=True)
        if m >= tol and not int8_kv:
            raise AssertionError(f"audio {a}: candidates differ with margin {m:.3e} >= {tol:g}")
    del model
    torch.cuda.empty_cache()


def parity_routes(dims, label: str, routes=("layer", "ctx"), int8: bool = False,
                  tol: float | None = None) -> None:
    """The greedy decode through each step route, f32, through the kernels
    and through the plain versions: prompted as BENCH_PROMPTED, or (``int8``:
    int8 weights and K/V on the append route) unprompted with the logit
    tolerance INT8_LOGIT_TOL.  The filtered logits of the steps at
    GREEDY_CHECK_POS (INT8_GREEDY_CHECK_POS: the first step, both ends of
    the 128 phase, one at 256), plain against kernel on the kernel path's
    own state, within the tolerance (``tol`` where given); tokens equal per
    row unless the plain path's top-2 margin at the first divergent
    position is below it; no-speech probabilities within 1e-5."""
    default, check_pos = ((INT8_LOGIT_TOL, INT8_GREEDY_CHECK_POS) if int8
                          else (1e-3, GREEDY_CHECK_POS))
    tol = default if tol is None else tol
    print(f"[parity] {label}, f32, {PARITY_WINDOWS} windows, "
          + ("unprompted, greedy, int8 weights and K/V" if int8 else
             f"prompted, greedy, step_kernel {' and '.join(routes)}"), flush=True)
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    if int8:
        quantize_params(model)
    cfg = filter_config(dims)
    rng, audio = parity_audio()
    if int8:
        initial, key_start, sample_begin, sot_idx = np.full((PARITY_WINDOWS, 1), SOT), None, 1, 0
        sample_len = SAMPLE_LEN
    else:
        initial, key_start, sample_begin, sot_idx = bench_prompts(rng, PARITY_WINDOWS,
                                                                  dims.n_text_ctx)
        sample_len = min(SAMPLE_LEN, dims.n_text_ctx - sample_begin)
    logits_fn, update_fn = decode_loop._step_logits, decode_loop._greedy_update
    for route in routes:
        step_diffs, margins = [], {}

        def recording_update(logits, tokens, pos, *args):
            # the plain path's top-2 margin of every row at every position
            top = logits.topk(2, dim=-1).values
            margins[int(pos)] = (top[:, 0] - top[:, 1]).tolist()
            return update_fn(logits, tokens, pos, *args)

        out = {}
        for kernels in (True, False):
            reset_launches()
            mel = log_mel_frontend(audio, dims.n_mels, kernels=kernels)
            if kernels:
                decode_loop._step_logits = checking_step_logits(logits_fn, check_pos, step_diffs)
            else:
                decode_loop._greedy_update = recording_update
            try:
                out[kernels] = decode_greedy(
                    model, mel, initial, sample_begin, sot_idx, cfg, GreedyMode(), sample_len,
                    NO_SPEECH, key_start=key_start, kernels=kernels, step_kernel=route,
                    quantize_kv=int8, graphs=False,
                )
            finally:
                decode_loop._step_logits, decode_loop._greedy_update = logits_fn, update_fn
            if kernels:
                print(f"  {route}: kernel-path launches {dict(LAUNCHES)} (with "
                      f"{len(step_diffs)} plain steps of the logits check)", flush=True)
        torch.cuda.synchronize()
        report_step_diffs(route, step_diffs, tol, check_pos)
        res_k, res_p = out[True], out[False]
        dn = (res_k.no_speech_probs - res_p.no_speech_probs).abs().max().item()
        print(f"  {route}: steps {res_k.steps} (plain {res_p.steps}); no-speech probs "
              f"max_abs_err {dn:.3e} (tolerance 1e-5)", flush=True)
        if dn > 1e-5:
            raise AssertionError("no-speech probabilities differ beyond 1e-5")
        tk, tp = res_k.candidates[:, 0], res_p.candidates[:, 0]
        for r in range(PARITY_WINDOWS):
            diff = (tk[r] != tp[r]).nonzero()
            if diff.numel() == 0:
                print(f"  {route} row {r}: identical", flush=True)
                continue
            pos = int(diff[0])
            margin = margins[pos][r]
            print(f"  {route} row {r}: diverges at position {pos}; plain top-2 margin "
                  f"{margin:.3e}", flush=True)
            if margin >= tol:
                raise AssertionError(f"{route} row {r} diverges at {pos} with margin {margin:.3e}")
    del model
    torch.cuda.empty_cache()


def ln_launches(dims, encoder_calls: int, layered_passes: int, layer_bodies: int = 0,
                encoder_blocks: int | None = None) -> int:
    """Row 3's launches (``ln_fused``), every LayerNorm of the model: each
    encoder block's first LayerNorm (``encoder_blocks`` block calls, by
    default n_audio_layer an encoder call; row 2 takes each block's
    second) and ``ln_post`` once an encoder call; 3 n_text_layer + 1 a
    layered decoder pass (a prefill of any width, a width-1 pass, a step
    body of the append, ctx, beam or int8 route: three a layer and the
    last); 1 a body of the layer route (row 12 keeps its own LayerNorms)."""
    blocks = dims.n_audio_layer * encoder_calls if encoder_blocks is None else encoder_blocks
    return (blocks + encoder_calls + (3 * dims.n_text_layer + 1) * layered_passes
            + layer_bodies)


def expected_launches(dims, bodies: int, n_passes: int, route: str,
                      int8_weights: bool = False) -> dict:
    """The launch count of each kernel on one e2e batch (one encoder call,
    one prefill) of ``bodies`` incremental step bodies
    (``DecodeResult.bodies``: the live steps, the no-op steps past the end
    of the last check interval and the warm-up body of each phase a call
    captures, each of which launches the step's kernels) and ``n_passes``
    width-1 decoder passes: cross attention n_text_layer times a width-1
    pass, the step kernels of the route n_text_layer times a body (the beam
    kernel in the append kernel's place on the beam path, row 10 on the
    greedy path over an int8 cache, route "int8"; no MLP kernel under int8
    weights), the whole-step kernel once a body; the LayerNorms as
    ``ln_launches`` counts them over the encoder call, the prefill and the
    bodies."""
    L = dims.n_text_layer
    layered = route != "layer"
    expect = dict.fromkeys(LAUNCHES, 0)  # no other kernel, and no fallback route
    expect.update({
        "log_mel": 1,
        "ln_fused": ln_launches(dims, 1, 1 + (bodies if layered else 0),
                                0 if layered else bodies),
        "residual_ln": dims.n_audio_layer,
        "encoder_attention_merged": dims.n_audio_layer,
        "cross_attention_step": L * (n_passes if layered else n_passes - bodies),
        "self_attention_append_step": L * bodies if route == "append" else 0,
        "beam_self_attention_step": L * bodies if route == "beam" else 0,
        "decoder_mlp_step": L * bodies if layered and not int8_weights else 0,
        "self_attention_fused_step": L * bodies if route == "ctx" else 0,
        "decoder_step_fused": bodies if route == "layer" else 0,
        "self_attention_step": L * bodies if route == "int8" else 0,
    })
    return expect


# The captured decode loop against the eager one, by decode path (printed
# in [graphs] lines; the run's JSON line carries them too)
LOOPS: dict = {}
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
              "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
              "cudaMemsetAsync")
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def host_calls(fn) -> dict:
    """The CUDA runtime calls the host makes in one call of ``fn`` (under
    torch.profiler with the host's activity): launches (kernels, graphs,
    copies, sets) and synchronising calls, by name; empty where the trace
    holds no runtime call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in HOST_CALLS or name in HOST_SYNCS:
            counts[name] = counts.get(name, 0) + 1
    return counts


def same_decode(a, b) -> bool:
    """Whether two DecodeResults are bit-equal: candidates, scores,
    no-speech probabilities, steps."""
    return (torch.equal(a.candidates, b.candidates) and torch.equal(a.scores, b.scores)
            and torch.equal(a.no_speech_probs, b.no_speech_probs) and a.steps == b.steps)


def loop_report(label: str, graph_res, eager_res, ms_graph: float, ms_eager: float, first=None,
                t_first: float = 0.0, mem: dict | None = None, host: dict | None = None,
                phases: int = 3, full: tuple | None = None) -> None:
    """Holds a path's captured loop to its eager one (``graphs=False``, the
    same kernels, the same budget): candidates, scores, no-speech
    probabilities and steps bit-equal; the captured loop's host syncs at
    most ceil(steps / k) + 3 (one more at most a phase, three phases), in
    the compared run and in ``full`` (the timed full-budget captured run
    and its ms a step); prints ms a step both ways, syncs and bodies a
    window, the captures of the first call and their seconds, k, the memory
    the cached window adds and the host's runtime calls of a cut window
    (``host``: {"graphs": calls, "eager": calls})."""
    if not same_decode(graph_res, eager_res):
        raise AssertionError(f"{label}: the captured loop differs from graphs=False")
    k = decode_loop.CHECK_EVERY
    for res in (graph_res,) + (() if full is None else (full[0],)):
        bound = -(-res.steps // k) + phases
        if res.syncs > bound or res.loop != "graphs":
            raise AssertionError(f"{label}: {res.syncs} syncs over {res.steps} steps (bound "
                                 f"{bound}), loop {res.loop}")
    steps = graph_res.steps
    row = {"steps": steps, "ms_step_graphs": ms_graph, "ms_step_eager": ms_eager,
           "syncs_graphs": graph_res.syncs, "syncs_eager": eager_res.syncs,
           "bodies_graphs": graph_res.bodies, "k": k, "loop_eager": eager_res.loop}
    text = (f"[graphs] {label}: captured loop bit-equal to graphs=False (candidates, scores, "
            f"no-speech, {steps} steps); ms a step {ms_graph:.3f} captured, {ms_eager:.3f} "
            f"eager ({ms_eager / ms_graph:.2f}x); host syncs a window {graph_res.syncs} "
            f"captured (k {k}; bound {-(-steps // k) + phases}), {eager_res.syncs} eager; "
            f"bodies {graph_res.bodies}")
    if full is not None:
        res, ms = full
        row.update(full_steps=res.steps, full_ms_step_graphs=ms, full_syncs_graphs=res.syncs)
        text += (f"; the full window captured: {res.steps} steps, {ms:.3f} ms a step, "
                 f"{res.syncs} syncs")
    if first is not None:
        row.update(captures=first.captures, capture_s=first.capture_seconds, first_call_s=t_first)
        text += (f"; first call {t_first:.3f} s with {first.captures} captures in "
                 f"{first.capture_seconds:.3f} s")
    if mem:
        row.update(mem)
        text += (f"; memory: the cached window holds {mem['held_mb']:.1f} MB, peak "
                 f"+{mem['peak_graphs_mb']:.1f} MB over the call before it (eager call "
                 f"+{mem['peak_eager_mb']:.1f} MB)")
    if host:
        row["host_calls"] = host
        text += "; host runtime calls of a " + "; ".join(
            f"{way} window: {sum(n for c, n in calls.items() if c in HOST_CALLS)} launches "
            f"{calls}" for way, calls in host.items())
    LOOPS[label] = row
    print(text, flush=True)


def e2e_routes(dims, name: str, batch: int) -> dict:
    """Greedy decode of ``batch`` audios in bf16 at full width and depth,
    prompted as BENCH_PROMPTED, through each step route, the step captured
    (one window cache a route: the first call captures): ``layer`` timed
    E2E_REPS times and profiled once, ``ctx`` and ``append`` timed once
    each, then each route once with ``graphs=False`` (the eager loop),
    held to the captured loop bit for bit (``loop_report``), on the same
    audios and prompts.  Returns {route: launches}."""
    print(f"[e2e] {name} bf16 batch {batch}, greedy, prompted: step_kernel layer {E2E_REPS} "
          f"timed runs, ctx and append one each; each route also eagerly", flush=True)
    t0 = time.perf_counter()
    model = e2e_model(dims)
    print(f"  init_random (or the model of the last e2e phase) {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = filter_config(dims)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((batch, 480_000)).astype(np.float32) * np.float32(0.1)
    initial, key_start, sample_begin, sot_idx = bench_prompts(rng, batch, dims.n_text_ctx)
    sample_len = min(SAMPLE_LEN, dims.n_text_ctx - sample_begin)
    print(f"  sample_begin {sample_begin}, budget {sample_len} tokens", flush=True)
    windows = {route: WindowCache() for route in ROUTES}

    def run(a, route, budget=sample_len, graphs=True):
        mel = log_mel_frontend(a, dims.n_mels, dtype=torch.bfloat16)
        res = decode_greedy(model, mel, initial, sample_begin, sot_idx, cfg, GreedyMode(), budget,
                            NO_SPEECH, key_start=key_start, step_kernel=route, graphs=graphs,
                            windows=windows[route] if graphs else None)
        torch.cuda.synchronize()
        return res

    for route in ROUTES:  # warm-up: kernel libraries, cuBLAS set-up
        run(audio + np.float32(0.001), route, budget=4, graphs=False)
    prompt = torch.as_tensor(initial, device="cuda")
    ks = torch.as_tensor(key_start, device="cuda")
    # the prefill into a window's buffers in place, as the decode runs it (a
    # window of the routes' shape, made outside the timing and freed after)
    split_win = DecodeWindow(model, greedy_shape(GreedyMode(), batch, prompt.shape[1],
                                                 sample_begin, sample_len, True, cfg, True)[0])

    def timed_part(with_prefill: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = log_mel_frontend(audio, dims.n_mels, dtype=torch.bfloat16)
        if with_prefill:
            _encode_and_prefill(split_win, mel, prompt, sot_idx, NO_SPEECH, ks)
        else:
            model.encoder(mel)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_enc, t_pre = timed_part(False), timed_part(True)
    del split_win
    torch.cuda.empty_cache()
    print(f"  split: mel+encoder {t_enc:.3f} s; prefill {t_pre - t_enc:.3f} s (into a "
          f"window's buffers)", flush=True)
    launches, results = {}, {}
    for route in ROUTES:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = run(audio, route)  # makes the route's window: its phases captured
        t_first = time.perf_counter() - t0
        mem = {"held_mb": (torch.cuda.memory_allocated() - base) / 1e6,
               "peak_graphs_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
        times = []
        for _ in range(E2E_REPS if route == "layer" else 1):
            reset_launches()
            t0 = time.perf_counter()
            res = run(audio, route)
            times.append(time.perf_counter() - t0)
            launches[route] = dict(LAUNCHES)
            expect = expected_launches(dims, res.bodies, res.bodies, route)
            if res.steps < 1 or launches[route] != expect:
                raise AssertionError(f"e2e {route}: launches {launches[route]}, expected {expect}")
        cand = res.candidates
        if cand.shape != (batch, 1, dims.n_text_ctx) or not torch.isfinite(res.scores).all():
            raise AssertionError(f"e2e {route}: malformed decode result")
        if not ((cand[:, 0, :sample_begin] == prompt).all()
                and (cand[:, 0, sample_begin] >= cfg.token_id_ts_begin).all()
                and (cand[:, 0, sample_begin + 1:] == cfg.token_id_eot).any(dim=-1).all()):
            raise AssertionError(f"e2e {route}: prompt, first timestamp or EOT missing")
        if not ((0 <= res.no_speech_probs) & (res.no_speech_probs <= 1)).all():
            raise AssertionError(f"e2e {route}: no-speech probabilities outside [0, 1]")
        results[route] = res
        elapsed = float(np.median(times))
        steps = res.steps
        print(f"  {route}: steps {steps}; runs {', '.join(f'{t:.3f}' for t in times)} s; "
              f"median {elapsed:.3f} s, {batch * 30.0 / elapsed:.2f} audio-s/s; steps "
              f"{elapsed - t_pre:.3f} s, {(elapsed - t_pre) / steps * 1e3:.2f} ms a step; "
              f"launches of the port's kernels a step "
              f"{sum(launches[route].values()) / steps:.2f}", flush=True)
        print(f"  {route} launches: {launches[route]}", flush=True)

        cmp_len = LOOP_CMP_STEPS["prompted"]
        run(audio, route, cmp_len)  # the cut window's own capture
        t0 = time.perf_counter()
        cmp_graph = run(audio, route, cmp_len)
        t_cmp = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        eager = run(audio, route, cmp_len, graphs=False)
        t_eager = time.perf_counter() - t0
        mem["peak_eager_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        if dict(LAUNCHES) != expected_launches(dims, eager.bodies, eager.bodies, route):
            raise AssertionError(f"e2e {route} eager: launches {dict(LAUNCHES)}")
        run(audio, route, PROFILE_STEPS)  # the profiled window's own capture
        host = {way: host_calls(lambda g=g: run(audio, route, PROFILE_STEPS, graphs=g))
                for way, g in (("captured", True), ("eager", False))}
        loop_report(f"{name} b{batch} greedy prompted, {route}", cmp_graph, eager,
                    (t_cmp - t_pre) / cmp_graph.steps * 1e3,
                    (t_eager - t_pre) / eager.steps * 1e3, first, t_first, mem,
                    {f"{way} {PROFILE_STEPS}-token": c for way, c in host.items()},
                    full=(res, (elapsed - t_pre) / steps * 1e3))
        # one incremental step of the route: a replay of its captured body
        # (the window has ended, so the step is a no-op that launches every
        # kernel of a step)
        win = next(iter(windows[route]._windows.values()))
        print(f"  {route}: one step (a replay of the captured body) under torch.profiler: "
              f"{device_launches(lambda: win.run_phase_steps(win.phases[-1], 1))} device "
              f"launches (kernels and copies)", flush=True)
    same = [int((results[r].candidates == results["append"].candidates).all(dim=-1).sum())
            for r in ROUTES]
    print(f"  rows whose tokens equal the append route's (bf16 rounds at other places on each "
          f"route): {dict(zip(ROUTES, same))} of {batch}", flush=True)
    profile_run(lambda a: run(a, "layer"), audio, "one e2e run of the layer route")
    del model, windows, win
    torch.cuda.empty_cache()
    return launches


@functools.lru_cache(maxsize=1)
def e2e_model(dims):
    """A seed-0 bf16 model of ``dims`` at full width and depth, kept for the
    next e2e phase of the same model (medium.en's three share one): the
    scales of ``init_random`` (linear weights N(0, 1/n_in), conv and
    embedding weights N(0, 0.02^2), biases 0, LayerNorms 1 and 0), drawn
    on the card by torch's CUDA generator, where ``init_random`` draws
    every weight with numpy on the host (large-v3's 1.55 B in tens of
    seconds).  The e2e paths hold no result to a reference, so any seeded
    weights serve."""
    model = _empty_model(dims, torch.bfloat16, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0 if name.endswith(("ln.weight", "ln_post.weight")) else 0.0)
            else:
                std = 0.02 if "conv" in name or "embedding" in name else p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * std)
    return model


def e2e(dims, name: str, batch: int, beam: int = 0, int8_weights: bool = False,
        int8_kv: bool = False, reps=None, summary=None) -> dict:
    """One path in bf16 at full width and depth: greedy and unprompted, or
    (``beam`` > 0) beam search prompted as bench.py's BENCH_PROMPTED; with
    int8 weights (``quantize_params``) and int8 K/V (``quantize_kv``) as
    asked; the step captured (a window cache: the first call captures, and
    is timed apart), ``reps`` timed runs (default E2E_REPS, or
    E2E_REPS_CUT's), then one run with ``graphs=False`` held to them bit
    for bit (``loop_report``), each run's launches checked.
    ``summary`` (a dict) takes audio-s/s, ms a step and the profiled run's
    launches and device busy ms a pass."""
    what = f"beam {beam}, prompted" if beam else "greedy, unprompted"
    what += "".join(f", int8 {w}" for w, on in (("weights", int8_weights), ("K/V", int8_kv)) if on)
    if reps is None:
        reps = E2E_REPS_CUT.get(name + (" int8" if int8_weights else " int8 KV" if int8_kv
                                        else ""), E2E_REPS)
    print(f"[e2e] {name} bf16 batch {batch}, {what}, {reps} timed runs", flush=True)
    t0 = time.perf_counter()
    if int8_weights:  # its own model: quantize_params works in place
        model = quantize_params(init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda"))
    else:
        model = e2e_model(dims)
    made = ("init_random + quantize_params" if int8_weights
            else "init_random (or the model of the last e2e phase)")
    print(f"  {made} {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = filter_config(dims)
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((batch, 480_000)).astype(np.float32) * np.float32(0.1)
    if beam:
        initial, key_start, sample_begin, sot_idx = bench_prompts(rng, batch, dims.n_text_ctx)
        sample_len = min(SAMPLE_LEN, dims.n_text_ctx - sample_begin)
        mode, decode, group = BeamSearchMode(beam_size=beam, patience=1.0), decode_beam, beam
    else:
        initial, key_start, sample_begin, sot_idx = np.full((batch, 1), SOT, np.int64), None, 1, 0
        sample_len, mode, decode, group = SAMPLE_LEN, GreedyMode(), decode_greedy, 1
    print(f"  sample_begin {sample_begin}, budget {sample_len} tokens", flush=True)
    windows = WindowCache()

    def run(a, budget=sample_len, graphs=True):
        mel = log_mel_frontend(a, dims.n_mels, dtype=torch.bfloat16)
        res = decode(model, mel, initial, sample_begin, sot_idx, cfg, mode, budget,
                     NO_SPEECH, key_start=key_start, quantize_kv=int8_kv, graphs=graphs,
                     windows=windows if graphs else None)
        torch.cuda.synchronize()
        return res

    route = "beam" if beam else "int8" if int8_kv else "append"
    # a one-token prefill is a decoder pass of width 1, so it takes the
    # cross kernel too, but not the incremental-step kernels
    one_token = 1 if sample_begin == 1 else 0

    def check_launches(res, what: str) -> None:
        expect = expected_launches(dims, res.bodies, res.bodies + one_token, route, int8_weights)
        if res.steps < 1 or dict(LAUNCHES) != expect:
            raise AssertionError(f"e2e {what}: launches {dict(LAUNCHES)}, expected {expect}")

    run(audio + np.float32(0.001), budget=4, graphs=False)  # warm-up: cuBLAS set-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    first = run(audio)  # makes the window: each phase's step captured
    t_first = time.perf_counter() - t0
    check_launches(first, "first captured call")
    mem = {"held_mb": (torch.cuda.memory_allocated() - base) / 1e6,
           "peak_graphs_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
    times = []
    for _ in range(reps):
        reset_launches()
        t0 = time.perf_counter()
        res = run(audio)
        times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        check_launches(res, "captured")
    steps = res.steps
    n_passes = steps + one_token
    # the loops compared at a cut budget, each timed: captured (its window
    # made by a first call), then eager
    cmp_len = LOOP_CMP_STEPS["prompted" if beam else "unprompted"]
    run(audio, cmp_len)
    reset_launches()
    t0 = time.perf_counter()
    cmp_graph = run(audio, cmp_len)
    t_cmp = time.perf_counter() - t0
    check_launches(cmp_graph, "captured, cut")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    eager = run(audio, cmp_len, graphs=False)
    t_eager = time.perf_counter() - t0
    mem["peak_eager_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    check_launches(eager, "eager")

    n_ctx = dims.n_text_ctx
    cand = res.candidates
    if cand.shape != (batch, group, n_ctx) or not torch.isfinite(res.scores).all():
        raise AssertionError("e2e: malformed decode result")
    prompt = torch.as_tensor(initial, device=cand.device)
    if not ((cand[:, :, :sample_begin] == prompt[:, None]).all()
            and (cand[:, :, sample_begin] >= cfg.token_id_ts_begin).all()):
        raise AssertionError("e2e: prompt or forced first timestamp missing")
    if not ((cand[:, :, sample_begin + 1:] == cfg.token_id_eot).any(dim=-1)).all():
        raise AssertionError("e2e: a candidate without EOT")
    if not (0 <= res.no_speech_probs).all() or not (res.no_speech_probs <= 1).all():
        raise AssertionError("e2e: no-speech probabilities outside [0, 1]")
    elapsed = float(np.median(times))
    print(f"  steps {res.steps}; runs {', '.join(f'{t:.3f}' for t in times)} s; "
          f"median {elapsed:.3f} s, {batch * 30.0 / elapsed:.2f} audio-s/s", flush=True)
    print(f"  launches of each run: {launches}", flush=True)
    step_kernel = {"beam": "beam_self_attention_step", "int8": "self_attention_step",
                   "append": "self_attention_append_step"}[route]
    print(f"  cross_attention_step: {launches['cross_attention_step'] / n_passes:g} a pass "
          f"over {n_passes} width-1 decoder passes; {step_kernel} "
          f"{launches[step_kernel] / steps:g} and the MLP kernel "
          f"{launches['decoder_mlp_step'] / steps:g} a step over {steps} steps", flush=True)
    if int8_weights:
        # what each step spends casting the int8 weights it reads, timed
        # alone: every QuantLinear of the step casts its weight to the
        # compute dtype, and the logits cast the int8 token table to f32
        blocks = model.decoder.blocks
        step_weights = [lin.weight for b in blocks for lin in (
            b.attn.query, b.attn.key, b.attn.value, b.attn.out, b.cross_attn.query,
            b.cross_attn.out, b.mlp[0], b.mlp[2])]
        table = model.decoder.token_embedding.weight

        def casts():
            for w in step_weights:
                w.to(torch.bfloat16)
            table.float()

        cast_bytes = 3 * sum(w.numel() for w in step_weights) + 5 * table.numel()
        cast_ms = timed_ms(casts, 10, graph=True)
        print(f"  int8 weight casts of one step (CUDA graph): {cast_ms:.4f} ms for "
              f"{cast_bytes / 1e6:.1f} MB read and written", flush=True)
    if beam:
        sel, avg, lengths = rank_max_likelihood(res, sample_begin, cfg.token_id_eot, None)
        picked = [cand[a, sel[a], sample_begin : sample_begin + lengths[a, sel[a]]].tolist()
                  for a in range(batch)]
        print(f"  selected candidate of each audio (rank_max_likelihood, no length penalty): "
              f"slots {sel.tolist()}, avg_logprob {[round(x, 4) for x in avg.tolist()]}, "
              f"tokens {json.dumps(picked)}", flush=True)

    # split of the median run: the frontend and encoder alone, then with the
    # prefill into the timed runs' window (its buffers, in place); the rest
    # is the step loop
    with_ks = key_start is not None
    shape = (beam_shape(mode, batch, prompt.shape[1], sample_begin, sample_len, with_ks, cfg,
                        True, int8_kv) if beam else
             greedy_shape(mode, batch, prompt.shape[1], sample_begin, sample_len, with_ks, cfg,
                          True, quantize_kv=int8_kv)[0])
    timed_win = windows.get(model, shape)

    def timed_part(with_prefill: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = log_mel_frontend(audio, dims.n_mels, dtype=torch.bfloat16)
        if with_prefill:
            _encode_and_prefill(
                timed_win, mel, prompt, sot_idx, NO_SPEECH,
                None if key_start is None else torch.as_tensor(key_start, device=prompt.device),
            )
        else:
            model.encoder(mel)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_enc, t_pre = timed_part(False), timed_part(True)
    t_steps = elapsed - t_pre
    print(f"  split: mel+encoder {t_enc:.3f} s; prefill {t_pre - t_enc:.3f} s; steps "
          f"{t_steps:.3f} s, {t_steps / steps * 1e3:.2f} ms a step (a width-1 decoder pass "
          f"and the token update); prefill+steps over the width-1 passes "
          f"{(elapsed - t_enc) / n_passes * 1e3:.2f} ms a pass", flush=True)
    run(audio, PROFILE_STEPS)  # the cut window's own capture
    host = {f"{way} {PROFILE_STEPS}-token": host_calls(
        lambda g=g: run(audio, PROFILE_STEPS, graphs=g)) for way, g in (("captured", True),
                                                                      ("eager", False))}
    loop_report(f"{name} b{batch}" + (f" beam{beam}" if beam else "")
                + (" int8" if int8_weights else " int8 KV" if int8_kv else ""), cmp_graph, eager,
                (t_cmp - t_pre) / cmp_graph.steps * 1e3, (t_eager - t_pre) / eager.steps * 1e3,
                first, t_first, mem, host, full=(res, t_steps / steps * 1e3))
    profiled = profile_run(lambda a: run(a, PROFILE_STEPS), audio,
                           f"one e2e run cut to {PROFILE_STEPS} tokens",
                           passes=PROFILE_STEPS if sample_begin == 1 else PROFILE_STEPS - 1)
    # one incremental step: a replay of a captured body (its window has
    # ended, so the step is a no-op that launches every kernel of a step)
    win = next(iter(windows._windows.values()))
    step_launches = device_launches(lambda: win.run_phase_steps(win.phases[-1], 1))
    print(f"  one step (a replay of the captured body) under torch.profiler: {step_launches} "
          f"device launches (kernels and copies)", flush=True)
    if summary is not None:
        summary.update(audio_s_per_s=batch * 30.0 / elapsed, ms_step=t_steps / steps * 1e3,
                       step_launches=step_launches, **profiled)
    del model, windows, win
    torch.cuda.empty_cache()
    return launches


# -- the transcription slice ---------------------------------------------------

# The golden test's dims (tests/test_golden_e2e.py): head dim 16 and D 64,
# which the encoder splits for row 6 and the step kernels take at their
# head-dim-16 instances
GOLDEN_DIMS = ModelDims(80, 51864, 1500, 64, 4, 2, 448, 64, 4, 2)
GOLDEN_SAMPLE_LEN = 16
TRANSCRIBE_MODEL = "base.en"  # the slice's main path: TranscribeOptions() defaults
TRANSCRIBE_SECONDS = 95  # four windows at least, the last one partial
TRANSCRIBE_PARITY_SECONDS = 60  # the f32 parity's: three windows, the last partial
TRANSCRIBE_LABEL = f"{TRANSCRIBE_MODEL} b1 beam5 transcribe"
GOLDEN_LABEL = "golden dims transcribe"
GOLDEN_BEAM_LABEL = "golden dims beam3"
# the golden dims' kernel instances that neither golden path runs
GOLDEN_OFF_LABELS = ("golden dims read-only steps", "golden dims int8 KV",
                     "golden dims beam3 int8 KV")
# row 6 at three shapes: base.en b128 (row 4's work, split), large-v3 b12
# with 20 heads over a model axis of 4 (the Ulysses encoder's per-card
# shape, an odd head count) and the golden dims' head dim 16
SPLIT_SHAPES = {
    "base.en b128 split heads": (128, 8, 1500, 64),
    "large-v3 b12 Ulysses per-card": (12, 5, 1500, 64),
    GOLDEN_LABEL: (1, 4, 1500, 16),
}


def check_split_attention(shape, dtype, randn) -> dict:
    """Row 6 at [B, H, T, dh] against its plain version, unit-scale q, k, v
    (scores of std 1 after the dh^-0.5 scale), without and with n_valid
    < T (T - 37 keys), on contiguous split tensors and on the heads of
    merged [B, T, D] tensors (views, as the encoder passes them); timed
    contiguous, without n_valid; the library call is SDPA on the same
    split tensors."""
    B, H, T, dh = shape
    isz = torch.tensor([], dtype=dtype).element_size()
    q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
    scale = dh**-0.5
    name = "encoder_attention_split"
    tol = tolerance(name, dtype)
    worst = (0.0, 0.0)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    for nv, (a, b, c), layout in ((None, (q, k, v), "split"), (T - 37, (q, k, v), "split"),
                                  (T - 37, views, "merged-head views")):
        err = compare(f"{name} {str(dtype).split('.')[-1]} {list(shape)} {layout} "
                      f"n_valid {nv or T}", (encoder_attention_split(a, b, c, scale, nv),),
                      (encoder_attention_split_plain(a, b, c, scale, nv),), tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
    del views
    small = B * H <= 64
    row = check_kernel(
        name, dtype, lambda: encoder_attention_split(q, k, v, scale),
        lambda: encoder_attention_split_plain(q, k, v, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        nbytes=4 * q.numel() * isz, flops=4 * B * H * T * T * dh,
        reps=20 if small else (3 if dtype == torch.float32 else 10), graph=small, checked=worst,
    )
    if dtype == torch.bfloat16:
        check_deterministic(name, lambda: encoder_attention_split(q, k, v, scale), row)
    del q, k, v
    torch.cuda.empty_cache()
    return row


# row 8 past the bf16 kernel's widest batch tile (48 columns): base.en at
# 129 rows takes three batch tiles; checked in the kernels phase only
MLP_TILES_LABEL = "base.en b129 MLP batch tiles"


def kernel_checks_mlp_tiles(rows: dict) -> None:
    """Row 8 at 129 rows of base.en, in f32 and bf16, into ``rows``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    rows[MLP_TILES_LABEL] = {name: {} for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] decoder_mlp_step ({tag}, base.en, 129 rows)", flush=True)
        rows[MLP_TILES_LABEL]["decoder_mlp_step"][tag] = check_mlp(dims_for("base.en"), 129,
                                                                   dtype, randn)


# the cross kernel past one chunk of rows a head: medium.en beam 10 at 4
# audios, two chunks of 8 and 2 rows; checked in the kernels phase only
G10_LABEL = "medium.en b4 beam10 cross attention"


def kernel_checks_g10(rows: dict) -> None:
    """Row 5 at G = 10 (medium.en, 4 audios), bf16, into ``rows``."""
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    rows[G10_LABEL] = {name: {} for name in KERNELS}
    print("[kernels] cross_attention_step (bf16, medium.en, 4 audios of 10 rows)", flush=True)
    rows[G10_LABEL]["cross_attention_step"]["bf16"] = check_cross(
        dims_for("medium.en"), 4, 10, torch.bfloat16, randn)


def kernel_checks_transcribe(rows: dict) -> None:
    """The kernels of the transcription paths, into ``rows``: row 6 at the
    three SPLIT_SHAPES in f32 and bf16; on the golden-dims path the mel
    kernel on a 35 s file's two chunks (overlapping rows of one padded
    buffer, a strided view), the LayerNorm pair at D 64 and the step
    kernels at head dim 16 (``kernel_checks_golden_steps``); on the main
    path every kernel at base.en batch 1, beam 5 (``kernel_checks``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    for label, shape in SPLIT_SHAPES.items():
        rows.setdefault(label, {name: {} for name in KERNELS})
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            print(f"[kernels] encoder_attention_split ({tag}, {list(shape)}, {label})", flush=True)
            rows[label]["encoder_attention_split"][tag] = check_split_attention(shape, dtype, randn)

    g = rows[GOLDEN_LABEL]
    print("[kernels] log_mel (f32, a 35 s file's two chunks, row pitch 480000)", flush=True)
    g["log_mel"]["f32"] = check_file_mel(35, randn)
    D = GOLDEN_DIMS.n_audio_state
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.tensor([], dtype=dtype).element_size()
        print(f"[kernels] LayerNorm pair ({tag}, D {D}, 1500 rows)", flush=True)
        x, d = randn(1, 1500, D, dtype=dtype), randn(1, 1500, D, dtype=dtype)
        s, b = randn(D, dtype=dtype), randn(D, dtype=dtype)
        g["ln_fused"][tag] = check_kernel(
            "ln_fused", dtype, lambda: ln_fused(x, s, b), lambda: ln_fused_plain(x, s, b),
            lambda: F.layer_norm(x, (D,), s, b, 1e-5),
            nbytes=2 * x.numel() * isz + 2 * D * isz, flops=8 * x.numel(), reps=20)
        g["residual_ln"][tag] = check_kernel(
            "residual_ln", dtype, lambda: residual_ln(x, d, s, b),
            lambda: residual_ln_plain(x, d, s, b), lambda: F.layer_norm(x + d, (D,), s, b, 1e-5),
            nbytes=4 * x.numel() * isz + 2 * D * isz, flops=9 * x.numel(), reps=20)
    kernel_checks_golden_steps(rows, randn, gen)
    rows[TRANSCRIBE_LABEL] = kernel_checks(dims_for(TRANSCRIBE_MODEL), 1,
                                           (torch.float32, torch.bfloat16), group=5)
    # the main path's mel is the whole file's chunks in one launch; the
    # one-window check above stays beside it
    one = rows[TRANSCRIBE_LABEL]["log_mel"]["f32"]
    print(f"[kernels] log_mel (f32, the {TRANSCRIBE_SECONDS} s file's "
          f"{-(-TRANSCRIBE_SECONDS // 30)} chunks, row pitch 480000)", flush=True)
    row = rows[TRANSCRIBE_LABEL]["log_mel"]["f32"] = check_file_mel(TRANSCRIBE_SECONDS, randn)
    row["one_window"] = {k: one[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "max_abs_err")}


def check_file_mel(seconds: int, randn) -> dict:
    """Row 1 on a seeded file of ``seconds`` as ``log_mel_file`` hands it to
    the kernel: the file zero-padded to whole 30 s chunks, reflect-padded
    once, its chunks overlapping rows of one buffer (a strided view)."""
    n = seconds * 16_000
    C = -(-n // N_SAMPLES)
    buf = torch.zeros(C * N_SAMPLES, device="cuda")
    buf[:n] = randn(n, scale=0.1)
    padded = reflect_pad(buf[None])[0]
    chunks = padded.as_strided((C, N_SAMPLES + N_FFT), (N_SAMPLES, 1))
    return check_mel(chunks, 80, padded.numel() * 4)


def kernel_checks_golden_steps(rows: dict, randn, gen) -> None:
    """Every step kernel's head-dim-16 instance (and the MLP at D 64) at the
    golden dims, in f32 and bf16, into ``rows``: on the greedy
    transcription (one row) the cross, append and MLP kernels; on the beam
    decode (2 audios of 3 rows) the cross, beam and MLP kernels; and the
    instances neither golden path runs, so that none goes unchecked: the
    fused and read-only steps over a compute-dtype cache, and the int8
    branches of the read-only step, the cross kernel and the beam
    kernel."""
    gd = GOLDEN_DIMS
    for label in (GOLDEN_BEAM_LABEL,) + GOLDEN_OFF_LABELS:
        rows.setdefault(label, {name: {} for name in KERNELS})
    greedy, beam = rows[GOLDEN_LABEL], rows[GOLDEN_BEAM_LABEL]
    read, int8, beam_int8 = (rows[label] for label in GOLDEN_OFF_LABELS)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] golden dims step kernels at head dim 16 ({tag})", flush=True)
        greedy["cross_attention_step"][tag] = check_cross(gd, 1, 1, dtype, randn)
        greedy["self_attention_append_step"][tag] = check_step_attention(gd, 1, 1, dtype, randn,
                                                                         gen)
        greedy["decoder_mlp_step"][tag] = check_mlp(gd, 1, dtype, randn)
        beam["cross_attention_step"][tag] = check_cross(gd, 2, 3, dtype, randn)
        beam["beam_self_attention_step"][tag] = check_step_attention(gd, 2, 3, dtype, randn, gen)
        beam["decoder_mlp_step"][tag] = check_mlp(gd, 6, dtype, randn)
        read["self_attention_fused_step"][tag] = check_step_attention(gd, 1, 1, dtype, randn, gen,
                                                                      fused=True)
        read["self_attention_step"][tag] = check_read_step(gd, 1, 1, dtype, randn, gen,
                                                           int8=False)
        int8["cross_attention_step"][tag] = check_cross(gd, 1, 1, dtype, randn, int8=True)
        int8["self_attention_step"][tag] = check_read_step(gd, 1, 1, dtype, randn, gen)
        beam_int8["cross_attention_step"][tag] = check_cross(gd, 2, 3, dtype, randn, int8=True)
        beam_int8["beam_self_attention_step"][tag] = check_read_step(gd, 2, 3, dtype, randn, gen)


@contextlib.contextmanager
def recorded_windows(task, margins=None):
    """Records each window a ``DecodeTask`` decodes: its DecodeOutputs, its
    decode loop's incremental steps and its step bodies (``windows``, a
    list of (outputs, steps, bodies); ``DecodeResult.bodies``, which the
    launch counts follow).  With ``margins`` (a list), each decode call appends the plain
    path's margins, read from every step's inputs: greedy, row 0's top-2
    margin at each sampled token; beam, each audio's smallest selection
    margin over the call."""
    windows = []
    greedy_fn, beam_fn = decode_task_module.decode_greedy, decode_task_module.decode_beam
    update_fn, step_fn = decode_loop._greedy_update, decode_loop._beam_step
    run_batch = task.run_batch
    steps = []

    def counting(fn):
        def run(*args, **kw):
            if margins is not None:
                margins.append([])
            res = fn(*args, **kw)
            steps.append((res.steps, res.bodies))
            return res
        return run

    def recording_update(logits, *args):
        top = logits.topk(2, dim=-1).values
        margins[-1].append((top[0, 0] - top[0, 1]).item())
        return update_fn(logits, *args)

    def recording_step(logits, s, pos, beam, cap, eot):
        m = selection_margins(logits, s, beam, eot)
        margins[-1] = m if not len(margins[-1]) else torch.minimum(margins[-1], m)
        return step_fn(logits, s, pos, beam, cap, eot)

    def recording_run_batch(*args, **kw):
        out = run_batch(*args, **kw)
        windows.append((out, *steps[-1]))
        return out

    decode_task_module.decode_greedy = counting(greedy_fn)
    decode_task_module.decode_beam = counting(beam_fn)
    if margins is not None:
        decode_loop._greedy_update, decode_loop._beam_step = recording_update, recording_step
    task.run_batch = recording_run_batch
    try:
        yield windows
    finally:
        decode_task_module.decode_greedy, decode_task_module.decode_beam = greedy_fn, beam_fn
        decode_loop._greedy_update, decode_loop._beam_step = update_fn, step_fn
        del task.run_batch


def compare_windows(what: str, got: list, want: list, margins: list, beam: bool) -> bool:
    """Window by window, each audio: tokens equal and avg_logprobs within
    1e-3, unless the plain path's margin (greedy: row 0's top-2 margin at
    the first divergent token; beam: the audio's smallest selection margin
    in that window) is below 1e-3, where comparing stops.  Returns whether
    every window was compared."""
    if len(got) != len(want):
        print(f"  {what}: {len(got)} windows against the plain path's {len(want)}", flush=True)
    for w, ((outs_k, *_), (outs_p, *_)) in enumerate(zip(got, want)):
        for a, (ok, op) in enumerate(zip(outs_k, outs_p, strict=True)):
            tk, tp = ok.tokens.tolist(), op.tokens.tolist()
            if tk == tp:
                d = abs(ok.avg_logprob - op.avg_logprob)
                if d > 1e-3:
                    raise AssertionError(f"{what} window {w} audio {a}: avg_logprob off by {d:.3e}")
                continue
            i = next((j for j, (x, y) in enumerate(zip(tk, tp)) if x != y), min(len(tk), len(tp)))
            margin = float(margins[w][a] if beam else margins[w][min(i, len(margins[w]) - 1)])
            print(f"  {what} window {w} audio {a}: tokens diverge at sampled token {i}; plain "
                  f"{'selection' if beam else 'top-2'} margin {margin:.3e}", flush=True)
            if margin >= 1e-3:
                raise AssertionError(f"{what} window {w}: diverges with margin {margin:.3e}")
            print(f"  {what}: the margin is below 1e-3, so comparing stops at window {w}",
                  flush=True)
            return False
    if len(got) != len(want):
        raise AssertionError(f"{what}: window counts differ with every window equal")
    return True


def transcribe_both(model, tok, options, audio, what: str):
    """``TranscribeTask.run`` through the kernels, then through the plain
    versions (f32), each window recorded; the kernel run's launch counts.
    The kernel path's steps are captured; the plain path runs the eager
    loop, whose every step the margins are read from.  Holds windows and,
    where every window agreed, segments and avg_logprobs (compare_windows).
    Returns (kernel output, its windows, launches)."""
    out = {}
    for kernels in (True, False):
        task = TranscribeTask(model, tok, options, kernels=kernels, graphs=kernels)
        margins = None if kernels else []
        with recorded_windows(task.decode_task, margins) as windows:
            reset_launches()
            res = task.run(audio)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        out[kernels] = (res, windows, margins, launches)
    (res_k, win_k, _, launches), (res_p, win_p, margins, _) = out[True], out[False]
    beam = isinstance(options.decode.mode, BeamSearchMode)
    print(f"  {what}: kernel path {len(win_k)} windows, {sum(s for _, s, _ in win_k)} steps; "
          f"plain path {len(win_p)} windows", flush=True)
    if compare_windows(what, win_k, win_p, margins, beam):
        seg = lambda s: (s.seek, s.start_time, s.end_time, s.text)  # noqa: E731
        if [seg(s) for s in res_k.segments] != [seg(s) for s in res_p.segments]:
            raise AssertionError(f"{what}: segments differ")
        d = max(abs(x - y) for x, y in zip(res_k.avg_logprobs, res_p.avg_logprobs, strict=True))
        print(f"  {what}: {len(res_k.segments)} segments equal (seek, start, end, text); tokens "
              f"equal; avg_logprobs max_abs_err {d:.3e} (tolerance 1e-3)", flush=True)
    return res_k, win_k, launches


def check_route_counts(what: str, launches: dict, kernels: dict) -> None:
    """The kernels of a path each launched as ``kernels`` says (a count, or
    True for at least once); every other count, the layer route's fallback
    among them, zero."""
    for name, want in kernels.items():
        n = launches[name]
        if (want is True and n < 1) or (want is not True and n != want):
            raise AssertionError(f"{what}: {name} launched {n} times, expected {want}")
    for name in LAUNCHES:
        if name not in kernels and launches[name]:
            raise AssertionError(f"{what}: {name} counted {launches[name]} times, expected 0")


def transcribe_golden_dims() -> dict:
    """The path that runs row 6: the golden test's dims (head dim 16) with
    seeded weights (seed 7), the vendored GPT-2 tokenizer and a 35 s file,
    f32, through the kernels and through the plain versions: TranscribeTask
    greedy (sample_len 16; two windows, the second prompted), then
    DecodeTask beam 3 on the first 30 s, unprompted and prompted.  The
    encoder takes row 6 in every layer of every encoder call and never row
    4; every step launches the cross and MLP kernels and the append
    (greedy) or beam kernel once a layer.  Returns the launches of the
    kernel path's transcription and of its beam decode."""
    print(f"[transcribe] golden dims {GOLDEN_DIMS}, f32, seed 7, 35 s", flush=True)
    model = init_random(GOLDEN_DIMS, seed=7, dtype=torch.float32, device="cuda")
    tok = Tokenizer()
    audio = (np.random.default_rng(11).standard_normal(16000 * 35) * 0.1).astype(np.float32)
    options = TranscribeOptions(decode=DecodeOptions(mode=GreedyMode(),
                                                     sample_len=GOLDEN_SAMPLE_LEN))
    _, windows, launches = transcribe_both(model, tok, options, audio, "greedy transcription")
    L, steps = GOLDEN_DIMS.n_audio_layer, sum(b for _, _, b in windows)  # step bodies
    Lt, n_win = GOLDEN_DIMS.n_text_layer, len(windows)
    check_route_counts("golden dims transcription", launches, {
        "log_mel": 1, "ln_fused": ln_launches(GOLDEN_DIMS, n_win, n_win + steps),
        "residual_ln": L * n_win,
        "encoder_attention_split": L * len(windows), "self_attention_append_step": Lt * steps,
        "cross_attention_step": Lt * steps, "decoder_mlp_step": Lt * steps})
    print(f"  launches (kernel path): {launches}", flush=True)

    beam = DecodeTask(model, tok, DecodeOptions(mode=BeamSearchMode(beam_size=3),
                                                sample_len=GOLDEN_SAMPLE_LEN))
    prompt = tok.encode(" previous window text")
    got = {}
    for kernels in (True, False):
        beam.kernels = beam.graphs = kernels  # the plain path's margins: the eager loop
        margins = None if kernels else []
        with recorded_windows(beam, margins) as windows:
            reset_launches()
            mel = pad_or_trim(log_mel_file(audio[:N_SAMPLES], kernels=kernels), 3000)
            beam.run_batch(mel[None].repeat(2, 1, 1), [None, prompt])
            torch.cuda.synchronize()
            got[kernels] = (windows, margins, dict(LAUNCHES))
    compare_windows("beam 3, unprompted and prompted", got[True][0], got[False][0],
                    got[False][1], beam=True)
    outs = got[True][0][0][0]
    print(f"  beam 3: tokens {[o.tokens.tolist() for o in outs]}, avg_logprob "
          f"{[round(o.avg_logprob, 4) for o in outs]}", flush=True)
    beam_steps = sum(b for _, _, b in got[True][0])  # step bodies
    check_route_counts("golden dims beam", got[True][2], {
        "log_mel": 1, "ln_fused": ln_launches(GOLDEN_DIMS, 1, 1 + beam_steps), "residual_ln": L,
        "encoder_attention_split": L, "beam_self_attention_step": Lt * beam_steps,
        "cross_attention_step": Lt * beam_steps, "decoder_mlp_step": Lt * beam_steps})
    print(f"  launches (kernel path, beam): {got[True][2]}", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, got[True][2]


def path_launches(dims, windows) -> dict:
    """The main path's launch counts over the recorded ``windows``: the mel
    kernel once a file, the encoder kernels once a layer a window, the
    cross, beam and MLP kernels once a layer a step, the LayerNorms as
    ``ln_launches`` counts them (an encoder call and a prefill a window)."""
    L, n_win = dims.n_audio_layer, len(windows)
    steps = sum(b for _, _, b in windows)  # step bodies, which launch the step's kernels
    return {"log_mel": 1, "ln_fused": ln_launches(dims, n_win, n_win + steps),
            "residual_ln": L * n_win,
            "encoder_attention_merged": L * n_win,
            "cross_attention_step": dims.n_text_layer * steps,
            "beam_self_attention_step": dims.n_text_layer * steps,
            "decoder_mlp_step": dims.n_text_layer * steps}


def transcribe_main_path() -> dict:
    """The slice's main path: base.en at full width and depth,
    ``TranscribeOptions()`` defaults (beam 5, patience 1, timestamps, blank
    and non-speech suppression, max_initial_timestamp 1, conditioned on the
    previous text), a seeded 95 s file.  (a) f32 on the file's first
    TRANSCRIBE_PARITY_SECONDS through the kernels and through the plain
    versions, window by window (compare_windows), and the whole-file mel
    through row 1 against its plain version; (b) bf16
    through the kernels, E2E_REPS timed runs with the launch counts of each,
    then one window under torch.profiler.  Returns the last timed run's
    launches."""
    dims = dims_for(TRANSCRIBE_MODEL)
    tok = Tokenizer.for_dims(dims)
    audio = (np.random.default_rng(21).standard_normal(16000 * TRANSCRIBE_SECONDS) * 0.1
             ).astype(np.float32)
    options = TranscribeOptions()
    print(f"[transcribe] {TRANSCRIBE_MODEL} full width and depth, TranscribeOptions() defaults "
          f"(beam {options.decode.mode.beam_size}), a {TRANSCRIBE_SECONDS} s file", flush=True)
    mel_k = log_mel_file(audio)
    mel_p = log_mel_file(audio, kernels=False)
    compare("log_mel_file (whole-file floor, 4 chunks) f32", (mel_k,), (mel_p,), TOL_F32)
    if mel_k.shape != (dims.n_mels, 16000 * TRANSCRIBE_SECONDS // HOP_LENGTH):
        raise AssertionError(f"log_mel_file: shape {tuple(mel_k.shape)}")
    del mel_k, mel_p

    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    _, windows, launches = transcribe_both(
        model, tok, options, audio[: 16000 * TRANSCRIBE_PARITY_SECONDS],
        f"f32 beam-5 transcription, the file's first {TRANSCRIBE_PARITY_SECONDS} s")
    check_route_counts("f32 transcription", launches, path_launches(dims, windows))
    del model
    torch.cuda.empty_cache()

    model = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")
    task = TranscribeTask(model, tok, options)
    task.run(audio[: 16000 * 5])  # warm-up: kernel libraries, cuBLAS set-up
    times = []
    reps = E2E_REPS_CUT.get(TRANSCRIBE_LABEL, E2E_REPS)
    for _ in range(reps):
        with recorded_windows(task.decode_task) as windows:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = task.run(audio)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = dict(LAUNCHES)
        n_win, steps = len(windows), sum(s for _, s, _ in windows)
        check_route_counts("bf16 transcription", launches, path_launches(dims, windows))
    elapsed = float(np.median(times))
    if not res.segments or not all(np.isfinite(res.avg_logprobs)) or res.tokens.size == 0:
        raise AssertionError("bf16 transcription: no segments, or a non-finite avg_logprob")
    if res.segments[-1].seek >= 16000 * TRANSCRIBE_SECONDS // HOP_LENGTH or n_win < 4:
        raise AssertionError(f"bf16 transcription: {n_win} windows, last seek "
                             f"{res.segments[-1].seek}")
    print(f"  bf16: {n_win} windows, {steps} incremental steps, {len(res.segments)} segments; "
          f"runs {', '.join(f'{t:.3f}' for t in times)} s (median of {reps}); "
          f"{TRANSCRIBE_SECONDS / elapsed:.2f} audio-s/s; wall over the steps "
          f"{elapsed / steps * 1e3:.2f} ms a step (mel, encoder and prefill included)", flush=True)
    print(f"  launches of the last run: {launches}; the port's kernels "
          f"{sum(v for k, v in launches.items() if ':' not in k) / n_win:.1f} a window", flush=True)
    print(f"  windows' seeks (frames): {sorted({s.seek for s in res.segments})}", flush=True)
    window = pad_or_trim(log_mel_file(audio)[:, :3000], 3000)
    task.decode_task.set_prompt(None)
    with recorded_windows(task.decode_task) as one:
        task.decode_task.run(window)
    profile_run(lambda _: task.decode_task.run(window), None,
                f"one window (the file's first, unprompted; {one[0][1]} steps)",
                passes=one[0][2])
    del model, task
    torch.cuda.empty_cache()
    return launches


# OpenAI's transcription recipe (the CLI's --temperatures 0,0.2,...,1.0
# --word-timestamps with TranscribeOptions' no-speech threshold 0.6), on a
# seeded FLAC file of RECIPE_SECONDS written and read back by the port
LADDER = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
RECIPE_SECONDS = 20  # two windows at least: a sampled window prompts the next
# The recipe's f32 parity keeps RECIPE_PARITY_DEPTH layers of base.en's 6 + 6
# (the kernels' shapes are the full width's), and its timed bf16 run, at
# full depth, takes the file's first RECIPE_TIMED_SECONDS: each window runs
# all six rungs, 15.9 ms a step at full depth (H100 80GB HBM3, 700 W)
RECIPE_PARITY_DEPTH = 2
RECIPE_TIMED_SECONDS = 10
RECIPE_LABEL = f"{TRANSCRIBE_MODEL} b1 recipe"
CLI_LABEL = f"{TRANSCRIBE_MODEL} b2 CLI --batch 2"
CLI_SECONDS = (6, 4)  # the CLI's two files, a WAV and a FLAC: a window each
# Layers of the seeded checkpoint (base.en's width, of its 6 + 6) that the
# command line, the evaluation tools and the torchrun CLI load: they check
# exit codes, output and launch counts, not throughput
CLI_DEPTH = 2
WORD_TIME_TOL = 0.02  # one encoder frame: DTW may meet a near-tie the other way
# The Gumbel noise's two logs may round apart between the card and the CPU:
# the CPU tests measured at most 2 ulps of max(|g|, 1) between torch and XLA
# (tests/test_torch_sampling.py); the tolerance is twice that.
GUMBEL_ULPS = 4
ARTIFACTS = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"


def check_rng() -> dict:
    """[rng] The sampler's noise on the card against the CPU, [5, 51865] (5
    rows of one audio, base.en's vocab rounded up to the multilingual one)
    at three (seed, step) pairs: the row keys, 32-bit random bits and the
    uniforms in [tiny, 1) bit for bit, the Gumbel noise within GUMBEL_ULPS
    ulps of max(|g|, 1), and the tokens of ``categorical`` on seeded
    logits at T 0.6 equal (where not, the CPU draw's top-2 gap must be
    under 1e-5).  The CPU side runs on one torch thread (``one_thread``);
    the Gumbel noise on torch's default CPU pool is compared with it and
    the values that differ are printed.  Then the draw alone on the card: its device launches, its
    wall ms a call (eager, synchronised, as a decode step makes it) and its
    device time (a CUDA graph).  Returns {"draw_ms", "draw_launches",
    "draw_device_ms"}."""
    dev, V, rows = torch.device("cuda"), 51865, 5
    gen = torch.Generator().manual_seed(3)

    def one_thread(fn, *args):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args)
        finally:
            torch.set_num_threads(threads)

    for seed, step in ((0, 0), (0, 9), (12345, 3)):
        key = decode_rng.PRNGKey(seed)
        k_cpu = decode_rng.row_keys(key, step + 1, rows, rows)[step]
        k_dev = decode_rng.row_keys(key.to(dev), step + 1, rows, rows)[step]
        if not torch.equal(k_dev.cpu(), k_cpu):
            raise AssertionError(f"rng: row keys differ at seed {seed} step {step}")
        if not torch.equal(decode_rng.random_bits(k_dev, (V,)).cpu(),
                           decode_rng.random_bits(k_cpu, (V,))):
            raise AssertionError(f"rng: random bits differ at seed {seed} step {step}")
        u_dev = decode_rng.uniform(k_dev, (V,), decode_rng.TINY, 1.0).cpu()
        u_cpu = decode_rng.uniform(k_cpu, (V,), decode_rng.TINY, 1.0)
        if not torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32)):
            raise AssertionError(f"rng: uniforms differ at seed {seed} step {step}")
        g_dev = decode_rng.gumbel(k_dev, (V,)).cpu()
        g_cpu = one_thread(decode_rng.gumbel, k_cpu, (V,))
        g_pool = decode_rng.gumbel(k_cpu, (V,))
        pool_apart = int((g_pool != g_cpu).sum())
        ulp = torch.from_numpy(np.spacing(np.maximum(g_cpu.abs().numpy(), 1.0)))
        ulps = ((g_dev - g_cpu).abs() / ulp).max().item()
        if ulps > GUMBEL_ULPS:
            raise AssertionError(f"rng: Gumbel noise {ulps:.1f} ulps apart (tolerance "
                                 f"{GUMBEL_ULPS})")
        logits = torch.randn(rows, V, generator=gen) * 3
        logits[:, ::7] = float("-inf")
        t = 0.6
        tok_cpu = one_thread(decode_rng.categorical, k_cpu, logits / torch.full((), t))
        tok_dev = decode_rng.categorical(k_dev, logits.to(dev) / torch.full((), t, device=dev))
        if not torch.equal(tok_dev.cpu(), tok_cpu):
            top = (g_cpu + logits / t).topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]).min().item()
            if gap >= 1e-5:
                raise AssertionError(f"rng: tokens differ with a top-2 gap of {gap:.3e}")
            print(f"  seed {seed} step {step}: tokens differ at a top-2 gap of {gap:.3e}",
                  flush=True)
        print(f"[rng] seed {seed} step {step}: keys, bits and uniforms bit-equal card vs CPU; "
              f"Gumbel max {ulps:.2f} ulps of max(|g|, 1) (tolerance {GUMBEL_ULPS}; the CPU "
              f"on one thread, {pool_apart} values apart on {torch.get_num_threads()} "
              f"threads); tokens {tok_dev.tolist()}", flush=True)
    scaled = (logits / t).to(dev)

    def draw():
        return decode_rng.categorical(k_dev, scaled)

    for _ in range(3):
        draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        draw()
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 50 * 1e3
    n = device_launches(draw)
    device_ms = timed_ms(draw, 20, graph=True)
    print(f"[rng] the draw at [{rows}, {V}] (threefry, uniform, Gumbel, argmax in torch ops): "
          f"{n} device launches, {ms:.3f} ms a call (wall, synchronised), {device_ms:.4f} ms of "
          f"device time (a CUDA graph of 20 calls)", flush=True)
    return {"draw_ms": ms, "draw_launches": n, "draw_device_ms": device_ms}


def kernel_checks_recipe(rows: dict) -> None:
    """The kernels at the shapes the recipe and the CLI give them for the
    first time, into ``rows``: the ladder's sampling rungs at batch 1 (best
    of 5: the cross kernel at A 1, G 5 on the greedy path, the append
    kernel at 5 rows with a key_start a row, the MLP at 5 rows), and the
    CLI's --batch 2 (every kernel at base.en batch 2, beam 5: the encoder
    kernels at 2 windows, the cross and beam kernels at A 2, G 5, the MLP
    at 10 rows; its sampling rungs' append kernel at 10 rows), each against
    its plain version, timed, bf16 bit-identical call to call."""
    dims = dims_for(TRANSCRIBE_MODEL)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    rec = rows.setdefault(RECIPE_LABEL, {name: {} for name in KERNELS})
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] sampling rungs: cross_attention_step ({tag}, greedy A 1, G 5)",
              flush=True)
        rec["cross_attention_step"][tag] = check_cross(dims, 1, 5, dtype, randn)
        print(f"[kernels] sampling rungs: self_attention_append_step ({tag}, 5 rows of one "
              f"audio, a key_start a row)", flush=True)
        rec["self_attention_append_step"][tag] = check_step_attention(dims, 5, 1, dtype, randn,
                                                                      gen)
        print(f"[kernels] sampling rungs: decoder_mlp_step ({tag}, 5 rows)", flush=True)
        rec["decoder_mlp_step"][tag] = check_mlp(dims, 5, dtype, randn)
    cli = rows[CLI_LABEL] = kernel_checks(dims, 2, (torch.bfloat16,), group=5)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] CLI sampling rungs: self_attention_append_step ({tag}, 10 rows)",
              flush=True)
        cli["self_attention_append_step"][tag] = check_step_attention(dims, 10, 1, dtype, randn,
                                                                      gen)


class RecordedCalls(list):
    """The decode calls ``recorded_calls`` keeps, and ``aligned``: the word
    aligner's teacher-forced passes made meanwhile."""

    aligned = 0


@contextlib.contextmanager
def recorded_calls(margins: bool = False):
    """Records every ``DecodeTask.run_batch`` call of any task (the ladder's
    primary and sampling tasks alike) as a dict: ``temperature`` (None for
    the primary task), ``rows`` (the windows of the call's mel),
    ``outputs``, incremental ``steps``, step ``bodies``, host ``syncs``,
    ``captures`` and ``capture_seconds``, the decode's
    ``candidates``, ``scores`` and ``no_speech`` (on the host), its
    ``loop`` and ``sample_begin``.  With ``margins``,
    the plain path's margins, in logit units: a beam call's smallest
    selection margin (``margin``); a sampling call's top-2 gap of
    ``logits / T + noise`` times T of every row at every step
    (``row_margins`` [steps, rows]) and the gap between its best two
    candidates' ranking scores (``rank_gap``).  Yields a ``RecordedCalls``,
    which also counts the word aligner's passes."""
    calls, state = RecordedCalls(), {}
    run_batch = decode_task_module.DecodeTask.run_batch
    greedy_fn, beam_fn = decode_task_module.decode_greedy, decode_task_module.decode_beam
    rank_fn = decode_task_module.rank_max_likelihood
    sample_fn, step_fn = decode_rng.categorical, decode_loop._beam_step
    align_fn = decode_align._alignment_qk

    def counting_align(*args, **kw):
        calls.aligned += 1
        return align_fn(*args, **kw)

    def counting(fn):
        def run(model, mel, tokens, sample_begin, *args, **kw):
            res = fn(model, mel, tokens, sample_begin, *args, **kw)
            state.update(steps=res.steps, bodies=res.bodies, syncs=res.syncs,
                         captures=res.captures, capture_seconds=res.capture_seconds,
                         candidates=res.candidates.cpu(), scores=res.scores.cpu(),
                         no_speech=res.no_speech_probs.cpu(), loop=res.loop,
                         sample_begin=sample_begin)
            return res
        return run

    def recording_sample(keys, scaled):
        top = (decode_rng.gumbel(keys, scaled.shape[-1:]) + scaled).topk(2, dim=-1).values
        state["rows"].append((top[:, 0] - top[:, 1]) * state["temperature"])
        return sample_fn(keys, scaled)

    def recording_step(logits, s, pos, beam, cap, eot):
        m = selection_margins(logits, s, beam, eot).min()
        state["margin"] = m if state["margin"] is None else torch.minimum(state["margin"], m)
        return step_fn(logits, s, pos, beam, cap, eot)

    def recording_rank(result, sample_begin, eot, length_penalty):
        out = rank_fn(result, sample_begin, eot, length_penalty)
        if result.scores.shape[1] > 1:
            top = (result.scores / out[2].clamp(min=1).float()).topk(2, dim=-1).values
            state["rank_gap"] = (top[:, 0] - top[:, 1]).min()
        return out

    def recording_run_batch(self, mel, prompts, temperature=None):
        state.update(margin=None, rank_gap=None, rows=[], temperature=temperature or 1.0)
        out = run_batch(self, mel, prompts, temperature=temperature)
        call = {"temperature": temperature, "rows": mel.shape[0], "outputs": out,
                **{k: state[k] for k in ("steps", "bodies", "syncs", "captures",
                                         "capture_seconds", "candidates", "scores",
                                         "no_speech", "loop", "sample_begin")}}
        if margins:
            call["margin"] = None if state["margin"] is None else float(state["margin"])
            call["rank_gap"] = None if state["rank_gap"] is None else float(state["rank_gap"])
            call["row_margins"] = torch.stack(state["rows"]).cpu() if state["rows"] else None
        calls.append(call)
        return out

    decode_task_module.decode_greedy = counting(greedy_fn)
    decode_task_module.decode_beam = counting(beam_fn)
    decode_task_module.DecodeTask.run_batch = recording_run_batch
    decode_align._alignment_qk = counting_align
    if margins:
        decode_rng.categorical, decode_loop._beam_step = recording_sample, recording_step
        decode_task_module.rank_max_likelihood = recording_rank
    try:
        yield calls
    finally:
        decode_task_module.decode_greedy, decode_task_module.decode_beam = greedy_fn, beam_fn
        decode_task_module.DecodeTask.run_batch = run_batch
        decode_align._alignment_qk = align_fn
        decode_rng.categorical, decode_loop._beam_step = sample_fn, step_fn
        decode_task_module.rank_max_likelihood = rank_fn


@contextlib.contextmanager
def kept_inputs():
    """Keeps the inputs of every ``DecodeTask.run_batch`` call, in order:
    dicts of ``task``, ``mel`` (a copy), ``prompts`` and ``temperature``, so
    that a call can be run again.  Entered inside ``recorded_calls`` its
    list lines up with that one's."""
    inputs = []
    run_batch = decode_task_module.DecodeTask.run_batch

    def keeping(task, mel, prompts, temperature=None):
        inputs.append({"task": task, "mel": torch.as_tensor(mel).clone(),
                       "prompts": [None if q is None else list(q) for q in prompts],
                       "temperature": temperature})
        return run_batch(task, mel, prompts, temperature=temperature)

    decode_task_module.DecodeTask.run_batch = keeping
    try:
        yield inputs
    finally:
        decode_task_module.DecodeTask.run_batch = run_batch


def compare_calls(what: str, got: list, want: list, tol: float = 1e-3) -> bool:
    """Call by call (each rung of each window), kernel path against plain
    path: the same rung; in a sampling call each row's candidate equal, or
    first apart at a step where the plain row's margin (its top-2 gap of
    ``logits / T + noise``, times T) is below ``tol``; the chosen tokens
    equal and avg_logprobs within 1e-3.  Where the chosen tokens differ,
    the difference must come from such a row, or (equal rows) from a gap
    below ``tol`` between the best two ranking scores, or in a beam call
    from a selection margin below ``tol``; comparing stops there, since
    every later call follows from it.  Returns whether every call was
    compared."""
    for i, (k, p) in enumerate(zip(got, want)):
        t = k["temperature"]
        if t != p["temperature"]:
            raise AssertionError(f"{what} call {i}: rung {t} against the plain path's "
                                 f"{p['temperature']}")
        apart = []
        if t is not None:
            ck, cp = k["candidates"], p["candidates"]
            for a, g in itertools.product(range(ck.shape[0]), range(ck.shape[1])):
                diff = torch.nonzero(ck[a, g] != cp[a, g])
                if not diff.numel():
                    continue
                step = min(int(diff[0]) - p["sample_begin"], p["row_margins"].shape[0] - 1)
                m = float(p["row_margins"][step, a * ck.shape[1] + g])
                print(f"  {what} call {i} (T {t}): row {g} apart from sampled token {step}, "
                      f"plain margin {m:.3e}", flush=True)
                if m >= tol:
                    raise AssertionError(f"{what} call {i}: a row diverges with margin {m:.3e}")
                apart.append(g)
        for ok, op in zip(k["outputs"], p["outputs"], strict=True):
            if ok.tokens.tolist() == op.tokens.tolist():
                d = abs(ok.avg_logprob - op.avg_logprob)
                if d > 1e-3:
                    raise AssertionError(f"{what} call {i}: avg_logprob off by {d:.3e}")
                continue
            margin = p["margin"] if t is None else (0.0 if apart else p["rank_gap"])
            print(f"  {what} call {i} (T {t or 0.0}): the chosen tokens differ; plain margin "
                  f"{margin:.3e}", flush=True)
            if margin >= tol:
                raise AssertionError(f"{what} call {i}: diverges with margin {margin:.3e}")
            print(f"  {what}: the margin is below {tol:g}, so comparing stops at call {i}",
                  flush=True)
            return False
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} calls against the plain path's {len(want)}")
    return True


def compare_words(what: str, got, want) -> int:
    """Segments (seek, start, end, text) equal; each segment's words: text
    equal, times within WORD_TIME_TOL.  Returns the number of words."""
    seg = lambda s: (s.seek, round(s.start_time, 6), round(s.end_time, 6), s.text)  # noqa: E731
    if [seg(s) for s in got.segments] != [seg(s) for s in want.segments]:
        raise AssertionError(f"{what}: segments differ")
    n, worst = 0, 0.0
    for gs, ws in zip(got.segments, want.segments):
        gw, ww = gs.words or [], ws.words or []
        if [w.word for w in gw] != [w.word for w in ww]:
            raise AssertionError(f"{what}: the words of segment at {gs.start_time} differ")
        for a, b in zip(gw, ww):
            worst = max(worst, abs(a.start - b.start), abs(a.end - b.end))
        n += len(gw)
    if worst > WORD_TIME_TOL + 1e-9:
        raise AssertionError(f"{what}: a word time {worst:.3f} s off (tolerance {WORD_TIME_TOL})")
    print(f"  {what}: {len(got.segments)} segments equal; {n} words, text equal, times within "
          f"{worst:.3f} s (tolerance {WORD_TIME_TOL})", flush=True)
    return n


def recipe_launches(dims, calls, files: int = 1, *, aligned: int) -> dict:
    """The recipe's launch counts over the recorded decode ``calls`` of
    ``files`` files and ``aligned`` passes of the word aligner: the mel
    kernel once a file; the encoder kernels once a layer a call (every
    rung encodes its window again); the cross and MLP kernels once a
    layer a step body (``DecodeResult.bodies``: the steps, the no-op
    steps past the end and the warm-up body of a capture); the beam
    kernel a layer a body of rung 0, the append kernel a layer a body of
    the sampling rungs; the LayerNorms as ``ln_launches`` counts them (an
    encoder call and a prefill a call, and each alignment pass a layered
    pass).  The alignment pass launches no other kernel (its attention
    and MLP in torch.matmul, as the JAX package computes them)."""
    L, Lt, n = dims.n_audio_layer, dims.n_text_layer, len(calls)
    # the step bodies (DecodeResult.bodies) launch the step's kernels
    beam = sum(c["bodies"] for c in calls if c["temperature"] is None)
    sampled = sum(c["bodies"] for c in calls if c["temperature"] is not None)
    return {"log_mel": files,
            "ln_fused": ln_launches(dims, n, n + beam + sampled + aligned),
            "residual_ln": L * n,
            "encoder_attention_merged": L * n, "cross_attention_step": Lt * (beam + sampled),
            "beam_self_attention_step": Lt * beam, "self_attention_append_step": Lt * sampled,
            "decoder_mlp_step": Lt * (beam + sampled)}


def rungs_per_window(calls) -> list:
    """The rungs each window took: a window starts at rung 0 (the primary
    task's call, temperature None)."""
    out = []
    for c in calls:
        if c["temperature"] is None:
            out.append([])
        out[-1].append(c["temperature"] or 0.0)
    return out


def transcribe_recipe(rng_row: dict) -> dict:
    """[transcribe recipe] base.en at full width and depth, OpenAI's recipe:
    ``TranscribeOptions(temperatures=LADDER, no_speech_threshold=0.6,
    word_timestamps=True)`` with the default beam 5 at rung 0 and best-of-5
    sampling above it, over a seeded RECIPE_SECONDS file written as FLAC by
    the port's ``encode_flac`` and read back by its ``load_audio``.  (a) f32
    with the depth cut to RECIPE_PARITY_DEPTH + RECIPE_PARITY_DEPTH layers
    (two windows at least) through the kernels and through the plain
    versions, call by call
    (``compare_calls``), then the segments and words (``compare_words``),
    and the kernel run's launch counts; (b) bf16 at full depth through the
    kernels on the file's first RECIPE_TIMED_SECONDS, timed
    (E2E_REPS, cut by E2E_REPS_CUT), each run's launch counts checked:
    audio-s/s, windows, the rungs of each, steps by rung kind, launches a
    window, the draw's launches and ms a step ([rng]) and the alignment
    pass's ms a window.  Fails where no window ran a rung above 0.  Returns
    the last timed run's launches."""
    dims = dims_for(TRANSCRIBE_MODEL)
    tok = Tokenizer.for_dims(dims)
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    path = ARTIFACTS / "recipe.flac"
    x = (np.random.default_rng(31).standard_normal(16000 * RECIPE_SECONDS) * 0.1
         ).astype(np.float32)
    path.write_bytes(encode_flac(np.clip(x, -1, 1), 16000))
    audio = load_audio(path)
    if audio.shape != x.shape or np.abs(audio - np.clip(x, -1, 1)).max() > 1 / 32767:
        raise AssertionError(f"load_audio: {audio.shape} samples, not the file written")
    options = TranscribeOptions(temperatures=LADDER, no_speech_threshold=0.6,
                                word_timestamps=True)
    print(f"[transcribe recipe] {TRANSCRIBE_MODEL} full width and depth, temperatures "
          f"{LADDER}, no_speech_threshold 0.6, word timestamps, beam "
          f"{options.decode.mode.beam_size} at rung 0; a {RECIPE_SECONDS} s FLAC "
          f"({path.stat().st_size} bytes) read back by load_audio", flush=True)

    cut = dataclasses.replace(dims, n_audio_layer=RECIPE_PARITY_DEPTH,
                              n_text_layer=RECIPE_PARITY_DEPTH)
    model = init_random(cut, seed=0, dtype=torch.float32, device="cuda")
    out = {}
    for kernels in (True, False):
        # the plain path's margins are read at every step: the eager loop
        task = TranscribeTask(model, tok, options, kernels=kernels, graphs=kernels)
        with recorded_calls(margins=not kernels) as calls:
            reset_launches()
            res = task.run(audio)
            torch.cuda.synchronize()
            out[kernels] = (res, calls, dict(LAUNCHES))
    (res_k, calls_k, launches), (res_p, calls_p, _) = out[True], out[False]
    if len(rungs_per_window(calls_k)) < 2:
        raise AssertionError("f32 recipe: one window: no sampled text prompted a window")
    print(f"  f32, {RECIPE_PARITY_DEPTH} + {RECIPE_PARITY_DEPTH} layers: kernel path {len(calls_k)} "
          f"calls, rungs by window "
          f"{rungs_per_window(calls_k)}; plain path {len(calls_p)} calls", flush=True)
    if compare_calls("f32 recipe", calls_k, calls_p):
        compare_words("f32 recipe", res_k, res_p)
    check_route_counts("f32 recipe", launches,
                       recipe_launches(cut, calls_k, aligned=calls_k.aligned))
    del model, task
    torch.cuda.empty_cache()

    model = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")
    task = TranscribeTask(model, tok, options)
    align_ms = []
    align = task._aligner.align_window

    def timed_align(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words = align(*args)
        align_ms.append((time.perf_counter() - t0) * 1e3)
        return words

    task._aligner.align_window = timed_align
    categorical = decode_rng.categorical

    def timed_draw(keys, scaled):
        # no synchronisation: the host's time launching the draw, and the
        # span the draw takes on the device's timeline (CUDA events)
        ends = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ends[0].record()
        t0 = time.perf_counter()
        out = categorical(keys, scaled)
        draw_host.append(time.perf_counter() - t0)
        ends[1].record()
        draw_events.append(ends)
        return out

    clip = audio[: 16000 * RECIPE_TIMED_SECONDS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with recorded_calls() as first_calls:
        task.run(clip)  # makes the windows of the clip's shapes: their phases captured
    t_first = time.perf_counter() - t0
    mem = {"held_mb": (torch.cuda.memory_allocated() - base) / 1e6,
           "peak_graphs_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
    times = []
    reps = E2E_REPS_CUT.get(RECIPE_LABEL, E2E_REPS)
    for _ in range(reps):
        with recorded_calls() as calls, kept_inputs() as inputs:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = task.run(clip)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = dict(LAUNCHES)
        check_route_counts("bf16 recipe", launches,
                           recipe_launches(dims, calls, aligned=calls.aligned))
    rungs = rungs_per_window(calls)
    if not any(t > 0 for window in rungs for t in window):
        raise AssertionError("bf16 recipe: no window ran a rung above 0: the ladder never sampled")
    words = [w for s in res.segments for w in (s.words or [])]
    if not res.segments or not words or not all(np.isfinite(res.avg_logprobs)):
        raise AssertionError("bf16 recipe: no segments, no words, or a non-finite avg_logprob")
    elapsed = float(np.median(times))
    beam_steps = sum(c["steps"] for c in calls if c["temperature"] is None)
    sampled_steps = sum(c["steps"] for c in calls if c["temperature"] is not None)
    n_win = len(rungs)
    print(f"  bf16: {n_win} windows, rungs by window {rungs}; {len(calls)} decode calls; steps "
          f"beam {beam_steps}, sampling {sampled_steps}; {len(res.segments)} segments, "
          f"{len(words)} words; runs {', '.join(f'{t:.3f}' for t in times)} s (median of "
          f"{reps}; the first, which captured, {t_first:.3f} s with "
          f"{sum(c['bodies'] - c['steps'] for c in first_calls)} bodies more than steps); "
          f"{RECIPE_TIMED_SECONDS / elapsed:.2f} audio-s/s; wall over the steps "
          f"{elapsed / (beam_steps + sampled_steps) * 1e3:.2f} ms a step", flush=True)
    print(f"  launches of the last run (checked against recipe_launches): {launches}; the "
          f"port's kernels {sum(v for k, v in launches.items() if ':' not in k) / n_win:.1f} a "
          f"window", flush=True)
    over = [c for c in calls if c["syncs"] > -(-c["steps"] // decode_loop.CHECK_EVERY) + 3]
    if over or any(c["loop"] != "graphs" for c in calls):
        raise AssertionError(f"bf16 recipe: syncs past ceil(steps / k) + 3, or an eager loop: "
                             f"{[(c['steps'], c['syncs'], c['loop']) for c in over or calls]}")

    # the first window's rung-0 call and its first sampled rung again through
    # the eager loop (graphs=False) on their inputs, each held to the
    # captured call bit for bit; the draw timed at each of its steps
    picked = [next(i for i, c in enumerate(calls) if c["temperature"] is None),
              next(i for i, c in enumerate(calls) if c["temperature"] is not None)]
    draw_host, draw_events = [], []
    t_graph = t_eager = 0.0
    n_steps = 0
    for i in picked:
        c, inp = calls[i], inputs[i]
        inp["task"].graphs = False
        with recorded_calls() as eager:
            decode_rng.categorical = timed_draw
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inp["task"].run_batch(inp["mel"], inp["prompts"], temperature=c["temperature"])
                torch.cuda.synchronize()
                t_eager += time.perf_counter() - t0
            finally:
                decode_rng.categorical = categorical
                inp["task"].graphs = True
        with recorded_calls() as again:  # the captured call, timed alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inp["task"].run_batch(inp["mel"], inp["prompts"], temperature=c["temperature"])
            torch.cuda.synchronize()
            t_graph += time.perf_counter() - t0
        for other in (eager[0], again[0]):
            if not (all(torch.equal(c[k], other[k]) for k in ("candidates", "scores", "no_speech"))
                    and c["steps"] == other["steps"]):
                raise AssertionError(f"bf16 recipe call {i} (T {c['temperature']}): the "
                                     f"captured loop differs from graphs=False or from itself")
        n_steps += c["steps"]
    sampling = [c for c in calls if c["temperature"] is not None]
    c, inp = calls[picked[1]], inputs[picked[1]]

    def sampled_call(graphs: bool):
        inp["task"].graphs = graphs
        try:
            inp["task"].run_batch(inp["mel"], inp["prompts"], temperature=c["temperature"])
        finally:
            inp["task"].graphs = True

    host = {way: host_calls(lambda g=g: sampled_call(g)) for way, g in (("captured", True),
                                                                        ("eager", False))}
    LOOPS[f"{RECIPE_LABEL} sampled rungs"] = row = {
        "calls": len(calls), "sampling_calls": len(sampling), "compared_calls": len(picked),
        "steps": n_steps, "ms_step_graphs": t_graph / n_steps * 1e3,
        "ms_step_eager": t_eager / n_steps * 1e3, "first_run_s": t_first,
        "syncs_graphs": sum(x["syncs"] for x in calls), "steps_all": beam_steps + sampled_steps,
        "captures": sum(x["captures"] for x in first_calls),
        "capture_s": sum(x["capture_seconds"] for x in first_calls), **mem,
        "host_calls": host, "k": decode_loop.CHECK_EVERY}
    launch_calls = {way: sum(n for name, n in h.items() if name in HOST_CALLS)
                    for way, h in host.items()}
    print(f"[graphs] {RECIPE_LABEL}, {RECIPE_TIMED_SECONDS} s clip: {len(calls)} captured calls "
          f"({len(sampling)} sampled rungs); window 0's rung 0 and first sampled rung (T "
          f"{calls[picked[1]]['temperature']}) again with graphs=False, bit-equal (candidates, "
          f"scores, no-speech, steps); {row['ms_step_graphs']:.3f} ms a step captured, "
          f"{row['ms_step_eager']:.3f} eager ({t_eager / t_graph:.2f}x; each call's encoder and "
          f"prefill included); host syncs {row['syncs_graphs']} over {row['steps_all']} steps "
          f"(k {decode_loop.CHECK_EVERY}); the first captured run {t_first:.3f} s with "
          f"{row['captures']} captures in {row['capture_s']:.3f} s; memory: the cached windows "
          f"hold {mem['held_mb']:.1f} MB, peak +{mem['peak_graphs_mb']:.1f} MB; host runtime "
          f"calls of the sampled call ({c['steps']} steps): {launch_calls['captured']} "
          f"launches captured {host['captured']}, {launch_calls['eager']} eager "
          f"{host['eager']}", flush=True)
    # a sampling call draws after its prefill and at each incremental step
    draws = calls[picked[1]]["steps"] + 1
    if len(draw_host) != draws:
        raise AssertionError(f"bf16 recipe: {len(draw_host)} draws, not the {draws} of its "
                             "sampling call")
    span_ms = [a.elapsed_time(b) for a, b in draw_events]
    print(f"  the draw, alone ([rng]): {rng_row['draw_launches']} device launches, "
          f"{rng_row['draw_ms']:.3f} ms a call synchronised, {rng_row['draw_device_ms']:.4f} ms "
          f"of device time", flush=True)
    print(f"  the draw in the eager sampled call: {len(draw_host)} draws, one a step and one "
          f"after its prefill; host {np.median(draw_host) * 1e3:.3f} ms a step to launch it "
          f"(median; {sum(draw_host):.3f} s in all); its span on the device's timeline "
          f"{np.median(span_ms):.3f} ms a step (median; CUDA events, {sum(span_ms) / 1e3:.3f} s "
          f"in all); in the captured loop it is part of each replayed step", flush=True)
    print(f"  alignment pass: {len(align_ms)} windows, {np.median(align_ms):.2f} ms a window "
          f"(median; all {', '.join(f'{t:.2f}' for t in align_ms)})", flush=True)
    del model, task
    torch.cuda.empty_cache()
    return launches


def cli_phase() -> dict:
    """[cli] The command line in process (``cli.main``) on a seeded
    OpenAI-format checkpoint of base.en's width at CLI_DEPTH + CLI_DEPTH
    layers (seed 0, written here) and two
    seeded files, a WAV and a FLAC: ``--batch 2 --language en
    --temperatures 0,0.2,...,1.0 --word-timestamps --json`` (bf16 on the
    card, its defaults) must exit 0 with one JSON entry a file, each
    segment's times finite and its words in time order; every decode call
    of 2 windows (the batch driver retries a failed batch row by row, which
    would hide the failure) and every kernel launched exactly as
    ``recipe_launches`` counts over the recorded calls, the mel kernel
    once a file; then ``--format srt --word-timestamps`` for one file
    (without the ladder: its six rungs would double the phase's time):
    numbered cues of well-formed times, its calls of 1 window and its
    launches checked likewise.  Prints the wall audio-s/s of each.  Returns
    the --batch 2 run's launches."""
    import io
    import re

    dims = cli_dims()
    ckpt = seeded_checkpoint()
    rng = np.random.default_rng(41)
    files = [ARTIFACTS / "cli0.wav", ARTIFACTS / "cli1.flac"]
    clips = [(rng.standard_normal(16000 * s) * 0.1).clip(-1, 1).astype(np.float32)
             for s in CLI_SECONDS]
    write_wav(files[0], clips[0])
    files[1].write_bytes(encode_flac(clips[1], 16000))
    recipe = ["--temperatures", ",".join(str(t) for t in LADDER), "--word-timestamps"]

    def run(argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t0

    def check_calls(what, calls, launches, rows, n_files):
        odd = [c["rows"] for c in calls if c["rows"] != rows]
        if not calls or odd:
            raise AssertionError(f"{what}: {len(calls)} decode calls, {len(odd)} of them of "
                                 f"{odd} windows, not {rows}")
        check_route_counts(what, launches, recipe_launches(dims, calls, n_files,
                                                          aligned=calls.aligned))

    reset_launches()
    with recorded_calls() as calls:
        rc, text, wall = run([*map(str, files), "--checkpoint", str(ckpt), "--batch", "2",
                              "--language", "en", *recipe, "--json"])
    launches = dict(LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cli --batch 2: exit code {rc}")
    payloads = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if [p["file"] for p in payloads] != [str(f) for f in files]:
        raise AssertionError(f"cli --batch 2: entries for {[p['file'] for p in payloads]}")
    n_words = 0
    for p in payloads:
        if not p["segments"] or p["language"] != "en" or not isinstance(p["text"], str):
            raise AssertionError(f"cli --batch 2: {p['file']}: no segments or a bad entry")
        for seg in p["segments"]:
            ws = seg.get("words", [])  # absent where the window aligned no word
            n_words += len(ws)
            if not (np.isfinite([seg["start"], seg["end"]]).all()
                    and all(w["start"] <= w["end"] for w in ws)
                    and all(a["end"] <= b["start"] + 1e-9 for a, b in zip(ws, ws[1:]))):
                raise AssertionError(f"cli --batch 2: {p['file']}: a segment's times or words "
                                     "out of order")
    check_calls("cli --batch 2", calls, launches, 2, len(files))
    print(f"[cli] --batch 2, 2 files ({sum(CLI_SECONDS)} s): exit 0, "
          f"{sum(len(p['segments']) for p in payloads)} segments, {n_words} words; "
          f"{len(calls)} decode calls of 2 windows, rungs "
          f"{[c['temperature'] or 0.0 for c in calls]}; wall {wall:.2f} s with the "
          f"checkpoint's load, {sum(CLI_SECONDS) / wall:.2f} audio-s/s; launches (checked "
          f"against recipe_launches) {launches}", flush=True)

    reset_launches()
    with recorded_calls() as calls:
        rc, text, wall = run([str(files[1]), "--checkpoint", str(ckpt), "--language", "en",
                              "--word-timestamps", "--format", "srt"])
    srt_launches = dict(LAUNCHES)
    cues = re.findall(r"(?m)^(\d+)\n(\d\d:\d\d:\d\d,\d\d\d) --> (\d\d:\d\d:\d\d,\d\d\d)$", text)
    if rc != 0 or not cues or [int(c[0]) for c in cues] != list(range(1, len(cues) + 1)):
        raise AssertionError(f"cli --format srt: exit code {rc}, cues {cues[:3]}")
    check_calls("cli --format srt", calls, srt_launches, 1, 1)
    print(f"[cli] --format srt, {files[1].name} ({CLI_SECONDS[1]} s): exit 0, {len(cues)} cues; "
          f"wall {wall:.2f} s, {CLI_SECONDS[1] / wall:.2f} audio-s/s", flush=True)
    return launches


# -- the serving engine, the int8×int8 matmuls and the evaluation tools --------

# [serve]: base.en at batch 4 with TranscribeOptions() defaults (beam 5,
# conditioned), six seeded requests of SERVE_SECONDS: the first SERVE_EARLY
# submitted at once, the rest from a second client thread once the first
# round has begun
SERVE_BATCH = 4
SERVE_SECONDS = (8, 12, 20, 35, 50, 65)
SERVE_EARLY = 4
SERVE_EAGER_CALLS = 2  # the serving calls also run with graphs=False
SERVE_LABEL = f"{TRANSCRIBE_MODEL} serve b{SERVE_BATCH} beam5"
# requests a second client submits while a new engine's first call captures
# its window (the capture held until they have returned)
SERVE_RACE_SUBMITS = 3
# the f32 pass: three requests with a two-rung ladder, the last submitted once
# the first round has begun, so that rows at both rungs share rounds; each
# call is cut to SERVE_F32_SAMPLE_LEN tokens for the script's time (every
# call is replayed through the plain path, every request sequentially)
SERVE_F32_SECONDS = (8, 20, 35)
SERVE_F32_LADDER = (0.0, 1.0)
SERVE_F32_SAMPLE_LEN = 64
# [int8 matmul]: the int8×int8 linears at base.en's shapes, (label, rows M,
# in K, out N); and the path, base.en b128 greedy with int8 weights and K/V
INT8_MM_SHAPES = tuple(
    (f"{where} {name}", m, k, n)
    for where, m in (("encoder b128", 128 * 1500), ("step b128", 128), ("step b5", 5))
    for name, k, n in (("q/k/v/out", 512, 512), ("fc1", 512, 2048), ("fc2", 2048, 512)))
INT8_MM_LABEL = f"{TRANSCRIBE_MODEL} b128 int8x8"
INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core OP/s (NVIDIA data sheet)
# [eval]: the keys of the JAX tool's verdict (tools/validate_checkpoint.py)
VERDICT_KEYS = {
    "checkpoint", "model_dims", "n_utterances", "decode", "dtype", "recipe", "wer",
    "audio_s_per_s", "wer_ok", "wer_int8", "delta_wer_int8", "int8_ok", "wer_int8_kv",
    "delta_wer_int8_kv", "int8_kv_ok", "wer_int8_matmul", "delta_wer_int8_matmul",
    "int8_matmul_ok", "word_timing", "language_id", "ok",
}


def kernel_checks_serve(rows: dict) -> None:
    """The kernels at the serving engine's shapes, into ``rows``: every
    kernel at base.en batch 4, beam 5 (the encoder kernels at 4 windows, the
    cross and beam kernels at A 4, G 5, the MLP at 20 rows), and the append
    kernel at 20 rows (the ladder's best-of-5 sampling rungs at batch 4)."""
    dims = dims_for(TRANSCRIBE_MODEL)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    serve = rows[SERVE_LABEL] = kernel_checks(dims, SERVE_BATCH, (torch.bfloat16,), group=5)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] serve sampling rungs: self_attention_append_step ({tag}, "
              f"{SERVE_BATCH * 5} rows)", flush=True)
        serve["self_attention_append_step"][tag] = check_step_attention(
            dims, SERVE_BATCH * 5, 1, dtype, randn, gen)


def seeded_audio(seconds, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in seconds]


@contextlib.contextmanager
def serving_recorded(engine, margins: bool = False, keep_inputs: bool = False):
    """``recorded_calls`` of an engine's decode calls, each call also with the
    request ids of its real rows in order (``rids``) and, with
    ``keep_inputs``, its task, mel and prompts; and the engine's rounds, the
    index of each round's first call and its requests (``rounds``: a list
    of (first call, request ids)).  The engine admits no request until
    ``gate`` is set, so that requests submitted before it share the first
    round.  Yields (calls, rounds, gate, started), the last an Event set when
    the first round begins."""
    rounds, gate, started = [], threading.Event(), threading.Event()
    decode_round, admit = engine._decode_round, engine._admit_locked
    with recorded_calls(margins) as calls:
        recording = decode_task_module.DecodeTask.run_batch

        def run_batch(task, mel, prompts, temperature=None):
            rids = [j.handle.request_id for j in engine._active
                    if j is not None and rung_key(engine.options, j.temp_idx) == temperature]
            # a prompt is its job's token list, which grows after the call
            inputs = dict(task=task, mel=mel.clone(),
                          prompts=[None if p is None else list(p) for p in prompts])
            out = recording(task, mel, prompts, temperature=temperature)
            calls[-1]["rids"] = rids
            if keep_inputs:
                calls[-1].update(inputs)
            return out

        def round_(jobs):
            rounds.append((len(calls), sorted(j.handle.request_id for _, j in jobs)))
            started.set()
            return decode_round(jobs)

        decode_task_module.DecodeTask.run_batch = run_batch
        engine._decode_round = round_
        engine._admit_locked = lambda: admit() if gate.is_set() else None
        try:
            yield calls, rounds, gate, started
        finally:
            del engine._decode_round, engine._admit_locked
            decode_task_module.DecodeTask.run_batch = recording


def request_calls(calls, rid=None) -> list:
    """The calls of one request as batch-1 calls, candidates from each call's
    sample_begin (the prefill bucket, set by the batch's longest prompt):
    ``rid`` None for calls that are one request's already (sequential)."""
    out = []
    for c in calls:
        a = 0 if rid is None else c["rids"].index(rid) if rid in c["rids"] else None
        if a is None:
            continue
        sb = c["sample_begin"]
        one = dict(c, candidates=c["candidates"][a:a + 1, :, sb:], sample_begin=0,
                   outputs=[c["outputs"][a]])
        out.append(one)
    return out


def trimmed(kernel: list, plain: list):
    """The two sides' candidates cut to one length (a request's prompt, and so
    its room in the context, differs between a batch and a sequential run)."""
    for k, p in zip(kernel, plain):
        n = min(k["candidates"].shape[-1], p["candidates"].shape[-1])
        k["candidates"], p["candidates"] = k["candidates"][..., :n], p["candidates"][..., :n]
    return kernel, plain


def serve_capture_race(model, tok, audio) -> dict:
    """A new engine (no ``warmup()``) whose first call captures its window
    while a second client thread submits SERVE_RACE_SUBMITS requests, each
    running its mel on the card on that thread.  The capture is held until
    those submits have returned (a wrapper of ``DecodeWindow.body`` waits on
    the capturing thread), so they surely run inside it.  Every request
    resolves and none fails: a mel refused during another thread's capture
    would fail its request as a bad input, and a capture disturbed by the
    client's work would raise in the engine's call."""
    body = decode_loop.DecodeWindow.body
    capturing, submitted = threading.Event(), threading.Event()
    held = []

    def held_body(self, W):
        if torch.cuda.is_current_stream_capturing() and not submitted.is_set():
            capturing.set()
            t0 = time.perf_counter()
            if not submitted.wait(timeout=300):
                raise AssertionError("serve race: no submit returned during the capture")
            held.append(time.perf_counter() - t0)
        return body(self, W)

    engine = ServingEngine(model, tok, TranscribeOptions(), batch_size=SERVE_BATCH)
    late = []

    def client():
        try:
            if capturing.wait(timeout=300):
                late.extend(engine.submit(audio) for _ in range(SERVE_RACE_SUBMITS))
        finally:
            submitted.set()

    decode_loop.DecodeWindow.body = held_body
    try:
        thread = threading.Thread(target=client)
        thread.start()
        first = engine.submit(audio)
        thread.join(timeout=600)
        outs = [h.result(timeout=600) for h in [first] + late]
        engine.drain(timeout=600)
        stats = engine.stats()
    finally:
        decode_loop.DecodeWindow.body = body
        engine.close()
    want = {"submitted": 1 + SERVE_RACE_SUBMITS, "completed": 1 + SERVE_RACE_SUBMITS,
            "failed": 0}
    if (len(late) != SERVE_RACE_SUBMITS or not held
            or {k: stats[k] for k in want} != want
            or not all(o.segments and np.isfinite(o.avg_logprobs).all() for o in outs)):
        raise AssertionError(f"serve race: {len(late)} submits during the capture, stats "
                             f"{stats}, outputs {[len(o.segments) for o in outs]}")
    print(f"  capture race: a new engine's first call captured its window while a second "
          f"client submitted {SERVE_RACE_SUBMITS} requests (their mel on the card on its "
          f"thread; the capture held {held[0]:.3f} s until they returned); all "
          f"{1 + SERVE_RACE_SUBMITS} resolved, none failed (capture_error_mode thread_local)",
          flush=True)
    return {"submits_in_capture": len(late), "capture_held_s": held[0]}


def window_mb(win) -> float:
    """The MB of a decode window's static buffers (its tensors, and those
    of its cache, cross K/V and beam state), each storage once."""
    storages = {}

    def add(x):
        if isinstance(x, torch.Tensor):
            storages[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))

    for value in vars(win).values():
        add(value)
    return sum(storages.values()) / 1e6


def serve_window_memory(model, tok) -> dict:
    """The memory a serving engine's decode windows hold at batch
    SERVE_BATCH: the primary task's and the sampling task's window at every
    prefill bucket (``WindowCache.SIZE`` each), captured: held after the
    captures (the buffers, the graphs' pools, and library workspaces of the
    capture streams), the peak, the buffers alone (``window_mb``), and what
    ``close()`` gives back, at least the buffers."""
    engine = ServingEngine(model, tok, TranscribeOptions(), batch_size=SERVE_BATCH)
    tasks = {"primary": engine.decode_task, "sampling": engine._sampling_task()}
    sot = tok.sequence_sot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    by_window, buffers = {}, 0.0
    for name, task in tasks.items():
        for width in PREFILL_BUCKETS:
            prompt = None if width == PREFILL_BUCKETS[0] else [tok.token_id_space] * (
                width - len(sot) - 1)
            tokens, _, sample_begin, _ = build_batch_prompts(
                [prompt] * SERVE_BATCH, sot, tok.token_id_sot, tok.token_id_startofprev,
                model.dims.n_text_ctx)
            if tokens.shape[1] != width:
                raise AssertionError(f"serve memory: a prompt for bucket {width} fills "
                                     f"{tokens.shape[1]}")
            before = torch.cuda.memory_allocated()
            win = task.windows.get(model, task._shape(SERVE_BATCH, width, sample_begin,
                                                      None if name == "primary" else 1.0))
            win.prepare(True)
            torch.cuda.synchronize()
            by_window[f"{name} {width}"] = (torch.cuda.memory_allocated() - before) / 1e6
            buffers += window_mb(win)
    held = (torch.cuda.memory_allocated() - base) / 1e6
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    if sum(len(t.windows) for t in tasks.values()) != 2 * len(PREFILL_BUCKETS):
        raise AssertionError("serve memory: a window was dropped")
    engine.close()
    del tasks, win
    gc.collect()
    left = (torch.cuda.memory_allocated() - base) / 1e6
    if held - left < buffers:
        raise AssertionError(f"serve memory: close() gave back {held - left:.1f} MB of the "
                             f"windows' {buffers:.1f} MB of buffers")
    print(f"  windows of batch {SERVE_BATCH} at every prefill bucket {PREFILL_BUCKETS}, the "
          f"primary task (beam 5) and the sampling task (best-of-5), captured: "
          f"{held:.1f} MB held ({buffers:.1f} MB of it the windows' buffers), peak "
          f"+{peak:.1f} MB; by window { {k: round(v, 1) for k, v in by_window.items()} } MB; "
          f"close() gave back {held - left:.1f} MB", flush=True)
    return {"held_mb_all_buckets": held, "peak_mb_all_buckets": peak,
            "buffers_mb_all_buckets": buffers, "mb_by_window": by_window,
            "left_after_close_mb": left}


def serve_phase() -> dict:
    """[serve] ``ServingEngine`` at base.en, full width and depth, seed-0
    weights, the port's Tokenizer, batch 4, after ``warmup()``.  (a) bf16,
    ``TranscribeOptions()`` defaults, six requests (SERVE_SECONDS), four
    at once and two from a second client thread once the first round has
    begun: every call of 4 rows; a round holding a late request beside an
    early one; every handle resolved, its partial segments equal to its
    output; stats consistent (submitted 6, completed 6, failed 0, the
    windows decoded and the utilisation over the calls); every kernel's
    launches as ``recipe_launches`` counts over the calls, the mel kernel
    once a request.  Prints audio-s/s (first submit to last result),
    latency p50 and p95, rounds, utilisation, ms a step.  (b) f32, three
    requests (SERVE_F32_SECONDS) with the ladder SERVE_F32_LADDER, the last
    submitted once the first round has begun: a round with calls at both
    rungs; each call replayed through the plain path on the same inputs
    (``compare_calls``); each request's calls against the port's sequential
    ``TranscribeTask`` on the card by the same rule.  Returns the bf16
    run's launches."""
    dims = dims_for(TRANSCRIBE_MODEL)
    tok = Tokenizer.for_dims(dims)
    audios = seeded_audio(SERVE_SECONDS, 51)
    print(f"[serve] {card_line()}: {TRANSCRIBE_MODEL} full width and depth, bf16, "
          f"ServingEngine batch {SERVE_BATCH}, TranscribeOptions() defaults; requests of "
          f"{SERVE_SECONDS} s, {SERVE_EARLY} at once, {len(SERVE_SECONDS) - SERVE_EARLY} from a "
          f"second client", flush=True)
    model = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")

    def first_request(warm: bool) -> tuple:
        """A new engine's first request (SERVE_SECONDS[0] s, one window),
        after ``warmup()`` or not: (its latency, the warm-up's seconds)."""
        engine = ServingEngine(model, tok, TranscribeOptions(), batch_size=SERVE_BATCH)
        t_warm = 0.0
        if warm:
            t0 = time.perf_counter()
            engine.warmup()
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.submit(audios[0]).result(timeout=600)
        latency = time.perf_counter() - t0
        engine.close()
        return latency, t_warm

    (cold, _), (warm, t_warm) = first_request(False), first_request(True)
    print(f"  first request ({SERVE_SECONDS[0]} s, one window) of a new engine: {cold:.3f} s "
          f"without warmup() (its window's phases captured in the request), {warm:.3f} s after "
          f"warmup() (DecodeTask.warmup: the windows of batch {SERVE_BATCH} at the first and "
          f"the last prefill bucket captured, {t_warm:.3f} s)", flush=True)
    LOOPS["serve first request"] = {"latency_cold_s": cold, "latency_warm_s": warm,
                                    "warmup_s": t_warm,
                                    **serve_capture_race(model, tok, audios[0])}
    LOOPS["serve windows"] = serve_window_memory(model, tok)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = ServingEngine(model, tok, TranscribeOptions(), batch_size=SERVE_BATCH)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    held_warm = (torch.cuda.memory_allocated() - base) / 1e6
    print(f"  warmup (build_all; DecodeTask.warmup: the windows of the unprompted and the 232 "
          f"bucket captured, the encoder and prefill run once): "
          f"{time.perf_counter() - t0:.2f} s; the windows hold {held_warm:.1f} MB", flush=True)
    late = []
    with serving_recorded(engine, keep_inputs=True) as (calls, rounds, gate, started):
        reset_launches()

        def second_client():
            if started.wait(timeout=600):
                late.extend(engine.submit(a) for a in audios[SERVE_EARLY:])

        client = threading.Thread(target=second_client)
        client.start()
        t_first = time.perf_counter()
        early = [engine.submit(a) for a in audios[:SERVE_EARLY]]
        gate.set()
        client.join(timeout=600)
        if client.is_alive() or len(late) != len(SERVE_SECONDS) - SERVE_EARLY:
            raise AssertionError("serve: the second client did not submit")
        handles = early + late
        outs = [h.result(timeout=600) for h in handles]
        t_last = max(h.finished_at for h in handles)
        if not engine.drain(timeout=600):
            raise AssertionError("serve: the engine did not drain")
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        stats = engine.stats()
    mem = {"held_mb": (torch.cuda.memory_allocated() - base) / 1e6,
           "peak_graphs_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
    odd = [c["rows"] for c in calls if c["rows"] != SERVE_BATCH]
    if not calls or odd:
        raise AssertionError(f"serve: {len(calls)} calls, {len(odd)} not of {SERVE_BATCH} rows")
    early_ids = {h.request_id for h in early}
    late_ids = {h.request_id for h in late}
    if rounds[0][1] != sorted(early_ids):
        raise AssertionError(f"serve: the first round holds {rounds[0][1]}, not the early "
                             f"requests {sorted(early_ids)}")
    if not any(early_ids & set(r) and late_ids & set(r) for _, r in rounds):
        raise AssertionError(f"serve: no round holds a late request beside an early one: "
                             f"{rounds}")
    for h, out in zip(handles, outs):
        if h.segments_so_far() != out.segments or not out.segments:
            raise AssertionError(f"serve: request {h.request_id}: no segments, or partial "
                                 "segments unlike its output")
        if not np.isfinite(out.avg_logprobs).all():
            raise AssertionError(f"serve: request {h.request_id}: a non-finite avg_logprob")
    windows = sum(len(o.avg_logprobs) for o in outs)
    want = {"submitted": 6, "completed": 6, "failed": 0, "queued": 0, "active": 0,
            "window_batches": len(calls), "windows_decoded": windows}
    if ({k: stats[k] for k in want} != want
            or abs(stats["batch_utilization"] - windows / (SERVE_BATCH * len(calls))) > 1e-12):
        raise AssertionError(f"serve: stats {stats}, expected {want}")
    check_route_counts("bf16 serve", launches, recipe_launches(dims, calls, len(SERVE_SECONDS),
                                                                     aligned=calls.aligned))
    steps = sum(c["steps"] for c in calls)
    print(f"  bf16: {len(SERVE_SECONDS)} requests, {windows} windows (by request "
          f"{[len(o.avg_logprobs) for o in outs]}) in {len(rounds)} rounds of "
          f"{len(calls)} calls of {SERVE_BATCH} rows; rounds' requests {[r for _, r in rounds]} "
          f"(early {sorted(early_ids)}, late {sorted(late_ids)}); utilisation "
          f"{stats['batch_utilization']:.3f}; {sum(SERVE_SECONDS) / (t_last - t_first):.2f} "
          f"audio-s/s from the first submit to the last result ({t_last - t_first:.3f} s); "
          f"latency p50 {stats['latency_p50']:.3f} s, p95 {stats['latency_p95']:.3f} s; "
          f"decode {stats['decode_seconds']:.3f} s over {steps} steps, "
          f"{stats['decode_seconds'] / steps * 1e3:.2f} ms a step", flush=True)
    print(f"  launches (checked against recipe_launches, the mel kernel once a request): "
          f"{launches}", flush=True)
    # the first SERVE_EAGER_CALLS calls again through the eager loop
    # (graphs=False) on their inputs, each held to the captured call bit for
    # bit (the eager loop costs the script's time)
    t_eager, eager_steps = 0.0, 0
    for i, c in enumerate(calls[:SERVE_EAGER_CALLS]):
        c["task"].graphs = False
        with recorded_calls() as eager:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c["task"].run_batch(c["mel"], c["prompts"], temperature=c["temperature"])
            torch.cuda.synchronize()
            t_eager += time.perf_counter() - t0
        c["task"].graphs = True
        (e,) = eager
        eager_steps += e["steps"]
        if not (all(torch.equal(c[k], e[k]) for k in ("candidates", "scores", "no_speech"))
                and c["steps"] == e["steps"] and c["loop"] == "graphs"):
            raise AssertionError(f"bf16 serve call {i}: the captured loop differs from "
                                 f"graphs=False ({c['loop']})")
    over = [c for c in calls if c["syncs"] > -(-c["steps"] // decode_loop.CHECK_EVERY) + 3]
    if over:
        raise AssertionError(f"bf16 serve: syncs past ceil(steps / k) + 3: "
                             f"{[(c['steps'], c['syncs']) for c in over]}")
    first = calls[0]

    def first_call(graphs: bool):
        first["task"].graphs = graphs
        try:
            first["task"].run_batch(first["mel"], first["prompts"],
                                    temperature=first["temperature"])
        finally:
            first["task"].graphs = True

    host = {way: host_calls(lambda g=g: first_call(g)) for way, g in (("captured", True),
                                                                      ("eager", False))}
    launch_calls = {way: sum(n for name, n in h.items() if name in HOST_CALLS)
                    for way, h in host.items()}
    LOOPS[SERVE_LABEL] = {"calls": len(calls), "steps": steps,
                          "compared_calls": min(len(calls), SERVE_EAGER_CALLS),
                          "ms_step_graphs": stats["decode_seconds"] / steps * 1e3,
                          "ms_step_eager": t_eager / eager_steps * 1e3,
                          "syncs_graphs": sum(c["syncs"] for c in calls),
                          "captures_in_calls": sum(c["captures"] for c in calls),
                          "capture_s_in_calls": sum(c["capture_seconds"] for c in calls),
                          "held_mb_after_warmup": held_warm, **mem, "host_calls": host,
                          "k": decode_loop.CHECK_EVERY}
    print(f"[graphs] {SERVE_LABEL}: {len(calls)} captured calls, the first "
          f"{min(len(calls), SERVE_EAGER_CALLS)} replayed with graphs=False on their inputs and "
          f"bit-equal (candidates, scores, no-speech, steps); decode "
          f"{stats['decode_seconds'] / steps * 1e3:.3f} ms a step captured (the engine's "
          f"decode seconds, encoders included), {t_eager / eager_steps * 1e3:.3f} eager (the "
          f"replays); host syncs {sum(c['syncs'] for c in calls)} over {steps} steps "
          f"(k {decode_loop.CHECK_EVERY}); captures in the calls (the buckets warmup() did not "
          f"make) {LOOPS[SERVE_LABEL]['captures_in_calls']} in "
          f"{LOOPS[SERVE_LABEL]['capture_s_in_calls']:.3f} s; memory: the engine's windows hold "
          f"{mem['held_mb']:.1f} MB, peak +{mem['peak_graphs_mb']:.1f} MB; host runtime calls "
          f"of call 0 ({first['steps']} steps): {launch_calls['captured']} launches captured "
          f"{host['captured']}, {launch_calls['eager']} eager {host['eager']}", flush=True)
    engine.close()  # drops the windows the replays above used
    del model, engine, calls, first
    torch.cuda.empty_cache()

    # (b) f32: the ladder, the plain replay of every call, the sequential task
    options = TranscribeOptions(decode=DecodeOptions(sample_len=SERVE_F32_SAMPLE_LEN),
                                temperatures=SERVE_F32_LADDER)
    audios = seeded_audio(SERVE_F32_SECONDS, 52)
    print(f"[serve] f32, temperatures {SERVE_F32_LADDER} (beam 5 at rung 0, best-of-5 "
          f"sampling above), sample_len {SERVE_F32_SAMPLE_LEN}; requests of {SERVE_F32_SECONDS} "
          f"s, the last once the first round has begun", flush=True)
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    engine = ServingEngine(model, tok, options, batch_size=SERVE_BATCH)
    with serving_recorded(engine, keep_inputs=True) as (calls, rounds, gate, started):
        reset_launches()
        handles = [engine.submit(a) for a in audios[:-1]]
        gate.set()
        if not started.wait(timeout=600):
            raise AssertionError("serve f32: no round began")
        handles.append(engine.submit(audios[-1]))
        outs = [h.result(timeout=600) for h in handles]
        engine.drain(timeout=600)
        torch.cuda.synchronize()
        launches_f32 = dict(LAUNCHES)
    engine.close()
    check_route_counts("f32 serve", launches_f32,
                       recipe_launches(dims, calls, len(SERVE_F32_SECONDS),
                                       aligned=calls.aligned))
    bounds = [i for i, _ in rounds] + [len(calls)]
    mixed = [r for r, (i, j) in enumerate(zip(bounds, bounds[1:]))
             if len({c["temperature"] for c in calls[i:j]}) > 1]
    if not mixed:
        raise AssertionError(f"serve f32: no round ran both rungs: {rounds}")
    print(f"  f32: {len(calls)} calls in {len(rounds)} rounds, rungs by round "
          f"{[[c['temperature'] or 0.0 for c in calls[i:j]] for i, j in zip(bounds, bounds[1:])]}"
          f"; requests by call {[c['rids'] for c in calls]}", flush=True)
    compared = 0
    for i, c in enumerate(calls):
        c["task"].kernels = c["task"].graphs = False  # the margins: the eager loop
        with recorded_calls(margins=True) as plain:
            c["task"].run_batch(c["mel"], c["prompts"], temperature=c["temperature"])
        c["task"].kernels = c["task"].graphs = True
        compared += compare_calls(f"f32 serve call {i} (T {c['temperature'] or 0.0}, requests "
                                  f"{c['rids']}), kernel path against plain", [c], plain)
    print(f"  f32: {compared} of {len(calls)} calls equal to the plain path on their inputs "
          f"(the rest stopped below the margin)", flush=True)
    for h, audio, seconds in zip(handles, audios, SERVE_F32_SECONDS):
        with recorded_calls(margins=True) as seq:
            want_out = TranscribeTask(model, tok, options, graphs=False).run(audio)
        got, ref = trimmed(request_calls(calls, h.request_id), request_calls(seq))
        what = f"f32 serve request {h.request_id} ({seconds} s) against sequential"
        if compare_calls(what, got, ref):
            out = outs[handles.index(h)]
            if ([(s.seek, s.text) for s in out.segments]
                    != [(s.seek, s.text) for s in want_out.segments]):
                raise AssertionError(f"{what}: segments differ")
            print(f"  {what}: {len(got)} calls (rungs {[c['temperature'] or 0.0 for c in got]})"
                  f" equal, {len(out.segments)} segments equal", flush=True)
    del model, engine
    torch.cuda.empty_cache()
    return launches


def int8_matmul_phase(rows: dict, int8_summary: dict) -> dict:
    """[int8 matmul] With ``WHISPER_INT8_MATMUL=1``: (a) the int8 linear
    (``quantize_rows``, ``torch._int_mm``, the f32 epilogue) at base.en's
    shapes (INT8_MM_SHAPES: the encoder's at 128 x 1500 rows, a step's at
    128 and at 5 rows, the M <= 16 case) bit-equal to its plain version
    (the exact float64 product) on the card, timed beside ``_int_mm``
    alone, ``QuantLinear``'s cast-and-matmul (the switch off) and a bf16
    ``F.linear``; whether the installed torch refuses ``_int_mm`` at 5 rows.
    (b) The path, base.en b128 greedy with int8 weights and K/V and the
    switch on: f32 parity at full depth (``parity_routes``, INT8_LOGIT_TOL),
    then bf16 timed once and profiled, beside the base.en b128 int8 path's
    ``int8_summary``.  Returns the bf16 run's launches."""
    from whisper_rs_tpu_torch.models.whisper import (
        QuantLinear,
        int8_dot,
        int8_matmul_enabled,
        int8_mm_plain,
        int_mm_rows,
        quantize_rows,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    probe = torch.zeros(5, 64, dtype=torch.int8, device=dev)
    try:
        torch._int_mm(probe, torch.zeros(64, 8, dtype=torch.int8, device=dev))
        refused = "takes 5 rows"
    except RuntimeError as e:
        refused = f"refuses 5 rows ({str(e).splitlines()[0][:80]})"
    print(f"[int8 matmul] {card_line()}: torch {torch.__version__}: torch._int_mm {refused}; "
          f"the port pads fewer than 17 rows with zero rows", flush=True)
    previous = os.environ.get("WHISPER_INT8_MATMUL")
    os.environ["WHISPER_INT8_MATMUL"] = "1"
    try:
        if not int8_matmul_enabled():
            raise AssertionError("int8 matmul: the switch does not read as on")
        for label, M, K, N in INT8_MM_SHAPES:
            lin = QuantLinear(K, N).to(dev)
            with torch.no_grad():
                w = torch.randn(N, K, generator=gen, device=dev) * K**-0.5
                values, scale = quantize_kv(w)
                lin.weight.copy_(values)
                lin.scale.copy_(scale)
                lin.bias.copy_(torch.randn(N, generator=gen, device=dev) * 0.1)
            lin = lin.to(torch.bfloat16)
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            xq, s_x = quantize_rows(x)
            got = int8_dot(xq, s_x, lin, torch.bfloat16)
            acc = int8_mm_plain(xq, lin.weight)
            want = ((acc.float() * s_x * lin.scale.float()) + lin.bias.float()).to(torch.bfloat16)
            if not torch.equal(got, want) or not torch.equal(lin(x), want):
                raise AssertionError(f"int8 matmul {label}: not bit-equal to the plain product")
            big = M * N > 1e7  # calls over a millisecond: timed eagerly
            reps = 5 if big else 50
            w_bf16 = lin.weight.to(torch.bfloat16) * lin.scale[:, None]
            ms = timed_ms(lambda: lin(x), reps, graph=not big)
            mm_ms = timed_ms(lambda: int_mm_rows(xq, lin.weight), reps, graph=not big)
            os.environ["WHISPER_INT8_MATMUL"] = "0"
            cast_ms = timed_ms(lambda: lin(x), reps, graph=not big)
            os.environ["WHISPER_INT8_MATMUL"] = "1"
            lib_ms = timed_ms(lambda: F.linear(x, w_bf16, lin.bias), reps, graph=not big)
            # x bf16 read, w int8 read, y bf16 written; 2 M K N int8 operations
            t_bytes, t_ops = (2 * M * K + N * K + 2 * M * N) / MEM_BW, 2 * M * K * N / INT8_PEAK_OPS
            bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                              else "operations")
            print(f"  {label} [{M}, {K}] x [{K}, {N}]: bit-equal to the plain product; int8 "
                  f"linear {ms:.4f} ms (_int_mm alone {mm_ms:.4f}) | switch off, cast and "
                  f"matmul {cast_ms:.4f} ms | bf16 F.linear {lib_ms:.4f} ms | int8 bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            del lin, x, xq, s_x, got, acc, want, w_bf16
            torch.cuda.empty_cache()

        dims = dims_for(TRANSCRIBE_MODEL)
        parity_routes(dims, f"{TRANSCRIBE_MODEL} full width, int8×int8 matmuls on",
                      routes=("append",), int8=True, tol=INT8X8_LOGIT_TOL)
        summary = {}
        launches = e2e(dims, TRANSCRIBE_MODEL, 128, int8_weights=True, int8_kv=True, reps=1,
                       summary=summary)
    finally:
        if previous is None:
            os.environ.pop("WHISPER_INT8_MATMUL", None)
        else:
            os.environ["WHISPER_INT8_MATMUL"] = previous
    print(f"[int8 matmul] {card_line()}: base.en b128 int8 weights and K/V, bf16: switch on "
          f"{summary['ms_step']:.2f} ms a step, {summary['audio_s_per_s']:.2f} audio-s/s, "
          f"{summary.get('launches_per_pass', float('nan')):.1f} launches and "
          f"{summary.get('busy_ms_per_pass', float('nan')):.3f} ms device busy a pass; switch "
          f"off (the int8 path above) {int8_summary['ms_step']:.2f} ms a step, "
          f"{int8_summary['audio_s_per_s']:.2f} audio-s/s, "
          f"{int8_summary.get('launches_per_pass', float('nan')):.1f} launches and "
          f"{int8_summary.get('busy_ms_per_pass', float('nan')):.3f} ms a pass", flush=True)
    rows[INT8_MM_LABEL] = rows[int8_label(*INT8_PATHS[0][:3])]
    return launches


def cli_dims():
    """base.en with its depth cut to CLI_DEPTH + CLI_DEPTH layers."""
    return dataclasses.replace(dims_for(TRANSCRIBE_MODEL), n_audio_layer=CLI_DEPTH,
                               n_text_layer=CLI_DEPTH)


@functools.lru_cache(maxsize=1)
def seeded_checkpoint() -> pathlib.Path:
    """An OpenAI-format checkpoint of ``cli_dims()`` with seed-0 weights,
    written under ARTIFACTS once a run (a file left there by another run
    may hold other weights)."""
    dims = cli_dims()
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    ckpt = ARTIFACTS / f"{TRANSCRIBE_MODEL}-{CLI_DEPTH}+{CLI_DEPTH}-seed0.pt"
    torch.save({"dims": dataclasses.asdict(dims),
                "model_state_dict": init_random(dims, 0, device="cpu").state_dict()}, ckpt)
    return ckpt


def eval_phase() -> None:
    """[eval] The evaluation tools on the card: a synthetic LibriSpeech split
    (two seeded 2 s FLACs and a trans.txt, as the JAX tools' tests write
    it) and the [cli] phase's checkpoint.  ``validate_checkpoint`` (greedy,
    batch 2, 16 tokens a window, the recipe) must print a verdict with
    every key of the JAX tool's and return 3 (random weights fail the
    quality gates); ``eval_wer`` (greedy, batch 2, one pass a window) must
    return 0 and print a WER."""
    import io

    from whisper_rs_tpu_torch.tools import eval_wer, validate_checkpoint

    split = ARTIFACTS / "librispeech" / "test-clean"
    d = split / "19" / "198"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(2):
        utt = f"19-198-{i:04d}"
        audio = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
        (d / f"{utt}.flac").write_bytes(encode_flac(audio, 16000))
        lines.append(f"{utt} HELLO WORLD NUMBER {i}")
    (d / "19-198.trans.txt").write_text("\n".join(lines))
    ckpt = seeded_checkpoint()

    def run(tool, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t0

    rc, text, wall = run(validate_checkpoint, [
        "--checkpoint", str(ckpt), "--librispeech", str(split), "--greedy", "--batch", "2",
        "--sample-len", "16"])
    verdict = json.loads(text.strip().splitlines()[-1])
    if rc != 3 or set(verdict) != VERDICT_KEYS or verdict["ok"]:
        raise AssertionError(f"validate_checkpoint: exit code {rc}, keys "
                             f"{sorted(set(verdict) ^ VERDICT_KEYS)} apart, ok {verdict['ok']}")
    print(f"[eval] {card_line()}: validate_checkpoint on the card: exit 3 (random weights fail the gates), "
          f"every key of the JAX tool's verdict; {wall:.2f} s; verdict {json.dumps(verdict)}",
          flush=True)
    rc, text, wall = run(eval_wer, ["--checkpoint", str(ckpt), "--librispeech", str(split),
                                    "--greedy", "--batch", "2", "--no-recipe"])
    line = next((x for x in text.splitlines() if x.startswith("WER:")), None)
    if rc != 0 or line is None:
        raise AssertionError(f"eval_wer: exit code {rc}, output {text[-200:]!r}")
    print(f"[eval] eval_wer on the card: exit 0; {line}; {wall:.2f} s", flush=True)


# -- [parallel]: tensor, sequence, pipeline and data parallelism on the card ----

# Two ranks share the one card through gloo, which stages every collective's
# tensors through pinned host memory (NCCL takes one card a rank): the times
# are those of two processes time-sharing a card, not a scaling figure.
PAR_MODEL = TRANSCRIBE_MODEL  # base.en at full width and depth
PAR_BATCH = 8
PAR_RANKS = 2
PAR_PATHS = ("tp", "ulysses", "pp", "dp")
PAR_TEXT = {"tp": "TP 2", "ulysses": "Ulysses 2", "pp": "PP 2", "dp": "DP 2"}
PAR_TP_LABEL = f"{PAR_MODEL} b{PAR_BATCH} TP 2 greedy"
PAR_ULYSSES_LABEL = f"{PAR_MODEL} b{PAR_BATCH} Ulysses 2"
PAR_SERVE_LABEL = f"{PAR_MODEL} serve b{SERVE_BATCH} beam5 TP 2"
PAR_TP4_LABEL = "large-v3 b12 TP 4 split heads"  # checked in the kernels phase only
PAR_SERVE_SECONDS = (8, 12, 20)
PAR_ENC_TOL = 1e-3  # |d| of an f32 encoder output of a parallel path against one process
PAR_TIMEOUT = 900
PAR_CLI_SAMPLE_LEN = 32  # the torchrun CLI's tokens a window (beam 5, f32)
PAR_SERVE_SAMPLE_LEN = 96  # the TP 2 engine's tokens a window (beam 5, bf16)


def tp_dims(dims, n: int):
    """The attention shapes of one tensor-parallel rank: n times fewer heads
    and as many times narrower q, k and v (the head dim stays)."""
    return dataclasses.replace(
        dims, n_audio_head=dims.n_audio_head // n, n_audio_state=dims.n_audio_state // n,
        n_text_head=dims.n_text_head // n, n_text_state=dims.n_text_state // n)


def kernel_checks_parallel(rows: dict) -> None:
    """The kernels at the shapes that [parallel] gives them for the first
    time, into ``rows``, each against its plain version, timed: TP 2 at
    base.en batch 8 (the mel kernel at 8 windows; the LayerNorm pair at the
    whole D; row 4 on 4 heads [8, 1500, 256]; the cross kernel at 4 heads,
    G 1; the append kernel at 8 rows of 4 heads; the MLP at D 512 and the
    shard's hidden 1024); Ulysses 2 at batch 8 (the LayerNorm pair at
    [8, 750, 512]; row 6 on 4 of the 8 heads, [8, 4, 1500, 64]); the TP 2
    serving engine at batch 4, beam 5 (row 4 on 4 heads, the cross and beam
    kernels at 4 heads, A 4, G 5, the MLP at 20 rows, hidden 1024; its mel
    and LayerNorm shapes are the unsharded engine's); and row 6 at
    large-v3 b12's TP 4 shape, 5 heads a rank [12, 5, 1500, 64], which row 4
    refuses (an odd head count)."""
    dims = dims_for(PAR_MODEL)
    local = tp_dims(dims, 2)
    T, D, H, dh = dims.n_audio_ctx, dims.n_audio_state, dims.n_audio_head, dims.head_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    tp, uly, srv, tp4 = ({name: {} for name in KERNELS} for _ in range(4))
    rows.update({PAR_TP_LABEL: tp, PAR_ULYSSES_LABEL: uly, PAR_SERVE_LABEL: srv,
                 PAR_TP4_LABEL: tp4})
    print(f"[kernels] TP 2: log_mel (f32, {PAR_BATCH} windows)", flush=True)
    padded = reflect_pad(randn(PAR_BATCH, N_SAMPLES, scale=0.1)).contiguous()
    tp["log_mel"]["f32"] = check_mel(padded, dims.n_mels, padded.numel() * 4)
    del padded
    for name in ("log_mel", "ln_fused", "residual_ln"):
        srv[name] = rows[SERVE_LABEL][name]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        print(f"[kernels] TP 2 b{PAR_BATCH} ({tag}): the LayerNorm pair at D {D}, row 4 on "
              f"{H // 2} heads, the cross and append kernels at {H // 2} heads, the MLP at "
              f"hidden {2 * D}", flush=True)
        tp["ln_fused"][tag], tp["residual_ln"][tag] = check_ln_pair((PAR_BATCH, T, D), dtype,
                                                                     randn)
        tp["encoder_attention_merged"][tag] = check_merged(PAR_BATCH, T, H // 2, dh, dtype,
                                                           randn)
        tp["cross_attention_step"][tag] = check_cross(local, PAR_BATCH, 1, dtype, randn)
        tp["self_attention_append_step"][tag] = check_step_attention(local, PAR_BATCH, 1, dtype,
                                                                     randn, gen)
        tp["decoder_mlp_step"][tag] = check_mlp(dims, PAR_BATCH, dtype, randn, hidden=2 * D)
        print(f"[kernels] Ulysses 2 b{PAR_BATCH} ({tag}): the LayerNorm pair at "
              f"[{PAR_BATCH}, {T // 2}, {D}], row 6 on {H // 2} heads", flush=True)
        uly["ln_fused"][tag], uly["residual_ln"][tag] = check_ln_pair((PAR_BATCH, T // 2, D),
                                                                       dtype, randn)
        uly["encoder_attention_split"][tag] = check_split_attention((PAR_BATCH, H // 2, T, dh),
                                                                    dtype, randn)
        print(f"[kernels] TP 2 serve b{SERVE_BATCH} beam 5 ({tag})", flush=True)
        srv["encoder_attention_merged"][tag] = check_merged(SERVE_BATCH, T, H // 2, dh, dtype,
                                                            randn)
        srv["cross_attention_step"][tag] = check_cross(local, SERVE_BATCH, 5, dtype, randn)
        srv["beam_self_attention_step"][tag] = check_step_attention(local, SERVE_BATCH, 5, dtype,
                                                                    randn, gen)
        srv["decoder_mlp_step"][tag] = check_mlp(dims, SERVE_BATCH * 5, dtype, randn,
                                                 hidden=2 * D)
        print(f"[kernels] large-v3 b12 TP 4 ({tag}): row 6 on 5 heads a rank", flush=True)
        tp4["encoder_attention_split"][tag] = check_split_attention((12, 5, 1500, 64), dtype,
                                                                    randn)
        torch.cuda.empty_cache()


def par_serve_options() -> TranscribeOptions:
    """``TranscribeOptions()`` (beam 5, timestamps, conditioned), each window
    cut to PAR_SERVE_SAMPLE_LEN tokens for the script's time."""
    return TranscribeOptions(decode=DecodeOptions(sample_len=PAR_SERVE_SAMPLE_LEN))


def _par_greedy(name: str, model, audio, encoder_fn=None, graphs: bool = True) -> dict:
    """One greedy path of ``parallel_rank``: the mel kernel, the decode, f32,
    SAMPLE_LEN steps (``graphs``: the step captured, where the mesh allows;
    ``decode.loop.eager_reason``), with every launch count and the
    collectives' counts set to 0 just before and read just after."""
    from whisper_rs_tpu_torch.parallel import collectives

    dims = model.dims
    initial = np.full((audio.shape[0], 1), SOT, np.int64)
    torch.cuda.synchronize()
    reset_launches()
    collectives.reset_stats()
    t0 = time.perf_counter()
    mel = log_mel_frontend(audio, dims.n_mels)
    res = decode_greedy(model, mel, initial, 1, 0, filter_config(dims), GreedyMode(), SAMPLE_LEN,
                        NO_SPEECH, encoder_fn=encoder_fn, graphs=graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tokens": res.candidates[:, 0].cpu(), "scores": res.scores.cpu(),
            "no_speech": res.no_speech_probs.cpu(), "xa": res.audio_features.float().cpu(),
            "steps": res.steps, "bodies": res.bodies, "syncs": res.syncs, "loop": res.loop,
            "captures": res.captures, "capture_s": res.capture_seconds, "wall": wall,
            "launches": dict(LAUNCHES), "stats": dict(collectives.STATS)}


def parallel_rank(rank: int, audio: np.ndarray, serve_audios: list) -> dict:
    """One of PAR_RANKS ranks of [parallel], sharing the card under gloo:
    base.en f32 greedy at batch 8 on four meshes (TP 2, Ulysses 2, PP 2,
    DP 2; each a model of its own, seed 0), then the bf16 TP 2 serving
    engine (rank 0) and its follower (rank 1), then, on rank 0, TP 1 on a
    one-card NCCL group.  Returns rank 0's outputs and every rank's counts."""
    import torch.distributed as dist

    from whisper_rs_tpu_torch.parallel import (
        collectives, make_mesh, pp_encoder_fn, shard_model, ulysses_encoder_fn,
    )
    from whisper_rs_tpu_torch.parallel.distributed import rank_device
    from whisper_rs_tpu_torch.parallel.mesh import Mesh
    from whisper_rs_tpu_torch.serve import serve_follower

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device("cuda")
    dims = dims_for(PAR_MODEL)
    whole = init_random(dims, seed=0, dtype=torch.float32, device=dev)

    def model_of(dtype=torch.float32):  # a copy of the seed-0 model, to shard in place
        return copy.deepcopy(whole).to(dtype)

    out = {}
    tp_mesh = make_mesh(n_model=2)
    meshes = {"tp": tp_mesh, "ulysses": tp_mesh, "pp": make_mesh(n_stage=2),
              "dp": make_mesh(n_data=2)}
    for name in PAR_PATHS:
        mesh = meshes[name]
        model = shard_model(model_of(), mesh, tensor_parallel=name != "ulysses")
        fn = {"ulysses": ulysses_encoder_fn(mesh), "pp": pp_encoder_fn(mesh)}.get(name)
        out[name] = _par_greedy(name, model, audio, fn)
        if rank:
            del out[name]["xa"]  # rank 0's stands for both: the encoder output is replicated
        del model
        torch.cuda.empty_cache()

    # bf16 serving: the engine on rank 0 leads the follower on rank 1
    model = shard_model(model_of(torch.bfloat16), tp_mesh)
    tok = Tokenizer.for_dims(dims)
    options = par_serve_options()
    if rank:
        dist.barrier()
        out["serve"] = {"follower_calls": serve_follower(model, tok, options)}
    else:
        engine = ServingEngine(model, tok, options, batch_size=SERVE_BATCH)
        dist.barrier()  # the kernels are built: no warmup()
        with serving_recorded(engine) as (calls, rounds, gate, started):
            reset_launches()
            collectives.reset_stats()
            t0 = time.perf_counter()
            handles = [engine.submit(a) for a in serve_audios]
            gate.set()
            outs = [h.result(timeout=600) for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, stats = dict(LAUNCHES), dict(collectives.STATS)
            engine_stats = engine.stats()
        engine.close()
        keep = ("temperature", "rows", "outputs", "steps", "bodies", "syncs", "loop",
                "candidates", "scores", "no_speech", "sample_begin", "rids")
        out["serve"] = {"calls": [{k: c[k] for k in keep} for c in calls],
                        "aligned": calls.aligned,
                        "rids": [h.request_id for h in handles], "wall": wall,
                        "segments": [[(s.seek, s.text) for s in o.segments] for o in outs],
                        "launches": launches, "stats": stats, "engine": engine_stats}
    del model
    torch.cuda.empty_cache()

    # TP 1 on a one-card NCCL group (rank 0 its only member): the NCCL branch
    # of every collective runs on the card
    nccl = dist.new_group([0], backend="nccl")
    if rank == 0:
        unsharded = _par_greedy("unsharded", model_of(), audio)
        mesh = Mesh(n_model=1, model_group=nccl, data_group=nccl, backend="nccl")
        tp1 = shard_model(model_of(), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one = _par_greedy("nccl", tp1, audio)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        eager = _par_greedy("nccl eager", tp1, audio, graphs=False)
        # the host's runtime calls of a PROFILE_STEPS-token window both ways
        # (the captured window made by a first call)
        mel = log_mel_frontend(audio, dims.n_mels)
        windows = WindowCache()

        def cut(graphs: bool):
            decode_greedy(tp1, mel, np.full((audio.shape[0], 1), SOT), 1, 0,
                          filter_config(dims), GreedyMode(), PROFILE_STEPS, NO_SPEECH,
                          graphs=graphs, windows=windows if graphs else None)

        cut(True)
        host = {f"{way} {PROFILE_STEPS}-token": host_calls(lambda g=g: cut(g))
                for way, g in (("captured", True), ("eager", False))}
        out["nccl"] = {"whole": unsharded, "tp1": one, "tp1_eager": eager, "host": host,
                       "peak_graphs_mb": peak}
        del windows
    dist.barrier()
    return out


def compare_greedy(what: str, tokens, want, model, mel, cfg) -> None:
    """Tokens [B, n_ctx] equal to ``want`` per row, unless the reference's
    plain top-2 margin at the row's first divergent position is below
    1e-3 (``plain_margin``)."""
    for r in range(want.shape[0]):
        diff = (tokens[r] != want[r]).nonzero()
        if diff.numel() == 0:
            continue
        pos = int(diff[0])
        margin = plain_margin(model, mel, r, want[r].to(mel.device), pos, cfg)
        print(f"  {what}: row {r} apart at position {pos}; the reference's top-2 margin "
              f"{margin:.3e}", flush=True)
        if margin >= 1e-3:
            raise AssertionError(f"{what}: row {r} diverges at {pos} with margin {margin:.3e}")


def parallel_cli(ckpt: pathlib.Path) -> dict:
    """The command line under torchrun: ``--tp 2 --dist-backend gloo`` on two
    processes (``python -m torch.distributed.run --standalone``) over the
    [cli] phase's files and checkpoint, f32, against the unsharded CLI in
    this process: exit 0, and the JSON equal, or apart only where the
    unsharded run's smallest beam selection margin or ranking gap was below
    1e-3 (``compare_calls``' rule).  Returns the seconds of each."""
    import io

    files = [ARTIFACTS / "cli0.wav", ARTIFACTS / "cli1.flac"]
    argv = [*map(str, files), "--checkpoint", str(ckpt), "--language", "en", "--json",
            "--dtype", "float32", "--sample-len", str(PAR_CLI_SAMPLE_LEN)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with recorded_calls(margins=True) as calls, contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli (one process): exit code {rc}")
    want = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(PAR_RANKS), "-m", "whisper_rs_tpu_torch.cli", *argv, "--tp", str(PAR_RANKS),
           "--dist-backend", "gloo"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root, env=env)
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun cli --tp 2: exit code {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    got = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if got != want:
        margins = [m for c in calls for m in (c["margin"], c["rank_gap"]) if m is not None]
        smallest = min(margins, default=float("inf"))
        print(f"  torchrun cli --tp 2: JSON apart from the unsharded CLI's; its smallest margin "
              f"{smallest:.3e}", flush=True)
        if smallest >= 1e-3 or [p["file"] for p in got] != [p["file"] for p in want]:
            raise AssertionError("torchrun cli --tp 2: JSON differs from the unsharded CLI's")
    print(f"[parallel] torchrun --nproc-per-node {PAR_RANKS} -m whisper_rs_tpu_torch.cli --tp "
          f"{PAR_RANKS} --dist-backend gloo (f32, {len(files)} files): exit 0, JSON "
          f"{'equal to' if got == want else 'apart below the margin from'} the unsharded CLI's "
          f"({len(calls)} decode calls); {run_s:.1f} s wall with start-up and the checkpoint's "
          f"load on each rank, against {whole_s:.1f} s in one process", flush=True)
    return {"torchrun_s": run_s, "one_process_s": whole_s}


def parallel_phase() -> dict:
    """[parallel] Two ranks share the card through gloo (``run_ranks(...,
    backend="gloo", device="cuda")``; NCCL takes one card a rank), base.en
    at full width and depth, seed-0 weights.  f32 greedy at batch 8 (8
    seeded 30 s windows, SAMPLE_LEN steps) on TP 2, Ulysses 2 (then greedy
    through ``encoder_fn``), PP 2 (likewise) and DP 2, each held to the
    single-process kernel path: the encoder output within PAR_ENC_TOL, the
    tokens equal per row unless the reference's top-2 margin at the first
    divergence is below 1e-3, both ranks' tokens equal, and each rank's
    launches as the path gives them; then the bf16 TP 2 ServingEngine on
    PAR_SERVE_SECONDS requests (``par_serve_options``),
    each request's calls held to the unsharded sequential TranscribeTask by
    ``compare_calls``' rule and its launches to ``recipe_launches``; then
    TP 1 on a one-card NCCL group against the unsharded model in the same
    process (tokens, encoder output and scores bit-equal); then the
    torchrun CLI (``parallel_cli``).  Prints each path's launches by kernel,
    its collectives a step, the bytes staged and ms a step: two processes
    time-sharing one card through host-staged collectives, not a scaling
    figure.  Returns the launches of the TP, Ulysses and serving paths."""
    from whisper_rs_tpu_torch.parallel.launch import run_ranks
    from whisper_rs_tpu_torch.parallel.pipeline import _default_n_micro

    dims = dims_for(PAR_MODEL)
    cfg = filter_config(dims)
    rng = np.random.default_rng(61)
    audio = np.stack([(rng.standard_normal(N_SAMPLES) * 0.05 * (i % 4 + 1)).astype(np.float32)
                      for i in range(PAR_BATCH)])
    serve_audios = seeded_audio(PAR_SERVE_SECONDS, 63)
    print(f"[parallel] {card_line()}: {PAR_MODEL} full width and depth, {PAR_RANKS} ranks on "
          f"one card through gloo (host-staged collectives); f32 greedy b{PAR_BATCH} "
          f"{SAMPLE_LEN} steps on {', '.join(PAR_TEXT.values())}; bf16 TP 2 serving of "
          f"{PAR_SERVE_SECONDS} s; TP 1 on NCCL; the torchrun CLI", flush=True)

    # the references: one process, the kernel path
    model = init_random(dims, seed=0, dtype=torch.float32, device="cuda")
    ref = _par_greedy("one process", model, audio)
    mel = log_mel_frontend(audio, dims.n_mels)
    model16 = init_random(dims, seed=0, dtype=torch.bfloat16, device="cuda")
    tok = Tokenizer.for_dims(dims)
    seq = []
    for a in serve_audios:
        with recorded_calls(margins=True) as calls:  # margins: the eager loop
            TranscribeTask(model16, tok, par_serve_options(), graphs=False).run(a)
        seq.append(calls)
    del model16
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_RANKS, backend="gloo", device="cuda",
                      args=(audio, serve_audios), timeout=PAR_TIMEOUT, threads=0)
    print(f"  {PAR_RANKS} ranks spawned, run and joined in {time.perf_counter() - t0:.1f} s",
          flush=True)
    L, Lt = dims.n_audio_layer, dims.n_text_layer
    n_micro = _default_n_micro(PAR_BATCH, 2)
    ref_ms = ref["wall"] / max(ref["steps"], 1) * 1e3
    print(f"  one process (the reference): {ref['steps']} steps, {ref_ms:.2f} ms a step "
          f"(mel, encoder and prefill included)", flush=True)
    launches = {}
    for name in PAR_PATHS:
        what = f"{PAR_TEXT[name]} greedy"
        got = ranks[0][name]
        d = (got["xa"] - ref["xa"]).abs().max().item()
        print(f"  {what}: encoder output max_abs_err {d:.3e} (tolerance {PAR_ENC_TOL:g})",
              flush=True)
        if not d <= PAR_ENC_TOL:
            raise AssertionError(f"{what}: encoder output off by {d:.3e}")
        compare_greedy(what, got["tokens"], ref["tokens"], model, mel, cfg)
        if not torch.equal(ranks[1][name]["tokens"], got["tokens"]):
            raise AssertionError(f"{what}: the two ranks' tokens differ")
        for r, res in enumerate(ranks):
            steps, bodies = res[name]["steps"], res[name]["bodies"]
            expect = expected_launches(dims, bodies, bodies + 1, "append")
            if name == "ulysses":
                expect.update(encoder_attention_merged=0, encoder_attention_split=L)
            if name == "pp":  # the stage's L / 2 blocks, once a microbatch; ln_post once
                expect.update({k: L // 2 * n_micro for k in
                               ("residual_ln", "encoder_attention_merged")})
                expect["ln_fused"] = ln_launches(dims, 1, bodies + 1,
                                                 encoder_blocks=L // 2 * n_micro)
            if name == "dp":  # each rank's own loop: its steps are not the gathered count
                expect = {k: True for k, v in expect.items() if v}
            check_route_counts(f"{what} rank {r}", res[name]["launches"], expect)
            ms = res[name]["wall"] / max(steps, 1) * 1e3
            st = res[name]["stats"]
            print(f"  {what} rank {r}: {steps} steps ({res[name]['loop']} loop, "
                  f"{res[name]['syncs']} syncs), {ms:.2f} ms a step (mel, encoder and "
                  f"prefill included); {st['collectives']} collectives "
                  f"({st['collectives'] / max(steps, 1):.1f} a step), "
                  f"{st['bytes_staged'] / 1e6:.2f} MB staged through host memory; launches "
                  f"{ {k: v for k, v in res[name]['launches'].items() if v} }", flush=True)
        launches[name] = ranks[0][name]["launches"]

    srv = ranks[0]["serve"]
    for rid, calls in zip(srv["rids"], seq):
        compare_calls(f"bf16 TP 2 serve request {rid} against the unsharded sequential task",
                      *trimmed(request_calls(srv["calls"], rid), request_calls(calls)))
    check_route_counts("bf16 TP 2 serve", srv["launches"],
                       recipe_launches(dims, srv["calls"], len(PAR_SERVE_SECONDS),
                                       aligned=srv["aligned"]))
    steps = sum(c["steps"] for c in srv["calls"])
    st = srv["stats"]
    print(f"  bf16 TP 2 serve: {len(PAR_SERVE_SECONDS)} requests, {len(srv['calls'])} calls of "
          f"{SERVE_BATCH} rows, {steps} steps; each request's calls held to the unsharded "
          f"sequential task; {sum(PAR_SERVE_SECONDS) / srv['wall']:.2f} audio-s/s; "
          f"{srv['wall'] / max(steps, 1) * 1e3:.2f} ms a step; {st['collectives']} collectives "
          f"({st['collectives'] / max(steps, 1):.1f} a step), {st['bytes_staged'] / 1e6:.2f} MB "
          f"staged; the follower mirrored {ranks[1]['serve']['follower_calls']} calls; launches "
          f"{ {k: v for k, v in srv['launches'].items() if v} }", flush=True)
    launches["serve"] = srv["launches"]

    whole, tp1 = ranks[0]["nccl"]["whole"], ranks[0]["nccl"]["tp1"]
    if not torch.equal(whole["tokens"], tp1["tokens"]):
        raise AssertionError("TP 1 on NCCL: tokens differ from the unsharded model's")
    dx = (whole["xa"] - tp1["xa"]).abs().max().item()
    ds = (whole["scores"] - tp1["scores"]).abs().max().item()
    if dx or ds:
        raise AssertionError(f"TP 1 on NCCL: encoder output off by {dx:.3e}, scores by {ds:.3e}")
    st = tp1["stats"]
    if st["collectives"] < 1 or st["bytes_staged"]:
        raise AssertionError(f"TP 1 on NCCL: collectives {st}: none ran on the card")
    print(f"  TP 1 on a one-card NCCL group: tokens, encoder output and scores bit-equal to "
          f"the unsharded model's; {st['collectives']} collectives on the card, none staged",
          flush=True)
    nccl = ranks[0]["nccl"]
    eager = nccl["tp1_eager"]
    if not (all(torch.equal(tp1[k], eager[k]) for k in ("tokens", "scores", "no_speech"))
            and tp1["steps"] == eager["steps"] and tp1["loop"] == "graphs"):
        raise AssertionError(f"TP 1 on NCCL: the captured loop ({tp1['loop']}) differs from "
                             "graphs=False")
    bound = -(-tp1["steps"] // decode_loop.CHECK_EVERY) + 3
    if tp1["syncs"] > bound:
        raise AssertionError(f"TP 1 on NCCL: {tp1['syncs']} syncs, past {bound}")
    launch_calls = {way: sum(n for name, n in h.items() if name in HOST_CALLS)
                    for way, h in nccl["host"].items()}
    LOOPS["base.en b8 TP 1 on NCCL"] = {
        "steps": tp1["steps"], "wall_ms_step_graphs": tp1["wall"] / tp1["steps"] * 1e3,
        "wall_ms_step_eager": eager["wall"] / eager["steps"] * 1e3, "syncs_graphs": tp1["syncs"],
        "syncs_eager": eager["syncs"], "captures": tp1["captures"], "capture_s": tp1["capture_s"],
        "peak_graphs_mb": nccl["peak_graphs_mb"], "host_calls": nccl["host"],
        "k": decode_loop.CHECK_EVERY, "collectives_recorded": st["collectives"]}
    print(f"[graphs] base.en b8 TP 1 on NCCL, f32: the captured loop (its all-reduces in the "
          f"graphs) bit-equal to graphs=False (tokens, scores, no-speech, {tp1['steps']} steps);"
          f" wall over the steps {tp1['wall'] / tp1['steps'] * 1e3:.3f} ms captured (its "
          f"first call, which captured: {tp1['captures']} captures in {tp1['capture_s']:.3f} "
          f"s), {eager['wall'] / eager['steps'] * 1e3:.3f} eager (mel, encoder and prefill "
          f"included); syncs {tp1['syncs']} (bound {bound}) / {eager['syncs']}; peak memory "
          f"+{nccl['peak_graphs_mb']:.1f} MB over the call; host runtime calls of a "
          f"{PROFILE_STEPS}-token window: " + "; ".join(
              f"{way} {launch_calls[way]} launches {h}" for way, h in nccl["host"].items())
          + f"; collectives counted on the host {st['collectives']} (a capture counts its "
          f"step's once)", flush=True)
    del model
    torch.cuda.empty_cache()
    parallel_cli(seeded_checkpoint())
    return launches


# substrings of the device kernel names of the port's own kernels
OWN_KERNELS = {
    "log_mel_kernel": "log_mel",
    "layer_norm_rows": "ln_fused/residual_ln (warp or block variant)",
    "attn_wgmma_kernel": "encoder_attention_merged / encoder_attention_split (bf16, dh 64)",
    "attn_mma_kernel": "encoder_attention_split (bf16, dh 16)",
    "cross_attn_kernel": "cross_attention_step",
    "self_append_kernel": "self_attention_append_step",
    "beam_self_kernel": "beam_self_attention_step",
    "mlp_tc_kernel": "decoder_mlp_step (bf16: fc1 + GELU, fc2)",
    "mlp_fc1_gelu_kernel": "decoder_mlp_step (f32: fc1 + GELU)",
    "mlp_fc2_kernel": "decoder_mlp_step (f32: fc2)",
    "self_fused_kernel": "self_attention_fused_step",
    "decoder_step_kernel": "decoder_step_fused (f32)",
    "decoder_step_tc_kernel": "decoder_step_fused (bf16)",
    "self_step_kernel": "self_attention_step",
    "beam_self_int8_kernel": "beam_self_attention_step (int8)",
}


def device_kind(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return f"port kernel: {label}"
    low = name.lower()
    if "copy" in low and "signed char" in low:
        return "library: int8 casts and copies (K/V quantise and write)"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "library: matmul"
    if any(s in low for s in ("sort", "radix")):
        return "library: sort (beam ranking)"
    if any(s in low for s in ("reduce", "softmax", "argmax")):
        return "library: reductions/softmax"
    if any(s in low for s in ("memcpy", "copy", "cat", "index", "scatter", "gather")):
        return "library: copies/indexing"
    return "library: elementwise/other"


def device_events(prof) -> dict:
    """{name: (device us, count)} of the kernels and copies of a finished
    ``torch.profiler`` run, less the profiler's own "Activity Buffer
    Request": what ``prof.key_averages()`` gives for its device-side events,
    read from the raw Kineto events without building the profiler's Python
    object and tree of every event, which take seconds for the 10^5 events
    of a traced e2e run.  An asynchronous event counts with no time, as in
    ``key_averages()``."""
    device = torch.autograd.DeviceType.CUDA
    names: dict = {}
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != device or getattr(e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = torch._C._demangle(raw) if len(raw) > 1 else raw
            names[raw] = name = "ProfilerStep*" if name.startswith("ProfilerStep#") else name
        if name == "Activity Buffer Request":
            continue
        timed = not (e.is_async() or e.start_thread_id() != e.end_thread_id())
        us = (e.end_ns() - e.start_ns()) / 1e3 if timed else 0.0
        t, n = out.get(name, (0.0, 0))
        out[name] = (t + us, n + 1)
    return out


def device_launches(fn, warmup: int = 2) -> int:
    """Device launches (kernels and copies on the card) of one call of
    ``fn`` under torch.profiler.  The profiler records ``warmup`` calls
    before the one it reports: a window of a single short call lost its
    first events on the H100 (the whole-step kernel among them).  Only the
    count is read: the durations of this short window were not plausible on
    the H100 (11.96 ms for a layer-route step whose kernels take 4.4 ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=1, repeat=1)) as prof:
        for _ in range(warmup + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(n for _, n in device_events(prof).values())


def profile_run(run, audio, what: str, passes: int = 0) -> dict:
    """One more run of the e2e batch under torch.profiler: its wall time, its
    device busy time (the sum of kernel durations; one stream, so kernels do
    not overlap) and idle share, device time by kind, the top kernels, and
    (given its ``passes`` width-1 decoder passes) its device launches a
    pass.  Returns those numbers (empty where the trace holds no device
    time).  The profiler records the device's activity alone (with the
    host's operators too, processing the trace took twice as long for the
    same device numbers), and the trace is read raw (``device_events``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(audio)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        print("[profile] the trace holds no device time: not measured", flush=True)
        return {}
    busy_ms = sum(t for t, _ in events.values()) / 1e3
    means = [(t, n) for name, (t, n) in events.items() if "MeanOps" in name]
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
           "mean_ops": sum(n for _, n in means)}
    print(f"[profile] {what} under torch.profiler: wall {wall_ms:.1f} ms; "
          f"device busy {busy_ms:.1f} ms; idle share {1 - busy_ms / wall_ms:.3f}; torch "
          f"MeanOps reductions {out['mean_ops']} launches, {sum(t for t, _ in means) / 1e3:.2f} "
          f"ms (a plain LayerNorm takes 2)", flush=True)
    if passes:
        n = sum(n for _, n in events.values())
        out.update(launches_per_pass=n / passes, busy_ms_per_pass=busy_ms / passes)
        print(f"  device launches (kernels and copies): {n} in all, {n / passes:.1f} a width-1 "
              f"decoder pass over {passes} (the encoder's and prefill's included); device busy "
              f"{busy_ms / passes:.3f} ms a pass", flush=True)
    by_kind: dict = {}
    for name, (us, count) in events.items():
        t, n = by_kind.get(device_kind(name), (0.0, 0))
        by_kind[device_kind(name)] = (t + us, n + count)
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:40s} {t / 1e3:9.2f} ms {n:7d} launches")
    print("  top kernels by device time:")
    for name, (us, count) in sorted(events.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.2f} ms {count:7d}x  {name[:90]}")
    return out


KERNELS = {
    "log_mel": ("cuda", "whisper_rs_tpu_torch/csrc/mel.cu",
                "whisper_rs_tpu/ops/mel_pallas.py:129"),
    "ln_fused": ("cuda", "whisper_rs_tpu_torch/csrc/layer_norm.cu",
                 "whisper_rs_tpu/ops/encoder_fused.py:99"),
    "residual_ln": ("cuda", "whisper_rs_tpu_torch/csrc/layer_norm.cu",
                    "whisper_rs_tpu/ops/encoder_fused.py:70"),
    "encoder_attention_merged": ("cuda", "whisper_rs_tpu_torch/csrc/encoder_attention.cu",
                                 "whisper_rs_tpu/ops/encoder_attention_pallas.py:139"),
    "cross_attention_step": ("cuda", "whisper_rs_tpu_torch/csrc/cross_attention.cu",
                             "whisper_rs_tpu/ops/decode_attention.py:748"),
    "self_attention_append_step": ("cuda", "whisper_rs_tpu_torch/csrc/self_attention.cu",
                                   "whisper_rs_tpu/ops/decode_attention.py:525"),
    "beam_self_attention_step": ("cuda", "whisper_rs_tpu_torch/csrc/self_attention.cu",
                                 "whisper_rs_tpu/ops/decode_attention.py:924"),
    "decoder_mlp_step": ("cuda", "whisper_rs_tpu_torch/csrc/decoder_mlp.cu",
                         "whisper_rs_tpu/ops/decoder_mlp_fused.py:121"),
    "self_attention_fused_step": ("cuda", "whisper_rs_tpu_torch/csrc/self_attention.cu",
                                  "whisper_rs_tpu/ops/decode_attention.py:285"),
    "decoder_step_fused": ("cuda", "whisper_rs_tpu_torch/csrc/decoder_layer.cu",
                           "whisper_rs_tpu/ops/decoder_layer_fused.py:499"),
    "self_attention_step": ("cuda", "whisper_rs_tpu_torch/csrc/self_attention.cu",
                            "whisper_rs_tpu/ops/decode_attention.py:166"),
    "encoder_attention_split": ("cuda", "whisper_rs_tpu_torch/csrc/encoder_attention.cu",
                                "whisper_rs_tpu/ops/encoder_attention_pallas.py:196"),
}


def print_ptxas() -> None:
    """ptxas's registers and spills of every kernel, from the build: each
    instance of the redesigned kernels (row 12, bf16 and its f32 parity
    instance; rows 7, 9, 10 and 11, the window body; rows 2 and 3, the
    warp variant at each vector count a lane and the block variant), a
    summary line for each source."""
    for source in SOURCES:
        report = ptxas_report(source)
        if not report:
            print(f"[build] ptxas {source}: no report", flush=True)
            continue
        spills = [r for r in report if r[2] or r[3]]
        print(f"[build] ptxas {source}: {len(report)} kernels, registers "
              f"{min(r[1] for r in report)}-{max(r[1] for r in report)}, "
              f"{len(spills)} with spills", flush=True)
        for kernel, regs, stores, loads, stack in report:
            if source in ("decoder_layer", "self_attention", "layer_norm"):
                print(f"  {kernel[-64:]}: {regs} registers, spill stores {stores} B, spill "
                      f"loads {loads} B, stack {stack} B", flush=True)


def print_sass_mma(source: str = "decoder_layer") -> None:
    """The tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) of each
    kernel of ``source``'s built library, from ``cuobjdump -sass`` beside
    nvcc (not measured where it is missing)."""
    import re

    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print(f"[build] sass {source}: cuobjdump not found, not measured", flush=True)
        return
    sass = subprocess.run([str(tool), "-sass", str(library_path(source))], capture_output=True,
                          text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = [0, 0]
        elif kernel and "HGMMA" in line:
            counts[kernel][1] += 1
        elif kernel and "HMMA" in line:
            counts[kernel][0] += 1
    for kernel, (hmma, hgmma) in counts.items():
        print(f"[build] sass {source} {kernel[-64:]}: HMMA {hmma}, HGMMA {hgmma}", flush=True)


def int8_label(m: str, b: int, beam: int) -> str:
    return f"{m} b{b} " + (f"beam{beam} int8 KV" if beam else "int8")


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
    print_ptxas()
    print_sass_mma()

    def phase_done(phase: str, t0: float) -> None:
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rng_row = check_rng()
    phase_done("rng", t0)

    def label(m: str, b: int, beam: int) -> str:
        return f"{m} b{b}" + (f" beam{beam}" if beam else "")

    rows, launches = {}, {}
    routes_model, routes_batch = ROUTES_PATH
    routes_label = f"{routes_model} b{routes_batch} greedy"
    layer_label, ctx_label = (f"{routes_label} prompted, {r}" for r in ("layer", "ctx"))
    for m, b, beam in PATHS:
        t0 = time.perf_counter()
        dtypes = (torch.float32, torch.bfloat16) if m == "base.en" else (torch.bfloat16,)
        rows[label(m, b, beam)] = kernel_checks(dims_for(m), b, dtypes, group=max(beam, 1))
        phase_done(f"kernels {label(m, b, beam)}", t0)
    t0 = time.perf_counter()
    checked = kernel_checks_routes(dims_for(routes_model), routes_batch)
    rows[layer_label] = {name: checked[name] if name == "decoder_step_fused" else {}
                         for name in KERNELS}
    rows[ctx_label] = {name: {} if name == "decoder_step_fused" else checked[name]
                       for name in KERNELS}
    phase_done(f"kernels {routes_label} routes", t0)
    t0 = time.perf_counter()
    kernel_checks_int8(rows)
    # on the int8 paths the encoder's kernels (and the beam path's MLP
    # kernel) run at the shapes of the bf16 path of the same model and
    # batch, whose checks stand for both
    for m, b, beam, int8_weights in INT8_PATHS:
        same = ("log_mel", "ln_fused", "residual_ln", "encoder_attention_merged")
        same += () if int8_weights else ("decoder_mlp_step",)
        rows[int8_label(m, b, beam)].update({k: rows[label(m, b, beam)][k] for k in same})
    phase_done("kernels int8", t0)
    t0 = time.perf_counter()
    kernel_checks_transcribe(rows)
    phase_done("kernels transcription", t0)
    t0 = time.perf_counter()
    kernel_checks_mlp_tiles(rows)
    phase_done("kernels MLP batch tiles", t0)
    t0 = time.perf_counter()
    kernel_checks_g10(rows)
    phase_done("kernels cross attention at G 10", t0)
    t0 = time.perf_counter()
    kernel_checks_recipe(rows)
    phase_done("kernels recipe and CLI shapes", t0)
    t0 = time.perf_counter()
    kernel_checks_serve(rows)
    phase_done("kernels serving shapes", t0)
    t0 = time.perf_counter()
    kernel_checks_ln_steps(rows)
    phase_done("kernels LayerNorm step rows", t0)
    t0 = time.perf_counter()
    kernel_checks_parallel(rows)
    phase_done("kernels parallel shapes", t0)

    for m, _, beam in PATHS + ((routes_model, 0, None),):
        t0 = time.perf_counter()
        dims, text = dims_for(m), f"{m} full width"
        if m in PARITY_DEPTH:
            n = PARITY_DEPTH[m]
            dims = dataclasses.replace(dims, n_audio_layer=n, n_text_layer=n)
            text += f", depth cut to {n} + {n} layers (dataclasses.replace: {dims})"
        if beam is None:
            parity_routes(dims, text)
        elif beam:
            parity_beam(dims, text, beam)
        else:
            parity(dims, text)
        phase_done(f"parity {m}" + (" greedy routes" if beam is None else ""), t0)
    for m, b, beam, _ in INT8_PATHS:
        t0 = time.perf_counter()
        dims, text = dims_for(m), f"{m} full width"
        if m in PARITY_DEPTH:
            n = PARITY_DEPTH[m]
            dims = dataclasses.replace(dims, n_audio_layer=n, n_text_layer=n)
            text += f", depth cut to {n} + {n} layers"
        if beam:
            parity_beam(dims, text, beam, int8_kv=True)
        else:
            parity_routes(dims, text, routes=("append",), int8=True)
        phase_done(f"parity {int8_label(m, b, beam)}", t0)
    t0 = time.perf_counter()
    launches[GOLDEN_LABEL], launches[GOLDEN_BEAM_LABEL] = transcribe_golden_dims()
    phase_done("transcribe golden dims", t0)
    for m, b, beam in PATHS:
        t0 = time.perf_counter()
        launches[label(m, b, beam)] = e2e(dims_for(m), m, b, beam)
        phase_done(f"e2e {label(m, b, beam)}", t0)
    t0 = time.perf_counter()
    by_route = e2e_routes(dims_for(routes_model), routes_model, routes_batch)
    launches[layer_label], launches[ctx_label] = by_route["layer"], by_route["ctx"]
    phase_done(f"e2e {routes_label} routes", t0)
    int8_summary = {}
    for m, b, beam, int8_weights in INT8_PATHS:
        t0 = time.perf_counter()
        launches[int8_label(m, b, beam)] = e2e(
            dims_for(m), m, b, beam, int8_weights=int8_weights, int8_kv=True,
            summary=int8_summary if (m, b, beam) == INT8_PATHS[0][:3] else None)
        phase_done(f"e2e {int8_label(m, b, beam)}", t0)
    t0 = time.perf_counter()
    launches[TRANSCRIBE_LABEL] = transcribe_main_path()
    phase_done(f"transcribe {TRANSCRIBE_LABEL}", t0)
    t0 = time.perf_counter()
    launches[RECIPE_LABEL] = transcribe_recipe(rng_row)
    phase_done("transcribe recipe", t0)
    t0 = time.perf_counter()
    launches[CLI_LABEL] = cli_phase()
    phase_done("cli", t0)
    t0 = time.perf_counter()
    launches[SERVE_LABEL] = serve_phase()
    phase_done("serve", t0)
    t0 = time.perf_counter()
    launches[INT8_MM_LABEL] = int8_matmul_phase(rows, int8_summary)
    phase_done("int8 matmul", t0)
    t0 = time.perf_counter()
    eval_phase()
    phase_done("eval", t0)
    t0 = time.perf_counter()
    par = parallel_phase()
    launches.update({PAR_TP_LABEL: par["tp"], PAR_ULYSSES_LABEL: par["ulysses"],
                     PAR_SERVE_LABEL: par["serve"]})
    phase_done("parallel", t0)

    # each kernel's headline numbers come from the path of the slice that
    # runs it: the whole-step kernel's from the layer route, the fused
    # self-attention's from the ctx route; the append kernel's from
    # large-v3; row 10's from the base.en int8 path; row 6's from the
    # golden-dims transcription; every other kernel's from the beam path.
    # Configs without launches were checked in the kernels phase alone (row
    # 10 at large-v3, and over a bf16 cache; row 6 at two more shapes; the
    # head-dim-16 instances that neither golden-dims path runs).
    headline = {"decoder_step_fused": layer_label, "self_attention_fused_step": ctx_label,
                "self_attention_append_step": label(*PATHS[1]),
                "self_attention_step": int8_label(*INT8_PATHS[0][:3]),
                "encoder_attention_split": GOLDEN_LABEL}
    configs = ([label(*path) for path in PATHS] + [layer_label, ctx_label]
               + [int8_label(*path[:3]) for path in INT8_PATHS]
               + [c for c in rows if c.endswith("bf16 cache") or c == "large-v3 b12 int8"]
               + list(SPLIT_SHAPES) + [GOLDEN_BEAM_LABEL, *GOLDEN_OFF_LABELS, TRANSCRIBE_LABEL,
                                       MLP_TILES_LABEL, G10_LABEL, RECIPE_LABEL, CLI_LABEL,
                                       SERVE_LABEL, INT8_MM_LABEL, PAR_TP_LABEL,
                                       PAR_ULYSSES_LABEL, PAR_SERVE_LABEL, PAR_TP4_LABEL])
    extra_keys = ("layered_step_ms", "layer_route_forward_ms", "phase_us", "phase_bound_us",
                  "phase_gbps", "library_call", "read_only_ms", "column_write_ms",
                  "cold_ms", "library_cold_ms", "bit_identical", "plan", "one_window",
                  "direct_dft_bound_ms", "step", "prefill")
    line = []
    for name, (route, source, replaces) in KERNELS.items():
        by_config = {}
        for config in configs:
            checked = rows[config][name]
            if not checked:
                continue
            r = checked.get("bf16", checked.get("f32"))
            by_config[config] = {
                "dtype": "bf16" if "bf16" in checked else "f32",
                "launches": launches.get(config, {}).get(name),
                **{k: r[k] for k in ("max_abs_err", "atol", "rtol", "tol_share", "ms",
                                     "plain_ms", "bound_ms", "bound_by", "library_ms")},
                **{k: r[k] for k in extra_keys if k in r},
                "f32": {k: v for k, v in checked.get("f32", {}).items()
                        if k in ("max_abs_err", "tol_share", "ms", "plain_ms", "bound_ms",
                                 "library_ms") + extra_keys},
            }
        main_config = headline.get(name, label(*PATHS[-1]))
        main = by_config[main_config]
        line.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "config": main_config,
            **{k: main[k] for k in ("launches", "max_abs_err", "atol", "rtol", "tol_share",
                                    "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms") + extra_keys if k in main},
            "by_config": by_config,
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print("[graphs] summary " + json.dumps(LOOPS), flush=True)
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
