"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

``run_cell`` does everything after the look for a chip (``run.py``), so a
test can drive a whole run on the CPU at a tiny size.  Its phases:

  1. set-up (``setup_s``, from the process's start): the port imported,
     its kernels built (``build_all``; the first run in a checkout
     compiles), the weights drawn on the device from the seed and loaded,
     the inputs generated, and the cell's own shapes warmed: a batch cell
     runs one call of its traffic (which captures its window's CUDA
     graphs), a serving cell runs ``ServingEngine.warmup()`` and a warm
     round of requests;
  2. the window: whole calls (batch) until ``seconds`` have passed, or the
     requests due within ``seconds`` (serve), each timed from when it was
     due until its handle resolved;
  3. ``memory_peak_bytes`` read, the program's state freed;
  4. the reference (``reference/whisper_f32.py``) over a sample of what the
     window served, drawn from the seed, with the longest in it; the
     numbers of ``COMPARED`` against the cell's limits
     (``limits/<cell>.json``), no request failed, and (batch cells) every
     call that repeats a pool batch returned what its first call did.

With ``trace`` the window also runs the readers' instrumentation (CUDA
events in hooks on the encoder and around each call, the steps each decode
reports, the profiler over a bounded part) and the result carries the
per-layer metrics, ``busy_s``/``window_s`` and the breakdown.

``control`` runs the program's own int8 path in its place (int8 weights,
``quantize_params``; the int8×int8 matmuls, ``WHISPER_INT8_MATMUL=1``;
int8 K/V): the run that the check has to refuse.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import gen, spec, trace as trace_mod, weights
from ..reference import tokens as ref_tokens, whisper_f32 as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_rs_tpu")
# the numbers the check can compare; a cell compares those its limits/<cell>.json names
COMPARED = ("rms_avg_logprob_gap", "rms_no_speech_gap", "block0_rel_err", "encoder_rel_err",
            "max_gap_logit", "mean_gap_logit")
REPLAY_TOL = 1e-5  # a repeated call's score and log no-speech probability against its first's
TRACE_SPAN = "gpubench.window"  # host annotation around each traced part


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name (the part before
    the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Call:
    """One call of a batch cell."""
    batch: int  # index into the pool
    seconds: float  # host clock, the call's start to its return
    outputs: List[np.ndarray]  # each audio's served tokens
    avg_logprobs: List[float]  # each audio's chosen candidate's score over its length + 1
    no_speech: List[float]  # each audio's no-speech probability
    steps: Optional[int] = None  # traced runs: the decode's own count
    encoder_ms: Optional[float] = None  # traced runs: CUDA events in the encoder's hooks
    call_ms: Optional[float] = None  # traced runs: CUDA events around the call


@dataclasses.dataclass
class Request:
    """One request of a serving cell (host monotonic clock)."""
    index: int
    due: float
    submitted: float = float("nan")  # when the generator called submit
    started: Optional[float] = None
    finished: Optional[float] = None
    tokens: Optional[np.ndarray] = None  # its first window's tokens, as the decode made them
    avg_logprob: Optional[float] = None
    no_speech: Optional[float] = None
    request_id: Optional[int] = None  # the engine's id of its handle
    unlike_its_window: bool = False  # what it returned is not what its first window kept
    error: Optional[str] = None

    @property
    def latency(self) -> float:
        if self.error is not None or self.finished is None:
            return float("inf")
        return self.finished - self.due


@dataclasses.dataclass
class Run:
    """What a run measured; the per-layer readers read it."""
    cell: spec.Cell
    seed: int
    seconds: float
    device: torch.device
    window_s: float = 0.0
    calls: List[Call] = dataclasses.field(default_factory=list)
    requests: List[Request] = dataclasses.field(default_factory=list)
    engine_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    unlike_their_window: int = 0  # serving cells: requests that returned other tokens
    encoder_out: Dict = dataclasses.field(default_factory=dict)  # the sampled rows' encoder
    # in the window: (pool batch, row) or a request's id -> (first block's output, output)
    wanted: Dict = dataclasses.field(default_factory=dict)  # batch: pool batch -> rows;
    # serve: request id -> True; the rows whose encoder output is kept
    trace: Optional[trace_mod.Trace] = None
    prefix_lengths: List[List[int]] = dataclasses.field(default_factory=list)  # batch cells:
    # each pool batch's real prefix length a row (the prompt and the SOT sequence)
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up's marks (s)
    t_start: float = 0.0

    def mark(self, stage: str) -> None:
        self.stages[stage] = time.perf_counter() - self.t_start


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (inf where a request failed)."""
    v = sorted(values)
    if not v:
        return float("nan")
    return float(v[max(0, min(len(v) - 1, int(np.ceil(q / 100 * len(v))) - 1))])


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class Program:
    """The port, set up for one cell: the model from the seed's weights, the
    tokenizer, and on the card its kernels built."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, control: bool,
                 run: Optional["Run"] = None):
        from whisper_rs_tpu_torch.config import ModelDims, dims_for
        from whisper_rs_tpu_torch.models.params import params_from_state_dict
        from whisper_rs_tpu_torch.models.quantize import quantize_params
        from whisper_rs_tpu_torch.tokenize import Tokenizer

        d = cell.dims
        self.dims = ModelDims(d["n_mels"], d["n_vocab"], d["n_audio_ctx"], d["n_state"],
                              d["n_head"], d["n_audio_layer"], d["n_text_ctx"], d["n_state"],
                              d["n_head"], d["n_text_layer"])
        if "port_model" in cell.config and dims_for(cell.config["port_model"]) != self.dims:
            raise ValueError(f"the port's {cell.config['port_model']} is "
                             f"{dims_for(cell.config['port_model'])}, the config {self.dims}")
        if device.type == "cuda":
            from whisper_rs_tpu_torch.ops.build import build_all

            build_all()
        if run is not None:
            run.mark("built")
        dtype = getattr(torch, cell.config["served_dtype"])
        sd = weights.draw(d, seed, dtype, device)
        self.model = params_from_state_dict(sd, self.dims, dtype=dtype, device=device)
        del sd
        if control:
            quantize_params(self.model)
        self.control = control
        self.tok = Tokenizer.for_dims(self.dims)
        if run is not None:
            run.mark("weights")
        t = cell.config["tokens"]
        tk = self.tok
        ids = {"sot": tk.token_id_sot, "eot": tk.token_id_eot, "space": tk.token_id_space,
               "ts_begin": tk.token_id_ts_begin, "no_timestamps": tk.token_id_no_timestamps,
               "no_speech": tk.token_id_no_speech, "startofprev": tk.token_id_startofprev,
               "sot_sequence": list(tk.sequence_sot())}
        if ids != t:
            raise ValueError(f"the port's token ids {ids} differ from the config's {t}")

    def options(self, traffic: dict):
        from whisper_rs_tpu_torch.config import BeamSearchMode, DecodeOptions, GreedyMode

        mode = (GreedyMode() if traffic["mode"] == "greedy"
                else BeamSearchMode(beam_size=traffic["beam"], patience=1.0))
        return DecodeOptions(sample_len=traffic["sample_len"], mode=mode,
                             timestamps=traffic["timestamps"])


@contextlib.contextmanager
def _steps_recorder(steps: List[int]):
    """Each decode's own count of steps (``DecodeResult.steps``), recorded
    around the decode functions the task calls."""
    import whisper_rs_tpu_torch.decode.task as task_mod

    saved = task_mod.decode_greedy, task_mod.decode_beam

    def wrap(fn):
        def run(*args, **kwargs):
            result = fn(*args, **kwargs)
            steps.append(int(result.steps))
            return result
        return run

    task_mod.decode_greedy, task_mod.decode_beam = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        task_mod.decode_greedy, task_mod.decode_beam = saved


@contextlib.contextmanager
def _encoder_kept(model, kept: Dict, pending: List):
    """While open, the encoder's rows that ``pending`` names are copied
    into ``kept``, each as (the residual stream after the first block, the
    encoder's output): before a call, the driver puts [(row, key), ...]
    into ``pending``; the encoder's next forward copies each row out under
    its key and empties ``pending``, so a call's other encoder runs and the
    other calls keep nothing."""
    block = model.encoder.blocks[0]
    forward, first = block.encoder_forward, []

    def first_block(x, *args, **kwargs):
        out = forward(x, *args, **kwargs)
        first[:] = [out[row].detach().clone() for row, _ in pending]
        return out

    def keep(_m, _a, out):
        for (row, key), x1 in zip(pending, first):
            kept[key] = (x1, out[row].detach().clone())
        pending.clear()
        first.clear()

    block.encoder_forward = first_block  # the encoder calls each block's method, not the module
    hook = model.encoder.register_forward_hook(keep)
    try:
        yield
    finally:
        hook.remove()
        del block.encoder_forward


def _profiler(device: torch.device, **kwargs):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts, **kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# batch cells
# ---------------------------------------------------------------------------

TRACE_CALLS = 2  # calls the profiler records, after one call of its own warm-up


def run_batch(run: Run, program: Program, do_trace: bool, t_start: float) -> dict:
    from whisper_rs_tpu_torch.decode.task import DecodeTask
    from whisper_rs_tpu_torch.ops.mel import log_mel_frontend

    tr, dev, model = run.cell.traffic, run.device, program.model
    task = DecodeTask(model, program.tok, program.options(tr), quantize_kv=program.control)
    pool = gen.batch_pool(tr, run.seed, dev)
    sot = len(run.cell.config["tokens"]["sot_sequence"])
    cap = program.dims.n_text_ctx // 2 - 1
    run.prefix_lengths = [[sot + (1 + len(p[-cap:]) if p else 0) for p in b.prompts]
                          for b in pool]
    call_events: List[list] = []

    def call(b, timed: bool = False):
        mel = log_mel_frontend(b.audio, program.dims.n_mels, dtype=model.dtype, device=dev)
        if timed:
            ev = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
            ev[0].record()
        outs = task.run_batch(mel, b.prompts)
        if timed:
            ev[1].record()
            call_events.append(ev)
        return ([o.tokens for o in outs], [o.avg_logprob for o in outs],
                [o.no_speech_prob for o in outs])

    run.mark("inputs")
    call(pool[0])  # warm-up: this cell's shapes, its window captured
    run.mark("warm")
    _sync(dev)
    run.wanted = batch_picks(run, len(pool))
    pending: List[tuple] = []

    enc_events: list = []
    hooks = []
    steps: List[int] = []
    prof = None
    traced: List[Optional[trace_mod.Trace]] = []
    stack = contextlib.ExitStack()
    if do_trace:
        def pre(_m, _a):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            enc_events.append([ev, None])

        def post(_m, _a, _o):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            enc_events[-1][1] = ev

        if dev.type == "cuda":
            hooks = [model.encoder.register_forward_pre_hook(pre),
                     model.encoder.register_forward_hook(post)]
        stack.enter_context(_steps_recorder(steps))
        from torch.profiler import schedule

        prof = _profiler(dev, schedule=schedule(wait=0, warmup=1, active=TRACE_CALLS, repeat=1),
                         on_trace_ready=lambda p: traced.append(trace_mod.read(p, TRACE_SPAN)))
        prof.start()

    stack.enter_context(_encoder_kept(model, run.encoder_out, pending))
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    i = 0
    with stack:
        while True:
            b = i % len(pool)
            if i < len(pool):  # a pool batch's first call: keep its sampled rows' encoder output
                pending[:] = [(r, (b, r)) for r in run.wanted.get(b, ())]
            c0 = time.perf_counter()
            span = (torch.profiler.record_function(TRACE_SPAN) if do_trace and 1 <= i <= TRACE_CALLS
                    else contextlib.nullcontext())
            with span:
                outs = call(pool[b], timed=do_trace and dev.type == "cuda")
            c1 = time.perf_counter()
            run.calls.append(Call(b, c1 - c0, *outs))
            i += 1
            if prof is not None and i <= TRACE_CALLS + 1:
                prof.step()
                if i == TRACE_CALLS + 1:
                    prof.stop()
                    prof = None
            if time.perf_counter() - t0 >= run.seconds:
                break
    t1 = time.perf_counter()
    run.window_s = t1 - t0
    if prof is not None:  # a window shorter than the traced calls
        prof.stop()
    for h in hooks:
        h.remove()
    _sync(dev)
    if do_trace:
        run.trace = traced[0] if traced else None
        if dev.type == "cuda":
            per_call = len(enc_events) // max(1, len(run.calls))
            for k, c in enumerate(run.calls):
                c.call_ms = call_events[k][0].elapsed_time(call_events[k][1])
                c.encoder_ms = sum(s.elapsed_time(e) for s, e in
                                   enc_events[k * per_call:(k + 1) * per_call])
        for c, s in zip(run.calls, steps):
            c.steps = s
    task.close()
    A = tr["audios"]
    return {"setup_s": setup_s, "attempted": A * len(run.calls), "failed": 0,
            "audio_s_per_s": A * 30.0 * len(run.calls) / run.window_s}


def batch_picks(run: Run, n_pool: int) -> Dict[int, List[int]]:
    """Pool batch -> its rows that the check compares: ``windows`` - 1
    windows, spread evenly over the pool (the first batches take the
    remainder), each batch's drawn from the seed before the window opens,
    so that the encoder's output of each can be kept as the window makes
    it."""
    n, A = run.cell.traffic["check"]["windows"] - 1, run.cell.traffic["audios"]
    rng = np.random.default_rng([int(run.seed) % 2**63, 5])
    per = [min(A, n // n_pool + (b < n % n_pool)) for b in range(n_pool)]  # the first most
    return {b: sorted(int(r) for r in rng.permutation(A)[:k]) for b, k in enumerate(per) if k}


def _first_calls(run: Run) -> Dict[int, int]:
    """Pool batch -> the index of its first call in the window."""
    first: Dict[int, int] = {}
    for k, c in enumerate(run.calls):
        first.setdefault(c.batch, k)
    return first


def batch_sample(run: Run) -> List[tuple]:
    """(call index, row) of the windows the check compares: the window
    that served the most tokens, and the picks of ``batch_picks`` whose
    pool batch the window reached, each from its batch's first call (a
    pool batch's windows repeat each time it comes round; ``replays``
    holds the later calls to the first)."""
    first = _first_calls(run)
    rows = [(k, r) for k in sorted(first.values()) for r in range(len(run.calls[k].outputs))]
    longest = max(rows, key=lambda kr: len(run.calls[kr[0]].outputs[kr[1]]))
    picked = [(first[b], r) for b, rs in sorted(run.wanted.items()) if b in first for r in rs]
    return [longest] + [p for p in picked if p != longest]


def replays(run: Run) -> Dict[str, float]:
    """The calls that repeat a pool batch against that batch's first call:
    ``unlike_first_call`` counts those with a row whose tokens differ, or
    whose score or log no-speech probability lies more than ``REPLAY_TOL``
    from the first call's; ``replay_max_diff`` is the widest such
    difference."""
    first = _first_calls(run)
    unlike, widest = 0, 0.0
    for c in run.calls:
        f = run.calls[first[c.batch]]
        if f is c:
            continue
        same = True
        for r in range(len(c.outputs)):
            d = max(abs(c.avg_logprobs[r] - f.avg_logprobs[r]),
                    abs(np.log(max(c.no_speech[r], 1e-38)) - np.log(max(f.no_speech[r], 1e-38))))
            widest = max(widest, float(d))
            same &= (d <= REPLAY_TOL and np.array_equal(np.asarray(c.outputs[r]),
                                                        np.asarray(f.outputs[r])))
        unlike += not same
    return {"unlike_first_call": unlike, "replay_max_diff": widest}


# ---------------------------------------------------------------------------
# serving cells
# ---------------------------------------------------------------------------

TRACE_SLICE_S = 5.0  # a serving cell's traced part: the window's last seconds


def run_serve(run: Run, program: Program, do_trace: bool, t_start: float) -> dict:
    from whisper_rs_tpu_torch.config import TranscribeOptions
    from whisper_rs_tpu_torch.serve import ServingEngine

    tr, dev = run.cell.traffic, run.device
    opts = TranscribeOptions(decode=program.options(tr), condition_on_prev_text=False)
    engine = ServingEngine(program.model, program.tok, opts, batch_size=tr["batch_size"])
    engine.decode_task.quantize_kv = program.control
    engine.warmup()
    run.mark("engine_warmup")
    warm = [engine.submit(c) for c in gen.warm_requests(tr, run.seed, dev)]
    for h in warm:
        h.result(timeout=600)
    run.mark("warm_round")
    reqs = gen.serve_requests(tr, run.seed, run.seconds, dev)
    run.requests = [Request(k, 0.0) for k in range(len(reqs.due_s))]
    decoded = _record_windows(engine.decode_task)
    run.wanted = serve_picks(run, max(h.request_id for h in warm))
    pending: List[tuple] = []
    _keep_first_windows(engine, run.wanted, pending)
    handles: List = [None] * len(run.requests)
    before = engine.stats()
    nxt = [0]
    lock = threading.Lock()
    errors: List[BaseException] = []

    def submitter(t0: float):
        try:
            while True:
                with lock:
                    k = nxt[0]
                    nxt[0] += 1
                if k >= len(run.requests):
                    return
                r = run.requests[k]
                r.due = t0 + float(reqs.due_s[k])
                wait = r.due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                r.submitted = time.monotonic()
                try:
                    handles[k] = engine.submit(reqs.clips[k])
                    r.request_id = handles[k].request_id
                except RuntimeError as e:  # refused (queue full, closed)
                    r.error = f"refused: {e}"
        except BaseException as e:  # noqa: BLE001 - reported below, the run fails
            errors.append(e)
            raise

    kept = _encoder_kept(program.model, run.encoder_out, pending)
    kept.__enter__()
    setup_s = time.perf_counter() - t_start
    t0 = time.monotonic() + 0.05
    threads = [threading.Thread(target=submitter, args=(t0,), daemon=True)
               for _ in range(tr["submitters"])]
    for t in threads:
        t.start()
    prof = None
    if do_trace:  # the window's last slice; the trace is read once every request resolved
        slice_s = min(TRACE_SLICE_S, run.seconds / 3)
        time.sleep(max(0.0, t0 + run.seconds - slice_s - 0.2 - time.monotonic()))
        prof = _profiler(dev)
        prof.start()
        time.sleep(0.2)
        with torch.profiler.record_function(TRACE_SPAN):
            time.sleep(slice_s)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    deadline = t0 + run.seconds + 60.0
    for r, h in zip(run.requests, handles):
        if h is None:
            continue
        try:
            out = h.result(timeout=max(0.0, deadline - time.monotonic()))
            r.avg_logprob, r.no_speech = out.avg_logprobs[0], out.no_speech_probs[0]
            r.tokens = decoded.get((r.avg_logprob, r.no_speech))
            r.unlike_its_window = r.tokens is None or not _returns_its_window(
                np.asarray(out.tokens), r.tokens, run.cell.config["tokens"]["ts_begin"])
        except TimeoutError:
            r.error = "not finished a minute after the window closed"
            continue
        except Exception as e:  # noqa: BLE001 - the request's own failure
            r.error = f"{type(e).__name__}: {e}"
        r.started, r.finished = h.started_at, h.finished_at
    if prof is not None:
        prof.stop()
        run.trace = trace_mod.read(prof, TRACE_SPAN)
        del prof
    run.window_s = max((r.finished for r in run.requests if r.finished is not None),
                       default=t0) - t0
    after = engine.stats()
    run.engine_counts = {
        "windows_decoded": after["windows_decoded"] - before["windows_decoded"],
        "rows": (after["window_batches"] - before["window_batches"]) * tr["batch_size"]}
    run.unlike_their_window = sum(r.unlike_its_window for r in run.requests)
    engine.close()
    kept.__exit__(None, None, None)
    lat = [r.latency for r in run.requests]
    late = [r.submitted - r.due for r in run.requests if np.isfinite(r.submitted)]
    failed = sum(r.error is not None for r in run.requests)
    return {"setup_s": setup_s, "attempted": len(run.requests), "failed": failed,
            "request_p50_s": percentile(lat, 50), "request_p95_s": percentile(lat, 95),
            "generator_late_p95_s": percentile(late, 95),
            "generator_late_max_s": max(late, default=float("nan"))}


def serve_picks(run: Run, last_warm_id: int) -> Dict[int, bool]:
    """The engine's request ids that the check compares, ``requests`` - 1
    of the window's drawn from the seed before it opens: the engine gives
    the window's requests the ids after the warm round's last, one each in
    the order they are submitted."""
    n, m = len(run.requests), run.cell.traffic["check"]["requests"] - 1
    rng = np.random.default_rng([int(run.seed) % 2**63, 5])
    return {last_warm_id + 1 + int(i): True for i in rng.choice(n, size=min(m, n), replace=False)}


def _keep_first_windows(engine, wanted: Dict[int, bool], pending: List[tuple]) -> None:
    """Each round of ``engine`` from now on names, in ``pending``, the rows
    of its call that decode the first window of a request in ``wanted``
    (``_encoder_kept`` keeps their encoder output under the request's id).
    A round whose rows are all on the primary task makes one call, its rows
    in the order of the round's jobs; any other round keeps nothing."""
    decode_round = engine._decode_round

    def recorded(jobs):
        if all(job.temp_idx == 0 for _, job in jobs):
            pending[:] = [(i, job.handle.request_id) for i, (_, job) in enumerate(jobs)
                          if job.seek == 0 and job.handle.request_id in wanted]
        try:
            decode_round(jobs)
        finally:
            pending.clear()

    engine._decode_round = recorded


def _record_windows(task) -> Dict[tuple, np.ndarray]:
    """Each window the serving engine's decode task decodes from now on:
    (its average log-probability, its no-speech probability) -> its tokens,
    recorded around ``run_batch`` of that task alone.  A request's first
    window is found by the two numbers its result carries."""
    decoded: Dict[tuple, np.ndarray] = {}
    run_batch = task.run_batch

    def recorded(*args, **kwargs):
        outs = run_batch(*args, **kwargs)
        for o in outs:
            decoded[(o.avg_logprob, o.no_speech_prob)] = np.asarray(o.tokens)
        return outs

    task.run_batch = recorded
    return decoded


def _returns_its_window(returned: np.ndarray, window: np.ndarray, ts_begin: int) -> bool:
    """Whether a request's returned tokens begin with what the transcription
    keeps of its first window: all of it, or, where two timestamps stand in
    a row (random weights emit timestamp tokens, which no filter bans
    without timestamps), the tokens up to the last such pair; the rest of
    the clip is then decoded again in a second window."""
    is_ts = window >= ts_begin
    pairs = np.nonzero(is_ts[:-1] & is_ts[1:])[0] + 1
    kept = window[: pairs[-1] + 1] if pairs.size else window
    return len(returned) >= len(kept) and bool(np.array_equal(returned[: len(kept)], kept))


def serve_sample(run: Run) -> List[int]:
    """Request indices the check compares: those of ``serve_picks`` that
    were served, and the one whose first window served the most tokens.
    Each is judged by its first window as the decode made it (a clip of at
    most 30 s is whole in it), whose score and no-speech
    probability the result carries; that the request returned what the
    transcription keeps of it is checked for every request
    (``_returns_its_window``)."""
    served = [r.index for r in run.requests if r.tokens is not None]
    if not served:
        return []
    longest = max(served, key=lambda k: (len(run.requests[k].tokens), k))
    picked = [k for k in served if run.requests[k].request_id in run.wanted]
    return [longest] + [p for p in picked if p != longest]


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def reference_gaps(run: Run, items: List[tuple]) -> Dict[str, float]:
    """The f32 reference over ``items``, each (label, audio [n] f32, prompt
    or None, served tokens, k, the program's average log-probability of
    them, its no-speech probability, (its first encoder block's output, its
    encoder output) in the window or None).  Returns

      * ``rms_avg_logprob_gap``: over the items, the root-mean-square
        difference of the average log-probability of the served tokens
        (their score, with their EOT where the decode chose one, over their
        count + 1) from the reference's;
      * ``rms_no_speech_gap``: that of the log of each window's no-speech
        probability (the SOT position's softmax: one logit, no selection);
      * ``encoder_rel_err``: over the items with an encoder output, the L2
        norm of its difference from the reference's audio features (the
        reference's own mel and encoder) over the L2 norm of the latter;
      * ``block0_rel_err``: the same of the residual stream after the
        encoder's first block, where bf16's own rounding has not yet
        built up over the layers;
      * ``max_gap_logit``: the widest gap of a served token's filtered logit
        below the reference's k-th best (k 1 for greedy tokens, beam + 1
        for a beam's): a token the decode should not have chosen;
      * ``mean_gap_logit``: the mean gap of a served token's filtered logit
        below the reference's best: a decode that keeps worse tokens than it
        should, as a beam that keeps the wrong candidates;
      * ``tokens_compared``, ``encoder_rows_compared``.

    Weights are drawn again from the seed; nothing of the program is read."""
    cfg, tr, dev = run.cell.config, run.cell.traffic, run.device
    d = run.cell.dims
    t = cfg["tokens"]
    suppress = ref_tokens.non_speech_ids(str(spec.ROOT / cfg["tokenizer_json"]))
    max_init = round(1.0 / (30.0 / d["n_audio_ctx"])) if tr["timestamps"] else None
    gaps_k, gaps_1, score_gaps, ns_gaps, labels = [], [], [], [], []
    enc_err2, enc_ref2, enc_rows = [0.0, 0.0], [0.0, 0.0], 0
    with ref.f32_exact(), torch.no_grad():
        W = {k: v.float() for k, v in weights.draw(
            d, run.seed, getattr(torch, cfg["served_dtype"]), dev).items()}
        for label, audio, prompt, served, k, avg_logprob, no_speech, enc in items:
            served = [int(x) for x in served]
            mel = ref.window_mel(audio.to(dev), d["n_mels"])
            x1, xa = ref.encoder_states(mel, W, d["n_head"], d["n_audio_layer"])
            if enc is not None:
                for i, (mine, theirs) in enumerate(zip(enc, (x1, xa))):
                    enc_err2[i] += float((mine.to(dev).float() - theirs).square().sum())
                    enc_ref2[i] += float(theirs.square().sum())
                enc_rows += 1
            prefix = list(t["sot_sequence"])
            if prompt:
                prefix = [t["startofprev"]] + list(prompt)[-(d["n_text_ctx"] // 2 - 1):] + prefix
            seq = torch.tensor(prefix + served, dtype=torch.long, device=dev)
            logits = ref.decoder_logits(seq, xa, W, d["n_head"], d["n_text_layer"])
            sot_row = len(prefix) - len(t["sot_sequence"])
            ns = torch.log_softmax(logits[sot_row], dim=-1)[t["no_speech"]]
            ns_gaps.append(abs(float(ns) - float(np.log(max(no_speech, 1e-38)))))
            labels.append(f"{label} tokens {len(served)}")
            filtered = ref.filtered_logits(logits[len(prefix) - 1:], served + [t["eot"]], t,
                                           suppress, tr["timestamps"], max_init)
            if served:
                gaps_k.append(ref.token_gaps(filtered[:-1], served, k))
                gaps_1.append(ref.token_gaps(filtered[:-1], served, 1))
            logprobs = torch.log_softmax(filtered, dim=-1)
            chosen = served + ([t["eot"]] if len(served) < tr["sample_len"] else [])
            score = float(logprobs[torch.arange(len(chosen)), torch.tensor(chosen)].sum())
            score_gaps.append(abs(score / (len(served) + 1) - avg_logprob))
        del W
    gk = torch.cat(gaps_k) if gaps_k else torch.zeros(0)
    g1 = torch.cat(gaps_1) if gaps_1 else torch.zeros(0)
    for i in sorted(range(len(labels)), key=lambda i: -score_gaps[i])[:3]:
        print(f"worst items: {labels[i]}: avg log-prob gap {score_gaps[i]:.5f}, no-speech "
              f"log gap {ns_gaps[i]:.5f}", file=sys.stderr)
    rms = lambda v: float(np.sqrt(np.mean(np.square(v)))) if v else 0.0  # noqa: E731
    nan = float("nan")
    return {"rms_avg_logprob_gap": rms(score_gaps), "rms_no_speech_gap": rms(ns_gaps),
            "block0_rel_err": float(np.sqrt(enc_err2[0] / enc_ref2[0])) if enc_rows else nan,
            "encoder_rel_err": float(np.sqrt(enc_err2[1] / enc_ref2[1])) if enc_rows else nan,
            "max_gap_logit": float(gk.max()) if len(gk) else 0.0,
            "mean_gap_logit": float(g1.mean()) if len(g1) else 0.0,
            "tokens_compared": int(len(gk)), "encoder_rows_compared": enc_rows}


def check(run: Run) -> Dict[str, float]:
    tr = run.cell.traffic
    k = tr["check"]["top_k"]
    if tr["driver"] == "batch":
        pool = gen.batch_pool(tr, run.seed, run.device)
        items = [(f"call {c} row {r}", pool[run.calls[c].batch].audio[r],
                  pool[run.calls[c].batch].prompts[r],
                  run.calls[c].outputs[r], k, run.calls[c].avg_logprobs[r],
                  run.calls[c].no_speech[r], run.encoder_out.get((run.calls[c].batch, r)))
                 for c, r in batch_sample(run)]
        numbers = reference_gaps(run, items)
        numbers.update(replays(run))
        return numbers
    reqs = gen.serve_requests(tr, run.seed, run.seconds, run.device)
    t0 = min(r.due for r in run.requests)
    items = [(f"request {i} due {run.requests[i].due - t0:.3f} s latency "
              f"{run.requests[i].latency:.3f} s samples {len(reqs.clips[i])}", reqs.clips[i],
              None, run.requests[i].tokens, k, run.requests[i].avg_logprob,
              run.requests[i].no_speech, run.encoder_out.get(run.requests[i].request_id))
             for i in serve_sample(run)]
    return reference_gaps(run, items)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

DRIVERS: Dict[str, Callable] = {"batch": run_batch, "serve": run_serve}


def _power_limit_w() -> Optional[float]:
    """The card's power limit (W), which the peaks of ``lib/peaks.py``
    assume at 700; None where ``nvidia-smi`` cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": _power_limit_w()}


def run_cell(cell: spec.Cell, seed: int, seconds: float, do_trace: bool, device,
             t_start: float, control: bool = False, limits: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (``metrics`` the cell's
    end-to-end metrics, or with ``do_trace`` its per-layer metrics)."""
    device = torch.device(device)
    run = Run(cell, seed, seconds, device, t_start=t_start)
    run.mark("imported")
    saved = os.environ.get("WHISPER_INT8_MATMUL")
    os.environ["WHISPER_INT8_MATMUL"] = "1" if control else "0"
    try:
        program = Program(cell, seed, device, control, run)
        measured = DRIVERS[cell.traffic["driver"]](run, program, do_trace, t_start)
    finally:
        if saved is None:
            os.environ.pop("WHISPER_INT8_MATMUL", None)
        else:
            os.environ["WHISPER_INT8_MATMUL"] = saved
    dev = device_info(device)
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, dict] = {}
    if do_trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s()
            dev["window_s"] = run.trace.window_s
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": units[m["name"]]}

    numbers = check(run)
    run.encoder_out.clear()
    limits = cell.limits if limits is None else limits
    compared = [name for name in COMPARED if name in limits]  # the cell's limits name them
    for name in COMPARED:
        if name not in limits:
            print(f"also read (no limit): {name} {numbers[name]}", file=sys.stderr)
    checked = {name: {"value": numbers[name], "limit": limits[name]} for name in compared}
    checked["tokens_compared"] = {"value": numbers["tokens_compared"], "limit": "at least 1"}
    checked["encoder_rows_compared"] = {"value": numbers["encoder_rows_compared"],
                                        "limit": "at least 1"}
    checked["failed"] = {"value": measured["failed"], "limit": 0}
    if run.requests:
        checked["unlike_their_window"] = {"value": run.unlike_their_window, "limit": 0}
    else:
        checked["unlike_first_call"] = {"value": numbers["unlike_first_call"], "limit": 0}
        print(f"also read (no limit): replay_max_diff {numbers['replay_max_diff']}",
              file=sys.stderr)
    correct = (bool(compared) and all(checked[n]["value"] <= checked[n]["limit"] for n in compared)
               and numbers["tokens_compared"] >= 1 and numbers["encoder_rows_compared"] >= 1
               and measured["failed"] == 0 and run.unlike_their_window == 0
               and numbers.get("unlike_first_call", 0) == 0)
    result = {"correct": bool(correct), "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics, "device": dev}
    if do_trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    extra = {k: v for k, v in measured.items()
             if k.startswith("generator_")}
    if extra:
        result["serving"] = extra
    result["stages"] = run.stages
    result["checked"] = checked
    return result
