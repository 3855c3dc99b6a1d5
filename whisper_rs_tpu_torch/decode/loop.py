"""Single-window decode (counterpart of ``whisper_rs_tpu/decode/loop.py``):
encoder, cross K/V precompute, prompt prefill, then incremental decoder
steps with the logit filters, in phases of growing attention window.  Two
token extractors:

  * greedy (``decode_greedy``): argmax at temperature 0, else a draw from
    ``softmax(logits / T)`` with JAX's threefry noise (``decode/rng.py``),
    and EOT bookkeeping; a phase ends when every row has finished;
  * beam search (``decode_beam``): per-beam top-(beam+1) candidates ranked
    per audio, EOT candidates into a capacity-capped finished buffer in
    score order, and the cache read through an ancestor table (gather at
    read: the cache never moves); a phase ends when every audio has filled
    its finished buffer.

The window runs on the device, as the JAX loop runs each phase as a
``lax.while_loop`` under one jit.  Its state lives in static buffers
(``DecodeWindow``: the cache, the cross K/V, tokens, the carried scores
and flags, ``pos`` and ``step`` as 0-d tensors), and one step body updates
them in place.  The body computes the JAX loop's ``cond`` on the device,
``live = (step < sample_len) & (pos < W) & ~done``, and gates every write
by it: a step taken after ``live`` turned false writes the slot -1 (no
cache column, ``ops.decode_attention.write_column``) and leaves every
buffer bit-equal, so however many steps run past the end, the result is
the JAX loop's.  Nothing on the step reads a device value on the host.

The host runs the body ``CHECK_EVERY`` (k) times between reads of the
termination test, never more steps than the phase can hold: one read (a
host sync) every ``k`` steps, at most ``ceil(steps / k)`` plus one a phase
and one more.  On the card each phase's body is captured once as a CUDA
graph (``torch.cuda.CUDAGraph``, one memory pool a window) and replayed;
on the CPU, and on the card with ``graphs=False``, the same body runs
eagerly (the reference the card's captured loop is held to, bit for bit).
A capture that fails raises: there is no fallback.  A capture guards only
its own thread (``capture_error_mode="thread_local"``), so a serving
client's thread may run its mel on the card while the engine's thread
captures.  Two cases run the eager loop on the card, decided from the
configuration at every call (``eager_reason``), never by catching an
error: a model whose step runs collectives through gloo
(``parallel/collectives.py``'s ``"stage"`` route: through host memory,
which a graph cannot hold), and ``utils.debug.enable_nan_checks`` (its
hooks read every output on the host), also on a window captured before
the checks were turned on.  NCCL collectives are captured.

Launch counts (``ops.LAUNCHES``) stay the kernels' launches: a capture
records what its body's wrappers count and takes it back out (a capture
launches nothing), each replay adds it; the eager warm-up body before a
capture (a step with ``live`` false, run so that libraries load outside
the capture) and the no-op steps past the end launch their kernels and are
counted as they are.  ``DecodeResult.bodies`` says how many bodies ran.

Ties among equal scores are broken as JAX's ``lax.top_k`` and stable
``argsort`` break them: the lower index first.  ``torch.topk`` promises no
order for ties on the card, so every ranking here is a stable sort.

A sampled draw is batch-composition invariant, as in the JAX loop: row r
of step s draws with the key ``fold_in(fold_in(rng_key, s), r % group)``,
where s counts from the first sampled position (not the absolute position,
which moves with the prompt bucket), so an audio draws the same noise
alone or inside a batch.  Every key of a decode is made once before the
step loop (``rng.row_keys``) into the window's key buffer, which the step
indexes by the device ``pos``; the temperature divisor is a device scalar
written at each call, never baked into a graph (JAX traces it).

Data parallelism: on a model with a mesh of more than one data rank
(``parallel.sharding.shard_model``), ``decode_greedy`` and ``decode_beam``
split the batch by audio into one contiguous block a data rank (padded
with repeats of the last audio to a multiple of the ranks, as the JAX
driver pads), decode the rank's block, and gather every block's outputs
over the data group, so every rank returns the whole batch.  An audio's
beams or sampled rows stay on one rank; a row's noise depends on its index
modulo the group only, so the draws are the single process's.
``encoder_fn(model, mel, kernels)`` replaces the encoder (the pipeline
and Ulysses encoders of ``parallel``), as the JAX loop's ``encoder_fn``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Optional

import torch

from .. import ops
from ..config import BeamSearchMode, GreedyMode
from ..models.whisper import CrossKV, KVCache, Whisper, encoder_forward, precompute_cross_kv
from ..ops.decode_attention import step_pos
from ..ops.decoder_layer_fused import decoder_step_weights
from ..parallel.collectives import all_gather_data
from ..parallel.sharding import shard_batch
from ..utils.debug import nan_checks_enabled
from . import rng
from .filters import FilterConfig, apply_filters, log_softmax
from .prompt import PREFILL_BUCKETS

BIG_NEG = -1e9  # finite stand-in for -inf in scores
# Steps run between two reads of the termination test (k), captured or
# eager: chosen on the H100 (chip_study.py loop, PERF.md).
CHECK_EVERY = 8


@dataclasses.dataclass
class DecodeResult:
    """Outputs of one window decode (per audio), and how its loop ran."""

    candidates: torch.Tensor  # [n_audio, n_cand, n_ctx] int64, EOT-terminated
    scores: torch.Tensor  # [n_audio, n_cand] f32 cumulative logprob
    no_speech_probs: torch.Tensor  # [n_audio] f32
    audio_features: torch.Tensor  # [n_audio, n_audio_ctx, n_state]
    steps: int = 0  # incremental decoder steps run after the prefill
    # step bodies run: the live steps, the no-op steps past the end, and
    # the warm-up body of each phase captured by this call
    bodies: int = 0
    syncs: int = 0  # reads of the termination test on the host
    captures: int = 0  # phases captured by this call
    capture_seconds: float = 0.0
    loop: str = "eager"  # "graphs", or why the eager loop ran


def eager_reason(model: Whisper, graphs: bool) -> Optional[str]:
    """Why a decode of ``model`` runs its steps eagerly, or None where each
    phase's step is captured as a CUDA graph: on the CPU; ``graphs=False``;
    ``enable_nan_checks`` on; a model whose step runs collectives through
    gloo (a model group under the gloo backend: staged through host memory,
    which a graph cannot capture)."""
    if model.device.type != "cuda":
        return "the CPU"
    if not graphs:
        return "graphs=False"
    if nan_checks_enabled():
        return "enable_nan_checks"
    mesh = getattr(model, "mesh", None)
    if (mesh is not None and mesh.backend == "gloo"
            and (mesh.n_model > 1 or mesh.model_group is not None)):
        return "collectives through gloo"
    return None


def _encode_and_prefill(win: "DecodeWindow", mel, initial_tokens, sot_idx: int,
                        no_speech_id: int, key_start, encoder_fn=None):
    """Encoder forward (``encoder_fn(model, mel, kernels)`` in its place
    where given), group repeat and prefill pass of ``win``'s shape, into
    the window's static buffers in place (the cache reset first, the cross
    K/V, the tokens, key_start); with the shape's ``quantize_kv`` the cross
    K/V and the cache are int8 with per-position scales.  Returns (the
    first step's filtered logits [B, V], no_speech_probs [n_audio], audio
    features)."""
    model, sh = win.model, win.shape
    group, sample_begin = sh.group, sh.sample_begin
    xa = encoder_forward(model, mel.to(model.dtype), kernels=sh.kernels, encoder_fn=encoder_fn)
    if group > 1:
        initial_tokens = initial_tokens.repeat_interleave(group, dim=0)
        if key_start is not None:
            key_start = key_start.repeat_interleave(group, dim=0)
    cross_kv = precompute_cross_kv(model, xa, quantize=sh.quantize_kv, out=win.cross_kv)
    cache, tokens = win.cache, win.tokens
    cache.reset()
    tokens.zero_()
    if key_start is not None:
        key_start = win.key_start.copy_(key_start)

    # only the SOT row (no-speech probability) and the last prompt row (the
    # first sampled position) need logits
    positions = torch.tensor([sot_idx, sample_begin - 1], device=xa.device)
    logits = model.decoder(
        initial_tokens, 0, cross_kv, cache, key_start=key_start,
        logit_positions=positions, cross_group=group, kernels=sh.kernels,
    )  # [B, 2, V] f32
    no_speech = torch.softmax(logits[:, 0], dim=-1)[:, no_speech_id]

    tokens[:, : initial_tokens.shape[1]] = initial_tokens
    filtered = apply_filters(sh.cfg, logits[:, 1], tokens, sample_begin, sample_begin)
    return filtered, no_speech[::group], xa


def _step_logits(
    model: Whisper, tokens, pos, cross_kv: CrossKV, cache: KVCache,
    cfg: FilterConfig, sample_begin: int, key_start, group: int, ctx_window: int,
    kernels: bool, ancestors=None, step_kernel: str = "append", step_weights=None,
    live=None,
):
    """One incremental step: feed the token at pos-1, return the filtered
    logits for position pos.  ``pos`` is a 0-d int64 tensor on the device
    (or an int); ``live``, a 0-d bool tensor, turns the step off where it
    is false: the step then writes its K/V at slot -1 (nowhere).  The step
    takes the route ``step_kernel`` of ``TextDecoder.forward`` (the append
    self-attention and fused MLP kernels by default; the beam kernel with
    ``ancestors``), which writes the cache in place; the prefill never
    does, as in the JAX loop."""
    pos = step_pos(pos, tokens.device)
    prev = pos - 1
    fed = tokens.index_select(1, prev.clamp(0, tokens.shape[1] - 1).view(1))
    slot = prev if live is None else torch.where(live, prev, -1)
    logits = model.decoder(
        fed, slot, cross_kv, cache, key_start=key_start,
        cross_group=group, ctx_window=ctx_window, kernels=kernels, incremental=True,
        ancestors=ancestors, step_kernel=step_kernel, step_weights=step_weights,
    )
    return apply_filters(cfg, logits[:, 0], tokens, pos, sample_begin)


def _phase_windows(n_ctx: int, prefill_width: int, sample_len: int) -> tuple:
    """Cache-window schedule (128 -> 256 -> n_ctx): a step at position pos
    attends only the first W >= pos + 1 slots.  Phases the position can
    never reach are dropped."""
    max_pos = min(n_ctx, prefill_width + sample_len + 1)
    wins = []
    for W in (128, 256, n_ctx):
        if W < prefill_width or W <= (wins[-1] if wins else 0):
            continue
        wins.append(W)
        if W >= max_pos:
            break
    return tuple(wins)


def _write_token(tokens, pos, values, live=None) -> None:
    """``tokens[:, pos] = values`` in place for a device ``pos`` (clamped
    into the buffer), where ``live`` (a 0-d bool tensor, or None for
    always) holds."""
    slot = pos.clamp(0, tokens.shape[1] - 1).view(1)
    if live is not None:
        values = torch.where(live, values, tokens.index_select(1, slot)[:, 0])
    tokens.index_copy_(1, slot, values[:, None])


def _greedy_update(logits, tokens, pos, sum_logprobs, finished, eot: int,
                   temperature=None, keys=None, live=None):
    """Next token: argmax, or with ``temperature`` (a 0-d f32 tensor, the
    divisor of the logits) a draw with the step's row ``keys``;
    accumulate its logprob (of the unscaled logits) for live rows; pin
    finished rows to EOT.  Writes ``tokens[:, pos]`` in place (only where
    ``live`` holds, a 0-d bool tensor; None: always); returns the new
    (sum_logprobs, finished), which the caller keeps where ``live``
    holds."""
    if temperature is None:
        next_tok = logits.argmax(dim=-1)
    else:
        next_tok = rng.categorical(keys, logits / temperature)
    cur_lp = log_softmax(logits).gather(1, next_tok[:, None])[:, 0]
    sum_logprobs = sum_logprobs + torch.where(finished, torch.zeros_like(cur_lp), cur_lp)
    next_tok = torch.where(finished, torch.full_like(next_tok, eot), next_tok)
    finished = finished | (next_tok == eot)
    _write_token(tokens, step_pos(pos, tokens.device), next_tok, live)
    return sum_logprobs, finished


def data_parallel(decode):
    """``decode`` (``decode_greedy`` or ``decode_beam``) split by audio over
    the data ranks of ``model.mesh`` and gathered (see the module
    docstring); as it is on one data rank."""

    @functools.wraps(decode)
    def run(model, mel, initial_tokens, *args, key_start=None, **kwargs) -> DecodeResult:
        mesh = getattr(model, "mesh", None)
        if mesh is None or (mesh.n_data == 1 and mesh.data_group is None):
            return decode(model, mel, initial_tokens, *args, key_start=key_start, **kwargs)
        dev = model.device
        mel = torch.as_tensor(mel).to(dev)
        initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
        n_audio = mel.shape[0]
        if key_start is not None:
            key_start = shard_batch(torch.as_tensor(key_start, dtype=torch.long, device=dev), mesh)
        res = decode(model, shard_batch(mel, mesh), shard_batch(initial_tokens, mesh), *args,
                     key_start=key_start, **kwargs)
        steps = all_gather_data(torch.tensor([res.steps], device=dev), mesh)
        gathered = (all_gather_data(t, mesh)[:n_audio] for t in (
            res.candidates, res.scores, res.no_speech_probs, res.audio_features))
        return DecodeResult(*gathered, steps=int(steps.max()), bodies=res.bodies,
                            syncs=res.syncs, captures=res.captures,
                            capture_seconds=res.capture_seconds, loop=res.loop)

    return run


# ---------------------------------------------------------------------------
# the window on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BeamState:
    tokens: torch.Tensor  # [n_audio*beam, n_ctx]
    sum_logprobs: torch.Tensor  # [n_audio*beam] f32
    # finished buffer; slot ``cap`` (the last) takes the writes the
    # reference drops, and is cut off at the end
    fin_tokens: torch.Tensor  # [n_audio, cap + 1, n_ctx]
    fin_scores: torch.Tensor  # [n_audio, cap + 1] f32
    fin_count: torch.Tensor  # [n_audio]
    # gather-at-read ancestor table [B, n_ctx] int32, beam-local: logical
    # beam b's K/V at position j is in physical row b - b % beam + anc[b, j]
    # (the JAX table holds that global row; a gather within one audio keeps
    # the local values valid, and the kernel takes them as they are)
    anc: torch.Tensor

    def keep(self, new: "_BeamState", live) -> None:
        """Each buffer takes ``new``'s values in place where ``live`` (a 0-d
        bool tensor) holds, and keeps its own where it does not."""
        for f in dataclasses.fields(self):
            buf = getattr(self, f.name)
            buf.copy_(torch.where(live, getattr(new, f.name), buf))


@dataclasses.dataclass(frozen=True)
class WindowShape:
    """What a window's static buffers and captured steps are built for:
    JAX's ``_window_fn`` key (audios, prefill width, key_start or not,
    sampled or not) and the port's own (the step route, int8 K/V, beam
    search and its capacity, kernels), with what the body bakes in (the
    first sampled position, the token budget, the filters)."""

    n_audio: int
    group: int  # rows an audio: the beam, or the greedy group
    prefill_width: int
    sample_begin: int
    sample_len: int
    with_key_start: bool
    sampled: bool
    beam: bool
    cap: int  # the beam's finished capacity (0 for greedy)
    step_kernel: str
    quantize_kv: bool
    kernels: bool
    cfg: FilterConfig


class DecodeWindow:
    """The static state of one window shape on one model: every buffer a
    decode of that shape updates in place, and on the card each phase's
    step captured as a CUDA graph.

    What it holds, K and V together: the self-attention cache (L B H n_ctx
    dh elements, 705 MB at base.en b128 and 881 MB at large-v3 b12 in
    bf16; int8 halves it and adds its f32 scales), the cross K/V (L A H 2
    dh 1500 elements: 2.36 GB at base.en b128, 2.95 GB at large-v3 b12), the
    tokens and the carried state (under a megabyte), and the graphs' memory
    pool (each phase's step intermediates, tens of MB)."""

    def __init__(self, model: Whisper, shape: WindowShape):
        dims = model.dims
        self.model, self.shape = model, shape
        dev = model.device
        B = shape.n_audio * shape.group
        n_ctx = dims.n_text_ctx
        self.B, self.n_ctx = B, n_ctx
        self.phases = _phase_windows(n_ctx, shape.prefill_width, shape.sample_len)
        self.cache = KVCache.init(dims, B, model.dtype, dev, quantize=shape.quantize_kv,
                                  n_head=model.decoder.n_head)
        blocks = model.decoder.blocks
        H, dh = blocks[0].cross_attn.n_head, blocks[0].cross_attn.head_dim
        kv_shape = (len(blocks), shape.n_audio, H, 2, dh, dims.n_audio_ctx)
        if shape.quantize_kv:
            scales = torch.ones((2, len(blocks), shape.n_audio, H, dims.n_audio_ctx), device=dev)
            self.cross_kv = CrossKV(torch.zeros(kv_shape, dtype=torch.int8, device=dev),
                                    scales[0], scales[1])
        else:
            self.cross_kv = CrossKV(torch.zeros(kv_shape, dtype=model.dtype, device=dev))
        self.tokens = torch.zeros((B, n_ctx), dtype=torch.long, device=dev)
        self.key_start = (torch.zeros(B, dtype=torch.long, device=dev)
                          if shape.with_key_start else None)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.step = torch.zeros((), dtype=torch.long, device=dev)
        self.sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
        self.step_weights = (decoder_step_weights(blocks) if shape.step_kernel == "layer"
                             else None)
        self.keys = self.divisor = None
        if shape.sampled:
            self.keys = torch.zeros((shape.sample_len, B, 2), dtype=torch.long, device=dev)
            self.divisor = torch.ones((), dtype=torch.float32, device=dev)
        if shape.beam:
            A, cap = shape.n_audio, shape.cap
            self.own = torch.arange(B, dtype=torch.int32, device=dev) % shape.group
            self.beam_state = _BeamState(
                tokens=self.tokens,
                sum_logprobs=self.sum_lp,
                fin_tokens=torch.zeros((A, cap + 1, n_ctx), dtype=torch.long, device=dev),
                fin_scores=torch.full((A, cap + 1), BIG_NEG, dtype=torch.float32, device=dev),
                fin_count=torch.zeros((A,), dtype=torch.long, device=dev),
                anc=torch.zeros((B, n_ctx), dtype=torch.int32, device=dev),
            )
        else:
            self.finished = torch.zeros(B, dtype=torch.bool, device=dev)
        self.eager: Optional[str] = None  # this call's eager_reason (prepare)
        self.graphs: dict = {}  # phase window -> (CUDAGraph, launches a replay)
        self.captures, self.capture_seconds, self.warmup_bodies = 0, 0.0, 0

    def prepare(self, graphs: bool) -> bool:
        """Decide this call's loop (``eager_reason``, read at every call: a
        window captured before ``enable_nan_checks`` was turned on runs
        eagerly while it is on), and capture the phases where the loop is
        captured and they are not yet.  Returns whether it captured them
        now."""
        self.eager = eager_reason(self.model, graphs)
        if self.eager is not None or self.graphs:
            return False
        self._capture_all()
        return True

    # -- the step body ------------------------------------------------------

    def done(self) -> torch.Tensor:
        """The termination test's last term, on the device: every greedy
        row finished, or every audio's finished buffer full."""
        if self.shape.beam:
            return (self.beam_state.fin_count >= self.shape.cap).all()
        return self.finished.all()

    def body(self, W: int) -> None:
        """One step of the phase of window ``W``, on the static buffers, in
        place: ``live`` is the JAX loop's ``cond`` on the device, and every
        write keeps the old value where it is false."""
        sh, m = self.shape, self.model
        live = (self.step < sh.sample_len) & (self.pos < W) & ~self.done()
        if sh.beam:
            s = self.beam_state
            # slot pos-1, written by this step, belongs to each row itself
            _write_token(s.anc, self.pos - 1, self.own, live)
            logits = _step_logits(m, s.tokens, self.pos, self.cross_kv, self.cache, sh.cfg,
                                  sh.sample_begin, self.key_start, sh.group, W, sh.kernels,
                                  ancestors=s.anc, live=live)
            s.keep(_beam_step(logits, s, self.pos, sh.group, sh.cap, sh.cfg.token_id_eot), live)
        else:
            logits = _step_logits(m, self.tokens, self.pos, self.cross_kv, self.cache, sh.cfg,
                                  sh.sample_begin, self.key_start, sh.group, W, sh.kernels,
                                  step_kernel=sh.step_kernel, step_weights=self.step_weights,
                                  live=live)
            self._greedy(logits, live)
        self.step.add_(live)
        self.pos.add_(live)

    def _greedy(self, logits, live) -> None:
        sh = self.shape
        keys = None
        if sh.sampled:
            at = (self.pos - sh.sample_begin).clamp(0, sh.sample_len - 1).view(1)
            keys = self.keys.index_select(0, at)[0]
        sum_lp, finished = _greedy_update(logits, self.tokens, self.pos, self.sum_lp,
                                          self.finished, sh.cfg.token_id_eot, self.divisor,
                                          keys, live)
        self.sum_lp.copy_(torch.where(live, sum_lp, self.sum_lp))
        self.finished.copy_(torch.where(live, finished, self.finished))

    # -- capture and replay ---------------------------------------------------

    def _capture_all(self) -> None:
        """Capture each phase's body as a CUDA graph, the phases sharing one
        memory pool.  The body first runs once eagerly, on a side stream,
        with ``live`` false (``step`` at the budget): a no-op that loads
        the kernel libraries, the cuBLAS handles and the device tables
        outside the capture.  A failing capture raises.  The capture
        guards its own thread only (``"thread_local"``): another thread,
        such as a serving client's running its mel, may use the card
        meanwhile."""
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        self.step.fill_(self.shape.sample_len)
        side = torch.cuda.Stream(self.model.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for W in self.phases:
                self.body(W)
                self.warmup_bodies += 1
        torch.cuda.current_stream().wait_stream(side)
        for W in self.phases:
            graph = torch.cuda.CUDAGraph()
            with ops.recorded_launches() as counts, torch.cuda.graph(
                    graph, pool=pool, capture_error_mode="thread_local"):
                self.body(W)
            self.graphs[W] = (graph, counts)
        torch.cuda.synchronize(self.model.device)
        self.captures = len(self.phases)
        self.capture_seconds = time.perf_counter() - t0

    def run_phase_steps(self, W: int, n: int) -> None:
        """``n`` bodies of phase ``W``: graph replays, or eager steps."""
        if self.eager is not None:
            for _ in range(n):
                self.body(W)
            return
        graph, counts = self.graphs[W]
        for _ in range(n):
            graph.replay()
        ops.add_launches(counts, n)

    def read(self) -> tuple:
        """(step, pos, done) on the host: one sync."""
        step, pos, done = torch.stack((self.step, self.pos, self.done().long())).tolist()
        return step, pos, bool(done)

    def run(self) -> tuple:
        """The phases after the first update (``step`` 1, ``pos`` at
        sample_begin + 1): ``CHECK_EVERY`` bodies between reads, never
        more than the phase can hold.  Returns (steps, pos, bodies, syncs)
        on the host."""
        sh = self.shape
        step, pos = 1, sh.sample_begin + 1
        bodies = syncs = 0
        done = False
        for W in self.phases:
            while not done:
                n = min(CHECK_EVERY, sh.sample_len - step, W - pos)
                if n <= 0:
                    break
                self.run_phase_steps(W, n)
                bodies += n
                step, pos, done = self.read()
                syncs += 1
            if done:
                break
        return step, pos, bodies, syncs


class WindowCache:
    """The windows of a task, by shape (``WindowShape``): at most SIZE, the
    least recently used dropped (its buffers and graphs freed with it),
    since each holds its own cache and cross K/V.  SIZE is one window a
    prefill bucket: the shapes a task cycles through at one batch size
    (a transcription's prompts grow from the first bucket to the last; a
    serving engine's calls are padded to its batch)."""

    SIZE = len(PREFILL_BUCKETS)

    def __init__(self):
        self._windows: collections.OrderedDict = collections.OrderedDict()

    def get(self, model: Whisper, shape: WindowShape) -> DecodeWindow:
        """The window of ``shape`` on ``model``, made (not captured) where
        the cache has none."""
        key = (id(model), shape)
        win = self._windows.get(key)
        if win is not None:
            self._windows.move_to_end(key)
            return win
        while len(self._windows) >= self.SIZE:
            self._windows.popitem(last=False)
        win = self._windows[key] = DecodeWindow(model, shape)
        return win

    def clear(self) -> None:
        """Drop every window, its buffers and graphs."""
        self._windows.clear()

    def __len__(self) -> int:
        return len(self._windows)


def greedy_shape(mode: GreedyMode, n_audio: int, prefill_width: int, sample_begin: int,
                 sample_len: int, with_key_start: bool, cfg: FilterConfig, kernels: bool,
                 step_kernel: str = "append", quantize_kv: bool = False,
                 temperature: Optional[float] = None) -> tuple:
    """(the ``WindowShape`` of a greedy decode, its temperature: ``mode``'s,
    or the override, at least 1e-6 where above 0)."""
    t = mode.temperature if temperature is None else float(temperature)
    if t > 0.0 and temperature is not None:
        t = max(t, 1e-6)
    return WindowShape(
        n_audio=n_audio, group=mode.group_size, prefill_width=prefill_width,
        sample_begin=sample_begin, sample_len=sample_len, with_key_start=with_key_start,
        sampled=t > 0.0, beam=False, cap=0, step_kernel=step_kernel, quantize_kv=quantize_kv,
        kernels=kernels, cfg=cfg,
    ), t


def beam_shape(mode: BeamSearchMode, n_audio: int, prefill_width: int, sample_begin: int,
               sample_len: int, with_key_start: bool, cfg: FilterConfig, kernels: bool,
               quantize_kv: bool = False) -> WindowShape:
    """The ``WindowShape`` of a beam decode."""
    beam = mode.beam_size
    return WindowShape(
        n_audio=n_audio, group=beam, prefill_width=prefill_width, sample_begin=sample_begin,
        sample_len=sample_len, with_key_start=with_key_start, sampled=False, beam=True,
        cap=max(beam, int(round(mode.patience * beam))), step_kernel="append",
        quantize_kv=quantize_kv, kernels=kernels, cfg=cfg,
    )


def _window(model, windows: Optional[WindowCache], shape: WindowShape, graphs: bool):
    """(the window of ``shape``, kept in ``windows`` or made for this call,
    prepared for this call's loop; whether its phases were captured now)."""
    win = DecodeWindow(model, shape) if windows is None else windows.get(model, shape)
    return win, win.prepare(graphs)


def _result(win: DecodeWindow, captured: bool, candidates, scores, no_speech, feats,
            steps: int, bodies: int, syncs: int) -> DecodeResult:
    return DecodeResult(
        candidates=candidates, scores=scores, no_speech_probs=no_speech, audio_features=feats,
        steps=steps, bodies=bodies + (win.warmup_bodies if captured else 0), syncs=syncs,
        captures=win.captures if captured else 0,
        capture_seconds=win.capture_seconds if captured else 0.0,
        loop="graphs" if win.eager is None else f"eager ({win.eager})",
    )


@data_parallel
def decode_greedy(
    model: Whisper,
    mel: torch.Tensor,  # [n_audio, n_mels, 3000] on the model's device
    initial_tokens,  # [n_audio, P] prompt (array or tensor)
    sample_begin: int,
    sot_idx: int,
    cfg: FilterConfig,
    mode: GreedyMode,
    sample_len: int,
    no_speech_id: int,
    key_start=None,  # [n_audio] first valid prompt slot per row
    kernels: bool = True,
    step_kernel: str = "append",
    quantize_kv: bool = False,
    rng_key: Optional[torch.Tensor] = None,  # [2] threefry key (rng.PRNGKey)
    temperature: Optional[float] = None,  # overrides mode.temperature
    encoder_fn=None,  # (model, mel, kernels) -> xa in the encoder's place
    graphs: bool = True,
    windows: Optional[WindowCache] = None,
) -> DecodeResult:
    """Greedy decode of one batch of 30 s windows.  ``kernels=False`` runs
    every kernel's plain version instead (the reference path on the card).
    ``step_kernel`` is the incremental steps' route (``TextDecoder.
    forward``): ``"append"`` (the default), ``"ctx"`` or ``"layer"``, the
    whole-step kernel, whose weight table is built once a window.
    ``quantize_kv`` keeps the cross K/V and the self-attention cache int8
    (the JAX ``quantize_kv``); it takes the append route, where each step's
    ``self_attention_step`` quantises and writes its K/V column, then reads
    the cache.

    At a temperature above 0 (``temperature``, else ``mode.temperature``)
    each row draws its token from ``softmax(logits / T)`` with the noise of
    the JAX loop on ``rng_key`` (default ``rng.PRNGKey(0)``), the ``group``
    rows of an audio independently (best-of-N); an override divides by
    ``max(T, 1e-6)``, as the JAX loop's traced temperature does.  At 0 it
    is the argmax.

    On the card each phase's step is captured as a CUDA graph and replayed
    (see the module docstring); ``graphs=False`` runs it eagerly.
    ``windows`` keeps the window's static buffers and graphs for the next
    call of its shape (a ``WindowCache``, as ``DecodeTask`` holds one);
    without it the window is made, and captured, for this call alone."""
    model.decoder.check_route(step_kernel, int8_kv=quantize_kv)
    dev = model.device
    group = mode.group_size
    initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
    if key_start is not None:
        key_start = torch.as_tensor(key_start, dtype=torch.long, device=dev)
    shape, t = greedy_shape(mode, initial_tokens.shape[0], initial_tokens.shape[1], sample_begin,
                            sample_len, key_start is not None, cfg, kernels, step_kernel,
                            quantize_kv, temperature)
    win, captured = _window(model, windows, shape, graphs)

    logits, no_speech, feats = _encode_and_prefill(win, mel.to(dev), initial_tokens, sot_idx,
                                                   no_speech_id, key_start, encoder_fn)
    tokens, B = win.tokens, win.B
    keys = None
    if shape.sampled:
        win.divisor.fill_(t)
        if rng_key is None:
            rng_key = rng.PRNGKey(0, device=dev)
        win.keys.copy_(rng.row_keys(rng_key.to(dev), sample_len, B, group))
        keys = win.keys[0]

    win.sum_lp.zero_()
    win.finished.zero_()
    win.pos.fill_(sample_begin)
    sum_lp, finished = _greedy_update(logits, tokens, win.pos, win.sum_lp, win.finished,
                                      cfg.token_id_eot, win.divisor, keys)
    win.sum_lp.copy_(sum_lp)
    win.finished.copy_(finished)
    win.step.fill_(1)
    win.pos.fill_(sample_begin + 1)

    step, pos, bodies, syncs = win.run()

    # finalize: rows that never emitted EOT get one appended
    n_ctx = win.n_ctx
    out = tokens.clone()
    write_pos = min(pos, n_ctx - 1)
    out[:, write_pos] = torch.where(
        win.finished, out[:, write_pos], torch.full_like(out[:, write_pos], cfg.token_id_eot)
    )
    n_audio = B // group
    return _result(win, captured, out.reshape(n_audio, group, n_ctx),
                   win.sum_lp.clone().reshape(n_audio, group), no_speech, feats, step - 1,
                   bodies, syncs)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def _sort_desc(x: torch.Tensor):
    """Values descending along the last dim, the lower index first among
    equal values: the order of ``lax.top_k`` and of a stable ``argsort`` of
    the negated values."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _beam_step(logits, s: _BeamState, pos, beam: int, cap: int, eot: int) -> _BeamState:
    """One beam-search update (JAX ``_beam_step``): per audio, each beam's
    top-(beam+1) candidates ranked together by cumulative logprob; EOT
    candidates that outrank the beam-th unfinished one go into the finished
    buffer in score order, up to ``cap``; the best ``beam`` unfinished
    candidates continue, with their tokens and ancestor rows gathered from
    their source beams.  Writes token ``pos`` (an int or a 0-d int64
    tensor on the device).  Returns the new state in new tensors; ``s`` is
    left as it was."""
    n_total, V = logits.shape
    n_audio = n_total // beam
    n_ctx = s.tokens.shape[-1]
    K = beam * (beam + 1)
    dev = logits.device
    slot = step_pos(pos, dev).clamp(0, n_ctx - 1).view(1)
    ar_k = torch.arange(K, device=dev)
    row0 = torch.arange(n_audio, device=dev)[:, None] * beam  # each audio's first row

    cum = (s.sum_logprobs[:, None] + log_softmax(logits)).view(n_audio, beam, V)
    top_lp, top_tok = (t[..., : beam + 1] for t in _sort_desc(cum))
    score = top_lp.reshape(n_audio, K)
    tok = top_tok.reshape(n_audio, K)
    src = (ar_k // (beam + 1)).expand(n_audio, K)

    score, order = _sort_desc(score)
    tok, src = tok.gather(1, order), src.gather(1, order)
    is_fin = tok == eot

    # continuing beams: the first ``beam`` unfinished in score order (every
    # beam gives at least ``beam`` unfinished candidates, so there are enough)
    unf = ~is_fin
    rank_unf = unf.cumsum(dim=-1)
    sel_pos = torch.where(unf & (rank_unf <= beam), ar_k, K)
    sel_idx = sel_pos.sort(dim=-1).values[:, :beam]
    new_score = score.gather(1, sel_idx).reshape(-1)
    new_tok = tok.gather(1, sel_idx).reshape(-1)
    global_src = (src.gather(1, sel_idx) + row0).reshape(-1)
    tokens = s.tokens[global_src]
    tokens.index_copy_(1, slot, new_tok[:, None])

    # finished candidates: only EOTs that outrank the beam-th unfinished one
    eligible = is_fin & (rank_unf < beam)
    fin_slot = s.fin_count[:, None] + eligible.cumsum(dim=-1) - 1
    writable = eligible & (fin_slot < cap)
    fin_slot = torch.where(writable, fin_slot, cap)
    cand = s.tokens[(src + row0).reshape(-1)].view(n_audio, K, n_ctx)
    cand.index_copy_(2, slot, tok[:, :, None])

    return _BeamState(
        tokens=tokens,
        sum_logprobs=new_score,
        fin_tokens=s.fin_tokens.scatter(1, fin_slot[:, :, None].expand(n_audio, K, n_ctx), cand),
        fin_scores=s.fin_scores.scatter(1, fin_slot, score),
        fin_count=s.fin_count + writable.sum(dim=-1),
        anc=s.anc[global_src],
    )


@data_parallel
def decode_beam(
    model: Whisper,
    mel: torch.Tensor,  # [n_audio, n_mels, 3000] on the model's device
    initial_tokens,  # [n_audio, P] prompt (array or tensor)
    sample_begin: int,
    sot_idx: int,
    cfg: FilterConfig,
    mode: BeamSearchMode,
    sample_len: int,
    no_speech_id: int,
    key_start=None,  # [n_audio] first valid prompt slot per row
    kernels: bool = True,
    quantize_kv: bool = False,
    encoder_fn=None,  # (model, mel, kernels) -> xa in the encoder's place
    graphs: bool = True,
    windows: Optional[WindowCache] = None,
) -> DecodeResult:
    """Beam-search decode of one batch of 30 s windows: ``beam_size`` rows
    per audio share one cross K/V, and every step reads the self-attention
    cache through the ancestor table.  Candidates [n_audio, cap, n_ctx] with
    ``cap = max(beam, round(patience * beam))``, EOT-terminated.
    ``kernels=False`` runs every kernel's plain version instead;
    ``quantize_kv`` keeps the cross K/V and the cache int8.  ``graphs``
    and ``windows`` as in ``decode_greedy``."""
    dev = model.device
    eot = cfg.token_id_eot
    initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
    if key_start is not None:
        key_start = torch.as_tensor(key_start, dtype=torch.long, device=dev)
    shape = beam_shape(mode, initial_tokens.shape[0], initial_tokens.shape[1], sample_begin,
                       sample_len, key_start is not None, cfg, kernels, quantize_kv)
    beam, cap = shape.group, shape.cap
    win, captured = _window(model, windows, shape, graphs)

    logits, no_speech, feats = _encode_and_prefill(win, mel.to(dev), initial_tokens, sot_idx,
                                                   no_speech_id, key_start, encoder_fn)
    B = win.B
    n_audio, n_ctx = B // beam, win.n_ctx
    s = win.beam_state

    # only beam 0 of each audio is live at the first step, so the identical
    # prefixes of the others never enter the top candidates
    s.sum_logprobs.copy_(torch.where(win.own == 0, torch.zeros((), device=dev),
                                     torch.full((), BIG_NEG, device=dev)))
    s.fin_tokens.zero_()
    s.fin_scores.fill_(BIG_NEG)
    s.fin_count.zero_()
    s.anc.copy_(win.own[:, None].expand(B, n_ctx))
    # the first step takes the prefill logits; the prefill wrote every row
    # itself, so each row's own beam is the right table for it
    s.keep(_beam_step(logits, s, sample_begin, beam, cap, eot),
           torch.ones((), dtype=torch.bool, device=dev))
    win.step.fill_(1)
    win.pos.fill_(sample_begin + 1)

    step, pos, bodies, syncs = win.run()

    # finalize: each audio with fewer than ``beam`` finished sequences is
    # filled up from its live beams, best first, EOT-terminated
    write_pos = min(pos, n_ctx - 1)
    live_tokens = s.tokens.view(n_audio, beam, n_ctx).clone()
    live_tokens[:, :, write_pos] = eot
    live_scores, order = _sort_desc(s.sum_logprobs.view(n_audio, beam))
    live_tokens = live_tokens.gather(1, order[:, :, None].expand(n_audio, beam, n_ctx))
    slot = s.fin_count[:, None] + torch.arange(beam, device=dev)
    slot = torch.where(slot < beam, slot, cap)
    fin_tokens = s.fin_tokens.scatter(1, slot[:, :, None].expand(n_audio, beam, n_ctx),
                                      live_tokens)
    fin_scores = s.fin_scores.scatter(1, slot, live_scores)
    return _result(win, captured, fin_tokens[:, :cap], fin_scores[:, :cap], no_speech, feats,
                   step - 1, bodies, syncs)
