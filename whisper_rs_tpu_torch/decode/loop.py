"""Single-window decode (counterpart of ``whisper_rs_tpu/decode/loop.py``):
encoder, cross K/V precompute, prompt prefill, then a host loop of
incremental decoder steps with the logit filters, in phases of growing
attention window.  Two token extractors:

  * greedy (``decode_greedy``): argmax at temperature 0, else a draw from
    ``softmax(logits / T)`` with JAX's threefry noise (``decode/rng.py``),
    and EOT bookkeeping; the loop checks ``finished.all()`` on the host
    once a step;
  * beam search (``decode_beam``): per-beam top-(beam+1) candidates ranked
    per audio, EOT candidates into a capacity-capped finished buffer in
    score order, and the cache read through an ancestor table (gather at
    read: the cache never moves); the loop checks the finished counts on
    the host once a step.

Ties among equal scores are broken as JAX's ``lax.top_k`` and stable
``argsort`` break them: the lower index first.  ``torch.topk`` promises no
order for ties on the card, so every ranking here is a stable sort.

A sampled draw is batch-composition invariant, as in the JAX loop: row r
of step s draws with the key ``fold_in(fold_in(rng_key, s), r % group)``,
where s counts from the first sampled position (not the absolute position,
which moves with the prompt bucket), so an audio draws the same noise
alone or inside a batch.  Every key of a decode is made once before the
step loop (``rng.row_keys``); a step hashes only its noise on the device
and adds no host sync.

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

import dataclasses
import functools
from typing import Optional

import torch

from ..config import BeamSearchMode, GreedyMode
from ..models.whisper import CrossKV, KVCache, Whisper, encoder_forward, precompute_cross_kv
from ..ops.decoder_layer_fused import decoder_step_weights
from ..parallel.collectives import all_gather_data
from ..parallel.sharding import shard_batch
from . import rng
from .filters import FilterConfig, apply_filters, log_softmax

BIG_NEG = -1e9  # finite stand-in for -inf in scores


@dataclasses.dataclass
class DecodeResult:
    """Outputs of one window decode (per audio)."""

    candidates: torch.Tensor  # [n_audio, n_cand, n_ctx] int64, EOT-terminated
    scores: torch.Tensor  # [n_audio, n_cand] f32 cumulative logprob
    no_speech_probs: torch.Tensor  # [n_audio] f32
    audio_features: torch.Tensor  # [n_audio, n_audio_ctx, n_state]
    steps: int = 0  # incremental decoder steps run after the prefill


def _encode_and_prefill(
    model: Whisper, mel, initial_tokens, sample_begin: int, sot_idx: int, group: int,
    cfg: FilterConfig, no_speech_id: int, key_start, kernels: bool, quantize_kv: bool = False,
    encoder_fn=None,
):
    """Encoder forward (``encoder_fn(model, mel, kernels)`` in its place
    where given), group repeat, prefill pass; with ``quantize_kv`` the
    cross K/V and the cache are int8 with per-position scales.  Returns
    (tokens [B, n_ctx], first-step filtered logits [B, V], cache, cross_kv,
    no_speech_probs [n_audio], audio features, key_start)."""
    dims = model.dims
    xa = encoder_forward(model, mel.to(model.dtype), kernels=kernels, encoder_fn=encoder_fn)
    if group > 1:
        initial_tokens = initial_tokens.repeat_interleave(group, dim=0)
        if key_start is not None:
            key_start = key_start.repeat_interleave(group, dim=0)
    B = initial_tokens.shape[0]

    cross_kv = precompute_cross_kv(model, xa, quantize=quantize_kv)
    cache = KVCache.init(dims, B, xa.dtype, xa.device, quantize=quantize_kv,
                         n_head=model.decoder.n_head)

    # only the SOT row (no-speech probability) and the last prompt row (the
    # first sampled position) need logits
    positions = torch.tensor([sot_idx, sample_begin - 1], device=xa.device)
    logits = model.decoder(
        initial_tokens, 0, cross_kv, cache, key_start=key_start,
        logit_positions=positions, cross_group=group, kernels=kernels,
    )  # [B, 2, V] f32
    no_speech = torch.softmax(logits[:, 0], dim=-1)[:, no_speech_id]
    no_speech_probs = no_speech[::group]

    tokens = torch.zeros((B, dims.n_text_ctx), dtype=torch.long, device=xa.device)
    tokens[:, : initial_tokens.shape[1]] = initial_tokens
    filtered = apply_filters(cfg, logits[:, 1], tokens, sample_begin, sample_begin)
    return tokens, filtered, cache, cross_kv, no_speech_probs, xa, key_start


def _step_logits(
    model: Whisper, tokens, pos: int, cross_kv: CrossKV, cache: KVCache,
    cfg: FilterConfig, sample_begin: int, key_start, group: int, ctx_window: int,
    kernels: bool, ancestors=None, step_kernel: str = "append", step_weights=None,
):
    """One incremental step: feed the token at pos-1, return the filtered
    logits for position pos.  The step takes the route ``step_kernel`` of
    ``TextDecoder.forward`` (the append self-attention and fused MLP
    kernels by default; the beam kernel with ``ancestors``), which writes
    the cache in place; the prefill never does, as in the JAX loop."""
    logits = model.decoder(
        tokens[:, pos - 1 : pos], pos - 1, cross_kv, cache, key_start=key_start,
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


def _greedy_update(logits, tokens, pos: int, sum_logprobs, finished, eot: int,
                   temperature=None, keys=None):
    """Next token: argmax, or with ``temperature`` (a 0-d f32 tensor, the
    divisor of the logits) a draw with the step's row ``keys``;
    accumulate its logprob (of the unscaled logits) for live rows; pin
    finished rows to EOT.  Writes ``tokens[:, pos]`` in place."""
    if temperature is None:
        next_tok = logits.argmax(dim=-1)
    else:
        next_tok = rng.categorical(keys, logits / temperature)
    cur_lp = log_softmax(logits).gather(1, next_tok[:, None])[:, 0]
    sum_logprobs = sum_logprobs + torch.where(finished, torch.zeros_like(cur_lp), cur_lp)
    next_tok = torch.where(finished, torch.full_like(next_tok, eot), next_tok)
    finished = finished | (next_tok == eot)
    tokens[:, pos] = next_tok
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
        return DecodeResult(*gathered, steps=int(steps.max()))

    return run


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
) -> DecodeResult:
    """Greedy decode of one batch of 30 s windows.  ``kernels=False`` runs
    every kernel's plain version instead (the reference path on the card).
    ``step_kernel`` is the incremental steps' route (``TextDecoder.
    forward``): ``"append"`` (the default), ``"ctx"`` or ``"layer"``, the
    whole-step kernel, whose weight table is built here once, before the
    step loop.  ``quantize_kv`` keeps the cross K/V and the self-attention
    cache int8 (the JAX ``quantize_kv``); it takes the append route, where
    each step's ``self_attention_step`` quantises and writes its K/V column,
    then reads the cache.

    At a temperature above 0 (``temperature``, else ``mode.temperature``)
    each row draws its token from ``softmax(logits / T)`` with the noise of
    the JAX loop on ``rng_key`` (default ``rng.PRNGKey(0)``), the ``group``
    rows of an audio independently (best-of-N); an override divides by
    ``max(T, 1e-6)``, as the JAX loop's traced temperature does.  At 0 it
    is the argmax."""
    model.decoder.check_route(step_kernel, int8_kv=quantize_kv)
    dev = model.device
    dims = model.dims
    eot = cfg.token_id_eot
    n_ctx = dims.n_text_ctx
    group = mode.group_size
    initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
    if key_start is not None:
        key_start = torch.as_tensor(key_start, dtype=torch.long, device=dev)

    tokens, logits, cache, cross_kv, no_speech, feats, key_start = _encode_and_prefill(
        model, mel.to(dev), initial_tokens, sample_begin, sot_idx, group, cfg,
        no_speech_id, key_start, kernels, quantize_kv, encoder_fn,
    )
    B = tokens.shape[0]
    n_audio = B // group
    step_weights = decoder_step_weights(model.decoder.blocks) if step_kernel == "layer" else None

    t = mode.temperature if temperature is None else float(temperature)
    divisor = keys = None
    if t > 0.0:
        if temperature is not None:
            t = max(t, 1e-6)
        divisor = torch.full((), t, dtype=torch.float32, device=dev)
        if rng_key is None:
            rng_key = rng.PRNGKey(0, device=dev)
        keys = rng.row_keys(rng_key.to(dev), sample_len, B, group)

    def update(logits, pos, sum_lp, finished):
        step_keys = None if keys is None else keys[pos - sample_begin]
        return _greedy_update(logits, tokens, pos, sum_lp, finished, eot, divisor, step_keys)

    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    sum_lp, finished = update(logits, sample_begin, sum_lp, finished)

    step, pos = 1, sample_begin + 1
    for W in _phase_windows(n_ctx, initial_tokens.shape[1], sample_len):
        while step < sample_len and pos < W and not bool(finished.all()):
            logits = _step_logits(
                model, tokens, pos, cross_kv, cache, cfg, sample_begin, key_start,
                group, W, kernels, step_kernel=step_kernel, step_weights=step_weights,
            )
            sum_lp, finished = update(logits, pos, sum_lp, finished)
            step, pos = step + 1, pos + 1

    # finalize: rows that never emitted EOT get one appended
    write_pos = min(pos, n_ctx - 1)
    tokens[:, write_pos] = torch.where(
        finished, tokens[:, write_pos], torch.full_like(tokens[:, write_pos], eot)
    )
    return DecodeResult(
        candidates=tokens.reshape(n_audio, group, n_ctx),
        scores=sum_lp.reshape(n_audio, group),
        no_speech_probs=no_speech,
        audio_features=feats,
        steps=step - 1,
    )


# ---------------------------------------------------------------------------
# beam search
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


def _sort_desc(x: torch.Tensor):
    """Values descending along the last dim, the lower index first among
    equal values: the order of ``lax.top_k`` and of a stable ``argsort`` of
    the negated values."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _beam_step(logits, s: _BeamState, pos: int, beam: int, cap: int, eot: int) -> _BeamState:
    """One beam-search update (JAX ``_beam_step``): per audio, each beam's
    top-(beam+1) candidates ranked together by cumulative logprob; EOT
    candidates that outrank the beam-th unfinished one go into the finished
    buffer in score order, up to ``cap``; the best ``beam`` unfinished
    candidates continue, with their tokens and ancestor rows gathered from
    their source beams.  Writes token ``pos``."""
    n_total, V = logits.shape
    n_audio = n_total // beam
    n_ctx = s.tokens.shape[-1]
    K = beam * (beam + 1)
    dev = logits.device
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
    tokens[:, pos] = new_tok

    # finished candidates: only EOTs that outrank the beam-th unfinished one
    eligible = is_fin & (rank_unf < beam)
    slot = s.fin_count[:, None] + eligible.cumsum(dim=-1) - 1
    writable = eligible & (slot < cap)
    slot = torch.where(writable, slot, cap)
    cand = s.tokens[(src + row0).reshape(-1)].view(n_audio, K, n_ctx)
    cand[:, :, pos] = tok
    s.fin_tokens.scatter_(1, slot[:, :, None].expand(n_audio, K, n_ctx), cand)
    s.fin_scores.scatter_(1, slot, score)

    return _BeamState(
        tokens=tokens,
        sum_logprobs=new_score,
        fin_tokens=s.fin_tokens,
        fin_scores=s.fin_scores,
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
) -> DecodeResult:
    """Beam-search decode of one batch of 30 s windows: ``beam_size`` rows
    per audio share one cross K/V, and every step reads the self-attention
    cache through the ancestor table.  Candidates [n_audio, cap, n_ctx] with
    ``cap = max(beam, round(patience * beam))``, EOT-terminated.
    ``kernels=False`` runs every kernel's plain version instead;
    ``quantize_kv`` keeps the cross K/V and the cache int8."""
    beam = mode.beam_size
    cap = max(beam, int(round(mode.patience * beam)))
    dev = model.device
    eot = cfg.token_id_eot
    n_ctx = model.dims.n_text_ctx
    initial_tokens = torch.as_tensor(initial_tokens, dtype=torch.long, device=dev)
    if key_start is not None:
        key_start = torch.as_tensor(key_start, dtype=torch.long, device=dev)

    tokens, logits, cache, cross_kv, no_speech, feats, key_start = _encode_and_prefill(
        model, mel.to(dev), initial_tokens, sample_begin, sot_idx, beam, cfg,
        no_speech_id, key_start, kernels, quantize_kv, encoder_fn,
    )
    B = tokens.shape[0]
    n_audio = B // beam
    own = torch.arange(B, dtype=torch.int32, device=dev) % beam  # each row's own beam

    # only beam 0 of each audio is live at the first step, so the identical
    # prefixes of the others never enter the top candidates
    s = _BeamState(
        tokens=tokens,
        sum_logprobs=torch.where(
            own == 0, torch.zeros((), device=dev), torch.full((), BIG_NEG, device=dev)
        ),
        fin_tokens=torch.zeros((n_audio, cap + 1, n_ctx), dtype=torch.long, device=dev),
        fin_scores=torch.full((n_audio, cap + 1), BIG_NEG, dtype=torch.float32, device=dev),
        fin_count=torch.zeros((n_audio,), dtype=torch.long, device=dev),
        anc=own[:, None].expand(B, n_ctx).contiguous(),
    )
    # the first step takes the prefill logits; the prefill wrote every row
    # itself, so each row's own beam is the right table for it
    s = _beam_step(logits, s, sample_begin, beam, cap, eot)

    step, pos = 1, sample_begin + 1
    for W in _phase_windows(n_ctx, initial_tokens.shape[1], sample_len):
        while step < sample_len and pos < W and not bool((s.fin_count >= cap).all()):
            # slot pos-1, written by this step, belongs to each row itself
            s.anc[:, pos - 1] = own
            logits = _step_logits(
                model, s.tokens, pos, cross_kv, cache, cfg, sample_begin, key_start,
                beam, W, kernels, ancestors=s.anc,
            )
            s = _beam_step(logits, s, pos, beam, cap, eot)
            step, pos = step + 1, pos + 1

    # finalize: each audio with fewer than ``beam`` finished sequences is
    # filled up from its live beams, best first, EOT-terminated
    write_pos = min(pos, n_ctx - 1)
    live_tokens = s.tokens.view(n_audio, beam, n_ctx).clone()
    live_tokens[:, :, write_pos] = eot
    live_scores, order = _sort_desc(s.sum_logprobs.view(n_audio, beam))
    live_tokens = live_tokens.gather(1, order[:, :, None].expand(n_audio, beam, n_ctx))
    slot = s.fin_count[:, None] + torch.arange(beam, device=dev)
    slot = torch.where(slot < beam, slot, cap)
    s.fin_tokens.scatter_(1, slot[:, :, None].expand(n_audio, beam, n_ctx), live_tokens)
    s.fin_scores.scatter_(1, slot, live_scores)
    return DecodeResult(
        candidates=s.fin_tokens[:, :cap],
        scores=s.fin_scores[:, :cap],
        no_speech_probs=no_speech,
        audio_features=feats,
        steps=step - 1,
    )
