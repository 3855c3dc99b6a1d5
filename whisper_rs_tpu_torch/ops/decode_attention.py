"""Decode-step attention kernels and their plain versions (counterpart of
``whisper_rs_tpu/ops/decode_attention.py``).

``self_attention_append_step`` (``csrc/self_attention.cu``): one greedy
step's self-attention.  It writes this step's K/V column into the ctx-major
cache ``[L, B, H, n_ctx, dh]`` at slot ``pos`` of layer ``layer``, in place,
then attends slots ``key_start[b] <= j <= pos`` of the first ``window``.
Math, as in the Pallas kernel: f32 scores of the pre-scaled q, masked slots
at the finite NEG, ``w = e / sum(e)`` kept in f32 (never rounded to the
cache dtype), ``w V`` accumulated in f32 and cast to the query dtype.

The kernel takes a running max and sum (an online softmax), adds ``e V``
and divides by ``sum(e)`` once: the same function, rounded apart from the
plain version within the tolerance it is held to.  A block takes one (row,
head); its warps, from 2 to 8, are the plan of ``step_launch_plan``, which
keeps the grid in one wave and gives each lane group of the kernel enough
slots to read ahead (``StepPlan``).

``beam_self_attention_step`` (the same source, the same body): one beam
step's self-attention with the ancestors resolved at read time.  Rows are
beams of A audios in groups of G (``b = a G + g``); slot j of row b is read
from row ``a G + anc_local[b, j]``, and the visible slots are
``key_start[a G] <= j <= pos``, the key_start of the audio's first row, as
in the Pallas kernel.  The column write and the math are the append step's.
Over an int8 cache it only reads: the caller has written the quantised
column and its scales (``models.whisper.KVCache.write``), and the scales of
slot j come from the same row as its K/V, the ancestor's.

``self_attention_step`` (the same source, the same body): the greedy step
over a cache whose slot ``pos`` the caller has written, read only.  The
cache is int8 with f32 per-position scales ``[L, B, H, n_ctx]``, or in the
query dtype without them.  Int8 math, as in the Pallas kernel: the f32 dot
of q with the int8 K row times ``k_scale`` before the mask, ``w = e /
sum(e)`` in f32, ``w * v_scale`` kept in f32, the f32 sum of ``w V``.  Over
an int8 cache it can also take this step's ``k_new``/``v_new``: each block
quantises its own (row, head)'s column (``quantize_kv``) and writes it and
its scales at slot ``pos``, then reads, as XLA quantises and writes the
column around the TPU kernel; no torch launch is left for the column.

``self_attention_fused_step`` (the same source, the same body): the append
step with the write left out.  The caller has written this step's K/V
column at slot ``pos`` already (as XLA does before the TPU kernel); the
kernel reads slots ``key_start[b] <= j <= pos`` and writes only its
output.  Its math is the append step's.

Every step kernel launches at the plan of ``step_launch_plan``, taken at
the call's window: the plan does not depend on the position.

The step kernels (rows 7, 9, 10 and 11) read the step's slot ``pos`` from
device memory: their wrappers and plain versions take it as a 0-d int64
tensor on q's device (a Python int is made into one), so that a decode
step captured as a CUDA graph reads the position of its replay.  A ``pos``
outside ``[0, window)`` is no step: the kernel and the plain version write
nothing into the cache and return zeros (the decode loop passes -1 for a
step that its termination test has turned off).

Each kernel has its predicate: ``step_kernel_takes`` for the four step
self-attention kernels (head dim 16 or 64, the instances of the CUDA
bodies) and ``cross_kernel_takes`` for the cross kernel (head dim 16 or 64,
Tk % 4 = 0, any G).  A call on the card that they refuse raises.

``cross_attention_step`` (``csrc/cross_attention.cu``): G query rows per
audio share one encoder K/V, read from the fused layout
``kv [L, A, H, 2, dh, Tk]`` (K^T and V^T planes, see ``models.whisper.
CrossKV``) at layer ``layer``.  Math, as in the Pallas kernel: f32 scores,
no mask, ``w = e / sum(e)`` in f32, ``w`` cast to the K/V dtype, then
``w V`` accumulated in f32 and cast to the query dtype.  With int8 K/V and
f32 scales ``[L, A, H, Tk]``: the scores times ``k_scale``, and ``w *
v_scale`` kept in f32 in place of the cast.  The kernel splits the keys
of each (head, audio, chunk of 8 rows) over the blocks of one thread-block
cluster; ``cross_launch_plan`` says how many.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import count_launch, use_kernel
from .build import I, P, check, kernel_function

HEAD_DIMS = (16, 64)  # the head dims the CUDA step and cross kernels are built for
NEG = -1e9  # finite mask value, as in the Pallas kernels


def step_kernel_takes(head_dim: int) -> bool:
    """Whether the step self-attention kernels (the append, beam, read-only
    and fused steps) take this head dim: 16 or 64."""
    return head_dim in HEAD_DIMS


def cross_kernel_takes(head_dim: int, Tk: int) -> bool:
    """Whether the cross kernel takes this head dim (16 or 64) and encoder
    length (a multiple of 4); it takes any number of rows an audio."""
    return head_dim in HEAD_DIMS and Tk % 4 == 0


def step_pos(pos, device) -> torch.Tensor:
    """The step's slot as the step kernels read it: a 0-d int64 tensor on
    ``device`` (an int is made into one by a fill on the device, not copied
    from the host; a tensor is checked and returned as it is)."""
    if not torch.is_tensor(pos):
        return torch.full((), int(pos), dtype=torch.int64, device=device)
    if pos.dtype != torch.int64 or pos.dim() != 0 or pos.device != torch.device(device):
        raise ValueError(f"pos must be a 0-d int64 tensor on {device}, not {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos


def _check_append_args(name, q, k_all, layer: int, pos, window: int) -> torch.Tensor:
    """The step's shapes and its slot; returns ``pos`` as ``step_pos``
    gives it.  An int pos must lie in [0, window); a tensor's value is the
    kernel's to check (outside [0, window): no step)."""
    L, B, H, n_ctx, dh = k_all.shape
    if q.shape != (B, H, dh):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache {tuple(k_all.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if not 1 <= window <= n_ctx:
        raise ValueError(f"{name}: needs 1 <= window ({window}) <= n_ctx ({n_ctx})")
    if not torch.is_tensor(pos) and not 0 <= pos < window:
        raise ValueError(f"{name}: needs 0 <= pos ({pos}) < window ({window})")
    return step_pos(pos, q.device)


def write_column(plane: torch.Tensor, layer: int, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``plane[layer, :, :, pos] = new`` in place, for a 0-d int64 ``pos``
    on the device, without reading its value on the host: an
    ``index_copy_`` at the slot clamped into the plane, of ``new`` where
    ``pos`` lies in [0, n_ctx) and of the slot's own values where it does
    not (no write).  ``plane`` [L, B, H, n_ctx(, dh)], ``new`` [B, H(, dh)]."""
    n_ctx = plane.shape[3]
    at = plane[layer]
    slot = pos.clamp(0, n_ctx - 1).view(1)
    old = at.index_select(2, slot)
    inside = (pos >= 0) & (pos < n_ctx)
    at.index_copy_(2, slot, torch.where(inside, new.unsqueeze(2).to(plane.dtype), old))


def _no_step(out: torch.Tensor, pos: torch.Tensor, window: int) -> torch.Tensor:
    """``out`` where ``pos`` lies in [0, window), else zeros: the plain
    versions' no step, as the kernels give it."""
    inside = (pos >= 0) & (pos < window)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _check_scales(name, q, planes, k_scale, v_scale, shape) -> bool:
    """Whether ``planes`` are int8 with their f32 per-position scales of
    ``shape``: both scales or neither, contiguous and on q's device;
    int8 planes need them, and planes in another dtype take none."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 K/V needs both k_scale and v_scale, or neither")
    int8 = [t.dtype == torch.int8 for t in planes]
    if k_scale is None:
        if any(int8):
            raise ValueError(f"{name}: int8 K/V needs its k_scale and v_scale")
        return False
    if not all(int8):
        raise ValueError(f"{name}: k_scale/v_scale go with int8 K/V, not {planes[0].dtype}")
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or tuple(s.shape) != tuple(shape):
            raise ValueError(f"{name}: int8 scales must be f32 {tuple(shape)}, not "
                             f"{s.dtype} {tuple(s.shape)}")
        if s.device != q.device or not s.is_contiguous():
            raise ValueError(f"{name}: int8 scales must be contiguous, on q's device")
    return True


def _check_new(name, scaled: bool, k_new, v_new) -> bool:
    """Whether a read-only step's caller passes this step's column: both of
    ``k_new``/``v_new`` or neither, and only over an int8 cache (a cache in
    q's dtype takes its column through the append step)."""
    if (k_new is None) != (v_new is None):
        raise ValueError(f"{name}: k_new and v_new go together")
    if k_new is not None and not scaled:
        raise ValueError(f"{name}: k_new/v_new go with an int8 cache; a cache in q's dtype takes "
                         "self_attention_append_step")
    return k_new is not None


def quantize_kv(x: torch.Tensor):
    """[..., dh] -> (int8 values [..., dh], f32 scale [...]), one symmetric
    scale a position, in f32 whatever x's dtype (the JAX ``_quantize_kv``,
    whose scale keeps a trailing 1): ``s = max(amax |x|, 1e-8) / 127`` and
    ``clip(round(x / s), -127, 127)``, rounded half to even as
    ``jnp.round``.  Row by row it is also the weights' per-output-channel
    quantisation (``models.quantize``).  On the card torch divides by the
    constant 127 as a multiply by its f32 reciprocal, as XLA does under
    ``jit`` (on the CPU both divide), so the scale's last bit can differ
    between the two devices; row 10's column write computes it as torch does
    on the card."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    return torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


def _check_kernel_tensors(name, q, k_new, v_new, k_all, v_all, key_start, *extra):
    """What the CUDA step kernels take: q, k_new, v_new (None
    for the read-only steps) f32 or bf16 alike; the caches in q's dtype or
    int8; key_start int64 [B]; every tensor contiguous, 16-byte aligned and
    on q's device."""
    new = tuple(t for t in (k_new, v_new) if t is not None)
    if k_all.shape[-1] != q.shape[-1] or any(t.shape != q.shape for t in new):
        raise ValueError(f"{name}: q, k_new, v_new must be [B, H, dh] alike, the caches' dh")
    if v_all.shape != k_all.shape:
        raise ValueError(f"{name}: k_all {tuple(k_all.shape)} vs v_all {tuple(v_all.shape)}")
    cache_dtype = torch.int8 if k_all.dtype == torch.int8 else q.dtype
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != q.dtype for t in new)
            or any(t.dtype != cache_dtype for t in (k_all, v_all))):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in (q, *new, k_all, v_all)]}")
    B = k_all.shape[1]
    if key_start is not None and (key_start.dtype != torch.int64 or key_start.shape != (B,)):
        raise ValueError(f"{name}: key_start must be int64 [{B}]")
    for t in (q, *new, k_all, v_all) + extra + (() if key_start is None else (key_start,)):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned")


def _write_slot(pos: torch.Tensor, window: int) -> torch.Tensor:
    """The slot a step writes: ``pos``, or -1 (none) outside [0, window)."""
    return torch.where((pos >= 0) & (pos < window), pos, torch.full_like(pos, -1))


def _attend_window(q, k, v, pos, key_start, k_scale=None, v_scale=None) -> torch.Tensor:
    """q [B, H, dh] pre-scaled against the window's rows k, v [B, H, W, dh]
    (int8 with per-position scales [B, H, W], or not): f32 scores (times
    k_scale), slots ``key_start[b] <= j <= pos`` visible, ``w = e / sum(e)``
    in f32 (times v_scale), the f32 sum of ``w V`` cast to q's dtype."""
    s = torch.einsum("bhd,bhwd->bhw", q.float(), k.float())
    if k_scale is not None:
        s = s * k_scale
    ids = torch.arange(k.shape[2], device=q.device)
    visible = ids[None, :] <= pos
    if key_start is not None:
        visible = visible & (ids[None, :] >= key_start[:, None])
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        w = w * v_scale
    return torch.einsum("bhw,bhwd->bhd", w, v.float()).to(q.dtype)


def self_attention_step_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int, pos,
    key_start=None, *, window: int, k_scale=None, v_scale=None, k_new=None, v_new=None,
) -> torch.Tensor:
    """Plain version: the attention output [B, H, dh] of the pre-scaled q
    over slots ``key_start[b] <= j <= pos`` of ``k_all``/``v_all``
    [L, B, H, n_ctx, dh] at ``layer`` (int8 with ``k_scale``/``v_scale``
    [L, B, H, n_ctx] f32, or in q's dtype).  With ``k_new``/``v_new``
    [B, H, dh] (q's dtype; int8 cache only) this step's column is first
    quantised (``quantize_kv``) and written with its scales at slot ``pos``
    in place; without them the caches are only read."""
    name = "self_attention_step"
    at = _check_append_args(name, q, k_all, layer, pos, window)
    scaled = _check_scales(name, q, (k_all, v_all), k_scale, v_scale, k_all.shape[:-1])
    if _check_new(name, scaled, k_new, v_new):
        for new, plane, scale in ((k_new, k_all, k_scale), (v_new, v_all, v_scale)):
            values, s = quantize_kv(new)
            write_column(plane, layer, _write_slot(at, window), values)
            write_column(scale, layer, _write_slot(at, window), s)
    ks, vs = ((s[layer, :, :, :window] for s in (k_scale, v_scale)) if scaled else (None, None))
    return _no_step(_attend_window(q, k_all[layer, :, :, :window], v_all[layer, :, :, :window],
                                   at, key_start, ks, vs), at, window)


def self_attention_fused_step_plain(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int, pos,
    key_start=None, *, window: int,
) -> torch.Tensor:
    """Plain version: the attention output [B, H, dh] of the pre-scaled q
    over slots ``key_start[b] <= j <= pos`` of ``k_all``/``v_all``
    [L, B, H, n_ctx, dh] at ``layer``; the caches are only read."""
    at = _check_append_args("self_attention_fused_step", q, k_all, layer, pos, window)
    return _no_step(_attend_window(q, k_all[layer, :, :, :window], v_all[layer, :, :, :window],
                                   at, key_start), at, window)


def self_attention_append_step_plain(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_all: torch.Tensor,
    v_all: torch.Tensor, layer: int, pos, key_start=None, *, window: int,
) -> torch.Tensor:
    """Plain version: writes ``k_new``/``v_new`` [B, H, dh] into slot ``pos``
    of ``k_all``/``v_all`` [L, B, H, n_ctx, dh] at ``layer`` in place;
    returns the attention output [B, H, dh] of the pre-scaled q."""
    at = _check_append_args("self_attention_append_step", q, k_all, layer, pos, window)
    write_column(k_all, layer, _write_slot(at, window), k_new)
    write_column(v_all, layer, _write_slot(at, window), v_new)
    return self_attention_fused_step_plain(q, k_all, v_all, layer, at, key_start, window=window)


def self_attention_append_step(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_all: torch.Tensor,
    v_all: torch.Tensor, layer: int, pos, key_start=None, *, window: int,
) -> torch.Tensor:
    """One greedy step's self-attention at ``layer``, with this step's K/V
    column written into the cache in place: the kernel on the card (head dim
    16 or 64, ``step_kernel_takes``; any other raises), the plain version
    on the CPU.  q, k_new, v_new [B, H, dh] (q pre-scaled); caches [L, B, H,
    n_ctx, dh]; ``key_start`` [B] int64 or None (zeros)."""
    name = "self_attention_append_step"
    if not use_kernel(name, step_kernel_takes(q.shape[-1]), q.device):
        return self_attention_append_step_plain(
            q, k_new, v_new, k_all, v_all, layer, pos, key_start, window=window
        )
    at = _check_append_args(name, q, k_all, layer, pos, window)
    if k_all.dtype == torch.int8:
        raise ValueError(f"{name}: an int8 cache takes self_attention_step")
    _check_kernel_tensors(name, q, k_new, v_new, k_all, v_all, key_start)
    L, B, H, n_ctx, dh = k_all.shape
    plan = step_launch_plan(B, H, int(window), int(window), dh, k_all.element_size())
    out = _window_launch("self_attention_append", plan, int(layer), at, int(window), q=q,
                         k_new=k_new, v_new=v_new, k_all=k_all, v_all=v_all,
                         key_start=key_start, out=torch.empty_like(q))
    count_launch("self_attention_append_step")
    return out


# The arguments of each step entry point of csrc/self_attention.cu before
# its sizes, in order: tensors (None for a null pointer), and the beam's
# group size
_STEP_ENTRY_ARGS = {
    "self_attention_append": ("q", "k_new", "v_new", "k_all", "v_all", "key_start", "out"),
    "self_attention_fused": ("q", "k_all", "v_all", "key_start", "out"),
    "self_attention_step": ("q", "k_new", "v_new", "k_all", "v_all", "k_scale", "v_scale",
                            "key_start", "out"),
    "beam_self_attention": ("q", "k_new", "v_new", "k_all", "v_all", "key_start", "anc_local",
                            "group", "out"),
    "beam_self_attention_int8": ("q", "k_all", "v_all", "k_scale", "v_scale", "key_start",
                                 "anc_local", "group", "out"),
}


def _window_launch(entry: str, plan: "StepPlan", layer: int, pos, window: int,
                   group: int = 1, **tensors) -> torch.Tensor:
    """Launches the step entry point ``entry`` (a key of _STEP_ENTRY_ARGS;
    q's dtype picks its instance) at ``plan`` on tensors that the wrappers
    have checked, with the step's slot ``pos`` (``step_pos``: the kernel
    reads it from device memory), writing ``tensors["out"]``, which it
    returns; raises if the launch fails."""
    q, out = tensors["q"], tensors["out"]
    L, B, H, n_ctx, dh = tensors["k_all"].shape
    at = step_pos(pos, q.device)
    symbol = f"{entry}_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}"
    names = _STEP_ENTRY_ARGS[entry]
    args = [group if k == "group" else None if tensors.get(k) is None else tensors[k].data_ptr()
            for k in names]
    types = tuple(I if k == "group" else P for k in names) + (I,) * 4 + (P,) + (I,) * 3 + (P,)
    fn = kernel_function("self_attention", symbol, types)
    check("self_attention", symbol,
          fn(*args, B, H, n_ctx, layer, at.data_ptr(), window, dh, plan.threads,
             torch.cuda.current_stream(q.device).cuda_stream))
    return out


def self_attention_fused_step(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int, pos,
    key_start=None, *, window: int,
) -> torch.Tensor:
    """One greedy step's self-attention at ``layer`` over a cache whose slot
    ``pos`` the caller has written: the kernel on the card (head dim 16 or
    64, ``step_kernel_takes``), the plain version on the CPU.  q [B, H, dh]
    pre-scaled; caches [L, B, H, n_ctx, dh], read only; ``key_start`` [B]
    int64 or None (zeros)."""
    name = "self_attention_fused_step"
    if not use_kernel(name, step_kernel_takes(q.shape[-1]), q.device):
        return self_attention_fused_step_plain(q, k_all, v_all, layer, pos, key_start,
                                               window=window)
    at = _check_append_args(name, q, k_all, layer, pos, window)
    if k_all.dtype == torch.int8:
        raise ValueError(f"{name}: an int8 cache takes self_attention_step")
    _check_kernel_tensors(name, q, None, None, k_all, v_all, key_start)
    L, B, H, n_ctx, dh = k_all.shape
    plan = step_launch_plan(B, H, int(window), int(window), dh, k_all.element_size())
    out = _window_launch("self_attention_fused", plan, int(layer), at, int(window), q=q,
                         k_all=k_all, v_all=v_all, key_start=key_start, out=torch.empty_like(q))
    count_launch("self_attention_fused_step")
    return out


def self_attention_step(
    q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, layer: int, pos,
    key_start=None, *, window: int, k_scale=None, v_scale=None, k_new=None, v_new=None,
) -> torch.Tensor:
    """One greedy step's self-attention at ``layer``: the kernel on the card
    (head dim 16 or 64, ``step_kernel_takes``), the plain version on the
    CPU.  q [B, H, dh] pre-scaled; caches [L, B, H, n_ctx, dh], int8 with
    ``k_scale``/``v_scale`` [L, B, H, n_ctx] f32, or in q's dtype without
    them; ``key_start`` [B] int64 or None (zeros).  Over an int8 cache
    ``k_new``/``v_new`` [B, H, dh] in q's dtype, if given, are quantised and
    written with their scales at slot ``pos`` in place before the read;
    without them the caller has written slot ``pos``, and the caches are
    only read."""
    name = "self_attention_step"
    if not use_kernel(name, step_kernel_takes(q.shape[-1]), q.device):
        return self_attention_step_plain(q, k_all, v_all, layer, pos, key_start, window=window,
                                         k_scale=k_scale, v_scale=v_scale, k_new=k_new,
                                         v_new=v_new)
    at = _check_append_args(name, q, k_all, layer, pos, window)
    scaled = _check_scales(name, q, (k_all, v_all), k_scale, v_scale, k_all.shape[:-1])
    _check_new(name, scaled, k_new, v_new)
    scales = (k_scale, v_scale) if scaled else ()
    _check_kernel_tensors(name, q, k_new, v_new, k_all, v_all, key_start, *scales)
    L, B, H, n_ctx, dh = k_all.shape
    plan = step_launch_plan(B, H, int(window), int(window), dh, k_all.element_size())
    out = _window_launch("self_attention_step", plan, int(layer), at, int(window), q=q,
                         k_new=k_new, v_new=v_new, k_all=k_all, v_all=v_all,
                         k_scale=k_scale if scaled else None, v_scale=v_scale,
                         key_start=key_start, out=torch.empty_like(q))
    count_launch("self_attention_step")
    return out


def _check_beam_args(name, q, k_new, v_new, k_all, v_all, layer, pos, window, key_start,
                     anc_local, group, k_scale, v_scale) -> bool:
    """The beam step's arguments; returns whether the caches are int8 (then
    the step only reads, and k_new/v_new must be None), and the slot
    (``step_pos``)."""
    at = _check_append_args(name, q, k_all, layer, pos, window)
    L, B, H, n_ctx, dh = k_all.shape
    if group < 1 or B % group:
        raise ValueError(f"{name}: {B} rows are not groups of {group}")
    if anc_local.shape != (B, n_ctx):
        raise ValueError(f"{name}: anc_local {tuple(anc_local.shape)}, want ({B}, {n_ctx})")
    if key_start is not None and key_start.shape != (B,):
        raise ValueError(f"{name}: key_start {tuple(key_start.shape)}, want ({B},)")
    scaled = _check_scales(name, q, (k_all, v_all), k_scale, v_scale, k_all.shape[:-1])
    if scaled != (k_new is None and v_new is None):
        raise ValueError(f"{name}: an int8 cache is written by the caller (k_new and v_new "
                         "None); any other takes k_new and v_new")
    return scaled, at


def beam_self_attention_step_plain(
    q: torch.Tensor, k_new, v_new, k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
    pos, key_start, anc_local: torch.Tensor, group: int, *, window: int, k_scale=None,
    v_scale=None,
) -> torch.Tensor:
    """Plain version: writes ``k_new``/``v_new`` [B, H, dh] into slot ``pos``
    of ``k_all``/``v_all`` [L, B, H, n_ctx, dh] at ``layer`` in place (an
    int8 cache, with ``k_scale``/``v_scale`` [L, B, H, n_ctx], is only read:
    k_new and v_new None), then attends with slot j of row ``b = a G + g``
    and its scales taken from row ``a G + anc_local[b, j]``; returns
    [B, H, dh]."""
    scaled, at = _check_beam_args("beam_self_attention_step", q, k_new, v_new, k_all, v_all,
                                  layer, pos, window, key_start, anc_local, group, k_scale,
                                  v_scale)
    B = q.shape[0]
    if not scaled:
        write_column(k_all, layer, _write_slot(at, window), k_new)
        write_column(v_all, layer, _write_slot(at, window), v_new)
    first = torch.arange(B, device=q.device) // group * group  # each audio's first row
    ids = torch.arange(window, device=q.device)
    src = first[:, None] + anc_local[:, :window].long()  # [B, W] physical rows

    def gather(t):  # [L, B, H, n_ctx, ...] at layer -> [B, H, W, ...] via the ancestors
        return t[layer][src, :, ids].transpose(1, 2)

    ks, vs = (gather(k_scale), gather(v_scale)) if scaled else (None, None)
    return _no_step(_attend_window(q, gather(k_all), gather(v_all), at,
                                   None if key_start is None else key_start[first], ks, vs),
                    at, window)


def beam_self_attention_step(
    q: torch.Tensor, k_new, v_new, k_all: torch.Tensor, v_all: torch.Tensor, layer: int,
    pos, key_start, anc_local: torch.Tensor, group: int, *, window: int, k_scale=None,
    v_scale=None,
) -> torch.Tensor:
    """One beam step's self-attention at ``layer``, with this step's K/V column
    written into the cache in place: the kernel on the card (head dim 16 or
    64, ``step_kernel_takes``), the plain version on the CPU.  q, k_new,
    v_new [B, H, dh] (q pre-scaled); caches [L, B, H, n_ctx, dh]; ``key_start`` [B] int64
    or None (zeros); ``anc_local`` [B, n_ctx] int32 beam-local ancestors in
    [0, group), with ``anc_local[b, pos] == b % group`` (the row's own fresh
    column).  An int8 cache with ``k_scale``/``v_scale`` [L, B, H, n_ctx]
    f32 is read only: the caller has written slot ``pos`` and its scales,
    and passes k_new and v_new as None."""
    name = "beam_self_attention_step"
    if not use_kernel(name, step_kernel_takes(q.shape[-1]), q.device):
        return beam_self_attention_step_plain(
            q, k_new, v_new, k_all, v_all, layer, pos, key_start, anc_local, group,
            window=window, k_scale=k_scale, v_scale=v_scale,
        )
    scaled, at = _check_beam_args(name, q, k_new, v_new, k_all, v_all, layer, pos, window,
                                  key_start, anc_local, group, k_scale, v_scale)
    scales = (k_scale, v_scale) if scaled else ()
    _check_kernel_tensors(name, q, k_new, v_new, k_all, v_all, key_start, anc_local, *scales)
    if anc_local.dtype != torch.int32:
        raise ValueError(f"{name}: anc_local must be int32")
    L, B, H, n_ctx, dh = k_all.shape
    plan = step_launch_plan(B, H, int(window), int(window), dh, k_all.element_size(),
                            beam=True)
    out = _window_launch("beam_self_attention_int8" if scaled else "beam_self_attention", plan,
                         int(layer), at, int(window), int(group), q=q, k_new=k_new,
                         v_new=v_new, k_all=k_all, v_all=v_all, k_scale=k_scale,
                         v_scale=v_scale, key_start=key_start, anc_local=anc_local,
                         out=torch.empty_like(q))
    count_launch("beam_self_attention_step")
    return out


# The cross kernel's tiling (csrc/cross_attention.cu): a block takes up to
# CROSS_ROWS rows of one audio and head and one split of the keys, and
# streams the split's K^T, then V^T, in tiles of rows of the split through
# a ring of CROSS_STAGES tiles (fewer where the split has fewer tiles or
# shared memory is short; the kernel takes up to CROSS_MAX_STAGES).  A tile
# holds as many rows (a multiple of 8 that divides the head dim) as fit
# CROSS_TILE_BYTES, CROSS_TILE_BYTES_FEW where the grid has at most one
# block a SM, or CROSS_TILE_BYTES_MANY where it has more than two, which
# keeps more blocks on each SM; unsplit, up to CROSS_WHOLE_ROWS rows in
# CROSS_TILE_BYTES_FEW.  The splits of a (head, audio, chunk of
# rows) are the blocks of one cluster, at most CROSS_MAX_SPLITS (the
# portable cluster size).  Keys are split only where the heads alone give
# fewer than CROSS_BLOCKS_AIM blocks (one a SM) and a head's K/V passes
# CROSS_SPLIT_BYTES, into as few splits as reach the aim, none under
# CROSS_MIN_KEYS keys: unsplit, a tile is one bulk copy, split, one a row,
# and each copy costs the copy engine about the same whatever its size.
# All of it measured on the H100 at the path shapes (`chip_study.py plans`,
# PERF.md): a deeper ring or bigger tiles only cost blocks a SM, and a
# second wave of blocks cost more than the splits' exchange gained.
CROSS_ROWS = 8
CROSS_TILE_BYTES = 26 * 1024
CROSS_TILE_BYTES_FEW = 48 * 1024
CROSS_TILE_BYTES_MANY = 12 * 1024
CROSS_STAGES = 3
CROSS_MAX_STAGES = 8
CROSS_MAX_SPLITS = 8
SMS = 132  # the H100's streaming multiprocessors
CROSS_BLOCKS_AIM = SMS
CROSS_SPLIT_BYTES = 128 * 1024
CROSS_WHOLE_ROWS = 16
CROSS_MIN_KEYS = 128
SMEM_LIMIT = 227 * 1024  # shared memory a block can have on the H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class CrossPlan(NamedTuple):
    """How the cross kernel launches: ``splits`` blocks (one cluster) a
    (head, audio, chunk of rows), split s taking keys [s chunk, min(Tk,
    (s + 1) chunk)); ``chunk`` is a multiple of 4 and no split is empty;
    tiles of ``rows`` rows of K^T or V^T through a ring of ``stages``;
    ``smem`` bytes of shared memory a block."""
    splits: int
    chunk: int
    rows: int
    stages: int
    smem: int
    Tk: int

    def bounds(self) -> list:
        return [(s * self.chunk, min(self.Tk, (s + 1) * self.chunk)) for s in range(self.splits)]


def _row_pitch(chunk: int, itemsize: int) -> int:
    """Bytes of a tile row: the split's keys and room for the 16-byte
    aligned superset of them that is copied."""
    return _cdiv(chunk * itemsize, 16) * 16 + 16


def _cross_smem(head_dim: int, itemsize: int, G: int, chunk: int, rows: int,
                stages: int) -> int:
    """Shared memory of one block: the ring, the scores of its rows' split,
    and its static arrays (q, the reductions, the statistics, the partial
    output, the ring's barriers)."""
    gm = CROSS_ROWS if G > 4 else (1 if G == 1 else (2 if G == 2 else 4))
    static = 4 * gm * (2 * head_dim + 8 + 4)
    return (stages * rows * _row_pitch(chunk, itemsize) + min(G, CROSS_ROWS) * chunk * 4 + static
            + 8 * CROSS_MAX_STAGES)


def cross_launch_plan(A: int, G: int, H: int, Tk: int, head_dim: int = 64,
                      itemsize: int = 2) -> CrossPlan:
    """The cross kernel's plan for A audios of G rows, H heads, Tk keys
    (a multiple of 4) of ``itemsize`` bytes at ``head_dim``."""
    blocks = H * A * _cdiv(G, CROSS_ROWS)
    most = max(1, min(CROSS_MAX_SPLITS, Tk // CROSS_MIN_KEYS))
    splits = 1
    if blocks < CROSS_BLOCKS_AIM and 2 * head_dim * Tk * itemsize > CROSS_SPLIT_BYTES:
        splits = min(most, _cdiv(CROSS_BLOCKS_AIM, blocks))
    chunk = 4 * _cdiv(Tk // 4, splits)
    pitch = _row_pitch(chunk, itemsize)
    grid = blocks * _cdiv(Tk, chunk)
    whole = chunk >= Tk  # one split: a tile is one bulk copy
    tile = (CROSS_TILE_BYTES_FEW if whole or grid <= SMS else
            CROSS_TILE_BYTES if grid <= 2 * SMS else CROSS_TILE_BYTES_MANY)
    rows = max([r for r in range(8, (CROSS_WHOLE_ROWS if whole else head_dim) + 1, 8)
                if head_dim % r == 0 and r * pitch <= tile] or [8])
    stages = min(CROSS_STAGES, 2 * head_dim // rows)
    while stages > 2 and _cross_smem(head_dim, itemsize, G, chunk, rows, stages) > SMEM_LIMIT:
        stages -= 1
    return CrossPlan(_cdiv(Tk, chunk), chunk, rows, stages,
                     _cross_smem(head_dim, itemsize, G, chunk, rows, stages), Tk)


# The step kernels' plan (csrc/self_attention.cu, attend_window): a block
# takes one (row, head).  A key row is read by `lanes` lanes (16
# bytes each, int8 8), a lane group; lane group g of the block's takes the
# visible slots lo + g, lo + g + groups, ..., in batches of STEP_UNROLL,
# each read two batches ahead of its scores.  A block has as many warps,
# a power of two from STEP_MIN_WARPS to STEP_MAX_WARPS, as keep the grid
# within STEP_WARPS_PER_SM warps an SM (one wave at the kernels'
# registers) and give each lane group STEP_GROUP_ROWS slots or more, a
# batch.  All of it measured on the H100 at the path shapes (`chip_study.py
# step`, PERF.md): where the blocks are many, 2 warps a block beat 4 and 8
# by keeping the grid in one wave; at the golden dims 4 beat 2; splitting
# the slots of a (row, head) over a cluster was never faster.
STEP_UNROLL = 4
STEP_MIN_WARPS = 2
STEP_MAX_WARPS = 8
STEP_WARPS_PER_SM = 16
STEP_GROUP_ROWS = STEP_UNROLL


def step_lanes(head_dim: int, itemsize: int) -> int:
    """Lanes that read one key row of the step kernels: 16 bytes each (int8:
    8)."""
    return head_dim * itemsize // (8 if itemsize == 1 else 16)


class StepPlan(NamedTuple):
    """How a step kernel launches: a block of ``threads`` a (row, head),
    with ``smem`` bytes of shared memory."""
    threads: int
    smem: int

    def group_slots(self, lo: int, hi: int, lanes: int) -> list:
        """The slots of lo..hi each lane group reads (a key row ``lanes``
        lanes), in the kernel's order."""
        groups = self.threads // lanes
        return [list(range(lo + g, hi + 1, groups)) for g in range(groups)]


def step_launch_plan(B: int, H: int, n: int, window: int, head_dim: int = 64,
                     itemsize: int = 2, beam: bool = False) -> StepPlan:
    """A step kernel's plan (the beam kernel's with ``beam``) for B rows, H
    heads and ``n`` visible slots of a ``window``, at ``head_dim`` over a
    cache of ``itemsize`` bytes: the warps of a block, and its shared
    memory (the beam row's ancestors over the window, and the warps'
    partials).  The wrappers take it at ``n = window``, the most slots the
    window holds, so that the plan does not depend on the step's position
    (which the kernel reads from device memory); ``n = pos + 1`` gives the
    plan that a call at ``pos`` took while the position was passed by
    value."""
    warps = min(STEP_MAX_WARPS, STEP_WARPS_PER_SM * SMS // (B * H),
                step_lanes(head_dim, itemsize) * n // (32 * STEP_GROUP_ROWS))
    warps = 1 << (max(warps, STEP_MIN_WARPS).bit_length() - 1)
    smem = (4 * window if beam else 0) + 4 * STEP_MAX_WARPS * (head_dim + 2)
    return StepPlan(32 * warps, smem)


def cross_kernel_smem(plan: CrossPlan, G: int, head_dim: int, itemsize: int) -> int:
    """The shared memory a block takes at ``plan`` as the built kernel
    counts it, its static arrays included (-1 for an instance that is not
    built); ``plan.smem`` is held to it on the card."""
    fn = kernel_function("cross_attention", "cross_smem_bytes", (I,) * 6)
    return fn(head_dim, itemsize, G, plan.chunk, plan.rows, plan.stages)


def _cross_scales(name, q, kv_all, k_scale, v_scale) -> bool:
    L, A, H, _, _, Tk = kv_all.shape
    return _check_scales(name, q, (kv_all,), k_scale, v_scale, (L, A, H, Tk))


def cross_attention_step_plain(
    q: torch.Tensor, kv_all: torch.Tensor, layer: int, *, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Plain version: q [A, G, H, dh] (pre-scaled) -> [A, G, H, dh]; int8
    ``kv_all`` takes f32 ``k_scale``/``v_scale`` [L, A, H, Tk]."""
    scaled = _cross_scales("cross_attention_step", q, kv_all, k_scale, v_scale)
    k_t = kv_all[layer, :, :, 0].float()  # [A, H, dh, Tk]
    v_t = kv_all[layer, :, :, 1].float()
    qk = torch.einsum("aghd,ahdk->aghk", q.float(), k_t)
    if scaled:
        qk = qk * k_scale[layer][:, None]
    e = torch.exp(qk - qk.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    # int8: the V scale joins the f32 weights; else the weights are rounded
    # to the K/V dtype, as in the Pallas kernel
    w = w * v_scale[layer][:, None] if scaled else w.to(kv_all.dtype).float()
    return torch.einsum("aghk,ahdk->aghd", w, v_t).to(q.dtype)


def _cross_launch(q, kv_all, out, layer: int, plan: CrossPlan, k_scale=None, v_scale=None):
    """Launches the cross kernel at ``plan`` on tensors that
    ``cross_attention_step`` has checked (int8 ``kv_all`` with its
    scales), writing ``out``; raises if the launch fails."""
    A, G, H, dh = q.shape
    Tk = kv_all.shape[-1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
    ints = (A, G, H, Tk, layer, dh, plan.splits, plan.chunk, plan.rows, plan.stages)
    if k_scale is not None:
        symbol = f"cross_attention_int8_{tag}"
        ptrs = (q, kv_all, k_scale, v_scale, out)
    else:
        symbol = f"cross_attention_{tag}"
        ptrs = (q, kv_all, out)
    fn = kernel_function("cross_attention", symbol, (P,) * len(ptrs) + (I,) * len(ints) + (P,))
    check("cross_attention", symbol, fn(*(t.data_ptr() for t in ptrs), *ints, stream))
    return out


def cross_attention_step(
    q: torch.Tensor, kv_all: torch.Tensor, layer: int, *, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Cross-attention for one decode step at ``layer``: the kernel on the
    card (``cross_kernel_takes``: head dim 16 or 64, any G; any other shape
    raises) at ``cross_launch_plan``'s plan, the plain version on the CPU.
    q [A, G, H, dh] pre-scaled; ``kv_all`` [L, A, H, 2, dh, Tk] in q's
    dtype, or int8 with f32 ``k_scale``/``v_scale`` [L, A, H, Tk]."""
    name = "cross_attention_step"
    if not use_kernel(name, cross_kernel_takes(kv_all.shape[-2], kv_all.shape[-1]), q.device):
        return cross_attention_step_plain(q, kv_all, layer, k_scale=k_scale, v_scale=v_scale)
    A, G, H, dh = q.shape
    L, A2, H2, two, dh2, Tk = kv_all.shape
    if (A2, H2, two, dh2) != (A, H, 2, dh):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs kv {tuple(kv_all.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    if G < 1:
        raise ValueError(f"{name}: needs G >= 1, got {G}")
    scaled = _cross_scales(name, q, kv_all, k_scale, v_scale)
    if q.dtype not in (torch.float32, torch.bfloat16) or (
            kv_all.dtype != (torch.int8 if scaled else q.dtype)):
        raise ValueError(f"{name}: dtypes {q.dtype}, {kv_all.dtype}")
    if kv_all.device != q.device:
        raise ValueError(f"{name}: q and kv on different devices")
    for t in (q, kv_all, *((k_scale, v_scale) if scaled else ())):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, kv and scales must be contiguous, 16-byte aligned")
    out = _cross_launch(q, kv_all, out=torch.empty_like(q), layer=int(layer),
                        plan=cross_launch_plan(A, G, H, Tk, dh, kv_all.element_size()),
                        k_scale=k_scale if scaled else None, v_scale=v_scale)
    count_launch("cross_attention_step")
    return out
