"""Word-level timestamps from cross-attention DTW alignment (counterpart of
``whisper_rs_tpu/decode/align.py``, the algorithm of OpenAI's whisper
``timing.py``):

  1. one teacher-forced decoder pass over the window's final token
     sequence (its length bucketed to a multiple of 64, as the JAX package
     buckets it), keeping the pre-softmax cross-attention logits of the
     alignment heads in f32 (``_alignment_qk``): by default every head of
     the upper half of the decoder layers; ``alignment_heads`` names
     (layer, head) pairs instead;
  2. softmax over the window's real content frames, each head z-normalised
     over the token axis, median-filtered along time, and the heads
     averaged into one [text tokens, frames] matrix;
  3. dynamic time warping over the negated matrix gives the monotone
     token -> frame path; a token starts at its first frame (0.02 s each);
  4. BPE tokens merge into words at space boundaries (per complete unicode
     piece in scripts written without spaces), punctuation glued to the
     word before.

Under tensor parallelism each rank holds ``n_text_head / tp`` heads of a
layer, while ``alignment_heads`` names global (layer, head) pairs: the f32
cross logits of each named layer are gathered over the model group before
the heads are picked, so every rank aligns the same words.

The pass is the decoder's own prefill on the model's device: its attention
and MLP in ``torch.matmul`` (the JAX package computes them outside any
Pallas kernel), its LayerNorms through row 3's kernel (``ln_fused``) where
the aligner's ``kernels`` is on, as its task's are; the products of the
alignment logits in f32
(``preferred_element_type=f32`` in JAX: under bf16, q and k are upcast
before the product); the rest runs on the host in numpy on the
alignment heads' rows of the text tokens, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelDims
from ..models.whisper import KVCache, Whisper, precompute_cross_kv
from ..parallel.collectives import all_gather_model

TIME_PER_FRAME = 0.02  # seconds per encoder frame: 2 mel hops of 10 ms

# scripts written without spaces: split words per token
_NO_SPACE_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue"}

_PUNCT = set(",.!?;:、。！？；：，\"')]}%")


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float


def default_alignment_heads(dims: ModelDims) -> Tuple[Tuple[int, int], ...]:
    """All heads of the upper half of the decoder layers (OpenAI's
    fallback for checkpoints without an alignment-head mask)."""
    return tuple(
        (l, h)
        for l in range(dims.n_text_layer // 2, dims.n_text_layer)
        for h in range(dims.n_text_head)
    )


@torch.no_grad()
def _alignment_qk(
    model: Whisper,
    tokens: torch.Tensor,  # [T] int64 (padded to a bucket; the pads sit after
    #   every real position, so the causal mask keeps them out)
    xa: torch.Tensor,  # [Tk, n_audio_state] the window's encoder output
    heads: Tuple[Tuple[int, int], ...],
    kernels: bool = True,
) -> torch.Tensor:  # [n_heads, T, Tk] f32 pre-softmax cross-attention logits
    """One teacher-forced prefill of the decoder (a cache of T slots,
    unquantised cross K/V) that keeps each layer's cross logits, the heads
    of a tensor-parallel model gathered over its model group; ``kernels``
    picks its LayerNorms' route, as a decode's prefill does."""
    T = tokens.shape[0]
    cross_kv = precompute_cross_kv(model, xa[None].to(model.dtype))
    cache = KVCache.init(model.dims, 1, model.dtype, model.device, n_head=model.decoder.n_head)
    logits = {layer: None for layer, _ in heads}
    model.decoder(tokens[None], 0, cross_kv, cache, ctx_window=T, kernels=kernels,
                  logit_positions=torch.tensor([T - 1], device=tokens.device),
                  cross_logits=logits)
    logits = {layer: all_gather_model(qk, model.decoder.tp, dim=1) for layer, qk in logits.items()}
    return torch.stack([logits[layer][0, h] for layer, h in heads])


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with reflect padding (matches the
    OpenAI timing pipeline's medfilt_width=7 default)."""
    if width <= 1:
        return x
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path minimizing total cost over an [N, M] matrix
    (moves: down, right, diagonal).  Returns (rows, cols) along the path."""
    N, M = cost.shape
    big = np.inf
    acc = np.full((N + 1, M + 1), big, dtype=np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), dtype=np.int8)
    for i in range(1, N + 1):
        row = cost[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        # c0: diagonal (i-1, j-1), c1: up (i-1, j), c2: left (i, j-1)
        for j in range(1, M + 1):
            c0, c1, c2 = prev[j - 1], prev[j], cur[j - 1]
            if c0 <= c1 and c0 <= c2:
                cur[j] = c0 + row[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                cur[j] = c1 + row[j - 1]
                trace[i, j] = 1
            else:
                cur[j] = c2 + row[j - 1]
                trace[i, j] = 2
    i, j = N, M
    rows, cols = [], []
    while i > 0 and j > 0:
        rows.append(i - 1)
        cols.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(rows[::-1]), np.array(cols[::-1])


def _dtw_fast(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DTW with a vectorized row recurrence (O(N) numpy passes instead of
    an O(N*M) python loop).  Within a row,

        acc[i, j] = cost[j] + min(acc[i-1, j-1], acc[i-1, j], acc[i, j-1])

    and unrolling the serial left-move chain gives

        acc[i, j] = min_{k <= j} ( m[k] + sum_{t=k..j} cost[t] ),
        m[k] = min(acc[i-1, k-1], acc[i-1, k])

    which is a cumulative sum plus a running minimum.  The path is
    recovered by backtracking over the finished acc table (same tie order
    as the reference ``dtw``: diagonal, then up, then left — verified
    equivalent by the unit tests on random matrices)."""
    N, M = cost.shape
    acc = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    acc[0, 0] = 0.0
    for i in range(1, N + 1):
        row = cost[i - 1].astype(np.float64)
        m = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])  # [M]: min(diag, up)
        csum = np.cumsum(row)  # csum[j-1] = sum_{t<=j} cost[t-1]
        shifted = np.concatenate(([0.0], csum[:-1]))  # sum strictly before k
        best = np.minimum.accumulate(m - shifted)
        acc[i, 1:] = csum + best
    i, j = N, M
    rows, cols = [], []
    while i > 0 and j > 0:
        rows.append(i - 1)
        cols.append(j - 1)
        d, u, lft = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
        if d <= u and d <= lft:
            i, j = i - 1, j - 1
        elif u <= lft:
            i -= 1
        else:
            j -= 1
    return np.array(rows[::-1]), np.array(cols[::-1])


def _complete_unicode_pieces(
    token_ids: Sequence[int], decode_fn
) -> List[Tuple[str, List[int]]]:
    """Group BPE tokens into complete-unicode pieces by cumulative decoding.

    A token holding a partial UTF-8 sequence decodes to U+FFFD, not the
    empty string, so per-token decoding cannot detect fragment boundaries
    for CJK/emoji text.  Instead, decode a running token list and cut a
    piece only when its decode contains no U+FFFD — unless the U+FFFD is
    genuinely present in the full decode at that offset (i.e. the audio
    really transcribed a replacement char)."""
    REPL = "�"
    ids = [int(t) for t in token_ids]
    full = decode_fn(np.asarray(ids, np.int64)) if ids else ""
    pieces: List[Tuple[str, List[int]]] = []
    cur: List[int] = []
    offset = 0
    for tid in ids:
        cur.append(tid)
        dec = decode_fn(np.asarray(cur, np.int64))
        i = dec.find(REPL)
        if i < 0 or (offset + i < len(full) and full[offset + i] == REPL):
            pieces.append((dec, cur))
            cur = []
            offset += len(dec)
    if cur:  # trailing incomplete fragment (truncated window tail)
        pieces.append((decode_fn(np.asarray(cur, np.int64)), cur))
    return pieces


def split_words(
    token_ids: Sequence[int], decode_fn, language: Optional[str]
) -> List[Tuple[str, List[int]]]:
    """Group text tokens into words.  Space-delimited scripts start a new
    word at a leading-space piece; no-space scripts split per complete
    unicode piece; punctuation-only pieces attach to the preceding word.
    Multi-byte BPE fragments are first merged into complete unicode pieces
    via cumulative decoding (see ``_complete_unicode_pieces``)."""
    words: List[Tuple[str, List[int]]] = []
    no_space = (language or "en") in _NO_SPACE_LANGUAGES
    for piece, ids in _complete_unicode_pieces(token_ids, decode_fn):
        if not piece:
            if words:
                words[-1] = (words[-1][0], words[-1][1] + ids)
            continue
        stripped = piece.strip()
        punct_only = bool(stripped) and all(c in _PUNCT for c in stripped)
        new_word = (
            not words
            or (no_space and not punct_only)
            or (not no_space and piece.startswith(" ") and not punct_only)
        )
        if new_word:
            words.append((piece, ids))
        else:
            words[-1] = (words[-1][0] + piece, words[-1][1] + ids)
    return words


class WordAligner:
    """Per-window word timings (see the module docstring) with ``model`` on
    its device."""

    def __init__(
        self,
        model: Whisper,
        tokenizer,
        alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
        medfilt_width: int = 7,
        kernels: bool = True,
    ):
        self.model = model
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.heads = tuple(alignment_heads or default_alignment_heads(self.dims))
        self.medfilt_width = medfilt_width
        self.kernels = kernels

    def _bucket(self, n: int) -> int:
        b = max(64, -(-n // 64) * 64)
        return min(b, self.dims.n_text_ctx)

    def align_window(
        self,
        window_tokens: Sequence[int],  # the window's sampled tokens
        xa: torch.Tensor,  # [n_audio_ctx, n_state] encoder output
        time_offset: float,  # absolute seconds of the window start
        content_frames: int,  # real (unpadded) encoder frames in the window
    ) -> List[WordTiming]:
        tok = self.tokenizer
        ts_begin = tok.token_id_ts_begin
        eot = tok.token_id_eot

        # text tokens only (timestamps mark segments, they are not aligned),
        # fed after the SOT sequence and <|notimestamps|>
        fed: List[int] = list(tok.sequence_sot()) + [tok.token_id_no_timestamps]
        text_positions: List[int] = []
        text_ids: List[int] = []
        for t in window_tokens:
            t = int(t)
            if t >= ts_begin or t == eot:
                continue
            text_positions.append(len(fed))
            text_ids.append(t)
            fed.append(t)
        fed.append(eot)
        if not text_ids:
            return []

        dev = self.model.device
        T = self._bucket(len(fed))
        padded = torch.full((T,), eot, dtype=torch.int64)
        padded[: len(fed)] = torch.tensor(fed, dtype=torch.int64)
        qk = _alignment_qk(self.model, padded.to(dev), torch.as_tensor(xa).to(dev),
                           self.heads, self.kernels)  # [nAH, T, Tk]
        frames = max(1, min(content_frames, qk.shape[-1]))
        # only the text rows and the content frames go to the host: slicing
        # before the softmax keeps attention mass on padding frames out of
        # short final windows
        rows = torch.tensor(text_positions, device=dev)
        w = qk[:, rows, :frames].cpu().numpy()
        w = w - w.max(axis=-1, keepdims=True)
        w = np.exp(w)
        w = w / w.sum(axis=-1, keepdims=True)
        # z-normalise each head over the token axis, median-filter in time
        mean = w.mean(axis=1, keepdims=True)
        std = w.std(axis=1, keepdims=True) + 1e-8
        w = (w - mean) / std
        w = median_filter(w, self.medfilt_width)
        matrix = w.mean(axis=0)  # [n_text, frames]

        rows, cols = _dtw_fast(-matrix.astype(np.float64))
        # the first aligned frame of each token
        n_text = matrix.shape[0]
        starts = np.zeros(n_text, np.int64)
        seen = np.zeros(n_text, bool)
        for r, c in zip(rows, cols):
            if not seen[r]:
                starts[r] = c
                seen[r] = True
        ends = np.append(starts[1:], frames)

        words = split_words(text_ids, tok.decode, getattr(tok, "language", None))
        out: List[WordTiming] = []
        idx = 0
        for text, ids in words:
            first, last = idx, idx + len(ids) - 1
            idx += len(ids)
            out.append(WordTiming(
                word=text,
                start=time_offset + float(starts[first]) * TIME_PER_FRAME,
                end=time_offset + float(ends[last]) * TIME_PER_FRAME,
            ))
        # monotone times (DTW is monotone per token; guard zero-length words)
        for i in range(1, len(out)):
            if out[i].start < out[i - 1].end - 1e-9:
                out[i].start = out[i - 1].end
            if out[i].end < out[i].start:
                out[i].end = out[i].start
        return out
