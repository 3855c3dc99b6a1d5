"""Plain float32 Whisper in PyTorch: the reference the benchmark holds the
port's served tokens to.

It follows OpenAI's published model (``whisper/model.py``, ``audio.py``,
``decoding.py``) and imports nothing of the port, of its tests or of JAX:
the log-mel frontend (a periodic Hann window, ``torch.stft`` with reflect
padding, power, Slaney mel filters made here, log10, the floor at the
maximum less 8, (x + 4) / 4), the encoder (two convolutions with exact GELU,
the sinusoid table, pre-LayerNorm blocks, ``ln_post``), a full causal
decoder pass over one token sequence (teacher forcing: no cache) with the
cross-attention over the encoder output, the tied logits, and the logit
filters of a decode (suppress blank, suppress tokens, the timestamp rules).

Departures, each shared with the program it is compared with:
  * a file's log-mel is that of the file zero-padded to whole 30 s windows,
    its floor taken over all of them, then cut to ``n_samples // 160``
    frames (OpenAI pads by one window);
  * the timestamp rules have no "timestamps never decrease" rule (the
    JAX package's filters have none).

Matrix products run in float32 with TF32 off (``f32_exact``), so no product
rounds below float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP


@contextlib.contextmanager
def f32_exact():
    """float32 matrix products and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- frontend ----------------------------------------------------------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = math.log(6.4) / 27.0
    lin = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    lin)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
                    m * f_sp)


def mel_filters(n_mels: int) -> np.ndarray:
    """[n_mels, 201] Slaney-normalised triangular filters (librosa's
    ``filters.mel(sr=16000, n_fft=400, n_mels=n_mels)``), in float64."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(np.array(0.0)),
                                _hz_to_mel(np.array(SAMPLE_RATE / 2.0)), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    tri = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return tri * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[n] float32 samples at 16 kHz -> [n_mels, n // 160] log-mel."""
    n = audio.shape[-1]
    buf = torch.zeros(max(1, -(-n // N_SAMPLES)) * N_SAMPLES, dtype=torch.float32,
                      device=audio.device)
    buf[:n] = audio.float()
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.stft(buf, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[:, :-1]
    fb = torch.from_numpy(mel_filters(n_mels)).float().to(audio.device)
    mel = fb @ spec.abs().square()
    log = torch.log10(mel.clamp(min=1e-10))
    log = torch.maximum(log, log.max() - 8.0)
    return ((log + 4.0) / 4.0)[:, : n // HOP]


def window_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """A clip of at most 30 s -> its [n_mels, 3000] decode window: the clip's
    log-mel, zero-padded at the end (OpenAI's ``pad_or_trim`` of the mel)."""
    mel = log_mel(audio, n_mels)
    return F.pad(mel, (0, N_FRAMES - mel.shape[-1]))


# -- model --------------------------------------------------------------------


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _ln(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], 1e-5)


def _lin(x, W, name):
    return F.linear(x, W[f"{name}.weight"], W.get(f"{name}.bias"))


def _attention(x, kv_in, W, name, n_head, causal: bool):
    """Multi-head attention of queries from ``x`` [T, D] over ``kv_in`` [S, D]."""
    T, D = x.shape
    S = kv_in.shape[0]
    dh = D // n_head
    q = _lin(x, W, f"{name}.query").view(T, n_head, dh).transpose(0, 1)
    k = _lin(kv_in, W, f"{name}.key").view(S, n_head, dh).transpose(0, 1)
    v = _lin(kv_in, W, f"{name}.value").view(S, n_head, dh).transpose(0, 1)
    scores = (q @ k.transpose(1, 2)) / math.sqrt(dh)
    if causal:
        scores = scores.masked_fill(
            torch.ones(T, S, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    return _lin(out.transpose(0, 1).reshape(T, D), W, f"{name}.out")


def _mlp(x, W, name):
    return _lin(F.gelu(_lin(x, W, f"{name}.mlp.0")), W, f"{name}.mlp.2")


def encoder(mel: torch.Tensor, W: Dict[str, torch.Tensor], n_head: int, n_layer: int):
    """[n_mels, 3000] log-mel -> [1500, D] audio features."""
    return encoder_states(mel, W, n_head, n_layer)[1]


def encoder_states(mel: torch.Tensor, W: Dict[str, torch.Tensor], n_head: int, n_layer: int):
    """[n_mels, 3000] log-mel -> ([1500, D] the residual stream after the
    first block, [1500, D] audio features)."""
    x = F.gelu(F.conv1d(mel[None], W["encoder.conv1.weight"], W["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, W["encoder.conv2.weight"], W["encoder.conv2.bias"], stride=2,
                        padding=1))[0].T
    x = x + sinusoids(x.shape[0], x.shape[1], x.device)
    first = None
    for i in range(n_layer):
        p = f"encoder.blocks.{i}"
        h = _ln(x, W, f"{p}.attn_ln")
        x = x + _attention(h, h, W, f"{p}.attn", n_head, causal=False)
        x = x + _mlp(_ln(x, W, f"{p}.mlp_ln"), W, p)
        first = x if i == 0 else first
    return first, _ln(x, W, "encoder.ln_post")


def decoder_logits(tokens: torch.Tensor, xa: torch.Tensor, W: Dict[str, torch.Tensor],
                   n_head: int, n_layer: int) -> torch.Tensor:
    """Token sequence [T] (positions 0..T-1) over audio features [1500, D]
    -> float32 logits [T, n_vocab] of the token after each position."""
    T = tokens.shape[0]
    emb = W["decoder.token_embedding.weight"]
    x = emb[tokens] + W["decoder.positional_embedding"][:T]
    for i in range(n_layer):
        p = f"decoder.blocks.{i}"
        h = _ln(x, W, f"{p}.attn_ln")
        x = x + _attention(h, h, W, f"{p}.attn", n_head, causal=True)
        x = x + _attention(_ln(x, W, f"{p}.cross_attn_ln"), xa, W, f"{p}.cross_attn", n_head,
                           causal=False)
        x = x + _mlp(_ln(x, W, f"{p}.mlp_ln"), W, p)
    return _ln(x, W, "decoder.ln") @ emb.T


# -- the logit filters of a decode ----------------------------------------------


def filtered_logits(logits: torch.Tensor, sampled: Sequence[int], tok: dict,
                    suppress: Sequence[int], timestamps: bool,
                    max_initial_timestamp_index: Optional[int]) -> torch.Tensor:
    """The filtered logits at each sampled position: ``logits`` [n, V] are
    the logits of sampled positions 0..n-1, ``sampled`` the n tokens chosen
    there (position j's filters read tokens 0..j-1 of it).  ``tok`` holds the
    ids ``eot``, ``space``, ``ts_begin`` and ``no_timestamps``."""
    n, V = logits.shape
    dev = logits.device
    x = logits.clone()
    col = torch.arange(V, device=dev)
    eot, ts_begin = tok["eot"], tok["ts_begin"]
    x[0, tok["space"]] = float("-inf")  # suppress blank at the first position
    x[0, eot] = float("-inf")
    if suppress:
        x[:, torch.as_tensor(list(suppress), device=dev)] = float("-inf")
    if not timestamps:
        return x
    x[:, tok["no_timestamps"]] = float("-inf")
    s = torch.as_tensor(list(sampled), dtype=torch.long, device=dev)
    j = torch.arange(n, device=dev)
    last = torch.where(j >= 1, s[(j - 1).clamp(min=0)], -1)
    penult = torch.where(j >= 2, s[(j - 2).clamp(min=0)], -1)
    last_ts = (j >= 1) & (last >= ts_begin)
    penult_ts = (j < 2) | (penult >= ts_begin)
    is_ts = col >= ts_begin
    x = x.masked_fill((last_ts & penult_ts)[:, None] & is_ts[None, :], float("-inf"))
    x = x.masked_fill((last_ts & ~penult_ts)[:, None] & (col < eot)[None, :], float("-inf"))
    x[0, :ts_begin] = float("-inf")  # the first sampled token is a timestamp
    if max_initial_timestamp_index is not None:
        x[0, ts_begin + max_initial_timestamp_index + 1:] = float("-inf")
    lp = torch.log_softmax(x, dim=-1)
    force = torch.logsumexp(lp[:, ts_begin:], dim=-1) > lp[:, :ts_begin].max(dim=-1).values
    return x.masked_fill(force[:, None] & ~is_ts[None, :], float("-inf"))


def token_gaps(filtered: torch.Tensor, served: Sequence[int], k: int) -> torch.Tensor:
    """[n] how far each served token's filtered logit lies below the k-th
    best filtered logit of its position (0 where it is among the k best;
    inf where the filters forbid it)."""
    s = torch.as_tensor(list(served), dtype=torch.long, device=filtered.device)
    kth = filtered.topk(k, dim=-1).values[:, -1]
    own = filtered.gather(1, s[:, None])[:, 0]
    return torch.where(torch.isfinite(own), (kth - own).clamp(min=0.0),
                       torch.full_like(own, float("inf")))
