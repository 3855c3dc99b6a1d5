"""Long-audio transcription: the 30 s seek loop with prompt conditioning
and timestamp-guided segmentation (counterpart of
``whisper_rs_tpu/transcribe.py``).

The whole file's log-mel is computed once (``ops.mel.log_mel_file``, its
floor over the whole file), then each window ``mel[:, seek:]``, zero-padded
or cut to 3000 frames, is decoded by a ``DecodeTask`` on the model's
device, prompted with the tokens so far when prompts are conditioned.  The
segmentation rules are the reference's:

  * a window with consecutive timestamp pairs splits at each pair, and the
    seek advances to the last pair's timestamp (a full window where that is
    0, which would never advance);
  * a window without one is one segment, trimmed to a lone trailing
    timestamp, and the seek advances a full window.

Segment ``start_token``/``end_token`` are global token indices in both
branches.

With ``TranscribeOptions.temperatures`` (OpenAI's fallback ladder, e.g.
0, 0.2, ..., 1.0) a window that ``needs_fallback`` (a degenerate
repetition or a low average log-probability, unless it is confidently
silence) is decoded again at the next rung, with the seek held: rung 0
with the primary task, every rung above 0 with one best-of-N sampling task
(``_sampling_task``: N the beam size, the temperature passed at run time).
With ``word_timestamps`` each window's consumed tokens are aligned to the
audio (``decode/align.py``) and each word goes to the segment its midpoint
falls in (``assign_words``).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .audio.constants import HOP_LENGTH, N_FRAMES, SAMPLE_RATE
from .audio.mel import pad_or_trim
from .config import BeamSearchMode, GreedyMode, TranscribeOptions
from .decode.align import WordAligner, WordTiming
from .decode.task import DecodeTask
from .models.whisper import Whisper
from .ops.mel import log_mel_file
from .tokenize import Tokenizer

QUANTUM = HOP_LENGTH / SAMPLE_RATE  # 0.01 s, one mel frame


@dataclasses.dataclass
class TranscribeSegment:
    """One segment; ``words`` holds its aligned words when
    ``TranscribeOptions.word_timestamps`` is on, else None."""

    seek: int
    start_time: float
    end_time: float
    start_token: int
    end_token: int
    text: str
    words: Optional[List[WordTiming]] = None


@dataclasses.dataclass
class TranscribeOutput:
    tokens: np.ndarray
    text: str
    segments: List[TranscribeSegment]
    # each window's quality metrics, in decode order
    avg_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_speech_probs: List[float] = dataclasses.field(default_factory=list)


def compression_ratio(text: str) -> float:
    """zlib compression ratio of the text: high values flag degenerate
    repetition loops."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(
    opts: TranscribeOptions, text: str, avg_logprob: float,
    no_speech_prob: Optional[float] = None,
) -> bool:
    """The temperature ladder's retry rule: a degenerate repetition or a low
    confidence asks for a retry, unless the window is confidently
    silence."""
    fallback = (compression_ratio(text) > opts.compression_ratio_threshold
                or avg_logprob < opts.logprob_threshold)
    if (no_speech_prob is not None and opts.no_speech_threshold is not None
            and no_speech_prob > opts.no_speech_threshold):
        fallback = False
    return fallback


def should_skip_no_speech(opts: TranscribeOptions, no_speech_prob: float,
                          avg_logprob: float) -> bool:
    """Whether a window is skipped as silence: a strong no-speech signal and
    a low-confidence decode."""
    return (opts.no_speech_threshold is not None and no_speech_prob > opts.no_speech_threshold
            and avg_logprob < opts.logprob_threshold)


def assign_words(segments: List[TranscribeSegment], words) -> None:
    """Attach a window's aligned words to its segments by time: each word
    goes to the segment whose span holds its midpoint (else the nearest
    span).  Words and segments are both in time order, so reading order is
    kept."""
    if not segments or not words:
        return
    for s in segments:
        s.words = []
    for w in words:
        mid = (w.start + w.end) / 2.0
        target = next((s for s in segments
                       if s.start_time - 1e-6 <= mid <= s.end_time + 1e-6), None)
        if target is None:
            target = min(segments, key=lambda s: min(abs(s.start_time - mid),
                                                     abs(s.end_time - mid)))
        target.words.append(w)


def sampling_options(options: TranscribeOptions):
    """The ``DecodeOptions`` of the ladder's rungs above 0: best-of-N greedy
    sampling (beam search is not defined at a temperature), N the beam
    size or the greedy group size."""
    mode = options.decode.mode
    n = mode.beam_size if isinstance(mode, BeamSearchMode) else getattr(mode, "group_size", 1)
    return dataclasses.replace(options.decode, mode=GreedyMode(group_size=max(n or 1, 1)))


def initial_prompt(opts: TranscribeOptions, tokenizer) -> Tuple[List[int], bool]:
    """(the tokens an utterance starts from, whether each window is prompted
    with the tokens so far): an initial prompt, as tokens or text, switches
    conditioning on; else ``condition_on_prev_text`` decides."""
    if opts.initial_prompt_tokens is not None:
        return list(opts.initial_prompt_tokens), True
    if opts.initial_prompt_text is not None:
        return list(tokenizer.encode(opts.initial_prompt_text)), True
    return [], opts.condition_on_prev_text


def rung_key(opts: TranscribeOptions, temp_idx: int) -> Optional[float]:
    """The rung a window at ladder index ``temp_idx`` decodes at: None for the
    primary task (no ladder, or temperature 0), else the temperature."""
    ladder = opts.temperatures or (0.0,)
    t = ladder[min(temp_idx, len(ladder) - 1)]
    return None if (opts.temperatures is None or t == 0.0) else float(t)


def sampling_task(primary: DecodeTask, opts: TranscribeOptions) -> DecodeTask:
    """The one task of every rung above 0 (``sampling_options``), on the
    primary task's model, with its ``kernels``, ``quantize_kv``,
    ``encoder_fn`` and ``graphs``; the temperature is passed at run
    time."""
    return DecodeTask(primary.model, primary.tokenizer, sampling_options(opts),
                      keep_audio_features=opts.word_timestamps, kernels=primary.kernels,
                      quantize_kv=primary.quantize_kv, encoder_fn=primary.encoder_fn,
                      graphs=primary.graphs)


def process_window_result(
    tokens: List[int],
    segments: List[TranscribeSegment],
    segment_tokens: np.ndarray,
    result_text: str,
    seek: int,
    ts_begin: int,
    input_stride: int,
    time_precision: float,
    decode_fn,
) -> int:
    """Apply one decoded window to the running transcription: append its
    segments and consumed tokens (both branches of the reference's rules),
    and return the new seek.  ``decode_fn`` maps token ids to text."""
    ts_offset = seek * QUANTUM
    is_ts = segment_tokens >= ts_begin
    consecutive = np.nonzero(is_ts[:-1] & is_ts[1:])[0] + 1
    token_offset = len(tokens)

    if consecutive.size > 0:
        last_slice = 0
        for current_slice in consecutive:
            sliced = segment_tokens[last_slice:current_slice]
            segments.append(TranscribeSegment(
                seek=seek,
                start_time=ts_offset + (int(sliced[0]) - ts_begin) * time_precision,
                end_time=ts_offset + (int(sliced[-1]) - ts_begin) * time_precision,
                start_token=token_offset + last_slice + 1,
                end_token=token_offset + int(current_slice),
                text=decode_fn(sliced),
            ))
            last_slice = int(current_slice)
        last_ts = int(segment_tokens[last_slice - 1]) - ts_begin
        # a <|0.00|><|0.00|> pair would advance by 0 frames: a full window
        seek += N_FRAMES if last_ts <= 0 else last_ts * input_stride
        tokens.extend(int(t) for t in segment_tokens[: last_slice + 1])
    else:
        segment_duration = 30.0
        ts_positions = segment_tokens[is_ts]
        if ts_positions.size > 0 and int(ts_positions[-1]) != ts_begin:
            # lone trailing timestamp: trim the duration to it
            segment_duration = (int(ts_positions[-1]) - ts_begin) * time_precision
        segments.append(TranscribeSegment(
            seek=seek,
            start_time=ts_offset,
            end_time=ts_offset + segment_duration,
            start_token=token_offset,
            end_token=token_offset + len(segment_tokens),
            text=result_text,
        ))
        seek += N_FRAMES
        tokens.extend(int(t) for t in segment_tokens)
    return seek


@dataclasses.dataclass
class Utterance:
    """One file's transcription state: its log-mel [n_mels, n_frames] on the
    model's device, the seek, the tokens so far (the next window's prompt
    where prompts are conditioned), the segments, each window's quality
    metrics, and the ladder rung of the window in flight."""

    mel: torch.Tensor
    tokens: List[int]
    seek: int = 0
    segments: List[TranscribeSegment] = dataclasses.field(default_factory=list)
    avg_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_speech_probs: List[float] = dataclasses.field(default_factory=list)
    temp_idx: int = 0

    @property
    def done(self) -> bool:
        return self.seek >= self.mel.shape[-1]

    def output(self, tokenizer) -> TranscribeOutput:
        tokens = np.asarray(self.tokens, np.int64)
        return TranscribeOutput(tokens=tokens, text=tokenizer.decode(tokens),
                                segments=self.segments, avg_logprobs=self.avg_logprobs,
                                no_speech_probs=self.no_speech_probs)


def record_window(u: Utterance, r, opts: TranscribeOptions, tokenizer, aligner,
                  input_stride: int) -> None:
    """Apply one accepted window ``r`` (a ``DecodeOutput``) to ``u``: its
    quality metrics, then the no-speech skip, or its segments, consumed
    tokens and seek (``process_window_result``) and, with an ``aligner``,
    its words."""
    u.avg_logprobs.append(r.avg_logprob)
    u.no_speech_probs.append(r.no_speech_prob)
    if should_skip_no_speech(opts, r.no_speech_prob, r.avg_logprob):
        u.seek += N_FRAMES
        return
    n_segs_before, n_tokens_before, seek_before = len(u.segments), len(u.tokens), u.seek
    u.seek = process_window_result(
        u.tokens, u.segments, np.asarray(r.tokens, np.int64), r.text, u.seek,
        tokenizer.token_id_ts_begin, input_stride, input_stride * QUANTUM, tokenizer.decode,
    )
    if aligner is not None and r.audio_features is not None:
        content = max(1, min(u.mel.shape[-1] - seek_before, N_FRAMES) // input_stride)
        # align only the tokens this window consumed: the tail past the last
        # timestamp pair is decoded (and aligned) again by the next window
        words = aligner.align_window(u.tokens[n_tokens_before:], r.audio_features,
                                     seek_before * QUANTUM, content)
        assign_words(u.segments[n_segs_before:], words)


def advance_window(u: Utterance, r, opts: TranscribeOptions, tokenizer, aligner,
                   input_stride: int) -> None:
    """Apply one decoded window to a row of the batch driver or the serving
    engine: a window that ``needs_fallback`` below the ladder's last rung
    moves to the next rung, its seek held and nothing recorded; else
    ``record_window``, and the next window starts at rung 0."""
    ladder = opts.temperatures
    if (ladder is not None and u.temp_idx < len(ladder) - 1
            and needs_fallback(opts, r.text, r.avg_logprob, r.no_speech_prob)):
        u.temp_idx += 1  # the same window at the next rung, next round
        return
    u.temp_idx = 0
    record_window(u, r, opts, tokenizer, aligner, input_stride)


class TranscribeTask:
    """Transcribes whole files with ``model`` on its device; ``kernels``
    passes through to the mel and the window decode (``decode_task``,
    whose own fields, e.g. ``quantize_kv``, may be set after
    construction; the sampling task of the ladder inherits
    ``quantize_kv`` when it is first made), ``encoder_fn`` and ``graphs``
    (``False``: the decode loop's steps run eagerly on the card) to the
    window decode.  On a sharded model (``parallel.sharding.shard_model``) every
    rank runs the same task on the same audio."""

    def __init__(
        self,
        model: Whisper,
        tokenizer: Tokenizer,
        options: TranscribeOptions = TranscribeOptions(),
        *,
        kernels: bool = True,
        encoder_fn=None,
        graphs: bool = True,
    ):
        self.model = model
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.options = options
        self.kernels = kernels
        self.decode_task = DecodeTask(model, tokenizer, options.decode, kernels=kernels,
                                      keep_audio_features=options.word_timestamps,
                                      encoder_fn=encoder_fn, graphs=graphs)
        self._fallback_tasks: dict = {}
        self._aligner = (WordAligner(model, tokenizer, alignment_heads=options.alignment_heads,
                                     kernels=kernels)
                         if options.word_timestamps else None)

    def _sampling_task(self) -> DecodeTask:
        """The one task of every rung above 0 (``sampling_options``); the
        temperature is passed at run time."""
        if "sampling" not in self._fallback_tasks:
            self._fallback_tasks["sampling"] = sampling_task(self.decode_task, self.options)
        return self._fallback_tasks["sampling"]

    def run(self, audio, mel: Optional[torch.Tensor] = None) -> TranscribeOutput:
        """audio [n_samples] f32 at 16 kHz, or a precomputed ``mel``
        [n_mels, n_frames] -> the transcription."""
        if mel is None:
            mel = log_mel_file(audio, self.dims.n_mels, device=self.model.device,
                               kernels=self.kernels)
        opts = self.options
        tokens, condition = initial_prompt(opts, self.tokenizer)
        u = Utterance(torch.as_tensor(mel).to(self.model.device), tokens)
        input_stride = N_FRAMES // self.dims.n_audio_ctx  # mel frames a timestamp step (2)
        n_rungs = len(opts.temperatures or (0.0,))
        while not u.done:
            window = pad_or_trim(u.mel[:, u.seek:], N_FRAMES)
            # the fallback ladder (without one: one pass with the primary task)
            for idx in range(n_rungs):
                temp = rung_key(opts, idx)
                task = self.decode_task if temp is None else self._sampling_task()
                if condition:
                    task.set_prompt(u.tokens)
                result = task.run(window, temperature=temp)[0]
                if idx == n_rungs - 1 or not needs_fallback(
                        opts, result.text, result.avg_logprob, result.no_speech_prob):
                    break
            record_window(u, result, opts, self.tokenizer, self._aligner, input_stride)
        return u.output(self.tokenizer)
