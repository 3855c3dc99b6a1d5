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
branches.  The temperature fallback ladder and word timestamps are not
ported: ``TranscribeOptions.temperatures`` and ``word_timestamps`` raise.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional

import numpy as np
import torch

from .audio.constants import HOP_LENGTH, N_FRAMES, SAMPLE_RATE
from .audio.mel import pad_or_trim
from .config import TranscribeOptions
from .decode.task import DecodeTask
from .models.whisper import Whisper
from .ops.mel import log_mel_file
from .tokenize import Tokenizer

QUANTUM = HOP_LENGTH / SAMPLE_RATE  # 0.01 s, one mel frame


@dataclasses.dataclass
class TranscribeSegment:
    seek: int
    start_time: float
    end_time: float
    start_token: int
    end_token: int
    text: str


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


class TranscribeTask:
    """Transcribes whole files with ``model`` on its device; ``kernels``
    passes through to the mel and the window decode (``decode_task``,
    whose own fields, e.g. ``quantize_kv``, may be set after
    construction)."""

    def __init__(
        self,
        model: Whisper,
        tokenizer: Tokenizer,
        options: TranscribeOptions = TranscribeOptions(),
        *,
        kernels: bool = True,
    ):
        if options.temperatures is not None:
            raise NotImplementedError(
                "the temperature fallback ladder samples, and sampling is not ported"
            )
        if options.word_timestamps:
            raise NotImplementedError("word timestamps (alignment) are not ported")
        self.model = model
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.options = options
        self.kernels = kernels
        self.decode_task = DecodeTask(model, tokenizer, options.decode, kernels=kernels)

    def run(self, audio, mel: Optional[torch.Tensor] = None) -> TranscribeOutput:
        """audio [n_samples] f32 at 16 kHz, or a precomputed ``mel``
        [n_mels, n_frames] -> the transcription."""
        if mel is None:
            mel = log_mel_file(audio, self.dims.n_mels, device=self.model.device,
                               kernels=self.kernels)
        mel = torch.as_tensor(mel).to(self.model.device)
        n_frames = mel.shape[-1]
        input_stride = N_FRAMES // self.dims.n_audio_ctx  # mel frames a timestamp step (2)
        time_precision = input_stride * QUANTUM  # 0.02 s

        opts = self.options
        if opts.initial_prompt_tokens is not None:
            tokens: List[int] = list(opts.initial_prompt_tokens)
            condition = True
        elif opts.initial_prompt_text is not None:
            tokens = list(self.tokenizer.encode(opts.initial_prompt_text))
            condition = True
        else:
            tokens = []
            condition = opts.condition_on_prev_text

        ts_begin = self.tokenizer.token_id_ts_begin
        segments: List[TranscribeSegment] = []
        avg_logprobs: List[float] = []
        no_speech_probs: List[float] = []
        seek = 0
        while seek < n_frames:
            window = pad_or_trim(mel[:, seek:], N_FRAMES)
            if condition:
                self.decode_task.set_prompt(tokens)
            result = self.decode_task.run(window)[0]
            avg_logprobs.append(result.avg_logprob)
            no_speech_probs.append(result.no_speech_prob)
            if should_skip_no_speech(opts, result.no_speech_prob, result.avg_logprob):
                seek += N_FRAMES
                continue
            seek = process_window_result(
                tokens, segments, np.asarray(result.tokens, np.int64), result.text, seek,
                ts_begin, input_stride, time_precision, self.tokenizer.decode,
            )

        tokens_arr = np.asarray(tokens, np.int64)
        return TranscribeOutput(
            tokens=tokens_arr,
            text=self.tokenizer.decode(tokens_arr),
            segments=segments,
            avg_logprobs=avg_logprobs,
            no_speech_probs=no_speech_probs,
        )
