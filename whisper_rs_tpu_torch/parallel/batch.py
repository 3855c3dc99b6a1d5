"""Batched transcription of many files (counterpart of
``whisper_rs_tpu/parallel/batch.py``, without its mesh): each round takes
the next 30 s window of up to ``batch_size`` unfinished files, decodes them
in one ``DecodeTask.run_batch`` call on the model's device with a prompt per
utterance, and advances each file's seek, segments and prompt on its own.

Rows at different rungs of the temperature ladder decode in separate calls
(the temperature is one value a call): rung 0 with the primary task, every
rung above 0 with one best-of-N sampling task.  A window that
``needs_fallback`` is decoded again at the next rung in the next round,
with its seek held and nothing recorded.  Short rounds are padded with
repeats of their last row to ``batch_size`` rows, and the padded rows are
dropped.  A failed call is retried one utterance at a time, so one bad
input does not fail its batchmates (``run(raise_on_error=False)`` returns
None for it).  The windows, prompts and sampling keys of every row are
those of the sequential ``TranscribeTask``, so both give the same output.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio.constants import N_FRAMES
from ..audio.mel import pad_or_trim
from ..config import TranscribeOptions
from ..decode.align import WordAligner
from ..decode.task import DecodeTask
from ..models.whisper import Whisper
from ..ops.mel import log_mel_file
from ..tokenize import Tokenizer
from ..transcribe import (
    QUANTUM,
    TranscribeOutput,
    TranscribeSegment,
    assign_words,
    needs_fallback,
    process_window_result,
    sampling_options,
    should_skip_no_speech,
)


@dataclasses.dataclass
class _UttState:
    mel: torch.Tensor  # [n_mels, n_frames] on the model's device
    seek: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    segments: List[TranscribeSegment] = dataclasses.field(default_factory=list)
    avg_logprobs: List[float] = dataclasses.field(default_factory=list)
    no_speech_probs: List[float] = dataclasses.field(default_factory=list)
    temp_idx: int = 0  # the ladder rung of the current window
    error: Optional[Exception] = None

    @property
    def done(self) -> bool:
        return self.error is not None or self.seek >= self.mel.shape[-1]


class BatchTranscriber:
    """Transcribes files ``batch_size`` windows a call with ``model`` on its
    device; ``kernels`` passes through to the mel and the decode."""

    def __init__(
        self,
        model: Whisper,
        tokenizer: Tokenizer,
        options: TranscribeOptions = TranscribeOptions(),
        batch_size: int = 8,
        *,
        kernels: bool = True,
    ):
        self.model = model
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.options = options
        self.batch_size = batch_size
        self.kernels = kernels
        self.decode_task = DecodeTask(model, tokenizer, options.decode, kernels=kernels,
                                      keep_audio_features=options.word_timestamps)
        self._sampling_task_cache: Optional[DecodeTask] = None
        self._aligner = (WordAligner(model, tokenizer, alignment_heads=options.alignment_heads)
                         if options.word_timestamps else None)

    def _sampling_task(self) -> DecodeTask:
        """The one task of every rung above 0 (``transcribe.sampling_options``),
        inheriting ``quantize_kv`` from the primary task."""
        if self._sampling_task_cache is None:
            self._sampling_task_cache = DecodeTask(
                self.model, self.tokenizer, sampling_options(self.options),
                keep_audio_features=self.options.word_timestamps, kernels=self.kernels,
                quantize_kv=getattr(self.decode_task, "quantize_kv", False),
            )
        return self._sampling_task_cache

    def _decode(self, task: DecodeTask, windows: list, prompts: list, temperature) -> list:
        """One padded ``run_batch`` call; where it fails, each real row alone
        (its exception in its place where that fails too)."""
        n_real = len(windows)
        while len(windows) < self.batch_size:
            windows.append(windows[-1])
            prompts.append(prompts[-1])
        try:
            return task.run_batch(torch.stack(windows), prompts, temperature=temperature)
        except Exception:  # isolate the failing utterance from its batchmates
            results = []
            for w, p in zip(windows[:n_real], prompts[:n_real]):
                try:
                    results.append(task.run_batch(w[None], [p], temperature=temperature)[0])
                except Exception as e:  # reported per utterance by run()
                    results.append(e)
            return results

    def run(self, audios: Sequence[np.ndarray],
            raise_on_error: bool = True) -> List[Optional[TranscribeOutput]]:
        """audios: [n_samples] f32 16 kHz arrays -> one transcription each
        (None for a failed one where ``raise_on_error`` is False)."""
        opts = self.options
        input_stride = N_FRAMES // self.dims.n_audio_ctx
        time_precision = input_stride * QUANTUM
        ts_begin = self.tokenizer.token_id_ts_begin
        if opts.initial_prompt_tokens is not None:
            init_tokens = list(opts.initial_prompt_tokens)
            condition = True
        elif opts.initial_prompt_text is not None:
            init_tokens = list(self.tokenizer.encode(opts.initial_prompt_text))
            condition = True
        else:
            init_tokens = []
            condition = opts.condition_on_prev_text

        dev = self.model.device
        states = [_UttState(mel=log_mel_file(a, self.dims.n_mels, device=dev,
                                             kernels=self.kernels), tokens=list(init_tokens))
                  for a in audios]
        ladder = opts.temperatures or (0.0,)
        while True:
            chunk = [i for i, s in enumerate(states) if not s.done][: self.batch_size]
            if not chunk:
                break
            # rows by rung: None is the primary task, a float a sampling rung
            groups: dict = {}
            for i in chunk:
                t = ladder[min(states[i].temp_idx, len(ladder) - 1)]
                key = None if (opts.temperatures is None or t == 0.0) else float(t)
                groups.setdefault(key, []).append(i)
            results: dict = {}
            for key, rows in groups.items():
                task = self.decode_task if key is None else self._sampling_task()
                windows = [pad_or_trim(states[i].mel[:, states[i].seek:], N_FRAMES)
                           for i in rows]
                prompts = [states[i].tokens if condition else None for i in rows]
                results.update(zip(rows, self._decode(task, windows, prompts, key)))

            for i in chunk:
                s, r = states[i], results[i]
                if isinstance(r, Exception):
                    s.error = r
                    continue
                if (opts.temperatures is not None and s.temp_idx < len(ladder) - 1
                        and needs_fallback(opts, r.text, r.avg_logprob, r.no_speech_prob)):
                    s.temp_idx += 1  # the same window at the next rung, next round
                    continue
                s.temp_idx = 0
                s.avg_logprobs.append(r.avg_logprob)
                s.no_speech_probs.append(r.no_speech_prob)
                if should_skip_no_speech(opts, r.no_speech_prob, r.avg_logprob):
                    s.seek += N_FRAMES
                    continue
                n_segs_before, n_tokens_before, seek_before = (len(s.segments), len(s.tokens),
                                                               s.seek)
                s.seek = process_window_result(
                    s.tokens, s.segments, np.asarray(r.tokens, np.int64), r.text, s.seek,
                    ts_begin, input_stride, time_precision, self.tokenizer.decode,
                )
                if self._aligner is not None and r.audio_features is not None:
                    content = max(1, min(s.mel.shape[-1] - seek_before, N_FRAMES)
                                  // input_stride)
                    words = self._aligner.align_window(s.tokens[n_tokens_before:],
                                                       r.audio_features,
                                                       seek_before * QUANTUM, content)
                    assign_words(s.segments[n_segs_before:], words)

        outputs: List[Optional[TranscribeOutput]] = []
        for s in states:
            if s.error is not None:
                if raise_on_error:
                    raise s.error
                outputs.append(None)
                continue
            arr = np.asarray(s.tokens, np.int64)
            outputs.append(TranscribeOutput(
                tokens=arr, text=self.tokenizer.decode(arr), segments=s.segments,
                avg_logprobs=s.avg_logprobs, no_speech_probs=s.no_speech_probs,
            ))
        return outputs
