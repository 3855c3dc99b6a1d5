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
    TranscribeOutput,
    Utterance,
    advance_window,
    initial_prompt,
    rung_key,
    sampling_task,
)


@dataclasses.dataclass
class _UttState(Utterance):
    error: Optional[Exception] = None

    @property
    def done(self) -> bool:
        return self.error is not None or super().done


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
            self._sampling_task_cache = sampling_task(self.decode_task, self.options)
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
        init_tokens, condition = initial_prompt(opts, self.tokenizer)
        dev = self.model.device
        states = [_UttState(log_mel_file(a, self.dims.n_mels, device=dev, kernels=self.kernels),
                            list(init_tokens)) for a in audios]
        while True:
            chunk = [i for i, s in enumerate(states) if not s.done][: self.batch_size]
            if not chunk:
                break
            # rows by rung: None is the primary task, a float a sampling rung
            groups: dict = {}
            for i in chunk:
                groups.setdefault(rung_key(opts, states[i].temp_idx), []).append(i)
            results: dict = {}
            for key, rows in groups.items():
                task = self.decode_task if key is None else self._sampling_task()
                windows = [pad_or_trim(states[i].mel[:, states[i].seek:], N_FRAMES)
                           for i in rows]
                prompts = [states[i].tokens if condition else None for i in rows]
                results.update(zip(rows, self._decode(task, windows, prompts, key)))

            for i in chunk:
                if isinstance(results[i], Exception):
                    states[i].error = results[i]
                else:
                    advance_window(states[i], results[i], opts, self.tokenizer, self._aligner,
                                   input_stride)

        outputs: List[Optional[TranscribeOutput]] = []
        for s in states:
            if s.error is not None:
                if raise_on_error:
                    raise s.error
                outputs.append(None)
            else:
                outputs.append(s.output(self.tokenizer))
        return outputs
