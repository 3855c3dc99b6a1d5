"""Serving engine: continuous batching of transcription requests
(counterpart of ``whisper_rs_tpu/serve.py``).

A long-running engine accepts requests asynchronously and keeps the decode
batch full by continuous batching at the granularity of a 30 s window:
every decode call is one window batch of ``batch_size`` rows on the
model's device, and an utterance is a chain of windows with prompt
conditioning between them.

  * A finished utterance frees its row at the next window boundary, and a
    queued request takes it in the same round (FIFO, no drain barrier), so
    short requests do not wait behind long ones.
  * Prompt conditioning, segmentation, the seek, the no-speech skip, the
    temperature-fallback ladder and word alignment are per-row state on
    the host.  Rows at different rungs of the ladder decode in separate
    calls of one round (the temperature is one value a call): rung 0 with
    the primary task, every rung above 0 with one best-of-N sampling task
    (``_sampling_task``).  A window that ``needs_fallback`` holds its seek
    and is decoded again at the next rung in the next round.
  * Every call is padded to ``batch_size`` rows with repeats of its last
    row.  Where a padded call raises, each real row is decoded again alone,
    so a bad input fails only its own request.
  * The mel runs on each client's thread (``submit``), on the model's
    device; the job keeps it there.  Clients and the engine share the
    device's current stream, which orders a mel before its first decode.

Rows are independent in the decode (per-row end-aligned prompts), so on the
CPU every request's output equals the sequential ``TranscribeTask``'s
whatever the batch holds.  On the card the prefill bucket (the batch's
longest prompt) and the kernels' launch plans (the row count) depend on
the batch, so a row can round apart from the batch-1 run.

Usage::

    engine = ServingEngine(model, tokenizer, options, batch_size=8)
    engine.warmup()                        # build the kernels before traffic
    handle = engine.submit(audio)          # non-blocking
    out = handle.result(timeout=600)       # TranscribeOutput
    engine.stats()                         # counters and latency percentiles
    engine.close()
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Tuple

import torch

from .audio.constants import N_FRAMES, SAMPLE_RATE
from .audio.mel import pad_or_trim
from .config import TranscribeOptions
from .decode.align import WordAligner
from .decode.task import DecodeTask
from .models.whisper import Whisper
from .ops.mel import log_mel_file
from .tokenize import Tokenizer
from .transcribe import (
    TranscribeOutput,
    TranscribeSegment,
    Utterance,
    advance_window,
    initial_prompt,
    rung_key,
    sampling_task,
)


class RequestHandle:
    """Future-like handle of one submitted utterance: ``result()`` blocks
    until it finishes (raising its error if it failed);
    ``segments_so_far()`` snapshots the segments decoded so far."""

    def __init__(self, request_id: int, audio_seconds: float):
        self.request_id = request_id
        self.audio_seconds = audio_seconds
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._output: Optional[TranscribeOutput] = None
        self._error: Optional[Exception] = None
        self._segments: List[TranscribeSegment] = []

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> TranscribeOutput:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request_id} not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._output

    def segments_so_far(self) -> List[TranscribeSegment]:
        with self._lock:
            return list(self._segments)

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def _publish_segments(self, segments: List[TranscribeSegment]) -> None:
        with self._lock:
            self._segments = list(segments)

    def _resolve(self, output: TranscribeOutput) -> None:
        self.finished_at = time.monotonic()
        self._output = output
        self._done.set()

    def _reject(self, error: Exception) -> None:
        self.finished_at = time.monotonic()
        self._error = error
        self._done.set()


class _Job(Utterance):
    """The engine's state of one utterance (one batch row) and its handle."""

    def __init__(self, handle: RequestHandle, mel: torch.Tensor, init_tokens: List[int]):
        super().__init__(mel, list(init_tokens))
        self.handle = handle


class ServingEngine:
    """Continuously batched transcription with ``model`` on its device, one
    engine thread decoding ``batch_size`` rows a call; requests beyond the
    active rows wait in a FIFO queue of at most ``max_queue``.  ``kernels``
    passes through to the mel and the decode; ``decode_task``'s own fields
    (``quantize_kv``) may be set after construction, and the sampling task
    inherits ``quantize_kv`` when it is first made."""

    def __init__(
        self,
        model: Whisper,
        tokenizer: Tokenizer,
        options: TranscribeOptions = TranscribeOptions(),
        batch_size: int = 8,
        max_queue: int = 1024,
        *,
        kernels: bool = True,
    ):
        self.model = model
        self.dims = model.dims
        self.tokenizer = tokenizer
        self.options = options
        self.batch_size = batch_size
        self.max_queue = max_queue
        self.kernels = kernels
        self.decode_task = DecodeTask(model, tokenizer, options.decode, kernels=kernels,
                                      keep_audio_features=options.word_timestamps)
        self._sampling_task_cache: Optional[DecodeTask] = None
        self._aligner = (WordAligner(model, tokenizer, alignment_heads=options.alignment_heads)
                         if options.word_timestamps else None)

        self._init_tokens, self._condition = initial_prompt(options, tokenizer)

        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._active: List[Optional[_Job]] = [None] * batch_size
        self._closed = False
        self._next_id = 0

        # counters (under _lock)
        self._n_submitted = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_window_batches = 0
        self._n_windows_real = 0
        self._n_windows_padded = 0
        self._audio_seconds_done = 0.0
        self._decode_seconds = 0.0
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._started_at = time.monotonic()

        self._thread = threading.Thread(target=self._loop, name="whisper-serve", daemon=True)
        self._thread.start()

    # -- public API ----------------------------------------------------------

    def warmup(self) -> None:
        """Before traffic: build every kernel library the path launches (on
        the card, with ``kernels``; nvcc takes tens of seconds), then decode
        one throwaway padded batch of silence, and with prompt conditioning
        one more at the widest prefill bucket (a prompt of n_text_ctx // 2
        tokens).  No counter of ``stats()`` moves."""
        if self.kernels and self.model.device.type == "cuda":
            from .ops.build import build_all

            build_all()
        windows = torch.zeros(self.batch_size, self.dims.n_mels, N_FRAMES,
                              device=self.model.device)
        prompts = [None]
        if self._condition:
            prompts.append([self.tokenizer.token_id_space] * (self.dims.n_text_ctx // 2))
        for prompt in prompts:
            self.decode_task.run_batch(windows, [prompt] * self.batch_size)

    def submit(self, audio) -> RequestHandle:
        """Enqueue one utterance ([n_samples] f32 at 16 kHz, numpy or tensor).
        The mel runs on the caller's thread; an input it refuses fails only
        this handle.  The handle resolves when the last window is decoded."""
        audio = torch.as_tensor(audio)
        handle = RequestHandle(request_id=self._alloc_id(),
                               audio_seconds=float(audio.shape[-1]) / SAMPLE_RATE)
        try:
            mel = log_mel_file(audio, self.dims.n_mels, device=self.model.device,
                               kernels=self.kernels)
        except Exception as e:  # a bad input: fail just this request
            handle._reject(e)
            with self._lock:
                self._n_submitted += 1
                self._n_failed += 1
            return handle
        job = _Job(handle, mel, self._init_tokens)
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if len(self._queue) >= self.max_queue:
                raise RuntimeError(f"queue full ({self.max_queue})")
            self._queue.append(job)
            self._n_submitted += 1
            self._wakeup.notify()
        return handle

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved; False on a
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._queue or any(j is not None for j in self._active):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._wakeup.wait(remaining)
        return True

    def close(self, timeout: float = 60.0) -> None:
        """Stop accepting requests, finish the work in flight, join the
        engine thread."""
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
        self._thread.join(timeout)

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            rows = self._n_windows_real + self._n_windows_padded
            return {
                "submitted": self._n_submitted,
                "completed": self._n_completed,
                "failed": self._n_failed,
                "queued": len(self._queue),
                "active": sum(j is not None for j in self._active),
                "window_batches": self._n_window_batches,
                "windows_decoded": self._n_windows_real,
                "batch_utilization": self._n_windows_real / rows if rows else 0.0,
                "audio_seconds_done": self._audio_seconds_done,
                "decode_seconds": self._decode_seconds,
                "throughput_audio_s_per_s": (self._audio_seconds_done / self._decode_seconds
                                             if self._decode_seconds else 0.0),
                "latency_p50": lat[len(lat) // 2] if lat else None,
                "latency_p95": lat[int(len(lat) * 0.95)] if lat else None,
                "uptime": time.monotonic() - self._started_at,
            }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine loop ---------------------------------------------------------

    def _alloc_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def _admit_locked(self) -> None:
        """Fill free rows from the queue, first in first out."""
        for slot in range(self.batch_size):
            if self._active[slot] is None and self._queue:
                job = self._queue.popleft()
                job.handle.started_at = time.monotonic()
                self._active[slot] = job

    def _loop(self) -> None:
        while True:
            with self._lock:
                self._admit_locked()
                jobs = [(i, j) for i, j in enumerate(self._active) if j is not None]
                if not jobs:
                    if self._closed:
                        return
                    self._wakeup.wait(0.05)
                    continue
            self._decode_round(jobs)

    def _sampling_task(self) -> DecodeTask:
        """The one task of every rung above 0 (``transcribe.sampling_options``),
        inheriting ``quantize_kv`` from the primary task."""
        if self._sampling_task_cache is None:
            self._sampling_task_cache = sampling_task(self.decode_task, self.options)
        return self._sampling_task_cache

    def _decode_round(self, jobs) -> None:
        """One round: the active rows grouped by ladder rung, one padded call
        a rung, then each row advanced."""
        groups: dict = {}  # rung key (None: the primary task) -> [(slot, job)]
        for slot, job in jobs:
            groups.setdefault(rung_key(self.options, job.temp_idx), []).append((slot, job))

        results_by_slot: dict = {}
        n_calls = 0
        n_padded = 0
        t0 = time.monotonic()
        for key, group in groups.items():
            task = self.decode_task if key is None else self._sampling_task()
            windows = [pad_or_trim(job.mel[:, job.seek:], N_FRAMES) for _, job in group]
            prompts = [job.tokens if self._condition else None for _, job in group]
            n_real = len(windows)
            while len(windows) < self.batch_size:  # one shape a call: pad with repeats
                windows.append(windows[-1])
                prompts.append(prompts[-1])
            n_calls += 1
            n_padded += self.batch_size - n_real
            try:
                results = task.run_batch(torch.stack(windows), prompts, temperature=key)
            except Exception:  # isolate the failing utterance: each real row alone
                results = []
                for w, p in zip(windows[:n_real], prompts[:n_real]):
                    try:
                        results.append(task.run_batch(w[None], [p], temperature=key)[0])
                    except Exception as e:  # this request's error, reported on its handle
                        results.append(e)
            for (slot, _), r in zip(group, results):
                results_by_slot[slot] = r
        dt = time.monotonic() - t0

        # rows advance outside the lock: jobs belong to the engine thread, and
        # word alignment runs on the device, which must not block submit()
        finished: List[_Job] = []
        failed: List[Tuple[int, _Job, Exception]] = []
        advanced: List[Tuple[int, _Job]] = []
        for slot, job in jobs:
            r = results_by_slot[slot]
            if isinstance(r, Exception):
                failed.append((slot, job, r))
                continue
            self._advance(job, r)
            advanced.append((slot, job))

        with self._lock:
            self._n_window_batches += n_calls
            self._n_windows_real += len(jobs)
            self._n_windows_padded += n_padded
            self._decode_seconds += dt
            for slot, job, err in failed:
                self._active[slot] = None
                self._n_failed += 1
                job.handle._reject(err)
            for slot, job in advanced:
                if job.done:
                    self._active[slot] = None
                    finished.append(job)
            self._wakeup.notify_all()

        for job in finished:
            self._finish(job)

    def _advance(self, job: _Job, r) -> None:
        """Apply one decoded window to its row (``transcribe.advance_window``)
        and publish the row's segments."""
        advance_window(job, r, self.options, self.tokenizer, self._aligner,
                       N_FRAMES // self.dims.n_audio_ctx)
        job.handle._publish_segments(job.segments)

    def _finish(self, job: _Job) -> None:
        out = job.output(self.tokenizer)
        with self._lock:
            self._n_completed += 1
            self._audio_seconds_done += job.handle.audio_seconds
        job.handle._resolve(out)
        with self._lock:
            if job.handle.latency is not None:
                self._latencies.append(job.handle.latency)
