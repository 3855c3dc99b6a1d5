"""DecodeTask: one batch of 30 s windows, from prompts to text (counterpart
of ``whisper_rs_tpu/decode/task.py``).

The filter stack is assembled once from ``DecodeOptions`` and the
tokenizer; a run builds the end-aligned prompts of its rows
(``build_batch_prompts``, per-row ``key_start``), decodes through
``decode_greedy`` or ``decode_beam`` on the model's device, ranks the
candidates and detokenizes the chosen one of each audio.  A greedy task
takes a temperature override at run time (the JAX package's traced
temperature: one task serves every rung of the fallback ladder);
``keep_audio_features`` hands each audio's encoder output to the caller,
on the model's device, for word alignment.

The task keeps its decode windows (``decode.loop.WindowCache``), as the
JAX task keeps one compiled window for each shape (``_window_fn``): keyed
by the JAX task's keys (audios, prefill width, key_start, sampled or not)
and the port's (the step route, int8 K/V, beam search), each with its
static buffers and, on the card, its phases captured as CUDA graphs, so
consecutive calls of one shape replay the same graphs on the same
buffers.  ``warmup`` makes them before traffic arrives, as the JAX
``warmup`` compiles them.  ``encoder_fn`` routes the
encoder through the pipeline or Ulysses (``parallel``), as the JAX task's
``encoder_fn``; on a model with data ranks the decode splits the batch
over them and gathers the outputs (``decode.loop.data_parallel``), so every
rank assembles the same outputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import DecodeOptions, GreedyMode
from ..models.whisper import Whisper
from ..tokenize import Tokenizer
from .filters import FilterConfig
from .loop import (
    WindowCache,
    _encode_and_prefill,
    beam_shape,
    decode_beam,
    decode_greedy,
    eager_reason,
    greedy_shape,
)
from .prompt import PREFILL_BUCKETS, build_batch_prompts
from .ranker import rank_max_likelihood


@dataclasses.dataclass
class DecodeOutput:
    """One audio's result: the sampled tokens (``sample_begin`` up to the
    EOT), their text, the average log-probability of the chosen candidate
    and the no-speech probability."""

    tokens: np.ndarray
    text: str
    avg_logprob: float
    no_speech_prob: float
    audio_features: Optional[torch.Tensor] = None  # [n_audio_ctx, n_state], on the device


class DecodeTask:
    """Decodes windows with ``model`` (on its device): greedy (argmax, or
    sampled at a temperature above 0) or beam search, as ``options.mode``
    says.  ``kernels``, ``step_kernel`` (greedy only) and ``quantize_kv``
    pass through to the decode loop; with ``keep_audio_features`` each
    output carries its audio's encoder output.  ``encoder_fn(model, mel,
    kernels)``, where given, runs in the encoder's place.  ``graphs=False``
    runs the decode loop's steps eagerly on the card (see
    ``decode.loop``).

    The task keeps up to ``WindowCache.SIZE`` decode windows (one a
    prefill bucket, four), the least recently used dropped; ``close()``
    drops them all.  Each holds its own self-attention cache and cross K/V
    (K and V together, in bf16: 705 MB and 2.36 GB at base.en b128, 881 MB
    and 2.95 GB at large-v3 b12; a transcription's batch 1 a few MB), so
    that bound, times the largest shape's, is what the cache can hold."""

    def __init__(
        self,
        model: Whisper,
        tokenizer: Tokenizer,
        options: DecodeOptions = DecodeOptions(),
        *,
        keep_audio_features: bool = False,
        quantize_kv: bool = False,
        kernels: bool = True,
        step_kernel: str = "append",
        encoder_fn=None,
        graphs: bool = True,
    ):
        dims = model.dims
        self.model = model
        self.dims = dims
        self.tokenizer = tokenizer
        self.options = options
        self.keep_audio_features = keep_audio_features
        self.quantize_kv = quantize_kv
        self.kernels = kernels
        self.step_kernel = step_kernel
        self.encoder_fn = encoder_fn
        self.graphs = graphs
        self.windows = WindowCache()

        suppress: tuple = tuple(options.suppress_tokens or ())
        if options.suppress_non_speech:
            suppress = tuple(sorted(set(suppress) | set(tokenizer.non_speech_tokens())))
        max_initial_ts_index = None
        if options.timestamps and options.max_initial_timestamp is not None:
            precision = 30.0 / dims.n_audio_ctx  # 0.02 s a timestamp step
            max_initial_ts_index = int(round(options.max_initial_timestamp / precision))
        self.filter_cfg = FilterConfig(
            n_vocab=dims.n_vocab,
            token_id_eot=tokenizer.token_id_eot,
            token_id_space=tokenizer.token_id_space,
            token_id_ts_begin=tokenizer.token_id_ts_begin,
            token_id_no_timestamps=tokenizer.token_id_no_timestamps,
            suppress_blank=options.suppress_blank,
            timestamps=options.timestamps,
            suppress_ids=suppress,
            max_initial_timestamp_index=max_initial_ts_index,
        )
        self.sample_len = (
            options.sample_len if options.sample_len is not None else dims.sample_len_default
        )
        self._prompt_tokens: Optional[List[int]] = None

    def set_prompt(self, prompt: Optional[Sequence[int]]) -> None:
        """The prompt of every row of the next ``run`` (None or empty: none)."""
        self._prompt_tokens = list(prompt) if prompt is not None and len(prompt) else None

    def _shape(self, n_audio: int, prefill_width: int, sample_begin: int,
               temperature: Optional[float] = None):
        """The window shape of a ``run_batch`` call (its key_start given)."""
        mode = self.options.mode
        common = (n_audio, prefill_width, sample_begin, self.sample_len, True, self.filter_cfg,
                  self.kernels)
        if isinstance(mode, GreedyMode):
            return greedy_shape(mode, *common, self.step_kernel, self.quantize_kv,
                                temperature)[0]
        return beam_shape(mode, *common, self.quantize_kv)

    def warmup(self, batch_sizes=(1,), with_prompts: bool = True) -> None:
        """Make the decode windows of the given batch sizes before traffic
        arrives (serving: no capture in a request's latency), as the JAX
        ``warmup`` compiles them: the no-prompt bucket and, with
        ``with_prompts``, the widest prompt bucket (the two shapes
        long-audio transcription alternates between).  Each window's
        phases are captured, then its encoder and prefill run once on
        silence (which also builds the encoder's kernels).  Where the steps
        run eagerly (on the CPU, ``graphs=False``, ...) there is nothing to
        capture, and it returns."""
        if eager_reason(self.model, self.graphs) is not None:
            return
        tok = self.tokenizer
        prompts = [None]
        if with_prompts:
            prompts.append([tok.token_id_space] * (self.dims.n_text_ctx // 2))
        for n_audio in batch_sizes:
            for prompt in prompts:
                tokens, key_start, sample_begin, sot_idx = build_batch_prompts(
                    [prompt] * n_audio, tok.sequence_sot(), tok.token_id_sot,
                    tok.token_id_startofprev, self.dims.n_text_ctx,
                )
                if prompt is not None and tokens.shape[1] != PREFILL_BUCKETS[-1]:
                    raise AssertionError(f"the warm-up prompt fills bucket {tokens.shape[1]}")
                win = self.windows.get(self.model, self._shape(n_audio, tokens.shape[1],
                                                               sample_begin))
                win.prepare(self.graphs)
                dev = self.model.device
                mel = torch.zeros((n_audio, self.dims.n_mels, 3000), device=dev)
                _encode_and_prefill(
                    win, mel, torch.as_tensor(tokens, dtype=torch.long, device=dev), sot_idx,
                    tok.token_id_no_speech, torch.as_tensor(key_start, device=dev).long(),
                    self.encoder_fn,
                )
        torch.cuda.synchronize(self.model.device)

    def close(self) -> None:
        """Drop the task's decode windows (their caches, cross K/V and
        graphs); a later run makes them again."""
        self.windows.clear()

    def run(self, mel, temperature: Optional[float] = None) -> List[DecodeOutput]:
        """mel [n_mels, 3000] or [n_audio, n_mels, 3000] (numpy or tensor)
        -> one DecodeOutput per audio, every row prompted with the current
        prompt (``set_prompt``)."""
        mel = torch.as_tensor(mel)
        if mel.ndim == 2:
            mel = mel[None]
        return self.run_batch(mel, [self._prompt_tokens] * mel.shape[0], temperature=temperature)

    def run_batch(self, mel, prompts, temperature: Optional[float] = None) -> List[DecodeOutput]:
        """Decode of [n_audio, n_mels, 3000] with a prompt per row (a token
        sequence, or None): the prompts end-aligned into one prefill bucket,
        each row masked from its own ``key_start``.  ``temperature``
        overrides a greedy mode's temperature (0: the argmax; above 0: a
        draw at that temperature, the logits divided by ``max(T, 1e-6)``);
        beam search takes none."""
        mel = torch.as_tensor(mel)
        if mel.ndim == 2:
            mel = mel[None]
        n_audio = mel.shape[0]
        if len(prompts) != n_audio:
            raise ValueError(f"{len(prompts)} prompts for {n_audio} audios")
        mode = self.options.mode
        greedy = isinstance(mode, GreedyMode)
        if temperature is not None and not greedy:
            raise ValueError("a temperature override applies to greedy decoding only")
        tok = self.tokenizer
        tokens, key_start, sample_begin, sot_idx = build_batch_prompts(
            prompts, tok.sequence_sot(), tok.token_id_sot, tok.token_id_startofprev,
            self.dims.n_text_ctx,
        )
        args = (self.model, mel.to(self.model.device), tokens, sample_begin, sot_idx,
                self.filter_cfg, mode, self.sample_len, tok.token_id_no_speech)
        kwargs = dict(key_start=key_start, kernels=self.kernels, quantize_kv=self.quantize_kv,
                      encoder_fn=self.encoder_fn, graphs=self.graphs, windows=self.windows)
        if greedy:
            result = decode_greedy(*args, step_kernel=self.step_kernel,
                                   temperature=temperature, **kwargs)
        else:
            result = decode_beam(*args, **kwargs)
        selected, avg_logprob, lengths = rank_max_likelihood(
            result, sample_begin, tok.token_id_eot, self.options.length_penalty
        )
        return self._assemble(result, selected, avg_logprob, lengths, sample_begin)

    def _assemble(self, result, selected, avg_logprob, lengths,
                  sample_begin: int) -> List[DecodeOutput]:
        candidates = result.candidates.cpu().numpy()
        selected = selected.cpu().numpy()
        avg_logprob = avg_logprob.cpu().numpy()
        lengths = lengths.cpu().numpy()
        no_speech = result.no_speech_probs.float().cpu().numpy()
        outputs = []
        for i in range(candidates.shape[0]):
            sel = int(selected[i])
            toks = candidates[i, sel, sample_begin : sample_begin + int(lengths[i, sel])]
            outputs.append(DecodeOutput(
                tokens=toks,
                text=self.tokenizer.decode(toks),
                avg_logprob=float(avg_logprob[i]),
                no_speech_prob=float(no_speech[i]),
                audio_features=result.audio_features[i] if self.keep_audio_features else None,
            ))
        return outputs
