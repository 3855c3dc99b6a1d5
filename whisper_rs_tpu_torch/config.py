"""Model configuration registry (counterpart of ``whisper_rs_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package:
``ModelDims``, the registry of released Whisper sizes, ``GreedyMode``,
``BeamSearchMode``, and the decode and transcription options
``DecodeOptions`` and ``TranscribeOptions`` (same fields and defaults).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Architecture hyperparameters of one Whisper model."""

    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        assert self.n_audio_state % self.n_audio_head == 0
        return self.n_audio_state // self.n_audio_head

    @property
    def sample_len_default(self) -> int:
        return self.n_text_ctx // 2


def _dims(n_mels, n_vocab, state, head, layer, text_layer=None) -> ModelDims:
    return ModelDims(
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_text_ctx=448,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer if text_layer is None else text_layer,
    )


# English-only checkpoints use a 51864-token vocab, multilingual 51865,
# large-v3 51866.  large-v3 also moves to 128 mel bins.
MODEL_REGISTRY = {
    "tiny.en": _dims(80, 51864, 384, 6, 4),
    "tiny": _dims(80, 51865, 384, 6, 4),
    "base.en": _dims(80, 51864, 512, 8, 6),
    "base": _dims(80, 51865, 512, 8, 6),
    "small.en": _dims(80, 51864, 768, 12, 12),
    "small": _dims(80, 51865, 768, 12, 12),
    "medium.en": _dims(80, 51864, 1024, 16, 24),
    "medium": _dims(80, 51865, 1024, 16, 24),
    "large-v1": _dims(80, 51865, 1280, 20, 32),
    "large-v2": _dims(80, 51865, 1280, 20, 32),
    "large-v3": _dims(128, 51866, 1280, 20, 32),
    "large-v3-turbo": _dims(128, 51866, 1280, 20, 32, text_layer=4),
    "distil-small.en": _dims(80, 51864, 768, 12, 12, text_layer=4),
    "distil-medium.en": _dims(80, 51864, 1024, 16, 24, text_layer=2),
    "distil-large-v2": _dims(80, 51865, 1280, 20, 32, text_layer=2),
    "distil-large-v3": _dims(128, 51866, 1280, 20, 32, text_layer=2),
}


def dims_for(name: str) -> ModelDims:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class GreedyMode:
    """Greedy token extraction; ``group_size`` rows per audio share one
    cross-attention K/V."""

    group_size: int = 1
    temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class BeamSearchMode:
    """Beam-search token extraction: ``beam_size`` rows per audio; the
    search stops once ``max(beam_size, round(patience * beam_size))``
    sequences of every audio have finished."""

    beam_size: int = 5
    patience: float = 1.0


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Single-window decode options; the defaults are the reference
    example's (beam 5, timestamps, blank and non-speech suppression)."""

    sample_len: Optional[int] = None
    mode: object = BeamSearchMode(beam_size=5, patience=1.0)
    length_penalty: Optional[float] = None
    max_initial_timestamp: Optional[float] = 1.0
    timestamps: bool = True
    suppress_blank: bool = True
    suppress_non_speech: bool = True
    suppress_tokens: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class TranscribeOptions:
    """Long-audio transcription options.  ``initial_prompt_tokens`` or
    ``initial_prompt_text`` prompt the first window and switch prompt
    conditioning on; else ``condition_on_prev_text`` decides.  A window
    with ``no_speech_prob > no_speech_threshold`` and ``avg_logprob <
    logprob_threshold`` is skipped as silence (None: never).
    ``temperatures`` is the fallback ladder (with
    ``compression_ratio_threshold`` and ``logprob_threshold``);
    ``word_timestamps`` aligns each window's words (with
    ``alignment_heads``, default the upper half of the decoder's heads)."""

    decode: DecodeOptions = DecodeOptions()
    initial_prompt_tokens: Optional[Tuple[int, ...]] = None
    initial_prompt_text: Optional[str] = None
    condition_on_prev_text: bool = True
    no_speech_threshold: Optional[float] = None
    logprob_threshold: float = -1.0
    temperatures: Optional[Tuple[float, ...]] = None
    compression_ratio_threshold: float = 2.4
    word_timestamps: bool = False
    alignment_heads: Optional[Tuple[Tuple[int, int], ...]] = None
