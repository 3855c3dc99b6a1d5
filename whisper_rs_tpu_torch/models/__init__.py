"""Whisper model modules, caches and weight loading."""

from .params import init_random, params_from_jax, params_from_state_dict
from .whisper import (
    AudioEncoder,
    CrossKV,
    KVCache,
    TextDecoder,
    Whisper,
    decoder_forward,
    encoder_forward,
    precompute_cross_kv,
)

__all__ = [
    "AudioEncoder",
    "CrossKV",
    "KVCache",
    "TextDecoder",
    "Whisper",
    "decoder_forward",
    "encoder_forward",
    "init_random",
    "params_from_jax",
    "params_from_state_dict",
    "precompute_cross_kv",
]
