"""Whisper model modules, caches and weight loading."""

from .checkpoint import load_params, save_params
from .params import (
    hf_dims_from_config,
    hf_rename_state_dict,
    init_random,
    load_checkpoint,
    load_hf_checkpoint,
    load_openai_checkpoint,
    params_from_jax,
    params_from_state_dict,
)
from .quantize import quantize_params
from .whisper import (
    AudioEncoder,
    CrossKV,
    KVCache,
    QuantEmbedding,
    QuantLinear,
    TextDecoder,
    Whisper,
    decoder_forward,
    encoder_forward,
    precompute_cross_kv,
    quantize_kv,
)

__all__ = [
    "AudioEncoder",
    "CrossKV",
    "KVCache",
    "QuantEmbedding",
    "QuantLinear",
    "TextDecoder",
    "Whisper",
    "decoder_forward",
    "encoder_forward",
    "hf_dims_from_config",
    "hf_rename_state_dict",
    "init_random",
    "load_checkpoint",
    "load_hf_checkpoint",
    "load_openai_checkpoint",
    "load_params",
    "params_from_jax",
    "params_from_state_dict",
    "precompute_cross_kv",
    "quantize_kv",
    "quantize_params",
    "save_params",
]
