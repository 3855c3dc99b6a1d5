"""Weights for the port's ``Whisper``: from the JAX params pytree, from an
OpenAI-format state dict, or a seeded random init (counterpart of
``whisper_rs_tpu/models/params.py``).

All three go through an OpenAI-format state dict (``[out, in]`` linear
weights, ``mlp.0``/``mlp.2``, ``decoder.token_embedding.weight``, ...),
which is also the ``Whisper`` module's own naming.  The JAX pytree stacks
every block along a leading L axis and stores linear weights ``[in, out]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelDims
from ..device import resolve_device
from .whisper import Whisper

_LINEARS = ("query", "key", "value", "out")


def _no_int8(p: dict, what: str) -> None:
    if "s" in p or "token_emb_scale" in p:
        raise NotImplementedError(
            f"int8-quantized JAX params ({what}) wait for the quantisation slice"
        )


def _jax_block(sd: dict, prefix: str, blocks: dict, i: int, cross: bool) -> None:
    def lin(name: str, p: dict):
        _no_int8(p, name)
        sd[f"{name}.weight"] = np.asarray(p["w"][i]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"][i])

    def ln(name: str, p: dict):
        sd[f"{name}.weight"] = np.asarray(p["scale"][i])
        sd[f"{name}.bias"] = np.asarray(p["bias"][i])

    attns = ("attn", "cross_attn") if cross else ("attn",)
    for attn in attns:
        for n in _LINEARS:
            lin(f"{prefix}.{attn}.{n}", blocks[attn][n])
        ln(f"{prefix}.{attn}_ln", blocks[f"{attn}_ln"])
    lin(f"{prefix}.mlp.0", blocks["mlp"]["fc1"])
    lin(f"{prefix}.mlp.2", blocks["mlp"]["fc2"])
    ln(f"{prefix}.mlp_ln", blocks["mlp_ln"])


def state_dict_from_jax(tree: dict, dims: ModelDims) -> dict:
    """The JAX params pytree (numpy or jax arrays) -> OpenAI-format dict of
    numpy arrays.  Raises on int8-quantized params."""
    enc, dec = tree["encoder"], tree["decoder"]
    _no_int8(dec, "decoder.token_emb")
    sd = {}
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = np.asarray(enc[conv]["w"])
        sd[f"encoder.{conv}.bias"] = np.asarray(enc[conv]["b"])
    for i in range(dims.n_audio_layer):
        _jax_block(sd, f"encoder.blocks.{i}", enc["blocks"], i, cross=False)
    sd["encoder.ln_post.weight"] = np.asarray(enc["ln_post"]["scale"])
    sd["encoder.ln_post.bias"] = np.asarray(enc["ln_post"]["bias"])
    sd["decoder.token_embedding.weight"] = np.asarray(dec["token_emb"])
    sd["decoder.positional_embedding"] = np.asarray(dec["pos_emb"])
    for i in range(dims.n_text_layer):
        _jax_block(sd, f"decoder.blocks.{i}", dec["blocks"], i, cross=True)
    sd["decoder.ln.weight"] = np.asarray(dec["ln"]["scale"])
    sd["decoder.ln.bias"] = np.asarray(dec["ln"]["bias"])
    return sd


def params_from_state_dict(
    sd: dict, dims: ModelDims, *, dtype=torch.float32, device=None
) -> Whisper:
    """An OpenAI-format state dict (numpy arrays or tensors) -> ``Whisper``
    on ``device`` (``cuda`` unless named) in ``dtype``.  The encoder's
    sinusoid table is recomputed, never loaded."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    sd.pop("encoder.positional_embedding", None)
    tensors = {
        k: v.float() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
        for k, v in sd.items()
    }
    model = Whisper(dims)
    model.load_state_dict(tensors, strict=True)
    return model.to(device=dev, dtype=dtype).eval().requires_grad_(False)


def params_from_jax(tree: dict, dims: ModelDims, *, dtype=torch.float32, device=None) -> Whisper:
    """The JAX params pytree (``whisper_rs_tpu.models.init_params`` layout)
    -> ``Whisper`` on ``device`` in ``dtype``."""
    return params_from_state_dict(state_dict_from_jax(tree, dims), dims, dtype=dtype, device=device)


def init_random(dims: ModelDims, seed: int, *, dtype=torch.float32, device=None) -> Whisper:
    """Seeded random weights with the scales of the JAX ``init_params``:
    linear weights N(0, 1/n_in), biases 0, LayerNorms 1/0, conv and
    embedding weights N(0, 0.02^2).  The draws are numpy's, not JAX's."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    sd = {}

    def block(prefix: str, n: int, cross: bool):
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            for name in _LINEARS:
                sd[f"{prefix}.{attn}.{name}.weight"] = normal((n, n), n**-0.5)
                if name != "key":
                    sd[f"{prefix}.{attn}.{name}.bias"] = np.zeros(n, np.float32)
            sd[f"{prefix}.{attn}_ln.weight"] = np.ones(n, np.float32)
            sd[f"{prefix}.{attn}_ln.bias"] = np.zeros(n, np.float32)
        sd[f"{prefix}.mlp.0.weight"] = normal((4 * n, n), n**-0.5)
        sd[f"{prefix}.mlp.0.bias"] = np.zeros(4 * n, np.float32)
        sd[f"{prefix}.mlp.2.weight"] = normal((n, 4 * n), (4 * n) ** -0.5)
        sd[f"{prefix}.mlp.2.bias"] = np.zeros(n, np.float32)
        sd[f"{prefix}.mlp_ln.weight"] = np.ones(n, np.float32)
        sd[f"{prefix}.mlp_ln.bias"] = np.zeros(n, np.float32)

    na, nt = dims.n_audio_state, dims.n_text_state
    sd["encoder.conv1.weight"] = normal((na, dims.n_mels, 3), 0.02)
    sd["encoder.conv1.bias"] = np.zeros(na, np.float32)
    sd["encoder.conv2.weight"] = normal((na, na, 3), 0.02)
    sd["encoder.conv2.bias"] = np.zeros(na, np.float32)
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", na, cross=False)
    sd["encoder.ln_post.weight"] = np.ones(na, np.float32)
    sd["encoder.ln_post.bias"] = np.zeros(na, np.float32)
    sd["decoder.token_embedding.weight"] = normal((dims.n_vocab, nt), 0.02)
    sd["decoder.positional_embedding"] = normal((dims.n_text_ctx, nt), 0.02)
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", nt, cross=True)
    sd["decoder.ln.weight"] = np.ones(nt, np.float32)
    sd["decoder.ln.bias"] = np.zeros(nt, np.float32)
    return params_from_state_dict(sd, dims, dtype=dtype, device=device)
