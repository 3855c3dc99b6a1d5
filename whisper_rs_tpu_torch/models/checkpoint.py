"""The JAX package's ``.npz`` parameter files (counterpart of
``whisper_rs_tpu/models/checkpoint.py``).

A file holds the stacked params pytree flattened to one ``.npz``: each key
is the leaf's tree path joined by ``/`` (``decoder/blocks/mlp/fc1/w``), and
``__dims__`` holds the ``ModelDims`` as JSON bytes.  ``load_params``
unflattens a file and loads the tree through ``state_dict_from_jax``;
``save_params`` writes a ``Whisper`` in that layout, its inverse (linear
weights ``[L, in, out]``, blocks stacked along L, floating leaves in f32,
int8 weights and the int8 token table kept int8 beside their f32 scales),
so that both packages' ``load_params`` read it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..device import resolve_device
from .params import _LINEARS, _dims_from, params_from_jax


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params(path, *, dtype=torch.float32, device=None):
    """A ``.npz`` written by the JAX ``save_params`` -> (``Whisper``,
    ``ModelDims``).  Floating leaves take ``dtype``; int8 leaves (the
    weights of ``quantize_params``) stay int8, as in the JAX
    ``load_params``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dims = _dims_from(json.loads(bytes(flat.pop("__dims__")).decode()))
    return params_from_jax(_unflatten(flat), dims, dtype=dtype, device=dev), dims


def _leaf(t: torch.Tensor) -> np.ndarray:
    """A parameter as a host array: int8 as it is, floating in f32."""
    t = t.detach().cpu()
    return t.numpy() if t.dtype == torch.int8 else t.float().numpy()


def jax_tree(model) -> dict:
    """The JAX params pytree of ``model`` (numpy leaves): the inverse of
    ``state_dict_from_jax``."""
    dims = model.dims
    p = {name: _leaf(t) for name, t in model.named_parameters()}

    def stacked(prefix: str, n: int, suffix: str) -> np.ndarray:
        return np.stack([p[f"{prefix}.{i}.{suffix}"] for i in range(n)])

    def linear(prefix: str, n: int, name: str) -> dict:
        out = {"w": np.stack([np.ascontiguousarray(p[f"{prefix}.{i}.{name}.weight"].T)
                              for i in range(n)])}
        for key, suffix in (("s", "scale"), ("b", "bias")):
            if f"{prefix}.0.{name}.{suffix}" in p:
                out[key] = stacked(prefix, n, f"{name}.{suffix}")
        return out

    def ln(prefix: str, n: int, name: str) -> dict:
        return {"scale": stacked(prefix, n, f"{name}.weight"),
                "bias": stacked(prefix, n, f"{name}.bias")}

    def blocks(prefix: str, n: int, cross: bool) -> dict:
        tree = {}
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            tree[attn] = {lin: linear(prefix, n, f"{attn}.{lin}") for lin in _LINEARS}
            tree[f"{attn}_ln"] = ln(prefix, n, f"{attn}_ln")
        tree["mlp"] = {"fc1": linear(prefix, n, "mlp.0"), "fc2": linear(prefix, n, "mlp.2")}
        tree["mlp_ln"] = ln(prefix, n, "mlp_ln")
        return tree

    encoder = {conv: {"w": p[f"encoder.{conv}.weight"], "b": p[f"encoder.{conv}.bias"]}
               for conv in ("conv1", "conv2")}
    encoder["blocks"] = blocks("encoder.blocks", dims.n_audio_layer, cross=False)
    encoder["ln_post"] = {"scale": p["encoder.ln_post.weight"], "bias": p["encoder.ln_post.bias"]}
    decoder = {"token_emb": p["decoder.token_embedding.weight"],
               "pos_emb": p["decoder.positional_embedding"],
               "blocks": blocks("decoder.blocks", dims.n_text_layer, cross=True),
               "ln": {"scale": p["decoder.ln.weight"], "bias": p["decoder.ln.bias"]}}
    if "decoder.token_embedding.scale" in p:
        decoder["token_emb_scale"] = p["decoder.token_embedding.scale"]
    return {"encoder": encoder, "decoder": decoder}


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def save_params(path, model) -> None:
    """Write ``model`` (a ``Whisper``, f32, bf16 or int8-quantised) to
    ``path`` as the JAX ``save_params`` writes its params: the pytree of
    ``jax_tree`` flattened by ``/``, and ``__dims__``."""
    flat = _flatten(jax_tree(model))
    flat["__dims__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(model.dims)).encode(), dtype=np.uint8
    )
    np.savez(path, **flat)
