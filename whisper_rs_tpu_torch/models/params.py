"""Weights for the port's ``Whisper``: from the JAX params pytree, from an
OpenAI-format state dict, from the checkpoint files users have (OpenAI
``.pt``, a Hugging Face ``transformers`` directory, the JAX package's
``.npz``), or a seeded random init (counterpart of
``whisper_rs_tpu/models/params.py``).

All of them go through an OpenAI-format state dict (``[out, in]`` linear
weights, ``mlp.0``/``mlp.2``, ``decoder.token_embedding.weight``, ...),
which is also the ``Whisper`` module's own naming.  The JAX pytree stacks
every block along a leading L axis and stores linear weights ``[in, out]``.
Each loader returns ``(Whisper, ModelDims)`` on ``cuda`` unless the caller
names a device, and copies the weights to it one tensor at a time.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..config import ModelDims
from ..device import resolve_device
from .whisper import Whisper, sinusoids

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


def _empty_model(dims: ModelDims, dtype, device) -> Whisper:
    """A ``Whisper`` with uninitialised parameters on ``device`` in ``dtype``,
    built without a host copy; the encoder's sinusoid table is filled."""
    with torch.device("meta"):
        model = Whisper(dims)
    model = model.to(dtype=dtype).to_empty(device=device)
    model.encoder.positional_embedding.copy_(
        torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state))
    )
    return model.eval().requires_grad_(False)


def _load(model: Whisper, items) -> Whisper:
    """Copy each (name, array or tensor) into the model's parameter of that
    name, one at a time (cast to its dtype, moved to its device); every
    parameter must be given exactly once, with its shape."""
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, value in items:
            if name not in params or name in seen:
                raise KeyError(f"unexpected or repeated weight {name!r}")
            src = value if torch.is_tensor(value) else torch.from_numpy(np.require(value, requirements="W"))
            if tuple(src.shape) != tuple(params[name].shape):
                raise ValueError(
                    f"{name}: shape {tuple(src.shape)}, expected {tuple(params[name].shape)}"
                )
            params[name].copy_(src.float())
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"missing weights: {missing[:5]}{' ...' if len(missing) > 5 else ''}")
    return model


def params_from_state_dict(
    sd: dict, dims: ModelDims, *, dtype=torch.float32, device=None
) -> Whisper:
    """An OpenAI-format state dict (numpy arrays or tensors) -> ``Whisper``
    on ``device`` (``cuda`` unless named) in ``dtype``.  The encoder's
    sinusoid table is recomputed, never loaded."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    sd.pop("encoder.positional_embedding", None)
    return _load(_empty_model(dims, dtype, dev), sd.items())


def params_from_jax(tree: dict, dims: ModelDims, *, dtype=torch.float32, device=None) -> Whisper:
    """The JAX params pytree (``whisper_rs_tpu.models.init_params`` layout)
    -> ``Whisper`` on ``device`` in ``dtype``."""
    return params_from_state_dict(state_dict_from_jax(tree, dims), dims, dtype=dtype, device=device)


def _random_weights(dims: ModelDims, seed: int):
    """(name, array) in a fixed order, drawn from numpy one tensor at a time
    with the scales of the JAX ``init_params``."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    def block(prefix: str, n: int, cross: bool):
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            for name in _LINEARS:
                yield f"{prefix}.{attn}.{name}.weight", normal((n, n), n**-0.5)
                if name != "key":
                    yield f"{prefix}.{attn}.{name}.bias", np.zeros(n, np.float32)
            yield f"{prefix}.{attn}_ln.weight", np.ones(n, np.float32)
            yield f"{prefix}.{attn}_ln.bias", np.zeros(n, np.float32)
        yield f"{prefix}.mlp.0.weight", normal((4 * n, n), n**-0.5)
        yield f"{prefix}.mlp.0.bias", np.zeros(4 * n, np.float32)
        yield f"{prefix}.mlp.2.weight", normal((n, 4 * n), (4 * n) ** -0.5)
        yield f"{prefix}.mlp.2.bias", np.zeros(n, np.float32)
        yield f"{prefix}.mlp_ln.weight", np.ones(n, np.float32)
        yield f"{prefix}.mlp_ln.bias", np.zeros(n, np.float32)

    na, nt = dims.n_audio_state, dims.n_text_state
    yield "encoder.conv1.weight", normal((na, dims.n_mels, 3), 0.02)
    yield "encoder.conv1.bias", np.zeros(na, np.float32)
    yield "encoder.conv2.weight", normal((na, na, 3), 0.02)
    yield "encoder.conv2.bias", np.zeros(na, np.float32)
    for i in range(dims.n_audio_layer):
        yield from block(f"encoder.blocks.{i}", na, cross=False)
    yield "encoder.ln_post.weight", np.ones(na, np.float32)
    yield "encoder.ln_post.bias", np.zeros(na, np.float32)
    yield "decoder.token_embedding.weight", normal((dims.n_vocab, nt), 0.02)
    yield "decoder.positional_embedding", normal((dims.n_text_ctx, nt), 0.02)
    for i in range(dims.n_text_layer):
        yield from block(f"decoder.blocks.{i}", nt, cross=True)
    yield "decoder.ln.weight", np.ones(nt, np.float32)
    yield "decoder.ln.bias", np.zeros(nt, np.float32)


def init_random(dims: ModelDims, seed: int, *, dtype=torch.float32, device=None) -> Whisper:
    """Seeded random weights with the scales of the JAX ``init_params``:
    linear weights N(0, 1/n_in), biases 0, LayerNorms 1/0, conv and
    embedding weights N(0, 0.02^2).  The draws are numpy's, not JAX's.
    Each tensor is drawn and moved to the device on its own, so the host
    never holds more than one (large-v3's 1.55 B weights are 6.2 GB in
    f32)."""
    dev = resolve_device(device)
    return _load(_empty_model(dims, dtype, dev), _random_weights(dims, seed))


def _dims_from(d: dict) -> ModelDims:
    return ModelDims(**{f: int(d[f]) for f in ModelDims.__dataclass_fields__})


def load_openai_checkpoint(path, *, dtype=torch.float32, device=None):
    """An OpenAI whisper ``.pt`` checkpoint (``{"dims": ..., "model_state_dict":
    ...}``) -> (``Whisper``, ``ModelDims``)."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and "model_state_dict" in ckpt and "dims" in ckpt):
        raise ValueError("expected an OpenAI whisper checkpoint with 'dims' and 'model_state_dict'")
    dims = _dims_from(ckpt["dims"])
    return params_from_state_dict(ckpt["model_state_dict"], dims, dtype=dtype, device=dev), dims


# Hugging Face transformers (WhisperForConditionalGeneration) module path ->
# OpenAI name fragment, inside each layer block.
_HF_LAYER_MAP = {
    "self_attn.q_proj": "attn.query",
    "self_attn.k_proj": "attn.key",
    "self_attn.v_proj": "attn.value",
    "self_attn.out_proj": "attn.out",
    "self_attn_layer_norm": "attn_ln",
    "encoder_attn.q_proj": "cross_attn.query",
    "encoder_attn.k_proj": "cross_attn.key",
    "encoder_attn.v_proj": "cross_attn.value",
    "encoder_attn.out_proj": "cross_attn.out",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "fc1": "mlp.0",
    "fc2": "mlp.2",
    "final_layer_norm": "mlp_ln",
}

_HF_TOP_MAP = {
    "encoder.layer_norm": "encoder.ln_post",
    "decoder.layer_norm": "decoder.ln",
    "decoder.embed_tokens": "decoder.token_embedding",
}


def hf_rename_state_dict(sd: dict) -> dict:
    """HF transformers Whisper names -> OpenAI names.  Drops the encoder's
    fixed sinusoid table and the tied ``proj_out``."""
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("model.")
        if k.startswith("proj_out.") or k == "encoder.embed_positions.weight":
            continue  # tied to embed_tokens / recomputed sinusoids
        if k == "decoder.embed_positions.weight":
            out["decoder.positional_embedding"] = v
            continue
        parts = k.split(".")
        if len(parts) >= 3 and parts[1] == "layers":
            side, idx = parts[0], parts[2]
            mapped = _HF_LAYER_MAP.get(".".join(parts[3:-1]))
            if mapped is None:
                raise KeyError(f"unrecognized HF layer param: {k}")
            out[f"{side}.blocks.{idx}.{mapped}.{parts[-1]}"] = v
            continue
        prefix, param = k.rsplit(".", 1)
        out[f"{_HF_TOP_MAP.get(prefix, prefix)}.{param}"] = v
    return out


def hf_dims_from_config(cfg: dict) -> ModelDims:
    """``ModelDims`` from an HF transformers Whisper ``config.json`` dict."""
    return ModelDims(
        n_mels=cfg["num_mel_bins"],
        n_vocab=cfg["vocab_size"],
        n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_text_ctx=cfg["max_target_positions"],
        n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
    )


def load_hf_checkpoint(path, *, dtype=torch.float32, device=None):
    """An HF transformers Whisper checkpoint directory (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``) -> (``Whisper``,
    ``ModelDims``).  ``model.safetensors`` needs the ``safetensors``
    package."""
    dev = resolve_device(device)
    d = pathlib.Path(path)
    dims = hf_dims_from_config(json.loads((d / "config.json").read_text()))
    st = d / "model.safetensors"
    if st.exists():
        try:
            from safetensors.torch import load_file
        except ImportError:
            raise RuntimeError(
                f"{st} needs the 'safetensors' package, which is not installed; "
                "install it, or save the weights as pytorch_model.bin"
            ) from None
        sd = load_file(str(st))
    else:
        sd = torch.load(d / "pytorch_model.bin", map_location="cpu", weights_only=True)
    return params_from_state_dict(hf_rename_state_dict(sd), dims, dtype=dtype, device=dev), dims


def load_checkpoint(path, *, dtype=torch.float32, device=None):
    """Auto-detecting loader: an HF checkpoint directory, the JAX package's
    ``.npz`` (``save_params``), or an OpenAI ``.pt`` -> (``Whisper``,
    ``ModelDims``)."""
    p = pathlib.Path(path)
    if p.is_dir():
        return load_hf_checkpoint(p, dtype=dtype, device=device)
    if p.suffix == ".npz":
        from .checkpoint import load_params

        return load_params(p, dtype=dtype, device=device)
    return load_openai_checkpoint(p, dtype=dtype, device=device)
