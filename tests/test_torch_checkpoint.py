"""The port's checkpoint loaders against the JAX package's, on small
synthetic checkpoints written here: an OpenAI ``.pt``, a Hugging Face
directory (``pytorch_model.bin`` or ``model.safetensors``) and a JAX
``.npz``.  Each loaded model gives the logits of ``params_from_jax`` of the
JAX loader's tree, exactly; an int8 ``.npz`` loads with its int8 leaves
int8, and a leaf of the wrong dtype raises.  Also pins ``init_random``'s
draws with a digest of a small model."""

import dataclasses
import hashlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hf_checkpoint import _CFG, _as_hf
from torch_oracle import make_random_state_dict
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.models import load_hf_checkpoint as jax_load_hf
from whisper_rs_tpu.models import load_openai_checkpoint as jax_load_openai
from whisper_rs_tpu.models.checkpoint import load_params as jax_load_params
from whisper_rs_tpu.models.checkpoint import save_params
from whisper_rs_tpu.models.quantize import quantize_params
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import (
    KVCache,
    decoder_forward,
    encoder_forward,
    hf_dims_from_config,
    init_random,
    load_checkpoint,
    load_hf_checkpoint,
    load_openai_checkpoint,
    load_params,
    params_from_jax,
    precompute_cross_kv,
)

FIELDS = dict(
    n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)


def _logits(model) -> np.ndarray:
    """Encoder on a seeded mel, then a 4-token prefill: f32 logits."""
    rng = np.random.default_rng(0)
    mel = torch.from_numpy((rng.standard_normal((1, 80, 3000)) * 0.3).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 51864, (1, 4)))
    xa = encoder_forward(model, mel)
    cache = KVCache.init(model.dims, 1, torch.float32, "cpu")
    return decoder_forward(model, tokens, 0, precompute_cross_kv(model, xa), cache).numpy()


def _want(jax_tree) -> np.ndarray:
    return _logits(params_from_jax(jax.tree.map(np.asarray, jax_tree), DIMS, device="cpu"))


@pytest.fixture(scope="module")
def state_dict():
    return make_random_state_dict(DIMS, seed=0)


def test_openai_pt(state_dict, tmp_path):
    path = tmp_path / "tiny.pt"
    torch.save({"dims": dataclasses.asdict(JDIMS), "model_state_dict": state_dict}, path)
    model, dims = load_openai_checkpoint(path, device="cpu")
    assert dims == DIMS
    jtree, jdims = jax_load_openai(str(path))
    assert dataclasses.asdict(jdims) == dataclasses.asdict(dims)
    np.testing.assert_array_equal(_logits(model), _want(jtree))
    # the auto-detecting loader takes the same path
    auto, _ = load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(_logits(auto), _logits(model))


def _hf_dir(tmp_path, state_dict, fmt: str):
    hf = _as_hf({k: v.numpy() for k, v in state_dict.items()})
    (tmp_path / "config.json").write_text(json.dumps(_CFG))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in hf.items()}, tmp_path / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file({k: np.ascontiguousarray(v) for k, v in hf.items()},
                  str(tmp_path / "model.safetensors"))
    return tmp_path


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_directory(state_dict, tmp_path, fmt):
    d = _hf_dir(tmp_path, state_dict, fmt)
    model, dims = load_hf_checkpoint(d, device="cpu")
    assert dims == DIMS == hf_dims_from_config(_CFG)
    jtree, _ = jax_load_hf(str(d))
    np.testing.assert_array_equal(_logits(model), _want(jtree))
    auto, _ = load_checkpoint(d, device="cpu")
    np.testing.assert_array_equal(_logits(auto), _logits(model))


def test_hf_safetensors_without_the_package_raises(state_dict, tmp_path, monkeypatch):
    d = _hf_dir(tmp_path, state_dict, "safetensors")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="needs the 'safetensors' package"):
        load_hf_checkpoint(d, device="cpu")


def test_jax_npz(tmp_path):
    params = init_params(jax.random.PRNGKey(3), JDIMS)
    path = tmp_path / "params.npz"
    save_params(str(path), params, JDIMS)
    model, dims = load_params(path, device="cpu")
    assert dims == DIMS
    jtree, _ = jax_load_params(str(path))
    np.testing.assert_array_equal(_logits(model), _want(jtree))
    auto, _ = load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(_logits(auto), _logits(model))


def test_jax_npz_int8_leaves_raise(tmp_path):
    """The ``.npz`` that a user saves after ``--quant int8`` loads: int8
    leaves stay int8, and the logits equal the port-quantised model's
    exactly.  A file whose int8 weight was saved as floats raises."""
    from whisper_rs_tpu_torch.models import quantize_params as port_quantize_params

    params = init_params(jax.random.PRNGKey(3), JDIMS)
    path = tmp_path / "int8.npz"
    save_params(str(path), quantize_params(params), JDIMS)
    model, dims = load_params(path, device="cpu")
    assert dims == DIMS and model.decoder.blocks[0].attn.query.weight.dtype == torch.int8
    want = port_quantize_params(params_from_jax(jax.tree.map(np.asarray, params), DIMS,
                                                device="cpu"))
    np.testing.assert_array_equal(_logits(model), _logits(want))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    flat["decoder/blocks/attn/query/w"] = flat["decoder/blocks/attn/query/w"].astype(np.float32)
    np.savez(tmp_path / "float_w.npz", **flat)
    with pytest.raises(ValueError, match="int8"):
        load_params(tmp_path / "float_w.npz", device="cpu")


def test_bf16_load_casts_every_weight(state_dict, tmp_path):
    path = tmp_path / "tiny.pt"
    torch.save({"dims": dataclasses.asdict(JDIMS), "model_state_dict": state_dict}, path)
    model, _ = load_openai_checkpoint(path, dtype=torch.bfloat16, device="cpu")
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, state_dict[name].bfloat16()), name


def test_missing_weight_raises(state_dict, tmp_path):
    sd = dict(state_dict)
    del sd["decoder.ln.bias"]
    path = tmp_path / "partial.pt"
    torch.save({"dims": dataclasses.asdict(JDIMS), "model_state_dict": sd}, path)
    with pytest.raises(KeyError, match="decoder.ln.bias"):
        load_openai_checkpoint(path, device="cpu")


# sha256 over (name, f32 bytes) of init_random(seed 3) at the small dims
# below, taken from the implementation that drew every tensor into one
# host dict before building the model.
INIT_DIGEST = {
    torch.float32: "ed6f149ecb6374e656ac3ad3e16e822b4d5d44afbc35d6d1365c40a7e1e4cdae",
    torch.bfloat16: "0a111db791ba2cad4e03755629f0ee9b6f5442e65b41e3f6eb57d5ec81b158eb",
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_init_random_draws_are_unchanged(dtype):
    dims = dataclasses.replace(DIMS, n_vocab=100)
    model = init_random(dims, 3, dtype=dtype, device="cpu")
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.float().numpy().tobytes())
    assert h.hexdigest() == INIT_DIGEST[dtype]
    assert model.dtype == dtype and not any(p.requires_grad for p in model.parameters())
