"""The port's ``save_params`` (``whisper_rs_tpu_torch/models/checkpoint.py``)
against the JAX package's ``.npz`` layout: a file the port writes from a
model made of JAX params reads back through the JAX ``load_params`` as
those params, leaf for leaf (f32, and int8 after ``quantize_params``); a
port save followed by a port ``load_params`` gives the same model; a bf16
model is written in f32."""

import jax
import numpy as np
import pytest
import torch

from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.models.checkpoint import load_params as jax_load_params
from whisper_rs_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_rs_tpu_torch import save_params
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import load_params, params_from_jax

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(4), JDIMS))


@pytest.mark.parametrize("int8", [False, True])
def test_port_save_reads_back_through_jax_load_params(params, int8, tmp_path):
    tree = jax.tree.map(np.asarray, jax_quantize_params(params)) if int8 else params
    model = params_from_jax(tree, DIMS, device="cpu")
    path = tmp_path / "port.npz"
    save_params(path, model)
    loaded, dims = jax_load_params(str(path))
    assert dims == JDIMS
    want, got = _leaves(tree), _leaves(loaded)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    if int8:
        assert got["['decoder']['blocks']['mlp']['fc1']['w']"].dtype == np.int8


@pytest.mark.parametrize("int8", [False, True])
def test_port_save_then_port_load_is_the_same_model(params, int8, tmp_path):
    tree = jax.tree.map(np.asarray, jax_quantize_params(params)) if int8 else params
    model = params_from_jax(tree, DIMS, device="cpu")
    path = tmp_path / "port.npz"
    save_params(path, model)
    again, dims = load_params(path, device="cpu")
    assert dims == DIMS
    want, got = model.state_dict(), again.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def test_a_bf16_model_is_written_in_f32(params, tmp_path):
    model = params_from_jax(params, DIMS, dtype=torch.bfloat16, device="cpu")
    path = tmp_path / "bf16.npz"
    save_params(path, model)
    with np.load(path) as z:
        assert z["decoder/token_emb"].dtype == np.float32
        np.testing.assert_array_equal(
            z["decoder/blocks/attn/query/w"][1],
            model.decoder.blocks[1].attn.query.weight.float().T.numpy())
    loaded, _ = load_params(path, dtype=torch.bfloat16, device="cpu")
    for name, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], t), name
