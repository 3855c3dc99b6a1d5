"""Two processes started by the port's ``initialize_multihost`` over a
localhost coordinator (the counterpart of tests/test_multihost.py and
tests/multihost_worker.py): each "host" ingests its own audio, encodes it
on the 2-rank data-parallel mesh, and gathers every host's features; a
per-host value (the sum of its |features|) is summed over the group; then the same gather runs with
every tensor taken as a card's, staged through host memory.  Held against
the port's single process and the JAX encoder on the same weights and
audio (2e-4)."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import encoder_forward as jax_encoder_forward
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu_torch.audio.mel import pad_or_trim
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models.params import state_dict_from_jax
from whisper_rs_tpu_torch.ops.mel import log_mel_file

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
SECONDS = 5
TOL = 2e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(0), JaxDims(**FIELDS))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS))
    future = torch_ranks.start_ranks(torch_ranks.multihost_rank, 2, (sd, FIELDS, SECONDS), 240,
                                     coordinator=f"127.0.0.1:{_free_port()}")
    # every host's audio, which this process knows by its seed
    mels = torch.stack([pad_or_trim(log_mel_file(
        (np.random.default_rng(r).standard_normal(16000 * SECONDS) * 0.1).astype(np.float32),
        80, device="cpu"), 3000) for r in range(2)])
    single = torch_ranks.one_thread(lambda: torch_ranks.model_of(sd, FIELDS).encoder(mels))
    jax_xa = np.asarray(jax_encoder_forward(params, jnp.asarray(mels.numpy()), JaxDims(**FIELDS)))
    return future.result(), single.numpy(), jax_xa


def test_two_process_dp_encoder(setup):
    ranks, single, jax_xa = setup
    assert [r["mesh"] for r in ranks] == [(0, 0, 0), (0, 1, 0)]
    for r in ranks:
        np.testing.assert_allclose(r["xa"], single, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["xa"], jax_xa, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["total"], np.abs(single.astype(np.float64)).sum(), rtol=1e-5)


def test_staged_collectives_give_the_same_result(setup):
    """With every tensor taken as a card's under gloo, the gather goes
    through host buffers: the same features, one collective, and the bytes
    staged out (the rank's block) and back in (both blocks) counted."""
    ranks, single, _ = setup
    for r in ranks:
        np.testing.assert_array_equal(r["staged"], r["xa"])
        assert r["stats"] == {"collectives": 1, "bytes_staged": 3 * r["local_bytes"]}
