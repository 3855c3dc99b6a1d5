"""The port's Ulysses sequence-parallel encoder
(whisper_rs_tpu_torch.parallel.ulysses) on the CPU, mirroring
tests/test_ulysses.py at its dims.

The torch side runs in four gloo rank processes spawned once for the
module (tests/torch_ranks.py::ulysses_rank): the encoder over 4 model
ranks and over 2 (x 2 data ranks), greedy decoding with it through the
``encoder_fn`` seam (the batch split over the data ranks), and 750 frames
over 4 ranks, which 4 does not divide (padded to 752 and masked by
n_valid).  The JAX side runs ``encoder_forward_ulysses`` on its fake mesh
at the same shapes; both are held against one process at the JAX test's
2e-4, the tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.parallel import make_mesh as jax_make_mesh
from whisper_rs_tpu.parallel.ulysses import encoder_forward_ulysses as jax_ulysses
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models.params import state_dict_from_jax
from whisper_rs_tpu_torch.parallel.mesh import Mesh
from whisper_rs_tpu_torch.parallel.ulysses import encoder_forward_ulysses

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=4, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
SHORT = dict(FIELDS, n_audio_ctx=750, n_audio_layer=2)
TOL = 2e-4  # tests/test_ulysses.py's
SPAWN_TIMEOUT = 240


def _sd(params, fields):
    return state_dict_from_jax(jax.tree.map(np.asarray, params), ModelDims(**fields))


@pytest.fixture(scope="module")
def results():
    """(every rank's results, one process's, JAX's), the ranks running while
    this process computes the other two."""
    params = init_params(jax.random.PRNGKey(0), JaxDims(**FIELDS))
    short = init_params(jax.random.PRNGKey(1), JaxDims(**SHORT))
    sd, sd_short = _sd(params, FIELDS), _sd(short, SHORT)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((4, 80, 3000)).astype(np.float32) * 0.3
    mel_short = rng.standard_normal((2, 80, 1500)).astype(np.float32) * 0.3
    future = torch_ranks.start_ranks(torch_ranks.ulysses_rank, 4,
                                     (sd, FIELDS, mel, sd_short, SHORT, mel_short), SPAWN_TIMEOUT)

    def single():
        from whisper_rs_tpu_torch.decode import decode_greedy

        model = torch_ranks.model_of(sd, FIELDS)
        r = decode_greedy(model, torch.as_tensor(mel), np.full((4, 1), torch_ranks.SOT), 1, 0,
                          torch_ranks.filter_config(1000), torch_ranks.GreedyMode(), 8,
                          torch_ranks.NO_SPEECH)
        xa_short = torch_ranks.model_of(sd_short, SHORT).encoder(torch.as_tensor(mel_short))
        return {"xa": r.audio_features.numpy(), "greedy": (r.candidates.numpy(), r.scores.numpy()),
                "short": xa_short.numpy()}

    one = torch_ranks.one_thread(single)
    jax_out = {}
    for M, D in ((4, 1), (2, 2)):
        mesh = jax_make_mesh(n_model=M, n_data=D, devices=jax.devices()[:4])
        with jax.set_mesh(mesh):
            jax_out[M] = np.asarray(jax_ulysses(params, jnp.asarray(mel), JaxDims(**FIELDS), mesh))
    cfg = JaxFilterConfig(n_vocab=1000, **torch_ranks.CFG_KW)
    r = jax_decode_greedy(params, jnp.asarray(mel), jnp.full((4, 1), torch_ranks.SOT, jnp.int32),
                          jnp.int32(1), jnp.int32(0), JaxDims(**FIELDS), cfg, JaxGreedy(), 8,
                          no_speech_id=torch_ranks.NO_SPEECH)
    jax_out["greedy"] = (np.asarray(r.candidates), np.asarray(r.scores))
    return future.result(), one, jax_out


@pytest.mark.parametrize("n", [4, 2], ids=["4-ranks", "2-ranks-2-data"])
def test_ulysses_matches_jax_and_single(results, n):
    ranks, one, jax_out = results
    for r in ranks:
        np.testing.assert_allclose(r[n], jax_out[n], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r[n], one["xa"], rtol=TOL, atol=TOL)


def test_ulysses_greedy_matches_single(results):
    """Greedy decoding with the Ulysses encoder through ``encoder_fn`` on 2
    model x 2 data ranks: the one process's tokens (the JAX loop's)."""
    ranks, one, jax_out = results
    np.testing.assert_array_equal(one["greedy"][0], jax_out["greedy"][0])
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"][0], one["greedy"][0])
        np.testing.assert_allclose(r["greedy"][1], one["greedy"][1], rtol=1e-4, atol=1e-4)


def test_ulysses_pads_a_sequence_the_ranks_do_not_divide(results):
    """750 frames over 4 ranks: padded to 752, the two pad keys masked."""
    ranks, one, _ = results
    for r in ranks:
        np.testing.assert_allclose(r["short"], one["short"], rtol=TOL, atol=TOL)


def test_ulysses_rejects_indivisible_heads():
    model = torch_ranks.model_of(_sd(init_params(jax.random.PRNGKey(0), JaxDims(**FIELDS)),
                                     FIELDS), FIELDS)
    with pytest.raises(ValueError, match="divisible"):
        encoder_forward_ulysses(model, torch.zeros(1, 80, 3000), Mesh(n_model=3))
