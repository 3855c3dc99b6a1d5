"""The port's GPipe encoder (whisper_rs_tpu_torch.parallel.pipeline) on the
CPU, mirroring tests/test_pipeline.py at its dims (4 encoder layers).

The torch side runs in four gloo rank processes spawned once for the
module (tests/torch_ranks.py::pipeline_rank): the pipeline encoder on a
mesh of 2 stages x 2 data ranks (4 microbatches), of 4 stages (8
microbatches) and of 2 stages x 2 model ranks (tensor parallelism inside
each stage, 4 microbatches), each rank's encoder bytes, and the CLI's
--pp transcription through ``BatchTranscriber(encoder_fn=pp_encoder_fn
(mesh))`` on the last mesh.  Four ranks hold a stage axis and one more
axis at a time; the JAX side runs on its fake 8-device mesh at the same
shapes, and both are held against one process (2e-4, the JAX test's
tolerance; tokens exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.parallel import make_mesh as jax_make_mesh
from whisper_rs_tpu.parallel import shard_params
from whisper_rs_tpu.parallel.pipeline import encoder_forward_pp as jax_encoder_forward_pp
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models.params import state_dict_from_jax
from whisper_rs_tpu_torch.parallel.mesh import Mesh
from whisper_rs_tpu_torch.parallel.sharding import shard_model

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=4, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
TOL = 2e-4  # tests/test_pipeline.py's
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def results():
    """(JAX params, every rank's results, the one-process encoder output and
    transcription, JAX's pipeline encoder at each mesh), the ranks running
    while this process computes the rest."""
    params = init_params(jax.random.PRNGKey(0), JaxDims(**FIELDS))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((8, 80, 3000)).astype(np.float32) * 0.3
    audios = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (20, 8)]
    future = torch_ranks.start_ranks(torch_ranks.pipeline_rank, 4, (sd, FIELDS, mel, audios),
                                     SPAWN_TIMEOUT)

    def single():
        from whisper_rs_tpu_torch.parallel import BatchTranscriber

        model = torch_ranks.model_of(sd, FIELDS)
        bt = BatchTranscriber(model, torch_ranks.SmallTokenizer(), torch_ranks.transcribe_options(),
                              batch_size=2)
        return model.encoder(torch.as_tensor(mel)).numpy(), torch_ranks.outputs_of(bt.run(audios))

    xa, transcribed = torch_ranks.one_thread(single)
    jax_xa = {}
    for S, D, M, n_micro in torch_ranks.PIPELINE_MESHES:
        mesh = jax_make_mesh(n_model=M, n_data=D, n_stage=S, devices=jax.devices()[:S * D * M])
        sp = shard_params(mesh, params)
        jax_xa[(S, D, M)] = np.asarray(jax.jit(
            lambda p, m: jax_encoder_forward_pp(p, m, JaxDims(**FIELDS), mesh, n_micro=n_micro)
        )(sp, jnp.asarray(mel)))
    return future.result(), xa, transcribed, jax_xa


@pytest.mark.parametrize("shape", torch_ranks.PIPELINE_MESHES,
                         ids=["2stage-2data-4micro", "4stage-8micro", "2stage-2model-4micro"])
def test_pp_encoder_matches_jax_and_single(results, shape):
    ranks, xa, _, jax_xa = results
    S, D, M, _ = shape
    for r in ranks:
        got = r[(S, D, M)]["xa"]
        np.testing.assert_allclose(got, jax_xa[(S, D, M)], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, xa, rtol=TOL, atol=TOL)


def test_pp_stage_split_cuts_encoder_bytes(results):
    """Each rank keeps its stage's L/S blocks: the encoder's block bytes fall
    by S (by about S * M with tensor parallelism inside the stage, whose
    LayerNorms and row-split biases stay whole)."""
    ranks = results[0]
    whole = 4 * ranks[0][(4, 1, 1)]["blocks_bytes"]  # a stage of 4 holds one block
    for S, D, M, _ in torch_ranks.PIPELINE_MESHES:
        layers = sorted({r[(S, D, M)]["stage_layers"] for r in ranks})
        assert layers == [(s * 4 // S, (s + 1) * 4 // S) for s in range(S)]
        for r in ranks:
            held = r[(S, D, M)]["blocks_bytes"]
            if M == 1:
                assert held * S == whole
            else:
                assert whole / (S * M) < held < 1.05 * whole / (S * M)


def test_pp_transcription_matches_single(results):
    """The CLI's --pp path on 2 stages x 2 model ranks: equal tokens, text and
    segments to one process's BatchTranscriber."""
    ranks, _, transcribed, _ = results
    for r in ranks:
        for (gt, gtext, gseg), (wt, wtext, wseg) in zip(r["transcribe"], transcribed,
                                                         strict=True):
            np.testing.assert_array_equal(gt, wt)
            assert gtext == wtext and gseg == wseg


def test_pp_rejects_bad_split():
    """4 encoder layers do not split over 3 stages; a model not cut to the
    mesh's stages is refused by the pipeline and the unsplit encoder."""
    from whisper_rs_tpu_torch.parallel.pipeline import encoder_forward_pp

    model = torch_ranks.model_of(
        state_dict_from_jax(jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0),
                                                                  JaxDims(**FIELDS))),
                            ModelDims(**FIELDS)), FIELDS)
    mel = torch.zeros(2, 80, 3000)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        shard_model(model, Mesh(n_stage=3, stage=0))
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        encoder_forward_pp(model, mel, Mesh(n_stage=3))
    with pytest.raises(ValueError, match="a stage's 2"):
        encoder_forward_pp(model, mel, Mesh(n_stage=2))
    shard_model(model, Mesh(n_stage=2, stage=1))
    assert model.encoder.stage_layers == (2, 4)
    with pytest.raises(ValueError, match="encoder_forward_pp"):
        model.encoder(mel)
