"""The port's tensor and data parallelism (whisper_rs_tpu_torch.parallel:
mesh, sharding, collectives) on the CPU, mirroring tests/test_sharding.py.

The torch side runs in four gloo rank processes on a 2 (data) x 2 (model)
mesh, spawned once for the module (``run_ranks``, tests/torch_ranks.py);
the JAX side on the same mesh shape over the first four devices of the
fake 8-device mesh, and both against one process.  Weights are the JAX
``init_params(PRNGKey(0))`` at the JAX test's dims (64 wide, 4 heads,
2 + 2 layers, vocab 1024) through ``params_from_jax``.

Checked: each parameter's split dim against the JAX ``param_shardings``
(int8 leaves included); each rank's bytes cut by the split; TP 2 logits;
DP 2 x TP 2 greedy, beam and sampled decodes (tokens exactly, scores at
test_sharding.py's 1e-3); int8 weights and K/V under TP (with the
int8×int8 matmuls too); the DP batch driver; word timestamps under TP; a
vocab of 1001 rows, which 2 does not divide (one pad row, which never
wins)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from whisper_rs_tpu.config import BeamSearchMode as JaxBeam
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_beam as jax_decode_beam
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import init_params, model_forward
from whisper_rs_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_rs_tpu.parallel import batch_sharding
from whisper_rs_tpu.parallel import make_mesh as jax_make_mesh
from whisper_rs_tpu.parallel import param_shardings as jax_param_shardings
from whisper_rs_tpu.parallel import shard_params
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models import params_from_jax, quantize_params
from whisper_rs_tpu_torch.models.params import state_dict_from_jax
from whisper_rs_tpu_torch.parallel.mesh import Mesh
from whisper_rs_tpu_torch.parallel.sharding import param_shardings

FIELDS = dict(n_mels=80, n_vocab=1024, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
ODD = dict(FIELDS, n_vocab=1001)
SCORE_TOL = 1e-3  # tests/test_sharding.py's scores
LOGIT_TOL = 2e-3  # tests/test_sharding.py's logits
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(0), JaxDims(**FIELDS))
    odd = init_params(jax.random.PRNGKey(0), JaxDims(**ODD))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((4, 80, 3000)).astype(np.float32) * 0.3
    audios = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (7, 4, 3)]
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    sds = (state_dict_from_jax(host(params), ModelDims(**FIELDS)),
           state_dict_from_jax(host(odd), ModelDims(**ODD)))
    return params, odd, sds, mel, audios


def _jax_mesh_results(params, mel) -> dict:
    """JAX on a 2 x 2 mesh (the first four fake devices): logits, greedy
    and beam decodes; and the sampled decode in one device."""
    dims = JaxDims(**FIELDS)
    cfg = JaxFilterConfig(n_vocab=1024, **torch_ranks.CFG_KW)
    initial = jnp.full((mel.shape[0], 1), torch_ranks.SOT, jnp.int32)
    tokens = jnp.asarray(torch_ranks.LOGIT_TOKENS * mel.shape[0], jnp.int32)
    mesh = jax_make_mesh(n_model=2, devices=jax.devices()[:4])
    out = {}
    with jax.set_mesh(mesh):
        sp = shard_params(mesh, params)
        mel_s = jax.device_put(jnp.asarray(mel), batch_sharding(mesh, 3))
        init_s = jax.device_put(initial, batch_sharding(mesh, 2))
        out["logits"] = np.asarray(jax.jit(lambda p, m, t: model_forward(p, m, t, dims))(
            sp, mel_s, jax.device_put(tokens, batch_sharding(mesh, 2))))
        for name, fn, mode, n in (
                ("greedy", jax_decode_greedy, JaxGreedy(), torch_ranks.GREEDY_LEN),
                ("beam", jax_decode_beam, JaxBeam(beam_size=2, patience=1.0),
                 torch_ranks.BEAM_LEN)):
            r = jax.jit(lambda p, m, t: fn(p, m, t, jnp.int32(1), jnp.int32(0), dims, cfg, mode,
                                           n, no_speech_id=torch_ranks.NO_SPEECH))(
                sp, mel_s, init_s)
            out[name] = (np.asarray(r.candidates), np.asarray(r.scores))
    r = jax_decode_greedy(params, jnp.asarray(mel), initial, jnp.int32(1), jnp.int32(0), dims,
                          cfg, JaxGreedy(temperature=0.7, group_size=2), torch_ranks.GREEDY_LEN,
                          no_speech_id=torch_ranks.NO_SPEECH)
    out["sampled"] = (np.asarray(r.candidates), np.asarray(r.scores))
    return out


def _jax_single_results(params, odd, mel, audios) -> dict:
    """JAX in one device: the vocab-1001 logits and the batch driver."""
    from whisper_rs_tpu.config import DecodeOptions, TranscribeOptions
    from whisper_rs_tpu.parallel.batch import BatchTranscriber as JaxBatchTranscriber

    opts = TranscribeOptions(decode=DecodeOptions(mode=JaxGreedy(), sample_len=8),
                             condition_on_prev_text=True)
    batch = JaxBatchTranscriber(params, JaxDims(**FIELDS), torch_ranks.SmallTokenizer(), opts,
                                batch_size=2).run(audios)
    odd_logits = model_forward(odd, jnp.asarray(mel[:1]),
                               jnp.asarray(torch_ranks.LOGIT_TOKENS, jnp.int32), JaxDims(**ODD))
    return {"batch": [(np.asarray(o.tokens), o.text) for o in batch],
            "odd_logits": np.asarray(odd_logits)}


@pytest.fixture(scope="module")
def results(setup):
    """(every rank's results from one spawn of four gloo ranks, the same
    cases in this process without a mesh, JAX's), the ranks running while
    this process computes the other two."""
    params, odd, (sd, sd_odd), mel, audios = setup
    future = torch_ranks.start_ranks(torch_ranks.sharding_rank, 4,
                                     (sd, FIELDS, sd_odd, ODD, mel, audios), SPAWN_TIMEOUT)
    single = torch_ranks.one_thread(torch_ranks.sharding_cases, sd, FIELDS, sd_odd, ODD, mel,
                                    audios)
    jax_results = {**_jax_mesh_results(params, mel),
                   **_jax_single_results(params, odd, mel, audios)}
    return future.result(), single, jax_results


@pytest.fixture(scope="module")
def ranks(results):
    return results[0]


@pytest.fixture(scope="module")
def single(results):
    return results[1]


@pytest.fixture(scope="module")
def jax_mesh_results(results):
    return results[2]


def _torch_name_to_jax(name: str):
    """A port parameter name -> (JAX leaf path, {torch dim: JAX axis})."""
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "encoder" and parts[1] in ("conv1", "conv2"):
        return ("encoder", parts[1], "w" if leaf == "weight" else "b"), {0: 0, 1: 1, 2: 2}
    if name == "encoder.ln_post.weight" or name == "encoder.ln_post.bias":
        return ("encoder", "ln_post", "scale" if leaf == "weight" else "bias"), {0: 0}
    if name.startswith("decoder.token_embedding."):
        return (("decoder", "token_emb") if leaf == "weight" else ("decoder", "token_emb_scale"),
                {0: 0, 1: 1})
    if name == "decoder.positional_embedding":
        return ("decoder", "pos_emb"), {0: 0, 1: 1}
    if parts[1] == "ln":
        return ("decoder", "ln", "scale" if leaf == "weight" else "bias"), {0: 0}
    side, module = parts[0], parts[3:-1]  # e.g. ["attn", "query"], ["mlp", "0"], ["attn_ln"]
    if module[0].endswith("_ln"):
        return (side, "blocks", module[0], "scale" if leaf == "weight" else "bias"), {0: 1}
    if module[0] == "mlp":
        module = ["mlp", {"0": "fc1", "2": "fc2"}[module[1]]]
    jleaf = {"weight": "w", "bias": "b", "scale": "s"}[leaf]
    # a JAX block linear is [L, in, out]; the port's weight [out, in]
    axes = {0: 2, 1: 1} if leaf == "weight" else {0: 1}
    return (side, "blocks", *module, jleaf), axes


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_split_dims_match_jax_param_shardings(setup, int8):
    params = setup[0]
    model = params_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS), device="cpu")
    if int8:
        params, model = jax_quantize_params(params), quantize_params(model)
    jspecs = jax_param_shardings(jax_make_mesh(n_model=2, devices=jax.devices()[:4]), params)
    dims = param_shardings(Mesh(n_data=2, n_model=2), model)
    assert dims and all(v is None for v in param_shardings(Mesh(n_data=4), model).values())
    for name, dim in dims.items():
        path, axes = _torch_name_to_jax(name)
        spec = jspecs
        for key in path:
            spec = spec[key]
        spec = tuple(spec.spec) + (None,) * 4
        want = [t for t, a in axes.items() if spec[a] == "model"]
        assert (dim,) == tuple(want or [None]), (name, spec)


def test_each_rank_holds_its_shard(ranks, single):
    whole = single["bytes"]
    for r in ranks:
        assert r["n_head"] == (2, 2)
        assert r["emb_rows"] == FIELDS["n_vocab"] // 2
        # the replicated LayerNorms, positional table and row-split biases
        # are under 10 % of this model's bytes
        assert whole / 2 < r["bytes"] < 0.55 * whole
    assert sorted(r["mesh"] for r in ranks) == [(0, d, m) for d in (0, 1) for m in (0, 1)]


def test_tp_logits_match_jax_and_single(ranks, single, jax_mesh_results):
    for r in ranks:
        np.testing.assert_allclose(r["logits"], jax_mesh_results["logits"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(r["logits"], single["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["greedy", "beam", "sampled"])
def test_dp_tp_decode_matches_jax_and_single(ranks, single, jax_mesh_results, name):
    """Tokens exactly; scores within 1e-3 of JAX's (the 2 x 2 mesh; the
    sampled draw against one device) and 1e-4 of one process."""
    want_c, want_s = jax_mesh_results[name]
    for r in ranks:
        cand, scores, no_speech = r["decodes"][name]
        np.testing.assert_array_equal(cand, want_c)
        np.testing.assert_array_equal(cand, single["decodes"][name][0])
        np.testing.assert_allclose(scores, want_s, rtol=SCORE_TOL, atol=SCORE_TOL)
        np.testing.assert_allclose(scores, single["decodes"][name][1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(no_speech, single["decodes"][name][2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["int8", "int8_matmul"])
def test_int8_under_tp_matches_single(ranks, single, name):
    """int8 weights (their scales split with their rows) and int8 K/V at 2
    heads a rank; under the int8×int8 matmuls a row-split linear quantises
    its input rows with their amax over the whole row."""
    for r in ranks:
        cand, scores, _ = r[name]["greedy"]
        np.testing.assert_array_equal(cand, single[name]["greedy"][0])
        np.testing.assert_allclose(scores, single[name]["greedy"][1], rtol=1e-4, atol=1e-4)


def _assert_outputs_equal(got, want, time_tol=0.0):
    assert len(got) == len(want)
    for (gt, gtext, gseg), (wt, wtext, wseg) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        assert gtext == wtext
        assert [s[:4] for s in gseg] == [s[:4] for s in wseg]
        for gs, ws in zip(gseg, wseg):
            assert (gs[4] is None) == (ws[4] is None)
            for gw, ww in zip(gs[4] or [], ws[4] or []):
                assert gw[0] == ww[0]
                assert abs(gw[1] - ww[1]) <= time_tol and abs(gw[2] - ww[2]) <= time_tol


def test_dp_batch_transcriber_matches_single_and_jax(ranks, single, jax_mesh_results):
    """BatchTranscriber on the 2 x 2 mesh: each call's batch split over the
    data ranks; every rank returns the one-process transcription, which is
    the JAX BatchTranscriber's on the same weights."""
    for r in ranks:
        _assert_outputs_equal(r["batch"], single["batch"])
    assert len(single["batch"]) == len(jax_mesh_results["batch"])
    for (tokens, text, _), (jax_tokens, jax_text) in zip(single["batch"],
                                                         jax_mesh_results["batch"]):
        np.testing.assert_array_equal(tokens, jax_tokens)
        assert text == jax_text


def test_word_timestamps_under_tp(ranks, single):
    """The alignment heads are global (layer, head) pairs: each rank's half
    of a layer's cross logits is gathered before the DTW, so every rank
    aligns the one process's words at its times."""
    assert any(s[4] for s in single["words"][0][2])
    for r in ranks:
        _assert_outputs_equal(r["words"], single["words"], time_tol=0.02)


def test_vocab_not_divisible_by_tp(ranks, single, jax_mesh_results):
    """1001 rows over 2 ranks: 501 a rank, the last one a zero pad row; the
    gathered logits are cut to 1001, so a pad row never wins."""
    jax_logits = jax_mesh_results["odd_logits"]
    for r in ranks:
        assert r["odd_rows"] == 501
        assert r["odd_logits"].shape[-1] == 1001
        np.testing.assert_allclose(r["odd_logits"], single["odd_logits"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["odd_logits"], jax_logits, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        cand = r["odd"]["greedy"][0]
        np.testing.assert_array_equal(cand, single["odd"]["greedy"][0])
        assert cand.max() < 1001


def test_split_needs_divisible_heads():
    from whisper_rs_tpu_torch.models import init_random
    from whisper_rs_tpu_torch.parallel.sharding import shard_model

    model = init_random(ModelDims(**dict(FIELDS, n_audio_head=2, n_text_head=2)), 0,
                        device="cpu")
    with pytest.raises(ValueError, match="n_audio_head"):
        shard_model(model, Mesh(n_model=4))
