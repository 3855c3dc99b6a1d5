"""The port's ServingEngine on a tensor-parallel model (the counterpart of
tests/test_serve.py::test_serving_tp_sharded_params) on the CPU.

Two gloo rank processes, spawned once for the module
(tests/torch_ranks.py::serve_rank), split the model over a 2-rank model
group; rank 0 runs the engine (batch 2, three files submitted at once) and
broadcasts every decode call's inputs and every word alignment's, rank 1
runs ``serve_follower`` until the engine's ``close()``.  Per case (plain,
the temperature ladder forced off rung 0, word timestamps) every request
equals the unsharded engine's output in one process, and the plain case
equals the JAX ServingEngine on TP-sharded params over two fake devices."""

import jax
import numpy as np
import pytest

import torch_ranks
from whisper_rs_tpu.config import DecodeOptions as JaxDecodeOptions
from whisper_rs_tpu.config import GreedyMode as JaxGreedy
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.config import TranscribeOptions as JaxTranscribeOptions
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.parallel import make_mesh as jax_make_mesh
from whisper_rs_tpu.parallel import shard_params
from whisper_rs_tpu.serve import ServingEngine as JaxServingEngine
from whisper_rs_tpu_torch.config import ModelDims
from whisper_rs_tpu_torch.models.params import state_dict_from_jax
from whisper_rs_tpu_torch.serve import ServingEngine

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def results():
    """(each rank's results, the unsharded engine's outputs per case, the
    JAX engine's on TP-sharded params), the ranks running while this
    process computes the other two."""
    params = init_params(jax.random.PRNGKey(21), JaxDims(**FIELDS))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params), ModelDims(**FIELDS))
    rng = np.random.default_rng(9)
    audios = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (8, 5, 3)]
    future = torch_ranks.start_ranks(torch_ranks.serve_rank, 2, (sd, FIELDS, audios),
                                     SPAWN_TIMEOUT)

    def unsharded():
        model, tok = torch_ranks.model_of(sd, FIELDS), torch_ranks.SmallTokenizer()
        out = {}
        for case, kw in torch_ranks.SERVE_CASES.items():
            with ServingEngine(model, tok, torch_ranks.transcribe_options(**kw),
                               batch_size=2) as engine:
                handles = [engine.submit(a) for a in audios]
                out[case] = torch_ranks.outputs_of([h.result(timeout=300) for h in handles])
        return out

    single = torch_ranks.one_thread(unsharded)
    mesh = jax_make_mesh(n_model=2, devices=jax.devices()[:2])
    opts = JaxTranscribeOptions(decode=JaxDecodeOptions(mode=JaxGreedy(), sample_len=8),
                                condition_on_prev_text=True)
    with jax.set_mesh(mesh):
        with JaxServingEngine(shard_params(mesh, params), JaxDims(**FIELDS),
                              torch_ranks.SmallTokenizer(), opts, batch_size=2) as engine:
            handles = [engine.submit(a) for a in audios]
            jax_out = [h.result(timeout=300) for h in handles]
    return future.result(), single, jax_out


@pytest.mark.parametrize("case", list(torch_ranks.SERVE_CASES))
def test_tp_serving_matches_unsharded(results, case):
    ranks, single, _ = results
    got, want = ranks[0][case], single[case]
    assert len(got) == len(want) == 3
    for (gt, gtext, gseg), (wt, wtext, wseg) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        assert gtext == wtext
        assert [s[:4] for s in gseg] == [s[:4] for s in wseg]
        for gs, ws in zip(gseg, wseg):
            assert [w[0] for w in gs[4] or []] == [w[0] for w in ws[4] or []]
            for gw, ww in zip(gs[4] or [], ws[4] or []):
                assert abs(gw[1] - ww[1]) <= 0.02 and abs(gw[2] - ww[2]) <= 0.02
    if case == "words":
        assert any(s[4] for _, _, segs in got for s in segs)


def test_tp_serving_matches_jax(results):
    ranks, _, jax_out = results
    for (tokens, text, _), j in zip(ranks[0]["plain"], jax_out, strict=True):
        np.testing.assert_array_equal(tokens, np.asarray(j.tokens))
        assert text == j.text


def test_close_ends_the_followers(results):
    """The follower mirrored at least one decode call an engine and returned
    when each engine closed (its spawn finished)."""
    ranks = results[0]
    assert all(isinstance(ranks[1][case], int) and ranks[1][case] > 0
               for case in torch_ranks.SERVE_CASES)
    assert ranks[1]["words"] > ranks[1]["plain"]  # the alignments were mirrored too


def test_engine_refuses_a_rank_other_than_0(monkeypatch):
    import torch.distributed as dist

    from whisper_rs_tpu_torch import serve

    monkeypatch.setattr(serve, "_spmd", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    with pytest.raises(RuntimeError, match="serve_follower"):
        ServingEngine(torch_ranks.model_of(state_dict_from_jax(
            jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(21), JaxDims(**FIELDS))),
            ModelDims(**FIELDS)), FIELDS), torch_ranks.SmallTokenizer())
