"""The port's sampling (whisper_rs_tpu_torch.decode.rng and the sampled
greedy loop) against JAX on the CPU: the threefry hash, ``PRNGKey``,
``fold_in`` and 32-bit ``random_bits`` bit-equal under the installed
partitionable layout (read, not set); ``uniform`` bit-equal; ``gumbel``
within GUMBEL_ULPS ulps of max(|g|, 1); ``categorical`` over the row keys
of 6 rows in groups of 3 token-equal to the JAX ``_sample_rows``; an
audio's draws the same alone and in a batch; ``decode_greedy`` at temperature 0.8 in groups of 3 against the JAX
``decode_greedy`` on the same key (candidates equal unless the port's
sampling margin at the first divergent step is under MARGIN_TOL, scores within
1e-4); determinism and temperature 0 collapsing a group; and
``DecodeTask.run_batch`` with a temperature override against the JAX
task's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax._src import prng as jax_prng

from whisper_rs_tpu.config import DecodeOptions as JaxDecodeOptions
from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import DecodeTask as JaxDecodeTask
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.decode.loop import _sample_rows as jax_sample_rows
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu_torch.config import BeamSearchMode, DecodeOptions, GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import DecodeTask, FilterConfig, decode_greedy, rng
from whisper_rs_tpu_torch.models import params_from_jax

FIELDS = dict(n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(n_vocab=1000, token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
              token_id_no_timestamps=599)
SOT, EOT, NO_SPEECH = 501, 500, 502
# Gumbel noise: the two logs of -log(-log(u)) may round apart between
# libraries; on the CPU torch and XLA differ by at most 2 ulps of max(|g|,
# 1) (4.8e-7 absolute) over 5 x 51865 draws at three keys, and by 1 ulp in
# the inner -log(u).  The tolerance is twice that.  The noise is the same
# on one torch thread and on the default pool (bit for bit here, and on the
# card's host in chip_smoke.py's [rng]); a deviation of one chunk seen once
# under the parallel suite did not come back (PERF.md section 7).
GUMBEL_ULPS = 4
# A sampled token may differ only where the draw's top-2 gap is below this:
# the logit tolerance of the repo's parity tests.
MARGIN_TOL = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops here run thousands of small torch ops; on torch's
    default pool, under the suite's parallel workers, its threads contend
    with the other workers' (one test took 650 s against 30 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

uint32 = st.integers(min_value=0, max_value=2**32 - 1)


def _key_np(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_uses_the_partitionable_threefry_layout():
    """The port copies the partitionable layout; the installed JAX must run
    it (read here, never set)."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@settings(max_examples=60, deadline=None)
@given(k1=uint32, k2=uint32, x1=st.lists(uint32, min_size=1, max_size=8), data=st.data())
def test_threefry2x32_matches_jax(k1, k2, x1, data):
    x2 = data.draw(st.lists(uint32, min_size=len(x1), max_size=len(x1)))
    want = jax_prng.threefry2x32_p.bind(
        jnp.uint32(k1), jnp.uint32(k2), jnp.asarray(x1, jnp.uint32), jnp.asarray(x2, jnp.uint32))
    got = rng.threefry2x32(torch.tensor(k1), torch.tensor(k2), torch.tensor(x1),
                           torch.tensor(x2))
    for g, w in zip(got, want, strict=True):
        assert g.tolist() == np.asarray(w).astype(np.int64).tolist()
    # threefry_2x32 hashes an even-length count as its two halves
    counts = jax_prng.threefry_2x32((jnp.uint32(k1), jnp.uint32(k2)),
                                    jnp.asarray(x1 + x2, jnp.uint32))
    assert np.asarray(counts).astype(np.int64).tolist() == got[0].tolist() + got[1].tolist()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1), d=uint32)
def test_prng_key_and_fold_in_match_jax(seed, d):
    key = jax.random.PRNGKey(seed)
    assert rng.PRNGKey(seed).tolist() == _key_np(key).tolist()
    assert rng.fold_in(rng.PRNGKey(seed), d).tolist() == _key_np(
        jax.random.fold_in(key, np.uint32(d))).tolist()


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 51865)])
@pytest.mark.parametrize("seed", [0, 42])
def test_random_bits_match_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    got = rng.random_bits(torch.from_numpy(_key_np(key)), shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("span", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                                  (-2.0, 3.0), (0.1, 0.7)])
def test_uniform_is_bit_equal(span):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.uniform(key, (4, 20_000), minval=span[0], maxval=span[1]))
    got = rng.uniform(rng.PRNGKey(11), (4, 20_000), *span).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_gumbel_within_ulps(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (5, 51865)))
    got = rng.gumbel(rng.PRNGKey(seed), (5, 51865)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)


def test_gumbel_is_the_same_on_one_thread_and_on_a_pool():
    """The noise does not depend on torch's CPU threads (the CPU side of
    chip_smoke.py's [rng] runs on one)."""
    one = rng.gumbel(rng.PRNGKey(3), (5, 51865))
    torch.set_num_threads(4)  # one_torch_thread restores the count after
    pool = rng.gumbel(rng.PRNGKey(3), (5, 51865))
    assert torch.equal(one.view(torch.int32), pool.view(torch.int32))


def test_batched_keys_match_vmapped_jax():
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5), s))(
        jnp.arange(4, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (300,)))(keys))
    got = rng.uniform(torch.from_numpy(np.asarray(keys).astype(np.int64)), (300,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _logits(seed, rows, vocab=51865):
    x = np.random.default_rng(seed).standard_normal((rows, vocab)).astype(np.float32) * 3
    x[:, ::7] = -np.inf  # suppressed tokens, as the filters leave them
    return x


@pytest.mark.parametrize("step", [0, 1, 17])
def test_sample_rows_matches_jax(step):
    """B 6, group 3: row r's key is fold_in(step_key, r % 3)."""
    logits = _logits(step, 6)
    step_key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    want = np.asarray(jax_sample_rows(step_key, jnp.asarray(logits), 3))
    keys = rng.row_keys(rng.PRNGKey(0), step + 1, 6, 3)[step]
    got = rng.categorical(keys, torch.from_numpy(logits))
    assert got.tolist() == want.tolist()
    # the same rows with a group of 3 at rows 0-2 and 3-5 draw alike
    assert (keys[:3] == keys[3:]).all()


def test_an_audios_draws_are_the_same_alone_and_in_a_batch():
    logits = _logits(3, 3)
    alone = rng.categorical(rng.row_keys(rng.PRNGKey(0), 4, 3, 3)[2],
                                   torch.from_numpy(logits))
    batch = np.concatenate([_logits(4, 6), logits])  # the audio is the third of three
    together = rng.categorical(rng.row_keys(rng.PRNGKey(0), 4, 9, 3)[2],
                                      torch.from_numpy(batch))
    assert together[6:].tolist() == alone.tolist()


# -- the sampled decode loop ----------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    params = init_params(jax.random.PRNGKey(5), JDIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu")
    mel = (np.random.default_rng(2).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    return params, model, mel


def _port_decode(model, mel, mode, rng_key=None, temperature=None, sample_len=8):
    return decode_greedy(model, torch.from_numpy(mel), np.full((mel.shape[0], 1), SOT), 1, 0,
                         FilterConfig(**CFG_KW), mode, sample_len, NO_SPEECH, rng_key=rng_key,
                         temperature=temperature)


def _record_margins(monkeypatch):
    """Each sampling step's top-2 gap of logits / T + noise, per row."""
    margins = []
    sample = rng.categorical

    def recording(keys, scaled):
        top = (rng.gumbel(keys, scaled.shape[-1:]) + scaled).topk(2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        return sample(keys, scaled)

    monkeypatch.setattr(rng, "categorical", recording)
    return margins


def _assert_sampled_equal(got, want, margins, sample_begin=1):
    """Candidates equal, scores within 1e-4; a row may differ only where
    the port's sampling margin at the first divergent step is below
    MARGIN_TOL (a near-tie that rounding may break either way)."""
    gc, wc = got.candidates.numpy(), np.asarray(want.candidates)
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    n_audio, group = gc.shape[:2]
    for a in range(n_audio):
        for g in range(group):
            row = a * group + g
            diff = np.nonzero(gc[a, g] != wc[a, g])[0]
            if diff.size:
                step = int(diff[0]) - sample_begin
                assert margins[step][row] < MARGIN_TOL, (a, g, step, margins[step][row])
                continue
            assert abs(gs[a, g] - ws[a, g]) <= 1e-4


def test_decode_greedy_sampled_matches_jax(setup, monkeypatch):
    params, model, mel = setup
    mode = GreedyMode(group_size=3, temperature=0.8)
    want = jax_decode_greedy(
        params, jnp.asarray(mel), jnp.full((2, 1), SOT, jnp.int32), jnp.int32(1), jnp.int32(0),
        JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(group_size=3, temperature=0.8), 8,
        no_speech_id=NO_SPEECH, rng_key=jax.random.PRNGKey(7))
    margins = _record_margins(monkeypatch)
    got = _port_decode(model, mel, mode, rng_key=rng.PRNGKey(7))
    assert got.candidates.shape == (2, 3, 448)
    _assert_sampled_equal(got, want, margins)
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(want.no_speech_probs),
                               atol=1e-5)


def test_decode_greedy_temperature_override_matches_jax(setup, monkeypatch):
    """The traced override of the JAX loop (logits / max(T, 1e-6)) with the
    default key PRNGKey(0)."""
    params, model, mel = setup
    want = jax_decode_greedy(
        params, jnp.asarray(mel), jnp.full((2, 1), SOT, jnp.int32), jnp.int32(1), jnp.int32(0),
        JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(group_size=2), 8,
        no_speech_id=NO_SPEECH, temperature=jnp.float32(0.6))
    margins = _record_margins(monkeypatch)
    got = _port_decode(model, mel, GreedyMode(group_size=2), temperature=0.6)
    _assert_sampled_equal(got, want, margins)


def test_sampling_is_deterministic_and_temperature_zero_collapses_a_group(setup):
    """Mirrors tests/test_sampling_and_ckpt.py: sampled candidates of a
    group differ, every one EOT-terminated, the same key draws the same;
    at temperature 0 the group's rows are the argmax's, all equal."""
    _, model, mel = setup
    mode = GreedyMode(group_size=3, temperature=0.8)
    res = _port_decode(model, mel, mode, rng_key=rng.PRNGKey(7))
    c = res.candidates.numpy()
    assert not (np.array_equal(c[0, 0], c[0, 1]) and np.array_equal(c[0, 1], c[0, 2]))
    assert all(EOT in c[i, g].tolist() for i in range(2) for g in range(3))
    again = _port_decode(model, mel, mode, rng_key=rng.PRNGKey(7))
    np.testing.assert_array_equal(again.candidates.numpy(), c)
    other = _port_decode(model, mel, mode, rng_key=rng.PRNGKey(8))
    assert not np.array_equal(other.candidates.numpy(), c)
    c0 = _port_decode(model, mel, GreedyMode(group_size=2)).candidates.numpy()
    np.testing.assert_array_equal(c0[:, 0], c0[:, 1])
    zero = _port_decode(model, mel, GreedyMode(group_size=2), temperature=0.0)
    np.testing.assert_array_equal(zero.candidates.numpy(), c0)


def test_decode_task_temperature_override_matches_jax(setup, monkeypatch):
    """``run_batch(temperature=t)`` on a best-of-3 greedy task, one audio
    unprompted and one prompted, against the JAX task's; beam search takes
    no override."""
    params, model, mel = setup

    class Tok:
        token_id_sot, token_id_eot, token_id_no_speech = SOT, EOT, NO_SPEECH
        token_id_startofprev, token_id_no_timestamps, token_id_ts_begin = 503, 599, 600
        token_id_space = 7

        def sequence_sot(self):
            return [SOT]

        def non_speech_tokens(self):
            return (3, 5)

        def decode(self, toks):
            return " ".join(str(int(t)) for t in toks)

    prompts = [None, [10, 11, 12, 13]]
    want = JaxDecodeTask(params, JDIMS, Tok(), JaxDecodeOptions(
        mode=JaxGreedyMode(group_size=3), sample_len=8)).run_batch(mel, prompts, temperature=0.4)
    margins = _record_margins(monkeypatch)
    task = DecodeTask(model, Tok(), DecodeOptions(mode=GreedyMode(group_size=3), sample_len=8))
    got = task.run_batch(torch.from_numpy(mel), prompts, temperature=0.4)
    near_tie = min(float(m.min()) for m in margins) < MARGIN_TOL
    for g, w in zip(got, want, strict=True):
        if not near_tie:
            assert g.tokens.tolist() == w.tokens.tolist() and g.text == w.text
            assert abs(g.avg_logprob - w.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-5
    with pytest.raises(ValueError, match="greedy"):
        DecodeTask(model, Tok(), DecodeOptions(mode=BeamSearchMode(beam_size=2), sample_len=2)
                   ).run_batch(torch.from_numpy(mel[:1]), [None], temperature=0.4)
