"""The port's int8×int8 matmuls (``WHISPER_INT8_MATMUL=1``) against the JAX
package's, on the CPU, with the switch set by monkeypatch on both sides, at
the dims of tests/test_torch_quantize.py (D 64, 4 heads, 2 + 2 layers,
vocab 1000):

  * ``quantize_rows`` bit-equal to ``_quantize_rows``, extreme rows included;
  * the int32 sums of ``int8_mm`` equal to ``lax.dot_general``'s exactly, the
    f32 epilogue of ``int8_dot`` within one f32 ulp of ``_int8_dot`` (XLA may
    contract its multiply-add into an FMA);
  * a quantised ``QuantLinear`` with the switch against the JAX ``linear``;
  * the encoder's shared q/k/v quantisation equal to three separate ones
    and to the JAX ``_int8_qkv``;
  * ``encoder_forward`` and ``decode_greedy`` (int8 weights and K/V) with the
    switch against the JAX package's;
  * the padding of fewer than INT_MM_MIN_ROWS rows for ``torch._int_mm``
    equal to the unpadded plain product;
  * the switch off (unset or "0") leaves ``QuantLinear``'s output as it was.

The JAX package reads the switch while it traces, so its caches are
cleared around every test that sets it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from whisper_rs_tpu.config import GreedyMode as JaxGreedyMode
from whisper_rs_tpu.config import ModelDims as JaxDims
from whisper_rs_tpu.decode import FilterConfig as JaxFilterConfig
from whisper_rs_tpu.decode import decode_greedy as jax_decode_greedy
from whisper_rs_tpu.models import encoder_forward as jax_encoder_forward
from whisper_rs_tpu.models import init_params
from whisper_rs_tpu.models import whisper as jax_whisper
from whisper_rs_tpu.models.quantize import _quantize_linear
from whisper_rs_tpu.models.quantize import quantize_params as jax_quantize_params
from whisper_rs_tpu_torch.config import GreedyMode, ModelDims
from whisper_rs_tpu_torch.decode import FilterConfig, decode_greedy
from whisper_rs_tpu_torch.models import (
    QuantLinear,
    encoder_forward,
    params_from_jax,
    quantize_params,
)
from whisper_rs_tpu_torch.models import whisper as port_whisper

FIELDS = dict(
    n_mels=80, n_vocab=1000, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
JDIMS, DIMS = JaxDims(**FIELDS), ModelDims(**FIELDS)
CFG_KW = dict(
    n_vocab=1000, token_id_eot=500, token_id_space=7, token_id_ts_begin=600,
    token_id_no_timestamps=599,
)
SOT, NO_SPEECH = 501, 502


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def switch_on(monkeypatch):
    """WHISPER_INT8_MATMUL=1 for both packages, with the JAX traces made
    before (and under) it dropped."""
    jax.clear_caches()
    monkeypatch.setenv("WHISPER_INT8_MATMUL", "1")
    yield
    monkeypatch.delenv("WHISPER_INT8_MATMUL")
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    """(JAX-quantised params, the port model, port-quantised: bit-equal to
    them, tests/test_torch_quantize.py)."""
    params = init_params(jax.random.PRNGKey(0), JDIMS)
    model = quantize_params(params_from_jax(jax.tree.map(np.asarray, params), DIMS, device="cpu"))
    return jax_quantize_params(params), model


def _linear_pair(rng, n_in, n_out, bias):
    """A JAX int8 leaf and the port ``QuantLinear`` holding the same values."""
    w = rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.3  # JAX [in, out]
    b = rng.standard_normal(n_out).astype(np.float32) * 0.1
    leaf = _quantize_linear({"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})})
    lin = QuantLinear(n_in, n_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(np.asarray(leaf["w"]).T))
        lin.scale.copy_(torch.tensor(np.asarray(leaf["s"])))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    return leaf, lin


def _extreme_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # amax 0: the 1e-8 floor
    x[1] *= 1e30  # huge
    x[2] *= 1e-30  # tiny
    x[3, :6] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5]  # exact halves: round to even
    x[3, 6:] = 0.0
    x[4, :] = -1.0  # every element at the amax, negative
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(3)
    jx = jnp.asarray(_extreme_rows(rng, (9, 64)), dtype)
    jq, js = jax_whisper._quantize_rows(jx)
    q, s = port_whisper.quantize_rows(
        torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (9, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[3, :6].tolist() == [127, 2, -4, 0, 2, 0] and (q[0] == 0).all()
    assert (q[4] == -127).all()


@pytest.mark.parametrize("bias", [True, False])
def test_int32_sums_exact_and_epilogue_within_an_ulp(bias):
    """The widest product of the registry's K (fc2 of large, K 5120) fits:
    127^2 K < 2^31 and < 2^53."""
    rng = np.random.default_rng(5)
    for M, K, N in ((5, 64, 256), (37, 256, 64), (3, 5120, 8)):
        leaf, lin = _linear_pair(rng, K, N, bias)
        x = rng.standard_normal((M, K)).astype(np.float32)
        xq, s_x = jax_whisper._quantize_rows(jnp.asarray(x))
        want_acc = lax.dot_general(xq, leaf["w"], (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        got_acc = port_whisper.int8_mm(torch.tensor(np.asarray(xq)), lin.weight)
        assert got_acc.dtype == torch.int32
        np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
        want = np.asarray(jax_whisper._int8_dot(xq, s_x, leaf, jnp.float32))
        got = port_whisper.int8_dot(torch.tensor(np.asarray(xq)),
                                    torch.tensor(np.asarray(s_x)), lin, torch.float32)
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_with_the_switch_matches_jax_linear(dtype, switch_on):
    rng = np.random.default_rng(7)
    leaf, lin = _linear_pair(rng, 64, 256, bias=True)
    # a model's floating leaves take its dtype (the JAX load_params, the
    # port's .to(dtype)); the int8 weight stays int8
    leaf = {k: v if k == "w" else v.astype(dtype) for k, v in leaf.items()}
    jx = jnp.asarray(rng.standard_normal((2, 7, 64)).astype(np.float32), dtype)
    want = np.asarray(jax_whisper.linear(jx, leaf).astype(jnp.float32))
    x = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = lin.to(getattr(torch, dtype))(x)
    assert got.dtype == x.dtype and got.shape == (2, 7, 256)
    if dtype == "float32":
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    else:  # one f32 ulp before the cast: at most one bf16 ulp after it
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=0)


def test_shared_qkv_quantisation_equals_three_separate(weights, switch_on, monkeypatch):
    """encoder_self quantises its input once for q, k and v (the JAX
    _int8_qkv): the attention gets the same q, k and v as each QuantLinear
    quantising its own input gives, and the JAX _int8_qkv's within an f32
    ulp."""
    qparams, model = weights
    attn = model.encoder.blocks[0].attn
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 1500, 64)).astype(
        np.float32))
    quantized, seen = [], {}
    quantize = port_whisper.quantize_rows
    monkeypatch.setattr(port_whisper, "quantize_rows",
                        lambda t: quantized.append(tuple(t.shape)) or quantize(t))
    for name in ("encoder_attention_merged_plain", "encoder_attention_split_plain"):
        def recorder(q, k, v, *args, _fn=getattr(port_whisper, name), **kw):
            seen["qkv"] = (q, k, v)
            return _fn(q, k, v, *args, **kw)
        monkeypatch.setattr(port_whisper, name, recorder)
    attn.encoder_self(x, kernels=False)
    assert quantized == [(2, 1500, 64)] * 2  # q, k and v at once; the out projection
    jp = qparams["encoder"]["blocks"]["attn"]
    jqkv = jax_whisper._int8_qkv(jnp.asarray(x.numpy()), {
        n: {k: v[0] for k, v in jp[n].items()} for n in ("query", "key", "value")})
    for got, lin, want in zip(seen["qkv"], (attn.query, attn.key, attn.value), jqkv):
        if got.ndim == 4:  # split heads (head dim 16 here)
            got = port_whisper.merge_heads(got)
        assert torch.equal(got, lin(x))
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def test_encoder_with_the_switch_matches_jax(weights, switch_on, monkeypatch):
    """The whole encoder, int8 weights, the switch on both sides.  With it
    off the two agree within 1.6e-6; with it on, where the two packages'
    f32 activations differ by an ulp next to a rounding boundary, an int8
    value rounds to the neighbouring step (1/127 of its row's amax), and
    attention spreads that over the positions.  So the bulk is held at f32
    noise (median |d| <= 1e-5, measured 1.4e-6), the mean well under the
    switch's own effect (measured 0.00017 against 0.0061, a ratio of 0.03;
    held at 0.1) and the worst element to 0.05 (measured 0.018 and 0.021 at
    two seeds).  The layer's products themselves are exact
    (test_shared_qkv_quantisation_equals_three_separate)."""
    qparams, model = weights
    mel = (np.random.default_rng(2).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    want = np.asarray(jax_encoder_forward(qparams, jnp.asarray(mel), JDIMS))
    got = encoder_forward(model, torch.from_numpy(mel), kernels=False).numpy()
    monkeypatch.setenv("WHISPER_INT8_MATMUL", "0")
    off = encoder_forward(model, torch.from_numpy(mel), kernels=False).numpy()
    d = np.abs(got - want)
    effect = np.abs(got - off).mean()
    print(f"encoder with the switch: |d| median {np.median(d):.3e}, mean {d.mean():.3e}, max "
          f"{d.max():.3e}; the switch's own effect, mean {effect:.3e}")
    assert np.median(d) <= 1e-5 and d.mean() <= 0.1 * effect and d.max() <= 0.05


def test_encoder_switch_changes_the_output(weights, monkeypatch):
    """The switch is read at every call: on, the encoder's int8 linears
    quantise their inputs and the output moves; off again, it is as
    before."""
    _, model = weights
    mel = torch.from_numpy(
        (np.random.default_rng(2).standard_normal((1, 80, 3000)) * 0.3).astype(np.float32))
    monkeypatch.delenv("WHISPER_INT8_MATMUL", raising=False)
    off = encoder_forward(model, mel, kernels=False)
    monkeypatch.setenv("WHISPER_INT8_MATMUL", "1")
    on = encoder_forward(model, mel, kernels=False)
    monkeypatch.setenv("WHISPER_INT8_MATMUL", "0")
    again = encoder_forward(model, mel, kernels=False)
    assert not torch.equal(on, off) and torch.equal(again, off)
    assert (on - off).abs().max() < 0.1 * off.abs().max()


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["bf16_kv", "int8_kv"])
def test_decode_greedy_with_the_switch_matches_jax(weights, quantize_kv, switch_on, monkeypatch):
    """int8 weights (and K/V) through the greedy loop at f32 with the switch
    on both sides, the JAX side with its Pallas kernels interpreted: tokens
    equal, scores within 1e-4."""
    monkeypatch.setenv("WHISPER_PALLAS_DECODE", "interpret")
    qparams, model = weights
    mel = (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.3).astype(np.float32)
    initial = np.full((2, 1), SOT)
    jres = jax_decode_greedy(
        qparams, jnp.asarray(mel), jnp.asarray(initial, jnp.int32), jnp.int32(1), jnp.int32(0),
        JDIMS, JaxFilterConfig(**CFG_KW), JaxGreedyMode(), 8, no_speech_id=NO_SPEECH,
        quantize_kv=quantize_kv,
    )
    tres = decode_greedy(model, torch.from_numpy(mel), initial, 1, 0, FilterConfig(**CFG_KW),
                         GreedyMode(), 8, NO_SPEECH, quantize_kv=quantize_kv)
    assert tres.steps == 7
    np.testing.assert_array_equal(tres.candidates.numpy(), np.asarray(jres.candidates))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tres.no_speech_probs.numpy(), np.asarray(jres.no_speech_probs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 40])
def test_row_padding_for_int_mm_equals_the_plain_product(M, monkeypatch):
    """On the card ``int8_mm`` pads fewer than INT_MM_MIN_ROWS rows with zero
    rows for ``torch._int_mm`` (which refuses M <= 16 in some releases) and
    slices them off: here ``torch._int_mm`` is a stand-in that refuses
    such M, and the padded product must equal the unpadded plain one."""
    seen = []

    def int_mm(a, b):
        seen.append(tuple(a.shape))
        assert a.shape[0] > 16 and a.dtype == b.dtype == torch.int8
        assert b.stride(0) == 1  # w.T: the column-major [K, N] operand, no copy
        return port_whisper.int8_mm_plain(a, b.T)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    rng = np.random.default_rng(M)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (32, 64)).astype(np.int8))
    got = port_whisper.int_mm_rows(xq, w)
    assert seen == [(max(M, port_whisper.INT_MM_MIN_ROWS), 64)]
    assert got.shape == (M, 32)
    assert torch.equal(got, port_whisper.int8_mm_plain(xq, w))
    want = xq.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("value", [None, "0"], ids=["unset", "zero"])
def test_switch_off_leaves_quant_linear_unchanged(value, monkeypatch):
    """Unset or "0": the weight-only product, ``(x @ w.T) * s + b``
    in x's dtype, bit for bit."""
    if value is None:
        monkeypatch.delenv("WHISPER_INT8_MATMUL", raising=False)
    else:
        monkeypatch.setenv("WHISPER_INT8_MATMUL", value)
    assert not port_whisper.int8_matmul_enabled()
    rng = np.random.default_rng(9)
    _, lin = _linear_pair(rng, 64, 128, bias=True)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    want = (x @ lin.weight.float().T) * lin.scale + lin.bias
    assert torch.equal(lin(x), want)
