"""The port's decode-step MLP (``ops/decoder_mlp_fused.py``, its plain
version on the CPU) against the JAX Pallas ``decoder_mlp_step`` in
interpret mode: f32 at D 128 and 256 within 2e-5 (the JAX kernel's
polynomial erf is within 1.5e-7 of erf), and a bf16 case that pins the
rounding of fc1's output to the compute dtype before the GELU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from whisper_rs_tpu.ops.decoder_mlp_fused import decoder_mlp_step as jax_mlp_step
from whisper_rs_tpu.ops.decoder_mlp_fused import pack_mlp_params
from whisper_rs_tpu_torch.ops.decoder_mlp_fused import decoder_mlp_step


def _jax(h, w1, b1, w2, layer, dtype):
    """JAX kernel on stacked [L, ...] weights in the JAX layout ([in, out])."""
    blocks = {"mlp": {
        "fc1": {"w": jnp.asarray(w1, dtype), "b": jnp.asarray(b1, dtype)},
        "fc2": {"w": jnp.asarray(w2, dtype)},
    }}
    w_pack, b_pack = pack_mlp_params(blocks)
    out = jax_mlp_step(jnp.asarray(h, dtype), w_pack, b_pack, jnp.int32(layer), interpret=True)
    return np.asarray(out, np.float32)


def _port(h, w1, b1, w2, layer, dtype):
    """The port on one layer's OpenAI-layout weights ([out, in])."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return decoder_mlp_step(t(h), t(w1[layer].T), t(b1[layer]), t(w2[layer].T)).float().numpy()


@pytest.mark.parametrize("D,B", [(128, 5), (256, 12)])
def test_decoder_mlp_step_f32_matches_pallas(D, B):
    rng = np.random.default_rng(D)
    L = 3
    w1 = (rng.standard_normal((L, D, 4 * D)) * D**-0.5).astype(np.float32)
    b1 = (rng.standard_normal((L, 4 * D)) * 0.5).astype(np.float32)
    w2 = (rng.standard_normal((L, 4 * D, D)) * (4 * D) ** -0.5).astype(np.float32)
    h = rng.standard_normal((B, D)).astype(np.float32)
    want = _jax(h, w1, b1, w2, 1, jnp.float32)
    got = _port(h, w1, b1, w2, 1, torch.float32)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_decoder_mlp_step_bf16_rounds_fc1_before_gelu():
    """Hidden units in pairs with the same bf16 weight row x, one of them
    nudged by 3/8 of an ulp of x through a second input: the f32 fc1 sums
    differ, their bf16 roundings do not.  fc2 takes each pair's difference,
    so the Pallas kernel, which rounds before the GELU, gives exactly 0;
    the port must too (atol 1e-3).  A plain version that runs the GELU on
    the unrounded f32 sum misses by up to one ulp of g (about 6e-3 here)."""
    D, B = 128, 3
    H4 = 4 * D
    x = torch.linspace(0.5, 3.0, D).bfloat16().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(x)) - 7)
    w1 = np.zeros((1, D, H4), np.float32)  # JAX layout [L, in, out]
    w1[0, 0, 0 : 2 * D : 2] = x
    w1[0, 1, 0 : 2 * D : 2] = 0.375 * ulp
    w1[0, 0, 1 : 2 * D : 2] = x
    w2 = np.zeros((1, H4, D), np.float32)
    w2[0, 2 * np.arange(D), np.arange(D)] = 1.0
    w2[0, 2 * np.arange(D) + 1, np.arange(D)] = -1.0
    b1 = np.zeros((1, H4), np.float32)
    h = np.zeros((B, D), np.float32)
    h[:, 0] = 1.0
    h[:, 1] = [1.0, 0.5, 1.0]
    tol = dict(rtol=0, atol=1e-3)

    want = _jax(h, w1, b1, w2, 0, jnp.bfloat16)
    np.testing.assert_allclose(_port(h, w1, b1, w2, 0, torch.bfloat16), want, **tol)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float()  # noqa: E731
    a = t(h) @ t(w1[0])  # f32 sum, never rounded
    unrounded = (F.gelu(a, approximate="tanh") @ t(w2[0])).bfloat16().float().numpy()
    assert np.abs(unrounded - want).max() > tol["atol"]
