"""The port's decode-step cross-attention (its plain version on the CPU)
against the JAX Pallas kernel in interpret mode, at 1e-5, and its checks
of int8 scales (the int8 branch itself is held against Pallas in
tests/test_torch_quantize.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_rs_tpu.ops.decode_attention import cross_attention_step as jax_cross_step
from whisper_rs_tpu_torch.ops.decode_attention import (
    cross_attention_step,
    cross_attention_step_plain,
)


@pytest.mark.parametrize("G", [1, 3])
def test_cross_attention_step_matches_pallas(G):
    rng = np.random.default_rng(G)
    L, A, H, Tk, dh = 3, 2, 4, 96, 64
    q = (rng.standard_normal((A, G, H, dh)) * dh**-0.5).astype(np.float32)
    kv = rng.standard_normal((L, A, H, 2, dh, Tk)).astype(np.float32)
    layer = 1
    want = np.asarray(jax_cross_step(jnp.asarray(q), jnp.asarray(kv), jnp.int32(layer), interpret=True))
    got = cross_attention_step(torch.from_numpy(q), torch.from_numpy(kv), layer)
    assert got.shape == (A, G, H, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cross_attention_step_bf16_rounds_weights_like_pallas():
    """In bf16 the softmax weights are cast to the K/V dtype before the
    value product, as the Pallas kernel does.  Unit-scale q peaks the
    weights, so leaving them unrounded misses by about 1.6e-2 here."""
    rng = np.random.default_rng(9)
    L, A, G, H, Tk, dh = 2, 2, 1, 2, 64, 64
    q = rng.standard_normal((A, G, H, dh)).astype(np.float32)
    kv = rng.standard_normal((L, A, H, 2, dh, Tk)).astype(np.float32)
    want = np.asarray(
        jax_cross_step(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16), jnp.int32(0),
            interpret=True,
        ),
        np.float32,
    )
    got = cross_attention_step(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kv).bfloat16(), 0
    ).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_int8_scales_raise():
    """Malformed int8 arguments raise ValueError naming int8: scales of the
    JAX shape (a trailing 1), only one scale, scales with f32 K/V, int8 K/V
    without scales.  Well-formed ones run."""
    q = torch.zeros(1, 1, 2, 64)
    kv8 = torch.zeros(1, 1, 2, 2, 64, 8, dtype=torch.int8)
    scale = torch.ones(1, 1, 2, 8)
    bad = [
        (kv8, dict(k_scale=scale[..., None], v_scale=scale[..., None])),
        (kv8, dict(k_scale=scale)),
        (kv8.float(), dict(k_scale=scale, v_scale=scale)),
        (kv8, {}),
    ]
    for fn in (cross_attention_step, cross_attention_step_plain):
        for kv, scales in bad:
            with pytest.raises(ValueError, match="int8"):
                fn(q, kv, 0, **scales)
        assert fn(q, kv8, 0, k_scale=scale, v_scale=scale).shape == q.shape
