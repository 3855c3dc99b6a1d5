"""JAX's threefry random numbers in integer torch ops: the counterpart of the
``jax.random`` calls the JAX package's sampling makes (``PRNGKey``,
``fold_in``, ``categorical``), so that the port draws the same noise, bit
for bit, on the same keys.

JAX runs with ``jax_threefry_partitionable`` on (the default of the JAX
release the package is tested with, and read, not set, by the tests):

  * ``random_bits(key, shape)`` hashes the counters of a flat ``uint64``
    iota over ``shape``, split into (high, low) 32-bit words, with the key,
    and returns the xor of the two output words;
  * ``fold_in(key, d)`` is the threefry hash of the counter pair ``(0, d)``
    under the key: the new key is the two output words;
  * ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``, as JAX builds it with
    64-bit mode off (its default): the high word of the seed is dropped.

``uniform`` puts 23 random bits in the mantissa of a float in [1, 2), takes
1 off and scales into [minval, maxval) with one fused multiply-add, as XLA
does; ``gumbel`` is JAX's default "low"
mode, ``-log(-log(uniform(tiny, 1)))``; ``categorical`` is the argmax of
logits plus Gumbel noise (the first index among ties, as ``jnp.argmax``).

A key is an ``int64`` tensor ``[..., 2]`` of two 32-bit words on the
device it is used on.  Every 32-bit word is held in ``int64`` and masked
with ``0xFFFFFFFF`` after each add and shift, since unsigned 32-bit
arithmetic is uneven across torch versions and devices; the float bits
are reinterpreted through ``int32``.  Bits and uniforms are therefore exact
on any device; only the two logarithms of the Gumbel noise can differ by
ulps between devices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000  # the bits of 1.0f
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``: int64 tensors (or ints) of 32-bit
    values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """The key of ``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``, made
    on ``device`` by a fill (a copy from the host would wait for the
    device)."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = int(seed) & MASK
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key ``[..., 2]`` and data (an int, or an
    integer tensor broadcast against the key's batch shape) -> the new
    keys ``[..., 2]``."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data) & MASK, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], 0, data.to(torch.int64) & MASK)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): key ``[*batch, 2]`` -> bits
    ``[*batch, *shape]`` in int64, one key a batch row (as ``jax.vmap``
    over the keys gives)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    hi = lo >> 32  # the high word of the flat counter
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(*batch, *(1,) * len(shape))
    k2 = key[..., 1].reshape(*batch, *(1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``[*batch, *shape]`` in [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # the bounds in f32 on the host (numpy), so that a draw reads nothing
    # back from a tensor
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # XLA fuses the scale and offset into one f32 multiply-add: the product
    # of two f32 values is exact in f64, so the f64 sum rounded to f32 is
    # that fused result (but where the f64 sum itself rounded onto an f32
    # midpoint, at most one draw in about 2**29; at [0, 1) and [tiny, 1),
    # the only ranges the sampler draws, the sum is exact)
    return torch.clamp_min((floats.double() * span + lo).float(), lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low" (JAX's default)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` with one key a row:
    key ``[*batch, 2]``, logits ``[*batch, V]`` (f32) -> ``[*batch]`` int64."""
    return torch.argmax(gumbel(key, logits.shape[-1:]) + logits, dim=-1)


def row_keys(key: torch.Tensor, n_steps: int, n_rows: int, group: int) -> torch.Tensor:
    """The sampling keys of a decode, ``[n_steps, n_rows, 2]``: step s's key
    is ``fold_in(key, s)`` (the step index counted from the first sampled
    position) and row r's key within it ``fold_in(step_key, r % group)``,
    as the JAX ``decode_greedy`` and ``_sample_rows`` fold them.  Made once
    before the step loop, so a step hashes only its noise."""
    dev = key.device
    steps = fold_in(key, torch.arange(n_steps, dtype=torch.int64, device=dev))
    within = torch.arange(n_rows, dtype=torch.int64, device=dev) % group
    return fold_in(steps[:, None, :], within[None, :])
