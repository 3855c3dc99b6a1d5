"""The operations and bytes of ``gpubench/work/`` against sums made by hand,
term by term, at two shapes each."""

import pytest

from gpubench.lib import peaks, spec


@pytest.mark.parametrize("B,H,T,dh", [(2, 3, 5, 4), (32, 20, 1500, 64)])
def test_encoder_attention(B, H, T, dh):
    macs = 0
    for _ in range(B * H):
        macs += T * T * dh  # Q K^T
        macs += T * T * dh  # P V
    ops, nbytes = spec.work("encoder_attention").call(B, H, T, dh)
    assert ops == 2 * macs
    assert nbytes == (B * T * H * dh) * 2 * 4  # q, k, v read and o written, bf16


@pytest.mark.parametrize("A,G,H,dh,S", [(2, 3, 2, 4, 5), (8, 5, 20, 64, 1500)])
def test_cross_attention(A, G, H, dh, S):
    macs = sum(2 * S * dh for _ in range(A * G * H))  # q . K and p . V a row and head
    kv = A * H * S * dh * 2  # each audio's K and V once
    ops, nbytes = spec.work("cross_attention").call(A, G, H, dh, S)
    assert ops == 2 * macs
    assert nbytes == (kv + 2 * A * G * H * dh) * 2


def _by_hand(d, prefix, group, steps):
    D, V, Ta = d["n_state"], d["n_vocab"], d["n_audio_ctx"]
    macs = 0
    for _ in prefix:  # each audio's encoder and cross K/V
        macs += (2 * Ta) * (3 * d["n_mels"]) * D + Ta * (3 * D) * D
        for _ in range(d["n_audio_layer"]):
            macs += Ta * (4 * D * D + 8 * D * D) + 2 * Ta * Ta * D
        macs += d["n_text_layer"] * Ta * 2 * D * D
    for p in prefix:
        for _ in range(group):
            positions = [(j, j + 1) for j in range(p)] + [(p + s - 1, p + s)
                                                          for s in range(1, steps + 1)]
            for _, keys in positions:
                for _ in range(d["n_text_layer"]):
                    macs += 4 * D * D + 2 * D * D + 8 * D * D + 2 * keys * D + 2 * Ta * D
            macs += (1 + steps) * D * V  # logits: the prefill's last position and each step
    return 2 * macs


@pytest.mark.parametrize("dims,prefix,group,steps", [
    (dict(n_state=8, n_vocab=11, n_audio_ctx=6, n_mels=3, n_audio_layer=2, n_text_layer=1),
     [1, 3], 2, 4),
    (dict(n_state=1280, n_vocab=51866, n_audio_ctx=1500, n_mels=128, n_audio_layer=32,
          n_text_layer=4), [1] * 3, 1, 127),
])
def test_window_flops(dims, prefix, group, steps):
    got = spec.work("whisper_window").call_flops(dims, prefix, group, steps)
    assert got == pytest.approx(_by_hand(dims, prefix, group, steps), rel=1e-12)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
