"""Model operations of one decode call of a batch of 30 s windows, from
shapes: what ``mfu`` counts.  2 operations a multiply-add; LayerNorms,
softmaxes, filters and the beam's bookkeeping are not counted.

  * the encoder, per window: the two convolutions, then per layer the four
    projections and the MLP (12 D^2 a position) and attention (4 T^2 D);
  * the cross K/V, per window and decoder layer: 2 D^2 a position;
  * the prefill, per row, over the row's real prefix (its padding is not
    useful work), and every step, per row: per decoder layer the self
    projections (4 D^2), the cross q and out (2 D^2), the MLP (8 D^2),
    self-attention over the keys so far and cross-attention over the
    encoder's positions; logits (D V) at the prefill's last position and at
    every step.
"""


def encoder(d: dict) -> float:
    D, T, M = d["n_state"], d["n_audio_ctx"], d["n_mels"]
    stem = 2 * (2 * T) * 3 * M * D + 2 * T * 3 * D * D
    layer = 2 * T * 12 * D * D + 4 * T * T * D
    return stem + d["n_audio_layer"] * layer


def token(d: dict, keys: int) -> float:
    """One decoder position attending ``keys`` cached positions."""
    D = d["n_state"]
    per_layer = 2 * 14 * D * D + 4 * D * keys + 4 * D * d["n_audio_ctx"]
    return d["n_text_layer"] * per_layer


def call_flops(d: dict, prefix_lengths, group: int, steps: int) -> float:
    """One call: ``prefix_lengths`` the real prefix length of each audio's
    rows, ``group`` rows an audio (the beam, or 1), ``steps`` the decode's
    incremental steps."""
    D, V = d["n_state"], d["n_vocab"]
    A = len(prefix_lengths)
    total = A * (encoder(d) + d["n_text_layer"] * 2 * d["n_audio_ctx"] * 2 * D * D)
    for p in prefix_lengths:
        rows = group
        prefill = sum(token(d, j + 1) for j in range(p)) + 2 * D * V
        decode = sum(token(d, p + j) for j in range(1, steps + 1)) + steps * 2 * D * V
        total += rows * (prefill + decode)
    return float(total)
