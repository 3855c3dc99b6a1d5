"""Row 5 (``csrc/cross_attention.cu``, ``cross_attn_kernel``): one call is one
decoder layer's cross-attention of a decode step: ``audios * group`` query
rows of ``heads * head_dim``, each audio's ``group`` rows (a beam) sharing
its K/V of ``keys`` encoder positions.

Operations: q . K and p . V over every key, 2 operations a multiply-add.
Bytes: each audio's K and V of the layer read once, q read and the output
written once.
"""


def call(audios: int, group: int, heads: int, head_dim: int, keys: int, elem_bytes: int = 2):
    """(operations, bytes) of one call."""
    rows = audios * group
    ops = 4 * rows * heads * keys * head_dim
    nbytes = (2 * audios * heads * keys * head_dim + 2 * rows * heads * head_dim) * elem_bytes
    return ops, nbytes
