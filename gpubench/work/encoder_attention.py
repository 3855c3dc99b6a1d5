"""Row 4 (``csrc/encoder_attention.cu``, ``attn_wgmma_kernel``): one call is
one encoder layer's attention over [batch, T, heads * head_dim] bf16 q, k, v.

Operations: Q K^T and P V, 2 * T * T * head_dim multiply-adds each a head,
2 operations a multiply-add (the softmax's exponentials are not counted).
Bytes: q, k and v read once and the output written once.
"""


def call(batch: int, heads: int, T: int, head_dim: int, elem_bytes: int = 2):
    """(operations, bytes) of one call."""
    ops = 4 * batch * heads * T * T * head_dim
    nbytes = 4 * batch * T * heads * head_dim * elem_bytes
    return ops, nbytes
