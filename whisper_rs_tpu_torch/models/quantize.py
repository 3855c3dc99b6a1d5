"""Weight-only int8 quantisation with per-output-channel symmetric scales
(counterpart of ``whisper_rs_tpu/models/quantize.py``).

``quantize_params`` puts ``QuantLinear`` (int8 ``weight`` [out, in], f32
``scale`` [out], the bias as it was) in place of every ``nn.Linear`` of the
attention, cross-attention and MLP of every encoder and decoder block, and
``QuantEmbedding`` (int8 rows, one f32 scale a row) in place of the token
embedding.  The conv stem, the LayerNorms and the positional embeddings
stay as they are, as in the JAX package.  The arithmetic is the JAX
package's, in f32: ``s = max(amax |w|, 1e-8) / 127`` over each output
channel's inputs (a row of the ``[out, in]`` weight) and ``clip(round(w /
s), -127, 127)``, rounded half to even, which is ``quantize_kv`` row by row.
"""

from __future__ import annotations

import torch
from torch import nn

from .whisper import QuantEmbedding, QuantLinear, Whisper, quantize_kv


def _quantized(module: nn.Module) -> nn.Module:
    """An int8 copy of an ``nn.Linear`` or ``nn.Embedding`` on its device."""
    w = module.weight.detach()
    with torch.no_grad(), torch.device(w.device):
        if isinstance(module, nn.Embedding):
            out = QuantEmbedding(*w.shape)
        else:
            out = QuantLinear(w.shape[1], w.shape[0], bias=module.bias is not None)
            if module.bias is not None:
                out.bias = nn.Parameter(module.bias.detach(), requires_grad=False)
        values, scale = quantize_kv(w)
        out.weight.copy_(values)
        out.scale.copy_(scale)
    return out


def quantize_params(model: Whisper) -> Whisper:
    """Make ``model``'s block linears and token embedding int8, in place, one
    tensor at a time on the model's device (the host never holds a copy);
    returns the model."""
    blocks = [*model.encoder.blocks, *model.decoder.blocks]
    for block in blocks:
        for attn in (block.attn, block.cross_attn):
            if attn is not None:
                for name in ("query", "key", "value", "out"):
                    setattr(attn, name, _quantized(getattr(attn, name)))
        block.mlp[0], block.mlp[2] = _quantized(block.mlp[0]), _quantized(block.mlp[2])
    model.decoder.token_embedding = _quantized(model.decoder.token_embedding)
    return model
