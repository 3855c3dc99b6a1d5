"""Seeded Whisper weights, drawn on the device in the type they are served in.

Both sides of the benchmark take their weights from here: the program loads
them through its public state-dict loader, and the float32 reference draws
them again from the same seed after the window and upcasts them.  Names and
layouts are OpenAI's state dict (``[out, in]`` linears, ``mlp.0``/``mlp.2``).

Scales follow ``init_random`` of the port (and ``chip_smoke.py::e2e_model``):
linear weights N(0, 1/n_in), conv and embedding weights N(0, 0.02^2).  The
biases and LayerNorm parameters are drawn too (N(0, 0.02^2), and 1 + N(0,
0.02^2) for LayerNorm scales), where those functions set them to 0 and 1, so
that the comparison with the reference covers every bias and every
LayerNorm parameter.

Each group of tensors (the conv stem, one encoder block, the token and
position tables, one decoder block, the final LayerNorms) is one normal draw
of a generator seeded from (seed, group), so any group can be drawn alone
and a draw costs one call a group.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: distinct group seeds for distinct (seed, group)


def group_seed(seed: int, group: int) -> int:
    """A generator seed for ``group`` of the weights of ``seed`` (any integer)."""
    return (int(seed) * MIX + 7919 * (group + 1)) % (2**63)


def _block(prefix: str, n: int, cross: bool) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of one residual block; kind: w (N(0, 1/n_in)),
    b (N(0, 0.02^2)), g (1 + N(0, 0.02^2))."""
    out = []
    for attn in ("attn", "cross_attn") if cross else ("attn",):
        for lin in ("query", "key", "value", "out"):
            out.append((f"{prefix}.{attn}.{lin}.weight", (n, n), "w"))
            if lin != "key":
                out.append((f"{prefix}.{attn}.{lin}.bias", (n,), "b"))
        out.append((f"{prefix}.{attn}_ln.weight", (n,), "g"))
        out.append((f"{prefix}.{attn}_ln.bias", (n,), "b"))
    out += [
        (f"{prefix}.mlp.0.weight", (4 * n, n), "w"),
        (f"{prefix}.mlp.0.bias", (4 * n,), "b"),
        (f"{prefix}.mlp.2.weight", (n, 4 * n), "w"),
        (f"{prefix}.mlp.2.bias", (n,), "b"),
        (f"{prefix}.mlp_ln.weight", (n,), "g"),
        (f"{prefix}.mlp_ln.bias", (n,), "b"),
    ]
    return out


def groups(dims: dict) -> List[List[Tuple[str, tuple, str]]]:
    """The weight groups of a model of ``dims`` (the keys of a config file's
    ``dims``), in draw order."""
    D, M = dims["n_state"], dims["n_mels"]
    out = [[
        ("encoder.conv1.weight", (D, M, 3), "e"),
        ("encoder.conv1.bias", (D,), "b"),
        ("encoder.conv2.weight", (D, D, 3), "e"),
        ("encoder.conv2.bias", (D,), "b"),
    ]]
    out += [_block(f"encoder.blocks.{i}", D, False) for i in range(dims["n_audio_layer"])]
    out.append([
        ("encoder.ln_post.weight", (D,), "g"),
        ("encoder.ln_post.bias", (D,), "b"),
        ("decoder.token_embedding.weight", (dims["n_vocab"], D), "e"),
        ("decoder.positional_embedding", (dims["n_text_ctx"], D), "e"),
        ("decoder.ln.weight", (D,), "g"),
        ("decoder.ln.bias", (D,), "b"),
    ])
    out += [_block(f"decoder.blocks.{i}", D, True) for i in range(dims["n_text_layer"])]
    return out


def draw_group(group: List[Tuple[str, tuple, str]], seed: int, index: int,
               dtype: torch.dtype, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of one group: one normal draw of the whole group in
    ``dtype`` on ``device``, cut and scaled tensor by tensor."""
    sizes = [torch.Size(shape).numel() for _, shape, _ in group]
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    offset = 0
    for (name, shape, kind), size in zip(group, sizes):
        z = flat[offset: offset + size].view(shape)
        offset += size
        if kind == "w":
            yield name, z * (shape[1] ** -0.5)
        elif kind == "g":
            yield name, z * 0.02 + 1.0
        else:  # "e" conv and embedding weights, "b" biases and LayerNorm offsets
            yield name, z * 0.02


def draw(dims: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Every weight of the model, as a state dict on ``device`` in ``dtype``."""
    sd = {}
    for index, group in enumerate(groups(dims)):
        sd.update(draw_group(group, seed, index, dtype, device))
    return sd
