"""Fused residual-add + LayerNorm for the encoder stack: Triton kernel
(``csrc/layer_norm.py``) and plain versions (counterpart of
``whisper_rs_tpu/ops/encoder_fused.py``).

  residual_ln(x, delta, scale, bias) -> (y, ln)   # y = x + delta, ln = LN(y)
  ln_fused(x, scale, bias)           -> ln        # plain row LN

Both view [..., D] as [rows, D]; the math is f32 (mean, variance, eps 1e-5)
and the outputs take the input dtype.  LN(y) is taken from the f32 sum, not
from y rounded to the input dtype, as in the Pallas kernel.
"""

from __future__ import annotations

import functools
import importlib.util

import torch

from . import LAUNCHES
from .build import CSRC

EPS = 1e-5


def _ln_f32(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def residual_ln_plain(x, delta, scale, bias, eps: float = EPS):
    y = x.float() + delta.float()
    return y.to(x.dtype), _ln_f32(y, scale, bias, eps).to(x.dtype)


def ln_fused_plain(x, scale, bias, eps: float = EPS):
    return _ln_f32(x.float(), scale, bias, eps).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _triton_source():
    spec = importlib.util.spec_from_file_location(
        "whisper_rs_tpu_torch_layer_norm", CSRC / "layer_norm.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *others):
    if not x.is_cuda:
        raise ValueError(f"layer norm kernel: unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer norm kernel: unsupported dtype {x.dtype}")
    for t in (x,) + others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("layer norm kernel: x and delta must match in shape, dtype, device")
        if not t.is_contiguous():
            raise ValueError("layer norm kernel: inputs must be contiguous")
    for p in (scale, bias):
        if p.shape != (D,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"layer norm kernel: scale/bias must be contiguous [{D}]")


def _launch(x, delta, scale, bias, y, ln, eps, has_residual: bool):
    """One program per row; without a residual, ``delta`` and ``y`` are
    never read or written."""
    import triton

    D = x.shape[-1]
    rows = x.numel() // D
    block_d = triton.next_power_of_2(D)
    _triton_source().layer_norm_rows[(rows,)](
        x, delta, scale, bias, y, ln, D, eps,
        HAS_RESIDUAL=has_residual, BLOCK_D=block_d,
        num_warps=4 if block_d <= 1024 else 8,
    )


def residual_ln(x, delta, scale, bias, eps: float = EPS):
    """(x + delta, LN(x + delta)) in one pass: the Triton kernel on the card,
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return residual_ln_plain(x, delta, scale, bias, eps)
    _check(x, scale, bias, delta)
    y = torch.empty_like(x)
    ln = torch.empty_like(x)
    _launch(x, delta, scale, bias, y, ln, eps, has_residual=True)
    LAUNCHES["residual_ln"] += 1
    return y, ln


def ln_fused(x, scale, bias, eps: float = EPS):
    """Row LayerNorm: the Triton kernel on the card, the plain version on
    the CPU."""
    if x.device.type == "cpu":
        return ln_fused_plain(x, scale, bias, eps)
    _check(x, scale, bias)
    ln = torch.empty_like(x)
    _launch(x, x, scale, bias, ln, ln, eps, has_residual=False)
    LAUNCHES["ln_fused"] += 1
    return ln
