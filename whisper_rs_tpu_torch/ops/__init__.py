"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel wrapper here takes its plain version for a tensor on the CPU
and launches its kernel (or raises) for a tensor on the card.  ``LAUNCHES``
counts the launches of each wrapper, so a run can show that the main path
went through the kernels; the wrapper adds one right after its launch and
nowhere else.
"""

from __future__ import annotations

LAUNCHES = {
    "log_mel": 0,
    "ln_fused": 0,
    "residual_ln": 0,
    "encoder_attention_merged": 0,
    "cross_attention_step": 0,
    "self_attention_append_step": 0,
    "beam_self_attention_step": 0,
    "decoder_mlp_step": 0,
    "self_attention_fused_step": 0,
    "decoder_step_fused": 0,
    "self_attention_step": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
