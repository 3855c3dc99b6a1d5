"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel wrapper here has one predicate beside it,
``*_kernel_takes(shape...)``, which says by shape alone whether its kernel
takes a call.  A wrapper takes its plain version for a tensor on the CPU; a
tensor on the card launches the kernel, or raises where the predicate
refuses the shape.  No wrapper falls back to its plain version on the card.
The callers route by the predicates between kernels: the encoder between
the merged and the split attention kernels, the layer route to the append
route where the whole-step kernel refuses a step.

``LAUNCHES`` counts the launches of each wrapper, so a run can show that the
main path went through the kernels; the wrapper adds one right after its
launch and nowhere else.  ``"decoder_step_fused:append"`` counts the layer
route's steps that took the append route instead.
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
    "encoder_attention_split": 0,
    "decoder_step_fused:append": 0,  # the layer route's steps on the append route
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(name: str, kernel_takes: bool, device) -> bool:
    """Whether wrapper ``name`` launches its kernel: False for a tensor on
    the CPU (the plain version runs), True on the card; raises off the CPU
    where its predicate refused the shape (``kernel_takes`` False), and on
    any device but the CPU and the card."""
    if device.type == "cpu":
        return False
    if not kernel_takes:
        raise ValueError(f"{name}: the kernel does not take this shape (see its predicate)")
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True
