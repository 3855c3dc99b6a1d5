"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense rates,
at its full power limit of 700 W): what roofline shares and ``mfu`` divide
by.  A card set below 700 W reaches less; runs report its limit beside."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time a call could take: the larger of its operations over
    the bf16 peak and its bytes over the memory bandwidth."""
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
