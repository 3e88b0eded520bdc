"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W limit): the roofline every share here is
held against. A card set to a lower power limit runs slower under load, so
the run prints the card's limit beside its shares."""

BF16_FLOPS = 989e12        # FLOP/s, tensor cores, bf16 / fp16 dense
HBM_BYTES = 3.35e12        # bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
