"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). Every roofline share and
MFU of this benchmark is stated against them, with the card's power limit
beside the number."""

PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12   # HBM3 bytes/s


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
