"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Every share of a
roofline or of a peak in this benchmark is against these numbers; a run
prints the card's power limit beside them."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
FP8_FLOPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12            # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(flops: float, nbytes: float,
            peak_flops: float = BF16_FLOPS) -> float:
    """The least time the chip could take: compute or memory, whichever
    binds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
