"""Hardware constants of the paper's GPUs (its Table 1): the scheduler's
device model (peak FLOP/s, memory bandwidth, link bandwidth, memory size,
rental price). The port's copy of ``repro.roofline.hw`` without its TPU
entry; in its place :data:`H100`, the card the port runs on, which the
roofline (``roofline/analysis.py``) converts counted work into seconds
with.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float        # bf16/fp16 FLOP/s
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s per link (one direction)
    hbm_bytes: float
    price_per_hr: float = 0.0


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU data sheet:
# dense bf16 tensor-core peak (no sparsity), HBM3 rate, the card's 80 GB,
# and NVLink 4 at 25 GB/s a link a direction (18 links: 900 GB/s both
# ways); a four-card host's cards talk over those links (``nvidia-smi
# nvlink -s``), the collective term of the dry-run's ``four`` mesh. No
# rental price is stated here.
H100 = ChipSpec("H100", peak_flops=989e12, hbm_bw=3.35e12, link_bw=25e9,
                hbm_bytes=80e9)
NVLINK_LINKS = 18            # H100 SXM5, NVLink 4

# Paper Table 1 (used by the scheduler's faithful reproduction)
A100 = ChipSpec("A100", 312e12, 2.0e12, 25e9, 80e9, 1.753)
A6000 = ChipSpec("A6000", 38.7e12, 768e9, 8e9, 48e9, 0.483)
A5000 = ChipSpec("A5000", 27.8e12, 626.8e9, 8e9, 24e9, 0.223)
A40 = ChipSpec("A40", 149.7e12, 696e9, 8e9, 48e9, 0.403)
RTX3090TI = ChipSpec("3090Ti", 40e12, 1008e9, 8e9, 24e9, 0.307)

GPU_SPECS = {c.name: c for c in (A100, A6000, A5000, A40, RTX3090TI)}
