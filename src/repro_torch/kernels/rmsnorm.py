"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``; it replaces
``repro/kernels/rmsnorm.py``).

CUDA tensors only (``kernels/ops.py`` sends CPU tensors to
``ref.rmsnorm_ref``); the launch count is ``rmsnorm.launches``. The
launch reads nothing back from the card, so it runs inside the decode
chunk's no-sync region.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant import _require_cuda


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d) bf16/f32; scale: (d,) f32. Returns
    ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in ``x.dtype``."""
    _require_cuda("rmsnorm", x=x, scale=scale)
    d = x.shape[-1]
    if (x.dtype not in (torch.bfloat16, torch.float32)
            or scale.dtype != torch.float32 or tuple(scale.shape) != (d,)
            or d == 0):
        raise ValueError(f"rmsnorm: want x (..., d) bf16/f32 and scale (d,) "
                         f"f32, got {tuple(x.shape)} {x.dtype}, "
                         f"{tuple(scale.shape)} {scale.dtype}")
    out = torch.empty_like(x)
    status = build.library().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), x.numel() // d, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
