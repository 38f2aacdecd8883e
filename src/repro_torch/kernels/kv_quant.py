"""Wrappers of the int4 KV (de)quantization CUDA kernels
(``csrc/kv_quant.cu``; they replace ``repro/kernels/kv_quant.py``).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity and raise on anything else, allocate the outputs, launch on the
current stream and count their launches in ``.launches``. The dispatch
that sends CPU tensors to the plain versions lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_IN_TYPES = (torch.bfloat16, torch.float32)


def _require_cuda(name: str, **tensors):
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def kv_quant(x: torch.Tensor):
    """x: (N, G) bf16/f32 on the card -> (packed (N, G//2) u8, scale (N, 1)
    f32, zero (N, 1) f32), byte-identical to ``ref.kv_quant_ref``."""
    _require_cuda("kv_quant", x=x)
    if x.dim() != 2 or x.shape[1] % 2 or x.dtype not in _IN_TYPES:
        raise ValueError(f"kv_quant: want (N, even G) bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, G = x.shape
    packed = torch.empty((N, G // 2), dtype=torch.uint8, device=x.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    status = build.library().kv_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
        scale.data_ptr(), zero.data_ptr(), N, G,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "kv_quant")
    kv_quant.launches += 1
    return packed, scale, zero


kv_quant.launches = 0


def kv_dequant(packed: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor, *, out_dtype=torch.bfloat16):
    """Inverse of :func:`kv_quant`: (N, G) in ``out_dtype`` (bf16/f32),
    value-identical to ``ref.kv_dequant_ref``."""
    _require_cuda("kv_dequant", packed=packed, scale=scale, zero=zero)
    N, Gh = packed.shape
    if (packed.dtype != torch.uint8 or scale.dtype != torch.float32
            or zero.dtype != torch.float32
            or tuple(scale.shape) != (N, 1) or tuple(zero.shape) != (N, 1)
            or out_dtype not in _IN_TYPES):
        raise ValueError(
            f"kv_dequant: want packed (N, G/2) u8 + scale/zero (N, 1) f32 "
            f"-> bf16/f32, got {tuple(packed.shape)} {packed.dtype}, "
            f"{tuple(scale.shape)} {scale.dtype}, {tuple(zero.shape)} "
            f"{zero.dtype} -> {out_dtype}")
    out = torch.empty((N, 2 * Gh), dtype=out_dtype, device=packed.device)
    status = build.library().kv_dequant_launch(
        packed.data_ptr(), scale.data_ptr(), zero.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), N, 2 * Gh,
        torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(status, "kv_dequant")
    kv_dequant.launches += 1
    return out


kv_dequant.launches = 0
