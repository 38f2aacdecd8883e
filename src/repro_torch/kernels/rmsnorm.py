"""Wrappers of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``; it replaces
``repro/kernels/rmsnorm.py``): ``rmsnorm`` and ``add_rmsnorm``, the same
body with the residual add in front of the norm fused in.

CUDA tensors only (``kernels/ops.py`` sends CPU tensors to
``ref.rmsnorm_ref`` and ``ref.add_rmsnorm_ref``); the launch counts are
``rmsnorm.launches`` and ``add_rmsnorm.launches``. A launch reads nothing
back from the card, so it runs inside the decode chunk's no-sync region.

The launch configuration (:func:`norm_plan`) is a function of the row
width and the body alone, never of the number of rows: a row normed in a
4-row launch has the bytes it has in a 1024-row one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant import _require_cuda, no_grad_inputs

MAX_THREADS = 512            # the kernel's __launch_bounds__
ELEMS_PER_THREAD = 32        # the most a thread holds in registers
MAX_D = MAX_THREADS * ELEMS_PER_THREAD
_TYPES = (torch.bfloat16, torch.float32)


def vector_width(d: int, esz: int, *tensors) -> int:
    """Elements a thread loads at once: 16 bytes' worth (the vector body)
    when rows of ``d`` elements of ``esz`` bytes keep every 16-byte
    boundary and every tensor starts on one, else 1 (the scalar body)."""
    vec = 16 // esz
    if d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return vec
    return 1


def norm_plan(d: int, vec: int):
    """``(vectors a thread holds, threads)`` for one row of ``d`` elements
    read ``vec`` at a time: the fewest vectors a thread that keep the block
    at most ``MAX_THREADS``, the block a whole number of warps. It fixes
    the row's summation order, so it reads nothing but ``d`` and ``vec``."""
    nvec = -(-d // vec)
    vpt = 1
    while vpt * vec <= ELEMS_PER_THREAD:
        threads = -(-nvec // vpt)
        if threads <= MAX_THREADS:
            return vpt, -(-threads // 32) * 32
        vpt *= 2
    raise ValueError(f"rmsnorm: rows of {d} elements exceed the kernel's "
                     f"{MAX_D} (a row is held in registers)")


def _launch(name, x, r, scale, eps):
    d = x.shape[-1]
    same = r is None or (r.dtype == x.dtype and r.shape == x.shape
                         and r.is_contiguous())
    if (x.dtype not in _TYPES or scale.dtype != torch.float32
            or tuple(scale.shape) != (d,) or d == 0 or not same
            or not x.is_contiguous() or not scale.is_contiguous()):
        got = "" if r is None else f", r {tuple(r.shape)} {r.dtype}"
        raise ValueError(f"{name}: want contiguous x (..., d) bf16/f32 (and "
                         f"r like x) and scale (d,) f32, got x "
                         f"{tuple(x.shape)} {x.dtype}{got}, scale "
                         f"{tuple(scale.shape)} {scale.dtype}")
    h = None if r is None else torch.empty_like(x)
    y = torch.empty_like(x)
    tensors = [t for t in (x, r, scale, h, y) if t is not None]
    vec = vector_width(d, x.element_size(), *tensors)
    vpt, threads = norm_plan(d, vec)
    status = build.library().rmsnorm_launch(
        x.data_ptr(), None if r is None else r.data_ptr(), scale.data_ptr(),
        None if h is None else h.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.bfloat16), x.numel() // d, d, vec, vpt, threads,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return h, y


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., d) bf16/f32 contiguous; scale: (d,) f32. Returns
    ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in ``x.dtype``."""
    no_grad_inputs("rmsnorm", x, scale)
    _require_cuda("rmsnorm", x=x, scale=scale)
    _, y = _launch("rmsnorm", x, None, scale, eps)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def add_rmsnorm(x, r, scale, *, eps: float = 1e-6):
    """x, r: (..., d) bf16/f32 contiguous, one shape and type; scale: (d,)
    f32. Returns ``(h, y)``: ``h = x + r`` (f32 sum rounded once to
    ``x.dtype``, PyTorch's ``x + r`` byte for byte) and ``y`` =
    :func:`rmsnorm` of ``h``, in one launch."""
    no_grad_inputs("add_rmsnorm", x, r, scale)
    _require_cuda("add_rmsnorm", x=x, r=r, scale=scale)
    h, y = _launch("add_rmsnorm", x, r, scale, eps)
    add_rmsnorm.launches += 1
    return h, y


add_rmsnorm.launches = 0
