"""Wrappers of the int4 KV (de)quantization CUDA kernels
(``csrc/kv_quant.cu``; they replace ``repro/kernels/kv_quant.py``), and
of the paged decode step's append, which quantizes a step's K and V and
writes them into the slots' tail pages in one launch.

The wrappers take CUDA tensors only: they check device, dtype, shape,
strides and alignment and raise on anything else, allocate the outputs,
launch on the current stream and count their launches in ``.launches``.
Each of ``kv_quant`` and ``kv_dequant`` has two bodies; the wrapper picks
one from the shape and the alignment (:func:`quant_body`,
:func:`dequant_body`), and either counts as a launch. The dispatch that
sends CPU tensors to the plain versions lives in ``kernels/ops.py``.

No kernel of the port has a backward. Every wrapper in ``ops.KERNELS``
first calls :func:`no_grad_inputs`, which raises when autograd records
(``torch.is_grad_enabled()``) and an input requires grad: a launch there
would cut the gradient with no error. Serving params never require
grad, so the check changes no launch and no graph capture.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_IN_TYPES = (torch.bfloat16, torch.float32)


def no_grad_inputs(name: str, *tensors):
    """Raise if autograd records and one of ``tensors`` (tensors, or
    tuples of them: int4 page triples) requires grad: the kernel
    ``name`` has no backward. A check in Python before the launch."""
    if not torch.is_grad_enabled():
        return
    flat = [t for x in tensors
            for t in (x if isinstance(x, (tuple, list)) else (x,))]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad (autograd would cut the gradient here); the "
            f"training forward runs the plain versions (kernels/ref.py)")


def _require_cuda(name: str, **tensors):
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def quant_body(x: torch.Tensor) -> str:
    """``"vector"`` (G/8 lanes a row, 16-byte loads) for rows of
    ``G % 8 == 0`` and ``G <= 256`` from a 16-byte aligned address,
    ``"scalar"`` (a warp a row) for every other ``(N, G)``."""
    G = x.shape[-1]
    vector = G % 8 == 0 and G <= 256 and x.data_ptr() % 16 == 0
    return "vector" if vector else "scalar"


def dequant_body(packed: torch.Tensor) -> str:
    """``"vector"`` (16 output bytes a thread, one store) for ``G % 8 ==
    0`` and ``G <= 1024`` from a 4-byte aligned address, ``"scalar"`` (a
    byte a thread) otherwise: ``_dequantize`` passes row slices of one
    packed tensor, which need not be aligned."""
    half = packed.shape[-1]
    vector = half % 4 == 0 and half <= 512 and packed.data_ptr() % 4 == 0
    return "vector" if vector else "scalar"


def kv_quant(x: torch.Tensor):
    """x: (N, G) bf16/f32 on the card -> (packed (N, G//2) u8, scale (N, 1)
    f32, zero (N, 1) f32), byte-identical to ``ref.kv_quant_ref``, through
    the body :func:`quant_body` picks."""
    no_grad_inputs("kv_quant", x)
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
        int(quant_body(x) == "vector"),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "kv_quant")
    kv_quant.launches += 1
    return packed, scale, zero


kv_quant.launches = 0


def kv_dequant(packed: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor, *, out_dtype=torch.bfloat16):
    """Inverse of :func:`kv_quant`: (N, G) in ``out_dtype`` (bf16/f32),
    value-identical to ``ref.kv_dequant_ref``, through the body
    :func:`dequant_body` picks."""
    no_grad_inputs("kv_dequant", packed, scale, zero)
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
        int(dequant_body(packed) == "vector"),
        torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(status, "kv_dequant")
    kv_dequant.launches += 1
    return out


kv_dequant.launches = 0


def kv_quant_append(k, v, kpages, vpages, page_table, lengths, *,
                    page_size):
    """One decode step's append to int4 pages, in ONE launch and in place.

    k/v: (B, 1, Hkv, hd) bf16/f32, read where they lie through their
    strides (a unit last stride, slot and head strides and the address
    16-byte aligned); kpages/vpages: ``(packed (P, R, g//2) u8, scale
    (P, R, 1) f32, zero (P, R, 1) f32)``, contiguous, ``R = page_size *
    ppr`` with ``ppr = Hkv*hd // g``; page_table (B, W) and lengths (B,)
    int32. Slot b's ppr groups of K (and of V) are quantized as
    :func:`kv_quant` and written to rows ``(lengths[b] % page_size) * ppr
    + r`` of page ``page_table[b, min(lengths[b] // page_size, W - 1)]``
    (clamped at 0, the trash page), byte-identical to
    ``ref.kv_quant_append_ref`` on every page but the trash page, where
    inactive slots' writes race. Reads nothing on the host."""
    no_grad_inputs("kv_quant_append", k, v, kpages, vpages)
    named = {"k": k, "v": v, "page_table": page_table, "lengths": lengths,
             **{f"kpages[{i}]": t for i, t in enumerate(kpages)},
             **{f"vpages[{i}]": t for i, t in enumerate(vpages)}}
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"kv_quant_append: {name} must be a CUDA "
                             f"tensor, got {t.device}")
    kp, ks, kz = kpages
    vp, vs, vz = vpages
    B, S, Hkv, hd = k.shape
    P, R, half = kp.shape
    g = 2 * half
    span = Hkv * hd
    ppr = span // g if g else 0
    W = page_table.shape[-1]
    ok = (k.dtype in _IN_TYPES and v.dtype == k.dtype and k.dim() == 4
          and S == 1 and tuple(v.shape) == tuple(k.shape)
          and k.stride(3) == 1 and v.stride(3) == 1 and hd % 8 == 0
          and all(t.stride(i) % 8 == 0 for t in (k, v) for i in (0, 2))
          and all(t.data_ptr() % 16 == 0 for t in (k, v))
          and g % 8 == 0 and 0 < g <= 256 and span % g == 0
          and R == page_size * ppr
          and all(t.is_contiguous() for t in (*kpages, *vpages,
                                              page_table, lengths))
          and kp.dtype == vp.dtype == torch.uint8
          and tuple(vp.shape) == (P, R, half)
          and all(t.dtype == torch.float32 and tuple(t.shape) == (P, R, 1)
                  for t in (ks, kz, vs, vz))
          and all(t.data_ptr() % 4 == 0 for t in (kp, vp))
          and page_table.dtype == lengths.dtype == torch.int32
          and tuple(page_table.shape) == (B, W) and W > 0
          and tuple(lengths.shape) == (B,))
    if not ok:
        raise ValueError(
            f"kv_quant_append: bad operands k {tuple(k.shape)} {k.dtype} "
            f"strides {k.stride()}, v {tuple(v.shape)} {v.dtype} strides "
            f"{v.stride()}, packed pages {tuple(kp.shape)}/"
            f"{tuple(vp.shape)}, scale/zero {tuple(ks.shape)}, page_table "
            f"{tuple(page_table.shape)} {page_table.dtype}, lengths "
            f"{tuple(lengths.shape)} {lengths.dtype}, page_size "
            f"{page_size}; want (B, 1, Hkv, hd) bf16/f32 with hd % 8 == 0 "
            f"and 16-byte aligned rows (no copy), contiguous pages of a "
            f"group g % 8 == 0, g <= 256, and int32 page_table/lengths")
    status = build.library().kv_quant_append_launch(
        k.data_ptr(), v.data_ptr(), int(k.dtype == torch.bfloat16),
        k.stride(0), k.stride(2), v.stride(0), v.stride(2), B, hd, g, ppr,
        kp.data_ptr(), ks.data_ptr(), kz.data_ptr(), vp.data_ptr(),
        vs.data_ptr(), vz.data_ptr(), P, R, page_table.data_ptr(), W,
        lengths.data_ptr(), page_size,
        torch.cuda.current_stream(k.device).cuda_stream)
    build.check(status, "kv_quant_append")
    kv_quant_append.launches += 1


kv_quant_append.launches = 0
