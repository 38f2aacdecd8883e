"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

They are what ``kernels/ops.py`` runs on CPU tensors, and the yardstick
each CUDA kernel is held to on the card. Only the int4 residency of the
paged decode attention is ported; the bf16 page residency waits for its
kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.kv_layout import interleave_nibbles, pack_nibbles

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, kv_len=None, sm_scale=None):
    """q: (B, Hkv, g, hd); k/v: (B, Hkv, S, hd); kv_len: (B,) valid
    lengths. f32 softmax; output in ``q.dtype``."""
    B, Hkv, g, hd = q.shape
    S = k.shape[2]
    sm_scale = sm_scale or 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * sm_scale
    if kv_len is not None:
        pos = torch.arange(S, device=q.device)
        mask = pos[None, None, None, :] < kv_len[:, None, None, None]
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", w, v.float())
    return o.to(q.dtype)


def paged_gather_ref(pages, page_table, *, page_size):
    """Dequantize int4 pages ``(packed (P, page_size*ppr, g//2), scale,
    zero)`` through ``page_table (B, W)`` into dense f32
    ``(B, W*page_size, Hkv*hd)``. Table entry 0 is the trash page."""
    packed, scale, zero = pages
    pt = page_table.clamp(min=0).long()
    g = packed.shape[-1] * 2
    x = kv_dequant_ref(packed[pt], scale[pt], zero[pt], dtype=torch.float32)
    B, W, R = x.shape[:3]
    ppr = R // page_size
    return x.reshape(B, W * page_size, ppr * g)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, kv_len, *,
                               page_size, sm_scale=None):
    """q: (B, Hkv, gq, hd); int4 K/V pages as in ``paged_gather_ref``.
    Gathers and dequantizes to dense, then runs the dense decode version."""
    B, Hkv, gq, hd = q.shape
    k = paged_gather_ref(k_pages, page_table, page_size=page_size)
    v = paged_gather_ref(v_pages, page_table, page_size=page_size)
    S = k.shape[1]
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    return decode_attention_ref(q, k, v, kv_len=kv_len, sm_scale=sm_scale)


def kv_quant_ref(x):
    """Group-wise int4 quantization over the last axis. x: (N, G).

    Returns (packed (N, G//2) uint8, scale (N,1) f32, zero (N,1) f32).
    True division and round-half-to-even, like ``jnp.round``."""
    xf = x.float()
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ in the last bit
    scale = torch.clamp(mx - mn, min=1e-8) / torch.full_like(mn, 15.0)
    q = torch.clamp(torch.round((xf - mn) / scale), 0, 15).to(torch.uint8)
    packed = pack_nibbles(q[..., 0::2], q[..., 1::2])
    return packed, scale, mn


def kv_dequant_ref(packed, scale, zero, dtype=torch.bfloat16):
    """Inverse of :func:`kv_quant_ref`: ``nibble * scale + zero`` (a
    separate multiply and add, no fused multiply-add) cast to ``dtype``."""
    q = interleave_nibbles(packed)
    return (q * scale + zero).to(dtype)
