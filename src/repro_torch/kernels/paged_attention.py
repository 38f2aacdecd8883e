"""Wrappers of the paged decode-attention CUDA kernels, one per page
residency of ``repro/kernels/paged_attention.py``:

* int4 pages (``_kernel_int4``): ``csrc/paged_attention.cu``, dequantization
  fused into the loop, each slot's sequence split (flash-decoding) by
  :func:`int4_split` of its own kv_len, the CTAs given the live (slot,
  split, KV head, row block) items alone (:func:`launch_shape`);
* bf16 pages (``_kernel_bf16``): the bf16 decode body of
  ``csrc/decode_attention.cu``, the dense decode kernel with key t read
  from row ``t % page_size`` of page ``page_table[b, t // page_size]``,
  split across the sequence the same way.

CUDA tensors only (``kernels/ops.py`` sends CPU tensors to
``ref.paged_decode_attention_ref``); the launch counts are
``paged_decode_attention_int4.launches`` and
``paged_decode_attention_bf16.launches``; the int4 kernel also counts the
CTAs it launches in ``paged_decode_attention_int4.ctas``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    HEAD_DIMS, _counters, split_operands, split_plan)
from repro_torch.kernels.kv_quant import _require_cuda, no_grad_inputs

INT4_HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the int4 instantiations


def rows_per_cta(gq: int) -> int:
    """Query rows a CTA keeps in registers: 1, or 4 under GQA (a block of
    4 rows, the last one padded)."""
    return 1 if gq == 1 else 4


def lane_elems(hd: int, rows: int) -> int:
    """Elements of a head each lane of the int4 kernel reads (``Geo`` in
    ``csrc/paged_attention.cu``): at one query row 32 (16 packed bytes),
    or the widest of 16 and 8 that divides hd (hd itself below 32); at
    several rows 8. It must divide the quantization group too."""
    if rows > 1:
        return 8
    if hd < 32:
        return hd
    return next(e for e in (32, 16, 8) if hd % e == 0)


# a slot's int4 splits: its pages in about INT4_SPLITS runs, each of
# split_plan's pages (64 tokens) to INT4_MAX_SPLIT_TOKENS (kSplits and
# kMaxSplitTokens in csrc/paged_attention.cu)
INT4_SPLITS = 4
INT4_MAX_SPLIT_TOKENS = 256


def int4_split(kv_len: int, W: int, page_size: int):
    """``(split_tokens, n_split)`` of one slot in the int4 kernel
    (``split_pages`` in ``csrc/paged_attention.cu``): a function of its own
    kv_len (clamped to ``[0, W * page_size]``) and the shapes alone, never
    of the other slots. Up to ``INT4_SPLITS`` splits of split_plan's 64
    tokens it is split_plan's split; a longer slot's splits grow to
    ``INT4_MAX_SPLIT_TOKENS``, so a split's fixed costs (its page ids, the
    merge of its token groups, its partial state and the merge of the
    splits) buy more keys, and beyond that it gets more splits."""
    pages, _ = split_plan(W, page_size)
    max_pages = max(pages, INT4_MAX_SPLIT_TOKENS // page_size)
    n = min(max(kv_len, 0), W * page_size)
    per = -(-(-(-n // page_size)) // INT4_SPLITS)
    tokens = min(max(per, pages), max_pages) * page_size
    return tokens, -(-n // tokens)


# the grid: up to this many times the CTAs the card keeps resident
WAVES = 4


def launch_shape(B: int, Hkv: int, gq: int, hd: int, W: int,
                 page_size: int, sms: int, per_sm: int):
    """The int4 kernel's CTAs, its f32 scratch elements (one
    ``(m, l, acc[hd])`` per row and split) and its merge counters (one per
    slot, head and row block), from host shapes and the card's residency
    alone (``sms`` SMs, ``per_sm`` CTAs of the kernel each,
    :func:`occupancy`): a 1-D grid of :data:`WAVES` times the CTAs the card
    keeps resident, capped by the work items the shapes allow, ``B *
    n_split * Hkv * row blocks``. Its CTAs stride over the live items,
    which the kernel lists from ``kv_len`` on the card."""
    _, n_split = split_plan(W, page_size)
    rows = rows_per_cta(gq)
    blocks = -(-gq // rows)
    items = B * Hkv * blocks * n_split
    ctas = max(1, min(items, WAVES * sms * per_sm))
    return (ctas, B * Hkv * blocks * rows * n_split * (hd + 2),
            B * Hkv * blocks)


_OCCUPANCY = {}       # (device index, q is bf16, hd, rows, B) -> (sms, per_sm)


def occupancy(device, q_is_bf16: int, hd: int, rows: int, B: int):
    """``(sms, per_sm)``: the card's SMs and the CTAs of the kernel's
    instantiation an SM holds at once, asked once per key."""
    key = (device.index, q_is_bf16, hd, rows, B)
    if key not in _OCCUPANCY:
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        build.check(build.library().paged_attention_int4_occupancy(
            q_is_bf16, hd, rows, B, ctypes.byref(sms), ctypes.byref(per_sm)),
            "paged_decode_attention occupancy")
        _OCCUPANCY[key] = (sms.value, max(per_sm.value, 1))
    return _OCCUPANCY[key]


def paged_decode_attention_int4(q, k_pages, v_pages, page_table, kv_len, *,
                                page_size, sm_scale=None):
    """q: (B, Hkv, gq, hd) bf16/f32, hd in ``INT4_HEAD_DIMS``;
    ``k_pages``/``v_pages`` the int4 triples ``(packed (P, page_size*ppr,
    g//2) u8, scale (P, ..., 1) f32, zero)``, packed pages 16-byte aligned;
    page_table (B, W) int32 (0 = trash page); kv_len (B,) int32. Returns
    (B, Hkv, gq, hd) in ``q.dtype``."""
    no_grad_inputs("paged_decode_attention_int4", q, k_pages, v_pages)
    kp, ks, kz = k_pages
    vp, vs, vz = v_pages
    _require_cuda("paged_decode_attention", q=q, kp=kp, ks=ks, kz=kz, vp=vp,
                  vs=vs, vz=vz, page_table=page_table, kv_len=kv_len)
    B, Hkv, gq, hd = q.shape
    P, R, g2 = kp.shape
    W = page_table.shape[1]
    g = 2 * g2
    ok = (q.dtype in (torch.bfloat16, torch.float32)
          and kp.dtype == vp.dtype == torch.uint8
          and tuple(vp.shape) == (P, R, g2)
          and all(t.dtype == torch.float32 and tuple(t.shape) == (P, R, 1)
                  for t in (ks, kz, vs, vz))
          and page_table.dtype == kv_len.dtype == torch.int32
          and tuple(page_table.shape) == (B, W)
          and tuple(kv_len.shape) == (B,)
          and hd in INT4_HEAD_DIMS
          and g % lane_elems(hd, rows_per_cta(gq)) == 0
          and kp.data_ptr() % 16 == 0 and vp.data_ptr() % 16 == 0
          and R % page_size == 0
          and (Hkv * hd) == (R // page_size) * g)
    if not ok:
        raise ValueError(
            f"paged_decode_attention: bad operands q {tuple(q.shape)} "
            f"{q.dtype}, pages {tuple(kp.shape)}/{tuple(ks.shape)}, "
            f"page_table {tuple(page_table.shape)} {page_table.dtype}, "
            f"kv_len {tuple(kv_len.shape)} {kv_len.dtype}, "
            f"page_size {page_size}; head_dim must be one of "
            f"{INT4_HEAD_DIMS}, the group a multiple of a lane's elements")
    sm_scale = sm_scale or 1.0 / math.sqrt(hd)
    pages, n_split = split_plan(W, page_size)
    bf16, rows = int(q.dtype == torch.bfloat16), rows_per_cta(gq)
    ctas, n_part, n_count = launch_shape(
        B, Hkv, gq, hd, W, page_size, *occupancy(q.device, bf16, hd, rows, B))
    out = torch.empty_like(q)
    part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    status = build.library().paged_attention_int4_launch(
        q.data_ptr(), bf16, kp.data_ptr(), ks.data_ptr(), kz.data_ptr(),
        vp.data_ptr(), vs.data_ptr(), vz.data_ptr(), page_table.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
        _counters(q.device, n_count).data_ptr(), B, Hkv, gq, hd, W, R, g,
        page_size, pages, n_split, rows, ctas, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_decode_attention")
    paged_decode_attention_int4.launches += 1
    paged_decode_attention_int4.ctas += ctas
    return out


paged_decode_attention_int4.launches = 0
paged_decode_attention_int4.ctas = 0


def paged_decode_attention_bf16(q, k_pages, v_pages, page_table, kv_len, *,
                                page_size, sm_scale=None):
    """q: (B, Hkv, gq, hd) bf16/f32; ``k_pages``/``v_pages`` (P, page_size,
    Hkv, hd) bf16; page_table (B, W) int32 (entries clamped at 0, the trash
    page); kv_len (B,) int32 (keys past ``W * page_size`` do not exist).
    Returns (B, Hkv, gq, hd) in ``q.dtype``."""
    no_grad_inputs("paged_decode_attention_bf16", q, k_pages, v_pages)
    _require_cuda("paged_decode_attention", q=q, k_pages=k_pages,
                  v_pages=v_pages, page_table=page_table, kv_len=kv_len)
    B, Hkv, gq, hd = q.shape
    W = page_table.shape[1]
    ok = (q.dtype in (torch.bfloat16, torch.float32)
          and k_pages.dtype == v_pages.dtype == torch.bfloat16
          and k_pages.dim() == 4
          and tuple(k_pages.shape[1:]) == (page_size, Hkv, hd)
          and tuple(v_pages.shape) == tuple(k_pages.shape)
          and hd in HEAD_DIMS
          and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages))
          and page_table.dtype == kv_len.dtype == torch.int32
          and tuple(page_table.shape) == (B, W) and W > 0
          and tuple(kv_len.shape) == (B,))
    if not ok:
        raise ValueError(
            f"paged_decode_attention: bad bf16 operands q {tuple(q.shape)} "
            f"{q.dtype}, pages {tuple(k_pages.shape)} {k_pages.dtype}, "
            f"page_table {tuple(page_table.shape)} {page_table.dtype}, "
            f"kv_len {tuple(kv_len.shape)} {kv_len.dtype}, page_size "
            f"{page_size}; head_dim must be one of {HEAD_DIMS}")
    out = torch.empty_like(q)
    split_len, n_split, part, counters = split_operands(q, B, Hkv, gq, hd, W,
                                                        page_size)
    status = build.library().paged_attention_bf16_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, Hkv, gq,
        hd, W, page_size, split_len, n_split,
        sm_scale or 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_decode_attention")
    paged_decode_attention_bf16.launches += 1
    return out


paged_decode_attention_bf16.launches = 0
