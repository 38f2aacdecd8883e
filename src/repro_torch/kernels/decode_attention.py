"""Wrapper of the dense flash-decode CUDA kernel
(``csrc/decode_attention.cu``; it replaces
``repro/kernels/decode_attention.py``).

CUDA tensors only (``kernels/ops.py`` sends CPU tensors to
``ref.decode_attention_ref``); the launch count is
``decode_attention.launches``. K and V are read IN PLACE through their
strides: any view whose last (head) dimension is contiguous, such as the
JAX signature's ``(B, Hkv, S, hd)`` or one layer of the port's dense
decode cache ``(B, S, Hkv, hd)`` permuted to ``(B, Hkv, S, hd)``. The
wrapper never copies K/V: copying the cache of every layer at every step
would move the whole ``max_seq`` cache per token.

The reference's model does not call its Pallas ``decode_attention``: its
dense decode step attends in plain jnp (``layers.attention`` with
``kv_len``/``q_offset``). The port's dense step calls this kernel, which
computes the same function: keys at or past ``kv_len[b]`` are masked.

The kernel splits the sequence across CTAs (flash-decoding): the split
plan (:func:`split_plan`, :func:`launch_shape`) is shared with the bf16
page residency (``paged_attention.paged_decode_attention_bf16``, the same
CUDA body) and with the int4 kernel, and so are the merge counters
(:func:`_counters`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant import _require_cuda, no_grad_inputs

HEAD_DIMS = (16, 32, 64, 80, 120, 128, 256)   # the instantiations
_TYPES = (torch.bfloat16, torch.float32)
SPLIT_TOKENS = 64     # keys a split covers (a whole number of pages)


def lane_elems(hd: int) -> int:
    """Contiguous elements of a K/V row each lane of a half-warp reads
    (``Lanes`` in ``csrc/decode_attention.cu``): ``hd // 16`` where that
    is a power of two, else 8 (hd 80 and 120: 10 or 15 lanes busy). K/V
    strides must be whole multiples of it."""
    q = hd // 16
    return q if hd % 16 == 0 and q & (q - 1) == 0 else 8


def split_plan(W: int, page_size: int):
    """``(pages_per_split, n_split)`` for a page table of width ``W``: split
    s covers pages ``[s * pages_per_split, min((s + 1) * pages_per_split,
    W))``; a dense view of S keys is S pages of one key. A function of host
    shapes only, never of ``kv_len``: the decode chunk runs under
    ``set_sync_debug_mode("error")`` and the launch must stay capturable in
    a CUDA graph; the kernels' CTAs whose split starts at or past
    ``kv_len`` exit at once."""
    pages = max(1, SPLIT_TOKENS // page_size)
    return pages, -(-W // pages)


def launch_shape(B: int, Hkv: int, g: int, hd: int, W: int,
                 page_size: int = 1):
    """The bf16 decode body's grid ``(n_split, B * Hkv, g)``, keys per
    split, f32 scratch elements (one ``(m, l, acc[hd])`` per query row and
    split) and merge counters (one per query row), from host shapes: ``W``
    pages of ``page_size`` keys (a dense view: ``W = S``, ``page_size =
    1``)."""
    pages, n_split = split_plan(W, page_size)
    return ((n_split, B * Hkv, g), pages * page_size,
            B * Hkv * g * n_split * (hd + 2), B * Hkv * g)


_COUNTERS = {}        # device index -> [int32 zeros], newest last


def _counters(device, n: int) -> torch.Tensor:
    """The merge counters of ``device``, shared by the split decode kernels
    (the int4 pages' and the bf16 body, dense or paged): zeroed once,
    reset to 0 by each launch's last CTA, so no launch pays a memset.
    Because the buffer is shared, launches on one device run in stream
    order and must not overlap. A buffer that grows keeps its predecessor
    alive: a captured CUDA graph may still point at it."""
    bufs = _COUNTERS.setdefault(device.index, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros((max(n, 1 << 14),), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def split_operands(q, B, Hkv, g, hd, W, page_size=1):
    """``(split_len, n_split, part, counters)`` of one bf16-body launch."""
    grid, split_len, n_part, n_count = launch_shape(B, Hkv, g, hd, W,
                                                    page_size)
    part = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    return split_len, grid[0], part, _counters(q.device, n_count)


def decode_attention(q, k, v, kv_len, *, sm_scale=None, softcap=0.0):
    """q: (B, Hkv, g, hd) contiguous, bf16/f32; k/v: (B, Hkv, S, hd) views
    with the same strides and a contiguous last dimension, bf16/f32;
    kv_len (B,) int32. Keys at or past ``kv_len[b]`` are never loaded;
    ``kv_len`` 0 gives zeros (the plain version's softmax over an all-masked
    row gives the mean of V instead; the model never asks: its kv_len is
    at least 1). A logit ``softcap`` > 0 caps each scaled score (``c
    tanh(s / c)``, before the mask) in the kernel's capped instantiation.
    Returns (B, Hkv, g, hd) in ``q.dtype``."""
    out = _launch("decode_attention", q, k, v, kv_len, sm_scale, False,
                  softcap)
    decode_attention.launches += 1
    return out


def decode_attention_lse(q, k, v, kv_len, *, sm_scale=None, softcap=0.0):
    """The partial mode of :func:`decode_attention` (the same kernel with
    its log-sum-exp output on; its own launch count): ``(o, lse)``, ``o``
    (B, Hkv, g, hd) f32 whatever q's type, normalised over this call's
    keys (so the merge reads it unrounded), and ``lse``
    (B, Hkv, g) f32, the log-sum-exp of each row's scaled scores, ``-inf``
    where ``kv_len`` is 0 (``o`` 0 there): what ``comm.merge_partials``
    needs to merge rows over disjoint key ranges held by different ranks
    (the kv_seq decode cache)."""
    out = _launch("decode_attention_lse", q, k, v, kv_len, sm_scale, True,
                  softcap)
    decode_attention_lse.launches += 1
    return out


def _launch(name, q, k, v, kv_len, sm_scale, with_lse, softcap):
    """One launch of the dense body: ``out`` in q's type, and with
    ``with_lse`` f32 with the f32 log-sum-exp of each row beside it."""
    no_grad_inputs(name, q, k, v)
    _require_cuda(name, q=q, kv_len=kv_len)
    for arg, t in (("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
    B, Hkv, g, hd = q.shape
    S = k.shape[2]
    epl = lane_elems(hd) if hd in HEAD_DIMS else 1
    ok = (q.dtype in _TYPES and k.dtype in _TYPES and v.dtype == k.dtype
          and k.dim() == 4 and tuple(k.shape) == (B, Hkv, S, hd)
          and tuple(v.shape) == tuple(k.shape)
          and k.stride() == v.stride() and k.stride(3) == 1
          and hd in HEAD_DIMS
          and all(s % epl == 0 for s in k.stride()[:3])
          and all(t.data_ptr() % 16 == 0 for t in (q, k, v)) and S > 0
          and softcap >= 0
          and kv_len.dtype == torch.int32 and tuple(kv_len.shape) == (B,))
    if not ok:
        raise ValueError(
            f"{name}: bad operands q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} {k.dtype} strides {k.stride()}, v "
            f"{tuple(v.shape)} {v.dtype} strides {v.stride()}, kv_len "
            f"{tuple(kv_len.shape)} {kv_len.dtype}, softcap {softcap}; "
            f"want a contiguous head "
            f"dimension in {HEAD_DIMS}, 16-byte aligned rows, and no copy")
    sb, sh, ss, _ = k.stride()
    lse = torch.empty((B, Hkv, g), dtype=torch.float32, device=q.device) \
        if with_lse else None
    out = torch.empty_like(q, dtype=torch.float32 if with_lse else None)
    split_len, n_split, part, counters = split_operands(q, B, Hkv, g, hd, S)
    status = build.library().decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
        v.data_ptr(), int(k.dtype == torch.bfloat16), kv_len.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, Hkv, g, hd, S, sb, ss, sh,
        split_len, n_split, sm_scale or 1.0 / math.sqrt(hd), float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, name)
    return out if lse is None else (out, lse)


decode_attention.launches = 0
decode_attention_lse.launches = 0
