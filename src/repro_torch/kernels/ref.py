"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

They are what ``kernels/ops.py`` runs on CPU tensors, and the yardstick
each CUDA kernel is held to on the card. ``paged_decode_attention_ref``
serves both page residencies (int4 triples and bf16 pages).

``flash_attention_ref`` is the prefill attention the model computed in
plain PyTorch before the flash kernel took its place: scores and softmax
in f32, probabilities cast to the value type, materialized for problems
up to 256 x 256 and an online softmax over key chunks above, exactly as
``repro.models.layers.attention``; with ``prefix_len`` the suffix mask of
``repro.models.transformer._suffix_attention``. Both attentions take the
reference's logit ``softcap`` (``s = c tanh(s / c)`` after the
``1/sqrt(hd)`` scale, before the mask; 0 leaves the scores as they are).
The reference's ``_suffix_attention`` leaves the softcap out (ROADMAP
C.4); here the suffix mask takes it like every other mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.kv_layout import interleave_nibbles, pack_nibbles

NEG_INF = -1e30


def cap_scores(s, softcap):
    """The logit softcap of the reference's ``attention_ref``: ``c
    tanh(s / c)`` (``softcap`` c > 0), else ``s`` unchanged."""
    return softcap * torch.tanh(s / softcap) if softcap else s


def decode_attention_ref(q, k, v, *, kv_len=None, sm_scale=None,
                         return_lse=False, softcap=0.0):
    """q: (B, Hkv, g, hd); k/v: (B, Hkv, S, hd) (any strided view);
    kv_len: (B,) valid lengths. f32 softmax; output in ``q.dtype``. A row
    with ``kv_len`` 0 is all masked and gives the mean of V (the kernel
    gives zeros there, as the TPU kernel does; the model's kv_len is at
    least 1).

    ``return_lse``: the kernel's partial mode, ``(o, lse)``: ``o`` f32
    (not cast to q's type), ``lse`` (B, Hkv, g) f32 the log-sum-exp of
    each row's scaled, unmasked scores; a row with ``kv_len`` 0 gives
    ``o`` 0 and ``lse`` -inf, as the kernel does (a kv_seq rank may hold
    no position of a slot yet)."""
    B, Hkv, g, hd = q.shape
    S = k.shape[2]
    sm_scale = sm_scale or 1.0 / math.sqrt(hd)
    s = cap_scores(torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float())
                   * sm_scale, softcap)
    if kv_len is not None:
        pos = torch.arange(S, device=q.device)
        mask = pos[None, None, None, :] < kv_len[:, None, None, None]
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", w, v.float())
    if not return_lse:
        return o.to(q.dtype)
    lse = torch.logsumexp(s, dim=-1)
    if kv_len is not None:
        empty = (kv_len <= 0)[:, None, None]
        lse = torch.where(empty, float("-inf"), lse)
        o = torch.where(empty[..., None], 0.0, o)
    return o, lse


def paged_gather_ref(pages, page_table, *, page_size):
    """Gather pages through ``page_table (B, W)`` into dense f32
    ``(B, W*page_size, Hkv*hd)``: int4 triples ``(packed (P,
    page_size*ppr, g//2), scale, zero)`` are dequantized, bf16 pages
    ``(P, page_size, Hkv, hd)`` cast. Table entry 0 is the trash page."""
    pt = page_table.clamp(min=0).long()
    if isinstance(pages, torch.Tensor):
        gathered = pages[pt]                      # (B, W, ps, Hkv, hd)
        B, W, ps, Hkv, hd = gathered.shape
        return gathered.float().reshape(B, W * ps, Hkv * hd)
    packed, scale, zero = pages
    g = packed.shape[-1] * 2
    x = kv_dequant_ref(packed[pt], scale[pt], zero[pt], dtype=torch.float32)
    B, W, R = x.shape[:3]
    ppr = R // page_size
    return x.reshape(B, W * page_size, ppr * g)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, kv_len, *,
                               page_size, sm_scale=None):
    """q: (B, Hkv, gq, hd); int4 or bf16 K/V pages as in
    ``paged_gather_ref``. Gathers (and dequantizes) to dense, then runs the
    dense decode version."""
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


def append_coords(page_table, lengths, page_size):
    """Where each slot's next token goes: ``(tail_page, tail_off)`` (B,)
    int64, the page ``page_table[b, min(lengths[b] // page_size, W - 1)]``
    (clamped so a slot at its last position, or an inactive one, indexes a
    real table entry; unallocated entries are 0, the trash page) and the
    token's place in it."""
    W = page_table.shape[1]
    pos0 = lengths.long()
    tail_pi = torch.clamp(pos0 // page_size, max=W - 1)
    tail_page = torch.gather(page_table, 1, tail_pi[:, None])[:, 0].long()
    return tail_page.clamp(min=0), pos0 % page_size


def kv_quant_append_ref(k, v, kpages, vpages, page_table, lengths, *,
                        page_size):
    """The paged decode step's append, in place: k/v (B, 1, Hkv, hd) of B
    slots quantized by :func:`kv_quant_ref` (groups of ``g``, the pages'
    width) and slot b's ``ppr`` groups written to rows ``tail_off * ppr +
    r`` of its tail page (:func:`append_coords`) in the int4 triples
    ``kpages``/``vpages`` = ``(packed (P, R, g//2), scale (P, R, 1), zero
    (P, R, 1))``. Inactive slots all write to the trash page 0."""
    B = k.shape[0]
    g = kpages[0].shape[-1] * 2
    ppr = k[0].numel() // g
    tail_page, tail_off = append_coords(page_table, lengths, page_size)
    rows = tail_off[:, None] * ppr \
        + torch.arange(ppr, device=k.device)[None]               # (B, ppr)
    for val, pages in ((k, kpages), (v, vpages)):
        for buf, t in zip(pages, kv_quant_ref(val.reshape(B * ppr, g))):
            buf[tail_page[:, None], rows] = t.reshape(B, ppr, -1)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last axis in
    f32, cast back to ``x.dtype``."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def add_rmsnorm_ref(x, r, scale, eps: float = 1e-6):
    """The residual add and the norm after it: ``h = x + r``, then
    ``(h, rmsnorm_ref(h, scale))``."""
    h = x + r
    return h, rmsnorm_ref(h, scale, eps=eps)


def _mask_bias(qpos, kpos, *, causal, window):
    """(B, Sq, Sk) additive f32 bias from causal / window masks."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    ok = torch.ones(qp.shape[:-1] + kp.shape[-1:], dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window and window > 0:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, NEG_INF)


def _attention_materialized(q, k, v, *, causal, window, softcap=0.0):
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qh = q.reshape(B, Sq, Hk, g, hd)
    s = cap_scores(torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float())
                   / math.sqrt(hd), softcap)
    qpos = torch.arange(Sq, device=q.device).expand(B, Sq)
    kpos = torch.arange(Sk, device=q.device).expand(B, Sk)
    s = s + _mask_bias(qpos, kpos, causal=causal,
                       window=window)[:, None, None]
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _attention_blocked(q, k, v, *, causal, window, softcap=0.0):
    """Online softmax over chunks of 512 queries x 1024 keys (the
    reference's default tiles): no (Sq, Sk) score tensor."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    cq, ck = min(512, Sq), min(1024, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * cq - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * ck - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * ck - Sk))
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        blk = qp[:, qi * cq:(qi + 1) * cq].reshape(B, cq, Hk, g, hd).float()
        qpos = (qi * cq + torch.arange(cq, device=dev)).expand(B, cq)
        m = torch.full((B, Hk, g, cq), NEG_INF, device=dev)
        l = torch.zeros((B, Hk, g, cq), device=dev)
        acc = torch.zeros((B, Hk, g, cq, hd), device=dev)
        for ki in range(nk):
            kblk = kp[:, ki * ck:(ki + 1) * ck]
            vblk = vp[:, ki * ck:(ki + 1) * ck]
            kpos = (ki * ck + torch.arange(ck, device=dev)).expand(B, ck)
            s = cap_scores(torch.einsum("bqhgd,bkhd->bhgqk", blk,
                                        kblk.float()) * scale, softcap)
            bias = _mask_bias(qpos, kpos, causal=causal, window=window)
            # the zero padding past Sk is never a key
            bias = torch.where(kpos[:, None, :] < Sk, bias, NEG_INF)
            s = s + bias[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,cq,Hk,g,hd)
    o = torch.cat(outs, dim=1).reshape(B, nq * cq, H, hd)
    return o[:, :Sq]


def _suffix_attention(q, K, V, prefix_len, softcap=0.0):
    B, S, H, hd = q.shape
    Sk, Hk = K.shape[1], K.shape[2]
    P = Sk - S
    g = H // Hk
    qh = q.reshape(B, S, Hk, g, hd)
    s = cap_scores(torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), K.float())
                   / math.sqrt(hd), softcap)
    j = torch.arange(Sk, device=q.device)[None, None, :]
    i = torch.arange(S, device=q.device)[None, :, None]
    plen = prefix_len[:, None, None]
    ok = torch.where(j < P, j < plen, (j - P) <= i)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(ok, zero, NEG_INF)[:, None, None]
    w = torch.softmax(s, dim=-1).to(V.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), V.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, prefix_len=None,
                        softcap=0.0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd), H a multiple of Hkv (GQA:
    q head h reads kv head h // (H // Hkv)). Output (B, Sq, H, hd) in
    ``q.dtype``.

    Without ``prefix_len``: query i sees key j iff j <= i (``causal``) and
    j > i - window (``window > 0``), positions aligned at 0 -- the TPU
    kernel's contract. With ``prefix_len (B,)``: keys are a right-padded
    prefix of width P = Sk - Sq followed by the Sq suffix keys; query i
    sees prefix key j iff j < prefix_len[b] and suffix key P + j' iff
    j' <= i (suffix prefill and chunked prefill; causal, no window).
    ``softcap`` > 0 caps the scaled scores before the mask."""
    if prefix_len is not None:
        if window or not causal:
            raise ValueError("suffix attention is causal with no window")
        return _suffix_attention(q, k, v, prefix_len, softcap)
    if q.shape[1] * k.shape[1] <= 256 * 256:
        return _attention_materialized(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    return _attention_blocked(q, k, v, causal=causal, window=window,
                              softcap=softcap)
