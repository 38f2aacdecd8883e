"""Paged decode cache and decode step (``repro.models.paged``).

The decode KV cache is a pool of fixed-size PAGES (``page_size`` tokens)
shared by every slot of a decode engine; each slot names its pages through
a row of ``page_table``. At rest the pages hold (by default) the SAME
group-wise affine int4 encoding the prefill->decode wire uses, so an
arriving wire scatters straight into pages and attention dequantizes
inside the kernel.

Layouts, stacked over the L layers (the reference's), one per residency:

* ``"int4"``: ``kp/vp (L, P, page_size*ppr, g//2) u8`` packed nibbles and
  ``ks/kz/vs/vz (L, P, page_size*ppr, 1) f32`` scale/zero, where
  ``g = page_group(cfg)`` divides Hkv*hd and ``ppr = Hkv*hd // g``; row
  ``t*ppr + r`` of a page is token t's r-th group;
* ``"bf16"``: ``k/v (L, P, page_size, Hkv, hd)`` bf16, the reference's
  ablation residency (attention through the bf16 paged kernel).

Page 0 is the TRASH page: unallocated table entries are 0, and inactive
slots' writes land there.

Where the reference returns updated arrays, ``decode_step_paged`` writes
the appended token's page rows IN PLACE (index_put on the page buffers)
and returns the same cache dict with new ``lengths``. Every index is a
device tensor, so the step never synchronizes with the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.kv_layout import pick_group
from repro_torch.models import layers
from repro_torch.models.transformer import (embed, logits_of, run_layers,
                                           shard_view)

DEFAULT_PAGE_SIZE = 16
PAGE_KEYS = ("kp", "ks", "kz", "vp", "vs", "vz")


def page_group(cfg) -> int:
    """The quantization group width shared with the wire format."""
    return pick_group(cfg.num_kv_heads * cfg.head_dim)


def groups_per_token(cfg) -> int:
    return (cfg.num_kv_heads * cfg.head_dim) // page_group(cfg)


def table_width(max_seq: int, page_size: int) -> int:
    """Page-table row width: enough entries for a max_seq-token slot."""
    return -(-max_seq // page_size)


def paged_supported(cfg) -> bool:
    """Pure full-attention stacks without logit softcap (the families the
    port runs so far are all dense)."""
    if cfg.family == "audio" or cfg.sliding_window or cfg.attn_logit_softcap:
        return False
    mixes = {k.split("+")[0] for k in cfg.layer_kinds()}
    return mixes == {"attn"} and page_group(cfg) > 0


def init_paged_cache(cfg, max_slots: int, max_seq: int, num_pages: int, *,
                     page_size: int = DEFAULT_PAGE_SIZE,
                     resident: str = "int4", device="cuda"):
    """Page buffers (all zero) of the ``resident`` layout, ``page_table
    (max_slots, W)`` (all trash) and ``lengths``."""
    if not paged_supported(cfg):
        raise ValueError(f"{cfg.name}: arch cannot page its decode cache")
    L = cfg.num_layers
    if resident == "int4":
        g, ppr = page_group(cfg), groups_per_token(cfg)
        R = page_size * ppr
        slot = {}
        for name in PAGE_KEYS:
            packed = name.endswith("p")
            slot[name] = torch.zeros(
                (L, num_pages, R, g // 2 if packed else 1),
                dtype=torch.uint8 if packed else torch.float32,
                device=device)
    elif resident == "bf16":
        shape = (L, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        slot = {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
                for name in ("k", "v")}
    else:
        raise ValueError(f"unknown residency {resident!r}")
    W = table_width(max_seq, page_size)
    return {"slot0": slot,
            "page_table": torch.zeros((max_slots, W), dtype=torch.int32,
                                      device=device),
            "lengths": torch.zeros((max_slots,), dtype=torch.int32,
                                   device=device)}


def decode_step_paged(cfg, params, cache, tokens, *,
                      page_size: int = DEFAULT_PAGE_SIZE,
                      backend: str = "auto", rt=None):
    """One decode step against the paged pool. tokens: (B, 1).

    Each slot's new K/V is written into its tail page: int4 pages take it
    through ``ops.kv_quant_append`` (quantized with the wire's arithmetic,
    so pages are byte-identical whichever path wrote a token; one launch a
    layer on the card), bf16 pages as bf16 rows (one ``index_put`` each
    for K and V). Attention runs through
    ``ops.paged_decode_attention``, whose kernel follows the residency.
    Returns (logits (B, 1, V) f32, cache) with ``lengths + 1``; the page
    table is host business. Under a mesh (``rt``) the pages hold this
    rank's KV heads (``cfg`` there is ``sharding.local_cfg``'s, as
    ``init_paged_cache`` was given), and their int4 group is the one
    this rank's span picks."""
    cfg, tp = shard_view(cfg, rt)
    x = embed(cfg, params, tokens, tp=tp)
    B = x.shape[0]
    lengths = cache["lengths"]
    positions = lengths[:, None]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    gq = cfg.num_heads // Hkv
    int4 = "kp" in cache["slot0"]
    pt = cache["page_table"]
    ps = page_size
    if not int4:
        tail_page, tail_off = ref.append_coords(pt, lengths, ps)
    kv_len = (lengths + 1).to(torch.int32)
    slot = cache["slot0"]

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        if int4:
            kpages = tuple(slot[n][i] for n in ("kp", "ks", "kz"))
            vpages = tuple(slot[n][i] for n in ("vp", "vs", "vz"))
            ops.kv_quant_append(k, v, kpages, vpages, pt, lengths,
                                page_size=ps, backend=backend)
        else:
            kpages, vpages = slot["k"][i], slot["v"][i]
            kpages[tail_page, tail_off] = k[:, 0].to(kpages.dtype)
            vpages[tail_page, tail_off] = v[:, 0].to(vpages.dtype)
        qr = q[:, 0].reshape(B, Hkv, gq, hd).contiguous()
        o = ops.paged_decode_attention(qr, kpages, vpages, pt, kv_len,
                                       page_size=ps, backend=backend)
        return layers.row_proj(p["attn"], "wo",
                               o.reshape(B, 1, cfg.q_dim).to(h.dtype), tp)

    _, h = run_layers(cfg, params, x, attend, backend=backend, rt=rt)
    logits = logits_of(cfg, params, h, tp)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits, new_cache
