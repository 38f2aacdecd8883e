"""The work of the served model, from a configuration's published keys and
the traffic's shapes: model FLOPs of a decode step and of a prompt (the
numerator of ``mfu.*``), and the attention kernels' least time (the
numerator of ``attn_roofline.*``, through the frozen ``kernel_cost``).

Model FLOPs count 2 per weight a token meets in a product (a MoE layer:
the router and the ``top-k`` experts the token is routed to, not the
experts it skips), the attention's two products over the positions a
query sees (4 ``head_dim`` a query head and key), Mamba's scan (9
operations a channel and state: the decay's exp and product, the input's
two products, the update's two, the read-out's two, the skip) and conv
(2 a tap and channel), and the unembedding where logits are made: every
decode token, a prompt's last position only.
"""
from __future__ import annotations

from typing import Iterable

import torch

from pbench import kernel_cost, peaks, spec


def _dims(m):
    d, H = int(m["hidden_size"]), int(m["num_attention_heads"])
    return d, H, int(m["num_key_value_heads"]), spec.head_dim(m), \
        int(m["intermediate_size"]), int(m["vocab_size"])


def weights_per_token(m: dict) -> int:
    """Weights a token meets in the layers' products (no unembedding)."""
    d, H, Hkv, hd, f, V = _dims(m)
    n = 0
    for mix, ffn in spec.layer_kinds(m):
        if mix == "attn":
            n += d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
        else:
            di, ds, dc, dtr = spec.mamba_dims(m)
            n += d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
        if ffn == "moe":
            n += d * int(m["num_experts"]) + \
                int(m["num_experts_per_tok"]) * 3 * d * f
        else:
            n += 3 * d * f
    return n


def _per_token_fixed(m: dict) -> float:
    flops = 2.0 * weights_per_token(m)
    for mix, _ in spec.layer_kinds(m):
        if mix == "mamba":
            di, ds, dc, _ = spec.mamba_dims(m)
            flops += 9 * di * ds + 2 * dc * di
    return flops


def n_attn(m: dict) -> int:
    return sum(mix == "attn" for mix, _ in spec.layer_kinds(m))


def decode_flops(m: dict, kv_lens: Iterable[int]) -> float:
    """One decode token for each ``kv_len`` (the positions its query
    sees, itself included)."""
    d, H, Hkv, hd, f, V = _dims(m)
    fixed = _per_token_fixed(m) + 2.0 * d * V
    na = n_attn(m)
    return sum(fixed + 4.0 * hd * H * kv * na for kv in kv_lens)


def prefill_flops(m: dict, n: int) -> float:
    """One prompt of ``n`` tokens, causal, logits at its last position."""
    d, H, Hkv, hd, f, V = _dims(m)
    return n * _per_token_fixed(m) + 4.0 * hd * H * n * (n + 1) / 2 \
        * n_attn(m) + 2.0 * d * V


def _group(span: int) -> int:
    return next((g for g in (128, 64, 32, 16, 8, 4, 2) if span % g == 0), 0)


def decode_attention_bound_s(m: dict, kv_lens, *, paged_int4: bool,
                             page_size: int, max_seq: int) -> float:
    """Least time of one decode step's attention over every attention
    layer: one launch a layer over the slots of ``kv_lens``."""
    kv_lens = list(kv_lens)
    if not kv_lens:
        return 0.0
    d, H, Hkv, hd, f, V = _dims(m)
    B, gq = len(kv_lens), H // Hkv
    bf, u8, f32, i32 = torch.bfloat16, torch.uint8, torch.float32, \
        torch.int32
    if paged_int4:
        g = _group(Hkv * hd)
        R = page_size * (Hkv * hd // g)
        W = -(-max_seq // page_size)
        shapes = [(B, Hkv, gq, hd), (1, R, g // 2), (1, R, 1), (1, R, 1),
                  (1, R, g // 2), (1, R, 1), (1, R, 1), (B, W), (B,)]
        dtypes = [bf, u8, f32, f32, u8, f32, f32, i32, i32]
        fl, by = kernel_cost.paged_decode_attention_int4(
            shapes, dtypes, page_size=page_size, kv_len=kv_lens)
    else:
        shapes = [(B, Hkv, gq, hd), (B, Hkv, max_seq, hd),
                  (B, Hkv, max_seq, hd), (B,)]
        fl, by = kernel_cost.decode_attention(shapes, [bf, bf, bf, i32],
                                              kv_len=kv_lens)
    return n_attn(m) * peaks.bound_s(fl, by)


def prefill_attention_bound_s(m: dict, n: int) -> float:
    """Least time of one prompt's causal flash attention over every
    attention layer (its own ``n`` tokens, no padding)."""
    d, H, Hkv, hd, f, V = _dims(m)
    bf = torch.bfloat16
    fl, by = kernel_cost.flash_attention(
        [(1, n, H, hd), (1, n, Hkv, hd), (1, n, Hkv, hd)], [bf, bf, bf],
        causal=True)
    return n_attn(m) * peaks.bound_s(fl, by)


def decode_step_lens(call, max_seq: int):
    """The kv_len of every (step, active slot) of a decode call, each slot
    stepping until its request is done: ``[[kv_len, ...] per step]``."""
    out = []
    for s in range(call.n_steps):
        out.append([ln + s + 1 for ln, left in zip(call.lens, call.left)
                    if s < max(left, 1) and ln + s + 1 < max_seq])
    return out

