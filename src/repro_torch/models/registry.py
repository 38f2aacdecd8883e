"""Model API over the ported families (``repro.models.registry``).

``build(cfg)`` returns a :class:`ModelApi` for the dense family, the only
one ported so far; other families raise ``NotImplementedError``. ``decode``
and ``decode_chunk`` step the dense cache (``transformer.decode_step``),
``paged_decode_fns`` the page pool. ``make_decode_chunk`` turns a single
decode step into the engine's
multi-token greedy loop: the reference's device ``lax.scan`` becomes a
Python loop over steps whose state (current tokens, active flags, token
counts) stays in device tensors, so a chunk launches kernels back to back
and never waits on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import paged, transformer


@dataclass
class ModelApi:
    cfg: ModelConfig
    prefill: Callable
    # partial-prefix-hit / chunked-prefill path (transformer.prefill_suffix)
    prefill_suffix: Optional[Callable] = None
    # paged_decode_fns(page_size, backend) -> (step_fn, chunk_fn)
    paged_decode_fns: Optional[Callable] = None
    # dense-cache decode: decode(params, cache, tokens) -> (logits, cache)
    # and its device-resident multi-step loop
    decode: Optional[Callable] = None
    decode_chunk: Optional[Callable] = None


def make_decode_chunk(decode_fn: Callable) -> Callable:
    """Greedy multi-token decode around ``decode_fn(params, cache, tokens)
    -> (logits, cache)``.

    state: {"cur": (B,) int32 current token per slot, "active": (B,) bool,
    "n_out": (B,) int32 tokens emitted so far (incl. first), "max_new":
    (B,) int32}. Returns (tokens (n_steps, B) int32 with -1 where a slot
    was inactive, valid (n_steps, B) bool, cache, state). Inactive slots
    keep their old lengths: the new lengths are computed out of place and
    selected with ``torch.where``. Nothing in the loop reads a device
    value on the host (no ``.item()``, ``int()``, ``.cpu()`` or boolean
    masks)."""

    def decode_chunk(params, cache, state, *, n_steps: int, eos_id: int,
                     max_seq: int):
        cur, active, n_out = state["cur"], state["active"], state["n_out"]
        max_new = state["max_new"]
        toks, valid = [], []
        for _ in range(n_steps):
            logits, new_cache = decode_fn(params, cache, cur[:, None])
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            n_out = n_out + active.to(torch.int32)
            lengths = torch.where(active, new_cache["lengths"],
                                  cache["lengths"])
            new_cache["lengths"] = lengths
            done = active & ((nxt == eos_id) | (n_out >= max_new)
                             | (lengths >= max_seq - 1))
            toks.append(torch.where(active, nxt, -1))
            valid.append(active)
            cur = torch.where(active, nxt, cur)
            active = active & ~done
            cache = new_cache
        return (torch.stack(toks), torch.stack(valid), cache,
                {"cur": cur, "active": active, "n_out": n_out,
                 "max_new": max_new})

    return decode_chunk


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family != "dense" or cfg.norm_type != "rmsnorm" or \
            cfg.qk_norm or cfg.attn_bias or cfg.mlp_bias or \
            cfg.parallel_block or cfg.embed_scale:
        raise NotImplementedError(
            f"{cfg.name}: only the plain dense family (LLaMA-style) is "
            f"ported; see ROADMAP queue A for the others")

    def prefill_fn(params, batch, *, max_seq=None):
        S = batch["tokens"].shape[1]
        return transformer.prefill(
            cfg, params, batch["tokens"], max_seq=max_seq or S,
            last_pos=batch.get("last_pos"), true_len=batch.get("true_len"))

    suffix_fn = paged_fns = None
    if paged.paged_supported(cfg):
        def suffix_fn(params, batch, *, max_seq=None):
            S = batch["tokens"].shape[1]
            return transformer.prefill_suffix(
                cfg, params, batch["tokens"], batch["prefix_kv"],
                batch["prefix_len"], max_seq=max_seq or S,
                last_pos=batch.get("last_pos"),
                true_len=batch.get("true_len"))

        def paged_fns(page_size: int, backend: str = "auto"):
            def step_fn(params, cache, tokens):
                return paged.decode_step_paged(
                    cfg, params, cache, tokens, page_size=page_size,
                    backend=backend)
            return step_fn, make_decode_chunk(step_fn)

    def decode_fn(params, cache, tokens):
        return transformer.decode_step(cfg, params, cache, tokens)

    return ModelApi(cfg=cfg, prefill=prefill_fn,
                    prefill_suffix=suffix_fn, paged_decode_fns=paged_fns,
                    decode=decode_fn,
                    decode_chunk=make_decode_chunk(decode_fn))
