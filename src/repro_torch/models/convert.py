"""Weights of the JAX package -> the port's parameter dicts.

``params_from_numpy(tree, cfg, device)`` takes the reference's params
pytree after ``jax.tree.map(np.asarray, params)`` (so this module never
sees a JAX array) and unstacks its layer axis into the port's per-layer
dicts (``models/transformer.py``). bfloat16 arrays (numpy's ``ml_dtypes``
type) are carried over bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)          # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _norm(tree, cfg, device, i=None):
    """An RMSNorm's scale tensor, or a LayerNorm's ``{"scale", "bias"}``
    (``layers.norm_apply``); ``i`` picks a layer of a stacked norm."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if cfg.norm_type == "rmsnorm":
        return _tensor(pick(tree["scale"]), device)
    return {k: _tensor(pick(tree[k]), device) for k in ("scale", "bias")}


def _layer(blk, cfg, device, j):
    """Index ``j`` of one slot's stacked block as a port layer dict."""
    attn = blk["attn"]
    layer = {"norm1": _norm(blk["norm1"], cfg, device, j),
             "attn": {n: _tensor(attn[n]["w"][j], device)
                      for n in ("wq", "wk", "wv", "wo")}}
    for n in ("qnorm", "knorm"):
        if n in attn:
            layer["attn"][n] = _tensor(attn[n]["scale"][j], device)
    if "moe" in blk:
        m = blk["moe"]
        layer["moe"] = {n: _tensor(m[n][j], device)
                        for n in ("router", "wi", "wo")}
        if "shared" in m:
            layer["moe"]["shared"] = {
                n: _tensor(m["shared"][n]["w"][j], device)
                for n in ("wi", "wo")}
    else:
        layer["mlp"] = {n: _tensor(blk["mlp"][n]["w"][j], device)
                        for n in ("wi", "wo")}
    if "norm2" in blk:
        layer["norm2"] = _norm(blk["norm2"], cfg, device, j)
    return layer


def params_from_numpy(tree, cfg, device="cuda"):
    """The reference stacks its layers in ``period`` slots (``blocks =
    {"slot0": ..., "slot{p-1}": ...}``, each stacked over ``num_layers //
    period`` superblocks): layer i is slot ``i % period``, index ``i //
    period``. A parallel block's stack has no ``norm2``, and tied
    embeddings no ``unembed``: neither appears in the result. A MoE slot
    carries ``moe`` (router, experts, shared expert), a qk-norm stack the
    ``qnorm``/``knorm`` scales, a VLM ``mm_projector``."""
    blocks = tree["blocks"]
    period = len(transformer.slot_kinds(cfg))
    if set(blocks) != {f"slot{s}" for s in range(period)}:
        raise ValueError(f"{cfg.name}: slots {sorted(blocks)} do not "
                         f"stack {cfg.num_layers} layers of period "
                         f"{period}")
    layers = [_layer(blocks[f"slot{i % period}"], cfg, device, i // period)
              for i in range(cfg.num_layers)]
    params = {"embed": _tensor(tree["embed"], device), "layers": layers,
              "final_norm": _norm(tree["final_norm"], cfg, device)}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device)
    if "mm_projector" in tree:
        params["mm_projector"] = _tensor(tree["mm_projector"]["w"], device)
    return params
