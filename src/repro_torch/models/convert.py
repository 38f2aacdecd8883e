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


def params_from_numpy(tree, cfg, device="cuda"):
    """A parallel block's stack has no ``norm2``, and tied embeddings no
    ``unembed``: neither appears in the result."""
    if set(tree["blocks"]) != {"slot0"}:
        raise NotImplementedError(
            f"{cfg.name}: only single-slot (dense) stacks convert")
    blk = tree["blocks"]["slot0"]
    attn, mlp = blk["attn"], blk["mlp"]
    layers = []
    for i in range(cfg.num_layers):
        layer = {
            "norm1": _norm(blk["norm1"], cfg, device, i),
            "attn": {n: _tensor(attn[n]["w"][i], device)
                     for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: _tensor(mlp[n]["w"][i], device) for n in ("wi", "wo")},
        }
        if "norm2" in blk:
            layer["norm2"] = _norm(blk["norm2"], cfg, device, i)
        layers.append(layer)
    params = {"embed": _tensor(tree["embed"], device), "layers": layers,
              "final_norm": _norm(tree["final_norm"], cfg, device)}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device)
    return params
