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


def params_from_numpy(tree, cfg, device="cuda"):
    if set(tree["blocks"]) != {"slot0"}:
        raise NotImplementedError(
            f"{cfg.name}: only single-slot (dense) stacks convert")
    blk = tree["blocks"]["slot0"]
    attn, mlp = blk["attn"], blk["mlp"]
    layers = []
    for i in range(cfg.num_layers):
        layers.append({
            "norm1": _tensor(blk["norm1"]["scale"][i], device),
            "attn": {n: _tensor(attn[n]["w"][i], device)
                     for n in ("wq", "wk", "wv", "wo")},
            "norm2": _tensor(blk["norm2"]["scale"][i], device),
            "mlp": {n: _tensor(mlp[n]["w"][i], device) for n in ("wi", "wo")},
        })
    params = {"embed": _tensor(tree["embed"], device), "layers": layers,
              "final_norm": _tensor(tree["final_norm"]["scale"], device)}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device)
    return params
