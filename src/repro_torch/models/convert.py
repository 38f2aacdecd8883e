"""Weights of the JAX package -> the port's parameter dicts.

``params_from_numpy(tree, cfg, device)`` takes the reference's params
pytree after ``jax.tree.map(np.asarray, params)`` (so this module never
sees a JAX array) and unstacks its layer axis into the port's per-layer
dicts (``models/transformer.py``, ``models/whisper.py``). bfloat16
arrays (numpy's ``ml_dtypes`` type) are carried over bit for bit.
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


def _flat(tree, device, j=None):
    """One layer (index ``j`` of a stacked tree, or an unstacked tree) in
    the port's layout: a ``{"w"(, "b")}`` projection becomes the weight
    under its name and its bias as ``name_b``, a scale-only norm
    (RMSNorm, ``gn``, ``qnorm``) its scale tensor, and any other dict
    (a LayerNorm's ``{"scale", "bias"}``, an MLP, a MoE's shared expert)
    keeps its keys."""
    pick = (lambda a: a) if j is None else (lambda a: a[j])
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = _tensor(pick(v), device)
        elif "w" in v:
            out[k] = _tensor(pick(v["w"]), device)
            if "b" in v:
                out[k + "_b"] = _tensor(pick(v["b"]), device)
        elif set(v) == {"scale"}:
            out[k] = _tensor(pick(v["scale"]), device)
        else:
            out[k] = _flat(v, device, j)
    return out


def _norm(tree, device):
    return _flat({"n": tree}, device)["n"]


def _stack(tree, n, device):
    return [_flat(tree, device, j) for j in range(n)]


def params_from_numpy(tree, cfg, device="cuda"):
    """The reference stacks a decoder's layers in ``period`` slots
    (``blocks = {"slot0": ..., "slot{p-1}": ...}``, each stacked over
    ``num_layers // period`` superblocks): layer i is slot ``i % period``,
    index ``i // period``. Each layer carries what its slot holds: its
    mixer (``attn``, ``mamba``, ``mlstm``, ``slstm``), its FFN (``mlp``,
    ``moe`` with router, experts and shared expert, or none), its norms
    (a parallel block's and an xLSTM block's stack has no ``norm2``), the
    biases and q/k norms where the config has them. Tied embeddings have
    no ``unembed``; a VLM has ``mm_projector``. Whisper's tree (``audio``)
    stacks ``enc_layers`` and ``dec_layers``, each unstacked into a
    list."""
    if cfg.family == "audio":
        out = {k: _tensor(tree[k], device) for k in ("embed", "unembed")}
        out.update(enc_layers=_stack(tree["enc_layers"],
                                     cfg.num_encoder_layers, device),
                   dec_layers=_stack(tree["dec_layers"], cfg.num_layers,
                                     device),
                   enc_norm=_norm(tree["enc_norm"], device),
                   final_norm=_norm(tree["final_norm"], device))
        return out
    blocks = tree["blocks"]
    period = len(transformer.slot_kinds(cfg))
    if set(blocks) != {f"slot{s}" for s in range(period)}:
        raise ValueError(f"{cfg.name}: slots {sorted(blocks)} do not "
                         f"stack {cfg.num_layers} layers of period "
                         f"{period}")
    layers = [_flat(blocks[f"slot{i % period}"], device, i // period)
              for i in range(cfg.num_layers)]
    params = {"embed": _tensor(tree["embed"], device), "layers": layers,
              "final_norm": _norm(tree["final_norm"], device)}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device)
    if "mm_projector" in tree:
        params["mm_projector"] = _tensor(tree["mm_projector"]["w"], device)
    return params
