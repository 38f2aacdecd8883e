"""Weights of the JAX package <-> the port's parameter dicts.

``params_from_numpy(tree, cfg, device)`` takes the reference's params
pytree after ``jax.tree.map(np.asarray, params)`` (so this module never
sees a JAX array), or the same pytree of CPU tensors (a checkpoint the
port loaded), and unstacks its layer axis into the port's per-layer
dicts (``models/transformer.py``, ``models/whisper.py``). bfloat16
arrays (numpy's ``ml_dtypes`` type) are carried over bit for bit.

``params_to_tree(params, cfg, device)`` is the exact inverse, into
tensors: the layers restacked into the reference's ``blocks/slot{s}``
(or whisper's ``enc_layers``/``dec_layers``), the biases and scales
nested back; ``params_to_numpy`` the same into numpy arrays. The AdamW
state (``m`` and ``v`` shaped like the params, and ``step``) has the
same pair. The port's checkpoints are written through these, in the
reference's layout, so each package loads the other's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def params_from_numpy(tree, cfg, device="cuda", mesh=None):
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
    list. With a ``mesh`` only this rank's shard is kept
    (``sharding.shard_params``), one layer at a time."""
    from repro_torch.distributed import sharding
    sharding.check_tp(cfg, sharding.model_size(mesh))
    if cfg.family == "audio":
        out = sharding.shard_params(
            {k: _tensor(tree[k], device) for k in ("embed", "unembed")},
            cfg, mesh)
        out.update({name: [sharding.shard_params(
            _flat(tree[name], device, j), cfg, mesh) for j in range(n)]
            for name, n in (("enc_layers", cfg.num_encoder_layers),
                            ("dec_layers", cfg.num_layers))})
        out.update(enc_norm=_norm(tree["enc_norm"], device),
                   final_norm=_norm(tree["final_norm"], device))
        return out
    blocks = tree["blocks"]
    period = len(transformer.slot_kinds(cfg))
    if set(blocks) != {f"slot{s}" for s in range(period)}:
        raise ValueError(f"{cfg.name}: slots {sorted(blocks)} do not "
                         f"stack {cfg.num_layers} layers of period "
                         f"{period}")
    layers = [sharding.shard_params(
        _flat(blocks[f"slot{i % period}"], device, i // period), cfg, mesh)
        for i in range(cfg.num_layers)]
    params = {"embed": _tensor(tree["embed"], device), "layers": layers,
              "final_norm": _norm(tree["final_norm"], device)}
    if "unembed" in tree:
        params["unembed"] = _tensor(tree["unembed"], device)
    if "mm_projector" in tree:
        params["mm_projector"] = _tensor(tree["mm_projector"]["w"], device)
    top = sharding.shard_params(
        {k: v for k, v in params.items() if k != "layers"}, cfg, mesh)
    return {k: layers if k == "layers" else top[k] for k in params}


# the reference's leaves that are neither a projection's {"w"(, "b")} nor
# a scale-only norm's {"scale"} (a MoE's expert weights are raw too)
_RAW = frozenset({"embed", "unembed", "A_log", "D", "conv_w", "conv_b",
                  "skip", "router", "r", "scale", "bias"})
# the port's scale tensors that the reference nests as {"scale": ...}
_SCALES = frozenset({"norm1", "norm2", "norm3", "final_norm", "enc_norm",
                     "qnorm", "knorm", "gn"})


def nest(tree, parent=""):
    """The inverse of :func:`_flat` on one unstacked layer (or the
    model's top level): a weight and its ``name_b`` back into ``{"w",
    "b"}``, an RMSNorm scale into ``{"scale"}``, raw leaves as they
    are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = nest(v, k)
        elif k in _RAW or (parent == "moe" and k in ("wi", "wo")):
            out[k] = v
        elif k in _SCALES:
            out[k] = {"scale": v}
        elif not (k.endswith("_b") and k[:-2] in tree):
            out[k] = {"w": v}
            if k + "_b" in tree:
                out[k]["b"] = tree[k + "_b"]
    return out


def _restack(trees, device):
    """Layer trees of one structure -> one tree of stacked tensors on
    ``device`` (each layer copied into its row, so no layer-sized
    temporary arises on the way)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _restack([t[k] for t in trees], device) for k in first}
    out = torch.empty((len(trees),) + tuple(first.shape), dtype=first.dtype,
                      device=device or first.device)
    for j, t in enumerate(trees):
        out[j].copy_(t.detach())
    return out


def _copy(tree, device):
    if isinstance(tree, dict):
        return {k: _copy(v, device) for k, v in tree.items()}
    return torch.empty_like(tree, device=device or tree.device).copy_(
        tree.detach())


def params_to_tree(params, cfg, device=None):
    """The port's params (or anything shaped like them, AdamW's ``m`` and
    ``v``) in the reference's pytree, as new tensors on ``device`` (the
    params' own if None; ``"meta"`` gives the structure with no data).
    ``params_from_numpy(params_to_tree(p, cfg), cfg)`` is ``p``, byte for
    byte."""
    if cfg.family == "audio":
        stacks = {name: _restack([nest(p) for p in params[name]], device)
                  for name in ("enc_layers", "dec_layers")}
    else:
        period = len(transformer.slot_kinds(cfg))
        layers = params["layers"]
        stacks = {"blocks": {
            f"slot{s}": _restack([nest(p) for p in layers[s::period]], device)
            for s in range(period)}}
    top = nest({k: v for k, v in params.items()
                 if k not in ("layers", "enc_layers", "dec_layers")})
    return {**_copy(top, device), **stacks}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes          # numpy's bfloat16 (a dependency of jax)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_to_numpy(params, cfg):
    """:func:`params_to_tree` as numpy arrays (bf16 as ``ml_dtypes``'s
    bfloat16, which only this conversion needs): what
    ``jax.tree.map(np.asarray, params)`` gives of the reference's
    params."""
    return _map(_numpy, params_to_tree(params, cfg, "cpu"))


def opt_state_to_tree(state, cfg, device=None):
    """AdamW's state (``training/optimizer.py``: ``m``, ``v`` shaped like
    the params, ``step``) in the reference's pytree, as new tensors on
    ``device`` (``step`` on the host)."""
    return {"m": params_to_tree(state["m"], cfg, device),
            "v": params_to_tree(state["v"], cfg, device),
            "step": state["step"].detach().to("cpu", copy=True)}


def opt_state_to_numpy(state, cfg):
    return _map(_numpy, opt_state_to_tree(state, cfg, "cpu"))


def opt_state_from_numpy(tree, cfg, device="cuda", mesh=None):
    """The inverse of :func:`opt_state_to_tree`: ``m``, ``v`` as the
    port's params on ``device`` (this rank's shard of each under a
    ``mesh``, cut as the params are), ``step`` an int32 scalar on the
    host."""
    return {"m": params_from_numpy(tree["m"], cfg, device, mesh=mesh),
            "v": params_from_numpy(tree["v"], cfg, device, mesh=mesh),
            "step": _tensor(tree["step"], "cpu")}
