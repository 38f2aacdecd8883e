"""AdamW and the int8 error-feedback gradient compressor (the port of
``repro.training.optimizer``), in f32 as the reference computes them.

A tree is a nest of dicts and lists of tensors: the port's parameters
(``models/transformer.py``), their gradients, AdamW's ``m`` and ``v``.
The reference's update is one ``jax.tree.map`` that builds new trees;
:func:`adamw_update` walks the tensors one at a time and writes params,
``m`` and ``v`` IN PLACE, so no f32 copy of the whole model ever exists:
the f32 temporaries are those of one tensor. ``step`` is an int32 scalar
on the host, and the learning rate and bias corrections are host
arithmetic in f32 (numpy), so a step never waits on the card until its
caller reads a number.

:func:`make_train_step` is ``jax.value_and_grad`` then the update: the
loss under autograd, ``torch.autograd.grad`` for the gradients (in the
params' type, as ``jax.grad`` gives them; a param the loss does not
reach gets zeros, as there).

Under a mesh (the model API's ``mesh``: ``registry.build(cfg,
rt=Runtime(mesh))``) the step is the reference's pjit step in explicit
SPMD: each rank's loss over its data rank's rows, backward on its shard,
the partial gradients completed over the ``model`` axis
(``sharding.sync_grads``), every gradient summed over the data axes
(the reference's pjit reduces them there; :func:`loss_and_grads`), the
global norm over the shards (:func:`global_norm`), and AdamW on each
rank's shards in place. Whole weights get the same gradient bytes on
every rank, so their updates stay bit-identical across the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F32 = np.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_leaves(tree):
    """The leaves (tensors) of a tree in a fixed order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _stacked(tree, inside=False):
    """For each tensor of :func:`tree_leaves`, whether it lies in a list:
    a layer of the port's per-layer lists, which the reference stacks
    along a leading layer axis."""
    if isinstance(tree, torch.Tensor):
        return [inside]
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in _stacked(tree[k], inside)]
    return [f for v in tree for f in _stacked(v, True)]


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return [build(v) for v in t]

    return build(like)


def lr_schedule(cfg: AdamWConfig, step) -> np.float32:
    """Linear warmup + cosine decay, in f32 as the reference's jnp
    arithmetic (Python constants rounded to f32 where they meet an f32
    value)."""
    step = F32(step)
    warm = step / F32(max(cfg.warmup_steps, 1))
    prog = np.clip((step - F32(cfg.warmup_steps))
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   F32(0.0), F32(1.0))
    cos = F32(cfg.min_lr_ratio) + F32((1 - cfg.min_lr_ratio) * 0.5) * (
        F32(1) + np.cos(F32(np.pi) * prog))
    return F32(cfg.lr) * (warm if step < cfg.warmup_steps else cos)


def adamw_init(params):
    """``m`` and ``v``: f32 zeros shaped like the params, on their
    devices; ``step``: int32 0 on the host."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree, *, share=None, model=None):
    """sqrt of the sum over the leaves of their f32 squares' sums (a 0-d
    f32 tensor on the leaves' device). Sharded (``share``, a tree like
    ``tree`` from ``sharding.norm_share``; ``model``, the model axis's
    group): a shard's square sum is summed over the axis, a replicated KV
    head's counted on its first rank only and summed, a leaf every rank
    holds alike counted as it is; one all-reduce carries the sums. The
    leaves are then added in the unsharded sum's order, so at axis size
    1 the norm is its bits."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if share is not None:
        how = tree_leaves(share)
        pick = [i for i, h in enumerate(how) if h != "once"]
        if pick:
            vals = model.all_reduce(torch.stack(
                [sq[i] * 0.0 if how[i] == "zero" else sq[i] for i in pick]))
            for j, i in enumerate(pick):
                sq[i] = vals[j]
    return torch.sqrt(sum(sq))


def _update_one(cfg, g, m, v, p, decay, scale, lr, bc1, bc2):
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
    del g
    delta = m / bc1
    delta /= torch.sqrt(v / bc2).add_(cfg.eps)
    if decay:                     # (p.float() is p itself for f32 p)
        delta += p.float() * cfg.weight_decay
    p.copy_(p.float() - delta.mul_(lr))


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, *,
                 norm_share=None, model=None):
    """One AdamW step: the gradients clipped to ``cfg.grad_clip`` by their
    global norm, bias-corrected moments, decoupled weight decay on tensors
    of two or more dims, the update computed in f32 and cast back to each
    param's type (no master weights). The dims are counted in the
    reference's pytree, which stacks the layers: a tensor of a layer (in
    one of the port's per-layer lists) counts the layer axis too, so its
    norm scales and biases decay, as in the reference, while the final
    norm does not. Params, ``m`` and ``v`` are updated in place, one
    tensor at a time (a rank's shards under a mesh: ``norm_share`` and
    ``model`` as :func:`global_norm` takes them). Returns ``(params,
    opt_state, {"grad_norm", "lr"})``: the same param tensors, the state
    with ``step + 1``."""
    step = int(opt_state["step"]) + 1
    gnorm = global_norm(grads, share=norm_share, model=model)
    scale = torch.clamp(gnorm.new_tensor(cfg.grad_clip) / (gnorm + 1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    bc1 = float(F32(1) - F32(cfg.b1) ** F32(step))
    bc2 = float(F32(1) - F32(cfg.b2) ** F32(step))
    with torch.no_grad():
        for g, m, v, p, stacked in zip(tree_leaves(grads),
                                       tree_leaves(opt_state["m"]),
                                       tree_leaves(opt_state["v"]),
                                       tree_leaves(params),
                                       _stacked(params)):
            _update_one(cfg, g, m, v, p, p.ndim + stacked >= 2, scale,
                        float(lr), bc1, bc2)
    state = {"m": opt_state["m"], "v": opt_state["v"],
             "step": torch.tensor(step, dtype=torch.int32)}
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (for low-bandwidth DP links)
# ---------------------------------------------------------------------------


def ef_int8_compress(g, error):
    """Quantize g + error to int8 with one per-tensor scale; returns (q,
    scale, new_error)."""
    gf = g.float() + error
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def ef_int8_decompress(q, scale):
    return q.float() * scale


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: every param made a
    leaf that requires grad, the loss run under autograd, the gradients
    from ``torch.autograd.grad`` (nothing accumulates in ``.grad``) as a
    tree like the params."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def loss_and_grads(api, params, batch):
    """``(loss, grads)`` of the model API's loss (:func:`value_and_grad`);
    under a mesh (``api.mesh``: ``batch`` this data rank's rows, the
    params this rank's shards) the gradients completed as the sharded
    step needs them: ``sharding.sync_grads`` over the ``model`` axis, then
    each summed over the data axes, and ``loss`` the global batch's (the
    data ranks' losses summed; their denominators are the global mask
    count already, ``transformer.loss_fn``)."""
    loss, grads = value_and_grad(api.loss, params, batch)
    mesh = getattr(api, "mesh", None)
    if mesh is None:
        return loss, grads
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import axis_group, data_axes
    sharding.sync_grads(grads, api.cfg, mesh)
    for a in data_axes(mesh):
        grp = axis_group(mesh, a)
        for g in tree_leaves(grads):
            grp.all_reduce(g)
        loss = grp.all_reduce(loss)
    return loss, grads


def make_train_step(api, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    stats)``, stats ``loss``, ``grad_norm`` (0-d tensors on the params'
    device) and ``lr`` (f32). The params and state are updated in place
    and returned.

    Under a mesh (``api.mesh``) this is the reference's pjit step in
    explicit SPMD: :func:`loss_and_grads` on this rank's rows and
    shards, then AdamW on the rank's shards with the global norm over
    the shards (``sharding.norm_share``). The collectives are issued at
    every axis size, 1 included, where the step is the unmeshed one bit
    for bit."""
    mesh = getattr(api, "mesh", None)
    kw = {}
    if mesh is not None:
        from repro_torch.distributed import sharding
        from repro_torch.launch.mesh import axis_group
        kw = dict(norm_share=sharding.norm_share(api.cfg, mesh),
                  model=axis_group(mesh, "model"))

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(api, params, batch)
        params, opt_state, stats = adamw_update(opt_cfg, grads, opt_state,
                                                params, **kw)
        stats["loss"] = loss
        return params, opt_state, stats

    return train_step
