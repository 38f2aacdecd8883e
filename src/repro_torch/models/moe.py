"""Mixture-of-Experts with capacity-based token dispatch
(``repro.models.moe``: ``route``, ``_expert_ffn`` and ``moe_apply``).

Routing follows GShard/Switch as the reference's does: the router runs
in f32, the top-k gates are renormalised (unless ``cfg.moe_renormalize``
is off, as in the published Jamba block, which weighs each route by its
softmax probability over all the experts), each route's position in its
expert is counted choice-major (every first choice gets a slot before
any second choice), capacity is
``max(min(T, 32), ceil(T * k * cf / E))`` over all ``T = B * S`` tokens
of the call, padding included, and a route past capacity is dropped (its
token's residual passes through). So a prompt's output depends on its
batch-mates and its padding once an expert overflows, in the reference
as here. A capacity factor of ``E / k`` (jamba's) makes capacity the
call's token count, so no route is dropped.

The expert products are library products (batched matmuls), as the
reference leaves its ``jnp.einsum`` to XLA; there is no Pallas kernel on
this path. Every expert's weights are read on every call, decode steps
included: the capacity buffer holds ``capacity`` rows of each expert
whether or not a route landed there (the reference computes the same).

Nothing here reads a device value on the host and no shape depends on
the data, so a decode chunk that runs it captures as one CUDA graph. The
dispatch writes each kept route into its own row of the capacity buffer
(dropped routes go to one extra row that is thrown away), and each
token's k expert outputs are gathered and added in choice order, the
order the reference's scatter-add takes on the CPU: no atomics, so a
replay gives the eager chunk's bytes.

``count_drops()`` collects each call's dropped routes as device scalars,
for callers that report them (it is off unless asked for).

:func:`moe_apply_shard_map` is the reference's expert-parallel path over
a mesh (``launch/mesh.py``), index for index, with ``torch.distributed``
collectives in place of ``shard_map``'s (``distributed/comm.py``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional

import torch

from repro_torch.distributed import comm
from repro_torch.launch.mesh import axis_group, shape_of
from repro_torch.models import layers

_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops():
    """Within the block, every :func:`moe_apply` call appends the number of
    its dropped routes (a device int64 scalar) to the list it yields."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def capacity_of(cfg, T: int, capacity_factor=None) -> int:
    """Rows a call of ``T`` tokens gives each expert. The floor of
    ``min(T, 32)`` keeps a decode-sized call from dropping on collisions
    (a 2-token step would otherwise get capacity 1)."""
    cf = capacity_factor or cfg.moe_capacity_factor
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    return max(min(T, 32), int(math.ceil(T * k * cf / E)))


def route(cfg, router_w, x2d, capacity: int):
    """x2d: (T, d) tokens. Returns (expert_idx, slot_pos, keep, gates)
    (each (T, k)) and the Switch aux loss.

    The top k are taken one ``argmax`` at a time, which returns the first
    of equal maxima: equal probabilities keep the lower expert first, as
    ``lax.top_k`` does."""
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    logits = x2d.float() @ router_w.float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    left, picks = probs, []
    for _ in range(k):                       # k is small and static
        picks.append(torch.argmax(left, dim=-1, keepdim=True))
        left = left.scatter(1, picks[-1], -1.0)
    idx = torch.cat(picks, dim=1)                         # (T, k)
    gates = torch.gather(probs, 1, idx)
    if cfg.moe_renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    experts = torch.arange(E, device=x2d.device)
    onehot = [(idx[:, c:c + 1] == experts).long() for c in range(k)]
    pos_list, base = [], torch.zeros((E,), dtype=torch.long,
                                     device=x2d.device)
    for c, oh in enumerate(onehot):           # (T, E) each
        pos_c = (torch.cumsum(oh, dim=0) - 1) + base[None, :]
        pos_list.append(torch.gather(pos_c, 1, idx[:, c:c + 1])[:, 0])
        base = base + oh.sum(0)
    pos = torch.stack(pos_list, dim=1)                    # (T, k)
    keep = pos < capacity
    me = probs.mean(0)                                    # mean gate prob
    ce = torch.zeros((E,), dtype=torch.float32, device=x2d.device)
    for oh in onehot:
        ce = ce + oh.float().mean(0)
    aux_loss = E * torch.sum(me * ce / k)
    return idx, pos, keep, gates, aux_loss


def _expert_ffn(cfg, wi, wo, buf):
    """buf: (E, C, d) -> (E, C, d) through each expert's gated FFN: the
    MLP with its products batched over the experts (``(E, C, d) @ (E, d,
    2 f)`` is one ``bmm``)."""
    return layers.mlp_apply(cfg, {"wi": wi, "wo": wo}, buf)


def moe_apply(cfg, p, x, *, capacity_factor=None):
    """x: (B, S, d). Returns (y, aux_loss). ``p``: ``router (d, E)`` f32,
    ``wi (E, d, 2 f)``, ``wo (E, f, d)`` and, with a shared expert,
    ``shared`` (an MLP's ``wi``/``wo``)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    capacity = capacity_of(cfg, T, capacity_factor)
    x2d = x.reshape(T, d)
    idx, pos, keep, gates, aux = route(cfg, p["router"], x2d, capacity)
    if _DROPS is not None:
        _DROPS.append((~keep).sum())

    # each kept route to its own row; dropped ones to the extra last row
    n_rows = E * capacity
    rows = torch.where(keep, idx * capacity + pos, n_rows).reshape(-1)
    buf = _dispatch(x2d, rows, n_rows, k)
    y_buf = _expert_ffn(cfg, p["wi"], p["wo"], buf.view(E, capacity, d))
    # a dropped route reads some row and weighs it 0, as the reference's
    w = (keep.to(x.dtype) * gates.to(x.dtype)).reshape(-1, 1)
    y = _combine(y_buf.reshape(n_rows, d), rows, w, T, k)
    if cfg.moe_shared_expert:
        y = y + layers.mlp_apply(cfg, p["shared"], x2d)
    return y.reshape(B, S, d), aux


@functools.lru_cache(maxsize=None)
def _with_experts(cfg, E: int):
    return cfg.replace(moe_num_experts=E)


def _dispatch(x2d, rows, n_rows, k):
    """The capacity buffer (``n_rows`` rows, each kept route's token in
    its own row; ``rows == n_rows`` is a dropped route's throwaway
    row)."""
    T, d = x2d.shape
    tok = torch.arange(T, device=x2d.device)[:, None].expand(T, k).reshape(-1)
    buf = x2d.new_zeros((n_rows + 1, d))
    buf[rows] = x2d[tok]
    return buf[:n_rows]


def _combine(y_rows, rows, w, T, k):
    """Each token's k expert outputs (rows of ``y_rows``, weighed by
    ``w``; a dropped route reads some row and weighs it 0) added in
    choice order, no atomics."""
    n_rows, d = y_rows.shape
    y_tok = (y_rows[torch.clamp(rows, max=n_rows - 1)] * w).view(T, k, d)
    y = torch.zeros((T, d), dtype=y_rows.dtype, device=y_rows.device)
    for c in range(k):
        y = y + y_tok[:, c]
    return y


def moe_apply_shard_map(cfg, p, x, *, mesh, expert_axis="model",
                        data_axis="data", capacity_factor=None,
                        local_batch=False):
    """Expert parallelism with explicit all-to-all (the reference's
    ``moe_apply_shard_map``). ``x (B, S, d)`` is the global batch, whole
    on every rank (the residual stream of a tensor-parallel model); the
    result is global too. ``p``: the router (``(d, E)``, whole) and this
    rank's ``E / ep`` experts of ``wi``/``wo`` (expert ``e`` lives on
    rank ``e // (E / ep)`` of ``expert_axis``); ``cfg`` may be the global
    config or a rank's (the experts are counted from the router).

    Each rank takes its tokens: its batch rows over the data axes (where
    they divide B; a mesh may have none) and, where ``S`` divides over
    ``ep`` ranks, its ``S / ep`` positions. Capacity comes from that
    local token count, so the drops are the reference's shard_map drops,
    not ``moe_apply``'s.

    * Sequence-sharded: each rank routes its tokens into an ``(E, C,
      d)`` buffer; an all-to-all sends each expert's rows to its owner
      (``(E/ep, ep*C, d)``, peer-major along capacity), the owner runs
      the FFN, and the reverse exchange returns them; the positions are
      gathered back over ``expert_axis``.
    * Replicated (decode, ``S < ep``): every rank routes all its tokens,
      serves only its own experts, and the outputs are summed over
      ``expert_axis``.

    The aux loss is averaged over every mesh axis. A shared expert runs
    outside the exchange, tensor-parallel over ``expert_axis``, as the
    reference applies it outside its shard_map. Under
    :func:`count_drops` each call appends this rank's dropped routes
    (its tokens', or on the replicated path the drops at its experts):
    their sum over the ranks is the call's.

    ``local_batch`` (the sharded training step): ``x`` holds this data
    rank's rows already, the rows the reference's shard_map gives it of
    the global batch, so nothing is cut or gathered over the data axes
    (capacity still counts the rank's tokens). Under autograd the
    exchanges differentiate (``distributed/comm.py``): ``x`` enters
    through ``comm.copy_to_model`` (a rank routes only its positions), the
    all-to-alls return each gradient to its token's rank, the positions'
    gather gives each rank its slice back; the aux loss's mean over the
    expert axis passes its gradient through (every rank of a data row
    computes the same loss) and its mean over the data axes sums it
    (each data rank's loss holds its part, ``transformer.loss_fn``). The
    router's gradient on a rank covers its tokens only and is summed
    over the expert axis after backward (``sharding.sync_grads``). The
    replicated path (``S < ep``) routes every token on every rank and
    is refused under autograd."""
    sizes = shape_of(mesh)
    ep = sizes[expert_axis]
    E = p["router"].shape[1]
    if cfg.moe_num_experts != E:
        cfg = _with_experts(cfg, E)
    k = cfg.moe_top_k
    if E % ep:
        raise ValueError(f"{E} experts over {ep} ranks")
    E_loc = E // ep
    B, S, d = x.shape
    seq_shard = S % ep == 0 and S >= ep

    data_axes = tuple(a for a in (("pod", data_axis) if "pod" in sizes
                                  else (data_axis,)) if a in sizes)
    n_data = math.prod(sizes[a] for a in data_axes)
    batch_shard = B % n_data == 0 and not local_batch
    b_loc = B // n_data if batch_shard else B
    T_loc = b_loc * (S // ep) if seq_shard else b_loc * S
    capacity = capacity_of(cfg, T_loc, capacity_factor)

    grp = axis_group(mesh, expert_axis)
    if comm.needs_grad(x) and not seq_shard:
        raise NotImplementedError(
            f"the expert exchange under autograd needs the sequence ({S}) "
            f"to divide over the {ep} ranks of {expert_axis!r}")
    xl = comm.copy_to_model(grp, x)
    if batch_shard and n_data > 1:
        di = 0
        for a in data_axes:
            di = di * sizes[a] + mesh.get_local_rank(a)
        xl = xl[di * b_loc:(di + 1) * b_loc]
    if seq_shard and ep > 1:
        s_loc = S // ep
        xl = xl[:, grp.rank * s_loc:(grp.rank + 1) * s_loc]
    t = xl.shape[0] * xl.shape[1]
    x2d = xl.reshape(t, d)
    idx, pos, keep, gates, aux = route(cfg, p["router"], x2d, capacity)

    if seq_shard:
        n_rows = E * capacity
        rows = torch.where(keep, idx * capacity + pos, n_rows).reshape(-1)
        buf = _dispatch(x2d, rows, n_rows, k).view(ep, E_loc, capacity, d)
        # (E, C, d) -> (E/ep, ep*C, d): expert owners gather their slots
        # (peer-major along the capacity axis)
        got = comm.all_to_all(grp, buf).transpose(0, 1).reshape(
            E_loc, ep * capacity, d)
        y_buf = _expert_ffn(cfg, p["wi"], p["wo"], got)
        # (E/ep, ep*C, d) -> (E, C, d): results return to token owners
        back = y_buf.view(E_loc, ep, capacity, d).transpose(0, 1)
        y_rows = comm.all_to_all(grp, back.contiguous()).reshape(n_rows, d)
        mine = keep
    else:
        # replicated tokens: each rank serves only its local experts,
        # combined with a sum over the expert axis
        lo = grp.rank * E_loc
        mine = keep & (idx >= lo) & (idx < lo + E_loc)
        n_rows = E_loc * capacity
        rows = torch.where(mine, (idx - lo) * capacity + pos,
                           n_rows).reshape(-1)
        buf = _dispatch(x2d, rows, n_rows, k).view(E_loc, capacity, d)
        y_rows = _expert_ffn(cfg, p["wi"], p["wo"], buf).reshape(n_rows, d)
    if _DROPS is not None:
        _DROPS.append((~keep).sum() if seq_shard else
                      (~keep & (idx // E_loc == grp.rank)).sum())
    w = (mine.to(x.dtype) * gates.to(x.dtype)).reshape(-1, 1)
    y = _combine(y_rows, rows, w, t, k)
    # one rank routes every token of the call: the shared expert reads
    # the router's rows, as moe_apply's does (the same autograd graph)
    alone = cfg.moe_shared_expert and grp.size == 1 and xl is x
    if alone:
        y = y + layers.mlp_apply(cfg, p["shared"], x2d, grp)
    if not seq_shard:
        grp.all_reduce(y)
    for a in sizes:                            # pmean over every axis
        aux = comm.reduce_from_model(axis_group(mesh, a), aux) \
            if a == expert_axis else comm.sum_over(axis_group(mesh, a), aux)
    aux = aux / math.prod(sizes.values())

    y = y.reshape(xl.shape)
    if seq_shard:
        y = comm.gather_from_model(grp, y, 1)
    if batch_shard and n_data > 1:
        for a in reversed(data_axes):
            y = axis_group(mesh, a).all_gather(y, 0)
    if cfg.moe_shared_expert and not alone:
        y = y + layers.mlp_apply(cfg, p["shared"], x, grp)
    return y, aux
