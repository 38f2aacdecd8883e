"""Mixture-of-Experts with capacity-based token dispatch
(``repro.models.moe``: ``route``, ``_expert_ffn`` and ``moe_apply``).

Routing follows GShard/Switch as the reference's does: the router runs
in f32, the top-k gates are renormalised, each route's position in its
expert is counted choice-major (every first choice gets a slot before
any second choice), capacity is
``max(min(T, 32), ceil(T * k * cf / E))`` over all ``T = B * S`` tokens
of the call, padding included, and a route past capacity is dropped (its
token's residual passes through). So a prompt's output depends on its
batch-mates and its padding once an expert overflows, in the reference
as here.

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
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch

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
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    buf = x.new_zeros((n_rows + 1, d))
    buf[rows] = x2d[tok]
    y_buf = _expert_ffn(cfg, p["wi"], p["wo"],
                        buf[:n_rows].view(E, capacity, d))
    # a dropped route reads some row and weighs it 0, as the reference's
    w = (keep.to(x.dtype) * gates.to(x.dtype)).reshape(-1, 1)
    y_tok = (y_buf.reshape(n_rows, d)[torch.clamp(rows, max=n_rows - 1)]
             * w).view(T, k, d)
    y = torch.zeros_like(x2d)
    for c in range(k):                         # choice order, no atomics
        y = y + y_tok[:, c]
    if cfg.moe_shared_expert:
        y = y + layers.mlp_apply(cfg, p["shared"], x2d)
    return y.reshape(B, S, d), aux
