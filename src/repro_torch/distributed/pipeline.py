"""Pipeline parallelism over a mesh axis (the port of
``repro.distributed.pipeline``): the reference's ``shard_map`` loop and
``ppermute`` become one process per stage and point-to-point sends
(``distributed/comm.py``: ``Group.exchange``).

GPipe loop schedule, as the reference's: rank 0 injects one microbatch
per step, activations hop rank -> rank+1, rank S-1 collects outputs;
n_steps = M + S - 1, bubble fraction (S-1)/(M+S-1). Stages run "garbage"
during fill and drain (rank 0 on zeros once its microbatches are in;
never collected), the standard SPMD formulation. The collected outputs
are then replicated with a masked sum, as the reference's ``psum``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import axis_group


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(fn: Callable, stage_params, x, *, mesh,
                   axis: str = "pod", n_microbatch: int = None):
    """Run ``fn(stage_params, microbatch) -> microbatch`` as a pipeline.

    ``stage_params``: this rank's stage (rank i of ``axis`` holds stage
    i, :func:`stage_params_of`). ``x``: the (B, ...) global batch, the
    same on every rank (microbatches enter at rank 0). Returns the (B,
    ...) output, the same on every rank."""
    grp = axis_group(mesh, axis)
    S, rank = grp.size, grp.rank
    B = x.shape[0]
    M = n_microbatch or S
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    buf = torch.zeros_like(mb[0])
    outbuf = torch.zeros_like(mb)
    for i in range(M + S - 1):
        cur = mb[min(i, M - 1)] if rank == 0 and i < M else buf
        out = fn(stage_params, cur)
        idx = i - (S - 1)
        if rank == S - 1 and idx >= 0:
            outbuf[idx] = out
        got = grp.exchange([(out, rank + 1)] if rank < S - 1 else [],
                           [(buf, rank - 1)] if rank > 0 else [])
        # ppermute leaves rank 0 without a source: zeros
        buf = got[0] if got else buf if S == 1 else torch.zeros_like(buf)
    # results live on the last rank; replicate via masked sum
    if rank != S - 1:
        outbuf.zero_()
    grp.all_reduce(outbuf)
    return outbuf.reshape((B,) + tuple(x.shape[1:]))


def pipeline_stage_specs(mesh, params_stacked, axis: str = "pod"):
    """The spec placing stage i of the stacked params on rank i of
    ``axis``: ``P(axis, None, ...)`` for every leaf."""
    return _tree_map(lambda a: P(*((axis,) + (None,) * (a.ndim - 1))),
                     params_stacked)


def stage_params_of(params_stacked, mesh, axis: str = "pod"):
    """This rank's stage of params stacked on a leading stage axis (what
    :func:`pipeline_stage_specs` places on it), as new tensors."""
    r = axis_group(mesh, axis).rank
    return _tree_map(lambda a: a[r].clone(), params_stacked)
