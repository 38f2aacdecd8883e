"""Algorithm 2: deduction of the optimal parallel configuration per group.

Heuristics (paper §3.3):
  1. TP never spans nodes (cloud inter-node links are too slow) and never
     mixes device types.
  2. Non-uniform pipeline layer partition proportional to stage capability
     (memory+compute), respecting per-device memory limits.
  3. Bitmask DP over pipeline stage ordering maximizing the minimum
     inter-stage bandwidth (Appendix B).

Prefill groups pick the latency-optimal plan; decode groups the
throughput-optimal plan.

The port's copy of ``repro.core.parallel`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.cluster import ClusterSpec


def _group_by_node_type(cluster: ClusterSpec, devices: Sequence[int]):
    """Partition a group's devices into (node, type) buckets."""
    buckets: Dict[Tuple[int, str], List[int]] = {}
    for i in devices:
        d = cluster.devices[i]
        buckets.setdefault((d.node, d.type_name), []).append(i)
    return buckets


def _route_stages_dp(cluster: ClusterSpec, stages: List[List[int]]
                     ) -> List[List[int]]:
    """Order pipeline stages to maximize the min inter-stage bandwidth.

    Bitmask DP over stage subsets: state (mask, last) -> best bottleneck bw.
    """
    k = len(stages)
    if k <= 2:
        return stages
    bw = [[cluster.min_bw_between(stages[i], stages[j]) if i != j else 0.0
           for j in range(k)] for i in range(k)]
    if k > 10:
        # bitmask DP is O(2^k k^2): beyond ~10 stages fall back to a greedy
        # max-bottleneck chain (start at the best edge, extend greedily)
        order = [0]
        left = set(range(1, k))
        while left:
            last = order[-1]
            nxt = max(left, key=lambda j: bw[last][j])
            order.append(nxt)
            left.remove(nxt)
        return [stages[i] for i in order]
    best: Dict[Tuple[int, int], Tuple[float, Tuple[int, ...]]] = {}
    for i in range(k):
        best[(1 << i, i)] = (math.inf, (i,))
    for mask in range(1, 1 << k):
        for last in range(k):
            if (mask, last) not in best:
                continue
            cur, path = best[(mask, last)]
            for nxt in range(k):
                if mask & (1 << nxt):
                    continue
                nb = min(cur, bw[last][nxt])
                key = (mask | (1 << nxt), nxt)
                if key not in best or best[key][0] < nb:
                    best[key] = (nb, path + (nxt,))
    full = (1 << k) - 1
    cand = [(v[0], v[1]) for (m, _), v in best.items() if m == full]
    _, order = max(cand)
    return [stages[i] for i in order]


def _partition_layers(cluster: ClusterSpec, cfg: ModelConfig,
                      stages: List[List[int]]) -> Optional[List[int]]:
    """Layers per stage proportional to capability, memory-feasible."""
    L = cfg.num_layers
    caps, mems = [], []
    for stage in stages:
        devs = [cluster.devices[i] for i in stage]
        caps.append(sum(d.chip.peak_flops for d in devs)
                    + 2e-9 * sum(d.chip.hbm_bw for d in devs))
        mems.append(sum(d.chip.hbm_bytes for d in devs) * 0.9)
    total_cap = sum(caps)
    part = [max(1, round(L * c / total_cap)) for c in caps]
    # fix rounding to sum exactly L
    while sum(part) > L:
        part[part.index(max(part))] -= 1
    while sum(part) < L:
        part[part.index(min(part))] += 1
    if any(p <= 0 for p in part):
        return None
    # memory feasibility: shift layers away from over-committed stages
    per_layer = cfg.param_count() * cm.BYTES / L
    embed = cfg.vocab_size * cfg.d_model * cm.BYTES
    for _ in range(4 * len(stages)):
        over = [i for i in range(len(stages))
                if part[i] * per_layer + embed > mems[i]]
        if not over:
            break
        i = over[0]
        if part[i] <= 1:
            return None  # stage can't hold even one layer
        part[i] -= 1
        j = min((x for x in range(len(stages)) if x not in over),
                key=lambda x: part[x] * per_layer / mems[x], default=None)
        if j is None:
            return None
        part[j] += 1
    if any(part[i] * per_layer + embed > mems[i] for i in range(len(stages))):
        return None
    return part


def enumerate_configs(cluster: ClusterSpec, cfg: ModelConfig,
                      devices: Sequence[int]) -> List[cm.ParallelConfig]:
    """All feasible (TP, PP) plans for a device group (Alg. 2 steps 1-3)."""
    buckets = _group_by_node_type(cluster, devices)
    if not devices:
        return []
    out: List[cm.ParallelConfig] = []
    sizes = [len(v) for v in buckets.values()]
    max_tp = min(sizes)  # heuristic 1: TP within single-type, single-node
    n = len(devices)
    for tp in [t for t in (1, 2, 4, 8) if t <= max_tp]:
        # carve each bucket into tp-sized cells; cells become PP stages
        stages: List[List[int]] = []
        ok = True
        for bucket in buckets.values():
            if len(bucket) % tp != 0:
                ok = False
                break
            for c in range(len(bucket) // tp):
                stages.append(bucket[c * tp:(c + 1) * tp])
        if not ok or not stages:
            continue
        pp = len(stages)
        if pp > cfg.num_layers:
            continue
        stages = _route_stages_dp(cluster, stages)
        part = _partition_layers(cluster, cfg, stages)
        if part is None:
            continue
        out.append(cm.ParallelConfig(tp=tp, pp=pp, stages=stages,
                                     layer_partition=part))
    return out


def deduce(cluster: ClusterSpec, cfg: ModelConfig, devices: Sequence[int],
           phase: str, *, mean_ctx: int = 1024
           ) -> Optional[Tuple[cm.ParallelConfig, cm.ReplicaCost]]:
    """Pick latency-optimal (prefill) or throughput-optimal (decode) plan."""
    best, best_score = None, -math.inf
    for pc in enumerate_configs(cluster, cfg, devices):
        rc = cm.replica_cost(cluster, cfg, pc, mean_ctx=mean_ctx)
        if phase == "prefill":
            score = -rc.prefill_latency_1k
        else:
            score = rc.decode_tokens_per_s
        if score > best_score:
            best, best_score = (pc, rc), score
    return best
