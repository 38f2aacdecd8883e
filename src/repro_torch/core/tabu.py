"""Algorithm 1: tabu search over (group construction, phase designation).

Initialization: hierarchical clustering on the inter-device bandwidth matrix
(groups avoid ultra-low-bandwidth cuts). Neighbor moves (paper Fig. 4):
flip / split / merge / move. Early feasibility check: a group must hold at
least one copy of the model parameters.

The port's copy of ``repro.core.tabu`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.cluster import ClusterSpec


@dataclass(frozen=True)
class Solution:
    """Upper-level solution: device groups + phase designation."""
    groups: Tuple[Tuple[int, ...], ...]
    phases: Tuple[str, ...]            # "prefill" | "decode" per group

    def key(self) -> Tuple:
        return (tuple(sorted((tuple(sorted(g)), p)
                             for g, p in zip(self.groups, self.phases))))


def group_memory_ok(cluster: ClusterSpec, cfg: ModelConfig,
                    group: Tuple[int, ...]) -> bool:
    mem = sum(cluster.devices[i].chip.hbm_bytes for i in group) * 0.92
    return mem >= cfg.param_count() * cm.BYTES * 1.05


def feasible(cluster: ClusterSpec, cfg: ModelConfig, sol: Solution) -> bool:
    if not sol.groups:
        return False
    phases = set(sol.phases)
    if "prefill" not in phases or "decode" not in phases:
        return False
    return all(group_memory_ok(cluster, cfg, g) for g in sol.groups)


def initial_solution(cluster: ClusterSpec, cfg: ModelConfig,
                     rng: random.Random) -> Solution:
    """Hierarchical clustering on the bandwidth matrix (paper §3.2 init)."""
    n = cluster.n
    with np.errstate(divide="ignore"):
        dist = 1.0 / np.maximum(cluster.bw, 1.0)
    np.fill_diagonal(dist, 0.0)
    cond = squareform(dist, checks=False)
    Z = linkage(cond, method="average")
    # pick the largest cluster count whose every group still fits the model
    for k in range(n, 0, -1):
        labels = fcluster(Z, k, criterion="maxclust")
        groups = [tuple(int(i) for i in np.where(labels == c)[0])
                  for c in sorted(set(labels))]
        if all(group_memory_ok(cluster, cfg, g) for g in groups) \
                and len(groups) >= 2:
            phases = ["prefill" if rng.random() < 0.5 else "decode"
                      for _ in groups]
            phases[0] = "prefill"
            phases[-1] = "decode"
            return Solution(tuple(groups), tuple(phases))
    return Solution((tuple(range(n)),), ("prefill",))


# ---------------------------------------------------------------------------
# Neighbor moves
# ---------------------------------------------------------------------------


def _flip(sol: Solution, rng) -> Optional[Solution]:
    if not sol.groups:
        return None
    i = rng.randrange(len(sol.groups))
    phases = list(sol.phases)
    phases[i] = "decode" if phases[i] == "prefill" else "prefill"
    return Solution(sol.groups, tuple(phases))


def _split(sol: Solution, rng) -> Optional[Solution]:
    cand = [i for i, g in enumerate(sol.groups) if len(g) >= 2]
    if not cand:
        return None
    i = rng.choice(cand)
    g = list(sol.groups[i])
    rng.shuffle(g)
    r = rng.uniform(0.25, 0.75)
    cut = max(1, min(len(g) - 1, int(len(g) * r)))
    g1, g2 = tuple(sorted(g[:cut])), tuple(sorted(g[cut:]))
    groups = list(sol.groups)
    phases = list(sol.phases)
    groups[i] = g1
    groups.append(g2)
    phases.append(rng.choice(("prefill", "decode")))
    phases[i] = rng.choice(("prefill", "decode"))
    return Solution(tuple(groups), tuple(phases))


def _merge(sol: Solution, rng) -> Optional[Solution]:
    if len(sol.groups) < 2:
        return None
    i, j = rng.sample(range(len(sol.groups)), 2)
    groups = list(sol.groups)
    phases = list(sol.phases)
    merged = tuple(sorted(groups[i] + groups[j]))
    for idx in sorted((i, j), reverse=True):
        del groups[idx]
        del phases[idx]
    groups.append(merged)
    phases.append(rng.choice(("prefill", "decode")))
    return Solution(tuple(groups), tuple(phases))


def _move(sol: Solution, rng) -> Optional[Solution]:
    cand = [i for i, g in enumerate(sol.groups) if len(g) >= 2]
    if not cand or len(sol.groups) < 2:
        return None
    i = rng.choice(cand)
    j = rng.choice([x for x in range(len(sol.groups)) if x != i])
    g_i = list(sol.groups[i])
    m = rng.randrange(1, len(g_i))
    rng.shuffle(g_i)
    moved, rest = g_i[:m], g_i[m:]
    groups = list(sol.groups)
    groups[i] = tuple(sorted(rest))
    groups[j] = tuple(sorted(list(groups[j]) + moved))
    return Solution(tuple(groups), sol.phases)


MOVES = (_flip, _split, _merge, _move)


def neighbors(cluster: ClusterSpec, cfg: ModelConfig, sol: Solution,
              n_nghb: int, rng, moves=MOVES) -> List[Solution]:
    out, seen = [], set()
    tries = 0
    while len(out) < n_nghb and tries < n_nghb * 12:
        tries += 1
        mv = rng.choice(moves)
        cand = mv(sol, rng)
        if cand is None or not feasible(cluster, cfg, cand):
            continue
        k = cand.key()
        if k in seen:
            continue
        seen.add(k)
        out.append(cand)
    return out


@dataclass
class TabuResult:
    best: Solution
    best_score: float
    history: List[float] = field(default_factory=list)
    evals: int = 0


def tabu_search(cluster: ClusterSpec, cfg: ModelConfig,
                f: Callable[[Solution], float], *, n_step: int = 100,
                n_nghb: int = 10, n_mem: int = 5, seed: int = 0,
                moves=MOVES, init: Optional[Solution] = None,
                patience: int = 25) -> TabuResult:
    """Paper Algorithm 1 (plus early stopping on `patience` flat steps)."""
    rng = random.Random(seed)
    x = init or initial_solution(cluster, cfg, rng)
    tabu: List[Tuple] = []
    best, best_score = x, f(x)
    res = TabuResult(best, best_score, [best_score], 1)
    flat = 0
    for _ in range(n_step):
        nbrs = [c for c in neighbors(cluster, cfg, x, n_nghb, rng, moves)
                if c.key() not in tabu]
        if not nbrs:
            break
        scored = [(f(c), c) for c in nbrs]
        res.evals += len(scored)
        score, x = max(scored, key=lambda t: t[0])
        if score > best_score:
            best, best_score = x, score
            flat = 0
        else:
            flat += 1
        tabu.append(x.key())
        if len(tabu) > n_mem:
            tabu = tabu[-n_mem:]
        res.history.append(best_score)
        if flat >= patience:
            break
    res.best, res.best_score = best, best_score
    return res
