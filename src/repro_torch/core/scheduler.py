"""Two-level scheduling driver (paper §3): tabu (upper) x {Alg. 2 parallel
deduction + TSTP orchestration} (lower) -> DeploymentPlan.

The port's copy of ``repro.core.scheduler`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import orchestrator as orch
from repro_torch.core import parallel as par
from repro_torch.core import tabu
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.workload import Workload


@dataclass
class DeploymentPlan:
    solution: tabu.Solution
    replicas: List[orch.ReplicaPlan]
    orchestration: Optional[orch.Orchestration]
    score: float
    search_seconds: float = 0.0
    search_history: List[float] = field(default_factory=list)
    evals: int = 0

    @property
    def prefill_replicas(self) -> List[orch.ReplicaPlan]:
        return [r for r in self.replicas if r.phase == "prefill"]

    @property
    def decode_replicas(self) -> List[orch.ReplicaPlan]:
        return [r for r in self.replicas if r.phase == "decode"]

    def describe(self) -> str:
        lines = []
        for r in self.replicas:
            lines.append(f"  {r.phase:8s} {r.pc.describe():12s} "
                         f"devices={list(r.devices)}")
        lines.append(f"  score={self.score:.4f} "
                     f"(P:{len(self.prefill_replicas)} "
                     f"D:{len(self.decode_replicas)})")
        return "\n".join(lines)


class LowerLevelSolver:
    """Caches Alg. 2 deductions per (group, phase) — the tabu inner loop
    re-visits the same groups constantly."""

    def __init__(self, cluster: ClusterSpec, cfg: ModelConfig, wl: Workload,
                 rate: float, slo: orch.SloSpec, *, compress: bool = True,
                 chunk_tokens: int = 0):
        self.cluster, self.cfg = cluster, cfg
        self.wl, self.rate, self.slo = wl, rate, slo
        self.compress = compress
        self.chunk_tokens = chunk_tokens
        self._cache: Dict[Tuple, Optional[Tuple]] = {}

    def seed(self, plan: "DeploymentPlan") -> None:
        """Freeze a live plan's parallel configs into the deduction cache.

        Every group keeps its deployed ParallelConfig for BOTH phase
        designations (the paper's no-reload constraint: a flip re-uses the
        resident sharded parameters, so the parallel config cannot change
        with the phase). After seeding, ``deduce`` never re-runs Alg. 2
        for a live group, and ``solve`` scores flip-only neighbors against
        the frozen configs."""
        for r in plan.replicas:
            for ph in ("prefill", "decode"):
                self._cache[(tuple(r.devices), ph)] = (r.pc, r.cost)

    def deduce(self, group: Tuple[int, ...], phase: str):
        key = (group, phase)
        if key not in self._cache:
            self._cache[key] = par.deduce(
                self.cluster, self.cfg, list(group), phase,
                mean_ctx=int(self.wl.mean_in + self.wl.mean_out))
        return self._cache[key]

    def solve(self, sol: tabu.Solution
              ) -> Tuple[float, List[orch.ReplicaPlan],
                         Optional[orch.Orchestration]]:
        replicas: List[orch.ReplicaPlan] = []
        for group, phase in zip(sol.groups, sol.phases):
            got = self.deduce(group, phase)
            if got is None:
                return 0.0, [], None
            pc, rc = got
            replicas.append(orch.ReplicaPlan(list(group), phase, pc, rc))
        pre = [r for r in replicas if r.phase == "prefill"]
        dec = [r for r in replicas if r.phase == "decode"]
        o = orch.orchestrate(self.cluster, self.cfg, pre, dec, self.wl,
                             self.rate, self.slo, compress=self.compress,
                             chunk_tokens=self.chunk_tokens)
        if o is None:
            return 0.0, replicas, None
        return o.attainment, replicas, o

    def score(self, sol: tabu.Solution) -> float:
        return self.solve(sol)[0]


def schedule(cluster: ClusterSpec, cfg: ModelConfig, wl: Workload,
             rate: float, slo: orch.SloSpec, *, n_step: int = 100,
             n_nghb: int = 10, n_mem: int = 5, seed: int = 0,
             compress: bool = True, patience: int = 25,
             chunk_tokens: int = 0) -> DeploymentPlan:
    """Full scheduling from scratch (paper Fig. 3 workflow).

    ``chunk_tokens`` exposes the serving scheduler's chunked-prefill
    budget to the cost model, so the tabu search scores phase splits
    against the TTFT the token-budget gateway will actually deliver."""
    t0 = time.time()
    solver = LowerLevelSolver(cluster, cfg, wl, rate, slo, compress=compress,
                              chunk_tokens=chunk_tokens)
    res = tabu.tabu_search(cluster, cfg, solver.score, n_step=n_step,
                           n_nghb=n_nghb, n_mem=n_mem, seed=seed,
                           patience=patience)
    score, replicas, o = solver.solve(res.best)
    return DeploymentPlan(solution=res.best, replicas=replicas,
                          orchestration=o, score=score,
                          search_seconds=time.time() - t0,
                          search_history=res.history, evals=res.evals)


def reschedule_lightweight(cluster: ClusterSpec, cfg: ModelConfig,
                           plan: DeploymentPlan, wl: Workload, rate: float,
                           slo: orch.SloSpec, *, n_step: int = 30,
                           n_nghb: int = 8, seed: int = 1,
                           compress: bool = True, chunk_tokens: int = 0,
                           init_solution: Optional[tabu.Solution] = None
                           ) -> DeploymentPlan:
    """Paper §3.4: flip-only tabu + re-orchestration.

    Group construction and parallel configurations are FROZEN (no parameter
    reloading); only phase designation and the TSTP routing change. Handles
    workload shifts and node failures (pass init_solution = drop_nodes(...)).
    """
    t0 = time.time()
    solver = LowerLevelSolver(cluster, cfg, wl, rate, slo, compress=compress,
                              chunk_tokens=chunk_tokens)
    # freeze parallel configs: seed the deduction cache from the live plan
    solver.seed(plan)
    res = tabu.tabu_search(cluster, cfg, solver.score, n_step=n_step,
                           n_nghb=n_nghb, seed=seed, moves=(tabu._flip,),
                           init=init_solution or plan.solution, patience=10)
    score, replicas, o = solver.solve(res.best)
    return DeploymentPlan(solution=res.best, replicas=replicas,
                          orchestration=o, score=score,
                          search_seconds=time.time() - t0,
                          search_history=res.history, evals=res.evals)


def drop_nodes(cluster: ClusterSpec, plan: DeploymentPlan,
               dead_devices: List[int]) -> tabu.Solution:
    """Remove failed devices: any group that lost a device is dropped
    OUTRIGHT — its surviving devices leave the solution entirely rather
    than being folded into other groups. Re-absorbing survivors would
    change those groups' parallel configs and force a parameter
    reload/re-shard; the paper instead drops the affected replicas and
    reflows their traffic onto the untouched groups (lightweight
    rescheduling then re-designates phases among the survivors)."""
    dead = set(dead_devices)
    groups, phases = [], []
    for g, p in zip(plan.solution.groups, plan.solution.phases):
        if not (set(g) & dead):
            groups.append(g)
            phases.append(p)
    return tabu.Solution(tuple(groups), tuple(phases))


# -- plan epochs: structural diff between two deployment plans ---------------


@dataclass
class PlanDelta:
    """What changed between two deployment plans, keyed by device group.

    Groups are the stable identity across an epoch transition: lightweight
    rescheduling never changes group construction (params stay resident),
    so a group either keeps its phase, flips it, dies (node failure), or —
    only after a FULL reschedule — appears anew. ``Gateway.apply_plan``
    consumes this to drain/flip live replicas and atomically install the
    new routing masses."""
    old_plan: DeploymentPlan
    new_plan: DeploymentPlan
    flips: List[Tuple[Tuple[int, ...], str, str]]   # (group, old, new phase)
    kept: List[Tuple[Tuple[int, ...], str]]         # (group, phase)
    dropped: List[Tuple[Tuple[int, ...], str]]      # in old only
    added: List[Tuple[Tuple[int, ...], str]]        # in new only

    @property
    def is_noop(self) -> bool:
        return not (self.flips or self.dropped or self.added)

    def describe(self) -> str:
        parts = [f"{len(self.flips)} flip(s)", f"{len(self.kept)} kept"]
        if self.dropped:
            parts.append(f"{len(self.dropped)} dropped")
        if self.added:
            parts.append(f"{len(self.added)} added")
        for g, a, b in self.flips:
            parts.append(f"{list(g)}: {a}->{b}")
        return ", ".join(parts)


def _group_key(devices) -> Tuple[int, ...]:
    return tuple(sorted(int(d) for d in devices))


def plan_diff(old: DeploymentPlan, new: DeploymentPlan) -> PlanDelta:
    """Structural diff old -> new, matching replicas by device group."""
    old_by = {_group_key(r.devices): r.phase for r in old.replicas}
    new_by = {_group_key(r.devices): r.phase for r in new.replicas}
    flips, kept = [], []
    for g, ph in new_by.items():
        if g not in old_by:
            continue
        if old_by[g] == ph:
            kept.append((g, ph))
        else:
            flips.append((g, old_by[g], ph))
    dropped = [(g, ph) for g, ph in old_by.items() if g not in new_by]
    added = [(g, ph) for g, ph in new_by.items() if g not in old_by]
    return PlanDelta(old_plan=old, new_plan=new, flips=flips, kept=kept,
                     dropped=dropped, added=added)
