"""Baseline serving policies the paper compares against (§5.1):

* vLLM-like     — colocated continuous batching, homogeneous in-house 8xA100.
* DistServe-like— phase splitting on the homogeneous in-house cluster,
                  NVLink KV transfer, no compression, no hetero scheduling.
* HexGen-like   — heterogeneous cloud, asymmetric parallelism via our Alg. 2,
                  but NO phase splitting (colocated groups) and generic
                  (capacity-proportional) routing.

All three produce (replicas, orchestration, colocated?) consumable by the
simulator, so every benchmark compares identical workloads end-to-end.

The port's copy of ``repro.core.baselines`` (numpy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import orchestrator as orch
from repro_torch.core import parallel as par
from repro_torch.core.cluster import ClusterSpec, make_inhouse
from repro_torch.core.workload import Workload


@dataclass
class BaselinePlan:
    name: str
    cluster: ClusterSpec
    replicas: List[orch.ReplicaPlan]
    orchestration: Optional[orch.Orchestration]
    colocated: bool
    compress: bool


def _even_groups(cluster: ClusterSpec, cfg: ModelConfig, per_group: int
                 ) -> List[List[int]]:
    idxs = [d.idx for d in cluster.devices]
    groups = [idxs[i:i + per_group] for i in range(0, len(idxs), per_group)]
    return [g for g in groups if len(g) == per_group]


def _min_group_size(cluster: ClusterSpec, cfg: ModelConfig) -> int:
    need = cfg.param_count() * cm.BYTES * 1.1
    sizes = sorted(d.chip.hbm_bytes for d in cluster.devices)
    for k in (1, 2, 4, 8):
        if sizes[0] * k >= need:
            return k
    return 8


def vllm_like(cfg: ModelConfig, wl: Workload, rate: float,
              slo: orch.SloSpec, seed: int = 0) -> BaselinePlan:
    cluster = make_inhouse(seed)
    k = _min_group_size(cluster, cfg)
    groups = _even_groups(cluster, cfg, k)
    replicas = []
    for g in groups:
        got = par.deduce(cluster, cfg, g, "decode",
                         mean_ctx=int(wl.mean_in + wl.mean_out))
        if got:
            replicas.append(orch.ReplicaPlan(g, "decode", *got))
    pre = replicas  # colocated: same replicas serve both phases
    o = orch.orchestrate(cluster, cfg, pre, replicas, wl, rate, slo,
                         compress=False)
    return BaselinePlan("vllm", cluster, replicas, o, colocated=True,
                        compress=False)


def distserve_like(cfg: ModelConfig, wl: Workload, rate: float,
                   slo: orch.SloSpec, seed: int = 0) -> BaselinePlan:
    cluster = make_inhouse(seed)
    k = _min_group_size(cluster, cfg)
    groups = _even_groups(cluster, cfg, k)
    # phase split proportional to workload demand (DistServe heuristic)
    demand_p = wl.mean_in / (wl.mean_in + 4.0 * wl.mean_out)
    n_pre = max(1, min(len(groups) - 1, round(len(groups) * demand_p)))
    replicas = []
    for gi, g in enumerate(groups):
        phase = "prefill" if gi < n_pre else "decode"
        got = par.deduce(cluster, cfg, g, phase,
                         mean_ctx=int(wl.mean_in + wl.mean_out))
        if got:
            replicas.append(orch.ReplicaPlan(g, phase, *got))
    pre = [r for r in replicas if r.phase == "prefill"]
    dec = [r for r in replicas if r.phase == "decode"]
    o = orch.orchestrate(cluster, cfg, pre, dec, wl, rate, slo,
                         compress=False)
    return BaselinePlan("distserve", cluster, replicas, o, colocated=False,
                        compress=False)


def hexgen_like(cluster: ClusterSpec, cfg: ModelConfig, wl: Workload,
                rate: float, slo: orch.SloSpec) -> BaselinePlan:
    """Heterogeneous groups via clustering init, asymmetric parallelism, but
    colocated phases + capacity-proportional routing (no TSTP)."""
    import random
    from repro_torch.core import tabu
    sol = tabu.initial_solution(cluster, cfg, random.Random(0))
    replicas = []
    for g in sol.groups:
        got = par.deduce(cluster, cfg, list(g), "decode",
                         mean_ctx=int(wl.mean_in + wl.mean_out))
        if got:
            replicas.append(orch.ReplicaPlan(list(g), "decode", *got))
    o = orch.orchestrate(cluster, cfg, replicas, replicas, wl, rate, slo,
                         compress=False)
    return BaselinePlan("hexgen", cluster, replicas, o, colocated=True,
                        compress=False)
