"""Discrete-event serving simulator (DistServe-style, paper §3.3 + §5).

Models: Poisson arrivals -> TSTP routing (X, Y) -> prefill replica queues
(token-budget batching, latency from the cost model) -> alpha-beta KV
transfer (Eq. 1, optional int4 compression) -> decode replicas (continuous
batching; per-step latency re-evaluated as the running batch changes).

Produces per-request TTFT / TPOT / E2E -> SLO attainment & throughput.
This is the measurement tool behind Figs. 6-12 reproductions.

The port's copy of ``repro.core.simulator`` (numpy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.orchestrator import Orchestration, ReplicaPlan, SloSpec
from repro_torch.core.workload import Request, Workload


@dataclass
class SimResult:
    requests: List[Request]
    duration: float
    ttft_attain: float
    tpot_attain: float
    e2e_attain: float
    throughput_tokens: float      # generated tokens / s
    throughput_reqs: float
    p50_e2e: float
    p99_e2e: float
    kv_comm_frac: float           # mean fraction of E2E spent in KV transfer

    def attainment(self, kind: str = "e2e") -> float:
        return {"ttft": self.ttft_attain, "tpot": self.tpot_attain,
                "e2e": self.e2e_attain}[kind]


class _PrefillReplica:
    def __init__(self, idx, cluster, cfg, plan: ReplicaPlan,
                 max_batch_tokens=4096):
        self.idx = idx
        self.cluster, self.cfg, self.plan = cluster, cfg, plan
        self.queue: List[Request] = []
        self.busy_until = 0.0
        self.max_batch_tokens = max_batch_tokens

    def latency(self, tokens: int) -> float:
        return cm.prefill_latency(self.cluster, self.cfg, self.plan.pc,
                                  max(tokens, 16))


class _DecodeReplica:
    def __init__(self, idx, cluster, cfg, plan: ReplicaPlan):
        self.idx = idx
        self.cluster, self.cfg, self.plan = cluster, cfg, plan
        self.active: List[Tuple[Request, int]] = []   # (req, tokens left)
        self.pending: List[Request] = []              # waiting for KV room
        self.max_batch = max(1, plan.cost.max_decode_batch)
        self.next_step = math.inf

    def step_latency(self) -> float:
        b = max(len(self.active), 1)
        ctx = int(np.mean([r.n_in for r, _ in self.active])) if self.active \
            else int(self.cfg.d_model and 1024)
        return cm.decode_step_latency(self.cluster, self.cfg, self.plan.pc,
                                      b, ctx)


def simulate(cluster: ClusterSpec, cfg: ModelConfig,
             replicas: List[ReplicaPlan], o: Orchestration,
             requests: List[Request], slo: SloSpec, *,
             compress: bool = True, seed: int = 0,
             colocated: bool = False,
             prefill_interference: float = 1.0) -> SimResult:
    """Run the event simulation.

    colocated=True models vLLM-style co-located serving: every replica is
    both prefill and decode; a prefill batch stalls that replica's decoding
    (interference), reproducing the paper's phase-splitting motivation.
    """
    rng = np.random.default_rng(seed)
    pre_plans = [r for r in replicas if r.phase == "prefill" or colocated]
    dec_plans = [r for r in replicas if r.phase == "decode" or colocated]
    pres = [_PrefillReplica(i, cluster, cfg, p)
            for i, p in enumerate(pre_plans)]
    decs = [_DecodeReplica(j, cluster, cfg, p)
            for j, p in enumerate(dec_plans)]

    X = o.X if o is not None and o.X.sum() > 1e-9 else \
        np.ones(len(pres)) / max(len(pres), 1)
    X = X / X.sum()
    Y = o.Y if o is not None else np.ones((len(pres), len(decs)))
    Y = np.where(Y.sum(axis=1, keepdims=True) > 1e-9,
                 Y / np.maximum(Y.sum(axis=1, keepdims=True), 1e-9),
                 np.ones_like(Y) / max(len(decs), 1))

    # event heap: (time, seq, kind, payload)
    ev: List[Tuple[float, int, str, object]] = []
    seq = 0

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(ev, (t, seq, kind, payload))
        seq += 1

    for r in requests:
        push(r.t_arrive, "arrive", r)

    done: List[Request] = []
    kv_frac: List[float] = []

    def start_prefill(p: _PrefillReplica, now: float):
        if not p.queue or p.busy_until > now:
            return
        batch, toks = [], 0
        while p.queue and (not batch
                           or toks + p.queue[0].n_in <= p.max_batch_tokens):
            r = p.queue.pop(0)
            batch.append(r)
            toks += r.n_in
        lat = p.latency(toks) * prefill_interference
        p.busy_until = now + lat
        for r in batch:
            r.t_prefill_start = now
        if colocated and p.idx < len(decs):
            # phase interference: a prefill batch stalls this replica's
            # decode loop (the paper's motivation for phase splitting)
            d = decs[p.idx]
            if d.next_step != math.inf:
                d.next_step += lat
                push(d.next_step, "decode_step", p.idx)
        push(now + lat, "prefill_done", (p.idx, batch, toks))

    while ev:
        now, _, kind, payload = heapq.heappop(ev)
        if kind == "arrive":
            r = payload
            i = int(rng.choice(len(pres), p=X))
            r.prefill_replica = i
            pres[i].queue.append(r)
            start_prefill(pres[i], now)
        elif kind == "prefill_done":
            pidx, batch, toks = payload
            p = pres[pidx]
            for r in batch:
                r.t_first_token = now
                j = int(rng.choice(len(decs), p=Y[pidx]))
                r.decode_replica = j
                if colocated and j == pidx:
                    t_kv = 0.0
                else:
                    t_kv = cm.kv_transfer_time(
                        cluster, cfg, p.plan.devices, decs[j].plan.devices,
                        r.n_in, compress=compress)
                kv_frac.append(t_kv)
                push(now + t_kv, "join_decode", (j, r))
            start_prefill(p, now)
        elif kind == "join_decode":
            j, r = payload
            d = decs[j]
            if len(d.active) >= d.max_batch:
                d.pending.append(r)   # KV memory full: queue at the replica
            else:
                d.active.append((r, r.n_out))
            if d.next_step == math.inf and d.active:
                d.next_step = now + d.step_latency()
                push(d.next_step, "decode_step", j)
        elif kind == "decode_step":
            j = payload
            d = decs[j]
            if now < d.next_step - 1e-12:
                continue  # stale event
            still = []
            for r, left in d.active:
                left -= 1
                if left <= 0:
                    r.t_done = now
                    done.append(r)
                else:
                    still.append((r, left))
            d.active = still
            while d.pending and len(d.active) < d.max_batch:
                nxt = d.pending.pop(0)
                d.active.append((nxt, nxt.n_out))
            if d.active:
                d.next_step = now + d.step_latency()
                push(d.next_step, "decode_step", j)
            else:
                d.next_step = math.inf

    # metrics
    finished = [r for r in done if r.t_done >= 0]
    if not finished:
        return SimResult([], 0.0, 0, 0, 0, 0, 0, 0, 0, 0)
    t_end = max(r.t_done for r in finished)
    t0 = min(r.t_arrive for r in finished)
    dur = max(t_end - t0, 1e-9)
    ttft = np.array([r.ttft for r in finished])
    tpot = np.array([r.tpot for r in finished])
    e2e = np.array([r.e2e for r in finished])
    toks = sum(r.n_out for r in finished)
    return SimResult(
        requests=finished, duration=dur,
        ttft_attain=float((ttft <= slo.ttft_s).mean()),
        tpot_attain=float((tpot <= slo.tpot_s).mean()),
        e2e_attain=float((e2e <= slo.e2e_s).mean()),
        throughput_tokens=toks / dur,
        throughput_reqs=len(finished) / dur,
        p50_e2e=float(np.percentile(e2e, 50)),
        p99_e2e=float(np.percentile(e2e, 99)),
        kv_comm_frac=float(np.mean(np.array(kv_frac)
                                   / np.maximum(e2e[:len(kv_frac)], 1e-9)))
        if kv_frac else 0.0)


def min_slo_scale_for(cluster, cfg, replicas, o, requests, base: SloSpec,
                      target: float = 0.9, *, kind: str = "e2e",
                      compress: bool = True,
                      scales=(1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0,
                              8.0, 10.0, 12.0, 16.0)) -> float:
    """Paper metric: minimum latency deadline (SLO scale) reaching the
    attainment target."""
    for s in scales:
        res = simulate(cluster, cfg, replicas, o, requests, base.scaled(s),
                       compress=compress)
        if res.attainment(kind) >= target:
            return s
    return float("inf")
