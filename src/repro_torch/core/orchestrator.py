"""Orchestration of prefill & decode replicas (paper §3.3, lower level).

Builds the SLO-attainment matrix D[i,j] from analytic queueing estimates
(service times from the cost model, alpha-beta KV transfer from Eq. 1), then
solves the two-stage transportation problem (TSTP) as an LP:

    max  sum_ij Z_ij D_ij
    s.t. sum_j Z_ij <= prefill_capacity_i / rate       (row caps)
         sum_i Z_ij <= decode_capacity_j / rate        (col caps)
         sum_ij Z_ij <= 1,  Z >= 0

X_i = sum_j Z*_ij and Y_ij = Z*_ij / X_i recover the paper's routing split.

The port's copy of ``repro.core.orchestrator`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linprog
from scipy.stats import lognorm

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.workload import Workload


@dataclass(frozen=True)
class SloSpec:
    ttft_s: float
    tpot_s: float
    e2e_s: float

    def scaled(self, k: float) -> "SloSpec":
        return SloSpec(self.ttft_s * k, self.tpot_s * k, self.e2e_s * k)


@dataclass
class ReplicaPlan:
    devices: List[int]
    phase: str                       # "prefill" | "decode"
    pc: cm.ParallelConfig
    cost: cm.ReplicaCost


@dataclass
class Orchestration:
    X: np.ndarray                    # (m,) prefill split
    Y: np.ndarray                    # (m, n) decode split per prefill
    Z: np.ndarray                    # (m, n) joint mass
    D: np.ndarray                    # (m, n) per-pair SLO attainment
    attainment: float                # expected overall SLO attainment
    served_frac: float


def _lognorm_cdf(x: float, mean: float, cv: float) -> float:
    if mean <= 0:
        return 1.0
    if x <= 0:
        return 0.0
    sigma2 = math.log(1 + cv * cv)
    mu = math.log(mean) - sigma2 / 2
    return float(lognorm.cdf(x, math.sqrt(sigma2), scale=math.exp(mu)))


def estimate_pair_slo(cluster: ClusterSpec, cfg: ModelConfig,
                      pre: ReplicaPlan, dec: ReplicaPlan, wl: Workload,
                      rate_i: float, rate_j: float, slo: SloSpec, *,
                      compress: bool = True,
                      chunk_tokens: int = 0) -> float:
    """Analytic SLO attainment for requests taking path (pre -> dec).

    ``chunk_tokens > 0`` models SARATHI-style chunked prefill: a request's
    own prefill takes slightly LONGER (per-chunk overheads +
    cross-attention against the resident prefix), but the head-of-line
    quantum a queued request waits behind shrinks from a whole prompt to
    one chunk — the knob the tabu search can now trade off."""
    # prefix-cache credit: only the unshared suffix of the mean prompt is
    # prefilled (full hits skip the prefill stage entirely)
    eff_in = cm.effective_prefill_tokens(wl)
    s_p = cm.prefill_latency(cluster, cfg,
                             pre.pc, max(int(eff_in), 1))
    if chunk_tokens > 0:
        s_own = cm.chunked_prefill_latency(cluster, cfg, pre.pc,
                                           max(int(eff_in), 1),
                                           chunk_tokens)
        s_chunk = cm.prefill_latency(
            cluster, cfg, pre.pc, max(min(chunk_tokens, int(eff_in)), 1))
        # server utilization follows the (slightly inflated) chunked
        # service time; the HOL quantum in the waiting term is one chunk
        rho_p = min(rate_i * s_own, 0.999)
        wait_p = min(s_p, s_chunk) * rho_p / (1 - rho_p)
        ttft_mean = wait_p + s_own
    else:
        rho_p = min(rate_i * s_p, 0.999)
        wait_p = s_p * rho_p / (1 - rho_p)      # M/M/1-ish queue
        ttft_mean = wait_p + s_p

    # decode: fixed-point on concurrent batch. Shared prefix pages let the
    # same page budget admit more concurrent sequences (capacity credit);
    # the attention read cost keeps the FULL context — shared pages are
    # still dequantized and read every step.
    bmax = cm.prefix_shared_decode_batch(dec.cost.max_decode_batch, wl)
    B = 8.0
    for _ in range(8):
        tpot = cm.decode_step_latency(cluster, cfg, dec.pc,
                                      max(int(B), 1),
                                      int(wl.mean_in + wl.mean_out / 2))
        B_new = rate_j * wl.mean_out * tpot
        B = 0.5 * B + 0.5 * min(max(B_new, 1.0), bmax)
    tpot = cm.decode_step_latency(cluster, cfg, dec.pc, max(int(B), 1),
                                  int(wl.mean_in + wl.mean_out / 2))
    overload = rate_j * wl.mean_out * tpot > bmax * 1.05

    # only freshly prefilled suffix KV transits the wire on the hot path
    # (full hits skip the transfer stage; page handles move, not tensors)
    t_kv = cm.kv_transfer_time(cluster, cfg, pre.devices, dec.devices,
                               max(int(eff_in), 1), compress=compress)
    e2e_mean = ttft_mean + t_kv + wl.mean_out * tpot

    p_ttft = _lognorm_cdf(slo.ttft_s, ttft_mean, wl.cv_in)
    p_tpot = 1.0 if tpot <= slo.tpot_s else \
        max(0.0, 1.0 - (tpot - slo.tpot_s) / max(slo.tpot_s, 1e-9))
    p_e2e = _lognorm_cdf(slo.e2e_s, e2e_mean, wl.cv_out)
    att = p_ttft * p_tpot * p_e2e
    if overload:
        att *= 0.1
    return att


def build_matrix(cluster: ClusterSpec, cfg: ModelConfig,
                 prefills: List[ReplicaPlan], decodes: List[ReplicaPlan],
                 wl: Workload, rate: float, slo: SloSpec, *,
                 compress: bool = True, chunk_tokens: int = 0) -> np.ndarray:
    m, n = len(prefills), len(decodes)
    D = np.zeros((m, n))
    cap_p = np.array([p.cost.prefill_tokens_per_s
                      / cm.effective_prefill_tokens(wl)
                      for p in prefills])
    cap_d = np.array([d.cost.decode_tokens_per_s / wl.mean_out
                      for d in decodes])
    lam_p = rate * cap_p / max(cap_p.sum(), 1e-9)
    lam_d = rate * cap_d / max(cap_d.sum(), 1e-9)
    for i in range(m):
        for j in range(n):
            D[i, j] = estimate_pair_slo(cluster, cfg, prefills[i],
                                        decodes[j], wl, lam_p[i], lam_d[j],
                                        slo, compress=compress,
                                        chunk_tokens=chunk_tokens)
    return D


def solve_tstp(D: np.ndarray, cap_p: np.ndarray, cap_d: np.ndarray,
               rate: float) -> Orchestration:
    """LP over joint mass Z (m*n vars)."""
    m, n = D.shape
    c = -D.reshape(-1)
    A_ub, b_ub = [], []
    for i in range(m):  # row caps
        row = np.zeros(m * n)
        row[i * n:(i + 1) * n] = 1.0
        A_ub.append(row)
        b_ub.append(min(cap_p[i] / max(rate, 1e-9), 1.0))
    for j in range(n):  # col caps
        row = np.zeros(m * n)
        row[j::n] = 1.0
        A_ub.append(row)
        b_ub.append(min(cap_d[j] / max(rate, 1e-9), 1.0))
    A_ub.append(np.ones(m * n))
    b_ub.append(1.0)
    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub),
                  bounds=(0, None), method="highs")
    Z = res.x.reshape(m, n) if res.success else np.zeros((m, n))
    X = Z.sum(axis=1)
    served = float(Z.sum())
    Y = np.where(X[:, None] > 1e-12, Z / np.maximum(X[:, None], 1e-12), 0.0)
    att = float((Z * D).sum())  # unserved requests contribute 0
    return Orchestration(X=X, Y=Y, Z=Z, D=D, attainment=att,
                         served_frac=served)


def orchestrate(cluster: ClusterSpec, cfg: ModelConfig,
                prefills: List[ReplicaPlan], decodes: List[ReplicaPlan],
                wl: Workload, rate: float, slo: SloSpec, *,
                compress: bool = True,
                chunk_tokens: int = 0) -> Optional[Orchestration]:
    if not prefills or not decodes:
        return None
    D = build_matrix(cluster, cfg, prefills, decodes, wl, rate, slo,
                     compress=compress, chunk_tokens=chunk_tokens)
    cap_p = np.array([p.cost.prefill_tokens_per_s
                      / cm.effective_prefill_tokens(wl)
                      for p in prefills])
    cap_d = np.array([d.cost.decode_tokens_per_s / wl.mean_out
                      for d in decodes])
    return solve_tstp(D, cap_p, cap_d, rate)
