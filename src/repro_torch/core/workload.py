"""Serving workloads (paper §5.1): coding and conversation traces from the
Azure LLM inference dataset statistics, plus Poisson arrival generation.

Paper/Appendix E: both workloads have median prompt > 1000 tokens; coding
generates a median of 13 output tokens, conversation 129.

The port's copy of ``repro.core.workload`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class Workload:
    name: str
    mean_in: float
    mean_out: float
    cv_in: float = 0.6          # coefficient of variation (lognormal-ish)
    cv_out: float = 0.9
    # fraction of prompt TOKENS expected to be served from the shared
    # radix prefix cache (serving/prefix_cache.py). The cost model credits
    # this against prefill load and the decode page budget; 0 = no sharing.
    prefix_hit_rate: float = 0.0


CODING = Workload("coding", mean_in=1024, mean_out=16, cv_in=0.5, cv_out=0.8)
CONVERSATION = Workload("conversation", mean_in=1024, mean_out=129,
                        cv_in=0.6, cv_out=0.9)

WORKLOADS = {"coding": CODING, "conversation": CONVERSATION}


@dataclass
class Request:
    rid: int
    t_arrive: float
    n_in: int
    n_out: int
    # filled by the simulator / runtime
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    prefill_replica: int = -1
    decode_replica: int = -1

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrive

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_arrive

    @property
    def tpot(self) -> float:
        if self.n_out <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / max(self.n_out - 1, 1)


def _lognormal(rng, mean, cv, size):
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - sigma2 / 2.0
    return rng.lognormal(mu, math.sqrt(sigma2), size)


def generate(workload: Workload, *, rate: float, duration: float,
             seed: int = 0, max_len: int = 8192) -> List[Request]:
    """Poisson arrivals at `rate` req/s for `duration` seconds."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = 0.0
    rid = 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        n_in = int(np.clip(_lognormal(rng, workload.mean_in,
                                      workload.cv_in, 1)[0], 8, max_len))
        n_out = int(np.clip(_lognormal(rng, workload.mean_out,
                                       workload.cv_out, 1)[0], 1, max_len))
        reqs.append(Request(rid, t, n_in, n_out))
        rid += 1
    return reqs


def mix(w1: Workload, w2: Workload, frac1: float, name: str = "mix"
        ) -> Workload:
    """Blend two workloads (used to model workload shifts)."""
    f2 = 1.0 - frac1
    return Workload(name,
                    mean_in=frac1 * w1.mean_in + f2 * w2.mean_in,
                    mean_out=frac1 * w1.mean_out + f2 * w2.mean_out,
                    cv_in=max(w1.cv_in, w2.cv_in),
                    cv_out=max(w1.cv_out, w2.cv_out))
