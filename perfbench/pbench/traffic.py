"""Open-loop traffic from a mix file (``perfbench/traffic/<mix>.json``).

:func:`generate` is a frozen copy of ``repro_torch.core.workload.generate``
(Poisson arrivals, lognormal lengths from a mean and a coefficient of
variation: the paper's Azure statistics, App. E), so a later change to the
program cannot move the yardstick. :func:`schedule` builds a run's
requests from it: a lead-in population and a window population, each drawn
once from the mix's ``population_seed``. Every seed offers this same
schedule, the same lengths at the same due times: in a queue the order of
arrivals is part of the work (shuffled by the seed, it moved the TTFT tail
of one cell by a third between seeds, against 3% between runs of one
seed). The run's ``--seed`` draws the prompts' token ids (and, elsewhere,
the weights).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def _lognormal(rng, mean, cv, size):
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - sigma2 / 2.0
    return rng.lognormal(mu, math.sqrt(sigma2), size)


def generate(mean_in: float, cv_in: float, mean_out: float, cv_out: float,
             *, rate: float, duration: float, seed: int = 0,
             max_len: int = 8192) -> List[Tuple[float, int, int]]:
    """``(arrival s, prompt tokens, output tokens)`` of Poisson arrivals at
    ``rate`` req/s over ``duration`` s, the program's arithmetic draw for
    draw."""
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        n_in = int(np.clip(_lognormal(rng, mean_in, cv_in, 1)[0], 8,
                           max_len))
        n_out = int(np.clip(_lognormal(rng, mean_out, cv_out, 1)[0], 1,
                            max_len))
        out.append((t, n_in, n_out))
    return out


@dataclass
class Arrival:
    rid: int
    due: float           # seconds after the run's start
    n_in: int
    n_out: int
    in_window: bool


def _population(mix, rate, duration, seed, max_seq):
    """One frozen draw, clipped so prompt + output fit ``max_seq - 2``
    positions (the decode engine retires a slot at ``max_seq - 1``)."""
    got = generate(mix["mean_in"], mix["cv_in"], mix["mean_out"],
                   mix["cv_out"], rate=rate, duration=duration, seed=seed,
                   max_len=max_seq)
    cap = max_seq - 2
    times = [t for t, _, _ in got]
    gaps = np.diff([0.0] + times)
    lens = []
    for _, n_in, n_out in got:
        n_in = min(n_in, cap - 1)
        lens.append((n_in, max(1, min(n_out, cap - n_in))))
    return gaps, lens


def schedule(mix: dict, *, rate: float, lead_in_s: float, seconds: float,
             max_seq: int, in_scale: float = 1.0,
             out_scale: float = 1.0) -> List[Arrival]:
    """The arrivals: the lead-in population over ``[0, lead_in_s)`` and
    the window population over ``[lead_in_s, lead_in_s + seconds]``.
    ``in_scale`` and ``out_scale`` shrink the mix's mean lengths (the CPU
    rehearsal)."""
    m = dict(mix)
    m["mean_in"] = mix["mean_in"] * in_scale
    m["mean_out"] = mix["mean_out"] * out_scale
    base = int(mix["population_seed"])
    out: List[Arrival] = []
    for k, (start, dur, win) in enumerate(((0.0, lead_in_s, False),
                                           (lead_in_s, seconds, True))):
        if dur <= 0:
            continue
        gaps, lens = _population(m, rate, dur, [base, k], max_seq)
        t = start
        for g, (n_in, n_out) in zip(gaps, lens):
            t += float(g)
            out.append(Arrival(len(out), t, n_in, n_out, win))
    return out


def prompt_tokens(arrivals: List[Arrival], vocab: int, seed: int):
    """Random prompt ids in ``[1, vocab)`` for each arrival, from ``seed``
    (one draw a request, in rid order)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 13])
    return [rng.integers(1, vocab, a.n_in).astype(np.int32)
            for a in arrivals]
