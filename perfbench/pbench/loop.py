"""The open loop: each request is submitted to the gateway at its due time
(or as soon after as the loop gets to it: the loop's lateness is
reported), the gateway pumped while it has work, and every request timed
from its due time, so a stalled pump delays the requests behind it in the
numbers too.

Tokens are stamped on the host clock as ``on_token`` delivers them. At the
window's close each request is read as it stands then: its first token,
its tokens and the last one's time, its state, and when it first left the
queue (``RequestHandle.history``).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.serving.gateway import DONE, QUEUED, ServeRequest

from pbench.traffic import Arrival


@dataclass
class Req:
    rid: int
    due: float                     # absolute, on the host clock
    n_in: int
    n_out: int
    in_window: bool
    submitted: float = -1.0
    stamps: List[float] = field(default_factory=list)
    handle: object = None


@dataclass
class Window:
    start: float
    end: float
    reqs: List[Req]
    lateness: List[float]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def counted(self) -> List[Req]:
        return [r for r in self.reqs if r.in_window]


def _range(on: bool, name: str):
    if on:
        import torch
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def serve(gw, arrivals: List[Arrival], prompts, *, t0: float,
          window: tuple, rec, tick: Optional[Callable[[float], None]] = None,
          ranges: bool = False, drain_s: float = 0.0) -> Window:
    """Drive ``gw`` open-loop from ``t0`` (due times are ``t0 + due``)
    until ``window[1]``; ``tick(now)`` runs between pumps (the trace's
    start and stop). With ``drain_s`` (the rate sweep) the gateway is then
    pumped, nothing more submitted, until it is idle or that long has
    passed."""
    reqs = [Req(a.rid, t0 + a.due, a.n_in, a.n_out, a.in_window)
            for a in arrivals]
    by_handle: Dict[int, Req] = {}
    clock = time.perf_counter

    def on_token(h, tok):
        by_handle[id(h)].stamps.append(clock())

    lateness, i, end = [], 0, window[1]
    while True:
        now = clock()
        if now >= end:
            break
        if tick is not None:
            tick(now)
        with _range(ranges, "harness.submit"):
            while i < len(reqs) and reqs[i].due <= now:
                r = reqs[i]
                h = gw.submit(ServeRequest(r.rid, prompts[r.rid], r.n_out),
                              on_token=on_token)
                r.submitted, r.handle = clock(), h
                by_handle[id(h)] = r
                rec.rid_of[id(h.req)] = r.rid
                lateness.append(r.submitted - r.due)
                i += 1
        busy = gw.queue or gw.transfer_queue or gw.retry_queue or any(
            d.alive and d.client.active for d in gw.dec)
        if busy:
            with _range(ranges, "gateway.pump"):
                gw.pump()
        else:
            nxt = reqs[i].due if i < len(reqs) else end
            with _range(ranges, "harness.idle"):
                time.sleep(max(min(nxt - clock(), end - clock(), 5e-3), 0))
    while clock() < end + drain_s and (gw.queue or gw.transfer_queue or any(
            d.alive and d.client.active for d in gw.dec)):
        gw.pump()
    return Window(window[0], end, reqs, lateness)


def state_at(r: Req, t: float) -> Dict[str, object]:
    """Request ``r`` as it stood at time ``t``."""
    n = sum(1 for s in r.stamps if s <= t)
    first = r.stamps[0] if n else None
    last = r.stamps[n - 1] if n else None
    state, left_queue = "unsubmitted", None
    if r.handle is not None:
        state = QUEUED
        for ts, st in r.handle.history:
            if ts > t:
                break
            state = st
            if left_queue is None and st != QUEUED:
                left_queue = ts
    return {"n": n, "first": first, "last": last, "state": state,
            "done": state == DONE, "left_queue": left_queue}
