"""The ``--trace 1`` run's device trace: ``torch.profiler`` over a steady
part of the window, reduced to the device's busy seconds, each kernel's
intervals, the operations that took most time, and the idle gaps named by
what the host was doing (the innermost ``record_function`` range of the
harness open at the gap's middle).

Kineto's raw events are read (``kineto_results.events()``), not the
profiler's event tree, which takes minutes over a few hundred thousand
kernels. Device events are kernels, copies and sets; user annotations
mirrored on the device are left out.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


def warm_cupti():
    """One empty profiling cycle: the first ``start()`` of a process spends
    seconds initialising CUPTI, which set-up pays instead of the window."""
    p = profiler()
    p.start()
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    p.stop()


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def _matching(self, patterns: List[str]):
        rx = [re.compile(p) for p in patterns]
        return [(s, e) for n, s, e in self.kernels
                if any(r.search(n) for r in rx)]

    def time_of(self, patterns: List[str]) -> Optional[float]:
        """Summed seconds of the kernels whose name matches a pattern."""
        ns = sum(e - s for s, e in self._matching(patterns))
        return ns * 1e-9 if ns else None

    def count_of(self, patterns: List[str]) -> int:
        return len(self._matching(patterns))


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    gaps = []
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def summarize(prof, t_start_ns: int, t_stop_ns: int,
              host_window_s: float) -> Summary:
    """``t_start_ns``/``t_stop_ns``: the traced window on the profiler's
    clock (``time.time_ns``, taken around ``start``/``stop``)."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                kernels.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
    busy, gaps = _union([(s, e) for _, s, e in kernels])
    lo = min((s for _, s, _ in kernels), default=t_start_ns)
    hi = max((e for _, _, e in kernels), default=t_stop_ns)
    gaps = [(max(t_start_ns, 0), lo)] + gaps + [(hi, t_stop_ns)]
    by_op: Dict[str, int] = {}
    for n, s, e in kernels:
        by_op[n] = by_op.get(n, 0) + (e - s)
    ranges.sort()
    by_host: Dict[str, int] = {}
    stack, j = [], 0          # the harness's ranges nest: a sweep
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) // 2
        while j < len(ranges) and ranges[j][0] <= mid:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "outside any harness range"
        by_host[name] = by_host.get(name, 0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=host_window_s, busy_s=busy * 1e-9,
                   kernels=kernels,
                   device_ops=[[n[:160], v * 1e-9] for n, v in top],
                   idle_gaps=[[n, v * 1e-9] for n, v in idle])


class Window:
    """Starts and stops the profiler between the gateway's pumps, each
    after a synchronize, so a call lies wholly inside or outside."""

    def __init__(self, rec, start_at: float, stop_at: float):
        self.rec, self.start_at, self.stop_at = rec, start_at, stop_at
        self.prof = None
        self._t = None

    def tick(self, now: float):
        if self.prof is None and self._t is None and now >= self.start_at:
            torch.cuda.synchronize()
            self.prof = profiler()
            self._t = (time.time_ns(), time.perf_counter())
            self.prof.start()
            self.rec.profiling = True
        elif self.prof is not None and now >= self.stop_at:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        torch.cuda.synchronize()
        t_ns, t_pc = time.time_ns(), time.perf_counter()
        self.rec.profiling = False
        self.prof.stop()
        self._stopped = (self._t[0], t_ns, t_pc - self._t[1])
        self._held, self.prof = self.prof, None

    def read(self) -> Optional[Summary]:
        if getattr(self, "_held", None) is None:
            return None
        t0, t1, win = self._stopped
        summary = summarize(self._held, t0, t1, win)
        self._held = None
        return summary
