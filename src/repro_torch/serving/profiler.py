"""Workload profiler (paper Appendix E): sliding-window statistics of
prompt/response lengths and arrival rate, with shift detection that triggers
the scheduler's lightweight rescheduling.

The port's copy of ``repro.serving.profiler``;
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Optional, Tuple

from repro_torch.core.workload import Workload


@dataclass
class WindowStats:
    n: int
    rate: float
    mean_in: float
    mean_out: float


class WorkloadProfiler:
    """Sliding windows over COMPLETIONS (lengths, via ``record``) and
    ARRIVALS (via ``record_arrival``). The two are kept apart because they
    answer different questions: length statistics exist only once a
    request finishes, but the offered load must be measured at submit time
    — under saturation (exactly when rescheduling matters) the completion
    rate is capped by the stale plan's capacity and badly underestimates
    the arrival rate.

    ``in_scale``/``out_scale`` map observed token counts back to the
    workload the COST MODEL should see — e.g. a reduced-config engine
    serving 1/32-scale prompts sets ``in_scale=32`` so ``as_workload()``
    describes the full-model trace."""

    def __init__(self, *, window: int = 200, shift_threshold: float = 0.4,
                 in_scale: float = 1.0, out_scale: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        self.window = window
        self.shift_threshold = shift_threshold
        self.in_scale = in_scale
        self.out_scale = out_scale
        self.clock = clock if clock is not None else time.time
        self._records: Deque[Tuple[float, int, int]] = deque(maxlen=window)
        self._arrivals: Deque[float] = deque(maxlen=window)
        self._prefix: Deque[Tuple[int, int]] = deque(maxlen=window)
        self._baseline: Optional[WindowStats] = None

    def record(self, n_in: int, n_out: int, t: Optional[float] = None):
        self._records.append((t if t is not None else self.clock(),
                              n_in, n_out))

    def record_arrival(self, t: Optional[float] = None):
        self._arrivals.append(t if t is not None else self.clock())

    def record_prefix(self, prompt_len: int, hit_len: int):
        """Record a prefix-cache probe at SUBMIT time: ``hit_len`` of the
        ``prompt_len`` prompt tokens were found in the shared radix cache
        (0 = miss). Probes are recorded at submit rather than completion
        for the same reason arrivals are — under saturation the hit rate
        of what is *offered* is what the next plan must be sized for."""
        self._prefix.append((max(int(prompt_len), 1),
                             max(int(hit_len), 0)))

    def prefix_hit_rate(self) -> float:
        """Token-weighted fraction of prompt tokens served from the
        prefix cache over the window; 0.0 until any probe is recorded."""
        if not self._prefix:
            return 0.0
        tot = sum(p for p, _ in self._prefix)
        hit = sum(min(h, p) for p, h in self._prefix)
        return hit / max(tot, 1)

    def arrival_rate(self) -> Optional[float]:
        """Offered load over the arrival window; None until 8 arrivals."""
        if len(self._arrivals) < 8:
            return None
        dur = max(self._arrivals[-1] - self._arrivals[0], 1e-9)
        return len(self._arrivals) / dur

    def stats(self) -> Optional[WindowStats]:
        if len(self._records) < 8:
            return None
        ts = [r[0] for r in self._records]
        dur = max(ts[-1] - ts[0], 1e-9)
        return WindowStats(
            n=len(self._records),
            rate=len(self._records) / dur,
            mean_in=sum(r[1] for r in self._records) / len(self._records),
            mean_out=sum(r[2] for r in self._records) / len(self._records))

    def set_baseline(self):
        self._baseline = self.stats()

    @property
    def has_baseline(self) -> bool:
        """True once a baseline window is pinned — until then
        ``shift_detected`` can never fire (drivers call ``set_baseline``
        as soon as the first window fills)."""
        return self._baseline is not None

    def shift_detected(self) -> bool:
        """Relative change in mean output (or input) length beyond threshold.

        Output length drives the prefill:decode balance (paper §3.4), so it
        is the primary signal."""
        cur = self.stats()
        if cur is None or self._baseline is None:
            return False
        b = self._baseline

        def rel(a, bb):
            return abs(a - bb) / max(abs(bb), 1e-9)

        return (rel(cur.mean_out, b.mean_out) > self.shift_threshold
                or rel(cur.mean_in, b.mean_in) > self.shift_threshold)

    def as_workload(self, name: str = "observed") -> Optional[Workload]:
        """Observed window as a cost-model workload, with the configured
        engine->full-model scale applied."""
        s = self.stats()
        if s is None:
            return None
        return Workload(name, mean_in=s.mean_in * self.in_scale,
                        mean_out=s.mean_out * self.out_scale,
                        prefix_hit_rate=self.prefix_hit_rate())
