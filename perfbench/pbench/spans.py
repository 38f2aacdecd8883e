"""The program's own host spans (``repro_torch.serving.trace``) inside a
run's window, and a span's time outside the named spans within it.

The program records spans while ``torch.profiler`` records (the
``--trace 1`` run's traced seconds) or while its tracer is enabled, on the
gateway's clock (``time.perf_counter``, the window's clock too). A reader
gets None where there are none: a ``--trace 0`` run, the CPU rehearsal,
or a program that has no tracer.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence


def records(run) -> Optional[list]:
    """The program's spans lying inside ``run``'s window, by start."""
    try:
        from repro_torch.serving import trace
    except ImportError:
        return None
    got = sorted(trace.spans(run.window.start, run.window.end),
                 key=lambda r: (r.t0, r.depth))
    return got or None


def named(run, name: str) -> List:
    return [r for r in records(run) or () if r.name == name]


def exclusive_s(run, outer: str, inner: Sequence[str],
                plus: Sequence[str] = ()) -> List[float]:
    """For each span named ``outer``: its seconds less the union of the
    spans named in ``inner`` that lie within it, plus the seconds of the
    spans named in ``plus`` within it (a part of an ``inner`` span that
    is counted back)."""
    recs = records(run) or []
    starts = [r.t0 for r in recs]
    out = []
    for o in (r for r in recs if r.name == outer):
        lo = bisect.bisect_left(starts, o.t0)
        hi = bisect.bisect_right(starts, o.t1)
        taken, back, end = 0.0, 0.0, o.t0
        for r in recs[lo:hi]:
            if r.depth <= o.depth or r.t1 > o.t1:
                continue
            if r.name in plus:
                back += r.t1 - r.t0
            if r.name not in inner:
                continue
            s = max(r.t0, end)
            if r.t1 > s:
                taken += r.t1 - s
                end = r.t1
        out.append(o.t1 - o.t0 - taken + back)
    return out
