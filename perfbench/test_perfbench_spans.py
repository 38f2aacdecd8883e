"""The readers of the program's spans (``pbench/spans.py``, the metrics
``prefill_pad_pct``, ``pump_host_ms`` and ``decode_host_ms``) over whole
runs of each cell on the CPU at its rehearsal sizes: with the program's
tracer enabled around the open loop each reads a finite number, and the
padding equals a count by hand from the window's prefill calls; with the
tracer off each reads None. On one pump of hand-set times, the host
metrics take out exactly the engines' calls, the graph's replay and
read-back, and the harness's decode client."""
from __future__ import annotations

import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from pbench import bench, spans, spec  # noqa: E402
from repro_torch.serving import trace  # noqa: E402

torch.set_num_threads(2)
CELLS = [w["name"] for w in spec.manifest()["workloads"]]
# long enough that whole pumps lie in the window on a loaded CPU (a
# rehearsal pump takes 0.25-0.4 s alone); the untraced run only reads None
SECONDS = 5.0
OFF_SECONDS = 0.5
READERS = ("prefill_pad_pct", "pump_host_ms", "decode_host_ms")


def _pad_by_hand(pre, lens):
    """(tokens, padded tokens) of one bucketed prefill call over prompts
    of ``lens``: grouped by bucket, at most ``max_batch`` rows a model
    call, the rows padded to a power of two."""
    by_bucket = {}
    for n in lens:
        by_bucket.setdefault(pre._bucket_of(n), []).append(n)
    padded = 0
    for Lb, group in by_bucket.items():
        for lo in range(0, len(group), pre.max_batch):
            sub = group[lo:lo + pre.max_batch]
            rows = min(1 << (len(sub) - 1).bit_length(), pre.max_batch)
            padded += rows * Lb - sum(sub)
    return sum(lens), padded


@pytest.mark.parametrize("cell", CELLS)
def test_span_readers_read_the_window(cell):
    c = bench.prepare(cell, seed=21, device="cpu", rehearse=True)
    arrivals, prompts = bench.arrivals_for(c, 21, SECONDS)
    bench.warm(c, arrivals, trace=False)
    pre = c.sys.pre
    assert pre.bucketed

    off = bench.measure(c, arrivals, prompts, seconds=OFF_SECONDS,
                        trace=False)
    for name in READERS:
        assert spec.metric_reader(name)(off.data) is None, name

    c.sys.reset()
    trace.enable()
    try:
        got = bench.measure(c, arrivals, prompts, seconds=SECONDS,
                            trace=True)
    finally:
        trace.disable()
    data = got.data
    vals = {name: spec.metric_reader(name)(data) for name in READERS}
    assert all(v is not None and math.isfinite(v) and v >= 0
               for v in vals.values()), vals
    assert vals["pump_host_ms"] > 0 and vals["decode_host_ms"] > 0

    calls = [k for k in data.calls if k.kind == "prefill"]
    tokens = padded = 0
    n = 0
    for s in spans.named(data, "prefill.call"):
        k, = [k for k in calls if k.t0 <= s.t0 and s.t1 <= k.t1]
        t, p = _pad_by_hand(pre, k.lens)
        assert (s.attrs["tokens"], s.attrs["padded_tokens"]) == (t, p)
        tokens, padded, n = tokens + t, padded + p, n + 1
    assert n >= 2
    assert vals["prefill_pad_pct"] == pytest.approx(100.0 * padded / tokens)

    # the readers read inside the window only
    for r in spans.records(data):
        assert data.window.start <= r.t0 and r.t1 <= data.window.end
    trace.clear()


# (name, t0 ms, t1 ms, children): one traced pump, one of each span
PUMP = ("pump", 0, 47, [
    ("pump.housekeeping", 0, 1, []),
    ("pump.dispatch", 1, 7, [("prefill.call", 2, 6, [])]),
    ("pump.transfers", 7, 10, [("decode.admit", 8, 9, [])]),
    ("pump.decode", 10, 46, [
        ("decode.chunk", 13, 43, [("decode.stage", 13.5, 14, []),
                                  ("decode.replay", 14, 20, []),
                                  ("decode.readback", 20, 40, []),
                                  ("decode.retire", 40, 42, [])]),
        ("pump.deliver", 44, 45, [])]),
])


def test_host_metrics_leave_out_the_engines_and_the_decode_client(
        monkeypatch):
    times = []

    def walk(node):
        name, t0, t1, kids = node
        times.append(t0)
        for k in kids:
            walk(k)
        times.append(t1)

    def play(node):
        with trace.span(node[0]):
            for k in node[3]:
                play(k)

    walk(PUMP)
    clock = iter(t * 1e-3 for t in times)
    monkeypatch.setattr(trace, "_clock", lambda: next(clock))
    trace.clear()
    trace.enable()
    try:
        play(PUMP)
    finally:
        trace.disable()
    run = SimpleNamespace(window=SimpleNamespace(start=-1.0, end=1.0))
    read = {n: spec.metric_reader(n)(run) for n in READERS}
    trace.clear()
    # 47 less prefill.call 4, decode.admit 1 and pump.decode 36, which
    # gives back its pump.deliver 1; the chunk's 30 less replay 6 and
    # read-back 20
    assert read["pump_host_ms"] == pytest.approx(7.0)
    assert read["decode_host_ms"] == pytest.approx(4.0)
    assert read["prefill_pad_pct"] is None
