"""The benchmark's traffic and its request-level numbers, on the CPU: the
frozen generator against the program's, one fixed schedule a mix (the
seed drawing only the prompts), nearest-rank percentiles, and the open
loop's timing from due times (a stalled pump shows in the tail;
unfinished and failed requests count as the metrics say)."""
from __future__ import annotations

import os
import sys
import time
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from pbench import bench, loop, spec, stats, traffic  # noqa: E402


@pytest.mark.parametrize("mix", ["conversation", "coding"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_generate_is_the_programs(mix, seed):
    from repro_torch.core.workload import WORKLOADS, generate
    m = spec.traffic(mix)
    want = [(r.t_arrive, r.n_in, r.n_out) for r in
            generate(WORKLOADS[mix], rate=3.0, duration=20.0, seed=seed)]
    got = traffic.generate(m["mean_in"], m["cv_in"], m["mean_out"],
                           m["cv_out"], rate=3.0, duration=20.0, seed=seed)
    assert got == want


def test_the_schedule_is_the_mix_population_and_seeds_draw_the_prompts():
    mix = spec.traffic("conversation")
    arr = traffic.schedule(mix, rate=2.0, lead_in_s=5.0, seconds=30.0,
                           max_seq=4096)
    win = [a for a in arr if a.in_window]
    assert len(win) > 40
    assert all(5.0 < a.due <= 35.0 + 1e-9 for a in win)
    assert all(a.due <= 5.0 + 1e-9 for a in arr if not a.in_window)
    assert all(a.n_in + a.n_out <= 4094 for a in arr)
    # the window's part is generate()'s draw from the mix's population
    # seed, clipped to max_seq
    want = traffic.generate(mix["mean_in"], mix["cv_in"], mix["mean_out"],
                            mix["cv_out"], rate=2.0, duration=30.0,
                            seed=[mix["population_seed"], 1], max_len=4096)
    assert [a.n_in for a in win] == [min(n, 4093) for _, n, _ in want]
    assert [round(a.due - 5.0, 9) for a in win] == \
        [round(t, 9) for t, _, _ in want]
    p1 = traffic.prompt_tokens(arr, 1000, 9)
    p2 = traffic.prompt_tokens(arr, 1000, 9)
    p3 = traffic.prompt_tokens(arr, 1000, 2 ** 33 + 9)
    assert all((a == b).all() for a, b in zip(p1, p2))
    assert not all((a == b).all() for a, b in zip(p1, p3))
    assert all(len(p) == a.n_in and p.min() >= 1 and p.max() < 1000
               for p, a in zip(p1, arr))


def test_nearest_rank_percentiles():
    assert stats.pct([], 90) is None
    assert stats.pct([5.0], 90) == 5.0
    v = list(range(1, 101))
    assert stats.pct(v, 90) == 90
    assert stats.pct(v, 50) == 50
    assert stats.pct([3, 1, 2], 90) == 3


class _Handle:
    def __init__(self, gw, req, on_token):
        self.req = types.SimpleNamespace(rid=req.rid)
        self.n_out, self.on_token = req.max_new_tokens, on_token
        self.history = [(time.perf_counter(), "QUEUED")]
        self.tokens, self.state = [], "QUEUED"


class _StallingGateway:
    """Serves every queued request at the next pump, all its tokens at
    once; the pump at ``stall_at`` first sleeps ``stall_s``."""

    def __init__(self, stall_at, stall_s):
        self.queue, self.transfer_queue, self.retry_queue, self.dec = \
            [], [], [], []
        self.stall_at, self.stall_s, self.pumps = stall_at, stall_s, 0

    def submit(self, req, on_token):
        h = _Handle(self, req, on_token)
        self.queue.append(h)
        return h

    def pump(self):
        self.pumps += 1
        if self.pumps == self.stall_at:
            time.sleep(self.stall_s)
        for h in self.queue:
            h.history.append((time.perf_counter(), "DONE"))
            h.state = "DONE"
            for t in range(h.n_out):
                h.tokens.append(t)
                h.on_token(h, t)
        self.queue = []


def _run(gw, n=20, gap=0.02, lead=0.0):
    arr = [traffic.Arrival(i, lead + gap * (i + 1), 8, 3, True)
           for i in range(n)]
    prompts = [np.ones(8, np.int32)] * n
    rec = types.SimpleNamespace(rid_of={})
    t0 = time.perf_counter()
    win = loop.serve(gw, arr, prompts, t0=t0,
                     window=(t0 + lead, t0 + lead + gap * n + 0.4), rec=rec)
    states = {r.rid: loop.state_at(r, win.end) for r in win.reqs}
    return bench.RunData("x", {}, {}, win, states, [], 0.0, None, False)


def test_a_stalled_pump_shows_in_the_ttft_tail():
    ttft = spec_reader("ttft_p90_s")
    calm = ttft(_run(_StallingGateway(stall_at=-1, stall_s=0.0)))
    stalled = ttft(_run(_StallingGateway(stall_at=3, stall_s=0.3)))
    assert calm < 0.05
    assert stalled > 0.2          # requests due during the stall waited


def spec_reader(name):
    return spec.metric_reader(name)


def test_unfinished_and_failed_requests_count():
    w = loop.Window(10.0, 20.0, [
        loop.Req(0, 11.0, 8, 5, True, stamps=[11.5, 11.6, 11.7, 11.8, 11.9]),
        loop.Req(1, 12.0, 8, 5, True, stamps=[13.0, 14.0]),
        loop.Req(2, 15.0, 8, 5, True),
        loop.Req(3, 16.0, 8, 5, True),
        loop.Req(4, 5.0, 8, 5, False, stamps=[9.0, 10.5, 19.0]),
    ], [])
    states = {0: {"n": 5, "first": 11.5, "last": 11.9, "state": "DONE",
                  "done": True, "left_queue": 11.2},
              1: {"n": 2, "first": 13.0, "last": 14.0, "state": "DECODING",
                  "done": False, "left_queue": 12.5},
              2: {"n": 0, "first": None, "last": None, "state": "QUEUED",
                  "done": False, "left_queue": None},
              3: {"n": 0, "first": None, "last": None, "state": "FAILED",
                  "done": False, "left_queue": 16.5},
              4: {"n": 3, "first": 9.0, "last": 19.0, "state": "DONE",
                  "done": True, "left_queue": 6.0}}
    run = bench.RunData("x", {}, {}, w, states, [], 1.0, None, False)
    # TTFT: 0.5, 1.0, and the waits to the close: 5.0 (queued), 4.0 (failed)
    assert spec_reader("ttft_p90_s")(run) == pytest.approx(5.0)
    # TPOT: 0.1 s (done); (20 - 13) / 2 (still decoding: its open gap)
    assert spec_reader("tpot_p90_ms")(run) == pytest.approx(3500.0)
    # queue waits: 200, 500, 5000 (still queued), 500 ms
    assert spec_reader("queue_wait_p50_ms")(run) == pytest.approx(500.0)
    # tokens inside [10, 20]: 5 + 2 + two of request 4's
    assert spec_reader("output_tokens_per_s")(run) == pytest.approx(0.9)
    assert bench.failed_of(run) == 1
