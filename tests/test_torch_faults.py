"""The reference's fault-injection and recovery cases
(``tests/test_faults.py``) re-pinned on the port: the chaos layer's
schedules, clock, retry policy and wrappers, the FAILED/REJECTED reason
contract, deadline shedding and the heartbeat detector on a
``VirtualClock``, transient transport faults (retry, then requeue through
prefill, then FAILED at ``max_restarts``), a decode death that frees its
pages exactly once, and a straggler that is suspected and recovers.

The port's ``serving/faults.py`` and ``serving/gateway.py`` are copies of
the reference's (``tests/test_torch_isolation.py``). The engines are the
port's, on the reduced LLaMA-30B config on the CPU with random weights
from ``init_params``. The straggler case runs on a ``VirtualClock``, where
the reference's runs on the wall clock (a 0.3 s stall against the fleet's
measured step latency, which fails when busy neighbours slow every step):
here every decode replica's step costs a scheduled stall of virtual time
(0.01 s, and 0.3 s on the straggler for its window), so the detector sees
the same contrast on any machine.
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, GenRequest,  # noqa: E402
                                        PrefillEngine)
from repro_torch.serving.faults import (CRASH, PREEMPT, STRAGGLER,  # noqa: E402
                                        TRANSIENT, ChaosClient,
                                        ChaosTransport, FaultEvent,
                                        FaultSchedule, ReplicaCrashError,
                                        RetryPolicy,
                                        TransientTransportError,
                                        VirtualClock, install_chaos)
from repro_torch.serving.gateway import (DECODING, DONE, FAILED,  # noqa: E402
                                         PREFILLING, QUEUED, REJECTED,
                                         TRANSFERRING, Gateway,
                                         RequestHandle, ServeRequest)
from repro_torch.serving.transport import InProcessTransport  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_reduced("llama-30b")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompt(cfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, n).astype(np.int32)


def _gw(cfg, params, *, n_dec=2, max_slots=4, chunk_size=4, paged=False,
        transport=None, **gw_kw):
    pre = PrefillEngine(cfg, params, max_seq=64, device="cpu")
    dkw = dict(max_slots=max_slots, chunk_size=chunk_size, max_seq=64,
               paged=paged, device="cpu")
    if paged:
        dkw.update(page_size=8)
    decs = [DecodeEngine(cfg, params, **dkw) for _ in range(n_dec)]
    return Gateway([pre], decs, transport=transport, **gw_kw)


def _reqs(cfg, n, *, max_new=16, plen=12, **kw):
    return [ServeRequest(i, _prompt(cfg, plen, seed=i), max_new, **kw)
            for i in range(n)]


# -- schedule / policy / clock (no model) -------------------------------------


def test_fault_schedule_reproducible():
    a = FaultSchedule.random(seed=7, horizon_s=10.0, n_events=4,
                             kinds=(CRASH, TRANSIENT, STRAGGLER, PREEMPT))
    b = FaultSchedule.random(seed=7, horizon_s=10.0, n_events=4,
                             kinds=(CRASH, TRANSIENT, STRAGGLER, PREEMPT))

    def key(e):
        return (e.t, e.kind, e.phase, e.idx, e.duration_s, e.grace_s,
                e.slow_s)
    assert [key(e) for e in a.events] == [key(e) for e in b.events]
    c = FaultSchedule.random(seed=8, horizon_s=10.0, n_events=4)
    assert [key(e) for e in a.events] != [key(e) for e in c.events]
    assert all(x.t <= y.t for x, y in zip(a.events, a.events[1:]))
    a.arm(100.0)
    assert all(e.kind in (CRASH, PREEMPT) for e in a.due(100.0 + 11.0))


def test_fault_schedule_windows():
    s = FaultSchedule([FaultEvent(t=1.0, kind=TRANSIENT, duration_s=0.5),
                       FaultEvent(t=2.0, kind=STRAGGLER, phase="decode",
                                  idx=1, duration_s=0.5, slow_s=0.07)])
    s.arm(10.0)
    assert not s.transport_faulty(10.9)
    assert s.transport_faulty(11.0) and s.transport_faulty(11.49)
    assert not s.transport_faulty(11.5)
    assert s.straggle_s("decode", 1, 12.2) == pytest.approx(0.07)
    assert s.straggle_s("decode", 0, 12.2) == 0.0
    assert s.straggle_s("decode", 1, 12.6) == 0.0


def test_retry_policy_backoff():
    p = RetryPolicy(max_retries=4, base_s=0.02, multiplier=2.0, jitter=0.5,
                    max_s=0.1)
    rng = random.Random(0)
    for attempt, nominal in enumerate([0.02, 0.04, 0.08, 0.1, 0.1]):
        d = p.delay_s(attempt, rng)
        assert 0.5 * nominal <= d <= 1.5 * nominal
    a = [p.delay_s(i, random.Random(3)) for i in range(3)]
    b = [p.delay_s(i, random.Random(3)) for i in range(3)]
    assert a == b


def test_virtual_clock():
    clk = VirtualClock(5.0)
    assert clk() == 5.0
    clk.advance(0.25)
    clk.sleep(0.25)
    assert clk() == pytest.approx(5.5)


def test_chaos_transport_unit():
    sent = []
    inner = SimpleNamespace(
        send=lambda w, s, d, *, now=None: sent.append(("pd", s, d)) or "tkt",
        send_decode=lambda w, s, d, *, now=None:
            sent.append(("dd", s, d)) or "tkt",
        transfers=0)
    clk = VirtualClock()
    s = FaultSchedule([FaultEvent(t=1.0, kind=TRANSIENT, duration_s=0.5)])
    s.arm(clk())
    ct = ChaosTransport(inner, s, clk)
    assert ct.send(None, 0, 1) == "tkt"
    clk.advance(1.2)
    with pytest.raises(TransientTransportError):
        ct.send(None, 0, 1)
    with pytest.raises(TransientTransportError):
        ct.send_decode(None, 0, 1)
    assert ct.faults_raised == 2
    clk.advance(0.5)
    assert ct.send_decode(None, 0, 1) == "tkt"
    assert ct.transfers == 0


def test_chaos_client_unit():
    inner = SimpleNamespace(step=lambda: ["stepped"],
                            resident=lambda: ["r0"],
                            release=lambda r: True,
                            n_free=lambda: 3)
    clk = VirtualClock()
    s = FaultSchedule([FaultEvent(t=0.0, kind=STRAGGLER, phase="decode",
                                  idx=0, duration_s=1.0, slow_s=0.2)])
    s.arm(clk())
    c = ChaosClient(inner, s, "decode", 0, clk)
    t0 = clk()
    assert c.step() == ["stepped"]
    assert clk() - t0 == pytest.approx(0.2)
    s.mark_crashed(c.cid)
    assert c.crashed
    with pytest.raises(ReplicaCrashError):
        c.step()
    assert c.n_free() == 0
    assert c.resident() == ["r0"]
    assert c.release("r0") is True


# -- the reason contract, shedding and the heartbeat detector -----------------


def test_failed_rejected_require_reason():
    gw = SimpleNamespace(clock=lambda: 0.0)

    def fresh(path):
        h = RequestHandle(ServeRequest(0, np.ones(4, np.int32), 4),
                          GenRequest(0, np.ones(4, np.int32), 4), gw)
        for st in path:
            h._transition(st)
        return h

    paths = [(), (PREFILLING,), (PREFILLING, TRANSFERRING),
             (PREFILLING, TRANSFERRING, DECODING)]
    for path in paths:
        h = fresh(path)
        with pytest.raises(ValueError):
            h._transition(FAILED)                # no reason -> refused
        assert h.state == (path[-1] if path else QUEUED)
        h._transition(FAILED, reason="boom")
        assert h.state == FAILED and h.reason == "boom"
    h = fresh(())
    with pytest.raises(ValueError):
        h._transition(REJECTED)
    h._transition(REJECTED, reason="deadline")
    assert h.reason == "deadline"


def test_virtual_clock_deadline_shed():
    clk = VirtualClock()
    pre = SimpleNamespace(synchronous=True, prefill=lambda *a, **k: [])
    dec = SimpleNamespace(synchronous=True, step=lambda: [], n_free=lambda: 1,
                          active=0, resident=lambda: [],
                          release=lambda r: False)
    gw = Gateway([pre], [dec], clock=clk)
    h = gw.submit(ServeRequest(0, np.ones(4, np.int32), 4,
                               ttft_deadline_s=0.5))
    clk.advance(1.0)
    gw.pump()
    assert h.state == REJECTED
    assert h.reason is not None and "deadline" in h.reason
    assert h.history[-1][0] == pytest.approx(1.0)


def test_async_heartbeat_suspect_beat_then_dead():
    clk = VirtualClock()
    pre = SimpleNamespace(synchronous=True, prefill=lambda *a, **k: [])
    fake = SimpleNamespace(synchronous=False, step=lambda: [],
                           n_free=lambda: 0, active=0, resident=lambda: [],
                           release=lambda r: False)
    sync = SimpleNamespace(synchronous=True, step=lambda: [],
                           n_free=lambda: 1, active=0, resident=lambda: [],
                           release=lambda r: False)
    gw = Gateway([pre], [fake, sync], clock=clk, heartbeat_timeout=1.0)
    gw.pump()
    assert gw.dec[0].status == "alive"
    clk.advance(0.6)                      # past suspect_timeout (0.5)
    gw.pump()
    assert gw.dec[0].status == "suspected"
    assert gw.dec[0].suspect_why == "heartbeat"
    assert any("suspected" in e for e in gw.events)
    gw.dec[0].beat(clk())                 # a fresh beat refutes suspicion
    assert gw.dec[0].status == "alive"
    clk.advance(1.1)                      # past heartbeat_timeout
    gw.pump()
    assert gw.dec[0].status == "dead"
    assert any("timed out" in e for e in gw.events)
    assert any("confirmed dead" in e for e in gw.events)
    assert gw.dec[1].status == "alive"
    assert gw.stats()["replicas"][1]["status"] == "dead"


# -- transient transport faults: retry -> requeue -> FAILED --------------------


def test_transient_fault_retries_then_delivers(small_model):
    cfg, params = small_model
    clk = VirtualClock()
    sched = FaultSchedule([FaultEvent(t=0.0, kind=TRANSIENT,
                                      duration_s=0.02)])
    sched.arm(clk())
    tr = ChaosTransport(InProcessTransport(), sched, clk)
    gw = _gw(cfg, params, n_dec=1, transport=tr, clock=clk,
             retry=RetryPolicy(max_retries=4, base_s=0.03, jitter=0.0))
    h = gw.submit(ServeRequest(0, _prompt(cfg), 8))
    gw.run_until_drained()
    assert h.state == DONE and len(h.tokens) == 8
    assert h.restarts == 0                      # retried, never requeued
    assert gw.n_retries == 1
    assert tr.faults_raised == 1
    assert any("transfer retry 1" in e for e in gw.events)


def test_retry_exhaustion_requeues_through_prefill(small_model):
    cfg, params = small_model
    clk = VirtualClock()
    sched = FaultSchedule([FaultEvent(t=0.0, kind=TRANSIENT,
                                      duration_s=0.06)])
    sched.arm(clk())
    tr = ChaosTransport(InProcessTransport(), sched, clk)
    gw = _gw(cfg, params, n_dec=2, transport=tr, clock=clk,
             retry=RetryPolicy(max_retries=1, base_s=0.04, jitter=0.0))
    h = gw.submit(ServeRequest(0, _prompt(cfg), 8))
    gw.run_until_drained()
    assert h.state == DONE and len(h.tokens) == 8
    assert h.restarts >= 1
    assert any("transfer retries exhausted" in e for e in gw.events)
    assert any("re-queued" in e for e in gw.events)
    states = [s for _, s in h.history]
    assert QUEUED in states[states.index(TRANSFERRING):]
    assert gw.stats()["counters"]["requeues"] >= 1


def test_retry_exhaustion_fails_at_max_restarts(small_model):
    cfg, params = small_model
    clk = VirtualClock()
    sched = FaultSchedule([FaultEvent(t=0.0, kind=TRANSIENT,
                                      duration_s=1e9)])
    sched.arm(clk())
    tr = ChaosTransport(InProcessTransport(), sched, clk)
    gw = _gw(cfg, params, n_dec=2, paged=True, transport=tr, clock=clk,
             retry=RetryPolicy(max_retries=0), max_restarts=0)
    h = gw.submit(ServeRequest(0, _prompt(cfg), 8))
    gw.pump()
    assert h.state == FAILED
    assert h.reason is not None and "gave up" in h.reason
    assert gw.n_failed == 1 and h in gw.done
    assert gw.stats()["counters"]["failed"] == 1
    # a TRANSFERRING-state failure never touched decode pages
    for d in gw.dec:
        st = d.engine.page_stats()
        assert st["allocs"] == 0 and st["frees"] == 0 and st["in_use"] == 0


# -- decode death: requeue + page accounting ----------------------------------


def test_decode_death_frees_pages_exactly_once(small_model):
    cfg, params = small_model
    gw = _gw(cfg, params, n_dec=2, paged=True, chunk_size=2)
    hs = [gw.submit(r) for r in _reqs(cfg, 3, max_new=12)]
    for _ in range(60):
        gw.pump()
        if all(h.state == DECODING for h in hs):
            break
    assert all(h.state == DECODING for h in hs)
    vic = max(range(2), key=lambda j: len(gw.dec[j].client.resident()))
    eng = gw.dec[vic].engine
    before = eng.page_stats()
    assert before["in_use"] > 0
    gw.kill_replica("decode", vic)
    after = eng.page_stats()
    # every resident page freed exactly once (a double free raises inside
    # PagePool.free), and no new allocations on the dead engine
    assert after["in_use"] == 0
    assert after["allocs"] == before["allocs"]
    assert after["frees"] == before["frees"] + before["in_use"]
    gw.run_until_drained()
    assert all(h.state == DONE and len(h.tokens) == 12 for h in hs)
    for d in gw.dec:
        st = d.engine.page_stats()
        assert st["in_use"] == 0 and st["allocs"] == st["frees"]
    assert gw.stats()["page_pool"]["alloc_failures"] >= 0


# -- a straggler, on the virtual clock ----------------------------------------


def test_straggler_suspected_then_recovers(small_model):
    cfg, params = small_model
    clk = VirtualClock()
    gw = _gw(cfg, params, n_dec=3, max_slots=2, chunk_size=4, clock=clk,
             suspect_probe_s=0.25)
    # every decode step costs 10 ms of virtual time; the straggler's cost
    # 300 ms for the first 1.5 s
    sched = FaultSchedule(
        [FaultEvent(t=0.0, kind=STRAGGLER, phase="decode", idx=i,
                    duration_s=1e9, slow_s=0.01) for i in (1, 2)]
        + [FaultEvent(t=0.0, kind=STRAGGLER, phase="decode", idx=0,
                      duration_s=1.5, slow_s=0.3)])
    install_chaos(gw, sched, clock=clk)
    hs = [gw.submit(r) for r in _reqs(cfg, 8, max_new=24)]
    suspected = False
    for _ in range(4000):
        gw.pump()
        suspected = suspected or gw.dec[0].status == "suspected"
        if all(h.is_terminal for h in hs):
            break
    assert all(h.state == DONE for h in hs)
    assert suspected, "the stalled replica never left the routing tables"
    assert any("suspected (latency" in e for e in gw.events)
    if gw.dec[0].status != "alive":
        clk.advance(0.3)
        gw.pump()
    assert gw.dec[0].status == "alive"
    assert any(("recovered" in e) or ("probe" in e) for e in gw.events)
