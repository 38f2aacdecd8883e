"""Deterministic fault injection for the serving stack (ROADMAP item 4).

The paper's robustness story (§3.4) is that node failures and spot
preemptions are handled by *lightweight reschedules* on a running
gateway. To prove that in CI we need faults that are (a) injected at
the same seams a real deployment fails at — the transport and the
replica clients — and (b) reproducible: a seeded schedule plus a
virtual clock, so a chaos run is a deterministic test, not a flake.

Pieces:

* :class:`VirtualClock` — injectable ``clock()`` callable (satellite of
  ISSUE 6): tests advance time explicitly instead of sleeping.
* :class:`RetryPolicy` — bounded exponential backoff with jitter for
  transient transport failures.
* :class:`FaultSchedule` — a seeded list of :class:`FaultEvent`
  (CRASH / TRANSIENT / STRAGGLER / PREEMPT) with window queries the
  chaos wrappers consult.
* :class:`ChaosTransport` / :class:`ChaosClient` — thin wrappers over
  the real transport / replica clients that raise or stall according
  to the schedule. Everything else forwards untouched, so the gateway
  code path under test is the production one.
* :class:`ChaosController` — fires control-plane events (crash
  confirmation, preemption notices) from the gateway's pump loop.
* :func:`install_chaos` — one-call wiring of all of the above onto a
  live :class:`~repro_torch.serving.gateway.Gateway`.

This module must not import ``repro_torch.serving.gateway`` (the gateway
imports us — for :class:`RetryPolicy` and the error types).

The port's copy of ``repro.serving.faults``;
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence


# --------------------------------------------------------------------------
# errors


class TransientTransportError(RuntimeError):
    """A KV transfer failed in a retryable way (flaky network window)."""


class ReplicaCrashError(RuntimeError):
    """A replica died mid-call; the request must be recovered elsewhere."""


# --------------------------------------------------------------------------
# virtual clock


class VirtualClock:
    """Deterministic time source. ``clock()`` returns the current virtual
    time; ``advance`` moves it forward. ``sleep`` is an alias for
    ``advance`` so gateway drain loops make progress without wall time."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    # gateway._sleep duck-types on this
    def sleep(self, dt: float) -> None:
        self.advance(dt)


# --------------------------------------------------------------------------
# retry policy


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter.

    ``delay_s(attempt)`` for attempt 0..max_retries-1 is
    ``min(base * multiplier**attempt, max_s)`` scaled by a uniform
    jitter in ``[1-jitter, 1+jitter]``. After ``max_retries`` failed
    sends the gateway falls back to requeue-through-prefill.
    """
    max_retries: int = 4
    base_s: float = 0.02
    multiplier: float = 2.0
    jitter: float = 0.5
    max_s: float = 2.0

    def delay_s(self, attempt: int, rng: Optional[_random.Random] = None) -> float:
        d = min(self.base_s * (self.multiplier ** attempt), self.max_s)
        r = rng.random() if rng is not None else _random.random()
        return d * (1.0 - self.jitter + 2.0 * self.jitter * r)


# --------------------------------------------------------------------------
# fault schedule

CRASH = "crash"            # replica dies (raises ReplicaCrashError forever)
TRANSIENT = "transient"    # transport raises TransientTransportError in a window
STRAGGLER = "straggler"    # replica calls stall for slow_s within a window
PREEMPT = "preempt"        # spot preemption notice with a grace window


@dataclass
class FaultEvent:
    """One scheduled fault. ``t`` is seconds after ``FaultSchedule.arm``.

    ``idx = -1`` means "the busiest alive replica of ``phase`` at fire
    time" (resolved by the controller), so a schedule written before the
    trace runs still hits a replica that actually holds work.
    ``require_busy`` defers a CRASH/PREEMPT until the victim has resident
    requests (up to ~2 s past ``t``), making loss scenarios deterministic.
    """
    t: float
    kind: str
    phase: str = "decode"
    idx: int = 0
    duration_s: float = 0.25   # TRANSIENT / STRAGGLER window length
    grace_s: float = 1.0       # PREEMPT grace window
    slow_s: float = 0.05       # STRAGGLER per-call stall
    require_busy: bool = False
    fired: bool = False


class FaultSchedule:
    """A seeded, armed set of fault events.

    Window faults (TRANSIENT, STRAGGLER) are *queried* by the chaos
    wrappers on every call; point faults (CRASH, PREEMPT) are *fired*
    once by the :class:`ChaosController` from the pump loop.
    """

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.t)
        self.seed = seed
        self.rng = _random.Random(seed)
        self.t0: Optional[float] = None
        self._crashed: set = set()

    def arm(self, t0: float) -> None:
        """Anchor event times to wall/virtual time ``t0``."""
        self.t0 = float(t0)

    def _rel(self, now: float) -> float:
        return now - (self.t0 if self.t0 is not None else 0.0)

    # --- window queries (called from wrappers) ---

    def transport_faulty(self, now: float) -> bool:
        rel = self._rel(now)
        return any(e.kind == TRANSIENT and e.t <= rel < e.t + e.duration_s
                   for e in self.events)

    def straggle_s(self, phase: str, idx: int, now: float) -> float:
        rel = self._rel(now)
        for e in self.events:
            if (e.kind == STRAGGLER and e.phase == phase
                    and e.idx == idx and e.t <= rel < e.t + e.duration_s):
                return e.slow_s
        return 0.0

    # --- point events (fired by the controller) ---

    def due(self, now: float) -> List[FaultEvent]:
        rel = self._rel(now)
        return [e for e in self.events
                if e.kind in (CRASH, PREEMPT) and not e.fired and e.t <= rel]

    # --- crash registry (keyed by stable ChaosClient ids) ---

    def mark_crashed(self, cid: int) -> None:
        self._crashed.add(cid)

    def is_crashed(self, cid: int) -> bool:
        return cid in self._crashed

    @classmethod
    def random(cls, *, seed: int, horizon_s: float, n_events: int = 3,
               phases: Sequence[str] = ("decode",),
               kinds: Sequence[str] = (CRASH, TRANSIENT, STRAGGLER, PREEMPT),
               n_replicas: int = 2) -> "FaultSchedule":
        """A reproducible random schedule: same seed -> same events."""
        rng = _random.Random(seed)
        ev = []
        for _ in range(n_events):
            ev.append(FaultEvent(
                t=rng.uniform(0.1 * horizon_s, 0.9 * horizon_s),
                kind=rng.choice(list(kinds)),
                phase=rng.choice(list(phases)),
                idx=rng.randrange(n_replicas),
                duration_s=rng.uniform(0.05, 0.3),
                grace_s=rng.uniform(0.3, 1.0),
                slow_s=rng.uniform(0.02, 0.1)))
        return cls(ev, seed=seed)


# --------------------------------------------------------------------------
# chaos wrappers

_next_cid = [0]


def _alloc_cid() -> int:
    _next_cid[0] += 1
    return _next_cid[0]


class ChaosTransport:
    """Wraps a Transport; raises :class:`TransientTransportError` inside
    scheduled transient windows. Everything else (``rebind_plan``,
    accounting attributes, ``send_decode``) forwards to the inner
    transport, so gateway code sees the production interface."""

    def __init__(self, inner, schedule: FaultSchedule,
                 clock: Callable[[], float] = time.time):
        self.__dict__["inner"] = inner
        self.__dict__["schedule"] = schedule
        self.__dict__["clock"] = clock
        self.__dict__["faults_raised"] = 0

    def _gate(self, now: Optional[float]) -> None:
        t = now if now is not None else self.clock()
        if self.schedule.transport_faulty(t):
            self.__dict__["faults_raised"] += 1
            raise TransientTransportError(
                f"injected transport fault at t={t:.3f}")

    def send(self, wire, src_replica, dst_replica, *, now=None):
        self._gate(now)
        return self.inner.send(wire, src_replica, dst_replica, now=now)

    def send_decode(self, wire, src_dec, dst_dec, *, now=None):
        self._gate(now)
        return self.inner.send_decode(wire, src_dec, dst_dec, now=now)

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    def __setattr__(self, name, value):
        setattr(self.__dict__["inner"], name, value)


class ChaosClient:
    """Wraps a replica client. Heavy calls (``prefill`` / ``step`` /
    ``admit`` — the one admission entry point, all sources) raise
    :class:`ReplicaCrashError` once this client's stable ``cid`` is
    marked crashed, and stall for scheduled straggler windows.
    Lightweight recovery calls (``resident``, ``release``) keep working
    — post-crash recovery uses gateway-side bookkeeping, not the dead
    engine — and ``n_free`` reports 0 so routing steers away."""

    _HEAVY = ("prefill", "step", "admit")

    def __init__(self, inner, schedule: FaultSchedule, phase: str, idx: int,
                 clock: Callable[[], float] = time.time):
        self.__dict__["inner"] = inner
        self.__dict__["schedule"] = schedule
        self.__dict__["phase0"] = phase
        self.__dict__["idx0"] = idx
        self.__dict__["clock"] = clock
        self.__dict__["cid"] = _alloc_cid()

    @property
    def crashed(self) -> bool:
        return self.schedule.is_crashed(self.cid)

    def _gate(self, name: str):
        if self.crashed:
            raise ReplicaCrashError(
                f"injected crash: {self.phase0}[{self.idx0}] is dead")
        stall = self.schedule.straggle_s(self.phase0, self.idx0, self.clock())
        if stall > 0.0:
            clk = self.__dict__["clock"]
            if hasattr(clk, "advance"):
                clk.advance(stall)
            else:
                time.sleep(stall)

    def prefill(self, *a, **kw):
        self._gate("prefill")
        return self.inner.prefill(*a, **kw)

    def step(self, *a, **kw):
        self._gate("step")
        return self.inner.step(*a, **kw)

    def admit(self, *a, **kw):
        self._gate("admit")
        return self.inner.admit(*a, **kw)

    def n_free(self, *a, **kw):
        if self.crashed:
            return 0
        return self.inner.n_free(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    def __setattr__(self, name, value):
        setattr(self.__dict__["inner"], name, value)


class ChaosController:
    """Fires point events (CRASH, PREEMPT) against a live gateway.

    Call :meth:`tick` from the pump loop (the gateway does this itself
    once ``install_chaos`` set ``gw.chaos``). Victim resolution happens
    at fire time: ``idx = -1`` picks the busiest alive replica of the
    phase, and ``require_busy`` defers up to ``defer_s`` until the
    victim holds resident work.
    """

    def __init__(self, gw, schedule: FaultSchedule, defer_s: float = 2.0):
        self.gw = gw
        self.schedule = schedule
        self.defer_s = defer_s
        self.fired: List[Dict[str, Any]] = []

    # --- victim resolution ---

    def _handles(self, phase: str):
        return self.gw.pre if phase == "prefill" else self.gw.dec

    def _resident_count(self, h) -> int:
        try:
            return len(h.client.resident())   # decode clients only
        except Exception:
            return 0

    def _resolve(self, ev: FaultEvent) -> Optional[int]:
        handles = self._handles(ev.phase)
        alive = [i for i, h in enumerate(handles) if h.alive]
        if not alive:
            return None
        if ev.idx >= 0:
            return ev.idx if ev.idx in alive else None
        return max(alive, key=lambda i: self._resident_count(handles[i]))

    def tick(self, now: float) -> None:
        for ev in self.schedule.due(now):
            idx = self._resolve(ev)
            if idx is None:
                ev.fired = True      # nothing to hit; consume the event
                continue
            if (ev.require_busy
                    and self._resident_count(self._handles(ev.phase)[idx]) == 0
                    and self.schedule._rel(now) < ev.t + self.defer_s):
                continue             # defer until the victim holds work
            ev.fired = True
            if ev.kind == CRASH:
                self._fire_crash(ev, idx, now)
            elif ev.kind == PREEMPT:
                self._fire_preempt(ev, idx, now)

    def _fire_crash(self, ev: FaultEvent, idx: int, now: float) -> None:
        h = self._handles(ev.phase)[idx]
        client = h.client
        if hasattr(client, "cid"):
            self.schedule.mark_crashed(client.cid)
        else:                         # not chaos-wrapped: hard kill
            self.gw.kill_replica(ev.phase, idx)
        self.fired.append({"kind": CRASH, "phase": ev.phase, "idx": idx,
                           "t": now})

    def _fire_preempt(self, ev: FaultEvent, idx: int, now: float) -> None:
        report = self.gw.handle_preemption(ev.phase, idx,
                                           grace_s=ev.grace_s, now=now)
        self.fired.append({"kind": PREEMPT, "phase": ev.phase, "idx": idx,
                           "t": now, **(report or {})})


def install_chaos(gw, schedule: FaultSchedule,
                  clock: Optional[Callable[[], float]] = None):
    """Wire a fault schedule onto a live gateway: wrap the transport and
    every replica client, arm the schedule at the current clock, and
    attach a :class:`ChaosController` as ``gw.chaos`` (ticked by
    ``Gateway.pump``). Returns the controller."""
    clk = clock if clock is not None else gw.clock
    if gw.transport is not None and not isinstance(gw.transport,
                                                   ChaosTransport):
        gw.transport = ChaosTransport(gw.transport, schedule, clk)
    for phase, handles in (("prefill", gw.pre), ("decode", gw.dec)):
        for i, h in enumerate(handles):
            if not isinstance(h.client, ChaosClient):
                h.client = ChaosClient(h.client, schedule, phase, i, clk)
    schedule.arm(clk())
    ctl = ChaosController(gw, schedule)
    gw.chaos = ctl
    return ctl
