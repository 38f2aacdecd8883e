"""Explicit-state model checker for the serving stack's protocols (the
port of ``repro.analysis.modelcheck``, over the port's
``serving/protocol.py`` and ``serving/page_pool.py``).

``python -m repro_torch.analysis check [--depth N] [--quick]`` explores small
abstract models of three protocols by exhaustive BFS over every event
interleaving — the interleavings chaos traces only sample:

* **lifecycle** — the request state machine (QUEUED -> ... -> DONE) with
  crash / preempt / cancel / retry-exhaustion events injectable at every
  transition point. The model's *behavior* side is the event alphabet
  below (what the gateway does); its *legality* side is
  ``serving/protocol.TRANSITIONS`` — the SAME dict object
  ``RequestHandle._transition`` validates against at runtime, so there is
  no hand-copied table to drift. An edge the behavior needs but the table
  forbids (or vice versa, via the sanitizer drift audit) is a violation
  with the event trace that exposes it.
* **pagepool** — alloc / share / COW / free / donate over the REAL
  :class:`~repro_torch.serving.page_pool.PagePool` (pure Python; branching via
  its ``snapshot``/``restore`` seam, rule R006). Checks refcount
  conservation, no free-at-refcount>0, no double-free, the
  donation-before-free retire ordering (``protocol.retire_steps``), and
  that a slot's append page is never shared (copy-on-write actually
  split it).
* **chunkedprefill** — PartialPrefill advance / cancel-mid-chunk /
  preempt-mid-chunk against ``protocol.chunk_take`` /
  ``chunk_complete`` / ``chunk_extract_compress``. Checks pages freed
  exactly once, no admission of incomplete jobs, and the quantize-once
  wire discipline (chunk wires stay RAW; the transport wire is
  quantized exactly once, over the spliced whole).

Counterexamples are event traces. ``replay_trace`` re-executes a trace
CONCRETELY through the real code the model binds to — a fresh real
``PagePool`` for the pool/chunk models, and the port's real
``RequestHandle._transition`` under ``VirtualClock`` +
``REPRO_SANITIZE=1`` for lifecycle traces — confirming the violation
reproduces outside the model. The mutation harness (``run_mutations``)
plants known protocol bugs in ``serving/protocol.py``'s hooks (which the
engines execute too) and asserts the checker catches each with a
replayable trace.

Everything but lifecycle replay is stdlib-only; lifecycle replay imports
the port's gateway (numpy and PyTorch, no device), so it always runs.
"""
from __future__ import annotations

import os
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.serving import protocol
from repro_torch.serving.page_pool import PagePool


class ProtocolError(Exception):
    """An event the protocol performs raised where it must not (e.g. the
    pool rejected a free/share the retire ordering guarantees is valid)."""


@dataclass
class Violation:
    model: str
    message: str
    trace: Tuple[str, ...]          # event path from the initial state
    state: str = ""

    def format(self) -> str:
        path = " -> ".join(self.trace) if self.trace else "(initial state)"
        s = f"[{self.model}] {self.message}\n    trace: {path}"
        if self.state:
            s += f"\n    state: {self.state}"
        return s


@dataclass
class CheckResult:
    model: str
    depth: int
    states: int                     # distinct states visited
    transitions: int                # edges executed
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def explore(model, *, depth: int = 12, max_states: int = 500_000,
            max_violations: int = 16) -> CheckResult:
    """BFS over ``model``'s state space to ``depth`` events.

    A model provides ``name``, ``initial() -> state`` (hashable),
    ``events(state) -> Iterable[str]``, ``apply(state, event) -> state``
    (raising :class:`ProtocolError` on a protocol-level rejection),
    ``invariants(state) -> Iterable[str]`` and optionally
    ``final(visited) -> Iterable[Violation]`` for whole-space properties
    (reachability)."""
    init = model.initial()
    visited: Dict[object, Tuple[str, ...]] = {init: ()}
    frontier = deque([(init, 0)])
    violations: List[Violation] = [
        Violation(model.name, msg, (), repr(init))
        for msg in model.invariants(init)]
    transitions = 0
    max_depth = 0
    while frontier and len(violations) < max_violations:
        state, d = frontier.popleft()
        if d >= depth:
            continue
        trace = visited[state]
        for ev in model.events(state):
            try:
                nxt = model.apply(state, ev)
            except ProtocolError as e:
                violations.append(Violation(model.name, str(e),
                                            trace + (ev,), repr(state)))
                if len(violations) >= max_violations:
                    break
                continue
            transitions += 1
            if nxt in visited:
                continue
            ntrace = trace + (ev,)
            visited[nxt] = ntrace
            max_depth = max(max_depth, d + 1)
            for msg in model.invariants(nxt):
                violations.append(Violation(model.name, msg, ntrace,
                                            repr(nxt)))
            if len(visited) >= max_states:
                violations.append(Violation(
                    model.name, f"state-space bound {max_states} hit "
                    f"(model not closed — shrink it)", ntrace))
                frontier.clear()
                break
            frontier.append((nxt, d + 1))
    final = getattr(model, "final", None)
    if callable(final) and not violations:
        violations.extend(final(visited))
    return CheckResult(model.name, max_depth, len(visited), transitions,
                       violations)


# -- model 1: request lifecycle ----------------------------------------------


class LifecycleModel:
    """Every gateway event, injectable at every state, with a bounded
    restart budget. State = ``(lifecycle_state, restarts)``."""

    name = "lifecycle"

    # event -> intended destination; "requeue" resolves to QUEUED while
    # the restart budget lasts, FAILED after (gateway._requeue_handle)
    INTENT: Dict[str, str] = {
        "dispatch": protocol.PREFILLING,            # _dispatch_prefill
        "full_prefix_hit": protocol.TRANSFERRING,   # _try_prefix
        "shed_deadline": protocol.REJECTED,         # _shed_expired
        "abort_replan": protocol.FAILED,            # apply_plan overflow
        "cancel": protocol.CANCELLED,               # Gateway.cancel
        "prefill_ok": protocol.TRANSFERRING,        # _send_wire
        "prefill_crash": "requeue",                 # ReplicaCrashError
        "admit": protocol.DECODING,                 # _drain_transfers
        "transfer_retries_exhausted": "requeue",    # _schedule_retry
        "decode_died_in_transfer": "requeue",       # _recover_from
        "finish": protocol.DONE,                    # _step_decodes
        "preempt_migrate": protocol.TRANSFERRING,   # handle_preemption
        "decode_crash": "requeue",                  # _recover_from
    }

    EVENTS: Dict[str, Tuple[str, ...]] = {
        protocol.QUEUED: ("dispatch", "full_prefix_hit", "shed_deadline",
                          "abort_replan", "cancel"),
        protocol.PREFILLING: ("prefill_ok", "prefill_crash", "cancel"),
        protocol.TRANSFERRING: ("admit", "transfer_retries_exhausted",
                                "decode_died_in_transfer", "cancel"),
        protocol.DECODING: ("finish", "preempt_migrate", "decode_crash",
                            "cancel"),
    }

    def __init__(self, table: Optional[Dict[str, frozenset]] = None,
                 max_restarts: int = 2):
        # default: the LIVE table — the one the gateway enforces
        self.table = table if table is not None else protocol.TRANSITIONS
        self.max_restarts = max_restarts

    def initial(self):
        return (protocol.QUEUED, 0)

    def events(self, state) -> Tuple[str, ...]:
        st, _ = state
        if st in protocol.TERMINAL_STATES:
            return ()               # terminal states absorb
        return self.EVENTS.get(st, ())

    def resolve(self, state, event) -> Tuple[str, int]:
        """Destination + new restart count the gateway intends for
        ``event`` in ``state`` (shared with the lifecycle replay)."""
        st, r = state
        dst = self.INTENT[event]
        if dst == "requeue":
            if r >= self.max_restarts:
                return protocol.FAILED, r
            return protocol.QUEUED, r + 1
        return dst, r

    def apply(self, state, event):
        st, _ = state
        dst, r = self.resolve(state, event)
        if dst not in self.table.get(st, frozenset()):
            raise ProtocolError(
                f"gateway event {event!r} needs edge {st} -> {dst}, which "
                f"the transition table forbids (legal from {st}: "
                f"{sorted(self.table.get(st, frozenset()))})")
        return (dst, r)

    def invariants(self, state) -> Iterable[str]:
        st, r = state
        if st not in self.table:
            yield f"state {st!r} is missing from the transition table"
        if r > self.max_restarts:
            yield (f"restart count {r} exceeds the max_restarts bound "
                   f"{self.max_restarts} — requeue without exhaustion check")
        if st in protocol.TERMINAL_STATES and self.table.get(st):
            yield (f"terminal state {st} has outgoing edges "
                   f"{sorted(self.table[st])} — terminal must absorb")

    def final(self, visited) -> Iterable[Violation]:
        reached = {s for s, _ in visited}
        if protocol.DONE not in reached:
            yield Violation(self.name,
                            "DONE is unreachable from QUEUED", ())
        # livelock freedom: every reachable state reaches a terminal
        for state, trace in visited.items():
            if self._terminal_reachable(state):
                continue
            yield Violation(
                self.name,
                f"no terminal state reachable from {state[0]} "
                f"(restarts={state[1]}) — requests can live-lock there",
                trace, repr(state))

    def _terminal_reachable(self, state) -> bool:
        seen = {state}
        work = [state]
        while work:
            s = work.pop()
            if s[0] in protocol.TERMINAL_STATES:
                return True
            for ev in self.events(s):
                try:
                    n = self.apply(s, ev)
                except ProtocolError:
                    continue
                if n not in seen:
                    seen.add(n)
                    work.append(n)
        return False


def check_table_drift() -> List[Violation]:
    """The runtime sanitizer keeps a deliberately independent copy of the
    lifecycle table (``sanitizers._LEGAL``); protocol.TRANSITIONS is the
    enforced original. They must agree edge-for-edge."""
    from repro_torch.analysis.sanitizers import _LEGAL
    out: List[Violation] = []
    for st in sorted(set(protocol.TRANSITIONS) | set(_LEGAL)):
        a = frozenset(protocol.TRANSITIONS.get(st, frozenset()))
        b = frozenset(_LEGAL.get(st, ()))
        if a != b:
            out.append(Violation(
                "lifecycle",
                f"transition-table drift at {st}: protocol has "
                f"{sorted(a)}, sanitizer audit has {sorted(b)}", ()))
    return out


# -- model 2: PagePool alloc/share/COW/free/donate ----------------------------

PX = "prefix-cache"                 # the index's owner tag (prefix_cache.py)
_TW = 8                             # model table width (page-chain bound)


class PoolModel:
    """Drives the REAL :class:`PagePool` through the engine's page
    protocol: fresh admits, retires (``protocol.retire_steps`` — donate
    to the prefix index, then free), cancels, full-prefix-hit admits with
    the ``protocol.cow_boundary`` copy-on-write split, and evictions.

    State = ``(pool.state_key(), slots, donated-chain set)``; branching
    rewinds the pool via its ``snapshot``/``restore`` seam. Page size 4;
    "mid" requests end mid-page (7 tokens, 2 pages — the COW case),
    "aligned" ones end on a page boundary (8 tokens, 3 pages)."""

    name = "pagepool"
    LN = {"mid": 7, "aligned": 8}

    def __init__(self, pool_factory: Optional[Callable[[], PagePool]] = None,
                 n_slots: int = 2, n_pages: int = 7, page_size: int = 4):
        self.page_size = page_size
        self.n_slots = n_slots
        self._factory = pool_factory or (
            lambda: PagePool(n_pages + 1, page_size))
        self.pool = self._factory()
        self._snaps: Dict[object, object] = {}

    def _need(self, ln: int) -> int:
        return -(-(ln + 1) // self.page_size)   # budget = ln + 1 decode tok

    def initial(self):
        self.pool.canonicalize()
        slots = (None,) * self.n_slots
        state = (self.pool.state_key(), slots, ())
        self._snaps[state] = self.pool.snapshot()
        return state

    def events(self, state) -> List[str]:
        self.pool.restore(self._snaps[state])
        _, slots, chains = state
        evs: List[str] = []
        for s, held in enumerate(slots):
            if held is None:
                evs += [f"admit_fresh_mid:{s}", f"admit_fresh_aligned:{s}"]
                for ci in range(len(chains)):
                    if self._chain_live(chains[ci]):
                        evs.append(f"admit_prefix:{s}:{ci}")
            else:
                evs += [f"retire:{s}", f"release:{s}"]
        for p in self.pool_pages_evictable(state):
            evs.append(f"evict:{p}")
        return evs

    def _chain_live(self, entry) -> bool:
        chain, _ = entry
        return all(PX in self.pool.owners_of(p) for p in chain)

    def pool_pages_evictable(self, state) -> List[int]:
        return [p for p in self.pool.owned_by(PX)
                if self.pool.owners_of(p) == frozenset({PX})]

    def apply(self, state, event):
        self.pool.restore(self._snaps[state])
        _, slots, chains = state
        slots = list(slots)
        chains = list(chains)
        parts = event.split(":")
        op = parts[0]
        try:
            if op in ("admit_fresh_mid", "admit_fresh_aligned"):
                s = int(parts[1])
                ln = self.LN["mid" if op.endswith("mid") else "aligned"]
                pages = self.pool.alloc(self._need(ln), s)
                if pages is None:
                    return state            # pool full: admission rejected
                slots[s] = (tuple(pages), ln)
            elif op == "admit_prefix":
                s, ci = int(parts[1]), int(parts[2])
                chain, ln = chains[ci]
                need_total = min(self._need(ln), _TW)
                n_extra = max(need_total - len(chain), 0)
                cow = protocol.cow_needed(ln, self.page_size, _TW,
                                          len(chain))
                alloced = self.pool.alloc(n_extra + int(cow), s)
                if alloced is None:
                    return state
                self.pool.share(list(chain), s)
                new_chain = list(chain) + (alloced[:n_extra] if cow
                                           else alloced)
                if cow:
                    cow_at = protocol.cow_boundary(ln, self.page_size, _TW)
                    repl = alloced[-1]
                    self.pool.unshare([new_chain[cow_at]], s)
                    new_chain[cow_at] = repl
                slots[s] = (tuple(new_chain), ln)
            elif op == "retire":
                s = int(parts[1])
                chain, ln = slots[s]
                n_used = -(-ln // self.page_size)
                donated = tuple(chain[:n_used])
                for step in protocol.retire_steps(donate=True):
                    if step == "donate":
                        fresh = [p for p in donated
                                 if PX not in self.pool.owners_of(p)]
                        if fresh:
                            self.pool.share(fresh, PX)
                        if (donated, ln) not in chains:
                            chains.append((donated, ln))
                    elif step == "free":
                        self.pool.free(list(chain), owner=s)
                slots[s] = None
            elif op == "release":
                s = int(parts[1])
                chain, _ = slots[s]
                self.pool.free(list(chain), owner=s)
                slots[s] = None
            elif op == "evict":
                p = int(parts[1])
                self.pool.unshare([p], PX)
                chains = [(c, ln) for c, ln in chains if p not in c]
            else:
                raise AssertionError(f"unknown event {event}")
        except ValueError as e:
            raise ProtocolError(f"PagePool rejected {event}: {e}") from e
        self.pool.canonicalize()
        new = (self.pool.state_key(), tuple(slots), tuple(chains))
        if new not in self._snaps:
            self._snaps[new] = self.pool.snapshot()
        return new

    def invariants(self, state) -> Iterable[str]:
        self.pool.restore(self._snaps[state])
        pool = self.pool
        _, slots, _ = state
        if pool.n_free + pool.n_in_use != pool.capacity:
            yield (f"refcount conservation broken: {pool.n_free} free + "
                   f"{pool.n_in_use} in use != capacity {pool.capacity} "
                   f"(a page is free while still referenced, or leaked)")
        for p in pool.pages_in_use():
            if pool.refcount(p) < 1:
                yield f"page {p} is in use with refcount 0"
        for s, held in enumerate(slots):
            if held is None:
                continue
            chain, ln = held
            for p in chain:
                if s not in pool.owners_of(p):
                    yield (f"slot {s} decodes from page {p} without "
                           f"holding a reference (use-after-free)")
            app = protocol.cow_boundary(ln, self.page_size, _TW)
            if app < len(chain) and pool.refcount(chain[app]) > 1:
                yield (f"slot {s}'s append page {chain[app]} is shared by "
                       f"{sorted(map(repr, pool.owners_of(chain[app])))} — "
                       f"copy-on-write was skipped; decode appends would "
                       f"corrupt KV other readers still attend over")


# -- model 3: chunked-prefill admission ---------------------------------------


class ChunkModel:
    """One PartialPrefill job walked through every interleaving of
    advance / cancel / preempt / admit / finish, with its admission pages
    drawn from a REAL :class:`PagePool`.

    State = ``(phase, pos, wire taints, transport taint, requeues,
    pool key)``. Prompt length 5, chunk budget 2 (so completion lands
    mid-budget and an off-by-one in ``protocol.chunk_complete`` is
    reachable)."""

    name = "chunkedprefill"
    N = 5                           # prompt tokens
    BUDGET = 2                      # chunk token budget per advance
    PAGES = 2                       # admission reservation

    def __init__(self, pool_factory: Optional[Callable[[], PagePool]] = None):
        self._factory = pool_factory or (lambda: PagePool(4, 4))
        self.pool = self._factory()
        self._snaps: Dict[object, object] = {}

    def initial(self):
        self.pool.canonicalize()
        state = ("chunking", 0, (), "", 0, self.pool.state_key())
        self._snaps[state] = self.pool.snapshot()
        return state

    def events(self, state) -> List[str]:
        phase, pos, wires, _, requeues, _ = state
        done = protocol.chunk_complete(pos, self.N)
        evs: List[str] = []
        if phase == "chunking":
            if not done:
                evs.append("advance")
                if pos > 0 and requeues < 1:
                    evs.append("preempt_mid_chunk")
            if done:
                evs.append("admit")
            evs.append("cancel")
        elif phase == "admitted":
            evs += ["finish", "cancel"]
        return evs

    def apply(self, state, event):
        phase, pos, wires, transport, requeues, _ = state
        self.pool.restore(self._snaps[state])
        try:
            if event == "advance":
                take = protocol.chunk_take(self.N - pos, self.BUDGET, True)
                taint = ("quant" if protocol.chunk_extract_compress()
                         else "raw")
                wires = wires + (taint,)
                pos += take
                if protocol.chunk_complete(pos, self.N):
                    # completion: ONE quantization over the spliced whole
                    transport = ("double-quant" if "quant" in wires
                                 else "quant-once")
            elif event == "preempt_mid_chunk":
                # the prefill replica died: accumulated chunk wires die
                # with it; the job requeues and restarts from scratch
                pos, wires, transport = 0, (), ""
                requeues += 1
            elif event == "cancel":
                if phase == "admitted":
                    self.pool.free(self.pool.owned_by("job"), owner="job")
                phase, wires = "cancelled", ()
            elif event == "admit":
                pages = self.pool.alloc(self.PAGES, "job")
                if pages is None:
                    return state
                phase = "admitted"
            elif event == "finish":
                self.pool.free(self.pool.owned_by("job"), owner="job")
                phase = "done"
            else:
                raise AssertionError(f"unknown event {event}")
        except ValueError as e:
            raise ProtocolError(
                f"PagePool rejected {event}: {e} (pages must be freed "
                f"exactly once)") from e
        self.pool.canonicalize()
        new = (phase, pos, wires, transport, requeues,
               self.pool.state_key())
        if new not in self._snaps:
            self._snaps[new] = self.pool.snapshot()
        return new

    def invariants(self, state) -> Iterable[str]:
        phase, pos, wires, transport, _, _ = state
        if phase in ("admitted", "done") and pos < self.N:
            yield (f"job admitted with only {pos}/{self.N} prompt tokens "
                   f"prefilled — the admission wire is missing the prompt "
                   f"tail's KV")
        if phase == "chunking" and "quant" in wires:
            yield ("chunk wire quantized before job completion — chunks "
                   "must stay RAW so the resumable prefix is exact "
                   "(quantize once, over the spliced whole)")
        if transport == "double-quant":
            yield ("transport wire quantized twice (per-chunk quantization "
                   "followed by completion compression)")
        self.pool.restore(self._snaps[state])
        if self.pool.n_free + self.pool.n_in_use != self.pool.capacity:
            yield "refcount conservation broken in the admission pool"
        if phase in ("done", "cancelled") and self.pool.owned_by("job"):
            yield (f"terminal job still holds pages "
                   f"{self.pool.owned_by('job')} — leak")


# -- entry points -------------------------------------------------------------

MODELS: Dict[str, Callable[[], object]] = {
    "lifecycle": LifecycleModel,
    "pagepool": PoolModel,
    "chunkedprefill": ChunkModel,
}


def run_check(*, depth: int = 12, quick: bool = False,
              models: Optional[Iterable[str]] = None) -> List[CheckResult]:
    """Explore every protocol model; quick mode shrinks the depth so the
    tier-1 CI step stays well under its 60s budget."""
    if quick:
        depth = min(depth, 8)
    out: List[CheckResult] = []
    for name in (models or MODELS):
        res = explore(MODELS[name](), depth=depth)
        if name == "lifecycle":
            res.violations.extend(check_table_drift())
        out.append(res)
    return out


# -- counterexample replay ----------------------------------------------------


def replay_trace(model_name: str, trace: Iterable[str]) -> Optional[str]:
    """Re-execute a counterexample trace CONCRETELY (no search) through
    the real code the model binds to; returns the reproduced failure
    message, or None when the trace completes cleanly (not reproduced).

    pagepool / chunkedprefill traces run against a fresh real
    :class:`PagePool` via the model's own ``apply`` (which performs real
    ``alloc``/``share``/``free`` calls); lifecycle traces drive the real
    ``RequestHandle._transition`` — the gateway's enforcement point —
    under ``VirtualClock`` with ``REPRO_SANITIZE=1``."""
    if model_name == "lifecycle":
        return _replay_lifecycle(list(trace))
    model = MODELS[model_name]()
    state = model.initial()
    for ev in trace:
        try:
            state = model.apply(state, ev)
        except ProtocolError as e:
            return str(e)
        bad = list(model.invariants(state))
        if bad:
            return bad[0]
    return None


def _replay_lifecycle(trace: List[str]) -> Optional[str]:
    """Drive the REAL RequestHandle through the trace's events. The
    handle's ``_transition`` validates against the live (possibly
    mutated) ``protocol.TRANSITIONS``; an illegal edge raises the
    gateway's own RuntimeError — the reproduction. A trace that
    completes is additionally audited by the sanitizer's independent
    state-machine auditor."""
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.analysis.sanitizers import (SanitizerError,
                                                 TransitionAuditor)
    from repro_torch.serving import gateway as gw
    from repro_torch.serving.faults import VirtualClock

    clock = VirtualClock()
    stub = SimpleNamespace(clock=clock)
    sreq = gw.ServeRequest(rid=0, tokens=np.arange(4, dtype=np.int32),
                           max_new_tokens=2)
    handle = gw.RequestHandle(sreq, gw.GenRequest(0, sreq.tokens, 2), stub)
    model = LifecycleModel()
    state = model.initial()
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        for ev in trace:
            dst, r = model.resolve(state, ev)
            clock.advance(0.001)
            try:
                handle._transition(dst, now=clock(),
                                   reason=f"modelcheck replay: {ev}")
            except RuntimeError as e:
                return f"RequestHandle rejected {ev!r}: {e}"
            handle.restarts = r
            state = (dst, r)
        auditor = TransitionAuditor()
        try:
            auditor.audit(handle, context="modelcheck replay")
        except SanitizerError as e:
            return str(e)
        return None
    finally:
        if old is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = old


# -- mutation harness ---------------------------------------------------------


@dataclass
class MutationResult:
    name: str
    model: str
    caught: bool
    trace: Tuple[str, ...]
    message: str
    replayed: Optional[bool]        # None: lifecycle replay not asked


@contextmanager
def _patched(obj, attr, value):
    orig = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


@contextmanager
def _drop_edge(src: str, dst: str):
    orig = protocol.TRANSITIONS[src]
    protocol.TRANSITIONS[src] = frozenset(orig - {dst})
    try:
        yield
    finally:
        protocol.TRANSITIONS[src] = orig


class _LeakyPool(PagePool):
    """Planted bug: ``free`` returns a page to the free list even while
    other owners still reference it (free-at-refcount>0)."""

    def _revoke(self, page, owner):
        owners = self._owners.get(page, set())
        owners.discard(owner)
        held = self._by_owner.get(owner)
        if held is not None:
            held.discard(page)
            if not held:
                del self._by_owner[owner]
        self._free.append(page)     # BUG: frees despite live references
        return True


MUTATIONS: Dict[str, Tuple[str, str, Callable]] = {
    # name -> (model it must trip, description, contextmanager factory)
    "lifecycle-missing-migration-edge": (
        "lifecycle",
        "drop DECODING -> TRANSFERRING (preemption drains cannot migrate)",
        lambda: _drop_edge(protocol.DECODING, protocol.TRANSFERRING)),
    "lifecycle-missing-crash-requeue": (
        "lifecycle",
        "drop PREFILLING -> QUEUED (prefill crash cannot requeue)",
        lambda: _drop_edge(protocol.PREFILLING, protocol.QUEUED)),
    "retire-free-before-donate": (
        "pagepool",
        "retire frees the chain before donating it to the prefix index",
        lambda: _patched(protocol, "retire_steps",
                         lambda donate: (("free", "donate") if donate
                                         else ("free",)))),
    "retire-double-free": (
        "pagepool",
        "retire releases the slot's references twice",
        lambda: _patched(protocol, "retire_steps",
                         lambda donate: ("donate", "free", "free"))),
    "cow-skip-tail": (
        "pagepool",
        "copy-on-write skips the chain's tail page (boundary off-by-one)",
        lambda: _patched(protocol, "cow_needed",
                         lambda ln, ps, tw, cl:
                         protocol.cow_boundary(ln, ps, tw) < cl - 1)),
    "chunk-admit-incomplete": (
        "chunkedprefill",
        "completion check off by one chunk (admits a job missing the "
        "prompt tail)",
        lambda: _patched(protocol, "chunk_complete",
                         lambda pos, n: pos >= n - ChunkModel.BUDGET)),
    "chunk-per-chunk-quant": (
        "chunkedprefill",
        "chunk extraction quantizes each chunk wire (raw-until-complete "
        "broken; transport double-quantized)",
        lambda: _patched(protocol, "chunk_extract_compress",
                         lambda: True)),
    "pool-free-at-refcount": (
        "pagepool",
        "pool frees a page other owners still reference",
        lambda: _patched(PoolModel, "__init__",
                         _leaky_pool_init)),
}


def _leaky_pool_init(self, pool_factory=None, n_slots=2, n_pages=7,
                     page_size=4):
    PoolModel.__wrapped_init__(self,
                               pool_factory=lambda: _LeakyPool(
                                   n_pages + 1, page_size),
                               n_slots=n_slots, n_pages=n_pages,
                               page_size=page_size)


PoolModel.__wrapped_init__ = PoolModel.__init__


def run_mutations(*, depth: int = 10, replay: bool = True,
                  lifecycle_replay: bool = False) -> List[MutationResult]:
    """Plant each known protocol bug, assert the checker catches it, and
    replay the counterexample through the real code to confirm.
    Pool/chunk replays are stdlib (a fresh real PagePool); lifecycle
    replay drives the port's real gateway RequestHandle, opt-in as in the
    reference (``lifecycle_replay``) — off, those report
    ``replayed=None``."""
    out: List[MutationResult] = []
    for name, (model_name, _desc, ctx) in MUTATIONS.items():
        with ctx():
            res = explore(MODELS[model_name](), depth=depth)
            caught = bool(res.violations)
            trace: Tuple[str, ...] = ()
            message = ""
            replayed: Optional[bool] = None
            if caught:
                # prefer a violation with a non-empty replayable trace
                v = next((v for v in res.violations if v.trace),
                         res.violations[0])
                trace, message = v.trace, v.message
                if replay and trace:
                    if model_name == "lifecycle" and not lifecycle_replay:
                        replayed = None
                    else:
                        replayed = replay_trace(model_name,
                                                trace) is not None
        out.append(MutationResult(name, model_name, caught, trace,
                                  message, replayed))
    return out
