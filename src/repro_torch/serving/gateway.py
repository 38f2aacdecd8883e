"""Serving gateway (paper Appendix E as a *service* API).

The public surface of the serving stack: ``Gateway.submit(ServeRequest)``
returns a :class:`RequestHandle` carrying an explicit request lifecycle

    QUEUED -> PREFILLING -> TRANSFERRING -> DECODING -> DONE
       |          |              |            |    ^
       |          |              |            |    | (KV page migration,
       |          |              |            v    |  preemption drain)
       |          +--------------+---> QUEUED + TRANSFERRING
       |               (replica failure / retry exhaustion)
       +---> TRANSFERRING   (full prefix-cache hit: prefill skipped, the
                             "wire" is a page handle on the target replica)
    any non-terminal -> CANCELLED / REJECTED / FAILED

with streaming token delivery (callback and iterator), ``cancel()``,
per-request deadline/priority, and admission control that sheds requests
whose TTFT deadline is provably missed while still queued.

Fault tolerance (DESIGN.md §8): an injectable ``clock`` makes every
timestamp deterministic under test; transient transport errors retry
with bounded exponential backoff + jitter before falling back to
requeue-through-prefill; the failure detector distinguishes
suspected-slow (kept out of routing, still stepped) from confirmed-dead
(recovered + epoch reschedule via ``set_failover``); and
``handle_preemption`` drains a spot-preempted decode replica by
migrating its resident KV page-granular over the transport to surviving
replicas within the grace window.

Replicas are reached only through the narrow :class:`PrefillClient` /
:class:`DecodeClient` interfaces and KV state moves only through a
:class:`~repro_torch.serving.transport.Transport`, so a multi-host RPC
realization (each replica = a pod slice driven over the wire) slots in
without touching routing, heartbeats, or rescheduling logic
(DESIGN.md §5).

Scheduling (DESIGN.md §11): each ``pump()`` is one token-budget tick —
with ``SchedulerConfig.prefill_chunk_tokens > 0`` pending prefill runs
as fixed-token CHUNKS (SARATHI-style continuous batching: a long prompt
no longer head-of-line-blocks TTFT for everyone behind it) interleaved
with one decode chunk per replica, and admissions/evictions happen at
the chunk boundary in between.

The port's copy of ``repro.serving.gateway``;
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition. Its one difference: ``gateway_from_plan`` takes
``device=`` where the reference takes a runtime. The replica clients'
``jit_cache_size`` counts the decode engines' captured CUDA graphs, which
the sanitizer's retrace monitor reads under ``REPRO_SANITIZE=1``.
"""
from __future__ import annotations

import math
import os
import random as _random
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.orchestrator import Orchestration, SloSpec
from repro_torch.serving.engine import (ADMIT_CHUNKED, ADMIT_FRESH,
                                  ADMIT_MIGRATED, ADMIT_PREFIX_HIT,
                                  AdmissionBatch, AdmissionItem,
                                  DecodeEngine, GenRequest, PartialPrefill,
                                  PrefillEngine, Replica)
from repro_torch.serving.faults import (ReplicaCrashError, RetryPolicy,
                                  TransientTransportError)
from repro_torch.serving.kv_transfer import KVWire
from repro_torch.serving.profiler import WorkloadProfiler
from repro_torch.serving import trace as _trace
from repro_torch.serving.transport import (InProcessTransport, TransferTicket,
                                     Transport)

# -- request lifecycle --------------------------------------------------------
#
# The states and the transition table live in ``serving/protocol.py`` (the
# stdlib-only contract module the model checker binds to); this module
# re-exports them under their historical names. ``_TRANSITIONS`` is the
# SAME object the checker explores — no hand-copied table, so the two
# cannot drift (repro.analysis.modelcheck, DESIGN.md §12).

from repro_torch.serving.protocol import (CANCELLED, DECODING, DONE, FAILED,
                                    PREFILLING, QUEUED, REJECTED,
                                    TERMINAL_STATES, TRANSFERRING)
from repro_torch.serving.protocol import TRANSITIONS as _TRANSITIONS


@dataclass
class ServeRequest:
    """What a client submits: prompt + generation budget + SLO terms."""
    rid: int
    tokens: np.ndarray                   # prompt token ids (1D)
    max_new_tokens: int
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    priority: int = 0                    # higher dispatches first
    ttft_deadline_s: float = math.inf    # relative to submit time
    e2e_deadline_s: float = math.inf

    @classmethod
    def from_gen(cls, req: GenRequest, **kw) -> "ServeRequest":
        return cls(req.rid, req.tokens, req.max_new_tokens,
                   extras=req.extras, **kw)


class RequestHandle:
    """Live view of one request's journey through the gateway.

    Tokens stream into :attr:`tokens` as decode chunks complete (first
    tokens are observable long before ``run_until_drained`` returns);
    ``on_token`` fires per delivered token. Terminal state, a
    human-readable :attr:`reason` for REJECTED/FAILED, and per-request
    TTFT/TPOT/E2E metrics live here — engines never mutate timestamps.
    """

    def __init__(self, request: ServeRequest, gen: GenRequest,
                 gateway: "Gateway",
                 on_token: Optional[Callable[["RequestHandle", int], None]]
                 = None):
        self.request = request
        self.req = gen                   # engine-level unit (owns out_tokens)
        self.tokens: List[int] = []
        self.on_token = on_token
        self.state = QUEUED
        self.reason: Optional[str] = None
        self.restarts = 0
        self.t_submit = gateway.clock()
        self.t_first = -1.0
        self.t_done = -1.0
        self.history: List[Tuple[float, str]] = [(self.t_submit, QUEUED)]
        self._gateway = gateway
        self._engine_seen = 0     # out_tokens consumed from current attempt

    # -- state machine ------------------------------------------------------

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def _transition(self, state: str, now: Optional[float] = None,
                    reason: Optional[str] = None):
        if state == self.state:
            return
        if state not in _TRANSITIONS[self.state]:
            raise RuntimeError(f"illegal transition {self.state} -> {state} "
                               f"for request {self.request.rid}")
        if state in (FAILED, REJECTED) and reason is None:
            raise ValueError(f"{state} requires a reason "
                             f"(request {self.request.rid})")
        now = now if now is not None else self._gateway.clock()
        self.state = state
        self.history.append((now, state))
        if reason is not None:
            self.reason = reason
        if state == DONE:
            self.t_done = now

    def _deliver(self, toks: Sequence[int], now: float):
        for t in toks:
            if self.t_first < 0:
                self.t_first = now
            self.tokens.append(int(t))
            if self.on_token is not None:
                self.on_token(self, int(t))

    def _requeue(self, now: float):
        """Decode-replica failure: KV is gone, go back through prefill.
        The DECODING -> QUEUED edge stays visible in :attr:`history`.
        Already-delivered tokens are KEPT — the restarted attempt's
        regenerated prefix is suppressed in ``_sync_tokens`` so streaming
        consumers never see a duplicate (greedy decoding regenerates the
        identical prefix)."""
        self._transition(QUEUED, now)
        self.restarts += 1
        self.req.out_tokens = []
        self._engine_seen = 0

    # -- client API ---------------------------------------------------------

    def cancel(self) -> bool:
        """Abort the request; frees its decode slot if mid-decode."""
        return self._gateway.cancel(self)

    def stream(self, *, max_iters: int = 100000) -> Iterator[int]:
        """Yield tokens as they are produced, pumping the gateway while
        waiting. Returns when the request reaches a terminal state."""
        sent = 0
        it = 0
        while True:
            while sent < len(self.tokens):
                yield self.tokens[sent]
                sent += 1
            if self.is_terminal:
                return
            if it >= max_iters:
                raise RuntimeError(f"request {self.request.rid} stalled in "
                                   f"{self.state}")
            self._gateway.pump()
            it += 1

    def result(self, *, max_iters: int = 100000) -> List[int]:
        """Block (pumping the gateway) until terminal; returns the tokens."""
        for _ in self.stream(max_iters=max_iters):
            pass
        return list(self.tokens)

    # -- metrics ------------------------------------------------------------

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit if self.t_first > 0 else math.nan

    @property
    def e2e(self) -> float:
        return self.t_done - self.t_submit if self.t_done > 0 else math.nan

    @property
    def tpot(self) -> float:
        if self.t_done < 0 or self.t_first < 0 or len(self.tokens) <= 1:
            return math.nan
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)

    def metrics(self) -> Dict[str, object]:
        r = self.request
        return {"rid": r.rid, "state": self.state, "reason": self.reason,
                "n_tokens": len(self.tokens), "restarts": self.restarts,
                "ttft_s": self.ttft, "tpot_s": self.tpot, "e2e_s": self.e2e,
                "ttft_met": (self.state == DONE
                             and self.ttft <= r.ttft_deadline_s),
                "e2e_met": (self.state == DONE
                            and self.e2e <= r.e2e_deadline_s)}


# -- scheduler configuration --------------------------------------------------


@dataclass(frozen=True)
class SchedulerConfig:
    """Token-budget scheduler knobs in ONE place (replaces the scattered
    ``pump(max_prefill_batch=...)`` kwarg and per-call admission tuning).

    ``prefill_chunk_tokens = 0`` keeps the legacy one-shot prefill; any
    positive budget turns each pump tick into a SARATHI-style schedule:
    up to that many prompt tokens of pending prefill run per prefill
    replica per tick (long prompts split across ticks, short prompts slip
    in between their chunks), then every decode replica advances one
    chunk. The dispatch order is ``priority_weight * priority +
    age_weight * seconds_waited`` (descending; FIFO tiebreak), so the
    defaults reproduce the old ``(-priority, t_submit)`` sort. Within a
    chunk tick the SAME key orders the in-flight job set, with
    shortest-remaining-prefill breaking ties — a freshly injected short
    prompt finishes inside its first tick instead of queueing its whole
    budget share behind a long prompt's leftover chunks (raise
    ``age_weight`` if long prompts must not yield under sustained
    short-prompt pressure)."""
    prefill_chunk_tokens: int = 0    # 0 = one-shot prefill (legacy)
    max_prefill_batch: int = 4       # concurrent prompts per prefill call
    decode_chunk_steps: int = 0      # 0 = the engine's own chunk_size
    priority_weight: float = 1.0
    age_weight: float = 0.0


# -- replica clients ----------------------------------------------------------


class PrefillClient(Protocol):
    """Everything the gateway needs from a prefill replica. A multi-host
    deployment implements this over RPC; the prompt goes out, wires and
    first tokens come back."""

    def prefill(self, reqs: List[GenRequest], *, compress: bool,
                backend: str) -> List[Tuple[GenRequest, KVWire, int]]:
        ...

    def prefill_chunk(self, jobs: List[PartialPrefill], budget: int, *,
                      compress: bool, backend: str) -> List[PartialPrefill]:
        """Advance chunked prefills by up to ``budget`` prompt tokens
        total; completed jobs come back ``done`` with their first token
        (RPC realization: jobs are sticky to this replica — the
        accumulated chunk wires live here)."""
        ...


class DecodeClient(Protocol):
    """Everything the gateway needs from a decode replica."""

    def admit(self, batch: AdmissionBatch, *,
              backend: str) -> AdmissionBatch:
        """THE admission call: one FIFO pass over typed items (FRESH |
        CHUNKED | PREFIX_HIT | MIGRATED — see ``engine.AdmissionItem``);
        returns the rejected tail. The RPC mapping is one request
        carrying per-item sources (DESIGN.md §5). The legacy
        ``admit_batch``/``admit_prefix``/``admit_migrated`` variants are
        DELETED — lint rule R003 bans reintroducing them."""
        ...

    def step(self, n_steps: Optional[int] = None) -> List[GenRequest]:
        ...

    def n_free(self) -> int:
        """Admissible request count. This is CAPACITY, not slot count:
        paged engines (DESIGN.md §7) report their page-budget headroom
        here, so dispatch and deadline shedding follow real KV memory
        instead of a worst-case ``max_slots x max_seq`` slab."""
        ...

    @property
    def active(self) -> int:
        ...

    def resident(self) -> List[GenRequest]:
        ...

    def release(self, req: GenRequest) -> bool:
        ...

    def extract_resident(self, *, compress: bool, backend: str):
        """(slot, req, wire, cur_token) snapshot of every resident request
        — the migration source side of a preemption drain (re-admitted on
        the target as MIGRATED items through :meth:`admit`)."""
        ...

    def page_stats(self) -> Optional[Dict[str, float]]:
        """Page-pool counters (incl. ``leaked_pages``) for paged engines;
        None for dense ones. The observability seam ``Gateway.stats()``
        aggregates — NOT an engine attribute reach-through (rule R003)."""
        ...

    # Prefix-cache seam (optional — the gateway getattr-guards every
    # call, so clients without sharing simply never match):
    #   prefix_match(tokens) -> Optional[PrefixMatch]
    #   prefix_pin(pages, tag) -> bool / prefix_unpin(tag)
    #   extract_prefix(pages, length) -> KVWire


class LocalPrefillClient:
    """In-process realization around a :class:`PrefillEngine`."""

    synchronous = True      # a blocking call that returns proves liveness

    def __init__(self, engine: PrefillEngine):
        self.engine = engine

    def prefill(self, reqs, *, compress, backend):
        return self.engine.run(reqs, compress=compress, backend=backend)

    def prefill_chunk(self, jobs, budget, *, compress, backend):
        return self.engine.prefill_chunk(jobs, budget, compress=compress,
                                         backend=backend)

    def supports_suffix(self) -> bool:
        return self.engine.supports_suffix

    def jit_cache_size(self) -> int:
        return self.engine.jit_cache_size


class LocalDecodeClient:
    """In-process realization around a :class:`DecodeEngine`."""

    synchronous = True      # a blocking call that returns proves liveness

    def __init__(self, engine: DecodeEngine):
        self.engine = engine

    def admit(self, batch, *, backend):
        return self.engine.admit(batch, backend=backend)

    def step(self, n_steps=None):
        return self.engine.step(n_steps)

    def n_free(self) -> int:
        return len(self.engine.free_slots())

    @property
    def active(self) -> int:
        return self.engine.active

    def resident(self):
        return [r for r in self.engine.slots if r is not None]

    def release(self, req) -> bool:
        for i, r in enumerate(self.engine.slots):
            if r is req:
                self.engine.release(i)
                return True
        return False

    def extract_resident(self, *, compress, backend):
        return self.engine.extract_resident(compress=compress,
                                            backend=backend)

    def page_stats(self):
        ps = getattr(self.engine, "page_stats", None)
        return ps() if callable(ps) else None

    def prefix_match(self, tokens):
        return self.engine.prefix_match(tokens)

    def prefix_pin(self, pages, tag) -> bool:
        return self.engine.prefix_pin(pages, tag)

    def prefix_unpin(self, tag):
        self.engine.prefix_unpin(tag)

    def extract_prefix(self, pages, length):
        return self.engine.extract_prefix(pages, length)

    def jit_cache_size(self) -> int:
        return self.engine.jit_cache_size


class LocalReplicaClient:
    """In-process client around a phase-switchable :class:`Replica`.

    Implements BOTH :class:`PrefillClient` and :class:`DecodeClient`,
    delegating to whichever engine the replica currently hosts, plus the
    ``switch_phase`` seam an epoch transition needs. A remote realization
    would implement the same surface over RPC (the flip is an in-place
    role change on the remote pod — the paper's no-reload trick — not a
    redeploy)."""

    synchronous = True      # a blocking call that returns proves liveness

    def __init__(self, replica: Replica):
        self.replica = replica

    @property
    def engine(self):
        return self.replica.engine

    @property
    def phase(self) -> str:
        return self.replica.phase

    def switch_phase(self, phase: Optional[str] = None):
        return self.replica.switch_phase(phase)

    def _require(self, phase: str):
        if self.replica.phase != phase:
            raise RuntimeError(
                f"replica is designated {self.replica.phase!r}, "
                f"cannot serve a {phase!r} call (stale routing after an "
                f"epoch transition?)")
        return self.replica.engine

    # -- PrefillClient -------------------------------------------------------

    def prefill(self, reqs, *, compress, backend):
        return self._require("prefill").run(reqs, compress=compress,
                                            backend=backend)

    def prefill_chunk(self, jobs, budget, *, compress, backend):
        return self._require("prefill").prefill_chunk(
            jobs, budget, compress=compress, backend=backend)

    def supports_suffix(self) -> bool:
        return (self.replica.phase == "prefill"
                and self.replica.engine.supports_suffix)

    # -- DecodeClient --------------------------------------------------------

    def admit(self, batch, *, backend):
        return self._require("decode").admit(batch, backend=backend)

    def step(self, n_steps=None):
        return self._require("decode").step(n_steps)

    def n_free(self) -> int:
        return len(self._require("decode").free_slots())

    @property
    def active(self) -> int:
        return self._require("decode").active

    def resident(self):
        return [r for r in self._require("decode").slots if r is not None]

    def release(self, req) -> bool:
        eng = self._require("decode")
        for i, r in enumerate(eng.slots):
            if r is req:
                eng.release(i)
                return True
        return False

    def extract_resident(self, *, compress, backend):
        return self._require("decode").extract_resident(compress=compress,
                                                        backend=backend)

    def page_stats(self):
        ps = getattr(self._require("decode"), "page_stats", None)
        return ps() if callable(ps) else None

    def prefix_match(self, tokens):
        return self._require("decode").prefix_match(tokens)

    def prefix_pin(self, pages, tag) -> bool:
        return self._require("decode").prefix_pin(pages, tag)

    def prefix_unpin(self, tag):
        self._require("decode").prefix_unpin(tag)

    def extract_prefix(self, pages, length):
        return self._require("decode").extract_prefix(pages, length)

    def jit_cache_size(self) -> int:
        return self.replica.engine.jit_cache_size


def _as_prefill_client(obj) -> PrefillClient:
    if isinstance(obj, Replica):
        return LocalReplicaClient(obj)
    return LocalPrefillClient(obj) if isinstance(obj, PrefillEngine) else obj


def _as_decode_client(obj) -> DecodeClient:
    if isinstance(obj, Replica):
        return LocalReplicaClient(obj)
    return LocalDecodeClient(obj) if isinstance(obj, DecodeEngine) else obj


@dataclass
class ReplicaHandle:
    """Gateway-side view of one replica: liveness + latency tracking.

    The failure detector is status-based (DESIGN.md §8):

    * ``alive`` — in the routing tables, taking new work;
    * ``suspected`` — kept OUT of routing (missed heartbeats or a
      latency outlier) but still stepped: resident requests finish, and
      recovery (a fresh beat / a healthy latency sample / a probe) flips
      it back to alive. Suspicion is cheap to be wrong about;
    * ``draining`` — spot-preemption notice received, admissions
      stopped, resident KV migrating out (transient, within
      ``handle_preemption``);
    * ``dead`` — confirmed: requests recovered, failover reschedule
      queued. Death is terminal for the handle.

    ``group`` is the replica's device-group identity from the deployment
    plan (the stable key across plan epochs); it is None for plan-less
    gateways built from bare engine lists, which then cannot take live
    epoch transitions."""
    idx: int
    phase: str
    client: object
    status: str = "alive"
    suspect_why: Optional[str] = None   # "heartbeat" | "latency"
    group: Optional[Tuple[int, ...]] = None
    last_heartbeat: float = 0.0   # gateway stamps clock() at construction
    last_track: float = 0.0             # last latency observation
    ema_latency: float = 0.0            # straggler tracking
    min_latency: float = math.inf       # lower bound for deadline shedding

    @property
    def alive(self) -> bool:
        """Not confirmed-dead (suspected/draining replicas still count —
        they hold live state). Pre-dating the status model; new code
        should test ``status`` directly."""
        return self.status != "dead"

    @alive.setter
    def alive(self, v: bool):
        self.status = "alive" if v else "dead"

    @property
    def dispatchable(self) -> bool:
        """May take NEW work (suspected replicas are excluded until they
        recover; draining/dead never come back)."""
        return self.status == "alive"

    def beat(self, now: float):
        """Record a liveness signal at gateway-clock time ``now`` (always
        caller-supplied — the handle has no clock of its own, rule R001)."""
        self.last_heartbeat = now
        # a beat refutes heartbeat-sourced suspicion only: latency
        # suspicion clears on a healthy sample or a probe, not on beats
        # (sync clients beat every pump)
        if self.status == "suspected" and self.suspect_why == "heartbeat":
            self.status = "alive"
            self.suspect_why = None

    @property
    def engine(self):
        """Underlying in-process engine, when there is one (local clients
        only — an RPC client has no engine attribute)."""
        return getattr(self.client, "engine", None)

    @property
    def switchable(self) -> bool:
        return hasattr(self.client, "switch_phase")


@dataclass
class _Transfer:
    handle: RequestHandle
    ticket: Optional[TransferTicket]   # None: nothing moves (full prefix hit)
    first: int               # first token (normal) / resume token (migrated)
    target: int
    migrated: bool = False   # mid-stream KV migration, not a fresh prefill
    chunked: bool = False    # wire spliced from prefill chunks
    # full prefix-cache hit: the "wire" is a handle onto pages already
    # resident on ``target`` — admission shares the chain, zero transfer
    prefix_full: bool = False
    prefix_pages: Optional[List[int]] = None

    @property
    def replica_bound(self) -> bool:
        """True when this transfer only makes sense on its target replica
        (page handles / suffix wires splicing onto pinned pages) — it is
        never rerouted, only requeued through prefill."""
        return self.prefix_full or self.handle.req.start_pos > 0

    def admission_item(self) -> AdmissionItem:
        """The typed item this transfer becomes at the decode boundary."""
        if self.prefix_full:
            return AdmissionItem(self.handle.req, int(self.first),
                                 ADMIT_PREFIX_HIT,
                                 pages=list(self.prefix_pages or []))
        src = (ADMIT_MIGRATED if self.migrated
               else ADMIT_CHUNKED if self.chunked else ADMIT_FRESH)
        return AdmissionItem(self.handle.req, int(self.first), src,
                             wire=self.ticket.wire)


@dataclass
class _ChunkJob:
    """An in-flight chunked prefill, sticky to the prefill replica whose
    jit caches (and accumulated chunk wires) it lives on."""
    handle: RequestHandle
    partial: PartialPrefill
    pre: ReplicaHandle


@dataclass
class _RetrySend:
    """A KV send that hit a transient transport fault, waiting out its
    backoff before the next attempt."""
    handle: RequestHandle
    wire: KVWire
    first: int
    src: int                 # prefill replica that produced the wire
    attempt: int             # next attempt number (1-based)
    not_before: float


# -- the gateway --------------------------------------------------------------


class Gateway:
    """Request-lifecycle facade over phase-split serving replicas.

    Owns TSTP routing (X/Y masses from the orchestration), heartbeat
    failure detection, straggler-aware routing refresh, workload-shift
    rescheduling, deadline admission control, and the prefill ->
    transport -> decode pipeline. One ``pump()`` is one event-loop
    iteration; ``run_until_drained()`` drives until every submitted
    request reaches a terminal state.
    """

    def __init__(self, prefills: Sequence, decodes: Sequence, *,
                 transport: Optional[Transport] = None,
                 orchestration: Optional[Orchestration] = None,
                 plan=None, compress: bool = True, backend: str = "auto",
                 heartbeat_timeout: float = 10.0, seed: int = 0,
                 profiler: Optional[WorkloadProfiler] = None,
                 clock: Callable[[], float] = time.time,
                 retry: Optional[RetryPolicy] = None,
                 max_restarts: int = 5,
                 suspect_timeout: Optional[float] = None,
                 suspect_latency_factor: float = 4.0,
                 suspect_probe_s: float = 1.0,
                 scheduler: Optional[SchedulerConfig] = None):
        self.clock = clock               # injectable time source (faults.py)
        self.scheduler = scheduler or SchedulerConfig()
        self.pre = [ReplicaHandle(i, "prefill", _as_prefill_client(e),
                                  last_heartbeat=clock())
                    for i, e in enumerate(prefills)]
        self.dec = [ReplicaHandle(j, "decode", _as_decode_client(e),
                                  last_heartbeat=clock())
                    for j, e in enumerate(decodes)]
        self.transport: Transport = transport or InProcessTransport(
            clock=clock)
        self.plan = plan                 # current DeploymentPlan, if bound
        self.epoch = 0                   # bumped by every apply_plan
        if plan is not None:
            self._bind_plan_groups(plan)
        self.o = orchestration if orchestration is not None else (
            plan.orchestration if plan is not None else None)
        self.compress = compress
        self.backend = backend
        self.heartbeat_timeout = heartbeat_timeout
        # suspected-slow threshold: missing beats for half the death
        # timeout parks a replica out of routing before it is declared dead
        self.suspect_timeout = (suspect_timeout if suspect_timeout is not None
                                else heartbeat_timeout / 2.0)
        self.suspect_latency_factor = suspect_latency_factor
        self.suspect_probe_s = suspect_probe_s
        self.rng = np.random.default_rng(seed)
        self.profiler = profiler or WorkloadProfiler(clock=clock)
        self.queue: List[RequestHandle] = []
        self.transfer_queue: List[_Transfer] = []
        self._chunks: List[_ChunkJob] = []   # in-flight chunked prefills
        self.n_chunk_ticks = 0               # prefill_chunk calls issued
        self.n_chunked_prefills = 0          # prompts completed chunked
        self.done: List[RequestHandle] = []
        self.events: List[str] = []
        self._by_req: Dict[int, RequestHandle] = {}   # id(GenRequest) -> h
        self._decode_outage_reported = False
        # fault tolerance (DESIGN.md §8)
        self.retry = retry or RetryPolicy()
        self.retry_queue: List[_RetrySend] = []
        self._retry_rng = _random.Random(seed)
        self.max_restarts = max_restarts
        self.chaos = None                # set by faults.install_chaos
        self._failover = None            # set by set_failover
        self._pending_failover = False
        # counters surfaced by stats()
        self.n_retries = 0
        self.n_requeues = 0
        self.n_migrations = 0
        self.n_migrated_tokens = 0
        self.n_failed = 0
        self.n_preemptions = 0
        # prefix cache (DESIGN.md §10): submit-time radix matches
        self.n_prefix_hits = 0          # full: prefill skipped entirely
        self.n_prefix_partial = 0       # suffix-only prefill
        self.n_prefix_miss = 0
        self.n_prefix_tokens_hit = 0    # prompt tokens whose KV was reused
        self._pins: Dict[int, Tuple[ReplicaHandle, object]] = {}  # rid ->
        # runtime sanitizers (REPRO_SANITIZE=1): lazy import keeps the
        # analysis package out of the hot path when disabled
        self.sanitizer = None
        if os.environ.get("REPRO_SANITIZE", "").strip() not in (
                "", "0", "false", "no"):
            from repro_torch.analysis.sanitizers import GatewaySanitizer
            self.sanitizer = GatewaySanitizer()

    def _bind_plan_groups(self, plan):
        """Tag live replica handles with their plan device groups (matched
        positionally: i-th prefill handle <-> i-th prefill replica plan)."""
        if (len(self.pre) != len(plan.prefill_replicas)
                or len(self.dec) != len(plan.decode_replicas)):
            raise ValueError(
                f"plan/replica mismatch: plan has "
                f"{len(plan.prefill_replicas)}P/{len(plan.decode_replicas)}D,"
                f" gateway has {len(self.pre)}P/{len(self.dec)}D")
        for h, r in zip(self.pre, plan.prefill_replicas):
            h.group = sched._group_key(r.devices)
        for h, r in zip(self.dec, plan.decode_replicas):
            h.group = sched._group_key(r.devices)

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _routable(handles: Sequence[ReplicaHandle]) -> np.ndarray:
        """Routing mask: healthy replicas first; if suspicion emptied the
        fleet, fall back to the suspected ones (slow beats unserved) —
        draining/dead replicas never take new work."""
        m = np.array([h.status == "alive" for h in handles], float)
        if m.sum() == 0:
            m = np.array([h.status == "suspected" for h in handles], float)
        return m

    def _X(self) -> np.ndarray:
        alive = self._routable(self.pre)
        if self.o is not None and self.o.X.shape[0] == len(self.pre):
            x = self.o.X * alive
        else:
            x = alive
        s = x.sum()
        return x / s if s > 0 else alive / max(alive.sum(), 1)

    def _Y(self, i: int) -> np.ndarray:
        alive = self._routable(self.dec)
        if self.o is not None and self.o.Y.shape == (len(self.pre),
                                                     len(self.dec)):
            y = self.o.Y[i] * alive
        else:
            y = alive
        s = y.sum()
        return y / s if s > 0 else alive / max(alive.sum(), 1)

    # -- request lifecycle --------------------------------------------------

    def submit(self, request, *,
               on_token: Optional[Callable[[RequestHandle, int], None]]
               = None) -> RequestHandle:
        """Admit a request into the gateway; returns its live handle.

        Accepts a :class:`ServeRequest` (the v2 API) or a bare
        :class:`GenRequest` (deprecated shim path: no deadlines, default
        priority)."""
        if isinstance(request, GenRequest):
            gen = request
            request = ServeRequest.from_gen(gen)
        else:
            gen = GenRequest(request.rid,
                             np.asarray(request.tokens, np.int32),
                             request.max_new_tokens,
                             extras=dict(request.extras))
        h = RequestHandle(request, gen, self, on_token=on_token)
        gen.t_submit = h.t_submit
        self.profiler.record_arrival(h.t_submit)
        self._by_req[id(gen)] = h
        # radix-match the prompt against resident prefixes BEFORE
        # dispatch: a full hit skips prefill entirely (QUEUED ->
        # TRANSFERRING with a page handle); a partial hit annotates the
        # request so prefill covers only the suffix
        if self._try_prefix(h):
            return h
        self.queue.append(h)
        return h

    # -- prefix cache (DESIGN.md §10) ----------------------------------------

    def _try_prefix(self, h: RequestHandle) -> bool:
        """Match ``h``'s prompt against every dispatchable decode
        replica's radix index. Returns True when the request was placed
        on the transfer queue as a FULL hit (caller must not queue it);
        a partial hit pins the prefix chain and annotates the request,
        which still goes through (suffix) prefill."""
        gen = h.req
        if len(gen.tokens) == 0:
            return False
        best: Optional[Tuple[object, int]] = None
        for j, d in enumerate(self.dec):
            if not d.dispatchable:
                continue
            pm = getattr(d.client, "prefix_match", None)
            if not callable(pm):
                continue
            m = pm(gen.tokens)
            if m is None:
                continue
            if best is None or (m.full, m.length) > (best[0].full,
                                                     best[0].length):
                best = (m, j)
        plen = len(gen.tokens)
        if best is None:
            self.n_prefix_miss += 1
            self.profiler.record_prefix(plen, 0)
            return False
        m, j = best
        d = self.dec[j]
        tag = ("prefix-pin", gen.rid)
        if not m.full:
            # partial hits need a prefill replica that can run a suffix
            if not any(p.dispatchable and self._suffix_ok(p)
                       for p in self.pre):
                self.n_prefix_miss += 1
                self.profiler.record_prefix(plen, 0)
                return False
        if not d.client.prefix_pin(m.pages, tag):
            self.n_prefix_miss += 1
            self.profiler.record_prefix(plen, 0)
            return False
        self._pins[gen.rid] = (d, tag)
        self.n_prefix_tokens_hit += m.length
        self.profiler.record_prefix(plen, m.length)
        if m.full:
            self.n_prefix_hits += 1
            h._transition(TRANSFERRING, self.clock())
            self.transfer_queue.append(_Transfer(
                h, None, int(m.next_token), j, prefix_full=True,
                prefix_pages=list(m.pages)))
            self.events.append(
                f"request {gen.rid}: full prefix hit ({m.length} tokens "
                f"resident on decode:{j}); prefill skipped")
            return True
        self.n_prefix_partial += 1
        gen.start_pos = m.length
        gen.prefix_pages = list(m.pages)
        gen.prefix_replica = j
        gen.prefix_wire = d.client.extract_prefix(m.pages, m.length)
        self.events.append(
            f"request {gen.rid}: partial prefix hit ({m.length}/{plen} "
            f"tokens resident on decode:{j}); suffix prefill only")
        return False

    @staticmethod
    def _suffix_ok(p: ReplicaHandle) -> bool:
        sup = getattr(p.client, "supports_suffix", None)
        return bool(sup()) if callable(sup) else False

    def _release_prefix(self, h: RequestHandle):
        """Drop ``h``'s pin (if any) and clear its prefix annotations so
        a requeued attempt goes through a normal full prefill."""
        rec = self._pins.pop(h.request.rid, None)
        if rec is not None:
            d, tag = rec
            if d.status != "dead":
                try:
                    d.client.prefix_unpin(tag)
                except Exception:
                    pass    # replica flipped/died mid-release: engine-side
                            # clear_prefix dropped the pin already
        h.req.start_pos = 0
        h.req.prefix_pages = None
        h.req.prefix_wire = None
        h.req.prefix_replica = -1

    def cancel(self, h: RequestHandle) -> bool:
        """Abort a request in any non-terminal state; a mid-decode cancel
        releases the slot (and its cache length) immediately."""
        if h.is_terminal:
            return False
        now = self.clock()
        if h in self.queue:
            self.queue.remove(h)
        self.transfer_queue = [t for t in self.transfer_queue
                               if t.handle is not h]
        self.retry_queue = [r for r in self.retry_queue
                            if r.handle is not h]
        self._chunks = [c for c in self._chunks if c.handle is not h]
        if h.state == DECODING:
            for d in self.dec:
                if d.client.release(h.req):
                    break
        self._release_prefix(h)
        h._transition(CANCELLED, now, reason="cancelled by client")
        self._finish(h)
        self.events.append(f"request {h.request.rid} cancelled "
                           f"({h.history[-2][1].lower()})")
        return True

    # -- admission control --------------------------------------------------

    def _min_prefill_estimate(self) -> float:
        """Best-case seconds of work between *now* and the first token for
        a request still in the queue: the fastest latency EVER observed on
        an alive prefill replica plus the smallest transport hop ever
        paid. Minima — not EMAs, which one jit-compile spike would inflate
        — and unmeasured components count as zero, so shedding stays
        conservative. Caveat: the minima are conditioned on the batch /
        bucket / wire shapes actually served so far; a request much
        smaller than everything previously observed could in principle
        beat them (the estimate is the tightest bound available without a
        per-shape cost model)."""
        mins = [r.min_latency for r in self.pre
                if r.alive and math.isfinite(r.min_latency)]
        est = min(mins) if mins else 0.0
        est += getattr(self.transport, "min_delay_s", 0.0) or 0.0
        return est

    def _shed_expired(self, now: float):
        if not self.queue:
            return
        est = self._min_prefill_estimate()
        keep = []
        for h in self.queue:
            dl = h.request.ttft_deadline_s
            waited = now - h.t_submit
            if math.isfinite(dl) and waited + est > dl:
                h._transition(
                    REJECTED, now,
                    reason=(f"TTFT deadline provably missed while queued: "
                            f"waited {waited:.3f}s + best-case "
                            f"{est:.3f}s > deadline {dl:.3f}s"))
                self._finish(h)
                self.events.append(
                    f"request {h.request.rid} rejected: ttft deadline")
            else:
                keep.append(h)
        self.queue = keep

    # -- event loop ---------------------------------------------------------

    def pump(self, *, max_prefill_batch: Optional[int] = None) -> int:
        """One token-budget scheduler tick; returns #finished this round.

        With ``scheduler.prefill_chunk_tokens > 0`` each tick packs up to
        that many prompt tokens of pending prefill per prefill replica
        (chunked — a long prompt spreads over many ticks while short
        prompts behind it complete and reach decode in between) plus one
        decode chunk per decode replica, with transfers admitted and
        finished slots evicted at the chunk boundary in between. With a
        zero budget, prefill is one-shot per prompt (legacy behavior).

        ``max_prefill_batch`` is a DEPRECATED one-PR override of
        ``scheduler.max_prefill_batch``."""
        with _trace.span("pump"):
            with _trace.span("pump.housekeeping"):
                if self.chaos is not None:
                    self.chaos.tick(self.clock())
                if self._pending_failover:
                    self._run_failover()
                now = self.clock()
                self._check_heartbeats()
                self._update_suspects(now)
                self._shed_expired(now)
                self._flush_retries(now)
            # 1. dispatch queued prompts: drain EVERY routable prefill
            #    replica this round (the TSTP masses only order who gets
            #    fed first)
            batch_cap = (max_prefill_batch if max_prefill_batch is not None
                         else self.scheduler.max_prefill_batch)
            if self.queue or self._chunks:
                with _trace.span("pump.dispatch"):
                    self._dispatch_round(batch_cap, now)
            # 2. drain KV transfers whose wires have arrived into decode
            #    slots (prefill-side queueing: wires wait here if the
            #    target has no free slot, cf. Appendix E)
            with _trace.span("pump.transfers"):
                self._drain_transfers()
            # 3. advance every decode replica one chunk of steps; stream
            #    every newly emitted token to its handle
            with _trace.span("pump.decode"):
                return self._step_decodes()

    def _dispatch_round(self, batch_cap: int, now: float):
        if self.queue:
            w_p = self.scheduler.priority_weight
            w_a = self.scheduler.age_weight
            self.queue.sort(key=lambda h: (
                -(w_p * h.request.priority + w_a * (now - h.t_submit)),
                h.t_submit))
        X = self._X()
        cand = [i for i in range(len(self.pre))
                if self.pre[i].alive and X[i] > 0]
        if len(cand) > 1:
            p = X[cand] / X[cand].sum()
            cand = [int(i) for i in self.rng.choice(
                cand, size=len(cand), replace=False, p=p)]
        budget = self.scheduler.prefill_chunk_tokens
        for i in cand:
            if not self.queue and not self._chunks:
                break
            if budget > 0 and self._suffix_ok(self.pre[i]):
                self._pump_chunks(self.pre[i], batch_cap, budget)
            elif self.queue:
                batch = self.queue[:batch_cap]
                self.queue = self.queue[batch_cap:]
                self._dispatch_prefill(i, batch)

    def _pump_chunks(self, pre: ReplicaHandle, batch_cap: int,
                     budget: int):
        """One chunked-prefill tick on replica ``pre``: top up its active
        job set from the queue (injection happens HERE, at a chunk
        boundary — no prompt waits for another prompt to finish), run one
        ``prefill_chunk`` call of up to ``budget`` tokens, and ship a
        spliced wire for every prompt that completed."""
        mine = [c for c in self._chunks if c.pre is pre]
        while self.queue and len(mine) < batch_cap:
            h = self.queue.pop(0)
            if h.req.start_pos > 0:
                # stale partial-hit annotation: only honored while the
                # pinned decode replica still takes work
                j = h.req.prefix_replica
                if not (0 <= j < len(self.dec)) \
                        or not self.dec[j].dispatchable:
                    self._release_prefix(h)
            h._transition(PREFILLING, self.clock())
            c = _ChunkJob(h, PartialPrefill(h.req), pre)
            self._chunks.append(c)
            mine.append(c)
        if not mine:
            return
        t0 = self.clock()
        # budget flows in dispatch-priority order, shortest remaining
        # prefill first among ties: a short prompt injected this tick
        # completes NOW, the long prompt soaks up the leftover budget
        mine.sort(key=lambda c: (
            -(self.scheduler.priority_weight * c.handle.request.priority
              + self.scheduler.age_weight * (t0 - c.handle.t_submit)),
            c.partial.remaining, c.handle.t_submit))
        try:
            pre.client.prefill_chunk([c.partial for c in mine], budget,
                                     compress=self.compress,
                                     backend=self.backend)
        except ReplicaCrashError as e:
            self._confirm_dead(pre, str(e))
            now = self.clock()
            for c in mine:
                if c in self._chunks:
                    self._chunks.remove(c)
                self._requeue_handle(c.handle, now,
                                     f"prefill:{pre.idx} crashed mid-chunk")
            return
        t1 = self.clock()
        self.n_chunk_ticks += 1
        self._track(pre, t1 - t0, t1)
        for c in mine:
            if not c.partial.done:
                continue
            self._chunks.remove(c)
            self.n_chunked_prefills += 1
            c.handle._transition(TRANSFERRING, t1)
            self._send_wire(c.handle, c.partial.wire(), c.partial.first,
                            pre.idx, t1, chunked=True)

    def _dispatch_prefill(self, i: int, batch: List[RequestHandle]):
        t0 = self.clock()
        suffix_ok = self._suffix_ok(self.pre[i])
        for h in batch:
            if h.req.start_pos > 0:
                # partial-hit annotation is only honored when this prefill
                # replica can run a suffix AND the pinned decode replica
                # is still taking work — otherwise fall back to a full
                # prefill before any suffix wire exists
                j = h.req.prefix_replica
                if (not suffix_ok or not (0 <= j < len(self.dec))
                        or not self.dec[j].dispatchable):
                    self._release_prefix(h)
            h._transition(PREFILLING, t0)
        try:
            results = self.pre[i].client.prefill(
                [h.req for h in batch], compress=self.compress,
                backend=self.backend)
        except ReplicaCrashError as e:
            now = self.clock()
            self._confirm_dead(self.pre[i], str(e))
            for h in batch:
                self._requeue_handle(h, now, f"prefill:{i} crashed")
            return
        t1 = self.clock()
        self._track(self.pre[i], t1 - t0, t1)
        for req, wire, first in results:
            h = self._by_req[id(req)]
            h._transition(TRANSFERRING, t1)
            self._send_wire(h, wire, first, i, t1)

    # -- transient-fault retry (bounded backoff + jitter) --------------------

    def _send_wire(self, h: RequestHandle, wire: KVWire, first: int,
                   src: int, now: float, attempt: int = 0,
                   chunked: bool = False):
        """Ship one wire toward a routable decode replica. A transient
        transport fault schedules a retry instead of losing the request;
        with no alive decode replica the target is a placeholder and
        ``_drain_transfers`` holds the wire + events."""
        if h.req.start_pos > 0:
            # suffix wire: only the replica holding the pinned prefix
            # chain can splice it — no TSTP routing choice to make
            j = h.req.prefix_replica
            if not (0 <= j < len(self.dec)) \
                    or not self.dec[j].dispatchable:
                self._requeue_handle(h, now, "(pinned prefix replica "
                                             "lost mid-transfer)")
                return
        else:
            Y = self._Y(src)
            j = (int(self.rng.choice(len(self.dec), p=Y))
                 if Y.sum() > 0 else 0)
        try:
            ticket = self.transport.send(wire, src, j, now=now)
        except TransientTransportError as e:
            self._schedule_retry(h, wire, first, src, attempt, now, str(e))
            return
        self.transfer_queue.append(
            _Transfer(h, ticket, first, j, chunked=chunked))

    def _schedule_retry(self, h: RequestHandle, wire: KVWire, first: int,
                        src: int, attempt: int, now: float, why: str):
        if attempt >= self.retry.max_retries:
            self.events.append(f"request {h.request.rid}: transfer retries "
                               f"exhausted after {attempt} attempt(s)")
            self._requeue_handle(h, now, "transfer retries exhausted")
            return
        delay = self.retry.delay_s(attempt, self._retry_rng)
        self.retry_queue.append(
            _RetrySend(h, wire, first, src, attempt + 1, now + delay))
        self.n_retries += 1
        self.events.append(f"request {h.request.rid}: transfer retry "
                           f"{attempt + 1} in {delay * 1e3:.0f}ms ({why})")

    def _flush_retries(self, now: float):
        if not self.retry_queue:
            return
        due, later = [], []
        for r in self.retry_queue:
            if r.handle.is_terminal:
                continue             # cancelled while backing off
            (due if r.not_before <= now else later).append(r)
        self.retry_queue = later
        for r in due:
            self._send_wire(r.handle, r.wire, r.first, r.src, now,
                            attempt=r.attempt)

    def _drain_transfers(self):
        if not self.transfer_queue:
            return
        now = self.clock()
        arrived = [t for t in self.transfer_queue
                   if t.ticket is None or t.ticket.ready(now)]
        in_flight = [t for t in self.transfer_queue
                     if not (t.ticket is None or t.ticket.ready(now))]
        if not arrived:
            return
        usable = [j for j, d in enumerate(self.dec) if d.dispatchable]
        if not usable:
            # do NOT silently reroute to replica 0 (it is dead too) — keep
            # the wires queued and surface the outage once
            if not self._decode_outage_reported:
                self.events.append(
                    "all decode replicas dead; KV transfers stalled")
                self._decode_outage_reported = True
            self.transfer_queue = in_flight + arrived
            return
        self._decode_outage_reported = False
        by_target: Dict[int, List[_Transfer]] = {}
        for t in arrived:
            j = t.target
            if not self.dec[j].dispatchable:
                if t.replica_bound:
                    # the pinned pages died with the replica: page handles
                    # and suffix wires cannot reroute — back through a
                    # full prefill (pin dropped, annotations cleared)
                    self._requeue_handle(
                        t.handle, now,
                        f"(prefix replica decode:{j} lost)")
                    continue
                # reroute to the healthy replica with the most free slots
                j = max(usable, key=lambda jj: self.dec[jj].client.n_free())
            by_target.setdefault(j, []).append(t)
        still = in_flight
        for j, items in by_target.items():
            # one admission RPC per target, source-typed per item — the
            # engine places what fits FIFO and hands back the rejected
            # tail, which stays queued until capacity frees up (full
            # prefix hits need no wire: the chain is shared into a fresh
            # slot, COW if the prompt ends mid-page, so TTFT is pure
            # queueing)
            pfx = [t for t in items if t.prefix_full]
            mig = [t for t in items if t.migrated]
            norm = [t for t in items
                    if not t.migrated and not t.prefix_full]
            ordered = pfx + norm + mig
            try:
                rejected = self.dec[j].client.admit(
                    AdmissionBatch([t.admission_item() for t in ordered]),
                    backend=self.backend)
            except ReplicaCrashError as e:
                self._confirm_dead(self.dec[j], str(e))
                still.extend(ordered)        # retry next pump
                continue
            rej = {id(it.req) for it in rejected.items}
            t_adm = self.clock()
            for t in ordered:
                if id(t.handle.req) in rej:
                    still.append(t)
                    continue
                t.handle._transition(DECODING, t_adm)
                if not t.migrated:
                    # migrated wires resume mid-stream: the resume token
                    # is never re-appended, so there is nothing to sync
                    self._sync_tokens(t.handle, t_adm)
                if t.prefix_full or t.handle.req.start_pos > 0:
                    # prefix chain shared/spliced: the slot now holds its
                    # own references — drop the pin
                    self._release_prefix(t.handle)
        self.transfer_queue = still

    def _step_decodes(self) -> int:
        n_done = 0
        for handle in self.dec:
            if not handle.alive:
                continue
            t0 = self.clock()
            ns = self.scheduler.decode_chunk_steps
            try:
                finished = (handle.client.step(n_steps=ns) if ns
                            else handle.client.step())
            except ReplicaCrashError as e:
                self._confirm_dead(handle, str(e))
                continue
            t1 = self.clock()
            with _trace.span("pump.deliver"):
                if handle.client.active or finished:
                    self._track(handle, t1 - t0, t1)
                for req in handle.client.resident():
                    self._sync_tokens(self._by_req[id(req)], t1)
                for req in finished:
                    h = self._by_req[id(req)]
                    self._sync_tokens(h, t1)
                    h._transition(DONE, t1)
                    self.profiler.record(len(req.tokens),
                                         len(req.out_tokens), t1)
                    self._finish(h)
                    n_done += 1
        return n_done

    def _finish(self, h: RequestHandle):
        """Terminal bookkeeping: the GenRequest leaves the routing tables
        so a long-running service doesn't grow without bound (the handle
        itself stays in ``done`` until ``clear_finished``)."""
        self._release_prefix(h)        # no-op unless a pin is still held
        self._by_req.pop(id(h.req), None)
        self.done.append(h)
        if self.sanitizer is not None:
            self.sanitizer.on_finish(h)

    def clear_finished(self) -> List[RequestHandle]:
        """Hand over (and forget) terminal handles + events — call
        periodically from a long-running service loop to bound memory."""
        out, self.done = self.done, []
        self.events.clear()
        return out

    def _sync_tokens(self, h: RequestHandle, now: float):
        """Stream tokens the engines appended to ``req.out_tokens`` since
        the last pump into the handle (timestamps live on the handle, not
        the GenRequest). After a failure requeue the restarted attempt
        regenerates the already-delivered prefix (greedy decode is
        deterministic): those positions are swallowed instead of re-firing
        ``on_token`` or growing ``tokens`` twice."""
        out = h.req.out_tokens
        pos = h._engine_seen
        new = out[pos:]
        if not new:
            return
        h._engine_seen = len(out)
        replay = len(h.tokens) - pos        # delivered positions to skip
        if replay > 0:
            new = new[replay:]
        if new:
            h._deliver(new, now)

    def _sleep(self, dt: float):
        """Wait helper that understands virtual clocks: a VirtualClock
        advances (so simulated wires land and backoffs expire without wall
        time); a wall clock really sleeps."""
        adv = getattr(self.clock, "advance", None)
        if adv is not None:
            adv(dt)
        else:
            time.sleep(dt)

    def run_until_drained(self, *, max_iters: int = 10000,
                          poll_s: float = 2e-4) -> List[RequestHandle]:
        """Drive until every submitted request is terminal (or decode is
        wedged); returns terminal handles in completion order."""
        it = 0
        while (self.queue or self._chunks or self.transfer_queue
               or self.retry_queue
               or any(d.alive and d.client.active for d in self.dec)) \
                and it < max_iters:
            n = self.pump()
            it += 1
            if n == 0 and not self.queue and not self._chunks \
                    and (self.transfer_queue or self.retry_queue) \
                    and not any(d.alive and d.client.active
                                for d in self.dec):
                # nothing computable until a simulated wire lands / a
                # backoff expires (or a dead fleet recovers): don't burn
                # max_iters busy-spinning
                self._sleep(poll_s)
        self.sanitize_check("run_until_drained")
        return self.done

    def sanitize_check(self, context: str = "drain"):
        """Run the ``REPRO_SANITIZE=1`` audits now: page leaks /
        ownership drift on live decode replicas, state-machine violations
        on finished requests, steady-state jit retraces. No-op when
        sanitizers are disabled."""
        if self.sanitizer is not None:
            self.sanitizer.check(self, context=context)

    # -- fault tolerance ----------------------------------------------------

    def _check_heartbeats(self):
        now = self.clock()
        for h in self.pre + self.dec:
            if h.status in ("dead", "draining"):
                continue
            if getattr(h.client, "synchronous", False):
                # an in-process client cannot miss a heartbeat: its calls
                # block, so wall time spent elsewhere (traffic gaps, jit
                # compilation) is not evidence of replica death — only
                # kill_replica takes a local replica down. Timeout-based
                # death is for asynchronous/remote clients.
                h.beat(now)
                continue
            silent = now - h.last_heartbeat
            if silent > self.heartbeat_timeout:
                self.events.append(f"replica {h.phase}:{h.idx} timed out")
                self._confirm_dead(
                    h, f"heartbeat timed out ({silent:.1f}s silent)")
            elif silent > self.suspect_timeout and h.status == "alive":
                h.status = "suspected"
                h.suspect_why = "heartbeat"
                self.events.append(f"replica {h.phase}:{h.idx} suspected "
                                   f"({silent:.1f}s without a heartbeat)")

    def _update_suspects(self, now: float):
        """Latency-based suspicion: a replica whose EMA latency exceeds
        ``suspect_latency_factor`` x the fleet median leaves the routing
        tables (it still steps its resident work). Recovery is either a
        healthy sample or — for a suspected replica starved of traffic,
        whose EMA can never refresh — a probe re-admission after
        ``suspect_probe_s`` without an observation."""
        for handles in (self.pre, self.dec):
            obs = [h.ema_latency for h in handles
                   if h.status in ("alive", "suspected")
                   and h.ema_latency > 0]
            if len(obs) >= 2:
                bar = self.suspect_latency_factor * float(np.median(obs))
                for h in handles:
                    if h.ema_latency <= 0 or bar <= 0:
                        continue
                    if h.status == "alive" and h.ema_latency > bar:
                        h.status = "suspected"
                        h.suspect_why = "latency"
                        self.events.append(
                            f"replica {h.phase}:{h.idx} suspected (latency "
                            f"{h.ema_latency * 1e3:.1f}ms > "
                            f"{bar * 1e3:.1f}ms)")
                    elif (h.status == "suspected"
                          and h.suspect_why == "latency"
                          and h.ema_latency <= bar):
                        h.status = "alive"
                        h.suspect_why = None
                        self.events.append(
                            f"replica {h.phase}:{h.idx} recovered "
                            f"(latency back under the bar)")
            for h in handles:
                if (h.status == "suspected" and h.suspect_why == "latency"
                        and now - h.last_track > self.suspect_probe_s):
                    h.status = "alive"
                    h.suspect_why = None
                    self.events.append(
                        f"replica {h.phase}:{h.idx} probe: re-admitted "
                        f"to routing for a fresh measurement")

    def kill_replica(self, phase: str, idx: int, *, recover: bool = True):
        """Failure injection (tests/benchmarks). ``recover=False`` models
        the NO-HANDLING baseline: the replica dies and its resident
        requests are silently stranded (they never reach a terminal
        state) — the contrast the fault-tolerance bench measures."""
        group = self.pre if phase == "prefill" else self.dec
        h = group[idx]
        h.status = "dead"
        self.events.append(f"replica {phase}:{idx} killed")
        if recover:
            self._recover_from(h)
            self._pending_failover = True

    def _confirm_dead(self, h: ReplicaHandle, why: str):
        """suspected/alive -> dead: recover resident requests and queue a
        failover reschedule (picked up at the top of the next pump — never
        mid-iteration, so dispatch loops don't see half-rebuilt replica
        lists)."""
        if h.status == "dead":
            return
        h.status = "dead"
        h.suspect_why = None
        self.events.append(f"replica {h.phase}:{h.idx} confirmed dead "
                           f"({why})")
        self._recover_from(h)
        self._pending_failover = True

    def _recover_from(self, h: ReplicaHandle):
        """Requests in a dead decode replica lose their KV — their handles
        transition DECODING -> QUEUED (visible in ``history``, counted in
        ``restarts``) and they re-enter the queue for a fresh prefill on a
        surviving replica. A request past ``max_restarts`` FAILs instead
        of looping forever."""
        now = self.clock()
        if h.phase == "prefill":
            # partially-prefilled chunk jobs lose their accumulated wires
            # with the replica — back through the queue for a fresh start
            lost = [c for c in self._chunks if c.pre is h]
            self._chunks = [c for c in self._chunks if c.pre is not h]
            for c in lost:
                self._requeue_handle(c.handle, now,
                                     f"after prefill:{h.idx} failure")
            return
        for req in h.client.resident():
            h.client.release(req)
            hd = self._by_req.get(id(req))
            if hd is not None:
                self._requeue_handle(hd, now,
                                     f"after decode:{h.idx} failure")

    def _requeue_handle(self, hd: RequestHandle, now: float, why: str):
        """The ONE requeue-through-prefill path (decode death, preemption
        overflow, retry exhaustion, prefill crash): KV is gone, delivered
        tokens are kept, the regenerated prefix is suppressed. Gives up
        with FAILED once ``max_restarts`` attempts are burned."""
        if hd.is_terminal:
            return
        # a restarted attempt conditions on nothing: pins released, prefix
        # annotations cleared (it may re-match at the fresh prefill's cost)
        self._release_prefix(hd)
        if hd.restarts >= self.max_restarts:
            hd._transition(FAILED, now,
                           reason=f"gave up after {hd.restarts} restart(s): "
                                  f"{why}")
            self._finish(hd)
            self.n_failed += 1
            self.events.append(f"request {hd.request.rid} failed: {why}")
            return
        hd._requeue(now)
        self.queue.append(hd)
        self.n_requeues += 1
        self.events.append(f"request {hd.request.rid} re-queued {why}")

    # -- spot preemption: page-granular KV drain -----------------------------

    def handle_preemption(self, phase: str, idx: int,
                          grace_s: float = 1.0, *,
                          now: Optional[float] = None) -> Dict[str, int]:
        """Spot-preemption notice for replica ``phase:idx`` with a grace
        window of ``grace_s`` seconds (ROADMAP item 4: treat the notice as
        a planned drain).

        Admissions stop immediately (status ``draining``). For a decode
        replica, every resident request's KV is extracted PAGE-GRANULAR
        (zero-dequant for the int4 residency — the pages already hold the
        wire encoding) and shipped over the transport's decode->decode
        links to the surviving replica with the most capacity. Transfers
        whose cumulative delay would outlive the grace window — and
        everything when no survivor exists — fall back to
        requeue-through-prefill, so no accepted request is ever lost. The
        replica is then confirmed dead, which queues the failover
        reschedule. Returns ``{"migrated", "requeued", "tokens_migrated"}``.
        """
        now = now if now is not None else self.clock()
        handles = self.pre if phase == "prefill" else self.dec
        h = handles[idx]
        if h.status == "dead":
            return {"migrated": 0, "requeued": 0, "tokens_migrated": 0}
        self.n_preemptions += 1
        h.status = "draining"
        self.events.append(f"replica {phase}:{idx} preemption notice "
                           f"(grace {grace_s:.2f}s)")
        migrated = requeued = tokens_moved = 0
        if phase == "decode":
            try:
                items = h.client.extract_resident(compress=self.compress,
                                                  backend=self.backend)
            except Exception as e:     # died before the drain: requeue-all
                self.events.append(f"decode:{idx} drain extract failed "
                                   f"({e}); requeueing residents")
                items = []
            survivors = [j for j, d in enumerate(self.dec)
                         if j != idx and d.status == "alive"]
            send = getattr(self.transport, "send_decode",
                           self.transport.send)
            budget = grace_s
            for _slot, req, wire, cur in items:
                hd = self._by_req.get(id(req))
                if hd is None:
                    h.client.release(req)
                    continue
                ticket = None
                if survivors and budget > 0:
                    target = max(survivors,
                                 key=lambda j: self.dec[j].client.n_free())
                    ticket = send(wire, idx, target, now=now)
                    budget -= ticket.delay_s
                    if budget < 0:
                        # this transfer would outlive the node: abandon it
                        ticket = None
                if ticket is not None:
                    hd._transition(TRANSFERRING, now)
                    self.transfer_queue.append(
                        _Transfer(hd, ticket, cur, target, migrated=True))
                    migrated += 1
                    tokens_moved += wire.request_len
                    self.events.append(
                        f"request {req.rid} migrating decode:{idx} -> "
                        f"decode:{target} ({wire.request_len} tokens)")
                else:
                    self._requeue_handle(
                        hd, now, f"(preempted decode:{idx}, "
                                 f"no migration target/grace)")
                    requeued += 1
                h.client.release(req)
            # anything extract_resident missed goes the requeue path
            self._recover_from(h)
        self.n_migrations += migrated
        self.n_migrated_tokens += tokens_moved
        self._confirm_dead(h, f"spot preemption (grace {grace_s:.2f}s "
                              f"elapsed)")
        self.events.append(f"preemption drain {phase}:{idx}: {migrated} "
                           f"migrated, {requeued} requeued")
        return {"migrated": migrated, "requeued": requeued,
                "tokens_migrated": tokens_moved}

    # -- failover: epoch reschedule excluding dead nodes ---------------------

    def set_failover(self, cluster, cfg: ModelConfig, slo: SloSpec, *,
                     workload=None, rate: Optional[float] = None,
                     search_fn=None):
        """Arm automatic failover rescheduling: when a replica is
        confirmed dead, the next pump re-plans on the surviving device
        groups (``drop_nodes`` -> flip-only search seeded with the
        survivors -> ``plan_diff`` -> ``apply_plan``). ``search_fn`` must
        accept ``reschedule_lightweight``'s signature (incl.
        ``init_solution``)."""
        self._failover = {"cluster": cluster, "cfg": cfg, "slo": slo,
                          "workload": workload, "rate": rate,
                          "search_fn": search_fn}

    def _run_failover(self):
        self._pending_failover = False
        ctx = self._failover
        if ctx is None or not self._is_plan_bound():
            return None
        plan_groups = {sched._group_key(r.devices) for r in
                       (list(self.plan.prefill_replicas)
                        + list(self.plan.decode_replicas))}
        dead_groups = [h.group for h in self.pre + self.dec
                       if h.status == "dead" and h.group in plan_groups]
        if not dead_groups:
            return None
        dead_devices = sorted({d for g in dead_groups for d in g})
        wl = ctx["workload"] or self.profiler.as_workload()
        if wl is None:
            self.events.append("failover reschedule skipped: no workload "
                               "observation yet (pass workload= to "
                               "set_failover)")
            return None
        rate = self.profiler.arrival_rate() or ctx["rate"] or 1.0
        init = sched.drop_nodes(ctx["cluster"], self.plan, dead_devices)
        if not init.groups:
            self.events.append("failover reschedule skipped: no surviving "
                               "groups")
            return None
        search = ctx["search_fn"] or sched.reschedule_lightweight
        try:
            new_plan = search(ctx["cluster"], ctx["cfg"], self.plan, wl,
                              rate, ctx["slo"], init_solution=init)
            delta = sched.plan_diff(self.plan, new_plan)
            n = 0 if delta.is_noop else self.apply_plan(delta)
        except Exception as e:
            self.events.append(f"failover reschedule failed: {e}")
            return None
        self.events.append(f"failover reschedule: dropped devices "
                           f"{dead_devices}, {n} request(s) requeued")
        return new_plan

    def heartbeat_all(self):
        now = self.clock()
        for h in self.pre + self.dec:
            if h.alive:
                h.beat(now)

    def _track(self, h: ReplicaHandle, dt: float,
               now: Optional[float] = None):
        now = now if now is not None else self.clock()
        h.beat(now)
        h.last_track = now
        h.ema_latency = 0.8 * h.ema_latency + 0.2 * dt if h.ema_latency \
            else dt
        h.min_latency = min(h.min_latency, dt)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Operational counters for drivers/dashboards: queue depths,
        recovery counters, aggregated page-pool stats (incl.
        ``alloc_failures``), and per-replica detector status."""
        pool: Optional[Dict[str, float]] = None
        for d in self.dec:
            # through the client seam (rule R003): an RPC client serves
            # page stats over the wire, there is no engine to reach into
            ps = getattr(d.client, "page_stats", None)
            st = ps() if callable(ps) else None
            if st is None:
                continue
            if pool is None:
                pool = {k: 0.0 for k in
                        ("pages", "in_use", "free", "peak_in_use", "allocs",
                         "frees", "alloc_failures", "leaked_pages",
                         "zero_copy_inserts", "reencoded_inserts",
                         "shares", "unshares", "shared_pages", "cow_copies",
                         "prefix_admits", "prefix_entries", "prefix_pages",
                         "prefix_evictions", "prefix_donations")}
            for k in pool:
                pool[k] += st.get(k, 0)
        probes = self.n_prefix_hits + self.n_prefix_partial \
            + self.n_prefix_miss
        prefix = {
            "hits": self.n_prefix_hits,
            "partial_hits": self.n_prefix_partial,
            "misses": self.n_prefix_miss,
            "hit_rate": ((self.n_prefix_hits + self.n_prefix_partial)
                         / probes if probes else 0.0),
            "hit_tokens": self.n_prefix_tokens_hit,
            "pins_held": len(self._pins),
        }
        out = {
            "epoch": self.epoch,
            "queued": len(self.queue),
            "chunks_in_flight": len(self._chunks),
            "transfers_in_flight": len(self.transfer_queue),
            "retries_pending": len(self.retry_queue),
            "counters": {"retries": self.n_retries,
                         "requeues": self.n_requeues,
                         "migrations": self.n_migrations,
                         "migrated_tokens": self.n_migrated_tokens,
                         "preemptions": self.n_preemptions,
                         "chunk_ticks": self.n_chunk_ticks,
                         "chunked_prefills": self.n_chunked_prefills,
                         "failed": self.n_failed},
            "page_pool": pool,
            "prefix": prefix,
            "replicas": [{"phase": h.phase, "idx": h.idx,
                          "status": h.status,
                          "suspect_why": h.suspect_why,
                          "ema_latency_s": round(h.ema_latency, 6)}
                         for h in self.pre + self.dec],
        }
        if self.sanitizer is not None:
            out["sanitizer"] = self.sanitizer.stats()
        return out

    # -- straggler mitigation -----------------------------------------------

    def refresh_routing_from_latency(self):
        """Bleed traffic away from slow replicas: reweight X/Y by inverse
        measured latency (keeps the TSTP structure, scales the masses).
        The ORIGINAL totals are preserved: when the TSTP deliberately shed
        mass (``Z.sum() < 1``, saturated fleet), renormalizing to 1 would
        silently route the unserved mass back onto the replicas the solver
        judged saturated."""
        if self.o is None:
            return
        lat_p = np.array([max(h.ema_latency, 1e-6) for h in self.pre])
        w = (1.0 / lat_p)
        w /= w.sum()
        x_total = self.o.X.sum()
        X = self.o.X * w
        if X.sum() > 0:
            self.o.X = X * (x_total / X.sum())
        lat_d = np.array([max(h.ema_latency, 1e-6) for h in self.dec])
        wd = (1.0 / lat_d)
        wd /= wd.sum()
        y_totals = self.o.Y.sum(axis=1, keepdims=True)
        Y = self.o.Y * wd[None, :]
        s = Y.sum(axis=1, keepdims=True)
        self.o.Y = np.where(s > 0, Y * y_totals / np.maximum(s, 1e-12),
                            self.o.Y)

    # -- plan epochs: live re-designation ------------------------------------

    def _install_routing(self, o: Optional[Orchestration]) -> bool:
        """Atomically swap the TSTP masses — only when their dimensions
        match the live replica lists (the invariant every epoch ends on)."""
        if (o is not None and o.X.shape[0] == len(self.pre)
                and o.Y.shape == (len(self.pre), len(self.dec))):
            self.o = o
            return True
        return False

    def _is_plan_bound(self) -> bool:
        return (self.plan is not None
                and all(h.group is not None for h in self.pre + self.dec))

    def apply_plan(self, delta) -> int:
        """Transition the running gateway to a new plan epoch.

        ``delta`` is a :class:`~repro_torch.core.scheduler.PlanDelta` (or a new
        ``DeploymentPlan``, diffed against the bound plan). For each group
        in the delta, the live replica:

        * **keeps phase** — untouched (requests in flight stay in flight);
        * **flips** — new work stops routing to it (it leaves the routing
          tables this call rebuilds), in-flight decode requests are
          requeued through the existing failure path (DECODING -> QUEUED,
          tokens kept, regenerated prefix suppressed), then
          ``switch_phase()`` re-roles the RESIDENT parameters — no reload;
        * **died** — marked dead, its requests requeued (node failure
          composes as ``drop_nodes`` -> ``reschedule_lightweight`` ->
          ``plan_diff`` -> here).

        The new routing masses are installed only once the ``pre``/``dec``
        lists match the new plan's dimensions, so routing never sees a
        half-applied epoch. Returns the number of requeued requests."""
        if not isinstance(delta, sched.PlanDelta):
            if self.plan is None:
                raise ValueError("apply_plan needs a PlanDelta (or a plan-"
                                 "bound gateway to diff a new plan against)")
            delta = sched.plan_diff(self.plan, delta)
        if delta.added:
            raise ValueError(
                f"apply_plan cannot materialize replicas for new groups "
                f"{[list(g) for g, _ in delta.added]}: a live epoch "
                f"transition only re-designates resident replicas (run a "
                f"full redeploy for new groups)")
        now = self.clock()
        by_group: Dict[Tuple[int, ...], ReplicaHandle] = {}
        for h in self.pre + self.dec:
            if h.group is None:
                raise ValueError(
                    "apply_plan requires group-tagged replicas: construct "
                    "the gateway with plan= (or via gateway_from_plan)")
            by_group[h.group] = h
        old_dec = list(self.dec)
        n_requeued = 0
        # 1. drain flipping/dying decode replicas through the requeue path
        for g, old_ph, _new_ph in delta.flips:
            h = by_group.get(g)
            if h is not None and old_ph == "decode" and h.alive:
                n_requeued += self._requeue_resident(
                    h, now, f"phase flip decode->prefill on {list(g)}")
        for g, ph in delta.dropped:
            h = by_group.pop(g, None)
            if h is None:
                continue
            if h.alive:
                if ph == "decode":
                    n_requeued += self._requeue_resident(
                        h, now, f"group {list(g)} dropped")
                h.alive = False
            self.events.append(f"epoch {self.epoch + 1}: replica "
                               f"{ph}:{list(g)} dropped from plan")
        # 2. flip the drained replicas around their resident params
        for g, _old_ph, new_ph in delta.flips:
            h = by_group.get(g)
            if h is None:
                continue
            if not h.switchable:
                raise TypeError(
                    f"replica {h.phase}:{h.idx} (group {list(g)}) cannot "
                    f"switch phase: wrap the engine in a Replica to make "
                    f"it live-redesignatable")
            if h.alive:
                h.client.switch_phase(new_ph)
            h.phase = new_ph
        # 3. rebuild the live lists in the new plan's replica order
        new_pre, new_dec = [], []
        for r in delta.new_plan.prefill_replicas:
            h = by_group[sched._group_key(r.devices)]
            h.idx, h.phase = len(new_pre), "prefill"
            new_pre.append(h)
        for r in delta.new_plan.decode_replicas:
            h = by_group[sched._group_key(r.devices)]
            h.idx, h.phase = len(new_dec), "decode"
            new_dec.append(h)
        self.pre, self.dec = new_pre, new_dec
        # 4. retarget in-flight KV transfers (decode indices changed; some
        #    targets may have flipped away or died). Prefix-bound
        #    transfers (page handles / suffix wires) follow their replica
        #    or fall back to a full prefill — never reroute.
        new_idx = {id(h): j for j, h in enumerate(self.dec)}
        alive = [j for j, d in enumerate(self.dec) if d.alive]
        keep_t = []
        for t in self.transfer_queue:
            h_old = (old_dec[t.target] if t.target < len(old_dec) else None)
            j = new_idx.get(id(h_old)) if h_old is not None else None
            if t.replica_bound:
                if j is None or not self.dec[j].dispatchable:
                    self._requeue_handle(t.handle, now,
                                         "(prefix replica left the plan)")
                    continue
                t.target = j
                if t.handle.req.prefix_replica >= 0:
                    t.handle.req.prefix_replica = j
                keep_t.append(t)
                continue
            if j is None or not self.dec[j].alive:
                j = (max(alive, key=lambda jj: self.dec[jj].client.n_free())
                     if alive else 0)
            t.target = j
            keep_t.append(t)
        self.transfer_queue = keep_t
        # queued partial-hit requests hold pins by decode INDEX: remap to
        # the new plan's indices or fall back to a full prefill
        for h in list(self.queue):
            r = h.req
            if r.start_pos > 0 and 0 <= r.prefix_replica < len(old_dec):
                j = new_idx.get(id(old_dec[r.prefix_replica]))
                if j is None or not self.dec[j].dispatchable:
                    self._release_prefix(h)
                else:
                    r.prefix_replica = j
        # in-flight chunk jobs are sticky to their prefill replica (the
        # accumulated KV lives there): if it flipped away or died, restart
        # through the queue
        live_pre = {id(p) for p in self.pre if p.dispatchable}
        for c in list(self._chunks):
            if id(c.pre) not in live_pre:
                self._chunks.remove(c)
                self._requeue_handle(c.handle, now,
                                     "(chunk prefill replica left the plan)")
        # 5. rebuild the transport link table from the new replica->device
        #    map, then atomically install the new routing masses
        if hasattr(self.transport, "rebind_plan"):
            self.transport.rebind_plan(delta.new_plan)
        installed = self._install_routing(delta.new_plan.orchestration)
        if not installed:
            # solver produced no orchestration (or a stale-dimension one):
            # fall back to alive-uniform routing rather than keeping masses
            # indexed against replicas that no longer exist
            self.o = None
        self.plan = delta.new_plan
        self.epoch += 1
        self.events.append(
            f"epoch {self.epoch}: applied plan delta ({delta.describe()}); "
            f"{n_requeued} request(s) requeued, routing "
            f"{'installed' if installed else 'uniform (no orchestration)'}, "
            f"P:{len(self.pre)} D:{len(self.dec)}")
        return n_requeued

    def _requeue_resident(self, h: ReplicaHandle, now: float,
                          why: str) -> int:
        """Requeue every request resident on a decode replica (the same
        path decode-replica death takes): KV is dropped, tokens already
        delivered are kept, the fresh attempt's regenerated prefix is
        suppressed by ``_sync_tokens``."""
        n = 0
        for req in list(h.client.resident()):
            h.client.release(req)
            hd = self._by_req.get(id(req))
            if hd is None:
                continue
            self._requeue_handle(hd, now, f": {why}")
            n += 1
        return n

    # -- workload shift -> lightweight rescheduling --------------------------

    def maybe_reschedule(self, cluster, cfg: ModelConfig, plan=None,
                         rate: Optional[float] = None,
                         slo: Optional[SloSpec] = None, *,
                         search_fn=None):
        """Profiler-gated lightweight rescheduling (paper §3.4).

        When the profiler reports a workload shift, re-solves phase
        designation + TSTP for the OBSERVED workload and arrival rate (the
        caller-supplied ``rate`` is only a fallback for an empty window)
        and applies the result to the running gateway as a plan epoch
        (plan-bound gateways flip live replicas; legacy plan-less gateways
        just install the masses, and only when dimensions match).
        ``search_fn`` (same signature as
        :func:`repro_torch.core.scheduler.reschedule_lightweight`) lets tests
        and drivers pin the search."""
        plan = plan if plan is not None else self.plan
        if plan is None:
            raise ValueError("maybe_reschedule needs a plan: pass one or "
                             "bind the gateway with plan=")
        if slo is None:
            raise ValueError("maybe_reschedule needs an SloSpec")
        if not self.profiler.shift_detected():
            return None
        wl = self.profiler.as_workload()
        stats = self.profiler.stats()
        if wl is None or stats is None:
            # fewer than 8 records in the window: the shift signal cannot
            # be trusted and there is no workload to re-plan for
            return None
        # offered load, measured at submit: under saturation (when a
        # reschedule matters most) the completion rate is capped by the
        # stale plan's capacity and would underestimate the true demand
        obs_rate = self.profiler.arrival_rate()
        if obs_rate is None or obs_rate <= 0:
            obs_rate = stats.rate if stats.rate > 0 else float(rate or 0.0)
        search = search_fn or sched.reschedule_lightweight
        new_plan = search(cluster, cfg, plan, wl, obs_rate, slo)
        delta = sched.plan_diff(plan, new_plan)
        if self._is_plan_bound():
            if delta.is_noop:
                # same designation, fresh masses for the observed workload:
                # a routing refresh, not a full epoch transition
                self._install_routing(new_plan.orchestration)
                self.plan = new_plan
            else:
                self.apply_plan(delta)
        else:
            if not self._install_routing(new_plan.orchestration):
                self.events.append(
                    "routing masses not installed: plan dimensions "
                    f"({len(new_plan.prefill_replicas)}P/"
                    f"{len(new_plan.decode_replicas)}D) do not match the "
                    f"live replicas ({len(self.pre)}P/{len(self.dec)}D) "
                    "and this gateway is not plan-bound")
            self.plan = new_plan
        self.profiler.set_baseline()
        self.events.append(
            f"lightweight rescheduling: {new_plan.search_seconds:.2f}s, "
            f"observed rate {obs_rate:.2f}/s, "
            f"P:{len(new_plan.prefill_replicas)} "
            f"D:{len(new_plan.decode_replicas)} ({delta.describe()})")
        return new_plan


# -- plan-bound construction --------------------------------------------------


def gateway_from_plan(plan, cfg: ModelConfig, params, *,
                      transport: Optional[Transport] = None,
                      max_seq: int = 64, max_slots: int = 4,
                      chunk_size: int = 4, device="cuda", rt=None,
                      prefill_kw: Optional[Dict] = None,
                      decode_kw: Optional[Dict] = None,
                      scheduler: Optional[SchedulerConfig] = None,
                      **gw_kw) -> Gateway:
    """Instantiate one phase-switchable :class:`Replica` per plan replica
    (all sharing ``params`` — the in-process stand-in for each group's
    resident sharded weights) and bind the gateway to the plan, so
    ``apply_plan`` / ``maybe_reschedule`` can run live epoch transitions.
    Engine kwargs are shared by every replica; per-phase extras go in
    ``prefill_kw`` / ``decode_kw``."""
    dkw = {"max_slots": max_slots, "chunk_size": chunk_size,
           **(decode_kw or {})}
    pres = [Replica(cfg, params, phase="prefill", max_seq=max_seq, rt=rt,
                    device=device, prefill_kw=prefill_kw, decode_kw=dkw)
            for _ in plan.prefill_replicas]
    decs = [Replica(cfg, params, phase="decode", max_seq=max_seq, rt=rt,
                    device=device, prefill_kw=prefill_kw, decode_kw=dkw)
            for _ in plan.decode_replicas]
    return Gateway(pres, decs, transport=transport, plan=plan,
                   scheduler=scheduler, **gw_kw)


# -- open-loop driving helpers ------------------------------------------------


def warmup_engines(prefills: Sequence[PrefillEngine],
                   decodes: Sequence[DecodeEngine], vocab_size: int, *,
                   compress: bool = True, backend: str = "auto",
                   prompt_lens: Sequence[int] = (8,), max_new: int = 2):
    """Compile the prefill/decode jit paths before an open-loop run so the
    first real request's TTFT measures serving, not XLA compilation. Pass
    the prompt lengths the trace will actually use — each distinct
    (power-of-two bucket, batch width) still compiles once. Engines are
    paired round-robin (jit caches are per-engine, so the full
    prefill x decode cross-product would add wall time, not coverage)."""
    rng = np.random.default_rng(0)
    for ln in prompt_lens:
        for k in range(max(len(prefills), len(decodes))):
            pre = prefills[k % len(prefills)]
            dec = decodes[k % len(decodes)]
            req = GenRequest(-1, rng.integers(
                1, vocab_size, int(ln)).astype(np.int32), max_new)
            dec.admit(AdmissionBatch(
                [AdmissionItem(r, f, ADMIT_FRESH, wire=w)
                 for r, w, f in pre.run([req], compress=compress,
                                        backend=backend)]), backend=backend)
            while dec.active:
                dec.step()


def warmup_gateway(gw: Gateway, vocab_size: int, *,
                   prompt_lens: Sequence[int] = (8,), max_new: int = 2):
    """:func:`warmup_engines` for a constructed :class:`Gateway`: drives
    the same compile-priming traffic through the replica CLIENT seams
    (rule R003 — works unchanged when the clients are RPC proxies), and
    marks the post-warmup point for the sanitizer's jit-retrace monitor.
    Heartbeats are refreshed afterwards so compile time is not mistaken
    for replica death."""
    rng = np.random.default_rng(0)
    pres = [h.client for h in gw.pre]
    decs = [h.client for h in gw.dec]
    budget = gw.scheduler.prefill_chunk_tokens
    for ln in prompt_lens:
        for k in range(max(len(pres), len(decs))):
            pre = pres[k % len(pres)]
            dec = decs[k % len(decs)]
            req = GenRequest(-1, rng.integers(
                1, vocab_size, int(ln)).astype(np.int32), max_new)
            sup = getattr(pre, "supports_suffix", None)
            if budget > 0 and callable(sup) and sup():
                # prime the chunked path: every suffix bucket the chunk
                # walk visits for this prompt length compiles here
                job = PartialPrefill(req)
                while not job.done:
                    pre.prefill_chunk([job], budget, compress=gw.compress,
                                      backend=gw.backend)
                items = [(req, job.wire(), job.first)]
            else:
                items = pre.prefill([req], compress=gw.compress,
                                    backend=gw.backend)
            rejected = dec.admit(AdmissionBatch(
                [AdmissionItem(r, f, ADMIT_FRESH, wire=w)
                 for r, w, f in items]), backend=gw.backend)
            if rejected:
                raise RuntimeError(f"warmup request rejected by decode "
                                   f"replica ({len(rejected)} items)")
            while dec.active:
                dec.step()
    gw.heartbeat_all()
    if gw.sanitizer is not None:
        gw.sanitizer.on_steady(gw)


def drive_open_loop(gw: Gateway, arrivals: Sequence[Tuple[float,
                                                          ServeRequest]], *,
                    time_scale: float = 1.0, max_iters: int = 200000,
                    on_token: Optional[Callable[[RequestHandle, int], None]]
                    = None,
                    tick: Optional[Callable[[Gateway], None]] = None,
                    tick_interval_s: float = 0.25) -> List[RequestHandle]:
    """Open-loop driver: submit each request at its trace arrival time
    (scaled by ``time_scale``) against the wall clock, pumping the gateway
    between arrivals, then drain. This is how a service is actually driven
    — dumping the whole trace at t=0 makes every E2E number meaningless.

    ``tick`` is the control-plane hook: it fires at most every
    ``tick_interval_s`` of driver-clock time with the gateway as argument
    — the place to run ``maybe_reschedule`` /
    ``refresh_routing_from_latency`` (or inject failures) against live
    traffic.

    Time flows through ``gw.clock`` / ``gw._sleep`` (rule R001): with the
    default wall clock the behavior is unchanged, while a
    :class:`~repro_torch.serving.faults.VirtualClock` makes the whole open-loop
    run deterministic (idle waits advance virtual time instead of
    sleeping).
    """
    pending = sorted(arrivals, key=lambda a: a[0])
    gw.heartbeat_all()      # time spent in setup/warmup is not a failure
    t0 = gw.clock()
    handles: List[RequestHandle] = []
    i = 0
    it = 0
    last_tick = t0
    while i < len(pending) or gw.queue or gw._chunks \
            or gw.transfer_queue or gw.retry_queue \
            or any(d.alive and d.client.active for d in gw.dec):
        if tick is not None and gw.clock() - last_tick >= tick_interval_s:
            tick(gw)
            last_tick = gw.clock()
        now = gw.clock() - t0
        while i < len(pending) and pending[i][0] * time_scale <= now:
            handles.append(gw.submit(pending[i][1], on_token=on_token))
            i += 1
        busy = (gw.queue or gw._chunks or gw.transfer_queue
                or gw.retry_queue
                or any(d.alive and d.client.active for d in gw.dec))
        if busy:
            n = gw.pump()
            if n == 0 and not gw.queue and not gw._chunks \
                    and (gw.transfer_queue or gw.retry_queue) \
                    and not any(d.alive and d.client.active
                                for d in gw.dec):
                # only in-flight simulated wires remain: wait for t_ready
                # instead of burning the iteration budget (same wedge
                # guard as run_until_drained)
                gw._sleep(2e-4)
        elif i < len(pending):
            # idle until the next arrival — don't burn the iteration budget
            gw._sleep(min(pending[i][0] * time_scale - now, 5e-3))
        it += 1
        if it > max_iters:
            break
    gw.sanitize_check("drive_open_loop")
    return handles


def summarize_handles(handles: Sequence[RequestHandle]) -> Dict[str, object]:
    """TTFT/TPOT/E2E percentiles + goodput over one open-loop run.

    Goodput is deadline attainment: the fraction of *submitted* requests
    that finished AND met both their TTFT and E2E deadlines (an infinite
    deadline is trivially met)."""
    def pct(xs, q):
        xs = [x for x in xs if not math.isnan(x)]
        return float(np.percentile(xs, q)) if xs else math.nan

    done = [h for h in handles if h.state == DONE]
    good = [h for h in done
            if h.ttft <= h.request.ttft_deadline_s
            and h.e2e <= h.request.e2e_deadline_s]
    states: Dict[str, int] = {}
    for h in handles:
        states[h.state] = states.get(h.state, 0) + 1
    ttft = [h.ttft for h in done]
    tpot = [h.tpot for h in done]
    e2e = [h.e2e for h in done]
    toks = sum(len(h.tokens) for h in done)
    return {
        "n_submitted": len(handles), "n_done": len(done),
        "states": states, "tokens": toks,
        "goodput": len(good) / max(len(handles), 1),
        "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
        "tpot_p50_s": pct(tpot, 50), "tpot_p99_s": pct(tpot, 99),
        "e2e_p50_s": pct(e2e, 50), "e2e_p99_s": pct(e2e, 99),
    }
