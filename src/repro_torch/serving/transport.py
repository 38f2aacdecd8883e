"""Pluggable KV transport between prefill and decode replicas.

The gateway never moves a :class:`~repro_torch.serving.kv_transfer.KVWire`
directly: every prefill -> decode handoff goes through a ``Transport``,
which decides what the hop costs and whether the payload leaves the
device. This is the seam where a real network stack (RDMA, gRPC,
DCN collectives) slots in later without touching routing, heartbeats,
or rescheduling logic.

Two in-process realizations ship today:

* :class:`InProcessTransport` — device arrays flow straight through;
  zero delay, no host synchronization (optionally ``materialize=True``
  to force the explicit host hop).
* :class:`SimNetworkTransport` — alpha-beta cost per link
  (``delay = alpha + bytes / bandwidth``) drawn from a
  :class:`~repro_torch.core.cluster.ClusterSpec` bandwidth matrix (or given
  explicitly), with the explicit ``KVWire.materialize()`` host hop a
  real network transfer would pay. Wires become *visible* at the
  receiver only once the wall clock passes the ticket's ``t_ready``,
  so open-loop drivers observe genuinely delayed TTFT.

The port's copy of ``repro.serving.transport``;
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple)

from repro_torch.serving.kv_transfer import KVWire, wire_bytes_uncompressed


@dataclass
class TransferTicket:
    """One in-flight prefill->decode KV transfer. ``clock`` is the issuing
    transport's clock (a REFERENCE to ``time.time`` by default, so ticket
    readiness follows a VirtualClock when one is injected — rule R001)."""
    wire: KVWire
    t_ready: float          # clock time the wire is usable downstream
    delay_s: float = 0.0
    nbytes: int = 0
    clock: Callable[[], float] = time.time

    def ready(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else self.clock()) >= self.t_ready


class Transport(Protocol):
    """Narrow seam the gateway uses to ship KV state between replicas.

    ``send`` is called once per wire with the *replica* indices chosen by
    the TSTP routing; it returns a ticket whose ``t_ready`` gates decode
    admission. Implementations decide whether the payload stays a device
    array (in-process) or crosses a host/network boundary.
    """

    def send(self, wire: KVWire, src_replica: int, dst_replica: int,
             *, now: Optional[float] = None) -> TransferTicket:
        ...


class InProcessTransport:
    """Same-process handoff: the decode side consumes device arrays
    directly and the hop is free. ``materialize=True`` forces the single
    explicit device->host sync (models collocated processes that still
    serialize)."""

    def __init__(self, *, materialize: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        self.materialize = materialize
        self.clock = clock if clock is not None else time.time
        self.transfers = 0

    def send(self, wire: KVWire, src_replica: int, dst_replica: int,
             *, now: Optional[float] = None) -> TransferTicket:
        if self.materialize:
            wire.materialize()
        self.transfers += 1
        return TransferTicket(wire, now if now is not None else self.clock(),
                              clock=self.clock)

    def send_decode(self, wire: KVWire, src_dec: int, dst_dec: int,
                    *, now: Optional[float] = None) -> TransferTicket:
        """Decode->decode KV migration hop (preemption drains): free."""
        return self.send(wire, src_dec, dst_dec, now=now)


class SimNetworkTransport:
    """Alpha-beta cost model per (prefill replica, decode replica) link.

    Link parameters come from a :class:`ClusterSpec` plus the device
    groups of each replica (``min_bw_between`` of the two groups — the
    bottleneck link a sliced KV transfer actually crosses), or from
    explicit ``alpha``/``bandwidth`` overrides when no cluster is given.

    ``bytes_scale`` lets a reduced-config engine pay the FULL model's
    wire cost (the same full-model/reduced-compute split the launchers
    use for scheduling); ``count_compressed=False`` charges the
    uncompressed KV size instead of the int4 wire size.
    """

    def __init__(self, cluster=None, *,
                 prefill_devices: Optional[Sequence[Sequence[int]]] = None,
                 decode_devices: Optional[Sequence[Sequence[int]]] = None,
                 alpha: Optional[float] = None,
                 bandwidth: Optional[float] = None,
                 bytes_scale: float = 1.0,
                 count_compressed: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        if cluster is None and bandwidth is None:
            raise ValueError("SimNetworkTransport needs a ClusterSpec or an "
                             "explicit bandwidth")
        self.cluster = cluster
        self.pre_devices = [list(g) for g in (prefill_devices or [])]
        self.dec_devices = [list(g) for g in (decode_devices or [])]
        self.alpha = alpha
        self.bandwidth = bandwidth
        self.bytes_scale = bytes_scale
        self.count_compressed = count_compressed
        self.clock = clock if clock is not None else time.time
        # accounting (benchmarks read these; min_delay_s is the gateway's
        # lower bound for deadline shedding)
        self.transfers = 0
        self.bytes_sent = 0
        self.total_delay_s = 0.0
        self.min_delay_s = 0.0
        self._links: Dict[Tuple[str, int, int], Tuple[float, float]] = {}

    @classmethod
    def from_plan(cls, cluster, plan, **kw) -> "SimNetworkTransport":
        """Wire the link table from a DeploymentPlan's replica->device map."""
        return cls(cluster,
                   prefill_devices=[r.devices for r in plan.prefill_replicas],
                   decode_devices=[r.devices for r in plan.decode_replicas],
                   **kw)

    def rebind_plan(self, plan) -> None:
        """Rebuild the replica->device link table for a new plan epoch:
        after a live re-designation the (prefill i, decode j) indices name
        different device groups, so every cached alpha-beta link is stale.
        Accounting (transfers/bytes/min_delay) is cumulative across epochs
        and intentionally survives."""
        self.pre_devices = [list(r.devices) for r in plan.prefill_replicas]
        self.dec_devices = [list(r.devices) for r in plan.decode_replicas]
        self._links.clear()

    def _link_between(self, key: Tuple[str, int, int],
                      src_group: Optional[Sequence[int]],
                      dst_group: Optional[Sequence[int]]) -> Tuple[float, float]:
        """(alpha_s, bandwidth_Bps) between two device groups, cached."""
        if key in self._links:
            return self._links[key]
        alpha = self.alpha if self.alpha is not None else (
            self.cluster.alpha if self.cluster is not None else 0.0)
        bw = self.bandwidth
        if (bw is None and self.cluster is not None
                and src_group is not None and dst_group is not None):
            bw = self.cluster.min_bw_between(src_group, dst_group)
        if bw is None and self.cluster is not None:
            bw = float(self.cluster.bw[self.cluster.bw > 0].min())
        self._links[key] = (alpha, float(bw))
        return self._links[key]

    def link(self, src_replica: int, dst_replica: int) -> Tuple[float, float]:
        """(alpha_s, bandwidth_Bps) for one prefill->decode link."""
        src = (self.pre_devices[src_replica]
               if src_replica < len(self.pre_devices) else None)
        dst = (self.dec_devices[dst_replica]
               if dst_replica < len(self.dec_devices) else None)
        return self._link_between(("pd", src_replica, dst_replica), src, dst)

    def link_decode(self, src_dec: int, dst_dec: int) -> Tuple[float, float]:
        """(alpha_s, bandwidth_Bps) for a decode->decode migration link
        (used by ``Gateway.handle_preemption`` to drain KV pages off a
        preempted replica)."""
        src = (self.dec_devices[src_dec]
               if src_dec < len(self.dec_devices) else None)
        dst = (self.dec_devices[dst_dec]
               if dst_dec < len(self.dec_devices) else None)
        return self._link_between(("dd", src_dec, dst_dec), src, dst)

    def _ship(self, wire: KVWire, alpha: float, bw: float,
              now: Optional[float]) -> TransferTicket:
        now = now if now is not None else self.clock()
        wire.materialize()          # the explicit host hop of a real network
        nbytes = (wire.nbytes() if self.count_compressed
                  else wire_bytes_uncompressed(wire))
        nbytes = int(nbytes * self.bytes_scale)
        delay = alpha + nbytes / max(bw, 1.0)
        self.transfers += 1
        self.bytes_sent += nbytes
        self.total_delay_s += delay
        self.min_delay_s = (delay if self.transfers == 1
                            else min(self.min_delay_s, delay))
        return TransferTicket(wire, now + delay, delay, nbytes,
                              clock=self.clock)

    def send(self, wire: KVWire, src_replica: int, dst_replica: int,
             *, now: Optional[float] = None) -> TransferTicket:
        alpha, bw = self.link(src_replica, dst_replica)
        return self._ship(wire, alpha, bw, now)

    def send_decode(self, wire: KVWire, src_dec: int, dst_dec: int,
                    *, now: Optional[float] = None) -> TransferTicket:
        """Decode->decode KV migration hop (preemption drains)."""
        alpha, bw = self.link_decode(src_dec, dst_dec)
        return self._ship(wire, alpha, bw, now)

    @property
    def mean_delay_s(self) -> float:
        return self.total_delay_s / max(self.transfers, 1)
