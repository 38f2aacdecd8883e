"""The harness's replica clients: the gateway's ``PrefillClient`` and
``DecodeClient`` protocol (``repro_torch.serving.gateway``), delegating to
the port's in-process clients and recording each call.

Every run records what each call served (the requests of a prefill call in
its order, which the plain reference needs to redo a MoE layer's capacity
over the call; a decode call's resident requests and their lengths). With
``timed`` (the ``--trace 1`` run) each call also records CUDA events around
it, a ``record_function`` range named ``client.<call>``, and for a paged
decode engine its ``page_stats()``; the events are read once the window
has closed, so nothing here waits on the device.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class Call:
    kind: str                   # prefill | prefill_chunk | decode | admit
    t0: float
    t1: float = 0.0
    rids: List[int] = field(default_factory=list)
    lens: List[int] = field(default_factory=list)   # prompt / context lens
    left: List[int] = field(default_factory=list)   # decode: tokens to go
    n_steps: int = 0
    profiled: bool = False
    reserved_pages: Optional[int] = None
    ev: Optional[tuple] = None
    ms: Optional[float] = None


class Recorder:
    """The calls of one run, and whether the profiler is on."""

    def __init__(self, timed: bool, device):
        self.timed = timed and torch.device(device).type == "cuda"
        self.calls: List[Call] = []
        self.profiling = False
        self.rid_of = {}            # id(GenRequest) -> benchmark rid

    def begin(self, call: Call):
        call.profiled = self.profiling
        if self.timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            call.ev = ev
        self.calls.append(call)
        return call

    def end(self, call: Call):
        if call.ev is not None:
            call.ev[1].record()
        call.t1 = time.perf_counter()

    def resolve(self):
        """Read every call's CUDA events (after a synchronize)."""
        if self.timed:
            torch.cuda.synchronize()
        for c in self.calls:
            if c.ev is not None:
                c.ms = c.ev[0].elapsed_time(c.ev[1])
                c.ev = None


def _range(rec: Recorder, name: str):
    if rec.timed or rec.profiling:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class PrefillClient:
    def __init__(self, inner, rec: Recorder):
        self.inner, self.rec = inner, rec
        self.synchronous = True

    def prefill(self, reqs, *, compress, backend):
        c = self.rec.begin(Call("prefill", time.perf_counter(),
                                rids=[self.rec.rid_of[id(r)] for r in reqs],
                                lens=[len(r.tokens) for r in reqs]))
        with _range(self.rec, "client.prefill"):
            out = self.inner.prefill(reqs, compress=compress,
                                     backend=backend)
        self.rec.end(c)
        return out

    def prefill_chunk(self, jobs, budget, *, compress, backend):
        c = self.rec.begin(Call("prefill_chunk", time.perf_counter(),
                                rids=[self.rec.rid_of[id(j.req)]
                                      for j in jobs]))
        with _range(self.rec, "client.prefill_chunk"):
            out = self.inner.prefill_chunk(jobs, budget, compress=compress,
                                           backend=backend)
        self.rec.end(c)
        return out

    def supports_suffix(self) -> bool:
        return self.inner.supports_suffix()

    def jit_cache_size(self) -> int:
        return self.inner.jit_cache_size()


class DecodeClient:
    def __init__(self, inner, rec: Recorder, paged: bool):
        self.inner, self.rec, self.paged = inner, rec, paged
        self.synchronous = True

    def admit(self, batch, *, backend):
        c = self.rec.begin(Call("admit", time.perf_counter(),
                                rids=[self.rec.rid_of[id(it.req)]
                                      for it in batch.items]))
        with _range(self.rec, "client.admit"):
            out = self.inner.admit(batch, backend=backend)
        self.rec.end(c)
        return out

    def step(self, n_steps=None):
        res = self.inner.resident()
        n = n_steps or self.inner.engine.chunk_size
        c = Call("decode", time.perf_counter(),
                 rids=[self.rec.rid_of[id(r)] for r in res],
                 lens=[len(r.tokens) + len(r.out_tokens) - 1 for r in res],
                 left=[r.max_new_tokens - len(r.out_tokens) for r in res],
                 n_steps=n)
        if self.rec.timed and self.paged:
            c.reserved_pages = int(self.inner.page_stats()["reserved_tokens"]
                                   // self.inner.engine.page_size)
        self.rec.begin(c)
        with _range(self.rec, "client.decode"):
            out = self.inner.step(n_steps)
        self.rec.end(c)
        return out

    def n_free(self) -> int:
        return self.inner.n_free()

    @property
    def active(self) -> int:
        return self.inner.active

    def resident(self):
        return self.inner.resident()

    def release(self, req) -> bool:
        return self.inner.release(req)

    def extract_resident(self, *, compress, backend):
        return self.inner.extract_resident(compress=compress,
                                           backend=backend)

    def page_stats(self):
        return self.inner.page_stats()

    def prefix_match(self, tokens):
        return self.inner.prefix_match(tokens)

    def prefix_pin(self, pages, tag) -> bool:
        return self.inner.prefix_pin(pages, tag)

    def prefix_unpin(self, tag):
        self.inner.prefix_unpin(tag)

    def extract_prefix(self, pages, length):
        return self.inner.extract_prefix(pages, length)

    def jit_cache_size(self) -> int:
        return self.inner.jit_cache_size()
