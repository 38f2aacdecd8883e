"""Host spans of the serving path: where the gateway's pump and the
engines spend the host's time, on the device trace's clock.

One process-wide tracer, so no constructor or signature carries it::

    with trace.span("decode.chunk") as sp:
        if sp:                       # attributes cost only when on
            sp.set(steps=n, residents=...)
        ...

It is on while :func:`enable`\\ d, or while a ``torch.profiler`` records in
the process. Under a profiler each span also opens a
``torch.profiler.record_function`` range of the same name, so Kineto
carries the spans on the device trace's own clock (a trace reader names
an idle gap of the device by the innermost range open across it). Its own
records go into a ring of :data:`RING` entries, stamped with
``time.perf_counter`` (never the wall clock), and are read back with
:func:`spans`. Nothing here synchronizes the device.

Off, :func:`span` returns the one shared :data:`NOOP` (falsy, allocates
nothing) after one probe of the profiler's state.

:func:`device_ms` times a block on the card with a pair of CUDA events
and adds the milliseconds to an attribute of an enclosing span, read when
that span closes: the enclosing span has by then waited for the device
itself (a prefill call copies its first tokens back), so the reading adds
no synchronization.

No span goes in code a CUDA graph captures (``models/registry.py``'s
chunk): a capture records device work only.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, NamedTuple

import torch

# finished spans kept; the oldest go first
RING = 1 << 16


class Record(NamedTuple):
    name: str
    t0: float
    t1: float
    depth: int              # spans open around it when it opened
    attrs: Dict[str, object]


_enabled = False
_clock = time.perf_counter
_ring: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()
_profiling = torch.autograd._profiler_enabled


def enable():
    """Record spans until :func:`disable`."""
    global _enabled
    _enabled = True


def disable():
    """Stop recording (a running profiler still turns spans on)."""
    global _enabled
    _enabled = False


def clear():
    _ring.clear()


def spans(t0: float = float("-inf"), t1: float = float("inf")
          ) -> List[Record]:
    """Finished spans lying inside ``[t0, t1]``, in the order they
    closed."""
    return [r for r in list(_ring) if t0 <= r.t0 and r.t1 <= t1]


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "t0", "depth", "_rf", "events")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name, self.attrs = name, attrs
        self.events = None          # [(attribute, start, end)] to read

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        self.depth = len(st)
        st.append(self)
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        if self.events and exc[0] is None:
            a = self.attrs
            for key, e0, e1 in self.events:
                a[key] = a.get(key, 0.0) + e0.elapsed_time(e1)
        _ring.append(Record(self.name, self.t0, t1, self.depth, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager timing its body as ``name`` (a live span when the
    tracer is on, else :data:`NOOP`)."""
    if _enabled or _profiling():
        return _Span(name, attrs)
    return NOOP


def _open(name: str):
    """The innermost open span called ``name``, or None."""
    for sp in reversed(getattr(_local, "stack", None) or ()):
        if sp.name == name:
            return sp
    return None


def add_to(name: str, **counts):
    """:func:`add` to the innermost open span called ``name``; nothing
    when none is open."""
    sp = _open(name)
    if sp is not None:
        for k, v in counts.items():
            sp.attrs[k] = sp.attrs.get(k, 0) + v


class _DeviceTimer:
    __slots__ = ("owner", "key", "e0")

    def __init__(self, owner: _Span, key: str):
        self.owner, self.key = owner, key

    def __enter__(self):
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record()
        return self

    def __exit__(self, *exc):
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        if self.owner.events is None:
            self.owner.events = []
        self.owner.events.append((self.key, self.e0, e1))
        return False


def device_ms(owner: str, key: str, device):
    """Time the block on ``device`` with CUDA events; the innermost open
    span called ``owner`` adds the milliseconds to its attribute ``key``
    when it closes. :data:`NOOP` when the tracer is off, no such span is
    open or ``device`` is not a CUDA device."""
    if torch.device(device).type != "cuda":
        return NOOP
    sp = _open(owner)
    return NOOP if sp is None else _DeviceTimer(sp, key)


def add(**counts):
    """Add ``counts`` to the innermost open span's attributes (summed with
    what it holds); nothing when no span is open."""
    st = getattr(_local, "stack", None)
    if st:
        a = st[-1].attrs
        for k, v in counts.items():
            a[k] = a.get(k, 0) + v
