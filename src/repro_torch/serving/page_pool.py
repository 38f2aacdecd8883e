"""Host-side page allocator for the paged decode cache + KV-wire insertion
(the port of ``repro.serving.page_pool``).

:class:`PagePool` is the reference's pure-Python refcounted allocator,
copied (``tests/test_torch_isolation.py`` drives both with the same
operations and holds their states equal). The functions below move KV
between wires and the pages of ``models/paged.py``. A wire from the
bucketed prefill (``kv_transfer.extract_batch(pad_to=...)``) carries
POSITION-ALIGNED int4 groups, row ``t*ppr + r`` = token t's r-th group,
exactly an int4 page's row order, so insertion is a pure uint8/f32
scatter (zero-copy: no dequantization, no requantization). Other wires
are re-encoded on arrival with one dequant + quant. bf16 pages take a
wire dequantized to token rows and give back raw wires.

Where the reference returns updated arrays, these functions write the
cache's page buffers, page table and lengths IN PLACE (index tensors are
int64 on the cache's device) and return the same dict. Page 0 is the
TRASH page; the allocator never hands it out.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import paged
from repro_torch.serving.kv_transfer import (KVWire, WireTensor, _dequantize,
                                             _dtype_name)


class PagePool:
    """Fixed-size-page allocator over ``num_pages`` pages (page 0 is the
    trash page and is never allocated). LIFO free list: a released
    request's pages are the next handed out, which keeps the hot page set
    small.

    Pages are REFCOUNTED: ``alloc`` grants the first reference,
    ``share`` adds one for a new owner (prefix-cache sharing), and
    ``free``/``unshare`` drop one owner's reference — a page returns to
    the free list only when its last owner releases it. Owner tags are
    arbitrary hashables (slot indices, the prefix cache's tag, in-flight
    pin tags); an owner holds at most one reference per page. All
    refcount/free-list mutation lives HERE (lint rule R006) — everything
    else goes through this API.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owners: Dict[int, Set[Hashable]] = {}   # page -> owner tags
        self._by_owner: Dict[Hashable, Set[int]] = {}  # owner -> its pages
        # stats
        self.allocs = 0
        self.frees = 0
        self.shares = 0
        self.unshares = 0
        self.alloc_failures = 0
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._owners)

    @property
    def n_shared(self) -> int:
        """Pages currently held by more than one owner."""
        return sum(1 for s in self._owners.values() if len(s) > 1)

    @property
    def capacity(self) -> int:
        """Allocatable pages (total minus the trash page)."""
        return self.num_pages - 1

    def owned_by(self, owner: Hashable) -> List[int]:
        """Pages this owner holds a reference on — O(pages held), via the
        per-owner index (not a scan of the whole pool)."""
        return sorted(self._by_owner.get(owner, ()))

    def owners_of(self, page: int) -> frozenset:
        return frozenset(self._owners.get(page, frozenset()))

    def refcount(self, page: int) -> int:
        return len(self._owners.get(page, ()))

    def pages_in_use(self) -> List[int]:
        return sorted(self._owners)

    def _grant(self, page: int, owner: Hashable):
        self._owners.setdefault(page, set()).add(owner)
        self._by_owner.setdefault(owner, set()).add(page)

    def _revoke(self, page: int, owner: Hashable) -> bool:
        """Drop one owner's reference; True when the page became free."""
        owners = self._owners[page]
        owners.discard(owner)
        held = self._by_owner.get(owner)
        if held is not None:
            held.discard(page)
            if not held:
                del self._by_owner[owner]
        if owners:
            return False
        del self._owners[page]
        self._free.append(page)
        return True

    def alloc(self, n: int, owner: Hashable) -> Optional[List[int]]:
        """Take ``n`` pages for ``owner`` (a slot index); None if the pool
        cannot satisfy the request — all-or-nothing, no partial grants."""
        if n <= 0:
            return []
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._grant(p, owner)
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        return pages

    def share(self, pages: Sequence[int], owner: Hashable):
        """Add ``owner``'s reference to already-allocated pages (prefix
        sharing). Batch-validated before any mutation: every page must be
        in use and not already held by this owner."""
        seen: Set[int] = set()
        for p in pages:
            if p in seen:
                raise ValueError(f"page {p} listed twice in one share()")
            seen.add(p)
            owners = self._owners.get(p)
            if owners is None:
                raise ValueError(f"share of free/foreign page {p}")
            if owner in owners:
                raise ValueError(f"owner {owner!r} already holds page {p}")
        for p in pages:
            self._grant(p, owner)
        self.shares += len(seen)

    def free(self, pages: Sequence[int], owner: Optional[Hashable] = None):
        """Release ``owner``'s reference on each page; a page returns to
        the free list only when its refcount hits 0. With ``owner=None``
        (legacy single-owner call) each page must have exactly one owner.
        Validates the WHOLE batch before mutating anything, so a bad call
        (double free, page listed twice, page not held by ``owner``)
        raises without corrupting the free list with a partial free."""
        seen: Set[int] = set()
        for p in pages:
            if p in seen:
                raise ValueError(f"page {p} listed twice in one free()")
            seen.add(p)
            owners = self._owners.get(p)
            if owners is None:
                raise ValueError(f"double free / foreign page {p}")
            if owner is None:
                if len(owners) != 1:
                    raise ValueError(
                        f"page {p} is shared by {sorted(map(repr, owners))}; "
                        f"free() needs an explicit owner")
            elif owner not in owners:
                if len(owners) == 1:
                    raise ValueError(
                        f"page {p} is owned by slot {next(iter(owners))}, "
                        f"not {owner!r}")
                raise ValueError(
                    f"page {p} is shared by {sorted(map(repr, owners))}; "
                    f"{owner!r} holds no reference")
        for p in pages:
            o = owner if owner is not None else next(iter(self._owners[p]))
            if self._revoke(p, o):
                self.frees += 1
            else:
                self.unshares += 1

    def unshare(self, pages: Sequence[int], owner: Hashable):
        """Drop ``owner``'s reference on shared pages — same release path
        as :meth:`free` (a page whose last reference drops goes back to
        the free list), with the owner always explicit."""
        self.free(pages, owner=owner)

    def snapshot(self):
        """Opaque deep copy of the allocator state (free list, refcount
        maps, counters) — with :meth:`restore`, the ONE sanctioned way to
        branch/rewind pool state from outside this module (rule R006:
        the model checker forks states without touching internals)."""
        return (list(self._free),
                {p: set(o) for p, o in self._owners.items()},
                {o: set(p) for o, p in self._by_owner.items()},
                (self.allocs, self.frees, self.shares, self.unshares,
                 self.alloc_failures, self.peak_in_use))

    def restore(self, snap):
        """Rewind to a :meth:`snapshot` (same pool geometry assumed)."""
        free, owners, by_owner, counters = snap
        self._free = list(free)
        self._owners = {p: set(o) for p, o in owners.items()}
        self._by_owner = {o: set(p) for o, p in by_owner.items()}
        (self.allocs, self.frees, self.shares, self.unshares,
         self.alloc_failures, self.peak_in_use) = counters

    def canonicalize(self):
        """Sort the free list into a fixed order. Free-list order is
        semantically irrelevant (any free page serves any alloc) but LIFO
        recycling makes :meth:`state_key` distinguish states that differ
        only by allocation history — the model checker calls this after
        every event as a symmetry reduction, collapsing those
        permutations so its search closes."""
        self._free.sort()

    def state_key(self) -> Tuple:
        """Hashable identity of the allocator state (owner tags by repr)
        — the model checker's visited-state key."""
        return (tuple(self._free),
                tuple(sorted((p, tuple(sorted(repr(o) for o in owners)))
                             for p, owners in self._owners.items())))

    def occupancy(self) -> float:
        return self.n_in_use / max(self.capacity, 1)

    def stats(self) -> Dict[str, float]:
        return {"pages": self.capacity, "page_size": self.page_size,
                "in_use": self.n_in_use, "free": self.n_free,
                "occupancy": self.occupancy(),
                "peak_in_use": self.peak_in_use, "allocs": self.allocs,
                "frees": self.frees, "shares": self.shares,
                "unshares": self.unshares, "shared_pages": self.n_shared,
                "alloc_failures": self.alloc_failures}


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, -(-n_tokens // page_size))


def _wire_rows_aligned(wt: WireTensor, g: int, ppr: int) -> bool:
    """True when an int4 wire tensor's rows map 1:1 onto page rows."""
    if wt.kind != "int4":
        return False
    L, ln, Hkv, hd = wt.orig_shape
    packed = wt.payload["packed"]
    return (packed.shape[1] == g // 2
            and packed.shape[0] == L * ln * ppr)


def _wire_to_rows(wt: WireTensor, cfg, backend: str):
    """(packed, scale, zero, zero_copy) rows in page row order for one wire
    tensor: the wire's own rows when the layout already matches, else one
    dequant + quant."""
    g = paged.page_group(cfg)
    ppr = paged.groups_per_token(cfg)
    if _wire_rows_aligned(wt, g, ppr):
        return (wt.payload["packed"], wt.payload["scale"],
                wt.payload["zero"], True)
    dense = _dequantize(wt, backend)               # (L, ln, Hkv, hd)
    L, ln = dense.shape[:2]
    packed, scale, zero = ops.kv_quant(
        dense.reshape(L * ln * ppr, g).contiguous(), backend=backend)
    return packed, scale, zero, False


def insert_wires(cache, cfg, items: Sequence[Tuple], *,
                 backend: str = "auto"):
    """Scatter transferred requests into their allocated pages.

    ``items`` = (wire, slot_index, pages[, prefix_pages]) with ``pages``
    allocated by the :class:`PagePool`. ``prefix_pages`` SPLICES the wire
    onto a shared, page-aligned prefix chain: wire token 0 is absolute
    position ``len(prefix_pages) * page_size``, the table row becomes
    ``prefix_pages + pages`` and the length covers the whole chain; prefix
    pages are never written. Returns (cache, n_zero_copy, n_reencoded)."""
    int4 = "kp" in cache["slot0"]
    ps = cache_page_size(cache, cfg)
    ppr = paged.groups_per_token(cfg)
    g = paged.page_group(cfg)
    pt = cache["page_table"]
    W = pt.shape[1]
    dev = pt.device
    n_zero, n_reenc = 0, 0
    for item in items:
        wire, slot, pages = item[0], item[1], item[2]
        prefix = list(item[3]) if len(item) > 3 and item[3] else []
        ln = wire.request_len
        need = pages_needed(ln, ps)
        if len(pages) < need or len(prefix) + need > W:
            raise ValueError(
                f"slot {slot}: {len(pages)} page(s) for a {ln}-token wire "
                f"(needs {need}, prefix {len(prefix)}, table width {W})")
        tpos = np.arange(ln)
        dst_page = torch.as_tensor(
            np.asarray(pages, np.int64)[tpos // ps][:, None], device=dev)
        if int4:
            rows = torch.as_tensor((tpos % ps)[:, None] * ppr
                                   + np.arange(ppr)[None], device=dev)
        else:
            dst_off = torch.as_tensor(tpos % ps, device=dev)
        for name, slot_wire in wire.slots.items():
            buf = cache[name]
            for base in ("k", "v"):
                wt = slot_wire.get(base)
                if wt is None:
                    continue
                if not int4:
                    # bf16 pages: dequantize and scatter the token rows
                    buf[base][:, dst_page[:, 0], dst_off] = \
                        _dequantize(wt, backend).to(buf[base].dtype)
                    continue
                packed, scale, zero, aligned = _wire_to_rows(wt, cfg,
                                                             backend)
                n_zero += int(aligned)
                n_reenc += int(not aligned)
                L = wt.orig_shape[0]
                for suffix, val, width in (("p", packed, g // 2),
                                           ("s", scale, 1), ("z", zero, 1)):
                    buf[base + suffix][:, dst_page, rows] = \
                        val.reshape(L, ln, ppr, width)
        set_page_chain(cache, slot, prefix + list(pages),
                       len(prefix) * ps + ln)
    return cache, n_zero, n_reenc


def set_page_chain(cache, slot: int, pages: Sequence[int], length: int):
    """Point a slot's table row at a page chain (rest of the row: trash)
    and set its length."""
    W = cache["page_table"].shape[1]
    if len(pages) > W:
        raise ValueError(f"chain of {len(pages)} pages exceeds table "
                         f"width {W}")
    row = np.zeros((W,), np.int32)
    row[:len(pages)] = pages
    cache["page_table"][slot] = torch.as_tensor(
        row, device=cache["page_table"].device)
    cache["lengths"][slot] = length
    return cache


def copy_page(cache, src_page: int, dst_page: int):
    """Copy one page's contents across every layer tensor: the
    copy-on-write step before a slot appends to a page it shares."""
    for name, buf in cache.items():
        if name in ("page_table", "lengths"):
            continue
        for a in buf.values():
            a[:, dst_page] = a[:, src_page]
    return cache


def extract_slot_wire(cache, cfg, ln: int, pages: Sequence[int]) -> KVWire:
    """Gather one resident slot's pages back into a :class:`KVWire` (prefix
    extraction for a partial hit, and migration). A pure page gather: int4
    pages already hold the wire's position-aligned encoding, so the result
    scatters zero-copy into another pool; bf16 pages ship raw tokens."""
    int4 = "kp" in cache["slot0"]
    ps = cache_page_size(cache, cfg)
    ppr = paged.groups_per_token(cfg)
    g = paged.page_group(cfg)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    if pages_needed(ln, ps) > len(pages):
        raise ValueError(f"{ln}-token slot spans more than {len(pages)} "
                         f"page(s)")
    pg = torch.as_tensor(np.asarray(pages, np.int64),
                         device=cache["page_table"].device)
    slots: Dict[str, Dict[str, WireTensor]] = {}
    for name, buf in cache.items():
        if name in ("page_table", "lengths"):
            continue
        out: Dict[str, WireTensor] = {}
        for base in ("k", "v"):
            if not int4:
                a = buf[base][:, pg]              # (L, n_pg, ps, Hkv, hd)
                t = a.reshape(a.shape[0], len(pages) * ps, Hkv, hd)[:, :ln]
                out[base] = WireTensor("raw", {"x": t}, tuple(t.shape),
                                       _dtype_name(t))
                continue
            payload = {}
            for suffix, wkey, width in (("p", "packed", g // 2),
                                        ("s", "scale", 1), ("z", "zero", 1)):
                a = buf[base + suffix][:, pg]             # (L, n_pg, R, w)
                L = a.shape[0]
                payload[wkey] = a.reshape(
                    L, len(pages) * ps, ppr, width)[:, :ln].reshape(
                    -1, width)
            out[base] = WireTensor("int4", payload, (L, ln, Hkv, hd))
        slots[name] = out
    return KVWire(request_len=ln, slots=slots)


def release_slot(cache, slot: int):
    """Point a released slot's table row back at the trash page and zero
    its length (the pages go back through ``PagePool.free``)."""
    cache["page_table"][slot] = 0
    cache["lengths"][slot] = 0
    return cache


def cache_page_size(cache, cfg) -> int:
    """page_size from the cache shapes (token rows per page)."""
    slot = cache["slot0"]
    if "kp" in slot:
        return slot["kp"].shape[2] // paged.groups_per_token(cfg)
    return slot["k"].shape[2]
