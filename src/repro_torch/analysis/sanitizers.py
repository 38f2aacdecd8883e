"""Runtime sanitizers for the port's serving stack (``REPRO_SANITIZE=1``):
the port of ``repro.analysis.sanitizers``.

They audit the *running* system: a page leaked because an exception
skipped the release path, a double free that only happens under
preemption racing a finish, a request whose recorded history disagrees
with its final state, a decode loop that re-captures its CUDA graph in
steady state, a migrated wire that silently re-encoded because its rows
stopped lining up with page rows.

Everything here is opt-in: the gateway installs the hooks only when
``REPRO_SANITIZE=1`` (see :func:`sanitize_enabled`), and violations raise
:class:`SanitizerError` with the captured allocation/free sites so the
failure points at the buggy call site, not at the audit that noticed it.
:class:`RetraceMonitor` reads the decode clients' ``jit_cache_size``,
which in the port counts the decode chunk's captured CUDA graphs
(``registry.GraphedDecodeChunk``).

A copy of the reference module: ``tests/test_torch_isolation.py`` holds
it to the reference's AST, definition by definition (imports and
docstrings aside); ``_site`` filters the port's own frames. The serving
modules are imported lazily, as in the reference.
"""
from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional, Sequence, Tuple


class SanitizerError(RuntimeError):
    """An enforced runtime invariant was violated."""


def sanitize_enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "").strip() not in (
        "", "0", "false", "no")


def _site(skip: int = 2, limit: int = 8) -> str:
    """Compact formatted stack of the caller's caller (the interesting
    frame), newest last."""
    frames = traceback.extract_stack()[:-skip]
    frames = [f for f in frames
              if "/repro_torch/analysis/" not in f.filename]
    return "".join(traceback.format_list(frames[-limit:]))


# -- page-pool sanitizer ------------------------------------------------------


def make_sanitized_pool(num_pages: int, page_size: int):
    """A :class:`~repro_torch.serving.page_pool.PagePool` that remembers
    WHERE every live page was allocated and where every dead page was
    freed, so double-free / use-after-free / leak reports carry the
    offending call sites instead of just a page number."""
    from repro_torch.serving.page_pool import PagePool

    class SanitizedPagePool(PagePool):
        def __init__(self, n, ps):
            super().__init__(n, ps)
            self._alloc_site: Dict[int, str] = {}
            self._free_site: Dict[int, str] = {}
            self._share_site: Dict[Tuple[int, object], str] = {}

        def alloc(self, n, owner):
            pages = super().alloc(n, owner)
            if pages:
                site = _site()
                for p in pages:
                    self._alloc_site[p] = site
                    self._free_site.pop(p, None)
            return pages

        def share(self, pages, owner):
            super().share(pages, owner)
            site = _site()
            for p in pages:
                self._share_site[(p, owner)] = site

        def free(self, pages, owner=None):
            for p in pages:
                owners = self._owners.get(p)
                if owners is None:
                    prior = self._free_site.get(p)
                    if prior is not None:
                        raise SanitizerError(
                            f"double free of page {p}: already freed "
                            f"at:\n{prior}second free at:\n{_site()}")
                    raise SanitizerError(
                        f"free of never-allocated page {p} at:\n{_site()}")
                if owner is not None and owner not in owners:
                    held = (f"slot {next(iter(owners))}" if len(owners) == 1
                            else str(sorted(map(repr, owners))))
                    raise SanitizerError(
                        f"use-after-free hazard: releasing page {p} as "
                        f"owner {owner!r} but it is owned by {held} "
                        f"(allocated at:\n{self._alloc_site.get(p, '?')})"
                        f"\nrelease attempted at:\n{_site()}")
            site = _site()
            super().free(pages, owner)
            for p in pages:
                if p not in self._owners:       # refcount hit 0: truly freed
                    self._free_site[p] = site
                    self._alloc_site.pop(p, None)
                if owner is not None:
                    self._share_site.pop((p, owner), None)

        def check_empty(self, context: str = ""):
            """Assert no live pages remain (drained gateway teardown)."""
            if self._owners:
                lines = []
                for p in sorted(self._owners):
                    who = sorted(map(repr, self._owners[p]))
                    lines.append(
                        f"  page {p} (held by {who}) allocated at:\n"
                        f"{self._alloc_site.get(p, '    <unknown>')}")
                raise SanitizerError(
                    f"page leak{' in ' + context if context else ''}: "
                    f"{len(self._owners)} page(s) still referenced after "
                    f"drain:\n" + "\n".join(lines))

    return SanitizedPagePool(num_pages, page_size)


def audit_paged_engine(engine, context: str = ""):
    """Cross-check a DecodeEngine's references against its pool's
    refcounted owner map. The engine's legitimate reference holders are
    its slot chains, its prefix-cache index, and its in-flight pins —
    every in-use page must be covered by at least one of them (else a
    release path leaked it), and every reference the engine holds must be
    backed by a live refcount under the matching owner tag (else a stale
    table row points at freed or re-owned pages)."""
    pool = getattr(engine, "pool", None)
    if pool is None:
        return
    where = f" in {context}" if context else ""
    slot_pages = getattr(engine, "_slot_pages", {})
    cache = getattr(engine, "prefix_cache", None)
    cache_pages = set(cache.page_set()) if cache is not None else set()
    pins = dict(getattr(engine, "_pins", {}))
    referenced = ({p for ps in slot_pages.values() for p in ps}
                  | cache_pages
                  | {p for ps in pins.values() for p in ps})
    in_use = set(pool.pages_in_use())
    leaked = sorted(in_use - referenced)
    if leaked:
        sites = ""
        alloc_site = getattr(pool, "_alloc_site", {})
        for p in leaked[:4]:
            if p in alloc_site:
                sites += f"\npage {p} allocated at:\n{alloc_site[p]}"
        raise SanitizerError(
            f"page leak{where}: pool holds pages {leaked} that no slot "
            f"chain, prefix-cache entry, or pin references (a release "
            f"path skipped pool.free/unshare)" + sites)
    expected = [(s, p) for s, ps in slot_pages.items() for p in ps]
    if cache is not None:
        expected += [(cache.owner, p) for p in cache_pages]
    expected += [(tag, p) for tag, ps in pins.items() for p in ps]
    for owner, p in expected:
        owners = pool.owners_of(p)
        if not owners:
            raise SanitizerError(
                f"use-after-free{where}: {owner!r} references freed "
                f"page {p}")
        if owner not in owners:
            raise SanitizerError(
                f"page ownership mismatch{where}: page {p} referenced by "
                f"{owner!r} in the engine but refcounted for "
                f"{sorted(map(repr, owners))} in the pool")


# -- request state-machine auditor --------------------------------------------

# independent copy of the DESIGN.md §5 transition table — deliberately NOT
# imported from gateway.py, so a drive-by edit there trips the audit here
_LEGAL: Dict[str, Tuple[str, ...]] = {
    # QUEUED -> TRANSFERRING is the full-prefix-hit fast path: every
    # prompt token is already resident in the decode replica's radix
    # cache, so the request skips the prefill stage outright and only a
    # page-handle "wire" (no tensors) moves (DESIGN.md §10).
    "QUEUED": ("PREFILLING", "TRANSFERRING", "CANCELLED", "REJECTED",
               "FAILED"),
    "PREFILLING": ("TRANSFERRING", "QUEUED", "CANCELLED", "FAILED"),
    "TRANSFERRING": ("DECODING", "QUEUED", "CANCELLED", "FAILED"),
    "DECODING": ("DONE", "QUEUED", "TRANSFERRING", "CANCELLED", "FAILED"),
    "DONE": (),
    "CANCELLED": (),
    "REJECTED": (),
    "FAILED": (),
}
_NEEDS_REASON = ("FAILED", "REJECTED")


class TransitionAuditor:
    """Validates finished requests against the §5 state machine using the
    recorded ``history`` — catching both illegal edges and state fields
    that were assigned around ``_transition``."""

    def __init__(self):
        self.audited = 0
        self.illegal = 0

    def audit(self, handle, context: str = ""):
        where = f" in {context}" if context else ""
        rid = getattr(getattr(handle, "request", None), "rid",
                      getattr(handle, "rid", "?"))
        hist = list(getattr(handle, "history", ()))
        state = _state_name(handle.state)
        self.audited += 1
        if not hist:
            self._fail(f"request {rid}{where}: empty history")
        chain = [_state_name(s) for _, s in hist]
        if chain[0] != "QUEUED":
            self._fail(f"request {rid}{where}: history starts at "
                       f"{chain[0]}, not QUEUED")
        for prev, nxt in zip(chain, chain[1:]):
            if nxt not in _LEGAL.get(prev, ()):
                self._fail(
                    f"request {rid}{where}: illegal transition "
                    f"{prev} -> {nxt} (history: {' -> '.join(chain)}); "
                    f"legal from {prev}: {list(_LEGAL.get(prev, ()))}")
        if chain[-1] != state:
            self._fail(
                f"request {rid}{where}: state is {state} but history "
                f"ends at {chain[-1]} — state was assigned without "
                f"_transition (history: {' -> '.join(chain)})")
        if state in _NEEDS_REASON and not getattr(handle, "reason", None):
            self._fail(f"request {rid}{where}: terminal {state} carries "
                       f"no reason")
        times = [t for t, _ in hist]
        if any(b < a for a, b in zip(times, times[1:])):
            self._fail(f"request {rid}{where}: history timestamps go "
                       f"backwards ({times})")

    def _fail(self, msg: str):
        self.illegal += 1
        raise SanitizerError(msg + "\n    (DESIGN.md §5 / lint rule R004 "
                             "govern this state machine)")


def _state_name(s) -> str:
    return getattr(s, "name", str(s))


# -- jit retrace monitor ------------------------------------------------------


class RetraceMonitor:
    """Flags steady-state recompiles in the DECODE loop: after warmup, a
    decode replica's jit caches must be size-stable (DESIGN.md §3 — the
    loop is fixed-shape by construction), so growth means a shape or a
    hashable static argument is churning per step (a silent 100x
    slowdown). Prefill is deliberately out of scope: it compiles one
    variant per pow2 length bucket and admitted batch shape, bounded but
    trace-dependent, so its cache may legitimately grow past warmup."""

    def __init__(self):
        self._baseline: Optional[Dict[str, int]] = None

    @staticmethod
    def _sizes(gw) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, handles in (("dec", gw.dec),):
            for i, h in enumerate(handles):
                client = getattr(h, "client", None)
                n = getattr(client, "jit_cache_size", None)
                if callable(n):
                    n = n()
                if n is not None:
                    out[f"{kind}[{i}]"] = int(n)
        return out

    def mark_steady(self, gw):
        """Snapshot cache sizes; call once the pipeline is warm."""
        self._baseline = self._sizes(gw)

    def check(self, gw, context: str = ""):
        if self._baseline is None:
            return
        now = self._sizes(gw)
        grew = {k: (self._baseline.get(k, 0), v) for k, v in now.items()
                if v > self._baseline.get(k, v)}
        if grew:
            where = f" in {context}" if context else ""
            detail = ", ".join(f"{k}: {a} -> {b}" for k, (a, b)
                               in sorted(grew.items()))
            raise SanitizerError(
                f"steady-state jit retrace{where}: compile caches grew "
                f"after warmup ({detail}) — a shape or static arg is "
                f"churning per step")


# -- wire alignment -----------------------------------------------------------


def check_wire_alignment(wire, cfg, context: str = ""):
    """A migrated (decode->decode) wire must scatter zero-copy: its int4
    rows must already be page rows. Re-encoding here means
    ``extract_slot_wire`` / ``insert_wires`` drifted apart and every
    migration silently pays a dequant+quant round-trip."""
    from repro_torch.models import paged
    from repro_torch.serving.page_pool import _wire_rows_aligned
    g = paged.page_group(cfg)
    ppr = paged.groups_per_token(cfg)
    bad: List[str] = []
    for name, slot_wire in wire.slots.items():
        for key, wt in slot_wire.items():
            if wt.kind == "int4" and not _wire_rows_aligned(wt, g, ppr):
                pk = wt.payload["packed"]
                bad.append(f"{name}.{key}: rows {tuple(pk.shape)} vs "
                           f"expected ({wire.request_len * wt.orig_shape[0] * ppr}, {g // 2})")
            elif wt.kind != "int4":
                bad.append(f"{name}.{key}: kind={wt.kind!r} (not int4)")
    if bad:
        where = f" in {context}" if context else ""
        raise SanitizerError(
            f"misaligned migration wire{where} — insertion will silently "
            f"re-encode (group g={g}, ppr={ppr}):\n  "
            + "\n  ".join(bad)
            + "\n    (layout contract: kernels/kv_layout.py, rule R005)")


# -- gateway-level orchestration ----------------------------------------------


class GatewaySanitizer:
    """The hooks a Gateway installs under ``REPRO_SANITIZE=1``:

    * every finished/terminal request runs :class:`TransitionAuditor`;
    * on drain, live decode replicas get :func:`audit_paged_engine` and
      the retrace check; at teardown sanitized pools ``check_empty``.
    """

    def __init__(self):
        self.transitions = TransitionAuditor()
        self.retrace = RetraceMonitor()

    def on_finish(self, handle):
        self.transitions.audit(handle, context="on_finish")

    def on_steady(self, gw):
        self.retrace.mark_steady(gw)

    def check(self, gw, context: str = "drain"):
        for h in gw.done:
            if not _LEGAL.get(_state_name(h.state), ("x",)):  # terminal
                self.transitions.audit(h, context=context)
        for d in gw.dec:
            if not getattr(d, "alive", True):
                continue  # a crashed replica's residents are accounted
            ps = getattr(d.client, "page_stats", None)
            stats = ps() if callable(ps) else None
            if stats and stats.get("leaked_pages"):
                raise SanitizerError(
                    f"{context}: decode[{d.idx}] reports "
                    f"{stats['leaked_pages']} leaked page(s)")
            eng = getattr(d, "engine", None)   # None for RPC clients
            if eng is not None:
                audit_paged_engine(eng, context=f"{context}/dec[{d.idx}]")
        self.retrace.check(gw, context=context)

    def stats(self) -> Dict[str, int]:
        return {"transitions_audited": self.transitions.audited,
                "transition_violations": self.transitions.illegal}
