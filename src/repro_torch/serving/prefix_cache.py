"""Radix index over resident KV pages: prefix sharing for the paged pool
(the port's copy of ``repro.serving.prefix_cache``, pure Python).

Serving traffic is dominated by shared prefixes (system prompts, few-shot
preambles, chat history), and the paged int4 cache was laid out so reuse
is pure HOST bookkeeping: pages are read-only to the decode kernel except
each slot's tail append, so a prefix that is already resident can back any
number of concurrent slots. This module is the index that finds it.

Structure: a radix tree at PAGE granularity. Each edge/node covers one
page worth of token ids (``page_size`` tokens; the last node of a donated
chain may be partial) and names the resident page that holds those
tokens' KV. Walking the tree with a prompt yields the longest resident
prefix; the caller shares the returned pages (``PagePool.share``) under
its own owner tag before using them — the tree itself holds ONE reference
per page under :data:`PREFIX_OWNER`, taken at donation time.

Hit classes:

* **full** — every prompt token's KV is resident AND the token following
  the prompt is known from a donor sequence where that token was
  GENERATED (greedy decode is deterministic, so a donor's generated token
  at position ``L`` is exactly what the model would emit after the same
  ``L``-token prefix). Prefill is skipped entirely: the request decodes
  straight off the shared chain, with copy-on-write if its tail page is
  shared. Tokens that were part of a donor's *prompt* are arbitrary user
  text and never satisfy this — full hits require the ``gen`` flag.
* **partial** — the match is truncated DOWN to a page boundary and the
  suffix is prefilled against the dequantized prefix KV
  (``transformer.prefill_suffix``), so shared pages are never written
  mid-page by the insert path.

Eviction: LRU over leaves whose page has no owner besides the tree
(refcount-0 from the outside). Interior nodes become evictable once their
children go. Refcount mutation happens only through the pool API (R006).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.page_pool import PagePool, pages_needed

# the tree's own reference on every adopted page rides under this tag
PREFIX_OWNER = "prefix-cache"


@dataclass
class PrefixMatch:
    """Result of matching a prompt against the index.

    ``length`` counts resident KV tokens covered (== prompt length for a
    full hit, a multiple of ``page_size`` otherwise); ``pages`` is the
    chain backing positions ``0..length-1``; ``next_token`` is the known
    continuation for a full hit (the token the skipped prefill would have
    produced)."""
    length: int
    pages: List[int]
    full: bool
    next_token: Optional[int] = None


class _Node:
    __slots__ = ("tokens", "gen", "page", "children", "parent", "key",
                 "stamp", "tail_token", "tail_gen")

    def __init__(self, tokens: Tuple[int, ...], gen: Tuple[bool, ...],
                 page: int, parent: "_Node", key: Tuple[int, ...]):
        self.tokens = tokens          # this block's token ids (n_valid of them)
        self.gen = gen                # True where the token was model-generated
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.key = key
        self.stamp = 0
        # donor's first token BEYOND this node's KV (chain ended here)
        self.tail_token: Optional[int] = None
        self.tail_gen = False

    @property
    def n_valid(self) -> int:
        return len(self.tokens)


class PrefixCache:
    """Radix index of resident page chains for ONE decode engine's pool
    (pages are pool-local ids; every decode replica indexes its own)."""

    def __init__(self, page_size: int, owner=PREFIX_OWNER):
        self.page_size = page_size
        self.owner = owner
        self._root = _Node((), (), -1, None, ())
        self._clock = 0
        # counters (hit/partial/miss are tallied where routing happens —
        # the gateway — since one prompt may probe several replicas)
        self.n_entries = 0
        self.donations = 0
        self.adopted_pages = 0
        self.upgrades = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------

    def _touch(self, node: _Node):
        self._clock += 1
        while node is not None and node is not self._root:
            node.stamp = self._clock
            node = node.parent

    def match(self, tokens: Sequence[int]) -> Optional[PrefixMatch]:
        """Longest resident prefix of ``tokens``; None on a miss."""
        toks = list(tokens)
        n = len(toks)
        ps = self.page_size
        node, pages, k = self._root, [], 0
        while True:
            rem = n - k * ps
            if rem == 0:
                nt = self._continuation(node)
                if nt is not None:
                    self._touch(node)
                    return PrefixMatch(n, pages, True, nt)
                break
            if rem >= ps:
                blk = tuple(toks[k * ps:(k + 1) * ps])
                child = node.children.get(blk)
                if child is not None:
                    node = child
                    pages.append(child.page)
                    k += 1
                    continue
            if 0 < rem < ps:
                part = tuple(toks[k * ps:])
                hit = self._tail_hit(node, part)
                if hit is not None:
                    page, nt, leaf = hit
                    self._touch(leaf)
                    return PrefixMatch(n, pages + [page], True, nt)
            break
        # partial: page-aligned, and leave >= 1 token for the suffix prefill
        if k * ps >= n:
            k -= 1
            pages.pop()
        if k == 0:
            return None
        self._touch(node)
        return PrefixMatch(k * ps, pages, False, None)

    def _continuation(self, node: _Node) -> Optional[int]:
        """Trusted next token after a prompt ending at ``node``'s
        boundary: a generated-flagged first token of any child edge, or
        the donor's trailing emitted token."""
        if node is self._root:
            return None
        for child in node.children.values():
            if child.gen and child.gen[0]:
                return child.tokens[0]
        if node.tail_token is not None and node.tail_gen:
            return node.tail_token
        return None

    def _tail_hit(self, node: _Node, part: Tuple[int, ...]):
        """Full-hit probe for a prompt ending ``len(part)`` tokens into a
        child edge. Returns (page, next_token, node) or None."""
        r = len(part)
        for child in node.children.values():
            if child.n_valid >= r and child.tokens[:r] == part:
                if child.n_valid > r:
                    if child.gen[r]:
                        return child.page, child.tokens[r], child
                elif child.tail_token is not None and child.tail_gen:
                    return child.page, child.tail_token, child
        return None

    # ------------------------------------------------------------------
    # donation
    # ------------------------------------------------------------------

    def insert(self, tokens: Sequence[int], kv_len: int,
               pages: Sequence[int], gen_from: int, pool: PagePool) -> int:
        """Donate a finished request's chain: ``tokens`` is the full
        sequence (prompt + emitted tokens, possibly one token past the
        resident KV), ``pages`` the chain covering ``kv_len`` resident
        positions, ``gen_from`` the index of the first generated token.
        Blocks already in the tree keep their existing pages (the donor's
        duplicates are simply not adopted; the caller frees its refs as
        usual); new blocks are adopted via ``pool.share`` under the
        tree's owner tag. Returns the number of pages adopted."""
        ps = self.page_size
        kv_len = min(kv_len, len(tokens))
        n_blocks = pages_needed(kv_len, ps) if kv_len > 0 else 0
        node, adopted = self._root, 0
        for j in range(n_blocks):
            lo, hi = j * ps, min((j + 1) * ps, kv_len)
            blk = tuple(tokens[lo:hi])
            gen = tuple(i >= gen_from for i in range(lo, hi))
            page = pages[j]
            if node is not self._root and node.n_valid < ps:
                break  # a partial node can't have children; chain ends
            child = node.children.get(blk) if len(blk) == ps else None
            if child is None:
                child = self._find_covering(node, blk)
            if child is not None:
                # token-identical overlap: OR-merge generated flags
                child.gen = tuple(
                    a or b for a, b in zip(child.gen, gen)
                ) + child.gen[len(gen):]
                node = child
                continue
            ext = self._find_extensible(node, blk)
            if ext is not None:
                # donor's block extends an existing partial leaf: swap to
                # the donor's longer page (old page released by the tree;
                # in-flight sharers keep their own refs on it)
                pool.share([page], self.owner)
                pool.unshare([ext.page], self.owner)
                del node.children[ext.key]
                merged = tuple(a or b for a, b in zip(ext.gen, gen))
                ext.tokens, ext.page = blk, page
                ext.gen = merged + gen[len(merged):]
                ext.key = blk
                ext.tail_token, ext.tail_gen = None, False
                node.children[blk] = ext
                self.upgrades += 1
                adopted += 1
                node = ext
                continue
            pool.share([page], self.owner)
            fresh = _Node(blk, gen, page, node, blk)
            node.children[blk] = fresh
            self.n_entries += 1
            adopted += 1
            node = fresh
        # trailing emitted token past the resident KV: continuation hint
        if node is not self._root and kv_len < len(tokens):
            end = (n_blocks - 1) * ps + node.n_valid
            if end == kv_len:
                t = int(tokens[kv_len])
                if node.tail_token is None or (not node.tail_gen
                                               and kv_len >= gen_from):
                    node.tail_token = t
                    node.tail_gen = kv_len >= gen_from
        self._touch(node)
        self.donations += 1
        self.adopted_pages += adopted
        return adopted

    def _find_covering(self, node: _Node, blk: Tuple[int, ...]):
        """An existing child whose tokens start with ``blk`` (the donor
        adds nothing new for this block)."""
        for child in node.children.values():
            if child.n_valid >= len(blk) and child.tokens[:len(blk)] == blk:
                return child
        return None

    def _find_extensible(self, node: _Node, blk: Tuple[int, ...]):
        """An existing partial leaf that ``blk`` strictly extends."""
        for child in node.children.values():
            if 0 < child.n_valid < len(blk) \
                    and blk[:child.n_valid] == child.tokens:
                return child
        return None

    # ------------------------------------------------------------------
    # eviction / teardown
    # ------------------------------------------------------------------

    def _evictable_leaves(self, pool: PagePool) -> List[_Node]:
        out: List[_Node] = []

        def walk(node: _Node):
            for child in node.children.values():
                if child.children:
                    walk(child)
                elif pool.owners_of(child.page) == {self.owner}:
                    out.append(child)

        walk(self._root)
        return out

    def evict(self, pool: PagePool, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, LRU-first, dropping only leaves
        whose page nobody shares (refcount 0 from outside the tree).
        Returns the number of pages actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves(pool)
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.stamp)
            del victim.parent.children[victim.key]
            pool.unshare([victim.page], self.owner)
            self.n_entries -= 1
            self.evictions += 1
            freed += 1
        return freed

    def clear(self, pool: PagePool) -> int:
        """Drop every entry (replica drain / phase flip): release the
        tree's reference on all pages; externally shared pages survive
        under their other owners."""
        pages = self.page_set()
        if pages:
            pool.unshare(sorted(pages), self.owner)
        n = self.n_entries
        self._root = _Node((), (), -1, None, ())
        self.n_entries = 0
        return n

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def page_set(self) -> set:
        out = set()

        def walk(node: _Node):
            for child in node.children.values():
                out.add(child.page)
                walk(child)

        walk(self._root)
        return out

    def stats(self) -> Dict[str, int]:
        return {"entries": self.n_entries, "pages": len(self.page_set()),
                "donations": self.donations,
                "adopted_pages": self.adopted_pages,
                "upgrades": self.upgrades, "evictions": self.evictions}
