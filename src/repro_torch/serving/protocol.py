"""The serving stack's protocol contracts, as executable data: the port's
copy of ``repro.serving.protocol``.

The JAX package's model checker (``repro.analysis.modelcheck``)
exhaustively explores the reference's copy of these hooks:

* the request lifecycle transition table (:data:`TRANSITIONS`);
* the retire ordering (:func:`retire_steps`): a finished slot's chain is
  DONATED to the prefix index before its references go back to the pool;
* the chunked-prefill advance rules (:func:`chunk_take`,
  :func:`chunk_complete`, :func:`chunk_extract_compress`) and the
  copy-on-write boundary (:func:`cow_boundary`, :func:`cow_needed`).

The port's engines call THIS copy; ``tests/test_torch_isolation.py``
holds it equal to the reference's (the table, and every hook over small
exhaustive ranges), so the checker's guarantees carry over. Stdlib only.
"""
from __future__ import annotations

from typing import Dict, Tuple

# -- request lifecycle --------------------------------------------------------

QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
TRANSFERRING = "TRANSFERRING"
DECODING = "DECODING"
DONE = "DONE"
CANCELLED = "CANCELLED"
REJECTED = "REJECTED"
FAILED = "FAILED"

TERMINAL_STATES = frozenset({DONE, CANCELLED, REJECTED, FAILED})

TRANSITIONS: Dict[str, frozenset] = {
    # QUEUED -> TRANSFERRING: full prefix-cache hit — every prompt
    # token's KV is already resident on a decode replica, so prefill is
    # skipped and the "transfer" is a page handle (DESIGN.md §10)
    QUEUED: frozenset({PREFILLING, TRANSFERRING, CANCELLED, REJECTED,
                       FAILED}),
    # PREFILLING -> QUEUED: the prefill replica crashed mid-batch
    PREFILLING: frozenset({TRANSFERRING, QUEUED, CANCELLED, FAILED}),
    TRANSFERRING: frozenset({DECODING, QUEUED, CANCELLED, FAILED}),
    # DECODING -> TRANSFERRING: mid-stream KV migration off a preempted
    # decode replica (handle_preemption)
    DECODING: frozenset({DONE, QUEUED, TRANSFERRING, CANCELLED, FAILED}),
    DONE: frozenset(), CANCELLED: frozenset(),
    REJECTED: frozenset(), FAILED: frozenset(),
}


def legal(src: str, dst: str) -> bool:
    """True when ``src -> dst`` is an edge of the lifecycle machine."""
    return dst in TRANSITIONS.get(src, frozenset())


# -- retire ordering (page donation vs. free) ---------------------------------


def retire_steps(donate: bool) -> Tuple[str, ...]:
    """Ordered operations for retiring a finished slot's page chain.

    ``("donate", "free")``: the prefix index takes its references on the
    chain (``PrefixCache.insert`` -> ``pool.share``) while the slot still
    holds its own, THEN the slot's references are released. Reversing the
    order frees the chain first, and the donation shares pages that are
    already back on the free list — ``PagePool.share`` raises "share of
    free/foreign page", which is exactly the counterexample the checker's
    pool model produces for the mutated ordering."""
    return ("donate", "free") if donate else ("free",)


# -- copy-on-write boundary (prefix-hit admission) ----------------------------


def cow_boundary(prompt_len: int, page_size: int, table_w: int) -> int:
    """Chain index of the page the NEXT decode append writes into, for a
    full prefix hit of ``prompt_len`` tokens (clamped to the table)."""
    return min(prompt_len // page_size, table_w - 1)


def cow_needed(prompt_len: int, page_size: int, table_w: int,
               chain_len: int) -> bool:
    """True when the append page is part of the SHARED chain and must be
    copy-on-write duplicated before this slot may write to it. Skipping
    the duplication (e.g. an off-by-one that exempts the tail page) lets
    the new stream append into KV that other readers still decode from."""
    return cow_boundary(prompt_len, page_size, table_w) < chain_len


# -- chunked-prefill advance --------------------------------------------------


def chunk_take(remaining: int, budget_left: int,
               supports_suffix: bool) -> int:
    """Prompt tokens the next chunk covers. Engines that cannot slice
    state at a position boundary (recurrent state, SWA) must run the
    whole remainder in one shot — the budget degrades to an admission
    hint."""
    return min(remaining, budget_left) if supports_suffix else remaining


def chunk_complete(next_pos: int, prompt_len: int) -> bool:
    """True when a chunked-prefill job has covered the whole prompt and
    may be admitted. Admitting earlier ships a wire that is missing the
    tail of the prompt's KV."""
    return next_pos >= prompt_len


def chunk_extract_compress() -> bool:
    """Whether per-chunk extraction quantizes (it must NOT): chunk wires
    stay RAW so the resumable prefix is the exact float KV a one-shot
    prefill computes; quantization happens ONCE over the spliced whole at
    completion (lint rule R007 enforces the same invariant statically)."""
    return False
