"""Serving engines: a prefill engine and a continuous-batching decode
engine around one set of weights each (the port of
``repro.serving.engine``).

The decode hot loop is DEVICE-RESIDENT: ``DecodeEngine.step()`` runs
``chunk_size`` decode steps back to back (``registry.make_decode_chunk``)
with the current tokens, done-flags and emitted tokens in device tensors,
and brings the chunk's results to the host in ONE copy. On the card the
chunk is a CUDA graph, captured once per ``n_steps`` and replayed
(``registry.GraphedDecodeChunk``, the reference's ``jax.jit``);
``cuda_graph=False`` keeps the eager loop. Prefill pads prompts to
power-of-two length buckets and quantizes a whole bucket's KV in one
kernel launch; recurrent and sliding-window stacks and VLMs are
prefilled at their exact lengths instead.

Ported: ``PrefillEngine`` (bucketed, with the suffix path of partial
prefix hits and chunked prefill, or exact-length); ``DecodeEngine`` over
the page pool
(``paged=True``, int4 pages by default or ``kv_resident="bf16"``, with
prefix sharing) or over the dense cache (``paged=False``, or an arch
that cannot page: a recurrent stack's slotted states, whisper's self and
cross K/V), each with ``step()`` and the one-token-per-host-
round-trip ``step_reference()``; and the phase-switching ``Replica``. The
port's ``DecodeEngine`` pages by default (the reference's defaults to the
dense cache): the paged int4 path is the system's main path.

Every engine takes ``rt`` (a ``transformer.Runtime``). Under a mesh it
runs this rank's shard of a tensor- and expert-parallel model
(``registry.build(cfg, rt=)``, every family): its caches, pages and
wires hold this rank's KV heads, or the one KV head its query heads
read where the KV heads are fewer than the ranks, and a recurrent
stack's states on this rank's channels or heads (``kv_cfg``,
``sharding.local_cfg``), so a page pool's bytes are the local KV's.
Under the kv_seq decode cache (``Runtime(kv_seq=True)``, and every
config whose heads the axis does not split) a prefill's cache and a
dense engine's hold the rank's share of every KV head's positions: both
are gathered whole before a wire is extracted
(``kv_transfer.gather_seq``), so wires carry every head at every
position, and a rank inserts its share of them
(``kv_transfer.insert_batch(seq_part=)``); the paged engines keep the head split and
refuse it (ROADMAP C.4).
Every rank of the ``model`` axis makes the same engine calls in the
same order (SPMD); the greedy tokens come from
the gathered logits, and the engines check that every rank chose the
same ones (:func:`_agree`), raising if not.
"""
from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitizers
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models import paged as paged_fmt
from repro_torch.models import registry, transformer, whisper
from repro_torch.serving import kv_transfer, page_pool, protocol
from repro_torch.serving import trace as _trace
from repro_torch.serving.kv_transfer import KVWire
from repro_torch.serving.page_pool import PagePool, pages_needed
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch


@dataclass
class GenRequest:
    """Engine-level unit of work: prompt in, ``out_tokens`` accumulate.
    Engines never stamp the timestamp fields; their owner does."""
    rid: int
    tokens: np.ndarray              # prompt token ids (1D)
    max_new_tokens: int
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    out_tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = -1.0
    t_done: float = -1.0
    # prefix-cache partial hit: positions [0, start_pos) are resident on
    # the target decode engine (``prefix_pages``); prefill covers only the
    # suffix, attending over ``prefix_wire``'s KV
    start_pos: int = 0
    prefix_pages: Optional[List[int]] = None
    prefix_wire: Optional[KVWire] = None
    prefix_replica: int = -1


# -- unified admission API ----------------------------------------------------
#   FRESH       one-shot prefill wire; ``token`` is the first output
#   CHUNKED     concatenated chunked-prefill wire (engine-side like FRESH)
#   PREFIX_HIT  full prefix-cache hit: no wire, ``pages`` is the resident
#               chain and ``token`` the known first output
#   MIGRATED    mid-stream snapshot off another decode engine; ``token`` is
#               the RESUME token (already in ``out_tokens``)

ADMIT_FRESH = "FRESH"
ADMIT_CHUNKED = "CHUNKED"
ADMIT_PREFIX_HIT = "PREFIX_HIT"
ADMIT_MIGRATED = "MIGRATED"


@dataclass
class AdmissionItem:
    """One request entering continuous batching, tagged with how its KV
    arrives: ``wire`` for FRESH/CHUNKED/MIGRATED, ``pages`` for
    PREFIX_HIT."""
    req: GenRequest
    token: int
    source: str = ADMIT_FRESH
    wire: Optional[KVWire] = None
    pages: Optional[List[int]] = None


@dataclass
class AdmissionBatch:
    """Ordered admission attempt: FIFO, stopping at the first item the
    page/slot budget cannot place; ``admit`` returns the rejected tail."""
    items: List[AdmissionItem] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __bool__(self) -> bool:
        return bool(self.items)


@dataclass
class PartialPrefill:
    """Resumable chunked-prefill state. ``pos`` counts prompt tokens
    prefilled past ``req.start_pos``; ``wires`` holds one RAW suffix wire
    per completed chunk (exact floats, so the resumable prefix is what a
    one-shot prefill computes); quantization happens once, over the
    spliced whole, when the job completes."""
    req: GenRequest
    pos: int = 0
    wires: List[KVWire] = field(default_factory=list)
    first: int = -1
    done: bool = False
    transport: Optional[KVWire] = None

    @property
    def next_pos(self) -> int:
        return self.req.start_pos + self.pos

    @property
    def remaining(self) -> int:
        return len(self.req.tokens) - self.next_pos

    def wire(self) -> KVWire:
        if self.transport is not None:
            return self.transport
        return kv_transfer.concat_wires(self.wires)


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def _params_device(params, device) -> torch.device:
    dev = torch.device(device)
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"params live on {have}, engine asked for {dev}")
    return have


def _first_tokens(logits, tp=None) -> np.ndarray:
    """Greedy first tokens: one device -> host copy per prefill call
    (checked across the model axis ``tp``, :func:`_agree`)."""
    return _agree(tp, torch.argmax(logits[:, -1], dim=-1).cpu().numpy(),
                  logits.device, "prefill's first tokens")


def _agree(tp, host: np.ndarray, device, what: str) -> np.ndarray:
    """``host`` unchanged where every rank of the model axis ``tp`` holds
    the same bytes (one gather of a checksum); raises where they
    differ. Nothing to check without a mesh."""
    if tp is None:
        return host
    mine = zlib.crc32(np.ascontiguousarray(host).tobytes())
    dev = device if tp.backend == "nccl" else torch.device("cpu")
    got = tp.all_gather(torch.tensor([mine], dtype=torch.int64,
                                     device=dev), 0).tolist()
    if len(set(got)) != 1:
        raise RuntimeError(f"SPMD ranks disagree on {what}: checksums "
                           f"{got}")
    return host


class PrefillEngine:
    """Latency-oriented: processes one prompt batch at a time, right-padded
    to power-of-two length buckets (at most ``max_batch`` rows per call,
    itself padded to a power of two). Logits are gathered at each
    prompt's own last token.

    A recurrent stack (jamba, xLSTM), a sliding-window stack or a VLM is
    not ``bucketed`` (the reference's rule): padding would run through a
    recurrence and into its state, a sliding window's prefill builds the
    ring cache from the true length, so padding would shift the ring, and
    the reference prefills a VLM at exact lengths. Their prompts are
    grouped by exact length (:meth:`_run_exact`: no padded row enters the
    model), and they cannot prefill a suffix, so chunked prefill runs each
    prompt in one shot. Whisper's prompts need frame embeddings, which
    the reference's engine never passes: its prefill runs through the
    model API only (``registry.build(cfg).prefill``)."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 512,
                 max_batch: int = 4, min_bucket: int = 16, device="cuda",
                 rt=None):
        self.cfg = cfg
        self.params = params
        self.device = _params_device(params, device)
        self.api = registry.build(cfg, rt=rt)
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        mixes = ({"attn"} if cfg.family == "audio" else
                 {k.split("+")[0] for k in cfg.layer_kinds()})
        self.bucketed = (mixes == {"attn"} and not cfg.sliding_window
                         and cfg.family != "vlm")

    @property
    def supports_suffix(self) -> bool:
        return self.bucketed and self.api.prefill_suffix is not None

    @property
    def jit_cache_size(self) -> int:
        """Compiled variants (the sanitizer's retrace monitor reads it):
        prefill runs eagerly, so none."""
        return 0

    def _bucket_of(self, n: int) -> int:
        return min(max(_next_pow2(n), self.min_bucket), self.max_seq)

    def _whole(self, out):
        """A prefill's ``(logits, cache)`` with a kv_seq cache (the rank's
        share of the positions) gathered whole, the wire's layout."""
        logits, cache = out
        if sharding.kv_seq(self.api.local_cfg):
            cache = kv_transfer.gather_seq(cache, self.api.tp,
                                           frames=self.cfg.encoder_seq)
        return logits, cache

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def run(self, reqs: List[GenRequest], *, compress: bool = True,
            backend: str = "auto") -> List[Tuple[GenRequest, KVWire, int]]:
        """Prefill a batch; returns per-request (req, wire, first_token).
        Requests carrying a resident prefix (``start_pos``/``prefix_wire``)
        take the suffix path. Traced as ``prefill.call``: ``rows`` the
        model's rows (padding rows too), ``tokens`` the prompts' own,
        ``padded_tokens`` the rest of rows x bucket (0 at exact lengths);
        a recurrent stack's adds ``mamba_ms``, ``moe_routes`` and
        ``moe_rows`` (``transformer._prefill_recurrent``)."""
        with _trace.span("prefill.call"):
            return self._run(reqs, compress=compress, backend=backend)

    def _run(self, reqs, *, compress, backend):
        if not reqs:
            return []
        suffix = [r for r in reqs
                  if r.start_pos > 0 and r.prefix_wire is not None]
        sids = {id(r) for r in suffix}
        normal = [r for r in reqs if id(r) not in sids]
        too_long = [r.rid for r in reqs if len(r.tokens) > self.max_seq]
        if too_long:
            raise ValueError(
                f"prompt(s) exceed max_seq={self.max_seq}: rids {too_long}")
        out = []
        if suffix:
            if not self.supports_suffix:
                raise ValueError("suffix prefill requested but this engine "
                                 "cannot slice its state at a position")
            out.extend(self._run_suffix(suffix, compress=compress,
                                        backend=backend))
        if normal:
            run = self._run_bucketed if self.bucketed else self._run_exact
            out.extend(run(normal, compress=compress, backend=backend))
        return out

    def prefill_chunk(self, jobs: List[PartialPrefill], budget: int, *,
                      compress: bool = True, backend: str = "auto"
                      ) -> List[PartialPrefill]:
        """Advance chunked prefills by up to ``budget`` prompt tokens TOTAL
        across ``jobs`` (FIFO), one model call per tick. Each chunk is a
        suffix prefill over the concat of the job's raw chunk wires (plus
        any prefix-cache wire); the admission wire is quantized once, over
        the spliced whole, at completion. Mutates and returns ``jobs``.
        Traced as ``prefill.call``, as :meth:`run`."""
        with _trace.span("prefill.call"):
            left = max(int(budget), 0)
            work = []                       # (job, clone, take)
            for job in jobs:
                if job.done or job.remaining <= 0 or left <= 0:
                    continue
                take = protocol.chunk_take(job.remaining, left,
                                           self.supports_suffix)
                left -= min(take, left)
                req = job.req
                upto = job.next_pos + take
                clone = GenRequest(req.rid, np.asarray(req.tokens)[:upto],
                                   req.max_new_tokens, extras=req.extras)
                if job.next_pos > 0:
                    parts = ([req.prefix_wire] if req.start_pos > 0
                             and req.prefix_wire is not None
                             else []) + job.wires
                    clone.start_pos = job.next_pos
                    clone.prefix_wire = kv_transfer.concat_wires(
                        parts, backend=backend)
                work.append((job, clone, take))
            if not work:
                return jobs
            by_clone = {id(c): (job, take) for job, c, take in work}
            # chunks extract RAW (protocol.chunk_extract_compress() is False)
            for clone, wire, first in self._run(
                    [c for _, c, _ in work],
                    compress=protocol.chunk_extract_compress(),
                    backend=backend):
                job, take = by_clone[id(clone)]
                job.wires.append(wire)
                job.pos += take
                if protocol.chunk_complete(job.next_pos, len(job.req.tokens)):
                    job.done = True
                    job.first = int(first)
                    full = kv_transfer.concat_wires(job.wires)
                    job.transport = (kv_transfer.compress_wire(
                        full, backend=backend) if compress else full)
            return jobs

    def _run_exact(self, reqs, *, compress, backend):
        """Group by exact prompt length (no padding ever enters attention),
        at most ``max_batch`` prompts a call (the reference runs a whole
        length group in one call; rows are independent, so the tokens and
        wires are the same)."""
        by_len: Dict[int, List[GenRequest]] = {}
        for r in reqs:
            by_len.setdefault(len(r.tokens), []).append(r)
        out = []
        for n, group in by_len.items():
            for lo in range(0, len(group), self.max_batch):
                sub = group[lo:lo + self.max_batch]
                toks = np.stack([np.asarray(r.tokens) for r in sub]).astype(
                    np.int64)
                _trace.add(rows=len(sub), tokens=n * len(sub),
                           padded_tokens=0)
                with _trace.span("prefill.model"):
                    logits, cache = self._whole(self.api.prefill(
                        self.params, {"tokens": self._tensor(toks)},
                        max_seq=self.max_seq))
                with _trace.span("prefill.first_token"):
                    first = _first_tokens(logits, self.api.tp)
                with _trace.span("prefill.wire"):
                    wires = kv_transfer.extract_batch(
                        cache, [(i, n) for i in range(len(sub))],
                        compress=compress, backend=backend)
                out.extend((r, wires[i], int(first[i]))
                           for i, r in enumerate(sub))
        return out

    def _run_bucketed(self, reqs, *, compress, backend):
        by_bucket: Dict[int, List[GenRequest]] = {}
        for r in reqs:
            by_bucket.setdefault(self._bucket_of(len(r.tokens)), []).append(r)
        out = []
        for Lb, group in by_bucket.items():
            for lo in range(0, len(group), self.max_batch):
                out.extend(self._run_one_bucket(
                    group[lo:lo + self.max_batch], Lb,
                    compress=compress, backend=backend))
        return out

    def _bucket_batch(self, group, Lb, lens, starts):
        """Right-padded tokens ``r.tokens[start:]`` plus last_pos/true_len
        for a pow2 batch."""
        B = min(_next_pow2(len(group)), self.max_batch)
        toks = np.zeros((B, Lb), np.int64)
        for i, r in enumerate(group):
            toks[i, :lens[i]] = np.asarray(r.tokens)[starts[i]:][:lens[i]]
        last_pos = np.zeros((B,), np.int64)
        last_pos[:len(group)] = np.asarray(lens) - 1
        true_len = np.ones((B,), np.int32)
        true_len[:len(group)] = lens
        return B, {"tokens": self._tensor(toks),
                   "last_pos": self._tensor(last_pos),
                   "true_len": self._tensor(true_len)}

    def _run_one_bucket(self, group, Lb, *, compress, backend):
        lens = [min(len(r.tokens), Lb) for r in group]
        B, batch = self._bucket_batch(group, Lb, lens, [0] * len(group))
        _trace.add(rows=B, tokens=sum(lens), padded_tokens=B * Lb - sum(lens))
        with _trace.span("prefill.model"):
            logits, cache = self._whole(self.api.prefill(
                self.params, batch, max_seq=self.max_seq))
        with _trace.span("prefill.first_token"):
            first = _first_tokens(logits, self.api.tp)
        with _trace.span("prefill.wire"):
            wires = kv_transfer.extract_batch(
                cache, [(i, lens[i]) for i in range(len(group))],
                compress=compress, backend=backend, pad_to=Lb)
        return [(r, wires[i], int(first[i])) for i, r in enumerate(group)]

    def _run_suffix(self, reqs, *, compress, backend):
        """Partial-hit path: group by (suffix bucket, prefix bucket) and
        prefill each suffix against its dequantized prefix KV."""
        by_key: Dict[Tuple[int, int], List[GenRequest]] = {}
        for r in reqs:
            Lb = self._bucket_of(len(r.tokens) - r.start_pos)
            Pb = self._bucket_of(r.start_pos)
            by_key.setdefault((Lb, Pb), []).append(r)
        out = []
        for (Lb, Pb), group in by_key.items():
            for lo in range(0, len(group), self.max_batch):
                out.extend(self._run_one_suffix_bucket(
                    group[lo:lo + self.max_batch], Lb, Pb,
                    compress=compress, backend=backend))
        return out

    def _run_one_suffix_bucket(self, group, Lb, Pb, *, compress, backend):
        slens = [min(len(r.tokens) - r.start_pos, Lb) for r in group]
        B, batch = self._bucket_batch(group, Lb, slens,
                                      [r.start_pos for r in group])
        _trace.add(rows=B, tokens=sum(slens),
                   padded_tokens=B * Lb - sum(slens))
        prefix_kv, plen = kv_transfer.dequantize_prefix_batch(
            [r.prefix_wire for r in group], Pb, backend=backend)
        if B > len(group):
            # dummy rows: zero-length prefix, masked out entirely
            pad = B - len(group)
            prefix_kv = {
                name: tuple(torch.cat([a, a.new_zeros(
                    (a.shape[0], pad) + a.shape[2:])], dim=1) for a in kv)
                for name, kv in prefix_kv.items()}
            plen = torch.cat([plen, plen.new_zeros(pad)])
        batch["prefix_kv"] = prefix_kv
        batch["prefix_len"] = plen
        with _trace.span("prefill.model"):
            logits, cache = self.api.prefill_suffix(self.params, batch,
                                                    max_seq=self.max_seq)
        with _trace.span("prefill.first_token"):
            first = _first_tokens(logits, self.api.tp)
        with _trace.span("prefill.wire"):
            wires = kv_transfer.extract_batch(
                cache, [(i, slens[i]) for i in range(len(group))],
                compress=compress, backend=backend, pad_to=Lb)
        return [(r, wires[i], int(first[i])) for i, r in enumerate(group)]


@contextlib.contextmanager
def _sync_errors(device: torch.device, on: bool):
    """Turn any host synchronization on ``device`` into an error."""
    if not (on and device.type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class DecodeEngine:
    """Throughput-oriented: continuous batching over a fixed set of slots.

    With ``paged=True`` the KV lives in a page pool, int4 at rest
    (``kv_resident="bf16"`` for the ablation): admission reserves
    ``ceil((prompt + max_new) / page_size)`` pages per request, aligned
    wires scatter into int4 pages with no dequant round trip, attention
    dequantizes in the kernel, and ``free_slots()`` truncates to what the
    page budget can admit. With ``prefix_sharing`` finished chains are
    donated to a radix index and later requests decode straight off the
    shared pages. With ``paged=False`` (or an arch that cannot page:
    ``paged_fallback`` says why) each slot owns a ``max_seq`` column of a
    dense bf16 cache (``min(max_seq, window)`` rows for a sliding-window
    stack: a ring once a slot passes the window; a recurrent stack's
    attention layers beside its states, which admission overwrites whole;
    whisper's self K/V beside its cross K/V), wires are dequantized into
    it on admission, and attention runs through the ``decode_attention``
    kernel. A migration snapshot (:meth:`extract_resident`) of a dense
    engine goes through ``kv_transfer.extract``, recurrent states raw.

    On a CUDA device each chunk is one CUDA graph replay
    (``registry.GraphedDecodeChunk``), captured the first time ``step()``
    runs a chunk of that length; ``cuda_graph=False`` runs the eager loop
    (the A/B arm). The cache's tensors stay the same objects for the life
    of the engine: every host-side edit (admission, release, the chunk's
    final lengths) writes into them in place."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 max_seq: int = 512, eos_id: int = -1, chunk_size: int = 8,
                 paged: bool = True,
                 page_size: int = paged_fmt.DEFAULT_PAGE_SIZE,
                 num_pages: Optional[int] = None,
                 kv_resident: str = "int4", paged_backend: str = "auto",
                 prefix_sharing: bool = False, cuda_graph: bool = True,
                 device="cuda", rt=None):
        self.cfg = cfg
        self.params = params
        self.device = _params_device(params, device)
        self.api = registry.build(cfg, rt=rt)
        self.kv_cfg = self.api.local_cfg     # what this rank's KV holds
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.chunk_size = chunk_size
        supported = self.api.paged_decode_fns is not None
        self.paged = bool(paged) and supported
        # the kv_seq cache: this rank's share of every KV head's positions
        # (the paged step refuses it: registry.build's paged_decode_fns)
        self._seq_part = (self.api.tp.rank, self.api.tp.size) \
            if sharding.kv_seq(self.kv_cfg) else None
        self.paged_fallback = (
            None if (not paged or supported) else
            f"{cfg.name}: arch cannot page its decode cache (recurrent "
            f"state / SWA ring buffer / audio / softcap)")
        if self.paged:
            self._decode, self._chunk = self.api.paged_decode_fns(
                page_size, paged_backend)
            self.page_size = page_size
            self.table_w = paged_fmt.table_width(max_seq, page_size)
            if num_pages is None:
                # parity with a dense max_slots x max_seq budget (+ trash)
                num_pages = max_slots * self.table_w + 1
            self.kv_resident = kv_resident
            if sanitizers.sanitize_enabled():
                # REPRO_SANITIZE=1: the pool records allocation/free sites
                self.pool = sanitizers.make_sanitized_pool(num_pages,
                                                           page_size)
            else:
                self.pool = PagePool(num_pages, page_size)
            self.cache = paged_fmt.init_paged_cache(
                self.kv_cfg, max_slots, max_seq, num_pages,
                page_size=page_size,
                resident=kv_resident, device=self.device)
            self._slot_pages: Dict[int, List[int]] = {}
            self._need_sum = 0      # pages reserved across admissions
            self._need_n = 0
            self.zero_copy_inserts = 0
            self.reencoded_inserts = 0
            self.prefix_cache = (PrefixCache(page_size) if prefix_sharing
                                 else None)
            self._pins: Dict[object, List[int]] = {}
            self.cow_copies = 0
            self.prefix_admits = 0
        else:
            # bf16 whatever the model's type, as the reference's cache
            init = (whisper.init_cache if cfg.family == "audio"
                    else transformer.init_cache)
            self.cache = init(self.kv_cfg, max_slots, max_seq,
                              device=self.device)
            self._decode, self._chunk = self.api.decode, \
                self.api.decode_chunk
        self.graphs = (registry.GraphedDecodeChunk(
            self._decode, self._chunk, params, self.cache, max_slots,
            self.api.tp)
            if cuda_graph and self.device.type == "cuda" else None)
        self.slots: List[Optional[GenRequest]] = [None] * max_slots
        self.cur_token = np.zeros((max_slots,), np.int32)
        # host-sync accounting: one per chunk (one per step_reference step)
        self.host_syncs = 0
        self.steps_run = 0

    # -- slot management ----------------------------------------------------

    def free_slots(self) -> List[int]:
        """Admissible slot indices. Paged engines truncate to the PAGE
        BUDGET: free (and prefix-index-only, reclaimable) pages over the
        mean reserved pages per admitted request."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not self.paged or not free:
            return free
        est = (self._need_sum / self._need_n) if self._need_n \
            else float(self.table_w)
        reclaimable = 0
        if self.prefix_cache is not None:
            reclaimable = sum(1 for p in self.prefix_cache.page_set()
                              if self.pool.refcount(p) == 1)
        cap = int((self.pool.n_free + reclaimable) / max(est, 1.0))
        return free[:max(cap, 0)]

    def _alloc_pages(self, n: int, owner) -> Optional[List[int]]:
        """Pool alloc; on failure evict unshared prefix-cache entries (LRU)
        to cover the shortfall, then retry."""
        if n == 0:
            return []
        pages = self.pool.alloc(n, owner)
        if pages is None and self.prefix_cache is not None:
            self.prefix_cache.evict(self.pool, n - self.pool.n_free)
            pages = self.pool.alloc(n, owner)
        return pages

    def admit(self, batch: AdmissionBatch, *,
              backend: str = "auto") -> AdmissionBatch:
        """One FIFO pass over an :class:`AdmissionBatch`; returns the
        REJECTED tail. Dense: one request per free slot, every wire
        inserted with one batched dequant. Paged: all-or-nothing per
        request on the page budget (pages for prompt + max_new reserved up
        front); PREFIX_HIT items share their resident chain (copy-on-write
        of the boundary page); wire items scatter in one ``insert_wires``
        call. Traced as ``decode.admit``."""
        if not isinstance(batch, AdmissionBatch):
            raise TypeError("admit() takes an AdmissionBatch")
        with _trace.span("decode.admit"):
            items = list(batch.items)
            if sanitizers.sanitize_enabled() and self.paged \
                    and self.kv_resident == "int4":
                # a migrated wire re-encoding (instead of zero-copy page
                # scatter) means extract_slot_wire/insert_wires drifted
                # apart; bf16 pages ship raw wires by design
                for it in items:
                    if it.source == ADMIT_MIGRATED:
                        sanitizers.check_wire_alignment(
                            it.wire, self.kv_cfg,
                            context=f"admit MIGRATED rid={it.req.rid}")
            if self.paged:
                n = self._admit_paged(items, backend=backend)
            else:
                n = self._admit_dense(items, backend=backend)
            return AdmissionBatch(items[n:])

    def _admit_dense(self, items: List[AdmissionItem], *, backend) -> int:
        free = self.free_slots()
        placed = []
        for it in items:
            if not free or it.source == ADMIT_PREFIX_HIT:
                break       # page-handle admission needs the paged pool
            placed.append((it, free.pop(0)))
        if placed:
            self.cache = kv_transfer.insert_batch(
                self.cache, [(it.wire, slot) for it, slot in placed],
                backend=backend, seq_part=self._seq_part)
            for it, slot in placed:
                self.slots[slot] = it.req
                self.cur_token[slot] = it.token
                if it.source != ADMIT_MIGRATED:
                    it.req.out_tokens.append(it.token)
        return len(placed)

    def _admit_paged(self, items: List[AdmissionItem], *, backend) -> int:
        n_taken = 0
        placed = []                      # wire-carrying placements
        free = [i for i, s in enumerate(self.slots) if s is None]
        for it in items:
            if it.source == ADMIT_PREFIX_HIT:
                if not self._admit_one_prefix(it.req, it.pages or [],
                                              it.token):
                    break
                free = [i for i, s in enumerate(self.slots) if s is None]
                n_taken += 1
                continue
            if not free:
                break
            req, wire = it.req, it.wire
            migrated = it.source == ADMIT_MIGRATED
            # partial prefix hit: the wire covers only the suffix; share
            # the resident prefix chain and splice suffix pages after it
            prefix = (list(req.prefix_pages)
                      if (not migrated and req.prefix_pages) else [])
            budget = min(len(req.tokens) + req.max_new_tokens, self.max_seq)
            need = min(pages_needed(budget, self.page_size), self.table_w) \
                - len(prefix)
            need = max(need, pages_needed(wire.request_len, self.page_size))
            if len(prefix) + need > self.table_w:
                break
            pages = self._alloc_pages(need, free[0])
            if pages is None:
                break
            if prefix:
                try:
                    self.pool.share(prefix, free[0])
                except ValueError:
                    self.pool.free(pages, owner=free[0])
                    break
            slot = free.pop(0)
            placed.append((it, slot, pages, prefix))
            n_taken += 1
        if placed:
            self.cache, nz, nr = page_pool.insert_wires(
                self.cache, self.kv_cfg,
                [(it.wire, s, p, pre) for it, s, p, pre in placed],
                backend=backend)
            self.zero_copy_inserts += nz
            self.reencoded_inserts += nr
            for it, slot, pages, prefix in placed:
                self.slots[slot] = it.req
                self._slot_pages[slot] = prefix + pages
                self.cur_token[slot] = it.token
                if it.source != ADMIT_MIGRATED:
                    it.req.out_tokens.append(it.token)
                self._need_sum += len(pages)
                self._need_n += 1
        return n_taken

    # -- prefix sharing -----------------------------------------------------

    def prefix_match(self, tokens) -> Optional[PrefixMatch]:
        if not self.paged or self.prefix_cache is None:
            return None
        return self.prefix_cache.match([int(t) for t in tokens])

    def prefix_pin(self, pages: List[int], tag) -> bool:
        """Reference matched pages under an in-flight tag so neither
        eviction nor a donor release recycles them before admission."""
        try:
            self.pool.share(pages, tag)
        except ValueError:
            return False
        self._pins[tag] = list(pages)
        return True

    def prefix_unpin(self, tag):
        pages = self._pins.pop(tag, None)
        if pages:
            self.pool.unshare(pages, tag)

    def extract_prefix(self, pages: List[int], length: int) -> KVWire:
        """Gather a (pinned) prefix chain into a wire for the suffix
        prefill: a pure page gather, no dequantization here."""
        return page_pool.extract_slot_wire(self.cache, self.kv_cfg, length,
                                           pages)

    def _admit_one_prefix(self, req: GenRequest, pages: List[int],
                          next_token: int) -> bool:
        """Admit a FULL prefix hit: every prompt token's KV is resident in
        ``pages`` and ``next_token`` is the known first output, so prefill
        is skipped. If the next append lands in a shared page, that page
        is copy-on-write duplicated first."""
        if not self.paged:
            return False
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        slot = free[0]
        ln = len(req.tokens)
        budget = min(ln + req.max_new_tokens, self.max_seq)
        need_total = min(pages_needed(budget, self.page_size), self.table_w)
        n_extra = max(need_total - len(pages), 0)
        cow_at = protocol.cow_boundary(ln, self.page_size, self.table_w)
        cow = protocol.cow_needed(ln, self.page_size, self.table_w,
                                  len(pages))
        alloced = self._alloc_pages(n_extra + int(cow), slot)
        if alloced is None:
            return False
        try:
            self.pool.share(pages, slot)
        except ValueError:
            if alloced:
                self.pool.free(alloced, owner=slot)
            return False
        chain = list(pages) + (alloced[:n_extra] if cow else alloced)
        if cow:
            repl = alloced[-1]
            self.cache = page_pool.copy_page(self.cache, chain[cow_at],
                                             repl)
            self.pool.unshare([chain[cow_at]], slot)
            chain[cow_at] = repl
            self.cow_copies += 1
        self.cache = page_pool.set_page_chain(self.cache, slot, chain, ln)
        self.slots[slot] = req
        self._slot_pages[slot] = chain
        self.cur_token[slot] = next_token
        req.out_tokens.append(next_token)
        self._need_sum += len(alloced)
        self._need_n += 1
        self.prefix_admits += 1
        return True

    def _retire_slot(self, slot: int, req: GenRequest, kv_len: int):
        """Release a finished slot's pages, first donating the chain to the
        prefix index (order from ``protocol.retire_steps``)."""
        donate = (self.prefix_cache is not None and req is not None
                  and kv_len > 0)
        chain = self._slot_pages.get(slot, []) if donate else []
        n_used = pages_needed(kv_len, self.page_size) if donate else 0
        donate = bool(donate and chain and n_used <= len(chain))
        for op in protocol.retire_steps(donate):
            if op == "donate":
                toks = [int(t) for t in req.tokens] + \
                    [int(t) for t in req.out_tokens]
                self.prefix_cache.insert(toks, kv_len, chain[:n_used],
                                         len(req.tokens), self.pool)
            elif op == "free":
                self._free_pages_of(slot)

    def clear_prefix(self) -> int:
        """Drop the radix index and every in-flight pin."""
        if not self.paged:
            return 0
        for tag in list(self._pins):
            self.prefix_unpin(tag)
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.clear(self.pool)

    def extract_resident(self, *, compress: bool = True,
                         backend: str = "auto"
                         ) -> List[Tuple[int, GenRequest, KVWire, int]]:
        """Snapshot every resident request as (slot, req, wire, cur_token)
        for migration, covering the tokens whose K/V is resident: paged
        engines gather pages (zero dequant for int4), dense ones go through
        ``kv_transfer.extract``. Slots are NOT released."""
        out = []
        if self.active == 0:
            return out
        lengths = self.cache["lengths"].cpu().numpy()
        cache = self.cache if self._seq_part is None else \
            kv_transfer.gather_seq(self.cache, self.api.tp,
                                   frames=self.cfg.encoder_seq)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            ln = int(lengths[slot])
            if self.paged:
                wire = page_pool.extract_slot_wire(
                    self.cache, self.kv_cfg, ln, self._slot_pages[slot])
            else:
                wire = kv_transfer.extract(cache, slot, ln,
                                           compress=compress,
                                           backend=backend)
            out.append((slot, req, wire, int(self.cur_token[slot])))
        return out

    def _free_pages_of(self, slot: int):
        pages = self._slot_pages.pop(slot, [])
        if pages:
            self.pool.free(pages, owner=slot)

    def release(self, slot: int) -> Optional[GenRequest]:
        """Free one slot (cancellation / failure recovery): zero its length;
        paged engines also return every page to the pool and point the
        table row back at the trash page."""
        req = self.slots[slot]
        self.slots[slot] = None
        if self.paged:
            self._free_pages_of(slot)
            self.cache = page_pool.release_slot(self.cache, slot)
        else:
            self.cache["lengths"][slot] = 0
        return req

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def jit_cache_size(self) -> int:
        """Decode chunk graphs captured (the sanitizer's retrace monitor
        flags growth after warm-up); 0 for the eager loop."""
        return len(self.graphs) if self.graphs is not None else 0

    # -- stepping -----------------------------------------------------------

    def _host_state(self):
        """The chunk's state in device tensors, from ONE host -> device
        copy of a (4, max_slots) int32 block."""
        host = np.zeros((4, self.max_slots), np.int32)
        host[0] = self.cur_token
        for i, s in enumerate(self.slots):
            if s is not None:
                host[1:, i] = (1, len(s.out_tokens), s.max_new_tokens)
        dev = torch.as_tensor(host, device=self.device)
        return {"cur": dev[0], "active": dev[1].bool(), "n_out": dev[2],
                "max_new": dev[3]}

    def step(self, n_steps: Optional[int] = None, *,
             sync_check: bool = False) -> List[GenRequest]:
        """Advance all active slots by up to ``chunk_size`` tokens; returns
        finished requests. ONE device -> host copy for the whole chunk.
        ``sync_check=True`` runs the chunk's device loop under
        ``torch.cuda.set_sync_debug_mode("error")``, so a hidden host
        synchronization inside the loop (or the graph replay) raises.

        Traced as ``decode.chunk`` (``steps``, ``residents``, a paged
        engine's ``reserved_pages`` and, on int4 pages on the card,
        ``attn_ctas``: the CTAs each paged attention launch of the chunk
        runs, a host number fixed at capture), over ``decode.stage`` (the
        host state and the capture check), ``decode.replay`` (the chunk),
        ``decode.readback`` (the copy back, which waits for the chunk) and
        ``decode.retire`` (tokens out, finished slots released)."""
        if self.active == 0:
            return []
        n = n_steps or self.chunk_size
        with _trace.span("decode.chunk") as sp:
            if sp:
                sp.set(steps=n, residents=self.active, reserved_pages=sum(
                    map(len, self._slot_pages.values()))
                    if self.paged else None)
            with _trace.span("decode.stage"):
                state = self._host_state()
                chunk = self._chunk
                if self.graphs is not None:
                    # a capture synchronizes the device: it runs before
                    # the guard
                    self.graphs.capture(self.params, self.cache,
                                        n_steps=n, eos_id=self.eos_id,
                                        max_seq=self.max_seq)
                    chunk = self.graphs
            ctas0, launches0 = ops.cta_counts(), ops.launch_counts()
            with _trace.span("decode.replay"), \
                    _sync_errors(self.device, sync_check):
                toks_d, valid_d, self.cache, st = chunk(
                    self.params, self.cache, state, n_steps=n,
                    eos_id=self.eos_id, max_seq=self.max_seq)
            int4 = "paged_decode_attention_int4"
            launched = ops.launch_counts()[int4] - launches0[int4]
            if sp and launched:
                sp.set(attn_ctas=(ops.cta_counts()[int4] - ctas0[int4])
                       // launched)
            B = self.max_slots
            # the single device -> host hop for this chunk
            with _trace.span("decode.readback"):
                host = torch.cat([toks_d.reshape(-1),
                                  valid_d.reshape(-1).to(torch.int32),
                                  st["cur"], st["active"].to(torch.int32),
                                  self.cache["lengths"]]).cpu().numpy()
                host = _agree(self.api.tp, host, self.device,
                              "a decode chunk")
            toks = host[:n * B].reshape(n, B)
            valid = host[n * B:2 * n * B].reshape(n, B).astype(bool)
            cur, still_active, lengths = (
                host[2 * n * B:2 * n * B + B],
                host[2 * n * B + B:2 * n * B + 2 * B],
                host[2 * n * B + 2 * B:])
            self.host_syncs += 1
            self.steps_run += n
            self.cur_token = cur.astype(np.int32)
            with _trace.span("decode.retire"):
                finished, freed = [], []
                for i, req in enumerate(self.slots):
                    if req is None:
                        continue
                    req.out_tokens.extend(
                        int(t) for t in toks[valid[:, i], i])
                    if not still_active[i]:
                        finished.append(req)
                        self.slots[i] = None
                        freed.append(i)
                for req, i in zip(finished, freed):
                    self._release_finished(i, req, int(lengths[i]))
            return finished

    def _release_finished(self, slot: int, req: GenRequest, kv_len: int):
        """Zero a finished slot's length (the chunk loop froze it) and, for
        paged engines, donate its chain to the prefix index before the
        slot's references return to the pool; the row points at trash."""
        if self.paged:
            self._retire_slot(slot, req, kv_len)
            self.cache = page_pool.release_slot(self.cache, slot)
        else:
            self.cache["lengths"][slot] = 0

    def step_reference(self) -> List[GenRequest]:
        """The seed path, kept for A/B benchmarks and equivalence tests:
        one decode step per call, one host synchronization and a Python
        slot loop per token. Every slot's length advances, as in the
        reference; finished slots are released."""
        if self.active == 0:
            return []
        tokens = torch.as_tensor(self.cur_token[:, None], device=self.device)
        logits, stepped = self._decode(self.params, self.cache, tokens)
        self.cache["lengths"].copy_(stepped["lengths"])
        host = _agree(self.api.tp, torch.cat([torch.argmax(
            logits[:, -1], dim=-1).to(torch.int32),
            self.cache["lengths"]]).cpu().numpy(), self.device,
            "a decode step")
        nxt, lengths = host[:self.max_slots], host[self.max_slots:]
        self.host_syncs += 1
        self.steps_run += 1
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self.cur_token[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens
                    or tok == self.eos_id
                    or int(lengths[i]) >= self.max_seq - 1):
                finished.append(req)
                self.slots[i] = None
                self._release_finished(i, req, int(lengths[i]))
        return finished

    # -- paged accounting ---------------------------------------------------

    def page_stats(self) -> Optional[Dict[str, float]]:
        """Pool occupancy, internal fragmentation, insert counters and
        ``leaked_pages`` (pages in use that nothing references: 0). None
        for a dense engine."""
        if not self.paged:
            return None
        st = self.pool.stats()
        reserved = sum(len(p) for p in self._slot_pages.values()) \
            * self.page_size
        used = sum(len(r.tokens) + len(r.out_tokens)
                   for r in self.slots if r is not None)
        st["resident_tokens"] = used
        st["reserved_tokens"] = reserved
        st["internal_frag"] = (1.0 - used / reserved) if reserved else 0.0
        st["zero_copy_inserts"] = self.zero_copy_inserts
        st["reencoded_inserts"] = self.reencoded_inserts
        referenced = {p for ps in self._slot_pages.values() for p in ps}
        if self.prefix_cache is not None:
            referenced |= self.prefix_cache.page_set()
        for pinned in self._pins.values():
            referenced.update(pinned)
        st["leaked_pages"] = sum(1 for p in self.pool.pages_in_use()
                                 if p not in referenced)
        st["cow_copies"] = self.cow_copies
        st["prefix_admits"] = self.prefix_admits
        if self.prefix_cache is not None:
            for k, v in self.prefix_cache.stats().items():
                st[f"prefix_{k}"] = v
        return st


# -- phase-switchable replica -------------------------------------------------


class Replica:
    """One model replica that owns its parameters ONCE and can host either
    serving role (paper §3.4's core trick: a phase flip re-uses the
    resident weights — no reload, no restart).

    ``switch_phase()`` constructs (or re-activates) the engine for the
    other phase around the SAME parameter tensors. Engines are cached per
    phase, so a replica that flips back re-enters the engine it built
    before. A decode replica must be drained (or its requests requeued by
    the gateway) before flipping — the slotted KV cache does not survive a
    role change. The page pool is likewise DECODE-phase-owned: it lives on
    the cached decode engine, so a drained flip leaves an all-free pool
    behind and a warm re-flip re-enters it without reallocation.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 phase: str = "prefill", max_seq: int = 512, device="cuda",
                 rt=None, prefill_kw: Optional[Dict] = None,
                 decode_kw: Optional[Dict] = None):
        if phase not in ("prefill", "decode"):
            raise ValueError(f"unknown phase {phase!r}")
        self.cfg = cfg
        self.params = params
        self._prefill_kw = {"max_seq": max_seq, "device": device, "rt": rt,
                            **(prefill_kw or {})}
        self._decode_kw = {"max_seq": max_seq, "device": device, "rt": rt,
                           **(decode_kw or {})}
        self._engines: Dict[str, object] = {}
        self.phase = ""
        self.switches = 0
        self.engine = None
        self._activate(phase)

    def _activate(self, phase: str):
        if phase not in self._engines:
            if phase == "prefill":
                self._engines[phase] = PrefillEngine(self.cfg, self.params,
                                                     **self._prefill_kw)
            else:
                self._engines[phase] = DecodeEngine(self.cfg, self.params,
                                                    **self._decode_kw)
        self.engine = self._engines[phase]
        self.phase = phase

    @property
    def drained(self) -> bool:
        """True when no request state would be lost by a phase flip."""
        return self.phase != "decode" or self.engine.active == 0

    def switch_phase(self, phase: Optional[str] = None):
        """Flip to ``phase`` (default: the other one) around the resident
        parameter tensors. Raises if an undrained decode engine would lose
        in-flight requests — the caller (gateway) drains or requeues them
        first. Returns the now-active engine."""
        target = phase or ("decode" if self.phase == "prefill"
                           else "prefill")
        if target not in ("prefill", "decode"):
            raise ValueError(f"unknown phase {target!r}")
        if target == self.phase:
            return self.engine
        if not self.drained:
            raise RuntimeError(
                f"cannot flip an undrained {self.phase} replica "
                f"({self.engine.active} request(s) resident): drain or "
                f"requeue them first")
        if self.phase == "decode" and hasattr(self.engine, "clear_prefix"):
            # shared prefixes don't survive a role change: release the
            # index's page references so the pool is left all-free
            self.engine.clear_prefix()
        self._activate(target)
        self.switches += 1
        return self.engine
