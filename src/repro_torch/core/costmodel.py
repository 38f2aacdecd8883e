"""Analytic cost model for replica latency/throughput (HexGen-style, paper
Appendix B) with alpha-beta communication terms (Eq. 1).

All estimates are roofline-based per stage: max(compute, HBM) + TP collective
+ PP transfer. Used by (a) Alg. 2 parallel-config deduction, (b) the SLO
simulator, (c) the TSTP orchestration matrix.

The port's copy of ``repro.core.costmodel`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import ClusterSpec

BYTES = 2  # bf16/fp16 weights+activations

# efficiency knobs (calibrated once; only relative accuracy matters)
MFU = 0.5                # achievable fraction of peak flops, prefill
HBM_EFF = 0.75           # achievable fraction of HBM bandwidth, decode
KERNEL_OVERHEAD = 8e-6   # fixed per-layer launch/dispatch overhead (s)

# int4 wire format: 4 bits/elem + (scale+zero = 8B f32) per 128-elem group
INT4_WIRE_FACTOR = (4.0 / 16.0) + 8.0 / (128 * BYTES)
# int4-RESIDENT decode cache (paged pool, DESIGN.md §7): same encoding at
# rest, so both the capacity term and decode's KV read traffic shrink by it
INT4_RESIDENT_FACTOR = INT4_WIRE_FACTOR
# fixed-size KV pages (tokens per page) for the paged capacity arithmetic;
# matches serving's DEFAULT_PAGE_SIZE
PAGE_SIZE = 16


@dataclass
class ParallelConfig:
    tp: int
    pp: int
    stages: List[List[int]]          # device idxs per stage (len == pp)
    layer_partition: List[int]       # layers per stage (sums to num_layers)

    def describe(self) -> str:
        return f"TP={self.tp},PP={self.pp}"


def model_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BYTES


_KV_CACHE: dict = {}
_STATE_CACHE: dict = {}


def kv_bytes_per_token(cfg: ModelConfig, *, resident: str = "bf16") -> float:
    """KV (or recurrent-state amortized) bytes per token across all layers.

    ``resident="int4"`` applies the paged pool's at-rest compression
    (group-wise int4 + scale/zero overhead) — the footprint decode
    capacity and decode HBM reads actually pay with the paged cache."""
    key = (cfg, resident)
    hit = _KV_CACHE.get(key)
    if hit is not None:
        return hit
    att_layers = sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l)
                     and cfg.family != "ssm")
    raw = 2 * att_layers * cfg.kv_dim * BYTES
    _KV_CACHE[key] = raw * (INT4_RESIDENT_FACTOR if resident == "int4"
                            else 1.0)
    return _KV_CACHE[key]


def paged_kv_supported(cfg: ModelConfig) -> bool:
    """Mirror of ``models.paged.paged_supported`` without importing the
    model stack: the cost model credits int4-resident paging only to
    pure-attention archs (recurrent/SWA/audio keep dense arithmetic)."""
    if cfg.family in ("ssm", "hybrid", "audio") or cfg.sliding_window \
            or cfg.attn_logit_softcap:
        return False
    return True


def state_bytes(cfg: ModelConfig, batch: int) -> float:
    """Recurrent state bytes (SSM/hybrid archs): O(1) in sequence length."""
    hit = _STATE_CACHE.get(cfg)
    if hit is None:
        total = 0.0
        kinds = cfg.layer_kinds()
        for l in range(cfg.num_layers):
            kind = kinds[l]
            if "mamba" in kind:
                total += cfg.mamba_d_inner * (cfg.mamba_d_state * 4
                                              + (cfg.mamba_d_conv - 1) * BYTES)
            elif "mlstm" in kind:
                dh = 2 * cfg.d_model // cfg.num_heads
                total += cfg.num_heads * (dh * dh + dh + 1) * 4
            elif "slstm" in kind:
                total += 4 * cfg.d_model * 4
        _STATE_CACHE[cfg] = total
        hit = total
    return hit * batch


@dataclass
class ReplicaCost:
    """Latency/throughput estimates for one (group, parallel cfg, phase)."""
    prefill_latency_1k: float    # TTFT for one 1024-token request (s)
    decode_tpot: float           # per-token decode latency at ref batch (s)
    max_decode_batch: int
    prefill_tokens_per_s: float
    decode_tokens_per_s: float


def _stage_devices(cluster: ClusterSpec, stage: Sequence[int]):
    return [cluster.devices[i] for i in stage]


def _intra_bw(cluster: ClusterSpec, stage: Sequence[int]) -> float:
    if len(stage) <= 1:
        return float("inf")
    return min(cluster.bw[i, j] for i in stage for j in stage if i != j)


def _allreduce_time(nbytes: float, n: int, bw: float, alpha: float) -> float:
    if n <= 1:
        return 0.0
    return alpha * math.log2(max(n, 2)) + 2.0 * nbytes * (n - 1) / (n * bw)


def prefill_latency(cluster: ClusterSpec, cfg: ModelConfig,
                    pc: ParallelConfig, tokens: int) -> float:
    """TTFT for a prompt batch of `tokens` total tokens (latency mode)."""
    n_act = cfg.active_param_count()
    total = 0.0
    d = cfg.d_model
    for s, stage in enumerate(pc.stages):
        devs = _stage_devices(cluster, stage)
        layers = pc.layer_partition[s]
        frac = layers / cfg.num_layers
        flops = 2.0 * n_act * frac * tokens
        # attention quadratic term (cheap estimate, causal halved)
        eff_ctx = min(tokens, cfg.sliding_window or tokens)
        flops += 2.0 * layers * tokens * eff_ctx * cfg.q_dim
        peak = sum(dv.chip.peak_flops for dv in devs) * MFU
        t_comp = flops / peak
        t_mem = (n_act * frac * BYTES) / (
            sum(dv.chip.hbm_bw for dv in devs) * HBM_EFF)
        # TP collectives: 2 all-reduces of activations per layer
        bw = _intra_bw(cluster, stage)
        t_tp = layers * 2 * _allreduce_time(tokens * d * BYTES, pc.tp, bw,
                                            cluster.alpha)
        total += max(t_comp, t_mem) + t_tp + layers * KERNEL_OVERHEAD
        if s + 1 < len(pc.stages):
            link = cluster.min_bw_between(stage, pc.stages[s + 1])
            total += cluster.alpha + tokens * d * BYTES / link
    return total


def chunked_prefill_latency(cluster: ClusterSpec, cfg: ModelConfig,
                            pc: ParallelConfig, tokens: int,
                            chunk_tokens: int) -> float:
    """Total prefill time for one prompt run as SARATHI-style fixed-token
    chunks of ``chunk_tokens`` (0 or >= tokens degenerates to one-shot).

    Each chunk pays the normal prefill cost for its own tokens plus the
    cross-attention of its queries against the KV already resident from
    earlier chunks (the suffix-prefill path attends over the dequantized
    prefix). Per-chunk kernel overheads repeat, so the total is strictly
    above the one-shot latency — the win is scheduling (TTFT of OTHER
    requests), not this prompt's completion time."""
    if chunk_tokens <= 0 or chunk_tokens >= tokens:
        return prefill_latency(cluster, cfg, pc, tokens)
    total, done = 0.0, 0
    while done < tokens:
        take = min(chunk_tokens, tokens - done)
        total += prefill_latency(cluster, cfg, pc, take)
        if done > 0:
            # queries of this chunk x resident prefix KV, across stages
            extra = 2.0 * cfg.num_layers * take * done * cfg.q_dim
            peak = sum(sum(dv.chip.peak_flops
                           for dv in _stage_devices(cluster, stage))
                       for stage in pc.stages) * MFU
            total += extra / peak
        done += take
    return total


def decode_step_latency(cluster: ClusterSpec, cfg: ModelConfig,
                        pc: ParallelConfig, batch: int, ctx: int) -> float:
    """One decode step (one token per sequence, batch sequences).

    Archs served by the paged pool read int4-at-rest KV (the fused-dequant
    kernel never materializes 16-bit), so their memory-bound KV term
    shrinks by the residency factor."""
    n_act = cfg.active_param_count()
    kv_tok = kv_bytes_per_token(
        cfg, resident="int4" if paged_kv_supported(cfg) else "bf16")
    eff_ctx = min(ctx, cfg.sliding_window or ctx)
    d = cfg.d_model
    total = 0.0
    for s, stage in enumerate(pc.stages):
        devs = _stage_devices(cluster, stage)
        layers = pc.layer_partition[s]
        frac = layers / cfg.num_layers
        hbm = sum(dv.chip.hbm_bw for dv in devs) * HBM_EFF
        bytes_params = n_act * frac * BYTES
        bytes_kv = batch * eff_ctx * kv_tok * frac
        bytes_state = state_bytes(cfg, batch) * frac
        t_mem = (bytes_params + bytes_kv + bytes_state) / hbm
        flops = 2.0 * n_act * frac * batch
        t_comp = flops / (sum(dv.chip.peak_flops for dv in devs) * MFU)
        bw = _intra_bw(cluster, stage)
        t_tp = layers * 2 * _allreduce_time(batch * d * BYTES, pc.tp, bw,
                                            cluster.alpha)
        total += max(t_comp, t_mem) + t_tp + layers * KERNEL_OVERHEAD
        if s + 1 < len(pc.stages):
            link = cluster.min_bw_between(stage, pc.stages[s + 1])
            total += cluster.alpha + batch * d * BYTES / link
    return total


def decode_page_budget(cluster: ClusterSpec, cfg: ModelConfig,
                       pc: ParallelConfig, *,
                       page_size: int = PAGE_SIZE) -> int:
    """Pages of int4-resident KV the group's remaining HBM can hold (the
    stage with the least headroom per hosted layer governs)."""
    page_bytes_full = page_size * kv_bytes_per_token(cfg, resident="int4")
    worst = math.inf
    for s, stage in enumerate(pc.stages):
        devs = _stage_devices(cluster, stage)
        mem = sum(dv.chip.hbm_bytes for dv in devs) * 0.9
        frac = pc.layer_partition[s] / cfg.num_layers
        avail = mem - cfg.active_param_count() * frac * BYTES \
            - cfg.vocab_size * cfg.d_model * BYTES
        worst = min(worst, avail / max(page_bytes_full * frac, 1.0))
    return max(0, int(worst))


def max_decode_batch(cluster: ClusterSpec, cfg: ModelConfig,
                     pc: ParallelConfig, ctx: int, *,
                     page_size: int = PAGE_SIZE) -> int:
    """Largest concurrent decode batch the group's remaining memory admits.

    Paged-capable archs use PAGE-BUDGET arithmetic: capacity = the
    group's int4-resident page budget divided by ``ceil(ctx/page_size)``
    pages per sequence — so the scheduler credits at-rest compression
    with its real (~7x) concurrency gain instead of assuming a dense
    bf16 ``batch x max_seq`` slab. Everything else keeps the dense
    worst-case arithmetic."""
    eff_ctx = min(ctx, cfg.sliding_window or ctx)
    if paged_kv_supported(cfg):
        pages_per_seq = -(-eff_ctx // page_size)
        budget = decode_page_budget(cluster, cfg, pc, page_size=page_size)
        return max(1, budget // max(pages_per_seq, 1))
    per_seq = (eff_ctx * kv_bytes_per_token(cfg) + state_bytes(cfg, 1))
    worst = math.inf
    for s, stage in enumerate(pc.stages):
        devs = _stage_devices(cluster, stage)
        mem = sum(dv.chip.hbm_bytes for dv in devs) * 0.9
        frac = pc.layer_partition[s] / cfg.num_layers
        avail = mem - cfg.active_param_count() * frac * BYTES \
            - cfg.vocab_size * cfg.d_model * BYTES
        worst = min(worst, avail / max(per_seq * frac, 1.0))
    return max(1, int(worst))


def effective_prefill_tokens(wl) -> float:
    """Mean prompt tokens a request actually PREFILLS once the shared radix
    prefix cache (serving/prefix_cache.py) serves ``wl.prefix_hit_rate`` of
    prompt tokens: full hits skip prefill outright and partial hits prefill
    only the suffix past the matched page boundary. Clamped to keep 5% of
    the prompt even at a measured hit rate of 1.0 — the first occurrence of
    every prefix is always a cold miss, so planning for literally zero
    prefill work would starve the prefill fleet of the capacity that
    *creates* cache entries."""
    hr = min(max(float(getattr(wl, "prefix_hit_rate", 0.0)), 0.0), 0.95)
    return max(wl.mean_in * (1.0 - hr), 1.0)


def prefix_shared_decode_batch(base_batch: int, wl, *,
                               page_size: int = PAGE_SIZE) -> int:
    """Concurrency credit from prefix sharing: the hit fraction of each
    sequence's PROMPT rides on refcounted pages shared with other residents,
    so only ``mean_in*(1-hr) + mean_out`` tokens' worth of pages are freshly
    allocated per admitted sequence. The page budget divided by that smaller
    per-sequence footprint admits proportionally more concurrent decodes at
    fixed cache bytes. Generated tokens never share; the same 0.95 clamp as
    ``effective_prefill_tokens`` keeps the first-occurrence cost real."""
    hr = min(max(float(getattr(wl, "prefix_hit_rate", 0.0)), 0.0), 0.95)
    if hr <= 0.0 or base_batch <= 0:
        return base_batch
    ctx_full = wl.mean_in + wl.mean_out / 2.0
    ctx_fresh = wl.mean_in * (1.0 - hr) + wl.mean_out / 2.0
    pages_full = max(-(-int(ctx_full) // page_size), 1)
    pages_fresh = max(-(-int(ctx_fresh) // page_size), 1)
    return max(base_batch,
               int(base_batch * pages_full / max(pages_fresh, 1)))


def kv_transfer_time(cluster: ClusterSpec, cfg: ModelConfig,
                     src: Sequence[int], dst: Sequence[int],
                     n_tokens: int, *, compress: bool = True) -> float:
    """Paper Eq. 1: T = alpha + 2*b*s*h*N_bytes / beta, with one-shot int4
    compression shrinking N_bytes 4x (+small scale overhead)."""
    kv = n_tokens * kv_bytes_per_token(cfg)
    if cfg.family in ("ssm",):
        kv = state_bytes(cfg, 1)          # recurrent snapshot, not KV
    if cfg.family == "hybrid":
        kv = n_tokens * kv_bytes_per_token(cfg) + state_bytes(cfg, 1)
    if compress:
        kv *= INT4_WIRE_FACTOR
    beta = cluster.min_bw_between(list(src), list(dst))
    return cluster.alpha + kv / beta


def replica_cost(cluster: ClusterSpec, cfg: ModelConfig, pc: ParallelConfig,
                 *, mean_ctx: int = 1024) -> ReplicaCost:
    lat1k = prefill_latency(cluster, cfg, pc, 1024)
    bmax = max_decode_batch(cluster, cfg, pc, mean_ctx * 2)
    bref = max(1, min(bmax, 64))
    tpot = decode_step_latency(cluster, cfg, pc, bref, mean_ctx)
    # pipeline throughput: pp microbatches in flight amortize stages
    pp_boost = min(pc.pp, 2.0) if pc.pp > 1 else 1.0
    return ReplicaCost(
        prefill_latency_1k=lat1k,
        decode_tpot=tpot / pp_boost,
        max_decode_batch=bmax,
        prefill_tokens_per_s=1024.0 / lat1k * pp_boost,
        decode_tokens_per_s=bref / (tpot / pp_boost),
    )
