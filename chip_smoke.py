#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
before the last line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc``, with
   each kernel's registers and spills from ptxas;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's LLaMA-30B shapes and at reduced shapes (a quantization
   group spanning several heads, GQA, a sliding window, a ragged suffix
   prefix, kv_len 1 and S); CUDA-event times of kernel, plain version and,
   where one PyTorch call computes the same function, that call (timed,
   never used by the port), beside the bound (bytes at 3.35 TB/s or
   operations at the peak rate of the inputs' type; the FLOPs and bytes
   from ``kernels/cost.py``). ``kv_quant`` and
   ``kv_dequant`` are checked through both bodies (vector and scalar, and
   a misaligned view) and timed through both at the prefill bucket; the
   decode append (``kv_quant_append``, K and V of 4 slots in one launch)
   is checked on every page but the trash page and timed beside the path
   it replaced (two ``kv_quant`` launches and six ``index_put``s); flash
   attention is also timed at a 32-token chunked-prefill tick; the
   residual add fused with the norm (``add_rmsnorm``) is checked at a
   decode step's 4 rows, the prefill bucket's 1024, 37 f32 rows, a small
   odd width and rows off the 16-byte grain (h byte for byte PyTorch's
   ``x + r``, y within one ulp) and timed four ways (graph replay, eager,
   plain, and ``x + r`` then ``F.rms_norm``), and both norms must give a
   row the same bytes in a 4-row and a 1024-row launch; then the other
   configs' shapes (stablelm-3b hd 80, h2o-danube-3-4b 120, gemma-2b
   256, command-r-35b 128 at 8 query heads a KV head; qwen3-moe 16,
   llama4-maverick 5 and llava-next 4 query heads a KV head at hd 128)
   in every attention kernel their path runs, at full width (flash at
   the prefill bucket, h2o-danube's 4200-token prompt over its 4096-token
   window, or llava-next's 616-token exact prompt; the dense decode step,
   h2o-danube's over its full ring; int4 and bf16 pages and the int4
   append where the arch pages; qwen3-moe's q/k norms, ``rmsnorm`` over
   rows of 128), each checked, timed beside its plain version, its bound
   and SDPA (flash, dense decode) or ``F.rms_norm``, and the f32 bodies
   checked small. A bf16 attention output may differ from its plain
   version by 2^-6 of its value plus 2^-5 of its row's RMS (f32: 1e-5);
   negative controls (no window, a 64-key split dropped, the keys' last
   8 head-dim elements zeroed, a KV head's query rows rolled by one; for
   the norm, two rows normed as one) must fail the check; then the
   recurrent and encoder-decoder configs' shapes (whisper-base's encoder,
   4 x 1500 frames, and its cross-attention prefill, 4 x 256 queries over
   the 1500 frames, both bidirectional, where a causal mask applied must
   fail the check too; its decoder's causal bucket; its self and cross
   decode attentions; jamba's flash and dense decode at 32 heads over 8;
   ``rmsnorm`` over the mLSTM's rows of 1536), each checked and timed
   the same way;
4. reference: each registered config reduced, served in float32 through
   the engines on the card and on the CPU (plain versions), once for
   each decode cache the arch takes (int4 pages, the dense cache, bf16
   pages; h2o-danube's sliding window, the recurrent stacks and whisper
   only the dense cache, whisper prefilled through the model API over
   seeded frames), the card's decode chunks as CUDA graph replays: greedy
   tokens must agree; each reduced MoE config but jamba's (a recurrent
   stack never chunks) also prefills a 32-token prompt in one shot and in
   16-token chunks on the card (nothing can drop): equal tokens, raw K/V
   within ``CHUNK_REL_TOL``;
5. serve: full-width LLaMA-30B (random bf16 weights from a seed) through
   ``PrefillEngine`` and, for each decode cache (int4 pages, the main
   path, first; the dense cache; bf16 pages), a graphed and an eager
   ``DecodeEngine`` (``cuda_graph=True``: each chunk one CUDA graph
   replay; ``cuda_graph=False``: the eager loop) on the same weights,
   driven in lockstep with the same requests, in the order the gateway's
   local clients call them: fresh prefills decoding alone, then (page
   residencies) a full prefix hit, a partial prefix hit and a chunked
   prefill with a 64-token budget over a 16-token hit, one decode chunk
   between ticks (dense: a fresh prompt and a chunked prefill). After
   every admission and chunk both arms must hold the same tokens, state,
   lengths, page table and page bytes; every chunk runs under
   ``torch.cuda.set_sync_debug_mode("error")``, and the graphed engine
   captures one graph. Host time per decode step is taken for each arm,
   the arm that goes first alternating chunk by chunk. Launch counts are
   reset before each cache's run and read after it; then one chunk of
   each arm runs under the profiler (launches and device time a step;
   1 ``rmsnorm`` and 2 ``add_rmsnorm`` a layer a step; the int4 chunk
   launches ``kv_quant_append`` once per layer per step and ``kv_quant``
   never), one replay of the graphed chunk is timed between CUDA events,
   the graphed dense engine's ``step_reference()`` must decode what its
   ``step()`` decodes, on the int4 pages a 32-token prompt prefilled in
   one shot and in 16-token chunks (layer 0 taken apart stage by stage,
   then every layer's raw K/V within ``CHUNK_REL_TOL`` of the one-shot
   run's, rows one position off rejected), and one prefill call of the
   256-token bucket at batch 4 runs under the profiler (2 ``rmsnorm`` and
   2L - 1 ``add_rmsnorm``);
6. gateway: the system's entry point, ``repro_torch.launch.serve.run``,
   at full width on phase 5's weights, three times: (a) with a 32-token
   chunked-prefill budget over a short open-loop trace under
   ``REPRO_SANITIZE=1`` (the runtime sanitizers audit every request's
   transitions and the pools at the drain, and no decode replica may
   capture a graph after the warm-up), (b) ``--live-reschedule`` over a
   short shifted trace, (c) ``--no-paged`` (dense decode engines), all
   with graphed decode chunks. Every request must be DONE with 0 leaked
   pages, (a) must chunk, and every engine must still hold phase 5's
   parameters. Launch counts are reset before and read after, and summed
   with phase 5's;
7. chaos: phase 6's gateways dropped, the chaos entry point
   ``repro_torch.launch.serve_e2e.run`` at full width on phase 5's
   weights with graphed decode engines (one prefill and three decode
   engines on the one card, one host thread), twice: (a) ``--chaos
   --requests 12 --rate 3 --max-new 32`` on int4 pages under
   ``REPRO_SANITIZE=1``, (b) ``--chaos --no-paged --requests 8 --rate 3
   --max-new 32`` on the dense cache (the migration goes through the
   wire's ``kv_quant``). In each run a decode replica crashes at 0.3 of
   the trace's span and another is preempted (grace 0.75 s) at 0.55. Each
   run must show: both events fired, each on a replica that held a
   request; the two victims dead and one decode replica serving; at
   least one migration with tokens; every request DONE with its full
   budget; 0 leaked pages, and no slot or page left on a dead replica;
   every engine on the weights it was given; one decode graph on every
   replica (a migration captures none); (a) audited clean by the
   sanitizers; and, once the run is dropped, the card's allocated memory
   back at its level before the phase. It prints each run's TTFT and TPOT
   p50/p99, E2E p99, wall time, counters and fired events. Its launch
   counts are summed with phases 5 and 6;
8. other archs: LLaMA-30B's weights dropped (the card's allocated memory
   must return to its level before phase 5), then gemma-2b, stablelm-3b,
   h2o-danube-3-4b and command-r-35b one after another at full width
   (random bf16 weights from a seed; parameter count and bytes printed;
   each dropped and the memory back at that level before the next):
   ``PrefillEngine`` (exact lengths for h2o-danube) and a graphed and an
   eager ``DecodeEngine`` in lockstep on the arch's main cache (int4
   pages; h2o-danube asks for pages and falls back to its 4096-row ring,
   with ``max_seq`` 8192 and a 4200-token prompt beside a 100-token one;
   gemma-2b also the dense cache and bf16 pages): equal tokens, state and
   cache bytes after every admission and chunk, one graph, one replay
   timed between CUDA events beside each arm's host time a step, and on
   the dense caches ``step_reference()`` equal to ``step()``; then
   ``repro_torch.launch.serve.run --arch`` on a short trace: every request
   DONE, 0 leaked pages, one graph a decode replica. Its launch counts
   are summed with phases 5-7;
9. MoE and VLM: the same for llava-next-mistral-7b (32 layers, int4
   pages), qwen3-moe-235b-a22b cut to 8 of its 94 layers and
   llama4-maverick-400b-a17b cut to 2 of its 48 (one dense layer, one
   MoE layer with its shared expert; int4 pages and the dense cache),
   published widths, random bf16 weights, one at a time, each dropped
   and the memory back at its level before phase 5. llava-next first
   runs the model API with patches: a prefill of 576 seeded patch
   embeddings and 40 text tokens (616 exact positions), then graphed and
   eager decode chunks on a dense cache, equal after each chunk.
   qwen3-moe runs phase 5's int4 run instead of the plain pair (a full
   prefix hit equal to its donor, a partial hit, a 64-token-budget
   chunked prefill, the profiled chunks and bucket prefill, the 32-token
   chunked prefill), then a 150-token prompt in one shot and in 64-token
   chunks: the dropped routes of each prefill call printed, and the raw
   K/V held to ``CHUNK_REL_TOL`` up to the first layer that dropped a
   route. Launch counts cover the int4 run, the Pair's runs and the entry
   point, not the comparisons. Each logs a replay's device
   time a step beside the bytes a step reads at 3.35 TB/s (all experts
   included: the capacity buffer runs every expert) and its profiled
   eager chunk; then ``launch.serve.run`` with the cut config
   (``cfg=``). Its launch counts are summed with phases 5-8;
10. the recurrent and encoder-decoder configs at published widths, one
   at a time, each dropped and the memory back at its level before phase
   5: xlstm-125m (12 layers), jamba-v0.1-52b cut to 16 of its 32 layers
   (two 8-layer periods, attention at layers 4 and 12, 8 MoE layers of
   16 experts: ~52 GB) and whisper-base, random bf16 weights. Each asks
   ``DecodeEngine`` for pages and falls back to the dense cache (a
   recurrent stack's slotted states, whisper's self and cross K/V); a
   graphed and an eager engine in lockstep (equal tokens, states and
   cache bytes after every admission and chunk), one graph, one replay
   timed between CUDA events beside the bytes a step reads, a profiled
   eager chunk, ``step_reference()`` = ``step()``. xlstm and jamba
   prefill through ``PrefillEngine`` at exact lengths and then serve
   through ``launch.serve.run --arch`` (jamba with ``cfg=``); xlstm then
   runs ``launch.serve_e2e.run --chaos --requests 8 --rate 3 --max-new
   32``: both events fire, a migration carries recurrent state, every
   request DONE. Whisper prefills 4 prompts through the model API over
   1500 seeded frame embeddings a prompt, the wires carry the caches into
   the engines, and ``launch.serve`` must refuse it. Its launch counts
   are summed with phases 5-9;
11. train: the training path, which reaches no kernel (the reference
   trains through plain jnp; a CUDA kernel has no backward): (a) every
   registered config reduced in float32, 3 AdamW steps from the same
   weights and ``PackedLM`` batches on the card and on the CPU, losses
   within 1e-4 relative and step 1's gradients within 1e-3 relative L2
   per tensor; (b) LLaMA-30B at full width cut to 8 of its 60 layers
   (4.71 B parameters, 56.5 GB of bf16 params and grads and f32 AdamW
   moments) through ``repro_torch.launch.train.run`` for 6 steps at batch
   4 x seq 512: finite losses and grad norms, the host time a step
   (median of steps 2-6) against the 8NT + 6dVT compute bound, peak
   memory against the reckoning, then one more step with its forward,
   backward and optimizer each under the profiler (device time between
   CUDA events and summed over kernel records, the 6 largest kernels;
   the optimizer against its 22-bytes-a-parameter bound); (c)
   LLaMA-30B cut to 1 layer, 6 steps with async checkpoints every 2
   steps into a temporary directory (the launcher checks the free space
   first; removed after), the step-4 checkpoint removed and the run
   resumed from step 2's (``--resume``): steps 3-5 give the same losses
   and every byte of the state, and the write and read rates are
   printed. No kernel
   launches in the phase (the counts are read before and after), and
   the memory returns to its level before it. ``CUBLAS_WORKSPACE_CONFIG``
   is set at the start of the script, before cuBLAS first runs;
12. distribution: (a) full LLaMA-30B under ``Runtime`` over a 1-D
   ``model`` mesh of one rank over NCCL, through a ``PrefillEngine`` and
   a graphed and an eager int4 ``DecodeEngine``, in lockstep with the
   unmeshed graphed engine: wires, tokens, lengths, page table and page
   bytes equal after every chunk, one graph holding 2L all-reduces and 2
   all-gathers a step, one replay of each graph timed turn by turn;
   then two ranks, each a process of its own on the one card over gloo
   (NCCL puts one rank on a card), against unsharded runs of the same
   cuts made first and freed before the ranks start: (b) LLaMA-30B at
   TP 2 cut to 16 layers, (c) qwen3-moe at EP 2 + TP 2 cut to 8 layers
   (its prefill drops printed by call and layer): prefill logits within
   0.05 relative L2 where no route dropped, every layer's raw K/V per
   head within ``CHUNK_REL_TOL`` up to the first dropped route, 8
   decode steps from the unsharded prefill cache fed the unsharded
   tokens within 0.05 (MoE: the median slot-step) with greedy tokens
   equal where the top-2 margin clears 0.1, and the engines (the int4
   wire into int4 and into bf16 pages) with every request DONE and 0
   leaked pages; (d) ``pipeline_apply`` of 8 LLaMA-30B layers in 2
   stages equal to the sequential apply bit for bit. Its launches, the
   ranks' included, are summed into the kernels line, and every kernel
   must launch in it. Phase 3 also checks and times the kernels at a
   TP-2 rank's shapes (LLaMA-30B's 26 heads, qwen3-moe's 32 over 2);
   (e) the nine other configs at TP 2 (xlstm and jamba in f32; in
   bf16 too, as ROADMAP C.3's probes, printed and not held, beside
   the unsharded run's own sensitivity to one bf16 ulp of every
   weight); (f) the sharded
   training step (``optimizer.make_train_step`` under the mesh): a
   world-1 NCCL train step of LLaMA-30B cut to one layer bit for bit the
   unmeshed one; LLaMA-30B at TP 2 (2 layers, 4 x 512, 2 steps), at data
   2 x model 2 (2 layers, one step over four ranks) and qwen3-moe at EP
   2 + TP 2 (one layer, one step), each against the unsharded run of its
   cut: every loss within 1e-2 relative, each leaf's step-1 gradient
   within ``CHUNK_REL_TOL`` of the unsharded one cut to the rank (MoE:
   only where no route dropped; drops printed), the leaves every rank
   holds alike the same bytes on each, host ms a step and gloo's seconds;
   a TP-2 checkpoint of the 1-layer cut read back at TP 1 byte for byte
   the state the ranks gathered. No kernel launches in (f); (g) the
   kv_seq decode cache (``Runtime(kv_seq=True)``) and heads the model
   axis does not split: a world-1 NCCL mesh of LLaMA-30B cut to one
   layer through dense engines in lockstep with the unmeshed ones (the
   graphed chunk bit for bit), then LLaMA-30B at TP 2 (4 layers, 16
   kv_seq steps after a 4 x 256 prefill) and at TP 8 (2 layers, its 52
   heads gathered: the attention columns cut inside heads, a qseq
   prefill, 8 kv_seq steps) over gloo ranks, teacher-fed, each against
   the unsharded run of its cut: prefill and step logits within
   ``CHUNK_REL_TOL``, greedy tokens where the margin clears 0.1, the
   ranks' weights and peak memory summed, and phase 13's count of a
   rank's step on meta equal to the card's launches and collectives.
   Phase 3 checks and times the decode kernel's partial mode
   (``decode_attention_lse``: ``o`` and the log-sum-exp beside it, a
   rank holding no position) at LLaMA-30B's and gemma-2b's kv_seq
   shapes; it must launch in (g);
13. the counts against the card: LLaMA-30B's int4 paged decode step (4
   slots, phase 5's pages and lengths), a 4 x 256 bucket prefill through
   the model API and the wire, and phase 11's train step (8 of 60
   layers, 4 x 512) are each counted on meta tensors by
   ``roofline/op_cost.py`` and run on the card on weights made as phases
   5 and 11 make them: (a) the counted matmul FLOPs must equal
   ``FlopCounterMode``'s on the real eager run, the counted kernel calls
   the launches it made, the counted argument bytes the real tensors';
   the traced peak is printed beside ``max_memory_allocated``'s rise;
   (b) each step's roofline time on the H100 (``roofline/analysis.py``)
   beside its measured time (the decode step one graph replay, the
   others eager between CUDA events), their ratio and the whole-step
   share ``model_flops_for / (measured s x 989e12)``: for decode and
   prefill the roofline time must not exceed the measured one, and the
   decode step's counted bytes must be at least the bytes it must read;
   (c) the dry-run (``python -m repro_torch.launch.dryrun``) on the
   host: the train cells at ``--mesh four`` from phase 1, the other
   cells at ``four`` (``--all``) and LLaMA-30B's, and LLaMA-30B's and
   qwen3-moe's cells at ``one`` (``--all`` takes ~25 min on the host
   there) from phase 10, xlstm's prefill and train cells at ``four``
   left out by name (``P13_SKIP``: its per-token sLSTM loop); every cell
   must be ``ok``; ``report.table`` of each mesh is printed;
14. the analysis package and the last model options: (a) ``python -m
   repro_torch.analysis lint --strict`` and ``check --quick --mutations
   --replay`` over this checkout (host processes from phase 1: exit 0,
   all 8 planted bugs caught and replayed), then R002's reachable set
   held to a real capture: a LLaMA-30B decode chunk (2 layers, dense and
   int4 pages) captured as a CUDA graph under ``sys.setprofile``; every
   function of ``src/repro_torch`` that ran must be in the set (the
   counts printed); (b) the capped flash and dense decode kernels at
   gemma-2b's shapes against their plain versions (a "no cap" control
   rejected), then gemma-2b, all 18 layers, with a logit softcap of 50
   through ``PrefillEngine`` and the dense cache its ``DecodeEngine``
   falls back to, graphed and eager in lockstep; (c) jamba (16 of 32
   layers) with a 4096-token window: a 4200-token prompt's ring against
   the unwindowed prefill's rows rotated, bit for bit, a decode step
   over it against the plain attention, then the engines; (d) LLaMA-30B
   (4 layers) on the hkv_s cache against s_hkv: tokens, cache bytes and
   decode logits bit for bit; and (b)-(d) on the reduced float32
   configs, card tokens equal to the CPU's. Each of (b)-(d) counts its
   launches from 0 and must launch its path's kernels
   (``P14_KERNELS``); the capped instantiations are the kernels line's
   ``*_softcap`` rows.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Needs a CUDA card: without
one (or without the repo beside it) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.roofline.hw import H100  # noqa: E402  (the repo's src)

HBM_BYTES_PER_S = H100.hbm_bw      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12             # non-tensor-core f32 peak, same source
BF16_FLOP_PER_S = H100.peak_flops  # dense bf16 tensor-core peak
SEED = 0
ATTN_TOL_F32 = 1e-5               # atol = rtol, as tests/test_torch_gpu.py
# a bf16 attention output may differ by two bf16 ulps of its value plus
# 2^-5 of its row's RMS over the head dim: the rounding of the output
# and of the probabilities both scale with the row, which over thousands
# of keys is ~0.03 (a fixed 2e-2 would pass a wrong window)
BF16_RTOL, BF16_ATOL_RMS = 2 ** -6, 2 ** -5
ATTN_TOL_TEXT = {"float32": f"atol = rtol = {ATTN_TOL_F32}",
                 "bfloat16": "2^-6 |want| + 2^-5 row RMS"}
NORM_RTOL = {"bfloat16": 2 ** -7, "float32": 1e-5}  # one bf16 ulp


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cost_bound(name, *args, peak=F32_FLOP_PER_S, **data):
    """(bound ms, "bytes" or "operations") of kernel ``name`` on ``args``
    (its tensor arguments in the wrapper's order), its FLOPs and bytes
    from ``kernels/cost.py`` (``data``: the values its work depends on,
    ``kv_len``, ``prefix_len``), its FLOPs at ``peak``."""
    from repro_torch.kernels import cost
    flops, nbytes = cost.of(name, *args, **data)
    return bound(nbytes, flops, peak)


def cost_flops(name, *args, **data):
    from repro_torch.kernels import cost
    return cost.of(name, *args, **data)[0]


def cost_bytes(name, *args, **data):
    from repro_torch.kernels import cost
    return cost.of(name, *args, **data)[1]


def peak_of(torch, dtype):
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def attn_close(torch, got, want):
    """(ok, worst) of an attention output against its plain version: the
    worst |got - want| over its tolerance (``ATTN_TOL_F32``, or for bf16
    ``BF16_RTOL`` of the value plus ``BF16_ATOL_RMS`` of the row's RMS);
    ok when it is at most 1 and every value is finite."""
    g, w = got.float(), want.float()
    if want.dtype == torch.float32:
        tol = ATTN_TOL_F32 + ATTN_TOL_F32 * w.abs()
    else:
        tol = (BF16_ATOL_RMS * w.pow(2).mean(-1, keepdim=True).sqrt()
               + BF16_RTOL * w.abs())
    err = (g - w).abs()
    worst = float(torch.where(err == 0, err,
                              err / tol.clamp(min=1e-30)).max())
    return worst <= 1 and bool(torch.isfinite(g).all()), worst


def negative_controls(torch, got, controls):
    """Each control is the plain version of a wrong computation (a missing
    window, dropped keys, dropped head-dim elements): the check must
    reject the kernel's output against it, or it could not see that
    fault."""
    for label, wrong in controls.items():
        ok, worst = attn_close(torch, got, wrong())
        log(f"    negative control ({label}): worst |err| / tol "
            f"{worst:.3g}, rejected: {not ok}")
        if ok:
            raise AssertionError(f"the check cannot tell the kernel from "
                                 f"{label}")


def cuda_ms(torch, fn, args_list, iters):
    """Mean device ms per call: ``iters`` calls (``args_list`` cycled, so
    distinct buffers defeat the L2) captured in one CUDA graph after a
    warm-up, and the graph replayed between CUDA events. Host launch
    overhead (the Python wrapper, PyTorch's dispatch) is not counted: at
    small shapes it is larger than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(*args_list[i % len(args_list)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / iters


def eager_ms(torch, fn, args_list, iters):
    """Mean ms per call launched eagerly, host overhead included: CUDA
    events around ``iters`` calls after one warm-up."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_resources(build_log):
    """(kernel<template arguments>, registers, spills) of each kernel in
    ptxas's report, names read from the mangled symbol."""
    import re
    rows, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}"
                      r"(?:2tc)?\d+(\w+?_kernel)I(\w*?)EEv", line)
        if m:
            args = re.sub(r"NS_\d+([A-Za-z]+?)I\w*?EE", r"\1,",
                          m.group(2))
            args = re.sub(r"Li(\d+)E", r"\1,", args).replace(
                "13__nv_bfloat16", "bf16,")
            args = re.sub(r"(^|,)f", r"\1f32,", args)
            name = f"{m.group(1)}<{args.rstrip(',')}>"
        m = re.search(r"\d+ bytes spill stores, \d+ bytes spill loads",
                      line)
        if m:
            spill = m.group(0)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


# -- phase 3: kernels against their plain versions ----------------------------


def at_offset(torch, t, offset):
    """A copy of ``t`` starting ``offset`` elements into a fresh buffer."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_quant(torch, ref, kq, N, G, dtype, *, timed, offset=0):
    """kv_quant and kv_dequant (to bf16) against their plain versions, with
    x and the packed bytes ``offset`` elements into their buffers (1 puts
    them off the vector bodies' grain: the scalar bodies run)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + N + G)
    x = at_offset(torch, (torch.randn((N, G), generator=gen, device="cuda")
                          * 3).to(dtype), offset)
    got = kq.kv_quant(x)
    want = ref.kv_quant_ref(x)
    err_q = max(float((g_.float() - w_.float()).abs().max())
                for g_, w_ in zip(got, want))
    ndiff = sum(int((g_ != w_).sum()) for g_, w_ in zip(got, want))
    got = (at_offset(torch, got[0], offset),) + got[1:]
    back = kq.kv_dequant(*got, out_dtype=torch.bfloat16)
    back_ref = ref.kv_dequant_ref(*want, dtype=torch.bfloat16)
    err_d = float((back.float() - back_ref.float()).abs().max())
    ndiff_d = int((back != back_ref).sum())
    qbody, dbody = kq.quant_body(x), kq.dequant_body(got[0])
    log(f"  kv_quant   N={N} G={G} {str(dtype)[6:]} offset {offset}: "
        f"{qbody} body, differing bytes/values {ndiff}; kv_dequant -> "
        f"bf16: {dbody} body, differing {ndiff_d}")
    if ndiff or ndiff_d:
        raise AssertionError("kv_quant/kv_dequant differ from the plain "
                             "version")
    if not timed:
        return None
    iters = 20 if N * G > 1 << 20 else 200
    rq = {"err": err_q,
          "ms": cuda_ms(torch, kq.kv_quant, [(x,)], iters),
          "plain_ms": cuda_ms(torch, ref.kv_quant_ref, [(x,)], iters),
          "bound": cost_bound("kv_quant", x)}
    deq = lambda p, s, z: kq.kv_dequant(p, s, z, out_dtype=torch.bfloat16)
    deq_ref = lambda p, s, z: ref.kv_dequant_ref(p, s, z,
                                                 dtype=torch.bfloat16)
    rd = {"err": err_d,
          "ms": cuda_ms(torch, deq, [got], iters),
          "plain_ms": cuda_ms(torch, deq_ref, [want], iters),
          "bound": cost_bound("kv_dequant", *got,
                              out_dtype=torch.bfloat16)}
    for name, r, b in (("kv_quant", rq, qbody), ("kv_dequant", rd, dbody)):
        log(f"  {name:10s} N={N} G={G} ({b} body): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return rq, rd


def check_append(torch, ref, kq, B, Hkv, hd, ps, W, kv_len, dtype, *,
                 timed):
    """The decode step's append (K and V of B slots quantized into their
    tail pages, one launch) against its plain version on every page but
    the trash page; timed beside the path it replaced (two kv_quant
    launches and six index_puts)."""
    from repro_torch.kernels.kv_layout import pick_group
    g = pick_group(Hkv * hd)
    ppr = Hkv * hd // g
    R, P = ps * ppr, B * W + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + B + Hkv)
    pages = lambda: (
        (torch.randint(0, 256, (P, R, g // 2), generator=gen,
                       device="cuda", dtype=torch.uint8),
         torch.rand((P, R, 1), generator=gen, device="cuda"),
         torch.randn((P, R, 1), generator=gen, device="cuda")))
    kpg, vpg = pages(), pages()
    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    n = 0
    for b, ln in enumerate(kv_len):
        k = min(ln // ps + 1, W)
        pt[b, :k] = perm[n:n + k]
        n += k
    pt = pt.cuda()
    lengths = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    kv = [tuple((torch.randn((B, 1, Hkv, hd), generator=gen, device="cuda")
                 * 2).to(dtype) for _ in range(2)) for _ in range(8)]
    want_k = tuple(t.clone() for t in kpg)
    want_v = tuple(t.clone() for t in vpg)
    ref.kv_quant_append_ref(*kv[0], want_k, want_v, pt, lengths,
                            page_size=ps)
    kq.kv_quant_append(*kv[0], kpg, vpg, pt, lengths, page_size=ps)
    ndiff = sum(int((a[1:] != b[1:]).sum())
                for a, b in zip(kpg + vpg, want_k + want_v))
    err = max(float((a[1:].float() - b[1:].float()).abs().max())
              for a, b in zip(kpg + vpg, want_k + want_v))
    log(f"  kv_quant_append B={B} Hkv={Hkv} hd={hd} g={g} ps={ps} W={W} "
        f"kv_len={kv_len} {str(dtype)[6:]}: differing bytes/values on "
        f"pages 1+ {ndiff}")
    if ndiff:
        raise AssertionError("kv_quant_append differs from the plain "
                             "version")
    if not timed:
        return None
    fused = lambda k, v: kq.kv_quant_append(k, v, kpg, vpg, pt, lengths,
                                            page_size=ps)
    plain = lambda k, v: ref.kv_quant_append_ref(k, v, kpg, vpg, pt,
                                                 lengths, page_size=ps)
    rows = (lengths.long() % ps)[:, None] * ppr \
        + torch.arange(ppr, device="cuda")[None]
    tail = ref.append_coords(pt, lengths, ps)[0][:, None]

    def two_launch(k, v):
        # the append before the fused kernel: kv_quant on K and on V, then
        # six index_puts into the pages
        for val, pgs in ((k, kpg), (v, vpg)):
            out = kq.kv_quant(val.reshape(B * ppr, g))
            for buf, t in zip(pgs, out):
                buf[tail, rows] = t.reshape(B, ppr, -1)

    quant2 = lambda k, v: (kq.kv_quant(k.reshape(B * ppr, g)),
                           kq.kv_quant(v.reshape(B * ppr, g)))
    app_args = (*kv[0], kpg, vpg, pt, lengths)
    nbytes = cost_bytes("kv_quant_append", *app_args)
    r = {"err": err, "ms": cuda_ms(torch, fused, kv, 200),
         "plain_ms": cuda_ms(torch, plain, kv, 50),
         "old_ms": cuda_ms(torch, two_launch, kv, 200),
         "quant2_ms": cuda_ms(torch, quant2, kv, 200),
         "bound": cost_bound("kv_quant_append", *app_args)}
    r["eager_ms"] = eager_ms(torch, fused, kv, 200)
    log(f"  kv_quant_append: {r['ms']:.4f} ms ({r['eager_ms']:.4f} ms "
        f"launched eagerly), plain {r['plain_ms']:.4f} ms, the path it "
        f"replaced {r['old_ms']:.4f} ms (of which two kv_quant launches "
        f"{r['quant2_ms']:.4f} ms), bound {r['bound'][0]:.5f} ms "
        f"({r['bound'][1]}, {nbytes} B)")
    return r


def make_pages(torch, L, B, Hkv, gq, hd, ps, W, kv_len, dtype):
    """Random int4 pages for L layers (like a decode pool), a shuffled page
    table, q and kv_len."""
    from repro_torch.kernels.kv_layout import pick_group
    g = pick_group(Hkv * hd)
    ppr = Hkv * hd // g
    R = ps * ppr
    P = B * W + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + B + hd)

    def triple():
        return (torch.randint(0, 256, (L, P, R, g // 2), generator=gen,
                              device="cuda", dtype=torch.uint8),
                torch.rand((L, P, R, 1), generator=gen, device="cuda") * 0.3,
                torch.randn((L, P, R, 1), generator=gen, device="cuda"))

    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    n = 0
    for b, ln in enumerate(kv_len):
        k = -(-ln // ps)
        pt[b, :k] = perm[n:n + k]
        n += k
    q = torch.randn((B, Hkv, gq, hd), generator=gen, device="cuda").to(dtype)
    return (q, triple(), triple(), pt.cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"), g, ppr)


def decode_controls(torch, fn_ref, q, k, v, rest, kl):
    """The wrong versions a decode attention check can be asked to
    reject, each the plain version ``fn_ref(q, k, v, *rest, kv_len)`` on
    altered inputs: "kv_len - 64" (a 64-key split dropped from every slot
    longer than 64), "last 8 of hd" (the keys' last 8 head-dim elements
    zeroed: the last lane chunk; dense keys only) and "rows rolled" (the
    output rows of each KV head rolled by one: a query head's result
    written to another head's row, which a padded row block of gq 5 could
    get wrong)."""
    short = torch.where(kl > 64, kl - 64, kl)
    return {"kv_len - 64": lambda: fn_ref(q, k, v, *rest, short),
            "last 8 of hd": lambda: fn_ref(q, last8_zeroed(k), v, *rest,
                                           kl),
            "rows rolled": lambda: fn_ref(q, k, v, *rest, kl).roll(
                1, dims=2)}


def check_attention(torch, ref, pa, L, B, Hkv, gq, hd, ps, W, kv_len,
                    dtype, *, controls=(), timed):
    """The int4 paged kernel over L layers of random pages; ``controls``
    names wrong versions the check must reject (:func:`decode_controls`,
    not "last 8 of hd"). Slots at kv_len 0 must read exactly 0 (the plain
    version gives the mean of V there); the others are checked."""
    q, kt, vt, pt, kl, g, ppr = make_pages(torch, L, B, Hkv, gq, hd, ps, W,
                                           kv_len, dtype)
    layer = [(q, tuple(t[i] for t in kt), tuple(t[i] for t in vt), pt, kl)
             for i in range(L)]
    fn = lambda *a: pa.paged_decode_attention_int4(*a, page_size=ps)
    fn_ref = lambda *a: ref.paged_decode_attention_ref(*a, page_size=ps)
    ctas = pa.paged_decode_attention_int4.ctas
    got, want = fn(*layer[0]), fn_ref(*layer[0])
    ctas = pa.paged_decode_attention_int4.ctas - ctas
    live = kl > 0
    if got[~live].any():
        raise AssertionError("paged attention: a slot at kv_len 0 is not 0")
    got, want = got[live], want[live]
    err = float((got.float() - want.float()).abs().max())
    ok, worst = attn_close(torch, got, want)
    lens = kv_len if len(kv_len) <= 8 else \
        f"{int(live.sum())} of {B} live: {[n for n in kv_len if n]}"
    log(f"  paged_decode_attention_int4 B={B} Hkv={Hkv} gq={gq} hd={hd} "
        f"g={g} ps={ps} W={W} kv_len={lens} {str(dtype)[6:]}: {ctas} "
        f"CTAs; max |err| {err:.3e}, worst |err| / tol {worst:.3g} "
        f"({ATTN_TOL_TEXT[str(dtype)[6:]]})")
    if not ok:
        raise AssertionError("paged attention differs from the plain "
                             "version beyond tolerance")
    wrong = decode_controls(torch, fn_ref, q, layer[0][1], layer[0][2],
                            (pt,), kl)
    negative_controls(torch, got, {c: (lambda w=wrong[c]: w()[live])
                                   for c in controls})
    if not timed:
        return None
    nbytes = cost_bytes("paged_decode_attention_int4", *layer[0],
                        page_size=ps, kv_len=kv_len)
    r = {"err": err,
         "ms": cuda_ms(torch, fn, layer, 3 * L),
         "plain_ms": cuda_ms(torch, fn_ref, layer, L),
         "bound": cost_bound("paged_decode_attention_int4", *layer[0],
                             page_size=ps, kv_len=kv_len)}
    log(f"  paged_decode_attention_int4: {r['ms']:.4f} ms/layer, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
        f"({r['bound'][1]}, {nbytes} B); layers cycled, L2 cold")
    return r


def check_flash(torch, ref, fa, B, Sq, P, H, Hkv, hd, dtype, *, window=0,
                plen=None, causal=True, Sk=None, controls=(), timed,
                softcap=0.0, scale=1.0):
    """Flash attention against its plain version; ``plen`` (B,) makes it
    the suffix mask over a P-token padded prefix; ``causal=False`` with
    ``Sk`` keys is bidirectional attention over another sequence (an
    encoder's frames). ``controls`` names wrong versions the check must
    reject: "window 0" (no window), "last 8 of hd" (the keys' last 8
    head-dim elements zeroed), "causal" (a causal mask applied), "no cap"
    (the logit softcap left out). ``softcap``: the capped instantiation;
    ``scale`` multiplies q and k, so the cap bites; its one-call
    library version is :func:`flex_softcap`."""
    import torch.nn.functional as F
    Sk = Sk or P + Sq
    gen = torch.Generator(device="cuda").manual_seed(SEED + B + Sq + P)
    q = (torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
         * scale).to(dtype)
    k = (torch.randn((B, Sk, Hkv, hd), generator=gen, device="cuda")
         * scale).to(dtype)
    v = torch.randn((B, Sk, Hkv, hd), generator=gen, device="cuda").to(dtype)
    pl = None if plen is None else torch.tensor(plen, dtype=torch.int32,
                                                device="cuda")
    kw = dict(causal=causal, window=window, prefix_len=pl)
    if softcap:
        kw["softcap"] = softcap
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    ok, worst = attn_close(torch, got, want)
    log(f"  flash_attention B={B} S={Sq} Sk={Sk} P={P} H={H} Hkv={Hkv} "
        f"hd={hd} causal={causal} window={window} prefix_len={plen} "
        f"softcap={softcap} {str(dtype)[6:]}: max |err| {err:.3e}, worst "
        f"|err| / tol {worst:.3g} ({ATTN_TOL_TEXT[str(dtype)[6:]]})")
    if not ok:
        raise AssertionError("flash attention differs from the plain "
                             "version beyond tolerance")
    wrong = {"window 0": lambda: ref.flash_attention_ref(
                 q, k, v, **dict(kw, window=0)),
             "last 8 of hd": lambda: ref.flash_attention_ref(
                 q, last8_zeroed(k), v, **kw),
             "causal": lambda: ref.flash_attention_ref(
                 q, k, v, **dict(kw, causal=True)),
             "no cap": lambda: ref.flash_attention_ref(
                 q, k, v, **dict(kw, softcap=0.0))}
    negative_controls(torch, got, {c: wrong[c] for c in controls})
    if not timed:
        return None
    cdata = dict(causal=causal, window=window, prefix_len=plen,
                 softcap=softcap)
    nbytes = cost_bytes("flash_attention", q, k, v, **cdata)
    fn = lambda a, b, c: fa.flash_attention(a, b, c, **kw)
    fn_ref = lambda a, b, c: ref.flash_attention_ref(a, b, c, **kw)
    r = {"err": err, "ms": cuda_ms(torch, fn, [(q, k, v)], 50),
         "plain_ms": cuda_ms(torch, fn_ref, [(q, k, v)], 10),
         "bound": cost_bound("flash_attention", q, k, v,
                             peak=peak_of(torch, dtype), **cdata)}
    if softcap:
        r["library_ms"] = flex_softcap(torch, q, k, v, want, softcap,
                                       causal=causal)
        r["eager_ms"] = eager_ms(torch, fn, [(q, k, v)], 50)
        log(f"  flash_attention softcap {softcap}: {r['ms']:.4f} ms "
            f"({r['eager_ms']:.4f} ms launched eagerly), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, {nbytes} B, "
            f"{cost_flops('flash_attention', q, k, v, **cdata)} FLOP)")
        return r
    # one PyTorch call of the same function (timed only, never used by
    # the port): SDPA on (B, H, S, hd) views of the same tensors (GQA
    # through enable_gqa), with the suffix mask or the sliding window
    # as a boolean mask
    mask = None
    j = torch.arange(Sk, device="cuda")[None, None, :]
    i = torch.arange(Sq, device="cuda")[None, :, None]
    if plen is not None:
        mask = torch.where(j < P, j < pl[:, None, None],
                           (j - P) <= i)[:, None]
    elif window:
        mask = ((j <= i) & (j > i - window))[:, None]
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
        attn_mask=mask, is_causal=mask is None and causal,
        enable_gqa=H != Hkv)
    lib = sdpa(q, k, v).transpose(1, 2)
    log(f"    SDPA vs plain max |err| "
        f"{float((lib.float() - want.float()).abs().max()):.3e}")
    r["library_ms"] = cuda_ms(torch, sdpa, [(q, k, v)], 50)
    r["eager_ms"] = eager_ms(torch, fn, [(q, k, v)], 50)
    log(f"  flash_attention: {r['ms']:.4f} ms ({r['eager_ms']:.4f} ms "
        f"launched eagerly), plain {r['plain_ms']:.4f} "
        f"ms, library {r['library_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, {nbytes} B, "
        f"{cost_flops('flash_attention', q, k, v, **cdata)} FLOP)")
    return r


def flex_softcap(torch, q, k, v, want, cap, *, causal, kv_len=None):
    """The library time of capped attention, or None: PyTorch's
    ``flex_attention`` with a ``c tanh(s / c)`` score_mod (compiled, as
    flex_attention runs only compiled; timed only, never used by the
    port) on q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) in the kernels'
    layout, causal or masked at ``kv_len``. None, with the reason logged,
    where it does not compile at these shapes or disagrees with the
    plain version ``want`` beyond the attention tolerance."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        B, Sq, H, hd = q.shape
        Sk = k.shape[1]

        def capped(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        if causal:
            mask = create_block_mask(lambda b, h, qi, ki: ki <= qi, None,
                                     None, Sq, Sk, device="cuda")
        else:
            mask = create_block_mask(lambda b, h, qi, ki: ki < kv_len[b], B,
                                     None, Sq, Sk, device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        args = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))]
        call = lambda a, b, c: flex(a, b, c, score_mod=capped,
                                    block_mask=mask,
                                    enable_gqa=H != k.shape[2])
        t = time.perf_counter()
        got = call(*args[0]).transpose(1, 2)
        torch.cuda.synchronize()
        ok, worst = attn_close(torch, got, want)
        log(f"    flex_attention (tanh score_mod) compiled in "
            f"{time.perf_counter() - t:.1f} s; vs plain max |err| "
            f"{float((got.float() - want.float()).abs().max()):.3e}, worst "
            f"|err| / tol {worst:.3g}")
        if not ok:
            return None
        return cuda_ms(torch, call, args, 20)
    except Exception as e:            # a library call that cannot run here
        log(f"    flex_attention (tanh score_mod): none ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]})")
        return None


def last8_zeroed(t):
    """A copy of ``t`` (any strides) with its last 8 elements of the last
    axis zeroed."""
    t = t.clone()
    t[..., -8:] = 0
    return t


def check_rmsnorm(torch, ref, rn, N, d, dtype, *, control=False, timed):
    """``control``: the check must reject the plain version over rows of
    2d (two heads normed together, where q/k norms take one head's
    ``head_dim``)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + N + d)
    x = (torch.randn((N, d), generator=gen, device="cuda") * 2).to(dtype)
    scale = torch.randn((d,), generator=gen, device="cuda") * 0.1
    got, want = rn.rmsnorm(x, scale), ref.rmsnorm_ref(x, scale)
    err = float((got.float() - want.float()).abs().max())
    rtol = NORM_RTOL[str(dtype)[6:]]
    ok = torch.allclose(got.float(), want.float(), atol=1e-6, rtol=rtol)
    log(f"  rmsnorm N={N} d={d} {str(dtype)[6:]}: max |err| {err:.3e} "
        f"(rtol {rtol:.3g})")
    if not ok:
        raise AssertionError("rmsnorm differs from the plain version "
                             "beyond one ulp")
    if control:
        pairs = ref.rmsnorm_ref(x.view(N // 2, 2 * d),
                                scale.repeat(2)).view(N, d)
        bad = torch.allclose(got.float(), pairs.float(), atol=1e-6,
                             rtol=rtol)
        log(f"    negative control (two rows normed as one): max |err| "
            f"{float((got.float() - pairs.float()).abs().max()):.3e}, "
            f"rejected: {not bad}")
        if bad:
            raise AssertionError("the rmsnorm check cannot tell rows of d "
                                 "from rows of 2d")
    if not timed:
        return None
    gain = (1.0 + scale).to(dtype)
    r = {"err": err, "ms": cuda_ms(torch, rn.rmsnorm, [(x, scale)], 100),
         "plain_ms": cuda_ms(torch, ref.rmsnorm_ref, [(x, scale)], 100),
         "library_ms": cuda_ms(
             torch, lambda a, w: F.rms_norm(a, (d,), weight=w, eps=1e-6),
             [(x, gain)], 100),
         "bound": cost_bound("rmsnorm", x, scale,
                             peak=peak_of(torch, dtype))}
    r["eager_ms"] = eager_ms(torch, rn.rmsnorm, [(x, scale)], 100)
    log(f"  rmsnorm {N}x{d}: {r['ms']:.4f} ms ({r['eager_ms']:.4f} ms "
        f"launched eagerly), plain {r['plain_ms']:.4f} "
        f"ms, library {r['library_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return r


def norm_inputs(torch, N, d, dtype, offset=0):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 * N + d)
    x = (torch.randn((N, d), generator=gen, device="cuda") * 2).to(dtype)
    r = (torch.randn((N, d), generator=gen, device="cuda") * 2).to(dtype)
    scale = torch.randn((d,), generator=gen, device="cuda") * 0.1
    return at_offset(torch, x, offset), at_offset(torch, r, offset), scale


def check_add_rmsnorm(torch, ref, rn, N, d, dtype, *, timed, offset=0):
    """The residual add fused with the norm: h must be PyTorch's x + r
    byte for byte, y within one ulp of the plain version. Timed four ways
    (graph replay, eager, plain, and the library's x + r then
    F.rms_norm)."""
    import torch.nn.functional as F
    x, r, scale = norm_inputs(torch, N, d, dtype, offset)
    (h, y), (wh, wy) = rn.add_rmsnorm(x, r, scale), \
        ref.add_rmsnorm_ref(x, r, scale)
    err = float((y.float() - wy.float()).abs().max())
    n_h = int((h != wh).sum())
    rtol = NORM_RTOL[str(dtype)[6:]]
    ok = n_h == 0 and torch.allclose(y.float(), wy.float(), atol=1e-6,
                                     rtol=rtol)
    body = "vector" if rn.vector_width(d, x.element_size(), x, r) > 1 \
        else "scalar"
    log(f"  add_rmsnorm N={N} d={d} {str(dtype)[6:]} offset {offset} "
        f"({body} body): h differing values {n_h}, y max |err| {err:.3e} "
        f"(rtol {rtol:.3g})")
    if not ok:
        raise AssertionError("add_rmsnorm differs from x + r and the plain "
                             "norm")
    if not timed:
        return None
    gain = (1.0 + scale).to(dtype)
    lib = lambda a, b, w: (a + b, F.rms_norm(a + b, (d,), weight=w,
                                              eps=1e-6))
    iters = 50 if N > 64 else 200
    r_ = {"err": err,
          "ms": cuda_ms(torch, rn.add_rmsnorm, [(x, r, scale)], iters),
          "plain_ms": cuda_ms(torch, ref.add_rmsnorm_ref, [(x, r, scale)],
                              iters),
          "library_ms": cuda_ms(torch, lib, [(x, r, gain)], iters),
          "bound": cost_bound("add_rmsnorm", x, r, scale,
                              peak=peak_of(torch, dtype))}
    r_["eager_ms"] = eager_ms(torch, rn.add_rmsnorm, [(x, r, scale)], iters)
    log(f"  add_rmsnorm {N}x{d}: {r_['ms']:.4f} ms ({r_['eager_ms']:.4f} ms "
        f"launched eagerly), plain {r_['plain_ms']:.4f} ms, library "
        f"{r_['library_ms']:.4f} ms (x + r, F.rms_norm), bound "
        f"{r_['bound'][0]:.5f} ms ({r_['bound'][1]})")
    return r_


def check_norm_rows(torch, ops, d, dtype):
    """Rows normed in a 4-row launch equal the same rows inside a 1024-row
    launch, byte for byte (rmsnorm and add_rmsnorm): a row's summation
    order must not depend on the row count."""
    x, r, scale = norm_inputs(torch, 1024, d, dtype)
    rows = [0, 1, 511, 1023]
    few = lambda t: t[rows].contiguous()
    h, y = ops.add_rmsnorm(x, r, scale)
    h4, y4 = ops.add_rmsnorm(few(x), few(r), scale)
    same = (torch.equal(h[rows], h4) and torch.equal(y[rows], y4)
            and torch.equal(ops.rmsnorm(x, scale)[rows],
                            ops.rmsnorm(few(x), scale)))
    log(f"  norm rows {rows} of a 1024-row launch == the same rows in a "
        f"4-row launch (d={d} {str(dtype)[6:]}): {same}")
    if not same:
        raise AssertionError("a norm row's bytes depend on the row count")


def check_decode(torch, ref, da, L, B, Hkv, g, hd, S, kv_len, qdt, kvdt, *,
                 controls=(), timed, softcap=0.0, scale=1.0):
    """Dense decode attention on one layer of an (L, B, S, Hkv, hd) cache,
    read through the permuted (B, Hkv, S, hd) view as the model does;
    layers cycled when timed, so the L2 is cold. ``controls`` names wrong
    versions the check must reject (:func:`decode_controls`; with a
    ``softcap`` also "no cap"). ``scale`` multiplies q and K."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + B + S + hd)
    K = (torch.randn((L, B, S, Hkv, hd), generator=gen, device="cuda")
         * scale).to(kvdt)
    V = torch.randn((L, B, S, Hkv, hd), generator=gen, device="cuda").to(kvdt)
    q = (torch.randn((B, Hkv, g, hd), generator=gen, device="cuda")
         * scale).to(qdt)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    layer = [(q, K[i].permute(0, 2, 1, 3), V[i].permute(0, 2, 1, 3), kl)
             for i in range(L)]
    fn_ref = lambda a, b, c, n: ref.decode_attention_ref(
        a, b, c, kv_len=n, softcap=softcap)
    fn = lambda a, b, c, n: da.decode_attention(a, b, c, n, softcap=softcap)
    got, want = fn(*layer[0]), fn_ref(*layer[0])
    err = float((got.float() - want.float()).abs().max())
    ok, worst = attn_close(torch, got, want)
    log(f"  decode_attention B={B} Hkv={Hkv} g={g} hd={hd} S={S} "
        f"kv_len={kv_len} softcap={softcap} q {str(qdt)[6:]} kv "
        f"{str(kvdt)[6:]}: max |err| {err:.3e}, worst |err| / tol "
        f"{worst:.3g} ({ATTN_TOL_TEXT[str(qdt)[6:]]})")
    if not ok:
        raise AssertionError("decode attention differs from the plain "
                             "version beyond tolerance")
    q0, k0, v0, _ = layer[0]
    wrong = decode_controls(torch, fn_ref, q0, k0, v0, (), kl)
    wrong["no cap"] = lambda: ref.decode_attention_ref(q0, k0, v0,
                                                       kv_len=kl)
    negative_controls(torch, got, {c: wrong[c] for c in controls})
    if not timed:
        return None
    nbytes = cost_bytes("decode_attention", *layer[0], kv_len=kv_len)
    if softcap:
        r = {"err": err, "ms": cuda_ms(torch, fn, layer, 3 * L),
             "plain_ms": cuda_ms(torch, fn_ref, layer, L),
             "library_ms": flex_softcap(torch, q0[:, :, :, None].reshape(
                 B, Hkv * g, 1, hd).transpose(1, 2), k0.transpose(1, 2),
                 v0.transpose(1, 2), want.reshape(B, Hkv * g, 1, hd)
                 .transpose(1, 2), softcap, causal=False, kv_len=kl),
             "bound": cost_bound("decode_attention", *layer[0],
                                 kv_len=kv_len, softcap=softcap,
                                 peak=peak_of(torch, kvdt))}
        r["eager_ms"] = eager_ms(torch, fn, layer, 3 * L)
        log(f"  decode_attention softcap {softcap}: {r['ms']:.4f} ms/layer "
            f"({r['eager_ms']:.4f} ms launched eagerly), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}, {nbytes} B); layers "
            f"cycled, L2 cold")
        return r

    def sdpa(a, b, c, n):
        # the g query heads of a KV head as g query rows, kv_len as a mask
        mask = (torch.arange(S, device="cuda")[None] < n[:, None])
        return F.scaled_dot_product_attention(a, b, c,
                                              attn_mask=mask[:, None, None])

    lib = sdpa(*layer[0])
    log(f"    SDPA vs plain max |err| "
        f"{float((lib.float() - want.float()).abs().max()):.3e}")
    r = {"err": err,
         "ms": cuda_ms(torch, da.decode_attention, layer, 3 * L),
         "plain_ms": cuda_ms(torch, fn_ref, layer, L),
         "library_ms": cuda_ms(torch, sdpa, layer, 3 * L),
         "bound": cost_bound("decode_attention", *layer[0], kv_len=kv_len,
                             peak=peak_of(torch, kvdt))}
    r["eager_ms"] = eager_ms(torch, da.decode_attention, layer, 3 * L)
    log(f"  decode_attention: {r['ms']:.4f} ms/layer ({r['eager_ms']:.4f} "
        f"ms launched eagerly), plain {r['plain_ms']:.4f} ms, library "
        f"{r['library_ms']:.4f} ms (SDPA, kv_len mask), bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}, {nbytes} B); layers "
        f"cycled, L2 cold")
    return r


LSE_TOL = 1e-5     # the partial mode's f32 log-sum-exp: atol = rtol


def check_decode_lse(torch, ref, da, L, B, Hkv, g, hd, S, kv_len, *,
                     timed):
    """The dense kernel's partial mode (``decode_attention_lse``: ``o``
    f32 normalised over the call's keys, and each row's f32
    log-sum-exp), as a kv_seq rank calls it: bf16 q over one layer of a
    rank's (L, B, S, Hkv, hd) share, kv_len the rank's (a slot at 0: a
    rank that owns no position yet, which must give o 0 and lse -inf).
    ``o`` is held as an f32 attention output (``ATTN_TOL_F32``), ``lse``
    to ``LSE_TOL``; the negative controls (a 64-key split dropped from
    o, and from lse) must fail. Timed as :func:`check_decode`, SDPA
    beside it (it computes ``o``, not ``lse``)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5 + B + S + hd)
    bf16 = torch.bfloat16
    K = torch.randn((L, B, S, Hkv, hd), generator=gen, device="cuda").to(bf16)
    V = torch.randn((L, B, S, Hkv, hd), generator=gen, device="cuda").to(bf16)
    q = torch.randn((B, Hkv, g, hd), generator=gen, device="cuda").to(bf16)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    layer = [(q, K[i].permute(0, 2, 1, 3), V[i].permute(0, 2, 1, 3), kl)
             for i in range(L)]

    def fn_ref(a, b, c, n):
        return ref.decode_attention_ref(a, b, c, kv_len=n, return_lse=True)

    (o, lse), (wo, wl) = da.decode_attention_lse(*layer[0]), \
        fn_ref(*layer[0])
    empty = kl == 0

    def lse_close(got, want):
        fin = torch.isfinite(want)
        same_inf = bool((torch.isfinite(got) == fin).all())
        err = (got[fin] - want[fin]).abs()
        worst = float((err / (LSE_TOL + LSE_TOL * want[fin].abs())).max()) \
            if fin.any() else 0.0
        return same_inf and worst <= 1, worst

    ok_o, worst_o = attn_close(torch, o, wo)
    ok_l, worst_l = lse_close(lse, wl)
    zero = bool((o[empty] == 0).all()) and bool(
        (lse[empty] == float("-inf")).all())
    log(f"  decode_attention_lse B={B} Hkv={Hkv} g={g} hd={hd} S={S} "
        f"kv_len={kv_len}: o max |err| "
        f"{float((o - wo).abs().max()):.3e}, worst |err| / tol "
        f"{worst_o:.3g} ({ATTN_TOL_TEXT['float32']}); lse worst |err| / "
        f"tol {worst_l:.3g} (atol = rtol = {LSE_TOL}); the empty rows o "
        f"= 0, lse = -inf: {zero}")
    if not (ok_o and ok_l and zero and o.dtype == torch.float32):
        raise AssertionError("the partial mode differs from its plain "
                             "version")
    if max(kv_len) > 64:
        short = torch.where(kl > 64, kl - 64, kl)
        wrong_o, wrong_l = fn_ref(q, layer[0][1], layer[0][2], short)
        negative_controls(torch, o, {"kv_len - 64": lambda: wrong_o})
        bad, w = lse_close(lse, wrong_l)
        log(f"    negative control (lse of kv_len - 64): worst |err| / tol "
            f"{w:.3g}, rejected: {not bad}")
        if bad:
            raise AssertionError("the lse check cannot tell a dropped "
                                 "split")
    r = {"err": max(float((o - wo).abs().max()),
                    float((lse - wl)[torch.isfinite(wl)].abs().max()))}
    if not timed:
        return r
    nbytes = cost_bytes("decode_attention_lse", *layer[0], kv_len=kv_len)

    def sdpa(a, b, c, n):
        mask = (torch.arange(S, device="cuda")[None] < n[:, None])
        return F.scaled_dot_product_attention(a, b, c,
                                              attn_mask=mask[:, None, None])

    r.update(ms=cuda_ms(torch, da.decode_attention_lse, layer, 3 * L),
             plain_ms=cuda_ms(torch, fn_ref, layer, L),
             library_ms=cuda_ms(torch, sdpa, layer, 3 * L),
             bound=cost_bound("decode_attention_lse", *layer[0],
                              kv_len=kv_len, peak=BF16_FLOP_PER_S))
    r["eager_ms"] = eager_ms(torch, da.decode_attention_lse, layer, 3 * L)
    log(f"  decode_attention_lse at kv_len {kv_len}: {r['ms']:.5f} ms/layer "
        f"({r['eager_ms']:.5f} ms launched eagerly), plain "
        f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms (SDPA "
        f"over the 256 rows, each slot's kv_len a mask; o only), bound "
        f"{r['bound'][0]:.5f} ms "
        f"({r['bound'][1]}, {nbytes} B); layers cycled, L2 cold")
    return r


def lse_shapes(torch, ref, da):
    """The partial mode at the kv_seq ranks' shapes: LLaMA-30B's decode
    step (4 slots, 52 heads of 128) on a TP-2 rank's half of a 512-row
    cache, phase 5's kv_len with slot 0 moved past 256 (360, 123, 56,
    17): rank 0's share (positions 0-255: 256, 123, 56, 17 keys), timed,
    the row of the kernels line; a full 256-row share on every slot,
    timed; rank 1's (positions 256-511: slot 0's 104 keys, the others
    none yet), checked only, its time the launch's; and gemma-2b's 8
    query heads over its one KV head at hd 256 on a 256-row share (one
    slot at 0), timed. Returns ``[(kernel, arch, shape, result)]``,
    LLaMA-30B's rank 0 first."""
    from repro_torch.configs import get_config
    cfg, gem = get_config("llama-30b"), get_config("gemma-2b")
    rows = []
    for c, L, kv, what, timed in (
            (cfg, cfg.num_layers, [256, 123, 56, 17],
             "TP-2 rank 0 of a 512-row kv_seq cache", True),
            (cfg, cfg.num_layers, [256] * 4,
             "a full 256-row kv_seq share on every slot", True),
            (cfg, cfg.num_layers, [104, 0, 0, 0],
             "TP-2 rank 1 of the same step", False),
            (gem, gem.num_layers, [232, 123, 0, 17],
             "a 256-row kv_seq share, one slot empty", True)):
        g = c.num_heads // c.num_kv_heads
        S = 256
        shape = f"4 slots x {c.num_heads} heads over {c.num_kv_heads}, " \
            f"hd {c.head_dim}, {what}, kv_len {kv}"
        rows.append(("decode_attention_lse", c.name, shape,
                     check_decode_lse(torch, ref, da, L, 4, c.num_kv_heads,
                                      g, c.head_dim, S, kv, timed=timed)))
    check_decode_lse(torch, ref, da, 2, 3, 2, 4, 16, 40, [1, 0, 23],
                     timed=False)
    return rows


def decode_split_anatomy(torch, da, L, B, Hkv, hd, S):
    """Graph-replay times of the split bf16 body (dense view, bf16, L2
    cold) over kv_len patterns that take its cost apart: one key a slot
    (launch, kv_len, early exits), one full 64-key split a slot (a round
    of loads, no merge), 65 keys (two splits and the in-launch merge),
    and every key."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    K = torch.randn((L, B, S, Hkv, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    V = torch.randn_like(K)
    q = torch.randn((B, Hkv, 1, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    out = {}
    for n in (1, 64, 65, S):
        kl = torch.full((B,), n, dtype=torch.int32, device="cuda")
        layer = [(q, K[i].permute(0, 2, 1, 3), V[i].permute(0, 2, 1, 3), kl)
                 for i in range(L)]
        out[n] = cuda_ms(torch, da.decode_attention, layer, 3 * L)
    log("  decode_attention split anatomy (B=4, S=256, every slot at one "
        "kv_len): " + ", ".join(f"kv_len {n}: {ms * 1e3:.2f} us"
                                for n, ms in out.items()))
    return out


def check_paged_bf16(torch, ref, pa, L, B, Hkv, gq, hd, ps, W, kv_len, qdt,
                     *, controls=(), timed):
    """The bf16 paged body over L layers of (P, ps, Hkv, hd) bf16 pages
    and a shuffled page table (unused entries: the trash page 0);
    ``controls`` as :func:`decode_controls` names them."""
    P = B * W + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + B + ps + hd)
    kp = torch.randn((L, P, ps, Hkv, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vp = torch.randn((L, P, ps, Hkv, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    n = 0
    for b, ln in enumerate(kv_len):
        k = min(-(-ln // ps), W)
        pt[b, :k] = perm[n:n + k]
        n += k
    q = torch.randn((B, Hkv, gq, hd), generator=gen, device="cuda").to(qdt)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    layer = [(q, kp[i], vp[i], pt.cuda(), kl) for i in range(L)]
    fn = lambda *a: pa.paged_decode_attention_bf16(*a, page_size=ps)
    fn_ref = lambda *a: ref.paged_decode_attention_ref(*a, page_size=ps)
    got, want = fn(*layer[0]), fn_ref(*layer[0])
    err = float((got.float() - want.float()).abs().max())
    ok, worst = attn_close(torch, got, want)
    log(f"  paged_decode_attention_bf16 B={B} Hkv={Hkv} gq={gq} hd={hd} "
        f"ps={ps} W={W} kv_len={kv_len} q {str(qdt)[6:]}: max |err| "
        f"{err:.3e}, worst |err| / tol {worst:.3g} "
        f"({ATTN_TOL_TEXT[str(qdt)[6:]]})")
    if not ok:
        raise AssertionError("bf16 paged attention differs from the plain "
                             "version beyond tolerance")
    wrong = decode_controls(torch, fn_ref, q, kp[0], vp[0], (layer[0][3],),
                            kl)
    negative_controls(torch, got, {c: wrong[c] for c in controls})
    if not timed:
        return None
    nbytes = cost_bytes("paged_decode_attention_bf16", *layer[0],
                        page_size=ps, kv_len=kv_len)
    r = {"err": err,
         "ms": cuda_ms(torch, fn, layer, 3 * L),
         "plain_ms": cuda_ms(torch, fn_ref, layer, L),
         "bound": cost_bound("paged_decode_attention_bf16", *layer[0],
                             page_size=ps, kv_len=kv_len,
                             peak=peak_of(torch, torch.bfloat16))}
    r["eager_ms"] = eager_ms(torch, fn, layer, 3 * L)
    log(f"  paged_decode_attention_bf16: {r['ms']:.4f} ms/layer "
        f"({r['eager_ms']:.4f} ms launched eagerly), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
        f"({r['bound'][1]}, {nbytes} B); no single PyTorch call gathers "
        f"pages; layers cycled, L2 cold")
    return r


# hd 80, 120, 256, and hd 128 at 8 query heads a KV head (int4 pages take
# their Geo<128, 4> body, flash its GQA at hd 128); then the MoE and VLM
# configs: 16 query heads a KV head (qwen3-moe: 4 row blocks of 4 in the
# int4 kernel), 5 (llama4-maverick: 2 blocks, 3 rows padded) and 4
# (llava-next, whose prefill is 576 patches + 40 text tokens, exact)
ARCH_SHAPES = ("stablelm-3b", "h2o-danube-3-4b", "gemma-2b", "command-r-35b",
               "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
               "llava-next-mistral-7b")
DECODE_LENS = [232, 123, 56, 17]          # phase 5's decode step
# the live slots of the served cells' decode step (96 slots): about
# conversation's 12 residents and coding's 3, at 1,000-3,000 tokens
CELL_LIVE = ((1000, 1234, 1500, 1777, 2000, 2048, 2049, 2222, 2500, 2750,
              2999, 3000), (1024, 1800, 3000))
# arch -> (flash batch, prompt tokens), (dense cache rows, kv_len) where
# they are not the bucket's 4 x 256 and DECODE_LENS over 256 rows
FLASH_SHAPE = {"llava-next-mistral-7b": (1, 616)}
DECODE_SHAPE = {"llava-next-mistral-7b": (640, [640, 630, 617, 300])}


def check_arch_shapes(torch, ref, fa, da, pa, kq, rn):
    """The other configs' attention shapes (stablelm-3b hd 80,
    h2o-danube-3-4b hd 120, gemma-2b hd 256, command-r-35b hd 128 with 8
    query heads a KV head; qwen3-moe 16, llama4-maverick 5 and
    llava-next 4 at hd 128) in every attention kernel their path runs, at
    their full width: flash attention at the prefill bucket (4 x 256;
    h2o-danube: phase 8's 4200-token prompt over its 4096-token window;
    llava-next: its 616-token exact prompt), the dense decode step (4
    slots; h2o-danube: its full 4096-row ring and two shorter slots;
    llava-next: a 640-row cache past its 616-token prefill), and where
    the arch pages the int4 and bf16 paged bodies and the int4 append at
    the same step; qwen3-moe's q/k norms (``rmsnorm`` over rows of 128,
    at the bucket's 65,536 q rows and a 4-slot step's 256). Each is
    checked against its plain version and timed beside it, the bound and
    SDPA (flash and dense decode) or ``F.rms_norm``; the f32 bodies are
    checked at small shapes. Negative controls: the window's check must
    reject the plain version without a window, flash and every dense
    decode check the keys' last 8 head-dim elements zeroed, every decode
    check (dense and paged) a 64-key split dropped, and where a KV head
    has several query heads, their rows rolled by one; the norm check
    two rows normed as one. Returns ``[(kernel, arch, shape, result)]``."""
    from repro_torch.configs import get_config
    from repro_torch.models.paged import paged_supported
    bf16 = torch.bfloat16
    rows = []
    for arch in ARCH_SHAPES:
        cfg = get_config(arch)
        L, H, Hkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        g = H // Hkv
        rolled = ("rows rolled",) if g > 1 else ()
        dec_controls = ("kv_len - 64", "last 8 of hd") + rolled
        log(f"  {arch}: hd {hd}, {H} heads (kv {Hkv}), {L} layers")
        if cfg.sliding_window:
            W = cfg.sliding_window
            rows.append(("flash_attention", arch,
                         f"prefill 1 x 4200, window {W}",
                         check_flash(torch, ref, fa, 1, 4200, 0, H, Hkv, hd,
                                     bf16, window=W,
                                     controls=("window 0", "last 8 of hd"),
                                     timed=True)))
            dec_S, dec_lens = W, [W, W, 300, 17]
        else:
            B, S = FLASH_SHAPE.get(arch, (4, 256))
            rows.append(("flash_attention", arch,
                         f"{'exact' if B == 1 else 'bucket'} {B} x {S}",
                         check_flash(torch, ref, fa, B, S, 0, H, Hkv, hd,
                                     bf16, controls=("last 8 of hd",),
                                     timed=True)))
            dec_S, dec_lens = DECODE_SHAPE.get(arch, (256, DECODE_LENS))
        check_flash(torch, ref, fa, 2, 100, 0, 4, 2, hd, torch.float32,
                    window=17 if cfg.sliding_window else 0, timed=False)
        rows.append(("decode_attention", arch,
                     f"decode 4 slots, {dec_S}-row cache, kv_len {dec_lens}",
                     check_decode(torch, ref, da, L, 4, Hkv, g, hd, dec_S,
                                  dec_lens, bf16, bf16,
                                  controls=dec_controls, timed=True)))
        check_decode(torch, ref, da, 2, 3, 2, 4, hd, 40, [1, 40, 23],
                     torch.float32, torch.float32, timed=False)
        if cfg.qk_norm:
            for n, what in ((4 * 256 * H, "q rows of the bucket"),
                            (4 * H, "q rows of a 4-slot step")):
                rows.append(("rmsnorm", arch, f"{n} x {hd} ({what})",
                             check_rmsnorm(torch, ref, rn, n, hd, bf16,
                                           control=True, timed=True)))
        if not paged_supported(cfg):
            continue
        step = f"decode 4 slots, kv_len {DECODE_LENS}"
        page_controls = ("kv_len - 64",) + rolled
        rows.append(("paged_decode_attention_int4", arch, step,
                     check_attention(torch, ref, pa, L, 4, Hkv, g, hd, 16,
                                     16, DECODE_LENS, bf16,
                                     controls=page_controls, timed=True)))
        rows.append(("paged_decode_attention_bf16", arch, step,
                     check_paged_bf16(torch, ref, pa, L, 4, Hkv, g, hd, 16,
                                      16, DECODE_LENS, bf16,
                                      controls=page_controls, timed=True)))
        check_attention(torch, ref, pa, 2, 3, 2, 4, hd, 8, 4, [5, 16, 23],
                        torch.float32, timed=False)
        check_append(torch, ref, kq, 4, Hkv, hd, 16, 16, DECODE_LENS, bf16,
                     timed=False)
    log("  the other configs' shapes: kernel, arch, shape: ms (plain, "
        "library, bound)")
    for name, arch, shape, r in rows:
        log(f"    {name} {arch} ({shape}): {r['ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, library "
            f"{r.get('library_ms') or float('nan'):.5f}, bound "
            f"{r['bound'][0]:.5f} by {r['bound'][1]}; "
            f"{r['ms'] / r['bound'][0]:.1f}x the bound)")
    return rows


def check_recurrent_shapes(torch, ref, fa, da, rn):
    """The shapes the recurrent and encoder-decoder configs give the
    kernels (phase 10's path), at their published widths: whisper-base's
    encoder (flash, 4 x 1500 frames, 8 heads of 64, bidirectional), its
    cross-attention prefill (flash, 4 x 256 queries over the 1500 frames,
    bidirectional: ``Sk`` no multiple of the 64-key tile), its decoder's
    causal self-attention at a 4 x 256 bucket, and its two decode
    attentions (4 slots: self over a 256-row cache, cross over the 1500
    frames); jamba's attention layers (flash at a 4 x 256 bucket and the
    dense decode step, 32 heads over 8 at hd 128, two layers in the
    16-layer cut); ``rmsnorm`` over the mLSTM's rows of 1536 (a 1024-row
    prefill, a 4-slot step). Each checked against its plain version and
    timed beside it, the bound and SDPA or ``F.rms_norm``; the
    bidirectional flash checks must reject the plain version with a
    causal mask applied, besides the earlier controls; the f32 bodies and
    a ragged 70-key tail are checked small. Returns ``[(kernel, arch,
    shape, result)]``."""
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    w, j = get_config("whisper-base"), get_config("jamba-v0.1-52b")
    H, hd, L, E = w.num_heads, w.head_dim, w.num_layers, w.encoder_seq
    bidir = ("causal", "last 8 of hd")
    dec_controls = ("kv_len - 64", "last 8 of hd")
    log(f"  whisper-base: hd {hd}, {H} heads, {L} decoder layers, {E} "
        f"frames; jamba-v0.1-52b: hd {j.head_dim}, {j.num_heads} heads "
        f"(kv {j.num_kv_heads})")
    rows = [
        ("flash_attention", "whisper-base",
         f"encoder 4 x {E} frames, bidirectional",
         check_flash(torch, ref, fa, 4, E, 0, H, H, hd, bf16, causal=False,
                     controls=bidir, timed=True)),
        ("flash_attention", "whisper-base",
         f"cross-attention 4 x 256 tokens over {E} frames",
         check_flash(torch, ref, fa, 4, 256, 0, H, H, hd, bf16,
                     causal=False, Sk=E, controls=bidir, timed=True)),
        ("flash_attention", "whisper-base",
         "decoder self-attention, bucket 4 x 256",
         check_flash(torch, ref, fa, 4, 256, 0, H, H, hd, bf16,
                     controls=("last 8 of hd",), timed=True)),
        ("flash_attention", "jamba-v0.1-52b", "bucket 4 x 256",
         check_flash(torch, ref, fa, 4, 256, 0, j.num_heads,
                     j.num_kv_heads, j.head_dim, bf16,
                     controls=("last 8 of hd",), timed=True)),
        ("decode_attention", "whisper-base",
         f"self-attention, 4 slots, 256-row cache, kv_len {DECODE_LENS}",
         check_decode(torch, ref, da, L, 4, H, 1, hd, 256, DECODE_LENS,
                      bf16, bf16, controls=dec_controls, timed=True)),
        ("decode_attention", "whisper-base",
         f"cross-attention, 4 slots over {E} frames",
         check_decode(torch, ref, da, L, 4, H, 1, hd, E, [E] * 4, bf16,
                      bf16, controls=dec_controls, timed=True)),
        ("decode_attention", "jamba-v0.1-52b",
         f"decode 4 slots, 256-row cache, kv_len {DECODE_LENS}, 2 layers",
         check_decode(torch, ref, da, 2, 4, j.num_kv_heads,
                      j.num_heads // j.num_kv_heads, j.head_dim, 256,
                      DECODE_LENS, bf16, bf16,
                      controls=dec_controls + ("rows rolled",),
                      timed=True)),
        ("rmsnorm", "xlstm-125m", "1024 x 1536 (mLSTM prefill rows)",
         check_rmsnorm(torch, ref, rn, 1024, 1536, bf16, control=True,
                       timed=True)),
        ("rmsnorm", "xlstm-125m", "4 x 1536 (mLSTM, a 4-slot step)",
         check_rmsnorm(torch, ref, rn, 4, 1536, bf16, timed=True))]
    # the reduced f32 bodies (phase 4's whisper), a ragged bf16 tail, the
    # sLSTM's rows of 768 and jamba's fused norm at d 4096
    check_flash(torch, ref, fa, 2, 24, 0, 4, 4, 16, f32, causal=False,
                controls=("causal",), timed=False)
    check_flash(torch, ref, fa, 2, 9, 0, 4, 4, 16, f32, causal=False, Sk=24,
                controls=("causal",), timed=False)
    check_flash(torch, ref, fa, 2, 33, 0, H, H, hd, bf16, causal=False,
                Sk=70, controls=bidir, timed=False)
    check_rmsnorm(torch, ref, rn, 4, 768, bf16, control=True, timed=False)
    check_add_rmsnorm(torch, ref, rn, 4, j.d_model, bf16, timed=False)
    log("  the recurrent and encoder-decoder configs' shapes: kernel, arch, "
        "shape: ms (plain, library, bound)")
    for name, arch, shape, r in rows:
        log(f"    {name} {arch} ({shape}): {r['ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, library "
            f"{r.get('library_ms') or float('nan'):.5f}, bound "
            f"{r['bound'][0]:.5f} by {r['bound'][1]}; "
            f"{r['ms'] / r['bound'][0]:.1f}x the bound)")
    return rows


# -- phases 4, 5 and 8: serving ----------------------------------------------


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


DECODE_MODES = {"int4": {}, "dense": {"paged": False},
                "bf16": {"kv_resident": "bf16"}}


def make_params(torch, cfg, *, seed=SEED, device="cuda", dtype=None,
                mesh=None):
    """Random weights of ``cfg``: ``whisper.init_params`` for the audio
    config, ``transformer.init_params`` for every other (this rank's
    shard under a ``mesh``)."""
    from repro_torch.models import transformer, whisper
    init = whisper.init_params if cfg.family == "audio" \
        else transformer.init_params
    return init(cfg, seed=seed, device=device,
                dtype=dtype or torch.bfloat16, mesh=mesh)


class FramePrefill:
    """Whisper's prefill for the engines: the model API
    (``registry.build(cfg).prefill``) over seeded frame embeddings, one
    ``(encoder_seq, d_model)`` block a request drawn from ``SEED +
    rid``, prompts grouped by exact length, wires extracted as
    ``PrefillEngine._run_exact`` extracts them (the engine itself cannot
    prefill audio: its batches hold tokens only, as the reference's
    do)."""
    bucketed = False

    def __init__(self, torch, cfg, params, device="cuda", rt=None):
        from repro_torch.models import registry
        self.torch, self.cfg, self.params = torch, cfg, params
        self.device = device
        self.api = registry.build(cfg, rt=rt)

    def frames(self, rid):
        rng = np.random.default_rng(SEED + rid)
        return rng.standard_normal(
            (self.cfg.encoder_seq, self.cfg.d_model)).astype(np.float32)

    def run(self, reqs, compress=True):
        from repro_torch.serving import kv_transfer
        torch, out, by_len = self.torch, [], {}
        for r in reqs:
            by_len.setdefault(len(r.tokens), []).append(r)
        for n, group in by_len.items():
            batch = {"tokens": np.stack([np.asarray(r.tokens)
                                         for r in group]).astype(np.int64),
                     "frame_embeds": np.stack([self.frames(r.rid)
                                               for r in group])}
            logits, cache = self.api.prefill(
                self.params, {k: torch.as_tensor(v, device=self.device)
                              for k, v in batch.items()})
            first = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            wires = kv_transfer.extract_batch(
                cache, [(i, n) for i in range(len(group))],
                compress=compress)
            out.extend((r, wires[i], int(first[i]))
                       for i, r in enumerate(group))
        return out


def prefill_engine(torch, cfg, params, *, max_seq, device="cuda", rt=None):
    from repro_torch.serving import engine as E
    if cfg.family == "audio":
        return FramePrefill(torch, cfg, params, device, rt=rt)
    return E.PrefillEngine(cfg, params, max_seq=max_seq, max_batch=4,
                           device=device, rt=rt)


def serve_small(torch, device, mode="int4", arch="llama-30b", over=None):
    """The reduced ``arch`` in float32 through the engines with the decode
    cache of ``mode`` (``DECODE_MODES``); returns tokens. Its prompts (7,
    19 and 33 tokens, 12 new) overrun h2o-danube's 32-token window.
    Whisper prefills through the model API (:class:`FramePrefill`).
    ``over``: config fields changed (phase 14's options)."""
    from repro_torch.configs import get_reduced
    from repro_torch.serving import engine as E
    cfg = get_reduced(arch).replace(dtype="float32", **(over or {}))
    # drawn on the CPU and copied: a CUDA generator gives other numbers
    params = to_device(make_params(torch, cfg, device="cpu",
                                   dtype=torch.float32), device)
    pre = prefill_engine(torch, cfg, params, max_seq=64, device=device)
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, page_size=8,
                         chunk_size=4, device=device, **DECODE_MODES[mode])
    rng = np.random.default_rng(SEED)
    reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 12)
            for i, n in enumerate((7, 19, 33))]
    out = pre.run(reqs)
    rest = dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in out]))
    assert not rest, "small reference run: admission rejected"
    while dec.active:
        dec.step()
    return [r.out_tokens for r in reqs]


ADD_KERNELS = ("AddFunctor", "CUDAFunctor_add")   # PyTorch's add, by name
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
                "cudaLaunchKernelExC", "cudaGraphLaunch")


def profile_chunk(torch, run, n_steps, what="chunk", per="step"):
    """Device time of one decode chunk (or of ``what``: ``n_steps`` units
    of ``per``) by kernel (torch.profiler, CUDA activity only) against its
    wall time on the host clock, the host's kernel launch calls by API
    (a graph replay is one ``cudaGraphLaunch``), and PyTorch's add
    kernels per unit: those on bf16 tensors are, in a bf16 model, the
    residual adds that ``add_rmsnorm`` fuses."""
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    wall_ms = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
             e.key) for e in averages]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_launch = sum(r[1] for r in rows)
    # the host's launch calls: exact, where the device records (kernels
    # and copies) can come back short when the tracer drops some
    calls = {e.key: e.count for e in averages if e.key in LAUNCH_CALLS}
    n_calls = sum(calls.values())
    log(f"  profiled {what} of {n_steps} {per}s: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{n_launch} device records; per {per}: {busy_ms / n_steps:.2f} ms "
        f"of device time, {n_launch / n_steps:.0f} records; launch calls "
        f"{json.dumps(calls)}, {n_calls / n_steps:.2f} a {per}")
    # the 8 largest, then the port's own kernels below them
    for ms, n, name in rows[:8] + [r for r in rows[8:]
                                   if "(anonymous namespace)::" in r[2]
                                   and "at::" not in r[2]]:
        log(f"    {ms:9.3f} ms  x{n:<6d} {name[:70]}")
    adds = [(n, name) for _, n, name in rows
            if any(a in name for a in ADD_KERNELS)]
    n_bf16 = sum(n for n, name in adds if "BFloat16" in name)
    log(f"    add kernels per {per}: {n_bf16 / n_steps:g} on bf16 tensors "
        f"(residual adds), {sum(n for n, _ in adds) / n_steps:g} of any "
        f"type")


def check_norm_launches(cfg, before, after, n, what, prefill=False):
    """The norm wrappers' launches over ``n`` decode steps (or prefill
    calls): each residual add is fused with the norm after it, so a step
    launches 1 rmsnorm and 2 add_rmsnorm a layer; a prefill call 2 and
    2L - 1 (its last add stays unfused; the final norm sees the kept rows
    only). q/k norms add 2 rmsnorm a layer."""
    L = cfg.num_layers
    qk = 2 * L if cfg.qk_norm else 0
    got = {k: after[k] - before[k] for k in ("rmsnorm", "add_rmsnorm")}
    want = ({"rmsnorm": (2 + qk) * n, "add_rmsnorm": (2 * L - 1) * n}
            if prefill else {"rmsnorm": (1 + qk) * n,
                             "add_rmsnorm": 2 * L * n})
    per = "call" if prefill else "step"
    log(f"  {what}: per {per} rmsnorm {got['rmsnorm'] / n:g}, add_rmsnorm "
        f"{got['add_rmsnorm'] / n:g} launches ({n} {per}s)")
    if got != want:
        raise AssertionError(f"{what}: norm launches {got}, want {want}")


class Clock:
    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self):
        return time.perf_counter() - self.t0


ARMS = ("graph", "eager")


def dense_cache_equal(torch, a, b, slots, lengths):
    """Whether two dense decode caches hold the same bytes wherever the
    occupied ``slots`` can read: attention rows below each slot's length,
    a recurrent stack's whole states, whisper's self rows below the
    length and its whole cross K/V."""
    for name, x in a.items():
        if name == "lengths":
            continue
        y = b[name]
        if isinstance(x, dict) and "k" in x:
            pairs = [(x[k][:, i, :lengths[i]], y[k][:, i, :lengths[i]])
                     for k in ("k", "v") for i in slots]
        elif isinstance(x, dict):
            pairs = [(x[k][:, i], y[k][:, i]) for k in x for i in slots]
        else:
            n = (lambda i: lengths[i]) if name.startswith("self_") \
                else (lambda i: x.shape[2])
            pairs = [(x[:, i, :n(i)], y[:, i, :n(i)]) for i in slots]
        if not all(torch.equal(p, q) for p, q in pairs):
            return False
    return True


class Pair:
    """Phase 5's A/B: a graphed and an eager ``DecodeEngine`` of one decode
    cache on one set of weights, driven in lockstep. Each arm has its own
    requests (same ids, prompts and budgets) and takes the same
    admissions; after every admission and every chunk the arms must hold
    the same slots, tokens, current tokens, lengths, page table and pool,
    and every byte attention can read (every page but the trash page,
    where idle slots' writes race; dense: :func:`dense_cache_equal`).
    Chunks alternate which arm goes first; each arm's chunk
    is timed on the host clock (``step()`` ends in the chunk's one
    device -> host copy)."""

    def __init__(self, torch, cfg, params, mode, device, max_seq=256):
        from repro_torch.serving import engine as E
        self.torch, self.E, self.mode = torch, E, mode
        kw = dict(max_slots=4, max_seq=max_seq, page_size=16, chunk_size=8,
                  prefix_sharing=mode != "dense", device=device,
                  **DECODE_MODES[mode])
        self.dec = {arm: E.DecodeEngine(cfg, params,
                                        cuda_graph=arm == "graph", **kw)
                    for arm in ARMS}
        self.reqs = {arm: {} for arm in ARMS}
        self.host_ms = {arm: [] for arm in ARMS}    # (round, ms per step)
        self.round = 1
        self.n_chunks = 0
        self.on_card = device == "cuda"

    def request(self, rid, tokens, max_new):
        for arm in ARMS:
            self.reqs[arm][rid] = self.E.GenRequest(rid, tokens.copy(),
                                                    max_new)
        return self.reqs["graph"][rid]

    def admit(self, items_of):
        """``items_of(arm)``: that arm's AdmissionItems."""
        for arm in ARMS:
            if self.dec[arm].admit(self.E.AdmissionBatch(items_of(arm))):
                raise AssertionError(f"{self.mode} {arm}: admission "
                                     f"rejected")
        self.check()

    def step(self, n_chunks_max=None):
        k = 0
        while any(d.active for d in self.dec.values()) and (
                n_chunks_max is None or k < n_chunks_max):
            finished = {}
            for arm in (ARMS if self.n_chunks % 2 == 0 else ARMS[::-1]):
                dec = self.dec[arm]
                t = time.perf_counter()
                done = dec.step(sync_check=True)
                if self.on_card:
                    self.torch.cuda.synchronize()
                self.host_ms[arm].append(
                    (self.round, (time.perf_counter() - t) * 1e3
                     / dec.chunk_size))
                finished[arm] = [r.rid for r in done]
            if finished["graph"] != finished["eager"]:
                raise AssertionError(f"{self.mode}: finished {finished}")
            self.check()
            self.n_chunks += 1
            k += 1

    def check(self):
        torch = self.torch
        a, b = self.dec["graph"], self.dec["eager"]
        same = ([None if r is None else (r.rid, r.out_tokens)
                 for r in a.slots]
                == [None if r is None else (r.rid, r.out_tokens)
                    for r in b.slots]
                and a.cur_token.tolist() == b.cur_token.tolist()
                and torch.equal(a.cache["lengths"], b.cache["lengths"]))
        if a.paged:
            same = same and torch.equal(a.cache["page_table"],
                                        b.cache["page_table"]) \
                and a.pool.state_key() == b.pool.state_key() \
                and all(torch.equal(x[:, 1:], y[:, 1:]) for x, y in zip(
                    a.cache["slot0"].values(), b.cache["slot0"].values()))
        else:
            same = same and dense_cache_equal(
                torch, a.cache, b.cache,
                [i for i, r in enumerate(a.slots) if r is not None],
                a.cache["lengths"].tolist())
        if not same:
            raise AssertionError(f"{self.mode}: the graphed and the eager "
                                 f"engine parted after chunk "
                                 f"{self.n_chunks}")

    def host_summary(self, arm, rnd=None):
        """min / median / max host ms per decode step over the chunks of
        round ``rnd`` (every chunk if None)."""
        v = sorted(ms for r, ms in self.host_ms[arm]
                   if rnd is None or r == rnd)
        return v[0], float(np.median(v)), v[-1], len(v)


def full_model(torch, cfg, device="cuda"):
    """Random bf16 weights of ``cfg`` made on ``device`` from ``SEED``, and
    the prefill engine phase 5 shares between its decode engines."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"  weights: {cfg.param_count():,} params, bf16, made on "
        f"{device} from seed {SEED} in {time.perf_counter() - t:.1f} s")
    return params, E.PrefillEngine(cfg, params, max_seq=256, max_batch=4,
                                   device=device)


def serve_ab(torch, cfg, params, pre, mode, device="cuda"):
    """Phase 5 for the decode cache of ``mode``: the same requests through
    a graphed and an eager engine (:class:`Pair`). Round 1: three fresh
    prompts sharing a 16-token prefix decode alone. Round 2, on the page
    residencies: a full prefix hit, a partial hit (64 tokens) and a
    chunked prefill over a 16-token hit (64-token budget, one decode chunk
    between ticks); on the dense cache a fresh prompt and a chunked
    prefill. Checks every request's tokens, the full hit against its
    donor, zero-copy inserts (int4), 0 leaked pages, one host sync per
    chunk, released lengths and one graph captured. Returns the kernels'
    launch counts of the run (both arms). On the card it then profiles a
    chunk of each arm (launches, device time, norms, the int4 append) and
    times one replay of the graphed chunk between CUDA events; on the
    dense cache ``step_reference()`` must decode what ``step()`` decodes;
    on the int4 pages a 32-token prompt in one shot and in 16-token
    chunks is compared (:func:`chunk_anatomy`, then
    :func:`chunked_vs_one_shot`, held to rounding) and one prefill call
    of the 256-token bucket at batch 4 is profiled."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as E
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    pair = Pair(torch, cfg, params, mode, device)
    graph_dec = pair.dec["graph"]
    if mode != "dense":
        pool_bytes = sum(a.numel() * a.element_size()
                         for a in graph_dec.cache["slot0"].values())
        log(f"  {mode} decode pool: {graph_dec.pool.capacity} pages of 16 "
            f"tokens (+ trash), {pool_bytes / 1e9:.3f} GB an engine")
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED)
    system = rng.integers(1, V, 16)                  # page-aligned prefix

    def prompt(n, head=system):
        return np.concatenate([head, rng.integers(1, V, n - len(head))])

    clock = Clock()
    ops.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def fresh(reqs):
        for r in reqs:
            r.t_submit = clock()
        out = pre.run(reqs)
        for r in reqs:
            r.t_first = clock()
        pair.admit(lambda arm: [E.AdmissionItem(pair.reqs[arm][r.rid], f,
                                                wire=w)
                                for r, w, f in out])

    # round 1: three fresh prompts, one prefill call per length bucket
    r0 = pair.request(0, prompt(40), 16)
    r1 = pair.request(1, prompt(100), 24)
    r2 = pair.request(2, prompt(200), 32)
    fresh([r0, r1, r2])
    pair.step()
    # round 2: matched against the prefix index first, like the gateway
    pair.round = 2
    paged = graph_dec.paged
    if paged:
        r3 = pair.request(3, r0.tokens, 16)               # repeat: full hit
        pair.request(4, prompt(120, head=r1.tokens[:64]), 20)   # partial
        r5 = pair.request(5, prompt(150), 24)   # chunked, 16-token hit
        hits = {arm: {} for arm in ARMS}
        for arm in ARMS:
            dec = pair.dec[arm]
            for rid in (3, 4, 5):
                r = pair.reqs[arm][rid]
                r.t_submit = clock()
                m = dec.prefix_match(r.tokens)
                if m is None or not dec.prefix_pin(m.pages, ("pin", rid)):
                    raise AssertionError(f"{mode} {arm} request {rid}: no "
                                         f"prefix hit")
                hits[arm][rid] = m
                if not m.full:
                    r.start_pos = m.length
                    r.prefix_pages = list(m.pages)
                    r.prefix_wire = dec.extract_prefix(m.pages, m.length)
        got = {arm: {k: (m.full, m.length, m.pages)
                     for k, m in hits[arm].items()} for arm in ARMS}
        h = hits["graph"]
        if got["graph"] != got["eager"] or not (
                h[3].full and not h[4].full and h[4].length == 64
                and not h[5].full and h[5].length == 16):
            raise AssertionError(f"{mode}: unexpected prefix matches {got}")
        log(f"  {mode} prefix hits: r3 full ({h[3].length} tokens), r4 "
            f"partial ({h[4].length}), r5 partial ({h[5].length})")
        pair.admit(lambda arm: [E.AdmissionItem(
            pair.reqs[arm][3], hits[arm][3].next_token, E.ADMIT_PREFIX_HIT,
            pages=list(hits[arm][3].pages))])
        r3.t_first = clock()
        fresh([pair.reqs["graph"][4]])
    else:
        r3 = pair.request(3, rng.integers(1, V, 60), 20)
        r5 = pair.request(5, rng.integers(1, V, 150), 24)
        fresh([r3])
        r5.t_submit = clock()
    job = E.PartialPrefill(r5)
    ticks = 0
    while not job.done:                              # continuous batching
        pre.prefill_chunk([job], 64)
        ticks += 1
        pair.step(1)
    r5.t_first = clock()
    pair.admit(lambda arm: [E.AdmissionItem(pair.reqs[arm][5], job.first,
                                            E.ADMIT_CHUNKED,
                                            wire=job.wire())])
    if paged:
        for arm in ARMS:
            for rid in (3, 4, 5):
                pair.dec[arm].prefix_unpin(("pin", rid))
    pair.step()
    sync()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    reqs = pair.reqs["graph"]
    for arm in ARMS:
        dec = pair.dec[arm]
        for r in pair.reqs[arm].values():
            toks = np.asarray(r.out_tokens)
            if len(toks) != r.max_new_tokens or toks.min() < 0 or \
                    toks.max() >= V:
                raise AssertionError(f"{mode} {arm} r{r.rid}: bad tokens "
                                     f"{toks}")
        if dec.host_syncs * dec.chunk_size != dec.steps_run:
            raise AssertionError(f"{mode} {arm}: more than one host sync "
                                 f"per chunk")
        if int(dec.cache["lengths"].abs().sum()) != 0:
            raise AssertionError(f"{mode} {arm}: finished slots kept their "
                                 f"lengths")
        if paged:
            st = dec.page_stats()
            if st["leaked_pages"] or st["prefix_admits"] == 0:
                raise AssertionError(f"{mode} {arm}: leaked pages or no "
                                     f"full prefix hit: {st}")
            if mode == "int4" and st["zero_copy_inserts"] == 0:
                raise AssertionError(f"{mode} {arm}: no zero-copy insert")
            if pair.reqs[arm][3].out_tokens != pair.reqs[arm][0].out_tokens:
                raise AssertionError(f"{mode} {arm}: the full prefix hit "
                                     f"decoded other tokens than its donor")
    log(f"  {mode}: {len(reqs)}/{len(reqs)} requests done on each arm, "
        f"{sum(len(r.out_tokens) for r in reqs.values())} tokens each, "
        f"equal on both arms after every admission and chunk "
        f"({pair.n_chunks} chunks, each under sync_debug_mode=error; "
        f"chunked prefill ticks {ticks})")
    for r in reqs.values():
        log(f"  {mode} r{r.rid}: prompt {len(r.tokens)}, out "
            f"{len(r.out_tokens)}, TTFT {(r.t_first - r.t_submit) * 1e3:.1f}"
            f" ms")
    if paged:
        st = graph_dec.page_stats()
        log(f"  {mode} full prefix hit r3 repeats r0's tokens: True; "
            f"page_stats (graphed arm): " + json.dumps(
                {k: st[k] for k in ("zero_copy_inserts", "reencoded_inserts",
                                    "cow_copies", "prefix_admits",
                                    "leaked_pages", "in_use", "free",
                                    "peak_in_use", "prefix_entries")}))
    n_graphs = graph_dec.jit_cache_size
    log(f"  {mode}: graphs captured {n_graphs} (eager arm "
        f"{pair.dec['eager'].jit_cache_size}); host_syncs "
        f"{graph_dec.host_syncs} for steps_run {graph_dec.steps_run} an arm;"
        f" peak device memory {peak / 1e9:.2f} GB; launches "
        f"{json.dumps(launches)}")
    if on_card and n_graphs != 1:
        raise AssertionError(f"{mode}: {n_graphs} graphs for one chunk "
                             f"length")
    kernel = {"int4": "paged_decode_attention_int4", "dense":
              "decode_attention", "bf16": "paged_decode_attention_bf16"}[mode]
    if on_card and launches[kernel] == 0:
        raise AssertionError(f"{mode}: {kernel} never launched")
    for rnd, what in ((1, "round 1, decoding alone"), (None, "all chunks")):
        g, e = pair.host_summary("graph", rnd), pair.host_summary("eager",
                                                                  rnd)
        log(f"  {mode} host ms per decode step, {what} (chunks alternate "
            f"the arm that goes first): graph min/median/max "
            f"{g[0]:.2f}/{g[1]:.2f}/{g[2]:.2f}, eager "
            f"{e[0]:.2f}/{e[1]:.2f}/{e[2]:.2f} ({g[3]} chunks each)")
    if not on_card:
        return launches
    # where a chunk's time goes, after the counted run: one more request,
    # one chunk of each arm under the profiler (which slows the host)
    r6 = pair.request(6, prompt(64), 41)
    fresh([r6])
    pair.step(1)
    for arm in ARMS:
        dec = pair.dec[arm]
        before, steps = ops.launch_counts(), dec.steps_run
        profile_chunk(torch, lambda: (dec.step(sync_check=True), sync()),
                      dec.chunk_size, what=f"{mode} {arm} chunk")
        after = ops.launch_counts()
        n_steps = dec.steps_run - steps
        check_norm_launches(cfg, before, after, n_steps,
                            f"profiled {mode} {arm} chunk")
        if mode == "int4":
            n_app = after["kv_quant_append"] - before["kv_quant_append"]
            n_quant = after["kv_quant"] - before["kv_quant"]
            log(f"  profiled int4 {arm} chunk: kv_quant_append {n_app} "
                f"launches ({n_steps * cfg.num_layers} = steps x layers), "
                f"kv_quant {n_quant}")
            if n_app != n_steps * cfg.num_layers or n_quant:
                raise AssertionError("the int4 chunk's append is not one "
                                     "kv_quant_append launch per layer per "
                                     "step")
    pair.check()
    graph, per_replay = graph_dec.graphs.captured(
        graph_dec.chunk_size, graph_dec.eos_id, graph_dec.max_seq)
    log(f"  {mode} graphed chunk: kernel launches a replay makes, by "
        f"wrapper (counted at capture): {json.dumps(per_replay)}")
    # one replay between CUDA events, its state buffers as the last chunk
    # left them (r6 still decoding), then r6 is released on both arms
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    kv_len = int(graph_dec.cache["lengths"].max()) + 1
    a.record()
    graph.replay()
    b.record()
    sync()
    replay_ms = a.elapsed_time(b)
    log(f"  {mode} one replay of the graphed chunk (CUDA events): "
        f"{replay_ms:.3f} ms, {replay_ms / graph_dec.chunk_size:.3f} ms of "
        f"device time per step (1 slot decoding from kv_len {kv_len})")
    for arm in ARMS:
        dec = pair.dec[arm]
        dec.release(dec.slots.index(pair.reqs[arm][6]))
        if dec.paged and dec.page_stats()["leaked_pages"]:
            raise AssertionError(f"{mode} {arm}: leaked pages after the "
                                 f"profiled request")
    if mode == "dense":
        # the seed path on the same admissions decodes the same tokens, on
        # the graphed engine
        pair_reqs = [E.GenRequest(10 + i, rng.integers(1, V, n), 9)
                     for i, n in enumerate((30, 70))]
        out = pre.run(pair_reqs)
        streams = []
        for use_ref in (False, True):
            copies = [E.GenRequest(r.rid, r.tokens, r.max_new_tokens)
                      for r in pair_reqs]
            if graph_dec.admit(E.AdmissionBatch(
                    [E.AdmissionItem(c, f, wire=w)
                     for c, (_, w, f) in zip(copies, out)])):
                raise AssertionError("dense: admission rejected")
            while graph_dec.active:
                graph_dec.step_reference() if use_ref else graph_dec.step()
            sync()
            streams.append([c.out_tokens for c in copies])
        log(f"  dense step_reference() == step() on the graphed engine: "
            f"{streams[0] == streams[1]} ({sum(map(len, streams[0]))} "
            f"tokens)")
        if streams[0] != streams[1]:
            raise AssertionError(f"step_reference {streams[1]} != step "
                                 f"{streams[0]}")
    if mode == "int4":
        # a 32-token prompt in one shot and in 16-token chunks: which
        # stage of layer 0 parts the second chunk's rows, then every
        # layer's raw K/V held to rounding
        if on_card:
            chunk_anatomy(torch, cfg, params, device)
        chunked_vs_one_shot(torch, cfg, params, pre, ((32, 16),),
                            device=device)
        # one prefill call of the 256-token bucket at batch 4 (the flash
        # kernel's main-path shape); its wires are not admitted
        bucket = [E.GenRequest(7 + i, prompt(256), 1) for i in range(4)]
        pre.run(bucket)
        sync()
        before = ops.launch_counts()
        profile_chunk(torch, lambda: (pre.run(bucket), sync()), 1,
                      what="prefill call (4 x 256 tokens)", per="call")
        check_norm_launches(cfg, before, ops.launch_counts(), 1,
                            "profiled prefill call", prefill=True)
    return launches


def serve_gateway(torch, params, *, device="cuda", reduced=False):
    """Phase 6: the entry point ``launch.serve.run`` on ``params``, one
    run with a 32-token chunk budget under ``REPRO_SANITIZE=1`` (the
    runtime sanitizers; no decode graph may be captured after the
    warm-up), one live-rescheduled run and one on dense decode engines
    (``--no-paged``); returns the kernels' launch counts over the three."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    base = ["--device", device, "--rate", "2"] + (["--reduced"] if reduced
                                                 else [])
    ops.reset_launches()
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        sanitized = serve.run(base + ["--duration", "8", "--chunk-tokens",
                                      "32"], params=params)
    finally:
        del os.environ["REPRO_SANITIZE"]
    runs = {"a": sanitized,
            "b": serve.run(["--device", device, "--rate", "3"]
                           + (["--reduced"] if reduced else [])
                           + ["--duration", "10", "--live-reschedule",
                              "--workload", "coding"], params=params),
            "c": serve.run(base + ["--duration", "6", "--no-paged"],
                           params=params)}
    if device == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    for name, out in runs.items():
        s, gw = out["summary"], out["gateway"]
        leaked = sum(p["leaked_pages"] for p in out["page_stats"])
        log(f"  run {name}: {s['n_done']}/{s['n_submitted']} done, states "
            f"{s['states']}, TTFT p50/p99 {s['ttft_p50_s'] * 1e3:.1f}/"
            f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50/p99 "
            f"{s['tpot_p50_s'] * 1e3:.1f}/{s['tpot_p99_s'] * 1e3:.1f} ms, "
            f"wall {out['wall_s']:.1f} s, leaked pages {leaked}, epoch "
            f"{gw.epoch}, counters {json.dumps(out['stats']['counters'])}")
        if s["n_submitted"] == 0 or s["n_done"] != s["n_submitted"]:
            raise AssertionError(f"run {name}: not every request is DONE")
        if leaked:
            raise AssertionError(f"run {name}: {leaked} leaked pages")
        if not out["params_resident"]:
            raise AssertionError(f"run {name}: an engine holds other "
                                 f"parameters than the ones passed in")
    if runs["a"]["stats"]["counters"]["chunked_prefills"] == 0:
        raise AssertionError("run a: no prompt was prefilled in chunks")
    gw = runs["a"]["gateway"]
    san = runs["a"]["stats"].get("sanitizer")
    graphs = [h.client.jit_cache_size() for h in gw.dec]
    log(f"  run a under REPRO_SANITIZE=1: {json.dumps(san)}; pool "
        f"{type(gw.dec[0].engine.pool).__name__}; decode graphs per "
        f"replica {graphs}, the same as after the warm-up (the drain's "
        f"retrace check)")
    if gw.sanitizer is None or not san or san["transition_violations"] or \
            san["transitions_audited"] < runs["a"]["summary"]["n_done"]:
        raise AssertionError(f"run a: the sanitizer did not audit the run: "
                             f"{san}")
    if device == "cuda" and graphs != [1] * len(gw.dec):
        raise AssertionError(f"run a: decode graphs {graphs}, want one a "
                             f"replica")
    if any(h.engine.paged for h in runs["c"]["gateway"].dec):
        raise AssertionError("run c: a decode engine pages its cache")
    return launches


CHAOS_RUNS = {
    # name: (extra flags, sanitized); every run: --chaos --rate 3
    # --max-new 32 (32 tokens span four 8-step chunks, so both events find
    # a busy victim)
    "a": (["--requests", "12"], True),
    "b": (["--no-paged", "--requests", "8"], False),
}


def check_chaos_run(name, out, device):
    """Phase 7's assertions on one ``serve_e2e.run --chaos`` result."""
    s, gw, c = out["summary"], out["gateway"], out["stats"]["counters"]
    fired = out["fired"]
    kinds = [f["kind"] for f in fired]
    if kinds != ["crash", "preempt"]:
        raise AssertionError(f"run {name}: chaos fired {kinds}, want a "
                             f"crash then a preemption")
    idle = [f["kind"] for f in fired if f["held"] < 1]
    if idle:
        raise AssertionError(f"run {name}: {idle} hit a replica that held "
                             f"no request")
    status = sorted(h.status for h in gw.dec)
    if status != ["alive", "dead", "dead"] or \
            sorted(out["dead"]) != sorted({f["idx"] for f in fired}):
        raise AssertionError(f"run {name}: decode replicas {status}, dead "
                             f"{out['dead']}, events on "
                             f"{[f['idx'] for f in fired]}: want the two "
                             f"victims dead and one serving")
    if c["migrations"] < 1 or c["migrated_tokens"] <= 0:
        raise AssertionError(f"run {name}: the preemption migrated nothing "
                             f"({c})")
    short = [h.request.rid for h in out["handles"]
             if h.state != "DONE"
             or len(h.tokens) != h.request.max_new_tokens]
    if s["n_submitted"] == 0 or short:
        raise AssertionError(f"run {name}: requests {short} are not DONE "
                             f"with their full budget")
    leaked = sum(p["leaked_pages"] for p in out["page_stats"])
    if leaked:
        raise AssertionError(f"run {name}: {leaked} leaked pages")
    held = [h.idx for h in gw.dec if h.status == "dead"
            and (h.engine.active or (h.engine.paged and h.engine.page_stats()
                                     ["reserved_tokens"]))]
    if held:
        raise AssertionError(f"run {name}: dead replicas {held} still hold "
                             f"slots or pages")
    if not out["params_resident"]:
        raise AssertionError(f"run {name}: an engine holds other parameters "
                             f"than the ones passed in")
    graphs = [h.client.jit_cache_size() for h in gw.dec]
    if device == "cuda" and graphs != [1] * len(gw.dec):
        raise AssertionError(f"run {name}: decode graphs {graphs}, want one "
                             f"a replica (a migration recaptures nothing)")
    return graphs


def serve_chaos(torch, params, *, device="cuda", reduced=False):
    """Phase 7: the chaos entry point ``launch.serve_e2e.run --chaos`` on
    ``params`` with graphed decode engines, on int4 pages under
    ``REPRO_SANITIZE=1`` (a) and on the dense cache (b); after each run is
    dropped, the card's allocated memory must be back at its level before
    the phase. Returns the kernels' launch counts over both runs."""
    import gc
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_e2e
    cuda = device == "cuda"

    def settled():
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated()
        return 0

    base_mem = settled()
    ops.reset_launches()
    for name, (extra, sanitized) in CHAOS_RUNS.items():
        argv = ["--device", device, "--chaos", "--rate", "3", "--max-new",
                "32"] + extra + (["--reduced"] if reduced else [])
        if sanitized:
            os.environ["REPRO_SANITIZE"] = "1"
        try:
            out = serve_e2e.run(argv, params=params)
        finally:
            os.environ.pop("REPRO_SANITIZE", None)
        s, c = out["summary"], out["stats"]["counters"]
        log(f"  run {name} ({' '.join(extra)}): {s['n_done']}/"
            f"{s['n_submitted']} done, TTFT p50/p99 "
            f"{s['ttft_p50_s'] * 1e3:.1f}/{s['ttft_p99_s'] * 1e3:.1f} ms, "
            f"TPOT p50/p99 {s['tpot_p50_s'] * 1e3:.1f}/"
            f"{s['tpot_p99_s'] * 1e3:.1f} ms, E2E p99 "
            f"{s['e2e_p99_s'] * 1e3:.1f} ms, wall {out['wall_s']:.2f} s, "
            f"counters {json.dumps(c)}")
        log(f"  run {name} fired: " + json.dumps(
            [{k: (round(v, 3) if isinstance(v, float) else v)
              for k, v in f.items()} for f in out["fired"]]))
        graphs = check_chaos_run(name, out, device)
        san = out["stats"].get("sanitizer")
        if sanitized and (not san or san["transition_violations"]
                          or san["transitions_audited"] < s["n_done"]):
            raise AssertionError(f"run {name}: the sanitizer did not audit "
                                 f"the run: {san}")
        log(f"  run {name}: decode replicas "
            f"{[h.status for h in out['gateway'].dec]}, graphs {graphs}, "
            f"leaked pages 0" + (f", sanitizer {json.dumps(san)}"
                                 if sanitized else ""))
        del out
        mem = settled()
        log(f"  run {name} dropped: {mem} bytes allocated, {base_mem} "
            f"before the phase")
        if mem > base_mem:
            raise AssertionError(f"run {name}: {mem - base_mem} bytes still "
                                 f"allocated after the run was dropped")
    return ops.launch_counts()


# phase 8: arch -> (decode caches, (prompt tokens, new tokens) a request,
# max_seq); h2o-danube's engine asks for pages and falls back to its ring
PHASE8 = {
    "gemma-2b": (("int4", "dense", "bf16"), ((40, 16), (100, 24), (200, 32)),
                 256),
    "stablelm-3b": (("int4",), ((40, 16), (100, 24), (200, 32)), 256),
    "h2o-danube-3-4b": (("ring",), ((4200, 32), (100, 24)), 8192),
    "command-r-35b": (("int4",), ((40, 16), (100, 24), (200, 32)), 256),
}


def settled(torch):
    """The card's allocated bytes once garbage is collected and cuBLAS's
    per-stream workspaces (allocated by PyTorch's allocator for each
    stream a GEMM ran on, such as the engines' capture stream) are
    released."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def tree_bytes(tree):
    """(elements, bytes) of every tensor in a nest of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        parts = [tree_bytes(t) for t in tree]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    return tree.numel(), tree.numel() * tree.element_size()


# phase 9: arch -> (layers kept, decode caches, requests, max_seq, what
# else runs first: "moe" the prefix hits, chunked prefill and profiles
# of phase 5's int4 run plus chunked vs one-shot, "vlm" the model API
# with patches); qwen3-moe's 94 layers and llama4-maverick's 48 do not
# fit one card and are cut in depth, llama4 to one dense and one MoE layer
PHASE9 = {
    "llava-next-mistral-7b": (None, ("int4",),
                              ((40, 16), (100, 24), (200, 32)), 256, "vlm"),
    "qwen3-moe-235b-a22b": (8, (), (), 256, "moe"),
    "llama4-maverick-400b-a17b": (2, ("int4", "dense"),
                                  ((40, 16), (100, 24), (200, 32)), 256,
                                  None),
}


# phase 10: arch -> (layers kept, decode caches, requests, max_seq, what
# else runs: "chaos" serve_e2e --chaos; whisper prefills through the
# model API over frames, FramePrefill); jamba's 32 layers (~103 GB of
# bf16 weights) are cut to two 8-layer periods (~52 GB). "fallback": the
# engines ask for pages and fall back to the dense cache
PHASE10 = {
    "xlstm-125m": (None, ("fallback",), ((40, 16), (100, 24), (200, 32)), 256,
                   "chaos"),
    "jamba-v0.1-52b": (16, ("fallback",), ((40, 16), (100, 24), (200, 32)),
                       256, None),
    "whisper-base": (None, ("fallback",),
                     ((40, 16), (40, 24), (100, 24), (200, 32)), 256,
                     None),
}


def phase_cfg(arch, reduced=False):
    """The config phases 8-10 serve: the full one, cut in depth where
    ``PHASE9`` or ``PHASE10`` says so, or the reduced one."""
    from repro_torch.configs import get_config, get_reduced
    if reduced:
        return get_reduced(arch)
    cfg = get_config(arch)
    table = {**PHASE9, **PHASE10}
    keep = table[arch][0] if arch in table else None
    return cfg.replace(num_layers=keep) if keep else cfg


def step_read_bytes(cfg, params, max_slots=4, max_seq=256):
    """Bytes a decode step reads at least: every weight of the decode
    path once, all experts included (the capacity buffer runs every
    expert), but of an untied embedding table only the rows it gathers
    (left out), and the cache a step reads whatever the lengths: a
    recurrent stack's states of every slot (each steps), read and
    written; whisper's cross K/V of every slot (each attends over all
    its frames). Whisper's encoder does not run in a decode step."""
    from repro_torch.models import transformer
    if cfg.family == "audio":
        n = sum(tree_bytes(params[k])[1]
                for k in ("dec_layers", "final_norm", "unembed"))
        return n + (2 * cfg.num_layers * max_slots * cfg.encoder_seq
                    * cfg.kv_dim * 2)
    _, n = tree_bytes(params)
    if not cfg.tie_embeddings:
        n -= tree_bytes(params["embed"])[1]
    if transformer.recurrent(cfg):
        cache = transformer.init_cache(cfg, max_slots, max_seq,
                                       device="meta")
        n += 2 * sum(tree_bytes(v)[1] for k, slot in cache.items()
                     if k != "lengths" and "k" not in slot
                     for v in slot.values())
    return n


def vlm_model_api(torch, cfg, params, device="cuda"):
    """Phase 9's VLM through the model API, the only place the reference
    takes patches: ``prefill`` of 2 prompts, each ``cfg.num_patches``
    seeded patch embeddings in front of 40 text tokens (an exact-length
    prompt of patches + text), then three 8-step decode chunks on a dense
    cache, a graphed and an eager arm from the same prefill: tokens,
    lengths and every cache row below the lengths equal after each
    chunk; one replay of the graphed chunk timed between CUDA events."""
    from repro_torch.models import registry, transformer
    on_card = device == "cuda"
    api = registry.build(cfg)
    rng = np.random.default_rng(SEED)
    B, n_text, P, chunk = 2, 40, cfg.num_patches, 8
    S, max_seq = P + n_text, P + n_text + 3 * chunk + 8
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, n_text)),
                           device=device)
    pe = torch.as_tensor(rng.standard_normal(
        (B, P, cfg.d_model)).astype(np.float32), device=device)
    t = time.perf_counter()
    logits, pre = api.prefill(params, {"tokens": toks, "patch_embeds": pe})
    if on_card:
        torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t) * 1e3
    if tuple(logits.shape) != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            pre["lengths"].tolist() != [S] * B or \
            pre["slot0"]["k"].shape[2] != S:
        raise AssertionError(f"{cfg.name}: patch prefill gave logits "
                             f"{tuple(logits.shape)}, lengths "
                             f"{pre['lengths'].tolist()}")
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    caches, runners, states, out = {}, {}, {}, {arm: [] for arm in ARMS}
    for arm in ARMS:
        cache = transformer.init_cache(cfg, B, max_seq,
                                       transformer.cache_dtype(cfg),
                                       device=device)
        runners[arm] = (registry.GraphedDecodeChunk(
            api.decode, api.decode_chunk, params, cache, B)
            if arm == "graph" and on_card else api.decode_chunk)
        for key in ("k", "v"):           # in place: a graph reads it there
            cache["slot0"][key][:, :, :S].copy_(pre["slot0"][key])
        cache["lengths"].copy_(pre["lengths"])
        caches[arm] = cache
        states[arm] = {"cur": first.clone(),
                       "active": torch.ones(B, dtype=torch.bool,
                                            device=device),
                       "n_out": torch.ones(B, dtype=torch.int32,
                                           device=device),
                       "max_new": torch.full((B,), 3 * chunk + 1,
                                             dtype=torch.int32,
                                             device=device)}
    for _ in range(3):
        for arm in ARMS:
            got, _, _, st = runners[arm](params, caches[arm], states[arm],
                                         n_steps=chunk, eos_id=-1,
                                         max_seq=max_seq)
            out[arm].append(got.clone())
            states[arm] = {k: v.clone() for k, v in st.items()}
        a, b = caches["graph"], caches["eager"]
        n = int(a["lengths"].max())
        if not (torch.equal(out["graph"][-1], out["eager"][-1])
                and torch.equal(a["lengths"], b["lengths"])
                and all(torch.equal(a["slot0"][k][:, :, :n],
                                    b["slot0"][k][:, :, :n])
                        for k in ("k", "v"))):
            raise AssertionError(f"{cfg.name}: graphed and eager decode "
                                 f"after the patch prefill parted")
    toks_out = torch.cat(out["eager"]).T.tolist()
    log(f"  {cfg.name} model API: prefill of {B} x ({P} patches + "
        f"{n_text} tokens) = {S} exact positions in {pre_ms:.1f} ms, "
        f"logits finite, lengths {pre['lengths'].tolist()}; dense decode "
        f"3 chunks of {chunk}: graphed == eager after each "
        f"(tokens, lengths, cache rows); tokens {toks_out}")
    if on_card:
        graph, per_replay = runners["graph"].captured(chunk, -1, max_seq)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        log(f"  {cfg.name} model API: one replay of the graphed chunk "
            f"(CUDA events, {B} slots from kv_len {S + 3 * chunk}) "
            f"{ms:.3f} ms, {ms / chunk:.3f} ms a step; launches a replay "
            f"{json.dumps(per_replay)}")
        del graph


# chunked vs one-shot prefill: the largest relative L2 distance of a
# layer's raw K (or V) rows, ||chunked - one-shot|| / ||one-shot||, that
# counts as rounding. The second chunk's rows part only by rounding
# (:func:`chunk_anatomy` on the H100: one bf16 ulp out of the attention
# kernel, which walks the prefix tile and then the aligned one where the
# one-shot call walks one tile, and for LLaMA-30B out of its MLP at 16
# rows against 32), and the distance grows with depth: at most 2.0e-7
# (reduced f32 MoE configs), 0.0174 (qwen3-moe, 8 layers) and 0.0247
# (LLaMA-30B, layer 59) measured. The same rows one position off (a
# wrong offset or splice) are ~1.4 away, one wrong row in 32 ~0.25, and
# every check must reject the first as its control.
CHUNK_REL_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def rel_l2(torch, a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


def chunk_anatomy(torch, cfg, params, device="cuda"):
    """Layer 0 of a 32-token prompt, one shot against two chunks of 16
    tokens as the engine runs them (the second a suffix prefill over the
    first's keys): where rows 16-31 part, and which stage parts them.
    Each stage is fed the same input on both sides: the q/k/v
    projections of the chunk's rows against all 32; the attention kernel
    (the suffix call over the same keys against the causal call); the
    output projection. Then the layer's output rows with the chunked
    attention swapped in alone, the chunked FFN (residual, norm, MLP or
    MoE over the chunk's rows) alone, and both. Logs and returns the max
    |diff| of each."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, moe, transformer
    if cfg.parallel_block or cfg.sliding_window:
        raise ValueError(f"{cfg.name}: chunk_anatomy takes a sequential "
                         f"block with full attention")
    n, split = 32, 16
    rng = np.random.default_rng(SEED + 32)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n)),
                           device=device)
    p = params["layers"][0]
    x = transformer.embed(cfg, params, toks)
    h = layers.norm_apply(cfg, p["norm1"], x)
    pos = torch.arange(n, device=device)[None]
    plen = torch.full((1,), split, dtype=torch.int32, device=device)

    def qkv(lo, hi):
        ps = pos[:, lo:hi]
        return layers.attn_qkv(cfg, p["attn"], h[:, lo:hi], ps,
                               layers.model_rope(cfg, ps))

    def wo(o):
        return layers.dense(p["attn"]["wo"],
                            o.reshape(1, o.shape[1], cfg.q_dim))

    def ffn(x_rows, att):
        x2, h2 = layers.add_norm(cfg, x_rows, att, p["norm2"])
        m = moe.moe_apply(cfg, p["moe"], h2)[0] if "moe" in p else \
            layers.mlp_apply(cfg, p["mlp"], h2)
        return x2 + m

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    q, k, v = qkv(0, n)
    _, ka, va = qkv(0, split)
    qb, kb, vb = qkv(split, n)
    o_one = ops.flash_attention(q, k, v, causal=True)
    o_two = ops.flash_attention(qb, torch.cat([ka, kb], 1),
                                torch.cat([va, vb], 1), prefix_len=plen)
    att_one = wo(o_one)                       # all n rows, one shot
    att_two = wo(o_two)                       # the second chunk's rows
    want = ffn(x, att_one)[:, split:]
    got = {
        "q/k/v projections": max(diff(a[:, split:], b) for a, b in
                                 ((q, qb), (k, kb), (v, vb))),
        "attention kernel": diff(o_one[:, split:], ops.flash_attention(
            q[:, split:], k, v, prefix_len=plen)),
        "output projection": diff(att_one[:, split:],
                                  wo(o_one[:, split:])),
        "layer, chunked attention alone": diff(want, ffn(
            x, torch.cat([att_one[:, :split], att_two], 1))[:, split:]),
        "layer, chunked FFN alone": diff(want, ffn(
            x[:, split:], att_one[:, split:])),
        "layer, both chunked": diff(want, ffn(x[:, split:], att_two)),
    }
    log(f"  {cfg.name} ({cfg.dtype}) layer 0 of a {n}-token prompt, rows "
        f"{split}-{n - 1} one shot vs as a second {split}-token chunk, max "
        f"|diff| by stage: " + ", ".join(f"{k} {v:.3g}"
                                         for k, v in got.items()))
    return got


def chunked_vs_one_shot(torch, cfg, params, pre, pairs, device="cuda"):
    """Prompts of ``pairs`` ``(tokens, budget)`` prefilled in one shot and
    through chunks of ``budget`` tokens (the gateway's chunked prefill),
    each decoded 16 tokens on one int4 decode engine. Held: every layer's
    raw K and V rows within ``CHUNK_REL_TOL`` (relative L2) of the
    one-shot run's, up to the first layer whose FFN dropped a route in
    either run (``moe.count_drops``: the one-shot bucket's padding and a
    chunk's own tokens share expert capacity, so past a drop the two may
    part, as in the reference; a call of T <= 32 tokens has capacity T,
    so nothing drops there); the one-shot rows one position off must
    fail the same check in some layer (the control). In float32 the two
    must also decode the same tokens wherever no route dropped; in bf16
    the tokens are reported (a last-bit change can turn
    an argmax or, in a MoE layer, a token's last expert)."""
    from repro_torch.models import moe
    from repro_torch.serving import engine as E
    from repro_torch.serving import kv_transfer
    V, L = cfg.vocab_size, cfg.num_layers
    tol = CHUNK_REL_TOL[cfg.dtype]
    moe_layers = [i for i, kind in enumerate(cfg.layer_kinds())
                  if kind == "attn+moe"]
    dec = E.DecodeEngine(cfg, params, max_slots=2, max_seq=256,
                         page_size=16, chunk_size=8, prefix_sharing=False,
                         device=device)
    rng = np.random.default_rng(SEED + 150)
    for n, budget in pairs:
        prompt = rng.integers(1, V, n)
        streams, firsts, drops, raw = [], [], [], []
        for chunked in (False, True):
            req = E.GenRequest(n + chunked, prompt.copy(), 16)
            with moe.count_drops() as counted:
                if chunked:
                    job = E.PartialPrefill(req)
                    while not job.done:
                        pre.prefill_chunk([job], budget, compress=False)
                    wire, first, src = job.transport, job.first, \
                        E.ADMIT_CHUNKED
                else:
                    (_, wire, first), = pre.run([req], compress=False)
                    src = E.ADMIT_FRESH
            per_call = [int(x) for x in counted]
            drops.append([per_call[i:i + len(moe_layers)]
                          for i in range(0, len(per_call),
                                         max(len(moe_layers), 1))])
            raw.append({key: wire.slots["slot0"][key].payload["x"][:, :n]
                        for key in ("k", "v")})
            firsts.append(first)
            if dec.admit(E.AdmissionBatch([E.AdmissionItem(
                    req, first, src, wire=kv_transfer.compress_wire(
                        wire))])):
                raise AssertionError("chunked vs one-shot: admission "
                                     "rejected")
            while dec.active:
                dec.step()
            streams.append(req.out_tokens)
        dropped_at = [moe_layers[j] for arm in drops for call in arm
                      for j, c in enumerate(call) if c]
        held = min(dropped_at) + 1 if dropped_at else L
        rel = [max(rel_l2(torch, raw[0][key][i], raw[1][key][i])
                   for key in ("k", "v")) for i in range(L)]
        ctrl = [max(rel_l2(torch, raw[0][key][i],
                           torch.roll(raw[0][key][i], 1, dims=0))
                    for key in ("k", "v")) for i in range(held)]
        parted = [i for i in range(L) if rel[i] > 0]
        same = streams[0] == streams[1]
        log(f"  {cfg.name} ({cfg.dtype}) {n}-token prompt, {budget}-token "
            f"chunks: dropped routes per prefill call, one-shot "
            f"{[sum(c) for c in drops[0]]}, chunked "
            f"{[sum(c) for c in drops[1]]}; raw K/V "
            + (f"part from layer {parted[0]}" if parted else
               "equal in every layer")
            + f", relative L2 by layer {[float(f'{r:.3g}') for r in rel]}, "
            f"held in layers 0-{held - 1} to {tol:g} (max "
            f"{max(rel[:held]):.3g}; rows one position off: max "
            f"{max(ctrl):.3g}); first tokens equal: "
            f"{firsts[0] == firsts[1]}; decoded tokens equal: {same}")
        if max(ctrl) <= tol:
            raise AssertionError(f"{cfg.name}: the chunked-prefill check "
                                 f"passes rows one position off")
        if max(rel[:held]) > tol:
            raise AssertionError(f"{cfg.name}: chunked and one-shot raw "
                                 f"K/V part by {max(rel[:held]):.3g} "
                                 f"(relative L2) within layers 0-"
                                 f"{held - 1}, past {tol:g}")
        if cfg.dtype == "float32" and not dropped_at and not same:
            raise AssertionError(f"{cfg.name}: chunked and one-shot "
                                 f"prefill decode {streams[1]} and "
                                 f"{streams[0]} with no route dropped")
    if dec.page_stats()["leaked_pages"]:
        raise AssertionError("chunked vs one-shot: leaked pages")


def moe_chunked_f32(torch, arch, device="cuda"):
    """The reduced config of a MoE arch in float32 on the card, chunked
    against one-shot prefill (32 tokens in 16-token chunks: nothing can
    drop), held strictly (phase 4)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    small = get_reduced(arch).replace(dtype="float32")
    # drawn on the CPU and copied: a CUDA generator gives other numbers
    p32 = to_device(init_params(small, seed=SEED, device="cpu",
                                dtype=torch.float32), device)
    chunked_vs_one_shot(torch, small, p32,
                        E.PrefillEngine(small, p32, max_seq=256,
                                        device=device),
                        ((32, 16),), device=device)


def serve_arch(torch, arch, device="cuda", reduced=False):
    """Phase 8 for one of the other dense configs at full width, and
    phase 9 for the MoE and VLM configs (cut in depth as ``PHASE9``
    says): random bf16 weights from ``SEED``; ``PrefillEngine`` and, on
    each decode cache of ``PHASE8``/``PHASE9`` (int4 pages; gemma-2b also
    the dense cache and bf16 pages; llama4-maverick also the dense
    cache; h2o-danube its ring: ``DecodeEngine(paged=True)`` falls back to
    ``min(max_seq, window)`` rows), a graphed and an eager
    ``DecodeEngine`` in lockstep (:class:`Pair`: equal tokens, state and
    cache bytes after every admission and chunk; phase 10's recurrent and
    audio configs ask for pages and fall back to the dense cache, whisper
    prefilling through the model API over frames, :class:`FramePrefill`);
    one replay of the
    graphed chunk between CUDA events (device time a step) beside each
    arm's host time a step and the bound (:func:`step_read_bytes` at
    3.35 TB/s); on the dense caches ``step_reference()`` must decode what
    ``step()`` decodes. Phase 9 first runs the VLM's model API with
    patches (:func:`vlm_model_api`), or for qwen3-moe phase 5's int4 run
    (:func:`serve_ab`: a full prefix hit equal to its donor, a partial
    hit, a chunked prefill, profiles, a 32-token prompt in chunks
    against one shot) and a 150-token :func:`chunked_vs_one_shot`.
    Then the entry point ``launch.serve.run --arch`` with the config
    served (``cfg=``) on a short trace: every request DONE, 0 leaked
    pages, one graph a decode replica (whisper: the entry point must
    refuse it); for xlstm-125m then ``launch.serve_e2e.run --chaos``
    (:func:`xlstm_chaos`). Returns the kernels' launch counts. With
    ``reduced`` (on the CPU, a rehearsal) the reduced config
    runs instead, with the Pair's prompts capped at 60 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving import engine as E
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = phase_cfg(arch, reduced)
    extra = None
    if arch in PHASE9:
        _, modes, spec, max_seq, extra = PHASE9[arch]
    elif arch in PHASE10:
        _, modes, spec, max_seq, extra = PHASE10[arch]
    else:
        modes, spec, max_seq = PHASE8[arch]
    if reduced and spec:
        spec, max_seq = tuple((min(n, 60), m) for n, m in spec), 128
    full = get_config(arch)
    cut = "" if cfg.num_layers == full.num_layers or reduced else \
        f" (cut from {full.num_layers} to fit one card)"
    if cut and on_card:
        # the entry point refuses the full depth before making a weight
        try:
            serve.check_fits(full, device)
        except ValueError as e:
            log(f"  {full.name}: check_fits refuses the full config: {e}")
        else:
            raise AssertionError(f"{full.name}: check_fits let the full "
                                 f"config through")
    t = time.perf_counter()
    params = make_params(torch, cfg, device=device)
    sync()
    n_el, n_bytes = tree_bytes(params)
    moe_text = (f", {cfg.moe_num_experts} experts of d_ff {cfg.moe_d_ff}, "
                f"top-{cfg.moe_top_k}"
                f"{' + a shared expert' if cfg.moe_shared_expert else ''}"
                f", layer kinds {list(cfg.layer_kinds())}"
                if cfg.moe_num_experts else "")
    log(f"  {cfg.name}: {cfg.num_layers} layers{cut}, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads (kv {cfg.num_kv_heads}), "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{moe_text}; {n_el:,} parameters "
        f"({cfg.param_count():,} analytic, which leaves out the final "
        f"norm, LayerNorm biases, q/k norms and a projector), {n_bytes:,} "
        f"bytes, bf16 from seed {SEED} on the card in "
        f"{time.perf_counter() - t:.1f} s")
    read = step_read_bytes(cfg, params, max_seq=max_seq)
    log(f"  {cfg.name}: a decode step reads at least {read:,} bytes (every "
        f"weight of the decode path, all experts included, but the "
        f"gathered embedding rows; the recurrent states of 4 slots read "
        f"and written, whisper's cross K/V of 4 slots): bound "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    pre = prefill_engine(torch, cfg, params, max_seq=max_seq,
                         device=device)
    V = cfg.vocab_size
    # the main path's launches: each run counted from 0 and read after it;
    # serve_ab counts its own run (not its profiles and comparisons)
    launches = {}

    def add(got):
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n

    if extra == "vlm":
        ops.reset_launches()
        vlm_model_api(torch, cfg, params, device)
        add(ops.launch_counts())
    elif extra == "moe":
        add(serve_ab(torch, cfg, params, pre, "int4", device))
        # a 150-token prompt in 64-token chunks, held up to the first
        # layer that dropped a route (serve_ab holds a 32-token one)
        chunked_vs_one_shot(torch, cfg, params, pre, ((150, 64),),
                            device=device)
    ops.reset_launches()
    for mode in modes:
        pair = Pair(torch, cfg, params,
                    "int4" if mode in ("ring", "fallback") else mode,
                    device, max_seq=max_seq)
        graph_dec = pair.dec["graph"]
        if mode == "fallback":
            log(f"  {cfg.name} DecodeEngine(paged=True): paged_fallback "
                f"{graph_dec.paged_fallback!r}; cache "
                f"{sorted(k for k in graph_dec.cache if k != 'lengths')}")
            if graph_dec.paged or not graph_dec.paged_fallback:
                raise AssertionError(f"{cfg.name}: no dense fallback")
        if mode == "ring":
            rows = graph_dec.cache["slot0"]["k"].shape[2]
            log(f"  {cfg.name} DecodeEngine(paged=True): paged_fallback "
                f"{graph_dec.paged_fallback!r}; a {rows}-row ring of "
                f"max_seq {max_seq}")
            if graph_dec.paged or not graph_dec.paged_fallback or \
                    rows != min(max_seq, cfg.sliding_window):
                raise AssertionError(f"{cfg.name}: no ring fallback")
        rng = np.random.default_rng(SEED)
        reqs = [pair.request(i, rng.integers(1, V, n), m)
                for i, (n, m) in enumerate(spec)]
        t = time.perf_counter()
        out = pre.run(reqs)
        sync()
        pre_ms = (time.perf_counter() - t) * 1e3
        if pre.bucketed and (cfg.sliding_window or cfg.family == "audio"
                             or transformer.recurrent(cfg)):
            raise AssertionError(f"{cfg.name}: bucketed prefill")
        pair.admit(lambda arm: [E.AdmissionItem(pair.reqs[arm][r.rid], f,
                                                wire=w) for r, w, f in out])
        pair.step()
        for arm in ARMS:
            dec = pair.dec[arm]
            for r in pair.reqs[arm].values():
                toks = np.asarray(r.out_tokens)
                if len(toks) != r.max_new_tokens or toks.min() < 0 or \
                        toks.max() >= V:
                    raise AssertionError(f"{cfg.name} {mode} {arm} "
                                         f"r{r.rid}: bad tokens {toks}")
            if dec.host_syncs * dec.chunk_size != dec.steps_run or \
                    int(dec.cache["lengths"].abs().sum()) != 0:
                raise AssertionError(f"{cfg.name} {mode} {arm}: host syncs "
                                     f"or lengths left")
            if dec.paged and dec.page_stats()["leaked_pages"]:
                raise AssertionError(f"{cfg.name} {mode} {arm}: leaked "
                                     f"pages")
        if graph_dec.jit_cache_size != int(on_card):
            raise AssertionError(f"{cfg.name} {mode}: "
                                 f"{graph_dec.jit_cache_size} graphs")
        g, e = pair.host_summary("graph"), pair.host_summary("eager")
        log(f"  {cfg.name} {mode}: prompts {[n for n, _ in spec]} prefilled"
            f" in {pre_ms:.1f} ms ({'bucketed' if pre.bucketed else 'exact lengths'}); "
            f"{sum(len(r.out_tokens) for r in pair.reqs['graph'].values())}"
            f" tokens, equal on both arms after every admission and chunk "
            f"({pair.n_chunks} chunks); one graph; host ms a decode step "
            f"(TPOT of the chunk) graph min/median/max "
            f"{g[0]:.2f}/{g[1]:.2f}/{g[2]:.2f}, eager "
            f"{e[0]:.2f}/{e[1]:.2f}/{e[2]:.2f}")
        # one replay of the graphed chunk between CUDA events, one slot
        # decoding (the state buffers as its first chunk left them)
        r9 = pair.request(9, rng.integers(1, V, 64), 41)
        (_, w9, f9), = pre.run([r9])
        pair.admit(lambda arm: [E.AdmissionItem(pair.reqs[arm][9], f9,
                                                wire=w9)])
        pair.step(1)
        if on_card and mode == modes[0]:
            # where an eager step's time goes, then the graphed arm's
            # chunk to keep the two in lockstep
            eager = pair.dec["eager"]
            profile_chunk(torch, lambda: (eager.step(sync_check=True),
                                          sync()), eager.chunk_size,
                          what=f"{cfg.name} {mode} eager chunk")
            graph_dec.step(sync_check=True)
            pair.check()
        if on_card:
            graph, per_replay = graph_dec.graphs.captured(
                graph_dec.chunk_size, graph_dec.eos_id, graph_dec.max_seq)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            graph.replay()
            b.record()
            sync()
            replay_ms = a.elapsed_time(b)
            log(f"  {cfg.name} {mode}: one replay of the graphed chunk "
                f"(CUDA events) {replay_ms:.3f} ms, "
                f"{replay_ms / graph_dec.chunk_size:.3f} ms of device time "
                f"a step (1 slot); launches a replay "
                f"{json.dumps(per_replay)}")
            del graph
        for arm in ARMS:
            dec = pair.dec[arm]
            dec.release(dec.slots.index(pair.reqs[arm][9]))
        if not graph_dec.paged:
            ref_reqs = [E.GenRequest(10 + i, rng.integers(1, V, n), 9)
                        for i, (n, _) in enumerate(spec)]
            outs = pre.run(ref_reqs)
            streams = []
            for use_ref in (False, True):
                copies = [E.GenRequest(r.rid, r.tokens, r.max_new_tokens)
                          for r in ref_reqs]
                if graph_dec.admit(E.AdmissionBatch(
                        [E.AdmissionItem(c, f, wire=w)
                         for c, (_, w, f) in zip(copies, outs)])):
                    raise AssertionError(f"{cfg.name}: admission rejected")
                while graph_dec.active:
                    graph_dec.step_reference() if use_ref \
                        else graph_dec.step()
                sync()
                streams.append([c.out_tokens for c in copies])
            log(f"  {cfg.name} {mode}: step_reference() == step() on the "
                f"graphed engine: {streams[0] == streams[1]} "
                f"({sum(map(len, streams[0]))} tokens)")
            if streams[0] != streams[1]:
                raise AssertionError(f"{cfg.name}: step_reference "
                                     f"{streams[1]} != step {streams[0]}")
        del pair, graph_dec
        if on_card:
            torch.cuda.empty_cache()
    argv = ["--arch", arch, "--device", device, "--rate", "2",
            "--duration", "5"]
    if cfg.family == "audio":
        try:
            serve.run(argv, params=params, cfg=cfg)
        except ValueError as e:
            log(f"  {cfg.name} launch.serve refuses: {e}")
        else:
            raise AssertionError(f"{cfg.name}: launch.serve served audio")
        sync()
        add(ops.launch_counts())
        return launches
    out = serve.run(argv, params=params, cfg=cfg)
    s, gw = out["summary"], out["gateway"]
    leaked = sum(p["leaked_pages"] for p in out["page_stats"])
    graphs = [h.client.jit_cache_size() for h in gw.dec]
    log(f"  {cfg.name} launch.serve: {s['n_done']}/{s['n_submitted']} done,"
        f" TTFT p50/p99 {s['ttft_p50_s'] * 1e3:.1f}/"
        f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50/p99 "
        f"{s['tpot_p50_s'] * 1e3:.1f}/{s['tpot_p99_s'] * 1e3:.1f} ms, wall "
        f"{out['wall_s']:.1f} s, leaked pages {leaked}, decode graphs "
        f"{graphs}, paged {[h.engine.paged for h in gw.dec]}")
    if s["n_submitted"] == 0 or s["n_done"] != s["n_submitted"] or leaked \
            or graphs != [int(on_card)] * len(gw.dec) \
            or not out["params_resident"]:
        raise AssertionError(f"{cfg.name} launch.serve: not every request "
                             f"DONE, leaked pages, or graphs {graphs}")
    del out, gw
    if extra == "chaos":
        xlstm_chaos(torch, params, device, reduced)
    sync()
    add(ops.launch_counts())
    return launches


def xlstm_chaos(torch, params, device="cuda", reduced=False):
    """Phase 10's chaos run: ``launch.serve_e2e.run --arch xlstm-125m
    --chaos --requests 8 --rate 3 --max-new 32`` on ``params`` (three
    dense decode engines, graphed): both events fire, the preemption
    migrates at least one request, whose wire carries nothing but the
    recurrent states (xlstm has no attention), every request is DONE with
    its full budget, one graph a decode replica, and the engines on the
    weights they were given. The events may find one victim idle or hit
    the same replica (a decode of 32 tokens lasts a few chunks): the run
    prints which."""
    from repro_torch.launch import serve_e2e
    argv = ["--device", device, "--arch", "xlstm-125m", "--chaos",
            "--requests", "8", "--rate", "3", "--max-new", "32"]
    out = serve_e2e.run(argv + (["--reduced"] if reduced else []),
                        params=params)
    s, c, gw = out["summary"], out["stats"]["counters"], out["gateway"]
    fired = out["fired"]
    log(f"  xlstm-125m serve_e2e --chaos: {s['n_done']}/{s['n_submitted']} "
        f"done, TTFT p50/p99 {s['ttft_p50_s'] * 1e3:.1f}/"
        f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50/p99 "
        f"{s['tpot_p50_s'] * 1e3:.1f}/{s['tpot_p99_s'] * 1e3:.1f} ms, wall "
        f"{out['wall_s']:.2f} s, counters {json.dumps(c)}; fired "
        + json.dumps([{k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in f.items()} for f in fired])
        + f"; decode replicas {[h.status for h in gw.dec]}")
    graphs = [h.client.jit_cache_size() for h in gw.dec]
    short = [h.request.rid for h in out["handles"]
             if h.state != "DONE"
             or len(h.tokens) != h.request.max_new_tokens]
    if [f["kind"] for f in fired] != ["crash", "preempt"] or \
            c["migrations"] < 1 or c["migrated_tokens"] <= 0 or short or \
            s["n_submitted"] != 8 or not out["params_resident"] or \
            (device == "cuda" and graphs != [1] * len(gw.dec)):
        raise AssertionError(f"xlstm chaos: fired {fired}, counters {c}, "
                             f"not DONE {short}, graphs {graphs}")


# -- phase 11: training and checkpoints ---------------------------------------

TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-3
TRAIN_ARGV = ["--batch", "4", "--seq", "512"]
TRAIN_LAYERS, CKPT_LAYERS = 8, 1     # LLaMA-30B's 60 layers cut in depth


def reduced_train_case(arch):
    """(config, params on the CPU, 3 batches as numpy) of ``arch``
    reduced in f32: ``PackedLM`` batches of 2 x 48 tokens, seeded patch
    embeddings (VLM) or frames (whisper)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import make_params
    from repro_torch.training.data import DataConfig, PackedLM
    cfg = get_reduced(arch).replace(dtype="float32")
    data = PackedLM(DataConfig(cfg.vocab_size, 48, 2))
    rng = np.random.default_rng(SEED)
    batches = []
    for i in range(3):
        b = data.batch_at(i)
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.standard_normal(
                (2, 5, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            b["frame_embeds"] = rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batches.append(b)
    return cfg, make_params(cfg, "cpu"), batches


def grad_rel_err(got, want):
    """The worst per-tensor relative L2 of ``got`` against ``want``, each
    against the larger of its own norm and ``TRAIN_GRAD_FLOOR`` of the
    whole gradient's (a key bias's gradient is zero in exact arithmetic:
    both sides give rounding noise there)."""
    total = sum(float(w.double().square().sum()) for w in want) ** 0.5
    return max(float((g.double() - w.double()).norm())
               / max(float(w.double().norm()), TRAIN_GRAD_FLOOR * total)
               for g, w in zip(got, want))


def train_reduced(torch, arch, device="cuda"):
    """Phase 11(a): 3 AdamW steps of ``arch`` reduced in f32 from the same
    weights and batches on ``device`` and on the CPU: losses within
    ``TRAIN_LOSS_RTOL`` relative, step 1's gradients within
    ``TRAIN_GRAD_RTOL`` relative L2 per tensor."""
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    cfg, cpu_params, batches = reduced_train_case(arch)
    api = build(cfg)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    runs = []
    for dev in (device, "cpu"):
        # a copy: the update writes the params in place
        params = opt.tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        state, losses, grads1 = opt.adamw_init(params), [], None
        for b in batches:
            tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            loss, grads = opt.value_and_grad(api.loss, params, tb)
            if grads1 is None:
                grads1 = [g.cpu() for g in opt.tree_leaves(grads)]
            params, state, _ = opt.adamw_update(ocfg, grads, state, params)
            losses.append(float(loss))
        runs.append((losses, grads1))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    grad_err = grad_rel_err(g_card, g_cpu)
    log(f"  {arch}: losses card {[round(x, 6) for x in l_card]} cpu "
        f"{[round(x, 6) for x in l_cpu]} (worst {loss_err:.2e} relative), "
        f"step-1 grads worst {grad_err:.2e} relative L2 over "
        f"{len(g_cpu)} tensors")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL
            and all(np.isfinite(l_card))):
        raise AssertionError(f"{arch}: card vs CPU training: losses "
                             f"{l_card} vs {l_cpu}, grads {grad_err:.3g}")


def profile_device_ms(torch, run, what):
    """(result, device ms between CUDA events around ``run()``, device ms
    summed over the profiler's kernel records, records) of ``run()``
    under the profiler (CUDA activity only); logs ``what``'s 6 largest
    kernels. The events bracket the work on the stream (autograd's
    backward runs on its device thread but on the same stream); the
    records can come back short when the tracer drops some. A CPU
    rehearsal runs it unprofiled and reads 0."""
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return run(), 0.0, 0.0, 0
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        out = run()
        b.record()
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) / 1e3,
                    e.count, e.key) for e in prof.key_averages()),
                  reverse=True)
    rows = [r for r in rows if r[0] > 0]
    log(f"    {what}: " + "; ".join(f"{ms:.1f} ms x{n} {name[:48]}"
                                      for ms, n, name in rows[:6]))
    return (out, a.elapsed_time(b), sum(r[0] for r in rows),
            sum(r[1] for r in rows))


def train_flops(cfg, tokens):
    """8 N T (forward, backward and the layers' recomputation; N the
    layers' parameters) plus the unembedding's 6 d V T."""
    from repro_torch.launch.train import make_params
    from repro_torch.training import optimizer as opt
    meta = make_params(cfg, "meta")
    n_layers = sum(t.numel() for t in opt.tree_leaves(meta["layers"]))
    return 8 * n_layers * tokens + 6 * cfg.d_model * cfg.vocab_size * tokens


def train_full(torch, smi, device="cuda", reduced=False):
    """Phase 11(b): LLaMA-30B at full width, ``TRAIN_LAYERS`` of its 60
    layers, 6 steps through ``launch.train.run`` at batch 4 x seq 512;
    then one more step split into forward, backward and the optimizer,
    each under the profiler. Returns the numbers it printed. (The CPU
    rehearsal: ``device="cpu", reduced=True``, the reduced config; its
    profiles and memory read 0.)"""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, PackedLM
    cfg = get_reduced("llama-30b") if reduced else \
        get_config("llama-30b").replace(num_layers=TRAIN_LAYERS)
    state_b, temps_b = train.train_state_bytes(cfg)
    n_params = state_b // train.BYTES_PER_PARAM
    on_card = device == "cuda"
    base = torch.cuda.memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = train.run(["--steps", "6", "--device", device] + TRAIN_ARGV,
                    cfg=cfg)
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    params, state = out["params"], out["opt_state"]
    losses, gnorms = out["losses"], out["grad_norms"]
    if len(losses) != 6 or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"full-width training: losses {losses}, grad "
                             f"norms {gnorms}")
    step_ms = float(np.median(out["step_s"][1:])) * 1e3
    tokens = 4 * 512
    flops = train_flops(cfg, tokens)
    bound_ms = flops / BF16_FLOP_PER_S * 1e3
    opt_bound_ms = 22 * n_params / HBM_BYTES_PER_S * 1e3
    log(smi)
    log(f"  {cfg.name} cut to {cfg.num_layers} of 60 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params:,} parameters, "
        f"batch 4 x seq 512, 6 steps in {run_s:.1f} s (weights included)")
    log(f"  losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}")
    log(f"  host ms a step (steps 2-6): {[round(s * 1e3, 1) for s in out['step_s'][1:]]}, "
        f"median {step_ms:.1f} ms, {tokens / step_ms * 1e3:,.0f} tokens/s; "
        f"8NT + 6dVT = {flops:.3e} FLOPs, {bound_ms:.1f} ms at "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16: "
        f"{100 * bound_ms / step_ms:.1f}% of peak")
    log(f"  peak memory {peak:,} bytes over the run; reckoning: "
        f"{state_b:,} (12 B x {n_params:,} params: bf16 params and grads, "
        f"f32 m and v) + {temps_b:,} (f32 temporaries of the largest "
        f"tensor) = {state_b + temps_b:,}")

    # one more step, its three parts profiled apart
    api = build(cfg.replace(vocab_chunk=512))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=6)
    b = PackedLM(DataConfig(cfg.vocab_size, 512, 4)).batch_at(6)
    tb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    leaves = opt.tree_leaves(params)

    def forward():
        with torch.enable_grad():
            return api.loss(params, tb)

    loss, fwd_ms, fwd_k, fwd_n = profile_device_ms(torch, forward,
                                                   "forward")
    grads, bwd_ms, bwd_k, bwd_n = profile_device_ms(
        torch, lambda: torch.autograd.grad(loss, leaves), "backward")
    del loss
    grads = opt.tree_unflatten(params, grads)
    upd, opt_ms, opt_k, opt_n = profile_device_ms(
        torch, lambda: opt.adamw_update(ocfg, grads, state, params),
        "optimizer")
    del grads, upd
    log(f"  one step by part (device ms between CUDA events; ms summed "
        f"over the profiler's kernel records, records): forward "
        f"{fwd_ms:.1f} ({fwd_k:.1f}, x{fwd_n}), backward {bwd_ms:.1f} "
        f"({bwd_k:.1f}, x{bwd_n}; the layers' and the loss chunk's "
        f"recomputation included), optimizer {opt_ms:.1f} ({opt_k:.1f}, "
        f"x{opt_n}) against its byte bound {opt_bound_ms:.1f} ms (22 B a "
        f"parameter at 3.35 TB/s)")
    del out, params, state, leaves, tb
    return {"step_ms": step_ms, "bound_ms": bound_ms, "flops": flops,
            "peak": peak, "reckoning": state_b + temps_b,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "opt_ms": opt_ms,
            "opt_bound_ms": opt_bound_ms}


def train_restart(torch, smi, device="cuda", reduced=False):
    """Phase 11(c): LLaMA-30B at full width cut to ``CKPT_LAYERS`` layer,
    6 steps through ``launch.train.run`` with async checkpoints every 2
    steps into a temporary directory (the launcher raises first if the
    disk cannot hold them), then,
    the step-4 checkpoint removed (as if the run died before writing it),
    ``--resume``: steps 3-5 again from step 2's checkpoint, losses and
    every byte of the final state equal. The directory is removed. (The
    CPU rehearsal: ``device="cpu", reduced=True``.)"""
    import shutil
    import tempfile
    from repro_torch.checkpoint.sharded import tree_bytes as ckpt_bytes
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch import train
    from repro_torch.training import optimizer as opt
    cfg = get_reduced("llama-30b") if reduced else \
        get_config("llama-30b").replace(num_layers=CKPT_LAYERS)
    meta = train.make_params(cfg, "meta")
    need = ckpt_bytes(train.train_tree(meta, opt.adamw_init(meta), cfg,
                                       "meta"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        log(f"  {cfg.name} at {cfg.num_layers} layer(s): a checkpoint holds "
            f"{need:,} bytes; {shutil.disk_usage(tmp).free:,} bytes free "
            f"under {tmp}")
        argv = ["--steps", "6", "--ckpt-dir", tmp, "--ckpt-every", "2",
                "--device", device] + TRAIN_ARGV
        a = train.run(argv, cfg=cfg)
        shutil.rmtree(os.path.join(tmp, "step_00000004"))
        b = train.run(argv + ["--resume"], cfg=cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_loss = b["losses"] == a["losses"][3:]
    pairs = list(zip(opt.tree_leaves((a["params"], a["opt_state"])),
                     opt.tree_leaves((b["params"], b["opt_state"]))))
    same_state = len(pairs) == len(opt.tree_leaves(a["params"])) * 3 + 1 \
        and all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
                for x, y in pairs)
    (s2, wbytes, wsec), (s4, _, wsec4) = a["writes"]
    rbytes, rsec = b["read"]
    log(f"  run a losses {[round(x, 4) for x in a['losses']]}; resumed at "
        f"step {b['start']}: {[round(x, 4) for x in b['losses']]}")
    log(f"  bit-identical after the restart: losses {same_loss}, state "
        f"{same_state} ({len(pairs)} tensors)")
    log(f"  checkpoint write (step {s2}): {wbytes:,} bytes in {wsec:.2f} s, "
        f"{wbytes / wsec / 1e9:.2f} GB/s (step {s4}: {wsec4:.2f} s); read "
        f"{rbytes:,} bytes in {rsec:.2f} s, {rbytes / rsec / 1e9:.2f} GB/s")
    log(smi)
    if not (same_loss and same_state and b["start"] == 3
            and rbytes == wbytes == need):
        raise AssertionError("the restarted run did not continue bit for "
                             "bit")
    del a, b, pairs
    return {"write_gbs": wbytes / wsec / 1e9, "read_gbs": rbytes / rsec / 1e9}


# -- phase 12: tensor-, expert- and pipeline-parallel replicas -----------------

# (arch, model axis) of a rank's shapes checked in phase 3: the paged
# stacks' every kernel (gemma-2b's 4 query heads over its one replicated
# KV head at hd 256, command-r's 32 over 4), then phase 12 (e)'s other
# new rank shapes (LOCAL_OTHER)
LOCAL_SHAPES = (("llama-30b", 2), ("qwen3-moe-235b-a22b", 2),
                ("gemma-2b", 2), ("command-r-35b", 2))
LOCAL_OTHER = ("h2o-danube-3-4b", "whisper-base", "jamba-v0.1-52b")
P12_RANKS = 2
# layers kept: (b) LLaMA-30B at TP 2, (c) qwen3-moe at EP 2 + TP 2, (d)
# LLaMA-30B in 2 pipeline stages (reduced: every layer of the reduced
# config)
P12_LAYERS = {"tp": 16, "moe": 8, "pipe": 8}
P12_DECODE_STEPS = 8
# the kernels phase 12's runs reach: all nine
PHASE12_KERNELS = ("kv_quant", "kv_dequant", "kv_quant_append",
                   "paged_decode_attention_int4",
                   "paged_decode_attention_bf16", "flash_attention",
                   "decode_attention", "rmsnorm", "add_rmsnorm")
# a prefill's logits, sharded against unsharded (relative L2); every
# layer's raw K/V per head is held to CHUNK_REL_TOL
P12_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.05}
# a greedy token must match where the unsharded run's top-2 margin is
# wider than this (logit units)
P12_MARGIN = 0.1


def check_local_shapes(torch, ref, fa, da, pa, kq, rn):
    """A tensor-parallel rank's shapes (phase 12's): LLaMA-30B at 26 of
    its 52 heads, qwen3-moe at 32 query heads over 2 KV heads, gemma-2b
    at 4 over its one replicated KV head (hd 256) and command-r at 32
    over 4 (TP 2), in every kernel a rank's main path runs: flash
    attention at the prefill bucket (4 x 256), the int4 and bf16 paged
    bodies and the
    dense decode step (4 slots, kv_len as phase 5's), the int4 append at
    the rank's KV heads (its group: 128, one head), qwen3's q/k norms
    over the rank's q rows; each checked against its plain version and
    timed beside it, its bound and SDPA (flash, dense decode) or
    ``F.rms_norm``; then :func:`check_local_other`. Returns
    ``[(kernel, arch, shape, result)]``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import rank_cfg
    bf16 = torch.bfloat16
    rows = []
    for arch, n in LOCAL_SHAPES:
        cfg = rank_cfg(get_config(arch), n)
        L, H, Hkv, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        g = H // Hkv
        rolled = ("rows rolled",) if g > 1 else ()
        tag = f"{arch} TP {n} rank"
        log(f"  {tag}: {H} heads (kv {Hkv}), hd {hd}, {L} layers")
        rows.append(("flash_attention", tag, "bucket 4 x 256",
                     check_flash(torch, ref, fa, 4, 256, 0, H, Hkv, hd,
                                 bf16, controls=("last 8 of hd",),
                                 timed=True)))
        step = f"decode 4 slots, kv_len {DECODE_LENS}"
        rows.append(("decode_attention", tag, step + ", 256-row cache",
                     check_decode(torch, ref, da, L, 4, Hkv, g, hd, 256,
                                  DECODE_LENS, bf16, bf16,
                                  controls=("kv_len - 64", "last 8 of hd")
                                  + rolled, timed=True)))
        rows.append(("paged_decode_attention_int4", tag, step,
                     check_attention(torch, ref, pa, L, 4, Hkv, g, hd, 16,
                                     16, DECODE_LENS, bf16,
                                     controls=("kv_len - 64",) + rolled,
                                     timed=True)))
        rows.append(("paged_decode_attention_bf16", tag, step,
                     check_paged_bf16(torch, ref, pa, L, 4, Hkv, g, hd, 16,
                                      16, DECODE_LENS, bf16,
                                      controls=("kv_len - 64",) + rolled,
                                      timed=True)))
        rows.append(("kv_quant_append", tag, f"4 slots x {Hkv} heads",
                     check_append(torch, ref, kq, 4, Hkv, hd, 16, 16,
                                  DECODE_LENS, bf16, timed=True)))
        if cfg.qk_norm:
            for m, what in ((4 * 256 * H, "q rows of the bucket"),
                            (4 * H, "q rows of a 4-slot step")):
                rows.append(("rmsnorm", tag, f"{m} x {hd} ({what})",
                             check_rmsnorm(torch, ref, rn, m, hd, bf16,
                                           control=True, timed=True)))
    log("  a rank's shapes: kernel, arch, shape: ms (plain, library, "
        "bound)")
    for name, tag, shape, r in rows:
        log(f"    {name} {tag} ({shape}): {r['ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, library "
            f"{r.get('library_ms') or float('nan'):.5f}, bound "
            f"{r['bound'][0]:.5f} by {r['bound'][1]}; "
            f"{r['ms'] / r['bound'][0]:.1f}x the bound)")
    return rows + check_local_other(torch, ref, fa, da)


def check_local_other(torch, ref, fa, da):
    """Phase 12 (e)'s other new rank shapes at TP 2: h2o-danube's 16
    query heads over 4 at hd 120 (flash over a 4200-token prompt in its
    4096-token window, the dense step over its 4096-row ring), whisper's
    4 heads of 64 (the encoder over 1500 frames and the decoder's
    cross-attention over them, bidirectional; the cross decode step) and
    jamba's attention, 16 over 4 at hd 128 (a 4 x 256 bucket, the dense
    step); each checked against its plain version and timed beside it,
    its bound and SDPA, with the controls of :func:`check_arch_shapes`
    and :func:`check_recurrent_shapes`. Returns ``[(kernel, arch, shape,
    result)]``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import rank_cfg
    bf16 = torch.bfloat16
    h, w, j = (rank_cfg(get_config(a), 2) for a in LOCAL_OTHER)
    W, E = h.sliding_window, w.encoder_seq
    bidir = ("causal", "last 8 of hd")
    dec = ("kv_len - 64", "last 8 of hd", "rows rolled")
    log(f"  TP 2 ranks: h2o-danube {h.num_heads} heads (kv "
        f"{h.num_kv_heads}), whisper {w.num_heads}, jamba {j.num_heads} "
        f"(kv {j.num_kv_heads})")
    tag = "TP 2 rank"
    rows = [
        ("flash_attention", f"h2o-danube-3-4b {tag}",
         f"prefill 1 x 4200, window {W}",
         check_flash(torch, ref, fa, 1, 4200, 0, h.num_heads, h.num_kv_heads,
                     h.head_dim, bf16, window=W,
                     controls=("window 0", "last 8 of hd"), timed=True)),
        ("decode_attention", f"h2o-danube-3-4b {tag}",
         f"decode 4 slots, {W}-row ring",
         check_decode(torch, ref, da, h.num_layers, 4, h.num_kv_heads,
                      h.num_heads // h.num_kv_heads, h.head_dim, W,
                      [W, W, 300, 17], bf16, bf16, controls=dec,
                      timed=True)),
        ("flash_attention", f"whisper-base {tag}",
         f"encoder 4 x {E} frames, bidirectional",
         check_flash(torch, ref, fa, 4, E, 0, w.num_heads, w.num_heads,
                     w.head_dim, bf16, causal=False, controls=bidir,
                     timed=True)),
        ("flash_attention", f"whisper-base {tag}",
         f"cross-attention 4 x 256 tokens over {E} frames",
         check_flash(torch, ref, fa, 4, 256, 0, w.num_heads, w.num_heads,
                     w.head_dim, bf16, causal=False, Sk=E, controls=bidir,
                     timed=True)),
        ("decode_attention", f"whisper-base {tag}",
         f"cross-attention, 4 slots over {E} frames",
         check_decode(torch, ref, da, w.num_layers, 4, w.num_heads, 1,
                      w.head_dim, E, [E] * 4, bf16, bf16,
                      controls=("kv_len - 64", "last 8 of hd"),
                      timed=True)),
        ("flash_attention", f"jamba-v0.1-52b {tag}", "bucket 4 x 256",
         check_flash(torch, ref, fa, 4, 256, 0, j.num_heads, j.num_kv_heads,
                     j.head_dim, bf16, controls=("last 8 of hd",),
                     timed=True)),
        ("decode_attention", f"jamba-v0.1-52b {tag}",
         f"decode 4 slots, 256-row cache, kv_len {DECODE_LENS}, 1 layer",
         check_decode(torch, ref, da, 1, 4, j.num_kv_heads,
                      j.num_heads // j.num_kv_heads, j.head_dim, 256,
                      DECODE_LENS, bf16, bf16, controls=dec, timed=True))]
    for name, arch, shape, r in rows:
        log(f"    {name} {arch} ({shape}): {r['ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, library "
            f"{r.get('library_ms') or float('nan'):.5f}, bound "
            f"{r['bound'][0]:.5f} by {r['bound'][1]}; "
            f"{r['ms'] / r['bound'][0]:.1f}x the bound)")
    return rows


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def same_engines(torch, a, b, what):
    """Two decode engines hold the same slots, tokens, lengths, page table
    and pool state and every page byte but the trash page's."""
    if [None if r is None else (r.rid, r.out_tokens) for r in a.slots] != \
            [None if r is None else (r.rid, r.out_tokens) for r in b.slots]:
        raise AssertionError(f"{what}: tokens differ")
    if not torch.equal(a.cache["lengths"], b.cache["lengths"]) or \
            not torch.equal(a.cache["page_table"], b.cache["page_table"]) \
            or a.pool.state_key() != b.pool.state_key():
        raise AssertionError(f"{what}: lengths, page table or pool differ")
    for key in a.cache["slot0"]:
        if not torch.equal(a.cache["slot0"][key][:, 1:],
                           b.cache["slot0"][key][:, 1:]):
            raise AssertionError(f"{what}: page bytes of {key} differ")


def same_wires(torch, xs, ys, what):
    for (_, w0, f0), (_, w1, f1) in zip(xs, ys):
        same = f0 == f1 and all(
            torch.equal(p, q) for s in w0.slots for k in w0.slots[s]
            for p, q in zip(w0.slots[s][k].payload.values(),
                            w1.slots[s][k].payload.values()))
        if not same:
            raise AssertionError(f"{what}: prefill wires differ")


def same_state(torch, a, b, what):
    """Two decode engines hold the same slots and tokens and the same
    cache bytes: :func:`same_engines` for pages, the lengths and
    :func:`dense_cache_equal` over the occupied slots for a dense
    cache."""
    if a.paged:
        return same_engines(torch, a, b, what)
    if [None if r is None else (r.rid, r.out_tokens) for r in a.slots] != \
            [None if r is None else (r.rid, r.out_tokens) for r in b.slots]:
        raise AssertionError(f"{what}: tokens differ")
    if not torch.equal(a.cache["lengths"], b.cache["lengths"]):
        raise AssertionError(f"{what}: lengths differ")
    slots = [i for i, r in enumerate(a.slots) if r is not None]
    lengths = a.cache["lengths"].tolist()
    if not dense_cache_equal(torch, a.cache, b.cache, slots, lengths):
        raise AssertionError(f"{what}: cache bytes differ")


def mesh_world1(torch, cfg, params, device="cuda", name="(a)",
                kv_seq=False):
    """Phase 12 (a), and (e)'s world-1 runs: ``Runtime(mesh)`` over a
    1-D ``model`` mesh of the one rank of a process group over NCCL (gloo
    on the CPU), through a prefill engine and a graphed and an eager
    ``DecodeEngine`` on the arch's usual cache (int4 pages where it
    pages, else its dense cache), in lockstep with the unmeshed engines
    (graphed) on the same weights: wires, tokens, lengths, page table and
    cache bytes equal after every chunk; the graphed chunk one graph
    holding its collectives, as many as the eager chunk made; the
    collectives a step and one replay's time (CUDA events) beside the
    unmeshed replay's, turn by turn. ``kv_seq``: the meshed engines run
    ``Runtime(kv_seq=True)``, every engine on the dense cache (the paged
    ones refuse the layout); at axis size 1 ``sharding.local_cfg`` drops
    the setting, so this runs the head-split step and no kv_seq code: it
    shows that asking for the layout changes nothing there
    (:func:`p12g_shares` graphs the kv_seq step's own code). Returns
    (the kernel launches of the run, the replay times)."""
    import torch.distributed as dist
    from repro_torch.distributed import comm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving import engine as E
    on_card = device == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        rt = Runtime(make_mesh((1,), ("model",), device=device),
                     moe_shard_map=bool(cfg.moe_num_experts), kv_seq=kv_seq)
        before = ops.launch_counts()
        comm.reset_counts()
        pres = {m: prefill_engine(torch, cfg, params, max_seq=256,
                                  device=device, rt=rt if m else None)
                for m in (False, True)}
        arms = {"unmeshed graphed": (False, True), "graphed": (True, True),
                "eager": (True, False)}
        decs = {a: E.DecodeEngine(cfg, params, max_slots=4, max_seq=256,
                                  device=device, rt=rt if m else None,
                                  cuda_graph=g and on_card,
                                  paged=not kv_seq)
                for a, (m, g) in arms.items()}
        rng = np.random.default_rng(SEED + 12)
        prompts = [rng.integers(1, cfg.vocab_size, n)
                   for n in (40, 200, 17, 100)]
        wires = {m: pre.run([E.GenRequest(i, p, 24)
                             for i, p in enumerate(prompts)])
                 for m, pre in pres.items()}
        same_wires(torch, wires[False], wires[True], f"{name} world 1")
        reqs = {}
        for a, dec in decs.items():
            reqs[a] = [E.GenRequest(i, p, 24) for i, p in enumerate(prompts)]
            if dec.admit(E.AdmissionBatch(
                    [E.AdmissionItem(r, f, wire=w) for r, (_, w, f) in
                     zip(reqs[a], wires[arms[a][0]])])):
                raise AssertionError(f"{name}: admission rejected")
        chunks, eager = 0, None
        while decs["graphed"].active:
            for a, dec in decs.items():
                c0 = comm.counts()
                dec.step()
                if a == "eager" and eager is None:
                    # the chunk's, less the gather of the ranks' checksum
                    # that step() makes after it (engine._agree)
                    c0["all_gather"] = c0.get("all_gather", 0) + 1
                    eager = {k: v - c0.get(k, 0)
                             for k, v in comm.counts().items()
                             if v != c0.get(k, 0)}
            chunks += 1
            for a in ("graphed", "eager"):
                same_state(torch, decs["unmeshed graphed"], decs[a],
                           f"{name} world 1, chunk {chunks}, {a}")
        if any(d.active for d in decs.values()) or any(
                len(r.out_tokens) != r.max_new_tokens
                for rs in reqs.values() for r in rs):
            raise AssertionError(f"{name}: requests not DONE")
        for a, dec in decs.items():
            if dec.paged and dec.page_stats()["leaked_pages"]:
                raise AssertionError(f"{name} {a}: leaked pages")
        launches = {k: n - before[k] for k, n in ops.launch_counts().items()}
        log(f"  {name} world 1, {cfg.name} ({cfg.num_layers} layers, "
            f"{'int4 pages' if decs['graphed'].paged else 'dense cache'}): "
            f"{len(prompts)} requests x 24 tokens, {chunks} chunks; wires, "
            f"tokens, lengths and cache bytes of the meshed graphed and "
            f"eager engines equal the unmeshed engine's after every chunk; "
            f"collectives issued {comm.counts()}")
        if not on_card:
            return launches, {}
        g_m, g_u = decs["graphed"], decs["unmeshed graphed"]
        if len(g_m.graphs) != 1 or len(g_u.graphs) != 1:
            raise AssertionError(f"{name}: one graph an engine")
        n = g_m.chunk_size
        per = g_m.graphs.collectives(n, g_m.eos_id, g_m.max_seq)
        if per != eager or (cfg.name == "llama-30b" and per != {
                "all_reduce": 2 * cfg.num_layers * n, "all_gather": 2 * n}):
            raise AssertionError(f"{name}: a replay's collectives {per}, "
                                 f"the eager chunk's {eager}")
        log(f"  {name} the graphed chunk holds its collectives, the eager "
            f"chunk's: {json.dumps({k: v // n for k, v in per.items()})} "
            f"over NCCL a step (counted at capture), kernel launches a "
            f"replay "
            f"{json.dumps(g_m.graphs.captured(n, g_m.eos_id, g_m.max_seq)[1])}")
        # one replay of each graph between CUDA events, turn by turn, one
        # request decoding on each
        for a in ("unmeshed graphed", "graphed"):
            r = E.GenRequest(9, prompts[1], 4 * n)
            (_, w, f), = pres[a == "graphed"].run([r])
            decs[a].admit(E.AdmissionBatch([E.AdmissionItem(r, f, wire=w)]))
            decs[a].step()
        times = {a: [] for a in ("unmeshed graphed", "graphed")}
        for a in ("unmeshed graphed", "graphed", "graphed",
                  "unmeshed graphed"):
            dec = decs[a]
            graph, _ = dec.graphs.captured(n, dec.eos_id, dec.max_seq)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            graph.replay()
            e.record()
            torch.cuda.synchronize()
            times[a].append(s.elapsed_time(e))
        log(f"  {name} one replay of the {n}-step chunk (CUDA events, 1 "
            f"slot decoding): meshed {times['graphed']} ms, unmeshed "
            f"{times['unmeshed graphed']} ms")
        for a in ("unmeshed graphed", "graphed"):
            decs[a].release(decs[a].slots.index(
                next(r for r in decs[a].slots if r is not None)))
        return launches, times
    finally:
        dist.destroy_process_group()


def p12_cfg(arch, part, reduced=False):
    from repro_torch.configs import get_config, get_reduced
    if reduced:
        return get_reduced(arch)
    return get_config(arch).replace(num_layers=P12_LAYERS[part])


def p12_batch(torch, cfg, device, reduced):
    B, S = (4, 32) if reduced else (4, 256)
    rng = np.random.default_rng(SEED + 120)
    lens = np.array([S, S - 9, S // 2, 17])
    return S, {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (B, S)), device=device),
        "last_pos": torch.as_tensor(lens - 1, device=device),
        "true_len": torch.as_tensor(lens.astype(np.int32), device=device)}


def tp_case(torch, arch, part, *, mesh=None, ref=None, device="cuda",
            reduced=False):
    """One run of phase 12 (b) or (c) on this process's shard (unsharded
    without a ``mesh``): a prefill of 4 prompts (logits at each last
    position, raw K/V, the drops of each MoE layer), 8 dense decode
    steps from the unsharded run's prefill cache fed the unsharded run's
    tokens (``ref``; its own without), and the engines on the main path
    (bucketed prefill, the int4 wire, int4 pages, eager chunks): every
    request DONE, 0 leaked pages. Returns host tensors and counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import build, moe, transformer
    from repro_torch.serving import engine as E
    cfg = p12_cfg(arch, part, reduced)
    rt = None if mesh is None else transformer.Runtime(
        mesh, moe_shard_map=bool(cfg.moe_num_experts))
    params = transformer.init_params(cfg, seed=SEED, device=device,
                                     mesh=mesh)
    api = build(cfg, rt=rt)
    local = api.local_cfg
    S, batch = p12_batch(torch, cfg, device, reduced)
    before = ops.launch_counts()
    with moe.count_drops() as drops:
        logits, cache = api.prefill(params, batch)
    out = {"logits": logits[:, -1].float().cpu(),
           "k": cache["slot0"]["k"].cpu(), "v": cache["slot0"]["v"].cpu(),
           "drops": [int(d) for d in drops]}
    del cache
    # decode steps from the unsharded run's prefill cache and tokens
    src = ref or out
    lo = 0 if mesh is None else api.tp.rank * local.num_kv_heads
    dc = transformer.init_cache(local, 4, S + P12_DECODE_STEPS,
                                device=device)
    for key in ("k", "v"):
        dc["slot0"][key][:, :, :S] = src[key][..., lo:lo + local.num_kv_heads,
                                              :].to(device)
    dc["lengths"].copy_(batch["true_len"])
    cur = torch.argmax(src["logits"], -1).to(device)
    dec_logits, dec_toks = [], []
    with moe.count_drops() as ddrops:
        for i in range(P12_DECODE_STEPS):
            lg, dc = api.decode(params, dc, cur[:, None].to(torch.long))
            dec_logits.append(lg[:, -1].float().cpu())
            dec_toks.append(torch.argmax(lg[:, -1], -1).cpu())
            cur = (src["dec_toks"][i] if ref else dec_toks[-1]).to(device)
    out.update(dec_logits=torch.stack(dec_logits),
               dec_toks=torch.stack(dec_toks),
               dec_drops=sum(int(d) for d in ddrops))
    del dc
    # the engines on the main path
    pre = E.PrefillEngine(cfg, params, max_seq=S + 32, max_batch=4,
                          device=device, rt=rt)
    rng = np.random.default_rng(SEED + 121)
    prompts = [rng.integers(1, cfg.vocab_size, n)
               for n in (S - S // 4, S // 3, 17, S - 1)]
    with moe.count_drops() as pdrops:
        wires = pre.run([E.GenRequest(i, p, 16)
                         for i, p in enumerate(prompts)])
    toks = {}
    for resident in ("int4", "bf16"):      # bf16 pages dequantize the wire
        dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=S + 32,
                             cuda_graph=False, device=device, rt=rt,
                             kv_resident=resident)
        reqs = [E.GenRequest(i, p, 16) for i, p in enumerate(prompts)]
        if dec.admit(E.AdmissionBatch([E.AdmissionItem(r, f, wire=w)
                                       for r, (_, w, f) in zip(reqs,
                                                               wires)])):
            raise AssertionError(f"{arch}: admission rejected")
        while dec.active:
            dec.step()
        if any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
            raise AssertionError(f"{arch} {resident}: requests not DONE")
        if dec.page_stats()["leaked_pages"]:
            raise AssertionError(f"{arch} {resident}: leaked pages")
        toks[resident] = [r.out_tokens for r in reqs]
        del dec
    out.update(engine_toks=toks["int4"], bf16_toks=toks["bf16"],
               prefill_drops=[int(d) for d in pdrops],
               launches={k: n - before[k]
                         for k, n in ops.launch_counts().items()})
    return out


def stage_fn(cfg):
    """``fn(layers, x)``: a pipeline stage, ``run_layers`` over its
    layers with causal flash attention (no cache)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, transformer

    def fn(stage, x):
        import torch
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        rope = layers.model_rope(cfg, positions)

        def attend(i, p, h):
            q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
            o = ops.flash_attention(q, k, v, causal=True)
            return layers.proj(p["attn"], "wo", o.reshape(B, S, cfg.q_dim))

        return transformer.run_layers(cfg, {"layers": stage}, x, attend,
                                      final_norm=False)[0]
    return fn


def pipe_inputs(torch, cfg, device):
    g = torch.Generator(device=device).manual_seed(SEED + 122)
    return torch.randn((4, 64, cfg.d_model), generator=g, device=device
                       ).to(torch.bfloat16)


def phase12_rank(rank, world, port, tmp, reduced, device):
    """One rank of phase 12 (b)-(e), a process of its own over gloo on
    the one card: (b) and (c) through :func:`tp_case` against the
    unsharded runs' results in ``tmp``, (d) ``pipeline_apply`` over two
    stages against the sequential apply, bit for bit, (e) every other
    config through :func:`p12e_rank`. Saves its results to
    ``tmp/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("model",), device=device)
        out = {}
        for part, arch in (("tp", "llama-30b"),
                           ("moe", "qwen3-moe-235b-a22b")):
            t = time.perf_counter()
            ref = torch.load(os.path.join(tmp, f"{part}.pt"),
                             weights_only=False)
            out[part] = tp_case(torch, arch, part, mesh=mesh, ref=ref,
                                device=device, reduced=reduced)
            del ref
            settled(torch) if device == "cuda" else None
            out[part]["s"] = time.perf_counter() - t
        # (d) two pipeline stages of LLaMA-30B's layers
        t = time.perf_counter()
        cfg = p12_cfg("llama-30b", "pipe", reduced)
        pod = make_mesh((world,), ("pod",), device=device)
        params = transformer.init_params(cfg, seed=SEED, device=device)
        n = cfg.num_layers // world
        stage = params["layers"][rank * n:(rank + 1) * n]
        del params
        y = pipeline_apply(stage_fn(cfg), stage, pipe_inputs(
            torch, cfg, device), mesh=pod, axis="pod", n_microbatch=2)
        want = torch.load(os.path.join(tmp, "pipe.pt"), weights_only=False)
        out["pipe"] = {"equal": bool(torch.equal(y.cpu(), want)),
                       "s": time.perf_counter() - t}
        del y, stage
        if device == "cuda":
            settled(torch)
        # (e) every other config at TP 2
        out["e"] = p12e_rank(torch, rank, world, mesh, tmp, reduced, device)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def compare_tp(torch, name, ref, got, dtype):
    """Phase 12 (b)/(c): the ranks' results against the unsharded run's.
    Prefill logits within P12_LOGIT_TOL relative L2 (held only where no
    route dropped in either run), every layer's raw K/V per head within
    CHUNK_REL_TOL up to the first layer where a route dropped, the
    decode steps' logits within P12_LOGIT_TOL relative L2 at every slot
    and step (a MoE model: the median slot-step, since rounding can move
    a route across the router's k-th place and change that slot-step's
    experts; every one is printed) and their greedy tokens equal where
    the unsharded top-2 margin exceeds P12_MARGIN."""
    tol, kv_tol = P12_LOGIT_TOL[dtype], CHUNK_REL_TOL[dtype]
    drops = [sum(g["drops"][i] for g in got)
             for i in range(len(ref["drops"]))]
    first = next((i for i, (a, b) in enumerate(zip(ref["drops"], drops))
                  if a or b), None)
    if not ref["drops"] or first is None:
        err = rel_l2(torch, ref["logits"], got[0]["logits"])
        log(f"  {name} prefill logits: relative L2 {err:.3e} (tol {tol})")
        if err > tol:
            raise AssertionError(f"{name}: prefill logits {err} > {tol}")
    else:
        log(f"  {name} prefill: routes dropped (unsharded {ref['drops']}, "
            f"sharded {drops} by layer); logits not held, K/V held up to "
            f"layer {first}")
    L = ref["k"].shape[0] if first is None else first + 1
    worst = 0.0
    for key in ("k", "v"):
        full = torch.cat([g[key] for g in got], dim=3)
        for i in range(L):
            for h in range(full.shape[3]):
                e = rel_l2(torch, ref[key][i, ..., h, :], full[i, ..., h, :])
                worst = max(worst, e)
                if e > kv_tol:
                    raise AssertionError(f"{name}: {key} layer {i} head {h}"
                                         f" relative L2 {e} > {kv_tol}")
    log(f"  {name} raw K/V of layers 0-{L - 1}, per head: worst relative "
        f"L2 {worst:.3e} (tol {kv_tol})")
    want, have = ref["dec_logits"], got[0]["dec_logits"]
    errs = torch.tensor([[rel_l2(torch, want[i, b], have[i, b])
                          for b in range(want.shape[1])]
                         for i in range(want.shape[0])])
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > P12_MARGIN
    same = ref["dec_toks"] == got[0]["dec_toks"]
    # MoE: a route that rounding moves across the router's k-th place
    # changes a slot-step's expert mix, so its median slot-step is held
    held = float(errs.median() if ref["drops"] else errs.max())
    log(f"  {name} {want.shape[0]} decode steps x {want.shape[1]} slots "
        f"fed the unsharded tokens: logits relative L2 by slot-step median "
        f"{float(errs.median()):.3e}, worst {float(errs.max()):.3e} (tol "
        f"{tol} on the {'median' if ref['drops'] else 'worst'}), each "
        f"step's worst {[round(float(e), 4) for e in errs.max(1).values]}; "
        f"greedy tokens equal at {int((same & clear).sum())} of "
        f"{int(clear.sum())} slot-steps whose top-2 margin clears "
        f"{P12_MARGIN} ({int(same.sum())} of {same.numel()} in all); drops "
        f"{[g['dec_drops'] for g in got]}")
    if held > tol or bool((clear & ~same).any()):
        raise AssertionError(f"{name}: decode steps differ")
    n_eq = [sum(a == b for a, b in zip(ref[k], got[0][k]))
            for k in ("engine_toks", "bf16_toks")]
    log(f"  {name} engines (the int4 wire into int4 and into bf16 pages, "
        f"eager chunks over gloo): 4 requests DONE each, 0 leaked pages on "
        f"every rank; token streams equal to the unsharded engines': "
        f"{n_eq[0]} of 4 (int4), {n_eq[1]} of 4 (bf16); prefill drops by "
        f"call and layer, unsharded {ref['prefill_drops']}, ranks "
        f"{[g['prefill_drops'] for g in got]}")


# phase 12 (e): every other config at TP 2 over two ranks, arch -> layers
# kept (None: every layer), so that both ranks and the unsharded run made
# before them fit 80 GB: jamba one 8-layer period (attention, Mamba,
# MoE), llama4 a dense and a MoE layer
P12E = {"stablelm-3b": 4, "gemma-2b": None, "h2o-danube-3-4b": 4,
        "command-r-35b": 4, "llava-next-mistral-7b": 4,
        "llama4-maverick-400b-a17b": 2, "jamba-v0.1-52b": 8,
        "xlstm-125m": None, "whisper-base": None}
# (e)'s C.3 probes: xlstm and jamba at TP 2 in bf16, measured and printed,
# not held (ROADMAP C.3 stays open with their values)
P12E_PROBES = ("xlstm-125m:bf16", "jamba-v0.1-52b:bf16")
P12E.update({"xlstm-125m:bf16": None, "jamba-v0.1-52b:bf16": 8})
# (e)'s world-1 NCCL runs: a paged stack with one KV head, a recurrent one
P12E_WORLD1 = ("gemma-2b", "jamba-v0.1-52b:bf16")
# xlstm and jamba run (e) in float32: in bf16 their random-weight stacks
# compound every rounding a rank's products make apart from the unsharded
# ones, xlstm's through its exponential gates (0.102 relative L2 at the
# logits of 12 layers on an H100 with f32 row-parallel sums, 0.152 with
# bf16 sums), jamba's through each Mamba step's decay and its routes
# (0.03-0.07 at the logits and 0.06-0.08 at the states of layers 5-7 of
# 8, once dropless routing held every layer), against 0.007-0.02 for the
# other configs (ROADMAP C.3, PERF.md); f32 holds the sharding itself to
# P12_LOGIT_TOL's 1e-4
P12E_F32 = ("xlstm-125m", "jamba-v0.1-52b")
P12E_STEPS = 4        # teacher-forced dense decode steps
P12E_NEW = 8          # tokens a request on the main path: one chunk
# the dim of a cache tensor its heads or channels are split on
HEADS_DIM = {"k": 3, "v": 3, "self_k": 3, "self_v": 3, "cross_k": 3,
             "cross_v": 3, "conv": -1, "ssm": 2, "C": 2, "n": 2, "m": 2,
             "c": 2, "h": 2}


def p12e_cfg(arch, reduced=False):
    from repro_torch.configs import get_config, get_reduced
    keep = P12E[arch]
    arch, _, probe = arch.partition(":")
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if not reduced and keep is not None:
        cfg = cfg.replace(num_layers=keep)
    return cfg.replace(dtype="float32") if arch in P12E_F32 and not probe \
        else cfg


def c3_sensitivity(torch, cfg, params, device="cuda", reduced=False):
    """C.3's yardstick: the unsharded run's own sensitivity, the relative
    L2 between its prefill logits (:func:`p12e_batch`) and those of the
    same run with every weight moved by one bf16 ulp, up or down at
    random (seeded): a bf16 weight's bits one step in magnitude (zeros
    stay), an f32 one by the bf16 ulp at its magnitude."""
    from repro_torch.models import build
    from repro_torch.training.optimizer import tree_map
    gen = torch.Generator(device=device).manual_seed(SEED + 31)

    def moved(t):
        step = torch.randint(0, 2, t.shape, generator=gen,
                             device=t.device, dtype=torch.int8) * 2 - 1
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16)
            step = torch.where((bits & 0x7FFF) != 0, step, 0)
            return (bits + step.to(torch.int16)).view(torch.bfloat16)
        ulp = torch.exp2(torch.floor(torch.log2(t.abs())) - 7)
        return torch.where(t != 0, t + step * ulp, t)

    api = build(cfg)
    S, batch = p12e_batch(torch, cfg, device, reduced)
    base = api.prefill(params, batch, max_seq=S)[0]
    other = tree_map(moved, params)
    got = api.prefill(other, batch, max_seq=S)[0]
    del other
    return rel_l2(torch, base, got)


def p12e_params(torch, cfg, device="cuda", mesh=None):
    return make_params(torch, cfg, device=device, mesh=mesh,
                       dtype=torch.float32 if cfg.dtype == "float32"
                       else None)


def bucketed(cfg):
    """Whether ``PrefillEngine`` pads ``cfg``'s prompts to buckets (a
    pure full-attention stack, not a VLM's)."""
    from repro_torch.models.transformer import recurrent
    return cfg.family not in ("audio", "vlm") and not recurrent(cfg) \
        and not cfg.sliding_window


def p12e_batch(torch, cfg, device, reduced):
    """(e)'s model-API prefill: a bucketed stack's padded bucket
    (:func:`p12_batch`), any other's 4 prompts of one exact length;
    llava's patch embeddings and whisper's frames in front, seeded."""
    if bucketed(cfg):
        return p12_batch(torch, cfg, device, reduced)
    S = 32 if reduced else 256
    rng = np.random.default_rng(SEED + 123)
    batch = {"tokens": torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (4, S)), device=device)}
    extra = {"vlm": ("patch_embeds", cfg.num_patches),
             "audio": ("frame_embeds", cfg.encoder_seq)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.as_tensor(rng.standard_normal(
            (4, extra[1], cfg.d_model)).astype(np.float32),
            device=device).to(torch.bfloat16)
    return S, batch


def flat_cache(cache):
    """``{name: tensor}`` of a cache (``slot{s}/key`` for a slotted one),
    without its lengths and page table."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": t for kk, t in v.items()})
        elif k not in ("lengths", "page_table"):
            out[k] = v
    return out


class CollectiveClock:
    """Host seconds spent in the model axis's collectives while it is
    entered (each call synchronized before and after, so the device work
    queued before it is not counted), by call."""

    def __init__(self, torch):
        self.torch, self.s, self.n = torch, 0.0, 0

    def __enter__(self):
        from repro_torch.distributed import comm
        self._old = {k: getattr(comm.Group, k)
                     for k in ("all_reduce", "all_gather", "all_to_all")}

        def timed(fn):
            def call(grp, *a, **kw):
                sync = self.torch.cuda.synchronize \
                    if self.torch.cuda.is_available() else (lambda: None)
                sync()
                t = time.perf_counter()
                out = fn(grp, *a, **kw)
                sync()
                self.s += time.perf_counter() - t
                self.n += 1
                return out
            return call

        for k, fn in self._old.items():
            setattr(comm.Group, k, timed(fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import comm
        for k, fn in self._old.items():
            setattr(comm.Group, k, fn)


def tp_family_case(torch, cfg, params, *, rt=None, ref=None, device="cuda",
                   reduced=False):
    """One config of phase 12 (e) on this process's shard (unsharded
    without ``rt``): a prefill through the model API (logits at each last
    position, every layer's raw K/V or states, each MoE layer's drops);
    P12E_STEPS steps of the dense decode step on the dense engine's cache,
    admitted from the prefill engine's raw wires and fed the unsharded
    run's tokens (``ref``; its own without); then the main path: the
    prefill engine's wires into a decode engine on the arch's usual cache
    (int4 pages where it pages, else its dense cache), one chunk of
    P12E_NEW tokens a request, graphed without a mesh, eager over gloo:
    every request DONE, 0 leaked pages. Returns host tensors and
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import build, moe
    from repro_torch.serving import engine as E
    api = build(cfg, rt=rt)
    S, batch = p12e_batch(torch, cfg, device, reduced)
    before = ops.launch_counts()
    with moe.count_drops() as drops:
        logits, cache = api.prefill(params, batch)
    out = {"logits": logits[:, -1].float().cpu(),
           "cache": {k: t.cpu() for k, t in flat_cache(cache).items()},
           "drops": [int(d) for d in drops]}
    del cache, logits
    max_seq = S + 32
    pre = prefill_engine(torch, cfg, params, max_seq=max_seq, device=device,
                         rt=rt)
    rng = np.random.default_rng(SEED + 124)
    prompts = [rng.integers(1, cfg.vocab_size, n)
               for n in (S - S // 4, S // 3, 17, S - 1)]

    def admitted(dec, compress):
        """Fresh requests prefilled and admitted in request order (slot
        i holds request i); returns (requests, first tokens)."""
        reqs = [E.GenRequest(i, p, P12E_NEW) for i, p in enumerate(prompts)]
        done = {r.rid: (r, w, f) for r, w, f in
                pre.run(reqs, compress=compress)}
        items = [E.AdmissionItem(done[i][0], done[i][2], wire=done[i][1])
                 for i in range(4)]
        if dec.admit(E.AdmissionBatch(items)):
            raise AssertionError(f"{cfg.name}: admission rejected")
        return reqs, torch.tensor([done[i][2] for i in range(4)])

    # the dense decode step, teacher-forced
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=max_seq,
                         paged=False, cuda_graph=False, device=device, rt=rt)
    with moe.count_drops() as pdrops:
        _, first = admitted(dec, False)
    cur = (ref["first"] if ref else first).to(device)
    dec_logits, dec_toks = [], []
    with moe.count_drops() as ddrops:
        for i in range(P12E_STEPS):
            lg, stepped = dec.api.decode(params, dec.cache,
                                         cur[:, None].to(torch.long))
            dec.cache["lengths"].copy_(stepped["lengths"])
            dec_logits.append(lg[:, -1].float().cpu())
            dec_toks.append(torch.argmax(lg[:, -1], -1).cpu())
            cur = (ref["dec_toks"][i] if ref else dec_toks[-1]).to(device)
    del dec
    out.update(first=first, dec_logits=torch.stack(dec_logits),
               dec_toks=torch.stack(dec_toks),
               dec_drops=sum(int(d) for d in ddrops))
    # the main path on the usual cache
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=max_seq,
                         chunk_size=P12E_NEW, device=device, rt=rt,
                         cuda_graph=rt is None and device == "cuda")
    reqs, _ = admitted(dec, True)
    while dec.active:
        dec.step()
    if any(len(r.out_tokens) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{cfg.name}: requests not DONE")
    if dec.paged and dec.page_stats()["leaked_pages"]:
        raise AssertionError(f"{cfg.name}: leaked pages")
    out.update(engine_toks=[r.out_tokens for r in reqs],
               cache_kind="int4 pages" if dec.paged else "dense",
               graphs=len(dec.graphs) if dec.graphs is not None else 0,
               prefill_drops=[int(d) for d in pdrops],
               launches={k: n - before[k]
                         for k, n in ops.launch_counts().items()})
    del dec, pre
    return out


def p12e_rank(torch, rank, world, mesh, tmp, reduced, device):
    """(e) on one rank: each config's shard, drawn rank after rank (a
    whole tensor is drawn before a rank keeps its half: llama4's expert
    ``wi`` alone is 21.5 GB), then :func:`tp_family_case` against the
    unsharded run's results in ``tmp``."""
    import torch.distributed as dist
    from repro_torch.models import transformer
    out = {}
    for arch in P12E:
        t = time.perf_counter()
        cfg = p12e_cfg(arch, reduced)
        for r in range(world):
            if r == rank:
                params = p12e_params(torch, cfg, device, mesh)
                if device == "cuda":
                    settled(torch)
            dist.barrier()
        ref = torch.load(os.path.join(tmp, f"e_{arch}.pt"),
                         weights_only=False)
        rt = transformer.Runtime(mesh, moe_shard_map=bool(
            cfg.moe_num_experts))
        with CollectiveClock(torch) as clock:
            out[arch] = tp_family_case(torch, cfg, params, rt=rt, ref=ref,
                                       device=device, reduced=reduced)
        del params, ref
        if device == "cuda":
            settled(torch)
        dist.barrier()
        out[arch].update(coll_s=clock.s, coll_n=clock.n,
                         s=time.perf_counter() - t)
    return out


def owners(cfg, n):
    """The first rank of the model axis that holds each KV head of
    ``cfg`` (replicated KV: one KV head a rank)."""
    from repro_torch.distributed import sharding
    if sharding.kv_replicated(cfg, n):
        return [h * (n // cfg.num_kv_heads) for h in range(cfg.num_kv_heads)]
    return list(range(n))


def gather_cache(torch, cfg, got, name, n, reverse=False):
    """A cache tensor of the ranks' results, whole: their shards
    concatenated on the tensor's heads or channels (replicated KV: each
    KV head once); ``reverse`` concatenates the ranks in reverse order
    (the negative control)."""
    from repro_torch.distributed import sharding
    key = name.rsplit("/", 1)[-1]
    ranks = owners(cfg, n) if key in ("k", "v") and \
        sharding.kv_replicated(cfg, n) else list(range(n))
    parts = [got[r]["cache"][name] for r in ranks]
    return torch.cat(parts[::-1] if reverse else parts, dim=HEADS_DIM[key])


def layer_of(cfg, name, j):
    """The layer index of index ``j`` of a stacked cache tensor (a
    recurrent stack's slotted cache: slot s, index j is layer ``j *
    period + s``; any other cache is one layer-ordered stack)."""
    from repro_torch.models.transformer import recurrent, slot_kinds
    slot = name.split("/")[0]
    if not (slot.startswith("slot") and recurrent(cfg)):
        return j
    return j * len(slot_kinds(cfg)) + int(slot[4:])


def compare_family(torch, arch, cfg, ref, got, dtype="bfloat16", *,
                   gated=True):
    """Phase 12 (e): one config's ranks against its unsharded run. The
    prefill logits within P12_LOGIT_TOL relative L2 (held where no MoE
    route dropped in either run) and equal on both ranks, every layer's
    raw K/V or states within CHUNK_REL_TOL up to the first layer where a
    route dropped, and the negative control (the ranks' shards in
    reverse order; replicated KV: its rows one position off) rejected;
    the teacher-forced decode steps' logits within P12_LOGIT_TOL's bf16
    bound (the dense decode cache is bf16 whatever the model's type) at
    every slot-step (a MoE config's median) and their greedy tokens equal
    where the unsharded top-2 margin clears P12_MARGIN. Everything is
    measured and printed before a failure raises (each cache tensor's
    error by layer where one fails); ``gated=False`` (the C.3 probe)
    prints what would fail and raises nothing. Returns the row of
    PERF.md's table."""
    from repro_torch.distributed import sharding
    tol, kv_tol = P12_LOGIT_TOL[dtype], CHUNK_REL_TOL[dtype]
    step_tol = P12_LOGIT_TOL["bfloat16"]
    n = len(got)
    bad_news = []
    if not torch.equal(got[0]["logits"], got[1]["logits"]):
        bad_news.append("the ranks' logits differ")
    drops = [sum(g["drops"][i] for g in got)
             for i in range(len(ref["drops"]))]
    moe_layers = [i for i, k in enumerate(cfg.layer_kinds())
                  if k.endswith("moe")]
    first = next((moe_layers[i] for i, (a, b) in enumerate(
        zip(ref["drops"], drops)) if a or b), None)
    logit_err = rel_l2(torch, ref["logits"], got[0]["logits"])
    if first is None and logit_err > tol:
        bad_news.append(f"prefill logits {logit_err} > {tol}")
    worst, held = 0.0, 0
    for name, want in ref["cache"].items():
        full = gather_cache(torch, cfg, got, name, n)
        errs = {layer_of(cfg, name, j): rel_l2(torch, want[j], full[j])
                for j in range(want.shape[0])}
        errs = {i: e for i, e in errs.items() if first is None or i <= first}
        worst, held = max([worst, *errs.values()]), held + len(errs)
        if any(e > kv_tol for e in errs.values()):
            bad_news.append(f"{name} relative L2 by layer "
                            f"{ {i: round(e, 6) for i, e in errs.items()} } "
                            f"past {kv_tol}")
    name = next((k for k in ref["cache"] if k.rsplit("/", 1)[-1] == "k"),
                next(iter(ref["cache"])))
    if name.rsplit("/", 1)[-1] in ("k", "v") and \
            sharding.kv_replicated(cfg, n):
        bad, what = torch.roll(gather_cache(torch, cfg, got, name, n), 1,
                               dims=2), "rows one position off"
    else:
        bad, what = gather_cache(torch, cfg, got, name, n,
                                 reverse=True), "ranks' shards swapped"
    control = rel_l2(torch, ref["cache"][name][0], bad[0])
    if control <= kv_tol:
        bad_news.append(f"the control ({what}) passed: {control}")
    want, have = ref["dec_logits"], got[0]["dec_logits"]
    errs = torch.tensor([[rel_l2(torch, want[i, b], have[i, b])
                          for b in range(want.shape[1])]
                         for i in range(want.shape[0])])
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > P12_MARGIN
    same = ref["dec_toks"] == got[0]["dec_toks"]
    step_err = float(errs.median() if moe_layers else errs.max())
    eng = sum(a == b for a, b in zip(ref["engine_toks"],
                                     got[0]["engine_toks"]))
    log(f"  (e) {arch} ({cfg.num_layers} layers) TP {n}: prefill logits "
        f"relative L2 {logit_err:.3e}"
        + (f" (not held: routes dropped, unsharded {ref['drops']}, sharded "
           f"{drops}; caches held to layer {first})" if first is not None
           else f" (tol {tol})")
        + f"; {held} cache layers, worst relative L2 {worst:.3e} (tol "
        f"{kv_tol}); control ({what}) {control:.3f}; {want.shape[0]} "
        f"decode steps x {want.shape[1]} slots: logits relative L2 "
        f"{'median' if moe_layers else 'worst'} {step_err:.3e}, greedy "
        f"tokens equal at {int((same & clear).sum())} of "
        f"{int(clear.sum())} slot-steps whose margin clears {P12_MARGIN}; "
        f"main path ({ref['cache_kind']}, unsharded graphed, ranks eager "
        f"over gloo): token streams equal {eng} of 4; host seconds in "
        f"gloo collectives {[round(g['coll_s'], 3) for g in got]} of "
        f"{[round(g['s'], 1) for g in got]} ({got[0]['coll_n']} calls)")
    if step_err > step_tol or bool((clear & ~same).any()):
        bad_news.append(f"decode steps differ ({step_err} against "
                        f"{step_tol})")
    if bad_news and not gated:
        log(f"  (e) {arch}, not held (C.3): {'; '.join(bad_news)}")
    elif bad_news:
        for line in bad_news:
            log(f"  (e) {arch} FAILED: {line}")
        raise AssertionError(f"(e) {arch}: {'; '.join(bad_news)}")
    return {"arch": arch, "layers": cfg.num_layers, "dtype": dtype,
            "logit_rel_l2":
            logit_err, "cache_rel_l2": worst, "control": control,
            "step_rel_l2": step_err, "tokens_clear":
            (int((same & clear).sum()), int(clear.sum())),
            "engine_equal": eng, "coll_s": [g["coll_s"] for g in got],
            "rank_s": [g["s"] for g in got]}


def phase12(torch, *, device="cuda", reduced=False):
    """Phase 12: (a) :func:`mesh_world1` on full LLaMA-30B (60 layers;
    reduced: the reduced config), and on gemma-2b and jamba (e's world-1
    runs); (b)-(e) over two ranks, each a process of its own on the one
    card over gloo (NCCL cannot put two ranks on one card), against
    unsharded runs made here first and freed before the ranks start.
    Returns (the kernel launches of its main-path runs, this process's
    and the ranks'; (e)'s rows and world-1 replay times)."""
    import tempfile
    from repro_torch.configs import get_config, get_reduced
    cfg = get_reduced("llama-30b") if reduced else get_config("llama-30b")
    dtype = "bfloat16"
    t = time.perf_counter()
    base = settled(torch) if device == "cuda" else 0
    params = full_model(torch, cfg, device)[0]
    launches = mesh_world1(torch, cfg, params, device)[0]
    del params
    if device == "cuda" and settled(torch) > base:
        raise AssertionError(f"(a) left {settled(torch) - base} bytes "
                             f"allocated")
    log(f"  (a) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    replay = {}
    for arch in P12E_WORLD1:
        ecfg = p12e_cfg(arch, reduced)
        params = p12e_params(torch, ecfg, device)
        got, replay[arch] = mesh_world1(torch, ecfg, params, device,
                                        name=f"(e) {arch}")
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
        del params
        if device == "cuda" and settled(torch) > base:
            raise AssertionError(f"(e) {arch} world 1 left "
                                 f"{settled(torch) - base} bytes allocated")
    log(f"  (e) world-1 runs: {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        refs = {}
        for part, arch in (("tp", "llama-30b"),
                           ("moe", "qwen3-moe-235b-a22b")):
            refs[part] = tp_case(torch, arch, part, device=device,
                                 reduced=reduced)
            torch.save(refs[part], os.path.join(tmp, f"{part}.pt"))
            if device == "cuda":
                settled(torch)
        pcfg = p12_cfg("llama-30b", "pipe", reduced)
        from repro_torch.models import transformer
        params = transformer.init_params(pcfg, seed=SEED, device=device)
        fn, x = stage_fn(pcfg), pipe_inputs(torch, pcfg, device)
        n = pcfg.num_layers // P12_RANKS
        seq = []
        for mb in x.reshape(2, -1, *x.shape[1:]):
            for s in range(P12_RANKS):
                mb = fn(params["layers"][s * n:(s + 1) * n], mb)
            seq.append(mb)
        torch.save(torch.cat(seq).cpu(), os.path.join(tmp, "pipe.pt"))
        del params, seq, x
        if device == "cuda":
            settled(torch)
        sens = {}
        for arch in P12E:
            ecfg = p12e_cfg(arch, reduced)
            params = p12e_params(torch, ecfg, device)
            refs[arch] = tp_family_case(torch, ecfg, params, device=device,
                                        reduced=reduced)
            if arch in P12E_PROBES:
                sens[arch] = c3_sensitivity(torch, ecfg, params, device,
                                            reduced)
            torch.save(refs[arch], os.path.join(tmp, f"e_{arch}.pt"))
            del params
            if device == "cuda":
                settled(torch)
        log(f"  unsharded runs of (b)-(e): {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        port, root = free_port(), os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(root, "src"), root]))
        outs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(P12_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke."
             f"phase12_rank({r}, {P12_RANKS}, {port}, {tmp!r}, {reduced}, "
             f"{device!r})"], cwd=root, env=env, stdout=outs[r],
            stderr=subprocess.STDOUT) for r in range(P12_RANKS)]
        try:
            # a rank that fails ends the others: none waits on it
            deadline = time.perf_counter() + 900
            while any(p.poll() is None for p in procs):
                if any(p.poll() for p in procs) or \
                        time.perf_counter() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for f in outs:
                f.close()
        for r, p in enumerate(procs):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                text = f.read()
            for line in text.splitlines():
                if line.startswith("[comm]") or p.returncode:
                    log(f"  [rank {r}] {line}")
            if p.returncode:
                raise AssertionError(f"phase 12 rank {r} exited "
                                     f"{p.returncode}")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(P12_RANKS)]
        log(f"  two ranks over gloo: {time.perf_counter() - t:.1f} s "
            f"(tp {[g['tp']['s'] for g in got]}, moe "
            f"{[g['moe']['s'] for g in got]}, pipe "
            f"{[g['pipe']['s'] for g in got]}, e "
            f"{[round(sum(x['s'] for x in g['e'].values()), 1) for g in got]}"
            f" s a rank)")
    for part, name in (("tp", f"(b) llama-30b TP {P12_RANKS}"),
                       ("moe", f"(c) qwen3-moe EP {P12_RANKS} + TP "
                               f"{P12_RANKS}")):
        compare_tp(torch, name, refs[part], [g[part] for g in got], dtype)
        for g in got:
            launches = {k: launches.get(k, 0) + n
                        for k, n in g[part]["launches"].items()}
    equal = [g["pipe"]["equal"] for g in got]
    log(f"  (d) pipeline_apply over {P12_RANKS} stages of "
        f"{p12_cfg('llama-30b', 'pipe', reduced).num_layers // P12_RANKS} "
        f"layers, 2 microbatches: equal to the sequential apply bit for "
        f"bit on every rank: {equal}")
    if not all(equal):
        raise AssertionError("(d): the pipeline differs from the "
                             "sequential apply")
    rows = []
    for arch in P12E:
        ecfg = p12e_cfg(arch, reduced)
        rows.append(compare_family(torch, arch, ecfg, refs[arch],
                                   [g["e"][arch] for g in got], ecfg.dtype,
                                   gated=arch not in P12E_PROBES))
        for r, g in enumerate(got):
            mine = g["e"][arch]["launches"]
            log(f"  (e) {arch} rank {r}'s kernel launches at its shapes: "
                f"{json.dumps({k: n for k, n in mine.items() if n})}")
            launches = {k: launches.get(k, 0) + n for k, n in mine.items()}
    log("  (e) table: arch | layers, type | prefill logits rel L2 | worst "
        "cache rel L2 | decode-step logits rel L2 | tokens equal (margin "
        "clears) | engine streams equal | gloo collectives host s (rank "
        "0, 1) | rank s")
    for r in rows:
        log(f"    {r['arch']} | {r['layers']}, {r['dtype']} | "
            f"{r['logit_rel_l2']:.3e} | "
            f"{r['cache_rel_l2']:.3e} | {r['step_rel_l2']:.3e} | "
            f"{r['tokens_clear'][0]}/{r['tokens_clear'][1]} | "
            f"{r['engine_equal']}/4 | "
            f"{', '.join(f'{s:.2f}' for s in r['coll_s'])} | "
            f"{', '.join(f'{s:.1f}' for s in r['rank_s'])}")
    for probe in (r for r in rows if r["arch"] in P12E_PROBES):
        log(f"  (e) C.3: {probe['arch']} at TP 2, prefill logits relative "
            f"L2 {probe['logit_rel_l2']:.3e}, worst cache relative L2 "
            f"{probe['cache_rel_l2']:.3e} (row-parallel sums in f32 above "
            f"axis size 1), beside the unsharded run's own sensitivity to "
            f"one bf16 ulp of every weight: {sens[probe['arch']]:.3e}; the "
            f"other configs' bound 2e-2")
    for arch, times in replay.items():
        log(f"  (e) {arch} world 1, one replay of the graphed chunk (ms): "
            f"meshed {times.get('graphed')}, unmeshed "
            f"{times.get('unmeshed graphed')}")
    return launches, rows, replay


# -- phase 12 (f): the sharded training step ----------------------------------

# layers kept at full width: (f) world 1, LLaMA-30B at TP 2, data 2 x model
# 2, the TP-2 checkpoint (its 1-layer state is 9.6 GB on disk; the 4-layer
# one's 25.7 GB would need ~80 GB of host memory to write and read back),
# qwen3-moe at EP 2 + TP 2
# (f)'s TP-2 run was 4 layers x 3 steps until the script neared its time
# limit (1131 s on a slow host with phase 14): 2 x 2 keeps the checks
P12F_LAYERS = {"world1": 1, "tp": 2, "dp": 2, "ckpt": 1, "moe": 1}
P12F_STEPS = {"tp": 2, "dp": 1, "moe": 1}
P12F_BATCH = (4, 512)             # rows x tokens of the global batch
P12F_LOSS_TOL = 1e-2              # relative, every step's loss
# step-1 gradients, each leaf's relative L2: CHUNK_REL_TOL (bf16 0.05)


def p12f_cfg(part, reduced=False):
    from repro_torch.configs import get_config, get_reduced
    arch = "qwen3-moe-235b-a22b" if part == "moe" else "llama-30b"
    if reduced:
        return get_reduced(arch)
    return get_config(arch).replace(num_layers=P12F_LAYERS[part])


def p12f_ocfg():
    from repro_torch.training import optimizer as opt
    return opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)


def p12f_batches(cfg, n, reduced):
    """``n`` global batches of the data pipeline (numpy)."""
    from repro_torch.training.data import DataConfig, PackedLM
    B, S = (4, 32) if reduced else P12F_BATCH
    data = PackedLM(DataConfig(cfg.vocab_size, S, B, seed=SEED))
    return [data.batch_at(i) for i in range(n)]


class RankOf:
    """A ``data x model`` mesh's shape and one rank's place in it, for
    ``sharding.shard_params`` in a process with no process group (the
    unsharded run cutting its gradients for each rank)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank):
        import types
        self.mesh = types.SimpleNamespace(shape=tuple(shape))
        self.rank = rank

    def get_local_rank(self, name):
        n = self.mesh.shape[1]
        return self.rank % n if name == "model" else self.rank // n


def p12f_train(torch, cfg, params, batches, device, rt=None):
    """The sharded (or, without ``rt``, the unsharded) train step over
    ``batches`` (this data rank's rows under a mesh): the step-1
    gradients (``optimizer.loss_and_grads`` of the initial state, the
    call the step makes) and routes dropped in that call, then every
    step through ``make_train_step``: losses, grad norms, host ms a step
    (the card synchronized)."""
    from repro_torch.launch.mesh import data_axes, shape_of
    from repro_torch.models import build, moe
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import rank_rows
    api = build(cfg, rt=rt)
    di, nd = 0, 1
    if rt is not None:
        for a in data_axes(rt.mesh):
            di = di * shape_of(rt.mesh)[a] + rt.mesh.get_local_rank(a)
            nd *= shape_of(rt.mesh)[a]

    def rows(b):
        return {k: torch.as_tensor(v, device=device)
                for k, v in rank_rows(b, di, nd).items()}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with moe.count_drops() as drops:
        _, g1 = opt.loss_and_grads(api, params, rows(batches[0]))
    g1 = opt.tree_map(lambda g: g.detach(), g1)
    step = opt.make_train_step(api, p12f_ocfg())
    state = opt.adamw_init(params)
    out = {"loss": [], "norm": [], "ms": [],
           "drops": int(sum(int(d) for d in drops))}
    for b in batches:
        b = rows(b)
        sync()
        t = time.perf_counter()
        params, state, st = step(params, state, b)
        sync()
        out["ms"].append(1e3 * (time.perf_counter() - t))
        out["loss"].append(float(st["loss"]))
        out["norm"].append(float(st["grad_norm"]))
    return out, g1, params, state


def p12f_world1(torch, device, reduced):
    """(f) world 1: a train step of full-width LLaMA-30B cut to one layer
    over a ``data 1 x model 1`` mesh of one NCCL rank (gloo on the CPU)
    against the unmeshed step, under deterministic algorithms: loss,
    grad norm and every param after the step, bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.training import optimizer as opt
    cfg = p12f_cfg("world1", reduced)
    batches = p12f_batches(cfg, 1, reduced)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        got = {}
        for arm in ("unmeshed", "meshed"):
            rt = None if arm == "unmeshed" else Runtime(make_mesh(
                (1, 1), ("data", "model"), device=device))
            params = make_params(torch, cfg, device=device)
            out, _, params, _ = p12f_train(torch, cfg, params, batches,
                                           device, rt)
            got[arm] = (out, [t.detach().cpu() for t in
                              opt.tree_leaves(params)])
            del params
            if device == "cuda":
                settled(torch)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(was)
    (a, pa), (b, pb) = got["unmeshed"], got["meshed"]
    same = a["loss"] == b["loss"] and a["norm"] == b["norm"] and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(pa, pb))
    log(f"  (f) world 1, {cfg.name} ({cfg.num_layers} layer(s)): the meshed "
        f"train step bit for bit the unmeshed one: {same} (loss "
        f"{b['loss'][0]:.6f}, grad norm {b['norm'][0]:.6f}, {len(pb)} "
        f"params; {b['ms'][0]:.1f} ms meshed, {a['ms'][0]:.1f} unmeshed)")
    if not same:
        raise AssertionError("(f) world 1: the meshed train step differs")


def p12f_reference(torch, part, tmp, device, reduced):
    """The unsharded run of (f)'s ``part``: its losses and the step-1
    gradients cut for each rank (``tmp/f_{part}_r{r}.pt``)."""
    from repro_torch.distributed import sharding
    from repro_torch.training import optimizer as opt
    world, shape = {"tp": (2, (1, 2)), "dp": (4, (2, 2)),
                    "moe": (2, (1, 2))}[part]
    cfg = p12f_cfg(part, reduced)
    batches = p12f_batches(cfg, P12F_STEPS[part], reduced)
    params = make_params(torch, cfg, device=device)
    t = time.perf_counter()
    out, g1, params, state = p12f_train(torch, cfg, params, batches, device)
    del params, state
    g1 = None if out["drops"] else opt.tree_map(lambda g: g.cpu(), g1)
    if device == "cuda":
        settled(torch)
    for r in range(world):
        # a step that dropped routes holds no gradient: none is saved
        grads = None if out["drops"] else sharding.shard_params(
            g1, cfg, RankOf(shape, r))
        torch.save({"out": out, "grads": grads},
                   os.path.join(tmp, f"f_{part}_r{r}.pt"))
    del g1, grads
    log(f"  (f) {part}: the unsharded run of {cfg.name} ({cfg.num_layers} "
        f"layers, {P12F_STEPS[part]} step(s)): losses "
        f"{[round(x, 5) for x in out['loss']]}, host ms a step "
        f"{[round(x, 1) for x in out['ms']]}, routes dropped "
        f"{out['drops']} ({time.perf_counter() - t:.1f} s)")
    return out


def p12f_rank(rank, world, port, tmp, part, reduced, device):
    """One rank of (f)'s ``part``: ``tp`` (LLaMA-30B at TP 2 over a 1 x 2
    mesh, then the TP-2 checkpoint of the 1-layer cut), ``dp`` (data 2 x
    model 2) or ``moe`` (qwen3-moe at EP 2 + TP 2): its shard drawn rank
    after rank, the steps (:func:`p12f_train`) under a collective clock,
    the step-1 gradients against the unsharded run's cut to the rank
    (each leaf's relative L2), the leaves every rank holds alike
    compared across the ranks. Saves ``tmp/f_{part}_rank{r}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.training import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        shape = (2, 2) if part == "dp" else (1, 2)
        mesh = make_mesh(shape, ("data", "model"), device=device)
        cfg = p12f_cfg(part, reduced)
        for r in range(world):
            if r == rank:
                params = make_params(torch, cfg, device=device, mesh=mesh)
                if device == "cuda":
                    settled(torch)
            dist.barrier()
        rt = Runtime(mesh, moe_shard_map=bool(cfg.moe_num_experts))
        t = time.perf_counter()
        with CollectiveClock(torch) as clock:
            out, g1, params, _ = p12f_train(
                torch, cfg, params, p12f_batches(cfg, P12F_STEPS[part],
                                                 reduced), device, rt)
        out.update(coll_s=clock.s, coll_n=clock.n,
                   s=time.perf_counter() - t, setup_s=t - t0)
        t = time.perf_counter()
        ref = torch.load(os.path.join(tmp, f"f_{part}_r{rank}.pt"),
                         weights_only=False)["grads"]
        out["grad_rel"] = [] if ref is None else [
            rel_l2(torch, w.to(g.device), g) for g, w in zip(
                opt.tree_leaves(g1), opt.tree_leaves(ref))]
        del g1, ref
        out["compare_s"] = time.perf_counter() - t
        # the leaves every rank holds alike: the same bytes on each
        same = []
        for kind, p in zip(opt.tree_leaves(sharding.grad_kinds(cfg, 2)),
                           opt.tree_leaves(params)):
            if kind in ("whole", "partial"):
                mine = p.detach().cpu().contiguous()
                got = [torch.empty_like(mine) for _ in range(world)]
                dist.all_gather(got, mine)
                same.append(all(torch.equal(g, got[0]) for g in got))
        out["whole_same"] = (sum(same), len(same))
        del params
        if device == "cuda":
            settled(torch)
        if part == "tp":
            t = time.perf_counter()
            out["ckpt"] = p12f_checkpoint(torch, rank, mesh, tmp, reduced,
                                          device)
            out["ckpt"]["s"] = time.perf_counter() - t
        torch.save(out, os.path.join(tmp, f"f_{part}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def p12f_checkpoint(torch, rank, mesh, tmp, reduced, device):
    """(f)'s TP-2 checkpoint: ``launch.train.run`` of the 1-layer cut at
    TP 2 for 2 steps, checkpointing after step 1 (the ranks gather each
    leaf, the first rank writes the whole state); then each rank reads it
    back at TP 1 (``load_checkpoint``: the whole state) and holds its cut
    (``restore_into``'s, the inverse of the gather) to the state it
    trained, byte for byte."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.checkpoint.sharded import tree_bytes as ckpt_bytes
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.models.transformer import Runtime
    from repro_torch.training import optimizer as opt
    B, S = (4, 32) if reduced else P12F_BATCH
    cfg = p12f_cfg("ckpt", reduced).replace(vocab_chunk=S)
    ck = os.path.join(tmp, "ck")
    argv = ["--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "1",
            "--device", device, "--batch", str(B), "--seq", str(S)]
    t = time.perf_counter()
    run = train.run(argv, cfg=cfg, rt=Runtime(mesh))
    run_s = time.perf_counter() - t
    t = time.perf_counter()
    back, step, _ = load_checkpoint(ck, train.whole_tree(cfg))
    read_s = time.perf_counter() - t
    mine = opt.tree_leaves((
        convert.params_from_numpy(back["p"], cfg, "cpu", mesh=mesh),
        convert.opt_state_from_numpy(back["o"], cfg, "cpu", mesh=mesh)))
    live = opt.tree_leaves((run["params"], run["opt_state"]))
    out = {"equal": len(mine) == len(live) and all(
               a.dtype == b.dtype and torch.equal(a, b.cpu())
               for a, b in zip(mine, live)),
           "n": len(live), "bytes": ckpt_bytes(back), "step": step,
           "read_s": read_s, "run_s": run_s, "writes": run["writes"]}
    del run, back, mine, live
    return out


def p12f_spawn(torch, part, world, tmp, reduced, device, fn="p12f_rank"):
    """Run :func:`p12f_rank` (or ``fn``, :func:`p12g_rank`) over ``world``
    processes (gloo, one card); a rank that fails ends the others.
    Returns the ranks' results (``tmp/f_{part}_rank{r}.pt``)."""
    port, root = free_port(), os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), root]))
    logs = [os.path.join(tmp, f"f_{part}_rank{r}.log") for r in range(world)]
    outs = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"{fn}({r}, {world}, {port}, {tmp!r}, {part!r}, {reduced}, "
         f"{device!r})"], cwd=root, env=env, stdout=outs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        deadline = time.perf_counter() + 600
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in outs:
            f.close()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            text = f.read()
        if p.returncode:
            for line in text.splitlines()[-40:]:
                log(f"  [(f) {part} rank {r}] {line}")
            raise AssertionError(f"(f) {part} rank {r} exited {p.returncode}")
    return [torch.load(os.path.join(tmp, f"f_{part}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def p12f_compare(part, ref, got):
    """(f)'s bounds for ``part``: every step's loss within P12F_LOSS_TOL
    relative of the unsharded run's; each leaf's step-1 gradient within
    CHUNK_REL_TOL["bfloat16"] relative L2 of the unsharded one cut to the
    rank (qwen3-moe: only where no route dropped, in either run); the
    leaves every rank holds alike, the same bytes. Returns a row."""
    tol = CHUNK_REL_TOL["bfloat16"]
    loss_rel = max(abs(a - b) / abs(b) for g in got
                   for a, b in zip(g["loss"], ref["loss"]))
    drops = [ref["drops"]] + [g["drops"] for g in got]
    held = not any(drops)
    worst = max((max(g["grad_rel"]) for g in got if g["grad_rel"]),
                default=float("nan"))
    same = [g["whole_same"] for g in got]
    row = {"part": part, "loss_rel": loss_rel, "grad_rel": worst,
           "compare_s": [round(g["compare_s"], 1) for g in got],
           "held": held, "drops": drops, "same": same,
           "ms": [g["ms"] for g in got], "coll_s": [g["coll_s"] for g in got],
           "s": [g["s"] for g in got]}
    log(f"  (f) {part}: losses {[round(x, 5) for x in got[0]['loss']]} "
        f"against {[round(x, 5) for x in ref['loss']]} (worst relative "
        f"{loss_rel:.3e}, bound {P12F_LOSS_TOL}); step-1 gradients' worst "
        f"leaf relative L2 {worst:.3e} (bound {tol}"
        f"{'' if held else ', not held: routes dropped'}); routes dropped "
        f"(unsharded, ranks) {drops}; leaves alike on every rank, equal "
        f"bytes: {same}; host ms a step {row['ms']}; gloo's collectives "
        f"{[round(x, 2) for x in row['coll_s']]} s of "
        f"{[round(x, 1) for x in row['s']]} s a rank (its train call, "
        f"after {[round(g['setup_s'], 1) for g in got]} s of set-up), "
        f"gradients compared in {row['compare_s']} s")
    if loss_rel > P12F_LOSS_TOL or (held and worst > tol) or \
            any(a != b for a, b in same):
        raise AssertionError(f"(f) {part}: the sharded step is off its "
                             f"unsharded one")
    return row


def phase12f(torch, *, device="cuda", reduced=False):
    """Phase 12 (f), the sharded training step: the world-1 check
    (:func:`p12f_world1`), then for each of LLaMA-30B at TP 2 (2 layers,
    2 steps; then the checkpoint), data 2 x model 2 (2 layers, one step)
    and qwen3-moe at EP 2 + TP 2 (one layer, one step): the unsharded run
    on the card first, freed before the ranks start, then the ranks over
    gloo. No kernel runs in training. Returns (f)'s rows. (The CPU
    rehearsal: ``device="cpu", reduced=True``.)"""
    import tempfile
    t = time.perf_counter()
    p12f_world1(torch, device, reduced)
    log(f"  (f) world 1: {time.perf_counter() - t:.1f} s")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for part, world in (("tp", 2), ("dp", 4), ("moe", 2)):
            t = time.perf_counter()
            ref = p12f_reference(torch, part, tmp, device, reduced)
            got = p12f_spawn(torch, part, world, tmp, reduced, device)
            rows.append(p12f_compare(part, ref, got))
            if part == "tp":
                ck = got[0]["ckpt"]
                (_, wbytes, wsec), = ck["writes"]
                log(f"  (f) the TP-2 checkpoint ({P12F_LAYERS['ckpt']} "
                    f"layer(s), step {ck['step']}): the 2-step run "
                    f"{ck['run_s']:.1f} s, its gathered {wbytes:,} bytes "
                    f"written in {wsec:.2f} s; read back at TP 1 in "
                    f"{[round(g['ckpt']['read_s'], 2) for g in got]} s, "
                    f"each rank's cut byte for byte its trained state: "
                    f"{[g['ckpt']['equal'] for g in got]} ({ck['n']} "
                    f"tensors a rank; "
                    f"{[round(g['ckpt']['s'], 1) for g in got]} s a rank)")
                if not all(g["ckpt"]["equal"] for g in got) or \
                        wbytes != ck["bytes"]:
                    raise AssertionError("(f) the TP-2 checkpoint differs")
            for name in os.listdir(tmp):
                if name.startswith(f"f_{part}_r") and name.endswith(".pt"):
                    os.remove(os.path.join(tmp, name))
            log(f"  (f) {part}: {time.perf_counter() - t:.1f} s")
    return rows


# -- phase 12 (g): the kv_seq decode cache, heads the axis does not split ------

# ranks, LLaMA-30B's layers kept, teacher-fed kv_seq decode steps: TP 2
# over its 52 heads, and TP 8, which does not split them (gathered: the
# attention columns cut inside heads, the prefill the qseq way)
P12G = {"tp2": (2, 4, 16), "tp8": (8, 2, 8)}
P12G_MAX_SEQ = 512      # the decode cache: 256 rows a rank at TP 2, 64 at 8


def p12g_cfg(part, reduced=False):
    from repro_torch.configs import get_config, get_reduced
    if reduced:   # the reduced 4 heads split over 8 ranks; 6 do not
        cfg = get_reduced("llama-30b")
        return cfg.replace(num_heads=6, num_kv_heads=6) if part == "tp8" \
            else cfg
    layers = 1 if part == "world1" else P12G[part][1]
    return get_config("llama-30b").replace(num_layers=layers)


def p12g_run(torch, cfg, params, device, reduced, steps, rt=None,
             teacher=None):
    """(g)'s run of ``cfg`` on this process's shard (unsharded without
    ``rt``): the model-API prefill of :func:`p12_batch`'s 4 right-padded
    prompts, their raw wires inserted into a dense decode cache of
    P12G_MAX_SEQ rows (under ``rt`` the kv_seq cache: each rank its
    share of every KV head's positions, ``insert_batch(seq_part=)``; the
    prefill's cache is its share too, gathered for the wires),
    then ``steps`` decode steps fed ``teacher``'s tokens (the unsharded
    run's greedy ones; its own without). Returns the prefill's and each
    step's last logits (f32, host), the tokens fed, the kernel launches
    and collectives of the first step."""
    from repro_torch.distributed import comm, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import build, transformer
    from repro_torch.serving import kv_transfer
    api = build(cfg, rt=rt)
    S, batch = p12_batch(torch, cfg, device, reduced)
    B = batch["tokens"].shape[0]
    start = ops.launch_counts()
    logits, pc = api.prefill(params, batch, max_seq=S)
    lens = batch["true_len"].tolist()
    part = (rt.tp.rank, rt.tp.size) if rt is not None and \
        sharding.kv_seq(api.local_cfg) else None
    pre_bytes = sum(t.numel() * t.element_size()
                    for t in pc["slot0"].values())
    if part:        # the prefill's share, gathered for the wires
        pc = kv_transfer.gather_seq(pc, rt.tp)
    wires = kv_transfer.extract_batch(pc, list(enumerate(lens)),
                                      compress=False)
    max_seq = 64 if reduced else P12G_MAX_SEQ
    cache = transformer.init_cache(api.local_cfg, B, max_seq, device=device)
    kv_transfer.insert_batch(cache, [(w, b) for b, w in enumerate(wires)],
                             seq_part=part)
    del pc, wires
    out = {"prefill": logits[:, -1].float().cpu(), "steps": [],
           "tokens": [], "prefill_cache_bytes": pre_bytes, "cache_bytes": sum(
               t.numel() * t.element_size()
               for t in cache["slot0"].values())}
    cur = logits[:, -1].argmax(-1)
    for t in range(steps):
        tok = cur if teacher is None else teacher[t].to(device)
        if t == 0:
            before, c0 = ops.launch_counts(), comm.counts()
        lg, cache = api.decode(params, cache, tok[:, None].to(torch.int32))
        if t == 0:
            out["launches"] = {k: n - before[k] for k, n in
                               ops.launch_counts().items() if n != before[k]}
            out["collectives"] = {k: n - c0.get(k, 0) for k, n in
                                  comm.counts().items()
                                  if n != c0.get(k, 0)}
        out["steps"].append(lg[:, -1].float().cpu())
        out["tokens"].append(tok.cpu())
        cur = lg[:, -1].argmax(-1)
    out["run_launches"] = {k: n - start[k] for k, n in
                           ops.launch_counts().items()}
    return out


def p12g_counted(torch, cfg, n, reduced):
    """Phase 13's count of (g)'s decode step: one rank's step over an
    abstract ``1 x n`` mesh under ``Runtime(kv_seq=True)`` on meta
    tensors (``roofline/op_cost.py``): its kernel calls and
    collectives."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import build, transformer
    from repro_torch.models.transformer import Runtime
    from repro_torch.roofline.op_cost import OpCounter
    mesh = abstract_mesh((1, n), ("data", "model"))
    api = build(cfg, rt=Runtime(mesh, kv_seq=True))
    params = transformer.init_params(cfg, device="meta", mesh=mesh)
    cache = transformer.init_cache(api.local_cfg, 4,
                                   64 if reduced else P12G_MAX_SEQ,
                                   device="meta")
    tok = torch.empty((4, 1), dtype=torch.int32, device="meta")
    with OpCounter() as c:
        api.decode(params, cache, tok)
    r = c.result()
    return r["kernels"], r["coll_counts"], r["coll_wire"]


def p12g_reference(torch, part, tmp, device, reduced):
    """The unsharded run of (g)'s ``part`` on the card, saved for its
    ranks (``tmp/g_{part}.pt``): the teacher's tokens and logits."""
    cfg = p12g_cfg(part, reduced)
    t = time.perf_counter()
    params = make_params(torch, cfg, device=device)
    out = p12g_run(torch, cfg, params, device, reduced, P12G[part][2])
    del params
    if device == "cuda":
        settled(torch)
    torch.save(out, os.path.join(tmp, f"g_{part}.pt"))
    log(f"  (g) {part}: the unsharded run of {cfg.name} ({cfg.num_layers} "
        f"layers; {time.perf_counter() - t:.1f} s)")
    return out


def p12g_rank(rank, world, port, tmp, part, reduced, device):
    """One rank of (g)'s ``part`` (``g_tp2``, ``g_tp8``): its shard of
    LLaMA-30B drawn rank after rank, :func:`p12g_run` under
    ``Runtime(kv_seq=True)`` fed the unsharded run's tokens, its peak
    memory, and phase 13's count of the step beside the step's real
    launches and collectives (:func:`p12g_counted`). Saves
    ``tmp/f_{part}_rank{r}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.training.optimizer import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    name = part[2:]
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"), device=device)
        cfg = p12g_cfg(name, reduced)
        for r in range(world):
            if r == rank:
                params = make_params(torch, cfg, device=device, mesh=mesh)
                if device == "cuda":
                    settled(torch)
            dist.barrier()
        ref = torch.load(os.path.join(tmp, f"g_{name}.pt"),
                         weights_only=False)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with CollectiveClock(torch) as clock:
            out = p12g_run(torch, cfg, params, device, reduced,
                           P12G[name][2], Runtime(mesh, kv_seq=True),
                           teacher=ref["tokens"])
        local = sharding.local_cfg(cfg, mesh, True)
        out.update(s=time.perf_counter() - t, setup_s=t - t0,
                   coll_s=clock.s, gathered=sharding.gathered(local),
                   peak=torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0,
                   param_bytes=sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
                   counted=p12g_counted(torch, cfg, world, reduced))
        del params
        torch.save(out, os.path.join(tmp, f"f_{part}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def p12g_compare(part, ref, got, device="cuda"):
    """(g)'s bounds: every rank's prefill and decode-step logits within
    CHUNK_REL_TOL (bf16 0.05) relative L2 of the unsharded run's, greedy
    tokens equal where its top-2 margin clears P12_MARGIN; phase 13's
    count of a step equal to the real step's collectives and, on the
    card, its kernel launches (the CPU runs the plain versions). Returns
    a row."""
    import torch
    tol = CHUNK_REL_TOL["bfloat16"]
    pre = max(rel_l2(torch, ref["prefill"], g["prefill"]) for g in got)
    steps = [max(rel_l2(torch, ref["steps"][t], g["steps"][t]) for g in got)
             for t in range(len(ref["steps"]))]
    clear = same = 0
    for t, want in enumerate(ref["steps"]):
        top2 = want.topk(2, dim=-1).values
        ok = (top2[:, 0] - top2[:, 1]) > P12_MARGIN
        clear += int(ok.sum())
        same += int(sum(bool((g["steps"][t].argmax(-1) == want.argmax(-1))[
            ok].all()) for g in got) == len(got)) * int(ok.sum())
    kernels, colls, wire = got[0]["counted"]
    real_k, real_c = got[0]["launches"], got[0]["collectives"]
    held = colls == real_c and (kernels == real_k or device != "cuda")
    row = {"part": part, "ranks": len(got), "prefill_rel": pre,
           "step_rel": max(steps), "tokens": (same, clear),
           "gathered": got[0]["gathered"],
           "peak": [g["peak"] for g in got],
           "param_bytes": [g["param_bytes"] for g in got],
           "cache_bytes": got[0]["cache_bytes"],
           "coll_s": [g["coll_s"] for g in got], "s": [g["s"] for g in got]}
    log(f"  (g) {part}: {len(got)} ranks "
        f"({'heads gathered' if row['gathered'] else 'heads split'}, "
        f"kv_seq cache {row['cache_bytes']:,} bytes a rank, unsharded "
        f"{ref['cache_bytes']:,}; the prefill's "
        f"{got[0]['prefill_cache_bytes']:,} a rank, unsharded "
        f"{ref['prefill_cache_bytes']:,}): prefill logits relative L2 "
        f"{pre:.3e}, "
        f"decode steps worst {max(steps):.3e} (bound {tol}; each "
        f"{[round(x, 5) for x in steps]}); greedy tokens equal where the "
        f"margin clears {P12_MARGIN}: {same}/{clear}; weights "
        f"{sum(row['param_bytes']):,} bytes over the ranks "
        f"({row['param_bytes'][0]:,} a rank), peak allocated "
        f"{sum(row['peak']):,} bytes summed over the ranks (a rank's "
        f"{row['peak']}); gloo's collectives "
        f"{[round(x, 2) for x in row['coll_s']]} s of "
        f"{[round(x, 1) for x in row['s']]} s a rank")
    log(f"  (13 g) a {part} rank's kv_seq decode step counted on meta over "
        f"an abstract 1 x {len(got)} mesh: kernels {json.dumps(kernels)}, "
        f"collectives {json.dumps(colls)} ({wire:,.0f} wire bytes); the "
        f"card's step launched {json.dumps(real_k)} and issued "
        f"{json.dumps(real_c)}: equal {held}")
    if pre > tol or max(steps) > tol or same != clear or not held:
        raise AssertionError(f"(g) {part}: off the unsharded run, or the "
                             f"count differs from the card's step")
    return row


class LocalShares:
    """A stand-in for the model axis's group with its ``size`` ranks'
    shares held in one process (:func:`p12g_shares`): ``rank`` is the
    rank being computed, ``all_gather`` hands back ``every`` (the stack of
    every rank's value, which the caller computed first), and
    ``all_reduce`` keeps each rank's term in ``terms`` and returns it
    (the caller sums them, in rank order)."""

    def __init__(self, size):
        self.size, self.rank, self.every, self.terms = size, 0, None, []

    def all_gather(self, x, dim):
        return self.every

    def all_reduce(self, x):
        self.terms.append(x)
        return x


def shares_step(torch, cfg, Ks, Vs, q, k, v, lengths, grp, owner=None):
    """One layer's kv_seq decode step over ``len(Ks)`` shares held in one
    process, as the ranks run it, from device values only: each share's
    masked write of this step's ``k``/``v`` (``transformer.seq_write``),
    its partial softmax over its rows (``transformer.seq_partial``, the
    kernel's partial mode), and the merge (``comm.merge_partials`` over
    :class:`LocalShares`). ``owner``: the negative control's write, into
    that one share only, chosen on the host (a branch a graph freezes).
    Returns the merged output (B, Hkv, g, hd) f32."""
    from repro_torch.distributed import comm
    from repro_torch.models import transformer
    R = Ks[0].shape[1]
    w_pos, kv_len = transformer.write_pos(cfg, lengths, R * len(Ks))
    parts = []
    for r, (K, V) in enumerate(zip(Ks, Vs)):
        if owner is None or r == owner:
            transformer.seq_write(K, V, k, v, w_pos, r * R)
        parts.append(transformer.seq_partial(q, K, V, kv_len, r * R))
    grp.every, grp.terms = torch.stack([lse for _, lse in parts]), []
    for r, (o, lse) in enumerate(parts):
        grp.rank = r
        comm.merge_partials(grp, o, lse)
    return torch.stack(grp.terms).sum(0)


def p12g_shares(torch, n, steps=16):
    """(g)'s graph check of the kv_seq step's own code at LLaMA-30B's step
    shape (4 slots, 52 heads of 128, bf16): :func:`shares_step` over the
    ``n`` shares of a P12G_MAX_SEQ-row cache, captured in one CUDA graph
    and replayed ``steps`` times at advancing lengths (slot 0 crosses
    from share 0 to share 1, slot 1 writes into the last share, slot 3
    starts empty, so its other shares hold no position), against the same
    steps run eagerly: every step's output and the shares at the end bit
    for bit; the shares end to end equal to the whole cache written
    plainly, bit for bit; each step's output within ``ATTN_TOL_F32`` of
    the plain version over the whole cache. Negative control: the write
    into the share that owned slot 0's row at capture, as a host branch
    would choose it, must leave the shares off the plain cache. Returns a
    row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    cfg = get_config("llama-30b")
    B, Hkv, hd, rows = 4, cfg.num_kv_heads, cfg.head_dim, P12G_MAX_SEQ
    R = rows // n
    start = [R - 6, rows - steps - 1, R // 2, 0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27 + n)
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    Kw, Vw = rand(B, rows, Hkv, hd), rand(B, rows, Hkv, hd)
    Q, Kn, Vn = (rand(steps, B, Hkv, 1, hd), rand(steps, B, Hkv, hd),
                 rand(steps, B, Hkv, hd))

    def shares():
        return ([Kw[:, r * R:(r + 1) * R].clone() for r in range(n)],
                [Vw[:, r * R:(r + 1) * R].clone() for r in range(n)])

    def static():
        return (Q[0].clone(), Kn[0].clone(), Vn[0].clone(),
                torch.tensor(start, dtype=torch.int32, device="cuda"))

    def feed(buf, t):
        for dst, src in zip(buf[:3], (Q[t], Kn[t], Vn[t])):
            dst.copy_(src)

    def graphed(owner=None):
        Ks, Vs = shares()
        buf = static()
        grp = LocalShares(n)

        def step():
            o = shares_step(torch, cfg, Ks, Vs, *buf, grp, owner=owner)
            buf[3].add_(1)
            return o

        side = torch.cuda.Stream()          # warm up off the capture
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            Kc, Vc = [K.clone() for K in Ks], [V.clone() for V in Vs]
            shares_step(torch, cfg, Kc, Vc, *buf, grp, owner=owner)
        torch.cuda.current_stream().wait_stream(side)
        del Kc, Vc
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = step()
        outs = []
        for t in range(steps):
            feed(buf, t)
            g.replay()
            outs.append(out.clone())
        torch.cuda.synchronize()
        return outs, Ks, Vs

    Ks, Vs = shares()
    buf, grp = static(), LocalShares(n)
    eager = []
    for t in range(steps):
        feed(buf, t)
        eager.append(shares_step(torch, cfg, Ks, Vs, *buf, grp))
        buf[3].add_(1)
    got, Kg, Vg = graphed()
    owner = start[0] // R
    _, Kx, Vx = graphed(owner)
    # the plain cache: each step's k/v at its slot's row, then attention
    Kp, Vp = Kw.clone(), Vw.clone()
    worst, lens = 0.0, torch.tensor(start, device="cuda")
    for t in range(steps):
        b = torch.arange(B, device="cuda")
        Kp[b, lens], Vp[b, lens] = Kn[t], Vn[t]
        lens = lens + 1
        want = ref.decode_attention_ref(
            Q[t].float(), Kp.permute(0, 2, 1, 3), Vp.permute(0, 2, 1, 3),
            kv_len=lens.to(torch.int32), return_lse=True)[0]
        ok, w = attn_close(torch, eager[t], want)
        worst = max(worst, w)
        if not ok:
            raise AssertionError(f"(g) shares n={n}: step {t} off the "
                                 f"plain version ({w:.3g} of its tol)")
    same_out = all(torch.equal(a, b) for a, b in zip(got, eager))
    same_shares = all(torch.equal(a, b) for a, b in zip(Kg + Vg, Ks + Vs))
    plain = torch.equal(torch.cat(Kg, 1), Kp) and \
        torch.equal(torch.cat(Vg, 1), Vp)
    control = torch.equal(torch.cat(Kx, 1), Kp) and \
        torch.equal(torch.cat(Vx, 1), Vp)
    crossed = sorted({(s + t) // R for s in start for t in range(steps)})
    log(f"  (g) the kv_seq step's device half over {n} shares of a "
        f"{rows}-row cache in one process (seq_write, the partial mode, "
        f"merge_partials over a stand-in group), one CUDA graph replayed "
        f"{steps} times from lengths {start} (shares written: {crossed}): "
        f"outputs bit for bit the eager steps: {same_out}; shares bit for "
        f"bit: {same_shares}; end to end the plain cache: {plain}; worst "
        f"|err| / tol against the plain attention {worst:.3g} "
        f"({ATTN_TOL_TEXT['float32']}); negative control (the write into "
        f"share {owner} only, as a host branch at capture would pick it): "
        f"the plain cache {control}, rejected: {not control}")
    if not (same_out and same_shares and plain) or control:
        raise AssertionError(f"(g) shares n={n}: the graphed kv_seq step "
                             f"differs from the eager one or the plain "
                             f"cache, or the control passed")
    return {"n": n, "steps": steps, "worst": worst}


def phase12g(torch, *, device="cuda", reduced=False):
    """Phase 12 (g), the kv_seq decode cache and heads the model axis does
    not split: a world-1 NCCL mesh under ``Runtime(kv_seq=True)``
    (LLaMA-30B cut to one layer, :func:`mesh_world1` on the dense cache:
    the graphed chunk bit for bit the unmeshed one; at axis size 1 that
    is the head-split step); the kv_seq step's own code graphed over 2
    and 8 shares held in one process (:func:`p12g_shares`); LLaMA-30B at
    TP 2 (4 layers, 16 kv_seq steps) and at TP 8 (2 layers, its 52 heads
    gathered, a qseq prefill and 8 kv_seq steps), gloo ranks on the one
    card against the unsharded run of each cut. Returns (the kernel
    launches of its runs, its rows). (The CPU rehearsal: ``device="cpu",
    reduced=True``.)"""
    import tempfile
    t = time.perf_counter()
    cfg = p12g_cfg("world1", reduced)
    params = make_params(torch, cfg, device=device)
    launches = mesh_world1(torch, cfg, params, device, name="(g)",
                           kv_seq=True)[0]
    del params
    if device == "cuda":
        settled(torch)
    log(f"  (g) world 1: {time.perf_counter() - t:.1f} s")
    rows = []
    if device == "cuda":        # CUDA graphs: the card only
        t = time.perf_counter()
        rows += [p12g_shares(torch, n) for n in (2, 8)]
        log(f"  (g) the kv_seq step graphed over shares: "
            f"{time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        for part, (world, _, _) in P12G.items():
            t = time.perf_counter()
            ref = p12g_reference(torch, part, tmp, device, reduced)
            got = p12f_spawn(torch, f"g_{part}", world, tmp, reduced, device,
                             fn="p12g_rank")
            rows.append(p12g_compare(part, ref, got, device))
            for g in got:
                launches = {k: launches.get(k, 0) + n for k, n in
                            g["run_launches"].items()}
            log(f"  (g) {part}: {time.perf_counter() - t:.1f} s")
    return launches, rows


# -- phase 13: the counts against the card ------------------------------------

P13_ARCHS = ("llama-30b", "qwen3-moe-235b-a22b")
P13_PS, P13_SEQ = 16, 256          # phase 5's pages and max_seq
P13_BUCKET = 256                   # phase 5's prefill bucket, 4 prompts
# left out of the four chain, by name: xlstm's per-token sLSTM loop over
# 32768 tokens takes ~11 minutes on the host; tests/test_torch_dryrun.py
# counts its four-mesh prefill at 2 x 64 tokens
P13_SKIP = (("xlstm-125m", "prefill_32k"), ("xlstm-125m", "train_4k"))
# the chains of phase 13(c): the two meshes' serving cells, and the train
# cells at four in a chain of their own (25-45 s each on the host, a
# sharded forward and backward on meta), started at phase 1
P13_CHAINS = ("one", "four", "four-train")


def p13_cells(chain):
    """The (arch, shape) cells phase 13(c) dry-runs in ``chain``: at
    ``one`` only LLaMA-30B's and qwen3-moe's (``--all`` takes ~25 min on
    the host there, ~19 of them xlstm's per-token sLSTM loop); at
    ``four`` every cell of ``all_cells()`` but ``P13_SKIP`` and the train
    cells, and LLaMA-30B's; ``four-train`` the train cells at ``four``
    (LLaMA-30B's too) but ``P13_SKIP``'s."""
    from repro_torch.configs import all_cells, get_config
    mine = [(a, s) for a in P13_ARCHS for s in get_config(a).shape_cells()]
    if chain == "one":
        return mine
    cells = [c for c in all_cells()[0] if c not in P13_SKIP]
    cells += [c for c in mine if c not in cells]
    train = chain == "four-train"
    return [c for c in cells if (c[1] == "train_4k") == train]


def dryrun_start(tmp, chains):
    """Phase 13(c), started early: the dry-run's CLI
    (``launch/dryrun.py: main``, ``--arch --shape --mesh --force``) over
    each cell of :func:`p13_cells`, one process a chain of ``chains``
    running its cells in turn, side by side on the host (meta tensors: no
    device work). Returns the processes and their log paths."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = []
    atexit.register(_stop, procs)
    for chain in chains:
        mesh = chain.split("-")[0]
        argv = [["--arch", a, "--shape", s, "--mesh", mesh, "--force"]
                for a, s in p13_cells(chain)]
        code = ("from repro_torch.launch import dryrun\n"
                f"for argv in {argv!r}:\n    dryrun.main(argv)")
        path = os.path.join(tmp, f"dryrun_{chain}.log")
        out = open(path, "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       cwd=root, env=env, stdout=out,
                                       stderr=subprocess.STDOUT),
                      out, path, chain))
    return procs


def _stop(procs):
    """Kill what is left of the dry-run's chains (a failed phase exits
    before :func:`dryrun_finish` waits for them)."""
    for p, out, _, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()


def dryrun_finish(procs, timeout=900):
    """Wait for :func:`dryrun_start`'s chains; print their logs. The
    chains' own exit codes say whether a cell failed (a refused cell at
    ``four`` is an expected error): the records decide."""
    for p, out, path, mesh in procs:
        try:
            p.wait(timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
        with open(path) as f:
            for line in f.read().splitlines():
                if line.startswith(("[ok]", "[FAIL]")):
                    log(f"  {line[:150]}")


def p13_dryrun(procs, t0):
    """Phase 13(c)'s end: wait for the chains, then hold their records
    (every cell ``ok``: a train cell over a model axis counts the sharded
    step) and print ``report.table`` of each mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    dryrun_finish(procs)
    log(f"  (c): the dry-run's chains ended {time.perf_counter() - t0:.1f}"
        f" s after the first started; left out at four, by name: "
        f"{', '.join(f'{a} x {s}' for a, s in P13_SKIP)} (its per-token "
        f"sLSTM loop; tests/test_torch_dryrun.py and "
        f"tests/test_torch_train_sharded.py count them reduced)")
    for mesh in ("one", "four"):
        recs = [dryrun.run_cell(arch, shape, mesh)
                for chain in P13_CHAINS if chain.split("-")[0] == mesh
                for arch, shape in p13_cells(chain)]
        bad = [r for r in recs if r["status"] != "ok"]
        n_train = sum(r["shape"] == "train_4k" for r in recs)
        log(f"  {mesh}: {len(recs) - len(bad)} of {len(recs)} cells ok "
            f"({n_train} train cells)")
        log(f"  report.table({mesh!r}), counted from shapes against the "
            f"H100's published peaks (not measured):")
        for line in report.table(mesh).splitlines():
            log(f"    {line}")
        if bad:
            raise AssertionError(f"dry-run cells failed at {mesh}: "
                                 f"{[(r['arch'], r['shape']) for r in bad]}")


def p13_count(torch, fn, *args):
    """``roofline/op_cost.py``'s count of ``fn(*args)`` on meta tensors
    (what ``launch/dryrun.py`` runs), and the host seconds it took."""
    from repro_torch.roofline.op_cost import OpCounter
    t = time.perf_counter()
    with OpCounter() as c:
        fn(*args)
    return c.result(), time.perf_counter() - t


def p13_real(torch, fn, *args):
    """The real eager run of ``fn(*args)`` on the card under
    ``FlopCounterMode``: (its matmul FLOPs, the kernel launches it made,
    the rise of ``max_memory_allocated`` over the memory before it)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    rise = torch.cuda.max_memory_allocated() - base
    return (fc.get_total_flops(),
            {k: after[k] - before[k] for k in after if after[k] != before[k]},
            rise)


def graph_replay_ms(torch, fn, reps=5):
    """Median ms of one CUDA-graph replay of ``fn()`` (captured once after
    a warm-up on the capture stream; the kernel wrappers' launch counts
    are restored after the capture, which ran nothing), each replay
    between CUDA events."""
    from repro_torch.kernels import ops
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = ops.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    for name, n in before.items():
        ops.KERNELS[name].launches = n
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return float(np.median(times))


def eager_call_ms(torch, fn, reps=3):
    """Median ms of an eager call of ``fn()`` between CUDA events, after
    one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def p13_hold(name, counted, real_flops, real_launches, arg_meta, arg_real):
    """Phase 13(a)'s three equalities for one step: the counted matmul
    FLOPs against ``FlopCounterMode``'s, the counted kernel calls against
    the real launches, the counted argument bytes against the real
    tensors'."""
    mm = counted["by_class"].get("matmul", {}).get("flops", 0)
    log(f"  {name}: matmul FLOPs counted on meta {mm:,}, FlopCounterMode on "
        f"the card {real_flops:,}; kernel calls counted {counted['kernels']}"
        f", launched {real_launches}; argument bytes counted {arg_meta:,}, "
        f"real {arg_real:,}")
    if mm != real_flops:
        raise AssertionError(f"{name}: counted matmul FLOPs {mm} != "
                             f"FlopCounterMode's {real_flops}")
    if counted["kernels"] != real_launches:
        raise AssertionError(f"{name}: counted kernel calls "
                             f"{counted['kernels']} != launches "
                             f"{real_launches}")
    if arg_meta != arg_real:
        raise AssertionError(f"{name}: counted argument bytes {arg_meta} != "
                             f"the real tensors' {arg_real}")


def p13_clock(name, counted, ms, shape, cfg, *, held):
    """Phase 13(b) for one step: the roofline time on the H100
    (``roofline/analysis.py``) beside the measured time, their ratio and
    the whole-step share ``model_flops_for / (measured s x 989e12)``.
    ``held``: the roofline time must not exceed the measured one."""
    from repro_torch.roofline import analysis
    mf = analysis.model_flops_for(cfg, shape)
    roof = analysis.analyze(counted, arch=cfg.name, shape=shape.name,
                            mesh_desc="card", n_chips=1, model_flops=mf)
    share = mf / (ms * 1e-3 * H100.peak_flops)
    log(f"  {name}: counted {roof.hlo_flops:.4e} FLOPs, {roof.hlo_bytes:.4e} "
        f"bytes; roofline {roof.step_s * 1e3:.3f} ms ({roof.bottleneck}: "
        f"compute {roof.compute_s * 1e3:.3f}, memory "
        f"{roof.memory_s * 1e3:.3f} ms) against {ms:.3f} ms measured, "
        f"ratio {roof.step_s * 1e3 / ms:.3f}; model_flops_for "
        f"{mf:.4e} at {shape} -> whole-step share "
        f"{100 * share:.2f}% of {H100.peak_flops / 1e12:.0f} TFLOP/s")
    if held and roof.step_s * 1e3 > ms:
        raise AssertionError(f"{name}: the roofline time "
                             f"{roof.step_s * 1e3:.3f} ms exceeds the "
                             f"measured {ms:.3f} ms: the count claims more "
                             f"work than the card did")
    return {"roofline_ms": roof.step_s * 1e3, "ms": ms,
            "ratio": roof.step_s * 1e3 / ms, "share": share,
            "flops": roof.hlo_flops, "bytes": roof.hlo_bytes}


def p13_serve(torch, smi, device="cuda"):
    """Phase 13(a) and (b) for LLaMA-30B's main path at full width, on
    weights made as phase 5 makes them (``full_model``'s seed): the int4
    paged decode step at 4 slots (``P13_PS``-token pages, ``P13_SEQ``
    positions, kv_len ``DECODE_LENS`` + 1) and one bucket prefill of 4 x
    ``P13_BUCKET`` through the model API and the wire (the prefill
    engine's ``_run_one_bucket`` without its first-token read)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models import paged, registry, transformer
    from repro_torch.serving import kv_transfer
    cfg = get_config("llama-30b")
    api = registry.build(cfg)
    step_fn, _ = api.paged_decode_fns(P13_PS)
    W = paged.table_width(P13_SEQ, P13_PS)
    n_pages = 4 * W + 1
    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)

    def decode_args(dev):
        cache = paged.init_paged_cache(cfg, 4, P13_SEQ, n_pages,
                                       page_size=P13_PS, device=dev)
        tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
        if dev != "meta":
            for key, t in cache["slot0"].items():
                if t.dtype == torch.uint8:
                    t.copy_(torch.randint(0, 256, t.shape, generator=gen,
                                          device=dev, dtype=torch.uint8))
                else:
                    t.copy_(torch.rand(t.shape, generator=gen, device=dev))
            cache["page_table"].copy_(torch.arange(
                1, n_pages, dtype=torch.int32, device=dev).view(4, W))
            cache["lengths"].copy_(torch.tensor(DECODE_LENS,
                                                dtype=torch.int32))
            tok.random_(0, cfg.vocab_size, generator=gen)
        return cache, tok

    def prefill(params, batch):
        _, cache = api.prefill(params, batch, max_seq=P13_SEQ)
        return kv_transfer.extract_batch(
            cache, [(i, P13_BUCKET) for i in range(4)], pad_to=P13_BUCKET)

    def prefill_batch(dev):
        tok = torch.zeros((4, P13_BUCKET), dtype=torch.int64, device=dev)
        if dev != "meta":
            tok.random_(0, cfg.vocab_size, generator=gen)
        return {"tokens": tok,
                "last_pos": torch.full((4,), P13_BUCKET - 1,
                                       dtype=torch.int64, device=dev),
                "true_len": torch.full((4,), P13_BUCKET, dtype=torch.int32,
                                       device=dev)}

    # the counts on meta first: no device memory, no kernel
    mparams = transformer.init_params(cfg, device="meta")
    mcache, mtok = decode_args("meta")
    c_dec, s_dec = p13_count(torch, step_fn, mparams, mcache, mtok)
    mbatch = prefill_batch("meta")
    c_pre, s_pre = p13_count(torch, prefill, mparams, mbatch)
    log(f"  counted on meta in {s_dec:.1f} s (decode step) and {s_pre:.1f} s "
        f"(prefill); traced peaks {c_dec['peak_bytes']:,} / "
        f"{c_pre['peak_bytes']:,} bytes")
    a_dec = tree_bytes([mparams, mcache, mtok])[1]
    a_pre = tree_bytes([mparams, mbatch])[1]
    del mparams, mcache, mbatch

    params, _ = full_model(torch, cfg, device=device)
    cache, tok = decode_args(device)
    step_fn(params, cache, tok)                     # warm
    f_dec, l_dec, rise_dec = p13_real(torch, step_fn, params, cache, tok)
    p13_hold("decode step", c_dec, f_dec, l_dec,
             a_dec, tree_bytes([params, cache, tok])[1])
    log(f"  decode step: traced peak {c_dec['peak_bytes']:,} bytes beside "
        f"max_memory_allocated's rise {rise_dec:,} bytes")
    read = step_read_bytes(cfg, params)
    log(f"  decode step: counted bytes {c_dec['bytes']:,} against "
        f"step_read_bytes {read:,}")
    if c_dec["bytes"] < read:
        raise AssertionError(f"the decode step's counted bytes "
                             f"{c_dec['bytes']} are fewer than the bytes "
                             f"it must read ({read})")
    ms = graph_replay_ms(torch, lambda: step_fn(params, cache, tok))
    log(smi)
    out["decode"] = p13_clock(
        "decode step (one graph replay)", c_dec, ms,
        ShapeSpec("decode_4x256", P13_SEQ, 4, "decode"), cfg, held=True)
    del cache, tok

    batch = prefill_batch(device)
    f_pre, l_pre, rise_pre = p13_real(torch, prefill, params, batch)
    p13_hold("bucket prefill", c_pre, f_pre, l_pre,
             a_pre, tree_bytes([params, batch])[1])
    log(f"  bucket prefill: traced peak {c_pre['peak_bytes']:,} bytes "
        f"beside max_memory_allocated's rise {rise_pre:,} bytes")
    ms = eager_call_ms(torch, lambda: prefill(params, batch))
    out["prefill"] = p13_clock(
        "bucket prefill (eager, CUDA events)", c_pre, ms,
        ShapeSpec("prefill_4x256", P13_BUCKET, 4, "prefill"), cfg,
        held=True)
    del params, batch
    return out


def p13_train(torch, smi, device="cuda"):
    """Phase 13(a) and (b) for phase 11's train step: LLaMA-30B at full
    width cut to ``TRAIN_LAYERS`` layers, batch 4 x 512, one
    ``make_train_step`` step (loss, autograd, AdamW in place). The
    roofline ratio is printed, not held: its many small f32 ops can hit
    L2."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, PackedLM
    cfg = get_config("llama-30b").replace(num_layers=TRAIN_LAYERS)
    api = build(cfg)
    step = opt.make_train_step(api, opt.AdamWConfig())
    b = PackedLM(DataConfig(cfg.vocab_size, 512, 4)).batch_at(0)

    def state(dev):
        params = train.make_params(cfg, dev)
        return params, opt.adamw_init(params), {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    mp, ms_, mb = state("meta")
    counted, secs = p13_count(torch, step, mp, ms_, mb)
    a_meta = tree_bytes([mp, ms_, mb])[1]
    log(f"  train step counted on meta in {secs:.1f} s; traced peak "
        f"{counted['peak_bytes']:,} bytes")
    del mp, ms_, mb
    params, st, batch = state(device)
    a_real = tree_bytes([params, st, batch])[1]
    f_real, l_real, rise = p13_real(torch, step, params, st, batch)
    p13_hold("train step", counted, f_real, l_real, a_meta, a_real)
    log(f"  train step: traced peak {counted['peak_bytes']:,} bytes beside "
        f"max_memory_allocated's rise {rise:,} bytes")
    ms = eager_call_ms(torch, lambda: step(params, st, batch), reps=2)
    log(smi)
    out = p13_clock("train step (eager, CUDA events)", counted, ms,
                    ShapeSpec("train_4x512", 512, 4, "train"), cfg,
                    held=False)
    del params, st, batch
    return out


# -- phase 14: the analysis package and the last model options ---------------

P14_CAP = 50.0          # (b): the logit softcap gemma-2b is served with
P14_WINDOW = 4096       # (c): jamba's long_500k window
P14_PROMPT = 4200       # (c): a prompt past the window
P14_LAYERS = {"scope": 2, "jamba": 16, "hkv_s": 4}   # depth cuts
# the kernels each new path must launch (the engines' wire: kv_quant at
# extraction, kv_dequant at insertion)
P14_KERNELS = {
    "softcap": ("flash_attention", "decode_attention", "rmsnorm",
                "add_rmsnorm", "kv_quant", "kv_dequant"),
    "window": ("flash_attention", "decode_attention", "rmsnorm",
               "add_rmsnorm"),
    "hkv_s": ("flash_attention", "decode_attention", "rmsnorm",
              "add_rmsnorm", "kv_quant", "kv_dequant"),
}


def analysis_start():
    """Phase 14 (a)'s host half, started at phase 1 beside the card's
    work: the CLI ``python -m repro_torch.analysis lint --strict`` and
    ``check --quick --mutations --replay`` over this checkout, one
    process each."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {}
    for name, argv in (("lint", ["lint", "--strict"]),
                       ("check", ["check", "--quick", "--mutations",
                                  "--replay"])):
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", *argv], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    atexit.register(lambda: [p.kill() for _, p in procs.values()
                             if p.poll() is None])
    return procs


def analysis_finish(procs):
    """Phase 14 (a): both must exit 0; the check must catch all 8 planted
    bugs, each with its replay confirmed."""
    for name, (t0, proc) in procs.items():
        out, _ = proc.communicate(timeout=600)
        lines = out.strip().splitlines()
        for line in lines[-4:] if name == "lint" else [
                x for x in lines if x.startswith(("check[", "mutation "))]:
            log(f"    {line}")
        log(f"  analysis {name}: exit {proc.returncode} ({len(lines)} lines "
            f"of output, started at phase 1)")
        if proc.returncode != 0:
            raise AssertionError(f"analysis {name} failed:\n{out[-3000:]}")
        if name == "check" and (
                "all 8 planted bugs caught" not in out
                or out.count("replay confirmed") != 8):
            raise AssertionError(f"analysis check: a planted bug missed or "
                                 f"not replayed:\n{out[-3000:]}")


def p14_scope(torch, device="cuda", reduced=False):
    """Phase 14 (a): R002's reachable set against a real capture. A
    LLaMA-30B decode chunk (full width, cut to 2 layers: the functions a
    chunk runs do not depend on the depth) captured as a CUDA graph
    (``registry.GraphedDecodeChunk``) on the dense cache and on int4
    pages, its chunk function run under ``sys.setprofile``
    (``analysis.lint.trace_calls``): every function of ``src/repro_torch``
    that ran during the capture must be in ``lint.captured_functions``.
    On the CPU (``reduced``, a rehearsal) the eager chunk is traced."""
    from repro_torch.analysis import lint
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import paged, registry, transformer
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_reduced("llama-30b") if reduced else \
        get_config("llama-30b").replace(num_layers=P14_LAYERS["scope"])
    params = make_params(torch, cfg, device=device)
    api = registry.build(cfg)
    t = time.perf_counter()
    held = lint.captured_functions(root)
    log(f"  R002's reachable set: {len(held)} functions and lambdas "
        f"({time.perf_counter() - t:.1f} s)")
    state = {k: torch.zeros((4,), dtype=torch.bool if k == "active"
                            else torch.int32, device=device)
             for k in registry.STATE_KEYS}
    for what in ("dense", "int4"):
        if what == "dense":
            cache = transformer.init_cache(cfg, 4, 256, device=device)
            step_fn, chunk_fn = api.decode, api.decode_chunk
        else:
            cache = paged.init_paged_cache(cfg, 4, 256, 65, page_size=16,
                                           device=device)
            step_fn, chunk_fn = api.paged_decode_fns(16)
        seen = {}

        def traced(*a, _fn=chunk_fn, **kw):
            out, seen["ran"] = lint.trace_calls(_fn, *a, root=root, **kw)
            return out

        t = time.perf_counter()
        if device == "cuda":
            g = registry.GraphedDecodeChunk(step_fn, traced, params, cache,
                                            4)
            g.capture(params, cache, n_steps=2, eos_id=-1, max_seq=256)
            del g
        else:
            traced(params, cache, state, n_steps=2, eos_id=-1, max_seq=256)
        ran = seen["ran"]
        missing = sorted(f for f in ran if f[:2] not in held)
        log(f"  {cfg.name} {what} decode chunk "
            f"{'captured' if device == 'cuda' else 'run eagerly'} under "
            f"sys.setprofile in {time.perf_counter() - t:.1f} s: "
            f"{len(ran)} functions of src/repro_torch ran, "
            f"{len(ran) - len(missing)} of them in R002's reachable set")
        if missing or len(ran) < 20:
            raise AssertionError(f"R002's scope misses what the capture "
                                 f"ran: {missing}")
        del cache


def serve_pair(torch, cfg, params, pre, mode, spec, max_seq, device):
    """A graphed and an eager decode engine (:class:`Pair`) of ``mode``
    through ``spec``'s (prompt tokens, new tokens) requests, in lockstep
    (equal tokens, state and cache bytes after every admission and
    chunk). Returns the graphed arm's requests."""
    from repro_torch.serving import engine as E
    pair = Pair(torch, cfg, params, mode, device, max_seq=max_seq)
    rng = np.random.default_rng(SEED)
    reqs = [pair.request(i, rng.integers(1, cfg.vocab_size, n), m)
            for i, (n, m) in enumerate(spec)]
    out = pre.run(reqs)
    pair.admit(lambda arm: [E.AdmissionItem(pair.reqs[arm][r.rid], f,
                                            wire=w) for r, w, f in out])
    pair.step()
    for r in pair.reqs["graph"].values():
        toks = np.asarray(r.out_tokens)
        if len(toks) != r.max_new_tokens or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name} {mode}: bad tokens {toks}")
    if device == "cuda" and pair.dec["graph"].jit_cache_size != 1:
        raise AssertionError(f"{cfg.name} {mode}: not one graph")
    return pair


def counted(name, got):
    """Fail unless every kernel of path ``name`` (``P14_KERNELS``) was
    launched in its run (``got``: the counts read after it)."""
    missing = [k for k in P14_KERNELS[name] if not got.get(k)]
    log(f"  ({name}) launches: {json.dumps({k: n for k, n in got.items() if n})}")
    if missing:
        raise AssertionError(f"({name}) never launched {missing}")


def p14_softcap(torch, device="cuda", reduced=False):
    """Phase 14 (b): gemma-2b, all 18 layers at full width, served with a
    logit softcap of ``P14_CAP`` through ``PrefillEngine`` and the dense
    ``DecodeEngine`` (a capped config cannot page), graphed and eager in
    lockstep; its prefill logits differ from the uncapped model's (the
    cap is on). Returns the path's launch counts (set to 0 before the
    engines run, read after)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import engine as E
    base = get_reduced("gemma-2b") if reduced else get_config("gemma-2b")
    cfg = base.replace(attn_logit_softcap=P14_CAP)
    params = make_params(torch, cfg, device=device)
    pre = prefill_engine(torch, cfg, params, max_seq=256, device=device)
    spec = ((40, 16), (100, 24), (200, 32))
    if reduced:
        spec = tuple((min(n, 60), m) for n, m in spec)
    ops.reset_launches()
    # the engines ask for pages: a capped config falls back to the dense
    # cache, as the reference's does
    pair = serve_pair(torch, cfg, params, pre, "int4", spec, 256, device)
    if device == "cuda":
        torch.cuda.synchronize()
    got = ops.launch_counts()
    dec = pair.dec["graph"]
    if dec.paged or "cannot page" not in (dec.paged_fallback or ""):
        raise AssertionError(f"{cfg.name} softcap: paged {dec.paged}")
    log(f"  {cfg.name} softcap {P14_CAP}: {cfg.num_layers} layers, "
        f"{sum(len(r.out_tokens) for r in pair.reqs['graph'].values())} "
        f"tokens on the dense cache, graphed == eager after every "
        f"admission and chunk ({pair.n_chunks} chunks); paged_fallback "
        f"{dec.paged_fallback!r}")
    del pair
    tok = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (1, 64)), device=device)
    capped = registry.build(cfg).prefill(params, {"tokens": tok})[0]
    plain = registry.build(base).prefill(params, {"tokens": tok})[0]
    gap = float((capped - plain).abs().max())
    log(f"  {cfg.name}: prefill logits capped vs uncapped max |diff| "
        f"{gap:.3e}")
    if not gap > 1e-3:
        raise AssertionError(f"{cfg.name}: the softcap changed nothing")
    return got


def p14_window(torch, device="cuda", reduced=False):
    """Phase 14 (c): jamba, full width cut to 16 of 32 layers (phase 10's
    cut), with a ``P14_WINDOW`` sliding window (its long_500k cell):
    a ``P14_PROMPT``-token prompt through the model API keeps the last
    ``window`` positions of each attention layer, rotated so position p
    sits at row ``p % window``: the first attention layer's ring equals
    the unwindowed prefill's rows rolled, bit for bit (its input does not
    depend on the window). A decode step over the ring through the
    kernel is held to the same step with the plain attention
    (``ref.decode_attention_ref``). Then the engines (a graphed and an
    eager dense decode engine, the ring as their cache) decode after the
    long prompt and a short one. Returns the engines' launch counts."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops, ref
    from repro_torch.models import registry, transformer
    if reduced:
        cfg = get_reduced("jamba-v0.1-52b").replace(sliding_window=8)
        n_prompt, max_seq = 20, 64
    else:
        cfg = get_config("jamba-v0.1-52b").replace(
            num_layers=P14_LAYERS["jamba"], sliding_window=P14_WINDOW)
        n_prompt, max_seq = P14_PROMPT, 8192
    W = cfg.sliding_window
    params = make_params(torch, cfg, device=device)
    rng = np.random.default_rng(SEED)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n_prompt)),
                          device=device)
    api = registry.build(cfg)
    t = time.perf_counter()
    logits, ring = api.prefill(params, {"tokens": tok}, max_seq=max_seq)
    _, full = registry.build(cfg.replace(sliding_window=0)).prefill(
        params, {"tokens": tok}, max_seq=max_seq)
    s0 = next(s for s, k in enumerate(transformer.slot_kinds(cfg))
              if k.startswith("attn"))
    for key in ("k", "v"):
        got = ring[f"slot{s0}"][key]
        want = torch.roll(full[f"slot{s0}"][key][:, :, -W:],
                          n_prompt % W, dims=2)
        if got.shape[2] != W or not torch.equal(got[0], want[0]):
            raise AssertionError(f"{cfg.name}: the {key} ring is not the "
                                 f"last {W} rows rotated")
    del full
    log(f"  {cfg.name} window {W}: a {n_prompt}-token prompt prefilled "
        f"twice ({time.perf_counter() - t:.1f} s); slot{s0}'s ring of "
        f"{W} rows == the unwindowed prefill's last {W} rows rolled by "
        f"{n_prompt % W}, bit for bit")
    cache = transformer.init_cache(cfg, 1, max_seq, device=device)
    for name, slot in ring.items():
        if name == "lengths":
            cache[name].copy_(slot)
            continue
        for key, t_ in slot.items():
            cache[name][key].copy_(t_)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    steps, ran = {}, {}
    for route in ("kernel", "plain"):
        c = {n: s.clone() if n == "lengths" else
             {k: t_.clone() for k, t_ in s.items()}
             for n, s in cache.items()}
        before = ops.launch_counts()["decode_attention"]
        if route == "kernel":
            steps[route] = api.decode(params, c, nxt)[0]
        else:
            kernel = ops.decode_attention
            ops.decode_attention = lambda q, k, v, kv_len, **kw: \
                ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                         softcap=kw.get("softcap", 0.0))
            try:
                steps[route] = api.decode(params, c, nxt)[0]
            finally:
                ops.decode_attention = kernel
        ran[route] = ops.launch_counts()["decode_attention"] - before
    if device == "cuda" and (ran["plain"] or not ran["kernel"]):
        raise AssertionError(f"{cfg.name}: decode kernel launches by "
                             f"route {ran}")
    a, b = steps["kernel"].float(), steps["plain"].float()
    rel = float((a - b).norm() / b.norm())
    log(f"  {cfg.name}: a decode step over the ring, kernel ({ran['kernel']}"
        f" launches) vs plain attention ({ran['plain']}): rel L2 "
        f"{rel:.3e}, top-1 equal {bool((a.argmax(-1) == b.argmax(-1)).all())}")
    if rel > 2e-2:
        raise AssertionError(f"{cfg.name}: the ring's decode step differs "
                             f"from the plain attention's")
    del cache, ring, steps, a, b
    pre = prefill_engine(torch, cfg, params, max_seq=max_seq, device=device)
    spec = ((n_prompt, 24), (100 if not reduced else 12, 16))
    ops.reset_launches()
    pair = serve_pair(torch, cfg, params, pre, "int4", spec, max_seq, device)
    if device == "cuda":
        torch.cuda.synchronize()
    got = ops.launch_counts()
    dec = pair.dec["graph"]
    rows = dec.cache[f"slot{s0}"]["k"].shape[2]
    log(f"  {cfg.name} engines: paged_fallback {dec.paged_fallback!r}, a "
        f"{rows}-row ring; prompts {[n for n, _ in spec]}, graphed == "
        f"eager after every admission and chunk ({pair.n_chunks} chunks)")
    if dec.paged or rows != W:
        raise AssertionError(f"{cfg.name}: no {W}-row ring")
    return got


def p14_hkv_s(torch, device="cuda", reduced=False):
    """Phase 14 (d): LLaMA-30B at full width cut to 4 layers, served
    through ``PrefillEngine`` and a graphed dense ``DecodeEngine`` on the
    s_hkv cache and on the hkv_s cache (the reference's (L, B, Hkv, S,
    hd), held as its transposed view): equal tokens and equal cache bytes;
    then four model-API decode steps on each layout from one prefill:
    equal logits, bit for bit. Returns the hkv_s run's launch counts."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import registry, transformer
    from repro_torch.serving import engine as E
    base = get_reduced("llama-30b") if reduced else \
        get_config("llama-30b").replace(num_layers=P14_LAYERS["hkv_s"])
    params = make_params(torch, base, device=device)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, base.vocab_size, n) for n in (40, 100, 200)]
    tok = torch.as_tensor(rng.integers(1, base.vocab_size, (2, 48)),
                          device=device)
    out, got = {}, {}
    for layout in ("s_hkv", "hkv_s"):
        cfg = base.replace(decode_cache_layout=layout)
        pre = prefill_engine(torch, cfg, params, max_seq=256, device=device)
        ops.reset_launches()
        dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=256,
                             chunk_size=8, paged=False, device=device)
        reqs = [E.GenRequest(i, p, 24) for i, p in enumerate(prompts)]
        if dec.admit(E.AdmissionBatch([E.AdmissionItem(r, f, wire=w)
                                       for r, w, f in pre.run(reqs)])):
            raise AssertionError(f"{layout}: admission rejected")
        while dec.active:
            dec.step()
        if device == "cuda":
            torch.cuda.synchronize()
        got[layout] = ops.launch_counts()
        api = registry.build(cfg)
        logits, pc = api.prefill(params, {"tokens": tok})
        c = transformer.init_cache(cfg, 2, 256, device=device)
        for key in ("k", "v"):
            c["slot0"][key][:, :, :48] = pc["slot0"][key]
        c["lengths"].copy_(pc["lengths"])
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        steps = []
        for _ in range(4):
            lg, c = api.decode(params, c, cur)
            steps.append(lg)
            cur = torch.argmax(lg[:, -1], dim=-1)[:, None]
        k = dec.cache["slot0"]["k"]
        out[layout] = ([r.out_tokens for r in reqs], k.contiguous(),
                       torch.stack(steps), k.stride())
        del dec, c, pc
    (ta, ka, la, sa), (tb, kb, lb, sb) = out["s_hkv"], out["hkv_s"]
    same = (ta == tb, torch.equal(ka, kb), torch.equal(la, lb))
    log(f"  {base.name} ({base.num_layers} layers) hkv_s (cache strides "
        f"{sb}) vs s_hkv ({sa}): tokens equal {same[0]} "
        f"({sum(map(len, tb))} tokens), cache bytes equal {same[1]}, four "
        f"decode steps' logits equal bit for bit {same[2]}")
    if not all(same):
        raise AssertionError("hkv_s differs from s_hkv")
    return got["hkv_s"]


def p14_reduced(torch):
    """(b)-(d) on the reduced float32 configs: tokens on the card (graphed
    chunks) equal the CPU's (plain versions)."""
    for arch, over in (("gemma-2b", {"attn_logit_softcap": 30.0}),
                       ("jamba-v0.1-52b", {"sliding_window": 8}),
                       ("llama-30b", {"decode_cache_layout": "hkv_s"})):
        on_card = serve_small(torch, "cuda", "dense", arch, over)
        on_cpu = serve_small(torch, "cpu", "dense", arch, over)
        log(f"  {arch} {over} reduced f32: card tokens == CPU tokens: "
            f"{on_card == on_cpu} ({sum(map(len, on_card))} tokens)")
        if on_card != on_cpu:
            raise AssertionError(f"{arch} {over}: card {on_card} != cpu "
                                 f"{on_cpu}")


def main() -> int:
    # phase 11's deterministic cuBLAS: set before the process first uses it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU only", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("[1/14] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # phase 13(c)'s train cells at four run on the host from here on
    import tempfile
    p13_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    t13c = time.perf_counter()
    dry = dryrun_start(p13_tmp, ("four-train",))
    log(f"  phase 13(c) started: the dry-run of the train cells at four "
        f"({len(p13_cells('four-train'))}), on the host")
    analysis = analysis_start()
    log("  phase 14(a) started: python -m repro_torch.analysis lint "
        "--strict and check --quick --mutations --replay, on the host")

    log("[2/14] build")
    t = time.perf_counter()
    build.library()
    log(f"  {len(build.sources())} sources -> {build.build().name} in "
        f"{time.perf_counter() - t:.1f} s")
    for name, regs, spill in kernel_resources(build.build_log()):
        log(f"  {name}: {regs} registers, {spill}")

    log("[3/14] kernels against their plain versions on the card")
    cfg = get_config("llama-30b")
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    # the wire of one 256-token bucket: K and V of 60 layers, 52 rows of
    # 128 per token; the vector bodies, then the scalar ones on the same
    # values one element off the grain
    rq, rd = check_quant(torch, ref, kq, 2 * L * 256 * Hkv, 128,
                         torch.bfloat16, timed=True)
    rq_s, rd_s = check_quant(torch, ref, kq, 2 * L * 256 * Hkv, 128,
                             torch.bfloat16, timed=True, offset=1)
    for offset in (0, 1):
        check_quant(torch, ref, kq, 3001, 64, torch.float32, timed=False,
                    offset=offset)
    check_quant(torch, ref, kq, 517, 4, torch.float32, timed=False)
    # the decode append: K and V of one layer for 4 slots, one launch a
    # layer (lengths as the paged step's), then the reduced f32 model's
    rapp = check_append(torch, ref, kq, 4, Hkv, hd, 16, 16,
                        [232, 123, 56, 17], torch.bfloat16, timed=True)
    check_append(torch, ref, kq, 4, 4, 16, 8, 8, [63, 5, 0, 17],
                 torch.float32, timed=False)
    # the decode step: 4 slots, kv lengths as in the serve phase
    ra = check_attention(torch, ref, pa, L, 4, Hkv, 1, hd, 16, 16,
                         [232, 123, 56, 17], torch.bfloat16, timed=True)
    check_attention(torch, ref, pa, 2, 3, 2, 4, 32, 8, 4, [5, 16, 23],
                    torch.float32, timed=False)
    check_attention(torch, ref, pa, 2, 3, 2, 4, 32, 8, 4, [5, 16, 23],
                    torch.bfloat16, timed=False)
    # the served cells' decode step (perfbench's command-r-35b: 96 slots of
    # 256 16-token pages, 8 query heads a KV head), 4 layers cycled
    cell_rows = []
    for live in CELL_LIVE:
        lens = [0] * 96
        for i, n in enumerate(live):
            lens[7 * i + 3] = n
        cell_rows.append(check_attention(
            torch, ref, pa, 4, 96, 8, 8, 128, 16, 256, lens, torch.bfloat16,
            controls=("kv_len - 64", "rows rolled"), timed=True))
    for live, r in zip(CELL_LIVE, cell_rows):
        log(f"  paged_decode_attention_int4 at the cells' step, {len(live)} "
            f"of 96 slots live: {r['ms']:.5f} ms (plain "
            f"{r['plain_ms']:.5f}, bound {r['bound'][0]:.5f} by "
            f"{r['bound'][1]}; {r['ms'] / r['bound'][0]:.1f}x the bound)")
    H = cfg.num_heads
    # the prefill bucket: 4 prompts of 256 tokens
    rf = check_flash(torch, ref, fa, 4, 256, 0, H, Hkv, hd, torch.bfloat16,
                     timed=True)
    # a partial prefix hit: 128-token suffix over a 64-token padded prefix
    check_flash(torch, ref, fa, 4, 128, 64, H, Hkv, hd, torch.bfloat16,
                plen=[64, 0, 13, 40], timed=False)
    # a chunked-prefill tick of the gateway's 32-token budget: one prompt,
    # 32 queries over its first 96 tokens padded to the 128-token bucket
    rf_tick = check_flash(torch, ref, fa, 1, 32, 128, H, Hkv, hd,
                          torch.bfloat16, plen=[96], timed=True)
    check_flash(torch, ref, fa, 2, 130, 0, 8, 2, 16, torch.float32,
                window=17, timed=False)
    check_flash(torch, ref, fa, 2, 16, 32, 8, 2, 16, torch.float32,
                plen=[32, 5], timed=False)
    # the prefill bucket's rows, then a decode step's
    rn_pre = check_rmsnorm(torch, ref, rn, 1024, cfg.d_model,
                           torch.bfloat16, timed=True)
    rn_dec = check_rmsnorm(torch, ref, rn, 4, cfg.d_model, torch.bfloat16,
                           timed=True)
    check_rmsnorm(torch, ref, rn, 37, cfg.d_model, torch.float32,
                  timed=False)
    # the residual add fused with the norm: a decode step's rows, the
    # prefill bucket's, f32 rows, and a small odd width off the grain
    radd_dec = check_add_rmsnorm(torch, ref, rn, 4, cfg.d_model,
                                 torch.bfloat16, timed=True)
    radd_pre = check_add_rmsnorm(torch, ref, rn, 1024, cfg.d_model,
                                 torch.bfloat16, timed=True)
    check_add_rmsnorm(torch, ref, rn, 37, cfg.d_model, torch.float32,
                      timed=False)
    check_add_rmsnorm(torch, ref, rn, 5, 77, torch.bfloat16, timed=False)
    check_add_rmsnorm(torch, ref, rn, 4, cfg.d_model, torch.bfloat16,
                      timed=False, offset=1)
    for dt in (torch.bfloat16, torch.float32):
        check_norm_rows(torch, ops, cfg.d_model, dt)
    # the dense decode step: one layer of the (60, 4, 256, 52, 128) cache
    # of 4 slots, kv lengths as the paged step's
    rdec = check_decode(torch, ref, da, L, 4, Hkv, 1, hd, 256,
                        [232, 123, 56, 17], torch.bfloat16, torch.bfloat16,
                        timed=True)
    decode_split_anatomy(torch, da, L, 4, Hkv, hd, 256)
    check_decode(torch, ref, da, 2, 3, 2, 4, 16, 40, [1, 40, 23],
                 torch.float32, torch.float32, timed=False)
    check_decode(torch, ref, da, 2, 3, 2, 4, 16, 40, [1, 40, 23],
                 torch.float32, torch.bfloat16, timed=False)
    check_decode(torch, ref, da, 2, 2, 4, 2, 64, 512, [300, 512],
                 torch.bfloat16, torch.bfloat16, timed=False)
    # the bf16 pages at row 3's shapes, then reduced ones (q f32 is the
    # reduced float32 model's)
    rpb = check_paged_bf16(torch, ref, pa, L, 4, Hkv, 1, hd, 16, 16,
                           [232, 123, 56, 17], torch.bfloat16, timed=True)
    check_paged_bf16(torch, ref, pa, 2, 3, 2, 4, 32, 8, 4, [5, 16, 23],
                     torch.float32, timed=False)
    check_paged_bf16(torch, ref, pa, 2, 3, 2, 4, 32, 8, 4, [5, 16, 23],
                     torch.bfloat16, timed=False)
    check_paged_bf16(torch, ref, pa, 2, 2, 4, 1, 16, 8, 2, [40, 9],
                     torch.float32, timed=False)
    arch_rows = check_arch_shapes(torch, ref, fa, da, pa, kq, rn)
    arch_rows += check_recurrent_shapes(torch, ref, fa, da, rn)
    arch_rows += check_local_shapes(torch, ref, fa, da, pa, kq, rn)
    lse_rows = lse_shapes(torch, ref, da)
    arch_rows += lse_rows
    torch.cuda.empty_cache()

    log("[4/14] reduced configs, float32: card vs plain versions on the CPU")
    from repro_torch.configs import ALL_ARCHS, get_reduced
    from repro_torch.models.paged import paged_supported
    from repro_torch.models.transformer import recurrent
    for arch in ALL_ARCHS:
        modes = DECODE_MODES if paged_supported(get_reduced(arch)) \
            else ("dense",)
        for mode in modes:
            on_card = serve_small(torch, "cuda", mode, arch)
            on_cpu = serve_small(torch, "cpu", mode, arch)
            log(f"  {arch} {mode}: tokens equal: {on_card == on_cpu} "
                f"({sum(map(len, on_card))} tokens)")
            if on_card != on_cpu:
                raise AssertionError(f"{arch} {mode}: card {on_card} != "
                                     f"cpu {on_cpu}")
        # a recurrent stack never chunks its prefill (exact lengths)
        if get_reduced(arch).moe_num_experts and \
                not recurrent(get_reduced(arch)):
            moe_chunked_f32(torch, arch)

    base_mem = settled(torch)
    log(f"[5/14] serve full-width {cfg.name}: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"(kv {cfg.num_kv_heads}), head_dim {hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}")
    params, pre = full_model(torch, cfg)
    launches5 = {}
    for mode in DECODE_MODES:              # int4 pages (main path) first
        got = serve_ab(torch, cfg, params, pre, mode)
        launches5 = {k: launches5.get(k, 0) + got[k] for k in got}
        torch.cuda.empty_cache()            # the engines' caches are freed
    log(f"  phase-5 launches: {launches5}")

    log(f"[6/14] the gateway entry point (repro_torch.launch.serve) at full "
        f"width on phase 5's weights")
    launches6 = serve_gateway(torch, params)
    log(f"  phase-6 launches: {launches6}")

    log(f"[7/14] the chaos entry point (repro_torch.launch.serve_e2e "
        f"--chaos) at full width on phase 5's weights: a decode crash and "
        f"a spot preemption with graphed decode chunks")
    log(smi.splitlines()[0])
    launches7 = serve_chaos(torch, params)
    log(f"  phase-7 launches: {launches7}")
    launches = {k: launches5[k] + launches6[k] + launches7[k]
                for k in launches5}

    log("[8/14] the other dense configs at full width: stablelm-3b, "
        "gemma-2b, h2o-danube-3-4b, command-r-35b")
    log(smi.splitlines()[0])
    del params, pre
    mem = settled(torch)
    log(f"  {cfg.name}'s weights dropped: {mem:,} bytes allocated, "
        f"{base_mem:,} before phase 5 made them")
    if mem > base_mem:
        raise AssertionError(f"{mem - base_mem} bytes still allocated after "
                             f"{cfg.name}'s weights were dropped")
    for arch in PHASE8:
        got = serve_arch(torch, arch)
        log(f"  {arch} launches: {got}")
        launches = {k: launches[k] + got[k] for k in launches}
        mem = settled(torch)
        log(f"  {arch} dropped: {mem:,} bytes allocated, {base_mem:,} "
            f"before phase 5")
        if mem > base_mem:
            raise AssertionError(f"{arch}: {mem - base_mem} bytes still "
                                 f"allocated after its run")

    log("[9/14] the MoE and VLM configs at published widths: "
        "llava-next-mistral-7b (32 layers), qwen3-moe-235b-a22b (8 of 94 "
        "layers), llama4-maverick-400b-a17b (2 of 48 layers)")
    log(smi.splitlines()[0])
    for arch in PHASE9:
        got = serve_arch(torch, arch)
        log(f"  {arch} launches: {got}")
        launches = {k: launches[k] + got[k] for k in launches}
        mem = settled(torch)
        log(f"  {arch} dropped: {mem:,} bytes allocated, {base_mem:,} "
            f"before phase 5")
        if mem > base_mem:
            raise AssertionError(f"{arch}: {mem - base_mem} bytes still "
                                 f"allocated after its run")

    # phase 13(c)'s serving cells run on the host (meta tensors) beside
    # phases 10-13
    dry += dryrun_start(p13_tmp, ("one", "four"))
    log(f"  phase 13(c) started: the dry-run of {', '.join(P13_ARCHS)}'s "
        f"cells at one and of every serving cell at four, on the host")

    log("[10/14] the recurrent and encoder-decoder configs at published "
        "widths: xlstm-125m, jamba-v0.1-52b (16 of 32 layers), "
        "whisper-base")
    log(smi.splitlines()[0])
    for arch in PHASE10:
        got = serve_arch(torch, arch)
        log(f"  {arch} launches: {got}")
        launches = {k: launches[k] + got[k] for k in launches}
        mem = settled(torch)
        log(f"  {arch} dropped: {mem:,} bytes allocated, {base_mem:,} "
            f"before phase 5")
        if mem > base_mem:
            raise AssertionError(f"{arch}: {mem - base_mem} bytes still "
                                 f"allocated after its run")
    # the partial mode runs on the kv_seq cache only: phase 12 (g)
    missing = [k for k, n in launches.items()
               if n == 0 and k != "decode_attention_lse"]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    log("[11/14] training and checkpoints: (a) every config reduced in "
        "float32, 3 AdamW steps on the card and on the CPU; (b) LLaMA-30B "
        f"at full width, {TRAIN_LAYERS} of 60 layers, 6 steps through "
        f"launch.train; (c) LLaMA-30B cut to {CKPT_LAYERS} layer, async "
        "checkpoints and a bit-identical restart")
    log(smi.splitlines()[0])
    t11 = time.perf_counter()
    before = ops.launch_counts()
    mem = settled(torch)
    for arch in ALL_ARCHS:
        train_reduced(torch, arch)
    full = train_full(torch, smi.splitlines()[0])
    mem_b = settled(torch)
    log(f"  (a), (b) dropped: {mem_b:,} bytes allocated, {mem:,} before "
        f"the phase")
    restart = train_restart(torch, smi.splitlines()[0])
    mem_c = settled(torch)
    log(f"  (c) dropped: {mem_c:,} bytes allocated, {mem:,} before the "
        f"phase")
    if ops.launch_counts() != before:
        raise AssertionError(f"training launched kernels: "
                             f"{ops.launch_counts()} from {before}")
    if max(mem_b, mem_c) > mem:
        raise AssertionError(f"phase 11 left {max(mem_b, mem_c) - mem} "
                             f"bytes allocated")
    log(f"  phase 11: {time.perf_counter() - t11:.1f} s; no kernel "
        f"launched; step {full['step_ms']:.1f} ms against the "
        f"{full['bound_ms']:.1f} ms compute bound, optimizer "
        f"{full['opt_ms']:.1f} ms against {full['opt_bound_ms']:.1f} ms, "
        f"checkpoints {restart['write_gbs']:.2f} GB/s written, "
        f"{restart['read_gbs']:.2f} GB/s read")

    log("[12/14] distribution: (a) Runtime over a 1-D model mesh of one "
        "rank over NCCL, full LLaMA-30B through the engines, graphed and "
        "eager, against the unmeshed engine; (b) LLaMA-30B at TP 2, "
        f"{P12_LAYERS['tp']} of 60 layers, (c) qwen3-moe at EP 2 + TP 2, "
        f"{P12_LAYERS['moe']} of 94 layers, (d) a 2-stage pipeline of "
        f"{P12_LAYERS['pipe']} LLaMA-30B layers: two ranks over gloo on "
        "the one card; (e) every other config at TP 2 (full widths, cut "
        "in depth), and gemma-2b and jamba over a world-1 NCCL mesh; (f) "
        "the sharded training step: a world-1 NCCL step of LLaMA-30B, "
        f"LLaMA-30B at TP 2 ({P12F_LAYERS['tp']} layers) and at data 2 x "
        f"model 2 ({P12F_LAYERS['dp']}), qwen3-moe at EP 2 + TP 2 "
        f"({P12F_LAYERS['moe']}), a TP-2 checkpoint read back at TP 1; "
        f"(g) the kv_seq decode cache: a world-1 NCCL mesh, LLaMA-30B at "
        f"TP 2 ({P12G['tp2'][1]} layers) and at TP 8 ({P12G['tp8'][1]} "
        f"layers, 52 heads gathered)")
    log(smi.splitlines()[0])
    t12 = time.perf_counter()
    got = phase12(torch)[0]
    launches = {k: launches[k] + got.get(k, 0) for k in launches}
    log(f"  phase-12 launches: {got}")
    missing = [k for k in PHASE12_KERNELS if not got.get(k)]
    if missing:
        raise AssertionError(f"phase 12 never launched {missing}")
    t12f = time.perf_counter()
    mem = settled(torch)
    before = ops.launch_counts()
    phase12f(torch)
    if ops.launch_counts() != before:
        raise AssertionError(f"(f): training launched kernels: "
                             f"{ops.launch_counts()} from {before}")
    if settled(torch) > mem:
        raise AssertionError(f"(f) left {settled(torch) - mem} bytes "
                             f"allocated")
    log(f"  (f): {time.perf_counter() - t12f:.1f} s; no kernel launched")
    t12g = time.perf_counter()
    mem = settled(torch)
    got = phase12g(torch)[0]
    launches = {k: launches[k] + got.get(k, 0) for k in launches}
    log(f"  (g) launches: {json.dumps({k: n for k, n in got.items() if n})}")
    if not got.get("decode_attention_lse"):
        raise AssertionError("(g) never launched the partial mode")
    if settled(torch) > mem:
        raise AssertionError(f"(g) left {settled(torch) - mem} bytes "
                             f"allocated")
    log(f"  (g): {time.perf_counter() - t12g:.1f} s")
    log(smi.splitlines()[0])
    log(f"  phase 12: {time.perf_counter() - t12:.1f} s")

    log("[13/14] the counts against the card: LLaMA-30B's int4 decode "
        "step, a bucket prefill and phase 11's train step counted on meta "
        "tensors (roofline/op_cost.py) and run on the card; the dry-run "
        "(launch/dryrun.py)")
    log(smi.splitlines()[0])
    t13 = time.perf_counter()
    mem = settled(torch)
    p13 = p13_serve(torch, smi.splitlines()[0])
    p13["train"] = p13_train(torch, smi.splitlines()[0])
    mem13 = settled(torch)
    if mem13 > mem:
        raise AssertionError(f"phase 13 left {mem13 - mem} bytes allocated")
    log(f"  (a), (b): {time.perf_counter() - t13:.1f} s")
    p13_dryrun(dry, t13c)
    log(f"  phase 13: {time.perf_counter() - t13:.1f} s; " + "; ".join(
        f"{k} share {100 * v['share']:.2f}%, roofline / measured "
        f"{v['ratio']:.3f}" for k, v in p13.items()))

    log(f"[14/14] the analysis package and the last model options: (a) "
        f"lint --strict, check --quick --mutations --replay, and R002's "
        f"scope against a captured LLaMA-30B decode chunk "
        f"({P14_LAYERS['scope']} layers); (b) gemma-2b, 18 layers, with a "
        f"logit softcap of {P14_CAP}: the capped kernels at its shapes, "
        f"then the engines; (c) jamba ({P14_LAYERS['jamba']} of 32 layers) "
        f"with a {P14_WINDOW}-token window and a {P14_PROMPT}-token prompt; "
        f"(d) LLaMA-30B ({P14_LAYERS['hkv_s']} layers) on the hkv_s cache "
        f"against s_hkv; the reduced f32 configs, card vs CPU")
    log(smi.splitlines()[0])
    t14 = time.perf_counter()
    mem = settled(torch)
    analysis_finish(analysis)
    p14_scope(torch)
    log(f"  (a): {time.perf_counter() - t14:.1f} s")
    t = time.perf_counter()
    rcap_f = check_flash(torch, ref, fa, 4, 256, 0, 8, 1, 256,
                         torch.bfloat16, softcap=P14_CAP, scale=4.0,
                         controls=("no cap",), timed=True)
    rcap_d = check_decode(torch, ref, da, 18, 4, 1, 8, 256, 256,
                          [232, 123, 56, 17], torch.bfloat16,
                          torch.bfloat16, softcap=P14_CAP, scale=4.0,
                          controls=("no cap",), timed=True)
    got_b = p14_softcap(torch)
    counted("softcap", got_b)
    log(f"  (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    settled(torch)
    got_c = p14_window(torch)
    counted("window", got_c)
    log(f"  (c): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    settled(torch)
    got_d = p14_hkv_s(torch)
    counted("hkv_s", got_d)
    p14_reduced(torch)
    log(f"  (d) and the reduced configs: {time.perf_counter() - t:.1f} s")
    launches = {k: launches[k] + got_b[k] + got_c[k] + got_d[k]
                for k in launches}
    launches["flash_attention_softcap"] = got_b["flash_attention"]
    launches["decode_attention_softcap"] = got_b["decode_attention"]
    if settled(torch) > mem:
        raise AssertionError(f"phase 14 left {settled(torch) - mem} bytes "
                             f"allocated")
    log(smi.splitlines()[0])
    log(f"  phase 14: {time.perf_counter() - t14:.1f} s")

    rows = [("kv_quant", "src/repro_torch/kernels/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:55", rq),
            ("kv_dequant", "src/repro_torch/kernels/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:80", rd),
            ("kv_quant_append", "src/repro_torch/kernels/csrc/kv_quant.cu",
             "src/repro/kernels/kv_quant.py:55", rapp),
            ("paged_decode_attention_int4",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:174", ra),
            ("paged_decode_attention_bf16",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/paged_attention.py:193", rpb),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:97", rf),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:96", rdec),
            ("decode_attention_lse",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:96", lse_rows[0][3]),
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:24", rn_pre),
            ("add_rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:24", radd_dec),
            # the capped instantiations (phase 14 (b): gemma-2b's shapes)
            ("flash_attention_softcap",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:97", rcap_f),
            ("decode_attention_softcap",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:96", rcap_d)]
    log(f"  kv_quant at the bucket: vector body {rq['ms']:.4f} ms, scalar "
        f"body {rq_s['ms']:.4f} ms; kv_dequant: vector {rd['ms']:.4f} ms, "
        f"scalar {rd_s['ms']:.4f} ms; bounds {rq['bound'][0]:.4f} / "
        f"{rd['bound'][0]:.4f} ms")
    log(f"  kv_quant_append at the decode step (4 slots x {Hkv} heads x "
        f"{hd}): {rapp['ms']:.4f} ms, the path it replaced "
        f"{rapp['old_ms']:.4f} ms (two kv_quant launches "
        f"{rapp['quant2_ms']:.4f} ms), bound {rapp['bound'][0]:.5f} ms")
    log(f"  flash_attention at a 32-token chunked-prefill tick (prefix 96 "
        f"of 128): {rf_tick['ms']:.4f} ms ({rf_tick['eager_ms']:.4f} ms "
        f"launched eagerly), plain {rf_tick['plain_ms']:.4f} ms, library "
        f"{rf_tick['library_ms']:.4f} ms (SDPA, suffix mask), bound "
        f"{rf_tick['bound'][0]:.5f} ms")
    log(f"  rmsnorm at the decode step's 4 x {cfg.d_model}: "
        f"{rn_dec['ms']:.4f} ms ({rn_dec['eager_ms']:.4f} ms launched "
        f"eagerly), plain {rn_dec['plain_ms']:.4f} ms, "
        f"library {rn_dec['library_ms']:.4f} ms, bound "
        f"{rn_dec['bound'][0]:.5f} ms")
    log(f"  add_rmsnorm at the prefill bucket's 1024 x {cfg.d_model}: "
        f"{radd_pre['ms']:.4f} ms ({radd_pre['eager_ms']:.4f} ms launched "
        f"eagerly), plain {radd_pre['plain_ms']:.4f} ms, library "
        f"{radd_pre['library_ms']:.4f} ms, bound "
        f"{radd_pre['bound'][0]:.4f} ms")
    # an error over every shape the kernel was checked at in phase 3 (the
    # times are at LLaMA-30B's shapes; the other configs' are logged above)
    err = {name: max([r["err"]] + [a["err"] for k, _, _, a in arch_rows
                                   if k == name])
           for name, _, _, r in rows}
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r.get("library_ms")}
        for name, src, rep, r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
