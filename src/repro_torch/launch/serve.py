"""Production serving launcher: ClusterSpec -> schedule -> engines ->
gateway -> serve an OPEN-LOOP request stream (the paper's overall routine,
§4 ①-④, driven the way a real service is driven: requests arrive over
time, tokens stream back under TTFT/TPOT deadlines).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-30b \\
      --cluster paper_cloud --workload conversation --rate 2 --duration 20

The port's copy of ``repro.launch.serve``, with the same flags and
defaults except:

* the engines run the FULL config of ``--arch`` on ``--device`` (default
  ``cuda``: one card holds one copy of the weights, which every engine and
  replica shares); ``--reduced`` runs the reduced config instead (the CPU
  tests use ``--device cpu --reduced``);
* ``--cluster`` offers ``paper_cloud`` and ``inhouse`` (the port keeps no
  TPU fleet profile) and ``--arch`` the configs the port has: LLaMA-30B,
  the dense stablelm-3b, gemma-2b, h2o-danube-3-4b and command-r-35b,
  the MoE qwen3-moe-235b-a22b and llama4-maverick-400b-a17b, and the VLM
  llava-next-mistral-7b, served on text prompts, the hybrid
  jamba-v0.1-52b and the xLSTM xlstm-125m (``--arch gemma-2b --reduced
  --device cpu`` on the CPU, ``--arch gemma-2b`` at full width on the
  card). A config whose bf16 weights exceed the card's memory (both MoE
  configs and jamba at full depth) is refused with the bytes it needs
  before any weight is made; whisper-base is refused too, as its prompts
  need frame embeddings the engines cannot take;
* random weights come from ``init_params(cfg, seed=0)`` on the device;
* ``backend=`` is left at its default: on the card the kernels run, and
  each decode chunk is one CUDA graph replay;
* under ``REPRO_SANITIZE=1`` the gateway's sanitizer takes its retrace
  baseline after the warm-up, so a decode graph captured later fails the
  run's drain check.

The deployment plan is computed for the FULL model on the requested
cluster, the same split the paper deploys. With ``--transport sim`` the
prefill->decode KV hop pays the FULL model's wire bytes over the plan's
inter-replica links (alpha-beta model from the cluster's bandwidth
matrix). ``run(argv, params=..., cfg=...)`` is the body, for callers that
already hold the weights on the card or serve a config of their own
(such as a MoE config cut in depth to fit one card); the plan is still
computed for ``--arch``'s full config.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_reduced
from repro_torch.core import scheduler
from repro_torch.core.cluster import make_cluster
from repro_torch.core.orchestrator import SloSpec
from repro_torch.core.workload import WORKLOADS, generate
from repro_torch.models.transformer import cache_dtype, init_params
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.gateway import (Gateway, SchedulerConfig,
                                         ServeRequest, drive_open_loop,
                                         gateway_from_plan,
                                         summarize_handles, warmup_engines)
from repro_torch.serving.profiler import WorkloadProfiler
from repro_torch.serving.transport import (InProcessTransport,
                                           SimNetworkTransport)

# trace -> engine scale of the requests built below (prompts ~
# n_in/IN_SCALE, outputs ~ n_out/OUT_SCALE); the profiler is configured
# with the same factors so the cost model sees the full-model workload
# shape
IN_SCALE, OUT_SCALE = 32, 16


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-30b", choices=ALL_ARCHS)
    ap.add_argument("--cluster", default="paper_cloud",
                    choices=("paper_cloud", "inhouse"))
    ap.add_argument("--workload", default="conversation",
                    choices=tuple(WORKLOADS))
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config of --arch (CPU tests) "
                         "instead of the full one")
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--transport", choices=("inproc", "sim"),
                    default="inproc")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="multiply trace arrival times (e.g. 0.5 = 2x "
                         "faster arrivals)")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="per-request TTFT deadline in s (0 = none); "
                         "queued requests that provably miss it are shed")
    ap.add_argument("--e2e-slo", type=float, default=0.0)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged decode cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool budget per decode engine (0 = parity "
                         "with the dense max_slots x max_seq budget)")
    ap.add_argument("--no-paged", action="store_true",
                    help="dense slotted decode cache instead of the paged "
                         "int4-resident pool")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the radix prefix cache (refcounted "
                         "copy-on-write page sharing + prefill skip)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill chunk token budget per scheduler tick "
                         "(0 = one-shot prefill); SARATHI-style chunking "
                         "bounds how long any prompt can head-of-line-"
                         "block TTFT")
    ap.add_argument("--decode-chunk-steps", type=int, default=0,
                    help="decode steps per scheduler tick (0 = engine "
                         "default)")
    ap.add_argument("--max-prefill-batch", type=int, default=4,
                    help="max prompts per prefill dispatch/chunk tick")
    ap.add_argument("--live-reschedule", action="store_true",
                    help="shift the workload mid-trace and let the "
                         "control plane apply a lightweight reschedule to "
                         "the RUNNING gateway (phase flips, no reload)")
    ap.add_argument("--shift-to", default="",
                    help="workload for the second half of the trace "
                         "(default: the other one)")
    return ap.parse_args(argv)


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (the
    numbers below are taken on it), or the CPU."""
    if torch.device(device).type != "cuda":
        return "device: cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return f"device: {smi.splitlines()[0]}"


def check_servable(cfg):
    """Refuse whisper-base: the engines build token-only prefill batches,
    as the reference's do, and cannot prefill audio (its frames reach the
    model only through ``registry.build(cfg).prefill``)."""
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the serving engines cannot prefill audio (their "
            f"prefill batches hold tokens only, as the reference's do); "
            f"run it through registry.build(cfg).prefill with "
            f"frame_embeds, then DecodeEngine")


def check_fits(cfg, device):
    """Refuse, before any weight is made, a config whose bf16 weights
    exceed the card's memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    need = 2 * cfg.param_count()
    have = torch.cuda.get_device_properties(dev).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name}: its bf16 weights take {need:,} bytes, more than "
            f"the {have:,} bytes of {torch.cuda.get_device_name(dev)}; "
            f"serve a config cut in depth through run(cfg=...)")


def run(argv=None, params=None, cfg=None):
    """Schedule, build the engines, serve the trace and print the results;
    returns them. ``cfg`` is the config the engines serve (by default
    ``--arch``'s, reduced with ``--reduced``); ``params`` are weights
    already on ``--device`` for it (made with ``init_params(cfg, seed=0)``
    when None)."""
    args = parse_args(argv)
    wl = WORKLOADS[args.workload]
    cluster = make_cluster(args.cluster)
    cfg_full = get_config(args.arch)
    if cfg is not None:
        size = "given"
    elif args.reduced:
        cfg, size = get_reduced(args.arch), "reduced"
    else:
        cfg, size = cfg_full, "full"
    check_servable(cfg)
    if params is None:
        check_fits(cfg, args.device)
    slo = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)

    print(f"[1/4] scheduling {cfg_full.name} on {args.cluster} "
          f"({cluster.types()})...")
    plan = scheduler.schedule(cluster, cfg_full, wl, args.rate, slo,
                              n_step=args.steps, seed=0)
    print(plan.describe())

    print(f"[2/4] instantiating engines ({size} config {cfg.name}: "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}) on "
          f"{args.device}...")
    print(device_line(args.device))
    if params is None:
        params = init_params(cfg, seed=0, device=args.device,
                             dtype=cache_dtype(cfg))
    if args.transport == "sim":
        # the engines compute, but the wire hop pays the FULL model's KV
        # bytes over the plan's inter-replica links
        scale = ((cfg_full.num_layers * cfg_full.d_model)
                 / (cfg.num_layers * cfg.d_model))
        transport = SimNetworkTransport.from_plan(cluster, plan,
                                                  bytes_scale=scale)
    else:
        transport = InProcessTransport()
    paged_kw = dict(paged=not args.no_paged, page_size=args.page_size,
                    num_pages=args.pages or None,
                    prefix_sharing=not (args.no_paged
                                        or args.no_prefix_sharing))
    sched_cfg = SchedulerConfig(prefill_chunk_tokens=args.chunk_tokens,
                                max_prefill_batch=args.max_prefill_batch,
                                decode_chunk_steps=args.decode_chunk_steps)
    if args.live_reschedule:
        # one phase-switchable Replica per plan replica, so the control
        # plane can re-designate the running fleet without a reload; the
        # page pool is the DECODE-phase-owned buffer (flips drop/rebuild
        # it with the cached engine, params stay resident)
        gw = gateway_from_plan(plan, cfg, params, transport=transport,
                               max_seq=96, max_slots=4, device=args.device,
                               decode_kw=paged_kw, scheduler=sched_cfg,
                               profiler=WorkloadProfiler(
                                   in_scale=IN_SCALE, out_scale=OUT_SCALE),
                               compress=not args.no_compress)
        pres = [h.engine for h in gw.pre]
        decs = [h.engine for h in gw.dec]
    else:
        n_pre = max(1, len(plan.prefill_replicas))
        n_dec = max(1, len(plan.decode_replicas))
        pres = [PrefillEngine(cfg, params, max_seq=96, device=args.device)
                for _ in range(min(n_pre, 4))]
        decs = [DecodeEngine(cfg, params, max_slots=4, max_seq=96,
                             device=args.device, **paged_kw)
                for _ in range(min(n_dec, 4))]
        gw = Gateway(pres, decs, transport=transport,
                     orchestration=plan.orchestration,
                     scheduler=sched_cfg,
                     compress=not args.no_compress)

    print("[3/4] serving the request stream (open loop, "
          f"{args.transport} transport)...")
    warmup_engines(pres, decs, cfg.vocab_size,
                   compress=not args.no_compress, prompt_lens=(16, 32, 48))
    if gw.sanitizer is not None:
        # REPRO_SANITIZE=1: every decode graph is captured by now, so the
        # retrace monitor fails the run if one is captured later
        gw.sanitizer.on_steady(gw)
    rng = np.random.default_rng(0)

    def to_serve(r, t_offset=0.0):
        return (t_offset + r.t_arrive, ServeRequest(
            r.rid, rng.integers(
                1, cfg.vocab_size,
                min(r.n_in // IN_SCALE + 8, 48)).astype(np.int32),
            max_new_tokens=min(args.max_new, max(r.n_out // OUT_SCALE, 2)),
            ttft_deadline_s=args.ttft_slo or float("inf"),
            e2e_deadline_s=args.e2e_slo or float("inf")))

    tick = None
    if args.live_reschedule:
        wl2 = WORKLOADS[args.shift_to or
                        ("conversation" if args.workload == "coding"
                         else "coding")]
        half = args.duration / 2
        first = generate(wl, rate=args.rate, duration=half, seed=0)
        second = generate(wl2, rate=args.rate, duration=half, seed=1)
        for i, r in enumerate(second):
            r.rid = len(first) + i
        arrivals = [to_serve(r) for r in first] + \
            [to_serve(r, t_offset=half) for r in second]
        print(f"    trace shifts {wl.name} -> {wl2.name} at t={half:.1f}s")
        printed = [0]

        def tick(g):
            if not g.profiler.has_baseline:
                g.profiler.set_baseline()
            else:
                g.maybe_reschedule(cluster, cfg_full, rate=args.rate,
                                   slo=slo)
            for e in g.events[printed[0]:]:
                print(f"    | {e}")
            printed[0] = len(g.events)
    else:
        trace = generate(wl, rate=args.rate, duration=args.duration, seed=0)
        arrivals = [to_serve(r) for r in trace]
    t0 = time.perf_counter()
    handles = drive_open_loop(gw, arrivals, time_scale=args.time_scale,
                              tick=tick)
    wall = time.perf_counter() - t0

    print("[4/4] results")
    print(device_line(args.device))
    s = summarize_handles(handles)
    print(f"  {s['n_done']}/{s['n_submitted']} requests done "
          f"(states {s['states']}), {s['tokens']} tokens in {wall:.1f}s "
          f"({s['tokens']/max(wall, 1e-9):.1f} tok/s)")
    print(f"  TTFT p50={s['ttft_p50_s']*1e3:.0f}ms "
          f"p99={s['ttft_p99_s']*1e3:.0f}ms  "
          f"TPOT p50={s['tpot_p50_s']*1e3:.0f}ms "
          f"p99={s['tpot_p99_s']*1e3:.0f}ms")
    print(f"  E2E  p50={s['e2e_p50_s']*1e3:.0f}ms "
          f"p99={s['e2e_p99_s']*1e3:.0f}ms  "
          f"goodput={s['goodput']*100:.0f}%")
    if isinstance(transport, SimNetworkTransport):
        print(f"  sim network: {transport.transfers} transfers, "
              f"{transport.bytes_sent/1e6:.1f}MB, "
              f"mean hop {transport.mean_delay_s*1e3:.1f}ms")
    # read the LIVE decode list: a mid-trace plan flip re-designates
    # replicas, so the construction-time snapshot would miss new pools
    live_decs = [h.engine for h in gw.dec] if args.live_reschedule else decs
    paged_decs = [d for d in live_decs
                  if isinstance(d, DecodeEngine) and d.paged]
    if paged_decs:
        st = [d.page_stats() for d in paged_decs]
        print(f"  paged KV: {sum(s['pages'] for s in st)} pages x "
              f"{st[0]['page_size']} tok (int4 at rest), peak "
              f"{sum(s['peak_in_use'] for s in st)} in use, "
              f"{sum(s['zero_copy_inserts'] for s in st)} zero-dequant "
              f"wire inserts, "
              f"{sum(s['reencoded_inserts'] for s in st)} re-encoded")
    resident = all(h.engine.params is params for h in gw.pre + gw.dec)
    if args.live_reschedule:
        requeued = sum(h.restarts for h in handles)
        print(f"  live reschedule: epoch {gw.epoch}, "
              f"P:{len(gw.pre)} D:{len(gw.dec)}, {requeued} requeued "
              f"through flips, params resident (no reload) = {resident}")
    st = gw.stats()
    c = st["counters"]
    print(f"  gateway: epoch={st['epoch']} retries={c['retries']} "
          f"requeues={c['requeues']} migrations={c['migrations']} "
          f"preemptions={c['preemptions']} failed={c['failed']}")
    if args.chunk_tokens > 0:
        print(f"  chunked prefill: {c['chunk_ticks']} chunk ticks, "
              f"{c['chunked_prefills']} prompts chunked "
              f"(budget {args.chunk_tokens} tok/tick)")
    if st["page_pool"]:
        print(f"  page pool (fleet): "
              f"{st['page_pool']['alloc_failures']:.0f} admission stalls, "
              f"{st['page_pool']['in_use']:.0f} pages still in use")
    pfx = st["prefix"]
    if pfx["hits"] or pfx["partial_hits"] or pfx["misses"]:
        pool = st["page_pool"] or {}
        print(f"  prefix cache: {pfx['hits']} full hits (prefill skipped), "
              f"{pfx['partial_hits']} partial (suffix prefill), "
              f"{pfx['misses']} misses "
              f"(hit rate {pfx['hit_rate']*100:.0f}%, "
              f"{pfx['hit_tokens']} prompt tokens reused, "
              f"{pool.get('cow_copies', 0):.0f} COW copies, "
              f"{pool.get('prefix_evictions', 0):.0f} evictions)")
    print("  replicas:", "  ".join(
        f"{r['phase']}:{r['idx']}={r['status']}"
        + (f"({r['suspect_why']})" if r["suspect_why"] else "")
        for r in st["replicas"]))
    if gw.events:
        print("  events:", gw.events[:5])
    if gw.sanitizer is not None:
        print(f"  sanitizer (REPRO_SANITIZE=1): {st['sanitizer']}, decode "
              f"graphs captured per replica "
              f"{[h.client.jit_cache_size() for h in gw.dec]}")
    return {"plan": plan, "gateway": gw, "handles": handles, "summary": s,
            "stats": st, "wall_s": wall, "params_resident": resident,
            "page_stats": [d.page_stats() for d in paged_decs]}


def main(argv=None):
    s = run(argv)["summary"]
    return 0 if s["n_done"] == s["n_submitted"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
