"""End-to-end phase-split serving through the gateway API, with a decode
crash and a spot preemption on request (``--chaos``).

  PYTHONPATH=src python -m repro_torch.launch.serve_e2e [--requests 12] \\
      [--rate 3] [--max-new 32] [--chaos] [--no-paged] [--transport sim] \\
      [--no-compress] [--chunk-tokens 16]

One prefill engine and two decode engines (three with ``--chaos``) on one
copy of the weights, the int4 KV wire between them and continuous batching
on decode, driven OPEN-LOOP: requests are submitted at Poisson arrival
times against the clock, tokens stream back through ``RequestHandle``
callbacks while later requests are still arriving, and per-request TTFT /
TPOT / E2E deadlines are accounted. The trace is the reference's: a shared
16-token system prefix, ~35% verbatim repeats of an earlier prompt (full
prefix hits), prompts of 16/24/32 tokens, seed 7. With ``--chaos`` a decode
replica crashes at 0.3 of the trace's span and another gets a spot
preemption notice (grace 0.75 s) at 0.55, each waiting for a victim that
holds work; every request must still finish, or the exit code is 1.

The port's copy of the reference's ``examples/serve_e2e.py``, with the same
flags and trace, except:

* the engines run the FULL config of ``--arch`` on ``--device`` (default
  ``cuda``: each decode chunk is one CUDA graph replay); ``--reduced`` runs
  the reduced config (the CPU tests use ``--device cpu --reduced``);
* random weights come from ``init_params(cfg, seed=0)`` on the device;
  ``run(argv, params=...)`` serves weights the caller already holds;
* ``--transport sim`` scales the wire's bytes by the reference's 400 on
  the reduced config, and by 1 at full width (the wire is the full
  model's already);
* the chaos message prints the times the events are scheduled at;
* ``--arch`` takes every config but whisper-base (its prompts need frame
  embeddings the engines cannot take); ``--arch xlstm-125m`` migrates
  recurrent state in the chaos run;
* ``run`` returns the results, the chaos controller's ``fired`` list and
  the dead decode replicas.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_reduced
from repro_torch.launch.serve import check_servable, device_line
from repro_torch.models.transformer import cache_dtype, init_params
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.faults import (CRASH, PREEMPT, FaultEvent,
                                        FaultSchedule, install_chaos)
from repro_torch.serving.gateway import (DONE, Gateway, SchedulerConfig,
                                         ServeRequest, drive_open_loop,
                                         summarize_handles, warmup_gateway)
from repro_torch.serving.transport import (InProcessTransport,
                                           SimNetworkTransport)

# the chaos schedule, as fractions of the trace's span
CRASH_AT, PREEMPT_AT, PREEMPT_GRACE_S = 0.3, 0.55, 0.75


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--arch", default="llama-30b", choices=ALL_ARCHS)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced config of --arch (CPU tests) "
                         "instead of the full one")
    ap.add_argument("--rate", type=float, default=3.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--transport", choices=("inproc", "sim"),
                    default="inproc")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="per-request TTFT deadline in s (0 = none)")
    ap.add_argument("--e2e-slo", type=float, default=0.0,
                    help="per-request E2E deadline in s (0 = none)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged decode cache)")
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool budget per decode engine (0 = parity "
                         "with the dense max_slots x max_seq budget)")
    ap.add_argument("--no-paged", action="store_true",
                    help="use the dense slotted decode cache instead of "
                         "the paged int4-resident pool")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the radix prefix cache (refcounted "
                         "copy-on-write page sharing + prefill skip)")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill chunk token budget per scheduler tick "
                         "(0 = one-shot prefill); with chunking, a long "
                         "prompt no longer head-of-line-blocks the TTFT "
                         "of short prompts behind it")
    ap.add_argument("--decode-chunk-steps", type=int, default=0,
                    help="decode steps per scheduler tick (0 = engine "
                         "default)")
    ap.add_argument("--max-prefill-batch", type=int, default=4,
                    help="max prompts per prefill dispatch/chunk tick")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a decode-replica crash and a spot "
                         "preemption mid-trace (3 decode replicas so a "
                         "survivor remains; every request must still "
                         "finish)")
    return ap.parse_args(argv)


def make_trace(args, vocab_size: int):
    """The reference's open-loop Poisson trace: every prompt opens with a
    shared 16-token system prompt (page-aligned: partial prefix hits once
    the first request donates its chain), and ~1/3 of requests repeat an
    earlier prompt verbatim (full hits: prefill skipped). Seed 7 differs
    from the warm-up's rng(0), so warm-up donations do not collide with
    the trace's prompts."""
    rng = np.random.default_rng(7)
    sys_prefix = rng.integers(1, vocab_size, 16).astype(np.int32)
    arrivals, prompts = [], []
    t = 0.0
    for rid in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        if prompts and rng.random() < 0.35:
            toks = prompts[int(rng.integers(len(prompts)))]
        else:
            n_in = int(rng.choice([16, 24, 32]))
            toks = np.concatenate([sys_prefix, rng.integers(
                1, vocab_size, n_in - 16).astype(np.int32)])
            prompts.append(toks)
        arrivals.append((t, ServeRequest(
            rid, toks, max_new_tokens=args.max_new,
            ttft_deadline_s=args.ttft_slo or float("inf"),
            e2e_deadline_s=args.e2e_slo or float("inf"))))
    return arrivals


def victim_load(gw, fired) -> int:
    """How many requests the victim of one fired chaos event held: a
    preemption's migrated and requeued ones, a crash's requests requeued
    from the dead replica (the gateway's events name each)."""
    if fired["kind"] == PREEMPT:
        return fired["migrated"] + fired["requeued"]
    tag = f"re-queued after {fired['phase']}:{fired['idx']} failure"
    return sum(tag in e for e in gw.events)


def run(argv=None, params=None):
    """Build the engines and the gateway, warm them up, (with ``--chaos``)
    arm the fault schedule, serve the trace and print the results; returns
    them. ``params`` are weights already on ``--device`` for the chosen
    config (made with ``init_params(cfg, seed=0)`` when None)."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("serve_e2e: no CUDA device; pass --device cpu "
                           "to run the plain versions on the CPU")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    check_servable(cfg)
    print(f"model {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {args.device}")
    print(device_line(args.device))
    if params is None:
        params = init_params(cfg, seed=0, device=args.device,
                             dtype=cache_dtype(cfg))

    prefill = PrefillEngine(cfg, params, max_seq=128, device=args.device)
    n_dec = 3 if args.chaos else 2
    decodes = [DecodeEngine(cfg, params, max_slots=4, max_seq=128,
                            paged=not args.no_paged,
                            page_size=args.page_size,
                            num_pages=args.pages or None,
                            prefix_sharing=not (args.no_paged
                                                or args.no_prefix_sharing),
                            device=args.device)
               for _ in range(n_dec)]
    if decodes[0].paged_fallback:
        print(f"note: {decodes[0].paged_fallback}")
    if args.transport == "sim":
        # shared-ethernet-class link, full-model wire bytes
        transport = SimNetworkTransport(
            alpha=5e-3, bandwidth=0.6e9,
            bytes_scale=400.0 if args.reduced else 1.0)
    else:
        transport = InProcessTransport()
    gw = Gateway([prefill], decodes, transport=transport,
                 scheduler=SchedulerConfig(
                     prefill_chunk_tokens=args.chunk_tokens,
                     max_prefill_batch=args.max_prefill_batch,
                     decode_chunk_steps=args.decode_chunk_steps),
                 compress=not args.no_compress)

    print("warming up (prefill buckets, decode graphs)...")
    warmup_gateway(gw, cfg.vocab_size, prompt_lens=(16, 24, 32))
    arrivals = make_trace(args, cfg.vocab_size)

    ctl = None
    if args.chaos:
        span = args.requests / args.rate
        schedule = FaultSchedule([
            FaultEvent(t=CRASH_AT * span, kind=CRASH, phase="decode",
                       idx=-1, require_busy=True),
            FaultEvent(t=PREEMPT_AT * span, kind=PREEMPT, phase="decode",
                       idx=-1, grace_s=PREEMPT_GRACE_S, require_busy=True)])
        ctl = install_chaos(gw, schedule)
        print(f"chaos armed: decode crash at ~{CRASH_AT * span:.1f}s, spot "
              f"preemption (grace {PREEMPT_GRACE_S}s) at "
              f"~{PREEMPT_AT * span:.1f}s")

    t0 = time.perf_counter()
    first_seen = {}

    def on_token(h, tok):
        if h.request.rid not in first_seen:
            first_seen[h.request.rid] = time.perf_counter() - t0
            if len(first_seen) <= 4:
                print(f"  rid {h.request.rid}: first token streamed at "
                      f"+{first_seen[h.request.rid]*1e3:.0f}ms "
                      f"({h.state}, {len(gw.queue)} queued behind it)")

    print(f"serving {args.requests} requests open-loop at "
          f"{args.rate:.1f} req/s ({args.transport} transport)...")
    handles = drive_open_loop(gw, arrivals, on_token=on_token)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    s = summarize_handles(handles)
    print(device_line(args.device))
    print(f"\nstates: {s['states']}  "
          f"({s['n_done']}/{s['n_submitted']} done, "
          f"{s['tokens']} tokens in {wall:.2f}s = "
          f"{s['tokens']/wall:.1f} tok/s)")
    print(f"TTFT  p50={s['ttft_p50_s']*1e3:.0f}ms "
          f"p99={s['ttft_p99_s']*1e3:.0f}ms")
    print(f"TPOT  p50={s['tpot_p50_s']*1e3:.0f}ms "
          f"p99={s['tpot_p99_s']*1e3:.0f}ms")
    print(f"E2E   p50={s['e2e_p50_s']*1e3:.0f}ms "
          f"p99={s['e2e_p99_s']*1e3:.0f}ms")
    print(f"goodput (deadline attainment): {s['goodput']*100:.0f}%")
    kv = "int4" if not args.no_compress else "raw bf16"
    print(f"KV transfer wire format: {kv}")
    if isinstance(transport, SimNetworkTransport):
        print(f"sim network: {transport.transfers} transfers, "
              f"{transport.bytes_sent/1e6:.1f}MB, "
              f"mean hop {transport.mean_delay_s*1e3:.1f}ms")
    syncs = sum(d.host_syncs for d in decodes)
    steps = sum(d.steps_run for d in decodes)
    print(f"decode host syncs: {syncs} for {steps} device steps "
          f"({steps / max(syncs, 1):.1f} steps/sync)")
    if decodes[0].paged:
        for i, d in enumerate(decodes):
            st = d.page_stats()
            print(f"decode {i} page pool: {st['pages']} pages x "
                  f"{st['page_size']} tok, peak {st['peak_in_use']} in use, "
                  f"{st['zero_copy_inserts']} zero-dequant wire inserts "
                  f"({st['reencoded_inserts']} re-encoded), "
                  f"{st['alloc_failures']} admission stalls")
    st = gw.stats()
    c = st["counters"]
    print(f"gateway stats: epoch={st['epoch']} retries={c['retries']} "
          f"requeues={c['requeues']} migrations={c['migrations']} "
          f"(tokens={c['migrated_tokens']}) "
          f"preemptions={c['preemptions']} failed={c['failed']}")
    if args.chunk_tokens > 0:
        print(f"chunked prefill: {c['chunk_ticks']} chunk ticks, "
              f"{c['chunked_prefills']} prompts chunked "
              f"(budget {args.chunk_tokens} tok/tick)")
    if st["page_pool"]:
        print(f"page pool (fleet): "
              f"{st['page_pool']['alloc_failures']:.0f} admission stalls, "
              f"{st['page_pool']['in_use']:.0f} pages still in use")
    pfx = st["prefix"]
    if pfx["hits"] or pfx["partial_hits"] or pfx["misses"]:
        pool = st["page_pool"] or {}
        print(f"prefix cache: {pfx['hits']} full hits (prefill skipped), "
              f"{pfx['partial_hits']} partial (suffix prefill), "
              f"{pfx['misses']} misses "
              f"(hit rate {pfx['hit_rate']*100:.0f}%, "
              f"{pfx['hit_tokens']} prompt tokens reused, "
              f"{pool.get('cow_copies', 0):.0f} COW copies)")
    print("replicas:", "  ".join(
        f"{r['phase']}:{r['idx']}={r['status']}"
        + (f"({r['suspect_why']})" if r["suspect_why"] else "")
        for r in st["replicas"]))
    fired = []
    if ctl is not None:
        # t from the arming; "held": the victim's requests at the event
        fired = [dict(f, t=f["t"] - ctl.schedule.t0,
                      held=victim_load(gw, f)) for f in ctl.fired]
        print("chaos fired:", [
            {k: (round(f[k], 3) if k == "t" else f[k])
             for k in ("kind", "idx", "t", "held", "migrated", "requeued")
             if k in f} for f in fired])
    if gw.events:
        print("events:", gw.events[:5])
    n_done = s["states"].get(DONE, 0)
    if n_done < args.requests:
        print(f"WARNING: only {n_done}/{args.requests} requests finished")
    return {"gateway": gw, "handles": handles, "summary": s, "stats": st,
            "wall_s": wall, "decodes": decodes, "fired": fired,
            "dead": [h.idx for h in gw.dec if h.status == "dead"],
            "params_resident": all(h.engine.params is params
                                   for h in gw.pre + gw.dec),
            "page_stats": [d.page_stats() for d in decodes if d.paged]}


def main(argv=None):
    args = parse_args(argv)
    s = run(argv)["summary"]
    return 1 if args.chaos and s["n_done"] < args.requests else 0


if __name__ == "__main__":
    raise SystemExit(main())
