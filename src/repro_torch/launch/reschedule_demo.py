"""Lightweight rescheduling demo (paper §3.4 + Fig. 11 + Table 4).

Scenario 1 — workload shift: live traffic drifts from coding to
conversation; the profiler detects the shift and the scheduler flips phase
designations + re-solves the TSTP in well under a second, with no parameter
reload.

Scenario 2 — node failure: one node (4 GPUs) dies; the affected replicas are
dropped and the survivors are re-designated. Compares lightweight vs full
rescheduling vs doing nothing, on simulated SLO attainment.

Scenario 3 — LIVE: the same mechanism applied to a RUNNING gateway (real
reduced-config engines, real tokens): short-output traffic establishes a
baseline, long-output traffic triggers shift detection mid-trace, and
`maybe_reschedule` applies the new plan as an epoch transition — draining
and flipping replicas around their resident parameters, requeueing
in-flight requests, with zero dropped requests and zero reloads.

  PYTHONPATH=src python -m repro_torch.launch.reschedule_demo  # all three
  PYTHONPATH=src python -m repro_torch.launch.reschedule_demo --live

The port's copy of the reference's ``examples/reschedule_demo.py``.
Scenarios 1 and 2 run on the host through the port's scheduler and
simulator, as the reference's do. Scenario 3 runs the reduced engines on
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions),
with random weights from ``init_params(cfg, seed=0)``; it exits non-zero
when a request is dropped or a parameter tensor is replaced across a
flip, as the reference's does. ``offline_scenarios()`` and
``live_scenario()`` return what they print.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import scheduler, tabu
from repro_torch.core.cluster import make_paper_cloud
from repro_torch.core.orchestrator import SloSpec
from repro_torch.core.simulator import simulate
from repro_torch.core.workload import CODING, CONVERSATION, generate

SLO = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)

# engine-level trace scale of launch/serve.py: prompts ~ n_in/32, outputs
# ~ n_out/16 — the profiler is configured with the inverse so the cost
# model sees full-model workloads
IN_SCALE, OUT_SCALE = 32, 16


def offline_scenarios():
    """Scenarios 1 and 2; returns the plans and each simulated result by
    (scenario, arm)."""
    cfg = get_config("llama-30b")
    cluster = make_paper_cloud()
    rate = 2.0
    results = {}

    print("== initial deployment (coding workload) ==")
    plan = scheduler.schedule(cluster, cfg, CODING, rate, SLO, n_step=40)
    print(plan.describe())

    print("\n== scenario 1: workload shift coding -> conversation ==")
    t0 = time.perf_counter()
    plan_shift = scheduler.reschedule_lightweight(
        cluster, cfg, plan, CONVERSATION, rate, SLO)
    dt = time.perf_counter() - t0
    print(f"lightweight rescheduling took {dt*1e3:.0f}ms "
          f"(no parameter reload)")
    delta = scheduler.plan_diff(plan, plan_shift)
    print(f"  delta: {delta.describe()}")
    print(f"  P:D was {len(plan.prefill_replicas)}:"
          f"{len(plan.decode_replicas)} -> "
          f"{len(plan_shift.prefill_replicas)}:"
          f"{len(plan_shift.decode_replicas)}")
    reqs = generate(CONVERSATION, rate=rate, duration=60, seed=7)
    for name, p in (("stale plan", plan), ("lightweight", plan_shift)):
        r = simulate(cluster, cfg, p.replicas, p.orchestration, reqs, SLO)
        results[("shift", name)] = r
        print(f"  {name:12s} e2e_attain={r.e2e_attain:.3f} "
              f"thpt={r.throughput_tokens:.0f} tok/s")

    print("\n== scenario 2: node failure (4 of 32 GPUs offline) ==")
    dead = [d.idx for d in cluster.devices if d.node == 0]
    shrunk = scheduler.drop_nodes(cluster, plan_shift, dead)
    t0 = time.perf_counter()
    plan_fail = scheduler.reschedule_lightweight(
        cluster, cfg, plan_shift, CONVERSATION, rate, SLO,
        init_solution=shrunk)
    t_light = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster_live = cluster.remove_nodes([0])
    plan_full = scheduler.schedule(cluster_live, cfg, CONVERSATION, rate,
                                   SLO, n_step=40)
    t_full = time.perf_counter() - t0

    noplan_sol = shrunk  # no rescheduling: keep surviving groups as-is
    solver = scheduler.LowerLevelSolver(cluster, cfg, CONVERSATION, rate,
                                        SLO)
    _, noplan_reps, noplan_o = solver.solve(noplan_sol)

    print(f"  lightweight: {t_light:.2f}s search, 0s reload "
          f"(paper Table 4: 13±2 s total at real cluster scale)")
    print(f"  full:        {t_full:.2f}s search + ~103s parameter reload "
          f"(paper Table 4: 157±13 s)")
    for name, reps, o in (
            ("no-resched", noplan_reps, noplan_o),
            ("lightweight", plan_fail.replicas, plan_fail.orchestration),
            ("full", plan_full.replicas, plan_full.orchestration)):
        cl = cluster_live if name == "full" else cluster
        r = simulate(cl, cfg, reps, o, reqs, SLO)
        results[("failure", name)] = r
        print(f"  {name:12s} e2e_attain={r.e2e_attain:.3f} "
              f"thpt={r.throughput_tokens:.0f} tok/s")
    return {"plan": plan, "plan_shift": plan_shift, "plan_fail": plan_fail,
            "plan_full": plan_full, "results": results}


def _tensor_ids(params):
    """The ids of every parameter tensor (a flip must keep each one)."""
    ids = set()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            ids.add(id(x))
    walk(params)
    return ids


def live_scenario(device: str = "cuda"):
    """Scenario 3 on ``device``; raises SystemExit when an invariant
    breaks, else returns the run's summary."""
    from repro_torch.models.transformer import cache_dtype, init_params
    from repro_torch.serving.gateway import (ServeRequest, drive_open_loop,
                                             gateway_from_plan,
                                             summarize_handles,
                                             warmup_engines)
    from repro_torch.serving.profiler import WorkloadProfiler

    print("== scenario 3: LIVE epoch transition on a running gateway ==")
    cfg_full = get_config("llama-30b")
    cluster = make_paper_cloud()
    solver = scheduler.LowerLevelSolver(cluster, cfg_full, CODING, 2.0, SLO)
    # four paper-cloud groups that each hold the full model; a
    # coding-shaped (prefill-heavy) initial designation
    groups = ((0, 1, 2, 3), (4, 5, 6, 7), tuple(range(8, 16)),
              tuple(range(16, 24)))
    sol = tabu.Solution(groups, ("prefill", "prefill", "prefill", "decode"))
    score, replicas, o = solver.solve(sol)
    plan = scheduler.DeploymentPlan(solution=sol, replicas=replicas,
                                    orchestration=o, score=score)
    print(f"  initial designation: P:{len(plan.prefill_replicas)} "
          f"D:{len(plan.decode_replicas)} on {len(groups)} resident groups")

    cfg = get_reduced("llama-30b")
    params = init_params(cfg, seed=0, device=device, dtype=cache_dtype(cfg))
    leaf_ids = _tensor_ids(params)
    gw = gateway_from_plan(plan, cfg, params, max_seq=64, max_slots=4,
                           chunk_size=4, device=device,
                           profiler=WorkloadProfiler(in_scale=IN_SCALE,
                                                     out_scale=OUT_SCALE))
    warmup_engines([h.engine for h in gw.pre], [h.engine for h in gw.dec],
                   cfg.vocab_size, prompt_lens=(12, 16))

    rng = np.random.default_rng(0)

    def req(rid, max_new):
        return ServeRequest(rid, rng.integers(
            1, cfg.vocab_size, int(rng.choice([10, 12, 16]))).astype(
                np.int32), max_new_tokens=max_new)

    print("  [phase A] short-output traffic (coding-like) ...")
    a = [(i * 0.03, req(i, 3)) for i in range(12)]
    ha = drive_open_loop(gw, a)
    gw.profiler.set_baseline()

    printed = [0]

    def tick(g):
        g.maybe_reschedule(cluster, cfg_full, rate=4.0, slo=SLO)
        for e in g.events[printed[0]:]:
            print(f"    | {e}")
        printed[0] = len(g.events)

    print("  [phase B] long-output traffic; control plane ticking ...")
    b = [(i * 0.08, req(100 + i, 12)) for i in range(16)]
    t0 = time.perf_counter()
    hb = drive_open_loop(gw, b, tick=tick, tick_interval_s=0.2)
    wall = time.perf_counter() - t0

    s = summarize_handles(ha + hb)
    resident_ok = all(_tensor_ids(h.engine.params) == leaf_ids
                      for h in gw.pre + gw.dec)
    requeued = sum(h.restarts for h in hb)
    print(f"  epoch {gw.epoch}, P:{len(gw.pre)} D:{len(gw.dec)} after "
          f"{wall:.1f}s of phase B")
    print(f"  {s['n_done']}/{s['n_submitted']} requests DONE "
          f"(states {s['states']}), {requeued} requeued through the flip, "
          f"0 dropped")
    print(f"  no-reload invariant: params resident across flip = "
          f"{resident_ok}")
    if not resident_ok or s["n_done"] != s["n_submitted"]:
        raise SystemExit("live epoch transition violated an invariant")
    if gw.epoch == 0:
        print("  (cost model kept the designation; shift was detected but "
              "no flip scored better)")
    return {"summary": s, "epoch": gw.epoch, "requeued": requeued,
            "params_resident": resident_ok}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--live", action="store_true",
                    help="run only the live gateway scenario (3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live scenario's engines")
    args = ap.parse_args(argv)
    if not args.live:
        offline_scenarios()
        print()
    live_scenario(args.device)


if __name__ == "__main__":
    main()
