"""Quickstart: schedule LLaMA-30B serving on the paper's heterogeneous cloud.

Reproduces the Table 3 experience: the two-level scheduler partitions the
32-GPU pool into prefill/decode groups with per-group parallel configs and
TSTP request routing — then shows the coding vs conversation contrast.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--rate 2.0] \\
      [--steps 40]

The port's copy of the reference's ``examples/quickstart.py``: the plan
is computed on the host by the port's scheduler, with no device. ``main``
returns the plans, by workload name.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import scheduler
from repro_torch.core.cluster import make_paper_cloud
from repro_torch.core.orchestrator import SloSpec
from repro_torch.core.workload import CODING, CONVERSATION


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--arch", default="llama-30b", choices=ALL_ARCHS)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cluster = make_paper_cloud()
    slo = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)

    print(f"cluster: {cluster.types()}  price=${cluster.price_per_hr():.2f}/hr")
    print(f"model:   {cfg.name} ({cfg.param_count()/1e9:.1f}B params)\n")

    plans = {}
    for wl in (CODING, CONVERSATION):
        plan = scheduler.schedule(cluster, cfg, wl, rate=args.rate, slo=slo,
                                  n_step=args.steps, seed=0)
        print(f"=== {wl.name} workload "
              f"(mean in/out = {wl.mean_in:.0f}/{wl.mean_out:.0f}) ===")
        print(plan.describe())
        print(f"  search: {plan.search_seconds:.1f}s, {plan.evals} "
              f"lower-level evals\n")
        plans[wl.name] = plan
    return plans


if __name__ == "__main__":
    main()
