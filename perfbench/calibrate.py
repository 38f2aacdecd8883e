"""The readings a cell's ``correct`` limits are set from: over the seeds
given, on one set-up, the program's numbers (``check.compare``) after a
short window at the cell's own load, and with ``--control`` the control's
at the same positions. One JSON line a seed, then the largest program
reading and the smallest control reading of each number.

    python3 perfbench/calibrate.py --workload command-r-35b.conversation \\
        --seeds 1,2,3 --seconds 10 --control
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parent),
                str(pathlib.Path(__file__).resolve().parents[1] / "src")]

from pbench import bench, spec  # noqa: E402
from pbench.system import System  # noqa: E402

NUMBERS = ("max_gap", "mean_gap", "mismatch_share")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the rehearsal sizes")
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    man = spec.manifest()
    seeds = [int(s) for s in args.seeds.split(",")]
    c = bench.prepare(args.workload, seed=seeds[0], manifest=man,
                      device=args.device, rehearse=cpu)
    rows = []
    for i, seed in enumerate(seeds):
        if i:
            c.weights.fill(seed)
            c.sys = System(c.cfg_file, c.params, c.device, rehearse=cpu)
        arr, prompts = bench.arrivals_for(c, seed, args.seconds)
        if i == 0:
            bench.warm(c, arr, trace=False)
        else:
            c.sys.build_decode()
            c.sys.warm_decode()
        got = bench.measure(c, arr, prompts, seconds=args.seconds,
                            trace=False)
        read = bench.verify(c, got, seed, control=args.control)
        read["seed"] = seed
        rows.append(read)
        print(json.dumps(read), flush=True)
    summary = {"program": {k: max(r[k] for r in rows) for k in NUMBERS}}
    if args.control:
        summary["control"] = {k: min(r["control_" + k] for r in rows)
                              for k in NUMBERS}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
