"""The rate sweep behind a cell's offered rate: one set-up, then the cell's
traffic at each rate given, each a lead-in, a window and a drain, printed
as one line a rate. Attainment is the share of the window's requests that
met both of the reference scheduler's limits over their whole lives (TTFT
2 s, TPOT 0.15 s; a failed request misses); ``queued_at_close`` and the
drain's seconds show a growing backlog.

    python3 perfbench/sweep.py --workload command-r-35b.conversation \\
        --rates 1,1.5,2,2.5,3 --seconds 30 --seed 11
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parent),
                str(pathlib.Path(__file__).resolve().parents[1] / "src")]

from pbench import bench, spec  # noqa: E402

TTFT_S, TPOT_S = 2.0, 0.15


def attainment(data, done) -> float:
    met = 0
    counted = data.window.counted()
    for r in counted:
        st = r.stamps
        if not st or r.rid not in done:
            continue
        tpot = (st[-1] - st[0]) / (len(st) - 1) if len(st) > 1 else 0.0
        met += (st[0] - r.due) <= TTFT_S and tpot <= TPOT_S
    return met / max(len(counted), 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--drain", type=float, default=60.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the rehearsal sizes")
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    man = spec.manifest()
    rates = [float(x) for x in args.rates.split(",")]
    c = bench.prepare(args.workload, seed=args.seed, manifest=man,
                      device=args.device, rehearse=cpu)
    arr, _ = bench.arrivals_for(c, args.seed, args.seconds, max(rates))
    bench.warm(c, arr, trace=False)
    for rate in rates:
        arr, prompts = bench.arrivals_for(c, args.seed, args.seconds, rate)
        t = time.perf_counter()
        got = bench.measure(c, arr, prompts, seconds=args.seconds,
                            trace=False, drain_s=args.drain)
        drained = time.perf_counter() - t - c.cs["lead_in_s"] - args.seconds
        data = got.data
        line = {"rate": rate,
                "attainment": attainment(data, {d["rid"] for d in got.done}),
                "due": len(data.window.counted()),
                "queued_at_close": sum(
                    1 for _, st in data.counted()
                    if st["state"] in ("QUEUED", "unsubmitted")),
                "drain_s": drained,
                "metrics": {k: v["value"] for k, v in bench.metrics_of(
                    man, data, False).items() if k != "setup_s"}}
        print(json.dumps(line), flush=True)
        c.sys.reset()


if __name__ == "__main__":
    main()
