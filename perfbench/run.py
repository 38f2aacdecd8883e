"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) on the card:

    python3 perfbench/run.py --workload command-r-35b.conversation \\
        --seed 7 --seconds 30 --trace 0

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (a separate run, profiled over a
steady part of the window). The last line of standard output is the
result, one JSON object; the numbers compared with the plain reference
are the last lines of standard error. ``--device cpu`` is the CPU
rehearsal (the configuration's and the cell's small ``rehearsal`` sizes,
no card). The program's kernels build once into the checkout
(``src/repro_torch/kernels/_build/``); the caches below stay inside it too.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


def _environment():
    """Fixed cache directories inside the checkout; no JAX in this
    process, whatever a library would load."""
    cache = REPO / ".pbcache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(HERE), str(REPO / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _environment()
    import torch
    from pbench import bench, spec

    man = spec.manifest()
    chips = spec.workload(man, args.workload)["chips"]
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            bench.log(f"{args.workload} needs {chips} CUDA device(s); "
                      f"found {torch.cuda.device_count()}")
            return 3
        torch.set_num_threads(4)
    res = bench.run_cell(args.workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         t_process=T_PROCESS, device=args.device,
                         rehearse=args.device == "cpu", manifest=man)
    bad = bench.forbidden_modules()
    if bad:
        bench.log(f"modules loaded that the benchmark must not load: {bad}")
        return 4
    for name, c in res["checks"].items():
        bench.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
