"""Render the roofline table from the per-cell dry-run JSONs in
results/dryrun_torch/ (the port's copy of ``repro.roofline.report``; the
reference's records are in results/dryrun/, the port's
``launch/dryrun.py`` writes its own). The terms are counted from shapes
(``roofline/op_cost.py``) against the H100's published peaks, not
measured."""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

ADVICE = {
    ("memory", "train"): "raise arithmetic intensity: relax the full-recompute "
                         "remat policy (save dot outputs) and fuse optimizer",
    ("memory", "prefill"): "larger attention tiles / fused blocks to cut "
                           "activation traffic",
    ("memory", "decode"): "in-place KV update (fori_loop + donation) instead "
                          "of scan-ys cache rewrite",
    ("compute", "train"): "near-roofline; overlap DP all-reduce with bwd",
    ("compute", "prefill"): "near-roofline; overlap TP collectives",
    ("compute", "decode"): "batch more sequences per step",
    ("collective", "train"): "reduce-scatter+all-gather instead of all-reduce; "
                             "overlap with compute",
    ("collective", "prefill"): "shard sequence instead of heads; compress "
                               "a2a payloads",
    ("collective", "decode"): "replicate small weights; fuse collectives",
}


def load_cells(mesh: str = "single", tag: str = "baseline") -> List[dict]:
    out = []
    for p in sorted(RESULTS.glob(f"{mesh}_*_{tag}.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") == "ok":
            out.append(rec)
    return out


def _kind(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode"}[shape]


def table(mesh: str = "single", tag: str = "baseline") -> str:
    cells = load_cells(mesh, tag)
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | "
           "bottleneck | MODEL_FLOPS | useful | roofline-frac | next lever |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in cells:
        advice = ADVICE.get((r["bottleneck"], _kind(r["shape"])), "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['bottleneck']}** | {r['model_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} | "
            f"{advice} |")
    return "\n".join(lines)


def pick_hillclimb_cells(mesh: str = "single") -> Dict[str, dict]:
    """The three §Perf cells: worst roofline fraction, most collective-bound,
    most representative of the paper's technique (largest dense-serving
    decode — the phase-splitting target)."""
    cells = load_cells(mesh)
    by = {(c["arch"], c["shape"]): c for c in cells}
    worst = min(cells, key=lambda c: c["roofline_frac"])
    coll = max(cells, key=lambda c: c["collective_s"] / max(c["step_s"], 1e-12))
    paper = by.get(("command-r-35b", "decode_32k")) or worst
    return {"worst_roofline_frac": worst, "most_collective_bound": coll,
            "paper_representative": paper}


def summarize(mesh: str = "single", tag: str = "baseline") -> dict:
    cells = load_cells(mesh, tag)
    if not cells:
        return {}
    return {
        "n": len(cells),
        "bottlenecks": {b: sum(1 for c in cells if c["bottleneck"] == b)
                        for b in ("compute", "memory", "collective")},
        "mean_useful": sum(c["useful_ratio"] for c in cells) / len(cells),
    }


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(table(mesh))
    print()
    print(summarize(mesh))
    for k, c in pick_hillclimb_cells(mesh).items():
        print(f"{k}: {c['arch']} x {c['shape']} "
              f"(frac={c['roofline_frac']:.3f}, "
              f"coll_share={c['collective_s']/max(c['step_s'],1e-12):.2f})")
