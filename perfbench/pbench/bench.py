"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference, and the result line's fields.

The pieces (:func:`prepare`, :func:`warm`, :func:`measure`,
:func:`verify`) are also what ``sweep.py`` (the rate sweep) and
``calibrate.py`` (the readings a limit is set from) drive, over one
set-up."""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from pbench import check, clients, loop, spec, traffic
from pbench import trace as trace_mod
from pbench.system import System
from pbench.weights import Weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the traced part of a --trace 1 run: from this share of the window, for
# this many seconds
TRACE_OFFSET = 0.3
TRACE_S = 3.0
# served tokens the comparison has to have checked (on the card; at the
# CPU rehearsal's sizes)
CHECK_TOKENS_MIN = 100
REHEARSAL_CHECK_TOKENS_MIN = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of the loaded modules that must not be loaded."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Cell:
    """A cell's files, its weights on the device and the system over them."""
    name: str
    w: dict
    cfg_file: dict
    mix: dict
    cs: dict                    # the cell's settings (cells/<cell>.json)
    m: dict                     # the model's published keys as run
    device: str
    rehearse: bool
    weights: Weights
    sys: Optional[System] = None

    @property
    def on_card(self) -> bool:
        return torch.device(self.device).type == "cuda"

    @property
    def params(self):
        return self.weights.tree


@dataclass
class RunData:
    """What the metric readers (``metrics/<name>.py``) read."""
    cell: str
    m: dict
    serve: dict
    window: loop.Window
    states: Dict[int, dict]     # rid -> the request at the window's close
    calls: List[clients.Call]
    setup_s: float
    pages: Optional[int]
    paged_int4: bool
    trace: Optional[trace_mod.Summary] = None

    def counted(self):
        return [(r, self.states[r.rid]) for r in self.window.counted()]

    def window_calls(self, kind: str, profiled: bool = False):
        w = self.window
        return [c for c in self.calls if c.kind == kind
                and w.start <= c.t0 and c.t1 <= w.end
                and (c.profiled or not profiled)]

    def op_patterns(self, name: str) -> List[str]:
        return spec.op_patterns(name)


def prepare(name: str, *, seed: int, device: str = "cuda",
            rehearse: bool = False, manifest: Optional[dict] = None
            ) -> Cell:
    man = manifest or spec.manifest()
    w = spec.workload(man, name)
    cfg_file = spec.config(w["config"])
    cs = dict(spec.cell_settings(name))
    if rehearse:
        cs.update(cs["rehearsal"])
    m = spec.model_keys(cfg_file, rehearse)
    t = time.perf_counter()
    weights = Weights(m, device)
    weights.fill(seed)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"set-up: {weights.nbytes:,} bytes of weights made in "
        f"{time.perf_counter() - t:.2f} s")
    c = Cell(name, w, cfg_file, spec.traffic(w["traffic"]), cs, m, device,
             rehearse, weights)
    c.sys = System(cfg_file, c.params, device, rehearse=rehearse)
    return c


def arrivals_for(c: Cell, seed: int, seconds: float,
                 rate: Optional[float] = None):
    arr = traffic.schedule(
        c.mix, rate=rate or c.cs["rate_per_s"], lead_in_s=c.cs["lead_in_s"],
        seconds=seconds, max_seq=c.sys.serve["max_seq"],
        in_scale=c.cs.get("in_scale", 1.0),
        out_scale=c.cs.get("out_scale", 1.0))
    return arr, traffic.prompt_tokens(arr, c.m["vocab_size"], seed)


def warm(c: Cell, arrivals, trace: bool):
    """The cell's prefill shapes, the decode engine and its chunk's graph
    (and for a traced run the profiler's first start)."""
    t = time.perf_counter()
    if c.sys.pre is None:
        c.sys = System(c.cfg_file, c.params, c.device, rehearse=c.rehearse)
    c.sys.warm_prefill([a.n_in for a in arrivals])
    t1 = time.perf_counter()
    c.sys.build_decode()
    c.sys.warm_decode()
    t2 = time.perf_counter()
    if trace and c.on_card:
        trace_mod.warm_cupti()
    log(f"set-up: prefill shapes {t1 - t:.2f} s, decode engine and its "
        f"graph {t2 - t1:.2f} s"
        + (f" ({c.sys.pages:,} pages)" if c.sys.pages else "")
        + (f", profiler {time.perf_counter() - t2:.2f} s" if trace else ""))


@dataclass
class Measured:
    data: RunData
    done: List[dict]            # finished requests: rid, served tokens
    prompts: Dict[int, np.ndarray]


def measure(c: Cell, arrivals, prompts, *, seconds: float, trace: bool,
            t_process: Optional[float] = None,
            drain_s: float = 0.0) -> Measured:
    """The open loop over ``arrivals``: a lead-in, then the window (then a
    drain of up to ``drain_s``, for the rate sweep)."""
    rec = clients.Recorder(timed=trace, device=c.device)
    gw = c.sys.gateway(rec, time.perf_counter)
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_process if t_process is not None else float("nan")
    ws, we = t0 + c.cs["lead_in_s"], t0 + c.cs["lead_in_s"] + seconds
    tw = None
    if trace and c.on_card:
        start = ws + TRACE_OFFSET * seconds
        tw = trace_mod.Window(rec, start, start + TRACE_S)
    win = loop.serve(gw, arrivals, prompts, t0=t0, window=(ws, we), rec=rec,
                     tick=tw.tick if tw else None,
                     ranges=trace and c.on_card, drain_s=drain_s)
    if tw is not None:
        tw.stop()
    rec.resolve()
    gc.unfreeze()
    summary = tw.read() if tw is not None else None
    states = {r.rid: loop.state_at(r, we) for r in win.reqs}
    data = RunData(c.name, c.m, c.sys.serve, win, states, rec.calls,
                   setup_s, c.sys.pages, bool(c.sys.dec.paged), summary)
    late = sorted(win.lateness)
    if late:
        log(f"loop lateness: {len(late)} submits, median "
            f"{late[len(late) // 2] * 1e3:.3f} ms, max "
            f"{late[-1] * 1e3:.3f} ms")
    done = [{"rid": r.rid, "tokens": list(r.handle.tokens)}
            for r in win.reqs if r.handle is not None
            and r.handle.state == "DONE"]
    for r in win.reqs:
        r.handle = None            # the gateway goes with its handles
    return Measured(data, done,
                    {a.rid: np.asarray(p, np.int64)
                     for a, p in zip(arrivals, prompts)})


def metrics_of(man: dict, data: RunData, trace: bool) -> dict:
    out = {}
    for mm in spec.metrics_for(man, data.cell, trace):
        v = spec.metric_reader(mm["name"])(data)
        if v is not None:
            out[mm["name"]] = {"value": v, "unit": mm["unit"]}
    return out


def failed_of(data: RunData) -> int:
    return sum(1 for _, st in data.counted()
               if st["state"] in ("FAILED", "REJECTED", "CANCELLED"))


def verify(c: Cell, got: Measured, seed: int, *, control: bool = False
           ) -> dict:
    """Free the program's state, then compare a sample of the finished
    requests with the plain reference."""
    c.sys.free()
    gc.collect()
    picked = check.sample(got.done, seed, c.cs["check_tokens"],
                          c.cs.get("check_requests", 1))
    t = time.perf_counter()
    read = check.compare(spec.reference_module(c.w["config"]), c.m,
                         c.params, picked, got.prompts, control=control,
                         log=log)
    log(f"reference: {read['requests_checked']} requests, "
        f"{read['tokens_checked']} served tokens in "
        f"{time.perf_counter() - t:.1f} s")
    return read


def checks_of(c: Cell, read: dict) -> Dict[str, dict]:
    limits = c.cfg_file["rehearsal"]["correct"] if c.rehearse \
        else c.cfg_file["correct"]
    out = {k: {"value": read.get(k, float("inf")), "limit": v}
           for k, v in limits.items()}
    out["tokens_checked"] = {"value": read["tokens_checked"],
                             "limit": REHEARSAL_CHECK_TOKENS_MIN
                             if c.rehearse else CHECK_TOKENS_MIN}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    """Every compared number within its limit: at most it, but the count
    of tokens checked, at least it."""
    return all((v["value"] >= v["limit"]) if k == "tokens_checked"
               else (v["value"] <= v["limit"]) for k, v in checks.items())


def device_of(c: Cell) -> dict:
    """The result's ``device``: the card and its memory's peak so far (read
    at the window's close, before the reference runs)."""
    if not c.on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             rehearse: bool = False, manifest: Optional[dict] = None
             ) -> dict:
    """One run; returns the result line's object, ``checks`` last."""
    man = manifest or spec.manifest()
    c = prepare(name, seed=seed, device=device, rehearse=rehearse,
                manifest=man)
    arrivals, prompts = arrivals_for(c, seed, seconds)
    warm(c, arrivals, trace)
    got = measure(c, arrivals, prompts, seconds=seconds, trace=trace,
                  t_process=t_process)
    dev = device_of(c)
    data = got.data
    metrics = metrics_of(man, data, trace)
    counted = data.counted()
    log(f"window: {len(counted)} requests due, "
        f"{sum(st['done'] for _, st in counted)} done by its close, "
        f"{failed_of(data)} failed; {len(got.done)} finished in the run")
    checks = checks_of(c, verify(c, got, seed))
    out = {"correct": passed(checks), "attempted": len(counted),
           "failed": failed_of(data), "metrics": metrics, "device": dev}
    if data.trace is not None:
        traced = data.window_calls("decode", True)
        log(f"trace: {data.trace.window_s:.3f} s; "
            f"{len(data.window_calls('prefill', True))} prefill calls, "
            f"{len(traced)} decode calls of "
            f"{sum(c.n_steps for c in traced)} steps; "
            + ", ".join(f"{op} {data.trace.count_of(spec.op_patterns(op))}"
                        f" launches" for op in spec.op_names()))
        dev.update(busy_s=data.trace.busy_s, window_s=data.trace.window_s)
        out["breakdown"] = {"device_ops": data.trace.device_ops,
                            "idle_gaps": data.trace.idle_gaps}
    out["checks"] = checks
    return out
