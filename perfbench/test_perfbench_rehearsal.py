"""Whole runs of each cell on the CPU at its rehearsal sizes (no card): the
program's run comes out correct; the control (the reference in fp8, put
in the program's place) fails a compared number; and with the timed path
broken underneath (each decode chunk's last token altered where the
engine produces it) the run comes out not correct."""
from __future__ import annotations

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from pbench import bench, spec  # noqa: E402

torch.set_num_threads(2)
CELLS = [w["name"] for w in spec.manifest()["workloads"]]
SECONDS = 3.0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_and_the_control_fails(cell):
    c = bench.prepare(cell, seed=11, device="cpu", rehearse=True)
    arrivals, prompts = bench.arrivals_for(c, 11, SECONDS)
    bench.warm(c, arrivals, trace=False)
    got = bench.measure(c, arrivals, prompts, seconds=SECONDS, trace=False)
    read = bench.verify(c, got, 11, control=True)
    assert bench.passed(bench.checks_of(c, read)), read
    control = {k[len("control_"):]: v for k, v in read.items()
               if k.startswith("control_")}
    control["tokens_checked"] = read["tokens_checked"]
    assert not bench.passed(bench.checks_of(c, control)), read


@pytest.mark.parametrize("cell", CELLS)
def test_a_token_altered_where_it_is_produced_fails(cell, monkeypatch):
    from repro_torch.serving import engine
    step = engine.DecodeEngine.step

    def altered(self, *a, **k):
        had = {id(r): len(r.out_tokens) for r in self.slots if r is not None}
        finished = step(self, *a, **k)
        for r in [r for r in self.slots if r is not None] + finished:
            if len(r.out_tokens) > had.get(id(r), len(r.out_tokens)):
                r.out_tokens[-1] = (r.out_tokens[-1] + 1) \
                    % self.cfg.vocab_size
        return finished

    monkeypatch.setattr(engine.DecodeEngine, "step", altered)
    res = bench.run_cell(cell, seed=12, seconds=SECONDS, trace=False,
                         t_process=time.perf_counter(), device="cpu",
                         rehearse=True)
    assert res["correct"] is False, res["checks"]
