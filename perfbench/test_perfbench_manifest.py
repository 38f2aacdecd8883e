"""``BENCHMARK.json`` and the files it reaches, on the CPU: every name's
file found, the manifest's form, what the harness and the reference may
import, and a checkout holding only the benchmark refusing to run."""
from __future__ import annotations

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO / "src")]

from pbench import spec  # noqa: E402

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_name_reaches_its_file():
    for key, path in spec.files_by_name(MAN).items():
        assert path.is_file(), key
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(spec.metric_reader(m["name"])), m["name"]
    for c in MAN["configs"]:
        assert callable(spec.reference_module(c["name"]).logits_many)
        assert spec.config(c["name"])["name"] == c["name"]
    for p in (HERE / "ops").glob("*.json"):
        pats = spec.op_patterns(p.stem)
        assert pats and all(re.compile(x) for x in pats)
    for w in MAN["workloads"]:
        cs = spec.cell_settings(w["name"])
        assert cs["rate_per_s"] > 0 and cs["check_tokens"] > 0


def test_manifest_form():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in [c["name"]] + c["reduced"])
        assert c["file"].startswith("perfbench/")
        assert sorted(spec.config(c["name"])["reduced"]) == \
            sorted(c["reduced"])
    cells = {w["name"]: w for w in MAN["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        # the metric it moves is reported in each of its cells
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        bad = {n for n in _imports(path)} & {"jax", "jaxlib", "flax",
                                              "repro", "benchmarks"}
        assert not bad, f"{path}: imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        names = set(_imports(path))
        assert names <= {"__future__", "contextlib", "math", "torch",
                         "numpy", "reference"}, f"{path}: {names}"


def test_a_checkout_of_the_benchmark_alone_refuses_to_run(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         MAN["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
