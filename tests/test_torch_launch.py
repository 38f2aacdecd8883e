"""The port's evaluation and fault-tolerance entry points on the CPU.

* ``launch.serve_e2e --chaos`` on the reduced model, on int4 pages and
  with ``--no-paged``: both chaos events fire, every request is DONE with
  its full budget, the preemption migrates, no page leaks, every engine
  keeps the weights it was given, and the engines (the dead ones too) go
  with the run's results. Without ``--device cpu`` on a machine with no
  card it raises.
* ``launch.quickstart`` prints the plans the reference's
  ``examples/quickstart.py`` prints, and ``launch.reschedule_demo``'s
  scenarios 1-2 simulate exactly the attainments and throughputs the
  reference's demo does (its ``simulate`` calls recorded, in order);
  scenario 3 runs live on the CPU without a drop or a reload.
"""
import gc
import importlib.util
import pathlib
import re
import sys
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import quickstart as t_quickstart  # noqa: E402
from repro_torch.launch import reschedule_demo as t_demo  # noqa: E402
from repro_torch.launch import serve_e2e  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAOS = ["--device", "cpu", "--reduced", "--chaos", "--requests", "8",
         "--rate", "3", "--max-new", "32"]


def _example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--no-paged"]],
                         ids=["int4_pages", "dense"])
def test_serve_e2e_chaos_loses_no_request(extra, capsys):
    out = serve_e2e.run(CHAOS + extra)
    s, c = out["summary"], out["stats"]["counters"]
    assert s["n_submitted"] == 8
    assert all(h.state == "DONE" and len(h.tokens) == 32
               for h in out["handles"])
    assert [f["kind"] for f in out["fired"]] == ["crash", "preempt"]
    assert c["preemptions"] == 1
    assert c["migrations"] >= 1 and c["migrated_tokens"] > 0
    assert 1 <= len(out["dead"]) <= 2
    assert all(p["leaked_pages"] == 0 for p in out["page_stats"])
    assert (out["page_stats"] == []) == bool(extra)
    assert out["params_resident"]
    assert all(h.engine.active == 0 for h in out["gateway"].dec
               if h.status == "dead")
    text = capsys.readouterr().out
    assert "chaos armed: decode crash at ~0.8s, spot preemption (grace " \
        "0.75s) at ~1.5s" in text
    assert "chaos fired:" in text and "8/8 done" in text
    engines = [weakref.ref(d) for d in out["decodes"]]
    del out
    gc.collect()
    assert all(e() is None for e in engines), "an engine outlived its run"


def test_serve_e2e_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_e2e.run(["--reduced", "--requests", "1"])


def test_quickstart_prints_the_reference_plans(capsys, monkeypatch):
    plans = t_quickstart.main(["--steps", "6"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--steps", "6"])
    _example("quickstart").main()
    theirs = capsys.readouterr().out

    def drop_search_time(text):
        return re.sub(r"search: [0-9.]+s", "search: _s", text)

    assert drop_search_time(mine) == drop_search_time(theirs)
    assert set(plans) == {"coding", "conversation"}
    assert all(p.describe() in mine for p in plans.values())


def test_reschedule_demo_offline_equals_reference(monkeypatch, capsys):
    ref = _example("reschedule_demo")
    recorded = []
    simulate = ref.simulate

    def record(*a, **kw):
        recorded.append(simulate(*a, **kw))
        return recorded[-1]

    monkeypatch.setattr(ref, "simulate", record)
    ref.offline_scenarios()
    got = t_demo.offline_scenarios()
    capsys.readouterr()
    keys = [("shift", "stale plan"), ("shift", "lightweight"),
            ("failure", "no-resched"), ("failure", "lightweight"),
            ("failure", "full")]
    assert list(got["results"]) == keys and len(recorded) == len(keys)
    for key, theirs in zip(keys, recorded):
        mine = got["results"][key]
        for f in ("e2e_attain", "ttft_attain", "tpot_attain",
                  "throughput_tokens", "throughput_reqs", "p99_e2e",
                  "kv_comm_frac"):
            assert getattr(mine, f) == getattr(theirs, f), (key, f)


def test_reschedule_demo_live_on_cpu(capsys):
    out = t_demo.live_scenario("cpu")
    s = out["summary"]
    assert s["n_done"] == s["n_submitted"] == 28
    assert out["params_resident"]
    assert "no-reload invariant: params resident across flip = True" in \
        capsys.readouterr().out
