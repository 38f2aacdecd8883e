"""The port's scheduler core against the JAX package's, on the CPU.

``repro_torch.core`` is a copy of ``repro.core`` (numpy/scipy only; see
``tests/test_torch_isolation.py`` for the AST comparison). Here the two
run side by side on the paper's two clusters for full-width LLaMA-30B and
must produce the SAME deployment plan: the same ``describe()`` (groups,
phases, parallel configs, score), the same search history and the same
orchestration masses within 1e-12. Lightweight rescheduling, node drops
and plan diffs are held to the reference the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import cluster as j_cluster  # noqa: E402
from repro.core import orchestrator as j_orch  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core import workload as j_wl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core import orchestrator as t_orch  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core import workload as t_wl  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

RATE = 2.0
SIDES = {
    "jax": (j_cluster, j_orch, j_sched, j_wl, j_get_config),
    "torch": (t_cluster, t_orch, t_sched, t_wl, get_config),
}
CASES = [(c, w) for c in ("paper_cloud", "inhouse")
         for w in ("coding", "conversation")]


def _run(side, cluster_name, workload):
    cl, orch, sched, wlm, get_cfg = SIDES[side]
    cluster = cl.make_cluster(cluster_name)
    cfg = get_cfg("llama-30b")
    slo = orch.SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)
    wl = wlm.WORKLOADS[workload]
    other = wlm.WORKLOADS["conversation" if workload == "coding"
                          else "coding"]
    plan = sched.schedule(cluster, cfg, wl, RATE, slo, n_step=8, seed=0)
    shifted = sched.reschedule_lightweight(cluster, cfg, plan, other,
                                           RATE * 1.5, slo, n_step=6)
    dead = list(plan.replicas[0].devices[:1])
    survivors = sched.drop_nodes(cluster, plan, dead)
    failover = sched.reschedule_lightweight(
        cluster, cfg, plan, wl, RATE, slo, n_step=6,
        init_solution=survivors)
    return {"plan": plan, "shifted": shifted, "survivors": survivors,
            "failover": failover,
            "delta": sched.plan_diff(plan, shifted),
            "delta_fail": sched.plan_diff(plan, failover)}


@pytest.fixture(scope="module")
def runs():
    return {case: {side: _run(side, *case) for side in SIDES}
            for case in CASES}


def _same_plan(a, b):
    assert a.describe() == b.describe()
    assert a.solution.groups == b.solution.groups
    assert a.solution.phases == b.solution.phases
    assert a.evals == b.evals
    np.testing.assert_allclose(a.search_history, b.search_history,
                               rtol=0, atol=1e-12)
    assert abs(a.score - b.score) <= 1e-12
    oa, ob = a.orchestration, b.orchestration
    assert (oa is None) == (ob is None)
    if oa is not None:
        for name in ("X", "Y", "Z", "D"):
            np.testing.assert_allclose(getattr(oa, name), getattr(ob, name),
                                       rtol=0, atol=1e-12, err_msg=name)
        assert abs(oa.attainment - ob.attainment) <= 1e-12
        assert abs(oa.served_frac - ob.served_frac) <= 1e-12
    for ra, rb in zip(a.replicas, b.replicas):
        assert ra.pc.describe() == rb.pc.describe()


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_schedule_gives_the_reference_plan(runs, case):
    _same_plan(runs[case]["jax"]["plan"], runs[case]["torch"]["plan"])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_reschedule_lightweight_gives_the_reference_plan(runs, case):
    _same_plan(runs[case]["jax"]["shifted"], runs[case]["torch"]["shifted"])
    _same_plan(runs[case]["jax"]["failover"],
               runs[case]["torch"]["failover"])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_drop_nodes_and_plan_diff_match(runs, case):
    j, t = runs[case]["jax"], runs[case]["torch"]
    assert j["survivors"].groups == t["survivors"].groups
    assert j["survivors"].phases == t["survivors"].phases
    for key in ("delta", "delta_fail"):
        dj, dt = j[key], t[key]
        assert dj.describe() == dt.describe()
        assert dj.is_noop == dt.is_noop
        for f in ("flips", "kept", "dropped", "added"):
            assert getattr(dj, f) == getattr(dt, f), (key, f)


def test_clusters_match_and_tpu_fleet_is_left_out():
    for name in ("paper_cloud", "inhouse"):
        a, b = j_cluster.make_cluster(name), t_cluster.make_cluster(name)
        assert a.types() == b.types()
        np.testing.assert_array_equal(a.bw, b.bw)
        assert a.price_per_hr() == b.price_per_hr()
        assert [(d.idx, d.node, d.chip.name, d.chip.peak_flops,
                 d.chip.hbm_bw, d.chip.hbm_bytes) for d in a.devices] == \
            [(d.idx, d.node, d.chip.name, d.chip.peak_flops, d.chip.hbm_bw,
              d.chip.hbm_bytes) for d in b.devices]
    with pytest.raises(ValueError, match="TPU"):
        t_cluster.make_cluster("tpu_fleet")


def test_workload_traces_match():
    for name in ("coding", "conversation"):
        a = j_wl.generate(j_wl.WORKLOADS[name], rate=3.0, duration=20.0,
                          seed=4)
        b = t_wl.generate(t_wl.WORKLOADS[name], rate=3.0, duration=20.0,
                          seed=4)
        assert [(r.rid, r.t_arrive, r.n_in, r.n_out) for r in a] == \
            [(r.rid, r.t_arrive, r.n_in, r.n_out) for r in b]
