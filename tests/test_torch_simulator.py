"""The port's serving simulator and the paper's baselines against the JAX
package's, on the CPU.

``repro_torch.core.simulator`` and ``repro_torch.core.baselines`` are
copies of ``repro.core``'s (numpy only; ``tests/test_torch_isolation.py``
holds their code to the reference's). Here both packages plan, generate
requests and simulate side by side, and every result must be EXACTLY
equal: the deployment plan, each ``SimResult`` field, and every request's
first-token and completion times and routing, for both workloads and both
wire formats; each baseline's plan and its simulated result; and
``min_slo_scale_for``. Requests are generated in each package separately,
because ``simulate`` writes into them. The reference's own simulator
properties (``tests/test_simulator.py``) then run on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import baselines as j_base  # noqa: E402
from repro.core import cluster as j_cluster  # noqa: E402
from repro.core import orchestrator as j_orch  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core import workload as j_wl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core import orchestrator as t_orch  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core import workload as t_wl  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

SIDES = {
    "jax": (j_cluster, j_orch, j_sched, j_wl, j_sim, j_base, j_get_config),
    "torch": (t_cluster, t_orch, t_sched, t_wl, t_sim, t_base, get_config),
}
WORKLOADS = ("coding", "conversation")


def _side(side):
    cl, orch, sched, wl, sim, base, get_cfg = SIDES[side]
    return dict(cl=cl, orch=orch, sched=sched, wl=wl, sim=sim, base=base,
                cfg=get_cfg("llama-30b"),
                slo=orch.SloSpec(2.0, 0.15, 30.0))


@pytest.fixture(scope="module")
def plans():
    """The reference test's plan, made by each package."""
    out = {}
    for side in SIDES:
        s = _side(side)
        out[side] = s["sched"].schedule(
            s["cl"].make_paper_cloud(), s["cfg"], s["wl"].CONVERSATION, 2.0,
            s["slo"], n_step=10, seed=0, patience=8)
    return out


def _plan_key(replicas, o):
    key = [(list(r.devices), r.phase, r.pc.describe(),
            r.cost.max_decode_batch) for r in replicas]
    if o is not None:
        key.append([getattr(o, n).tolist() for n in ("X", "Y", "Z", "D")]
                   + [o.attainment, o.served_frac])
    return key


def _sim_key(res):
    fields = ("duration", "ttft_attain", "tpot_attain", "e2e_attain",
              "throughput_tokens", "throughput_reqs", "p50_e2e", "p99_e2e",
              "kv_comm_frac")
    return ([getattr(res, f) for f in fields],
            [(r.rid, r.t_arrive, r.n_in, r.n_out, r.t_prefill_start,
              r.t_first_token, r.t_done, r.prefill_replica,
              r.decode_replica) for r in res.requests])


def _requests(side, workload, *, rate=2.0, duration=40, seed=3):
    wl = SIDES[side][3]
    return wl.generate(wl.WORKLOADS[workload], rate=rate, duration=duration,
                       seed=seed)


def test_plans_are_equal(plans):
    j, t = plans["jax"], plans["torch"]
    assert j.describe() == t.describe()
    assert (j.solution.groups, j.solution.phases, j.score, j.evals) == \
        (t.solution.groups, t.solution.phases, t.score, t.evals)
    assert _plan_key(j.replicas, j.orchestration) == \
        _plan_key(t.replicas, t.orchestration)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_simulate_equals_reference(plans, workload, compress):
    keys = {}
    for side in SIDES:
        s, plan = _side(side), plans[side]
        res = s["sim"].simulate(s["cl"].make_paper_cloud(), s["cfg"],
                                plan.replicas, plan.orchestration,
                                _requests(side, workload), s["slo"],
                                compress=compress)
        assert len(res.requests) > 0
        keys[side] = _sim_key(res)
    assert keys["jax"] == keys["torch"]


def _baseline(side, name, workload):
    s = _side(side)
    wl = s["wl"].WORKLOADS[workload]
    if name == "hexgen":
        return s["base"].hexgen_like(s["cl"].make_paper_cloud(), s["cfg"],
                                     wl, 2.0, s["slo"])
    fn = {"vllm": s["base"].vllm_like,
          "distserve": s["base"].distserve_like}[name]
    return fn(s["cfg"], wl, 2.0, s["slo"], seed=0)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("name", ["vllm", "distserve", "hexgen"])
def test_baseline_plan_and_simulation_equal_reference(name, workload):
    keys = {}
    for side in SIDES:
        s = _side(side)
        bl = _baseline(side, name, workload)
        assert bl.replicas
        res = s["sim"].simulate(bl.cluster, s["cfg"], bl.replicas,
                                bl.orchestration, _requests(side, workload),
                                s["slo"], compress=bl.compress,
                                colocated=bl.colocated)
        keys[side] = (bl.name, bl.colocated, bl.compress,
                      bl.cluster.types(),
                      _plan_key(bl.replicas, bl.orchestration),
                      _sim_key(res))
    assert keys["jax"] == keys["torch"]


@pytest.mark.parametrize("kind,target", [("e2e", 0.9), ("ttft", 0.5)])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_min_slo_scale_for_equals_reference(plans, workload, kind, target):
    got = {}
    for side in SIDES:
        s, plan = _side(side), plans[side]
        got[side] = s["sim"].min_slo_scale_for(
            s["cl"].make_paper_cloud(), s["cfg"], plan.replicas,
            plan.orchestration, _requests(side, workload, rate=1.0,
                                          duration=30, seed=4),
            s["slo"], target=target, kind=kind)
    assert got["jax"] == got["torch"]


# -- the reference's simulator properties, on the port --------------------------


def _slo_scale_monotone(plan, s):
    reqs = _requests("torch", "conversation", seed=0)
    prev = -1.0
    for scale in (0.25, 1.0, 4.0):
        res = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                                plan.orchestration, reqs,
                                s["slo"].scaled(scale))
        assert res.e2e_attain >= prev - 1e-9
        prev = res.e2e_attain


def _every_request_finishes(plan, s):
    reqs = _requests("torch", "conversation", duration=30, seed=1)
    res = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                            plan.orchestration, reqs, s["slo"])
    assert len(res.requests) == len(reqs)
    assert all(r.t_done >= r.t_first_token >= r.t_arrive - 1e-9
               for r in res.requests)


def _overload_degrades_latency(plan, s):
    lo = _requests("torch", "conversation", rate=1.0, seed=2)
    hi = _requests("torch", "conversation", rate=16.0, seed=2)
    r_lo = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                             plan.orchestration, lo, s["slo"])
    r_hi = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                             plan.orchestration, hi, s["slo"])
    assert r_hi.p99_e2e >= r_lo.p99_e2e


def _compression_reduces_kv_time_fraction(plan, s):
    reqs = _requests("torch", "conversation", seed=3)
    r_raw = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                              plan.orchestration, reqs, s["slo"],
                              compress=False)
    r_c = s["sim"].simulate(s["cluster"], s["cfg"], plan.replicas,
                            plan.orchestration, reqs, s["slo"],
                            compress=True)
    assert r_c.kv_comm_frac < r_raw.kv_comm_frac


def _min_slo_scale_finite(plan, s):
    reqs = _requests("torch", "conversation", rate=1.0, duration=30, seed=4)
    assert s["sim"].min_slo_scale_for(
        s["cluster"], s["cfg"], plan.replicas, plan.orchestration, reqs,
        s["slo"], target=0.5) < float("inf")


PROPERTIES = {f.__name__.lstrip("_"): f for f in (
    _slo_scale_monotone, _every_request_finishes, _overload_degrades_latency,
    _compression_reduces_kv_time_fraction, _min_slo_scale_finite)}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_simulator_property_holds_on_the_port(plans, prop):
    s = dict(_side("torch"), cluster=t_cluster.make_paper_cloud())
    PROPERTIES[prop](plans["torch"], s)
