"""The reference's end-to-end system cases (``tests/test_system.py``) on the
port: schedule on the paper's cloud and simulate (TSTP routing against
random dispatch), serve real reduced-config engines through the gateway,
adapt to a workload shift by lightweight rescheduling, and reweight
routing away from a straggler. The engines are the port's on the CPU, with
random weights from ``init_params``; the reference's default decode engine
is the dense one, so these say ``paged=False``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import scheduler  # noqa: E402
from repro_torch.core.cluster import make_paper_cloud  # noqa: E402
from repro_torch.core.orchestrator import Orchestration, SloSpec  # noqa: E402
from repro_torch.core.simulator import simulate  # noqa: E402
from repro_torch.core.workload import CODING, CONVERSATION, generate  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, GenRequest,  # noqa: E402
                                        PrefillEngine)
from repro_torch.serving.gateway import Gateway  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

SLO = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_reduced("llama-30b")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _dense(cfg, params, **kw):
    return DecodeEngine(cfg, params, max_seq=64, paged=False, device="cpu",
                        **kw)


def test_schedule_then_simulate_beats_random_dispatch():
    """Fig. 12's orchestration claim: TSTP routing > random dispatch."""
    cfg = get_config("llama-30b")
    cluster = make_paper_cloud()
    plan = scheduler.schedule(cluster, cfg, CONVERSATION, 2.0, SLO,
                              n_step=12, seed=0, patience=10)
    reqs = generate(CONVERSATION, rate=2.0, duration=40, seed=5)
    res = simulate(cluster, cfg, plan.replicas, plan.orchestration, reqs,
                   SLO)
    res_rand = simulate(cluster, cfg, plan.replicas, None, reqs, SLO)
    assert res.e2e_attain >= res_rand.e2e_attain - 0.05


def test_full_pipeline_real_models(small_model):
    """Real computation end to end: every request completes and produces
    its tokens, with ordered timestamps."""
    cfg, params = small_model
    pre = [PrefillEngine(cfg, params, max_seq=64, device="cpu")]
    dec = [_dense(cfg, params, max_slots=4), _dense(cfg, params, max_slots=4)]
    gw = Gateway(pre, dec, compress=True)
    rng = np.random.default_rng(0)
    n = 8
    for rid in range(n):
        gw.submit(GenRequest(
            rid, rng.integers(1, cfg.vocab_size,
                              int(rng.choice([8, 12, 16]))).astype(np.int32),
            max_new_tokens=5))
    done = gw.run_until_drained(max_iters=400)
    assert len(done) == n
    for h in done:
        assert len(h.req.out_tokens) == 5
        assert h.t_done >= h.t_first >= h.t_submit


def test_workload_shift_triggers_lightweight_reschedule(small_model):
    cfg = get_config("llama-30b")
    cluster = make_paper_cloud()
    plan = scheduler.schedule(cluster, cfg, CODING, 2.0, SLO, n_step=10,
                              seed=0, patience=8)
    cfg_small, params = small_model
    gw = Gateway([PrefillEngine(cfg_small, params, max_seq=64,
                                device="cpu")],
                 [_dense(cfg_small, params, max_slots=2)],
                 orchestration=plan.orchestration)
    for i in range(16):
        gw.profiler.record(1024, 16, t=float(i))
    gw.profiler.set_baseline()
    for i in range(64):
        gw.profiler.record(1024, 140, t=float(16 + i))
    new_plan = gw.maybe_reschedule(cluster, cfg, plan, 2.0, SLO)
    assert new_plan is not None, "shift must trigger rescheduling"
    # conversation-ward shift: decode share must not shrink
    assert len(new_plan.decode_replicas) >= len(plan.decode_replicas)
    assert any("lightweight" in e for e in gw.events)


def test_straggler_routing_reweight(small_model):
    cfg, params = small_model
    o = Orchestration(X=np.array([1.0]), Y=np.array([[0.5, 0.5]]),
                      Z=np.array([[0.5, 0.5]]), D=np.ones((1, 2)),
                      attainment=1.0, served_frac=1.0)
    gw = Gateway([PrefillEngine(cfg, params, max_seq=64, device="cpu")],
                 [_dense(cfg, params, max_slots=2),
                  _dense(cfg, params, max_slots=2)],
                 orchestration=o)
    gw.dec[0].ema_latency = 0.01   # fast
    gw.dec[1].ema_latency = 0.10   # straggler
    gw.refresh_routing_from_latency()
    assert o.Y[0, 0] > o.Y[0, 1], "traffic must shift to the fast replica"
