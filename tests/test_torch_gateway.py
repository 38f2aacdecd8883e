"""The port's gateway against the JAX package's, and the reference's
gateway contracts re-pinned inside the port (CPU, reduced LLaMA-30B, f32).

* One open-loop trace on a ``VirtualClock`` through both packages'
  ``Gateway`` (one prefill engine, two paged decode engines with prefix
  sharing, ``prefill_chunk_tokens=16``): the same final states, counters,
  prefix-cache and page-pool statistics, and the same tokens where the JAX
  prefill's top-2 logit margin clears 1e-3 (the rule of
  ``tests/test_torch_serving.py``; at this seed every request clears it and
  the streams are compared whole). The virtual clock makes every routing
  and scheduling decision depend on the trace alone, not on how fast
  either framework computes.
* Within the port: a live ``apply_plan`` phase swap keeps every engine on
  the same parameter tensors and loses no request; a chaos crash loses no
  request; a preemption drain migrates resident KV and the streams are
  bit-identical to an undisturbed run; ``launch.serve.run`` serves a trace
  end to end; ``REPRO_SANITIZE=1`` installs the port's sanitizer.
* The reference's fault cases on DENSE decode engines
  (``tests/test_faults.py``, whose engines are dense by default) re-pinned
  on the port with a ``VirtualClock`` and no wall-clock threshold: a
  chaos crash recovers every request, a preemption drain migrates with
  zero loss (bit-identical streams over raw wires), a zero-grace drain
  requeues, and a dead replica triggers a failover reschedule;
  ``launch.serve.run --no-paged`` serves a trace end to end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import faults as JF  # noqa: E402
from repro.serving import gateway as JG  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core import tabu as t_tabu  # noqa: E402
from repro_torch.core.cluster import make_paper_cloud  # noqa: E402
from repro_torch.core.orchestrator import SloSpec  # noqa: E402
from repro_torch.core.workload import CONVERSATION  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import faults as TF  # noqa: E402
from repro_torch.serving import gateway as TG  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

MARGIN = 1e-3
PS = 8
PAGE_KEYS = ("in_use", "zero_copy_inserts", "reencoded_inserts",
             "cow_copies", "prefix_admits", "leaked_pages", "peak_in_use",
             "alloc_failures", "prefix_entries")


def _trace(V):
    """Arrivals (t, rid, prompt, max_new): fresh prompts sharing a
    one-page system prefix, a repeat of an earlier prompt (full prefix
    hit once its donor finished), prompts sharing two pages with an
    earlier one (partial hits) and prompts longer than the 16-token chunk
    budget."""
    rng = np.random.default_rng(21)
    system = rng.integers(1, V, PS)

    def prompt(n, head=system):
        return np.concatenate([head, rng.integers(1, V, n - len(head))]) \
            .astype(np.int32)

    p0, p1, p2 = prompt(13), prompt(37), prompt(24)
    out = [(0.00, 0, p0, 6), (0.01, 1, p1, 8), (0.02, 2, p2, 5),
           (0.03, 3, prompt(29), 7)]
    out += [(0.50, 4, p0.copy(), 6),                       # full hit
            (0.51, 5, prompt(30, head=p1[:2 * PS]), 6),    # partial hit
            (0.52, 6, prompt(45), 4),                      # chunked
            (0.53, 7, prompt(22, head=p2[:2 * PS]), 5)]    # partial hit
    return out


def _open_loop(E, G, F, cfg, params, **dev):
    clock = F.VirtualClock()
    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    decs = [E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, paged=True,
                           page_size=PS, chunk_size=4, prefix_sharing=True,
                           **dev) for _ in range(2)]
    gw = G.Gateway([pre], decs, clock=clock,
                   scheduler=G.SchedulerConfig(prefill_chunk_tokens=16))
    arrivals = [(t, G.ServeRequest(rid, p, n)) for t, rid, p, n in
                _trace(cfg.vocab_size)]
    handles = G.drive_open_loop(gw, arrivals)
    return {"gw": gw, "handles": handles, "decs": decs,
            "prompts": {r.rid: r.tokens for _, r in arrivals}}


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_reduced("llama-30b").replace(dtype="float32")
    tcfg = get_reduced("llama-30b").replace(dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    return {"jcfg": jcfg, "jparams": jax.tree.map(jnp.asarray, tree),
            "tcfg": tcfg, "tparams": convert.params_from_numpy(tree, tcfg,
                                                               "cpu")}


@pytest.fixture(scope="module")
def runs(models):
    return {"jax": _open_loop(JE, JG, JF, models["jcfg"], models["jparams"]),
            "torch": _open_loop(TE, TG, TF, models["tcfg"],
                                models["tparams"], device="cpu")}


def test_open_loop_final_states_and_counters_match(runs):
    j, t = runs["jax"], runs["torch"]
    assert [h.request.rid for h in j["handles"]] == \
        [h.request.rid for h in t["handles"]]
    assert [h.state for h in t["handles"]] == [TG.DONE] * 8
    assert [h.state for h in j["handles"]] == [h.state for h in t["handles"]]
    assert [h.restarts for h in j["handles"]] == \
        [h.restarts for h in t["handles"]]
    sj, st = j["gw"].stats(), t["gw"].stats()
    assert sj["counters"] == st["counters"]
    assert st["counters"]["chunked_prefills"] > 0
    assert sj["prefix"] == st["prefix"]
    assert st["prefix"]["hits"] >= 1 and st["prefix"]["partial_hits"] >= 1
    assert [r["status"] for r in sj["replicas"]] == \
        [r["status"] for r in st["replicas"]]


def test_open_loop_page_stats_match(runs):
    for dj, dt in zip(runs["jax"]["decs"], runs["torch"]["decs"]):
        pj, pt = dj.page_stats(), dt.page_stats()
        for k in PAGE_KEYS:
            assert pj[k] == pt[k], k
        assert pt["leaked_pages"] == 0


def test_open_loop_tokens_equal_where_margin_clears(runs, models):
    jcfg, jp = models["jcfg"], models["jparams"]
    checked = 0
    for hj, ht in zip(runs["jax"]["handles"], runs["torch"]["handles"]):
        prompt = runs["jax"]["prompts"][hj.request.rid]
        logits, _ = j_tf.prefill(jcfg, jp, jnp.asarray(prompt[None]),
                                 max_seq=len(prompt))
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        if top2[1] - top2[0] < MARGIN:
            continue
        assert list(hj.tokens) == list(ht.tokens), hj.request.rid
        checked += 1
    assert checked == 8


# -- within the port --------------------------------------------------------------


def _prompt(cfg, n=12, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, n) \
        .astype(np.int32)


def _gw(cfg, params, *, n_dec=2, chunk_size=2, **gw_kw):
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    decs = [TE.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                            page_size=PS, chunk_size=chunk_size,
                            device="cpu") for _ in range(n_dec)]
    return TG.Gateway([pre], decs, **gw_kw)


def _reqs(cfg, n, *, max_new=16, plen=12):
    return [TG.ServeRequest(i, _prompt(cfg, plen, seed=i), max_new)
            for i in range(n)]


def test_live_apply_plan_keeps_params_resident_and_drops_nothing(models):
    cfg, params = models["tcfg"], models["tparams"]
    slo = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)
    solver = t_sched.LowerLevelSolver(make_paper_cloud(),
                                      get_config("llama-30b"), CONVERSATION,
                                      2.0, slo)
    groups = ((0, 1, 2, 3), (4, 5, 6, 7), tuple(range(8, 16)),
              tuple(range(16, 24)))

    def plan(phases):
        sol = t_tabu.Solution(groups, tuple(phases))
        score, replicas, o = solver.solve(sol)
        return t_sched.DeploymentPlan(solution=sol, replicas=replicas,
                                      orchestration=o, score=score)

    plan_a = plan(("prefill", "prefill", "decode", "decode"))
    plan_b = plan(("decode", "decode", "prefill", "prefill"))
    gw = TG.gateway_from_plan(plan_a, cfg, params, max_seq=64, max_slots=4,
                              chunk_size=2, device="cpu",
                              decode_kw={"page_size": PS})
    tensors = {id(t) for lay in params["layers"] for d in lay.values()
               for t in (d.values() if isinstance(d, dict) else [d])}
    hs = [gw.submit(TG.ServeRequest(i, _prompt(cfg, 8 + 2 * (i % 3), i),
                                    max_new_tokens=12)) for i in range(6)]
    while not any(h.state == TG.DECODING for h in hs):
        gw.pump()
    in_flight = [h for h in hs if h.state == TG.DECODING]
    n_requeued = gw.apply_plan(t_sched.plan_diff(plan_a, plan_b))
    assert gw.epoch == 1 and n_requeued == len(in_flight) > 0
    assert {h.group for h in gw.dec} == {groups[0], groups[1]}
    for h in gw.pre + gw.dec:
        assert h.client.phase == h.phase
        assert h.engine.params is params
        assert {id(t) for lay in h.engine.params["layers"]
                for d in lay.values()
                for t in (d.values() if isinstance(d, dict) else [d])} \
            == tensors
    assert sum(h.client.replica.switches for h in gw.pre + gw.dec) == 4
    gw.run_until_drained()
    assert all(h.state == TG.DONE and len(h.tokens) == 12 for h in hs)
    for h in gw.dec:
        assert h.engine.page_stats()["leaked_pages"] == 0


def test_chaos_crash_loses_no_request(models):
    cfg, params = models["tcfg"], models["tparams"]
    clk = TF.VirtualClock()
    gw = _gw(cfg, params, clock=clk)
    sched = TF.FaultSchedule([TF.FaultEvent(t=0.0, kind=TF.CRASH,
                                            phase="decode", idx=-1,
                                            require_busy=True)])
    ctl = TF.install_chaos(gw, sched, clock=clk)
    hs = [gw.submit(r) for r in _reqs(cfg, 4, max_new=10)]
    gw.run_until_drained()
    assert [f["kind"] for f in ctl.fired] == [TF.CRASH]
    assert sum(d.status == "dead" for d in gw.dec) == 1
    assert all(h.state == TG.DONE and len(h.tokens) == 10 for h in hs)
    assert gw.stats()["counters"]["requeues"] >= 1


def test_preemption_migrates_bit_identical_streams(models):
    cfg, params = models["tcfg"], models["tparams"]
    reqs = _reqs(cfg, 3, max_new=20)
    base = _gw(cfg, params)
    bh = [base.submit(r) for r in reqs]
    base.run_until_drained()
    want = {h.request.rid: list(h.tokens) for h in bh}
    assert all(h.state == TG.DONE for h in bh)

    gw = _gw(cfg, params)
    hs = [gw.submit(r) for r in reqs]
    for _ in range(60):
        gw.pump()
        if (all(h.state == TG.DECODING for h in hs)
                and min(len(h.tokens) for h in hs) >= 2):
            break
    assert all(h.state == TG.DECODING for h in hs)
    vic = max(range(2), key=lambda j: len(gw.dec[j].client.resident()))
    n_vic = len(gw.dec[vic].client.resident())
    rep = gw.handle_preemption("decode", vic, grace_s=60.0)
    assert n_vic >= 1 and rep["migrated"] == n_vic
    assert rep["requeued"] == 0
    assert gw.dec[vic].engine.page_stats()["in_use"] == 0
    gw.run_until_drained()
    assert all(h.state == TG.DONE and h.restarts == 0 for h in hs)
    assert {h.request.rid: list(h.tokens) for h in hs} == want
    st = gw.stats()["counters"]
    assert st["migrations"] == n_vic and st["preemptions"] == 1
    for d in gw.dec:
        assert d.engine.page_stats()["reencoded_inserts"] == 0


def test_launch_serve_runs_end_to_end_on_cpu(capsys):
    out = t_serve.run(["--device", "cpu", "--reduced", "--duration", "3",
                       "--rate", "2", "--steps", "6", "--chunk-tokens",
                       "16"])
    s = out["summary"]
    assert s["n_submitted"] > 0 and s["n_done"] == s["n_submitted"]
    assert out["stats"]["counters"]["chunk_ticks"] > 0
    assert out["params_resident"]
    assert all(p["leaked_pages"] == 0 for p in out["page_stats"])
    text = capsys.readouterr().out
    assert "device: cpu" in text
    assert f"{s['n_done']}/{s['n_submitted']} requests done" in text


def test_launch_serve_refuses_the_tpu_fleet():
    with pytest.raises(SystemExit):
        t_serve.parse_args(["--cluster", "tpu_fleet"])


def test_repro_sanitize_raises(models, monkeypatch):
    """``REPRO_SANITIZE=1`` installs the port's sanitizer, whose drain
    check raises on a request whose history skips the state machine;
    ``REPRO_SANITIZE=0`` installs none."""
    from repro_torch.analysis.sanitizers import (GatewaySanitizer,
                                                 SanitizerError)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    gw = _gw(models["tcfg"], models["tparams"], n_dec=1)
    assert isinstance(gw.sanitizer, GatewaySanitizer)
    h = gw.submit(_reqs(models["tcfg"], 1, max_new=3)[0])
    gw.run_until_drained()
    assert h.state == TG.DONE
    h.history = [h.history[0], h.history[-1]]       # QUEUED -> DONE
    with pytest.raises(SanitizerError, match="illegal transition"):
        gw.sanitize_check("tampered")
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert _gw(models["tcfg"], models["tparams"]).sanitizer is None


# -- dense decode engines (the reference's fault tests' default) ------------------


def _dense_gw(cfg, params, *, n_dec=2, chunk_size=2, **gw_kw):
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    decs = [TE.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                            paged=False, chunk_size=chunk_size, device="cpu")
            for _ in range(n_dec)]
    return TG.Gateway([pre], decs, clock=TF.VirtualClock(), **gw_kw)


def test_dense_chaos_crash_recovers_all_requests(models):
    cfg, params = models["tcfg"], models["tparams"]
    gw = _dense_gw(cfg, params)
    sched = TF.FaultSchedule([TF.FaultEvent(t=0.0, kind=TF.CRASH,
                                            phase="decode", idx=-1,
                                            require_busy=True)])
    ctl = TF.install_chaos(gw, sched, clock=gw.clock)
    hs = [gw.submit(r) for r in _reqs(cfg, 4, max_new=10)]
    gw.run_until_drained()
    assert [f["kind"] for f in ctl.fired] == [TF.CRASH]
    assert sum(d.status == "dead" for d in gw.dec) == 1
    assert any("confirmed dead" in e for e in gw.events)
    assert all(h.state == TG.DONE and len(h.tokens) == 10 for h in hs)
    assert gw.stats()["counters"]["requeues"] >= 1
    assert gw.stats()["page_pool"] is None


@pytest.mark.parametrize("compress", [False, True])
def test_dense_preemption_migrates_with_zero_loss(models, compress):
    """A preemption drain moves resident dense-cache KV to the survivor:
    no request restarts and none loses a token; over raw wires the
    streams are bit-identical to an undisturbed run."""
    cfg, params = models["tcfg"], models["tparams"]
    reqs = _reqs(cfg, 3, max_new=20)
    base = _dense_gw(cfg, params, compress=compress)
    bh = [base.submit(r) for r in reqs]
    base.run_until_drained()
    want = {h.request.rid: list(h.tokens) for h in bh}

    gw = _dense_gw(cfg, params, compress=compress)
    hs = [gw.submit(r) for r in reqs]
    for _ in range(60):
        gw.pump()
        if (all(h.state == TG.DECODING for h in hs)
                and min(len(h.tokens) for h in hs) >= 2):
            break
    assert all(h.state == TG.DECODING for h in hs)
    vic = max(range(2), key=lambda j: len(gw.dec[j].client.resident()))
    n_vic = len(gw.dec[vic].client.resident())
    rep = gw.handle_preemption("decode", vic, grace_s=60.0)
    assert n_vic >= 1 and rep["migrated"] == n_vic
    assert rep["requeued"] == 0
    assert rep["tokens_migrated"] >= n_vic * 13   # 12 prompt + >= 1 decoded
    assert gw.dec[vic].status == "dead" and gw.dec[vic].engine.active == 0
    gw.run_until_drained()
    assert all(h.state == TG.DONE and h.restarts == 0
               and len(h.tokens) == 20 for h in hs)
    if not compress:
        assert {h.request.rid: list(h.tokens) for h in hs} == want
    st = gw.stats()["counters"]
    assert st["migrations"] == n_vic and st["preemptions"] == 1


def test_dense_preemption_zero_grace_requeues(models):
    cfg, params = models["tcfg"], models["tparams"]
    gw = _dense_gw(cfg, params)
    hs = [gw.submit(r) for r in _reqs(cfg, 2, max_new=10)]
    for _ in range(60):
        gw.pump()
        if all(h.state == TG.DECODING for h in hs):
            break
    vic = max(range(2), key=lambda j: len(gw.dec[j].client.resident()))
    n_vic = len(gw.dec[vic].client.resident())
    rep = gw.handle_preemption("decode", vic, grace_s=0.0)
    assert rep["migrated"] == 0 and rep["requeued"] == n_vic
    assert any("preemption drain" in e for e in gw.events)
    gw.run_until_drained()
    assert all(h.state == TG.DONE and len(h.tokens) == 10 for h in hs)
    assert sum(h.restarts for h in hs) >= n_vic


def test_dense_dead_replica_triggers_failover_reschedule(models):
    cfg, params = models["tcfg"], models["tparams"]
    cfg_full = get_config("llama-30b")
    slo = SloSpec(ttft_s=2.0, tpot_s=0.15, e2e_s=30.0)
    cluster = make_paper_cloud()
    solver = t_sched.LowerLevelSolver(cluster, cfg_full, CONVERSATION, 2.0,
                                      slo)
    groups = ((0, 1, 2, 3), (4, 5, 6, 7), tuple(range(8, 16)),
              tuple(range(16, 24)))
    sol = t_tabu.Solution(groups, ("prefill", "prefill", "decode", "decode"))
    score, replicas, o = solver.solve(sol)
    plan = t_sched.DeploymentPlan(solution=sol, replicas=replicas,
                                  orchestration=o, score=score)
    calls = []

    def pinned(cluster_, cfg_, plan_, wl, rate, slo_, *, init_solution=None,
               **kw):
        calls.append(init_solution)
        sc, reps, orch = solver.solve(init_solution)
        return t_sched.DeploymentPlan(solution=init_solution, replicas=reps,
                                      orchestration=orch, score=sc)

    gw = TG.gateway_from_plan(plan, cfg, params, max_seq=64, max_slots=4,
                              chunk_size=4, device="cpu",
                              decode_kw={"paged": False},
                              clock=TF.VirtualClock())
    assert all(not h.engine.paged for h in gw.dec)
    gw.set_failover(cluster, cfg_full, slo, workload=CONVERSATION, rate=2.0,
                    search_fn=pinned)
    hs = [gw.submit(r) for r in _reqs(cfg, 3, max_new=8)]
    for _ in range(30):
        gw.pump()
        if any(h.state == TG.DECODING for h in hs):
            break
    dead_group = gw.dec[1].group
    gw.kill_replica("decode", 1)
    gw.pump()
    assert calls, "failover search never ran"
    assert gw.epoch == 1
    live_groups = {h.group for h in gw.pre + gw.dec if h.alive}
    assert dead_group not in live_groups
    assert set(calls[0].groups) == live_groups
    assert any(e.startswith("failover reschedule:") for e in gw.events)
    gw.run_until_drained()
    assert all(h.state == TG.DONE and len(h.tokens) == 8 for h in hs)


def test_launch_serve_no_paged_runs_end_to_end_on_cpu(capsys):
    out = t_serve.run(["--device", "cpu", "--reduced", "--no-paged",
                       "--duration", "3", "--rate", "2", "--steps", "6",
                       "--chunk-tokens", "16"])
    s = out["summary"]
    assert s["n_submitted"] > 0 and s["n_done"] == s["n_submitted"]
    assert out["params_resident"] and out["page_stats"] == []
    assert all(not h.engine.paged for h in out["gateway"].dec)
    assert out["stats"]["page_pool"] is None
    assert "paged KV" not in capsys.readouterr().out
