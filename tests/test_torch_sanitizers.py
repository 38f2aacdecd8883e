"""The port's runtime sanitizers (``repro_torch.analysis.sanitizers``)
against the reference's (``repro.analysis.sanitizers``), scenario by
scenario (CPU).

Each scenario of the reference's sanitizer tests (``tests/test_analysis.py``)
runs through both modules: a double free that names both sites, a free
under the wrong owner that mutates nothing, a leak report with its
allocation site, the transition auditor on legal and illegal lifecycles,
the retrace monitor on a growing compile cache, and a misaligned
migration wire. Both must raise ``SanitizerError`` on the same scenarios,
with the same first line of the message (later lines are stack sites,
whose paths differ). Then a sanitized ``Gateway`` of each package
(reduced LLaMA-30B in f32, the same weights, paged decode engines) drains
clean, and a planted leak makes both drain checks raise. Inside the port,
``REPRO_SANITIZE=1`` gives the engine the sanitized pool, audits its
references, refuses a misaligned migrated wire at admission, and the
retrace monitor reads the decode clients' ``jit_cache_size`` (0 on the
CPU, where the chunk runs eagerly).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import sanitizers as JS  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.kernels.kv_layout import pick_group  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import gateway as JG  # noqa: E402
from repro.serving import kv_transfer as j_kvt  # noqa: E402
from repro_torch.analysis import sanitizers as TS  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import gateway as TG  # noqa: E402
from repro_torch.serving import kv_transfer as t_kvt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

SIDES = (JS, TS)


def _outcome(fn, *args, **kw):
    """("ok", None) or ("raise", first line of the SanitizerError)."""
    try:
        fn(*args, **kw)
    except (JS.SanitizerError, TS.SanitizerError) as e:
        return "raise", str(e).splitlines()[0]
    return "ok", None


def _both(scenario):
    """Run ``scenario(S)`` against each sanitizer module; their outcomes
    (and the sites each message names) must match."""
    out = [scenario(S) for S in SIDES]
    assert out[0] == out[1], out
    return out[1]


# -- page pool -------------------------------------------------------------------


def _double_free(S):
    pool = S.make_sanitized_pool(8, 4)
    pages = pool.alloc(2, 0)
    pool.free(pages, owner=0)
    with pytest.raises(S.SanitizerError) as e:
        pool.free(pages, owner=0)
    msg = str(e.value)
    return (msg.splitlines()[0], "second free at" in msg,
            msg.count(", in _double_free\n"))


def test_sanitized_pool_double_free_names_both_sites():
    first, second, n_sites = _both(_double_free)
    assert "already freed" in first and second
    assert n_sites == 2                      # the first free and the second


def _wrong_owner(S):
    pool = S.make_sanitized_pool(8, 4)
    pages = pool.alloc(1, 0)
    got = _outcome(pool.free, pages, owner=3)
    refused_kept = pool.n_in_use == 1        # the refused free mutated nothing
    pool.free(pages, owner=0)
    return got, refused_kept, pool.n_in_use


def test_sanitized_pool_wrong_owner():
    (kind, line), kept, left = _both(_wrong_owner)
    assert kind == "raise" and "owned by slot 0" in line
    assert kept and left == 0


def _leak(S):
    pool = S.make_sanitized_pool(8, 4)
    pool.alloc(1, 5)
    with pytest.raises(S.SanitizerError) as e:
        pool.check_empty("teardown")
    return str(e.value).splitlines()[0], ", in _leak\n" in str(e.value)


def test_sanitized_pool_leak_report_has_alloc_site():
    first, site = _both(_leak)
    assert first.startswith("page leak in teardown") and site


def _never_allocated(S):
    pool = S.make_sanitized_pool(8, 4)
    return _outcome(pool.free, [3])


def test_sanitized_pool_free_of_never_allocated_page():
    kind, line = _both(_never_allocated)
    assert kind == "raise" and "never-allocated page 3" in line


# -- transition auditor ------------------------------------------------------------


def _handle(chain, state=None, reason=None, rid=7, times=None):
    hist = list(zip(times or [float(i) for i in range(len(chain))], chain))
    return SimpleNamespace(request=SimpleNamespace(rid=rid),
                           state=state or chain[-1], history=hist,
                           reason=reason)


LIFECYCLES = {
    "served": (["QUEUED", "PREFILLING", "TRANSFERRING", "DECODING", "DONE"],
               {}),
    "migrated_and_requeued": (
        ["QUEUED", "PREFILLING", "TRANSFERRING", "DECODING", "TRANSFERRING",
         "DECODING", "QUEUED", "PREFILLING", "TRANSFERRING", "DECODING",
         "DONE"], {}),
    "full_prefix_hit": (["QUEUED", "TRANSFERRING", "DECODING", "DONE"], {}),
    "rejected_with_reason": (["QUEUED", "REJECTED"], {"reason": "deadline"}),
    "illegal_edge": (["QUEUED", "DONE"], {}),
    "state_around_transition": (["QUEUED", "PREFILLING"], {"state": "DONE"}),
    "failed_without_reason": (["QUEUED", "FAILED"], {}),
    "not_from_queued": (["PREFILLING", "TRANSFERRING"], {}),
    "time_backwards": (["QUEUED", "PREFILLING"], {"times": [2.0, 1.0]}),
    "empty_history": ([], {"state": "QUEUED"}),
}
LEGAL = ("served", "migrated_and_requeued", "full_prefix_hit",
         "rejected_with_reason")


@pytest.mark.parametrize("case", sorted(LIFECYCLES))
def test_transition_auditor_matches_reference(case):
    chain, kw = LIFECYCLES[case]

    def run(S):
        aud = S.TransitionAuditor()
        got = _outcome(aud.audit, _handle(chain, **kw), context="test")
        return got, aud.audited, aud.illegal

    (kind, line), audited, illegal = _both(run)
    assert audited == 1
    assert (kind, illegal) == (("ok", 0) if case in LEGAL else ("raise", 1))


def test_transition_tables_are_the_same():
    assert TS._LEGAL == JS._LEGAL
    assert TS._NEEDS_REASON == JS._NEEDS_REASON


# -- retrace monitor -----------------------------------------------------------------


def _retrace(S):
    sizes = {"n": 3}
    client = SimpleNamespace(jit_cache_size=lambda: sizes["n"])
    gw = SimpleNamespace(pre=[], dec=[SimpleNamespace(client=client)])
    mon = S.RetraceMonitor()
    unarmed = _outcome(mon.check, gw)              # no baseline yet
    mon.mark_steady(gw)
    stable = _outcome(mon.check, gw)
    sizes["n"] = 5
    grown = _outcome(mon.check, gw, context="steady state")
    sizes["n"] = 2                                  # shrinking is fine
    shrunk = _outcome(mon.check, gw)
    return unarmed, stable, grown, shrunk


def test_retrace_monitor_flags_growth():
    unarmed, stable, grown, shrunk = _both(_retrace)
    assert unarmed == stable == shrunk == ("ok", None)
    assert grown[0] == "raise" and "dec[0]: 3 -> 5" in grown[1]


# -- migration wire alignment --------------------------------------------------------


def _wire(KVWire, WireTensor, zeros, cfg, *, half_group=False, raw=False):
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    span = Hkv * hd
    ln, L = 4, 1
    g = pick_group(span) // (2 if half_group else 1)
    rows = L * ln * (span // g)
    if raw:
        wt = WireTensor("raw", {"x": zeros((L, ln, Hkv, hd), "float32")},
                        (L, ln, Hkv, hd), "float32")
    else:
        wt = WireTensor("int4", {"packed": zeros((rows, g // 2), "uint8"),
                                 "scale": zeros((rows, 1), "float32"),
                                 "zero": zeros((rows, 1), "float32")},
                        (L, ln, Hkv, hd))
    return KVWire(request_len=ln, slots={"slot0": {"k": wt, "v": wt}})


def _np_zeros(shape, dt):
    return np.zeros(shape, getattr(np, dt))


def _torch_zeros(shape, dt):
    return torch.zeros(shape, dtype=getattr(torch, dt))


@pytest.mark.parametrize("kind", ["aligned", "half_group", "raw"])
def test_migration_wire_alignment_matches_reference(kind):
    kw = {"half_group": kind == "half_group", "raw": kind == "raw"}
    j = _wire(j_kvt.KVWire, j_kvt.WireTensor, _np_zeros,
              j_get_reduced("llama-30b"), **kw)
    t = _wire(t_kvt.KVWire, t_kvt.WireTensor, _torch_zeros,
              get_reduced("llama-30b"), **kw)
    got = [_outcome(JS.check_wire_alignment, j, j_get_reduced("llama-30b"),
                    context="test"),
           _outcome(TS.check_wire_alignment, t, get_reduced("llama-30b"),
                    context="test")]
    assert got[0] == got[1]
    span = 4 * 16                       # the reduced config's Hkv * hd
    if kind == "aligned":
        assert got[1] == ("ok", None)
    else:
        assert got[1] == ("raise", "misaligned migration wire in test — "
                                   "insertion will silently re-encode "
                                   f"(group g={pick_group(span)}, ppr="
                                   f"{span // pick_group(span)}):")


def test_sanitize_enabled_reads_the_same_values(monkeypatch):
    for value in ("", "0", "false", "no", " 0 ", "1", "yes", "true"):
        monkeypatch.setenv("REPRO_SANITIZE", value)
        assert TS.sanitize_enabled() == JS.sanitize_enabled() == \
            JE._sanitize_enabled()
    monkeypatch.delenv("REPRO_SANITIZE")
    assert not TS.sanitize_enabled() and not JS.sanitize_enabled()


# -- sanitized gateways, end to end ------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_reduced("llama-30b").replace(dtype="float32")
    tcfg = get_reduced("llama-30b").replace(dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    return {"jax": (jcfg, jax.tree.map(jnp.asarray, tree)),
            "torch": (tcfg, convert.params_from_numpy(tree, tcfg, "cpu"))}


def _mk_gw(side, models, *, paged=True, n_dec=1):
    E, G = (JE, JG) if side == "jax" else (TE, TG)
    cfg, params = models[side]
    dev = {} if side == "jax" else {"device": "cpu"}
    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    dkw = dict(max_slots=2, chunk_size=2, max_seq=64, paged=paged, **dev)
    if paged:
        dkw["page_size"] = 8
    decs = [E.DecodeEngine(cfg, params, **dkw) for _ in range(n_dec)]
    return G.Gateway([pre], decs, backend="ref")


def _reqs(G, cfg, n, *, max_new=4, plen=12):
    rng = np.random.default_rng(0)
    return [G.ServeRequest(i, rng.integers(1, cfg.vocab_size, plen)
                           .astype(np.int32), max_new) for i in range(n)]


def _clean_run_then_leak(side, models):
    G, S = (JG, JS) if side == "jax" else (TG, TS)
    gw = _mk_gw(side, models)
    assert isinstance(gw.sanitizer, S.GatewaySanitizer)
    for r in _reqs(G, models[side][0], 3):
        gw.submit(r)
    done = gw.run_until_drained()        # the drain runs sanitize_check
    st = gw.stats()
    clean = (len(done), [h.state for h in done],
             st["page_pool"]["leaked_pages"], st["sanitizer"])
    eng = gw.dec[0].engine
    eng.pool.alloc(1, 0)                 # pages no slot references
    leaked = gw.stats()["page_pool"]["leaked_pages"]
    with pytest.raises(S.SanitizerError) as e:
        gw.sanitize_check("test")
    return clean, leaked, str(e.value).splitlines()[0]


def test_sanitized_gateway_clean_run_and_planted_leak(models, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    j = _clean_run_then_leak("jax", models)
    t = _clean_run_then_leak("torch", models)
    assert j == t
    (n, states, leaked0, san), leaked, line = t
    assert n == 3 and states == ["DONE"] * 3 and leaked0 == 0
    assert san["transitions_audited"] >= 3
    assert san["transition_violations"] == 0
    assert leaked == 1 and line == "test: decode[0] reports 1 leaked page(s)"


def test_sanitized_engine_pool_names_the_double_free_site(models,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    gw = _mk_gw("torch", models)
    gw.submit(_reqs(TG, models["torch"][0], 1)[0])
    gw.run_until_drained()
    eng = gw.dec[0].engine
    assert type(eng.pool).__name__ == "SanitizedPagePool"
    pages = eng.pool.alloc(2, 0)
    eng.pool.free(pages, owner=0)
    with pytest.raises(TS.SanitizerError, match="already freed at"):
        eng.pool.free(pages, owner=0)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert type(_mk_gw("torch", models).dec[0].engine.pool).__name__ == \
        "PagePool"


def test_audit_paged_engine_catches_leak_and_stale_reference(models,
                                                            monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    cfg, params = models["torch"]
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    eng = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                          page_size=8, chunk_size=2, device="cpu")
    req = TE.GenRequest(0, np.arange(1, 12), 6)
    (r, w, f), = pre.run([req])
    assert not eng.admit(TE.AdmissionBatch([TE.AdmissionItem(r, f, wire=w)]))
    TS.audit_paged_engine(eng, "admitted")          # clean
    leak = eng.pool.alloc(1, "nobody")
    with pytest.raises(TS.SanitizerError, match=r"page leak in t: pool "
                                                r"holds pages \["):
        TS.audit_paged_engine(eng, "t")
    eng.pool.free(leak, owner="nobody")
    stale = eng._slot_pages[0][0]
    eng.pool.free([stale], owner=0)                 # freed behind the slot
    with pytest.raises(TS.SanitizerError, match="use-after-free"):
        TS.audit_paged_engine(eng, "t")


def test_misaligned_migrated_wire_refused_at_admission(models, monkeypatch):
    """A MIGRATED wire whose int4 rows are not page rows would re-encode
    silently: under ``REPRO_SANITIZE=1`` the int4-paged engine refuses it
    before touching its pool."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    cfg, params = models["torch"]
    eng = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                          page_size=8, device="cpu")
    bad = _wire(t_kvt.KVWire, t_kvt.WireTensor, _torch_zeros, cfg,
                half_group=True)
    req = TE.GenRequest(0, np.arange(1, 5), 4, out_tokens=[1])
    with pytest.raises(TS.SanitizerError, match="misaligned migration "
                                                "wire in admit MIGRATED"):
        eng.admit(TE.AdmissionBatch([TE.AdmissionItem(
            req, 1, TE.ADMIT_MIGRATED, wire=bad)]))
    assert eng.pool.n_in_use == 0 and eng.active == 0


def test_retrace_monitor_reads_the_decode_clients(models, monkeypatch):
    """The sanitizer's retrace monitor reads each decode client's
    ``jit_cache_size`` (the engine's captured graphs; 0 on the CPU, which
    runs the eager loop) and stays quiet through a drained run."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    gw = _mk_gw("torch", models, n_dec=2)
    assert [h.client.jit_cache_size() for h in gw.dec] == [0, 0]
    assert [h.client.jit_cache_size() for h in gw.pre] == [0]
    TG.warmup_gateway(gw, models["torch"][0].vocab_size)
    assert gw.sanitizer.retrace._baseline == {"dec[0]": 0, "dec[1]": 0}
    for r in _reqs(TG, models["torch"][0], 4):
        gw.submit(r)
    gw.run_until_drained()                       # runs the retrace check
    assert all(h.engine.graphs is None for h in gw.dec)
