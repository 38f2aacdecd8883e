"""The port's serving slice against the JAX engines, and the reference's
own contracts re-pinned inside the port (CPU, reduced LLaMA-30B, f32).

One scenario runs through both packages' ``PrefillEngine`` and paged
``DecodeEngine(prefix_sharing=True)`` in the order the gateway's local
clients call them: three fresh prompts, then a repeat of a finished
prompt (full prefix hit), a prompt sharing two pages with a finished one
(partial hit: suffix prefill over the int4-dequantized prefix, the JAX
package's WARM path), and a chunked prefill (8-token budget) on top of a
one-page hit.

Tolerances: wire packed bytes identical; f32 scale/zero rows within 1e-5
relative (the K/V they quantize come from f32 products summed in another
order); greedy tokens equal where the JAX prefill's top-2 logit margin
clears 1e-3 (at this seed every request's does, and the decoded streams
are compared whole).

The dense decode cache (``paged=False``) and the bf16 page residency are
held to the JAX package's engines the same way (the same margin rule on
the same weights), and within the port to their own contracts:
``step()`` and ``step_reference()`` decode bit-identical streams, and so
do chunked and one-shot prefill into the dense cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import kv_transfer as j_kvt  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import kv_transfer as t_kvt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

MARGIN = 1e-3
PS = 8


def _scenario(E, cfg, params, kv_resident="int4", **dev):
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    system = rng.integers(1, V, PS)

    def prompt(n, head=system):
        return np.concatenate([head, rng.integers(1, V, n - len(head))]) \
            .astype(np.int32)

    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, paged=True,
                         page_size=PS, chunk_size=4, prefix_sharing=True,
                         kv_resident=kv_resident, **dev)

    def admit(items):
        assert not dec.admit(E.AdmissionBatch(items), backend="ref")

    def drain(max_chunks=None):
        k = 0
        while dec.active and (max_chunks is None or k < max_chunks):
            dec.step()
            k += 1

    r0 = E.GenRequest(0, prompt(13), 6)
    r1 = E.GenRequest(1, prompt(24), 8)
    r2 = E.GenRequest(2, prompt(30), 6)
    fresh = pre.run([r0, r1, r2], backend="ref")
    admit([E.AdmissionItem(r, f, wire=w) for r, w, f in fresh])
    drain()

    r3 = E.GenRequest(3, r0.tokens.copy(), 6)
    r4 = E.GenRequest(4, prompt(26, head=r1.tokens[:2 * PS]), 6)
    r5 = E.GenRequest(5, prompt(29), 6)
    matches = {}
    for r in (r3, r4, r5):
        m = dec.prefix_match(r.tokens)
        assert m is not None and dec.prefix_pin(m.pages, ("pin", r.rid))
        matches[r.rid] = (m.full, m.length)
        if m.full:
            full_hit = m
        else:
            r.start_pos, r.prefix_pages = m.length, list(m.pages)
            r.prefix_wire = dec.extract_prefix(m.pages, m.length)
    admit([E.AdmissionItem(r3, full_hit.next_token, E.ADMIT_PREFIX_HIT,
                           pages=list(full_hit.pages))])
    (_, w4, f4), = pre.run([r4], backend="ref")
    admit([E.AdmissionItem(r4, f4, wire=w4)])
    job = E.PartialPrefill(r5)
    ticks = 0
    while not job.done:
        pre.prefill_chunk([job], PS, backend="ref")
        ticks += 1
        drain(1)
    admit([E.AdmissionItem(r5, job.first, E.ADMIT_CHUNKED,
                           wire=job.wire())])
    for r in (r3, r4, r5):
        dec.prefix_unpin(("pin", r.rid))
    drain()
    reqs = [r0, r1, r2, r3, r4, r5]
    return {"reqs": reqs, "wires": [w for _, w, _ in fresh] + [w4,
                                                             job.wire()],
            "first": [f for _, _, f in fresh] + [f4, job.first],
            "matches": matches, "ticks": ticks, "stats": dec.page_stats(),
            "dec": dec, "pre": pre}


@pytest.fixture(scope="module")
def runs():
    jcfg = j_get_reduced("llama-30b").replace(dtype="float32")
    tcfg = get_reduced("llama-30b").replace(dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    return {"jax": _scenario(JE, jcfg, jparams),
            "torch": _scenario(TE, tcfg, tparams, device="cpu"),
            "jcfg": jcfg, "jparams": jparams, "tcfg": tcfg,
            "tparams": tparams}


def _payload(wt, key):
    a = wt.payload[key]
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_prefix_matches_are_the_same(runs):
    assert runs["jax"]["matches"] == runs["torch"]["matches"] == \
        {3: (True, 13), 4: (False, 16), 5: (False, 8)}
    assert runs["jax"]["ticks"] == runs["torch"]["ticks"] == 3


def test_wire_payload_bytes_equal(runs):
    """Fresh wires, the partial hit's suffix wire and the chunked
    transport wire: same kind, shapes and packed bytes."""
    for wj, wt in zip(runs["jax"]["wires"], runs["torch"]["wires"]):
        assert wj.request_len == wt.request_len
        for key in ("k", "v"):
            a, b = wj.slots["slot0"][key], wt.slots["slot0"][key]
            assert a.kind == b.kind == "int4"
            assert tuple(a.orig_shape) == tuple(b.orig_shape)
            np.testing.assert_array_equal(_payload(a, "packed"),
                                          _payload(b, "packed"))
            for k in ("scale", "zero"):
                np.testing.assert_allclose(_payload(a, k), _payload(b, k),
                                           rtol=1e-5, atol=1e-6)
        assert wj.nbytes() == wt.nbytes()
        assert j_kvt.wire_bytes_uncompressed(wj) == \
            t_kvt.wire_bytes_uncompressed(wt)


def test_insert_counters_equal(runs):
    sj, st = runs["jax"]["stats"], runs["torch"]["stats"]
    for k in ("zero_copy_inserts", "reencoded_inserts", "cow_copies",
              "prefix_admits", "in_use", "prefix_entries"):
        assert sj[k] == st[k], k
    assert st["zero_copy_inserts"] > 0 and st["reencoded_inserts"] == 0


def test_greedy_tokens_equal_where_margin_clears(runs):
    jcfg, jp = runs["jcfg"], runs["jparams"]
    checked = 0
    for rj, rt in zip(runs["jax"]["reqs"], runs["torch"]["reqs"]):
        assert rj.rid == rt.rid
        logits, _ = j_tf.prefill(jcfg, jp, jnp.asarray(rj.tokens[None]),
                                 max_seq=len(rj.tokens))
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        if top2[1] - top2[0] < MARGIN:
            continue
        assert rj.out_tokens == rt.out_tokens, rj.rid
        checked += 1
    assert checked == 6


def test_full_prefix_hit_matches_cold_run(runs):
    """r3 repeats r0's prompt and decodes straight off the shared chain:
    its tokens are r0's (within the port, and within the reference)."""
    for side in ("torch", "jax"):
        reqs = runs[side]["reqs"]
        assert reqs[3].out_tokens == reqs[0].out_tokens


def test_no_page_leaks_and_pool_drains(runs):
    dec = runs["torch"]["dec"]
    assert dec.page_stats()["leaked_pages"] == 0
    assert dec.active == 0
    dec.clear_prefix()
    assert dec.pool.n_in_use == 0
    assert dec.pool.n_free == dec.pool.capacity
    assert int(dec.cache["page_table"].abs().sum()) == 0
    assert int(dec.cache["lengths"].abs().sum()) == 0


def test_chunked_prefill_matches_one_shot_bit_for_bit(runs):
    """Within the port: chunked prefill (4-token budget) and one-shot
    prefill decode bit-identical token streams. (The transport wires agree
    to f32 rounding: the chunk's K/V come from products over fewer rows,
    which PyTorch's CPU GEMM may round differently.)"""
    cfg, params = runs["tcfg"], runs["tparams"]
    prompt = np.random.default_rng(11).integers(1, 256, 27).astype(np.int32)
    outs = []
    for chunked in (False, True):
        pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                              page_size=PS, device="cpu")
        req = TE.GenRequest(0, prompt, 10)
        if chunked:
            job = TE.PartialPrefill(req)
            while not job.done:
                pre.prefill_chunk([job], 4)
            wire, first, src = job.wire(), job.first, TE.ADMIT_CHUNKED
        else:
            (_, wire, first), = pre.run([req])
            src = TE.ADMIT_FRESH
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(req, first, src, wire=wire)]))
        while dec.active:
            dec.step()
        outs.append((wire, req.out_tokens))
    (w1, t1), (w2, t2) = outs
    assert t1 == t2 and len(t1) == 10
    for key in ("k", "v"):
        for k in ("scale", "zero"):
            torch.testing.assert_close(w1.slots["slot0"][key].payload[k],
                                       w2.slots["slot0"][key].payload[k],
                                       rtol=1e-5, atol=1e-6)


def test_admit_returns_rejected_tail(runs):
    cfg, params = runs["tcfg"], runs["tparams"]
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    dec = TE.DecodeEngine(cfg, params, max_slots=8, max_seq=64,
                          page_size=PS, num_pages=7, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [TE.GenRequest(i, rng.integers(1, 256, 20), 12) for i in range(3)]
    out = pre.run(reqs)
    rest = dec.admit(TE.AdmissionBatch(
        [TE.AdmissionItem(r, f, wire=w) for r, w, f in out]))
    # each needs ceil(32/8) = 4 of the 6 usable pages: one fits
    assert [it.req.rid for it in rest] == [1, 2]
    assert dec.active == 1 and dec.free_slots() == []
    while dec.active:
        dec.step()
    assert dec.pool.n_in_use == 0 and len(dec.free_slots()) >= 1


def test_extract_resident_migrates_without_changing_tokens(runs):
    """Mid-stream migration: a resident slot's pages, gathered into a wire
    and admitted as MIGRATED elsewhere, decode the undisturbed tokens."""
    cfg, params = runs["tcfg"], runs["tparams"]
    prompt = np.random.default_rng(3).integers(1, 256, 19).astype(np.int32)
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    streams = []
    for migrate in (False, True):
        a = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                            page_size=PS, chunk_size=3, device="cpu")
        req = TE.GenRequest(0, prompt, 12)
        (_, w, f), = pre.run([req])
        assert not a.admit(TE.AdmissionBatch([TE.AdmissionItem(req, f,
                                                               wire=w)]))
        a.step()
        if migrate:
            (slot, r, wire, cur), = a.extract_resident()
            a.release(slot)
            b = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                                page_size=PS, chunk_size=3, device="cpu")
            assert not b.admit(TE.AdmissionBatch([TE.AdmissionItem(
                r, cur, TE.ADMIT_MIGRATED, wire=wire)]))
            assert b.zero_copy_inserts == 2
            a = b
        while a.active:
            a.step()
        streams.append(req.out_tokens)
    assert streams[0] == streams[1]


def test_unported_engine_modes_raise(runs):
    """What still refuses: an unknown page residency, and an engine on the
    wrong device. An arch that cannot page falls back to the dense cache,
    as the reference does; with a sliding window (whose step refused here
    until its ring cache was ported) that cache is an 8-row ring and the
    engine decodes past it; a softcap (ROADMAP A.15, which refused here
    until it was ported) serves on the dense cache and decodes the JAX
    engines' tokens. The dense engine and a dense ``Replica`` build. The
    phase-switching ``Replica`` builds each phase's engine once around the
    same parameters and refuses an undrained flip."""
    cfg, params = runs["tcfg"], runs["tparams"]
    dense = TE.DecodeEngine(cfg, params, paged=False, device="cpu")
    assert not dense.paged and dense.paged_fallback is None
    assert dense.page_stats() is None and dense.prefix_match([1, 2]) is None
    rep = TE.Replica(cfg, params, phase="decode", device="cpu",
                     decode_kw={"paged": False})
    assert not rep.engine.paged
    with pytest.raises(ValueError, match="unknown residency"):
        TE.DecodeEngine(cfg, params, kv_resident="int8", device="cpu")
    swa = cfg.replace(sliding_window=8)
    fb = TE.DecodeEngine(swa, params, max_slots=2, max_seq=64,
                         device="cpu")
    assert not fb.paged and "cannot page" in fb.paged_fallback
    (_, w, f), = TE.PrefillEngine(swa, params, max_seq=64,
                                  device="cpu").run(
        [TE.GenRequest(0, np.arange(1, 12), 4)])
    swa_req = TE.GenRequest(0, np.arange(1, 12), 4)
    assert not fb.admit(TE.AdmissionBatch([TE.AdmissionItem(
        swa_req, f, wire=w)]))
    assert fb.cache["slot0"]["k"].shape[2] == 8
    while fb.active:
        fb.step()
    assert len(swa_req.out_tokens) == 4
    capped = {}
    for E, c, p, dev in (
            (TE, cfg.replace(attn_logit_softcap=30.0), params,
             {"device": "cpu"}),
            (JE, runs["jcfg"].replace(attn_logit_softcap=30.0),
             runs["jparams"], {})):
        fc = E.DecodeEngine(c, p, max_slots=2, max_seq=64, paged=True,
                            **dev)
        assert not fc.paged and "cannot page" in fc.paged_fallback
        reqs = [E.GenRequest(i, np.arange(1 + i, 12 + 3 * i), 6)
                for i in range(2)]
        out = E.PrefillEngine(c, p, max_seq=64, **dev).run(reqs)
        assert not fc.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in out]))
        while fc.active:
            fc.step()
        capped[E is TE] = [r.out_tokens for r in reqs]
    assert capped[True] == capped[False]
    with pytest.raises(ValueError, match="params live on"):
        TE.PrefillEngine(cfg, params, device="cuda")
    with pytest.raises(ValueError, match="params live on"):
        TE.Replica(cfg, params)                  # the card by default
    rep = TE.Replica(cfg, params, phase="decode", max_seq=64, device="cpu",
                     decode_kw={"page_size": PS, "max_slots": 2})
    dec = rep.engine
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    req = TE.GenRequest(0, np.arange(1, 12), 6)
    (_, w, f), = pre.run([req])
    assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(req, f,
                                                             wire=w)]))
    with pytest.raises(RuntimeError, match="undrained"):
        rep.switch_phase()
    while dec.active:
        dec.step()
    assert isinstance(rep.switch_phase(), TE.PrefillEngine)
    assert rep.switch_phase("decode") is dec     # cached, not rebuilt
    assert rep.switches == 2 and rep.engine.params is params
    assert dec.pool.n_in_use == 0


def test_materialize_is_the_host_hop(runs):
    wire = runs["torch"]["wires"][0]
    before = wire.nbytes()
    wire.materialize()
    assert all(a.device.type == "cpu"
               for t in wire.slots["slot0"].values()
               for a in t.payload.values())
    assert wire.nbytes() == before


def test_insert_batch_dense_matches_jax(runs):
    """The dense-cache insert (kept for the dense decode engine)."""
    wj, wt = runs["jax"]["wires"][1], runs["torch"]["wires"][1]
    cfg = runs["tcfg"]
    shape = (cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.head_dim)
    jc = {"slot0": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
          "lengths": jnp.zeros((2,), jnp.int32)}
    tc = {"slot0": {"k": torch.zeros(shape), "v": torch.zeros(shape)},
          "lengths": torch.zeros((2,), dtype=torch.int32)}
    jc = j_kvt.insert_batch(jc, [(wj, 1)], backend="ref")
    tc = t_kvt.insert_batch(tc, [(wt, 1)])
    np.testing.assert_allclose(np.asarray(jc["slot0"]["k"]),
                               tc["slot0"]["k"].numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())


# -- the dense decode cache and the bf16 page residency -------------------------


def _serve(cfg, params, prompts, max_new, *, use_reference=False, **kw):
    """Prefill ``prompts`` and decode them to the end on one port engine,
    with ``step()`` or ``step_reference()``."""
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    dec = TE.DecodeEngine(cfg, params, max_slots=4, max_seq=64, chunk_size=4,
                          device="cpu", **kw)
    reqs = [TE.GenRequest(i, p, n) for i, (p, n) in
            enumerate(zip(prompts, max_new))]
    out = pre.run(reqs)
    assert not dec.admit(TE.AdmissionBatch(
        [TE.AdmissionItem(r, f, wire=w) for r, w, f in out]))
    while dec.active:
        dec.step_reference() if use_reference else dec.step()
    return [r.out_tokens for r in reqs], dec


MODES = {"dense": {"paged": False},
         "bf16": {"paged": True, "page_size": PS, "kv_resident": "bf16"}}


def _prompts(n_each=(7, 19, 33)):
    rng = np.random.default_rng(9)
    return [rng.integers(1, 256, n).astype(np.int32) for n in n_each]


# the reference's jnp dense step rounds attention probabilities to the
# bf16 cache type before P.V; the port's kernel keeps them in f32 (the
# Pallas decode_attention's contract), so the two dense paths' logits are
# ~1e-2 apart on this model. Both bf16 page bodies keep f32 probabilities.
STEP_MARGIN = {"dense": 2e-2, "bf16": MARGIN}


def _greedy_steps(E, cfg, params, prompts, n_steps, *, jax_side, **kw):
    """Prefill, admit, then ``n_steps`` greedy steps of the engine's own
    decode step over every slot; returns per-step (tokens, top-2 margins),
    each (n_steps, n_prompts), and the first tokens."""
    dev = {} if jax_side else {"device": "cpu"}
    bk = {"backend": "ref"} if jax_side else {}
    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, **kw, **dev)
    reqs = [E.GenRequest(i, p, n_steps + 1) for i, p in enumerate(prompts)]
    out = pre.run(reqs, **bk)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in out]), **bk)
    cache, cur = dec.cache, np.array(dec.cur_token)
    toks, margins = [], []
    for _ in range(n_steps):
        if jax_side:
            logits, cache = dec._decode(params, cache,
                                        {"tokens": jnp.asarray(cur[:, None])})
        else:
            logits, cache = dec._decode(params, cache,
                                        torch.as_tensor(cur[:, None]))
        lg = np.asarray(logits[:, -1], np.float32)[:len(prompts)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        cur[:len(prompts)] = lg.argmax(-1)
        toks.append(lg.argmax(-1))
        margins.append(top2[:, 1] - top2[:, 0])
    return np.array(toks), np.array(margins), [f for _, _, f in out]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dense_and_bf16_engines_match_jax(runs, mode):
    """The JAX package's engine and the port's on the same weights and
    prompts, stepped greedily: the first tokens are equal, and each
    stream's tokens are equal up to the first step whose top-2 margin in
    the JAX run is below ``STEP_MARGIN[mode]`` (past it the streams may
    part on rounding)."""
    prompts, n = _prompts(), 12
    jt, jm, jf = _greedy_steps(JE, runs["jcfg"], runs["jparams"], prompts,
                               n, jax_side=True, **MODES[mode])
    tt, _, tf = _greedy_steps(TE, runs["tcfg"], runs["tparams"], prompts,
                              n, jax_side=False, **MODES[mode])
    assert jf == tf
    compared = 0
    for i in range(len(prompts)):
        for t in range(n):
            if jm[t, i] < STEP_MARGIN[mode]:
                break
            assert jt[t, i] == tt[t, i], (i, t)
            compared += 1
    assert compared >= n * len(prompts) // 2, compared


def test_bf16_pages_serve_the_prefix_scenario(runs):
    """The scenario's prefix sharing over bf16 pages: the same matches,
    the full hit repeats its donor's tokens, raw prefix wires feed the
    partial hit and the chunked prefill, and no page leaks."""
    out = _scenario(TE, runs["tcfg"], runs["tparams"], kv_resident="bf16",
                    device="cpu")
    assert out["matches"] == runs["torch"]["matches"]
    reqs = out["reqs"]
    assert reqs[3].out_tokens == reqs[0].out_tokens
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    st = out["stats"]
    assert st["leaked_pages"] == 0 and st["prefix_admits"] == 1
    assert st["zero_copy_inserts"] == st["reencoded_inserts"] == 0
    assert out["dec"].cache["slot0"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["int4", "dense", "bf16"])
def test_step_reference_matches_step(runs, mode):
    """One host round trip per token decodes what the chunked device loop
    decodes, bit for bit, and leaves the cache released."""
    kw = MODES.get(mode, {"paged": True, "page_size": PS})
    prompts, max_new = _prompts(), [10, 6, 8]
    a, _ = _serve(runs["tcfg"], runs["tparams"], prompts, max_new, **kw)
    b, dec = _serve(runs["tcfg"], runs["tparams"], prompts, max_new,
                    use_reference=True, **kw)
    assert a == b and [len(t) for t in a] == max_new
    assert dec.steps_run == dec.host_syncs == max(max_new) - 1
    if dec.paged:
        assert dec.pool.n_in_use == 0


def test_dense_chunked_prefill_matches_one_shot(runs):
    """The dense cache's counterpart of the reference's chunked-prefill
    parity: a 4-token budget and one-shot prefill decode bit-identical
    streams."""
    cfg, params = runs["tcfg"], runs["tparams"]
    prompt = np.random.default_rng(11).integers(1, 256, 27).astype(np.int32)
    outs = []
    for chunked in (False, True):
        pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                              paged=False, device="cpu")
        req = TE.GenRequest(0, prompt, 10)
        if chunked:
            job = TE.PartialPrefill(req)
            while not job.done:
                pre.prefill_chunk([job], 4)
            wire, first, src = job.wire(), job.first, TE.ADMIT_CHUNKED
        else:
            (_, wire, first), = pre.run([req])
            src = TE.ADMIT_FRESH
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(req, first, src, wire=wire)]))
        while dec.active:
            dec.step()
        outs.append(req.out_tokens)
        assert int(dec.cache["lengths"].abs().sum()) == 0
    assert outs[0] == outs[1] and len(outs[0]) == 10


@pytest.mark.parametrize("compress", [False, True])
def test_dense_extract_resident_migrates(runs, compress):
    """A dense slot's KV, extracted mid-stream and admitted as MIGRATED on
    another dense engine, finishes the stream: a raw wire reproduces the
    undisturbed tokens bit for bit; an int4 wire loses no token."""
    cfg, params = runs["tcfg"], runs["tparams"]
    prompt = np.random.default_rng(3).integers(1, 256, 19).astype(np.int32)
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    streams = []
    for migrate in (False, True):
        a = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                            paged=False, chunk_size=3, device="cpu")
        req = TE.GenRequest(0, prompt, 12)
        (_, w, f), = pre.run([req])
        assert not a.admit(TE.AdmissionBatch([TE.AdmissionItem(req, f,
                                                               wire=w)]))
        a.step()
        if migrate:
            (slot, r, wire, cur), = a.extract_resident(compress=compress)
            assert wire.request_len == len(prompt) + 3
            assert {t.kind for t in wire.slots["slot0"].values()} == \
                {"int4" if compress else "raw"}
            a.release(slot)
            assert int(a.cache["lengths"][slot]) == 0
            b = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=64,
                                paged=False, chunk_size=3, device="cpu")
            assert not b.admit(TE.AdmissionBatch([TE.AdmissionItem(
                r, cur, TE.ADMIT_MIGRATED, wire=wire)]))
            a = b
        while a.active:
            a.step()
        streams.append(req.out_tokens)
    assert len(streams[1]) == 12
    if not compress:
        assert streams[0] == streams[1]
