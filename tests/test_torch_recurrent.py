"""The recurrent families (xlstm-125m: mLSTM + sLSTM; jamba-v0.1-52b:
Mamba + attention + MoE) in the port against the JAX package (CPU,
reduced configs in float32, the JAX weights carried over by
``convert.params_from_numpy``, inputs made from a seed with numpy).

* ``causal_conv1d`` (with and without a carried bf16 state), the sLSTM
  step and the Mamba and mLSTM decode steps: within 1e-5 (of the
  output's largest magnitude where it passes 1).
* ``mamba_apply`` (chunks of 4, the doubling scan against
  ``lax.associative_scan``; its state against the reference's unpadded
  call, ROADMAP C.4) and ``mlstm_apply`` (chunks of 8) over
  several chunks from a carried state, and each family's prefill logits
  and states and decode logits (four steps, fed the JAX run's greedy
  tokens): within 1e-4 of the largest |logit|, with the tokens equal
  wherever the JAX run's top-2 margin exceeds 1e-3. The decode steps run
  on f32 caches, so both sides attend with f32 probabilities; the JAX
  side is the reference's ``decode_step_inplace``, the step whose states
  keep the cache's types (its scan step returns a conv state in the
  stream's type, which its jitted decode chunk refuses on an f32 model).
* jamba's config: the port runs the published block (unit-gain dt/B/C
  norms, gates not renormalised, dropless routing), the reference does
  not: the port's side takes ``conftest.jax_block``.
* The wire: recurrent states cross raw (``test_recurrent_state_transfer
  _roundtrip`` of ``tests/test_serving.py``), an insert followed by an
  extract gives them back bit for bit, and the port's wire has the JAX
  wire's slots, keys, shapes and types.
* The engines: ``PrefillEngine`` prefills at exact lengths, the port's
  engines decode the JAX engines' greedy tokens (jamba's bf16 attention
  cache rounds probabilities to bf16 in the JAX step: the dense margin
  of ``tests/test_torch_archs_serving.py``), ``step()`` decodes what
  ``step_reference()`` decodes, and an xlstm request migrated between
  decode engines mid-stream decodes what the undisturbed one does.
* The entry points: ``launch.serve --arch <arch> --reduced --device cpu``
  drains every request, and ``launch.serve_e2e --chaos --arch
  xlstm-125m`` loses none across a migration of recurrent state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import kv_transfer as j_kvt  # noqa: E402
from conftest import jax_block  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import serve_e2e  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import kv_transfer as t_kvt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

STEP_TOL, MODEL_TOL, MARGIN = 1e-5, 1e-4, 1e-3
DENSE_MARGIN = 2e-2          # tests/test_torch_archs_serving.py
RT = j_tf.Runtime(inplace_decode=True)
# the JAX side's functions, jitted (eager dispatch of the scans is slow)
J_MAMBA_APPLY = jax.jit(j_mamba.mamba_apply, static_argnums=0,
                        static_argnames="chunk")
J_MAMBA_STEP = jax.jit(j_mamba.mamba_decode_step, static_argnums=0)
J_MLSTM_APPLY = jax.jit(j_xlstm.mlstm_apply, static_argnums=0)
J_MLSTM_STEP = jax.jit(j_xlstm.mlstm_decode_step, static_argnums=0)
J_SLSTM_APPLY = jax.jit(j_xlstm.slstm_apply, static_argnums=0)
ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
_MODELS = {}


def _model(arch):
    """(JAX config, JAX f32 params, port config, port params, numpy
    tree) of the reduced ``arch`` in float32."""
    if arch not in _MODELS:
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        tcfg = jax_block(get_reduced(arch).replace(dtype="float32"))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
            j_build(jcfg).init)(jax.random.PRNGKey(0)))
        _MODELS[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                         convert.params_from_numpy(tree, tcfg, "cpu"), tree)
    return _MODELS[arch]


def _t(a):
    """A JAX or numpy array as a CPU tensor, bf16 bit for bit."""
    return convert._tensor(np.asarray(a), "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer(arch, mix):
    """The first layer of ``mix`` kind: (JAX params, port params)."""
    jcfg, jp, tcfg, tp, _ = _model(arch)
    kinds = j_tf.slot_kinds(jcfg)
    s = next(i for i, k in enumerate(kinds) if k.startswith(mix))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][f"slot{s}"][mix])
    return jcfg, jl, tcfg, tp["layers"][s][mix]


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 12)
    w = jnp.asarray(_randn(rng, 4, 12), jnp.bfloat16)
    b = jnp.asarray(_randn(rng, 12), jnp.bfloat16)
    st = jnp.asarray(_randn(rng, 2, 3, 12), jnp.bfloat16) if with_state \
        else None
    jy, js = j_layers.causal_conv1d(jnp.asarray(x), w, b, st)
    ty, ts = t_layers.causal_conv1d(torch.from_numpy(x), _t(w), _t(b),
                                    None if st is None else _t(st))
    _close(ty, jy, STEP_TOL)
    _close(ts, js, STEP_TOL)
    assert str(ts.dtype)[6:] == str(js.dtype)


def _mamba_state(rng, jcfg, jl, B):
    """A realistic carried state: the one a 5-step sequence leaves."""
    h = jnp.asarray(_randn(rng, B, 5, jcfg.d_model))
    return J_MAMBA_APPLY(jcfg, jl, h)[1]


def test_mamba_decode_step_matches_jax():
    jcfg, jl, tcfg, tl = _layer("jamba-v0.1-52b", "mamba")
    rng = np.random.default_rng(2)
    conv, ssm = _mamba_state(rng, jcfg, jl, 3)
    x = _randn(rng, 3, 1, jcfg.d_model)
    jo, (jc, jh) = J_MAMBA_STEP(jcfg, jl, jnp.asarray(x), (conv, ssm))
    to, (tc, th) = t_mamba.mamba_decode_step(
        tcfg, tl, torch.from_numpy(x), (_t(conv), _t(ssm)))
    for got, want in ((to, jo), (tc, jc), (th, jh)):
        _close(got, want, STEP_TOL)


def test_mamba_apply_over_chunks_matches_jax():
    """11 steps in chunks of 4 from a carried state: the doubling scan
    against the reference's associative scan. The reference pads the last
    chunk and hands on the state after the padding; the port's state is
    the one after step 11 (ROADMAP C.4), which the reference gives when
    one chunk holds all 11 steps."""
    jcfg, jl, tcfg, tl = _layer("jamba-v0.1-52b", "mamba")
    rng = np.random.default_rng(3)
    conv, ssm = _mamba_state(rng, jcfg, jl, 2)
    x = _randn(rng, 2, 11, jcfg.d_model)
    jo, (jc, _) = J_MAMBA_APPLY(jcfg, jl, jnp.asarray(x), chunk=4,
                                state=(conv, ssm))
    _, (_, jh) = J_MAMBA_APPLY(jcfg, jl, jnp.asarray(x), chunk=16,
                               state=(conv, ssm))
    to, (tc, th) = t_mamba.mamba_apply(tcfg, tl, torch.from_numpy(x),
                                       chunk=4, state=(_t(conv), _t(ssm)))
    for got, want in ((to, jo), (tc, jc), (th, jh)):
        _close(got, want, MODEL_TOL)


def test_doubling_scan_is_the_recurrence():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)).astype(
        np.float32))
    b = torch.from_numpy(_randn(rng, 2, 13, 3))
    h, want = torch.zeros(2, 3), []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = t_mamba.doubling_scan(a.clone(), b.clone())
    _close(got, torch.stack(want, 1), STEP_TOL)


def _mlstm_state(rng, jcfg, jl, B):
    h = jnp.asarray(_randn(rng, B, 5, jcfg.d_model))
    _, (st, conv) = J_MLSTM_APPLY(jcfg, jl, h)
    return st, conv


def test_mlstm_decode_step_matches_jax():
    jcfg, jl, tcfg, tl = _layer("xlstm-125m", "mlstm")
    rng = np.random.default_rng(5)
    st, conv = _mlstm_state(rng, jcfg, jl, 3)
    x = _randn(rng, 3, 1, jcfg.d_model)
    jo, jst, jc = J_MLSTM_STEP(jcfg, jl, jnp.asarray(x), st, conv)
    to, tst, tc = t_xlstm.mlstm_decode_step(
        tcfg, tl, torch.from_numpy(x), tuple(_t(a) for a in st), _t(conv))
    for got, want in zip((to, tc) + tuple(tst), (jo, jc) + tuple(jst)):
        _close(got, want, STEP_TOL)


def test_mlstm_apply_over_chunks_matches_jax():
    """19 steps in chunks of 8 (the last padded) from a carried state."""
    jcfg, jl, tcfg, tl = _layer("xlstm-125m", "mlstm")
    assert jcfg.xlstm_chunk == 8
    rng = np.random.default_rng(6)
    st, conv = _mlstm_state(rng, jcfg, jl, 2)
    x = _randn(rng, 2, 19, jcfg.d_model)
    jo, (jst, jc) = J_MLSTM_APPLY(jcfg, jl, jnp.asarray(x), state=st,
                                  conv_state=conv)
    to, (tst, tc) = t_xlstm.mlstm_apply(
        tcfg, tl, torch.from_numpy(x), state=tuple(_t(a) for a in st),
        conv_state=_t(conv))
    for got, want in zip((to, tc) + tuple(tst), (jo, jc) + tuple(jst)):
        _close(got, want, MODEL_TOL)


def test_slstm_step_matches_jax():
    jcfg, jl, tcfg, tl = _layer("xlstm-125m", "slstm")
    rng = np.random.default_rng(7)
    _, st = J_SLSTM_APPLY(jcfg, jl, jnp.asarray(
        _randn(rng, 3, 5, jcfg.d_model)))
    x = _randn(rng, 3, 1, jcfg.d_model)
    jo, jst = J_SLSTM_APPLY(jcfg, jl, jnp.asarray(x), state=st)
    to, tst = t_xlstm.slstm_decode_step(tcfg, tl, torch.from_numpy(x),
                                        tuple(_t(a) for a in st))
    for got, want in zip((to,) + tuple(tst), (jo,) + tuple(jst)):
        _close(got, want, STEP_TOL)
    H, dh = jcfg.num_heads, jcfg.d_model // jcfg.num_heads
    pre = _randn(rng, 3, 4, H, dh)
    jst1, jh = j_xlstm._slstm_step(jl, st, jnp.asarray(pre))
    tst1 = t_xlstm._slstm_step(tl["r"], tuple(_t(a) for a in st),
                               torch.from_numpy(pre))
    for got, want in zip(tst1, jst1):
        _close(got, want, STEP_TOL)
    _close(tst1[2], jh, STEP_TOL)


# -- whole models -------------------------------------------------------------


def _check_tokens(j_logits, t_logits):
    """Each row's logits within 1e-4 of its largest |logit|, and its
    argmax equal wherever the JAX top-2 margin exceeds ``MARGIN``."""
    j, t = _np(j_logits)[:, -1], _np(t_logits)[:, -1]
    for a, b in zip(j, t):
        assert np.abs(a - b).max() <= MODEL_TOL * np.abs(a).max()
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > MARGIN:
            assert a.argmax() == b.argmax()
    return j.argmax(-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    B, S, max_seq = 2, 13, 24
    toks = np.random.default_rng(8).integers(1, 256, (B, S)).astype(
        np.int32)
    jl, jc = jax.jit(j_build(jcfg).prefill, static_argnames="max_seq")(
        jp, {"tokens": jnp.asarray(toks)}, max_seq=S)
    tl, tc = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    _check_tokens(jl, tl)
    assert set(jc) == set(tc)
    for name, slot in tc.items():
        if name == "lengths":
            assert tc["lengths"].tolist() == [S] * B
            continue
        for key, t in slot.items():
            want = jc[name][key][:, :, :S] if key in "kv" else \
                jc[name][key]
            _close(t, want, MODEL_TOL)
    # decode on f32 caches with room, fed the JAX run's greedy tokens
    jd = j_tf.init_cache(jcfg, B, max_seq, jnp.float32)
    td = t_tf.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    for b in range(B):
        jd = j_kvt.insert(jd, j_kvt.extract(jc, b, S, compress=False),
                          b, backend="ref")
        t_kvt.insert(td, t_kvt.extract(tc, b, S, compress=False), b)
    cur = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
    j_step = jax.jit(lambda p, c, t: j_tf.decode_step(jcfg, p, c, t, rt=RT))
    for _ in range(4):
        jl, jd = j_step(jp, jd, jnp.asarray(cur))
        tl, td = t_tf.decode_step(tcfg, tp, td, torch.from_numpy(cur))
        cur = _check_tokens(jl, tl).astype(np.int32)[:, None]
    assert td["lengths"].tolist() == [S + 4] * B


# -- the wire -----------------------------------------------------------------


def test_recurrent_state_transfer_roundtrip():
    """tests/test_serving.py's round trip, then bit for bit: the raw
    snapshot of every state of a slot comes back out of the decode cache
    it went into as the same bytes, and the wire has the JAX wire's
    slots, keys, shapes and types."""
    jcfg, jp, tcfg, tp, _ = _model("xlstm-125m")
    toks = np.random.default_rng(9).integers(1, 256, (2, 16)).astype(
        np.int32)
    _, jc = j_build(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  max_seq=32)
    _, tc = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    jw = j_kvt.extract(jc, 1, 16, compress=True, backend="ref")
    tw = t_kvt.extract(tc, 1, 16, compress=True)
    assert {n: {k: (w.kind, w.orig_shape, str(w.dtype))
                for k, w in s.items()} for n, s in jw.slots.items()} == \
        {n: {k: (w.kind, w.orig_shape, w.dtype) for k, w in s.items()}
         for n, s in tw.slots.items()}
    dec = t_tf.init_cache(tcfg, 2, 32, device="cpu")
    t_kvt.insert(dec, tw, 0)
    np.testing.assert_allclose(_np(tc["slot0"]["C"][:, 1]),
                               _np(dec["slot0"]["C"][:, 0]), rtol=1e-6)
    back = t_kvt.extract(dec, 0, 16)
    for name, slot in back.slots.items():
        for key, wt in slot.items():
            assert wt.kind == "raw"
            assert torch.equal(wt.payload["x"],
                               tw.slots[name][key].payload["x"].to(
                                   wt.payload["x"].dtype)), (name, key)
    # the snapshot is a copy: the cache moving on does not change it
    before = back.slots["slot0"]["C"].payload["x"].clone()
    dec["slot0"]["C"].add_(1.0)
    assert torch.equal(back.slots["slot0"]["C"].payload["x"], before)
    # compressing a raw wire quantizes positional tensors only
    raw = t_kvt.extract(tc, 0, 16, compress=False)
    assert all(w.kind == "raw" for s in t_kvt.compress_wire(raw)
               .slots.values() for w in s.values())


def test_jamba_wire_compresses_attention_only():
    jcfg, jp, tcfg, tp, _ = _model("jamba-v0.1-52b")
    toks = np.random.default_rng(10).integers(1, 256, (1, 9)).astype(
        np.int32)
    _, tc = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)})
    w = t_kvt.extract(tc, 0, 9)
    kinds = {(n, k): wt.kind for n, s in w.slots.items()
             for k, wt in s.items()}
    attn = [n for n, k in enumerate(j_tf.slot_kinds(jcfg))
            if k.startswith("attn")]
    assert kinds == {(n, k): ("int4" if int(n[4:]) in attn else "raw")
                     for n, s in tc.items() if n != "lengths" for k in s}
    dec = t_tf.init_cache(tcfg, 3, 16, device="cpu")
    t_kvt.insert(dec, w, 2)
    assert int(dec["lengths"][2]) == 9
    for n, s in tc.items():
        if n == "lengths" or int(n[4:]) in attn:
            continue
        for k, t in s.items():
            assert torch.equal(dec[n][k][:, 2], t[:, 0].to(dec[n][k].dtype))


# -- engines ------------------------------------------------------------------


def _greedy(E, cfg, params, prompts, n_steps, *, jax_side):
    """Prefill, admit into a dense decode engine, then ``n_steps`` greedy
    decode steps of the engine's own step function over every slot;
    returns (tokens, JAX-side top-2 margins), each (n_steps, prompts)."""
    dev = {} if jax_side else {"device": "cpu"}
    bk = {"backend": "ref"} if jax_side else {}
    kw = {"rt": RT} if jax_side else {"paged": False}
    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    assert not pre.bucketed
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, **kw, **dev)
    reqs = [E.GenRequest(i, p, n_steps + 1) for i, p in enumerate(prompts)]
    out = pre.run(reqs, **bk)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in out]), **bk)
    cache, cur = dec.cache, np.array(dec.cur_token)
    toks, margins = [], []
    for _ in range(n_steps):
        tok = cur[:, None]
        logits, cache = dec._decode(
            params, cache, {"tokens": jnp.asarray(tok)} if jax_side
            else torch.as_tensor(tok))
        lg = _np(logits[:, -1])[:len(prompts)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        cur[:len(prompts)] = lg.argmax(-1)
        toks.append(lg.argmax(-1))
        margins.append(top2[:, 1] - top2[:, 0])
    return np.array(toks), np.array(margins)


def _prompts(lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_jax(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    prompts, n = _prompts((7, 19, 7)), 8
    jt, jm = _greedy(JE, jcfg, jp, prompts, n, jax_side=True)
    tt, _ = _greedy(TE, tcfg, tp, prompts, n, jax_side=False)
    margin = MARGIN if arch == "xlstm-125m" else DENSE_MARGIN
    for i in range(len(prompts)):
        compared = 0
        for t in range(n):
            if jm[t, i] < margin:
                break
            assert jt[t, i] == tt[t, i], (i, t)
            compared += 1
        assert compared >= 1, (i, jm[:, i])


@pytest.mark.parametrize("arch", ARCHS)
def test_step_equals_step_reference(arch):
    _, _, tcfg, tp, _ = _model(arch)
    pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    streams = []
    for use_ref in (False, True):
        dec = TE.DecodeEngine(tcfg, tp, max_slots=4, max_seq=64,
                              chunk_size=4, device="cpu")
        assert not dec.paged and "recurrent state" in dec.paged_fallback
        reqs = [TE.GenRequest(i, p, 9)
                for i, p in enumerate(_prompts((5, 12, 30)))]
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step_reference() if use_ref else dec.step()
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 9 for s in streams[0])


def test_xlstm_migration_decodes_what_the_undisturbed_slot_does():
    """A request decoding on engine A is snapshotted mid-stream
    (``extract_resident``: recurrent states raw), admitted MIGRATED into
    engine B, and finishes with the tokens it gets on an engine left
    alone."""
    _, _, tcfg, tp, _ = _model("xlstm-125m")
    pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    prompts = _prompts((9, 14), seed=12)

    def fresh():
        reqs = [TE.GenRequest(i, p, 14) for i, p in enumerate(prompts)]
        return reqs, [TE.AdmissionItem(r, f, wire=w)
                      for r, w, f in pre.run(reqs)]

    engine = lambda: TE.DecodeEngine(tcfg, tp, max_slots=3, max_seq=64,
                                     chunk_size=4, device="cpu")
    ref_reqs, items = fresh()
    alone = engine()
    alone.admit(TE.AdmissionBatch(items))
    while alone.active:
        alone.step()
    reqs, items = fresh()
    a, b = engine(), engine()
    a.admit(TE.AdmissionBatch(items))
    a.step()
    # b's slot 0 holds another request, so the migrant lands in slot 1
    other, = [it for it in fresh()[1] if it.req.rid == 1]
    b.admit(TE.AdmissionBatch([other]))
    b.step()
    moved = [it for it in a.extract_resident() if it[1].rid == 0]
    (slot, req, wire, cur), = moved
    assert {w.kind for s in wire.slots.values() for w in s.values()} == \
        {"raw"}
    a.release(slot)
    assert not b.admit(TE.AdmissionBatch([TE.AdmissionItem(
        req, cur, source=TE.ADMIT_MIGRATED, wire=wire)]))
    assert b.slots.index(req) == 1
    while a.active or b.active:
        a.step()
        b.step()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


# -- entry points -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_arch_reduced_drains(arch):
    out = t_serve.run(["--arch", arch, "--reduced", "--device", "cpu",
                       "--duration", "2", "--rate", "2", "--steps", "4"])
    s = out["summary"]
    assert s["n_done"] == s["n_submitted"] > 0
    assert all(not h.engine.paged for h in out["gateway"].dec)


def test_serve_e2e_xlstm_chaos_migrates_recurrent_state():
    out = serve_e2e.run(["--device", "cpu", "--reduced", "--arch",
                         "xlstm-125m", "--chaos", "--requests", "8",
                         "--rate", "3", "--max-new", "32"])
    c = out["stats"]["counters"]
    assert [f["kind"] for f in out["fired"]] == ["crash", "preempt"]
    assert c["migrations"] >= 1 and c["migrated_tokens"] > 0
    assert all(h.state == "DONE" and len(h.tokens) == 32
               for h in out["handles"])
    assert out["page_stats"] == [] and out["params_resident"]
