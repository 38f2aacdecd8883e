"""whisper-base (the audio encoder-decoder) in the port against the JAX
package (CPU, the reduced config: 2 encoder and 2 decoder layers,
d_model 64, 24 frames; the JAX weights carried over by
``convert.params_from_numpy``, frames and tokens made from a seed with
numpy).

* ``sinusoidal_pos``: within 1e-5 below position 64, and within two
  f32 ulps of the angle at the full encoder's 1500 frames.
* The model in float32: the reference's encoder casts its frames to
  bf16, which its ``lax.scan`` refuses beside f32 weights, so the JAX
  side runs its own whisper code with that one cast lifted (``jnp`` seen
  through :class:`_F32Frames`). Encoder output, prefill logits and
  decode logits (four steps from the same cache on both sides, an f32
  copy of the JAX prefill cache, fed the JAX run's greedy tokens) within
  1e-4 of the largest magnitude, tokens equal wherever the JAX top-2
  margin exceeds 1e-3; the prefill caches (bf16, as the reference's)
  within one bf16 ulp of each other.
* The model in bf16 (the reference's own types): the encoder within a
  relative L2 of 2^-6. JAX rounds every elementwise op of its bf16 GELU
  to bf16, PyTorch computes ``F.gelu`` in f32 and rounds once, so ~44% of
  a bf16 GELU's outputs sit one ulp apart (the bf16 products agree bit
  for bit).
* The wire: ``self_*`` trimmed to the request and int4-compressed,
  ``cross_*`` whole, carrying the encoder's length (the reference's
  ``test_whisper_kv_transfer_roundtrip`` of
  ``tests/test_decode_loop.py``), with the JAX wire's slots, shapes and
  kinds.
* The engine: a dense ``DecodeEngine`` (whisper cannot page) decodes the
  JAX engine's greedy tokens from the two packages' own prefills (the
  margin of the dense cache, 2e-2: the JAX step rounds its probabilities
  to bf16), and ``step()`` decodes what ``step_reference()`` does.
* ``launch.serve`` and ``launch.serve_e2e`` refuse ``--arch
  whisper-base``: the engines cannot prefill audio.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import kv_transfer as j_kvt  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import serve_e2e  # noqa: E402
from repro_torch.models import build, convert, layers  # noqa: E402
from repro_torch.models import whisper as t_whisper  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import kv_transfer as t_kvt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

TOL, MARGIN, DENSE_MARGIN = 1e-4, 1e-3, 2e-2
ARCH = "whisper-base"


class _F32Frames:
    """``jax.numpy`` with ``bfloat16`` naming float32, for the reference's
    whisper module: its ``encode`` casts the frames to ``jnp.bfloat16``;
    through this it runs the same code in f32 (defaults bound at
    definition, such as ``init_cache``'s bf16, are untouched)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def f32_reference(monkeypatch):
    monkeypatch.setattr(j_whisper, "jnp", _F32Frames())


_TREES = {}


def _model(dtype):
    """(JAX config, JAX params, port config, port params) of the reduced
    config with every weight in ``dtype``."""
    if dtype not in _TREES:
        jcfg = j_get_reduced(ARCH)
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), jax.jit(
            j_build(jcfg).init)(jax.random.PRNGKey(0)))
        tcfg = get_reduced(ARCH)
        if dtype == np.float32:
            jcfg, tcfg = (c.replace(dtype="float32") for c in (jcfg, tcfg))
        _TREES[dtype] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                         convert.params_from_numpy(tree, tcfg, "cpu"))
    return _TREES[dtype]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _inputs(cfg, B=2, S=9, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    return frames, rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def _check_tokens(j_logits, t_logits):
    j, t = _np(j_logits)[:, -1], _np(t_logits)[:, -1]
    for a, b in zip(j, t):
        assert np.abs(a - b).max() <= TOL * np.abs(a).max()
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > MARGIN:
            assert a.argmax() == b.argmax()
    return j.argmax(-1)


def test_sinusoidal_pos_matches_jax():
    """Within 1e-5 at the reduced config's positions (below 64). Past
    them the two packages' f32 ``exp`` of a frequency may differ by an
    ulp, which a position p scales into its angle: at the full encoder's
    1500 frames the sides stay within p * 2 ulp(1) of each other."""
    near = np.array([[0, 3, 17], [63, 25, 40]], np.int32)
    far = np.array([[1499, 1024, 250]], np.int32)
    for d in (64, 512):
        _close(layers.sinusoidal_pos(torch.from_numpy(near), d),
               j_layers.sinusoidal_pos(jnp.asarray(near), d), 1e-5)
        err = np.abs(_np(layers.sinusoidal_pos(torch.from_numpy(far), d))
                     - _np(j_layers.sinusoidal_pos(jnp.asarray(far), d)))
        assert np.all(err <= far[..., None] * 2 * 2.0 ** -23 + 1e-6)


def test_encoder_matches_jax_f32(f32_reference):
    jcfg, jp, tcfg, tp = _model(np.float32)
    frames, _ = _inputs(jcfg)
    je = jax.jit(j_whisper.encode, static_argnums=0)(jcfg, jp,
                                                      jnp.asarray(frames))
    te = t_whisper.encode(tcfg, tp, torch.from_numpy(frames))
    assert je.dtype == jnp.float32 and te.dtype == torch.float32
    _close(te, je)


def test_encoder_bf16_within_gelu_rounding():
    jcfg, jp, tcfg, tp = _model(jnp.bfloat16)
    frames, _ = _inputs(jcfg)
    je = _np(jax.jit(j_whisper.encode, static_argnums=0)(
        jcfg, jp, jnp.asarray(frames)))
    te = t_whisper.encode(tcfg, tp, torch.from_numpy(frames))
    assert te.dtype == torch.bfloat16
    rel = np.linalg.norm(_np(te) - je) / np.linalg.norm(je)
    assert rel <= 2 ** -6, rel


def test_prefill_and_decode_logits_match_jax(f32_reference):
    jcfg, jp, tcfg, tp = _model(np.float32)
    frames, toks = _inputs(jcfg)
    B, S, max_seq = toks.shape + (16,)
    jl, jc = jax.jit(j_build(jcfg).prefill, static_argnames="max_seq")(
        jp, {"tokens": jnp.asarray(toks), "frame_embeds":
             jnp.asarray(frames)}, max_seq=S)
    tl, tc = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks),
                                      "frame_embeds":
                                      torch.from_numpy(frames)})
    _check_tokens(jl, tl)
    assert tc["lengths"].tolist() == [S] * B
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tc[name].dtype == torch.bfloat16
        a, b = _np(jc[name]), _np(tc[name])
        assert a.shape == b.shape, name
        assert np.all(np.abs(a - b) <= 2 ** -7 * np.abs(a) + 1e-6), name
    # four decode steps from the JAX prefill cache (f32 on both sides)
    jd = j_whisper.init_cache(jcfg, B, max_seq, jnp.float32)
    td = t_whisper.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    tc_j = {k: convert._tensor(np.asarray(v), "cpu") for k, v in jc.items()}
    for b in range(B):
        jd = j_kvt.insert(jd, j_kvt.extract(jc, b, S, compress=False), b,
                          backend="ref")
        t_kvt.insert(td, t_kvt.extract(tc_j, b, S, compress=False), b)
    j_step = jax.jit(lambda p, c, t: j_whisper.decode_step(jcfg, p, c, t))
    cur = _np(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jd = j_step(jp, jd, jnp.asarray(cur))
        tl, td = t_whisper.decode_step(tcfg, tp, td, torch.from_numpy(cur))
        cur = _check_tokens(jl, tl).astype(np.int32)[:, None]
    assert td["lengths"].tolist() == [S + 4] * B
    _close(td["self_k"][:, :, :S + 4], jd["self_k"][:, :, :S + 4])


def test_whisper_kv_transfer_roundtrip():
    """The reference's round trip on the port: self_* trimmed to the
    request, cross_* whole, both within int4's error; the wire's slots,
    kinds and shapes are the JAX wire's."""
    jcfg, jp, tcfg, tp = _model(jnp.bfloat16)
    frames, toks = _inputs(jcfg, B=2, S=12, seed=1)
    batch = {"tokens": toks, "frame_embeds": frames}
    _, jc = jax.jit(j_build(jcfg).prefill, static_argnames="max_seq")(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_seq=32)
    _, tc = build(tcfg).prefill(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    jw = j_kvt.extract(jc, 1, 12, compress=True, backend="ref")
    wire = t_kvt.extract(tc, 1, 12, compress=True)
    shape = lambda w: {n: {k: (t.kind, t.orig_shape) for k, t in s.items()}
                       for n, s in w.slots.items()}
    assert shape(wire) == shape(jw)
    assert wire.slots["cross_k"]["x"].orig_shape[1] == jcfg.encoder_seq
    assert wire.nbytes() > 0
    dec = t_whisper.init_cache(tcfg, 3, 32, device="cpu")
    t_kvt.insert(dec, wire, 0)
    for name, ln in (("self_k", 12), ("cross_k", jcfg.encoder_seq)):
        src = _np(tc[name][:, 1, :ln])
        dst = _np(dec[name][:, 0, :ln])
        rng_ = np.abs(src).max()
        assert np.abs(src - dst).max() <= rng_ / 15 * 1.1 + 1e-3, name
    assert int(dec["lengths"][0]) == 12


def _greedy(E, cfg, params, n_steps, *, jax_side):
    """The model API's prefill of 3 prompts over seeded frames, the wires
    admitted into a dense decode engine, then ``n_steps`` greedy steps of
    the engine's own step function; returns (tokens, margins)."""
    frames, toks = _inputs(cfg, B=3, S=7, seed=2)
    if jax_side:
        lg, cache = jax.jit(j_build(cfg).prefill,
                            static_argnames="max_seq")(
            params, {"tokens": jnp.asarray(toks),
                     "frame_embeds": jnp.asarray(frames)}, max_seq=7)
        dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=32)
        wires = [j_kvt.extract(cache, b, 7, backend="ref")
                 for b in range(3)]
    else:
        lg, cache = build(cfg).prefill(
            params, {"tokens": torch.from_numpy(toks),
                     "frame_embeds": torch.from_numpy(frames)})
        dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=32,
                             device="cpu")
        assert not dec.paged and "audio" in dec.paged_fallback
        wires = [t_kvt.extract(cache, b, 7) for b in range(3)]
    first = _np(lg[:, -1]).argmax(-1)
    reqs = [E.GenRequest(b, toks[b], n_steps + 1) for b in range(3)]
    bk = {"backend": "ref"} if jax_side else {}
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, int(f), wire=w)
         for r, f, w in zip(reqs, first, wires)]), **bk)
    cache, cur = dec.cache, np.array(dec.cur_token)
    out, margins = [], []
    for _ in range(n_steps):
        tok = cur[:, None]
        logits, cache = dec._decode(
            params, cache, {"tokens": jnp.asarray(tok)} if jax_side
            else torch.as_tensor(tok))
        lg_ = _np(logits[:, -1])[:3]
        top2 = np.sort(lg_, axis=-1)[:, -2:]
        cur[:3] = lg_.argmax(-1)
        out.append(lg_.argmax(-1))
        margins.append(top2[:, 1] - top2[:, 0])
    return first, np.array(out), np.array(margins)


def test_engine_matches_jax(f32_reference):
    jcfg, jp, tcfg, tp = _model(np.float32)
    jf, jt, jm = _greedy(JE, jcfg, jp, 8, jax_side=True)
    tf, tt, _ = _greedy(TE, tcfg, tp, 8, jax_side=False)
    assert jf.tolist() == tf.tolist()
    for i in range(3):
        compared = 0
        for t in range(8):
            if jm[t, i] < DENSE_MARGIN:
                break
            assert jt[t, i] == tt[t, i], (i, t)
            compared += 1
        assert compared >= 1, (i, jm[:, i])


def test_step_equals_step_reference():
    _, _, tcfg, tp = _model(jnp.bfloat16)
    frames, toks = _inputs(tcfg, B=3, S=5, seed=3)
    lg, cache = build(tcfg).prefill(
        tp, {"tokens": torch.from_numpy(toks),
             "frame_embeds": torch.from_numpy(frames)})
    first = lg[:, -1].argmax(-1).tolist()
    streams = []
    for use_ref in (False, True):
        dec = TE.DecodeEngine(tcfg, tp, max_slots=4, max_seq=32,
                              chunk_size=4, device="cpu")
        reqs = [TE.GenRequest(b, toks[b], 9) for b in range(3)]
        assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(
            r, first[b], wire=t_kvt.extract(cache, b, 5))
            for b, r in enumerate(reqs)]))
        while dec.active:
            dec.step_reference() if use_ref else dec.step()
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert all(len(s) == 9 for s in streams[0])


@pytest.mark.parametrize("entry", ["serve", "serve_e2e"])
def test_entry_points_refuse_whisper(entry):
    run = t_serve.run if entry == "serve" else serve_e2e.run
    with pytest.raises(ValueError, match="cannot prefill audio"):
        run(["--arch", ARCH, "--reduced", "--device", "cpu"])
