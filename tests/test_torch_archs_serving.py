"""The other architectures (the dense stablelm-3b, gemma-2b,
h2o-danube-3-4b and command-r-35b, the MoE qwen3-moe-235b-a22b and
llama4-maverick-400b-a17b, and the VLM llava-next-mistral-7b on text
prompts) through the port's engines, wire and entry point, against the
JAX package's engines (CPU, reduced configs in float32).

* Both packages' ``PrefillEngine`` and ``DecodeEngine`` on the same
  weights and prompts, stepped greedily on every decode cache the arch
  takes (int4 pages, the dense cache, bf16 pages; h2o-danube's sliding
  window cannot page and falls back to its dense ring in both): first
  tokens equal, and each stream's tokens equal up to the first step whose
  top-2 margin in the JAX run is below the margin of
  ``tests/test_torch_serving.py`` (2e-2 on the dense cache, whose jnp
  step rounds probabilities to bf16; 1e-3 on pages). Every stream must
  have its first step compared, and on pages half its steps.
* The reference's jitted wire codec rounds where its plain definition
  (``kernels/ref.py``, which the port follows byte for byte) does not:
  ``ops.kv_quant`` divides by 15 as a multiply by 1/15 (XLA's rewrite of
  a division by a constant), and ``ops.kv_dequant`` fuses ``q * scale +
  zero`` into one multiply-add. On bf16 rows (the VLM's exact-length
  wires re-encoded into int4 pages), whose values often sit on a rounding
  tie, the first flips nibbles; the second moves a bf16 page element by
  one ulp now and then, which qwen3's normed keys carry to ~1e-4 in the
  logits over 12 steps. So every arch's run encodes and decodes wires
  on the reference side through ``kv_quant_ref``/``kv_dequant_ref`` run
  eagerly (:func:`_eager_reference_codec`): one plain codec on both
  sides, whatever the arch.
* The same engines fed the same tokens (the JAX run's greedy ones) give
  per-step logits within the model tests' 1e-4, whatever the margins: on
  int4 and bf16 pages against the JAX engine on the same pages; on the
  dense cache against the JAX engine on bf16 pages, which computes the
  port's dense step (the same bf16 K/V rows, f32 probabilities), where
  the JAX dense step rounds its probabilities to bf16 first (~1e-2 apart;
  the sliding window, which cannot page, is held to 1e-4 by the model
  test of its ring in ``tests/test_torch_archs.py``).
* The sliding-window engines: prefill runs at exact lengths (no padded
  row reaches the model), chunked prefill runs a prompt in one shot (with
  raw wires bit-identical to one-shot prefill; int4 wires are grouped
  differently, as in the reference: see the test), the
  decode engine asked for pages reports ``paged_fallback`` and decodes on
  a ``min(max_seq, window)``-row ring, ``step_reference()`` decodes what
  ``step()`` decodes, and the wire carries the ring's rows byte for byte
  as the reference's extraction does.
* The VLM's ``PrefillEngine`` is not bucketed (the reference's rule):
  its prompts run at their exact lengths. A MoE prefill engine pads to
  buckets, and its batch's padding takes expert capacity as the
  reference's does.
* ``launch.serve --arch <arch> --reduced --device cpu`` drains every
  request for each arch.
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
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import kv_transfer as t_kvt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ARCHS = ("stablelm-3b", "gemma-2b", "h2o-danube-3-4b", "command-r-35b",
         "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "llava-next-mistral-7b")
VLM = "llava-next-mistral-7b"
NEW = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", VLM)
MODES = {"int4": {"paged": True, "page_size": 8},
         "dense": {"paged": False},
         "bf16": {"paged": True, "page_size": 8, "kv_resident": "bf16"}}
STEP_MARGIN = {"int4": 1e-3, "dense": 2e-2, "bf16": 1e-3}
ATOL = 1e-4            # tests/test_torch_models.py
SWA = "h2o-danube-3-4b"
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        tcfg = get_reduced(arch).replace(dtype="float32")
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            j_build(jcfg).init(jax.random.PRNGKey(0)))
        _MODELS[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                         convert.params_from_numpy(tree, tcfg, "cpu"))
    return _MODELS[arch]


def _prompts(lens):
    rng = np.random.default_rng(9)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lens]


def _greedy_steps(E, cfg, params, prompts, n_steps, *, jax_side,
                  feed=None, **kw):
    """Prefill, admit, then ``n_steps`` greedy steps of the engine's own
    decode step over every slot; returns per-step tokens, top-2 margins
    (each (n_steps, n_prompts)), logits (n_steps, n_prompts, vocab) and
    the first tokens. ``feed`` (n_steps, n_prompts) forces the tokens fed
    after each step in place of the engine's own argmax."""
    dev = {} if jax_side else {"device": "cpu"}
    bk = {"backend": "ref"} if jax_side else {}
    pre = E.PrefillEngine(cfg, params, max_seq=64, **dev)
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, **kw, **dev)
    reqs = [E.GenRequest(i, p, n_steps + 1) for i, p in enumerate(prompts)]
    out = pre.run(reqs, **bk)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in out]), **bk)
    cache, cur = dec.cache, np.array(dec.cur_token)
    toks, margins, logits_ = [], [], []
    for t in range(n_steps):
        if jax_side:
            logits, cache = dec._decode(params, cache,
                                        {"tokens": jnp.asarray(cur[:, None])})
        else:
            logits, cache = dec._decode(params, cache,
                                        torch.as_tensor(cur[:, None]))
        lg = np.asarray(logits[:, -1], np.float32)[:len(prompts)]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        cur[:len(prompts)] = lg.argmax(-1) if feed is None else feed[t]
        toks.append(lg.argmax(-1))
        margins.append(top2[:, 1] - top2[:, 0])
        logits_.append(lg)
    order = {r.rid: f for r, _, f in out}
    return (np.array(toks), np.array(margins), np.array(logits_),
            [order[i] for i in range(len(prompts))])


def _eager_reference_codec(monkeypatch):
    """The reference's wire codec as its eager plain versions (see the
    module docstring)."""
    from repro.kernels import ops as j_ops
    from repro.kernels import ref as j_ref

    def kv_quant(x, *, backend="auto", **_):
        assert backend == "ref"
        return j_ref.kv_quant_ref(x)

    def kv_dequant(packed, scale, zero, *, out_dtype=jnp.bfloat16,
                   backend="auto", **_):
        assert backend == "ref"
        return j_ref.kv_dequant_ref(packed, scale, zero, dtype=out_dtype)

    monkeypatch.setattr(j_ops, "kv_quant", kv_quant)
    monkeypatch.setattr(j_ops, "kv_dequant", kv_dequant)


def _cases():
    out = []
    for arch in ARCHS:
        for mode in (("dense",) if arch == SWA else sorted(MODES)):
            out.append((arch, mode))
    return out


def _run_prompts(arch):
    """The sliding window's prompts (7, 19 and 40 tokens) overrun its
    32-token window, in prefill or within the 12 steps."""
    return _prompts((7, 19, 40) if arch == SWA else (7, 19, 33)), 12


@pytest.mark.parametrize("arch,mode", _cases())
def test_engines_match_jax(arch, mode, monkeypatch):
    _eager_reference_codec(monkeypatch)
    jcfg, jp, tcfg, tp = _model(arch)
    prompts, n = _run_prompts(arch)
    jt, jm, _, jf = _greedy_steps(JE, jcfg, jp, prompts, n, jax_side=True,
                                  **MODES[mode])
    tt, _, _, tf = _greedy_steps(TE, tcfg, tp, prompts, n, jax_side=False,
                                 **MODES[mode])
    assert jf == tf
    want = 1 if mode == "dense" else n // 2
    for i in range(len(prompts)):
        compared = 0
        for t in range(n):
            if jm[t, i] < STEP_MARGIN[mode]:
                break
            assert jt[t, i] == tt[t, i], (i, t)
            compared += 1
        assert compared >= want, (i, compared)


@pytest.mark.parametrize("arch,mode", [c for c in _cases() if c[0] != SWA])
def test_engine_logits_match_jax(arch, mode, monkeypatch):
    """Every step's logits for every stream, both engines fed the JAX
    run's greedy tokens."""
    _eager_reference_codec(monkeypatch)
    jcfg, jp, tcfg, tp = _model(arch)
    prompts, n = _run_prompts(arch)
    jt, _, _, _ = _greedy_steps(JE, jcfg, jp, prompts, n, jax_side=True,
                                **MODES[mode])
    _, _, lj, _ = _greedy_steps(JE, jcfg, jp, prompts, n, jax_side=True,
                                feed=jt, **MODES["bf16" if mode == "dense"
                                                 else mode])
    _, _, lt, _ = _greedy_steps(TE, tcfg, tp, prompts, n, jax_side=False,
                                feed=jt, **MODES[mode])
    np.testing.assert_allclose(lj, lt, atol=ATOL)


def test_sliding_window_prefill_runs_exact_lengths(monkeypatch):
    """The sliding-window engine is not bucketed: prompts are grouped by
    exact length, so no padded row enters the model (the ring would
    shift), and it cannot prefill a suffix."""
    _, _, tcfg, tp = _model(SWA)
    pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    assert not pre.bucketed and not pre.supports_suffix
    shapes = []
    prefill = pre.api.prefill

    def spy(params, batch, **kw):
        shapes.append(tuple(batch["tokens"].shape))
        assert "last_pos" not in batch and "true_len" not in batch
        return prefill(params, batch, **kw)

    monkeypatch.setattr(pre.api, "prefill", spy)
    reqs = [TE.GenRequest(i, p, 4) for i, p in
            enumerate(_prompts((7, 40, 7, 19)))]
    out = pre.run(reqs)
    assert sorted(shapes) == [(1, 19), (1, 40), (2, 7)]
    assert [r.rid for r, _, _ in out] == [0, 2, 1, 3]
    for r, w, _ in out:
        assert w.request_len == len(r.tokens)
        assert w.slots["slot0"]["k"].orig_shape[1] == min(len(r.tokens), 32)
    _, _, cfg, params = _model("stablelm-3b")
    full = TE.PrefillEngine(cfg, params, device="cpu")
    assert full.bucketed and full.supports_suffix


def test_vlm_prefill_runs_exact_lengths(monkeypatch):
    """The VLM engine, like the reference's, is not bucketed: each prompt
    runs at its exact length (no padded row), and no suffix prefill."""
    _, _, tcfg, tp = _model(VLM)
    pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    jpre = JE.PrefillEngine(_model(VLM)[0], _model(VLM)[1], max_seq=64)
    assert not pre.bucketed and not pre.supports_suffix
    assert not jpre.bucketed
    shapes = []
    prefill = pre.api.prefill

    def spy(params, batch, **kw):
        shapes.append(tuple(batch["tokens"].shape))
        assert "last_pos" not in batch and "patch_embeds" not in batch
        return prefill(params, batch, **kw)

    monkeypatch.setattr(pre.api, "prefill", spy)
    out = pre.run([TE.GenRequest(i, p, 4)
                   for i, p in enumerate(_prompts((7, 19)))])
    assert sorted(shapes) == [(1, 7), (1, 19)]
    assert [w.request_len for _, w, _ in out] == [7, 19]


def test_moe_bucket_padding_matches_the_reference_engine():
    """qwen3-moe's prefill engine pads a 5-token and a 9-token prompt into
    one 16-token bucket of batch 2, as the reference's does: the padded
    batch's 32 tokens share each expert's capacity, and the first tokens
    and int4 wires equal the reference engine's."""
    arch = "qwen3-moe-235b-a22b"
    jcfg, jp, tcfg, tp = _model(arch)
    prompts = _prompts((5, 9))
    jpre = JE.PrefillEngine(jcfg, jp, max_seq=64)
    tpre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    assert jpre.bucketed and tpre.bucketed
    jout = jpre.run([JE.GenRequest(i, p, 4) for i, p in enumerate(prompts)],
                    backend="ref")
    tout = tpre.run([TE.GenRequest(i, p, 4) for i, p in enumerate(prompts)])
    assert [f for _, _, f in jout] == [f for _, _, f in tout]
    for (_, wj, _), (_, wt, _) in zip(jout, tout):
        a, b = wj.slots["slot0"]["k"], wt.slots["slot0"]["k"]
        assert tuple(a.orig_shape) == tuple(b.orig_shape)
        np.testing.assert_allclose(np.asarray(a.payload["scale"]),
                                   b.payload["scale"].numpy(), rtol=1e-4)


@pytest.mark.parametrize("arch", NEW[:2])
def test_moe_chunked_prefill_matches_one_shot_without_drops(arch):
    """The in-port chunked = one-shot contract for a MoE config where no
    route can drop (a 32-token prompt in 16-token chunks: a call of T <=
    32 tokens has capacity T): no route dropped in either arm, the raw
    K/V equal in every layer and the decoded tokens equal."""
    from repro_torch.models import moe
    _, _, tcfg, tp = _model(arch)
    prompt = _prompts((32,))[0]
    outs = []
    for chunked in (False, True):
        pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(tcfg, tp, max_slots=2, max_seq=64,
                              page_size=8, device="cpu")
        req = TE.GenRequest(0, prompt, 10)
        with moe.count_drops() as drops:
            if chunked:
                job = TE.PartialPrefill(req)
                while not job.done:
                    pre.prefill_chunk([job], 16, compress=False)
                wire, first, src = job.transport, job.first, \
                    TE.ADMIT_CHUNKED
            else:
                (_, wire, first), = pre.run([req], compress=False)
                src = TE.ADMIT_FRESH
        n_moe = sum(k == "attn+moe" for k in tcfg.layer_kinds())
        assert len(drops) == n_moe * (1 + chunked)
        assert sum(int(d) for d in drops) == 0
        assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(
            req, first, src, wire=t_kvt.compress_wire(wire))]))
        while dec.active:
            dec.step()
        outs.append((wire.slots["slot0"]["k"].payload["x"][:, :32],
                     req.out_tokens))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] and len(outs[0][1]) == 10


def test_sliding_window_chunked_prefill_runs_in_one_shot():
    """A 40-token prompt with an 8-token budget completes in one tick (the
    engine cannot slice the ring at a position) and, with raw wires,
    decodes what a one-shot prefill decodes. (Compressed, the two differ
    as the reference's do: the one-shot exact-length extraction picks its
    int4 group from the whole tensor, ``compress_wire`` one per position,
    so the two wires round K/V differently.)"""
    _, _, tcfg, tp = _model(SWA)
    prompt = _prompts((40,))[0]
    streams = []
    for chunked in (False, True):
        pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(tcfg, tp, max_slots=2, max_seq=64,
                              device="cpu")
        req = TE.GenRequest(0, prompt, 10)
        if chunked:
            job = TE.PartialPrefill(req)
            pre.prefill_chunk([job], 8, compress=False)
            assert job.done and len(job.wires) == 1
            wire, first, src = job.wire(), job.first, TE.ADMIT_CHUNKED
        else:
            (_, wire, first), = pre.run([req], compress=False)
            src = TE.ADMIT_FRESH
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(req, first, src, wire=wire)]))
        while dec.active:
            dec.step()
        streams.append(req.out_tokens)
    assert streams[0] == streams[1] and len(streams[0]) == 10


def test_sliding_window_engine_decodes_on_its_ring():
    """Asked for pages, the engine falls back to the dense cache (as the
    reference's does) at ``min(max_seq, window)`` rows: 32 of 64. Slots
    decode past the window, ``step_reference()`` decodes what ``step()``
    decodes, and ``step()`` leaves the released slots' lengths at 0."""
    _, _, tcfg, tp = _model(SWA)
    prompts, max_new = _prompts((7, 19, 40)), [30, 20, 12]
    streams = []
    for use_reference in (False, True):
        pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(tcfg, tp, max_slots=4, max_seq=64,
                              chunk_size=4, device="cpu")
        assert not dec.paged and "cannot page" in dec.paged_fallback
        assert dec.cache["slot0"]["k"].shape[2] == 32
        reqs = [TE.GenRequest(i, p, n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step_reference() if use_reference else dec.step()
        if not use_reference:       # the seed path advances idle slots
            assert int(dec.cache["lengths"].abs().sum()) == 0
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[0]] == max_new


@pytest.mark.parametrize("compress", [False, True])
def test_ring_wire_matches_the_reference(compress):
    """A 45-token prefill on the 32-row ring: the wire carries the ring's
    32 rows (position p at row p % 32), the same kind, shape and bytes as
    the reference's extraction, and inserting it into a dense ring cache
    gives the reference's cache."""
    jcfg, jp, tcfg, tp = _model(SWA)
    prompt = _prompts((45,))[0]
    jpre = JE.PrefillEngine(jcfg, jp, max_seq=64)
    tpre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    (_, wj, fj), = jpre.run([JE.GenRequest(0, prompt, 4)], compress=compress,
                            backend="ref")
    (_, wt, ft), = tpre.run([TE.GenRequest(0, prompt, 4)], compress=compress)
    assert fj == ft and wj.request_len == wt.request_len == 45
    for key in ("k", "v"):
        a, b = wj.slots["slot0"][key], wt.slots["slot0"][key]
        assert a.kind == b.kind == ("int4" if compress else "raw")
        assert tuple(a.orig_shape) == tuple(b.orig_shape)
        assert a.orig_shape[1] == 32
        if compress:
            np.testing.assert_array_equal(
                np.asarray(a.payload["packed"]), b.payload["packed"].numpy())
        else:
            np.testing.assert_allclose(np.asarray(a.payload["x"]),
                                       b.payload["x"].numpy(), atol=1e-4)
    shape = (tcfg.num_layers, 2, 32, tcfg.num_kv_heads, tcfg.head_dim)
    jc = {"slot0": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)},
          "lengths": jnp.zeros((2,), jnp.int32)}
    tc = {"slot0": {"k": torch.zeros(shape), "v": torch.zeros(shape)},
          "lengths": torch.zeros((2,), dtype=torch.int32)}
    jc = j_kvt.insert_batch(jc, [(wj, 1)], backend="ref")
    tc = t_kvt.insert_batch(tc, [(wt, 1)])
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc["slot0"][key]),
                                   tc["slot0"][key].numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_drains_every_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu`` (with a chunk budget): every request DONE, no page
    leaked, every engine on the weights it was given."""
    out = t_serve.run(["--arch", arch, "--device", "cpu", "--reduced",
                       "--duration", "3", "--rate", "2", "--steps", "6",
                       "--chunk-tokens", "16"])
    s = out["summary"]
    assert s["n_submitted"] > 0 and s["n_done"] == s["n_submitted"]
    assert out["params_resident"]
    assert all(p["leaked_pages"] == 0 for p in out["page_stats"])
    assert bool(out["page_stats"]) == (arch != SWA)
    text = capsys.readouterr().out
    assert f"scheduling {arch}" in text
    assert f"{s['n_done']}/{s['n_submitted']} requests done" in text
