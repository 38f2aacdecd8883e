"""The reference's last model options in the port, against the JAX
package on the CPU (ROADMAP A.15): a logit softcap, the ``hkv_s`` decode
cache layout, and a sliding window in a recurrent stack's prefill.

Reduced configs in float32 on the same converted weights. Tolerances:
``MODEL_TOL`` (1e-4) of ``max(1, |want|)`` on logits, caches and losses
(f32 products summed in another order); greedy tokens equal wherever the
reference's top-2 margin clears ``MARGIN`` (1e-3). The plain kernels
against ``repro.models.layers.attention_ref`` at 1e-5 (one product each).
The hkv_s step against the port's own s_hkv step: bit for bit (the same
indices over other strides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from conftest import jax_block  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

MODEL_TOL, MARGIN = 1e-4, 1e-3
CAP = 30.0


def _close(got, want, tol=MODEL_TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _same_tokens(got, want):
    """Greedy tokens equal where the reference's top-2 margin clears."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert (got.argmax(-1)[clear] == want.argmax(-1)[clear]).all()
    return want.argmax(-1)


def _models(arch, **over):
    jcfg = j_get_reduced(arch).replace(dtype="float32", **over)
    tcfg = jax_block(get_reduced(arch).replace(dtype="float32", **over))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        j_build(jcfg).init)(jax.random.PRNGKey(0)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            convert.params_from_numpy(tree, tcfg, "cpu"))


def _tokens(B, S, seed, V=256):
    return np.random.default_rng(seed).integers(1, V, (B, S)).astype(
        np.int32)


# -- the plain kernels -------------------------------------------------------------


@pytest.mark.parametrize("Sq,Sk,window,causal", [
    (16, 16, 0, True), (300, 300, 0, True),     # 300: the blocked path
    (40, 40, 7, True), (12, 20, 0, False)])
def test_plain_flash_softcap_matches_attention_ref(Sq, Sk, window, causal):
    rng = np.random.default_rng(Sq + window)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32) * 3
    v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    want = j_layers.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=CAP / 10)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window, softcap=CAP / 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    uncapped = ref.flash_attention_ref(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal,
                                       window=window)
    assert np.abs(uncapped.numpy() - np.asarray(want)).max() > 1e-3


def test_plain_decode_softcap_matches_attention_ref():
    """The decode step's plain version over (B, Hkv, S, hd) against the
    reference's masked attention of one query, and its partial mode's
    log-sum-exp over the capped scores."""
    rng = np.random.default_rng(5)
    B, Hkv, g, hd, S = 3, 2, 4, 16, 24
    q = rng.standard_normal((B, Hkv, g, hd)).astype(np.float32) * 3
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32) * 3
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    kv_len = np.array([1, 24, 13], np.int32)
    want = j_layers.attention_ref(
        jnp.asarray(q.reshape(B, 1, Hkv * g, hd)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), causal=False,
        softcap=CAP / 10, kv_len=jnp.asarray(kv_len))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = ref.decode_attention_ref(*args, kv_len=torch.from_numpy(kv_len),
                                   softcap=CAP / 10)
    np.testing.assert_allclose(got.numpy().reshape(B, 1, Hkv * g, hd),
                               np.asarray(want), atol=1e-5)
    o, lse = ref.decode_attention_ref(*args,
                                      kv_len=torch.from_numpy(kv_len),
                                      softcap=CAP / 10, return_lse=True)
    s = np.einsum("bhgd,bhkd->bhgk", q, k) / np.sqrt(hd)
    s = CAP / 10 * np.tanh(s / (CAP / 10))
    s = np.where(np.arange(S) < kv_len[:, None, None, None], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               atol=1e-5)


# -- the softcap in the reduced LLaMA-30B --------------------------------------------


@pytest.fixture(scope="module")
def capped():
    return _models("llama-30b", attn_logit_softcap=CAP)


@pytest.mark.parametrize("B,S", [(2, 16), (1, 300)])
def test_softcap_prefill_matches(capped, B, S):
    jcfg, jp, tcfg, tp = capped
    toks = _tokens(B, S, seed=S)
    lp = np.array([S - 1, S // 2][:B], np.int32)
    lj, cj = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=S,
                          last_pos=jnp.asarray(lp),
                          true_len=jnp.asarray(lp + 1))
    lt, ct = t_tf.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                          max_seq=S, last_pos=torch.from_numpy(lp),
                          true_len=torch.from_numpy(lp + 1))
    _close(lt.numpy(), lj)
    for key in ("k", "v"):
        _close(ct["slot0"][key].numpy(), cj["slot0"][key])
    # the cap is on: the uncapped model's logits differ
    lu, _ = t_tf.prefill(tcfg.replace(attn_logit_softcap=0.0), tp,
                         torch.from_numpy(toks).long(), max_seq=S,
                         last_pos=torch.from_numpy(lp),
                         true_len=torch.from_numpy(lp + 1))
    assert np.abs(lu.numpy() - np.asarray(lj)).max() > 1e-3


def test_softcap_suffix_prefill_equals_one_shot(capped):
    """A suffix prefill over the prefix's K/V gives the reference's
    one-shot prefill of the whole prompt (logits and the suffix's K/V).
    The reference's own ``prefill_suffix`` leaves the cap out
    (``_suffix_attention``; ROADMAP C.4): its logits miss the one-shot's,
    which is why the port is held to the one-shot prefill here."""
    jcfg, jp, tcfg, tp = capped
    B, P, S = 2, 24, 16
    toks = _tokens(B, P + S, seed=41)
    lj, cj = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=P + S)
    pk, pv = (np.asarray(cj["slot0"][key])[:, :, :P] for key in ("k", "v"))
    plen = np.array([P, P], np.int32)
    lt, ct = t_tf.prefill_suffix(
        tcfg, tp, torch.from_numpy(toks[:, P:]).long(),
        {"slot0": (torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()))},
        torch.from_numpy(plen), max_seq=S)
    _close(lt.numpy(), lj)
    _close(ct["slot0"]["k"].numpy(), np.asarray(cj["slot0"]["k"])[:, :, P:])
    lr, _ = j_tf.prefill_suffix(
        jcfg, jp, jnp.asarray(toks[:, P:]),
        {"slot0": (jnp.asarray(pk), jnp.asarray(pv))}, jnp.asarray(plen),
        max_seq=S)
    assert np.abs(np.asarray(lr) - np.asarray(lj)).max() > 1e-3


def _decode_both(jcfg, jp, tcfg, tp, toks, steps, max_seq=32):
    """Prefill ``toks`` on both sides, then ``steps`` greedy steps: the
    reference's in-place step (jitted) against the port's dense step.
    Returns the port's final cache."""
    B, S = toks.shape
    _, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=max_seq)
    lt, ct = t_tf.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                          max_seq=S)
    tc = t_tf.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    for key in ("k", "v"):
        tc["slot0"][key][:, :, :S] = ct["slot0"][key]
    tc["lengths"].copy_(ct["lengths"])
    rt = j_tf.Runtime(inplace_decode=True)
    j_step = jax.jit(lambda p, c, t: j_tf.decode_step(jcfg, p, c, t, rt=rt))
    cur = lt.numpy()[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(steps):
        jl, jc = j_step(jp, jc, jnp.asarray(cur))
        tl, tc = t_tf.decode_step(tcfg, tp, tc, torch.from_numpy(cur))
        _close(tl.numpy(), jl)
        cur = _same_tokens(tl.numpy()[:, -1], np.asarray(jl)[:, -1]
                           ).astype(np.int32)[:, None]
    return tc, jc


def test_softcap_decode_matches(capped):
    jcfg, jp, tcfg, tp = capped
    _decode_both(jcfg, jp, tcfg, tp, _tokens(2, 9, seed=2), steps=6)


def test_softcap_loss_matches(capped):
    jcfg, jp, tcfg, tp = capped
    toks = _tokens(2, 17, seed=9)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want = j_tf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    got = t_tf.loss_fn(tcfg, tp, {k: torch.from_numpy(v).long()
                                  for k, v in batch.items()})
    _close(got.detach().numpy(), want)


def test_softcap_engines_serve_on_the_dense_cache(capped):
    """The engines take a capped config as the reference's do: it cannot
    page (the dense cache serves it), and its tokens are the model API's."""
    from repro_torch.serving import engine as TE
    _, _, tcfg, tp = capped
    dec = TE.DecodeEngine(tcfg, tp, max_slots=2, max_seq=64, device="cpu")
    assert not dec.paged and "cannot page" in dec.paged_fallback
    pre = TE.PrefillEngine(tcfg, tp, max_seq=64, device="cpu")
    req = TE.GenRequest(0, np.arange(1, 12), 5)
    (r, w, f), = pre.run([req])
    assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(r, f,
                                                             wire=w)]))
    while dec.active:
        dec.step()
    assert len(req.out_tokens) == 5


# -- the hkv_s decode cache ----------------------------------------------------------


def test_hkv_s_decode_matches_reference_and_s_hkv_bit_for_bit():
    """The reduced model decoding on the hkv_s cache: its logits against
    the reference's ``decode_step_inplace`` on its (L, B, Hkv, S, hd)
    cache, and bit for bit against the port's own s_hkv step."""
    jcfg, jp, tcfg, tp = _models("llama-30b", decode_cache_layout="hkv_s")
    toks = _tokens(2, 9, seed=4)
    tc, jc = _decode_both(jcfg, jp, tcfg, tp, toks, steps=6)
    k = tc["slot0"]["k"]
    assert k.transpose(2, 3).is_contiguous()       # the reference's layout
    _close(k.transpose(2, 3).numpy(), jc["slot0"]["k"])
    base = tcfg.replace(decode_cache_layout="s_hkv")
    caches = {}
    for cfg in (base, tcfg):
        _, ct = t_tf.prefill(cfg, tp, torch.from_numpy(toks).long(),
                             max_seq=9)
        c = t_tf.init_cache(cfg, 2, 32, torch.float32, device="cpu")
        for key in ("k", "v"):
            c["slot0"][key][:, :, :9] = ct["slot0"][key]
        c["lengths"].copy_(ct["lengths"])
        cur = torch.tensor([[3], [17]], dtype=torch.int32)
        logits = []
        for _ in range(5):
            lg, c = t_tf.decode_step(cfg, tp, c, cur)
            logits.append(lg)
            cur = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        caches[cfg.decode_cache_layout] = (torch.stack(logits), c)
    (la, ca), (lb, cb) = caches["s_hkv"], caches["hkv_s"]
    assert torch.equal(la, lb)
    for key in ("k", "v"):
        assert torch.equal(ca["slot0"][key], cb["slot0"][key])


def test_hkv_s_engine_tokens_equal_s_hkv():
    """Both engines' paths (the wire's insert, the chunk) on the hkv_s
    cache give the s_hkv engine's tokens."""
    from repro_torch.serving import engine as TE
    _, _, tcfg, tp = _models("llama-30b")
    out = {}
    for layout in ("s_hkv", "hkv_s"):
        cfg = tcfg.replace(decode_cache_layout=layout)
        pre = TE.PrefillEngine(cfg, tp, max_seq=64, device="cpu")
        dec = TE.DecodeEngine(cfg, tp, max_slots=2, max_seq=64,
                              paged=False, device="cpu")
        reqs = [TE.GenRequest(i, np.arange(1, n), 6)
                for i, n in enumerate((12, 20))]
        assert not dec.admit(TE.AdmissionBatch(
            [TE.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step()
        out[layout] = [r.out_tokens for r in reqs]
    assert out["hkv_s"] == out["s_hkv"]


# -- a sliding window in a recurrent stack -----------------------------------------


def test_jamba_window_prefill_ring_and_decode_match():
    """Reduced jamba with a window of 8 and a 20-token prompt: the
    attention slots' ring (the last 8 positions, position p at row p % 8)
    and the recurrent states against the reference's prefill, then its
    in-place decode steps."""
    window = 8
    jcfg, jp, tcfg, tp = _models("jamba-v0.1-52b", sliding_window=window)
    toks = _tokens(2, 20, seed=20)
    lj, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=32)
    lt, ct = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 max_seq=32)
    _close(lt.numpy(), lj)
    attn = [s for s, kind in enumerate(t_tf.slot_kinds(tcfg))
            if kind.startswith("attn")]
    assert attn
    for s, slot in ((s, f"slot{s}") for s in range(
            len(t_tf.slot_kinds(tcfg)))):
        for key, t in ct[slot].items():
            if s in attn:
                assert t.shape[2] == window
            _close(t.numpy(), jc[slot][key])
    td = t_tf.init_cache(tcfg, 2, 32, torch.float32, device="cpu")
    for slot, st in ct.items():
        if slot == "lengths":
            td["lengths"].copy_(st)
            continue
        for key, t in st.items():
            td[slot][key].copy_(t)
    rt = j_tf.Runtime(inplace_decode=True)
    j_step = jax.jit(lambda p, c, t: j_tf.decode_step(jcfg, p, c, t, rt=rt))
    cur = np.asarray(lj)[:, -1].argmax(-1).astype(np.int32)[:, None]
    for _ in range(6):
        jl, jc = j_step(jp, jc, jnp.asarray(cur))
        tl, td = t_tf.decode_step(tcfg, tp, td, torch.from_numpy(cur))
        _close(tl.numpy(), jl)
        cur = _same_tokens(tl.numpy()[:, -1], np.asarray(jl)[:, -1]
                           ).astype(np.int32)[:, None]
    for s in attn:
        _close(td[f"slot{s}"]["k"].numpy(), jc[f"slot{s}"]["k"])


@pytest.mark.parametrize("mesh", ["one", "four"])
def test_dryrun_kv_layout_hkv_s_counts_the_s_hkv_step(monkeypatch, mesh):
    """The dry-run's ``--kv_layout hkv_s`` (a 64-token decode cell of
    LLaMA-30B): the same cache bytes, kernel calls, FLOPs and bytes as the
    s_hkv step, over a cache whose strides are the reference's layout."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    monkeypatch.setitem(dryrun.SHAPES, "decode_64",
                        ShapeSpec("decode_64", 64, 2, "decode"))
    got = {}
    for layout in (None, "hkv_s"):
        counted, info = dryrun.trace_cell(
            "llama-30b", "decode_64", dryrun.make_mesh(mesh),
            kv_layout=layout)
        got[layout] = (counted["kernels"], counted["flops"],
                       counted["bytes"], info["cache"])
    assert info["cfg"].decode_cache_layout == "hkv_s"
    assert got["hkv_s"] == got[None]
