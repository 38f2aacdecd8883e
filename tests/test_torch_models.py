"""The port's model against the JAX package on the same weights (CPU).

Reduced LLaMA-30B (2 layers, d_model 64) with ``dtype="float32"``; the
JAX params pytree is cast to float32, converted with
``repro_torch.models.convert.params_from_numpy`` and fed to both sides.
Tolerances: logits and KV within 1e-4 absolute (f32 products summed in
another order; |logits| <= ~5). Page bytes after N decode steps must be
identical; the f32 scale/zero rows within 1e-5 relative. The dense decode
step (an f32 cache) and the bf16 page residency are held to the same 1e-4
on their logits; the bf16 pages within one bf16 ulp (2**-7 relative:
K/V a few f32 roundings apart can land on neighbouring bf16 values).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import paged as j_paged  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import paged as t_paged  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_reduced("llama-30b").replace(dtype="float32")
    tcfg = get_reduced("llama-30b").replace(dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            convert.params_from_numpy(tree, tcfg, "cpu"))


def _tokens(B, S, seed, V=256):
    return np.random.default_rng(seed).integers(1, V, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("B,S", [(2, 16), (1, 300)])   # 300: blocked path
def test_prefill_logits_and_cache_match(model, B, S):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(B, S, seed=S)
    lp = np.array([S - 1, S // 2][:B], np.int32)
    lj, cj = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=S,
                          last_pos=jnp.asarray(lp),
                          true_len=jnp.asarray(lp + 1))
    lt, ct = t_tf.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                          max_seq=S, last_pos=torch.from_numpy(lp),
                          true_len=torch.from_numpy(lp + 1))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(cj["slot0"][key]),
                                   ct["slot0"][key].numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(cj["lengths"]),
                                  ct["lengths"].numpy())


def test_prefill_suffix_logits_match(model):
    jcfg, jp, tcfg, tp = model
    B, S, P = 2, 16, 32
    rng = np.random.default_rng(7)
    toks = _tokens(B, S, seed=8)
    plen = np.array([32, 16], np.int32)
    shape = (jcfg.num_layers, B, P, jcfg.num_kv_heads, jcfg.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    lp = np.array([15, 9], np.int32)
    lj, cj = j_tf.prefill_suffix(
        jcfg, jp, jnp.asarray(toks), {"slot0": (jnp.asarray(pk),
                                                jnp.asarray(pv))},
        jnp.asarray(plen), max_seq=S, last_pos=jnp.asarray(lp),
        true_len=jnp.asarray(lp + 1))
    lt, ct = t_tf.prefill_suffix(
        tcfg, tp, torch.from_numpy(toks).long(),
        {"slot0": (torch.from_numpy(pk), torch.from_numpy(pv))},
        torch.from_numpy(plen), max_seq=S, last_pos=torch.from_numpy(lp),
        true_len=torch.from_numpy(lp + 1))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    np.testing.assert_allclose(np.asarray(cj["slot0"]["k"]),
                               ct["slot0"]["k"].numpy(), atol=ATOL)


def test_decode_step_paged_logits_and_pages_match(model):
    """N steps from an empty pool: per-step logits, then every page byte
    (slot 1 runs past its last allocated page into the trash page)."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 12, seed=3)
    table = np.array([[3, 5, 1, 0], [2, 0, 0, 0]], np.int32)
    jc = j_paged.init_paged_cache(jcfg, 2, 32, 9, page_size=8)
    jc["page_table"] = jnp.asarray(table)
    tc = t_paged.init_paged_cache(tcfg, 2, 32, 9, page_size=8,
                                  device="cpu")
    tc["page_table"] = torch.from_numpy(table)
    for s in range(toks.shape[1]):
        lj, jc = j_paged.decode_step_paged(
            jcfg, jp, jc, jnp.asarray(toks[:, s:s + 1]), page_size=8,
            backend="ref")
        lt, tc = t_paged.decode_step_paged(
            tcfg, tp, tc, torch.from_numpy(toks[:, s:s + 1]).long(),
            page_size=8)
        np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    for name in ("kp", "vp"):
        np.testing.assert_array_equal(np.asarray(jc["slot0"][name][:, 1:]),
                                      tc["slot0"][name][:, 1:].numpy())
    for name in ("ks", "kz", "vs", "vz"):
        np.testing.assert_allclose(np.asarray(jc["slot0"][name][:, 1:]),
                                   tc["slot0"][name][:, 1:].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_decode_step_dense_logits_and_cache_match(model):
    """N dense steps after a ragged prefill: per-step logits, then the
    cache and lengths (slot 1 starts shorter, so its writes land at other
    positions than slot 0's)."""
    jcfg, jp, tcfg, tp = model
    B, S, max_seq = 2, 8, 32
    toks = _tokens(B, S + 10, seed=5)
    true_len = np.array([8, 5], np.int32)
    jc = j_tf.init_cache(jcfg, B, max_seq, jnp.float32)
    tc = t_tf.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    _, jpre = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :S]), max_seq=S,
                           true_len=jnp.asarray(true_len))
    for key in ("k", "v"):
        jc["slot0"][key] = jc["slot0"][key].at[:, :, :S].set(
            jpre["slot0"][key][:, :, :S])
        tc["slot0"][key][:, :, :S] = torch.from_numpy(
            np.array(jpre["slot0"][key][:, :, :S]))
    jc["lengths"] = jnp.asarray(true_len)
    tc["lengths"] = torch.from_numpy(true_len)
    for s in range(S, toks.shape[1]):
        lj, jc = j_tf.decode_step(jcfg, jp, jc,
                                  jnp.asarray(toks[:, s:s + 1]))
        lt, tc = t_tf.decode_step(tcfg, tp, tc,
                                  torch.from_numpy(toks[:, s:s + 1]).long())
        np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc["slot0"][key]),
                                   tc["slot0"][key].numpy(), atol=ATOL)


def test_decode_step_paged_bf16_logits_and_pages_match(model):
    """The bf16 residency: N steps from an empty pool, per-step logits and
    every page (slot 1 runs past its last page into the trash page)."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(2, 12, seed=4)
    table = np.array([[3, 5, 1, 0], [2, 0, 0, 0]], np.int32)
    jc = j_paged.init_paged_cache(jcfg, 2, 32, 9, page_size=8,
                                  resident="bf16")
    jc["page_table"] = jnp.asarray(table)
    tc = t_paged.init_paged_cache(tcfg, 2, 32, 9, page_size=8,
                                  resident="bf16", device="cpu")
    tc["page_table"] = torch.from_numpy(table)
    for s in range(toks.shape[1]):
        lj, jc = j_paged.decode_step_paged(
            jcfg, jp, jc, jnp.asarray(toks[:, s:s + 1]), page_size=8,
            backend="ref")
        lt, tc = t_paged.decode_step_paged(
            tcfg, tp, tc, torch.from_numpy(toks[:, s:s + 1]).long(),
            page_size=8)
        np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    for key in ("k", "v"):
        assert tc["slot0"][key].dtype == torch.bfloat16
        np.testing.assert_allclose(
            np.asarray(jc["slot0"][key][:, 1:], np.float32),
            tc["slot0"][key][:, 1:].float().numpy(), rtol=2 ** -7,
            atol=1e-6)


def test_converter_layout_and_init_shapes(model):
    jcfg, jp, tcfg, tp = model
    mine = t_tf.init_params(tcfg, seed=1, device="cpu")
    for p in (tp, mine):
        n = sum(t.numel() for t in jax.tree.leaves(
            p, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        # the analytic count leaves out the final norm's d_model scales
        assert n == tcfg.param_count() + tcfg.d_model
    assert mine["layers"][0]["mlp"]["wi"].dtype == torch.bfloat16
    assert mine["layers"][0]["norm1"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(mine, is_leaf=lambda x: isinstance(
            x, torch.Tensor)), jax.tree.leaves(tp, is_leaf=lambda x:
                                               isinstance(x, torch.Tensor))):
        assert a.shape == b.shape


def test_full_width_config_is_llama_30b():
    cfg = get_config("llama-30b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (60, 6656, 52, 52, 128, 17920, 32000)
    assert cfg.param_count() == 32_528_936_960
    assert (t_paged.page_group(cfg), t_paged.groups_per_token(cfg)) == \
        (128, 52)
    # K+V bytes of one token in one layer: 2 * ppr * (g/2 + 8)
    assert 2 * 52 * (128 // 2 + 8) == 7488


def test_unported_families_raise():
    """What still refuses: a residency nobody has. The hybrid, SSM and
    audio families, which refused here until the recurrent slice (ROADMAP
    A.8), now build, and so do biases (whisper has them). A sliding
    window, which refused here until its ring cache was ported, now
    decodes: an 8-row ring of a 16-position cache, written at ``lengths %
    8``; q/k norms, which refused until the MoE slice, now build. A
    softcap and the hkv_s layout refused here until ROADMAP A.15: their
    dense step now matches the reference's in-place step on the same
    weights, and hkv_s the port's s_hkv step bit for bit."""
    for arch in ("jamba-v0.1-52b", "xlstm-125m", "whisper-base"):
        api = build(get_reduced(arch))
        assert api.decode is not None and api.paged_decode_fns is None
    assert build(get_reduced("llama-30b").replace(attn_bias=True,
                                                  mlp_bias=True))
    assert build(get_reduced("llama-30b").replace(qk_norm=True))
    with pytest.raises(ValueError, match="unknown residency"):
        t_paged.init_paged_cache(get_reduced("llama-30b"), 2, 32, 9,
                                 resident="fp8", device="cpu")
    base = get_reduced("llama-30b")
    for cfg in (base.replace(sliding_window=8),
                base.replace(attn_logit_softcap=30.0),
                base.replace(decode_cache_layout="hkv_s")):
        api = build(cfg)
        params = t_tf.init_params(cfg, device="cpu", dtype=torch.float32)
        cache = t_tf.init_cache(cfg, 1, 16, device="cpu")
        tok = torch.ones((1, 1), dtype=torch.long)
        if not cfg.sliding_window:
            _a15_step_matches(cfg, params, api)
            continue
        assert cache["slot0"]["k"].shape[2] == 8
        cache["lengths"].fill_(11)
        logits, cache = api.decode(params, cache, tok)
        assert bool(torch.isfinite(logits).all())
        assert int(cache["lengths"][0]) == 12
        assert bool(cache["slot0"]["k"][:, 0, 11 % 8].abs().sum() > 0)


def _a15_step_matches(cfg, params, api):
    """Three dense steps from lengths 5 of a zero f32 cache: the port's
    logits within ``ATOL`` of the reference's ``decode_step_inplace`` on
    the same converted weights (hkv_s: the reference's (L, B, Hkv, S, hd)
    cache); hkv_s equal to the s_hkv step bit for bit."""
    tree = convert.params_to_tree(params, cfg)
    jcfg = j_get_reduced("llama-30b").replace(
        dtype="float32", attn_logit_softcap=cfg.attn_logit_softcap,
        decode_cache_layout=cfg.decode_cache_layout)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                      tree)
    jc = j_tf.init_cache(jcfg, 1, 16, jnp.float32)
    jc["lengths"] = jnp.full((1,), 5, jnp.int32)
    tc = t_tf.init_cache(cfg, 1, 16, torch.float32, device="cpu")
    tc["lengths"].fill_(5)
    plain = cfg.replace(decode_cache_layout="s_hkv")
    pc = t_tf.init_cache(plain, 1, 16, torch.float32, device="cpu")
    pc["lengths"].fill_(5)
    rt = j_tf.Runtime(inplace_decode=True)
    tok = np.array([[7]], np.int32)
    for _ in range(3):
        jl, jc = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(tok), rt=rt)
        tl, tc = api.decode(params, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        pl, pc = build(plain).decode(params, pc, torch.from_numpy(tok))
        if cfg.decode_cache_layout == "hkv_s":
            assert torch.equal(tl, pl)
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("path", ["prefill", "suffix", "dense", "int4",
                                  "bf16"])
def test_residual_adds_fused_with_the_norms(model, monkeypatch, path):
    """Every residual add but prefill's last is fused with the norm after
    it: a decode step calls ``rmsnorm`` once (layer 0's norm1) and
    ``add_rmsnorm`` twice a layer (norm2; the next norm1 or the final
    norm); a prefill call norms layer 0 and its kept rows, and leaves the
    last layer's add unfused (2 rmsnorm, 2L - 1 add_rmsnorm)."""
    from repro_torch.kernels import ops as t_ops
    _, _, tcfg, tp = model
    L = tcfg.num_layers
    calls = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in calls:
        fn = getattr(t_ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(t_ops, name, counted)
    toks = torch.from_numpy(_tokens(2, 8, seed=11)).long()
    if path == "prefill":
        t_tf.prefill(tcfg, tp, toks, max_seq=8)
    elif path == "suffix":
        shape = (L, 2, 4, tcfg.num_kv_heads, tcfg.head_dim)
        t_tf.prefill_suffix(tcfg, tp, toks,
                            {"slot0": (torch.zeros(shape),
                                       torch.zeros(shape))},
                            torch.tensor([4, 2], dtype=torch.int32),
                            max_seq=8)
    elif path == "dense":
        cache = t_tf.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
        t_tf.decode_step(tcfg, tp, cache, toks[:, :1])
    else:
        cache = t_paged.init_paged_cache(tcfg, 2, 16, 5, page_size=8,
                                         resident=path, device="cpu")
        t_paged.decode_step_paged(tcfg, tp, cache, toks[:, :1], page_size=8)
    if path in ("prefill", "suffix"):
        assert calls == {"rmsnorm": 2, "add_rmsnorm": 2 * L - 1}
    else:
        assert calls == {"rmsnorm": 1, "add_rmsnorm": 2 * L}
