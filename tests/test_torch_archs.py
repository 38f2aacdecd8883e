"""The other architectures (stablelm-3b, gemma-2b, h2o-danube-3-4b,
command-r-35b; the MoE qwen3-moe-235b-a22b and llama4-maverick-400b-a17b;
the VLM llava-next-mistral-7b) in the port against the JAX package on the
same weights (CPU, reduced configs in float32).

Each arch's JAX params pytree is cast to float32, converted with
``convert.params_from_numpy`` and fed to both sides. What each adds:
stablelm LayerNorm and 25% partial rotary; gemma GeGLU, the embedding
scale, tied embeddings and MQA; h2o-danube a 32-token sliding window (a
ring cache in decode); command-r the parallel block, LayerNorm and tied
embeddings; qwen3-moe a MoE FFN on every layer (top-2 of 8 experts in
the reduced config) and q/k norms; llama4-maverick a two-slot stack (a
dense layer, then a top-1 MoE with a shared expert); llava-next the
projected patch embeddings in front of the text. The reference keeps a
two-slot stack's caches and pages per slot (layer i at slot ``i % 2``,
index ``i // 2``); the port keeps one stack in layer order, and the
comparisons interleave the reference's slots (:func:`_layers`).

Tolerances are those of ``tests/test_torch_models.py``: logits and
caches within 1e-4 absolute, page bytes identical (f32 scale/zero rows
within 1e-5 relative), bf16 pages within one bf16 ulp. The parallel
block adds ``(x + attn) + mlp`` in the port where the reference's
``forward`` (its prefill) adds ``x + (attn + mlp)``: f32 rounding, inside
the same 1e-4. (The plain attention kernels at head dims 80, 120 and
256 are cases of ``tests/test_torch_kernels.py``.)
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import paged as j_paged  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import paged as t_paged  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ATOL = 1e-4
MOE_VLM = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
           "llava-next-mistral-7b")
ARCHS = ("stablelm-3b", "gemma-2b", "h2o-danube-3-4b", "command-r-35b") \
    + MOE_VLM
PAGED_ARCHS = ("stablelm-3b", "gemma-2b", "command-r-35b") + MOE_VLM
VLM = "llava-next-mistral-7b"
_MODELS = {}


def _model(arch):
    """(jcfg, JAX params, port cfg, port params) of the reduced f32 arch,
    built once per module."""
    if arch not in _MODELS:
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        tcfg = get_reduced(arch).replace(dtype="float32")
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            j_build(jcfg).init(jax.random.PRNGKey(0)))
        _MODELS[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                         convert.params_from_numpy(tree, tcfg, "cpu"))
    return _MODELS[arch]


def _tokens(B, S, seed, V=256):
    return np.random.default_rng(seed).integers(1, V, (B, S)).astype(
        np.int32)


def _layers(cache, key):
    """The reference's per-slot stacks of ``key`` (each (n_super, ...))
    as one (L, ...) array in layer order: layer i is slot ``i % period``,
    index ``i // period``."""
    slots = sorted(k for k in cache if k.startswith("slot"))
    stacks = [np.asarray(cache[s][key]) for s in slots]
    L = sum(a.shape[0] for a in stacks)
    return np.stack([stacks[i % len(slots)][i // len(slots)]
                     for i in range(L)])


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x,
                                                              torch.Tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match(arch):
    """Right-padded prompts (exact ones for the sliding window, whose 45
    tokens overrun it: the cache holds the last 32, rolled)."""
    jcfg, jp, tcfg, tp = _model(arch)
    window = bool(tcfg.sliding_window)
    B, S = (2, 45) if window else (2, 16)
    toks = _tokens(B, S, seed=S)
    lp = np.array([S - 1, S - 1 if window else S // 2], np.int32)
    lj, cj = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=S,
                          last_pos=jnp.asarray(lp),
                          true_len=jnp.asarray(lp + 1))
    lt, ct = t_tf.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                          max_seq=S, last_pos=torch.from_numpy(lp),
                          true_len=torch.from_numpy(lp + 1))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    rows = t_tf.cache_rows(tcfg, S)
    assert ct["slot0"]["k"].shape[2] == rows == (32 if window else S)
    for key in ("k", "v"):
        np.testing.assert_allclose(_layers(cj, key),
                                   ct["slot0"][key].numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(cj["lengths"]),
                                  ct["lengths"].numpy())


def _prefilled_caches(jcfg, jp, tcfg, toks, true_len, max_seq):
    """Both sides' dense decode caches of ``max_seq`` after one JAX
    prefill of ``toks`` (B, S) with ``true_len``."""
    B, S = toks.shape
    jc = j_tf.init_cache(jcfg, B, max_seq, jnp.float32)
    tc = t_tf.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    _, jpre = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=S,
                           true_len=jnp.asarray(true_len))
    n = min(S, tc["slot0"]["k"].shape[2])
    for key in ("k", "v"):
        for slot in (k for k in jc if k.startswith("slot")):
            jc[slot][key] = jc[slot][key].at[:, :, :n].set(
                jpre[slot][key][:, :, :n])
        tc["slot0"][key][:, :, :n] = torch.from_numpy(
            _layers(jpre, key)[:, :, :n])
    jc["lengths"] = jnp.asarray(true_len)
    tc["lengths"] = torch.from_numpy(true_len)
    return jc, tc


def _decode_both(jcfg, jp, tcfg, tp, jc, tc, toks):
    """One dense decode step a column of ``toks``; logits each step."""
    for s in range(toks.shape[1]):
        lj, jc = j_tf.decode_step(jcfg, jp, jc,
                                  jnp.asarray(toks[:, s:s + 1]))
        lt, tc = t_tf.decode_step(tcfg, tp, tc,
                                  torch.from_numpy(toks[:, s:s + 1]).long())
        np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jc["lengths"]),
                                  tc["lengths"].numpy())
    for key in ("k", "v"):
        np.testing.assert_allclose(_layers(jc, key),
                                   tc["slot0"][key].numpy(), atol=ATOL)
    return jc, tc


@pytest.mark.parametrize("arch", MOE_VLM)
def test_prefill_suffix_logits_and_cache_match(arch):
    """A suffix over a right-padded prefix of random K/V (the partial hit
    and chunked prefill), each layer's prefix handed to the reference in
    its slot."""
    jcfg, jp, tcfg, tp = _model(arch)
    B, S, P, L = 2, 16, 32, tcfg.num_layers
    rng = np.random.default_rng(7)
    toks = _tokens(B, S, seed=8)
    plen = np.array([32, 16], np.int32)
    shape = (L, B, P, tcfg.num_kv_heads, tcfg.head_dim)
    pk, pv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    period = t_tf.period_of(tcfg)
    jkv = {f"slot{s}": (jnp.asarray(pk[s::period]),
                        jnp.asarray(pv[s::period])) for s in range(period)}
    lp = np.array([15, 9], np.int32)
    lj, cj = j_tf.prefill_suffix(
        jcfg, jp, jnp.asarray(toks), jkv, jnp.asarray(plen), max_seq=S,
        last_pos=jnp.asarray(lp), true_len=jnp.asarray(lp + 1))
    lt, ct = t_tf.prefill_suffix(
        tcfg, tp, torch.from_numpy(toks).long(),
        {"slot0": (torch.from_numpy(pk), torch.from_numpy(pv))},
        torch.from_numpy(plen), max_seq=S, last_pos=torch.from_numpy(lp),
        true_len=torch.from_numpy(lp + 1))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_layers(cj, key),
                                   ct["slot0"][key].numpy(), atol=ATOL)


@pytest.mark.parametrize("n_text", [9, 1])
def test_vlm_prefill_with_patches_then_decode(n_text):
    """llava-next through each package's model API: the prefill takes
    ``patch_embeds`` (8 patches in the reduced config), projected and put
    in front of the right-padded text, with ``last_pos``/``true_len`` in
    text positions shifted by the patch count; the cache holds patches
    plus text. Then ten dense decode steps on each side's own cache."""
    jcfg, jp, tcfg, tp = _model(VLM)
    from repro_torch.models import registry as t_reg
    B, S, n_patch = 2, 12, tcfg.num_patches
    rng = np.random.default_rng(n_text)
    pe = rng.standard_normal((B, n_patch, tcfg.d_model)).astype(np.float32)
    toks = _tokens(B, S + 10, seed=n_text)
    lp = np.array([S - 1, n_text - 1], np.int32)
    jl, jpre = j_build(jcfg).prefill(
        jp, {"tokens": jnp.asarray(toks[:, :S]),
             "patch_embeds": jnp.asarray(pe), "last_pos": jnp.asarray(lp),
             "true_len": jnp.asarray(lp + 1)})
    tl, tpre = t_reg.build(tcfg).prefill(
        tp, {"tokens": torch.from_numpy(toks[:, :S]).long(),
             "patch_embeds": torch.from_numpy(pe),
             "last_pos": torch.from_numpy(lp),
             "true_len": torch.from_numpy(lp + 1)})
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    assert tpre["slot0"]["k"].shape[2] == n_patch + S
    np.testing.assert_array_equal(tpre["lengths"].numpy(),
                                  lp + 1 + n_patch)
    np.testing.assert_array_equal(np.asarray(jpre["lengths"]),
                                  lp + 1 + n_patch)
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jpre["slot0"][key]),
                                   tpre["slot0"][key].numpy(), atol=ATOL)
    # each side's own prefill cache, in a decode cache of 40 rows; the
    # first token fed is each slot's greedy one (text position lp + 1)
    n = n_patch + S
    jc = j_tf.init_cache(jcfg, B, 40, jnp.float32)
    tc = t_tf.init_cache(tcfg, B, 40, torch.float32, device="cpu")
    for key in ("k", "v"):
        jc["slot0"][key] = jc["slot0"][key].at[:, :, :n].set(
            jpre["slot0"][key][:, :, :n])
        tc["slot0"][key][:, :, :n] = tpre["slot0"][key]
    jc["lengths"], tc["lengths"] = jpre["lengths"], tpre["lengths"]
    feed = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
    _decode_both(jcfg, jp, tcfg, tp, jc, tc,
                 np.concatenate([feed, toks[:, S:S + 9]], axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_dense_logits_and_cache_match(arch):
    """Ten dense steps after a ragged prefill (slot 1 starts shorter)."""
    jcfg, jp, tcfg, tp = _model(arch)
    B, S = 2, 8
    toks = _tokens(B, S + 10, seed=5)
    jc, tc = _prefilled_caches(jcfg, jp, tcfg, toks[:, :S],
                               np.array([8, 5], np.int32), 32)
    _decode_both(jcfg, jp, tcfg, tp, jc, tc, toks[:, S:])


@pytest.mark.parametrize("prompt_len", [45, 20])
def test_sliding_window_ring_decodes_past_the_wrap(prompt_len):
    """Reduced h2o-danube (window 32, cache of 96 -> a 32-row ring): a
    45-token prompt starts wrapped, a 20-token one wraps after 12 of its
    24 steps; per-step logits, the ring's rows and the lengths equal the
    reference's, which writes the same ring."""
    jcfg, jp, tcfg, tp = _model("h2o-danube-3-4b")
    toks = _tokens(1, prompt_len + 24, seed=prompt_len)
    jc, tc = _prefilled_caches(jcfg, jp, tcfg, toks[:, :prompt_len],
                               np.array([prompt_len], np.int32), 96)
    assert tc["slot0"]["k"].shape[2] == tcfg.sliding_window == 32
    _, tc = _decode_both(jcfg, jp, tcfg, tp, jc, tc, toks[:, prompt_len:])
    assert int(tc["lengths"][0]) == prompt_len + 24 > 32


@pytest.mark.parametrize("arch,resident", [(a, r) for a in PAGED_ARCHS
                                           for r in ("int4", "bf16")])
def test_decode_step_paged_logits_and_pages_match(arch, resident):
    """N steps from an empty pool on each page residency: per-step logits,
    then the pages (slot 1 runs past its last page into the trash
    page)."""
    jcfg, jp, tcfg, tp = _model(arch)
    toks = _tokens(2, 12, seed=3)
    table = np.array([[3, 5, 1, 0], [2, 0, 0, 0]], np.int32)
    jc = j_paged.init_paged_cache(jcfg, 2, 32, 9, page_size=8,
                                  resident=resident)
    jc["page_table"] = jnp.asarray(table)
    tc = t_paged.init_paged_cache(tcfg, 2, 32, 9, page_size=8,
                                  resident=resident, device="cpu")
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
    if resident == "bf16":
        for key in ("k", "v"):
            np.testing.assert_allclose(
                _layers(jc, key)[:, 1:].astype(np.float32),
                tc["slot0"][key][:, 1:].float().numpy(), rtol=2 ** -7,
                atol=1e-6)
        return
    for name in ("kp", "vp"):
        np.testing.assert_array_equal(_layers(jc, name)[:, 1:],
                                      tc["slot0"][name][:, 1:].numpy())
    for name in ("ks", "kz", "vs", "vz"):
        np.testing.assert_allclose(_layers(jc, name)[:, 1:],
                                   tc["slot0"][name][:, 1:].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_the_converted_layout(arch):
    """``init_params`` builds the converted tree's layout: a LayerNorm's
    scale (ones) and bias (zeros), no ``norm2`` under the parallel block,
    no ``unembed`` under tied embeddings, ``moe`` (f32 router, shared
    expert) on a MoE layer's kind, q/k norms, a VLM's projector; bf16
    weights, f32 norms."""
    _, _, tcfg, tp = _model(arch)
    mine = t_tf.init_params(tcfg, seed=1, device="cpu")
    assert jax.tree.structure(mine, is_leaf=lambda x: isinstance(
        x, torch.Tensor)) == jax.tree.structure(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(_leaves(mine), _leaves(tp)):
        assert a.shape == b.shape
    blk = mine["layers"][0]
    assert ("norm2" in blk) == (not tcfg.parallel_block)
    assert ("unembed" in mine) == (not tcfg.tie_embeddings)
    assert [("moe" in b, "mlp" in b) for b in mine["layers"]] == \
        [(k == "attn+moe", k == "attn+mlp") for k in tcfg.layer_kinds()]
    assert ("mm_projector" in mine) == (tcfg.family == "vlm")
    assert ("qnorm" in blk["attn"]) == tcfg.qk_norm
    ffn = blk["mlp"] if "mlp" in blk else blk["moe"]
    assert ffn["wi"].dtype == torch.bfloat16
    if "moe" in blk:
        assert blk["moe"]["router"].dtype == torch.float32
    if tcfg.norm_type == "layernorm":
        assert torch.equal(blk["norm1"]["scale"], torch.ones(tcfg.d_model))
        assert torch.equal(blk["norm1"]["bias"], torch.zeros(tcfg.d_model))
    else:
        assert blk["norm1"].dtype == torch.float32
    # the analytic count has 2 d of norms a layer, no final norm, no bias,
    # no q/k norm and no projector
    n_norm = sum(t.numel() for b in mine["layers"]
                 for k in ("norm1", "norm2") if k in b
                 for t in _leaves(b[k])) + sum(
        t.numel() for t in _leaves(mine["final_norm"])) + sum(
        b["attn"][k].numel() for b in mine["layers"]
        for k in ("qnorm", "knorm") if k in b["attn"]) + sum(
        t.numel() for t in _leaves(mine.get("mm_projector", [])))
    n = sum(t.numel() for t in _leaves(mine))
    assert n - n_norm == tcfg.param_count() - 2 * tcfg.d_model * \
        tcfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 3, 96)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(j_layers.layernorm(jx, jnp.asarray(scale),
                                         jnp.asarray(bias)), np.float32)
    got = t_layers.layernorm(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(want, got, rtol=tol, atol=tol)


def test_geglu_is_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does the
    port's GeGLU (``F.gelu(approximate="tanh")``): gemma's MLP agrees with
    the reference's, and not with the exact erf GELU."""
    jcfg, jp, tcfg, tp = _model("gemma-2b")
    assert tcfg.mlp_type == "geglu"
    x = np.random.default_rng(1).standard_normal(
        (2, 3, tcfg.d_model)).astype(np.float32) * 2
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"]["slot0"]["mlp"])
    want = np.asarray(j_layers.mlp_apply(jcfg, jmlp, jnp.asarray(x)))
    got = t_layers.mlp_apply(tcfg, tp["layers"][0]["mlp"],
                             torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(want, got, atol=1e-5, rtol=1e-5)
    z = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax.nn.gelu(jnp.asarray(z))),
        torch.nn.functional.gelu(torch.from_numpy(z),
                                 approximate="tanh").numpy(), atol=1e-6)
    assert not np.allclose(
        np.asarray(jax.nn.gelu(jnp.asarray(z))),
        torch.nn.functional.gelu(torch.from_numpy(z)).numpy(), atol=1e-6)


def test_embed_scale_rounds_sqrt_d_to_the_embedding_type():
    """gemma multiplies its bf16 embeddings by sqrt(d_model) cast to bf16
    first (sqrt(2048) = 45.25 in bf16, 45.2548 in f32), as the
    reference's ``_embed_inputs`` does."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma-2b")
    table = torch.randn((16, cfg.d_model), generator=torch.Generator()
                        .manual_seed(0)).to(torch.bfloat16)
    toks = torch.arange(16).reshape(2, 8)
    got = t_tf.embed(cfg, {"embed": table}, toks)
    jt = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    want = j_tf._embed_inputs(cfg, {"embed": jt}, jnp.asarray(toks.numpy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  got.float().numpy())
    assert t_tf._embed_scale(cfg.d_model, torch.bfloat16) == 45.25 != \
        math.sqrt(cfg.d_model)


def test_kernel_lane_maps_cover_every_registered_head_dim():
    """Host side, no card: every registered config with attention layers
    (all but xlstm-125m, whose head_dim 192 no kernel reads) has its head
    dim instantiated in the attention kernels its path runs, the decode
    body's lanes cover it in whole chunks (16-byte bf16 chunks where
    hd / 16 is no power of two: 10 lanes at hd 80, 15 at 120), and where
    the arch pages, the int4 kernel's lane chunk divides the quantization
    group (stablelm-3b: 16 of a 128-wide group over heads of 80)."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.kernels import decode_attention as t_da
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import paged_attention as t_pa
    want = {16: (1, 16), 32: (2, 16), 64: (4, 16), 80: (8, 10),
            120: (8, 15), 128: (8, 16), 256: (16, 16)}
    assert {hd: (t_da.lane_elems(hd), hd // t_da.lane_elems(hd))
            for hd in t_da.HEAD_DIMS} == want
    assert 96 not in t_fa.HEAD_DIMS and 120 not in t_pa.INT4_HEAD_DIMS
    for arch in ALL_ARCHS:
        for cfg in (get_config(arch), get_reduced(arch)):
            if cfg.family == "ssm":
                assert not any(k.startswith("attn")
                               for k in cfg.layer_kinds())
                continue
            hd, gq = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
            assert hd in t_fa.HEAD_DIMS and hd in t_da.HEAD_DIMS, arch
            if t_paged.paged_supported(cfg):
                e = t_pa.lane_elems(hd, t_pa.rows_per_cta(gq))
                assert hd in t_pa.INT4_HEAD_DIMS and hd % e == 0
                assert t_paged.page_group(cfg) % e == 0, arch
    stablelm = get_config("stablelm-3b")
    assert (t_paged.page_group(stablelm), t_pa.lane_elems(80, 1)) == \
        (128, 16)
