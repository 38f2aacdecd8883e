"""The port's plain kernel versions against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Against ``repro.kernels.ref`` the port must agree BIT FOR BIT on
``kv_quant``/``kv_dequant`` (packed bytes, scale, zero, dequantized
values). The Pallas kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) round their scale and f32 dequant
differently (a reciprocal multiply, a fused multiply-add): against them
scale and values are held to 1e-6 relative and a nibble on a rounding
knife edge may move by one, as ``tests/test_kernels.py`` holds the two
JAX paths. Paged attention sums in another order: 2e-5 in f32.

Flash attention (the port's prefill attention, ``(B, S, H, hd)`` layout)
is held to ``repro.kernels.ref.flash_attention_ref`` and to the Pallas
kernel in interpret mode (``(B*H, S, hd)`` layout) over causal, window and
GQA shapes at 1e-5 in f32; its suffix mask to the port's previous
``_suffix_attention`` formula. RMSNorm is held to ``rmsnorm_ref`` and the
interpreted Pallas kernel at 1e-6 in f32 and one ulp in bf16.

Dense decode attention (``decode_attention_ref``, read through a strided
cache view) and the bf16 page residency of paged attention are held to
``repro.kernels.ref`` and to the interpreted Pallas kernels at 2e-5 in
f32 (another summation order), with ragged ``kv_len >= 1`` (the Pallas
decode kernel needs S divisible by min(256, S): S = 40 is one key block,
S = 512 two) and trash-page table entries.
"""
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kv_layout as j_layout  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import decode_attention as t_da  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import kv_layout as t_layout  # noqa: E402
from repro_torch.kernels import kv_quant as t_kq  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import paged_attention as t_pa  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import rmsnorm as t_rn  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


# -- layout contract ------------------------------------------------------------


def test_layout_constants_and_group_rule_match():
    assert t_layout.GROUPS == j_layout.GROUPS
    for span in range(0, 1100):
        assert t_layout.pick_group(span) == j_layout.pick_group(span)


@pytest.mark.parametrize("shape", [(7, 3), (4, 64), (2, 5, 8)])
def test_nibble_helpers_match(shape):
    rng = np.random.default_rng(sum(shape))
    even = rng.integers(0, 16, shape).astype(np.uint8)
    odd = rng.integers(0, 16, shape).astype(np.uint8)
    pj = j_layout.pack_nibbles(jnp.asarray(even), jnp.asarray(odd))
    pt = t_layout.pack_nibbles(torch.from_numpy(even), torch.from_numpy(odd))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    for a, b in zip(j_layout.unpack_nibbles(pj), t_layout.unpack_nibbles(pt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(j_layout.interleave_nibbles(pj)),
                                  t_layout.interleave_nibbles(pt).numpy())


# -- kv_quant / kv_dequant --------------------------------------------------------


QUANT_CASES = [(17, 64), (300, 64), (257, 128), (256, 16), (1, 2)]


@pytest.mark.parametrize("N,G", QUANT_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_ref_bit_exact_vs_jax(N, G, dtype):
    x = np.random.default_rng(N * G).standard_normal((N, G)) \
        .astype(np.float32) * 3
    xj, xt = _both(x, dtype)
    for a, b in zip(j_ref.kv_quant_ref(xj), t_ref.kv_quant_ref(xt)):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the CPU dispatch of ops is exactly the plain version
    for a, b in zip(t_ops.kv_quant(xt), t_ref.kv_quant_ref(xt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,G", QUANT_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_ref_vs_pallas_interpret(N, G, dtype):
    x = np.random.default_rng(N + G).standard_normal((N, G)) \
        .astype(np.float32) * 3
    xj, xt = _both(x, dtype)
    pj, sj, zj = j_ops.kv_quant(xj, backend="interpret")
    pt, st, zt = t_ref.kv_quant_ref(xt)
    np.testing.assert_allclose(_np(sj), _np(st), rtol=1e-6)
    np.testing.assert_array_equal(_np(zj), _np(zt))
    # the interpreted scale is a rounding apart, so a value on a rounding
    # knife edge may land one nibble over (tests/test_kernels.py allows
    # the same between the two JAX paths)
    nj = np.asarray(j_layout.interleave_nibbles(pj))
    nt = t_layout.interleave_nibbles(pt).numpy()
    assert np.abs(nj - nt).max() <= 1
    assert (nj != nt).mean() < 1e-3


@pytest.mark.parametrize("N,G", QUANT_CASES)
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_kv_dequant_ref_vs_jax(N, G, out):
    rng = np.random.default_rng(N * 3 + G)
    packed = rng.integers(0, 256, (N, G // 2)).astype(np.uint8)
    scale = (rng.random((N, 1)) * 0.4).astype(np.float32)
    zero = rng.standard_normal((N, 1)).astype(np.float32)
    jd, td = DTYPES[out]
    yt = t_ref.kv_dequant_ref(torch.from_numpy(packed),
                              torch.from_numpy(scale),
                              torch.from_numpy(zero), dtype=td)
    yj = j_ref.kv_dequant_ref(jnp.asarray(packed), jnp.asarray(scale),
                              jnp.asarray(zero), dtype=jd)
    np.testing.assert_array_equal(_np(yj), _np(yt))
    yi = j_ops.kv_dequant(jnp.asarray(packed), jnp.asarray(scale),
                          jnp.asarray(zero), out_dtype=jd,
                          backend="interpret")
    # interpret mode fuses the multiply-add in f32: one rounding apart
    np.testing.assert_allclose(_np(yi), _np(yt), rtol=1e-6, atol=1e-6)


# -- paged decode attention ---------------------------------------------------------


def _paged_inputs(B, Hkv, gq, hd, ps, lens, seed, n_extra_pages=3):
    """Random int4 pages (numpy), a shuffled page table whose unused
    entries point at the trash page 0, q and kv_len."""
    rng = np.random.default_rng(seed)
    g = j_layout.pick_group(Hkv * hd)
    ppr = Hkv * hd // g
    W = max(-(-ln // ps) for ln in lens) + 1           # >= 1 trash entry
    need = sum(-(-ln // ps) for ln in lens)
    P = 1 + need + n_extra_pages
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, W), np.int32)
    n = 0
    for b, ln in enumerate(lens):
        k = -(-ln // ps)
        pt[b, :k] = perm[n:n + k]
        n += k

    def triple():
        return (rng.integers(0, 256, (P, ps * ppr, g // 2)).astype(np.uint8),
                (rng.random((P, ps * ppr, 1)) * 0.3).astype(np.float32),
                rng.standard_normal((P, ps * ppr, 1)).astype(np.float32))

    q = rng.standard_normal((B, Hkv, gq, hd)).astype(np.float32)
    return q, triple(), triple(), pt, np.asarray(lens, np.int32)


PAGED_CASES = [
    # (B, Hkv, gq, hd, page_size, kv_lens)
    (3, 2, 4, 16, 8, [5, 16, 23]),       # GQA; g = 32 spans 2 heads
    (2, 1, 8, 32, 16, [17, 48]),         # MQA; g = 32 = hd
    (4, 4, 1, 16, 8, [1, 9, 24, 31]),    # reduced llama: g = 64 spans 4
    (2, 2, 2, 128, 4, [7, 13]),          # g = 128 = hd, GQA
    (2, 2, 1, 80, 8, [5, 19]),           # stablelm-3b's hd: g = 32 (5 a pair)
    (2, 1, 2, 256, 8, [5, 19]),          # gemma-2b's: g = 128, 2 a head
]


@pytest.mark.parametrize("B,Hkv,gq,hd,ps,lens", PAGED_CASES)
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_paged_attention_ref_vs_jax(B, Hkv, gq, hd, ps, lens, against):
    q, kp, vp, pt, kl = _paged_inputs(B, Hkv, gq, hd, ps, lens,
                                      seed=B * 31 + hd)
    jt = lambda tr: tuple(jnp.asarray(a) for a in tr)
    tt = lambda tr: tuple(torch.from_numpy(a) for a in tr)
    if against == "ref":
        want = j_ref.paged_decode_attention_ref(
            jnp.asarray(q), jt(kp), jt(vp), jnp.asarray(pt),
            jnp.asarray(kl), page_size=ps)
    else:
        want = j_ops.paged_decode_attention(
            jnp.asarray(q), jt(kp), jt(vp), jnp.asarray(pt),
            jnp.asarray(kl), page_size=ps, backend="interpret")
    got = t_ops.paged_decode_attention(
        torch.from_numpy(q), tt(kp), tt(vp), torch.from_numpy(pt),
        torch.from_numpy(kl), page_size=ps)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_paged_attention_ignores_trash_page_and_tail():
    q, kp, vp, pt, kl = _paged_inputs(3, 2, 4, 16, 8, [5, 16, 23], seed=4)
    tt = lambda tr: tuple(torch.from_numpy(a) for a in tr)
    args = (torch.from_numpy(pt), torch.from_numpy(kl))
    a = t_ref.paged_decode_attention_ref(torch.from_numpy(q), tt(kp), tt(vp),
                                         *args, page_size=8)
    kp2 = (kp[0].copy(), kp[1].copy(), kp[2])
    kp2[0][0] = 255
    kp2[1][0] = 1e6
    b = t_ref.paged_decode_attention_ref(torch.from_numpy(q), tt(kp2),
                                         tt(vp), *args, page_size=8)
    assert torch.equal(a, b)


# -- the int4 CUDA kernel's split plan (host side, no card needed) -------------

H100_SMS = 132


@pytest.mark.parametrize("W,ps", [(16, 16), (6, 16), (5, 16), (1, 16),
                                  (4, 8), (17, 4), (64, 1), (3, 128)])
def test_split_plan_covers_every_page_once(W, ps):
    """Splits tile the page table: every page index in exactly one split,
    none empty; for every kv_len the splits the kernel keeps (those that
    start below kv_len, and split 0 for kv_len 0) hold exactly the pages
    it must read, min(ceil(kv_len / ps), W) of them."""
    pages, n_split = t_pa.split_plan(W, ps)
    spans = [range(s * pages, min((s + 1) * pages, W))
             for s in range(n_split)]
    assert all(len(r) > 0 for r in spans)
    assert [i for r in spans for i in r] == list(range(W))
    for kv_len in range(W * ps + 5):
        n_need = min(-(-kv_len // ps), W)
        live = [r for s, r in enumerate(spans)
                if s * pages * ps < min(kv_len, W * ps) or s == 0]
        read = [i for r in live for i in r if i < n_need]
        assert read == list(range(n_need))
        assert len(live) == max(1, -(-min(kv_len, W * ps) // (pages * ps)))


def test_split_plan_reads_only_host_shapes():
    """Grid, scratch and counters come from shapes and the card's
    residency alone (the wrapper never reads kv_len, so it runs under
    set_sync_debug_mode("error") and in a CUDA graph): the grid is 1-D, at
    most WAVES times the CTAs the SMs hold (16 each at most: 2,048 threads
    of 128), so at most 64 x 132 on the H100 whatever B and W are, and at
    most the work items the shapes allow; the main path's decode step (4
    slots, 52 KV heads, W = 16 pages of 16 tokens) gets a CTA for each of
    its items, at least 2 on each SM."""
    import inspect
    assert list(inspect.signature(t_pa.split_plan).parameters) == \
        ["W", "page_size"]
    assert list(inspect.signature(t_pa.launch_shape).parameters) == \
        ["B", "Hkv", "gq", "hd", "W", "page_size", "sms", "per_sm"]
    assert t_pa.WAVES == 4
    ctas, n_part, n_count = t_pa.launch_shape(4, 52, 1, 128, 16, 16,
                                              H100_SMS, 3)
    assert 2 * H100_SMS <= ctas == 4 * 52 * t_pa.split_plan(16, 16)[1]
    assert n_part == 4 * 52 * 4 * (128 + 2) and n_count == 4 * 52
    # the served cell: 96 slots of 256 16-token pages, 8 KV heads of 8
    # query rows (2 row blocks of 4): 98,304 items, 4 waves of CTAs
    ctas, n_part, n_count = t_pa.launch_shape(96, 8, 8, 128, 256, 16,
                                              H100_SMS, 4)
    assert ctas == 4 * 4 * H100_SMS and n_count == 96 * 8 * 2
    assert n_part == 96 * 8 * 2 * 4 * 64 * (128 + 2)
    for B in (1, 4, 96, 1024):
        for W in (1, 16, 256, 4096):
            for per_sm in (1, 3, 4, 16):
                ctas = t_pa.launch_shape(B, 8, 8, 128, W, 16, H100_SMS,
                                         per_sm)[0]
                items = B * 8 * 2 * t_pa.split_plan(W, 16)[1]
                assert 1 <= ctas <= min(items, 64 * H100_SMS,
                                         t_pa.WAVES * H100_SMS * per_sm)
    # GQA: rows in blocks of 4, the last block padded
    ctas, n_part, n_count = t_pa.launch_shape(3, 2, 6, 32, 4, 8,
                                              H100_SMS, 8)
    assert ctas == 12 and n_count == 12
    assert n_part == 6 * 2 * 4 * 1 * (32 + 2)
    assert t_pa.paged_decode_attention_int4.ctas >= 0
    assert "paged_decode_attention_int4" in t_ops.cta_counts()


@pytest.mark.parametrize("W,ps", [(256, 16), (16, 16), (5, 16), (1, 16),
                                  (4, 8), (17, 4), (64, 1), (3, 128)])
def test_int4_split_tiles_each_slot(W, ps):
    """A slot's int4 splits (a function of its own kv_len and the shapes)
    tile its keys, none empty; each is split_plan's length up to
    INT4_SPLITS of them (there the kernel's arithmetic is the split
    plan's), else grows, a whole number of pages, to at most
    INT4_MAX_SPLIT_TOKENS; a slot never has more splits than split_plan
    gives, so the scratch sized by shapes holds them."""
    pages, n_split = t_pa.split_plan(W, ps)
    top = max(pages, t_pa.INT4_MAX_SPLIT_TOKENS // ps) * ps
    for kv_len in range(-1, W * ps + 5):
        tokens, n = t_pa.int4_split(kv_len, W, ps)
        m = min(max(kv_len, 0), W * ps)
        assert tokens % ps == 0 and pages * ps <= tokens <= top
        assert n <= n_split and (n - 1) * tokens < m <= n * tokens or \
            m == n == 0
        if m <= t_pa.INT4_SPLITS * pages * ps:
            assert tokens == pages * ps
        elif tokens < top:
            assert n <= t_pa.INT4_SPLITS


def _work_list(kv_len, Hkv, n_rb, W, ps, ctas):
    """A model of the int4 kernel's work (``csrc/paged_attention.cu``),
    each slot split by ``int4_split`` of its own kv_len: the block scan of
    each slot's live splits lists the live items, nested (slot, split,
    head, row block); CTA ``c`` of the 1-D grid of ``ctas`` takes items
    ``c, c + ctas, ...`` and finds each one's slot by the kernel's binary
    search. Returns ``[(cta, b, split, h, rb, t0, t_end)]``."""
    max_len = W * ps
    lens = [min(max(int(n), 0), max_len) for n in kv_len]
    plans = [t_pa.int4_split(n, W, ps) for n in lens]
    first = [0]
    for _, n in plans:
        first.append(first[-1] + n * Hkv * n_rb)
    out = []
    for cta in range(ctas):
        for item in range(cta, first[-1], ctas):
            b, hi = 0, len(lens)
            while hi - b > 1:
                mid = (b + hi) >> 1
                if first[mid] <= item:
                    b = mid
                else:
                    hi = mid
            k = item - first[b]
            rb, h, split = k % n_rb, (k // n_rb) % Hkv, k // (n_rb * Hkv)
            t0 = split * plans[b][0]
            out.append((cta, b, split, h, rb, t0,
                        min(lens[b], t0 + plans[b][0])))
    return out


@pytest.mark.parametrize("B,Hkv,gq,W,ps,seed", [
    (96, 8, 8, 256, 16, 0),      # the served cell: 96 slots, gq 8
    (96, 8, 8, 256, 16, 1),
    (96, 8, 8, 256, 16, 2),
    (96, 52, 1, 16, 16, 3),      # LLaMA-30B's one-row body
    (7, 1, 8, 16, 16, 4),        # gemma-2b: 8 query heads over 1 KV head
    (5, 4, 16, 8, 4, 5),         # qwen3-moe: 4 row blocks
    (9, 8, 5, 17, 8, 6),         # llama4-maverick: gq 5, a ragged last split
    (200, 2, 4, 3, 16, 7),       # more slots than a CTA's 128 threads
])
def test_int4_work_list_covers_live_items_once(B, Hkv, gq, W, ps, seed):
    """Random kv_len over B slots, zeros included, up to W x page_size:
    every live (slot, split, head, row block) is one item, taken by
    exactly one CTA, whatever the grid (one item a CTA, or several); a
    slot's splits tile its own keys; and a slot's split boundaries stay
    the same when the other slots' lengths change or its items fall to
    other CTAs."""
    rng = np.random.default_rng(seed)
    n_rb = -(-gq // t_pa.rows_per_cta(gq))
    _, n_split = t_pa.split_plan(W, ps)
    max_len = W * ps

    def draw():
        lens = rng.integers(1, max_len + 1, size=B)
        lens[rng.random(B) < 0.5] = 0
        lens[rng.integers(B)] = max_len
        return lens

    def slot_spans(work, b):
        return sorted(w[2:] for w in work if w[1] == b)

    lens = draw()
    ctas = t_pa.launch_shape(B, Hkv, gq, 128, W, ps, H100_SMS, 4)[0]
    work = _work_list(lens, Hkv, n_rb, W, ps, ctas)
    items = [w[1:5] for w in work]
    assert len(set(items)) == len(items)
    assert sorted(items) == sorted(
        (b, s, h, rb) for b in range(B) for h in range(Hkv)
        for rb in range(n_rb)
        for s in range(t_pa.int4_split(lens[b], W, ps)[1]))
    assert all(0 <= w[2] < n_split and w[5] < w[6] for w in work)
    for b in range(B):
        keys = [t for w in work if w[1] == b and w[3:5] == (0, 0)
                for t in range(w[5], w[6])]
        assert sorted(keys) == list(range(lens[b]))
    others = draw()
    for b in np.flatnonzero(lens)[:4]:
        moved = others.copy()
        moved[b] = lens[b]
        alone = np.zeros_like(lens)
        alone[b] = lens[b]
        want = slot_spans(work, b)
        for kl, n in ((moved, ctas), (alone, 1), (lens, 7)):
            got = _work_list(kl, Hkv, n_rb, W, ps, n)
            assert slot_spans(got, b) == want


DECODE_CASES = [
    # (B, Hkv, g, hd, S, kv_lens)
    (3, 2, 4, 16, 40, [1, 40, 23]),      # GQA, one key block
    (2, 4, 1, 16, 512, [300, 512]),      # two 256-key blocks, MHA
    (2, 1, 8, 32, 40, [17, 2]),          # MQA
    (2, 2, 1, 80, 40, [17, 40]),         # stablelm-3b's head dim
    (2, 1, 2, 120, 40, [17, 40]),        # h2o-danube-3-4b's
    (2, 1, 2, 256, 40, [17, 40]),        # gemma-2b's
]


@pytest.mark.parametrize("B,Hkv,g,hd,S,lens", DECODE_CASES)
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_decode_attention_ref_vs_jax(B, Hkv, g, hd, S, lens, against):
    """The plain version, fed one layer of an (L, B, S, Hkv, hd) cache as
    the permuted view the model passes, against the JAX oracle and the
    interpreted Pallas kernel on (B, Hkv, S, hd) copies."""
    rng = np.random.default_rng(B * 7 + S)
    q = rng.standard_normal((B, Hkv, g, hd)).astype(np.float32)
    cache = rng.standard_normal((2, 2, B, S, Hkv, hd)).astype(np.float32)
    kl = np.asarray(lens, np.int32)
    k_j = np.ascontiguousarray(cache[0, 1].transpose(0, 2, 1, 3))
    v_j = np.ascontiguousarray(cache[1, 1].transpose(0, 2, 1, 3))
    if against == "ref":
        want = j_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k_j),
                                          jnp.asarray(v_j),
                                          kv_len=jnp.asarray(kl))
    else:
        want = j_ops.decode_attention(jnp.asarray(q), jnp.asarray(k_j),
                                      jnp.asarray(v_j), jnp.asarray(kl),
                                      backend="interpret")
    tc = torch.from_numpy(cache)
    got = t_ops.decode_attention(torch.from_numpy(q),
                                 tc[0, 1].permute(0, 2, 1, 3),
                                 tc[1, 1].permute(0, 2, 1, 3),
                                 torch.from_numpy(kl))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=2e-5,
                               rtol=2e-5)


def _bf16_page_inputs(B, Hkv, gq, hd, ps, lens, seed):
    """bf16-valued pages (as f32 numpy: both sides cast), the page table
    of ``_paged_inputs`` (unused entries on the trash page 0), q, kv_len."""
    q, _, _, pt, kl = _paged_inputs(B, Hkv, gq, hd, ps, lens, seed)
    rng = np.random.default_rng(seed + 1)
    P = int(pt.max()) + 4

    def pages():
        x = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    return q, pages(), pages(), pt, kl


@pytest.mark.parametrize("B,Hkv,gq,hd,ps,lens", PAGED_CASES)
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_paged_attention_bf16_ref_vs_jax(B, Hkv, gq, hd, ps, lens, against):
    q, kp, vp, pt, kl = _bf16_page_inputs(B, Hkv, gq, hd, ps, lens,
                                          seed=B * 17 + hd)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    if against == "ref":
        want = j_ref.paged_decode_attention_ref(
            jnp.asarray(q), jb(kp), jb(vp), jnp.asarray(pt),
            jnp.asarray(kl), page_size=ps)
    else:
        want = j_ops.paged_decode_attention(
            jnp.asarray(q), jb(kp), jb(vp), jnp.asarray(pt),
            jnp.asarray(kl), page_size=ps, backend="interpret")
    got = t_ops.paged_decode_attention(
        torch.from_numpy(q), tb(kp), tb(vp), torch.from_numpy(pt),
        torch.from_numpy(kl), page_size=ps)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_paged_attention_bf16_ignores_trash_page_and_tail():
    q, kp, vp, pt, kl = _bf16_page_inputs(3, 2, 4, 16, 8, [5, 16, 23],
                                          seed=5)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = (torch.from_numpy(pt), torch.from_numpy(kl))
    a = t_ref.paged_decode_attention_ref(torch.from_numpy(q), tb(kp),
                                         tb(vp), *args, page_size=8)
    kp2 = kp.copy()
    kp2[0] = 1e4
    b = t_ref.paged_decode_attention_ref(torch.from_numpy(q), tb(kp2),
                                         tb(vp), *args, page_size=8)
    assert torch.equal(a, b)


# -- kv_quant_append: the paged decode step's append ----------------------------------

APPEND_CASES = [
    # (B, Hkv, hd, page_size, W, lengths); -1 = an inactive slot (length 0,
    # its table row all trash)
    (4, 4, 16, 8, 3, [23, 5, -1, 0]),    # reduced llama: g = 64, ppr = 1;
                                         # slot 0 at its last position
    (3, 3, 32, 4, 2, [7, -1, 2]),        # g = 32, ppr = 3, last position
    (3, 2, 8, 4, 2, [8, 3, -1]),         # g = 16; slot 0 past its table:
                                         # clamped to entry W - 1
]


def _append_inputs(B, Hkv, hd, ps, W, lens, seed):
    """Random int4 pages of both K and V (numpy), a page table with each
    active slot's entries on shuffled pages (enough to hold its next token,
    at most W), this step's k/v (B, 1, Hkv, hd) and the lengths."""
    rng = np.random.default_rng(seed)
    g = j_layout.pick_group(Hkv * hd)
    ppr = Hkv * hd // g
    R = ps * ppr
    P = 1 + B * W
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, W), np.int32)
    n = 0
    for b, ln in enumerate(lens):
        if ln >= 0:
            k = min(ln // ps + 1, W)
            pt[b, :k] = perm[n:n + k]
            n += k

    def triple():
        return (rng.integers(0, 256, (P, R, g // 2)).astype(np.uint8),
                (rng.random((P, R, 1)) * 0.3).astype(np.float32),
                rng.standard_normal((P, R, 1)).astype(np.float32))

    k = (rng.standard_normal((B, 1, Hkv, hd)) * 2).astype(np.float32)
    v = (rng.standard_normal((B, 1, Hkv, hd)) * 2).astype(np.float32)
    lengths = np.maximum(np.asarray(lens, np.int32), 0)
    return k, v, triple(), triple(), pt, lengths


def _append_reference(k, v, kpages, vpages, pt, lengths, ps, dtype):
    """The reference's append in numpy: ``repro.kernels.ref.kv_quant_ref``
    on each slot's groups, scattered as ``repro.models.paged``'s decode
    step does (tail page clamped into the table and at 0)."""
    B, W = pt.shape
    g = kpages[0].shape[-1] * 2
    ppr = k[0].size // g
    pos0 = lengths.astype(np.int64)
    tail_pi = np.minimum(pos0 // ps, W - 1)
    tail_page = np.maximum(
        np.take_along_axis(pt, tail_pi[:, None], axis=1)[:, 0], 0)
    rows = (pos0 % ps)[:, None] * ppr + np.arange(ppr)[None]
    out = []
    for val, pages in ((k, kpages), (v, vpages)):
        pages = [a.copy() for a in pages]
        xj, _ = _both(val.reshape(B * ppr, g), dtype)
        for buf, t in zip(pages, j_ref.kv_quant_ref(xj)):
            buf[tail_page[:, None], rows] = np.asarray(t).reshape(B, ppr, -1)
        out.append(pages)
    return out


@pytest.mark.parametrize("B,Hkv,hd,ps,W,lens", APPEND_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_append_ref_matches_reference_append(B, Hkv, hd, ps, W, lens,
                                                      dtype):
    """``ops.kv_quant_append`` on CPU tensors runs the plain version
    (uncounted), which writes the bytes the reference's append writes on
    every page but the trash page (inactive slots' writes race there)."""
    k, v, kp, vp, pt, lengths = _append_inputs(B, Hkv, hd, ps, W, lens,
                                               seed=B + hd)
    want_k, want_v = _append_reference(k, v, kp, vp, pt, lengths, ps, dtype)
    _, kt = _both(k, dtype)
    _, vt = _both(v, dtype)
    got_k = tuple(torch.from_numpy(a.copy()) for a in kp)
    got_v = tuple(torch.from_numpy(a.copy()) for a in vp)
    before = t_ops.launch_counts()
    t_ops.kv_quant_append(kt, vt, got_k, got_v, torch.from_numpy(pt),
                          torch.from_numpy(lengths), page_size=ps)
    assert t_ops.launch_counts() == before
    for got, want in ((got_k, want_k), (got_v, want_v)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[1:].numpy(), b[1:])
    # the append changed no more than the active slots' rows on pages 1+
    ppr = Hkv * hd // j_layout.pick_group(Hkv * hd)
    changed = (got_k[0][1:].numpy() != kp[0][1:]).any(axis=-1).sum()
    assert 0 < changed <= sum(ln >= 0 for ln in lens) * ppr


def test_kv_quant_append_refuses_cpu_and_unknown_devices():
    """The append's wrapper takes CUDA tensors only; ``ops`` sends CPU
    tensors to the plain version, counts meta ones (and refuses them
    outside an op counter: ``roofline/op_cost.py``) and refuses any other
    device."""
    k, v, kp, vp, pt, lengths = _append_inputs(2, 2, 8, 4, 2, [3, 5],
                                               seed=1)
    args = (torch.from_numpy(k), torch.from_numpy(v),
            tuple(map(torch.from_numpy, kp)),
            tuple(map(torch.from_numpy, vp)), torch.from_numpy(pt),
            torch.from_numpy(lengths))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kq.kv_quant_append(*args, page_size=4)
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor)
                 else tuple(t.to("meta") for t in a) for a in args)
    with pytest.raises(RuntimeError, match="outside an op counter"):
        t_ops.kv_quant_append(*meta, page_size=4)
    with pytest.raises(ValueError, match="no kernel for device"):
        t_ops.kv_quant_append(_on_device("xpu", args[0]), *args[1:],
                              page_size=4)


def _on_device(kind, t):
    """A stand-in for ``t`` on a device the port has no kernel for (no
    such tensor can be made here): its shape, a device of ``kind``."""
    return types.SimpleNamespace(shape=tuple(t.shape),
                                 device=torch.device(kind))


@pytest.mark.parametrize("G,offset,want", [
    (128, 0, "vector"), (8, 0, "vector"), (256, 0, "vector"),
    (24, 0, "vector"), (4, 0, "scalar"), (2, 0, "scalar"),
    (264, 0, "scalar"), (128, 1, "scalar"), (128, 4, "scalar"),
    (128, 8, "vector"), (1032, 0, "scalar")])
def test_kv_quant_bodies_follow_shape_and_alignment(G, offset, want):
    """The wrapper picks the body from the shape and the address alone
    (bf16 rows here; ``offset`` elements into a fresh buffer): the vector
    body takes rows of G % 8 == 0 up to 256 from a 16-byte aligned
    address; the packed bytes' body wants G % 8 == 0 up to 1024 and 4-byte
    alignment."""
    N = 3
    buf = torch.zeros(N * G + offset, dtype=torch.bfloat16)
    x = buf[offset:].view(N, G)
    assert buf.data_ptr() % 64 == 0
    assert t_kq.quant_body(x) == want
    pbuf = torch.zeros(N * G // 2 + offset, dtype=torch.uint8)
    packed = pbuf[offset:].view(N, G // 2)
    vector = G % 8 == 0 and G <= 1024 and offset % 4 == 0
    assert t_kq.dequant_body(packed) == ("vector" if vector else "scalar")


# -- the wrappers take CUDA tensors only ----------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never turns into its plain version: only
    ``ops`` dispatches, and only on the tensor's device."""
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kq.kv_quant(x)
    p, s, z = t_ref.kv_quant_ref(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kq.kv_dequant(p, s, z)
    q, kp, vp, pt, kl = _paged_inputs(1, 2, 1, 16, 8, [3], seed=0)
    tt = lambda tr: tuple(torch.from_numpy(a) for a in tr)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pa.paged_decode_attention_int4(
            torch.from_numpy(q), tt(kp), tt(vp), torch.from_numpy(pt),
            torch.from_numpy(kl), page_size=8)
    qa = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention(qa, qa, qa)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rn.rmsnorm(x, torch.zeros((64,)))
    before = t_ops.launch_counts()
    t_ops.kv_quant(x)
    t_ops.kv_dequant(p, s, z)
    t_ops.flash_attention(qa, qa, qa)
    t_ops.rmsnorm(x, torch.zeros((64,)))
    assert t_ops.launch_counts() == before, \
        "plain CPU runs must not count as launches"


def test_decode_wrappers_refuse_cpu_tensors():
    """The dense decode kernel and the bf16 paged body take CUDA tensors
    only; on the CPU ``ops`` runs their plain versions uncounted."""
    q = torch.zeros((2, 2, 1, 16))
    kv = torch.zeros((2, 2, 8, 16))
    kl = torch.tensor([3, 8], dtype=torch.int32)
    pages = torch.zeros((3, 8, 2, 16), dtype=torch.bfloat16)
    pt = torch.tensor([[1], [2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_da.decode_attention(q, kv, kv, kl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pa.paged_decode_attention_bf16(q, pages, pages, pt, kl,
                                         page_size=8)
    before = t_ops.launch_counts()
    t_ops.decode_attention(q, kv, kv, kl)
    t_ops.paged_decode_attention(q, pages, pages, pt, kl, page_size=8)
    assert t_ops.launch_counts() == before


def test_ops_refuse_unknown_device():
    with pytest.raises(ValueError, match="no kernel for device"):
        t_ops.kv_quant(_on_device("xpu", torch.zeros((4, 64))))
    # meta is counted by an op counter, and refused outside one
    with pytest.raises(RuntimeError, match="outside an op counter"):
        t_ops.kv_quant(torch.zeros((4, 64), device="meta"))


# -- flash attention ------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, H, Hkv, hd, causal, window)
    (2, 16, 4, 4, 16, True, 0),
    (1, 64, 8, 2, 32, True, 0),          # GQA
    (2, 32, 4, 1, 16, True, 8),          # MQA, sliding window
    (1, 48, 6, 3, 16, False, 0),         # not causal
    (1, 128, 2, 2, 16, True, 33),        # window across several blocks
    (1, 32, 2, 2, 80, True, 0),          # stablelm-3b's head dim
    (1, 32, 2, 2, 120, True, 9),         # h2o-danube-3-4b's, a window
    (1, 32, 2, 2, 256, True, 0),         # gemma-2b's
]


def _to_bh(a):
    """(B, S, H, hd) -> the Pallas kernel's (B*H, S, hd)."""
    B, S, H, hd = a.shape
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                       .reshape(B * H, S, hd))


def _from_bh(a, B, H):
    a = np.asarray(a, np.float32)
    return a.reshape(B, H, a.shape[1], a.shape[2]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_flash_attention_ref_vs_jax(B, S, H, Hkv, hd, causal, window,
                                    against):
    rng = np.random.default_rng(B * 100 + S + H + hd)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    got = t_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    if against == "ref":
        want = j_ref.flash_attention_ref(_to_bh(q), _to_bh(k), _to_bh(v),
                                         causal=causal, window=window)
    else:
        want = j_ops.flash_attention(_to_bh(q), _to_bh(k), _to_bh(v),
                                     causal=causal, window=window,
                                     backend="interpret", block_q=16,
                                     block_k=16)
    np.testing.assert_allclose(_from_bh(want, B, H), got.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture
def process_state(request):
    """What this process was left with when the test starts, for the
    failure message of a test whose error has once gone past its
    tolerance on a parallel run and not again: the f32 matmul precision,
    the thread count, the oneDNN and determinism switches, whether
    denormals flush to zero, the xdist worker and the test files it ran
    before this one (from the worker's terminal reporter). Nothing is
    set."""
    tiny = torch.tensor([1e-40], dtype=torch.float32)
    reporter = request.config.pluginmanager.getplugin("terminalreporter")
    here = request.node.nodeid.split("::")[0]
    earlier = [] if reporter is None else sorted(
        {r.nodeid.split("::")[0] for reports in reporter.stats.values()
         for r in reports if getattr(r, "nodeid", "")} - {here})
    return (f"f32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}, "
            f"{torch.get_num_threads()} threads "
            f"({torch.get_num_interop_threads()} inter-op), mkldnn "
            f"{torch.backends.mkldnn.enabled}, deterministic "
            f"{torch.are_deterministic_algorithms_enabled()}, denormals "
            f"flushed {bool((tiny * 1.0 == 0).item())}, worker "
            f"{os.environ.get('PYTEST_XDIST_WORKER', 'none')}, earlier "
            f"files in this process {earlier}")


def test_flash_attention_blocked_plain_path_matches_materialized(
        process_state):
    """Above 256 x 256 the plain version takes the online softmax over key
    chunks (the reference's blocked jnp path): same result to f32
    rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 300, 2, 16)).astype(np.float32)) for _ in range(3))
    for window in (0, 70):
        blocked = t_ops.flash_attention(q, k, v, window=window)
        full = t_ref._attention_materialized(q, k, v, causal=True,
                                             window=window)
        torch.testing.assert_close(
            blocked, full, atol=1e-5, rtol=1e-5,
            msg=lambda m: f"{m}\nwindow {window}; {process_state}")


def _old_suffix_attention(q, K, V, prefix_len):
    """``models/transformer.py: _suffix_attention`` as the port had it
    before the flash kernel replaced it."""
    import math
    B, S, H, hd = q.shape
    Sk, Hk = K.shape[1], K.shape[2]
    P = Sk - S
    qh = q.reshape(B, S, Hk, H // Hk, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), K.float()) \
        / math.sqrt(hd)
    j = torch.arange(Sk)[None, None, :]
    i = torch.arange(S)[None, :, None]
    ok = torch.where(j < P, j < prefix_len[:, None, None], (j - P) <= i)
    s = s + torch.where(ok, torch.zeros(()), -1e30)[:, None, None]
    w = torch.softmax(s, dim=-1).to(V.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), V.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


@pytest.mark.parametrize("B,S,P,H,Hkv,hd,plen", [
    (3, 8, 16, 4, 2, 16, [16, 5, 0]),     # ragged, one dummy row
    (2, 16, 32, 2, 2, 32, [32, 17]),
    (1, 4, 8, 8, 1, 16, [8]),
])
def test_flash_attention_suffix_mask_is_the_old_formula(B, S, P, H, Hkv, hd,
                                                        plen):
    rng = np.random.default_rng(B + S + P)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd))
                         .astype(np.float32))
    K = torch.from_numpy(rng.standard_normal((B, P + S, Hkv, hd))
                         .astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((B, P + S, Hkv, hd))
                         .astype(np.float32))
    pl = torch.tensor(plen, dtype=torch.int32)
    got = t_ops.flash_attention(q, K, V, prefix_len=pl)
    assert torch.equal(got, _old_suffix_attention(q, K, V, pl))
    assert bool(torch.isfinite(got).all())
    # with an empty prefix the suffix mask is plain causal attention
    z = t_ops.flash_attention(q, K[:, P:], V[:, P:],
                              prefix_len=torch.zeros((B,), dtype=torch.int32))
    torch.testing.assert_close(z, t_ops.flash_attention(q, K[:, P:],
                                                        V[:, P:]),
                               atol=1e-6, rtol=1e-6)


def test_flash_attention_suffix_refuses_a_window():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="no window"):
        t_ops.flash_attention(q, torch.cat([q, q], 1), torch.cat([q, q], 1),
                              window=2,
                              prefix_len=torch.zeros((1,), dtype=torch.int32))


# -- rmsnorm ------------------------------------------------------------------------------


@pytest.mark.parametrize("N,d", [(1, 8), (7, 64), (256, 96), (512, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_rmsnorm_ref_vs_jax(N, d, dtype, against):
    rng = np.random.default_rng(N * d)
    x = (rng.standard_normal((N, d)) * 2).astype(np.float32)
    scale = (rng.standard_normal((d,)) * 0.1).astype(np.float32)
    xj, xt = _both(x, dtype)
    got = t_ops.rmsnorm(xt, torch.from_numpy(scale))
    assert got.dtype == xt.dtype
    if against == "ref":
        want = j_ref.rmsnorm_ref(xj, jnp.asarray(scale))
    else:
        want = j_ops.rmsnorm(xj, jnp.asarray(scale), backend="interpret",
                             block_n=min(N, 256))
    # f32: the same arithmetic, summed in another order; bf16: the f32
    # results round to the same bf16 value or to a neighbour (one ulp)
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(want), _np(got), rtol=rtol, atol=1e-6)


# -- add_rmsnorm: the residual add fused with the norm after it ------------------------


@pytest.mark.parametrize("N,d", [(1, 8), (7, 64), (256, 96), (3, 6656)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("against", ["ref", "interpret"])
def test_add_rmsnorm_ref_vs_jax(N, d, dtype, against):
    """``add_rmsnorm_ref`` against the JAX package's ``x + r`` followed by
    its rmsnorm (plain or the Pallas kernel interpreted): h exactly (both
    add in f32 and round once to the working type), y as
    ``test_rmsnorm_ref_vs_jax`` holds the norm alone."""
    rng = np.random.default_rng(N * d + 1)
    x = (rng.standard_normal((N, d)) * 2).astype(np.float32)
    r = (rng.standard_normal((N, d)) * 2).astype(np.float32)
    scale = (rng.standard_normal((d,)) * 0.1).astype(np.float32)
    (xj, xt), (rj, rt) = _both(x, dtype), _both(r, dtype)
    h, y = t_ops.add_rmsnorm(xt, rt, torch.from_numpy(scale))
    assert h.dtype == y.dtype == xt.dtype
    hj = xj + rj
    if against == "ref":
        want = j_ref.rmsnorm_ref(hj, jnp.asarray(scale))
    else:
        want = j_ops.rmsnorm(hj, jnp.asarray(scale), backend="interpret",
                             block_n=min(N, 256))
    np.testing.assert_array_equal(_np(hj), _np(h))
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(want), _np(y), rtol=rtol, atol=1e-6)


def test_add_rmsnorm_on_cpu_is_the_plain_version():
    """On a CPU tensor ``ops.add_rmsnorm`` is ``x + r`` then
    ``rmsnorm_ref``, bit for bit, and counts no launch; the kernel wrapper
    refuses CPU tensors."""
    rng = np.random.default_rng(3)
    x, r = (torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    scale = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = t_ops.launch_counts()
    h, y = t_ops.add_rmsnorm(x, r, scale)
    assert t_ops.launch_counts() == before
    assert torch.equal(h, x + r)
    assert torch.equal(y, t_ref.rmsnorm_ref(x + r, scale))
    assert "add_rmsnorm" in t_ops.KERNELS
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rn.add_rmsnorm(x, r, scale)


def test_norm_plan_reads_only_the_row_width():
    """The launch configuration fixes a row's summation order, so it is a
    function of d and the body alone (a row normed in a 4-row launch has
    the bytes it has in a 1024-row one); it covers the row with whole
    warps, at most 512 threads, and refuses rows past the registers."""
    import inspect
    assert list(inspect.signature(t_rn.norm_plan).parameters) == ["d", "vec"]
    assert t_rn.norm_plan(6656, 8) == (2, 416)      # LLaMA-30B, bf16
    assert t_rn.norm_plan(6656, 4) == (4, 416)      # f32
    assert t_rn.norm_plan(1, 1) == (1, 32)
    for d in (1, 2, 63, 64, 65, 1000, 6656, 6657, 16384):
        for vec in (1, 4, 8):
            if vec > 1 and d % vec:
                continue
            vpt, threads = t_rn.norm_plan(d, vec)
            assert threads % 32 == 0 and 32 <= threads <= t_rn.MAX_THREADS
            assert vpt * vec <= t_rn.ELEMS_PER_THREAD
            assert vpt * vec * threads >= d
            assert vpt == 1 or -(-d // vec) > (vpt // 2) * t_rn.MAX_THREADS
    with pytest.raises(ValueError, match="registers"):
        t_rn.norm_plan(t_rn.MAX_D + 8, 8)


def test_vector_width_follows_row_width_and_alignment():
    x = torch.zeros((4, 6656), dtype=torch.bfloat16)
    assert t_rn.vector_width(6656, 2, x) == 8
    assert t_rn.vector_width(6656, 4, x.float()) == 4
    assert t_rn.vector_width(6657, 2, x) == 1       # rows off the grain
    assert t_rn.vector_width(6655, 2, x[:, 1:]) == 1


# -- the bf16 decode body's split plan (dense strides and bf16 pages) ----------------


@pytest.mark.parametrize("S,W,ps", [(256, 16, 16), (40, 5, 8), (1, 1, 1),
                                    (65, 3, 32), (512, 4, 128), (70, 17, 5),
                                    (64, 64, 1)])
def test_decode_split_plan_covers_every_key_once(S, W, ps):
    """For a dense view of S keys (pages of one key) and for W pages of ps
    keys: the splits tile the keys, none empty, and for every kv_len the
    splits the kernel keeps (those starting below kv_len, and split 0 for
    kv_len 0) hold exactly the keys it must read, min(kv_len, max) of
    them."""
    for max_len, (n_pages, size) in ((S, (S, 1)), (W * ps, (W, ps))):
        grid, split_len, n_part, n_count = t_da.launch_shape(
            4, 3, 2, 64, n_pages, size)
        n_split = grid[0]
        spans = [range(s * split_len, min((s + 1) * split_len, max_len))
                 for s in range(n_split)]
        assert all(len(r) > 0 for r in spans)
        assert [t for r in spans for t in r] == list(range(max_len))
        assert split_len == max(1, t_da.SPLIT_TOKENS // size) * size
        assert grid == (n_split, 4 * 3, 2) and n_count == 4 * 3 * 2
        assert n_part == 4 * 3 * 2 * n_split * (64 + 2)
        for kv_len in range(max_len + 5):
            n = min(kv_len, max_len)
            live = [r for s, r in enumerate(spans)
                    if s * split_len < n or s == 0]
            assert [t for r in live for t in r if t < n] == list(range(n))
            assert len(live) == max(1, -(-n // split_len))


def test_decode_launch_shape_reads_only_host_shapes():
    """The dense and bf16-page launches of the main path's decode step (4
    slots, 52 KV heads, 256 keys: dense S = 256 or W = 16 pages of 16)
    have the same grid, 4 splits of 64 keys, from shapes alone."""
    import inspect
    assert "kv_len" not in inspect.signature(t_da.launch_shape).parameters
    dense = t_da.launch_shape(4, 52, 1, 128, 256)
    paged = t_da.launch_shape(4, 52, 1, 128, 16, 16)
    assert dense == paged == ((4, 4 * 52, 1), 64, 4 * 52 * 4 * 130, 4 * 52)
    assert t_pa.split_plan is t_da.split_plan
    assert t_pa._counters is t_da._counters
