"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the ``cuda`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: ``kv_quant``/``kv_dequant`` must agree bit for bit (the wire,
the pages and the decode append share one encoding); paged attention (both
residencies), dense decode attention and flash attention sum in another
order than the plain versions (flash attention's f32 body keeps
probabilities in f32 where the plain version rounds them to bf16; its bf16
body rounds them to bf16 before P.V as the plain version does, but before
normalising), so they are held to 1e-5 when q is f32 (K/V f32 or bf16:
the plain version reads the same bf16 values) and to 2e-2 (a few bf16
ulps at |out| <= 4) when q is bf16. RMSNorm sums its row in another order:
1e-5 relative in f32, one bf16 ulp (2**-7 relative) in bf16; the residual
add fused in front of it (``add_rmsnorm``) must give PyTorch's ``x + r``
byte for byte.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _at_offset(t, offset):
    """A copy of ``t`` starting ``offset`` elements into a fresh buffer
    (offset 1 is off the vector bodies' grain: the scalar bodies run)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("N", [1, 17, 300, 100_003])
@pytest.mark.parametrize("G", [2, 4, 8, 16, 64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("offset", [0, 1])
def test_kv_quant_kernel_bit_exact(cuda, N, G, dtype, offset):
    """Both bodies of kv_quant and of kv_dequant, bit for bit: aligned
    operands take the vector bodies where the shape allows (G % 8 == 0),
    operands one element off the grain the scalar ones."""
    dt = getattr(torch, dtype)
    x = _at_offset((torch.randn((N, G), generator=_gen(N + G), device=cuda)
                    * 3).to(dt), offset)
    body = "vector" if offset == 0 and G % 8 == 0 else "scalar"
    assert kq.quant_body(x) == body
    before = kq.kv_quant.launches
    got = kq.kv_quant(x)
    want = ref.kv_quant_ref(x)
    torch.cuda.synchronize()
    assert kq.kv_quant.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    packed = _at_offset(got[0], offset)
    assert kq.dequant_body(packed) == body
    for out_dt in (torch.bfloat16, torch.float32):
        back = kq.kv_dequant(packed, *got[1:], out_dtype=out_dt)
        assert torch.equal(back, ref.kv_dequant_ref(*want, dtype=out_dt))


@pytest.mark.parametrize("offset", [0, 1])
def test_kv_quant_constant_rows(cuda, offset):
    """max == min: the 1e-8 floor on the scale, every nibble 0."""
    x = _at_offset(torch.full((5, 64), 2.5, device=cuda), offset)
    for a, b in zip(kq.kv_quant(x), ref.kv_quant_ref(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("offset", [0, 1])
def test_kv_quant_rounds_ties_to_even(cuda, dtype, offset):
    """Rows whose quotients land exactly on half-integers (min 0, max 15:
    scale 1) and a hair either side of them: rint's half-to-even and the
    true division decide every nibble, as in the plain version (these are
    the quotients where the vector body's reciprocal product falls back to
    the true division)."""
    half = torch.arange(15, dtype=torch.float32, device=cuda) + 0.5
    ends = torch.tensor([0.0, 15.0], device=cuda)
    rows = []
    for scale in (1.0, 0.1, 3.0, 1e-3):
        for nudge in (0.0, 2.0 ** -20, -2.0 ** -20):
            mid = (half + nudge) * scale
            rows.append(torch.cat([ends * scale, mid, mid]).repeat(4))
    x = _at_offset(torch.stack(rows).to(getattr(torch, dtype)), offset)
    got = kq.kv_quant(x)
    for a, b in zip(got, ref.kv_quant_ref(x)):
        assert torch.equal(a, b)
    # row 0, elements 2 and 3: 0.5 -> 0 and 1.5 -> 2 (ties to even)
    assert int(got[0][0, 1]) == 0x20


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_vector_body_near_half_integers(cuda, dtype):
    """Rows over 40 binades of scale and offset whose quotients sit within
    a few ulp of half-integers, on both sides, and some a little further
    out: the vector body's reciprocal product, with its fallback to the
    true division, gives the plain version's bytes (and so does the
    scalar body)."""
    N, G = 4096, 128
    gen = _gen(17)
    scale = torch.exp2(torch.rand((N, 1), generator=gen, device=cuda) * 40
                       - 20)
    mn = torch.randn((N, 1), generator=gen, device=cuda) * scale * 4
    k = torch.randint(0, 15, (N, G), generator=gen, device=cuda).float()
    wiggle = torch.randint(-64, 65, (N, G), generator=gen, device=cuda)
    q = k + 0.5 + wiggle.float() * 2.0 ** -22
    q[:, 0], q[:, 1] = 0.0, 15.0
    x = (mn + q * scale).to(getattr(torch, dtype))
    want = ref.kv_quant_ref(x)
    assert kq.quant_body(x) == "vector"
    for offset in (0, 1):
        for a, b in zip(kq.kv_quant(_at_offset(x, offset)), want):
            assert torch.equal(a, b)


def test_kv_quant_misaligned_views(cuda):
    """Views off one body's grain: x 8 bytes off the 16-byte grain takes
    the scalar quant body; a row slice of one packed tensor (as
    ``_dequantize`` passes) keeps the vector dequant body however its scale
    and zero are aligned. Both stay exact."""
    N, G = 300, 128
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((N, G), generator=_gen(3), device=cuda).to(dt)
        x = _at_offset(x, 8 // x.element_size())
        assert kq.quant_body(x) == "scalar"
        got, want = kq.kv_quant(x), ref.kv_quant_ref(x)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        p, sc, z = (t[3:] for t in got)    # scale/zero 12 bytes in
        assert kq.dequant_body(p) == "vector" and sc.data_ptr() % 16
        assert torch.equal(kq.kv_dequant(p, sc, z, out_dtype=dt),
                           ref.kv_dequant_ref(p, sc, z, dtype=dt))


def _random_pages(B, Hkv, gq, hd, ps, W, kv_len, dtype, seed):
    g = next(c for c in (128, 64, 32, 16, 8, 4, 2) if (Hkv * hd) % c == 0)
    ppr = Hkv * hd // g
    R = ps * ppr
    need = sum(min(-(-l // ps), W) for l in kv_len)
    P = 1 + need + 3
    gen = _gen(seed)

    def triple():
        packed = torch.randint(0, 256, (P, R, g // 2), generator=gen,
                               device="cuda", dtype=torch.uint8)
        scale = torch.rand((P, R, 1), generator=gen, device="cuda") * 0.3
        zero = torch.randn((P, R, 1), generator=gen, device="cuda")
        return packed, scale, zero

    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1)[:need] + 1
    n = 0
    for b, l in enumerate(kv_len):
        k = min(-(-l // ps), W)          # keys past W * ps do not exist
        pt[b, :k] = perm[n:n + k]
        n += k
    q = torch.randn((B, Hkv, gq, hd), generator=gen, device="cuda").to(dtype)
    return (q, triple(), triple(), pt.cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


# 96 slots, 12 of them live (1,000-3,000 tokens), the others at kv_len 0
CELL_LENS = [0] * 96
for _i, _n in enumerate((1000, 1234, 1500, 1777, 2000, 2048, 2049, 2222,
                         2500, 2750, 2999, 3000)):
    CELL_LENS[7 * _i + 3] = _n


def _spread(B, hi, empty=2):
    """B lengths spread evenly over 1..hi, the first ``empty`` at 0."""
    n = B - empty
    return [0] * empty + [1 + (hi - 1) * i // (n - 1) for i in range(n)]


# more live items than the int4 kernel's grid (4 waves of the CTAs the
# card keeps resident): each CTA strides over several
PAGED_OVER_CASES = [
    (32, 52, 1, 128, 16, 64, _spread(32, 1024)),   # LLaMA-30B's one row
    (64, 32, 1, 80, 16, 32, _spread(64, 512)),     # stablelm-3b, hd 80
    (1024, 1, 8, 256, 16, 32, _spread(1024, 512)),  # gemma-2b, hd 256
    (128, 8, 5, 128, 16, 32, _spread(128, 512)),   # llama4-maverick, gq 5
]

PAGED_CASES = [
    # (B, Hkv, gq, hd, ps, W, kv_len)
    (4, 52, 1, 128, 16, 16, [256, 1, 100, 17]),   # LLaMA-30B width, g = hd
    (3, 2, 4, 32, 8, 4, [5, 16, 23]),             # GQA, g = 64 spans 2 heads
    (2, 4, 1, 16, 16, 5, [70, 3]),                # reduced config, trash tail
    # the split plan's 64-key splits (16-token pages): kv_len on a split
    # boundary, one past it, 1, and past W x page_size
    (4, 8, 1, 128, 16, 16, [64, 65, 1, 300]),
    (4, 3, 4, 64, 16, 16, [128, 129, 1, 256]),    # GQA over several splits
    (2, 4, 2, 32, 8, 16, [64, 65]),               # g = 128 spans 4 heads
    (3, 8, 1, 80, 16, 8, [100, 1, 65]),   # g = 128 over heads of 80
    (2, 2, 4, 80, 8, 4, [5, 30]),         # 4 rows a CTA: 10 of 16 lanes
    (3, 1, 8, 256, 16, 16, [200, 1, 256]),  # gemma-2b: 2 row blocks of 4
    (2, 2, 1, 256, 16, 4, [64, 17]),
    # the MoE and VLM configs' decode step: qwen3-moe 16 query heads a KV
    # head (4 row blocks of 4), llama4-maverick 5 (2 blocks, 3 rows
    # padded), llava-next 4
    (4, 4, 16, 128, 16, 16, [232, 123, 56, 17]),
    (4, 8, 5, 128, 16, 16, [232, 123, 56, 17]),
    (3, 8, 4, 128, 16, 16, [200, 1, 65]),
    # the served cell's decode step (command-r-35b): 96 slots of 256
    # 16-token pages, 12 live at 1,000-3,000 tokens, the rest empty
    (96, 8, 8, 128, 16, 256, CELL_LENS),
] + PAGED_OVER_CASES


@pytest.mark.parametrize("B,Hkv,gq,hd,ps,W,lens", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_attention_kernel_matches_plain(cuda, B, Hkv, gq, hd, ps, W,
                                              lens, dtype):
    dt = getattr(torch, dtype)
    q, kpg, vpg, pt, kv_len = _random_pages(B, Hkv, gq, hd, ps, W, lens,
                                            dt, seed=B * 7 + hd)
    before = pa.paged_decode_attention_int4.launches
    got = ops.paged_decode_attention(q, kpg, vpg, pt, kv_len, page_size=ps)
    want = ref.paged_decode_attention_ref(q, kpg, vpg, pt, kv_len,
                                          page_size=ps)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_int4.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    live = kv_len > 0     # kv_len 0 gives 0 (the plain version: mean V)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_attention_slot_alone_and_in_a_batch(cuda, dtype):
    """A slot's output bytes depend on its own kv_len and pages alone: the
    same alone (the other 95 slots empty) as among 11 live ones, at the
    served cell's shape; the launch's CTAs come from shapes alone."""
    dt = getattr(torch, dtype)
    q, kpg, vpg, pt, kv_len = _random_pages(96, 8, 8, 128, 16, 256,
                                            CELL_LENS, dt, seed=31)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n0 = pa.paged_decode_attention_int4.ctas
    batch = pa.paged_decode_attention_int4(q, kpg, vpg, pt, kv_len,
                                           page_size=16)
    ctas = pa.paged_decode_attention_int4.ctas - n0
    assert 0 < ctas <= pa.WAVES * 16 * sms      # 16: 2,048 threads of 128
    for b in (3, 45, 80):
        alone = torch.zeros_like(kv_len)
        alone[b] = kv_len[b]
        n0 = pa.paged_decode_attention_int4.ctas
        out = pa.paged_decode_attention_int4(q, kpg, vpg, pt, alone,
                                             page_size=16)
        assert pa.paged_decode_attention_int4.ctas - n0 == ctas
        assert torch.equal(out[b], batch[b])
        assert not out[torch.arange(96, device=cuda) != b].any()


@pytest.mark.parametrize("B,Hkv,gq,hd,ps,W,lens", PAGED_OVER_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_attention_strides_over_more_items_than_ctas(cuda, B, Hkv, gq,
                                                           hd, ps, W, lens,
                                                           dtype):
    """Where the live items outnumber the grid's CTAs, each CTA takes
    several; a slot's output bytes still depend on its own kv_len alone:
    the even slots read the same with the odd ones emptied."""
    dt = getattr(torch, dtype)
    q, kpg, vpg, pt, kv_len = _random_pages(B, Hkv, gq, hd, ps, W, lens,
                                            dt, seed=B + hd)
    n_rb = -(-gq // pa.rows_per_cta(gq))
    items = sum(pa.int4_split(n, W, ps)[1] for n in lens) * Hkv * n_rb
    n0 = pa.paged_decode_attention_int4.ctas
    full = pa.paged_decode_attention_int4(q, kpg, vpg, pt, kv_len,
                                          page_size=ps)
    assert items > pa.paged_decode_attention_int4.ctas - n0
    even = kv_len.clone()
    even[1::2] = 0
    half = pa.paged_decode_attention_int4(q, kpg, vpg, pt, even,
                                          page_size=ps)
    assert torch.equal(half[0::2], full[0::2])
    assert not half[1::2].any()


def test_paged_int4_graph_replays_follow_kv_len_at_the_cell_shape(cuda):
    """The served cell's shape (command-r-35b: 96 slots, tables of 256
    16-token pages, 8 query heads a KV head), two layers' launches captured
    in one CUDA graph as a decode chunk holds them, replayed back to back
    while kv_len changes in place (12 live slots, 3, all 96, none): every
    replay equals the eager launches byte for byte, so the capture baked in
    no length and each launch leaves the merge counters at 0."""
    bf = torch.bfloat16
    full = [256 * 16] * 96
    layers = [_random_pages(96, 8, 8, 128, 16, 256, full, bf, seed=40 + i)
              for i in range(2)]
    kv_len = layers[0][4]
    few = [0] * 96
    few[3], few[50], few[95] = 1024, 1800, 3000

    def run():
        return [pa.paged_decode_attention_int4(q, kpg, vpg, pt, kv_len,
                                               page_size=16)
                for q, kpg, vpg, pt, _ in layers]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                   # build, counters, warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for lens in (CELL_LENS, few, _spread(96, 4096, empty=0), [0] * 96,
                 CELL_LENS):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        graph.replay()
        want = run()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)
        assert not outs[0][kv_len == 0].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_attention_slot_on_the_trash_page(cuda, dtype):
    """A slot whose whole page list is the trash page (entry 0) attends
    over the trash page's contents, as the plain version does."""
    dt = getattr(torch, dtype)
    q, kpg, vpg, pt, kv_len = _random_pages(3, 4, 1, 128, 16, 8,
                                            [40, 100, 77], dt, seed=11)
    pt[1] = 0
    got = ops.paged_decode_attention(q, kpg, vpg, pt, kv_len, page_size=16)
    want = ref.paged_decode_attention_ref(q, kpg, vpg, pt, kv_len,
                                          page_size=16)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_paged_attention_ignores_trash_page(cuda):
    """Poisoning the trash page and every page past kv_len changes
    nothing."""
    q, kpg, vpg, pt, kv_len = _random_pages(3, 2, 4, 32, 8, 4, [5, 16, 23],
                                            torch.float32, seed=3)
    a = ops.paged_decode_attention(q, kpg, vpg, pt, kv_len, page_size=8)
    kp, ks, kz = kpg
    kp2, ks2 = kp.clone(), ks.clone()
    kp2[0] = 255
    ks2[0] = 1e6
    b = ops.paged_decode_attention(q, (kp2, ks2, kz), vpg, pt, kv_len,
                                   page_size=8)
    assert torch.equal(a, b)
    assert math.isfinite(float(a.abs().max()))


# -- flash attention -------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, P, H, Hkv, hd, causal, window, prefix_len)
    (4, 256, 0, 52, 52, 128, True, 0, None),      # LLaMA-30B prefill bucket
    (2, 100, 0, 8, 2, 16, True, 0, None),         # GQA, ragged q tile
    (2, 130, 0, 8, 2, 16, True, 17, None),        # sliding window
    (1, 70, 0, 4, 4, 32, False, 0, None),         # not causal
    (3, 65, 0, 6, 3, 64, True, 40, None),
    (4, 128, 64, 52, 52, 128, True, 0, [64, 0, 13, 40]),  # suffix, ragged
    (2, 16, 32, 8, 2, 16, True, 0, [32, 5]),      # chunked-prefill tick
    # the tensor-core body's 64-row q tiles and 64-key tiles: Sq 1, one
    # short of a tile, one tile, one past, several; every head dim
    (2, 1, 0, 4, 2, 128, True, 0, None),
    (2, 63, 0, 4, 4, 64, True, 0, None),
    (2, 64, 0, 4, 2, 32, True, 0, None),
    (2, 65, 0, 4, 1, 16, True, 0, None),
    (2, 300, 0, 8, 2, 128, True, 0, None),
    (1, 300, 0, 4, 2, 64, False, 0, None),
    (2, 300, 0, 4, 4, 32, True, 100, None),       # window across tiles
    (3, 32, 224, 8, 4, 128, True, 0, [0, 100, 224]),  # chunked tick
    # the other dense configs' head dims: stablelm-3b 80 (MHA), h2o-danube
    # 120 (GQA, its 4096 window over S > 4096: the zero-padded
    # contraction), gemma-2b 256 (MQA: 32-key tiles, Q in shared memory)
    (2, 130, 0, 4, 4, 80, True, 0, None),
    (1, 64, 0, 2, 2, 80, False, 0, None),
    (2, 16, 32, 4, 4, 80, True, 0, [32, 5]),
    (2, 100, 0, 8, 2, 120, True, 0, None),
    (1, 4200, 0, 2, 1, 120, True, 4096, None),
    (2, 65, 0, 8, 1, 256, True, 0, None),
    (1, 300, 0, 2, 1, 256, True, 0, None),
    (2, 16, 32, 8, 1, 256, True, 0, [20, 32]),
    # the MoE and VLM configs: qwen3-moe's 64 heads over 4, llama4's 40
    # over 8 (a prompt and a suffix), llava-next's 616-token exact prompt
    # (576 patches + 40 text tokens) at 32 over 8
    (1, 256, 0, 64, 4, 128, True, 0, None),
    (2, 256, 0, 40, 8, 128, True, 0, None),
    (2, 32, 96, 40, 8, 128, True, 0, [96, 30]),
    (1, 616, 0, 32, 8, 128, True, 0, None),
]


@pytest.mark.parametrize("B,Sq,P,H,Hkv,hd,causal,window,plen", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, P, H, Hkv, hd,
                                              causal, window, plen, dtype):
    dt = getattr(torch, dtype)
    gen = _gen(B * 100 + Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=cuda).to(dt)
    k = torch.randn((B, P + Sq, Hkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn((B, P + Sq, Hkv, hd), generator=gen, device=cuda).to(dt)
    pl = None if plen is None else torch.tensor(plen, dtype=torch.int32,
                                                device=cuda)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              prefix_len=pl)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=pl)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("Sq,Sk,dtype", [(24, 24, "float32"),
                                         (9, 24, "float32"),
                                         (33, 70, "bfloat16"),
                                         (256, 1500, "bfloat16")])
def test_flash_attention_bidirectional_over_other_keys(cuda, Sq, Sk,
                                                       dtype):
    """Whisper's encoder and cross-attention: ``causal=False`` with Sk
    keys, Sk no multiple of the 64-key tile."""
    dt = getattr(torch, dtype)
    gen = _gen(Sq + Sk)
    q = torch.randn((2, Sq, 8, 64), generator=gen, device=cuda).to(dt)
    k = torch.randn((2, Sk, 8, 64), generator=gen, device=cuda).to(dt)
    v = torch.randn((2, Sk, 8, 64), generator=gen, device=cuda).to(dt)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_flash_attention_ignores_masked_prefix_keys(cuda):
    """Prefix keys at or past prefix_len (the bucket's right padding) and a
    dummy row's whole prefix are never read into the result."""
    gen = _gen(7)
    B, S, P, H, hd = 3, 20, 24, 4, 16
    q = torch.randn((B, S, H, hd), generator=gen, device=cuda)
    k = torch.randn((B, P + S, H, hd), generator=gen, device=cuda)
    v = torch.randn((B, P + S, H, hd), generator=gen, device=cuda)
    pl = torch.tensor([24, 9, 0], dtype=torch.int32, device=cuda)
    a = ops.flash_attention(q, k, v, prefix_len=pl)
    k2, v2 = k.clone(), v.clone()
    k2[1, 9:P] = 1e4
    v2[1, 9:P] = float("nan")
    k2[2, :P] = -1e4
    v2[2, :P] = float("inf")
    b = ops.flash_attention(q, k2, v2, prefix_len=pl)
    assert torch.equal(a, b)


def test_flash_attention_rejects_bad_operands(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="bad operands"):
        fa.flash_attention(q, q, q, window=4,
                           prefix_len=torch.zeros((1,), dtype=torch.int32,
                                                  device=cuda))


# -- rmsnorm -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1024, 6656), (4, 6656), (4, 1, 6656),
                                   (37, 6656), (3, 5, 64), (2, 1),
                                   # qwen3-moe's q norm: a bucket, a step
                                   (4, 256, 64, 128), (4, 1, 64, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    gen = _gen(sum(shape))
    x = (torch.randn(shape, generator=gen, device=cuda) * 2).to(dt)
    scale = torch.randn((shape[-1],), generator=gen, device=cuda) * 0.1
    before = rn.rmsnorm.launches
    got = ops.rmsnorm(x, scale)
    want = ref.rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert got.dtype == dt and got.shape == x.shape
    rtol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=rtol)


def test_norm_and_attention_launch_without_host_sync(cuda):
    """The decode chunk runs under sync_debug_mode("error"): the
    wrappers must read nothing back from the card."""
    x = torch.randn((4, 1, 6656), device=cuda, dtype=torch.bfloat16)
    scale = torch.zeros((6656,), device=cuda)
    q = torch.randn((4, 16, 4, 16), device=cuda)
    pl = torch.tensor([3, 0, 16, 7], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.rmsnorm(x, scale)
        ops.flash_attention(q, torch.cat([q, q], 1), torch.cat([q, q], 1),
                            prefix_len=pl)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()


# -- add_rmsnorm: the residual add fused with the norm ----------------------------


def _norm_inputs(shape, dt, seed, offset=0):
    gen = _gen(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dt)
    r = (torch.randn(shape, generator=gen, device="cuda") * 2).to(dt)
    scale = torch.randn((shape[-1],), generator=gen, device="cuda") * 0.1
    return _at_offset(x, offset), _at_offset(r, offset), scale


def _assert_norm_close(got, want):
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=rtol)


@pytest.mark.parametrize("shape", [(1024, 6656), (4, 1, 6656), (37, 6656),
                                   (3, 5, 64), (2, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("offset", [0, 1])
def test_add_rmsnorm_kernel_matches_plain(cuda, shape, dtype, offset):
    """h byte-identical to PyTorch's x + r, y within one ulp of the plain
    version; offset 1 puts every row off the 16-byte grain (the scalar
    body)."""
    dt = getattr(torch, dtype)
    x, r, scale = _norm_inputs(shape, dt, sum(shape) + offset, offset)
    before = rn.add_rmsnorm.launches
    h, y = ops.add_rmsnorm(x, r, scale)
    want_h, want_y = ref.add_rmsnorm_ref(x, r, scale)
    torch.cuda.synchronize()
    assert rn.add_rmsnorm.launches == before + 1
    assert h.dtype == y.dtype == dt and h.shape == y.shape == x.shape
    assert torch.equal(h, want_h)
    _assert_norm_close(y, want_y)
    if offset:
        assert rn.vector_width(shape[-1], x.element_size(), x, r) == 1


@pytest.mark.parametrize("d", [6656, 64, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_norm_rows_do_not_depend_on_the_row_count(cuda, d, dtype):
    """Rows normed in a 4-row launch have the bytes of the same rows in a
    1024-row launch, for rmsnorm and add_rmsnorm (chunked vs one-shot
    prefill and step vs step_reference are held bit for bit)."""
    x, r, scale = _norm_inputs((1024, d), getattr(torch, dtype), d)
    rows = [0, 17, 500, 1023]
    h_all, y_all = ops.add_rmsnorm(x, r, scale)
    h_few, y_few = ops.add_rmsnorm(x[rows].contiguous(),
                                   r[rows].contiguous(), scale)
    assert torch.equal(h_all[rows], h_few) and torch.equal(y_all[rows], y_few)
    assert torch.equal(ops.rmsnorm(x, scale)[rows],
                       ops.rmsnorm(x[rows].contiguous(), scale))


def test_add_rmsnorm_without_host_sync_and_in_a_graph(cuda):
    """The launch reads nothing back (the decode chunk's sync-debug guard),
    and a CUDA graph of it replays on new contents of its inputs."""
    x, r, scale = _norm_inputs((4, 1, 6656), torch.bfloat16, 7)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.add_rmsnorm(x, r, scale)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.add_rmsnorm(x, r, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h, y = ops.add_rmsnorm(x, r, scale)
    for seed in (8, 9):
        nx, nr, ns = _norm_inputs((4, 1, 6656), torch.bfloat16, seed)
        x.copy_(nx), r.copy_(nr), scale.copy_(ns)
        graph.replay()
        torch.cuda.synchronize()
        want_h, want_y = ref.add_rmsnorm_ref(nx, nr, ns)
        assert torch.equal(h, want_h)
        _assert_norm_close(y, want_y)


def test_add_rmsnorm_refuses_bad_operands(cuda):
    x = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="r like x"):
        rn.add_rmsnorm(x, x.to(torch.bfloat16), torch.zeros((64,),
                                                            device=cuda))
    with pytest.raises(ValueError, match="registers"):
        big = torch.zeros((1, rn.MAX_D + 8), device=cuda)
        rn.add_rmsnorm(big, big, torch.zeros((rn.MAX_D + 8,), device=cuda))


# -- dense decode attention and the bf16 paged body ------------------------------

DECODE_CASES = [
    # (B, Hkv, g, hd, S, kv_len)
    (4, 52, 1, 128, 256, [232, 123, 56, 17]),    # LLaMA-30B decode step
    (3, 2, 4, 16, 40, [1, 40, 23]),              # GQA, kv_len 1 and S
    (2, 4, 2, 64, 512, [300, 512]),              # two 256-key blocks
    (1, 3, 3, 32, 70, [69]),
    (4, 32, 1, 80, 256, [232, 123, 56, 17]),     # stablelm-3b: 10 lanes
    (3, 8, 4, 120, 300, [1, 300, 65]),           # h2o-danube-3-4b: 15
    (2, 1, 8, 256, 200, [64, 199]),              # gemma-2b: MQA
    (4, 4, 16, 128, 256, [232, 123, 56, 17]),    # qwen3-moe: 16 a KV head
    (4, 8, 5, 128, 256, [232, 123, 56, 17]),     # llama4-maverick: 5
    (2, 8, 4, 128, 640, [640, 617]),             # llava-next past 616
]
DTYPE_PAIRS = [("bfloat16", "bfloat16"), ("float32", "float32"),
               ("float32", "bfloat16")]          # (q, K/V)


def _decode_inputs(B, Hkv, g, hd, S, lens, qdt, kvdt, layout, seed):
    """q, K/V as (B, Hkv, S, hd) views (``layout`` "bhsd": contiguous, as
    the JAX signature; "cache": one layer of an (L, B, S, Hkv, hd) cache,
    permuted), the cache itself and kv_len."""
    gen = _gen(seed)
    q = torch.randn((B, Hkv, g, hd), generator=gen, device="cuda").to(qdt)
    if layout == "bhsd":
        cache = torch.randn((2, B, Hkv, S, hd), generator=gen,
                            device="cuda").to(kvdt)
        k, v = cache[0], cache[1]
    else:
        cache = torch.randn((2, 3, B, S, Hkv, hd), generator=gen,
                            device="cuda").to(kvdt)
        k, v = (cache[i, 1].permute(0, 2, 1, 3) for i in (0, 1))
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, cache


@pytest.mark.parametrize("B,Hkv,g,hd,S,lens", DECODE_CASES)
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
@pytest.mark.parametrize("layout", ["bhsd", "cache"])
def test_decode_attention_kernel_matches_plain(cuda, B, Hkv, g, hd, S, lens,
                                               qdt, kvdt, layout):
    q, k, v, kv_len, _ = _decode_inputs(
        B, Hkv, g, hd, S, lens, getattr(torch, qdt), getattr(torch, kvdt),
        layout, seed=B * 13 + hd + S)
    before = da.decode_attention.launches
    got = ops.decode_attention(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if qdt == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


LSE_CASES = [
    # (B, Hkv, g, hd, S, kv_len): a kv_seq rank's share of a cache
    (4, 52, 1, 128, 256, [256, 123, 56, 17]),    # LLaMA-30B, TP-2 rank 0
    (4, 52, 1, 128, 256, [104, 0, 0, 0]),        # rank 1: 3 slots hold none
    (4, 1, 8, 256, 256, [232, 123, 0, 17]),      # gemma-2b: MQA
    (3, 2, 4, 16, 40, [1, 0, 23]),
]


@pytest.mark.parametrize("B,Hkv,g,hd,S,lens", LSE_CASES)
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
def test_decode_attention_partial_mode_matches_plain(cuda, B, Hkv, g, hd, S,
                                                     lens, qdt, kvdt):
    """The partial mode (``return_lse``): ``o`` f32 whatever q's type (q
    read as it is), normalised over the call's keys, and each row's f32
    log-sum-exp, both within 1e-5 of the plain version (which reads the
    same q values in f32); a row with kv_len 0 gives o 0 and lse -inf."""
    q, k, v, kv_len, _ = _decode_inputs(
        B, Hkv, g, hd, S, lens, getattr(torch, qdt), getattr(torch, kvdt),
        "cache", seed=B * 7 + hd + sum(lens))
    before = da.decode_attention_lse.launches
    o, lse = ops.decode_attention(q, k, v, kv_len, return_lse=True)
    want_o, want_l = ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert da.decode_attention_lse.launches == before + 1
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=1e-5)
    fin = torch.isfinite(want_l)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], want_l[fin], atol=1e-5, rtol=1e-5)
    empty = kv_len == 0
    assert bool((lse[empty] == float("-inf")).all())
    assert bool((o[empty] == 0).all())


def test_decode_attention_reads_the_cache_in_place(cuda, monkeypatch):
    """The kernel gets the cache's own addresses: no copy of K/V."""
    q, k, v, kv_len, cache = _decode_inputs(4, 8, 1, 128, 64, [5, 64, 1, 30],
                                            torch.bfloat16, torch.bfloat16,
                                            "cache", seed=1)
    lib = build.library()
    seen = []

    class Spy:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                seen.append(args)
                return fn(*args)
            return call

    monkeypatch.setattr(build, "library", lambda: Spy())
    ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    (args,) = seen
    assert args[2] == cache[0, 1].data_ptr() == k.data_ptr()
    assert args[3] == cache[1, 1].data_ptr() == v.data_ptr()


def test_decode_attention_never_reads_past_kv_len(cuda):
    """Keys at or past kv_len (poisoned with NaN/inf) change nothing, and
    kv_len 0 gives zeros, as the TPU kernel does."""
    q, k, v, kv_len, _ = _decode_inputs(3, 2, 4, 16, 40, [1, 40, 23],
                                        torch.float32, torch.float32,
                                        "cache", seed=2)
    a = ops.decode_attention(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 1:] = float("nan")
    v2[2, :, 23:] = float("inf")
    assert torch.equal(a, ops.decode_attention(q, k2, v2, kv_len))
    zero = ops.decode_attention(q, k, v, torch.zeros_like(kv_len))
    assert torch.equal(zero, torch.zeros_like(zero))


def test_decode_attention_refuses_a_copy(cuda):
    q, k, v, kv_len, _ = _decode_inputs(2, 2, 1, 16, 8, [3, 8],
                                        torch.float32, torch.float32,
                                        "bhsd", seed=3)
    with pytest.raises(ValueError, match="no copy"):
        da.decode_attention(q, k.transpose(2, 3), v.transpose(2, 3),
                            kv_len)
    shifted = torch.as_strided(k, k.shape, k.stride(),
                               k.storage_offset() + 1)   # misaligned rows
    with pytest.raises(ValueError, match="no copy"):
        da.decode_attention(q, shifted, shifted, kv_len)


def _bf16_pages(B, Hkv, gq, hd, ps, W, lens, qdt, seed):
    """Random bf16 pages and a shuffled table (at most W pages a row; the
    rest of a row is the trash page 0), q and kv_len."""
    n_pages = [min(-(-ln // ps), W) for ln in lens]
    need = sum(n_pages)
    P = 1 + need + 3
    gen = _gen(seed)
    kp = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    vp = torch.randn((P, ps, Hkv, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed))[:need] + 1
    n = 0
    for b, k in enumerate(n_pages):
        pt[b, :k] = perm[n:n + k]
        n += k
    q = torch.randn((B, Hkv, gq, hd), generator=gen, device="cuda").to(qdt)
    return (q, kp, vp, pt.cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


BF16_PAGED_CASES = [
    # (B, Hkv, gq, hd, ps, W, kv_len)
    (4, 52, 1, 128, 16, 16, [232, 123, 56, 17]),  # LLaMA-30B decode step
    (3, 2, 4, 32, 8, 4, [5, 16, 23]),             # GQA
    (2, 4, 1, 16, 16, 5, [70, 3]),                # reduced config
    (2, 4, 1, 16, 8, 2, [40, 9]),                 # kv_len past W * ps
    (3, 8, 1, 80, 16, 8, [100, 1, 65]),           # stablelm-3b's hd
    (2, 2, 4, 120, 8, 8, [5, 60]),                # h2o-danube-3-4b's
    (3, 1, 8, 256, 16, 16, [200, 1, 256]),        # gemma-2b's
    (4, 4, 16, 128, 16, 16, [232, 123, 56, 17]),  # qwen3-moe's gq 16
    (4, 8, 5, 128, 16, 16, [232, 123, 56, 17]),   # llama4-maverick's gq 5
]


@pytest.mark.parametrize("B,Hkv,gq,hd,ps,W,lens", BF16_PAGED_CASES)
@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
def test_paged_bf16_kernel_matches_plain(cuda, B, Hkv, gq, hd, ps, W, lens,
                                         qdt):
    q, kp, vp, pt, kv_len = _bf16_pages(B, Hkv, gq, hd, ps, W, lens,
                                        getattr(torch, qdt), seed=B + hd)
    before = pa.paged_decode_attention_bf16.launches
    got = ops.paged_decode_attention(q, kp, vp, pt, kv_len, page_size=ps)
    want = ref.paged_decode_attention_ref(q, kp, vp, pt, kv_len,
                                          page_size=ps)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention_bf16.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if qdt == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_paged_bf16_ignores_trash_page(cuda):
    q, kp, vp, pt, kv_len = _bf16_pages(3, 2, 4, 32, 8, 4, [5, 16, 23],
                                        torch.float32, seed=4)
    a = ops.paged_decode_attention(q, kp, vp, pt, kv_len, page_size=8)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = float("nan")
    vp2[0] = float("inf")
    pt2 = pt.clone()
    pt2[pt2 == 0] = -3                            # clamped to the trash page
    b = ops.paged_decode_attention(q, kp2, vp2, pt2, kv_len, page_size=8)
    assert torch.equal(a, b)
    assert math.isfinite(float(a.abs().max()))


def test_decode_kernels_launch_without_host_sync(cuda):
    q, k, v, kv_len, _ = _decode_inputs(4, 8, 1, 128, 64, [5, 64, 1, 30],
                                        torch.bfloat16, torch.bfloat16,
                                        "cache", seed=5)
    pq, kp, vp, pt, pl = _bf16_pages(3, 2, 4, 32, 8, 4, [5, 16, 23],
                                     torch.bfloat16, seed=6)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.decode_attention(q, k, v, kv_len)
        ops.paged_decode_attention(pq, kp, vp, pt, pl, page_size=8)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()


# -- kv_quant_append: the paged decode step's append ---------------------------------


def _append_operands(B, Hkv, hd, ps, W, lens, dtype, seed, layout="bshd"):
    """Random int4 pages of K and V, a table giving each active slot the
    pages its next token needs (shuffled; -1 in ``lens`` = an inactive slot
    on the trash page), and this step's k/v (B, 1, Hkv, hd): contiguous
    (``"bshd"``) or the two halves of one (B, 1, 2*Hkv, hd) tensor
    (``"fused"``, strided views)."""
    gen = _gen(seed)
    g = next(c for c in (128, 64, 32, 16, 8) if (Hkv * hd) % c == 0)
    ppr = Hkv * hd // g
    R = ps * ppr
    P = 1 + B * W

    def triple():
        return (torch.randint(0, 256, (P, R, g // 2), generator=gen,
                              device="cuda", dtype=torch.uint8),
                torch.rand((P, R, 1), generator=gen, device="cuda"),
                torch.randn((P, R, 1), generator=gen, device="cuda"))

    pt = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    n = 0
    for b, ln in enumerate(lens):
        if ln >= 0:
            k = min(ln // ps + 1, W)
            pt[b, :k] = perm[n:n + k]
            n += k
    if layout == "fused":
        kv = torch.randn((B, 1, 2 * Hkv, hd), generator=gen, device="cuda")
        kv = (kv * 2).to(dtype)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    else:
        k = (torch.randn((B, 1, Hkv, hd), generator=gen,
                         device="cuda") * 2).to(dtype)
        v = (torch.randn((B, 1, Hkv, hd), generator=gen,
                         device="cuda") * 2).to(dtype)
    lengths = torch.tensor([max(ln, 0) for ln in lens], dtype=torch.int32,
                           device="cuda")
    return k, v, triple(), triple(), pt.cuda(), lengths


def _assert_pages_equal(got, want):
    """Every page but the trash page 0, byte for byte."""
    for a, b in zip(got, want):
        assert torch.equal(a[1:], b[1:])


APPEND_GPU_CASES = [
    # (B, Hkv, hd, page_size, W, lengths, dtype, layout)
    (4, 52, 128, 16, 16, [232, 123, 56, 17], "bfloat16", "bshd"),  # main
    (4, 52, 128, 16, 16, [255, -1, 0, 16], "bfloat16", "fused"),
    (4, 4, 16, 8, 8, [63, 5, -1, 0], "float32", "bshd"),   # reduced, f32
    (3, 3, 32, 4, 2, [7, -1, 2], "float32", "fused"),      # ppr 3, g 32
    (3, 2, 8, 4, 2, [8, 3, -1], "bfloat16", "bshd"),       # g 16, clamped
    (2, 64, 64, 16, 4, [40, 1], "bfloat16", "bshd"),       # g 128 of 2 heads
    (4, 32, 80, 16, 16, [232, 123, 56, 17], "bfloat16", "bshd"),  # stablelm
    (4, 1, 256, 16, 16, [232, 123, 56, 17], "bfloat16", "bshd"),  # gemma
    (3, 8, 80, 8, 4, [7, -1, 30], "float32", "fused"),
]


@pytest.mark.parametrize("B,Hkv,hd,ps,W,lens,dtype,layout", APPEND_GPU_CASES)
def test_kv_quant_append_matches_plain(cuda, B, Hkv, hd, ps, W, lens, dtype,
                                       layout):
    """One launch writes the bytes the plain version writes (kv_quant_ref
    and six index_puts) on every page but the trash page."""
    k, v, kpg, vpg, pt, lengths = _append_operands(
        B, Hkv, hd, ps, W, lens, getattr(torch, dtype), seed=B + hd,
        layout=layout)
    want_k = tuple(t.clone() for t in kpg)
    want_v = tuple(t.clone() for t in vpg)
    ref.kv_quant_append_ref(k, v, want_k, want_v, pt, lengths, page_size=ps)
    before = ops.launch_counts()
    ops.kv_quant_append(k, v, kpg, vpg, pt, lengths, page_size=ps)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["kv_quant_append"] == before["kv_quant_append"] + 1
    assert after["kv_quant"] == before["kv_quant"]
    _assert_pages_equal(kpg, want_k)
    _assert_pages_equal(vpg, want_v)


def test_kv_quant_append_refuses_a_copy(cuda):
    """Operands it would have to copy or cannot address raise: a k view
    off the 16-byte grain, int64 lengths, a sequence axis of 2."""
    k, v, kpg, vpg, pt, lengths = _append_operands(
        2, 4, 16, 8, 2, [3, 9], torch.bfloat16, seed=7)
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    k_off = buf[1:].view(k.shape)
    with pytest.raises(ValueError, match="no copy"):
        kq.kv_quant_append(k_off, v, kpg, vpg, pt, lengths, page_size=8)
    with pytest.raises(ValueError, match="bad operands"):
        kq.kv_quant_append(k, v, kpg, vpg, pt, lengths.long(), page_size=8)
    k2 = torch.cat([k, k], dim=1)
    with pytest.raises(ValueError, match="bad operands"):
        kq.kv_quant_append(k2, k2, kpg, vpg, pt, lengths, page_size=8)


def test_kv_quant_append_graph_replay_follows_lengths(cuda):
    """The append captured once in a CUDA graph, replayed after lengths,
    the page table and k/v were overwritten in place: each replay writes
    what the plain version writes on the new contents (nothing about the
    lengths was decided on the host)."""
    B, Hkv, hd, ps, W = 4, 52, 128, 16, 16
    k, v, kpg, vpg, pt, lengths = _append_operands(
        B, Hkv, hd, ps, W, [232, 123, 56, 17], torch.bfloat16, seed=31)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # build, warm-up
        kq.kv_quant_append(k, v, kpg, vpg, pt, lengths, page_size=ps)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kq.kv_quant_append(k, v, kpg, vpg, pt, lengths, page_size=ps)
    for i, lens in enumerate(([0, 15, 16, 255], [233, 124, 57, 18],
                              [100, 0, 200, 31])):
        k.copy_(torch.randn(k.shape, generator=_gen(40 + i), device=cuda))
        v.copy_(torch.randn(v.shape, generator=_gen(50 + i), device=cuda))
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        pt.copy_(pt.roll(1, dims=0))
        want_k = tuple(t.clone() for t in kpg)
        want_v = tuple(t.clone() for t in vpg)
        ref.kv_quant_append_ref(k, v, want_k, want_v, pt, lengths,
                                page_size=ps)
        graph.replay()
        torch.cuda.synchronize()
        _assert_pages_equal(kpg, want_k)
        _assert_pages_equal(vpg, want_v)


def test_decode_chunk_appends_once_per_layer_without_host_sync(cuda):
    """A paged int4 decode engine on the card (reduced LLaMA-30B): every
    chunk runs under ``set_sync_debug_mode("error")`` (``sync_check``),
    launches ``kv_quant_append`` once per layer per step and ``kv_quant``
    never, and decodes the tokens the same engine decodes on the CPU."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced("llama-30b").replace(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    streams = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, dev)
        pre = E.PrefillEngine(cfg, p, max_seq=64, device=dev)
        dec = E.DecodeEngine(cfg, p, max_slots=4, max_seq=64, page_size=8,
                             chunk_size=4, device=dev)
        rng = np.random.default_rng(0)
        reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 10)
                for i, n in enumerate((7, 19, 33))]
        out = pre.run(reqs)
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in out]))
        while dec.active:
            before, steps = ops.launch_counts(), dec.steps_run
            dec.step(sync_check=True)
            after = ops.launch_counts()
            if dev == "cuda":
                n = (dec.steps_run - steps) * cfg.num_layers
                assert after["kv_quant_append"] - \
                    before["kv_quant_append"] == n
                assert after["kv_quant"] == before["kv_quant"]
        assert dec.page_stats()["leaked_pages"] == 0
        streams[dev] = [r.out_tokens for r in reqs]
    assert dec.host_syncs * dec.chunk_size == dec.steps_run
    assert streams["cuda"] == streams["cpu"]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# -- the redesigned kernels under CUDA-graph replay -------------------------------


def test_graph_replay_follows_kv_len_and_prefix_len(cuda):
    """Flash attention (bf16, suffix mask) and paged int4 attention captured
    once in a CUDA graph, then replayed after the kv_len / prefix_len
    tensors were overwritten in place: each replay must match the plain
    version on the new contents, so no host-side decision (split count,
    tile count, early exit) was baked into the capture."""
    gen = _gen(21)
    B, S, P, H, Hkv, hd = 3, 32, 224, 8, 4, 128
    bf = torch.bfloat16
    q = torch.randn((B, S, H, hd), generator=gen, device=cuda).to(bf)
    k = torch.randn((B, P + S, Hkv, hd), generator=gen, device=cuda).to(bf)
    v = torch.randn((B, P + S, Hkv, hd), generator=gen, device=cuda).to(bf)
    plen = torch.tensor([224, 0, 100], dtype=torch.int32, device=cuda)
    pq, kpg, vpg, pt, kv_len = _random_pages(4, 8, 1, 128, 16, 16,
                                             [256, 256, 256, 256], bf,
                                             seed=22)
    kv_len.copy_(torch.tensor([17, 232, 64, 1], dtype=torch.int32))

    def run():
        return (fa.flash_attention(q, k, v, prefix_len=plen),
                pa.paged_decode_attention_int4(pq, kpg, vpg, pt, kv_len,
                                               page_size=16))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                   # build, counters, warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fo, po = run()
    for pl, lens in (([224, 0, 100], [17, 232, 64, 1]),
                     ([0, 224, 31], [256, 1, 65, 0]),
                     ([5, 64, 223], [129, 64, 300, 200])):
        plen.copy_(torch.tensor(pl, dtype=torch.int32))
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want_f = ref.flash_attention_ref(q, k, v, prefix_len=plen)
        want_p = ref.paged_decode_attention_ref(pq, kpg, vpg, pt, kv_len,
                                                page_size=16)
        torch.testing.assert_close(fo.float(), want_f.float(), atol=2e-2,
                                   rtol=2e-2)
        live = kv_len > 0     # kv_len 0 gives 0 (the plain version: mean V)
        torch.testing.assert_close(po[live].float(), want_p[live].float(),
                                   atol=2e-2, rtol=2e-2)
        assert torch.equal(po[~live], torch.zeros_like(po[~live]))


# -- the split bf16 decode body: dense strides and bf16 pages --------------------

SPLIT_EDGES = [0, 1, 63, 64, 65, 256]   # kv_len around the 64-key splits


@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
def test_split_decode_attention_at_split_edges(cuda, qdt, kvdt):
    """kv_len 0, 1, 63, 64, 65 and the maximum (S = 256, 4 splits) in one
    launch: the live rows match the plain version, kv_len 0 gives 0."""
    B = len(SPLIT_EDGES)
    q, k, v, kv_len, _ = _decode_inputs(B, 4, 2, 128, 256, SPLIT_EDGES,
                                        getattr(torch, qdt),
                                        getattr(torch, kvdt), "cache",
                                        seed=31)
    got = ops.decode_attention(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    tol = 2e-2 if qdt == "bfloat16" else 1e-5
    torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("ps", [16, 8])
def test_split_paged_bf16_at_split_edges(cuda, qdt, ps):
    B = len(SPLIT_EDGES)
    W = 256 // ps
    q, kp, vp, pt, kv_len = _bf16_pages(B, 4, 2, 128, ps, W, SPLIT_EDGES,
                                        getattr(torch, qdt), seed=32 + ps)
    got = ops.paged_decode_attention(q, kp, vp, pt, kv_len, page_size=ps)
    want = ref.paged_decode_attention_ref(q, kp, vp, pt, kv_len,
                                          page_size=ps)
    torch.cuda.synchronize()
    tol = 2e-2 if qdt == "bfloat16" else 1e-5
    torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_split_bf16_body_graph_replay_follows_kv_len_and_page_table(cuda):
    """The dense and the paged launch captured once in a CUDA graph, then
    replayed after kv_len and the page table were overwritten in place:
    each replay matches the plain version on the new contents (the split
    plan and the early exits are decided on the card)."""
    B, Hkv, g, hd, ps, W = 4, 8, 1, 128, 16, 16
    bf = torch.bfloat16
    q, k, v, kv_len, _ = _decode_inputs(B, Hkv, g, hd, W * ps,
                                        [17, 232, 64, 1], bf, bf, "cache",
                                        seed=33)
    pq, kp, vp, pt, pl = _bf16_pages(B, Hkv, g, hd, ps, W,
                                     [256, 256, 256, 256], bf, seed=34)

    def run():
        return (ops.decode_attention(q, k, v, kv_len),
                ops.paged_decode_attention(pq, kp, vp, pt, pl, page_size=ps))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        do, po = run()
    perm = torch.randperm(kp.shape[0] - 1,
                          generator=torch.Generator().manual_seed(35)) + 1
    for step, lens in enumerate(([17, 232, 64, 1], [256, 0, 65, 63],
                                 [129, 64, 256, 200])):
        kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
        pl.copy_(torch.tensor(lens, dtype=torch.int32))
        if step:                                  # new pages for every slot
            pt.copy_(torch.roll(perm, step)[:B * W].reshape(B, W).to(
                torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want_d = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
        want_p = ref.paged_decode_attention_ref(pq, kp, vp, pt, pl,
                                                page_size=ps)
        live = kv_len > 0
        for got, want in ((do, want_d), (po, want_p)):
            torch.testing.assert_close(got[live].float(),
                                       want[live].float(), atol=2e-2,
                                       rtol=2e-2)
            assert torch.equal(got[~live], torch.zeros_like(got[~live]))


# -- the decode chunk as a CUDA graph (registry.GraphedDecodeChunk) -------------

GRAPH_MODES = {"int4": {"page_size": 8, "prefix_sharing": True},
               "dense": {"paged": False},
               "bf16": {"page_size": 8, "prefix_sharing": True,
                        "kv_resident": "bf16"}}


def _graph_engines(mode, dtype="bfloat16"):
    """A prefill engine and two decode engines of ``mode`` on one set of
    weights: ``{True: graphed, False: eager}``."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced("llama-30b").replace(dtype=dtype)
    params = _tree_to(init_params(cfg, seed=0, device="cpu",
                                  dtype=getattr(torch, dtype)), "cuda")
    pre = E.PrefillEngine(cfg, params, max_seq=64, device="cuda")
    decs = {g: E.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                              chunk_size=4, cuda_graph=g, device="cuda",
                              **GRAPH_MODES[mode]) for g in (True, False)}
    return cfg, pre, decs


def _assert_same_decode_state(a, b):
    """The same slots, tokens and current tokens, the same lengths and page
    table, and every byte attention can read equal: every page but the
    trash page (idle slots' writes race there) or, dense, each occupied
    slot's rows below its length."""
    assert [None if r is None else (r.rid, r.out_tokens) for r in a.slots] \
        == [None if r is None else (r.rid, r.out_tokens) for r in b.slots]
    assert a.cur_token.tolist() == b.cur_token.tolist()
    assert torch.equal(a.cache["lengths"], b.cache["lengths"])
    if a.paged:
        assert torch.equal(a.cache["page_table"], b.cache["page_table"])
        assert a.pool.state_key() == b.pool.state_key()
        for x, y in zip(a.cache["slot0"].values(),
                        b.cache["slot0"].values()):
            assert torch.equal(x[:, 1:], y[:, 1:])
        return
    lengths = a.cache["lengths"].tolist()
    for slot, req in enumerate(a.slots):
        if req is not None:
            for key in ("k", "v"):
                n = lengths[slot]
                assert torch.equal(a.cache["slot0"][key][:, slot, :n],
                                   b.cache["slot0"][key][:, slot, :n])


def _step_both(decs, n_steps=None):
    """One chunk on each engine under the sync-debug guard; the wrappers'
    launch counts must move the same on both (the graphed one adds back
    what its capture counted)."""
    launched, finished = {}, {}
    for g in (True, False):
        before = ops.launch_counts()
        finished[g] = [r.rid for r in decs[g].step(n_steps, sync_check=True)]
        after = ops.launch_counts()
        launched[g] = {k: after[k] - before[k] for k in after}
    torch.cuda.synchronize()
    assert finished[True] == finished[False]
    assert launched[True] == launched[False]
    _assert_same_decode_state(decs[True], decs[False])
    return launched[True]


def test_decode_chunk_span_carries_attn_ctas(cuda):
    """On int4 pages a traced ``decode.chunk`` carries ``attn_ctas``, the
    CTAs each paged int4 launch of the chunk runs as the wrapper counts
    them (``ops.cta_counts``): the same graphed and eager, since the grid
    comes from shapes alone, and at most the items the shapes allow."""
    import numpy as np
    from repro_torch.serving import engine as E
    from repro_torch.serving import trace
    cfg, pre, decs = _graph_engines("int4")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 19, 30)]
    for dec in decs.values():
        reqs = [E.GenRequest(i, p, 6) for i, p in enumerate(prompts)]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w)
             for r, (_, w, f) in zip(reqs, pre.run(reqs))]))
    trace.clear()
    trace.enable()
    try:
        _step_both(decs)
        _step_both(decs)
    finally:
        trace.disable()
    chunks = [r.attrs for r in trace.spans() if r.name == "decode.chunk"]
    assert len(chunks) == 4
    ctas = {r["attn_ctas"] for r in chunks}
    Hkv, H = cfg.num_kv_heads, cfg.num_heads
    rows = pa.rows_per_cta(H // Hkv)
    items = 4 * Hkv * -(-(H // Hkv) // rows) * pa.split_plan(64 // 8, 8)[1]
    assert len(ctas) == 1 and 0 < ctas.pop() <= items


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_graphed_chunk_matches_eager_chunk(cuda, mode):
    """The graphed and the eager chunk on one card, in lockstep over
    several chunks with admissions, a migration, a cancellation, a fresh
    admission into a released slot and (paged) a full prefix hit with
    copy-on-write between them: equal tokens, state, lengths and page
    bytes after every chunk, equal launch counts, 0 leaked pages, one
    graph per chunk length."""
    import numpy as np
    from repro_torch.serving import engine as E
    cfg, pre, decs = _graph_engines(mode)
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    system = rng.integers(1, V, 8)
    prompts = [np.concatenate([system, rng.integers(1, V, n)])
               for n in (5, 13, 22, 9)]
    reqs = {g: [E.GenRequest(i, p, m) for i, (p, m) in
                enumerate(zip(prompts, (3, 14, 11, 6)))] for g in decs}
    wires = pre.run(reqs[True][:3])

    def admit(g, items):
        assert not decs[g].admit(E.AdmissionBatch(items))

    for g in decs:
        admit(g, [E.AdmissionItem(reqs[g][i], f, wire=w)
                  for i, (_, w, f) in enumerate(wires)])
    n_graph = decs[True].jit_cache_size
    assert n_graph == 0                      # captured on the first chunk
    _step_both(decs)
    assert decs[True].jit_cache_size == 1
    for g, dec in decs.items():              # migrate request 1 home
        (slot, req, wire, cur), = [s for s in dec.extract_resident()
                                   if s[1].rid == 1]
        dec.release(slot)
        admit(g, [E.AdmissionItem(req, cur, E.ADMIT_MIGRATED, wire=wire)])
    _assert_same_decode_state(decs[True], decs[False])
    _step_both(decs)
    for g, dec in decs.items():              # cancel request 2
        dec.release(dec.slots.index(reqs[g][2]))
    (_, w3, f3), = pre.run([reqs[True][3]])
    for g in decs:                           # a fresh request in its slot
        admit(g, [E.AdmissionItem(reqs[g][3], f3, wire=w3)])
    if decs[True].paged:                     # request 0 finished: full hit
        for g, dec in decs.items():
            hit = dec.prefix_match(prompts[0])
            assert hit is not None and hit.full
            reqs[g].append(E.GenRequest(4, prompts[0], 3))
            admit(g, [E.AdmissionItem(reqs[g][4], hit.next_token,
                                      E.ADMIT_PREFIX_HIT,
                                      pages=list(hit.pages))])
            assert dec.cow_copies == 1
    while decs[True].active or decs[False].active:
        per_chunk = _step_both(decs)
        assert decs[True].jit_cache_size == 1
    attn = {"int4": "paged_decode_attention_int4",
            "bf16": "paged_decode_attention_bf16",
            "dense": "decode_attention"}[mode]
    assert per_chunk[attn] == per_chunk["add_rmsnorm"] // 2 == \
        4 * cfg.num_layers
    for g in decs:
        assert [len(r.out_tokens) for r in reqs[g]][3:] == \
            [r.max_new_tokens for r in reqs[g]][3:]
    assert [r.out_tokens for r in reqs[True]] == \
        [r.out_tokens for r in reqs[False]]
    if decs[True].paged:
        assert reqs[True][4].out_tokens == reqs[True][0].out_tokens
        assert decs[True].page_stats()["leaked_pages"] == 0
    # a second chunk length captures exactly one more graph
    for g in decs:
        reqs[g].append(E.GenRequest(5, prompts[3], 7))
        admit(g, [E.AdmissionItem(reqs[g][-1], f3, wire=w3)])
    _step_both(decs, n_steps=2)
    assert decs[True].jit_cache_size == 2 and decs[False].jit_cache_size == 0
    while decs[True].active or decs[False].active:
        _step_both(decs, n_steps=2)
    assert decs[True].jit_cache_size == 2


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_graphed_step_reference_matches_step(cuda, mode):
    """On a graphed engine, one host round trip per token decodes what the
    replayed chunks decode, bit for bit."""
    import numpy as np
    from repro_torch.serving import engine as E
    cfg, pre, decs = _graph_engines(mode)
    dec = decs[True]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (7, 19, 33)]
    streams = []
    for use_ref in (False, True):
        reqs = [E.GenRequest(i, p, m)
                for i, (p, m) in enumerate(zip(prompts, (9, 6, 8)))]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step_reference() if use_ref else dec.step(sync_check=True)
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert dec.jit_cache_size == 1
    if dec.paged:
        assert dec.page_stats()["leaked_pages"] == 0


def test_graph_guard_raises_when_a_captured_tensor_moves(cuda):
    """A replay never reads or writes a tensor that is no longer the
    engine's: replacing a cache tensor or a parameter makes the next chunk
    raise instead of replaying."""
    import numpy as np
    from repro_torch.serving import engine as E
    cfg, pre, decs = _graph_engines("int4")
    dec = decs[True]
    req = E.GenRequest(0, np.arange(1, 12), 20)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run([req])]))
    dec.step()
    kept = dec.cache["lengths"]
    dec.cache["lengths"] = kept.clone()
    with pytest.raises(RuntimeError, match="captured tensor was replaced"):
        dec.step()
    dec.cache["lengths"] = kept
    dec.step()                                   # the same tensors: fine
    dec.params["layers"][0]["mlp"]["wo"] = \
        dec.params["layers"][0]["mlp"]["wo"].clone()
    with pytest.raises(RuntimeError, match="captured tensor was replaced"):
        dec.step()


def test_graphs_are_released_with_their_engine(cuda):
    """A retired engine's graphs and the memory of their pools go with
    it: nothing else holds them."""
    import gc
    import weakref
    import numpy as np
    from repro_torch.serving import engine as E
    cfg, pre, decs = _graph_engines("int4")
    del decs[True]
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    dec = E.DecodeEngine(cfg, pre.params, max_slots=4, max_seq=64,
                         page_size=8, chunk_size=4, device="cuda")
    req = E.GenRequest(0, np.arange(1, 12), 9)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run([req])]))
    while dec.active:
        dec.step()
    assert dec.jit_cache_size == 1
    graphs = weakref.ref(dec.graphs)
    del dec
    gc.collect()
    torch.cuda.synchronize()
    assert graphs() is None
    assert torch.cuda.memory_allocated() <= base


def test_capture_is_not_spoiled_by_a_dead_engines_graph(cuda):
    """A graphed engine that died in a reference cycle (as a dropped
    gateway's engines do) must not spoil another engine's capture: CUDA
    refuses to destroy a graph while a stream captures, so a garbage
    collection that lands inside the capture would invalidate it. The
    capture collects first and suspends automatic collection; here a
    collection is forced inside the capture, with automatic collection
    off so the dead graph survives until then."""
    import gc
    import numpy as np
    from repro_torch.serving import engine as E
    cfg, pre, decs = _graph_engines("int4")
    old = decs.pop(True)

    def serve(dec, rid):
        req = E.GenRequest(rid, np.arange(1, 12), 9)
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run([req])]))
        while dec.active:
            dec.step()
        return req.out_tokens

    want = serve(old, 0)
    assert old.jit_cache_size == 1
    collecting = gc.isenabled()
    gc.disable()
    try:
        cycle = [old]
        cycle.append(cycle)
        del old, cycle                 # garbage holding a captured graph
        new = E.DecodeEngine(cfg, pre.params, max_slots=4, max_seq=64,
                             page_size=8, chunk_size=4, device="cuda")
        chunk = new.graphs._chunk_fn

        def collect_inside(*a, **kw):
            gc.collect()
            return chunk(*a, **kw)

        new.graphs._chunk_fn = collect_inside
        assert serve(new, 1) == want
    finally:
        if collecting:
            gc.enable()
    assert new.jit_cache_size == 1


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_reduced_f32_graphed_tokens_equal_cpu(cuda, mode):
    """The reduced float32 model decodes the same tokens on the card with
    graphs as on the CPU with the plain versions, on each decode cache."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced("llama-30b").replace(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    streams = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, dev)
        pre = E.PrefillEngine(cfg, p, max_seq=64, device=dev)
        dec = E.DecodeEngine(cfg, p, max_slots=4, max_seq=64, chunk_size=4,
                             device=dev, **GRAPH_MODES[mode])
        rng = np.random.default_rng(0)
        reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 12)
                for i, n in enumerate((7, 19, 33))]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step()
        streams[dev] = [r.out_tokens for r in reqs]
        assert dec.jit_cache_size == (1 if dev == "cuda" else 0)
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_graphed_preemption_migrates_bit_identical_streams(cuda, mode):
    """A spot preemption between graphed decode engines (the reduced
    float32 model on the card): the victim's resident KV is written into
    the survivor's cache while the survivor's graph is live, and every
    stream equals an undisturbed run's byte for byte, with no restart, no
    second graph on either engine and no leaked page. The dense engines
    ship raw wires, as the reference's bit-identity test does."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving import gateway as G
    cfg = get_reduced("llama-30b").replace(dtype="float32")
    params = _tree_to(init_params(cfg, seed=0, device="cpu",
                                  dtype=torch.float32), "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]

    def gateway():
        pre = E.PrefillEngine(cfg, params, max_seq=64, device="cuda")
        decs = [E.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                               chunk_size=2, device="cuda",
                               **GRAPH_MODES[mode]) for _ in range(2)]
        gw = G.Gateway([pre], decs, compress=mode != "dense")
        G.warmup_gateway(gw, cfg.vocab_size, prompt_lens=(12,))
        assert [d.jit_cache_size for d in decs] == [1, 1]
        return gw, [gw.submit(G.ServeRequest(i, p, 20))
                    for i, p in enumerate(prompts)]

    base, bh = gateway()
    base.run_until_drained()
    want = {h.request.rid: list(h.tokens) for h in bh}
    assert all(h.state == G.DONE and len(h.tokens) == 20 for h in bh)

    gw, hs = gateway()
    for _ in range(60):
        gw.pump()
        if (all(h.state == G.DECODING for h in hs)
                and min(len(h.tokens) for h in hs) >= 2):
            break
    assert all(h.state == G.DECODING for h in hs)
    vic = max(range(2), key=lambda j: len(gw.dec[j].client.resident()))
    n_vic = len(gw.dec[vic].client.resident())
    rep = gw.handle_preemption("decode", vic, grace_s=60.0)
    assert n_vic >= 1 and rep["migrated"] == n_vic
    assert rep["requeued"] == 0
    gw.run_until_drained()
    assert all(h.state == G.DONE and h.restarts == 0 for h in hs)
    assert {h.request.rid: list(h.tokens) for h in hs} == want
    assert gw.stats()["counters"]["migrations"] == n_vic
    assert [h.engine.jit_cache_size for h in gw.dec] == [1, 1]
    for h in gw.dec:
        if h.engine.paged:
            st = h.engine.page_stats()
            assert st["leaked_pages"] == 0 and st["reencoded_inserts"] == 0


# -- the other dense configs (their head dims are cases above) ------------------


def test_head_dims_without_an_instantiation_raise(cuda):
    """hd 96 has no instantiation in any attention kernel, and the int4
    pages none at hd 120 (no registered config pages at it): each wrapper
    raises before a launch."""
    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    kv = torch.zeros((1, 2, 8, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bad operands"):
        da.decode_attention(q[:, :1].reshape(1, 2, 1, 96).contiguous(), kv,
                            kv, torch.ones((1,), dtype=torch.int32,
                                           device=cuda))
    q, kpg, vpg, pt, kv_len = _random_pages(1, 2, 1, 120, 8, 2, [9],
                                            torch.bfloat16, seed=5)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention_int4(q, kpg, vpg, pt, kv_len, page_size=8)


DENSE_ARCHS = ("stablelm-3b", "gemma-2b", "h2o-danube-3-4b", "command-r-35b")
MOE_VLM_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                 "llava-next-mistral-7b")
RECURRENT_ARCHS = ("xlstm-125m", "jamba-v0.1-52b")


def _arch_modes(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models.paged import paged_supported
    if paged_supported(get_reduced(arch)):
        return sorted(GRAPH_MODES)
    return ["dense"]


@pytest.mark.parametrize("arch,mode", [(a, m)
                                       for a in DENSE_ARCHS + MOE_VLM_ARCHS
                                       + RECURRENT_ARCHS
                                       for m in _arch_modes(a)])
def test_reduced_archs_graphed_tokens_equal_cpu(cuda, arch, mode):
    """Each other config's reduced float32 model decodes the same tokens
    on the card (graphed chunks) as on the CPU, on every decode cache it
    can take; h2o-danube's 32-token window wraps its ring; the MoE
    configs route in f32 (TF32 off) to the CPU's experts; the recurrent
    stacks' states are written in place under the graph."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced(arch).replace(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    streams = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, dev)
        pre = E.PrefillEngine(cfg, p, max_seq=64, device=dev)
        dec = E.DecodeEngine(cfg, p, max_slots=4, max_seq=64, chunk_size=4,
                             device=dev, **GRAPH_MODES[mode])
        rng = np.random.default_rng(0)
        reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 20)
                for i, n in enumerate((7, 19, 40))]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step()
        streams[dev] = [r.out_tokens for r in reqs]
        assert dec.jit_cache_size == (1 if dev == "cuda" else 0)
    assert streams["cuda"] == streams["cpu"]


def test_moe_apply_in_a_graph_without_host_sync(cuda):
    """The MoE layer at a decode step's 4 tokens (bf16, reduced qwen3-moe
    widths with 128 experts): no host sync (the decode chunk's guard),
    captured in a CUDA graph whose replay on new tokens gives the eager
    call's bytes (no atomics in the dispatch or the combine), and within
    one bf16 ulp-scale tolerance of the CPU's f32 computation of the same
    routes."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    cfg = get_reduced("qwen3-moe-235b-a22b").replace(moe_num_experts=128,
                                                     moe_top_k=8)
    gen = _gen(77)
    E, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": torch.randn((d, E), generator=gen, device=cuda) / d ** .5,
         "wi": (torch.randn((E, d, 2 * f), generator=gen, device=cuda)
                / d ** .5).to(torch.bfloat16),
         "wo": (torch.randn((E, f, d), generator=gen, device=cuda)
                / f ** .5).to(torch.bfloat16)}
    x = torch.randn((4, 1, d), generator=gen, device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager, _ = moe.moe_apply(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_apply(cfg, p, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_apply(cfg, p, static)
    x2 = torch.randn((4, 1, d), generator=gen, device=cuda).to(torch.bfloat16)
    for inp in (x, x2):
        static.copy_(inp)
        graph.replay()
        torch.cuda.synchronize()
        want, _ = moe.moe_apply(cfg, p, inp)
        assert torch.equal(out, want)
    cpu = {k: v.cpu().float() for k, v in p.items()}
    ref_out, _ = moe.moe_apply(cfg, cpu, x2.cpu().float())
    torch.testing.assert_close(out.float().cpu(), ref_out, atol=2e-2,
                               rtol=2e-2)


# -- jamba at the published widths (ROADMAP C.5) ---------------------------------


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("S", [600, 1100])
def test_jamba_mamba_state_at_full_width_is_the_prompts(cuda, S):
    """One Mamba mixer of jamba-v0.1-52b at its published widths (d 4,096,
    d_inner 8,192, d_state 16, dt_rank 256, the inner norms on), bf16
    weights: over S tokens, more than the 512-step chunk and no multiple
    of it, ``mamba_apply`` hands on the state after step S: the
    step-by-step recurrence's (``mamba_decode_step`` over the prompt) and
    its own call in one chunk: within 1e-3 relative L2 of the one-chunk
    call (the same inputs, summed in another order) and 1e-2 of the steps
    (a token's ``in_proj`` alone rounds its bf16 output apart from the
    whole prompt's); the state after zeros padded to a whole chunk, which
    the padding's steps decay, misses the steps' by over 0.1. The outputs
    and the conv state agree with the steps' within 1e-2 (bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models.transformer import ParamMaker
    cfg = get_config("jamba-v0.1-52b")
    assert cfg.mamba_inner_norms and cfg.mamba_d_inner == 8192
    p = ParamMaker(cfg, 0, cuda, torch.bfloat16).mamba()
    x = torch.randn((1, S, cfg.d_model), generator=_gen(S),
                    device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        out, (conv, h) = mamba.mamba_apply(cfg, p, x)
        _, (_, h_one) = mamba.mamba_apply(cfg, p, x, chunk=S)
        st = mamba.mamba_state_init(cfg, 1, device=cuda)
        ys = []
        for t in range(S):
            y, st = mamba.mamba_decode_step(cfg, p, x[:, t:t + 1], st)
            ys.append(y)
        padded = torch.cat([x, torch.zeros_like(x[:, :512 - S % 512])], 1)
        _, (_, h_pad) = mamba.mamba_apply(cfg, p, padded)
    assert _rel_l2(h, h_one) < 1e-3 and _rel_l2(h, st[1]) < 1e-2
    assert _rel_l2(conv, st[0]) < 1e-2
    assert _rel_l2(out, torch.cat(ys, 1)) < 1e-2
    assert _rel_l2(h_pad, st[1]) > 0.1


def test_jamba_prefill_call_times_its_mamba_mixers(cuda):
    """The reduced jamba's exact-length prefill on the card under the
    tracer: ``prefill.call`` carries ``mamba_ms``, the CUDA-event time of
    its Mamba mixers (positive, below the call's own host time, which
    waits for the first tokens), beside ``moe_routes`` and ``moe_rows``;
    with the tracer off no event is recorded and the call has no
    record."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving import trace
    cfg = get_reduced("jamba-v0.1-52b")
    params = init_params(cfg, device=cuda)
    pre = E.PrefillEngine(cfg, params, max_seq=128, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n)
                         .astype(np.int32), 4) for i, n in enumerate((30, 90))]
    pre.run(reqs)
    trace.clear()
    trace.enable()
    try:
        pre.run(reqs)
    finally:
        trace.disable()
    call, = [r for r in trace.spans() if r.name == "prefill.call"]
    assert 0 < call.attrs["mamba_ms"] < 1e3 * (call.t1 - call.t0)
    assert call.attrs["moe_routes"] > 0 and call.attrs["moe_rows"] > 0
    trace.clear()
    pre.run(reqs)
    assert not trace.spans()


# -- training (the plain versions under autograd; no kernel) -----------------


@pytest.mark.parametrize("arch", ["llama-30b", "qwen3-moe-235b-a22b",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_reduced_train_grads_card_match_cpu(cuda, arch):
    """The loss and gradients of the reduced f32 config from the same
    weights and batch on the card and on the CPU: the loss within 1e-4
    relative, the gradients within 1e-3 relative L2 per tensor (against
    the larger of the tensor's norm and 1e-3 of the whole gradient's); no
    kernel runs (the launch counts stay). Gradients, not updated params:
    Adam's first step moves an element by about +-lr whatever its
    gradient's size, so a gradient near zero may take either sign."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import make_params
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, PackedLM
    cfg = get_reduced(arch).replace(dtype="float32")
    api = build(cfg)
    batch = PackedLM(DataConfig(cfg.vocab_size, 48, 2)).batch_at(0)
    g = torch.Generator().manual_seed(0)
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (2, cfg.encoder_seq, cfg.d_model), generator=g).numpy()
    cpu = make_params(cfg, "cpu")
    before = ops.launch_counts()
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = opt.tree_map(lambda t: t.to(dev, copy=True), cpu)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, grads = opt.value_and_grad(api.loss, p, tb)
        out.append((float(loss), [t.cpu() for t in opt.tree_leaves(grads)]))
    assert ops.launch_counts() == before
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    total = sum(float(w.double().square().sum()) for w in g_cpu) ** 0.5
    for a, b in zip(g_card, g_cpu):
        scale = max(float(b.double().norm()), 1e-3 * total)
        assert float((a.double() - b.double()).norm()) <= 1e-3 * scale


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    """A tensor that requires grad reaching a kernel raises, through the
    wrapper and through ``ops``, and launches nothing; under no_grad the
    same call launches."""
    x = torch.randn((4, 64), device=cuda, requires_grad=True)
    scale = torch.zeros(64, device=cuda)
    before = ops.launch_counts()
    for call in (lambda: rn.rmsnorm(x, scale),
                 lambda: ops.rmsnorm(x, scale),
                 lambda: ops.add_rmsnorm(x, x, scale),
                 lambda: ops.kv_quant(x),
                 lambda: ops.flash_attention(*(x.view(1, 4, 1, 64),) * 3)):
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    assert ops.launch_counts() == before
    with torch.no_grad():
        want = ref.rmsnorm_ref(x, scale)
        got = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before["rmsnorm"] + 1
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_train_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    """``launch.train --reduced --device cuda``: 6 steps with checkpoints
    after steps 2 and 4; the step-4 one removed, ``--resume`` runs steps
    3-5 again from step 2's: the same losses and every byte of the state
    (deterministic algorithms, the embedding's backward sorted)."""
    import shutil
    from repro_torch.launch import train
    from repro_torch.training import optimizer as opt
    argv = ["--reduced", "--device", "cuda", "--steps", "6", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    a = train.run(argv)
    shutil.rmtree(tmp_path / "step_00000004")
    b = train.run(argv + ["--resume"])
    assert b["start"] == 3
    assert b["losses"] == a["losses"][3:]
    for x, y in zip(opt.tree_leaves((a["params"], a["opt_state"])),
                    opt.tree_leaves((b["params"], b["opt_state"]))):
        assert torch.equal(x.cpu(), y.cpu())


# -- a model axis over torch.distributed (ROADMAP A.9) -------------------------


@pytest.fixture
def world1(request, cuda):
    """A process group of one rank (``request.param``: ``nccl`` or
    ``gloo``) and a 1-D ``model`` mesh over it on the card; the group is
    destroyed after the test."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(request.param,
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1,), ("model",), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world1", ["nccl"], indirect=True)
@pytest.mark.parametrize("mode", ["int4", "dense"])
def test_nccl_world1_graphed_chunk_holds_collectives(world1, mode):
    """At model axis size 1 over NCCL, the meshed engines (graphed and
    eager) equal the unmeshed graphed engine bit for bit after every
    chunk: prefill wires, tokens, lengths, page bytes. The graphed chunk
    captures its collectives with its kernels (one graph: 2L all-reduces
    and 2 all-gathers a step), and a replay counts them."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.distributed import comm
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced("llama-30b")
    params = _tree_to(init_params(cfg, seed=0, device="cpu"), "cuda")
    rt = Runtime(world1)
    pres = {m: E.PrefillEngine(cfg, params, max_seq=64, device="cuda",
                               rt=rt if m else None) for m in (True, False)}
    decs = {(m, g): E.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                                   chunk_size=4, cuda_graph=g, device="cuda",
                                   rt=rt if m else None, **GRAPH_MODES[mode])
            for m, g in ((False, True), (True, True), (True, False))}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 13, 22)]
    wires = {}
    for m, pre in pres.items():
        wires[m] = pre.run([E.GenRequest(i, p, 9)
                            for i, p in enumerate(prompts)])
    for (_, w0, f0), (_, w1, f1) in zip(wires[False], wires[True]):
        assert f0 == f1
        for s in w0.slots:
            for k in w0.slots[s]:
                for a, b in zip(w0.slots[s][k].payload.values(),
                                w1.slots[s][k].payload.values()):
                    assert torch.equal(a, b)
    reqs = {}
    for key, dec in decs.items():
        reqs[key] = [E.GenRequest(i, p, 9) for i, p in enumerate(prompts)]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w)
             for r, (_, w, f) in zip(reqs[key], wires[key[0]])]))
    while decs[False, True].active:
        for dec in decs.values():
            dec.step()
        torch.cuda.synchronize()
        _assert_same_decode_state(decs[False, True], decs[True, True])
        _assert_same_decode_state(decs[True, True], decs[True, False])
    assert all(not d.active for d in decs.values())
    graphed = decs[True, True].graphs
    assert len(graphed) == 1 and len(decs[False, True].graphs) == 1
    per_replay = graphed.collectives(4, -1, 64)
    assert per_replay == {"all_reduce": 4 * 2 * cfg.num_layers,
                          "all_gather": 4 * 2}
    assert decs[False, True].graphs.collectives(4, -1, 64) == {}
    # a replay adds back the collectives its capture counted
    req = E.GenRequest(9, prompts[0], 4)
    (_, w, f), = pres[True].run([req])
    assert not decs[True, True].admit(E.AdmissionBatch(
        [E.AdmissionItem(req, f, wire=w)]))
    before = comm.counts()
    decs[True, True].step()
    after = comm.counts()
    assert after["all_reduce"] - before["all_reduce"] == \
        per_replay["all_reduce"]
    assert [r.out_tokens for r in reqs[False, True]] == \
        [r.out_tokens for r in reqs[True, True]] == \
        [r.out_tokens for r in reqs[True, False]]


@pytest.mark.parametrize("world1", ["gloo"], indirect=True)
def test_gloo_group_refuses_a_graphed_decode_chunk(world1):
    """A gloo group's collectives run on the host and cannot be captured:
    a decode engine asked for ``cuda_graph=True`` raises; the eager
    engine serves (its all-gathers staged through host copies)."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.serving import engine as E
    cfg = get_reduced("llama-30b")
    params = _tree_to(init_params(cfg, seed=0, device="cpu"), "cuda")
    rt = Runtime(world1)
    assert rt.tp.backend == "gloo" and rt.tp.staged
    with pytest.raises(ValueError, match="gloo"):
        E.DecodeEngine(cfg, params, max_slots=2, max_seq=32, device="cuda",
                       rt=rt)
    dec = E.DecodeEngine(cfg, params, max_slots=2, max_seq=32,
                         cuda_graph=False, device="cuda", rt=rt)
    pre = E.PrefillEngine(cfg, params, max_seq=32, device="cuda", rt=rt)
    req = E.GenRequest(0, np.arange(1, 10), 5)
    (r, w, f), = pre.run([req])
    assert not dec.admit(E.AdmissionBatch([E.AdmissionItem(r, f, wire=w)]))
    while dec.active:
        dec.step()
    assert len(req.out_tokens) == 5


# -- the logit softcap and the hkv_s cache layout (ROADMAP A.15) ----------------

SOFTCAP_FLASH_CASES = [
    # (B, Sq, P, H, Hkv, hd, window, plen, softcap)
    (2, 130, 0, 8, 1, 256, 0, None, 50.0),       # gemma-2b: MQA, hd 256
    (1, 300, 0, 8, 1, 256, 0, None, 50.0),
    (2, 16, 32, 8, 1, 256, 0, [20, 32], 50.0),   # a suffix over a prefix
    (2, 100, 0, 8, 2, 128, 0, None, 30.0),
    (2, 300, 0, 4, 4, 32, 100, None, 5.0),       # a window, a tight cap
    (3, 32, 224, 8, 4, 128, 0, [0, 100, 224], 30.0),
]


@pytest.mark.parametrize("B,Sq,P,H,Hkv,hd,window,plen,cap",
                         SOFTCAP_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_softcap_matches_plain(cuda, B, Sq, P, H, Hkv, hd,
                                               window, plen, cap, dtype):
    """The capped instantiations against the plain version's ``c tanh(s /
    c)`` (scores scaled up so the cap bites); and the same inputs uncapped
    differ (the cap is on). bf16 at the uncapped tests' 2e-2; f32 at
    1e-4: ``tanhf`` and the plain version's tanh differ by up to 2 ulps,
    which the cap multiplies by c (a capped score near 50 moves by ~1e-5,
    and an output of |v| ~ 3 with it)."""
    dt = getattr(torch, dtype)
    gen = _gen(B * 100 + Sq + hd + int(cap))
    q = (torch.randn((B, Sq, H, hd), generator=gen, device=cuda) * 4).to(dt)
    k = (torch.randn((B, P + Sq, Hkv, hd), generator=gen, device=cuda)
         * 4).to(dt)
    v = torch.randn((B, P + Sq, Hkv, hd), generator=gen, device=cuda).to(dt)
    pl = None if plen is None else torch.tensor(plen, dtype=torch.int32,
                                                device=cuda)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, prefix_len=pl,
                              softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, prefix_len=pl,
                                   softcap=cap)
    plain = ref.flash_attention_ref(q, k, v, window=window, prefix_len=pl)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert (plain.float() - want.float()).abs().max() > 10 * tol


@pytest.mark.parametrize("B,Hkv,g,hd,S,lens", [
    (4, 1, 8, 256, 256, [232, 123, 56, 17]),     # gemma-2b's decode step
    (4, 52, 1, 128, 256, [232, 123, 56, 17]),
    (3, 2, 4, 16, 40, [1, 40, 23])])
@pytest.mark.parametrize("qdt,kvdt", DTYPE_PAIRS)
@pytest.mark.parametrize("layout", ["cache", "hkv_s"])
@pytest.mark.parametrize("lse", [False, True])
def test_decode_attention_softcap_matches_plain(cuda, B, Hkv, g, hd, S,
                                                lens, qdt, kvdt, layout,
                                                lse):
    """The dense body's capped instantiation (and its partial mode) over
    the s_hkv cache's view and the hkv_s cache's (the reference's
    (B, Hkv, S, hd), read where it lies). f32 (and the partial mode) at
    1e-4, as the flash test says; bf16 q at 2e-2."""
    q, k, v, kv_len, _ = _decode_inputs(
        B, Hkv, g, hd, S, lens, getattr(torch, qdt), getattr(torch, kvdt),
        "bhsd" if layout == "hkv_s" else "cache", seed=B * 11 + hd + S)
    q = q * 4
    k = k * 4
    name = "decode_attention_lse" if lse else "decode_attention"
    before = ops.KERNELS[name].launches
    got = ops.decode_attention(q, k, v, kv_len, return_lse=lse,
                               softcap=30.0)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                    return_lse=lse, softcap=30.0)
    torch.cuda.synchronize()
    assert ops.KERNELS[name].launches == before + 1
    tol = 1e-4 if lse or qdt == "float32" else 2e-2
    if lse:
        torch.testing.assert_close(got[0], want[0], atol=tol, rtol=tol)
        torch.testing.assert_close(got[1], want[1], atol=tol, rtol=tol)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("cuda_graph", [True, False])
def test_hkv_s_decode_equals_s_hkv_bit_for_bit(cuda, cuda_graph):
    """The reduced model decoding on an hkv_s cache (the same indices over
    the reference's (L, B, Hkv, S, hd) strides) gives the s_hkv engine's
    tokens, logits-driven state and cache bytes exactly; graphed too."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    streams, caches = {}, {}
    for layout in ("s_hkv", "hkv_s"):
        cfg = get_reduced("llama-30b").replace(decode_cache_layout=layout)
        params = _tree_to(init_params(cfg, seed=0, device="cpu"), "cuda")
        pre = E.PrefillEngine(cfg, params, max_seq=64, device="cuda")
        dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64,
                             chunk_size=4, cuda_graph=cuda_graph,
                             paged=False, device="cuda")
        rng = np.random.default_rng(0)
        reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 12)
                for i, n in enumerate((7, 19, 33))]
        assert not dec.admit(E.AdmissionBatch(
            [E.AdmissionItem(r, f, wire=w) for r, w, f in pre.run(reqs)]))
        while dec.active:
            dec.step()
        streams[layout] = [r.out_tokens for r in reqs]
        k = dec.cache["slot0"]["k"]
        caches[layout] = k.contiguous()
        if layout == "hkv_s":
            assert k.transpose(2, 3).is_contiguous()
    assert streams["hkv_s"] == streams["s_hkv"]
    assert torch.equal(caches["hkv_s"], caches["s_hkv"])


# -- R002's banned calls under a CUDA graph capture ------------------------------

_CAPTURE_PROBE = r"""
import json, sys
import numpy as np
import torch
x = torch.arange(1, 9, device="cuda", dtype=torch.float32)
r = torch.full((8,), 2, device="cuda", dtype=torch.int64)
CALLS = {
    ".item()": lambda: x.sum().item(),
    ".tolist()": lambda: x.tolist(),
    ".cpu()": lambda: x.cpu(),
    ".numpy()": lambda: x.numpy(),
    "int() of an element": lambda: int(x[0]),
    "float() of an element": lambda: float(x[0]),
    "bool() of an element": lambda: bool(x[0]),
    "np.asarray": lambda: np.asarray(x),
    "np.array": lambda: np.array(x),
    "torch.cuda.synchronize": lambda: torch.cuda.synchronize(),
    "nonzero": lambda: torch.nonzero(x),
    "unique": lambda: torch.unique(x),
    "masked_select": lambda: x.masked_select(x > 2),
    "boolean-mask indexing": lambda: x[x > 2],
    "one-argument where": lambda: torch.where(x > 2),
    "repeat_interleave without output_size": lambda: x.repeat_interleave(r),
}
out = {}
side = torch.cuda.Stream()
for name, fn in CALLS.items():
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, stream=side):
            fn()
        out[name] = "captured"
    except Exception as e:
        out[name] = "raises: " + type(e).__name__
    del g
    try:
        assert torch.ones(4, device="cuda").sum().item() == 4.0
    except Exception as e:
        out[name] += "; context broken: " + type(e).__name__
        break
print(json.dumps(out))
"""


def test_r002_banned_calls_raise_under_capture(cuda):
    """Each call R002 bans, inside ``torch.cuda.graph`` (one process, a
    capture each, the context probed after each): every one raises, so
    every finding R002 makes is a real fault on the card."""
    import json
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _CAPTURE_PROBE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(got, indent=1))
    assert len(got) == 16, got
    assert all(v.startswith("raises") and "broken" not in v
               for v in got.values()), got
