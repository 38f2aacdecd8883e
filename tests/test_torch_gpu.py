"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided inside
the ``cuda`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: ``kv_quant``/``kv_dequant`` must agree bit for bit (the wire,
the pages and the decode append share one encoding); paged attention sums
in another order than the plain version, so it is held to 1e-5 in f32 and
to 2e-2 (a few bf16 ulps at |out| <= 4) in bf16.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import kv_quant as kq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("N", [1, 17, 300, 100_003])
@pytest.mark.parametrize("G", [2, 16, 64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_quant_kernel_bit_exact(cuda, N, G, dtype):
    dt = getattr(torch, dtype)
    x = (torch.randn((N, G), generator=_gen(N + G), device=cuda) * 3).to(dt)
    before = kq.kv_quant.launches
    got = kq.kv_quant(x)
    want = ref.kv_quant_ref(x)
    torch.cuda.synchronize()
    assert kq.kv_quant.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for out_dt in (torch.bfloat16, torch.float32):
        back = kq.kv_dequant(*got, out_dtype=out_dt)
        assert torch.equal(back, ref.kv_dequant_ref(*want, dtype=out_dt))


def test_kv_quant_constant_rows(cuda):
    """max == min: the 1e-8 floor on the scale, every nibble 0."""
    x = torch.full((5, 64), 2.5, device=cuda)
    for a, b in zip(kq.kv_quant(x), ref.kv_quant_ref(x)):
        assert torch.equal(a, b)


def _random_pages(B, Hkv, gq, hd, ps, W, kv_len, dtype, seed):
    g = next(c for c in (128, 64, 32, 16, 8, 4, 2) if (Hkv * hd) % c == 0)
    ppr = Hkv * hd // g
    R = ps * ppr
    need = sum(-(-l // ps) for l in kv_len)
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
        k = -(-l // ps)
        pt[b, :k] = perm[n:n + k]
        n += k
    q = torch.randn((B, Hkv, gq, hd), generator=gen, device="cuda").to(dtype)
    return (q, triple(), triple(), pt.cuda(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


PAGED_CASES = [
    # (B, Hkv, gq, hd, ps, W, kv_len)
    (4, 52, 1, 128, 16, 16, [256, 1, 100, 17]),   # LLaMA-30B width, g = hd
    (3, 2, 4, 32, 8, 4, [5, 16, 23]),             # GQA, g = 64 spans 2 heads
    (2, 4, 1, 16, 16, 5, [70, 3]),                # reduced config, trash tail
]


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
