"""The port's roofline (``roofline/op_cost.py``, ``roofline/analysis.py``,
``kernels/cost.py``) against the JAX package's (CPU, reduced configs).

* ``model_flops_for`` and the dry-run's cells (``all_cells``,
  ``ASSIGNED_ARCHS``, ``get_shape``) are the reference's exactly, for
  every config and shape.
* The ring model's wire bytes equal ``repro.roofline.analysis.
  parse_collectives`` on synthetic HLO lines (all-reduce, all-gather,
  all-to-all, collective-permute) at groups of 2, 4 and 16.
* The counter's FLOPs equal ``FlopCounterMode``'s on the reduced LLaMA
  prefill, dense decode step and train step on the CPU (where the
  kernels run as their plain versions, whose products both count); a
  product's, a view's and an in-place add's bytes are checked by hand.
* The meta count of the reduced LLaMA prefill against
  ``repro.roofline.hlo_cost`` of the JAX prefill lowered on the CPU:
  they part by exactly what the two attention walks imply (the JAX
  prefill's plain attention multiplies every query-key pair of a
  layer, masked or not; the port's flash kernel is counted by its
  visible causal pairs).
* ``kernels/cost.py`` gives ``PERF.md``'s bound column for rows 1, 1a,
  2, 3, 4, 5, 6, 7 and 7a to its printed digits.
* A kv_seq decode step's collectives on an abstract ``1 x n`` mesh (n =
  4, 16, and a ``2 x 16 x 16`` production mesh's model axis) carry the
  payloads a rank's shapes give, by hand: the q/k/v gather's whole
  columns, the merge's gathered log-sum-exps (one f32 a query row and
  rank) and its f32 output all-reduce, the f32 row-parallel sums, the
  embedding's and the logits' gathers; the wire bytes are the ring
  model's over the model axis; the partial mode's kernel cost counts an
  f32 ``o`` and one f32 log-sum-exp a row.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.kv_layout import pick_group  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.hw import H100  # noqa: E402
from repro_torch.roofline.op_cost import OpCounter  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

torch.set_num_threads(2)


# -- (a) the analytic FLOPs and the cells -------------------------------------


@pytest.mark.parametrize("arch", t_configs.ALL_ARCHS)
def test_model_flops_for_matches_reference(arch):
    for name in t_configs.SHAPES:
        mine = analysis.model_flops_for(t_configs.get_config(arch),
                                        t_configs.get_shape(name))
        theirs = j_analysis.model_flops_for(j_configs.get_config(arch),
                                            j_configs.get_shape(name))
        assert mine == theirs, (arch, name)


def test_cells_and_shapes_match_reference():
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert t_configs.all_cells() == j_configs.all_cells()
    assert list(t_configs.SHAPES) == list(j_configs.SHAPES)
    for name in j_configs.SHAPES:
        assert dataclasses.asdict(t_configs.get_shape(name)) == \
            dataclasses.asdict(j_configs.get_shape(name))
    assert sorted(t_configs.__all__) == sorted(j_configs.__all__)


# -- (c) the ring model -------------------------------------------------------

_HLO = {
    "all_reduce": "  %ar = f32[{n}] all-reduce(f32[{n}] %p), "
                  "replica_groups={{{g}}}, to_apply=%sum",
    "all_gather": "  %ag = bf16[{n}] all-gather(bf16[{m}] %p), "
                  "replica_groups={{{g}}}, dimensions={{0}}",
    "all_to_all": "  %a2a = f32[{n}] all-to-all(f32[{n}] %p), "
                  "replica_groups={{{g}}}, dimensions={{0}}",
    "send_recv": "  %cp = f32[{n}] collective-permute(f32[{n}] %p), "
                 "source_target_pairs={{{{0,1}}}}",
}
_ESZ = {"all_reduce": 4, "all_gather": 2, "all_to_all": 4, "send_recv": 4}


@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("op", sorted(_HLO))
def test_wire_bytes_match_parse_collectives(op, group):
    n = 4096 * group
    line = _HLO[op].format(n=n, m=n // group,
                           g=",".join(map(str, range(group))))
    stats = j_analysis.parse_collectives(line, default_group=group)
    assert sum(stats.counts.values()) == 1
    payload = n * _ESZ[op]
    assert stats.total_payload() == payload
    assert analysis.wire_bytes(op, payload, group) == stats.wire_bytes


def test_wire_bytes_of_one_rank_are_zero():
    for op in _HLO:
        assert analysis.wire_bytes(op, 1024, 1) == 0.0


# -- (d) the counter against FlopCounterMode, and single ops by hand ----------


def _llama():
    cfg = t_configs.get_reduced("llama-30b").replace(dtype="float32")
    return cfg, t_tf.init_params(cfg, device="cpu", dtype=torch.float32)


def _both(fn):
    """(OpCounter result, FlopCounterMode total) of ``fn()`` run once
    under each."""
    with OpCounter() as c:
        fn()
    with FlopCounterMode(display=False) as fc:
        fn()
    return c.result(), fc.get_total_flops()


def test_op_cost_flops_match_flop_counter_on_the_cpu():
    cfg, params = _llama()
    api = build(cfg)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(1, 256, (2, 16)))
    cache = t_tf.init_cache(cfg, 2, 32, torch.float32, device="cpu")
    batch = {"tokens": toks, "targets": toks}
    step = opt.make_train_step(api, opt.AdamWConfig())
    state = opt.adamw_init(params)
    runs = {"prefill": lambda: api.prefill(params, {"tokens": toks},
                                           max_seq=32),
            "decode": lambda: api.decode(params, cache, toks[:, :1]),
            "train": lambda: step(params, state, batch)}
    for name, fn in runs.items():
        counted, flops = _both(fn)
        assert flops > 0
        assert counted["flops"] == flops, name
        assert counted["by_class"]["matmul"]["flops"] == flops, name
    # the kernels were counted as calls; their plain versions' products
    # are what the CPU ran
    counted, _ = _both(runs["decode"])
    assert counted["kernels"] == {"rmsnorm": 1, "decode_attention": 2,
                                  "add_rmsnorm": 4}
    assert "kernel" not in counted["by_class"]


def test_single_ops_bytes_by_hand():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    x, y = torch.randn(32), torch.randn(32)
    with OpCounter() as c:
        a @ b
    r = c.result()
    assert r["flops"] == 2 * 8 * 4 * 16
    assert r["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    with OpCounter() as c:
        a.view(16, 8).t()
    assert c.result()["bytes"] == 0 and c.result()["flops"] == 0
    with OpCounter() as c:
        x.add_(y)
    # reads x and y, writes x once
    assert c.result()["bytes"] == 3 * 4 * 32
    assert c.result()["peak_bytes"] == 0          # nothing allocated
    with OpCounter() as c:
        z = x + y
        del z
        w = x * y
    assert c.result()["peak_bytes"] == 4 * 32 and w.shape == (32,)


def test_op_cost_raises_on_uncounted_products():
    q = torch.randn(1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="does not count"):
        with OpCounter():
            torch.nn.functional.scaled_dot_product_attention(q, q, q)


# -- (e) the meta count against the reference's HLO walk ----------------------


def test_meta_prefill_flops_against_the_reference_hlo():
    jcfg = j_configs.get_reduced("llama-30b").replace(dtype="float32")
    cfg = t_configs.get_reduced("llama-30b").replace(dtype="float32")
    B, S = 2, 16
    japi = j_build(jcfg)
    jparams = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    text = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_seq=S)
                   ).lower(jparams, toks).compile().as_text()
    theirs = hlo_cost.analyze_text(text).flops

    params = t_tf.init_params(cfg, device="meta", dtype=torch.float32)
    with OpCounter() as c:
        build(cfg).prefill(params, {"tokens": torch.empty(
            (B, S), dtype=torch.int32, device="meta")}, max_seq=S)
    mine = c.result()
    assert mine["kernels"]["flash_attention"] == cfg.num_layers
    # every product but attention is the same on both sides
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    attn_jax = L * 4 * B * H * S * S * hd           # every (q, k) pair
    attn_port = L * 4 * hd * H * B * S * (S + 1) // 2   # causal pairs
    assert mine["kernel_cost"]["flash_attention"]["flops"] == attn_port
    # hlo_cost counts dots only: the port's products plus its attention
    # kernel (the norm kernels' elementwise FLOPs left out)
    dots = mine["by_class"]["matmul"]["flops"] + attn_port
    assert theirs - dots == attn_jax - attn_port
    assert theirs - dots == L * 4 * hd * H * B * S * (S - 1) // 2


# -- (g) the kernels' bound column ---------------------------------------------


def _bound_ms(flops, nbytes, peak):
    return max(nbytes / H100.hbm_bw, flops / peak) * 1e3


def _digits(x, printed):
    """``x`` to ``printed``'s number of digits after the point."""
    places = len(printed.split(".")[1])
    return f"{round(x, places):.{places}f}"


F32_PEAK = 67e12                  # chip_smoke.py: F32_FLOP_PER_S
BF16, F32 = torch.bfloat16, torch.float32
I32, U8 = torch.int32, torch.uint8


def _pages(Hkv, hd, ps=16, W=16, B=4):
    g = pick_group(Hkv * hd)
    R, P = ps * (Hkv * hd // g), B * W + 1
    return [(P, R, g // 2), (P, R, 1), (P, R, 1)], [U8, F32, F32]


def test_kernel_costs_give_the_perf_bound_column():
    """Rows of PERF.md's kernel table at LLaMA-30B's shapes (phase 3):
    the wire of a 256-token bucket (1,597,440 rows of 128), a 4-slot
    decode step (kv_len 232/123/56/17 over 16 pages of 16), the 4 x 256
    bucket, 1,024 and 4 rows of 6,656."""
    N = 2 * 60 * 256 * 52
    tri, tri_t = _pages(52, 128)
    kl = [232, 123, 56, 17]
    q = (4, 52, 1, 128)
    rows = {
        "1": (cost.kv_quant([(N, 128)], [BF16]), F32_PEAK, "0.156"),
        "1a": (cost.kv_quant_append([(4, 1, 52, 128)] * 2 + tri + tri
                                    + [(4, 16), (4,)],
                                    [BF16] * 2 + tri_t + tri_t + [I32] * 2),
               F32_PEAK, "0.00004"),
        "2": (cost.kv_dequant([(N, 64), (N, 1), (N, 1)], [U8, F32, F32]),
              F32_PEAK, "0.156"),
        "3": (cost.paged_decode_attention_int4(
            [q] + tri + tri + [(4, 16), (4,)],
            [BF16] + tri_t + tri_t + [I32] * 2, page_size=16, kv_len=kl),
            F32_PEAK, "0.00099"),
        "4": (cost.paged_decode_attention_bf16(
            [q, (65, 16, 52, 128), (65, 16, 52, 128), (4, 16), (4,)],
            [BF16, BF16, BF16, I32, I32], page_size=16, kv_len=kl),
            H100.peak_flops, "0.00343"),
        "5": (cost.flash_attention([(4, 256, 52, 128)] * 3, [BF16] * 3),
              H100.peak_flops, "0.0163"),
        "6": (cost.decode_attention(
            [q, (4, 52, 256, 128), (4, 52, 256, 128), (4,)],
            [BF16, BF16, BF16, I32], kv_len=kl), H100.peak_flops,
            "0.00343"),
        "7": (cost.rmsnorm([(1024, 6656), (6656,)], [BF16, F32]),
              H100.peak_flops, "0.0081"),
        "7 (4 rows)": (cost.rmsnorm([(4, 6656), (6656,)], [BF16, F32]),
                       H100.peak_flops, "0.00004"),
        "7a": (cost.add_rmsnorm([(4, 6656)] * 2 + [(6656,)],
                                [BF16, BF16, F32]), H100.peak_flops,
               "0.00007"),
        "7a (bucket)": (cost.add_rmsnorm([(1024, 6656)] * 2 + [(6656,)],
                                         [BF16, BF16, F32]),
                        H100.peak_flops, "0.0163"),
    }
    for row, ((flops, nbytes), peak, printed) in rows.items():
        assert _digits(_bound_ms(flops, nbytes, peak), printed) == printed, \
            row
    # row 1: 523.9 MB of bytes, bound by them
    flops, nbytes = rows["1"][0]
    assert f"{nbytes / 1e6:.1f}" == "524.0" and nbytes / H100.hbm_bw > \
        flops / F32_PEAK
    assert math.isclose(nbytes, 523_960_320)


def test_kernel_costs_count_every_row_when_the_data_is_unknown():
    q = (4, 52, 1, 128)
    known = cost.decode_attention([q, (4, 52, 256, 128), (4, 52, 256, 128),
                                   (4,)], [BF16, BF16, BF16, I32],
                                  kv_len=[256] * 4)
    assert cost.decode_attention([q, (4, 52, 256, 128), (4, 52, 256, 128),
                                  (4,)], [BF16, BF16, BF16, I32]) == known
    full = cost.flash_attention([(2, 8, 4, 16), (2, 24, 4, 16),
                                 (2, 24, 4, 16)], [F32] * 3,
                                prefix_len=[16, 16])
    assert cost.flash_attention([(2, 8, 4, 16), (2, 24, 4, 16),
                                 (2, 24, 4, 16)], [F32] * 3,
                                prefix_len="unknown") == full


def test_analyze_terms():
    counted = {"flops": 989e9, "bytes": 6.7e9, "coll_wire": 450e9 * 0.002,
               "coll_payload": 1, "coll_counts": {"all_reduce": 1}}
    r = analysis.analyze(counted, arch="a", shape="decode_32k",
                         mesh_desc="one", n_chips=1, model_flops=494.5e9,
                         memory={"arg": 10, "temp": 5, "out": 2})
    assert math.isclose(r.compute_s, 1e-3)
    assert math.isclose(r.memory_s, 2e-3)
    assert math.isclose(r.collective_s, 2e-3)
    assert r.bottleneck == "memory" and math.isclose(r.step_s, 2e-3)
    assert math.isclose(r.useful_ratio, 0.5)
    assert r.memory_estimate_bytes == 15 and r.per_device_output_bytes == 2
    assert set(r.to_json()) == set(j_analysis.Roofline.__dataclass_fields__)


# -- (h) the kv_seq decode step's collectives ----------------------------------


@pytest.mark.parametrize("shape", [(1, 4), (1, 16), (2, 16, 16)])
def test_kv_seq_decode_collectives_by_hand(shape):
    from repro_torch.launch.mesh import abstract_mesh
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    mesh = abstract_mesh(shape, axes)
    n = shape[-1]
    # 52 heads over 16 run gathered; over 4 they split (kv_seq asked for)
    cfg = t_configs.get_config("llama-30b").replace(num_layers=2)
    api = build(cfg, rt=t_tf.Runtime(mesh, kv_seq=True))
    params = t_tf.init_params(cfg, device="meta", mesh=mesh)
    B = 4
    cache = t_tf.init_cache(api.local_cfg, B, 4096, device="meta")
    assert cache["slot0"]["k"].shape == (2, B, 4096 // n, 52, 128)
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    with OpCounter() as c:
        api.decode(params, cache, tok)
    r = c.result()
    L, d, V, H, hd = cfg.num_layers, cfg.d_model, cfg.vocab_size, 52, 128
    qkv = B * 3 * cfg.q_dim * 2            # the gathered columns, bf16
    lse = n * B * H * 4                     # every rank's, f32
    merged = B * H * hd * 4                 # the weighted o, f32
    rows = B * d * 4                        # a row-parallel sum, f32
    gathers = L * (qkv + lse) + B * d * 2 + B * V * 2
    reduces = L * (merged + 2 * rows)
    assert r["coll_counts"] == {"all_gather": 2 * L + 2,
                                "all_reduce": 3 * L}
    assert r["coll_payload"] == gathers + reduces
    assert r["coll_wire"] == pytest.approx(
        analysis.wire_bytes("all_gather", gathers, n)
        + analysis.wire_bytes("all_reduce", reduces, n))
    assert r["kernels"] == {"rmsnorm": 1, "add_rmsnorm": 2 * L,
                            "decode_attention_lse": L}
    q = torch.empty((B, H, 1, hd), dtype=torch.float32)
    kv = torch.empty((B, H, 4096 // n, hd), dtype=torch.bfloat16)
    flops, nbytes = cost.of("decode_attention_lse", q, kv, kv,
                            torch.empty((B,), dtype=torch.int32))
    plain_f, plain_b = cost.of("decode_attention", q, kv, kv,
                               torch.empty((B,), dtype=torch.int32))
    assert flops == plain_f and nbytes == plain_b + 4 * B * H
