"""The port's MoE layer (``repro_torch.models.moe``) and the q/k norms
against the JAX package (CPU, reduced configs in float32, inputs from a
numpy seed).

* ``route``: expert index, position in the expert, keep flags, gates and
  the aux loss equal to ``repro.models.moe.route`` index for index, with
  and without dropped routes, and on a right-padded bucket batch whose
  padding rows take capacity as the reference's do; ties go to the lower
  expert, as ``lax.top_k`` does.
* ``moe_apply`` within 1e-4 of the reference's for qwen3-moe (top-2) and
  llama4-maverick (top-1 plus a shared expert), drops included, and the
  dropped routes counted by ``count_drops``.
* ``params_from_numpy`` on llama4's two-slot stack (a dense layer, then
  a MoE layer with its shared expert), and qwen3's q/k norms in
  ``attn_qkv``.
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
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ATOL = 1e-4
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        tcfg = get_reduced(arch).replace(dtype="float32")
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            j_build(jcfg).init(jax.random.PRNGKey(0)))
        _MODELS[arch] = (jcfg, tree, tcfg,
                         convert.params_from_numpy(tree, tcfg, "cpu"))
    return _MODELS[arch]


def _moe_slot(tree):
    """(slot name, its stacked ``moe`` params) of the first MoE slot."""
    name = next(s for s in sorted(tree["blocks"])
                if "moe" in tree["blocks"][s])
    return name, tree["blocks"][name]["moe"]


def _x(T, d, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((T, d))
            * scale).astype(np.float32)


def _route_both(arch, x, capacity):
    jcfg, tree, tcfg, _ = _model(arch)
    _, m = _moe_slot(tree)
    router = m["router"][0]
    want = j_moe.route(jcfg, jnp.asarray(router), jnp.asarray(x), capacity)
    got = t_moe.route(tcfg, torch.from_numpy(np.array(router)),
                      torch.from_numpy(x), capacity)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_route_equal(want, got):
    for name, a, b in zip(("idx", "pos", "keep"), want[:3], got[:3]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(want[4], got[4], rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity", [32, 5])
def test_route_matches_jax(arch, capacity):
    """64 tokens: capacity 32 keeps every route; capacity 5 drops some,
    the later choices and later tokens first."""
    x = _x(64, _model(arch)[2].d_model, seed=capacity, scale=2.0)
    want, got = _route_both(arch, x, capacity)
    _assert_route_equal(want, got)
    dropped = int((~got[2]).sum())
    assert (dropped > 0) == (capacity == 5), dropped


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities (a zero token: every logit 0) keep the lower
    experts first, as ``lax.top_k``; positions count choice-major."""
    arch = MOE_ARCHS[0]
    x = np.zeros((6, _model(arch)[2].d_model), np.float32)
    want, got = _route_both(arch, x, 4)
    _assert_route_equal(want, got)
    np.testing.assert_array_equal(got[0], np.tile([0, 1], (6, 1)))
    assert got[1][:, 0].tolist() == [0, 1, 2, 3, 4, 5]
    assert got[2].sum() == 8


@pytest.mark.parametrize("T", [1, 4, 31, 32, 33, 64, 1024])
def test_capacity_is_the_reference_formula(T):
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        E, k, cf = cfg.moe_num_experts, cfg.moe_top_k, \
            cfg.moe_capacity_factor
        assert t_moe.capacity_of(cfg, T) == max(
            min(T, 32), int(math.ceil(T * k * cf / E)))


def _moe_both(arch, x):
    """The reference's and the port's ``moe_apply`` on ``x (B, S, d)``
    with layer 0 of the first MoE slot; the port's drop count too."""
    jcfg, tree, tcfg, tp = _model(arch)
    name, _ = _moe_slot(tree)
    layer = next(i for i, p in enumerate(tp["layers"]) if "moe" in p)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["blocks"][name]["moe"])
    yj, auxj = j_moe.moe_apply(jcfg, jp, jnp.asarray(x))
    with t_moe.count_drops() as drops:
        yt, auxt = t_moe.moe_apply(tcfg, tp["layers"][layer]["moe"],
                                   torch.from_numpy(x))
    assert len(drops) == 1
    return (np.asarray(yj), float(auxj)), (yt.numpy(), float(auxt)), \
        int(drops[0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("skewed", [False, True])
def test_moe_apply_matches_jax(arch, skewed):
    """A (2, 24) batch: independent tokens spread over the experts and
    drop nothing; tokens near one shared vector all pick the same experts,
    past the 32-row capacity, and the dropped routes' outputs (zero, or
    the shared expert's) match too."""
    d = _model(arch)[2].d_model
    x = _x(48, d, seed=int(skewed))
    if skewed:
        x = _x(1, d, seed=9) + 0.05 * x
    x = x.reshape(2, 24, d)
    (yj, aj), (yt, at), dropped = _moe_both(arch, x)
    np.testing.assert_allclose(yj, yt, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(aj, at, rtol=1e-5)
    assert (dropped > 0) == skewed, dropped


def test_padding_rows_take_capacity_as_in_the_reference():
    """A prompt right-padded into a bucket batch (the engine's padding:
    token 0 rows, and a dummy batch row) routes all ``B * S`` tokens: the
    padding's routes fill capacity and push out the prompt's, as they do
    in the reference, so the prompt's rows differ from its rows routed
    alone."""
    arch = MOE_ARCHS[0]
    _, _, tcfg, _ = _model(arch)
    d = tcfg.d_model
    rng = np.random.default_rng(4)
    prompt = rng.standard_normal((1, 10, d)).astype(np.float32)
    pad_row = np.full((d,), 3.0, np.float32)    # one embedding, repeated
    x = np.broadcast_to(pad_row, (2, 64, d)).copy()
    x[0, :10] = prompt[0]
    (yj, _), (yt, _), dropped = _moe_both(arch, x)
    np.testing.assert_allclose(yj, yt, atol=ATOL, rtol=ATOL)
    assert dropped > 0
    (alone, _), _, none = _moe_both(arch, prompt)
    assert none == 0
    assert not np.allclose(alone[0], yt[0, :10], atol=ATOL)


def test_moe_apply_adds_the_choices_in_choice_order():
    """Each token's k expert outputs are gathered and summed in choice
    order: the output equals that sum done by hand from the capacity
    buffer's rows, bit for bit (no accumulation order left to atomics)."""
    arch = MOE_ARCHS[0]
    _, _, tcfg, tp = _model(arch)
    p = tp["layers"][0]["moe"]
    x = torch.from_numpy(_x(12, tcfg.d_model, seed=5)).reshape(3, 4, -1)
    y, _ = t_moe.moe_apply(tcfg, p, x)
    C = t_moe.capacity_of(tcfg, 12)
    idx, pos, keep, gates, _ = t_moe.route(tcfg, p["router"],
                                           x.reshape(12, -1), C)
    assert bool(keep.all())
    want = torch.zeros((12, tcfg.d_model))
    for c in range(tcfg.moe_top_k):
        buf = torch.zeros((tcfg.moe_num_experts, C, tcfg.d_model))
        buf[idx.reshape(-1), pos.reshape(-1)] = x.reshape(12, -1).repeat_interleave(
            tcfg.moe_top_k, 0)
        out = t_moe._expert_ffn(tcfg, p["wi"], p["wo"], buf)
        want = want + out[idx[:, c], pos[:, c]] * gates[:, c:c + 1]
    assert torch.equal(y.reshape(12, -1), want)


def test_params_from_numpy_reads_llama4s_two_slots():
    """llama4's period-2 stack: layer i is slot i % 2, index i // 2; slot 0
    a dense MLP, slot 1 the MoE with its shared expert; every tensor
    carried over exactly."""
    jcfg, tree, tcfg, tp = _model(MOE_ARCHS[1])
    assert t_tf.period_of(tcfg) == 2
    assert t_tf.slot_kinds(tcfg) == ("attn+mlp", "attn+moe")
    assert sorted(tree["blocks"]) == ["slot0", "slot1"]
    assert len(tp["layers"]) == tcfg.num_layers == 2
    dense, sparse = tp["layers"]
    assert "mlp" in dense and "moe" not in dense
    assert "moe" in sparse and "mlp" not in sparse
    assert sorted(sparse["moe"]) == ["router", "shared", "wi", "wo"]
    slot1 = tree["blocks"]["slot1"]
    for name in ("router", "wi", "wo"):
        np.testing.assert_array_equal(sparse["moe"][name].numpy(),
                                      slot1["moe"][name][0])
    for name in ("wi", "wo"):
        np.testing.assert_array_equal(
            sparse["moe"]["shared"][name].numpy(),
            slot1["moe"]["shared"][name]["w"][0])
        np.testing.assert_array_equal(
            dense["mlp"][name].numpy(),
            tree["blocks"]["slot0"]["mlp"][name]["w"][0])
    assert sparse["moe"]["router"].dtype == torch.float32


def test_params_from_numpy_refuses_slots_that_do_not_stack():
    _, tree, tcfg, _ = _model(MOE_ARCHS[1])
    with pytest.raises(ValueError, match="do not stack"):
        convert.params_from_numpy(tree, tcfg.replace(num_layers=3), "cpu")


def test_qk_norm_matches_jax_attn_qkv():
    """qwen3's per-head RMSNorm of q and k before RoPE, with non-zero
    scales, against the reference's ``attn_qkv``."""
    jcfg, tree, tcfg, tp = _model(MOE_ARCHS[0])
    assert tcfg.qk_norm
    rng = np.random.default_rng(2)
    attn = jax.tree.map(lambda a: a[0], tree["blocks"]["slot0"]["attn"])
    attn["qnorm"]["scale"] = rng.standard_normal(tcfg.head_dim).astype(
        np.float32)
    attn["knorm"]["scale"] = rng.standard_normal(tcfg.head_dim).astype(
        np.float32)
    mine = dict(tp["layers"][0]["attn"])
    mine["qnorm"] = torch.from_numpy(attn["qnorm"]["scale"])
    mine["knorm"] = torch.from_numpy(attn["knorm"]["scale"])
    x = _x(2 * 5, tcfg.d_model, seed=3).reshape(2, 5, -1)
    pos = np.broadcast_to(np.arange(5) + 3, (2, 5)).astype(np.int32)
    want = j_layers.attn_qkv(jcfg, jax.tree.map(jnp.asarray, attn),
                             jnp.asarray(x), jnp.asarray(pos))
    got = t_layers.attn_qkv(tcfg, mine, torch.from_numpy(x),
                            torch.from_numpy(pos))
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
    plain = t_layers.attn_qkv(tcfg.replace(qk_norm=False), mine,
                              torch.from_numpy(x), torch.from_numpy(pos))
    assert not torch.allclose(plain[0], got[0], atol=1e-3)


def test_cli_refuses_a_config_the_card_cannot_hold(monkeypatch):
    """``launch.serve --arch qwen3-moe-235b-a22b`` on an 80 GB card stops
    before any weight is made, with the bytes the full config needs;
    the config cut to 8 layers (``run(cfg=...)``, as the smoke serves
    it) fits."""
    from types import SimpleNamespace

    from repro_torch.launch import serve as t_serve
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=80 * 10**9))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "card")
    for arch in MOE_ARCHS:
        need = 2 * get_config(arch).param_count()
        with pytest.raises(ValueError, match=f"{need:,} bytes"):
            t_serve.run(["--arch", arch])
    t_serve.check_fits(get_config(MOE_ARCHS[0]).replace(num_layers=8),
                       "cuda")
    t_serve.check_fits(get_config("llava-next-mistral-7b"), "cuda")
