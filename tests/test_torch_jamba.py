"""The port's jamba runs the published Jamba block (CPU, reduced config in
float32, the port's own weights; nothing here needs the JAX package):

* The Mamba state a prefill hands decode is the one after the prompt's
  last step (ROADMAP C.4, C.5): at 600 and 1,100 tokens, more than the
  512-step chunk and no multiple of it, ``mamba_apply``'s outputs and
  state equal the step-by-step recurrence (``mamba_decode_step`` over the
  prompt) and its own call in one chunk, and a whole model's prefill
  followed by decode steps gives the logits of decoding the prompt token
  by token (within 1e-5 of the largest, f32 rounding: the chunked scan
  adds in another order).
* The mixer's inner norms: the time-step input, B and C after ``x_proj``
  are plain RMSNorms at gain 1 (eps 1e-6).
* Routing: the gates are the softmax's top 2 as they come, and with every
  router at zero (all tokens tie, so all go to experts 0 and 1) no route
  is dropped and a prompt's logits are the same alone and beside
  batch-mates; at the JAX package's capacity factor both fail, which is
  what the check can see.
* xLSTM's mLSTM pads its last prefill chunk, which moves the stabiliser
  ``m`` of the state it hands on but not the state it stands for: decode
  steps after a 100-token prompt (chunks of 8) give the step-by-step
  recurrence's outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import jax_block  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import build, mamba, moe, xlstm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"
TOL = 1e-5
_MODEL = {}


def _model():
    if not _MODEL:
        cfg = get_reduced(ARCH).replace(dtype="float32")
        _MODEL["m"] = (cfg, tf.init_params(cfg, device="cpu",
                                           dtype=torch.float32))
    return _MODEL["m"]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _mamba_layer():
    cfg, params = _model()
    return cfg, next(p["mamba"] for p in params["layers"] if "mamba" in p)


@pytest.mark.parametrize("S", [600, 1100])
def test_mamba_state_is_the_one_after_the_prompt(S):
    cfg, p = _mamba_layer()
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(S))
    with torch.no_grad():
        out, (conv, h) = mamba.mamba_apply(cfg, p, x)
        one, (_, h_one) = mamba.mamba_apply(cfg, p, x, chunk=S)
        st = mamba.mamba_state_init(cfg, 2, dtype=torch.float32,
                                    device="cpu")
        ys = []
        for t in range(S):
            y, st = mamba.mamba_decode_step(cfg, p, x[:, t:t + 1], st)
            ys.append(y)
    assert _rel(out, torch.cat(ys, 1)) < TOL
    assert _rel(h, st[1]) < TOL and _rel(h, h_one) < TOL
    assert _rel(conv, st[0]) < TOL


def _prefill_then_decode(cfg, params, prompt, follow, max_seq):
    """Logits of the prompt's last position from the model's prefill, then
    one decode step a token of ``follow`` from the prefill's cache laid
    into an f32 decode cache of ``max_seq`` rows (the engines' dense cache
    holds K/V in bf16, whose rounding ``perfbench/test_perfbench_jamba.py``
    allows for)."""
    S = len(prompt)
    cache = tf.init_cache(cfg, 1, max_seq, torch.float32, device="cpu")
    with torch.no_grad():
        logits, got = build(cfg).prefill(params, {"tokens": torch.as_tensor(
            prompt[None].astype(np.int64))}, max_seq=max_seq)
        for slot, leaves in got.items():
            if slot == "lengths":
                cache["lengths"].copy_(leaves)
                continue
            for key, t in leaves.items():
                if key in ("k", "v"):
                    cache[slot][key][:, :, :S] = t
                else:
                    cache[slot][key].copy_(t)
        rows = [logits[0, -1]]
        for t in follow:
            lg, cache = tf.decode_step(cfg, params, cache,
                                       torch.tensor([[int(t)]]))
            rows.append(lg[0, -1])
    return torch.stack(rows)


def _token_by_token(cfg, params, tokens, n_read, max_seq):
    """The logits of the last ``n_read`` positions, decoding every token
    from an empty cache."""
    cache = tf.init_cache(cfg, 1, max_seq, tf.cache_dtype(cfg),
                          device="cpu")
    rows = []
    with torch.no_grad():
        for i, t in enumerate(tokens):
            lg, cache = tf.decode_step(cfg, params, cache,
                                       torch.tensor([[int(t)]]))
            if i >= len(tokens) - n_read:
                rows.append(lg[0, -1])
    return torch.stack(rows)


@pytest.mark.parametrize("S", [600, 1100])
def test_prefill_then_decode_is_decoding_token_by_token(S):
    cfg, params = _model()
    rng = np.random.default_rng(S)
    prompt = rng.integers(1, cfg.vocab_size, S)
    follow = rng.integers(1, cfg.vocab_size, 4)
    got = _prefill_then_decode(cfg, params, prompt, follow, 1200)
    want = _token_by_token(cfg, params, np.concatenate([prompt, follow]),
                           len(follow) + 1, 1200)
    assert _rel(got, want) < TOL


def test_inner_norms_are_unit_gain_rmsnorms():
    cfg, p = _mamba_layer()
    assert cfg.mamba_inner_norms
    xc = torch.randn(2, 9, cfg.mamba_d_inner,
                     generator=torch.Generator().manual_seed(3))
    dA, dBx, Cm = mamba._selective_terms(cfg, p, xc)

    def norm(t):
        return t / torch.sqrt(t.square().mean(-1, keepdim=True) + 1e-6)

    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    dt_r, Bm, C = torch.split(xc @ p["x_proj"], [dtr, ds, ds], dim=-1)
    dt = torch.nn.functional.softplus(norm(dt_r) @ p["dt_proj"]
                                      + p["dt_proj_b"])
    assert _rel(Cm, norm(C)) < TOL
    assert _rel(dA, torch.exp(dt[..., None] * -torch.exp(p["A_log"]))) < TOL
    assert _rel(dBx, (dt * xc)[..., None] * norm(Bm)[..., None, :]) < TOL
    off = mamba._selective_terms(cfg.replace(mamba_inner_norms=False), p,
                                 xc)[2]
    assert _rel(off, C) < TOL and _rel(Cm, C) > 0.1


def _moe_layer():
    cfg, params = _model()
    return cfg, next(p["moe"] for p in params["layers"] if "moe" in p)


def test_gates_are_the_softmax_top_k_as_they_come():
    cfg, p = _moe_layer()
    assert not cfg.moe_renormalize
    x = torch.randn(40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    idx, _, _, gates, _ = moe.route(cfg, p["router"], x, 40)
    probs = torch.softmax(x @ p["router"], dim=-1)
    top = torch.topk(probs, cfg.moe_top_k, dim=-1)
    assert torch.equal(idx, top.indices)
    assert _rel(gates, top.values) < TOL
    assert float(gates.sum(-1).max()) < 1.0


def _zero_routers(params):
    """``params`` with every router at zero: each token's probabilities
    tie, so every token picks experts 0 and 1."""
    out = dict(params, layers=[dict(p) for p in params["layers"]])
    for p in out["layers"]:
        if "moe" in p:
            p["moe"] = dict(p["moe"], router=torch.zeros_like(
                p["moe"]["router"]))
    return out


@pytest.mark.parametrize("jax_capacity", [False, True])
def test_no_route_is_dropped_under_a_skewed_router(jax_capacity):
    cfg, p = _moe_layer()
    if jax_capacity:
        cfg = jax_block(cfg)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    with moe.count_drops() as drops, torch.no_grad():
        moe.moe_apply(cfg, dict(p, router=torch.zeros_like(p["router"])), x)
    assert (int(drops[0]) > 0) == jax_capacity


@pytest.mark.parametrize("jax_capacity", [False, True])
def test_a_prompts_logits_do_not_depend_on_its_batch_mates(jax_capacity):
    cfg, params = _model()
    if jax_capacity:
        cfg = jax_block(cfg)
    params = _zero_routers(params)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, 48)))
    api = build(cfg)
    with torch.no_grad():
        alone, _ = api.prefill(params, {"tokens": toks[:1]}, max_seq=64)
        mates, _ = api.prefill(params, {"tokens": toks.flip(0)},
                               max_seq=64)
    assert (_rel(mates[-1, -1], alone[0, -1]) < TOL) != jax_capacity


def test_mlstm_state_after_a_short_last_chunk_decodes_as_stepwise():
    cfg = get_reduced("xlstm-125m").replace(dtype="float32")
    params = tf.init_params(cfg, device="cpu", dtype=torch.float32)
    p = next(q["mlstm"] for q in params["layers"] if "mlstm" in q)
    g = torch.Generator().manual_seed(7)
    S = 100
    assert S % cfg.xlstm_chunk
    x = torch.randn(2, S, cfg.d_model, generator=g)
    with torch.no_grad():
        _, (st, conv) = xlstm.mlstm_apply(cfg, p, x)
        ref, ref_conv = xlstm.mlstm_state_init(cfg, 2, "cpu"), None
        for t in range(S):
            _, ref, ref_conv = xlstm.mlstm_decode_step(
                cfg, p, x[:, t:t + 1], ref, ref_conv)
    # the padding moves the stabiliser, not the state it stands for
    (C, n, m), (Cr, nr, mr) = st, ref
    assert float((m - mr).abs().max()) > 1e-2
    assert _rel(C * m.exp()[..., None, None], Cr * mr.exp()[..., None, None]
                ) < TOL
    assert _rel(n * m.exp()[..., None], nr * mr.exp()[..., None]) < TOL
    with torch.no_grad():
        for _ in range(16):
            xn = torch.randn(2, 1, cfg.d_model, generator=g)
            a, st, conv = xlstm.mlstm_decode_step(cfg, p, xn, st, conv)
            b, ref, ref_conv = xlstm.mlstm_decode_step(cfg, p, xn, ref,
                                                       ref_conv)
            assert _rel(a, b) < TOL
