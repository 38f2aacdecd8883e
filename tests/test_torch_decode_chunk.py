"""What the graphed decode chunk relies on, held on the CPU (reduced
LLaMA-30B, f32).

* RoPE tables built once per model call: every prefill, suffix prefill and
  decode step (dense, int4 pages, bf16 pages) computes ``rope_table`` once
  and gives every layer's q and k the same table, and its logits and cache
  are byte for byte those of the per-call rotation (each ``apply_rope``
  building its own table, 2L tables a call). ``apply_rope`` with a table
  equals ``apply_rope`` without one and the JAX package's, for partial
  rotary dims and for NoPE.
* Cache identity: a CUDA graph reads fixed addresses, so every tensor of a
  decode engine's cache stays the same object through admissions (fresh,
  prefix hit with copy-on-write, migrated), chunks, ``step_reference()``
  and releases, on each decode cache; the eager chunk returns the cache it
  was given.
* On the CPU there is no graph: ``cuda_graph=True`` leaves the eager loop,
  and ``jit_cache_size`` is 0 for both engines.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as j_layers  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import paged as t_paged  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

PS = 8
PATHS = ["prefill", "suffix", "dense", "int4", "bf16"]
MODES = {"int4": {"page_size": PS, "prefix_sharing": True},
         "bf16": {"page_size": PS, "prefix_sharing": True,
                  "kv_resident": "bf16"},
         "dense": {"paged": False}}


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("llama-30b").replace(dtype="float32")
    return cfg, t_tf.init_params(cfg, seed=3, device="cpu",
                                 dtype=torch.float32)


def _call(cfg, params, path):
    """One model call of ``path`` on fixed inputs; returns its logits and
    every tensor of the cache it wrote."""
    L = cfg.num_layers
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 8))).long()
    if path == "prefill":
        logits, cache = t_tf.prefill(cfg, params, toks, max_seq=8)
    elif path == "suffix":
        shape = (L, 2, 4, cfg.num_kv_heads, cfg.head_dim)
        gen = torch.Generator().manual_seed(5)
        logits, cache = t_tf.prefill_suffix(
            cfg, params, toks, {"slot0": (torch.randn(shape, generator=gen),
                                          torch.randn(shape, generator=gen))},
            torch.tensor([4, 2], dtype=torch.int32), max_seq=8)
    else:
        if path == "dense":
            cache = t_tf.init_cache(cfg, 2, 16, torch.float32, device="cpu")
        else:
            cache = t_paged.init_paged_cache(cfg, 2, 16, 5, page_size=PS,
                                             resident=path, device="cpu")
            cache["page_table"][:, :2] = torch.tensor([[1, 2], [3, 4]])
        cache["lengths"][:] = torch.tensor([3, 9])
        step = t_tf.decode_step if path == "dense" else \
            lambda *a: t_paged.decode_step_paged(*a, page_size=PS)
        logits, cache = step(cfg, params, cache, toks[:, :1])
    return logits, registry._tensors(cache)


@pytest.mark.parametrize("path", PATHS)
def test_rope_table_once_per_call_is_bit_identical(model, monkeypatch, path):
    cfg, params = model
    built = []
    real = layers.rope_table

    def counted(*a, **kw):
        built.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "rope_table", counted)
    logits, cache = _call(cfg, params, path)
    assert len(built) == 1                    # once for every layer
    built.clear()
    monkeypatch.setattr(layers, "model_rope", lambda cfg, positions: None)
    logits_pc, cache_pc = _call(cfg, params, path)
    assert len(built) == 2 * cfg.num_layers   # q and k of every layer
    assert torch.equal(logits, logits_pc)
    assert len(cache) == len(cache_pc)
    for a, b in zip(cache, cache_pc):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rotary_pct,theta", [(1.0, 10000.0),
                                              (0.5, 10000.0),
                                              (0.25, 500000.0),
                                              (1.0, 0.0)])
def test_apply_rope_with_a_table_matches_reference(rotary_pct, theta):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    table = layers.rope_table(tp, 16, rotary_pct=rotary_pct, theta=theta)
    assert (table is None) == (theta <= 0.0)
    got = layers.apply_rope(tx, tp, rotary_pct=rotary_pct, theta=theta,
                            table=table)
    per_call = layers.apply_rope(tx, tp, rotary_pct=rotary_pct, theta=theta)
    assert torch.equal(got, per_call)
    want = np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          rotary_pct=rotary_pct,
                                          theta=theta))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- cache identity through an engine's life --------------------------------------


def _snapshot(dec):
    return [(id(t), t.data_ptr()) for t in registry._tensors(dec.cache)]


def _prompts(cfg):
    rng = np.random.default_rng(8)
    system = rng.integers(1, cfg.vocab_size, PS)
    return [np.concatenate([system, rng.integers(1, cfg.vocab_size, n)])
            for n in (5, 12, 20)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_cache_tensors_stay_put(model, mode):
    """Admission, chunks, ``step_reference()``, release, a migration and
    (paged) a full prefix hit with copy-on-write all write into the
    engine's cache tensors in place."""
    cfg, params = model
    pre = TE.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    dec = TE.DecodeEngine(cfg, params, max_slots=4, max_seq=64, chunk_size=3,
                          device="cpu", **MODES[mode])
    assert dec.graphs is None and dec.jit_cache_size == 0
    cache, before = dec.cache, _snapshot(dec)
    reqs = [TE.GenRequest(i, p, n)
            for i, (p, n) in enumerate(zip(_prompts(cfg), (4, 9, 7)))]
    out = pre.run(reqs)
    assert not dec.admit(TE.AdmissionBatch(
        [TE.AdmissionItem(r, f, wire=w) for r, w, f in out]))
    dec.step()
    dec.step_reference()
    (slot, req, wire, cur), = [s for s in dec.extract_resident()
                               if s[1].rid == 1]
    dec.release(slot)                          # migrate request 1 home
    assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(
        req, cur, TE.ADMIT_MIGRATED, wire=wire)]))
    while dec.active:
        dec.step()
    if dec.paged:
        hit = dec.prefix_match(reqs[0].tokens)
        assert hit is not None and hit.full
        again = TE.GenRequest(9, reqs[0].tokens, 4)
        assert not dec.admit(TE.AdmissionBatch([TE.AdmissionItem(
            again, hit.next_token, TE.ADMIT_PREFIX_HIT,
            pages=list(hit.pages))]))
        assert dec.cow_copies == 1
        while dec.active:
            dec.step()
        assert again.out_tokens == reqs[0].out_tokens
        assert dec.page_stats()["leaked_pages"] == 0
    assert dec.cache is cache and _snapshot(dec) == before


def test_host_state_is_the_slots_state(model):
    cfg, params = model
    dec = TE.DecodeEngine(cfg, params, max_slots=3, max_seq=64, page_size=PS,
                          device="cpu")
    dec.slots[1] = TE.GenRequest(0, np.arange(1, 5), 7, out_tokens=[3, 4])
    dec.cur_token[:] = (5, 4, 6)
    st = dec._host_state()
    assert st["cur"].tolist() == [5, 4, 6]
    assert st["active"].tolist() == [False, True, False]
    assert st["n_out"].tolist() == [0, 2, 0]
    assert st["max_new"].tolist() == [0, 7, 0]
    assert [st[k].dtype for k in registry.STATE_KEYS] == \
        [torch.int32, torch.bool, torch.int32, torch.int32]


def test_no_graph_and_no_compile_cache_on_the_cpu(model):
    cfg, params = model
    for graph in (True, False):
        dec = TE.DecodeEngine(cfg, params, max_slots=2, max_seq=32,
                              page_size=PS, cuda_graph=graph, device="cpu")
        assert dec.graphs is None and dec.jit_cache_size == 0
    assert TE.PrefillEngine(cfg, params, device="cpu").jit_cache_size == 0
