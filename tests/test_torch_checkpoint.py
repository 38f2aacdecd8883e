"""The port's checkpoints (``repro_torch.checkpoint``) and the training
state's conversion to the reference's pytree (``models/convert.py``), on
the CPU.

* The reference's four checkpoint tests (``tests/test_checkpoint.py``),
  on the port: a round trip with bf16, f32, int and tuple leaves; the
  latest of several steps; the async writer; a restarted run that
  continues bit for bit (losses and every param byte).
* ``params_to_tree``/``params_to_numpy`` invert ``params_from_numpy``
  byte for byte for every registered config (bf16, its reduced
  weights), and the AdamW state's pair does the same.
* A JAX checkpoint of ``{"p": params, "o": opt_state}`` loads into the
  port, and the port's loads through ``repro.checkpoint.load_checkpoint``:
  identical bytes, identical manifests and file names.
* The loader checks shapes and types against the tree it restores into.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import DataConfig, PackedLM  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.randn((4, 8), generator=g),
        "nested": {"b": torch.randn((3,), generator=g).to(torch.bfloat16),
                   "c": (torch.arange(5),
                         torch.ones((2, 2), dtype=torch.bfloat16))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_tree_equal(a, b):
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        assert x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, t, 120, extra={"note": "hi"})
    got, step, extra = load_checkpoint(tmp_path, t)
    assert step == 120 and extra["note"] == "hi"
    assert isinstance(got["nested"]["c"], tuple)
    _assert_tree_equal(t, got)


def test_latest_step_and_multiple(tmp_path):
    t = _tree()
    for s in (10, 20, 30):
        save_checkpoint(tmp_path, t, s)
    assert latest_step(tmp_path) == 30
    _, step, _ = load_checkpoint(tmp_path, t, step=20)
    assert step == 20
    (tmp_path / "step_00000040.tmp").mkdir()     # a write that never ended
    assert latest_step(tmp_path) == 30


def test_async_checkpointer(tmp_path):
    t = _tree()
    ck = AsyncCheckpointer(tmp_path)
    for s in (5, 6):
        ck.save(t, s)
    t["a"].zero_()               # save() copied: the write is unaffected
    ck.close()
    got, step, _ = load_checkpoint(tmp_path, t)
    assert step == 6
    assert not torch.equal(got["a"], t["a"])
    _assert_tree_equal(_tree(), got)
    assert [w[0] for w in ck.writes] == [5, 6]
    assert ck.writes[0][1] == 4 * 32 + 2 * 3 + 8 * 5 + 2 * 4 + 4


def test_load_checks_shapes_and_types(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, t, 1)
    wrong = _tree()
    wrong["a"] = wrong["a"].double()
    with pytest.raises(ValueError, match="float64"):
        load_checkpoint(tmp_path, wrong)
    wrong = _tree()
    del wrong["step"]
    with pytest.raises(ValueError, match="keys differ"):
        load_checkpoint(tmp_path, wrong)
    meta = {"a": t["a"].to("meta"), "nested": t["nested"],
            "step": t["step"]}
    got, _, _ = load_checkpoint(tmp_path, meta)
    assert torch.equal(got["a"], t["a"])


def test_restart_resumes_training(tmp_path):
    """Checkpoint/restart: a restarted run continues bit-identically (the
    reference's test, on the port: 6 steps with a checkpoint after step
    2, then steps 3-5 again from it)."""
    cfg = get_reduced("llama-30b")
    api = build(cfg)
    params = t_train.make_params(cfg, "cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ostate = opt.adamw_init(params)
    step_fn = opt.make_train_step(api, ocfg)
    data = PackedLM(DataConfig(cfg.vocab_size, 16, 2))

    losses_a = []
    for i, batch in enumerate(data):
        if i >= 6:
            break
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, ostate, st = step_fn(params, ostate, tb)
        losses_a.append(float(st["loss"]))
        if i == 2:
            save_checkpoint(tmp_path, t_train.train_tree(params, ostate, cfg,
                                                         "cpu"), i,
                            extra={"data": data.state()})

    params2 = t_train.make_params(cfg, "cpu")
    ostate2 = opt.adamw_init(params2)
    got, _, extra = load_checkpoint(
        tmp_path, t_train.train_tree(params2, ostate2, cfg, "meta"))
    t_train.restore_into(params2, ostate2, cfg, got)
    assert int(ostate2["step"]) == 3
    data2 = PackedLM(DataConfig(cfg.vocab_size, 16, 2))
    data2.restore(extra["data"])
    losses_b = []
    for i, batch in enumerate(data2):
        if i >= 3:
            break
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params2, ostate2, st = step_fn(params2, ostate2, tb)
        losses_b.append(float(st["loss"]))
    assert losses_a[3:] == losses_b
    _assert_tree_equal((params, ostate), (params2, ostate2))


# -- the reference's pytree ---------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat_np(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_arrays(a, b):
    fa, fb = _flat_np(a), _flat_np(b)
    assert fa.keys() == fb.keys(), set(fa) ^ set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_round_trip_bytes(arch):
    """The reference's bf16 params -> the port -> back: the same pytree
    and the same bytes; and the port's own tree -> the reference's ->
    the port's again, byte for byte."""
    jcfg = j_get_reduced(arch)
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_reduced(arch)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    _assert_same_arrays(tree, convert.params_to_numpy(params, cfg))
    again = convert.params_from_numpy(convert.params_to_tree(params, cfg),
                                      cfg, "cpu")
    _assert_tree_equal(params, again)
    meta = convert.params_to_tree(params, cfg, "meta")
    assert [t.shape for t in opt.tree_leaves(meta)] == \
        [t.shape for t in opt.tree_leaves(convert.params_to_tree(params,
                                                                 cfg))]


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "whisper-base"])
def test_opt_state_round_trip_bytes(arch):
    jcfg = j_get_reduced(arch)
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jo = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)),
        j_opt.adamw_init(jp))
    jo["step"] = jnp.int32(11)
    tree = jax.tree.map(np.asarray, jo)
    cfg = get_reduced(arch)
    state = convert.opt_state_from_numpy(tree, cfg, "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 11
    _assert_same_arrays(tree, convert.opt_state_to_numpy(state, cfg))


def _train_state(arch):
    """The reference's reduced params (bf16) and an AdamW state after one
    step, as numpy trees."""
    jcfg = j_get_reduced(arch)
    api = j_build(jcfg)
    jp = api.init(jax.random.PRNGKey(0))
    b = PackedLM(DataConfig(jcfg.vocab_size, 16, 2)).batch_at(0)
    step = j_opt.make_train_step(api, j_opt.AdamWConfig(warmup_steps=2))
    jp, jo, _ = jax.jit(step)(jp, j_opt.adamw_init(jp),
                              {k: jnp.asarray(v) for k, v in b.items()})
    return jax.tree.map(np.asarray, {"p": jp, "o": jo})


def _read_dir(path):
    d = next(p for p in path.iterdir() if p.name.startswith("step_"))
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, {f.name: np.load(f) for f in d.glob("*.npy")}


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path):
    """A JAX checkpoint of the training state loads into the port (the
    same bytes, restored into the port's state); the port writes it back
    in the same files, bytes and manifest; the reference loads that."""
    arch = "llama-30b"
    cfg = get_reduced(arch)
    state = _train_state(arch)
    j_ckpt.save_checkpoint(tmp_path / "jax", state, 1,
                           extra={"data": {"step": 1}})

    params = t_train.make_params(cfg, "cpu")
    ostate = opt.adamw_init(params)
    got, step, extra = load_checkpoint(
        tmp_path / "jax", t_train.train_tree(params, ostate, cfg, "meta"))
    assert step == 1 and extra == {"data": {"step": 1}}
    t_train.restore_into(params, ostate, cfg, got)
    assert int(ostate["step"]) == 1
    _assert_same_arrays(state["p"], convert.params_to_numpy(params, cfg))
    _assert_same_arrays(state["o"], convert.opt_state_to_numpy(ostate, cfg))

    save_checkpoint(tmp_path / "port", t_train.train_tree(params, ostate,
                                                          cfg, "cpu"), 1,
                    extra={"data": {"step": 1}})
    m_j, files_j = _read_dir(tmp_path / "jax")
    m_t, files_t = _read_dir(tmp_path / "port")
    assert m_j == m_t
    assert files_j.keys() == files_t.keys()
    for name in files_j:
        assert files_j[name].dtype == files_t[name].dtype, name
        np.testing.assert_array_equal(files_j[name], files_t[name])

    like = jax.tree.map(jnp.asarray, state)
    back, step, _ = j_ckpt.load_checkpoint(tmp_path / "port", like)
    assert step == 1
    _assert_same_arrays(state, jax.tree.map(np.asarray, back))
