"""The port's training substrate against the JAX package (CPU), on the
same numpy inputs:

* ``PackedLM`` (a copy): batches, ``state``/``restore`` bit for bit;
* ``lr_schedule`` over steps 0..total: within 1e-6 relative;
* ``adamw_update`` given identical grads (three steps, f32 and bf16
  params): params within 1e-6 max abs (bf16: at most one bf16 ulp, on at
  most 0.1% of the elements), ``m``/``v`` within 1e-6 of each tensor's
  largest magnitude (an element of ``m`` near zero, where random
  gradients cancel, carries the rounding of its summands, not its own),
  ``step`` equal, the global norm within 1e-5 relative (f32 sums of
  ~10^5 squares in another order); with the norm clipping, 1e-5 for
  params, ``m`` and ``v`` (the clip scale carries that order);
* ``ef_int8_compress``/``decompress``: q bit for bit, scale and error
  within 1e-6;
* ``chunked_xent`` with a mask and a chunk that does not divide S: the
  loss within 1e-6 relative, its gradients within 1e-5 relative L2;
* the out-of-place Mamba scan gives the in-place one's values bit for
  bit, and the in-place one is what autograd refuses;
* every kernel wrapper of ``ops.KERNELS`` raises, naming itself, when
  autograd records and an input requires grad (before it looks at the
  device);
* ``launch.train --reduced --device cpu`` trains, and a run resumed
  from its step-2 checkpoint gives steps 3-5 bit for bit (losses and
  every byte of the state); ``launch.train_e2e`` trains with its
  mid-run restore and the loss drops;
* the fit check counts 12 bytes a parameter plus the largest tensor's
  f32 temporaries.
"""
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.training import data as j_data  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch import train_e2e  # noqa: E402
from repro_torch.models import convert, layers, mamba  # noqa: E402
from repro_torch.training import data as t_data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_packed_lm_matches_reference(rank, world):
    cfg = dict(vocab_size=1024, seq_len=64, global_batch=4, seed=7)
    a = j_data.PackedLM(j_data.DataConfig(**cfg), rank=rank, world=world)
    b = t_data.PackedLM(t_data.DataConfig(**cfg), rank=rank, world=world)
    for step in (0, 3, 11):
        ja, tb = a.batch_at(step), b.batch_at(step)
        assert ja.keys() == tb.keys()
        for k in ja:
            assert ja[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(ja[k], tb[k])
    ia, ib = iter(a), iter(b)
    for _ in range(3):
        np.testing.assert_array_equal(next(ia)["tokens"], next(ib)["tokens"])
    assert a.state() == b.state() == {"step": 3}
    b2 = t_data.PackedLM(t_data.DataConfig(**cfg), rank=rank, world=world)
    b2.restore(a.state())
    np.testing.assert_array_equal(next(iter(b2))["targets"],
                                  next(ia)["targets"])


# -- AdamW --------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    jc, tc = j_opt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    for step in range(0, 51):
        want = float(j_opt.lr_schedule(jc, jnp.int32(step)))
        got = float(opt.lr_schedule(tc, step))
        assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)


def _params_tree(dtype):
    """The reduced LLaMA-30B's reference params in ``dtype`` (numpy)."""
    jcfg = j_get_reduced("llama-30b")
    p = j_build(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a.astype(dtype)), p)


@pytest.mark.parametrize("dtype,grad_scale,tol", [
    ("float32", 0.001, 1e-6), ("float32", 10.0, 1e-5),
    ("bfloat16", 0.001, 1e-6)])
def test_adamw_update_matches_reference(dtype, grad_scale, tol):
    """Three steps from the same params and the same gradients. At
    ``grad_scale`` 0.001 the global norm stays under the clip; at 10 it
    clips, and the clip scale carries the norm's summation order into
    every element (``tol`` 1e-5 there)."""
    tree = _params_tree(jnp.dtype(dtype))
    cfg = get_reduced("llama-30b").replace(dtype=dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = j_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = j_opt.adamw_init(jp)
    tp = convert.params_from_numpy(tree, cfg, "cpu")
    to = opt.adamw_init(tp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(lambda a: (grad_scale * rng.standard_normal(
            a.shape)).astype(a.dtype), tree)
        jp, jo, jst = j_opt.adamw_update(jc, jax.tree.map(jnp.asarray, g),
                                         jo, jp)
        tp, to, tst = opt.adamw_update(tc, convert.params_from_numpy(
            g, cfg, "cpu"), to, tp)
        gn = float(jst["grad_norm"])
        assert abs(float(tst["grad_norm"]) - gn) <= 1e-5 * gn
        assert abs(float(tst["lr"]) - float(jst["lr"])) <= 1e-6 * kw["lr"]
    assert int(to["step"]) == int(jo["step"]) == 3
    got_p = convert.params_to_numpy(tp, cfg)
    got_o = convert.opt_state_to_numpy(to, cfg)
    for want, got, rel in ((jp, got_p, False), (jo["m"], got_o["m"], True),
                           (jo["v"], got_o["v"], True)):
        for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            w = np.asarray(w, np.float64)
            t = np.asarray(t, np.float64)
            if not rel and dtype == "bfloat16":
                # the f32 update rounds to bf16 once: at most one ulp off
                off = np.abs(t - w) > 0
                assert (np.abs(t - w) <= 2 ** -7 * np.abs(w)).all()
                assert off.mean() <= 1e-3, off.mean()
                continue
            err = np.abs(t - w).max()
            if rel:
                err = err / np.abs(w).max()
            assert err <= tol, err


def test_ef_int8_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((37, 53)).astype(np.float32)
    err = (0.01 * rng.standard_normal((37, 53))).astype(np.float32)
    jq, js, je = j_opt.ef_int8_compress(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = opt.ef_int8_compress(torch.from_numpy(g),
                                      torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert abs(float(ts) - float(js)) <= 1e-6 * float(js)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
    np.testing.assert_allclose(
        opt.ef_int8_decompress(tq, ts).numpy(),
        np.asarray(j_opt.ef_int8_decompress(jq, js)), atol=1e-6)


# -- the loss -------------------------------------------------------------------


def test_chunked_xent_matches_reference():
    """S = 45 in chunks of 16 (the last padded), a mask, f32; the loss
    and its gradients with respect to x and the unembedding."""
    rng = np.random.default_rng(9)
    B, S, d, V = 3, 45, 24, 97
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / np.sqrt(d)).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)

    def j_loss(x, w):
        return j_layers.chunked_xent(x, w, jnp.asarray(t), chunk=16,
                                     mask=jnp.asarray(mask))

    want, (jgx, jgw) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = layers.chunked_xent(tx, tw, torch.from_numpy(t), chunk=16,
                              mask=torch.from_numpy(mask))
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-6 * abs(float(want))
    for a, b in ((jgx, tx.grad), (jgw, tw.grad)):
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= 1e-5 * np.linalg.norm(a)


def test_mamba_scan_out_of_place_is_bit_exact():
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 7, 33, 64):
        a = torch.rand((2, n, 5, 3), generator=g)
        b = torch.randn((2, n, 5, 3), generator=g)
        want = mamba.doubling_scan(a.clone(), b.clone())
        got = mamba.doubling_scan_out(a, b)
        assert torch.equal(got, want)
    a.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inplace"):
        mamba.doubling_scan(a * 1, b.clone()).sum().backward()
    mamba.doubling_scan_out(a, b).sum().backward()
    assert a.grad is not None


# -- the kernels refuse autograd --------------------------------------------------


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    x = torch.randn((4, 8, 2, 16), requires_grad=True)
    pages = tuple(torch.zeros((2, 8, 8), requires_grad=True)
                  for _ in range(3))
    idx = torch.zeros((4,), dtype=torch.int32)
    calls = {
        "kv_quant": lambda f: f(x.reshape(-1, 16)),
        "kv_dequant": lambda f: f(*pages),
        "kv_quant_append": lambda f: f(x[:, :1], x[:, :1], pages, pages,
                                       idx[:, None], idx, page_size=8),
        "paged_decode_attention_int4": lambda f: f(
            x[:, :2], pages, pages, idx[:, None], idx, page_size=8),
        "paged_decode_attention_bf16": lambda f: f(
            x[:, :2], x, x, idx[:, None], idx, page_size=8),
        "flash_attention": lambda f: f(x, x, x),
        "decode_attention": lambda f: f(x, x, x, idx),
        "decode_attention_lse": lambda f: f(x, x, x, idx),
        "rmsnorm": lambda f: f(x, torch.zeros(16)),
        "add_rmsnorm": lambda f: f(x, x, torch.zeros(16)),
    }
    assert calls.keys() == ops.KERNELS.keys()
    for name, call in calls.items():
        fn = ops.KERNELS[name]
        before = fn.launches
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel "
                                               f"has no backward"):
            call(fn)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call(fn)             # no grad recorded: the device check
        assert fn.launches == before


# -- the launchers ---------------------------------------------------------------


def _train(tmp_path, *extra):
    return t_train.run(["--reduced", "--device", "cpu", "--steps", "6",
                        "--seq", "32", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2", *extra])


def test_launch_train_resumes_bit_identically(tmp_path, capsys):
    a = _train(tmp_path)
    assert [w[0] for w in a["writes"]] == [2, 4]
    assert all(np.isfinite(a["losses"]))
    out = capsys.readouterr().out
    assert "step    5 loss=" in out and "device: cpu" in out
    shutil.rmtree(tmp_path / "step_00000004")   # died before step 4's
    b = _train(tmp_path, "--resume")
    assert b["start"] == 3 and "resumed from step 2" in \
        capsys.readouterr().out
    assert b["read"][0] == a["writes"][0][1]
    assert b["losses"] == a["losses"][3:]
    assert b["lrs"] == a["lrs"][3:]
    for x, y in zip(opt.tree_leaves((a["params"], a["opt_state"])),
                    opt.tree_leaves((b["params"], b["opt_state"]))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert not torch.are_deterministic_algorithms_enabled()


def test_launch_train_e2e_restores_mid_run(capsys):
    out = train_e2e.run(["--device", "cpu", "--steps", "30", "--seq", "32",
                         "--d-model", "64", "--layers", "2",
                         "--ckpt-every", "5"])
    assert out["restored_at"] == (18, 15)
    assert "simulated failure: restored step 15" in capsys.readouterr().out


def test_fit_check_counts():
    """12 bytes a parameter plus four f32 copies of the largest tensor:
    LLaMA-30B cut to 8 layers fits one 80 GB card, whole it does not."""
    cut = get_config("llama-30b").replace(num_layers=8)
    state, temps = t_train.train_state_bytes(cut)
    assert state == 12 * 4_706_384_384
    assert temps == 16 * 6656 * 2 * 17920
    assert state + temps < 80e9
    assert sum(t_train.train_state_bytes(get_config("llama-30b"))) > 80e9


def test_launch_train_refuses_a_disk_too_small(tmp_path, monkeypatch):
    """Before any step, the launcher checks that ``--ckpt-dir``'s disk
    holds every checkpoint the run will write."""
    monkeypatch.setattr(t_train.shutil, "disk_usage",
                        lambda path: types.SimpleNamespace(free=1000))
    with pytest.raises(OSError, match="2 checkpoints of"):
        _train(tmp_path)
    assert not list(tmp_path.glob("step_*"))
