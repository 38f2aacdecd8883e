"""The port's training loss and gradients against the JAX package, per
family (CPU, reduced configs in float32).

Each registered config reduced, ``dtype="float32"``, the JAX params cast
to f32 and converted (``convert.params_from_numpy``); the same
``PackedLM`` batch of 2 x 48 tokens on both sides (48 > h2o-danube's
32-token window), seeded patch embeddings for the VLM and frames for
whisper (the reference's encoder casts frames to bf16: its module sees
``jnp`` through :class:`F32Frames`, as in ``tests/test_torch_whisper.py``).

* ``api.loss`` within 1e-5 relative of the reference's ``loss``;
* the gradients of ``jax.grad`` and of autograd, compared in the
  reference's pytree (``convert.params_to_numpy``): every leaf within a
  relative L2 of 1e-4 of the larger of its own norm and 1e-3 of the
  whole gradient's. The floor is for the key biases (whisper), whose
  gradient is zero in exact arithmetic (softmax ignores a shift common
  to every key): both sides give rounding noise there, ~5e-9 against a
  whole gradient of ~3;
* ``cfg.remat`` on against off: the port's gradients bit-equal;
* the training path reaches no kernel entry point: every function of
  ``kernels/ops.py`` made to raise, ``loss.backward()`` runs for every
  family.

The recurrent families (jamba, xlstm, whisper) run in
``tests/test_torch_train_recurrent.py`` through :func:`check_family`, so
the JAX compiles spread over two test files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from conftest import jax_block  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import DataConfig, PackedLM  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-3
B, S = 2, 48
RECURRENT = ("jamba-v0.1-52b", "xlstm-125m", "whisper-base")


class F32Frames:
    """``jax.numpy`` with ``bfloat16`` naming float32, for the reference's
    whisper module (its ``encode`` casts the frames to bf16)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def family_case(arch):
    """(JAX config, JAX f32 params, port config, port params, batch as
    numpy) of ``arch`` reduced in f32."""
    jcfg = j_get_reduced(arch).replace(dtype="float32")
    cfg = jax_block(get_reduced(arch).replace(dtype="float32"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    batch = PackedLM(DataConfig(cfg.vocab_size, S, B)).batch_at(0)
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, 5, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            convert.params_from_numpy(tree, cfg, "cpu"), batch)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf, np.float64) for p, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_family(arch, monkeypatch):
    """The loss within ``LOSS_RTOL`` relative, every gradient leaf within
    ``GRAD_RTOL`` (module docstring)."""
    monkeypatch.setattr(j_whisper, "jnp", F32Frames())
    jcfg, jp, cfg, params, batch = family_case(arch)
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_build(jcfg).loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = opt.value_and_grad(build(cfg).loss, params,
                                     torch_batch(batch))
    assert abs(float(loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    want = _flat(jax.tree.map(np.asarray, j_grads))
    got = _flat(convert.params_to_numpy(grads, cfg))
    assert want.keys() == got.keys(), set(want) ^ set(got)
    total = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    for k, w in want.items():
        scale = max(np.linalg.norm(w), GRAD_FLOOR * total)
        err = np.linalg.norm(got[k] - w) / scale
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a not in RECURRENT])
def test_loss_and_grads_match_reference(arch, monkeypatch):
    check_family(arch, monkeypatch)


@pytest.mark.parametrize("arch", ["llama-30b", "command-r-35b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_remat_gives_the_same_grads(arch):
    """``cfg.remat`` (each layer under ``torch.utils.checkpoint``) changes
    what backward recomputes, not a bit of the gradients."""
    _, _, cfg, params, batch = family_case(arch)
    out = []
    for remat in (False, True):
        loss, grads = opt.value_and_grad(
            build(cfg.replace(remat=remat)).loss, params, torch_batch(batch))
        out.append([loss] + opt.tree_leaves(grads))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_training_path_reaches_no_kernel(arch, monkeypatch):
    """Every kernel entry point of ``kernels/ops.py`` raises; the loss and
    its backward still run (with remat, the recomputation too): the
    training forward calls the plain versions directly."""
    def refuse(*a, **k):
        raise AssertionError("the training path reached a kernel")
    for name in ops.KERNELS:
        if hasattr(ops, name):
            monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(ops, "paged_decode_attention", refuse)
    _, _, cfg, params, batch = family_case(arch)
    for t in opt.tree_leaves(params):
        t.requires_grad_(True)
    loss = build(cfg.replace(remat=True)).loss(params, torch_batch(batch))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(t.grad is not None for t in opt.tree_leaves(params))
