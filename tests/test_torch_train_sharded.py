"""The sharded training step (ROADMAP A.9 step two, item 1) against the
unsharded port and the JAX package, on the CPU.

Four ranks run over gloo, one spawned process each (``python -c`` with
``src`` and ``tests`` on the path; a ``file://`` store in the tmp dir),
as ``tests/test_torch_distributed.py`` runs them: ONE spawn makes every
multi-rank check (:func:`worker`) and saves what each rank found; a
one-rank world makes the axis-size-1 checks (:func:`worker_size1`); the
JAX package's ``jax.grad`` of its ``moe_apply_shard_map`` runs in one
subprocess with four host devices. All three start together (the
``runs`` fixture) and the tests read their results. The reduced configs
run in float32.

Tolerances:

* TP 2 (a ``data 2 x model 2`` mesh, so every case is also data-parallel
  over rows with unequal token counts) and TP 4 (``1 x 4``), every
  config whose heads the axis divides: the global loss within 1e-5 of
  the unsharded port's on the whole batch; each leaf's gradient within
  1e-5 relative L2 of the unsharded gradient cut to the rank's shard
  (``sharding.shard_params``: this is what catches a wrong whole/partial
  entry; a leaf whose gradient is 0 in exact arithmetic, an attention
  key's bias, holds rounding only and is held against 1e-3 of the whole
  gradient's norm instead); after 2 AdamW steps at lr 1e-3 the grad
  norms within 1e-5 relative and the rank's params within 1e-5 relative
  L2 (over all its leaves) of the unsharded params cut to the rank (not
  leaf by leaf: AdamW divides each element's step by that element's own
  gradient, so an element whose gradient is small against its leaf's
  carries the sums' reordering into its step), the zero-gradient leaves
  left out of that sum and held within two steps (2 lr) instead, since
  AdamW's step of a rounding-only gradient is rounding of any sign;
  leaves every rank holds alike bit-identical across the ranks. The partial products
  are summed in another order, hence 1e-5 and not bits. A MoE layer's
  aux loss under the exchange is the reference's shard_map aux, the
  mean of each shard's Switch loss over its own tokens; the unsharded
  run computes it so (:func:`_shard_aux`; no route drops at these token
  counts, so the outputs are ``moe_apply``'s).
* data 2 x model 2 with the mask of :func:`_batch` (the two data ranks
  hold 11 and 16 target tokens): the same bounds, for LLaMA and for
  qwen3-moe under EP.
* the EP MoE layer's gradients (router, the rank's experts, the rank's
  rows of x) within 1e-5 of ``jax.grad`` of the reference's
  ``moe_apply_shard_map`` on the same ``2 x 2`` mesh.
* axis size 1: two meshed train steps bit for bit the unmeshed ones
  (losses, grad norms, every param), every config.
* checkpoints: a TP-2 checkpoint (written by ``launch.train.run`` on the
  ``2 x 2`` mesh) loads in ``repro.checkpoint.load_checkpoint`` and
  equals, through ``models/convert.py``, the state gathered on the
  ranks; it loads at TP 4 as each rank's cut of it and at TP 1 whole,
  byte for byte; a TP-2 resume continues bit for bit.
* the dry-run: the eleven train_4k cells at ``four`` are counted
  (``launch/dryrun.py: trace_cell``, depth cut to one period; xlstm's at
  2 x 64 tokens, its sLSTM a loop over time); one TP-2
  rank's train step counted on meta has the matmul FLOPs that
  ``FlopCounterMode`` counts on a real gloo rank.
* C.3: reduced xlstm at TP 2 in bf16 is no farther (relative L2 of the
  prefill logits) from its unsharded run than with the bf16 all-reduce
  ``row_proj`` made before; at axis size 1 ``row_proj`` is that
  function's bits.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ALL_ARCHS, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build, convert, layers, moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import whisper as t_wh  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {2: (2, 2), 4: (1, 4)}           # data x model
B, S = 2, 16
TOL = 1e-5
OCFG = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
CASES = ALL_ARCHS + ("llama-30b/remat",)
QWEN = "qwen3-moe-235b-a22b"
XLSTM_TRAIN = ShapeSpec("train_4k", 64, 2, "train")
# a leaf whose gradient is 0 in exact arithmetic (an attention key's
# bias: softmax ignores a shift of every score) holds rounding only; its
# error is taken against this share of the whole gradient's norm
ZERO_GRAD = 1e-3


def _cfg(case):
    arch, _, extra = case.partition("/")
    cfg = get_reduced(arch).replace(dtype="float32")
    return cfg.replace(remat=True) if extra == "remat" else cfg


def _sizes(case):
    """The model axes that split the case's heads (the gathered ones are
    tests/test_torch_distributed_seq.py's)."""
    cfg = _cfg(case)
    return [n for n in MESHES if not sharding.tp_refusals(cfg, n)
            and sharding.heads_split(cfg, n)]


def _init(cfg, mesh=None, seed=1):
    init = t_wh.init_params if cfg.family == "audio" else t_tf.init_params
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    return init(cfg, seed=seed, device="cpu", dtype=dt, mesh=mesh)


def _batch(cfg):
    """The global batch (B rows of S tokens), seeded: row 0 masks its
    last 5 targets, so the two data ranks of a 2 x 2 mesh hold 11 and 16
    tokens; a VLM's patches and whisper's frames in front."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
    mask = np.ones((B, S), np.float32)
    mask[0, -5:] = 0
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:]),
             "mask": torch.from_numpy(mask)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


def _rows(batch, mesh):
    """This data rank's rows (``training/data.py: rank_rows``)."""
    from repro_torch.training.data import rank_rows
    n = mesh.mesh.shape[0]
    r = mesh.get_local_rank("data")
    got = rank_rows({k: v.numpy() for k, v in batch.items()}, r, n)
    return {k: torch.from_numpy(v) for k, v in got.items()}


class _shard_aux:
    """Within the block, ``moe.moe_apply`` (the unsharded MoE) returns
    the aux loss the exchange computes on an ``n_data x ep`` mesh: the
    mean over the shards (rows over data, positions over the expert
    axis) of each shard's Switch loss on its own tokens."""

    def __init__(self, n_data, ep):
        self.n_data, self.ep = n_data, ep

    def __enter__(self):
        self.orig = orig = moe.moe_apply
        n_data, ep = self.n_data, self.ep

        def apply(cfg, p, x, **kw):
            y, _ = orig(cfg, p, x, **kw)
            Bx, Sx, d = x.shape
            auxes = []
            for xr in x.chunk(n_data, 0):
                for xs in xr.chunk(ep, 1):
                    T = xs.shape[0] * xs.shape[1]
                    auxes.append(moe.route(cfg, p["router"],
                                           xs.reshape(T, d),
                                           moe.capacity_of(cfg, T))[4])
            return y, sum(auxes) / len(auxes)

        moe.moe_apply = apply
        return self

    def __exit__(self, *exc):
        moe.moe_apply = self.orig


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def _rel(got, want, floor=0.0):
    """||got - want|| / max(||want||, floor)."""
    return _norm(got - want) / max(_norm(want), floor, 1e-30)


def _unsharded(cfg, batch, shards=None):
    """The unsharded port: (loss, grads) at the initial params, then the
    params and grad norms of two AdamW steps on the same batch."""
    ctx = _shard_aux(*shards) if cfg.moe_num_experts and shards else None
    if ctx:
        ctx.__enter__()
    try:
        api = build(cfg)
        params = _init(cfg)
        loss, grads = opt.loss_and_grads(api, params, batch)
        grads = opt.tree_map(lambda g: g.detach().clone(), grads)
        params, norms = _two_steps(api, _init(cfg), batch)
    finally:
        if ctx:
            ctx.__exit__()
    return loss, grads, params, norms


def _two_steps(api, params, batch):
    step = opt.make_train_step(api, OCFG)
    state = opt.adamw_init(params)
    norms = []
    for _ in range(2):
        params, state, stats = step(params, state, batch)
        norms.append(float(stats["grad_norm"]))
    return params, norms


def _tp_case(case, n, mesh):
    """One case on this rank: the sharded step against the unsharded one
    (both computed here). Returns the worst errors and this rank's final
    params."""
    cfg = _cfg(case)
    batch = _batch(cfg)
    u_loss, u_grads, u_params, u_norms = _unsharded(
        cfg, batch, (mesh.mesh.shape[0], n))
    rt = t_tf.Runtime(mesh, moe_shard_map=bool(cfg.moe_num_experts))
    api = build(cfg, rt=rt)
    mine = _rows(batch, mesh)
    loss, grads = opt.loss_and_grads(api, _init(cfg, mesh), mine)
    want = sharding.shard_params(u_grads, cfg, mesh)
    floor = ZERO_GRAD * _norm(torch.stack([g.norm() for g in
                                           opt.tree_leaves(u_grads)]))
    grad_err = max(_rel(g, w, floor) for g, w in zip(
        opt.tree_leaves(grads), opt.tree_leaves(want)))
    params, norms = _two_steps(api, _init(cfg, mesh), mine)
    want_p = opt.tree_leaves(sharding.shard_params(u_params, cfg, mesh))
    got_p = opt.tree_leaves(params)
    # AdamW's step of a rounding-only gradient is itself rounding, of any
    # sign and up to lr an element: such leaves are held to two steps' size
    noise = [_norm(w) < floor for w in opt.tree_leaves(want)]
    pairs = [(p.detach(), w) for p, w, z in zip(got_p, want_p, noise)
             if not z]
    param_err = _norm(torch.cat([(p - w).flatten() for p, w in pairs])) / \
        _norm(torch.cat([w.flatten() for _, w in pairs]))
    noise_err = max([float((p.detach() - w).abs().max()) for p, w, z in
                     zip(got_p, want_p, noise) if z], default=0.0)
    return {"loss": (float(loss), float(u_loss)), "grad": grad_err,
            "param": param_err,
            "norm": max(abs(a - b) / b for a, b in zip(norms, u_norms)),
            "noise": noise_err,
            "params": [p.detach().clone() for p in got_p],
            "kinds": opt.tree_leaves(sharding.grad_kinds(cfg, n))}


def _old_row_proj(p, name, x, tp=None):
    """``layers.row_proj`` before the f32 sum: the product in ``x``'s type,
    all-reduced in it."""
    y = x @ p[name]
    if tp is not None:
        tp.all_reduce(y)
    b = p.get(name + "_b")
    return y if b is None else y + b


def _xlstm_bf16(mesh):
    """C.3: reduced xlstm in bf16, prefill logits' relative L2 from the
    unsharded run, with ``row_proj`` as it is and as it was."""
    from repro_torch.models import xlstm
    cfg = get_reduced("xlstm-125m")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, cfg.vocab_size, (2, 24)))
    want = build(cfg).prefill(_init(cfg, seed=4), {"tokens": toks})[0]
    rt = t_tf.Runtime(mesh)
    params = _init(cfg, mesh, seed=4)
    now = build(cfg, rt=rt).prefill(params, {"tokens": toks})[0]
    xlstm.row_proj, t_tf.layers.row_proj = _old_row_proj, _old_row_proj
    try:
        before = build(cfg, rt=rt).prefill(params, {"tokens": toks})[0]
    finally:
        xlstm.row_proj = t_tf.layers.row_proj = layers.row_proj
    return _rel(now.float(), want.float()), _rel(before.float(), want.float())


def _moe_grads(inp, mesh):
    """The EP MoE layer's gradients on this rank: router (summed over the
    expert axis), its experts' wi/wo and its rows of x (each summed over
    the data axis), of ``sum(y * cot) + 0.01 * aux`` over the global
    batch (this data rank's part: its rows, aux / data ranks)."""
    from repro_torch.launch.mesh import axis_group
    cfg = _cfg(QWEN)
    out = []
    for i, cf in enumerate(inp["moe_cf"]):
        p = sharding.shard_params({"moe": {k: torch.from_numpy(v) for k, v
                                           in inp["moe_p"].items()}},
                                  cfg, mesh)["moe"]
        x = torch.from_numpy(inp[f"moe_x{i}"])
        cot = torch.from_numpy(inp[f"moe_cot{i}"])
        d, n_data = mesh.get_local_rank("data"), mesh.mesh.shape[0]
        b = x.shape[0] // n_data
        x, cot = x[d * b:(d + 1) * b], cot[d * b:(d + 1) * b]
        leaves = [p["router"], p["wi"], p["wo"], x]
        for t in leaves:
            t.requires_grad_(True)
        y, aux = moe.moe_apply_shard_map(cfg, p, x, mesh=mesh,
                                         capacity_factor=float(cf),
                                         local_batch=True)
        loss = (y * cot).sum() + 0.01 * aux / n_data
        grads = torch.autograd.grad(loss, leaves)
        axis_group(mesh, "model").all_reduce(grads[0])
        for g in grads[:3]:
            axis_group(mesh, "data").all_reduce(g)
        out.append([g.detach() for g in grads])
    return out


def _ckpt_runs(tmp, mesh):
    """A TP-2 run of 3 steps that checkpoints at step 2, its resume for
    step 3, and a straight run of 4 steps (``launch.train.run``), on the
    reduced LLaMA; then the checkpoint loaded at TP 4, gathered back."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    cfg = get_reduced("llama-30b")
    rt = t_tf.Runtime(mesh)
    argv = ["--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt-dir",
            f"{tmp}/ck", "--ckpt-every", "2"]
    at2 = train.run(argv + ["--steps", "3"], cfg=cfg, rt=rt)
    resumed = train.run(argv + ["--steps", "4", "--resume"], cfg=cfg, rt=rt)
    straight = train.run(argv[:6] + ["--steps", "4"], cfg=cfg, rt=rt)
    leaves = opt.tree_leaves
    out = {"at2": [t.detach().clone() for t in leaves(
               (at2["params"], at2["opt_state"]["m"],
                at2["opt_state"]["v"]))],
           "resumed_from": resumed["start"],
           "resume_equal": all(torch.equal(a, b) for a, b in zip(
               leaves((resumed["params"], resumed["opt_state"]["m"])),
               leaves((straight["params"], straight["opt_state"]["m"])))),
           "losses": (resumed["losses"], straight["losses"][3:])}
    # at TP 4: each rank's cut of the whole checkpoint, gathered back
    four = make_mesh((1, 4), ("data", "model"), device="cpu")
    params = train.make_params(cfg, "cpu", four)
    state = opt.adamw_init(params)
    tree, _, _ = load_checkpoint(f"{tmp}/ck", train.whole_tree(cfg))
    train.restore_into(params, state, cfg, tree, four)
    back = train.train_tree(params, state, cfg, "cpu", four)
    out["tp4_equal"] = all(torch.equal(a, b) for a, b in zip(
        leaves(back), leaves(tree)))
    return out


def _replicated_moe_refusal(mesh):
    """The exchange's replicated path (fewer positions than expert ranks)
    under autograd: the error it raises (ROADMAP C.4)."""
    cfg = _cfg(QWEN)
    p = sharding.shard_params({"moe": moe_params(cfg)}, cfg, mesh)["moe"]
    x = torch.zeros((2, 2, cfg.d_model), requires_grad=True)
    try:
        moe.moe_apply_shard_map(cfg, p, x, mesh=mesh, local_batch=True)
    except NotImplementedError as e:
        return str(e)
    return None


def _exchange_grads(mesh):
    """A ring of ``comm.exchange`` under autograd: each rank sends its
    tensor to the next and weighs what it received by its own rank + 1;
    backward's reversed exchange returns each weight to the sender."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import axis_group
    grp = axis_group(mesh, "model")
    r, n = grp.rank, grp.size
    x = torch.full((3,), float(r + 1), requires_grad=True)
    got, = comm.exchange(grp, [(x, (r + 1) % n)],
                         [(torch.empty(3), (r - 1) % n)])
    (got * (r + 1)).sum().backward()
    return float(got[0]), x.grad.tolist()


def moe_params(cfg):
    return t_tf.ParamMaker(cfg, 5, "cpu", torch.float32).moe()


def _flops_rank(mesh):
    """Matmul FLOPs ``FlopCounterMode`` counts in one TP-2 train step of
    the reduced LLaMA on this rank."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _cfg("llama-30b")
    api = build(cfg, rt=t_tf.Runtime(mesh))
    params = _init(cfg, mesh)
    step = opt.make_train_step(api, OCFG)
    with FlopCounterMode(display=False) as fc:
        step(params, opt.adamw_init(params), _rows(_batch(cfg), mesh))
    return fc.get_total_flops()


def worker(rank: int, world: int, tmp: str):
    """One rank of the spawn: every multi-rank check, saved to
    ``rank{r}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {"tp": {}}
    for n, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for case in CASES:
            if n in _sizes(case):
                out["tp"][case, n] = _tp_case(case, n, mesh)
        if n == 4:
            out["refusal"] = _replicated_moe_refusal(mesh)
            out["exchange"] = _exchange_grads(mesh)
        if n == 2:
            out["c3"] = _xlstm_bf16(mesh)
            out["moe"] = _moe_grads(inp, mesh)
            out["ckpt"] = _ckpt_runs(tmp, mesh)
            out["flops"] = _flops_rank(mesh)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _steps(arch, rt):
    """Two train steps of the reduced ``arch`` (its own type) under
    ``rt``: every loss, grad norm and param."""
    cfg = get_reduced(arch)
    api = build(cfg, rt=rt)
    params = _init(cfg, seed=2)
    step = opt.make_train_step(api, OCFG)
    state = opt.adamw_init(params)
    out = []
    for _ in range(2):
        params, state, stats = step(params, state, _batch(cfg))
        out += [stats["loss"], stats["grad_norm"]]
    return out + opt.tree_leaves(params)


def worker_size1(tmp: str):
    """A world of one rank: every config's meshed train step against no
    mesh, ``row_proj`` at axis size 1 against its old form, and the
    dry-run's train cells at ``four`` (``size1.pt``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh, axis_group
    from repro_torch.models import transformer
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv1",
                            rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = {"equal": {}}
    for arch in ALL_ARCHS:
        runs = [_steps(arch, None), _steps(arch, t_tf.Runtime(mesh))]
        if get_reduced(arch).moe_num_experts:
            runs.append(_steps(arch, t_tf.Runtime(mesh, moe_shard_map=True)))
        out["equal"][arch] = all(
            len(r) == len(runs[0]) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(r, runs[0])) for r in runs[1:])
    g = torch.Generator().manual_seed(3)
    p = {"wo": torch.randn((64, 32), generator=g).to(torch.bfloat16),
         "wo_b": torch.randn((32,), generator=g).to(torch.bfloat16)}
    x = torch.randn((2, 5, 64), generator=g).to(torch.bfloat16)
    tp = axis_group(mesh, "model")
    out["row_proj"] = torch.equal(layers.row_proj(p, "wo", x, tp),
                                  _old_row_proj(p, "wo", x, tp))
    four = abstract_mesh((1, 4), ("data", "model"))
    out["cells"] = {}
    full = dryrun.SHAPES["train_4k"]
    for arch in ALL_ARCHS:
        cfg = dryrun.get_config(arch)
        cut = {"num_layers": 1, "num_encoder_layers": 1} \
            if cfg.family == "audio" else \
            {"num_layers": len(transformer.slot_kinds(cfg))}
        # xlstm's sLSTM is a loop over time: 2 x 64 tokens, as
        # tests/test_torch_dryrun.py counts its prefill
        dryrun.SHAPES["train_4k"] = XLSTM_TRAIN if arch == "xlstm-125m" \
            else full
        try:
            counted, info = dryrun.trace_cell(arch, "train_4k", four,
                                              overrides=cut)
            out["cells"][arch] = (counted["coll_counts"], info["batch"],
                                  info["shape"].global_batch)
        except Exception as e:  # noqa: BLE001 -- the test reports it
            out["cells"][arch] = repr(e)
        finally:
            dryrun.SHAPES["train_4k"] = full
    torch.save(out, f"{tmp}/size1.pt")
    dist.destroy_process_group()


# -- the JAX package's gradients ----------------------------------------------

_JAX_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.models import moe

tmp = sys.argv[1]
inp = np.load(os.path.join(tmp, "jax_in.npz"))
cfg = get_reduced("qwen3-moe-235b-a22b").replace(dtype="float32")
p = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "wi", "wo")}
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for i, cf in enumerate(inp["moe_cf"]):
    x, cot = jnp.asarray(inp[f"moe_x{i}"]), jnp.asarray(inp[f"moe_cot{i}"])

    def f(p, x):
        y, aux = moe.moe_apply_shard_map(cfg, p, x, mesh=mesh,
                                         capacity_factor=float(cf))
        return jnp.sum(y * cot) + 0.01 * aux

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
    for k in ("router", "wi", "wo"):
        out[f"{k}{i}"] = np.asarray(gp[k])
    out[f"x{i}"] = np.asarray(gx)
np.savez(os.path.join(tmp, "jax_out.npz"), **out)
print("JAX REF OK")
"""

MOE_CASES = ((4, 8, 8.0), (4, 64, 1.0))     # (B, S, capacity factor)


def _inputs(tmp):
    """The MoE layer's JAX weights and inputs, for both sides."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models import moe as j_moe
    qcfg = j_get_reduced(QWEN).replace(dtype="float32")
    pm = {k: np.asarray(v, np.float32) for k, v in
          j_moe.moe_init(qcfg, jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(11)
    inp = {"moe_p": pm, "moe_cf": np.array([c for _, _, c in MOE_CASES])}
    for i, (b, s, _) in enumerate(MOE_CASES):
        inp[f"moe_x{i}"] = rng.standard_normal(
            (b, s, qcfg.d_model)).astype(np.float32)
        inp[f"moe_cot{i}"] = rng.standard_normal(
            (b, s, qcfg.d_model)).astype(np.float32)
    torch.save(inp, tmp / "inputs.pt")
    np.savez(tmp / "jax_in.npz", **{f"moe_{k}": v for k, v in pm.items()},
             **{k: v for k, v in inp.items() if k not in ("moe_p",)})
    return inp


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, the one-rank world and the JAX reference
    together; wait for all. Returns (per-rank results, the one-rank
    world's, JAX's, the inputs, the tmp dir, the ranks' logs)."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    inp = _inputs(tmp)
    env = _child_env()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_train_sharded as t; "
         f"t.worker({r}, {WORLD}, {str(tmp)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", "import test_torch_train_sharded as t; "
         f"t.worker_size1({str(tmp)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    ref = subprocess.run([sys.executable, "-c", _JAX_REF, str(tmp)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=240)[0])
        finally:
            proc.kill()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"process {r}:\n{log[-4000:]}"
    assert "JAX REF OK" in ref.stdout, ref.stderr[-4000:]
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    one = torch.load(tmp / "size1.pt", weights_only=False)
    return res, one, dict(np.load(tmp / "jax_out.npz")), inp, tmp, logs


# -- (1) TP 2 (with data 2) and TP 4 against the unsharded port --------------

TP_CASES = [(c, n) for c in CASES for n in _sizes(c)]


@pytest.mark.parametrize("case,n", TP_CASES)
def test_tp_step_matches_unsharded(runs, case, n):
    res = runs[0]
    for r in range(WORLD):
        got = res[r]["tp"][case, n]
        loss, want = got["loss"]
        assert abs(loss - want) <= TOL, (r, loss, want)
        assert got["grad"] <= TOL, (r, got["grad"])
        assert got["norm"] <= TOL, (r, got["norm"])
        assert got["param"] <= TOL, (r, got["param"])
        assert got["noise"] <= 2 * OCFG.lr, (r, got["noise"])


def _model_rank(r, n):
    return r % n


@pytest.mark.parametrize("case,n", TP_CASES)
def test_whole_leaves_stay_bit_identical_across_ranks(runs, case, n):
    """Whole and completed-partial leaves: the same bytes on every rank
    (data ranks hold the same shards too); a replicated KV head: the
    same bytes on every rank that holds it."""
    res = runs[0]
    cfg = _cfg(case)
    kinds = res[0]["tp"][case, n]["kinds"]
    for r in range(1, WORLD):
        got, first = res[r]["tp"][case, n], res[0]["tp"][case, n]
        same_shard = _model_rank(r, n) == 0
        for kind, a, b in zip(kinds, got["params"], first["params"]):
            if kind in ("whole", "partial") or same_shard:
                assert torch.equal(a, b), (r, kind)
            elif kind == "kv" and sharding.kv_head_of(
                    cfg, n, _model_rank(r, n)) == 0:
                assert torch.equal(a, b), (r, kind)
    assert "partial" in kinds or "whole" in kinds


# -- (2) the EP MoE layer against jax.grad -------------------------------------


@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_ep_moe_grads_match_jax(runs, case):
    res, _, ref, inp, _, _ = runs
    cfg = _cfg(QWEN)
    E = cfg.moe_num_experts
    for r in range(WORLD):
        g_router, g_wi, g_wo, g_x = res[r]["moe"][case]
        m, d = r % 2, r // 2
        e = E // 2
        b = inp[f"moe_x{case}"].shape[0] // 2
        for got, want in ((g_router, ref[f"router{case}"]),
                          (g_wi, ref[f"wi{case}"][m * e:(m + 1) * e]),
                          (g_wo, ref[f"wo{case}"][m * e:(m + 1) * e]),
                          (g_x, ref[f"x{case}"][d * b:(d + 1) * b])):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL,
                                       rtol=TOL)


# -- (3) axis size 1 -----------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axis_size_one_train_step_is_bit_identical(runs, arch):
    assert runs[1]["equal"][arch] is True


# -- (4) checkpoints -----------------------------------------------------------


def test_tp2_checkpoint_loads_in_the_reference_and_at_tp1(runs):
    """The TP-2 checkpoint through ``repro.checkpoint.load_checkpoint``
    and ``models/convert.py``: the whole state whose cut is each rank's
    shard at step 2, byte for byte; the port's own loader at TP 1 gives
    the same bytes."""
    from repro.checkpoint import load_checkpoint as j_load
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    res, _, _, _, tmp, _ = runs
    cfg = get_reduced("llama-30b")
    like = train.whole_tree(cfg)
    jtree = j_load(str(tmp / "ck"), jax_like(like))[0]
    ptree = load_checkpoint(str(tmp / "ck"), like)[0]
    whole = {"p": convert.params_from_numpy(jtree["p"], cfg, "cpu"),
             "o": convert.opt_state_from_numpy(jtree["o"], cfg, "cpu")}
    mine = {"p": convert.params_from_numpy(ptree["p"], cfg, "cpu"),
            "o": convert.opt_state_from_numpy(ptree["o"], cfg, "cpu")}
    flat = opt.tree_leaves((whole["p"], whole["o"]["m"], whole["o"]["v"]))
    assert all(torch.equal(a, b) for a, b in zip(flat, opt.tree_leaves(
        (mine["p"], mine["o"]["m"], mine["o"]["v"]))))
    assert int(whole["o"]["step"]) == 3
    mesh = _FakeMesh((2, 2))
    for r in range(WORLD):
        mesh.rank = r
        cut = opt.tree_leaves(tuple(sharding.shard_params(
            t, cfg, mesh) for t in (whole["p"], whole["o"]["m"],
                                    whole["o"]["v"])))
        got = res[r]["ckpt"]["at2"]
        assert len(cut) == len(got)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(cut, got)), r


def test_tp2_checkpoint_loads_at_tp4_and_resumes_bit_for_bit(runs):
    res = runs[0]
    for r in range(WORLD):
        got = res[r]["ckpt"]
        assert got["tp4_equal"] is True
        assert got["resumed_from"] == 3
        assert got["resume_equal"] is True
        assert got["losses"][0] == got["losses"][1]


class _FakeMesh:
    """A ``data x model`` mesh's shape and one rank's place in it, for
    ``sharding.shard_params`` outside a process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        import types
        self.mesh = types.SimpleNamespace(shape=shape)
        self.rank = 0

    def get_local_rank(self, name):
        n = self.mesh.shape[1]
        return self.rank % n if name == "model" else self.rank // n


def jax_like(tree):
    """A numpy tree of the shapes and types of ``tree`` (meta tensors),
    the ``like_tree`` the reference's loader checks against."""
    import ml_dtypes
    if isinstance(tree, dict):
        return {k: jax_like(v) for k, v in tree.items()}
    dt = ml_dtypes.bfloat16 if tree.dtype == torch.bfloat16 else \
        np.dtype(str(tree.dtype).removeprefix("torch."))
    return np.zeros(tuple(tree.shape), dt)


# -- (5) the dry-run -----------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dryrun_train_cell_at_four_is_counted(runs, arch):
    got = runs[1]["cells"][arch]
    assert not isinstance(got, str), got
    colls, batch, whole = got
    assert batch == whole                   # data 1: the whole batch
    assert colls.get("all_reduce", 0) > 0   # the backward sums at least


def test_meta_flops_of_a_tp2_train_step_equal_a_real_ranks(runs):
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.roofline.op_cost import OpCounter
    res = runs[0]
    cfg = _cfg("llama-30b")
    mesh = abstract_mesh((2, 2), ("data", "model"))
    api = build(cfg, rt=t_tf.Runtime(mesh))
    params = t_tf.init_params(cfg, device="meta", dtype=torch.float32,
                              mesh=mesh)
    batch = {k: torch.empty((B // 2,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in _batch(cfg).items()}
    with OpCounter() as c:
        opt.make_train_step(api, OCFG)(params, opt.adamw_init(params), batch)
    mm = c.result()["by_class"]["matmul"]["flops"]
    assert mm == res[0]["flops"] > 0


def test_exchange_sends_gradients_back(runs):
    for r in range(WORLD):
        got, grad = runs[0][r]["exchange"]
        assert got == float((r - 1) % WORLD + 1)
        assert grad == [float((r + 1) % WORLD + 1)] * 3


def test_replicated_expert_path_is_refused_under_autograd(runs):
    for r in range(WORLD):
        assert "to divide over the 4 ranks" in runs[0][r]["refusal"]


# -- (6) C.3 -------------------------------------------------------------------


def test_c3_bf16_row_parallel_sum(runs):
    res, one = runs[0], runs[1]
    for r in range(WORLD):
        now, before = res[r]["c3"]
        assert now <= before, (r, now, before)
    assert one["row_proj"] is True
