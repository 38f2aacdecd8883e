"""Training launcher: data pipeline -> train loop -> async checkpoints
(the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama-30b \\
      --reduced --device cpu --steps 10

The reference's flags and defaults, except:

* the FULL config of ``--arch`` on ``--device`` (default ``cuda``), as
  the port's other entry points; ``--reduced`` trains the reduced config
  (the reference always does; the tests use ``--reduced --device cpu``).
  ``run(argv, cfg=...)`` trains a config of the caller's, such as a full
  one cut in depth to fit one card. As in the reference, the sequence is
  one cross-entropy chunk (``vocab_chunk = --seq``) and the weights are
  random, ``init_params(cfg, seed=0)``, in the config's type;
* before any weight is made, :func:`check_fits` refuses a config whose
  training state does not fit the card;
* the run is deterministic: ``torch.use_deterministic_algorithms(True)``
  (the embedding's backward sorts instead of adding with atomics) and
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (set if unset; it must be set
  before the process first uses cuBLAS), so ``--resume`` continues
  bit for bit;
* every step prints its loss, learning rate and host time (the card
  synchronized), not every tenth;
* checkpoints are the reference's layout and pytree
  (``{"p": params, "o": opt_state}``, ``extra["data"]`` the data
  state), so either package resumes from the other's.

``run(argv, cfg=, rt=)`` trains sharded, as the reference's step runs
under pjit (its launcher has no mesh flag either; the caller
initializes the process group and builds ``rt = Runtime(mesh)``): each
rank holds its shard of the params and AdamW state (``init_params(mesh=
)``), takes its data rank's rows of the global batch
(``training/data.py: rank_rows``), and steps through
``optimizer.make_train_step`` under the mesh; ``check_fits`` reckons one
rank's shard. A checkpoint is the whole model's: data rank 0's model
ranks gather each leaf over the ``model`` axis, one leaf at a time
(``sharding.unshard_params``), and the mesh's first rank writes it; a
resume cuts each whole leaf to the loading rank's shard, so a
checkpoint taken at one axis size loads at any other, and in the
reference. The mesh's first rank prints.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.checkpoint.sharded import tree_bytes
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import data_axes, shape_of
from repro_torch.launch.serve import device_line
from repro_torch.models import build, convert, whisper
from repro_torch.models.transformer import cache_dtype, init_params
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, PackedLM, rank_rows

BYTES_PER_PARAM = 12      # bf16 param and grad, f32 m and v
F32_TEMPS = 4             # f32 copies of one tensor alive in its update


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama-30b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (tests, CPU)")
    return ap.parse_args(argv)


def make_params(cfg, device, mesh=None):
    """Random weights of ``cfg`` (seed 0) in its type on ``device``; this
    rank's shard under a ``mesh``."""
    init = whisper.init_params if cfg.family == "audio" else init_params
    return init(cfg, seed=0, device=device, dtype=cache_dtype(cfg),
                mesh=mesh)


def train_state_bytes(cfg, mesh=None):
    """(bytes of params, grads, m and v at ``BYTES_PER_PARAM``, bytes of
    the largest tensor's f32 temporaries in its update), counted on the
    meta device: one rank's shard under a ``mesh``."""
    leaves = opt.tree_leaves(make_params(cfg, "meta", mesh))
    n = sum(t.numel() for t in leaves)
    return BYTES_PER_PARAM * n, 4 * F32_TEMPS * max(t.numel()
                                                   for t in leaves)


def check_fits(cfg, device, mesh=None):
    """Refuse, before any weight is made, a config whose training state
    (:func:`train_state_bytes`, one rank's shard under a ``mesh``)
    exceeds the card's memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    state, temps = train_state_bytes(cfg, mesh)
    have = torch.cuda.get_device_properties(dev).total_memory
    if state + temps > have:
        raise ValueError(
            f"{cfg.name}: its training state takes {state:,} bytes "
            f"({BYTES_PER_PARAM} a parameter) plus {temps:,} of f32 "
            f"temporaries, more than the {have:,} bytes of "
            f"{torch.cuda.get_device_name(dev)}; train a config cut in "
            f"depth through run(cfg=...)")


def _ranks(mesh):
    """(this rank's index over the data axes, their count, whether it is
    data rank 0, whether it is the mesh's first rank)."""
    if mesh is None:
        return 0, 1, True, True
    sizes = shape_of(mesh)
    di, n = 0, 1
    for a in data_axes(mesh):
        di = di * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    first = all(mesh.get_local_rank(a) == 0 for a in sizes)
    return di, n, di == 0, first


def train_tree(params, ostate, cfg, device, mesh=None, keep=True):
    """The checkpointed tree, in the reference's pytree, on ``device``.
    Under a ``mesh`` the whole model's: each leaf of the params, ``m``
    and ``v`` gathered over the ``model`` axis one at a time
    (``sharding.unshard_params``, to ``device``); ``keep=False`` (a rank
    that does not write) joins the gathers and returns None."""
    if mesh is not None:
        params, m, v = (sharding.unshard_params(t, cfg, mesh, device=device,
                                                keep=keep)
                        for t in (params, ostate["m"], ostate["v"]))
        if not keep:
            return None
        ostate = {"m": m, "v": v, "step": ostate["step"]}
    return {"p": convert.params_to_tree(params, cfg, device),
            "o": convert.opt_state_to_tree(ostate, cfg, device)}


def whole_tree(cfg):
    """:func:`train_tree` of the whole model on the meta device (the
    shapes a checkpoint holds)."""
    params = make_params(cfg, "meta")
    return train_tree(params, opt.adamw_init(params), cfg, "meta")


def restore_into(params, ostate, cfg, tree, mesh=None):
    """Copy a loaded reference-layout tree (CPU tensors, the whole
    model's) into the training state in place; under a ``mesh`` each
    leaf cut to this rank's shard first."""
    got_p = convert.params_from_numpy(tree["p"], cfg, "cpu", mesh=mesh)
    got_o = convert.opt_state_from_numpy(tree["o"], cfg, "cpu", mesh=mesh)
    with torch.no_grad():
        for dst, src in zip(opt.tree_leaves((params, ostate["m"],
                                             ostate["v"])),
                            opt.tree_leaves((got_p, got_o["m"],
                                             got_o["v"]))):
            dst.copy_(src)
    ostate["step"] = got_o["step"]


def _checkpointer(args, start, nbytes):
    """The run's ``AsyncCheckpointer``, once the disk under
    ``--ckpt-dir`` is found to hold every checkpoint the steps from
    ``start`` will write (``nbytes`` each; none is deleted)."""
    saves = sum(1 for i in range(start, args.steps)
                if i and i % args.ckpt_every == 0)
    pathlib.Path(args.ckpt_dir).mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(args.ckpt_dir).free
    if free < saves * nbytes:
        raise OSError(f"{args.ckpt_dir}: {free:,} bytes free, {saves} "
                      f"checkpoints of {nbytes:,} bytes to write")
    return AsyncCheckpointer(args.ckpt_dir)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None, cfg=None, rt=None):
    """Train and print per step; returns ``{"losses", "lrs",
    "grad_norms", "step_s", "params", "opt_state", "start", "writes",
    "read"}``: each trained step's loss, lr, grad norm and host seconds,
    the final state (on the device; this rank's shard under ``rt``'s
    mesh), the first step run, the checkpoint writes (``(step, bytes,
    seconds)``, the writing rank's) and the resume's read ``(bytes,
    seconds)`` or None."""
    args = parse_args(argv)
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced else \
            get_config(args.arch)
    cfg = cfg.replace(vocab_chunk=args.seq)
    dev = torch.device(args.device)
    check_fits(cfg, dev, None if rt is None else rt.mesh)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, cfg, dev, rt)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _train(args, cfg, dev, rt=None):
    mesh = None if rt is None else rt.mesh
    di, n_data, data0, first = _ranks(mesh)
    say = print if first else (lambda *a, **k: None)
    api = build(cfg, rt=rt)
    say(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e6:.1f}M params, batch {args.batch} x "
        f"seq {args.seq}" + ("" if mesh is None else
                             f", mesh {shape_of(mesh)}"))
    say(device_line(dev))
    params = make_params(cfg, dev, mesh)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=args.steps)
    ostate = opt.adamw_init(params)
    data = PackedLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    start, read, ckpt = 0, None, None
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        state, s, extra = load_checkpoint(args.ckpt_dir, whole_tree(cfg))
        read = (tree_bytes(state), time.perf_counter() - t0)
        restore_into(params, ostate, cfg, state, mesh)
        del state
        data.restore(extra["data"])
        start = s + 1
        say(f"resumed from step {s}")
    if args.ckpt_dir and first:
        ckpt = _checkpointer(args, start, tree_bytes(whole_tree(cfg)))

    step_fn = opt.make_train_step(api, ocfg)
    out = {"losses": [], "lrs": [], "grad_norms": [], "step_s": []}
    t_run = time.perf_counter()
    try:
        for i in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     rank_rows(data.batch_at(i), di, n_data).items()}
            data.step = i + 1
            _sync(dev)
            t0 = time.perf_counter()
            params, ostate, stats = step_fn(params, ostate, batch)
            _sync(dev)
            dt = time.perf_counter() - t0
            loss = float(stats["loss"])
            out["losses"].append(loss)
            out["lrs"].append(float(stats["lr"]))
            out["grad_norms"].append(float(stats["grad_norm"]))
            out["step_s"].append(dt)
            say(f"step {i:4d} loss={loss:.4f} lr={float(stats['lr']):.2e} "
                f"{dt * 1e3:.1f} ms")
            if args.ckpt_dir and data0 and i and i % args.ckpt_every == 0:
                tree = train_tree(params, ostate, cfg, "cpu", mesh,
                                  keep=first)
                if ckpt:
                    ckpt.save(tree, i, extra={"data": data.state()})
                del tree
    finally:
        if ckpt:
            ckpt.close()
    if mesh is not None:
        # every rank returns once the writer's checkpoints are on disk
        torch.distributed.barrier()
    dt = time.perf_counter() - t_run
    losses = out["losses"]
    k = max(len(losses) // 5, 1)
    if losses:
        say(f"{len(losses)} steps in {dt:.1f}s; loss "
            f"{np.mean(losses[:k]):.3f} -> {np.mean(losses[-k:]):.3f}")
    out.update(params=params, opt_state=ostate, start=start, read=read,
               writes=list(ckpt.writes) if ckpt else [])
    return out


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
