"""Dry-run every (arch x shape) cell: count a rank's step on ``meta``
tensors and record its roofline terms (the port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh one
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama-30b \\
        --shape decode_32k --mesh four

Nothing is allocated and no device is needed: params, optimizer state,
caches and the batch are meta tensors, the kernels count through their
cost functions (``kernels/ops.py``'s meta branch), and the collectives
through an abstract mesh (``launch/mesh.py: abstract_mesh``) whose
groups count them. The reference lowers and compiles each cell for a
TPU mesh; here :func:`trace_cell` runs the port's own step under
``roofline/op_cost.py``'s counter, as a rank of the mesh would:

- ``--mesh single|multi``: the reference's production meshes, (16, 16)
  ``data x model`` and (2, 16, 16) ``pod x data x model``;
- ``--mesh one``: the one H100 the port runs on (1 x 1);
- ``--mesh four``: ``data 1 x model 4``, the four cards of one host.

A rank's config is ``sharding.local_cfg``'s (its heads, KV heads, FFN
columns, experts and recurrent channels; every family shards, whisper's
encoder-decoder too; heads the model axis does not divide, such as
LLaMA-30B's 52 over 16, run gathered: their attention columns cut as
the reference's specs cut them, prefill and training attending the
reference's qseq way) and its batch the global one divided over the
data axes where they divide it (the reference's ``_fits``). A decode
cell counts the reference's ``kv_seq`` layout (``Runtime(kv_seq=True)``:
the dense cache's positions split over ``model``, every KV head; the
q/k/v gathers and the partial softmaxes' merge) at every mesh; at
``one`` that is the whole cache. What the port does not shard is
refused by ``sharding.check_tp`` and recorded as an error with its words
(ROADMAP A.9 step two: experts or a width that the model axis does not
divide). A train cell counts the sharded training step
(``training/optimizer.py: make_train_step`` under the mesh): the
forward's and backward's collectives (``distributed/comm.py``'s
differentiable ones), the partial gradients' sums over ``model``, the
gradients' sums over the data axes and the global norm's. At ``four``
every cell is counted. The port's decode step always writes its cache
in place, so ``--inplace-decode`` changes nothing (ROADMAP C.4).

Records: one JSON per cell under ``results/dryrun_torch/`` (the
reference's are under ``results/dryrun/``), with the reference's keys;
``trace_s`` stands for its ``lower_s``/``compile_s``, ``memory_analysis``
holds a rank's ``argument_size_in_bytes`` (params, AdamW state, cache,
batch), ``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of
live bytes the counted ops made), ``cache_bytes`` a rank's decode cache
(0 for train and prefill), and ``fits_hbm`` whether arguments and
temporaries fit in ``roofline.hw.H100.hbm_bytes``. Exits 1 if any cell
failed.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import abstract_mesh, data_axes, shape_of
from repro_torch.models import registry, transformer, whisper
from repro_torch.models.transformer import Runtime
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.training import optimizer as opt

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model")),
          "four": ((1, 4), ("data", "model"))}


def make_mesh(kind: str):
    """The abstract mesh of ``kind``, this process the last rank of its
    ``model`` axis: the critical one where a causal qseq split loads the
    ranks unevenly (rank r's query rows attend keys ``[0, (r + 1) S /
    n)``); every other count is the same on every rank."""
    shape, axes = MESHES[kind]
    return abstract_mesh(shape, axes,
                         {"model": shape[axes.index("model")] - 1})


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(t) for t in tree)
    return 0


def rank_batch(B: int, mesh) -> int:
    """A rank's share of a global batch of ``B`` over the mesh's data axes
    (the reference's ``_fits``: replicated where they do not divide it)."""
    n = math.prod(shape_of(mesh)[a] for a in data_axes(mesh))
    return B // n if B % n == 0 else B


def trace_cell(arch: str, shape_name: str, mesh, *, moe_shard_map=True,
               inplace_decode=True, kv_layout=None, overrides=None):
    """Count one rank's step of a cell on meta tensors. Returns (the
    counter's result, info: ``cfg``, ``shape``, ``arg``/``out`` bytes,
    the rank's batch)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ecfg = registry._effective_cfg(cfg, shape)
    if kv_layout:
        ecfg = ecfg.replace(decode_cache_layout=kv_layout)
    if overrides:
        ecfg = ecfg.replace(**overrides)
    n_model = sharding.model_size(mesh)
    sharding.check_tp(ecfg, n_model)
    rt = Runtime(mesh=mesh, moe_shard_map=moe_shard_map and bool(
        ecfg.moe_num_experts), inplace_decode=inplace_decode,
        kv_seq=shape.kind == "decode")
    api = registry.build(ecfg, rt=rt)
    b_loc = rank_batch(shape.global_batch, mesh)
    batch = {k: torch.empty((b_loc,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for k, v in api.input_specs(shape).items()}
    dtype = transformer.cache_dtype(ecfg)
    if ecfg.family == "audio":
        params = whisper.init_params(ecfg, device="meta", dtype=dtype,
                                     mesh=mesh)
    else:
        params = transformer.init_params(ecfg, device="meta", dtype=dtype,
                                         mesh=mesh)
    args = [params, batch]
    if shape.kind == "train":
        args.append(opt.adamw_init(params))
    elif shape.kind != "prefill":
        init = whisper.init_cache if ecfg.family == "audio" \
            else transformer.init_cache
        args.append(init(api.local_cfg, b_loc, shape.seq_len, dtype=dtype,
                         device="meta"))
    with OpCounter() as counter:
        if shape.kind == "train":
            out = opt.make_train_step(api, opt.AdamWConfig())(
                params, args[2], batch)
        elif shape.kind == "prefill":
            out = api.prefill(params, batch, max_seq=shape.seq_len)
        else:
            out = api.decode(params, args[2], batch["tokens"])
    return counter.result(), {"cfg": ecfg, "shape": shape,
                              "arg": tree_bytes(args),
                              "out": tree_bytes(out), "batch": b_loc,
                              "cache": tree_bytes(args[2]) if shape.kind
                              not in ("train", "prefill") else 0}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, force=False,
             moe_shard_map=True, tag="baseline", inplace_decode=True,
             kv_layout=None, overrides=None) -> dict:
    RESULTS.mkdir(parents=True, exist_ok=True)
    out_path = RESULTS / f"{mesh_kind}_{arch}_{shape_name}_{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    mesh = make_mesh(mesh_kind)
    sizes = shape_of(mesh)
    n_chips = math.prod(sizes.values())
    t0 = time.perf_counter()
    try:
        counted, info = trace_cell(arch, shape_name, mesh,
                                   moe_shard_map=moe_shard_map,
                                   inplace_decode=inplace_decode,
                                   kv_layout=kv_layout, overrides=overrides)
        t_trace = time.perf_counter() - t0
        mf = analysis.model_flops_for(info["cfg"], info["shape"])
        mem = {"argument_size_in_bytes": info["arg"],
               "output_size_in_bytes": info["out"],
               "temp_size_in_bytes": counted["peak_bytes"]}
        roof = analysis.analyze(
            counted, arch=arch, shape=shape_name,
            mesh_desc=f"{mesh_kind}:{sizes}", n_chips=n_chips,
            model_flops=mf, memory={"arg": info["arg"], "out": info["out"],
                                    "temp": counted["peak_bytes"]})
        rec = {"status": "ok", "arch": arch, "shape": shape_name,
               "mesh": mesh_kind, "tag": tag, "n_chips": n_chips,
               "trace_s": round(t_trace, 2), "memory_analysis": mem,
               "fits_hbm": info["arg"] + counted["peak_bytes"]
               <= H100.hbm_bytes,
               "rank_batch": info["batch"],
               "cache_bytes": info["cache"],
               "kernel_calls": counted["kernels"],
               "by_class": counted["by_class"], **roof.to_json()}
    except Exception as e:  # record failures — they are bugs to fix
        rec = {"status": "error", "arch": arch, "shape": shape_name,
               "mesh": mesh_kind, "tag": tag,
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count every (arch x shape) cell's step on meta "
                    "tensors (no device) and record its roofline terms on "
                    "the H100.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=tuple(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--moe-dense", action="store_true",
                    help="replicated MoE instead of the expert-parallel "
                         "exchange")
    ap.add_argument("--inplace-decode", action="store_true",
                    help="accepted: the port's decode step is always in "
                         "place")
    ap.add_argument("--kv-layout", default=None,
                    help="decode cache layout override, e.g. hkv_s")
    args = ap.parse_args(argv)

    print(f"dry-run on meta tensors (no device): mesh {args.mesh} "
          f"{MESHES[args.mesh]}, roofline on {H100.name}", flush=True)
    cells, skipped = all_cells()
    if not args.all:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    ok = fail = 0
    for arch, shape_name in cells:
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, args.mesh, force=args.force,
                       moe_shard_map=not args.moe_dense, tag=args.tag,
                       kv_layout=args.kv_layout)
        dt = time.perf_counter() - t0
        if rec["status"] == "ok":
            ok += 1
            print(f"[ok]   {args.mesh:6s} {arch:28s} {shape_name:12s} "
                  f"flops/dev={rec['hlo_flops']:.3e} "
                  f"bytes/dev={rec['hlo_bytes']:.3e} "
                  f"coll={rec['collective_wire']:.3e}B "
                  f"bottleneck={rec['bottleneck']:10s} ({dt:.0f}s)",
                  flush=True)
        else:
            fail += 1
            print(f"[FAIL] {args.mesh:6s} {arch:28s} {shape_name:12s} "
                  f"{rec['error']}", flush=True)
    if args.all:
        for arch, shape_name, why in skipped:
            print(f"[skip] {arch:28s} {shape_name:12s} {why}")
    print(f"done: {ok} ok, {fail} failed, {len(skipped) if args.all else 0} "
          f"documented skips")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
