"""Training driver: a small LM trained on the packed synthetic pipeline
with AdamW, the cosine schedule, async checkpoints and a mid-run restore
(the checkpoint/restart demo; the port of ``examples/train_e2e.py``).

  PYTHONPATH=src python -m repro_torch.launch.train_e2e --device cpu \\
      --steps 120

The reference's flags and defaults, plus ``--device`` (default ``cuda``,
as the port's other entry points). The model is the reduced LLaMA-30B
widened by ``--d-model``/``--layers`` (heads of 32, vocab 2048), random
weights from ``init_params(cfg, seed=0)``. At 60% of the run the state
is restored from the last checkpoint, as after a preemption. Without
``--outdir`` the checkpoints go to a temporary directory, removed at the
end. Exits non-zero if the loss did not drop.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import device_line
from repro_torch.launch.train import make_params, restore_into, train_tree
from repro_torch.models import build
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, PackedLM


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None):
    """The run; returns ``{"losses", "restored_at", "seconds"}``."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = get_reduced("llama-30b").replace(
        name="train-e2e", d_model=args.d_model, num_layers=args.layers,
        num_heads=args.d_model // 32, num_kv_heads=args.d_model // 32,
        head_dim=32, d_ff=args.d_model * 3, vocab_size=2048,
        vocab_chunk=args.seq)
    api = build(cfg)
    print(f"model: {cfg.num_layers}L d={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M")
    print(device_line(dev))

    params = make_params(cfg, dev)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt_state = opt.adamw_init(params)
    train_step = opt.make_train_step(api, ocfg)

    data = PackedLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    outdir = args.outdir or tempfile.mkdtemp(prefix="repro_ckpt_")
    ckpt = AsyncCheckpointer(outdir)

    losses = []
    t0 = time.time()
    restored_at = None
    try:
        for step, batch in enumerate(data):
            if step >= args.steps:
                break
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt_state, stats = train_step(params, opt_state, tb)
            losses.append(float(stats["loss"]))
            if step % 20 == 0:
                print(f"step {step:4d} loss={losses[-1]:.4f} "
                      f"lr={float(stats['lr']):.2e} "
                      f"gnorm={float(stats['grad_norm']):.2f}")
            if step and step % args.ckpt_every == 0:
                ckpt.save(train_tree(params, opt_state, cfg, "cpu"), step,
                          extra={"data": data.state()})
            # fault-tolerance demo: at 60% of the run, restore from the
            # last checkpoint (simulating a preemption + restart)
            if restored_at is None and step == int(args.steps * 0.6) \
                    and latest_step(outdir) is not None:
                ckpt.wait()
                state, s, extra = load_checkpoint(
                    outdir, train_tree(params, opt_state, cfg, "meta"))
                restore_into(params, opt_state, cfg, state)
                data.restore(extra["data"])
                restored_at = (step, s)
                print(f"-- simulated failure: restored step {s} "
                      f"checkpoint (was at {step}) --")
        ckpt.close()
    finally:
        if args.outdir is None:
            shutil.rmtree(outdir, ignore_errors=True)
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s)")
    k = max(len(losses) // 10, 1)
    print(f"loss: first10={np.mean(losses[:k]):.4f} "
          f"last10={np.mean(losses[-k:]):.4f} "
          f"(restore demo at {restored_at})")
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError("loss did not drop")
    print("training loss decreased")
    return {"losses": losses, "restored_at": restored_at, "seconds": dt}


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
