"""Synthetic-but-structured data pipeline: deterministic token streams with
document packing, sharded per data-parallel rank, infinitely resumable
(state = (epoch_seed, step) — restart-safe for checkpoint/restore).

A copy of ``repro.training.data`` (numpy only): ``batch_at(i)`` gives the
reference's arrays bit for bit, and ``tests/test_torch_isolation.py``
holds the code to the reference's.

The generator produces Zipf-distributed tokens with local n-gram structure so
the loss actually decreases during the example training runs (pure-uniform
tokens would pin the loss at ln(V)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.3


class PackedLM:
    """Documents sampled, concatenated, chunked to seq_len (+1 for targets)."""

    def __init__(self, cfg: DataConfig, *, rank: int = 0, world: int = 1):
        assert cfg.global_batch % world == 0
        self.cfg = cfg
        self.rank, self.world = rank, world
        self.local_batch = cfg.global_batch // world
        self.step = 0

    def _doc(self, rng) -> np.ndarray:
        n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
        # zipf body with a per-doc offset -> learnable bigram structure
        base = rng.zipf(self.cfg.zipf_a, n) % (self.cfg.vocab_size - 2)
        shift = rng.integers(1, 17)
        mix = (base + np.roll(base, 1) * shift) % (self.cfg.vocab_size - 2)
        doc = np.concatenate([[self.cfg.vocab_size - 1], mix.astype(np.int64)])
        return doc

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        need = self.cfg.seq_len + 1
        toks = np.zeros((self.local_batch, need), np.int64)
        for b in range(self.local_batch):
            rng = np.random.default_rng(
                (self.cfg.seed, step, self.rank, b))
            buf = []
            total = 0
            while total < need:
                d = self._doc(rng)
                buf.append(d)
                total += len(d)
            row = np.concatenate(buf)[:need]
            toks[b] = row
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1  # state() now points at the NEXT batch, so a
            yield b          # checkpoint taken mid-loop resumes correctly

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])


def rank_rows(batch: Dict[str, np.ndarray], rank: int, n: int
              ) -> Dict[str, np.ndarray]:
    """Data rank ``rank``'s rows of a global batch over ``n`` data ranks:
    the ``rank``-th of ``n`` equal runs of rows, as the reference's pjit
    splits the batch dim over its data axes (``launch/dryrun.py:
    rank_batch`` is the rule: the whole batch where ``n`` does not
    divide it)."""
    B = len(next(iter(batch.values())))
    if B % n:
        return batch
    b = B // n
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}

