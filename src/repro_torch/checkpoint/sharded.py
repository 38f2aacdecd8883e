"""Checkpoints: one ``.npy`` per tree leaf plus a JSON manifest, the
reference's layout (``repro.checkpoint.sharded``), so each package loads
the other's.

Layout::

  <dir>/step_00000120/manifest.json
  <dir>/step_00000120/<flat-key>.npy

A tree is a nest of dicts, lists and tuples; its leaves are tensors (any
device) or numpy arrays. Keys flatten as the reference's (dict keys
sorted, ``a.b[0]``). A bfloat16 leaf is stored as its ``uint16`` bits
with ``"dtype": "bfloat16"`` in the manifest (the reference's
convention; numpy has no bfloat16 here). A checkpoint is written into
``step_N.tmp`` and renamed into place, so a partial one never loads.
Loading gives CPU tensors, bfloat16 restored from its bits.

The port writes its training state in the reference's pytree
(``models/convert.py``: ``params_to_tree``, ``opt_state_to_tree``), so a
JAX checkpoint of ``{"p": params, "o": opt_state}`` loads here and the
port's loads into ``repro.checkpoint.load_checkpoint``.

A sharded training state is written whole, in the same layout: the
launcher (``launch/train.py: train_tree``) gathers each leaf over the
``model`` axis on the training thread, one leaf at a time
(``distributed/sharding.py: unshard_params``, the inverse of
``shard_params``' cut), and one rank hands the whole tree to its
:class:`AsyncCheckpointer`, whose worker only writes. Loading gives the
whole tree; ``launch/train.py: restore_into`` cuts each leaf to the
loading rank's shard, so a checkpoint taken at one model axis loads at
any other, and in the reference.
"""
from __future__ import annotations

import json
import pathlib
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(spec, flat: Dict[str, Any], prefix=""):
    if isinstance(spec, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}.{k}" if prefix else
                                   str(k)) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_unflatten_into(v, flat, f"{prefix}[{i}]")
                     for i, v in enumerate(spec))
    if isinstance(spec, list):
        return [_unflatten_into(v, flat, f"{prefix}[{i}]")
                for i, v in enumerate(spec)]
    return flat[prefix]


def _key_to_fname(key: str) -> str:
    return re.sub(r"[^\w.\-\[\]]", "_", key) + ".npy"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, manifest dtype) of a leaf: a bf16 tensor or a
    numpy bfloat16 array as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(path, tree, step: int, *, extra: Optional[dict] = None):
    d = pathlib.Path(path) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "keys": {}, "extra": extra or {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        manifest["keys"][key] = {"file": _key_to_fname(key), "dtype": dtype}
        np.save(tmp / _key_to_fname(key), arr)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)  # atomic publish: partial checkpoints never load
    return d


def latest_step(path) -> Optional[int]:
    p = pathlib.Path(path)
    if not p.exists():
        return None
    steps = [int(x.name.split("_")[1]) for x in p.iterdir()
             if x.is_dir() and x.name.startswith("step_")
             and (x / "manifest.json").exists()]
    return max(steps) if steps else None


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def load_checkpoint(path, like_tree, step: Optional[int] = None
                    ) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like_tree`` (leaves tensors, on
    any device, ``"meta"`` included, or arrays): every leaf's shape and
    type are checked against it. Returns ``(tree of CPU tensors, step,
    extra)``; ``step`` None loads the latest."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = pathlib.Path(path) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = _flatten(like_tree)
    if set(like) != set(manifest["keys"]):
        raise ValueError(f"{d}: keys differ from the tree's: "
                         f"{sorted(set(like) ^ set(manifest['keys']))[:8]}")
    flat = {}
    for key, meta in manifest["keys"].items():
        arr = np.load(d / meta["file"])
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want = (tuple(like[key].shape), _dtype_name(like[key]))
        if (tuple(t.shape), meta["dtype"]) != want:
            raise ValueError(f"{d}: {key} is {tuple(t.shape)} "
                             f"{meta['dtype']}, the tree wants {want}")
        flat[key] = t
    tree = _unflatten_into(like_tree, flat)
    return tree, manifest["step"], manifest.get("extra", {})


def tree_bytes(tree) -> int:
    return sum(v.nbytes if isinstance(v, np.ndarray) else
               v.numel() * v.element_size() for v in _flatten(tree).values())


class AsyncCheckpointer:
    """Background writer: ``save()`` copies the tree to host memory and
    returns (the training loop may then update its tensors in place);
    a worker thread writes it; ``wait()`` joins the writes and re-raises
    the first that failed. ``writes`` lists ``(step, bytes, seconds)`` of
    each finished write (``save_checkpoint`` alone, the copy to the host
    not counted)."""

    def __init__(self, path):
        self.path = path
        self.writes: List[Tuple[int, int, float]] = []
        self._errors: List[BaseException] = []
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._pending = 0
        self._lock = threading.Lock()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            tree, step, extra = item
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.path, tree, step, extra=extra)
                wrote = (step, tree_bytes(tree), time.perf_counter() - t0)
                with self._lock:
                    self.writes.append(wrote)
            except Exception as e:     # noqa: BLE001 -- re-raised by wait()
                with self._lock:
                    self._errors.append(e)
            finally:
                with self._lock:
                    self._pending -= 1

    def save(self, tree, step: int, *, extra: Optional[dict] = None):
        def host(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to("cpu", copy=True)
            return np.array(leaf, copy=True)
        host_tree = _unflatten_into(tree, {k: host(v) for k, v in
                                           _flatten(tree).items()})
        with self._lock:
            self._pending += 1
        self._q.put((host_tree, step, extra))

    def wait(self):
        while True:
            with self._lock:
                if self._pending == 0:
                    break
            time.sleep(0.01)
        with self._lock:
            if self._errors:
                raise self._errors[0]

    def close(self):
        """Finish the pending writes and stop the worker."""
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=60)
