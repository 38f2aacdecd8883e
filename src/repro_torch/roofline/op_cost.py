"""Count the work of a step as it runs: FLOPs, bytes, kernel calls and
collectives (the port's counterpart of ``repro.roofline.hlo_cost``).

The reference walks the HLO XLA compiled; an eager PyTorch step has no
such artifact, so :class:`OpCounter` counts the aten ops the step
dispatches, on ``meta`` tensors (the dry-run: nothing is allocated or
computed) or on real ones. Autograd's backward ops dispatch through it
too, so a train step's backward is counted.

- FLOPs: the products, ``2 * prod(out) * prod(contracting)`` as
  ``hlo_cost`` counts XLA's dots: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``_scaled_mm``, ``mv``, ``addmv``, ``dot`` (and ``mm``
  with an ``out_dtype``, a sharded row-parallel product's; einsum and
  ``matmul`` reach these). No other aten op adds FLOPs (elementwise
  arithmetic is left to the bytes). The port's paths reach no
  convolution or SDPA op; one of those raises rather than go uncounted.
- Bytes: an eager op reads its operands from HBM and writes its
  outputs there, so each op counts its tensor operands plus its
  outputs; an in-place op's output (an operand) is written once more.
  Views, reshapes, ``detach``, ``empty`` and other metadata ops cost 0.
  A gather (``index``, ``embedding``, ``index_select``, ``gather``)
  reads the rows it gathers, not its whole source; a scatter into
  place (``index_put_``, ``scatter_``, ...) reads its values and writes
  as many; ``copy_`` and ``fill_`` do not read their destination.
- Kernels: each ``kernels/ops.py`` call is one call of its kernel (the
  wrappers tell the counter, :data:`ops.COUNTERS`); on meta and on the
  card its cost is ``kernels/cost.py``'s (a kernel is no aten op), on
  the CPU its plain version's aten ops are what is counted.
- Collectives: an abstract mesh's ``comm.CountingGroup`` calls, each
  ``(op, payload bytes, group size)``.
- Memory: the live bytes of the storages the counted ops create,
  freed when their storage dies, and their peak: the counterpart of
  ``memory_analysis()``'s temp size. Tensors made before the counter
  (params, caches, the batch) are the arguments, not counted there.

A meta ``.item()`` or data-dependent shape raises as it would anyway:
the counter never guesses a value.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops

aten = torch.ops.aten

_MATMUL = {
    aten.mm.default, aten.addmm.default, aten.bmm.default,
    aten.baddbmm.default, aten._scaled_mm.default, aten.mv.default,
    aten.addmv.default, aten.dot.default,
}
if hasattr(aten.mm, "dtype"):      # a half-precision product's f32 result
    _MATMUL.add(aten.mm.dtype)
# ops that carry FLOPs this counter does not count: they must not pass
_UNCOUNTED = {
    name for name in ("convolution", "_convolution", "convolution_backward",
                      "_scaled_dot_product_flash_attention",
                      "_scaled_dot_product_efficient_attention",
                      "_scaled_dot_product_cudnn_attention",
                      "_scaled_dot_product_flash_attention_for_cpu")
}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "alias", "lift_fresh",
         "set_", "resize_", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type", "record_stream"}
_GATHERS = {"index", "embedding", "index_select", "gather"}
_SCATTERS = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_copy_", "index_add_"}
_COPIES = {"copy_", "_to_copy", "clone", "cat", "stack", "roll", "flip",
           "index", "embedding", "index_select", "gather", "index_put",
           "index_put_", "_index_put_impl_", "scatter", "scatter_",
           "scatter_add_", "index_copy_", "repeat",
           "constant_pad_nd", "fill_", "zero_", "zeros", "zeros_like",
           "ones", "ones_like", "full", "full_like", "new_zeros",
           "new_full", "new_ones", "arange", "masked_fill_"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _is_index(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def matmul_flops(func, args, out) -> int:
    """``2 * prod(out) * K`` of a product op (K its contracted length)."""
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        a = args[1]
    else:
        a = args[0]
    return 2 * _prod(out.shape) * int(a.shape[-1])


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step(...)``, then :meth:`result`. Also
    the active counter of ``kernels/ops.py`` and of the abstract mesh's
    collectives while it is entered."""

    def __init__(self):
        super().__init__()
        self.by_class: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: {"flops": 0, "bytes": 0, "ops": 0})
        self.kernels: Dict[str, int] = collections.Counter()
        self.kernel_cost: Dict[str, Dict[str, int]] = collections.defaultdict(
            lambda: {"flops": 0, "bytes": 0})
        self.coll_counts: Dict[str, int] = collections.Counter()
        self.coll_payload = 0
        self.coll_wire = 0.0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    # -- the mode --------------------------------------------------------

    def __enter__(self):
        ops.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _UNCOUNTED:
            raise NotImplementedError(f"op_cost does not count {func}")
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        self._op(func, name, args, ins, outs, out)
        self._track(ins, outs)
        return out

    def _op(self, func, name, args, ins, outs, out):
        flops, cls = 0, "elementwise"
        if func.is_view or name in _FREE:
            cls, nbytes = "view", 0
        elif func in _MATMUL:
            cls = "matmul"
            flops = matmul_flops(func, args, out)
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        elif name in _GATHERS:
            # the rows gathered, read and written; the indices read
            idx = sum(_nbytes(t) for t in ins[1:] if _is_index(t))
            nbytes = idx + 2 * sum(map(_nbytes, outs))
        elif name in _SCATTERS:
            # the values (the last operand) read and as many written; the
            # indices read
            vals = ins[-1] if len(ins) >= 3 else None
            nbytes = sum(_nbytes(t) for t in ins[1:] if t is not vals) \
                + (2 * _nbytes(vals) if vals is not None else 0)
        elif name in ("copy_",):
            nbytes = sum(map(_nbytes, ins[1:])) + _nbytes(ins[0])
        elif name in ("fill_", "zero_"):
            nbytes = _nbytes(ins[0])
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if cls == "elementwise" and name in _COPIES:
            cls = "copy"
        c = self.by_class[cls]
        c["flops"] += flops
        c["bytes"] += nbytes
        c["ops"] += 1

    def _track(self, ins, outs):
        """Register the storages ``outs`` create (not an input's) and
        free them when they die."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    # -- what the wrappers and the counting groups report ----------------

    def kernel(self, name: str, cost: Optional[tuple]):
        """One call of kernel ``name``; ``cost`` its ``(flops, bytes)``,
        or None where its aten ops are counted instead (the CPU)."""
        self.kernels[name] += 1
        if cost is None:
            return
        flops, nbytes = cost
        kc, c = self.kernel_cost[name], self.by_class["kernel"]
        kc["flops"] += flops
        kc["bytes"] += nbytes
        c["flops"] += flops
        c["bytes"] += nbytes
        c["ops"] += 1

    def collective(self, op: str, payload: int, n: int):
        from repro_torch.roofline.analysis import wire_bytes
        self.coll_counts[op] += 1
        self.coll_payload += payload
        self.coll_wire += wire_bytes(op, payload, n)

    # -- the result ------------------------------------------------------

    @property
    def flops(self) -> int:
        return sum(c["flops"] for c in self.by_class.values())

    @property
    def bytes(self) -> int:
        return sum(c["bytes"] for c in self.by_class.values())

    def result(self) -> dict:
        """Totals, per-class subtotals (``matmul``, ``kernel``, ``copy``,
        ``elementwise``, ``view``), kernel calls and their cost,
        collectives, and the peak of live bytes."""
        return {"flops": self.flops, "bytes": self.bytes,
                "by_class": {k: dict(v) for k, v in self.by_class.items()},
                "kernels": dict(self.kernels),
                "kernel_cost": {k: dict(v)
                                for k, v in self.kernel_cost.items()},
                "coll_counts": dict(self.coll_counts),
                "coll_payload": self.coll_payload,
                "coll_wire": self.coll_wire,
                "peak_bytes": self.peak}


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCounter result)``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.result()
