"""The collectives the layers call on one mesh axis.

The reference's collectives are XLA's (``psum``, ``all_to_all``,
``ppermute`` inside ``shard_map``); here each becomes a
``torch.distributed`` call on the process group of one mesh axis:
NCCL on the card, gloo on the CPU. :class:`Group` wraps that process
group with the four calls the layers need (``all_reduce``,
``all_gather``, ``all_to_all`` and point-to-point ``exchange``).

On NCCL every call is issued on the device, so a decode chunk that makes
them captures them in its CUDA graph. Gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``: on a gloo group the other calls copy a
CUDA tensor to the host and back (``Group.staged``). That choice is made
from the group's backend when the group is built, and printed; it is
never made by catching a failure. A gloo group cannot be captured in a
graph (``Group.graphable``).

Calls are issued at every group size, 1 included, so a world of one
rank exercises the same calls as a larger one. Each call adds one to
its count (:func:`counts`), as a kernel wrapper does, so a caller can
read how many collectives a step made.

:class:`CountingGroup` is :class:`Group`'s sibling for an abstract mesh
(``launch/mesh.py: abstract_mesh``, the dry-run's): no process group,
the same four calls on ``meta`` tensors, each returning a meta tensor of
the shape the real call returns and telling the active op counter
(``roofline/op_cost.py``) its op, payload bytes and group size.

Under autograd (the training forward) the layers call the collectives
through the functions at the end of this module, each a
``torch.autograd.Function`` whose backward is the collective's adjoint
(Megatron-LM's *f* and *g*): :func:`copy_to_model` is the identity
forward and an all-reduce backward (a replicated tensor entering work
that each rank does on its own shard, so each rank's gradient is a
part), :func:`reduce_from_model` an all-reduce forward and the identity
backward (partial sums whose total every rank then uses alike),
:func:`gather_from_model` an all-gather forward and the rank's slice
backward, :func:`all_to_all` and :func:`exchange` their own reverse.
A region that every rank computes whole and alike (a whole ``unembed``,
a gathered norm) takes none of them: reducing its gradient would count
it once a rank.

Heads the model axis does not split (``sharding.gathered``, and the
``kv_seq`` decode cache) are gathered whole by :func:`gather_cols` (one
all-gather of a rank's columns of q, k and v; under autograd the whole
tensors enter work of the rank's own, so their gradient is summed
before the rank keeps its columns), the qseq attention's output goes
back from a rank's rows to its columns by :func:`rows_to_cols` (one
all-to-all, its own adjoint), and the partial softmaxes of the ranks'
shares of a ``kv_seq`` cache are merged by :func:`merge_partials`. Without grad (serving, or a tensor that needs none)
each function issues exactly the :class:`Group` call the layers made
before, in place where that call is. The backward collectives go
through the same group, so they are counted too, and on an abstract
mesh the dry-run sees them.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

_COUNTS: Dict[str, int] = collections.Counter()

# the flat gather's name in newer releases, the older one's otherwise
_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def counts() -> Dict[str, int]:
    """Collectives issued so far in this process, by call."""
    return dict(_COUNTS)


def reset_counts():
    _COUNTS.clear()


def add_counts(delta: Dict[str, int]):
    """Add the collectives a graph replay made (its capture counted them
    once and was taken back, as the kernel wrappers' counts are)."""
    for name, n in delta.items():
        _COUNTS[name] += n


def set_counts(snapshot: Dict[str, int]):
    _COUNTS.clear()
    _COUNTS.update(snapshot)


class Group:
    """One mesh axis's process group: ``size``, this rank's ``rank`` in
    it, its ``backend`` and the collectives on it."""

    def __init__(self, pg, name: str):
        self.pg, self.name = pg, name
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.backend = str(dist.get_backend(pg))
        self.staged = self.backend == "gloo"
        self.graphable = self.backend == "nccl"
        how = ("all_gather, all_to_all and send/recv of CUDA tensors go "
               "through host copies (gloo takes CUDA tensors only for "
               "all_reduce and broadcast)" if self.staged else
               "every collective is issued on the device")
        print(f"[comm] axis {name!r}: {self.size} rank(s) over "
              f"{self.backend}; {how}", flush=True)

    def global_rank(self, r: int) -> int:
        return dist.get_global_rank(self.pg, r)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        # repro: ignore[R002] gloo only: a graph never captures a gloo group
        return x.cpu() if self.staged and x.is_cuda else x.contiguous()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place; returns ``x``."""
        _COUNTS["all_reduce"] += 1
        dist.all_reduce(x, group=self.pg)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim``, in rank order."""
        _COUNTS["all_gather"] += 1
        h = self._host(x)
        buf = h.new_empty((self.size * h.shape[0],) + tuple(h.shape[1:]))
        _all_gather_flat(buf, h, group=self.pg)
        parts = buf.view((self.size,) + tuple(h.shape)).unbind(0)
        out = torch.cat(parts, dim=dim % x.ndim)
        return out.to(x.device) if out.device != x.device else out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s dim 0 in ``size`` equal chunks: chunk j goes to rank j,
        and chunk i of the result came from rank i."""
        _COUNTS["all_to_all"] += 1
        h = self._host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=self.pg)
        return out.to(x.device) if out.device != x.device else out

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]
                 ) -> List[torch.Tensor]:
        """Point-to-point: each ``(tensor, peer)`` of ``sends`` to its
        peer, each of ``recvs`` filled from its peer (peers are ranks of
        this group), all in one ``batch_isend_irecv``. Returns the
        received tensors (on the device of the ones passed)."""
        if not sends and not recvs:
            return []
        _COUNTS["send_recv"] += 1
        ops, got = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, self._host(t),
                                  self.global_rank(peer), group=self.pg))
        for t, peer in recvs:
            h = torch.empty(t.shape, dtype=t.dtype,
                            device="cpu" if self.staged else t.device)
            got.append((h, t))
            ops.append(dist.P2POp(dist.irecv, h, self.global_rank(peer),
                                  group=self.pg))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [h.to(t.device) if h.device != t.device else h
                for h, t in got]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingGroup:
    """One axis of an abstract mesh: ``size`` ranks, this one ``rank``
    (0 unless the mesh names another), no process group. Each call runs nothing, returns what the real call
    returns in shape and type (meta tensors), and adds ``(op, payload
    bytes, size)`` to the active op counter; outside a counter it
    raises. Payloads are the reference's (``roofline/analysis.py``): an
    all-reduce's tensor, an all-gather's output, an all-to-all's tensor,
    a point-to-point exchange's sends."""

    backend = "abstract"
    staged = graphable = False

    def __init__(self, size: int, name: str, rank: int = 0):
        self.size, self.name, self.rank = size, name, rank

    def global_rank(self, r: int) -> int:
        return r

    def _count(self, op: str, payload: int):
        from repro_torch.kernels import ops
        if not ops.COUNTERS:
            raise RuntimeError(f"{op} on abstract axis {self.name!r} outside "
                               f"an op counter: an abstract mesh only counts")
        _COUNTS[op] += 1
        ops.COUNTERS[-1].collective(op, payload, self.size)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all_reduce", _nbytes(x))
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim % x.ndim] *= self.size
        out = x.new_empty(shape)
        self._count("all_gather", _nbytes(out))
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all_to_all", _nbytes(x))
        return torch.empty_like(x)

    def exchange(self, sends, recvs) -> List[torch.Tensor]:
        if not sends and not recvs:
            return []
        self._count("send_recv", sum(_nbytes(t) for t, _ in sends))
        return [torch.empty_like(t) for t, _ in recvs]


# -- differentiable collectives (the training forward) ------------------------


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _fresh(g: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of its own (a gradient autograd hands over may
    be shared or strided; an in-place collective needs neither)."""
    return g.clone(memory_format=torch.contiguous_format)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grp.all_reduce(_fresh(g)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return grp.all_reduce(_fresh(x))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return grp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        mine = g.chunk(ctx.grp.size, ctx.dim)[ctx.grp.rank]
        return mine.contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return grp.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        # chunk i of the output came from rank i: its gradient goes back
        return ctx.grp.all_to_all(g.contiguous()), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grp, send_peers, recvs, *sends):
        ctx.grp, ctx.send_peers = grp, send_peers
        ctx.recv_peers = [peer for _, peer in recvs]
        ctx.send_like = [torch.empty_like(t, device="meta") for t in sends]
        ctx.devices = [t.device for t in sends]
        return tuple(grp.exchange(list(zip(sends, send_peers)), recvs))

    @staticmethod
    def backward(ctx, *gs):
        # the received tensors' gradients go back to their senders; the
        # sent ones' come back from their receivers
        back = ctx.grp.exchange(
            [(g.contiguous(), peer) for g, peer in zip(gs, ctx.recv_peers)],
            [(torch.empty(t.shape, dtype=t.dtype, device=dev), peer)
             for t, dev, peer in zip(ctx.send_like, ctx.devices,
                                     ctx.send_peers)])
        return (None, None, None, *back)


def copy_to_model(grp, x):
    """Megatron's *f*: ``x`` as it is; under autograd its gradient is
    summed over ``grp`` in backward (``x`` is replicated and each rank's
    work on it gives part of its gradient). None ``grp``, or a group of
    one rank: ``x``, not recorded (its backward is the identity there, and
    leaving it out keeps the order in which autograd adds ``x``'s
    gradients, so a meshed step at axis size 1 is the unmeshed one bit
    for bit)."""
    if grp is None or grp.size == 1 or not needs_grad(x):
        return x
    return _Copy.apply(x, grp)


def reduce_from_model(grp, x):
    """Megatron's *g*: ``x`` summed over ``grp`` (in place without grad,
    as ``Group.all_reduce``); backward passes the gradient through, as
    every rank uses the sum alike. None ``grp``: ``x``."""
    if grp is None:
        return x
    if not needs_grad(x):
        return grp.all_reduce(x)
    return _Reduce.apply(x, grp)


def sum_over(grp, x):
    """``x`` summed over ``grp`` where each rank then uses the sum in
    work of its own: both directions all-reduce (:func:`reduce_from_model`
    after :func:`copy_to_model`). One collective without grad."""
    return copy_to_model(grp, reduce_from_model(grp, x))


def gather_from_model(grp, x, dim: int):
    """The ranks' ``x`` concatenated along ``dim`` (``Group.all_gather``);
    backward keeps this rank's slice of the gradient, which every rank
    holds whole."""
    if not needs_grad(x):
        return grp.all_gather(x, dim)
    return _Gather.apply(x, grp, dim)


def all_to_all(grp, x):
    """``Group.all_to_all``; backward sends each chunk's gradient back to
    the rank it came from (the same exchange)."""
    if not needs_grad(x):
        return grp.all_to_all(x)
    return _AllToAll.apply(x, grp)


def exchange(grp, sends, recvs):
    """``Group.exchange``; backward runs the reversed exchange (each
    received tensor's gradient to its sender, each sent tensor's
    gradient from its receiver)."""
    if not needs_grad(*(t for t, _ in sends)):
        return grp.exchange(sends, recvs)
    return list(_Exchange.apply(grp, [peer for _, peer in sends],
                                list(recvs), *(t for t, _ in sends)))



# -- whole heads over the model axis (sharding.gathered, kv_seq) --------------


def gather_cols(grp, *ts):
    """Each of ``ts`` (..., c_i), this rank's columns of a tensor split
    evenly over ``grp`` along its last dim, whole (..., n * c_i, the
    ranks' columns in rank order), from one all-gather of their
    concatenation. Under autograd the whole tensors enter work of the
    rank's own (attention over its query rows, its channels of a
    recurrent block), so their gradient is summed over the group
    (:func:`copy_to_model`) before the gather's backward keeps the rank's
    columns. At a group of one rank under autograd ``ts`` come back as
    they are (the gather is the identity there; the concatenation would
    change the order in which autograd adds their gradients, and a
    size-1 mesh trains bit for bit as no mesh)."""
    if grp.size == 1 and needs_grad(*ts):
        return list(ts)
    widths = [t.shape[-1] for t in ts]
    cat = torch.cat(ts, dim=-1) if len(ts) > 1 else ts[0]
    whole = copy_to_model(grp, gather_from_model(grp, cat, -1))
    parts = whole.unflatten(-1, (grp.size, sum(widths))).split(widths, -1)
    return [t.flatten(-2) for t in parts]


def rows_to_cols(grp, o):
    """``o`` (B, m, C): this rank's m rows (of n * m, rank r's the r-th
    run) of every column. Returns (B, n * m, C / n): every row of this
    rank's columns, from one all-to-all (the qseq attention's output
    handed back to the column slices its row-parallel ``wo`` reads)."""
    B, m, C = o.shape
    n = grp.size
    x = o.reshape(B, m, n, C // n).permute(2, 0, 1, 3).contiguous()
    y = all_to_all(grp, x)               # chunk i: rank i's rows
    return y.permute(1, 0, 2, 3).reshape(B, n * m, C // n)


def merge_partials(grp, o, lse):
    """The softmax over every rank's keys from each rank's partial one
    (the kv_seq decode step: each rank attends its share of a cache's
    positions, ``ops.decode_attention(return_lse=True)``). ``o`` (..., hd)
    f32, normalised over this rank's keys; ``lse`` (...) f32 their
    log-sum-exp, ``-inf`` where the rank holds none. Returns ``sum_r
    exp(lse_r - M) o_r / sum_r exp(lse_r - M)`` (M the rows' largest
    ``lse``), f32: one all-gather of ``lse`` and one all-reduce of the
    weighted ``o``. A rank with no key weighs 0; a row no rank holds a
    key of gives 0, as the kernel does. All on the device: a graph
    captures it."""
    every = grp.all_gather(lse[None], 0)                 # (n, ...)
    top = every.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(every - top)
    den = w.sum(dim=0)
    mine = w[grp.rank] / torch.where(den > 0, den, torch.ones_like(den))
    return grp.all_reduce(o * mine[..., None])
