"""Logical-axis sharding rules and per-parameter PartitionSpecs (the port
of ``repro.distributed.sharding``).

The rules, ``set_rules``/``use_rules``/``get_mesh``, ``_resolve``, the
parameter patterns, ``param_spec``, ``tree_paths`` and
``params_pspec_tree`` are the reference's, over the port's own ``P`` (a
tuple: one entry a dim, ``None`` or a mesh axis name or a tuple of
them) and its mesh (``launch/mesh.py``: ``shape_of`` is the reference's
``mesh.shape``).

The reference leaves the layout to XLA's SPMD partitioner, so its
``constrain`` is a ``with_sharding_constraint``. The port is explicit
SPMD: every rank holds its shard and the layers place the collectives,
so ``constrain`` moves no data. Without rules it is a no-op, as in the
reference; under rules with a mesh it checks that the tensor's local
shape is what the logical spec implies on this rank, and raises if not.

Port-only: :func:`local_cfg` is the config one rank's shard of a tensor-
and expert-parallel model computes (:class:`RankConfig`: heads, KV heads,
the FFN width, the experts and the recurrent widths divided by the
``model`` axis), so the layer code runs unchanged on a rank's shard;
:func:`shard_params` cuts each weight to this rank's slice by its spec;
:func:`check_tp` refuses what the port does not shard (ROADMAP A.9 step
two: experts, ``d_model``, an FFN width, or attention columns that the
axis does not divide).

Heads the axis does not divide (LLaMA-30B's 52 at 8 or 16, gemma-2b's 8
and its one KV head at 16, xlstm's 4 at 8 or 16): the rank's config is
*gathered* (:func:`heads_split` false). Its ``wq``/``wk``/``wv`` take the
reference's plain column cut and ``wo`` its row cut, even where the cut
falls inside a head, and a head-wise mixer runs on whole heads gathered
over ``model``: prefill and training attend the reference's
``ATTN_QSEQ_RULES`` way (each rank all heads for its share of the query
rows, ``layers.qseq_attention``), decode over the ``kv_seq`` cache; the
xLSTM blocks run their recurrences on every head, their states whole on
every rank (the reference's cache spec replicates ``C``).

The ``kv_seq`` decode cache (the reference's ``DEFAULT_RULES["kv_seq"]``,
``transformer.Runtime(kv_seq=True)``, and every gathered config): rank r
holds positions ``[r R, (r + 1) R)`` of every KV head, ``R`` the cache's
rows over the axis (rounded up; a ring's rows must divide); whisper's
cross cache of ``encoder_seq`` frames is split the same way where the
axis divides them and stays whole where not (``_fits``). A decode step
gathers q, k and v to whole heads, writes the new K/V on the rank that
owns its position and merges the ranks' partial softmaxes
(``comm.merge_partials``); a prefill under it attends the qseq way and
its cache holds every KV head at every position (the wire a ``kv_seq``
decode engine inserts its share of). The paged engines keep the head
split and refuse it.

Where a rank's shard is not the plain cut of the reference's spec
(``_shard_tree``), or the spec leaves a weight whole and the layer takes
its part of the weight's input or output, the port differs thus, and
``param_spec`` stays the reference's. The last column says what a
rank's gradient of the weight is in the sharded training step
(:func:`grad_kinds`): **whole** where the rank computes it entire (its
shard's, or a whole weight's that every rank computes alike), or
**partial** where it covers only the rank's heads, channels or tokens
and must be summed over the ranks that hold the weight
(:func:`sync_grads`):

======================================  ==============================  =======
weight                                  what a rank holds or does       grad
======================================  ==============================  =======
``mlp|shared/wi`` (gated)               1/n of gate and 1/n of up       whole
``mamba/in_proj``, ``mlstm/w_up``       1/n of x and 1/n of z           whole
``slstm/w_in`` and its bias             1/n of each of z, i, f and o    whole
``slstm/ffn_wi``                        1/n of gate and 1/n of up       whole
``wk``/``wv`` (+ bias), replicated KV   the whole KV head its queries   partial
                                        read (never 1/n of              (over
                                        ``head_dim``)                   its
                                                                        ranks)
``wq``/``wk``/``wv`` (+ bias), gathered  1/n of the columns, a cut       whole
                                        inside a head; gathered to      (summed
                                        whole heads, ``wo`` row cut     in the
                                                                        gather)
``mamba/out_proj`` (whole)              ``y`` gathered before it        whole
``mlstm/w_if`` (whole) and its bias     its heads' i and f gates        partial
                                        sliced
``mlstm/gn`` (whole)                    its channels; the sum of        partial
                                        squares all-reduced
``slstm/gn`` (whole)                    ``y`` gathered, then the        whole
                                        whole norm
``slstm/r`` (whole)                     its heads sliced (gathered:     partial
                                        every head, whole: the input's  (whole)
                                        gates gathered)
``mm_projector`` (whole)                the whole patches projected     whole
``unembed``, vocab not dividing         whole: every logit on every     whole
                                        rank
``qnorm``/``knorm`` (whole)             applied to its heads            partial
``moe/router`` (whole)                  routes its tokens               partial
======================================  ==============================  =======

Every other weight is a plain cut (whole gradient of the shard) or
replicated and computed alike on every rank (whole): the embedding,
the norms, the biases of row-parallel projections.

Replicated KV: where the axis is a multiple of the KV heads' count
(gemma-2b's one KV head), each rank holds the one KV head its query
heads read, whole, so its cache, pages and wire hold that head.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import threading
from contextlib import contextmanager
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh as Mesh

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_group, shape_of

_state = threading.local()


class P(tuple):
    """A PartitionSpec: ``P(None, "model")`` is the tuple
    ``(None, "model")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "kv_seq": "model",       # decode KV cache: sequence-sharded (flash-decode)
    "experts": "model",
    "mamba_inner": "model",
    "state": None,
}

# Sequence-parallel variant: long-context activations shard seq over model.
SEQPAR_RULES = dict(DEFAULT_RULES, seq="model", kv_seq="model")

# MQA/GQA fix-up (heads % model != 0): shard attention on the QUERY sequence,
# force-replicate the (tiny) KV — stops XLA sharding head_dim and emitting
# partial-sum all-reduces per attention block. "qseq"/"kseq" are only
# constrained inside attention; the rest of the model keeps DEFAULT rules.
ATTN_QSEQ_RULES = dict(DEFAULT_RULES, qseq="model", kseq="force_replicated")


def set_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    _state.mesh = mesh
    _state.rules = dict(rules) if rules is not None else None


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextmanager
def use_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    old = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    set_rules(mesh, rules if rules is not None else DEFAULT_RULES)
    try:
        yield
    finally:
        set_rules(*old)


def _resolve(mesh, rules, logical_axes, ndim):
    spec = [None] * ndim
    forced = False
    for i, ax in enumerate(logical_axes):
        if ax is None:
            continue
        target = rules.get(ax)
        if target == "force_replicated":
            forced = True  # emit the constraint even if fully-None
            continue
        if target is None:
            continue
        names = target if isinstance(target, tuple) else (target,)
        names = tuple(n for n in names if n in shape_of(mesh))
        if names:
            spec[i] = names if len(names) > 1 else names[0]
    return P(*spec), forced


def _fits(shape, spec, sizes):
    """Replicate every spec axis that does not divide its dimension (the
    reference's rule, ``launch/dryrun.py: _fits`` and ``constrain``)."""
    out = []
    for i, s in enumerate(spec):
        names = () if s is None else s if isinstance(s, tuple) else (s,)
        n = 1
        for nm in names:
            n *= sizes[nm]
        out.append(s if names and shape[i] % n == 0 else None)
    return P(*out)


def local_shape(shape, spec, sizes):
    """Each dim of ``shape`` over the product of its spec entry's axis
    sizes (after :func:`_fits`)."""
    out = []
    for dim, s in zip(shape, _fits(shape, spec, sizes)):
        names = () if s is None else s if isinstance(s, tuple) else (s,)
        n = 1
        for nm in names:
            n *= sizes[nm]
        out.append(dim // n)
    return tuple(out)


def constrain(x, *logical_axes, full=None):
    """No-op without rules. Under rules with a mesh, checks that ``x``
    (this rank's tensor) has the local shape that the logical spec
    implies for the global shape ``full`` (``x.shape`` where None: a
    tensor the rules must leave whole), and raises if not. Moves no
    data: explicit SPMD has laid the tensor out already."""
    mesh = getattr(_state, "mesh", None)
    rules = getattr(_state, "rules", None)
    if mesh is None or rules is None:
        return x
    full = tuple(x.shape) if full is None else tuple(full)
    spec, _ = _resolve(mesh, rules, logical_axes, len(full))
    want = local_shape(full, spec, shape_of(mesh))
    if tuple(x.shape) != want:
        raise ValueError(
            f"constrain{logical_axes}: local shape {tuple(x.shape)}, the "
            f"spec {tuple(spec)} of {full} gives {want} on this rank")
    return x


# ---------------------------------------------------------------------------
# Per-parameter PartitionSpecs (pattern-matched on the param tree path)
# ---------------------------------------------------------------------------

# (regex on "/"-joined path, spec builder given leaf ndim). Specs are written
# for the *unstacked* param; a leading scan/stack dim is padded with None.
_PARAM_PATTERNS = [
    (r"embed$",                lambda: P(None, "model")),            # (V, d)
    (r"unembed$",              lambda: P(None, "model")),            # (d, V)
    (r"pos_embed$",            lambda: P(None, None)),
    (r"(wq|wk|wv)/w$",         lambda: P(None, "model")),            # col-par
    (r"wo/w$",                 lambda: P("model", None)),            # row-par
    (r"(wi|w_up|ffn_wi|w_in)/w$", lambda: P(None, "model")),
    (r"(w_down|ffn_wo)/w$",    lambda: P("model", None)),
    (r"moe/wi$",               lambda: P("model", None, None)),      # (E,d,f) EP
    (r"moe/wo$",               lambda: P("model", None, None)),
    (r"moe/router$",           lambda: P(None, None)),
    (r"shared/wi/w$",          lambda: P(None, "model")),
    (r"shared/wo/w$",          lambda: P("model", None)),
    (r"in_proj/w$",            lambda: P(None, "model")),            # mamba
    (r"conv_w$",               lambda: P(None, "model")),            # (K, di)
    (r"conv_b$",               lambda: P("model",)),
    (r"x_proj/w$",             lambda: P("model", None)),
    (r"dt_proj/w$",            lambda: P(None, "model")),
    (r"A_log$",                lambda: P("model", None)),
    (r"D$",                    lambda: P("model",)),
    (r"w_if/w$",               lambda: P(None, None)),               # tiny gates
    (r"skip$",                 lambda: P("model",)),
]


def param_spec(path: str, ndim: int, n_stacked_dims: int = 0) -> P:
    for pat, builder in _PARAM_PATTERNS:
        if re.search(pat, path):
            spec = builder()
            if len(spec) + n_stacked_dims == ndim:
                return P(*([None] * n_stacked_dims + list(spec)))
            return P(*([None] * ndim))  # rank mismatch (e.g. bias): replicate
    return P(*([None] * ndim))  # default: replicated


def tree_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(tree_paths(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def params_pspec_tree(params, *, stacked_prefixes=("blocks",)):
    """PartitionSpec pytree matching ``params``; block params get a leading
    None for the scan-stacking dimension."""
    def rec(tree, prefix="", stacked=False):
        if isinstance(tree, dict):
            return {k: rec(v, f"{prefix}/{k}" if prefix else str(k),
                           stacked or k in stacked_prefixes)
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            t = type(tree)
            return t(rec(v, f"{prefix}/{i}", stacked)
                     for i, v in enumerate(tree))
        n_stack = 1 if stacked else 0
        return param_spec(prefix, tree.ndim if hasattr(tree, "ndim")
                          else len(tree.shape), n_stack)
    return rec(params)


# ---------------------------------------------------------------------------
# Port-only: the rank-local config and parameters
# ---------------------------------------------------------------------------

STEP_TWO = "is not sharded over a model axis larger than 1 yet " \
    "(ROADMAP A.9 step two)"


def heads_split(cfg, n: int) -> bool:
    """Whether a ``model`` axis of ``n`` splits ``cfg``'s attention (or
    xLSTM) heads: the axis divides the query heads, and the KV heads or
    their count divides the axis (replicated KV needs whole query groups
    a rank). Otherwise the rank's config is gathered (the module's
    docstring)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return H % n == 0 and (Hkv % n == 0 or n % Hkv == 0)


def tp_refusals(cfg, n: int):
    """What keeps ``cfg`` from running tensor- and expert-parallel over a
    ``model`` axis of ``n`` ranks (empty at ``n == 1``): experts or a
    ``d_model`` that the axis does not divide, an FFN width, a shared
    expert's or an sLSTM's, whose gate and up halves it does not divide
    (a whole row-parallel ``wo`` would be summed ``n`` times), and, where
    it does not split the heads (:func:`heads_split`), attention columns
    ``q_dim``/``kv_dim`` that it does not divide (no column cut). Heads
    the axis does not divide are no refusal: they run gathered. A
    vocabulary that does not divide leaves ``unembed`` whole (``_fits``),
    which needs nothing."""
    from repro_torch.models import xlstm
    if n == 1:
        return []
    widths = [("an FFN of", cfg.d_ff)]
    if cfg.moe_shared_expert:
        widths.append(("a shared expert of", cfg.moe_d_ff))
    if cfg.family == "ssm":
        widths.append(("an sLSTM FFN of", xlstm.slstm_ffn_width(cfg) // 2))
    elif not heads_split(cfg, n):
        widths += [(f"{cfg.num_heads} heads over q_dim", cfg.q_dim),
                   (f"{cfg.num_kv_heads} KV heads over kv_dim", cfg.kv_dim)]
    why = [name for name, on in (
        (f"{cfg.moe_num_experts} experts",
         cfg.moe_num_experts and cfg.moe_num_experts % n),
        (f"d_model {cfg.d_model}", cfg.d_model % n),
        *((f"{what} {f}", f and f % n) for what, f in widths)) if on]
    return why


def check_tp(cfg, n: int):
    why = tp_refusals(cfg, n)
    if why:
        raise NotImplementedError(
            f"{cfg.name} with {', '.join(why)} {STEP_TWO}; model axis {n}")


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """The config one rank of a ``model`` axis of ``model_axis`` ranks
    computes (:func:`rank_cfg`): a ``ModelConfig`` whose heads, KV heads,
    FFN width and experts are the rank's, and whose recurrent widths
    follow ``model_axis``: the Mamba inner width here, the mLSTM and
    sLSTM widths in ``models/xlstm.py`` (:func:`split_of`). ``d_model``
    stays whole: the residual stream is whole on every rank.

    ``gathered``: the axis does not split the heads; ``num_heads`` and
    ``num_kv_heads`` are then the whole model's, the rank holding
    ``q_dim / n`` and ``kv_dim / n`` columns of the projections.
    ``kv_seq``: the dense decode cache is split by sequence and holds
    every KV head (always where gathered). ``heads_whole`` and
    ``kv_heads_whole``: the whole model's counts (:func:`whole_heads`)."""
    model_axis: int = 1
    gathered: bool = False
    kv_seq: bool = False
    heads_whole: int = 0
    kv_heads_whole: int = 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model // self.model_axis


def split_of(cfg) -> int:
    """The ``model`` axis a config's recurrent widths are divided over (1
    for a whole model's config)."""
    return getattr(cfg, "model_axis", 1)


def gathered(cfg) -> bool:
    """Whether a rank's config runs its heads gathered (:class:`RankConfig`;
    False for a whole model's config)."""
    return getattr(cfg, "gathered", False)


def kv_seq(cfg) -> bool:
    """Whether a rank's config splits its dense decode cache by sequence
    and attends whole heads the kv_seq and qseq way (False for a whole
    model's config)."""
    return getattr(cfg, "kv_seq", False)


def whole_heads(cfg):
    """``(query heads, KV heads)`` of the whole model a config is a rank
    of (its own where it is whole)."""
    return (getattr(cfg, "heads_whole", 0) or cfg.num_heads,
            getattr(cfg, "kv_heads_whole", 0) or cfg.num_kv_heads)


@functools.lru_cache(maxsize=None)
def rank_cfg(cfg, n: int, kv_seq: bool = False):
    """:func:`local_cfg` for a ``model`` axis of ``n`` ranks: ``n``-th of
    the query heads, the KV heads (one where the axis is a multiple of
    their count: replicated KV), the dense FFN width and the experts
    (MoE interleaved with dense layers divides both), and of the
    recurrent widths (:class:`RankConfig`); where the axis does not split
    the heads (:func:`heads_split`) the head counts stay whole and the
    config is gathered, its decode cache ``kv_seq``. ``kv_seq`` asks for
    that cache (and the qseq prefill) where the heads split too."""
    check_tp(cfg, n)
    if n == 1:
        return cfg
    split = heads_split(cfg, n)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw.update(d_ff=cfg.d_ff // n, model_axis=n, gathered=not split,
              kv_seq=kv_seq or not split, heads_whole=cfg.num_heads,
              kv_heads_whole=cfg.num_kv_heads)
    if split:
        kw.update(num_heads=cfg.num_heads // n,
                  num_kv_heads=max(cfg.num_kv_heads // n, 1))
    if cfg.moe_num_experts:
        kw["moe_num_experts"] = cfg.moe_num_experts // n
    return RankConfig(**kw)


def model_size(mesh) -> int:
    return 1 if mesh is None else shape_of(mesh).get("model", 1)


def local_cfg(cfg, mesh, kv_seq: bool = False):
    """The config one rank of ``mesh``'s ``model`` axis computes
    (:func:`rank_cfg`; ``kv_seq``: the sequence-split decode cache).
    ``cfg`` itself at axis size 1 or without a mesh, where the kv_seq
    layout is the whole cache; raises (:func:`check_tp`) for what this
    step does not shard."""
    return rank_cfg(cfg, model_size(mesh), kv_seq)


def kv_replicated(cfg, n: int) -> bool:
    """Whether a ``model`` axis of ``n`` replicates ``cfg``'s KV heads:
    the axis splits the query heads but has more ranks than KV heads, so
    each rank holds the one its query heads read (the reference's
    ``ATTN_QSEQ_RULES`` replicate the KV whole rather than split
    ``head_dim``). A gathered config cuts the KV columns instead."""
    return (cfg.num_kv_heads % n != 0 and n % cfg.num_kv_heads == 0
            and cfg.num_heads % n == 0)


def kv_head_of(cfg, n: int, r: int) -> int:
    """The KV head rank ``r`` holds under replicated KV."""
    return r // (n // cfg.num_kv_heads)


def _split_dim(spec):
    """The dim a spec splits over ``model`` (None if replicated there)."""
    for i, s in enumerate(spec):
        names = () if s is None else s if isinstance(s, tuple) else (s,)
        if "model" in names:
            return i
    return None


def _cut(t, dim, r, n, chunks=1):
    """Rank r's 1/n of ``t`` along ``dim``; a last dim of ``chunks``
    concatenated outputs (``[gate | up]``, Mamba's ``[x | z]``, the
    sLSTM's ``[z | i | f | o]``) gives each chunk's 1/n, in order (a
    contiguous split would give rank 0 all of the first). A new tensor:
    the full one can be freed."""
    if chunks > 1:
        return torch.cat([h.chunk(n, dim)[r] for h in t.chunk(chunks, dim)],
                         dim=dim)
    return t.chunk(n, dim)[r].clone()


# column-parallel weights whose output is ``chunks`` concatenated parts:
# (weight path, chunks; None: 2 where the MLP is gated)
_CHUNKED = ((r"(^|/)(mlp|shared)/wi/w$", None),
            (r"(^|/)mamba/in_proj/w$", 2),
            (r"(^|/)mlstm/w_up/w$", 2),
            (r"(^|/)slstm/w_in/w$", 4),
            (r"(^|/)slstm/ffn_wi/w$", 2))


def _chunks_of(path, gated):
    for pat, chunks in _CHUNKED:
        if re.search(pat, path):
            return (2 if gated else 1) if chunks is None else chunks
    return 1


def _leaf_specs(tree):
    """The reference's spec of each leaf of a port parameter tree (one
    layer's dict, or the model's top level), through the reference's
    nesting (``convert.nest``: ``wq`` -> ``wq/w``, ``wq_b`` -> ``wq/b``):
    ``{id(leaf): (spec, path)}``."""
    from repro_torch.models import convert
    return {id(t): (param_spec(path, t.ndim), path)
            for path, t in tree_paths(convert.nest(tree)).items()}


def _rules(tree, n, cfg):
    """How each leaf of a whole parameter tree (one layer's dict, or the
    model's top level) is cut over a ``model`` axis of ``n``: ``{id(leaf):
    rule}``, a rule None (kept whole), ``"kv"`` (replicated KV: the head
    a rank's queries read) or ``(dim, chunks)`` (:func:`_cut`)."""
    specs = _leaf_specs(tree)
    gated = cfg.mlp_type in ("silu", "geglu")
    rep_kv = kv_replicated(cfg, n)
    out = {}

    def rec(sub):
        for k, v in sub.items():
            if isinstance(v, dict):
                rec(v)
            else:
                out[id(v)] = leaf(sub, k, v)

    def leaf(sub, k, t):
        spec, path = specs[id(t)]
        if k.endswith("_b") and k[:-2] in sub:      # a projection's bias
            wspec, path = specs[id(sub[k[:-2]])]
            if _split_dim(wspec) != len(wspec) - 1:
                return None                         # row-parallel: whole
            spec = P(*([None] * (t.ndim - 1) + ["model"]))
        if rep_kv and re.search(r"(^|/)(attn|self_attn|cross_attn)/(wk|wv)/w$",
                                   path):
            return "kv"
        dim = _split_dim(_fits(t.shape, spec, {"model": n}))
        if dim is None:
            return None
        return dim, _chunks_of(path, gated) if dim == t.ndim - 1 else 1

    rec(tree)
    return out


def _shard_tree(tree, r, n, cfg):
    rules = _rules(tree, n, cfg)

    def rec(sub):
        return {k: rec(v) if isinstance(v, dict) else leaf(v)
                for k, v in sub.items()}

    def leaf(t):
        rule = rules[id(t)]
        if rule is None:
            return t
        if rule == "kv":
            # replicated KV: the whole head this rank's queries read
            return t.chunk(cfg.num_kv_heads, -1)[
                kv_head_of(cfg, n, r)].clone()
        return _cut(t, rule[0], r, n, rule[1])

    return rec(tree)


def shard_params(params, cfg, mesh):
    """This rank's shard of ``params`` (the whole model, or one layer's
    dict): each tensor cut along the dim its reference spec puts on
    ``model``, where the axis divides it (``_fits``), with the port's
    differences from a plain cut (the module's table); a
    column-parallel weight's bias follows its columns, a row-parallel
    one's stays whole (added once, after the reduce). A list of layers
    (``layers``, whisper's ``enc_layers`` and ``dec_layers``) is cut
    layer by layer. At axis size 1 (or without a mesh) the tensors are
    returned as they are."""
    n = model_size(mesh)
    if n == 1:
        return params
    r = mesh.get_local_rank("model")
    lists = {k for k, v in params.items() if isinstance(v, list)}
    top = _shard_tree({k: v for k, v in params.items() if k not in lists},
                      r, n, cfg)
    return {k: [_shard_tree(p, r, n, cfg) for p in v] if k in lists
            else top[k] for k, v in params.items()}


# ---------------------------------------------------------------------------
# Port-only: the sharded training step's gradients and checkpoints
# ---------------------------------------------------------------------------

# whole weights whose gradient a rank computes only for its heads,
# channels or tokens (the module's table: partial)
_PARTIAL = re.compile(r"(^|/)((attn|self_attn|cross_attn)/(qnorm|knorm)/scale"
                      r"|mlstm/(w_if/w|w_if/b|gn/scale)|slstm/r|moe/router)$")
_KV = re.compile(r"(^|/)(attn|self_attn|cross_attn)/(wk|wv)/(w|b)$")
_SLSTM_R = re.compile(r"(^|/)slstm/r$")


@functools.lru_cache(maxsize=None)
def whole_meta(cfg):
    """The whole model's parameters of ``cfg`` on the ``meta`` device
    (shapes and types, no data): what a rank's shard is cut from."""
    from repro_torch.models import transformer, whisper
    init = whisper.init_params if cfg.family == "audio" else \
        transformer.init_params
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return init(cfg, device="meta", dtype=dt)


def _walk(fn, *trees):
    """``fn`` over the leaves of trees of one structure (the port's
    params: dicts and lists), in order; returns a tree of its
    results."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _walk(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_walk(fn, *(x[i] for x in trees)) for i in range(len(t))]
    return fn(*trees)


def _per_dict(fn, whole):
    """``fn(dict)`` -> ``{id(leaf): value}`` of each layer's dict and of
    the top level's leaves, merged."""
    lists = {k for k, v in whole.items() if isinstance(v, list)}
    out = fn({k: v for k, v in whole.items() if k not in lists})
    for k in lists:
        for sub in whole[k]:
            out.update(fn(sub))
    return out


@functools.lru_cache(maxsize=None)
def grad_kinds(cfg, n: int):
    """A tree like the params of ``cfg`` (``whole_meta``'s structure)
    holding, for each leaf, what a rank's gradient of it is over a
    ``model`` axis of ``n`` (the module's table): ``"sharded"`` (the
    rank's cut of a split weight, whole; a column cut inside a head too,
    whose gathered columns are summed in backward), ``"whole"`` (a whole
    weight every rank computes alike: the gathered sLSTM's ``r``),
    ``"partial"`` (summed over the axis) or ``"kv"`` (a replicated KV
    head: summed over the ranks that hold it).
    """
    from repro_torch.models import convert
    whole = whole_meta(cfg)
    # gathered sLSTM: every rank runs every head of the whole r alike
    whole_r = n > 1 and not heads_split(cfg, n)

    def kinds(tree):
        paths = {id(t): p for p, t in tree_paths(convert.nest(tree)).items()}
        rules = _rules(tree, n, cfg) if n > 1 else {}
        out = {}
        for i, path in paths.items():
            if whole_r and _SLSTM_R.search(path):
                out[i] = "whole"
            elif _PARTIAL.search(path):
                out[i] = "partial"
            elif rules.get(i) == "kv" or (n > 1 and kv_replicated(cfg, n)
                                          and _KV.search(path)):
                out[i] = "kv"
            else:
                out[i] = "whole" if rules.get(i) is None else "sharded"
        return out

    ids = _per_dict(kinds, whole)
    return _walk(lambda t: ids[id(t)], whole)


def sync_grads(grads, cfg, mesh):
    """Complete a rank's gradients after backward: each ``"partial"``
    leaf (:func:`grad_kinds`) summed over the ``model`` axis, each
    replicated KV head's summed over the ranks that hold that head (one
    all-reduce of a buffer with a slot a head). In place; returns
    ``grads``. Every rank then holds its shard's gradient and the same
    bytes of each whole weight's. At axis size 1 the sums are issued and
    change nothing."""
    n = model_size(mesh)
    grp = axis_group(mesh, "model")

    def fix(g, kind):
        if kind == "partial":
            grp.all_reduce(g)
        elif kind == "kv":
            h = kv_head_of(cfg, n, grp.rank)
            buf = g.new_zeros((cfg.num_kv_heads,) + tuple(g.shape))
            buf[h] = g
            g.copy_(grp.all_reduce(buf)[h])

    _walk(fix, grads, grad_kinds(cfg, n))
    return grads


def norm_share(cfg, mesh):
    """A tree like the params: how each leaf's squared sum on this rank
    enters the global gradient norm (``training/optimizer.py:
    global_norm``): ``"sum"`` (a shard: summed over the ``model`` axis),
    ``"once"`` (the same bytes on every rank: counted as it is), or, for
    a replicated KV head, ``"sum"`` on the first rank that holds it and
    ``"zero"`` on the others."""
    n = model_size(mesh)
    rank = axis_group(mesh, "model").rank
    first = n <= cfg.num_kv_heads or rank % (n // cfg.num_kv_heads) == 0
    share = {"sharded": "sum", "whole": "once", "partial": "once",
             "kv": "sum" if first else "zero"}
    return _walk(lambda k: share[k], grad_kinds(cfg, n))


def unshard_leaf(t, rule, grp, cfg):
    """The whole tensor of a rank's cut ``t`` (:func:`_rules`' ``rule``),
    gathered over the ``model`` group ``grp``: the inverse of
    :func:`_cut` (a chunked output's chunks put back in order) and of
    the replicated KV head's pick (each head from its first rank)."""
    n = grp.size
    if rule is None:
        return t
    if rule == "kv":
        g = grp.all_gather(t.contiguous(), -1).unflatten(-1, (n, -1))
        step = n // cfg.num_kv_heads
        return g[..., ::step, :].flatten(-2)
    dim, chunks = rule
    g = grp.all_gather(t.contiguous(), dim)
    if chunks == 1:
        return g
    dim %= g.ndim
    return g.unflatten(dim, (n, chunks, -1)).transpose(dim, dim + 1) \
        .flatten(dim, dim + 2)


def unshard_params(params, cfg, mesh, *, device="cpu", keep=True):
    """The whole model of a rank's shard (params, or AdamW's ``m`` or
    ``v``, shaped like them): each leaf gathered over the ``model`` axis
    (:func:`unshard_leaf`), one leaf at a time, and moved to ``device``
    before the next is gathered, so at most one whole leaf is on the
    card at a time. Every rank of the axis must call it (the gathers are
    collectives); ``keep=False`` drops each whole leaf once gathered (a
    rank that does not write). At axis size 1 the tensors are copied to
    ``device``."""
    n = model_size(mesh)
    grp = axis_group(mesh, "model")
    whole = whole_meta(cfg)
    rules = _per_dict(lambda tree: _rules(tree, n, cfg), whole) \
        if n > 1 else {}

    host = torch.device(device).type == "cpu" and grp.staged

    def one(t, w):
        # a gloo group gathers on the host anyway: go there first
        src = t.detach().to("cpu") if host else t.detach()
        g = unshard_leaf(src, rules.get(id(w)), grp, cfg)
        if tuple(g.shape) != tuple(w.shape):
            raise ValueError(f"gathered {tuple(g.shape)}, the whole model's "
                             f"is {tuple(w.shape)}")
        if not keep:
            return None
        shared = g.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
        return g.to(device, copy=shared)

    return _walk(one, params, whole)

