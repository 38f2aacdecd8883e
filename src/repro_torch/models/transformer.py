"""Decoder-only transformer of the pure-attention families (dense, MoE,
VLM): init, prefill, suffix prefill and the dense decode step (those
parts of ``repro.models.transformer``).

Parameters are plain dicts of tensors, one dict per layer instead of the
reference's layer-stacked pytree (``models/convert.py`` maps one onto the
other):

    {"embed": (V, d), "final_norm": N, "unembed": (d, V),
     "layers": [{"norm1": N, "norm2": N,
                 "attn": {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                          "wo": (qd, d)},
                 "mlp": {"wi": (d, 2*d_ff), "wo": (d_ff, d)}}, ...]}

where a norm ``N`` is an RMSNorm's ``(d,)`` scale or a LayerNorm's
``{"scale", "bias"}`` (``layers.norm_apply``). A parallel block
(``cfg.parallel_block``: attention and MLP read one shared norm) has no
``norm2``; tied embeddings (``cfg.tie_embeddings``) no ``unembed``. A
layer whose kind (``cfg.layer_kinds()``) is ``attn+moe`` holds ``"moe":
{"router": (d, E) f32, "wi": (E, d, 2 f), "wo": (E, f, d)}`` (plus an
MLP ``"shared"`` where ``cfg.moe_shared_expert``) in place of ``"mlp"``
(``models/moe.py``); the reference stacks such a stack in
``period_of(cfg)`` slots (llama4: a dense and a MoE layer), where layer
i is slot ``i % period``, index ``i // period``. Under ``cfg.qk_norm``
``attn`` also holds ``qnorm``/``knorm`` ``(hd,)`` f32 scales; a VLM has
``mm_projector (d, d)``, applied to patch embeddings that prefill puts
in front of the text.

A prefill cache is ``{"slot0": {"k", "v": (L, B, S, Hkv, hd)}, "lengths":
(B,)}``, the reference's layout. The port's prefill cache holds the S
computed positions; the reference pads it to ``max_seq`` with zeros that
the wire extraction never reads. A sliding-window stack holds at most
``window`` rows (:func:`cache_rows`): a longer prompt keeps its last
``window`` positions, rolled so that position p sits at row p % window,
the ring the decode step writes. The cache is written in place, layer by
layer.

A decode cache has the same layout at ``cache_rows(cfg, max_seq)``
positions (``init_cache``). Under ``cfg.decode_cache_layout == "hkv_s"``
the K/V tensors are the reference's ``(L, B, Hkv, rows, hd)`` cache, held
as its view ``transpose(2, 3)``: every index stays ``[layer, b, pos]``,
only the strides change (a head's positions lie contiguous, the decode
kernel reads them in place), and ``.transpose(2, 3)`` of a cache tensor
is the reference's tensor itself, no copy.

A logit softcap (``cfg.attn_logit_softcap``) caps every attention's
scaled scores (``c tanh(s / c)``, before the mask), in the kernels and
their plain versions alike. A recurrent stack with a sliding window
(jamba's long_500k cell) attends with the window in prefill and keeps
its last ``window`` positions as the decode step's ring. ``decode_step`` is the reference's
``decode_step`` / ``decode_step_inplace`` for the plain dense family: it
scatters the new token's K/V into the stacked cache IN PLACE (at
``lengths % window`` on a ring) and attends through the
``decode_attention`` kernel, which reads one layer of the cache where it
lies. The reference's dense step attends with plain jnp
(``layers.attention`` with ``kv_len``/``q_offset``, or
``_decode_attn_hkv``), not with its Pallas ``decode_attention``; the
kernel computes the same function.

:func:`forward` and :func:`loss_fn` are the training forward of every
family but whisper's (``models/whisper.py``), under autograd: the plain
versions of the norm and the attention, as the reference trains.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import axis_group, data_axes, shape_of
from repro_torch.models import layers, mamba, moe, xlstm
from repro_torch.models.layers import dense
from repro_torch.serving import trace as _trace


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def period_of(cfg) -> int:
    """Layers in one period of the stack's kinds (the reference's slots):
    the lcm of its interleave frequencies, or every layer where the
    depth is no multiple of it."""
    p = 1
    if cfg.family == "hybrid" and cfg.attn_period:
        p = _lcm(p, cfg.attn_period)
    if cfg.moe_num_experts and cfg.moe_every > 1:
        p = _lcm(p, cfg.moe_every)
    if cfg.family == "ssm" and cfg.xlstm_slstm_every:
        p = _lcm(p, cfg.xlstm_slstm_every)
    if cfg.num_layers % p != 0:
        p = cfg.num_layers  # irregular: unroll everything
    return p


def slot_kinds(cfg):
    """Kinds of the first ``period_of(cfg)`` layers (they repeat)."""
    kinds = cfg.layer_kinds()
    p = period_of(cfg)
    for i in range(p, cfg.num_layers):
        assert kinds[i] == kinds[i % p], (i, kinds[i], kinds[i % p])
    return kinds[:p]


class ParamMaker:
    """Random weights with the reference's scales, drawn directly in their
    type on ``device`` from one ``torch.Generator``, one tensor at a time
    (LLaMA-30B's 65 GB of bf16 weights, or one llama4 expert ``wi`` of
    21.5 GB, never pass through an f32 temporary). Shared by the decoder
    stacks here and ``models/whisper.py``. On the ``meta`` device it makes
    the shapes and types alone (no generator there)."""

    def __init__(self, cfg, seed: int, device, dtype):
        self.cfg, self.dtype = cfg, dtype
        self.dev = torch.device(device)
        self.gen = None if self.dev.type == "meta" else \
            torch.Generator(device=self.dev).manual_seed(seed)

    def normal(self, shape, scale, dt=None):
        return torch.randn(shape, generator=self.gen, device=self.dev,
                           dtype=dt or self.dtype).mul_(scale)

    def proj(self, name, d_in, d_out, *, bias=False, scale=None):
        """``{name: (d_in, d_out)}`` (normal * 1/sqrt(d_in) unless
        ``scale``), with a zero bias ``name_b`` where asked (the port's
        layout of the reference's ``dense_init``)."""
        out = {name: self.normal((d_in, d_out),
                                 scale or 1 / math.sqrt(d_in))}
        if bias:
            out[name + "_b"] = self.zeros(d_out)
        return out

    def zeros(self, n, dt=None):
        return torch.zeros((n,), dtype=dt or self.dtype, device=self.dev)

    def norm(self, n=None):
        """An RMSNorm's zero scale, or a LayerNorm's unit scale and zero
        bias."""
        zeros = self.zeros(n or self.cfg.d_model, torch.float32)
        if self.cfg.norm_type == "rmsnorm":
            return zeros
        return {"scale": torch.ones_like(zeros), "bias": zeros}

    def mlp(self, f=None):
        cfg, d = self.cfg, self.cfg.d_model
        f = f or cfg.d_ff
        gated = cfg.mlp_type in ("silu", "geglu")
        return {**self.proj("wi", d, 2 * f if gated else f,
                            bias=cfg.mlp_bias),
                **self.proj("wo", f, d, bias=cfg.mlp_bias)}

    def attn(self):
        cfg, d, b = self.cfg, self.cfg.d_model, self.cfg.attn_bias
        attn = {**self.proj("wq", d, cfg.q_dim, bias=b),
                **self.proj("wk", d, cfg.kv_dim, bias=b),
                **self.proj("wv", d, cfg.kv_dim, bias=b),
                **self.proj("wo", cfg.q_dim, d, bias=b)}
        if cfg.qk_norm:
            attn["qnorm"] = self.norm(cfg.head_dim)
            attn["knorm"] = self.norm(cfg.head_dim)
        return attn

    def moe(self):
        cfg, d = self.cfg, self.cfg.d_model
        E, f = cfg.moe_num_experts, cfg.moe_d_ff
        gated = cfg.mlp_type in ("silu", "geglu")
        out = {"router": self.normal((d, E), 1 / math.sqrt(d),
                                     torch.float32),
               "wi": self.normal((E, d, 2 * f if gated else f),
                                 1 / math.sqrt(d)),
               "wo": self.normal((E, f, d), 1 / math.sqrt(f))}
        if cfg.moe_shared_expert:
            out["shared"] = self.mlp(f)
        return out

    def mamba(self):
        cfg, d = self.cfg, self.cfg.d_model
        di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        dtr = cfg.mamba_dt_rank
        f32 = dict(dtype=torch.float32, device=self.dev)
        # S4D-real A, and dt's bias the inverse softplus of a dt drawn
        # log-uniform in [0.001, 0.1]
        A = torch.arange(1, ds + 1, **f32)[None, :].repeat(di, 1)
        u = torch.rand((di,), generator=self.gen, **f32)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        return {**self.proj("in_proj", d, 2 * di),
                "conv_w": self.normal((dc, di), 1 / math.sqrt(dc)),
                "conv_b": self.zeros(di),
                **self.proj("x_proj", di, dtr + 2 * ds),
                "dt_proj": self.normal((dtr, di), dtr ** -0.5),
                "dt_proj_b": torch.log(torch.exp(dt) - 1.0 + 1e-9),
                "A_log": torch.log(A), "D": torch.ones((di,), **f32),
                **self.proj("out_proj", di, d)}

    def mlstm(self):
        cfg, d = self.cfg, self.cfg.d_model
        di, H = 2 * d, cfg.num_heads
        return {**self.proj("w_up", d, 2 * di),
                "conv_w": self.normal((4, di), 0.5),
                "conv_b": self.zeros(di),
                **self.proj("wq", di, di), **self.proj("wk", di, di),
                **self.proj("wv", di, di),
                **self.proj("w_if", di, 2 * H, bias=True),
                "skip": torch.ones((di,), dtype=torch.float32,
                                   device=self.dev),
                "gn": self.zeros(di, torch.float32),
                **self.proj("w_down", di, d)}

    def slstm(self):
        cfg, d = self.cfg, self.cfg.d_model
        H = cfg.num_heads
        dh, f = d // H, xlstm.slstm_ffn_width(cfg)
        return {**self.proj("w_in", d, 4 * d, bias=True),
                "r": self.normal((4, H, dh, dh), 1 / math.sqrt(dh),
                                 torch.float32),
                "gn": self.zeros(d, torch.float32),
                **self.proj("ffn_wi", d, f), **self.proj("ffn_wo", f // 2, d)}


class Runtime:
    """Execution context (the reference's ``Runtime``): the mesh and the
    feature flags, passed to the model calls, never global.

    With a ``mesh`` the model runs explicit SPMD over its ``model`` axis:
    each rank holds its shard of the weights (``init_params(mesh=)``,
    ``distributed/sharding.py: shard_params``) and computes the config
    ``sharding.local_cfg`` gives, its heads, KV heads (or the one KV
    head its queries read, where the KV heads are fewer than the ranks),
    FFN columns, experts and recurrent channels; the layers place the
    collectives (``tp``, the axis's ``comm.Group``): an ``all_gather`` of
    the embedding (split on ``d``), an ``all_reduce`` after each
    row-parallel ``wo`` (a parallel block makes two, one for attention
    and one for the MLP), the experts' exchange
    (``moe.moe_apply_shard_map`` under ``moe_shard_map``), the recurrent
    blocks' own (``models/mamba.py``, ``models/xlstm.py``), and an
    ``all_gather`` of the vocab-parallel logits (a tied table's partial
    sums are reduced; a vocabulary the axis does not divide leaves
    ``unembed`` whole, and no collective).
    The collectives are issued at axis size 1 too, where the results
    equal the run without a mesh bit for bit. ``inplace_decode`` is the
    reference's flag: the port's decode steps always write their cache
    in place, so it must be True.

    ``kv_seq`` mirrors the reference's ``DEFAULT_RULES["kv_seq"] =
    "model"``: the dense decode cache of a rank holds its share of the
    positions of every KV head (:func:`init_cache`), a decode step
    attends whole heads over it and merges the ranks' partial softmaxes
    (:func:`_decode_attend_seq`), and prefill attends the qseq way
    (``layers.qseq_attention``), its cache holding every KV head. A
    config whose heads the model axis does not split runs so whatever
    the flag (``sharding.rank_cfg``: gathered). At axis size 1 it changes
    nothing: the whole cache is one rank's share."""

    def __init__(self, mesh=None, moe_shard_map=False, inplace_decode=True,
                 kv_seq=False):
        if not inplace_decode:
            raise ValueError("the port's decode steps write their cache in "
                             "place (inplace_decode=True)")
        self.mesh = mesh
        self.moe_shard_map = moe_shard_map
        self.inplace_decode = inplace_decode
        self.kv_seq = kv_seq
        self.tp = axis_group(mesh, "model") \
            if mesh is not None and "model" in shape_of(mesh) else None


def shard_view(cfg, rt):
    """``(the config this rank computes, the model axis's group or
    None)`` of a model call under ``rt``."""
    if rt is None or rt.tp is None:
        return cfg, None
    local = sharding.local_cfg(cfg, rt.mesh, rt.kv_seq)
    if rt.tp.size > 1 and cfg.moe_num_experts and not rt.moe_shard_map:
        raise ValueError(f"{cfg.name}: experts split over a model axis of "
                         f"{rt.tp.size} need Runtime(moe_shard_map=True)")
    return local, rt.tp


def init_params(cfg, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16, mesh=None):
    """Random weights with the reference's scales (normal * 1/sqrt(d_in),
    embed * 0.02; RMSNorm scales zero, LayerNorm scales one and biases
    zero; a MoE router f32; the recurrent blocks' f32 states' parameters
    as the reference's inits), made by :class:`ParamMaker`. A layer holds
    its mixer under its kind (``attn``, ``mamba``, ``mlstm``, ``slstm``)
    and its FFN (``mlp``, ``moe``, or none: an xLSTM block carries its
    own). The numbers differ from ``jax.random``'s; parity tests convert
    the JAX weights instead.

    With a ``mesh`` each full tensor is drawn in the unsharded order
    from the same generator, and only this rank's slice is kept
    (``sharding.shard_params``, one layer at a time), so every width of
    the ``model`` axis holds the same model as the unsharded one."""
    mk = ParamMaker(cfg, seed, device, dtype)
    sharding.check_tp(cfg, sharding.model_size(mesh))

    def keep(tree):
        return sharding.shard_params(tree, cfg, mesh)

    d = cfg.d_model
    blocks = []
    for kind in cfg.layer_kinds():
        mix, ffn = kind.split("+")
        blk = {"norm1": mk.norm(), mix: getattr(mk, mix)()}
        if ffn == "moe":
            blk["moe"] = mk.moe()
        elif ffn == "mlp":
            blk["mlp"] = mk.mlp()
        if ffn != "none" and not (cfg.parallel_block and "mlp" in blk):
            blk["norm2"] = mk.norm()
        blocks.append(keep(blk))
    params = {**keep({"embed": mk.normal((cfg.vocab_size, d), 0.02)}),
              "layers": blocks, "final_norm": mk.norm()}
    if not cfg.tie_embeddings:
        params.update(keep({"unembed": mk.normal((d, cfg.vocab_size),
                                                 1 / math.sqrt(d))}))
    if cfg.family == "vlm":
        params["mm_projector"] = mk.normal((d, d), 1 / math.sqrt(d))
    return params


def unembed_matrix(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype) -> float:
    """``sqrt(d_model)`` rounded to ``dtype`` first, as the reference
    multiplies by ``jnp.asarray(sqrt(d), x.dtype)``."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def embed(cfg, params, tokens, patch_embeds=None, tp=None):
    """Token embeddings, times the rounded ``sqrt(d_model)`` where
    ``cfg.embed_scale`` (gemma). A VLM given ``patch_embeds (B, P, d)``
    puts ``mm_projector`` of them (cast to the embeddings' type first)
    in front of the text, as the reference's ``_embed_inputs``. Under
    tensor parallelism (``tp``) the table is split on ``d``: the rows'
    slices are gathered over the model axis."""
    x = params["embed"][tokens]
    if tp is not None:
        x = comm.gather_from_model(tp, x, -1)
    if cfg.embed_scale:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = dense(params["mm_projector"], patch_embeds.to(x.dtype))
        x = torch.cat([pe, x], dim=1)
    return x


def cache_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cache_rows(cfg, max_seq: int) -> int:
    """Positions an attention cache of ``max_seq`` holds: a sliding-window
    stack only ever needs ``window`` of them (the reference's
    ``_mix_cache_init``). A cache of exactly ``window`` rows is a ring."""
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window \
        else max_seq


def seq_rows(cfg, rows: int) -> int:
    """The rows of a positional cache of ``rows`` positions that one rank
    holds: ``rows`` itself unless the config splits its decode cache by
    sequence (``sharding.kv_seq``), then ``rows / n`` rounded up, rank r
    holding positions ``[r R, (r + 1) R)`` (a position past the whole
    cache's rows is never written: the engines retire a slot first). A
    sliding-window ring's rows must divide, or positions would leave the
    ring's order."""
    n = sharding.split_of(cfg)
    if not sharding.kv_seq(cfg) or n == 1:
        return rows
    if cfg.sliding_window and rows == cfg.sliding_window and rows % n:
        raise ValueError(f"{cfg.name}: a ring of {rows} rows is not split "
                         f"over a model axis of {n}")
    return -(-rows // n)


def seq_share(cfg, t, tp):
    """What a rank keeps of a positional tensor ``t`` (B, rows, ...)
    that it computed whole: under kv_seq (``sharding.kv_seq``) its share,
    rows ``[r R, (r + 1) R)`` (:func:`seq_rows`), zeros past ``rows``;
    else ``t``. A kv_seq prefill's cache is the reference's, split by
    sequence."""
    if not sharding.kv_seq(cfg) or tp is None or tp.size == 1:
        return t
    R = seq_rows(cfg, t.shape[1])
    part = t[:, tp.rank * R:(tp.rank + 1) * R]
    if part.shape[1] < R:
        part = torch.cat([part, part.new_zeros(
            (part.shape[0], R - part.shape[1]) + tuple(part.shape[2:]))], 1)
    return part


def cache_kv_heads(cfg) -> int:
    """KV heads a rank's attention cache holds: every one under kv_seq,
    else the rank's."""
    return sharding.whole_heads(cfg)[1] if sharding.kv_seq(cfg) \
        else cfg.num_kv_heads


def recurrent(cfg) -> bool:
    """Whether the stack holds a recurrent mixer (jamba's Mamba layers,
    xLSTM's mLSTM and sLSTM blocks)."""
    return any(k.split("+")[0] != "attn" for k in cfg.layer_kinds())


def kv_zeros(cfg, shape, dtype, device):
    """A zero K or V cache tensor of ``shape`` (n, B, rows, Hkv, hd):
    contiguous, or under the ``hkv_s`` layout the transposed view of a
    contiguous (n, B, Hkv, rows, hd) tensor (the same indices, a head's
    positions contiguous)."""
    if cfg.decode_cache_layout != "hkv_s":
        return torch.zeros(shape, dtype=dtype, device=device)
    n, B, rows, Hkv, hd = shape
    return torch.zeros((n, B, Hkv, rows, hd), dtype=dtype,
                       device=device).transpose(2, 3)


def _slot_cache(cfg, mix, n, batch, max_seq, dtype, device, whole=False):
    """The cache of one slot of a recurrent stack: its ``n`` layers'
    attention K/V (``dtype``; :func:`init_cache` on ``whole``) or
    recurrent states (the reference's ``_mix_cache_init``: conv states in
    ``dtype``, the others f32, ``m`` at -1e30)."""
    if mix == "attn":
        rows = cache_rows(cfg, max_seq)
        shape = (n, batch, rows if whole else seq_rows(cfg, rows),
                 cache_kv_heads(cfg), cfg.head_dim)
        return {key: kv_zeros(cfg, shape, dtype, device)
                for key in ("k", "v")}
    if mix == "mamba":
        st = dict(zip(("conv", "ssm"), mamba.mamba_state_init(
            cfg, batch, dtype, device)))
    elif mix == "mlstm":
        st = dict(zip("Cnm", xlstm.mlstm_state_init(cfg, batch, device)))
        st["conv"] = torch.zeros((batch, 3, xlstm.mlstm_dims(cfg)[0]),
                                 dtype=dtype, device=device)
    else:
        st = dict(zip("cnhm", xlstm.slstm_state_init(cfg, batch, device)))
    return {key: torch.stack([t] * n) for key, t in st.items()}


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device="cuda", whole=False):
    """The dense decode cache. A pure-attention stack's is ``{"slot0":
    {"k", "v": (L, B, rows, Hkv, hd)}, "lengths"}``; a recurrent stack's
    is the reference's slotted one: ``{"slot{s}": ...}`` for each slot s
    of the period, stacked over its ``L / period`` layers (layer i is
    slot ``i % period``, index ``i // period``), holding attention K/V or
    the recurrent states (:func:`_slot_cache`). Under kv_seq (a rank's
    config, ``sharding.kv_seq``) the K/V hold every KV head and the
    rank's share of the rows (:func:`seq_rows`); ``whole`` keeps every
    row (a suffix prefill's cache, which holds its own positions). Under
    the ``hkv_s`` layout the K/V are :func:`kv_zeros`' views."""
    lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    if recurrent(cfg):
        kinds = slot_kinds(cfg)
        n = cfg.num_layers // len(kinds)
        cache = {f"slot{s}": _slot_cache(cfg, kind.split("+")[0], n, batch,
                                         max_seq, dtype, device, whole)
                 for s, kind in enumerate(kinds)}
        cache["lengths"] = lengths
        return cache
    rows = cache_rows(cfg, max_seq)
    shape = (cfg.num_layers, batch, rows if whole else seq_rows(cfg, rows),
             cache_kv_heads(cfg), cfg.head_dim)
    return {"slot0": {"k": kv_zeros(cfg, shape, dtype, device),
                      "v": kv_zeros(cfg, shape, dtype, device)},
            "lengths": lengths}


def run_layers(cfg, params, x, attend, *, final_norm=True,
               backend: str = "auto", rt=None, ffn=None):
    """The residual stream ``x`` through every layer: ``attend(i, p, h)``
    returns layer i's mixer output (attention projected back to d_model,
    or a recurrent block's) for the normed input ``h``. Each residual add
    goes with the norm after it (``layers.add_norm``: one
    ``ops.add_rmsnorm`` launch on the card for RMSNorm): the mixer's
    residual with ``norm2``, the FFN's with the next layer's ``norm1`` or,
    after the last layer, with the final norm. A layer with no FFN (an
    xLSTM block) adds its mixer's output with the next norm directly. A
    parallel block feeds attention and MLP the same ``h`` and adds ``(x +
    attn) + mlp``, in that order on every path (the reference's
    ``prefill_suffix``, ``decode_step_inplace`` and paged step do; its
    ``forward`` adds ``x + (attn + mlp)``). Returns ``(x, h)``: the stream
    and its final norm; with ``final_norm=False`` the last add stays
    unfused and ``h`` is None (prefill norms only the rows it keeps).

    The FFN follows the layer's kind: an MLP, or (a layer holding
    ``moe``) ``moe.moe_apply`` over the call's tokens, as the reference's
    ``_apply_ffn`` on every path; a MoE layer is never a parallel block.
    Under a mesh (``rt``; ``cfg`` is then this rank's, ``shard_view``)
    the MLP reduces its row-parallel ``wo`` over the model axis and the
    MoE runs ``moe.moe_apply_shard_map`` where ``rt.moe_shard_map``; the
    residual stream stays whole on every rank. ``ffn(cfg, p, h, rt)``
    stands in for a MoE layer's :func:`_ffn` where given (the recurrent
    prefill's traced one).

    On the CPU the arithmetic is the reference's exactly: an add, then
    the norm's plain version."""
    blocks = params["layers"]
    tp = None if rt is None else rt.tp
    ffn = ffn or _ffn
    h = layers.norm_apply(cfg, blocks[0]["norm1"], x, backend=backend)
    for i, p in enumerate(blocks):
        o = attend(i, p, h)
        if cfg.parallel_block and "mlp" in p:
            # two all-reduces under a mesh, attention's and the MLP's;
            # their sum could be reduced once (ROADMAP perf queue)
            m = layers.mlp_apply(cfg, p["mlp"], h, tp)
            x = x + o
        elif "norm2" in p:
            x, h = layers.add_norm(cfg, x, o, p["norm2"], backend=backend)
            m = ffn(cfg, p, h, rt) if "moe" in p else \
                layers.mlp_apply(cfg, p["mlp"], h, tp)
        else:
            m = o
        if i + 1 < len(blocks):
            x, h = layers.add_norm(cfg, x, m, blocks[i + 1]["norm1"],
                                   backend=backend)
        elif final_norm:
            x, h = layers.add_norm(cfg, x, m, params["final_norm"],
                                   backend=backend)
        else:
            x, h = x + m, None
    return x, h


def _ffn(cfg, p, h, rt):
    """A MoE layer's FFN: the expert-parallel exchange under a mesh with
    ``rt.moe_shard_map`` (the reference's ``_apply_ffn``), else
    ``moe_apply``."""
    if rt is not None and rt.moe_shard_map and rt.mesh is not None:
        return moe.moe_apply_shard_map(cfg, p["moe"], h, mesh=rt.mesh)[0]
    return moe.moe_apply(cfg, p["moe"], h)[0]


def _traced_ffn(cfg, p, h, rt):
    """:func:`_ffn` in a ``prefill.moe`` span. The enclosing
    ``prefill.call`` gains ``moe_routes`` (tokens x k) and ``moe_rows``
    (experts x capacity: the rows the expert products compute) of
    ``moe_apply``'s buffer, host numbers from the shapes."""
    with _trace.span("prefill.moe") as sp:
        if sp and not (rt is not None and rt.moe_shard_map):
            T = h.shape[0] * h.shape[1]
            _trace.add_to("prefill.call", moe_routes=T * cfg.moe_top_k,
                          moe_rows=cfg.moe_num_experts
                          * moe.capacity_of(cfg, T))
        return _ffn(cfg, p, h, rt)


def logits_of(cfg, params, h, tp=None):
    """``h @ unembed`` in the working type, cast to f32 (the reference's
    order). Under tensor parallelism the unembedding is split on the
    vocab and the logits' slices are gathered; a tied table (split on
    ``d``) gives partial sums, which are reduced; a vocabulary the axis
    does not divide leaves ``unembed`` whole (``sharding._fits``), and
    every rank computes every logit."""
    if tp is None or (not cfg.tie_embeddings
                      and cfg.vocab_size % tp.size):
        return (h @ unembed_matrix(cfg, params)).float()
    if cfg.tie_embeddings:
        y = h.chunk(tp.size, -1)[tp.rank] @ params["embed"].T
        return tp.all_reduce(y).float()
    return tp.all_gather(h @ params["unembed"], -1).float()


def _last_logits(cfg, params, x, last_pos, tp=None):
    """Final norm + unembed at each sequence's last real position, in f32
    (``h_last @ w`` in the working type, then cast, as the reference)."""
    B = x.shape[0]
    if last_pos is None:
        h_last = x[:, -1:]
    else:
        h_last = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    h_last = layers.norm_apply(cfg, params["final_norm"], h_last)
    return logits_of(cfg, params, h_last, tp)


def _train_layer(cfg, kind, p, x, positions, rope, rt=None):
    """One layer of the training forward: ``(x, aux)``, aux its MoE
    layer's Switch loss (0 elsewhere). Under a mesh (``rt``; ``cfg``
    this rank's, :func:`shard_view`) the layer runs on the rank's shard
    with the sharded prefill's layer functions and collectives, which
    differentiate (``distributed/comm.py``)."""
    tp = None if rt is None else rt.tp
    mix, ffn = kind.split("+")
    B, S = x.shape[:2]
    h = layers.norm_plain(cfg, p["norm1"], x)
    if mix == "attn" and sharding.kv_seq(cfg):
        q, k, v = layers.attn_qkv_whole(cfg, p["attn"], h, positions, rope,
                                        kernels=layers.PLAIN, tp=tp)
        o = layers.qseq_attention(tp, q, k, v, window=cfg.sliding_window,
                                  softcap=cfg.attn_logit_softcap,
                                  kernels=layers.PLAIN)
        out = layers.row_proj(p["attn"], "wo", o, tp)
    elif mix == "attn":
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope,
                                  kernels=layers.PLAIN, tp=tp)
        o = ref.flash_attention_ref(q, k, v, causal=True,
                                    window=cfg.sliding_window,
                                    softcap=cfg.attn_logit_softcap)
        out = layers.row_proj(p["attn"], "wo", o.reshape(B, S, cfg.q_dim),
                              tp)
    elif mix == "mamba":
        out, _ = mamba.mamba_apply(cfg, p["mamba"], h,
                                   scan=mamba.doubling_scan_out, tp=tp)
    elif mix == "mlstm":
        out, _ = xlstm.mlstm_apply(cfg, p["mlstm"], h, kernels=layers.PLAIN,
                                   tp=tp)
    else:
        out, _ = xlstm.slstm_apply(cfg, p["slstm"], h, kernels=layers.PLAIN,
                                   tp=tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + out
    if cfg.parallel_block and "mlp" in p:
        x = x + layers.mlp_apply(cfg, p["mlp"], h, tp)
    elif ffn != "none":
        h = layers.norm_plain(cfg, p["norm2"], x)
        if ffn == "moe" and rt is not None and rt.moe_shard_map:
            delta, aux = moe.moe_apply_shard_map(cfg, p["moe"], h,
                                                 mesh=rt.mesh,
                                                 local_batch=True)
        elif ffn == "moe":
            delta, aux = moe.moe_apply(cfg, p["moe"], h)
        else:
            delta = layers.mlp_apply(cfg, p["mlp"], h, tp)
        x = x + delta
    return x, aux


def forward(cfg, params, tokens, *, patch_embeds=None, rt=None):
    """The training forward (the reference's ``forward`` without a
    cache): ``(hidden, aux)``, the final-normed hidden states (B, S, d)
    (a VLM's ``patch_embeds`` in front of the text, :func:`embed`) and
    the sum of the MoE layers' Switch losses (f32; 0 without MoE).

    It runs under autograd and reaches no kernel: the norms are
    ``layers.norm_plain``, the q/k norms and the attention the plain
    versions (``ref.rmsnorm_ref``, ``ref.flash_attention_ref``, the
    reference's jnp ``layers.attention``; causal, with
    ``cfg.sliding_window`` and the logit softcap as the reference's
    ``attn_apply``), Mamba's
    scan the out-of-place one. Nothing is written in place and no cache
    is collected. Under ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``nothing_saveable``
    policy on its layer body: only the layer's input is kept, the rest
    recomputed in backward); the results are the same bits either way.
    A parallel block adds ``(x + attn) + mlp``, the order of the port's
    other paths (ROADMAP C.4); the reference's ``forward`` adds ``x +
    (attn + mlp)``, which agrees to f32 rounding.

    Under a mesh (``rt``) this rank's shard runs the step tensor- and
    expert-parallel over the ``model`` axis on its data rank's rows
    (``tokens`` the rank's rows of the global batch): the layers of the
    sharded prefill, their collectives differentiable; a MoE layer's
    exchange takes the rows as they are (``local_batch``). Under
    ``cfg.remat`` backward recomputes each layer and so issues its
    collectives again, in the same order on every rank."""
    cfg, tp = shard_view(cfg, rt)
    x = embed(cfg, params, tokens, patch_embeds, tp)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = layers.model_rope(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.layer_kinds(), params["layers"]):
        if cfg.remat:
            x, a = checkpoint(_train_layer, cfg, kind, p, x, positions,
                              rope, rt, use_reentrant=False)
        else:
            x, a = _train_layer(cfg, kind, p, x, positions, rope, rt)
        aux = aux + a
    return layers.norm_plain(cfg, params["final_norm"], x), aux


def data_groups(rt):
    """The data axes' groups of ``rt``'s mesh (none without one)."""
    if rt is None or rt.mesh is None:
        return ()
    return tuple(axis_group(rt.mesh, a) for a in data_axes(rt.mesh))


def loss_fn(cfg, params, batch, rt=None):
    """``batch``: tokens and targets (B, S), optional ``patch_embeds``
    and ``mask``. The chunked cross-entropy of the text positions (a
    VLM's patches come first and are left out) plus 0.01 of the MoE
    aux loss, as the reference's ``loss_fn``.

    Under a mesh (``rt``) ``batch`` is this data rank's rows: the NLL is
    divided by the mask's sum over the global batch (summed over the
    data axes first) and the aux loss, a mean over every axis, by the
    data ranks' count, so the data ranks' losses add up to the global
    batch's loss and their gradients, summed over the data axes
    (``training/optimizer.py: make_train_step``), to its gradient, even
    where the ranks hold unequal token counts. The unembedding is cut
    as ``logits_of`` cuts it (``layers.xent_split``)."""
    x, aux = forward(cfg, params, batch["tokens"],
                     patch_embeds=batch.get("patch_embeds"), rt=rt)
    targets = batch["targets"]
    x = x[:, -targets.shape[1]:]
    local, tp = shard_view(cfg, rt)
    data = data_groups(rt)
    nll = layers.chunked_xent(x, unembed_matrix(cfg, params), targets,
                              chunk=cfg.vocab_chunk, mask=batch.get("mask"),
                              tp=tp, split=layers.xent_split(cfg, tp),
                              data=data)
    n_data = math.prod(g.size for g in data)
    return nll + 0.01 * (aux / n_data if data else aux)


def _lengths(true_len, B, S, device):
    if true_len is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return true_len.to(torch.int32)


def prefill(cfg, params, tokens, *, max_seq: int, last_pos=None,
            true_len=None, patch_embeds=None, rt=None):
    """Process right-padded prompts ``tokens (B, S)``; returns
    (logits at ``last_pos`` (B, 1, V) f32, cache). Causal attention makes
    the right padding invisible to the real positions; a sliding window
    (flash attention's ``window``) is not, so sliding-window stacks are
    prefilled at their exact lengths (``PrefillEngine``), and their cache
    keeps the last ``window`` positions as a ring (:func:`cache_rows`).
    A VLM's ``patch_embeds (B, P, d)`` come first (:func:`embed`): the
    sequence is P + S long, and ``last_pos``/``true_len`` count the
    patches (``registry.build``'s prefill shifts them). Under a mesh
    (``rt``) the cache holds this rank's KV heads; under kv_seq
    (``sharding.kv_seq``) its share of every KV head's positions
    (:func:`seq_share`), the attention the qseq way
    (:func:`_prefill_attend`)."""
    cfg, tp = shard_view(cfg, rt)
    if recurrent(cfg):
        return _prefill_recurrent(cfg, params, tokens, max_seq=max_seq,
                                  last_pos=last_pos, true_len=true_len,
                                  rt=rt)
    dev = tokens.device
    x = embed(cfg, params, tokens, patch_embeds, tp)
    B, S = x.shape[:2]
    if S > max_seq:
        raise ValueError(f"prompt bucket {S} exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = init_cache(cfg, B, S, cache_dtype(cfg), device=dev)
    rows = cache_rows(cfg, S)

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v, o = _prefill_attend(cfg, p, h, positions, rope, tp)
        if rows < S:
            # the last `rows` positions, position p at ring row p % rows
            k = torch.roll(k[:, -rows:], S % rows, dims=1)
            v = torch.roll(v[:, -rows:], S % rows, dims=1)
        cache["slot0"]["k"][i] = seq_share(cfg, k, tp)
        cache["slot0"]["v"][i] = seq_share(cfg, v, tp)
        return layers.row_proj(p["attn"], "wo", o, tp)

    x, _ = run_layers(cfg, params, x, attend, final_norm=False, rt=rt)
    cache["lengths"] = _lengths(true_len, B, S, dev)
    return _last_logits(cfg, params, x, last_pos, tp), cache


def _prefill_attend(cfg, p, h, positions, rope, tp, *, window=None):
    """One layer's causal prefill attention: ``(q, k, v, o)``, ``o`` (B,
    S, ·) what the row-parallel ``wo`` reads. Under kv_seq
    (``sharding.kv_seq``) q, k and v are whole heads
    (``layers.attn_qkv_whole``) and ``o`` the rank's columns of the qseq
    attention; else the rank's heads and their output."""
    B, S = h.shape[:2]
    window = cfg.sliding_window if window is None else window
    cap = cfg.attn_logit_softcap
    if sharding.kv_seq(cfg):
        q, k, v = layers.attn_qkv_whole(cfg, p["attn"], h, positions, rope,
                                        tp=tp)
        return q, k, v, layers.qseq_attention(tp, q, k, v, window=window,
                                              softcap=cap)
    q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            softcap=cap)
    return q, k, v, o.reshape(B, S, cfg.q_dim)


def prefill_suffix(cfg, params, tokens, prefix_kv, prefix_len, *,
                   max_seq: int, last_pos=None, true_len=None, rt=None):
    """Prefill only a prompt SUFFIX against already-computed prefix KV
    (the partial prefix hit and chunked prefill). ``prefix_kv["slot0"]``
    is (k, v) of shape (L, B, P, Hkv, hd), right-padded to P;
    ``prefix_len (B,)`` the true prefix lengths. Suffix queries sit at
    absolute positions ``prefix_len + i``. The returned cache holds only
    the suffix KV (lengths = suffix true lengths). Full attention only,
    as the reference asserts. A logit softcap caps the suffix's scores as
    every other attention's (the reference's ``_suffix_attention`` leaves
    it out: ROADMAP C.4)."""
    if cfg.sliding_window or recurrent(cfg):
        raise ValueError(f"{cfg.name}: suffix prefill assumes a stack of "
                         f"full attention")
    cfg, tp = shard_view(cfg, rt)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"suffix bucket {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    pk_all, pv_all = prefix_kv["slot0"]
    x = embed(cfg, params, tokens, tp=tp)
    positions = prefix_len[:, None].long() + torch.arange(S, device=dev)[None]
    cache = init_cache(cfg, B, S, cache_dtype(cfg), device=dev, whole=True)
    seq = sharding.kv_seq(cfg)

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        if seq:     # whole heads: every rank every row, its columns kept
            q, k, v = layers.attn_qkv_whole(cfg, p["attn"], h, positions,
                                            rope, tp=tp)
        else:
            q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        K = torch.cat([pk_all[i].to(k.dtype), k], dim=1)
        V = torch.cat([pv_all[i].to(v.dtype), v], dim=1)
        o = ops.flash_attention(q, K, V, prefix_len=prefix_len,
                                softcap=cfg.attn_logit_softcap).reshape(
            B, S, -1)
        if seq:
            o = o.chunk(tp.size, -1)[tp.rank]
        cache["slot0"]["k"][i] = k
        cache["slot0"]["v"][i] = v
        return layers.row_proj(p["attn"], "wo", o, tp)

    x, _ = run_layers(cfg, params, x, attend, final_norm=False, rt=rt)
    cache["lengths"] = _lengths(true_len, B, S, dev)
    return _last_logits(cfg, params, x, last_pos, tp), cache


def decode_step(cfg, params, cache, tokens, *, backend: str = "auto",
                rt=None):
    """One decode step against the dense cache. tokens: (B, 1).

    Each slot's new K/V is written into every layer of ``cache["slot0"]``
    ((L, B, S_c, Hkv, hd), in place, device indices only, so nothing
    waits on the host), then attention reads the layer through
    ``ops.decode_attention``. On a full-length cache the write lands at
    position ``lengths`` and ``kv_len = lengths + 1``; a write position
    past the cache is clamped to its last row (the engines retire a slot
    at ``max_seq - 1``, so only an idle slot gets there). On a
    sliding-window ring (``S_c == window``) it lands at ``lengths %
    window`` and ``kv_len = min(lengths + 1, window)``: softmax does not
    care in which order the window's keys lie, and each key was rotated
    at its own position before it was written. Returns (logits (B, 1, V)
    f32, cache) with ``lengths + 1``. Under a mesh (``rt``) the cache
    holds this rank's KV heads, or under kv_seq its share of every KV
    head's positions (:func:`_decode_attend_seq`). A recurrent stack
    with a window (the reference's jamba long_500k cell) keeps its
    attention layers' K/V in the same ring (:func:`_decode_step_recurrent`),
    as the reference's in-place step does. Under the ``hkv_s`` layout the
    write and the kernel's read go through the same indices, over the
    cache's other strides (:func:`kv_zeros`)."""
    cfg, tp = shard_view(cfg, rt)
    if recurrent(cfg):
        return _decode_step_recurrent(cfg, params, cache, tokens,
                                      backend=backend, rt=rt)
    x = embed(cfg, params, tokens, tp=tp)
    lengths = cache["lengths"]
    positions = lengths[:, None]
    K, V = cache["slot0"]["k"], cache["slot0"]["v"]
    # once for every layer: the write rows, kv_len and the RoPE table
    w_pos, kv_len = write_pos(cfg, lengths, whole_rows(cfg, K.shape[2]))
    rope = layers.model_rope(cfg, positions)

    def attend(i, p, h):
        return _attend_fn(cfg)(cfg, p, h, positions, rope, K[i], V[i],
                               w_pos, kv_len, backend, tp)

    _, h = run_layers(cfg, params, x, attend, backend=backend, rt=rt)
    logits = logits_of(cfg, params, h, tp)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits, new_cache


def whole_rows(cfg, rows: int) -> int:
    """The whole cache's rows of a rank's share of ``rows`` (kv_seq: the
    ranks' shares end to end; :func:`seq_rows`)."""
    return rows * sharding.split_of(cfg) if sharding.kv_seq(cfg) else rows


def _attend_fn(cfg):
    """A layer's dense decode attention: the kv_seq one where the rank's
    config splits its cache by sequence, else the head-split one."""
    return _decode_attend_seq if sharding.kv_seq(cfg) else _decode_attend


def write_pos(cfg, lengths, rows):
    """((slot index, row) each slot's new K/V lands in, kv_len) of a
    decode step on a cache of ``rows`` rows (:func:`decode_step`)."""
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    if cfg.sliding_window and rows == cfg.sliding_window:
        return ((bidx, torch.remainder(lengths.long(), rows)),
                torch.clamp(lengths + 1, max=rows).to(torch.int32))
    return ((bidx, torch.clamp(lengths.long(), max=rows - 1)),
            (lengths + 1).to(torch.int32))


def _decode_attend(cfg, p, h, positions, rope, K, V, w_pos, kv_len,
                   backend, tp=None):
    """One layer's decode attention over its cache ``K``/``V`` (B, rows,
    Hkv, hd): this step's K/V written in place at ``w_pos`` (slot index,
    row), then ``ops.decode_attention`` over the permuted views,
    projected back."""
    B = h.shape[0]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
    K[w_pos] = k[:, 0].to(K.dtype)
    V[w_pos] = v[:, 0].to(V.dtype)
    o = ops.decode_attention(
        q[:, 0].reshape(B, Hkv, cfg.num_heads // Hkv, hd).contiguous(),
        K.permute(0, 2, 1, 3), V.permute(0, 2, 1, 3), kv_len,
        softcap=cfg.attn_logit_softcap, backend=backend)
    return layers.row_proj(p["attn"], "wo",
                           o.reshape(B, 1, cfg.q_dim).to(h.dtype), tp)


def seq_write(K, V, k, v, w_pos, lo):
    """The kv_seq cache's write of this step's k/v (B, Hkv, hd): each
    slot's row ``w_pos`` of the whole cache lands in this rank's share
    ``K``/``V`` (B, R, Hkv, hd), which holds rows ``[lo, lo + R)``, only
    where the rank owns it; elsewhere the rank's nearest row is written
    back as it was. Device values only (no branch on the host), so a
    captured chunk writes where each replay's lengths say."""
    bidx, row = w_pos
    R = K.shape[1]
    loc = row - lo
    own = ((loc >= 0) & (loc < R))[:, None, None]
    loc = loc.clamp(0, R - 1)
    K[bidx, loc] = torch.where(own, k.to(K.dtype), K[bidx, loc])
    V[bidx, loc] = torch.where(own, v.to(V.dtype), V[bidx, loc])


def seq_partial(q, K, V, kv_len, lo, backend="auto", softcap=0.0):
    """Whole query heads q (B, Hkv, g, hd) over a kv_seq share ``K``/``V``
    (B, R, Hkv, hd) holding rows ``[lo, lo + R)`` of a cache whose first
    ``kv_len`` rows are valid: the partial mode of the decode kernel over
    the rank's ``clamp(kv_len - lo, 0, R)`` rows, ``(o, lse)``."""
    R = K.shape[1]
    local = torch.clamp(kv_len - lo, 0, R).to(torch.int32)
    return ops.decode_attention(q, K.permute(0, 2, 1, 3),
                                V.permute(0, 2, 1, 3), local,
                                return_lse=True, softcap=softcap,
                                backend=backend)


def seq_attention(q, K, V, kv_len, lo, tp, backend="auto", softcap=0.0):
    """:func:`seq_partial` merged over ``tp`` (``comm.merge_partials``):
    (B, Hkv, g, hd) f32, every rank the same."""
    return comm.merge_partials(tp, *seq_partial(q, K, V, kv_len, lo,
                                                backend, softcap))


def _decode_attend_seq(cfg, p, h, positions, rope, K, V, w_pos, kv_len,
                       backend, tp):
    """:func:`_decode_attend` over the kv_seq cache: this rank's share
    ``K``/``V`` (B, R, Hkv, hd) of every KV head's positions ``[r R, (r +
    1) R)``. The rank projects its columns of q, k and v and gathers them
    to whole heads (``layers.attn_qkv_whole``: one token each), writes
    the new K/V where it owns the write row (:func:`seq_write`), attends
    every query head over its rows and merges the ranks' partials
    (:func:`seq_attention`), and keeps its ``q_dim / n`` columns of the
    output for the row-parallel ``wo``."""
    B = h.shape[0]
    H, Hkv = sharding.whole_heads(cfg)
    hd, n = cfg.head_dim, tp.size
    q, k, v = layers.attn_qkv_whole(cfg, p["attn"], h, positions, rope,
                                    tp=tp)
    lo = tp.rank * K.shape[1]
    seq_write(K, V, k[:, 0], v[:, 0], w_pos, lo)
    o = seq_attention(q[:, 0].reshape(B, Hkv, H // Hkv, hd).contiguous(),
                      K, V, kv_len, lo, tp, backend,
                      cfg.attn_logit_softcap)
    c = H * hd // n
    o = o.reshape(B, 1, H * hd)[..., tp.rank * c:(tp.rank + 1) * c]
    return layers.row_proj(p["attn"], "wo", o.to(h.dtype), tp)


# -- recurrent stacks (jamba, xLSTM) ------------------------------------------


def _mix_of(cfg, i):
    """(mixer kind, cache slot, index in the slot) of layer i."""
    kinds = slot_kinds(cfg)
    return kinds[i % len(kinds)].split("+")[0], f"slot{i % len(kinds)}", \
        i // len(kinds)


def _prefill_recurrent(cfg, params, tokens, *, max_seq, last_pos, true_len,
                       rt=None):
    """:func:`prefill` of a recurrent stack, the reference's ``forward``
    with ``collect_cache``: attention layers run causal flash attention
    (jamba has no RoPE: ``model_rope`` is None) and keep their K/V in the
    cache's type, Mamba and xLSTM layers run their full-sequence paths
    and keep the states they end with, as those come out (a conv state
    in the stream's type). The cache is slotted (:func:`init_cache`) and
    holds the S computed positions. Right padding would run through the
    recurrences: ``PrefillEngine`` prefills these stacks at exact
    lengths. Under a mesh (``rt``) each layer runs on this rank's heads
    or channels, and the cache holds the rank's KV heads (under kv_seq
    its share of every head's positions) and states. Under a sliding
    window the attention layers attend within it, and a prompt longer
    than the window keeps its last ``window`` positions, position p at
    ring row ``p % window`` (the reference's rotation at the prefill
    handoff; :func:`cache_rows`).

    Traced (``serving/trace.py``): a ``prefill.mamba`` span around each
    Mamba mixer, whose device time (CUDA events, on the card) the
    enclosing ``prefill.call`` sums as ``mamba_ms``, and a
    ``prefill.moe`` span around each expert layer
    (:func:`_traced_ffn`)."""
    tp = None if rt is None else rt.tp
    dev = tokens.device
    x = embed(cfg, params, tokens, tp=tp)
    B, S = x.shape[:2]
    if S > max_seq:
        raise ValueError(f"prompt {S} exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=dev).expand(B, S)
    rope = layers.model_rope(cfg, positions)
    rows = cache_rows(cfg, S)
    got = [None] * cfg.num_layers

    def ring(t):
        # the last `rows` positions, position p at ring row p % rows
        return torch.roll(t[:, -rows:], S % rows, dims=1) if rows < S else t

    def mix(i, p, h):
        kind = _mix_of(cfg, i)[0]
        if kind == "attn":
            _, k, v, o = _prefill_attend(cfg, p, h, positions, rope, tp)
            got[i] = {"k": seq_share(cfg, ring(k).to(cache_dtype(cfg)), tp),
                      "v": seq_share(cfg, ring(v).to(cache_dtype(cfg)), tp)}
            return layers.row_proj(p["attn"], "wo", o, tp)
        if kind == "mamba":
            with _trace.span("prefill.mamba"), \
                    _trace.device_ms("prefill.call", "mamba_ms", dev):
                o, (conv, ssm) = mamba.mamba_apply(cfg, p["mamba"], h,
                                                   tp=tp)
            got[i] = {"conv": conv, "ssm": ssm}
        elif kind == "mlstm":
            o, ((C, n, m), conv) = xlstm.mlstm_apply(cfg, p["mlstm"], h,
                                                     tp=tp)
            got[i] = {"C": C, "n": n, "m": m, "conv": conv}
        else:
            o, st = xlstm.slstm_apply(cfg, p["slstm"], h, tp=tp)
            got[i] = dict(zip("cnhm", st))
        return o

    x, _ = run_layers(cfg, params, x, mix, final_norm=False, rt=rt,
                      ffn=_traced_ffn)
    P = len(slot_kinds(cfg))
    cache = {f"slot{s}": {key: _stack_slot(cfg, key, got[s::P])
                          for key in got[s]} for s in range(P)}
    del got
    cache["lengths"] = _lengths(true_len, B, S, dev)
    return _last_logits(cfg, params, x, last_pos, tp), cache


def _stack_slot(cfg, key, layers_got):
    """One slot's tensors of ``key`` stacked over its layers: attention
    K/V in the cache layout (:func:`kv_zeros`), states as they are."""
    ts = [g[key] for g in layers_got]
    if key not in ("k", "v"):
        return torch.stack(ts)
    out = kv_zeros(cfg, (len(ts),) + tuple(ts[0].shape), ts[0].dtype,
                   ts[0].device)
    for j, t in enumerate(ts):
        out[j] = t
    return out


def _decode_step_recurrent(cfg, params, cache, tokens, *, backend, rt=None):
    """:func:`decode_step` of a recurrent stack (the reference's
    ``decode_step_inplace``): attention layers as the pure-attention
    step, on their slot's K/V; each recurrent layer steps its states and
    copies them back into the cache IN PLACE (``copy_``, a conv state
    cast back to the cache's type), so a captured chunk replays on the
    engine's own tensors. Under a sliding window the attention slots'
    caches of ``window`` rows are rings (:func:`write_pos`). Every slot's state advances, idle ones too (the
    reference freezes only ``lengths``): admission overwrites all of a
    slot's state."""
    tp = None if rt is None else rt.tp
    x = embed(cfg, params, tokens, tp=tp)
    lengths = cache["lengths"]
    positions = lengths[:, None]
    rope = layers.model_rope(cfg, positions)
    attn_slots = [cache[f"slot{s}"]["k"].shape[2]
                  for s, kind in enumerate(slot_kinds(cfg))
                  if kind.startswith("attn")]
    if attn_slots:
        w_pos, kv_len = write_pos(cfg, lengths,
                                  whole_rows(cfg, attn_slots[0]))

    def mix(i, p, h):
        kind, name, j = _mix_of(cfg, i)
        slot = cache[name]
        if kind == "attn":
            return _attend_fn(cfg)(cfg, p, h, positions, rope,
                                   slot["k"][j], slot["v"][j], w_pos,
                                   kv_len, backend, tp)
        if kind == "mamba":
            o, st = mamba.mamba_decode_step(
                cfg, p["mamba"], h, (slot["conv"][j], slot["ssm"][j]),
                tp=tp)
            new = dict(zip(("conv", "ssm"), st))
        elif kind == "mlstm":
            o, st, conv = xlstm.mlstm_decode_step(
                cfg, p["mlstm"], h, tuple(slot[k][j] for k in "Cnm"),
                slot["conv"][j], tp=tp)
            new = dict(zip("Cnm", st), conv=conv)
        else:
            o, st = xlstm.slstm_decode_step(
                cfg, p["slstm"], h, tuple(slot[k][j] for k in "cnhm"),
                tp=tp)
            new = dict(zip("cnhm", st))
        for key, t in new.items():
            slot[key][j].copy_(t)
        return o

    _, h = run_layers(cfg, params, x, mix, backend=backend, rt=rt)
    logits = logits_of(cfg, params, h, tp)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits, new_cache
