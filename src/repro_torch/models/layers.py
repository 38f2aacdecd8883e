"""Dense transformer layers (the dense parts of ``repro.models.layers``).

Plain functions on tensors; a layer's parameters are a dict of tensors
with weights stored ``(d_in, d_out)`` as in the JAX package, so ``x @ w``
reads the same in both. The reference's ``rmsnorm`` and prefill
``attention`` are kernels in the port (``kernels/ops.py``: ``rmsnorm`` and
``flash_attention``, whose plain versions in ``kernels/ref.py`` are the
reference's jnp code). LayerNorm is plain jnp in the reference and plain
PyTorch here.

A norm's parameters follow ``cfg.norm_type``: an RMSNorm is its ``(d,)``
f32 scale tensor, a LayerNorm the dict ``{"scale", "bias"}`` of two. A
projection ``w`` with a bias (``cfg.attn_bias``, ``cfg.mlp_bias``, and
the gate projections of the recurrent blocks) keeps it beside it as
``w_b``: ``{"wq": ..., "wq_b": ...}`` where the reference nests
``{"wq": {"w", "b"}}``.

The training forward runs none of the kernels: the reference trains
through its plain jnp ``rmsnorm`` and ``attention``, and a CUDA kernel has
no backward. The functions that reach a kernel take ``kernels=`` (default
``ops``, the kernel entry points); the training forward passes
:data:`PLAIN`, the same names bound to the plain versions in
``kernels/ref.py``. :func:`chunked_xent` is the training loss.

Under tensor parallelism (``tp``, the model axis's ``comm.Group``) the
layers place the collectives through ``distributed/comm.py``'s
differentiable functions, so the same code runs the sharded training
step: a replicated input enters each column-parallel projection
through ``comm.copy_to_model`` (its gradient summed over the axis in
backward) and each row-parallel sum leaves through
``comm.reduce_from_model``. Without grad these issue the calls the
serving paths always made.

Where the heads are not split over the axis (``sharding.kv_seq``: heads
the axis does not divide, or the kv_seq decode cache asked for),
:func:`attn_qkv_whole` gathers a rank's columns of q, k and v to whole
heads and :func:`qseq_attention` attends the reference's
``ATTN_QSEQ_RULES`` way: each rank all heads for its share of the query
rows, its output handed back to the rank's columns for ``wo``.
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ops, ref

# the kernels' names bound to their plain versions (the training forward)
PLAIN = types.SimpleNamespace(rmsnorm=ref.rmsnorm_ref,
                              flash_attention=ref.flash_attention_ref)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    """The reference's LayerNorm: f32 mean and variance over the last
    axis, ``rsqrt(var + eps)``, scale and bias, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def norm_apply(cfg, p, x, *, backend: str = "auto"):
    """The norm of ``cfg.norm_type`` with parameters ``p``."""
    if cfg.norm_type == "rmsnorm":
        return ops.rmsnorm(x, p, backend=backend)
    return layernorm(x, p["scale"], p.get("bias"))


def norm_plain(cfg, p, x):
    """:func:`norm_apply` through the plain versions (the training
    forward's norm, the reference's jnp ``norm_apply``)."""
    if cfg.norm_type == "rmsnorm":
        return ref.rmsnorm_ref(x, p)
    return layernorm(x, p["scale"], p.get("bias"))


def rmsnorm_split(x, scale, tp, eps: float = 1e-6):
    """The RMSNorm of rows whose channels are split evenly over the
    model axis ``tp``: ``x`` this rank's share of each row, ``scale``
    its slice of the ``(1 + scale)`` gain. Each rank's mean square is
    summed over the axis (one all-reduce; under autograd its gradient is
    summed too, since each rank scales its own channels by the sum) and
    divided by its size, the whole row's mean square; the rest is
    ``ref.rmsnorm_ref``'s f32 arithmetic, so at axis size 1 the result
    is its bits."""
    dt = x.dtype
    xf = x.float()
    ms = comm.sum_over(tp, xf.square().mean(dim=-1, keepdim=True)) / tp.size
    xf = xf * torch.rsqrt(ms + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def add_norm(cfg, x, r, p, *, backend: str = "auto"):
    """A residual add and the norm after it: ``(h, norm(h))`` with
    ``h = x + r``. RMSNorm fuses the two (``ops.add_rmsnorm``, one launch
    on the card); LayerNorm adds, then norms."""
    if cfg.norm_type == "rmsnorm":
        return ops.add_rmsnorm(x, r, p, backend=backend)
    h = x + r
    return h, norm_apply(cfg, p, h)


def rope_freqs(head_dim: int, rotary_pct: float, theta: float, device):
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def rope_table(positions, head_dim: int, *, rotary_pct: float = 1.0,
               theta: float = 10000.0):
    """``(sin, cos)`` of ``positions (..., S)``, each ``(..., S, 1, rot/2)``
    f32: the part of :func:`apply_rope` that depends on the positions
    alone. A model call computes it once and hands it to every layer's q
    and k (``attn_qkv(..., rope=...)``); None where nothing rotates."""
    if theta <= 0.0:
        return None
    inv, rot_dim = rope_freqs(head_dim, rotary_pct, theta, positions.device)
    if rot_dim == 0:
        return None
    ang = positions[..., None].float() * inv             # (..., S, rot/2)
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]


def apply_rope(x, positions, *, rotary_pct: float = 1.0,
               theta: float = 10000.0, table=None):
    """x: (..., S, H, hd); positions: (..., S). Rotates the two HALVES of
    the rotary dims (not interleaved pairs), like the reference. ``table``
    is :func:`rope_table` of the same positions, computed once per model
    call; without it the table is computed here."""
    if table is None:
        table = rope_table(positions, x.shape[-1], rotary_pct=rotary_pct,
                           theta=theta)
    if table is None:
        return x
    sin, cos = table
    rot_dim = 2 * sin.shape[-1]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., :rot_dim // 2], xr[..., rot_dim // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot_dim < x.shape[-1] else out


def sinusoidal_pos(positions, d_model: int):
    """The reference's absolute positions (whisper): ``sin`` then ``cos``
    of ``positions (...)`` over ``d_model / 2`` frequencies, f32
    ``(..., d_model)``."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense(w, x, b=None):
    y = x @ w
    return y if b is None else y + b


def proj(p, name, x):
    """``x @ p[name]``, plus its bias ``p[name + "_b"]`` where it has one."""
    return dense(p[name], x, p.get(name + "_b"))


def f32_product(x, w):
    """``x @ w`` with an f32 result: on the card (or meta) without grad,
    a bf16 or f16 product written in f32 (``torch.mm``'s ``out_dtype``,
    where this PyTorch has it: the same GEMM, its accumulator kept);
    otherwise the product of the operands cast to f32 (under autograd,
    or on the CPU; no cast where they are f32 already)."""
    if (x.device.type in ("cuda", "meta") and _MM_OUT_DTYPE
            and x.dtype in (torch.bfloat16, torch.float16)
            and w.dtype == x.dtype and not comm.needs_grad(x, w)):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


# torch.mm(..., out_dtype=) (an f32 result of a half-precision product)
_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def row_proj(p, name, x, tp=None):
    """A row-parallel projection (attention's and the MLP's ``wo``): this
    rank's partial product summed over the model axis ``tp``
    (``distributed/comm.py``; none without a mesh), then the bias, once.
    Above axis size 1 the partial product is f32 (:func:`f32_product`),
    summed in f32 and cast once to ``x``'s type, so the sum is rounded
    once as the unsharded product is (a sum of rounded partials would
    round again, which compounds through xLSTM's exponential gates); at
    size 1 the product is ``x``'s type and reduced as it is, so a meshed
    run at size 1 is the unmeshed run bit for bit. :func:`proj` where
    ``tp`` is None."""
    if tp is not None and tp.size > 1:
        y = comm.reduce_from_model(tp, f32_product(x, p[name])).to(x.dtype)
    else:
        y = comm.reduce_from_model(tp, x @ p[name])
    b = p.get(name + "_b")
    return y if b is None else y + b


def causal_conv1d(x, w, b=None, state=None):
    """Depthwise causal conv over time (Mamba, mLSTM), the reference's:
    x (B, S, C), taps w (K, C), optional bias b (C,), ``state (B, K-1,
    C)`` the inputs carried from before (zeros if None). The taps are
    summed in f32 in the reference's order and cast to x's type. Returns
    ``(y, new_state)``: new_state is the last K-1 inputs, in the type
    the state and x promote to (the decode cache casts it back to its
    own)."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    xx = torch.cat([state, x], dim=1)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xx[:, i:i + S].float() * w[i].float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype), xx[:, S:]


def mlp_apply(cfg, p, x, tp=None):
    """SwiGLU / GeGLU / GELU MLP; ``wi``'s output splits as (gate, up).
    Under tensor parallelism (``tp``, the model axis's group) ``wi`` holds
    this rank's columns of gate and of up (``x`` enters through
    ``comm.copy_to_model``), ``wo`` the matching rows
    (:func:`row_proj`)."""
    h = proj(p, "wi", comm.copy_to_model(tp, x))
    if cfg.mlp_type in ("silu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        act = F.silu(g) if cfg.mlp_type == "silu" else \
            F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(h, approximate="tanh")
    return row_proj(p, "wo", h, tp)


def model_rope(cfg, positions):
    """The RoPE table of one model call (:func:`rope_table`)."""
    return rope_table(positions, cfg.head_dim, rotary_pct=cfg.rotary_pct,
                      theta=cfg.rope_theta)


def attn_qkv(cfg, p, x, positions, rope=None, *, kernels=ops, tp=None):
    """Projections, the q/k norms where ``cfg.qk_norm`` (qwen3: an RMSNorm
    over each head's ``head_dim``, ``p["qnorm"]``/``p["knorm"]`` its
    ``(hd,)`` scales, through ``kernels.rmsnorm`` on rows of
    ``head_dim``), then RoPE. x: (B, S, d) -> q (B,S,H,hd), k/v
    (B,S,Hkv,hd). ``rope`` is the call's :func:`model_rope` table, shared
    by every layer; without it each rotation builds its own. Under
    ``tp`` (``cfg`` a rank's) the projections hold this rank's heads and
    ``x`` enters through ``comm.copy_to_model``."""
    B, S, _ = x.shape
    x = comm.copy_to_model(tp, x)
    q = proj(p, "wq", x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = proj(p, "wk", x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = proj(p, "wv", x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = kernels.rmsnorm(q, p["qnorm"])
        k = kernels.rmsnorm(k, p["knorm"])
    q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta, table=rope)
    k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta, table=rope)
    return q, k, v


def attn_qkv_whole(cfg, p, x, positions, rope=None, *, kernels=ops,
                   tp=None):
    """:func:`attn_qkv` on whole heads where the axis does not split them
    (``sharding.kv_seq``): this rank's columns of q, k and v projected
    (a cut inside a head where the config is gathered, its heads where
    split), gathered over ``tp`` in one all-gather, a replicated KV head
    (which each of its ranks shipped) kept once, then the q/k norms and
    RoPE on whole heads. x: (B, S, d) -> q (B, S, H, hd), k/v (B, S,
    Hkv, hd), the whole model's heads."""
    B, S, _ = x.shape
    H, Hkv = sharding.whole_heads(cfg)
    hd = cfg.head_dim
    x = comm.copy_to_model(tp, x)
    q, k, v = comm.gather_cols(tp, proj(p, "wq", x), proj(p, "wk", x),
                               proj(p, "wv", x))
    q = q.reshape(B, S, H, hd)
    k, v = (t.reshape(B, S, -1, hd) for t in (k, v))
    if k.shape[2] != Hkv:
        step = k.shape[2] // Hkv
        k, v = k[:, :, ::step], v[:, :, ::step]
    if cfg.qk_norm:
        q = kernels.rmsnorm(q, p["qnorm"])
        k = kernels.rmsnorm(k, p["knorm"])
    q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta, table=rope)
    k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta, table=rope)
    return q, k, v


def qseq_attention(tp, q, k, v, *, causal=True, window=0, softcap=0.0,
                   kernels=ops):
    """Attention over whole heads (:func:`attn_qkv_whole`) the reference's
    ``ATTN_QSEQ_RULES`` way, returning this rank's columns of the output
    (B, S, H * hd / n) for its row-parallel ``wo``. q: (B, S, H, hd);
    k/v: (B, Sk, Hkv, hd), whole on every rank. Where the axis divides S
    (and no window), rank r attends its S / n query rows: causal, over
    keys ``[0, (r + 1) S / n)`` (``kernels.flash_attention``'s suffix call
    with ``prefix_len = r S / n``, every prefix key visible: exactly the
    causal mask of those rows), or bidirectional over every key; the
    rows' outputs go back to the ranks' columns in one all-to-all
    (``comm.rows_to_cols``). Otherwise every rank attends every row and
    keeps its columns. ``softcap``: the logit softcap of every call."""
    B, S, H, hd = q.shape
    n, r = tp.size, tp.rank
    if S % n or window:
        o = kernels.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
        return o.reshape(B, S, H * hd).chunk(n, -1)[r]
    m = S // n
    lo = r * m
    qr = q[:, lo:lo + m]
    if not causal:
        o = kernels.flash_attention(qr, k, v, causal=False, softcap=softcap)
    elif lo == 0:
        o = kernels.flash_attention(qr, k[:, :m], v[:, :m], causal=True,
                                    softcap=softcap)
    else:
        plen = torch.full((B,), lo, dtype=torch.int32, device=q.device)
        o = kernels.flash_attention(qr, k[:, :lo + m], v[:, :lo + m],
                                    prefix_len=plen, softcap=softcap)
    return comm.rows_to_cols(tp, o.reshape(B, m, H * hd))


def _xent_chunk(xc, w, tc, mc, tp=None, split=None):
    """One chunk's masked NLL sum: f32 logits (the reference's bf16
    operands with f32 accumulation is their f32 product), logsumexp minus
    the gold logit. ``split`` (with ``tp``, the model axis) is how the
    unembedding is cut: ``"vocab"``, this rank's columns of the vocab
    (each row's max gathered, its sum of exponentials and gold logit
    summed over the axis, the gold from the rank that owns the target);
    ``"d"``, a tied table's rows of ``d`` (the rank's slice of ``xc``
    times its slice of the table, the logits summed over the axis)."""
    if split == "d":
        xr = xc.chunk(tp.size, -1)[tp.rank]
        logits = comm.reduce_from_model(tp, xr.float() @ w.float())
    else:
        logits = xc.float() @ w.float()
    if split != "vocab":
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        return ((lse - gold) * mc).sum()
    with torch.no_grad():         # the shift is any constant: no gradient
        m = tp.all_gather(logits.amax(-1, keepdim=True), -1).amax(
            -1, keepdim=True)
    s = comm.reduce_from_model(tp, torch.exp(logits - m).sum(-1))
    lse = torch.log(s) + m[..., 0]
    v = logits.shape[-1]
    t = tc - tp.rank * v
    mine = (t >= 0) & (t < v)
    gold = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])[
        ..., 0]
    gold = comm.reduce_from_model(tp, torch.where(mine, gold, 0.0))
    return ((lse - gold) * mc).sum()


def xent_split(cfg, tp):
    """How :func:`chunked_xent` cuts the unembedding of ``cfg`` over the
    model axis ``tp``, as ``transformer.logits_of`` does: None without an
    axis above size 1, or where the vocabulary does not divide it
    (``unembed`` whole, every logit on every rank); ``"d"`` for a tied
    table; ``"vocab"`` otherwise."""
    if tp is None or tp.size == 1 or (not cfg.tie_embeddings
                                      and cfg.vocab_size % tp.size):
        return None
    return "d" if cfg.tie_embeddings else "vocab"


def chunked_xent(x, w_unembed, targets, *, chunk: int = 2048, mask=None,
                 tp=None, split=None, data=()):
    """The reference's chunked softmax cross-entropy: x (B, S, d) final
    hiddens, w_unembed (d, V), targets (B, S) ints, mask (B, S) or None.
    The sequence runs in chunks of ``chunk`` (the last one zero-padded,
    its padding masked), the masked NLL summed chunk by chunk, then
    divided by the mask's sum (at least 1). Each chunk runs under
    ``torch.utils.checkpoint``: its (B, chunk, V) f32 logits are not kept
    for backward but recomputed there, so at a 256k vocab only one
    chunk's logits exist at a time.

    Sharded (``tp``, ``split`` as :func:`xent_split`; ``w_unembed`` this
    rank's part): ``x`` enters through ``comm.copy_to_model`` and each
    chunk reduces over the axis (:func:`_xent_chunk`), again when
    backward recomputes it. ``data`` are the data axes' groups: the
    mask's sum is summed over them before the division, so that the
    ranks' losses add up to the global batch's mean and their gradients,
    summed over the data axes, to its gradient."""
    B, S, _ = x.shape
    c = min(chunk, S)
    pad = -(-S // c) * c - S
    ms = torch.ones((B, S), dtype=torch.float32, device=x.device) \
        if mask is None else mask.float()
    if split is not None:
        x = comm.copy_to_model(tp, x)
    xs = F.pad(x, (0, 0, 0, pad))
    ts, ms = F.pad(targets.long(), (0, pad)), F.pad(ms, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S + pad, c):
        args = (xs[:, i:i + c], w_unembed, ts[:, i:i + c], ms[:, i:i + c])
        if split is not None:
            args += (tp, split)
        tot = tot + checkpoint(_xent_chunk, *args, use_reentrant=False)
        cnt = cnt + ms[:, i:i + c].sum()
    for grp in data:
        cnt = grp.all_reduce(cnt)
    return tot / torch.clamp(cnt, min=1.0)
