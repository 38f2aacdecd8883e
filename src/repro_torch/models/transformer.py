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
positions (``init_cache``). ``decode_step`` is the reference's
``decode_step`` / ``decode_step_inplace`` for the plain dense family: it
scatters the new token's K/V into the stacked cache IN PLACE (at
``lengths % window`` on a ring) and attends through the
``decode_attention`` kernel, which reads one layer of the cache where it
lies. The reference's dense step attends with plain jnp
(``layers.attention`` with ``kv_len``/``q_offset``, or
``_decode_attn_hkv``), not with its Pallas ``decode_attention``; the
kernel computes the same function.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers, moe
from repro_torch.models.layers import dense


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


def init_params(cfg, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Random weights with the reference's scales (normal * 1/sqrt(d_in),
    embed * 0.02; RMSNorm scales zero, LayerNorm scales one and biases
    zero; a MoE router f32). Each tensor is drawn directly in its type on
    ``device`` from one ``torch.Generator``, one tensor at a time:
    LLaMA-30B's 65 GB of bf16 weights, or one llama4 expert ``wi`` of
    21.5 GB, never pass through an f32 temporary. The numbers differ from
    ``jax.random``'s; parity tests convert the JAX weights instead."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    gated = cfg.mlp_type in ("silu", "geglu")

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dt).mul_(scale)

    def norm(n=d):
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        if cfg.norm_type == "rmsnorm":
            return zeros
        return {"scale": torch.ones_like(zeros), "bias": zeros}

    def mlp(f):
        return {"wi": normal((d, 2 * f if gated else f), 1 / math.sqrt(d)),
                "wo": normal((f, d), 1 / math.sqrt(f))}

    blocks = []
    for kind in cfg.layer_kinds():
        attn = {"wq": normal((d, qd), 1 / math.sqrt(d)),
                "wk": normal((d, kvd), 1 / math.sqrt(d)),
                "wv": normal((d, kvd), 1 / math.sqrt(d)),
                "wo": normal((qd, d), 1 / math.sqrt(qd))}
        if cfg.qk_norm:
            attn["qnorm"] = norm(cfg.head_dim)
            attn["knorm"] = norm(cfg.head_dim)
        blk = {"norm1": norm(), "attn": attn}
        if kind.endswith("+moe"):
            E, f = cfg.moe_num_experts, cfg.moe_d_ff
            blk["moe"] = {
                "router": normal((d, E), 1 / math.sqrt(d), torch.float32),
                "wi": normal((E, d, 2 * f if gated else f),
                             1 / math.sqrt(d)),
                "wo": normal((E, f, d), 1 / math.sqrt(f))}
            if cfg.moe_shared_expert:
                blk["moe"]["shared"] = mlp(f)
        else:
            blk["mlp"] = mlp(cfg.d_ff)
        if not (cfg.parallel_block and "mlp" in blk):
            blk["norm2"] = norm()
        blocks.append(blk)
    params = {"embed": normal((cfg.vocab_size, d), 0.02), "layers": blocks,
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    if cfg.family == "vlm":
        params["mm_projector"] = normal((d, d), 1 / math.sqrt(d))
    return params


def unembed_matrix(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype) -> float:
    """``sqrt(d_model)`` rounded to ``dtype`` first, as the reference
    multiplies by ``jnp.asarray(sqrt(d), x.dtype)``."""
    return float(torch.tensor(math.sqrt(d_model), dtype=dtype))


def embed(cfg, params, tokens, patch_embeds=None):
    """Token embeddings, times the rounded ``sqrt(d_model)`` where
    ``cfg.embed_scale`` (gemma). A VLM given ``patch_embeds (B, P, d)``
    puts ``mm_projector`` of them (cast to the embeddings' type first)
    in front of the text, as the reference's ``_embed_inputs``."""
    x = params["embed"][tokens]
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


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device="cuda"):
    shape = (cfg.num_layers, batch, cache_rows(cfg, max_seq),
             cfg.num_kv_heads, cfg.head_dim)
    return {"slot0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)},
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def run_layers(cfg, params, x, attend, *, final_norm=True,
               backend: str = "auto"):
    """The residual stream ``x`` through every layer: ``attend(i, p, h)``
    returns layer i's attention output, projected back to d_model, for the
    normed input ``h``. Each residual add goes with the norm after it
    (``layers.add_norm``: one ``ops.add_rmsnorm`` launch on the card for
    RMSNorm): the attention residual with ``norm2``, the MLP residual with
    the next layer's ``norm1`` or, after the last layer, with the final
    norm. A parallel block feeds attention and MLP the same ``h`` and adds
    ``(x + attn) + mlp``, in that order on every path (the reference's
    ``prefill_suffix``, ``decode_step_inplace`` and paged step do; its
    ``forward`` adds ``x + (attn + mlp)``). Returns ``(x, h)``: the stream
    and its final norm; with ``final_norm=False`` the last add stays
    unfused and ``h`` is None (prefill norms only the rows it keeps).

    The FFN follows the layer's kind: an MLP, or (a layer holding
    ``moe``) ``moe.moe_apply`` over the call's tokens, as the reference's
    ``_apply_ffn`` on every path; a MoE layer is never a parallel block.

    On the CPU the arithmetic is the reference's exactly: an add, then
    the norm's plain version."""
    blocks = params["layers"]
    h = layers.norm_apply(cfg, blocks[0]["norm1"], x, backend=backend)
    for i, p in enumerate(blocks):
        o = attend(i, p, h)
        if cfg.parallel_block and "mlp" in p:
            m = layers.mlp_apply(cfg, p["mlp"], h)
            x = x + o
        else:
            x, h = layers.add_norm(cfg, x, o, p["norm2"], backend=backend)
            m = moe.moe_apply(cfg, p["moe"], h)[0] if "moe" in p else \
                layers.mlp_apply(cfg, p["mlp"], h)
        if i + 1 < len(blocks):
            x, h = layers.add_norm(cfg, x, m, blocks[i + 1]["norm1"],
                                   backend=backend)
        elif final_norm:
            x, h = layers.add_norm(cfg, x, m, params["final_norm"],
                                   backend=backend)
        else:
            x, h = x + m, None
    return x, h


def _last_logits(cfg, params, x, last_pos):
    """Final norm + unembed at each sequence's last real position, in f32
    (``h_last @ w`` in the working type, then cast, as the reference)."""
    B = x.shape[0]
    if last_pos is None:
        h_last = x[:, -1:]
    else:
        h_last = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    h_last = layers.norm_apply(cfg, params["final_norm"], h_last)
    return (h_last @ unembed_matrix(cfg, params)).float()


def _lengths(true_len, B, S, device):
    if true_len is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return true_len.to(torch.int32)


def prefill(cfg, params, tokens, *, max_seq: int, last_pos=None,
            true_len=None, patch_embeds=None):
    """Process right-padded prompts ``tokens (B, S)``; returns
    (logits at ``last_pos`` (B, 1, V) f32, cache). Causal attention makes
    the right padding invisible to the real positions; a sliding window
    (flash attention's ``window``) is not, so sliding-window stacks are
    prefilled at their exact lengths (``PrefillEngine``), and their cache
    keeps the last ``window`` positions as a ring (:func:`cache_rows`).
    A VLM's ``patch_embeds (B, P, d)`` come first (:func:`embed`): the
    sequence is P + S long, and ``last_pos``/``true_len`` count the
    patches (``registry.build``'s prefill shifts them)."""
    _unported(cfg, "prefill", layout=False)
    dev = tokens.device
    x = embed(cfg, params, tokens, patch_embeds)
    B, S = x.shape[:2]
    if S > max_seq:
        raise ValueError(f"prompt bucket {S} exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = init_cache(cfg, B, S, cache_dtype(cfg), device=dev)
    rows = cache["slot0"]["k"].shape[2]

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        o = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window)
        if rows < S:
            # the last `rows` positions, position p at ring row p % rows
            k = torch.roll(k[:, -rows:], S % rows, dims=1)
            v = torch.roll(v[:, -rows:], S % rows, dims=1)
        cache["slot0"]["k"][i] = k
        cache["slot0"]["v"][i] = v
        return dense(p["attn"]["wo"], o.reshape(B, S, cfg.q_dim))

    x, _ = run_layers(cfg, params, x, attend, final_norm=False)
    cache["lengths"] = _lengths(true_len, B, S, dev)
    return _last_logits(cfg, params, x, last_pos), cache


def prefill_suffix(cfg, params, tokens, prefix_kv, prefix_len, *,
                   max_seq: int, last_pos=None, true_len=None):
    """Prefill only a prompt SUFFIX against already-computed prefix KV
    (the partial prefix hit and chunked prefill). ``prefix_kv["slot0"]``
    is (k, v) of shape (L, B, P, Hkv, hd), right-padded to P;
    ``prefix_len (B,)`` the true prefix lengths. Suffix queries sit at
    absolute positions ``prefix_len + i``. The returned cache holds only
    the suffix KV (lengths = suffix true lengths). Full attention only,
    as the reference asserts."""
    if cfg.sliding_window:
        raise ValueError(f"{cfg.name}: suffix prefill assumes full "
                         f"attention")
    _unported(cfg, "suffix prefill", layout=False)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"suffix bucket {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    pk_all, pv_all = prefix_kv["slot0"]
    x = embed(cfg, params, tokens)
    positions = prefix_len[:, None].long() + torch.arange(S, device=dev)[None]
    cache = init_cache(cfg, B, S, cache_dtype(cfg), device=dev)

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        K = torch.cat([pk_all[i].to(k.dtype), k], dim=1)
        V = torch.cat([pv_all[i].to(v.dtype), v], dim=1)
        o = ops.flash_attention(q, K, V, prefix_len=prefix_len)
        cache["slot0"]["k"][i] = k
        cache["slot0"]["v"][i] = v
        return dense(p["attn"]["wo"], o.reshape(B, S, cfg.q_dim))

    x, _ = run_layers(cfg, params, x, attend, final_norm=False)
    cache["lengths"] = _lengths(true_len, B, S, dev)
    return _last_logits(cfg, params, x, last_pos), cache


def _unported(cfg, what, *, layout=True):
    """Options no registered config uses, which the kernels do not
    compute: a logit softcap, and (for the dense decode step) the
    reference's ``hkv_s`` cache layout."""
    why = [name for name, on in (
        ("a logit softcap", cfg.attn_logit_softcap),
        ("the hkv_s cache layout",
         layout and cfg.decode_cache_layout == "hkv_s")) if on]
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {what} with {', '.join(why)} is not ported "
            f"(ROADMAP A.15)")


def decode_step(cfg, params, cache, tokens, *, backend: str = "auto"):
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
    f32, cache) with ``lengths + 1``."""
    _unported(cfg, "the dense decode step")
    x = embed(cfg, params, tokens)
    B = x.shape[0]
    lengths = cache["lengths"]
    positions = lengths[:, None]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // Hkv
    K, V = cache["slot0"]["k"], cache["slot0"]["v"]
    rows = K.shape[2]
    bidx = torch.arange(B, device=x.device)
    if cfg.sliding_window and rows == cfg.sliding_window:
        w_pos = torch.remainder(lengths.long(), rows)
        kv_len = torch.clamp(lengths + 1, max=rows).to(torch.int32)
    else:
        w_pos = torch.clamp(lengths.long(), max=rows - 1)
        kv_len = (lengths + 1).to(torch.int32)

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        K[i][bidx, w_pos] = k[:, 0].to(K.dtype)
        V[i][bidx, w_pos] = v[:, 0].to(V.dtype)
        o = ops.decode_attention(
            q[:, 0].reshape(B, Hkv, g, hd).contiguous(),
            K[i].permute(0, 2, 1, 3), V[i].permute(0, 2, 1, 3), kv_len,
            backend=backend)
        return dense(p["attn"]["wo"], o.reshape(B, 1, cfg.q_dim).to(h.dtype))

    _, h = run_layers(cfg, params, x, attend, backend=backend)
    logits = (h @ unembed_matrix(cfg, params)).float()
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits, new_cache
