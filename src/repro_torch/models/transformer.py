"""Dense decoder-only transformer: init, prefill, suffix prefill and the
dense decode step (the dense-family parts of ``repro.models.transformer``).

Parameters are plain dicts of tensors, one dict per layer instead of the
reference's layer-stacked pytree (``models/convert.py`` maps one onto the
other):

    {"embed": (V, d), "final_norm": (d,), "unembed": (d, V),
     "layers": [{"norm1": (d,), "norm2": (d,),
                 "attn": {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                          "wo": (qd, d)},
                 "mlp": {"wi": (d, 2*d_ff), "wo": (d_ff, d)}}, ...]}

A prefill cache is ``{"slot0": {"k", "v": (L, B, S, Hkv, hd)},
"lengths": (B,)}``, the reference's layout. The port's prefill cache
holds the S computed positions; the reference pads it to ``max_seq``
with zeros that the wire extraction never reads. The cache is written in
place, layer by layer.

A decode cache has the same layout at ``max_seq`` positions
(``init_cache``). ``decode_step`` is the reference's ``decode_step`` /
``decode_step_inplace`` for the plain dense family: it scatters the new
token's K/V into the stacked cache IN PLACE and attends through the
``decode_attention`` kernel, which reads one layer of the cache where it
lies. The reference's dense step attends with plain jnp
(``layers.attention`` with ``kv_len``/``q_offset``, or
``_decode_attn_hkv``), not with its Pallas ``decode_attention``; the
kernel computes the same function.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import dense


def init_params(cfg, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Random weights with the reference's scales (normal * 1/sqrt(d_in),
    embed * 0.02, norms zero). Each tensor is drawn directly in ``dtype``
    on ``device`` from one ``torch.Generator``: LLaMA-30B's 65 GB of bf16
    weights never pass through an f32 temporary. The numbers differ from
    ``jax.random``'s; parity tests convert the JAX weights instead."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype).mul_(scale)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "norm1": zeros(d),
            "attn": {"wq": normal((d, qd), 1 / math.sqrt(d)),
                     "wk": normal((d, kvd), 1 / math.sqrt(d)),
                     "wv": normal((d, kvd), 1 / math.sqrt(d)),
                     "wo": normal((qd, d), 1 / math.sqrt(qd))},
            "norm2": zeros(d),
            "mlp": {"wi": normal((d, 2 * f), 1 / math.sqrt(d)),
                    "wo": normal((f, d), 1 / math.sqrt(f))},
        })
    params = {"embed": normal((cfg.vocab_size, d), 0.02), "layers": blocks,
              "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    return params


def unembed_matrix(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def cache_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device="cuda"):
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"slot0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)},
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def run_layers(cfg, params, x, attend, *, final_norm=True,
               backend: str = "auto"):
    """The residual stream ``x`` through every layer: ``attend(i, p, h)``
    returns layer i's attention output, projected back to d_model, for the
    normed input ``h``. Each residual add is fused with the norm after it
    (``ops.add_rmsnorm``, one launch on the card): the attention residual
    with ``norm2``, the MLP residual with the next layer's ``norm1`` or,
    after the last layer, with the final norm. Returns ``(x, h)``: the
    stream and its final norm; with ``final_norm=False`` the last add stays
    unfused and ``h`` is None (prefill norms only the rows it keeps).

    On the CPU the arithmetic is the reference's exactly: an add, then
    ``rmsnorm_ref``."""
    blocks = params["layers"]
    h = ops.rmsnorm(x, blocks[0]["norm1"], backend=backend)
    for i, p in enumerate(blocks):
        x, h = ops.add_rmsnorm(x, attend(i, p, h), p["norm2"],
                               backend=backend)
        m = layers.mlp_apply(cfg, p["mlp"], h)
        if i + 1 < len(blocks):
            x, h = ops.add_rmsnorm(x, m, blocks[i + 1]["norm1"],
                                   backend=backend)
        elif final_norm:
            x, h = ops.add_rmsnorm(x, m, params["final_norm"],
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
    h_last = ops.rmsnorm(h_last, params["final_norm"])
    return (h_last @ unembed_matrix(cfg, params)).float()


def _lengths(true_len, B, S, device):
    if true_len is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return true_len.to(torch.int32)


def prefill(cfg, params, tokens, *, max_seq: int, last_pos=None,
            true_len=None):
    """Process right-padded prompts ``tokens (B, S)``; returns
    (logits at ``last_pos`` (B, 1, V) f32, cache). Causal attention makes
    the right padding invisible to the real positions."""
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt bucket {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(S, device=dev).expand(B, S)
    cache = init_cache(cfg, B, S, cache_dtype(cfg), device=dev)

    rope = layers.model_rope(cfg, positions)   # once for every layer

    def attend(i, p, h):
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, positions, rope)
        o = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window)
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
    the suffix KV (lengths = suffix true lengths)."""
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"suffix bucket {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    pk_all, pv_all = prefix_kv["slot0"]
    x = params["embed"][tokens]
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


def _dense_decode_unported(cfg):
    why = [name for name, on in (
        ("a sliding-window ring cache", cfg.sliding_window),
        ("a logit softcap", cfg.attn_logit_softcap),
        ("the hkv_s cache layout", cfg.decode_cache_layout == "hkv_s"))
        if on]
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the dense decode step with {', '.join(why)} is not "
            f"ported (ROADMAP A.8)")


def decode_step(cfg, params, cache, tokens, *, backend: str = "auto"):
    """One decode step against the dense cache. tokens: (B, 1).

    Each slot's new K/V is written at position ``lengths`` of every layer
    of ``cache["slot0"]`` ((L, B, max_seq, Hkv, hd), in place, device
    indices only, so nothing waits on the host), then attention reads the
    layer through ``ops.decode_attention`` with ``kv_len = lengths + 1``.
    A write position past the cache is clamped to its last row (the
    engines retire a slot at ``max_seq - 1``, so only an idle slot gets
    there). Returns (logits (B, 1, V) f32, cache) with ``lengths + 1``."""
    _dense_decode_unported(cfg)
    x = params["embed"][tokens]
    B = x.shape[0]
    lengths = cache["lengths"]
    positions = lengths[:, None]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // Hkv
    K, V = cache["slot0"]["k"], cache["slot0"]["v"]
    bidx = torch.arange(B, device=x.device)
    w_pos = torch.clamp(lengths.long(), max=K.shape[2] - 1)
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
