"""Whisper-style encoder-decoder (the port of ``repro.models.whisper``).

The audio front end is a stub, as in the reference: a caller supplies
frame embeddings ``(B, encoder_seq, d_model)``. The encoder runs
bidirectional self-attention over the frames; the decoder causal
self-attention over its tokens and cross-attention over the encoder's
output. Positions are sinusoidal (``layers.sinusoidal_pos``), norms
LayerNorm (plain, as for the dense configs), and every projection has a
bias (``cfg.attn_bias``, ``cfg.mlp_bias``).

Attention runs through the kernels: the encoder, the decoder's
self-attention prefill (causal) and its cross-attention prefill
(``Sq`` tokens over ``Sk = encoder_seq`` frames) through
``ops.flash_attention``; both decode attentions through
``ops.decode_attention``, self-attention with ``kv_len = lengths + 1``
and cross-attention with ``kv_len = encoder_seq``. The training forward
(:func:`forward`, :func:`loss_fn`) runs the same layers through the
plain attention (``ref.flash_attention_ref``, the reference's jnp
``attention``), as the reference trains.

Parameters: ``{"embed": (V, d), "enc_layers": [{"norm1", "attn",
"norm2", "mlp"}, ...], "enc_norm", "dec_layers": [{"norm1",
"self_attn", "norm2", "cross_attn", "norm3", "mlp"}, ...],
"final_norm", "unembed": (d, V)}`` with the attention and MLP dicts of
``models/transformer.py``. A cache is the reference's flat one:
``{"self_k", "self_v": (L, B, S, Hkv, hd), "cross_k", "cross_v": (L, B,
encoder_seq, Hkv, hd), "lengths": (B,)}``, bf16 whatever the model's
type, as the reference's; a prefill cache holds the S prompt positions
(the reference pads it to ``max_seq`` with rows the wire never reads).

Under tensor parallelism (``rt``, a ``transformer.Runtime`` over a mesh;
:func:`prefill` and :func:`decode_step`) a rank holds its heads of every
attention (encoder, decoder self and cross: ``wq``/``wk``/``wv`` and
their biases column-parallel, ``wo`` row-parallel, all-reduced, its bias
added once after), its columns of each MLP's ``wi`` (and bias) and rows
of ``wo``, the embedding's columns (the rows looked up are gathered) and
the vocabulary's columns of ``unembed`` where the axis divides it (the
logits gathered; whisper-base's 51865 does not, and every rank computes
every logit). LayerNorms are whole. Its caches, the self and the cross
K/V, hold its heads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.layers import norm_apply, proj, row_proj
from repro_torch.models.transformer import (ParamMaker, data_groups, embed,
                                           logits_of, shard_view, write_pos)

CACHE_DTYPE = torch.bfloat16


def init_params(cfg, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16, mesh=None):
    """Random weights with the reference's scales (:class:`ParamMaker`).
    With a ``mesh`` each tensor is drawn whole, in the unsharded order,
    and only this rank's shard is kept (``sharding.shard_params``, one
    layer at a time)."""
    mk = ParamMaker(cfg, seed, device, dtype)
    sharding.check_tp(cfg, sharding.model_size(mesh))

    def keep(tree):
        return sharding.shard_params(tree, cfg, mesh)

    enc = [keep({"norm1": mk.norm(), "attn": mk.attn(), "norm2": mk.norm(),
                 "mlp": mk.mlp()}) for _ in range(cfg.num_encoder_layers)]
    dec = [keep({"norm1": mk.norm(), "self_attn": mk.attn(),
                 "norm2": mk.norm(), "cross_attn": mk.attn(),
                 "norm3": mk.norm(), "mlp": mk.mlp()})
           for _ in range(cfg.num_layers)]
    d, V = cfg.d_model, cfg.vocab_size
    return {**keep({"embed": mk.normal((V, d), 0.02)}), "enc_layers": enc,
            "enc_norm": mk.norm(), "dec_layers": dec,
            "final_norm": mk.norm(),
            **keep({"unembed": mk.normal((d, V), 1 / math.sqrt(d))})}


def _positions(S, B, device):
    return torch.arange(S, device=device).expand(B, S)


def encode(cfg, params, frame_embeds, *, kernels=ops, tp=None):
    """The encoder over ``frame_embeds (B, S_enc, d)``, its attention
    ``kernels.flash_attention``. The reference casts the frames to bf16,
    its weights' type; here they take the encoder weights' type (the same
    for bf16 weights). Under ``tp`` on this rank's heads."""
    B, S, d = frame_embeds.shape
    dt = params["enc_layers"][0]["attn"]["wq"].dtype
    x = frame_embeds.to(dt)
    pos = _positions(S, B, x.device)
    x = x + layers.sinusoidal_pos(pos[0], d).to(dt)[None]
    for p in params["enc_layers"]:
        h = norm_apply(cfg, p["norm1"], x)
        q, k, v = layers.attn_qkv(cfg, p["attn"], h, pos, tp=tp)
        o = kernels.flash_attention(q, k, v, causal=False)
        x = x + row_proj(p["attn"], "wo", o.reshape(B, S, cfg.q_dim), tp)
        x = x + layers.mlp_apply(cfg, p["mlp"],
                                 norm_apply(cfg, p["norm2"], x), tp)
    return norm_apply(cfg, params["enc_norm"], x)


def _cross_kv(cfg, p_layer, enc_out, tp=None):
    """One decoder layer's cross K/V of the encoder output, in the type
    the encoder output and the layer's weights promote to (the
    reference's ``dense`` promotes); under ``tp`` the rank's heads, the
    encoder output entering through ``comm.copy_to_model``."""
    B, S, _ = enc_out.shape
    a = p_layer["cross_attn"]
    x = comm.copy_to_model(tp, enc_out.to(
        torch.promote_types(enc_out.dtype, a["wk"].dtype)))
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return proj(a, "wk", x).reshape(shape), proj(a, "wv", x).reshape(shape)


def _dec_tail(cfg, p, x, o_self, cross_attend, tp=None):
    """The decoder layer after its self-attention output ``o_self`` (B, S,
    H, hd): residual, cross-attention (``cross_attend(q)`` of the
    queries), residual, MLP."""
    B, S = x.shape[:2]
    x = x + row_proj(p["self_attn"], "wo", o_self.reshape(B, S, cfg.q_dim),
                     tp)
    h = comm.copy_to_model(tp, norm_apply(cfg, p["norm2"], x))
    q = proj(p["cross_attn"], "wq", h).reshape(B, S, cfg.num_heads,
                                               cfg.head_dim)
    o = cross_attend(q)
    x = x + row_proj(p["cross_attn"], "wo", o.reshape(B, S, cfg.q_dim), tp)
    return x + layers.mlp_apply(cfg, p["mlp"],
                                norm_apply(cfg, p["norm3"], x), tp)


def init_cache(cfg, batch: int, max_seq: int, dtype=CACHE_DTYPE, *,
               device="cuda"):
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    z = lambda S: torch.zeros((L, batch, S, Hkv, hd), dtype=dtype,
                              device=device)
    return {"self_k": z(max_seq), "self_v": z(max_seq),
            "cross_k": z(cfg.encoder_seq), "cross_v": z(cfg.encoder_seq),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def forward(cfg, params, tokens, frame_embeds, rt=None):
    """The training forward (the reference's ``forward``): the encoder
    over ``frame_embeds``, then the decoder over ``tokens (B, S)``
    teacher-forced, causal self-attention and cross-attention to the
    encoder, all through the plain attention (the norms are LayerNorms,
    plain on every path). Returns the final-normed hidden states (B, S,
    d). Under a mesh (``rt``) this rank's heads, columns and embedding
    slice, on its data rank's rows, the collectives differentiable
    (``distributed/comm.py``) as in ``transformer.forward``."""
    cfg, tp = shard_view(cfg, rt)
    enc_out = encode(cfg, params, frame_embeds, kernels=layers.PLAIN, tp=tp)
    B, S = tokens.shape
    x = embed(cfg, params, tokens, tp=tp)
    pos = _positions(S, B, tokens.device)
    x = x + layers.sinusoidal_pos(pos[0], cfg.d_model).to(x.dtype)[None]
    for p in params["dec_layers"]:
        h = norm_apply(cfg, p["norm1"], x)
        q, k, v = layers.attn_qkv(cfg, p["self_attn"], h, pos,
                                  kernels=layers.PLAIN, tp=tp)
        o = ref.flash_attention_ref(q, k, v, causal=True)
        kc, vc = _cross_kv(cfg, p, enc_out, tp)
        x = _dec_tail(cfg, p, x, o, lambda q_: ref.flash_attention_ref(
            q_, kc, vc, causal=False), tp)
    return norm_apply(cfg, params["final_norm"], x)


def loss_fn(cfg, params, batch, rt=None):
    """``layers.chunked_xent`` of :func:`forward` over ``unembed``;
    ``batch``: tokens, targets, frame_embeds and an optional mask. Under
    a mesh (``rt``) the rank's rows, the mask's sum taken over the data
    axes and the unembedding cut as ``logits_of`` cuts it
    (``transformer.loss_fn``)."""
    x = forward(cfg, params, batch["tokens"], batch["frame_embeds"], rt=rt)
    _, tp = shard_view(cfg, rt)
    return layers.chunked_xent(x, params["unembed"], batch["targets"],
                               chunk=cfg.vocab_chunk, mask=batch.get("mask"),
                               tp=tp, split=layers.xent_split(cfg, tp),
                               data=data_groups(rt))


def prefill(cfg, params, tokens, frame_embeds, *, max_seq: int,
            last_pos=None, true_len=None, rt=None):
    """The encoder, then the decoder over ``tokens (B, S)``: causal flash
    self-attention and non-causal flash cross-attention over the encoder
    output. ``last_pos``/``true_len`` serve right-padded prompts (causal
    self-attention keeps the padding from the real positions). Returns
    (logits at the last position (B, 1, V) f32, cache); under a mesh
    (``rt``) the cache holds this rank's heads."""
    cfg, tp = shard_view(cfg, rt)
    enc_out = encode(cfg, params, frame_embeds, tp=tp)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    x = embed(cfg, params, tokens, tp=tp)
    pos = _positions(S, B, dev)
    x = x + layers.sinusoidal_pos(pos[0], cfg.d_model).to(x.dtype)[None]
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache = {name: torch.empty((L, B, n, Hkv, hd), dtype=CACHE_DTYPE,
                               device=dev)
             for name, n in (("self_k", S), ("self_v", S),
                             ("cross_k", enc_out.shape[1]),
                             ("cross_v", enc_out.shape[1]))}
    for i, p in enumerate(params["dec_layers"]):
        h = norm_apply(cfg, p["norm1"], x)
        q, k, v = layers.attn_qkv(cfg, p["self_attn"], h, pos)
        o = ops.flash_attention(q, k, v, causal=True)
        kc, vc = _cross_kv(cfg, p, enc_out, tp)
        x = _dec_tail(cfg, p, x, o, lambda q_: ops.flash_attention(
            q_, kc, vc, causal=False), tp)
        for name, t in (("self_k", k), ("self_v", v), ("cross_k", kc),
                        ("cross_v", vc)):
            cache[name][i] = t
    x = norm_apply(cfg, params["final_norm"], x)
    cache["lengths"] = (torch.full((B,), S, dtype=torch.int32, device=dev)
                        if true_len is None else true_len.to(torch.int32))
    if last_pos is None:
        h_last = x[:, -1:]
    else:
        h_last = x[torch.arange(B, device=dev), last_pos.long()][:, None]
    return logits_of(cfg, params, h_last, tp), cache


def decode_step(cfg, params, cache, tokens, *, backend: str = "auto",
                rt=None):
    """One decoder token per slot against both caches; tokens (B, 1).
    This step's self K/V is written into ``self_k``/``self_v`` IN PLACE
    at row ``lengths`` (clamped to the last row, which only an idle slot
    reaches), so a captured chunk replays on the engine's own cache.
    Returns (logits (B, 1, V) f32, cache with ``lengths + 1``); under a
    mesh (``rt``) the caches hold this rank's heads."""
    cfg, tp = shard_view(cfg, rt)
    lengths = cache["lengths"]
    x = embed(cfg, params, tokens, tp=tp)
    B = x.shape[0]
    dev = x.device
    x = x + layers.sinusoidal_pos(lengths, cfg.d_model)[:, None].to(x.dtype)
    positions = lengths[:, None]
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // Hkv
    w_pos, kv_self = write_pos(cfg, lengths, cache["self_k"].shape[2])
    kv_cross = torch.full((B,), cache["cross_k"].shape[2],
                          dtype=torch.int32, device=dev)

    def attend(q, K, V, kv_len):
        o = ops.decode_attention(
            q[:, 0].reshape(B, Hkv, g, hd).contiguous(),
            K.permute(0, 2, 1, 3), V.permute(0, 2, 1, 3), kv_len,
            backend=backend)
        return o.reshape(B, 1, cfg.num_heads, hd)

    for i, p in enumerate(params["dec_layers"]):
        K, V = cache["self_k"][i], cache["self_v"][i]
        h = norm_apply(cfg, p["norm1"], x)
        q, k, v = layers.attn_qkv(cfg, p["self_attn"], h, positions)
        K[w_pos] = k[:, 0].to(K.dtype)
        V[w_pos] = v[:, 0].to(V.dtype)
        o = attend(q, K, V, kv_self)
        x = _dec_tail(cfg, p, x, o, lambda q_: attend(
            q_, cache["cross_k"][i], cache["cross_v"][i], kv_cross), tp)
    x = norm_apply(cfg, params["final_norm"], x)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits_of(cfg, params, x, tp), new_cache
