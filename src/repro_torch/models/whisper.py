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

Where the axis does not split the heads (whisper-base's 8 at 16) or the
runtime asks for the kv_seq cache (``sharding.kv_seq``), every attention
runs on whole heads: a rank's columns of q, k and v (a cut inside a head
where gathered) are gathered, the encoder and the decoder's self and
cross attention of prefill and training attend the qseq way
(``layers.qseq_attention``: the encoder's 1500 frames, which 16 does not
divide, on every rank), and a decode step attends over the kv_seq cache:
the self cache's positions split over the ranks, the cross cache's
frames too where the axis divides ``encoder_seq`` and whole where not
(``_fits``), partial softmaxes merged (``transformer.seq_attention``).
A prefill's caches then hold every head.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import norm_apply, proj, row_proj
from repro_torch.models.transformer import (ParamMaker, cache_kv_heads,
                                           data_groups, embed, logits_of,
                                           seq_attention, seq_rows,
                                           seq_share, seq_write, shard_view,
                                           whole_rows, write_pos)

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
        o = _self_attend(cfg, p["attn"], h, pos, tp, causal=False,
                         kernels=kernels)[3]
        x = x + row_proj(p["attn"], "wo", o, tp)
        x = x + layers.mlp_apply(cfg, p["mlp"],
                                 norm_apply(cfg, p["norm2"], x), tp)
    return norm_apply(cfg, params["enc_norm"], x)


def _self_attend(cfg, a, h, pos, tp, *, causal, kernels=ops):
    """A self-attention of prefill or training: ``(q, k, v, o)``, ``o``
    (B, S, ·) what the row-parallel ``wo`` reads: whole heads and the
    rank's columns of the qseq attention under kv_seq, else the rank's
    heads and their output."""
    B, S = h.shape[:2]
    if sharding.kv_seq(cfg):
        q, k, v = layers.attn_qkv_whole(cfg, a, h, pos, tp=tp,
                                        kernels=kernels)
        return q, k, v, layers.qseq_attention(tp, q, k, v, causal=causal,
                                              kernels=kernels)
    q, k, v = layers.attn_qkv(cfg, a, h, pos, tp=tp, kernels=kernels)
    o = kernels.flash_attention(q, k, v, causal=causal)
    return q, k, v, o.reshape(B, S, cfg.q_dim)


def _heads(cfg, t, tp, kv=False):
    """A projection's columns (B, S, c) as heads: the rank's, or under
    kv_seq the whole model's, gathered over ``tp``."""
    B, S = t.shape[:2]
    if sharding.kv_seq(cfg):
        t = comm.gather_cols(tp, t)[0]
    return t.reshape(B, S, -1, cfg.head_dim)


def _cross_kv(cfg, p_layer, enc_out, tp=None):
    """One decoder layer's cross K/V of the encoder output, in the type
    the encoder output and the layer's weights promote to (the
    reference's ``dense`` promotes); under ``tp`` the rank's heads (every
    head under kv_seq), the encoder output entering through
    ``comm.copy_to_model``."""
    a = p_layer["cross_attn"]
    x = comm.copy_to_model(tp, enc_out.to(
        torch.promote_types(enc_out.dtype, a["wk"].dtype)))
    return _heads(cfg, proj(a, "wk", x), tp), _heads(cfg, proj(a, "wv", x),
                                                     tp)


def _dec_tail(cfg, p, x, o_self, cross_attend, tp=None):
    """The decoder layer after its self-attention output ``o_self`` (B, S,
    ·, what ``wo`` reads): residual, cross-attention (``cross_attend(q)``
    of the queries, as heads; it returns what ``wo`` reads), residual,
    MLP."""
    B, S = x.shape[:2]
    x = x + row_proj(p["self_attn"], "wo", o_self.reshape(B, S, -1), tp)
    h = comm.copy_to_model(tp, norm_apply(cfg, p["norm2"], x))
    q = _heads(cfg, proj(p["cross_attn"], "wq", h), tp)
    o = cross_attend(q)
    x = x + row_proj(p["cross_attn"], "wo", o.reshape(B, S, -1), tp)
    return x + layers.mlp_apply(cfg, p["mlp"],
                                norm_apply(cfg, p["norm3"], x), tp)


def _cross_prefill(cfg, q, kc, vc, tp, kernels=ops):
    """The prefill's (or training's) cross-attention of queries ``q`` over
    the encoder's K/V: the qseq way under kv_seq, else the rank's
    heads."""
    if sharding.kv_seq(cfg):
        return layers.qseq_attention(tp, q, kc, vc, causal=False,
                                     kernels=kernels)
    return kernels.flash_attention(q, kc, vc, causal=False)


def cross_rows(cfg) -> int:
    """Frames of the cross cache a rank holds: under kv_seq its share of
    ``encoder_seq`` where the axis divides it, else all of them (the
    reference's ``_fits`` keeps the 1500 frames whole at 16)."""
    n, S = sharding.split_of(cfg), cfg.encoder_seq
    return S // n if sharding.kv_seq(cfg) and S % n == 0 else S


def init_cache(cfg, batch: int, max_seq: int, dtype=CACHE_DTYPE, *,
               device="cuda"):
    """The decode cache (the module's docstring); under kv_seq every head,
    the self cache's positions split over the ranks (``seq_rows``) and
    the cross cache's frames where the axis divides them
    (:func:`cross_rows`)."""
    L, Hkv, hd = cfg.num_layers, cache_kv_heads(cfg), cfg.head_dim
    z = lambda S: torch.zeros((L, batch, S, Hkv, hd), dtype=dtype,
                              device=device)
    return {"self_k": z(seq_rows(cfg, max_seq)),
            "self_v": z(seq_rows(cfg, max_seq)),
            "cross_k": z(cross_rows(cfg)), "cross_v": z(cross_rows(cfg)),
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
        o = _self_attend(cfg, p["self_attn"], h, pos, tp, causal=True,
                         kernels=layers.PLAIN)[3]
        kc, vc = _cross_kv(cfg, p, enc_out, tp)
        x = _dec_tail(cfg, p, x, o, lambda q_: _cross_prefill(
            cfg, q_, kc, vc, tp, layers.PLAIN), tp)
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
    (``rt``) the cache holds this rank's heads, under kv_seq every head
    and the rank's share of the positions and frames, as
    :func:`init_cache`'s (``transformer.seq_share``)."""
    cfg, tp = shard_view(cfg, rt)
    enc_out = encode(cfg, params, frame_embeds, tp=tp)
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt {S} exceeds max_seq={max_seq}")
    dev = tokens.device
    x = embed(cfg, params, tokens, tp=tp)
    pos = _positions(S, B, dev)
    x = x + layers.sinusoidal_pos(pos[0], cfg.d_model).to(x.dtype)[None]
    L, Hkv, hd = cfg.num_layers, cache_kv_heads(cfg), cfg.head_dim
    F = enc_out.shape[1]
    c = cross_rows(cfg) if F == cfg.encoder_seq else F

    def frames(t):      # the rank's share of the frames, where split
        return t if c == F else t[:, tp.rank * c:(tp.rank + 1) * c]

    cache = {name: torch.empty((L, B, n, Hkv, hd), dtype=CACHE_DTYPE,
                               device=dev)
             for name, n in (("self_k", seq_rows(cfg, S)),
                             ("self_v", seq_rows(cfg, S)),
                             ("cross_k", c), ("cross_v", c))}
    for i, p in enumerate(params["dec_layers"]):
        h = norm_apply(cfg, p["norm1"], x)
        _, k, v, o = _self_attend(cfg, p["self_attn"], h, pos, tp,
                                  causal=True)
        kc, vc = _cross_kv(cfg, p, enc_out, tp)
        x = _dec_tail(cfg, p, x, o, lambda q_: _cross_prefill(
            cfg, q_, kc, vc, tp), tp)
        for name, t in (("self_k", seq_share(cfg, k, tp)),
                        ("self_v", seq_share(cfg, v, tp)),
                        ("cross_k", frames(kc)), ("cross_v", frames(vc))):
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
    seq = sharding.kv_seq(cfg)
    H, Hkv = sharding.whole_heads(cfg) if seq else (cfg.num_heads,
                                                    cfg.num_kv_heads)
    hd = cfg.head_dim
    w_pos, kv_self = write_pos(cfg, lengths,
                               whole_rows(cfg, cache["self_k"].shape[2]))
    n_cross = cache["cross_k"].shape[2]
    split_cross = seq and n_cross != cfg.encoder_seq
    kv_cross = torch.full((B,), cfg.encoder_seq if split_cross
                          else n_cross, dtype=torch.int32, device=dev)

    def attend(q, K, V, kv_len, lo=None):
        """Heads q over K/V: the rank's heads, or (kv_seq) every head
        over the rank's share of rows ``[lo, ...)`` merged over the ranks
        (``lo`` None: rows whole on every rank); the output what ``wo``
        reads."""
        q = q[:, 0].reshape(B, Hkv, H // Hkv, hd).contiguous()
        if lo is not None:
            o = seq_attention(q, K, V, kv_len, lo, tp, backend)
        else:
            o = ops.decode_attention(q, K.permute(0, 2, 1, 3),
                                     V.permute(0, 2, 1, 3), kv_len,
                                     backend=backend)
        o = o.reshape(B, 1, H * hd)
        if seq:
            o = o.chunk(tp.size, -1)[tp.rank]
        return o.to(x.dtype)

    for i, p in enumerate(params["dec_layers"]):
        K, V = cache["self_k"][i], cache["self_v"][i]
        h = norm_apply(cfg, p["norm1"], x)
        if seq:
            q, k, v = layers.attn_qkv_whole(cfg, p["self_attn"], h,
                                            positions, tp=tp)
            lo = tp.rank * K.shape[1]
            seq_write(K, V, k[:, 0], v[:, 0], w_pos, lo)
        else:
            q, k, v = layers.attn_qkv(cfg, p["self_attn"], h, positions)
            K[w_pos] = k[:, 0].to(K.dtype)
            V[w_pos] = v[:, 0].to(V.dtype)
            lo = None
        o = attend(q, K, V, kv_self, lo)
        x = _dec_tail(cfg, p, x, o, lambda q_: attend(
            q_, cache["cross_k"][i], cache["cross_v"][i], kv_cross,
            tp.rank * n_cross if split_cross else None), tp)
    x = norm_apply(cfg, params["final_norm"], x)
    new_cache = dict(cache)
    new_cache["lengths"] = lengths + 1
    return logits_of(cfg, params, x, tp), new_cache
