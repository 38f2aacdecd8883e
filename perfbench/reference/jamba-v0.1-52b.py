"""Plain reference of jamba-v0.1-52b (AI21 Jamba: a hybrid of Mamba and
attention mixers, sparse expert FFNs on every other layer), float32.

Each layer: ``h = RMSNorm(x)``; ``x = x + Mixer(h)``; ``h = RMSNorm(x)``;
``x = x + FFN(h)``; then a final RMSNorm and logits against the untied
head. The mixer is attention on layers ``i % attn_layer_period ==
attn_layer_offset`` and Mamba on the others; the FFN is the expert layer
on ``i % expert_layer_period == expert_layer_offset`` and a SwiGLU MLP on
the others. Norm gains are stored as ``1 + scale`` (``plain.rmsnorm``).

* Attention: causal grouped-query attention with no positional encoding.
* Mamba, per row: ``in_proj`` splits into ``x`` and ``z``; a causal
  depthwise conv of ``d_conv`` taps with its bias (tap ``d_conv - 1``
  meets the current step), then SiLU; ``x_proj`` gives the time-step
  input (``dt_rank`` wide), ``B`` and ``C`` (``d_state`` each), each
  RMS-normed at unit gain; ``dt = softplus(dt_proj(.) + b)``, ``A =
  -exp(A_log)``; the recurrence ``h_t = exp(dt_t A) h_(t-1) + dt_t x_t
  B_t`` from ``h_0 = 0``, run step by step; ``y_t = h_t C_t + D x_t``;
  ``out_proj(y * SiLU(z))``.
* Experts: the softmax of the router's logits over all the experts, the
  top ``num_experts_per_tok`` of it as the gates (not renormalised), and
  every route computed: each expert's SwiGLU over the tokens routed to
  it, its weights cast to float32 one expert at a time.

Every product goes through ``plain.Prec``, so the control's precision
covers the Mamba, router and expert products too. Rows are independent:
a row's padding at its end is never read back (causal attention, the
recurrence runs forward, the experts act token by token).

Departures from the published model, which the program shares: 16 of its
32 layers (the configuration's cut in depth); the three inner RMSNorms at
gain 1, their initial value, since the benchmark's weights carry no gains
for them; the weights stored in bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import plain

# time steps of the recurrence whose decay and input are formed at once
STEP_BLOCK = 256


def _unit_rmsnorm(t, eps):
    return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps)


def _conv(x, w, b):
    """Causal depthwise conv over time: x ``(B, T, C)``, taps w ``(K,
    C)``; ``y_t = b + sum_i w[i] x_(t - K + 1 + i)``, zeros before the
    start."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = b.float().expand_as(x).clone()
    for i in range(K):
        y = y + xp[:, i:i + T] * w[i].float()
    return y


def _mamba(m, p, h, prec, eps):
    di = int(m["mamba_expand"]) * int(m["hidden_size"])
    ds = int(m["mamba_d_state"])
    dtr = int(m["mamba_dt_rank"])
    x, z = torch.split(prec.mm(h, p["in_proj"]), [di, di], dim=-1)
    x = F.silu(_conv(x, p["conv_w"], p["conv_b"]))
    dt_in, Bm, Cm = torch.split(prec.mm(x, p["x_proj"]), [dtr, ds, ds],
                                dim=-1)
    dt_in, Bm, Cm = (_unit_rmsnorm(t, eps) for t in (dt_in, Bm, Cm))
    dt = F.softplus(prec.mm(dt_in, p["dt_proj"]) + p["dt_proj_b"].float())
    A = -torch.exp(p["A_log"].float())                       # (di, ds)
    B_, T = h.shape[:2]
    state = torch.zeros(B_, di, ds, dtype=torch.float32, device=h.device)
    y = torch.empty(B_, T, di, dtype=torch.float32, device=h.device)
    for t0 in range(0, T, STEP_BLOCK):
        t1 = min(t0 + STEP_BLOCK, T)
        decay = torch.exp(dt[:, t0:t1, :, None] * A)     # (B, L, di, ds)
        inp = (dt[:, t0:t1] * x[:, t0:t1])[..., None] \
            * Bm[:, t0:t1, None, :]
        for j in range(t1 - t0):
            state = decay[:, j] * state + inp[:, j]
            y[:, t0 + j] = (state * Cm[:, t0 + j, None, :]).sum(-1)
        del decay, inp
    y = (y + p["D"].float() * x) * F.silu(z)
    return prec.mm(y, p["out_proj"])


def _attention(m, a, h, prec):
    B, T = h.shape[:2]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["hidden_size"] // H
    q = prec.mm(h, a["wq"]).view(B, T, H, hd)
    k = prec.mm(h, a["wk"]).view(B, T, Hkv, hd)
    v = prec.mm(h, a["wv"]).view(B, T, Hkv, hd)
    o = plain.causal_attention(q, k, v).reshape(B, T, H * hd)
    return prec.mm(o, a["wo"])


def _experts(m, p, h, prec):
    """Every route of every token: top-k of the softmax over the experts,
    the gates as they come."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    gates, idx = torch.topk(probs, int(m["num_experts_per_tok"]), dim=-1)
    out = torch.zeros_like(x)
    for e in range(int(m["num_experts"])):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            ye = plain.gated_mlp(x[tok], p["wi"][e], p["wo"][e], prec)
            out.index_add_(0, tok, ye * gates[tok, choice, None])
    return out.view(shape)


def logits_many(m: dict, params: dict, items, *, fp8: bool = False):
    """f32 logits of several independent sequences in one batched forward:
    ``items`` are ``(tokens, prompt_len, n_read)``; for each, the logits
    ``(n_read, V)`` at positions ``prompt_len - 1 .. prompt_len - 2 +
    n_read``, each predicting the token after it. Rows are padded at
    their ends, which no position before the padding reads back."""
    prec = plain.Prec(fp8)
    eps = float(m["rms_norm_eps"])
    attn_p, attn_o = m["attn_layer_period"], m["attn_layer_offset"]
    moe_p, moe_o = m["expert_layer_period"], m["expert_layer_offset"]
    dev = params["embed"].device
    T = max(len(s) for s, _, _ in items)
    tok = torch.zeros(len(items), T, dtype=torch.long, device=dev)
    for i, (s, _, _) in enumerate(items):
        tok[i, :len(s)] = torch.as_tensor(s, dtype=torch.long, device=dev)
    with plain.exact(), torch.no_grad():
        x = params["embed"][tok].float()
        for i, p in enumerate(params["layers"]):
            h = plain.rmsnorm(x, p["norm1"], eps)
            if i % attn_p == attn_o:
                x = x + _attention(m, p["attn"], h, prec)
            else:
                x = x + _mamba(m, p["mamba"], h, prec, eps)
            h = plain.rmsnorm(x, p["norm2"], eps)
            if i % moe_p == moe_o:
                x = x + _experts(m, p["moe"], h, prec)
            else:
                x = x + plain.gated_mlp(h, p["mlp"]["wi"], p["mlp"]["wo"],
                                        prec)
            del h
        rows = torch.cat([x[i, n - 1:n - 1 + k]
                          for i, (_, n, k) in enumerate(items)])
        hN = plain.rmsnorm(rows, params["final_norm"], eps)
        out = plain.unembed(hN, params["unembed"], False, prec)
        return list(torch.split(out, [k for _, _, k in items]))
