"""Dense transformer layers (the dense parts of ``repro.models.layers``).

Plain functions on tensors; a layer's parameters are a dict of tensors
with weights stored ``(d_in, d_out)`` as in the JAX package, so ``x @ w``
reads the same in both. Attention scores and softmax are computed in f32,
matching the reference's ``preferred_element_type=jnp.float32`` einsums.
Prefill attention stays this plain PyTorch code (no fused library
attention); a hand-written flash-attention kernel replaces it later.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, rotary_pct: float, theta: float, device):
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def apply_rope(x, positions, *, rotary_pct: float = 1.0,
               theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S). Rotates the two HALVES of
    the rotary dims (not interleaved pairs), like the reference."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    inv, rot_dim = rope_freqs(hd, rotary_pct, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv             # (..., S, rot/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., :rot_dim // 2], xr[..., rot_dim // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot_dim < hd else out


def dense(w, x, b=None):
    y = x @ w
    return y if b is None else y + b


def mlp_apply(cfg, p, x):
    """SwiGLU / GeGLU / GELU MLP; ``wi``'s output splits as (gate, up)."""
    h = dense(p["wi"], x)
    if cfg.mlp_type in ("silu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        act = F.silu(g) if cfg.mlp_type == "silu" else \
            F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(p["wo"], h)


def _mask_bias(qpos, kpos, *, causal, window, kv_len):
    """(B, Sq, Sk) additive f32 bias from causal / window / length masks."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    ok = torch.ones(qp.shape[:-1] + kp.shape[-1:], dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window and window > 0:
        ok = ok & (kp > qp - window)
    if kv_len is not None:
        ok = ok & (kp < kv_len[..., None, None])
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, NEG_INF)


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=None,
                  kv_len=None):
    """Materialized-score attention. q: (B,Sq,H,hd); k/v: (B,Sk,Hk,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qh = q.reshape(B, Sq, Hk, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) \
        / math.sqrt(hd)
    ar_q = torch.arange(Sq, device=q.device)
    qpos = (ar_q.expand(B, Sq) if q_offset is None
            else q_offset[:, None] + ar_q[None, :])
    kpos = torch.arange(Sk, device=q.device).expand(B, Sk)
    bias = _mask_bias(qpos, kpos, causal=causal, window=window,
                      kv_len=kv_len)
    s = s + bias[:, None, None]
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, q_offset=None,
              kv_len=None, chunk_q=512, chunk_kv=1024):
    """Blocked attention with an online softmax over KV chunks, so no
    (Sq, Sk) score tensor materializes for long prompts; small problems
    take :func:`attention_ref`, exactly as the reference does."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    if Sq * Sk <= 256 * 256:
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    cq, ck = min(chunk_q, Sq), min(chunk_kv, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * cq - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * ck - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * ck - Sk))
    dev = q.device
    eff_len = (torch.full((B,), Sk, dtype=torch.int32, device=dev)
               if kv_len is None else kv_len.to(torch.int32))
    qoff = (torch.zeros((B,), dtype=torch.int32, device=dev)
            if q_offset is None else q_offset)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        blk = qp[:, qi * cq:(qi + 1) * cq].reshape(B, cq, Hk, g, hd).float()
        qpos = qoff[:, None] + qi * cq + torch.arange(cq, device=dev)[None]
        m = torch.full((B, Hk, g, cq), NEG_INF, device=dev)
        l = torch.zeros((B, Hk, g, cq), device=dev)
        acc = torch.zeros((B, Hk, g, cq, hd), device=dev)
        for ki in range(nk):
            kblk = kp[:, ki * ck:(ki + 1) * ck]
            vblk = vp[:, ki * ck:(ki + 1) * ck]
            kpos = (ki * ck + torch.arange(ck, device=dev)).expand(B, ck)
            s = torch.einsum("bqhgd,bkhd->bhgqk", blk, kblk.float()) * scale
            s = s + _mask_bias(qpos, kpos, causal=causal, window=window,
                               kv_len=eff_len)[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B,cq,Hk,g,hd)
    o = torch.cat(outs, dim=1).reshape(B, nq * cq, H, hd)
    return o[:, :Sq]


def attn_qkv(cfg, p, x, positions):
    """Projections + RoPE. x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct,
                   theta=cfg.rope_theta)
    return q, k, v
