"""Plain float32 building blocks of the configurations' reference models.

Straight PyTorch on float32 tensors, with TF32 off (:func:`exact`): no
kernel, cache or batching of the program's, and nothing imported from it.
Weights arrive in the layout the benchmark made them in (projections
``(d_in, d_out)``) and are cast to float32 one matrix at a time, so the
reference fits beside the weights it shares with the program.

:class:`Prec` is where a product's precision is chosen: exact float32, or
the control's ``fp8`` (the nearest precision below the configurations'
bfloat16: every weight matrix rounded to float8 e4m3 with a scale per
output column, and every activation entering a product rounded to e4m3
with a scale per row, the products then taken in float32).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (f32) rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Prec:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def w(self, w: torch.Tensor) -> torch.Tensor:
        """A weight ``(..., d_in, d_out)`` in float32."""
        w = w.to(torch.float32)
        return fp8_round(w, -2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = fp8_round(x, -1)
        return x @ self.w(w)


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def rmsnorm(x, scale, eps):
    """RMSNorm with the gain stored as ``1 + scale``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, theta: float):
    """Rotary embedding of x ``(B, T, H, hd)`` at positions ``0..T-1``,
    rotating the two halves of the head (the program's convention)."""
    B, T, H, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, heads_at_once: int = 8):
    """Softmax attention, causal, grouped-query: q ``(B, T, H, hd)``, k, v
    ``(B, T, Hkv, hd)``; a few query heads at a time."""
    B, T, H, hd = q.shape
    g = H // k.shape[2]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, heads_at_once):
        hs = slice(h0, min(h0 + heads_at_once, H))
        qh = q[:, :, hs].transpose(1, 2)                       # B h T hd
        kv_idx = torch.arange(hs.start, hs.stop, device=q.device) // g
        kh = k[:, :, kv_idx].transpose(1, 2)
        vh = v[:, :, kv_idx].transpose(1, 2)
        s = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        out[:, :, hs] = (torch.softmax(s, -1) @ vh).transpose(1, 2)
    return out


def gated_mlp(x, wi, wo, prec: Prec):
    """SwiGLU: ``wi``'s output splits as (gate, up)."""
    gate, up = torch.chunk(prec.mm(x, wi), 2, dim=-1)
    return prec.mm(F.silu(gate) * up, wo)


def unembed(h, table, transposed: bool, prec: Prec, scale: float = 1.0,
            rows: int = 32768):
    """Logits of h ``(N, d)`` against a vocabulary table, a block of rows
    at a time: ``(V, d)`` (tied embeddings, ``transposed``) or ``(d, V)``."""
    V = table.shape[0] if transposed else table.shape[1]
    out = torch.empty(h.shape[0], V, dtype=torch.float32, device=h.device)
    for v0 in range(0, V, rows):
        w = table[v0:v0 + rows].T if transposed else table[:, v0:v0 + rows]
        out[:, v0:v0 + rows] = prec.mm(h, w)
    return out * scale
