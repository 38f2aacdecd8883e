"""xLSTM blocks (the port of ``repro.models.xlstm``): mLSTM, a matrix
memory prefilled chunkwise in parallel, and sLSTM, a scalar memory with
an exact sequential recurrence.

mLSTM is linear-recurrent with exponential gating: prefill runs each
chunk of ``cfg.xlstm_chunk`` steps as gated attention within the chunk
plus the carried matrix state, in the log-space of a running maximum
``m``; decode carries ``(C, n, m)`` per head. sLSTM feeds ``h`` back
through its recurrent weights, so its prefill is a loop over time (the
reference's ``lax.scan``). Every state is f32, as the reference keeps
it; ``m`` starts at -1e30 and the intra-chunk mask is -inf.

Parameters, one dict a layer (a bias beside its weight as ``w_b``, see
``models/layers.py``):

    mLSTM {"w_up": (d, 4d), "conv_w": (4, 2d) bf16, "conv_b": (2d,) bf16,
           "wq", "wk", "wv": (2d, 2d), "w_if": (2d, 2H), "w_if_b": (2H,),
           "skip": (2d,) f32, "gn": (2d,) f32, "w_down": (2d, d)}
    sLSTM {"w_in": (d, 4d), "w_in_b": (4d,), "r": (4, H, dh, dh) f32,
           "gn": (d,) f32, "ffn_wi": (d, f), "ffn_wo": (f / 2, d)}

``gn`` is an RMSNorm scale; the norm runs through ``ops.rmsnorm`` (the
kernel on the card) over rows of ``2 d`` (mLSTM) and ``d`` (sLSTM), or,
in the training forward (``kernels=layers.PLAIN``), through its plain
version. Both blocks differentiate as they stand: nothing here writes in
place, and the sLSTM stays a Python loop over time under autograd.

Under tensor parallelism (``tp``, the model axis's ``comm.Group``; the
config a rank's, ``sharding.local_cfg``: its heads, its widths from
:func:`mlstm_dims` and :func:`slstm_dims`) each block runs on the rank's
heads. The mLSTM's ``w_up`` holds the rank's channels of x and of z and
the conv runs on them; ``xc`` and ``xm`` are gathered (one all-gather,
``comm.gather_cols``) for ``wq``/``wk``/``wv``, which hold the rank's
heads' columns, and for the whole ``w_if``, whose gates the rank slices
to its heads; ``gn`` normalizes over the whole inner width, so each
rank's mean square is all-reduced (``layers.rmsnorm_split``); ``skip`` is the rank's channels
and ``w_down`` row-parallel, all-reduced. The sLSTM's ``w_in`` holds the
rank's heads of each of z, i, f and o (bias too) and the recurrence runs
on the rank's heads of ``r``; ``y`` is gathered (the GeGLU FFN's
column-parallel ``ffn_wi`` needs whole rows anyway), normed whole, and
``ffn_wo`` is row-parallel, all-reduced. The states ``C (H, dh, dh)``,
``n``, ``m`` and the sLSTM's hold the rank's heads, the conv state its
channels.

Where the axis does not split the heads (``sharding.gathered``: xlstm's
4 heads at 8 or 16) each block runs every head on every rank, its states
whole (the reference's cache spec replicates ``C``). The mLSTM gathers
its rank's columns of q, k and v (a cut inside a head) to whole heads
(``comm.gather_cols``), takes every head's gates from the whole
``w_if``, norms the whole ``y`` and keeps its channels for the skip, the
output gate and the row-parallel ``w_down``; the sLSTM gathers its
rank's channels of the four gates' pre-activations and runs the whole
recurrence, so ``y`` is whole without a gather after it. A rank's
gradient of the sLSTM's ``r`` is then whole (every rank computes it
alike), of the mLSTM's ``w_if`` and ``gn`` still partial (each rank's
channels of ``y`` reach its loss).

Under autograd (the sharded training step) the collectives are
``distributed/comm.py``'s differentiable ones: ``x`` enters ``w_up`` and
``w_in`` through ``comm.copy_to_model``, as do the gathered ``xc`` and
``xm`` the mLSTM's head projections read and the normed ``y`` the
sLSTM's ``ffn_wi`` reads; the gathers give each rank its slice of the
gradient back, the split ``gn``'s mean square is summed both ways
(``layers.rmsnorm_split``), and the row-parallel sums pass the gradient
through. A rank's gradient of the whole ``w_if``, ``gn`` (mLSTM) and
``r`` covers only its heads or channels, so it is summed over the axis
after backward (``sharding.sync_grads``); the sLSTM's ``gn``, applied
whole and alike on every rank, is not.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import gathered, split_of
from repro_torch.kernels import ops
from repro_torch.models.layers import (causal_conv1d, proj, rmsnorm_split,
                                       row_proj)


def mlstm_dims(cfg):
    """(inner width 2 d, heads, head width); a rank's share of the
    inner width and its heads under a model axis (gathered: the rank's
    share of the channels, and every head at its whole width)."""
    di = 2 * cfg.d_model // split_of(cfg)
    if gathered(cfg):
        return di, cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
    return di, cfg.num_heads, di // cfg.num_heads


def slstm_dims(cfg):
    """(width d, heads, head width) of the sLSTM's recurrence; a rank's
    share of ``d`` and its heads under a model axis (gathered: the whole
    recurrence on every rank)."""
    d = cfg.d_model if gathered(cfg) else cfg.d_model // split_of(cfg)
    return d, cfg.num_heads, d // cfg.num_heads


def slstm_ffn_width(cfg) -> int:
    """The sLSTM's GeGLU width (gate and up), the reference's ~4/3."""
    return int(cfg.d_model * 4 / 3 / 8) * 8 * 2


# -- mLSTM --------------------------------------------------------------------


def _mlstm_chunk(q, k, v, lf, li, state):
    """One chunk. q, k, v: (B, H, L, dh); lf, li: (B, H, L) log forget
    and input gates; state (C (B, H, dh, dh), n (B, H, dh), m (B, H)).
    Returns (y (B, H, L, dh) f32, new state)."""
    L, dh = q.shape[2], q.shape[3]
    C0, n0, m0 = state
    b = torch.cumsum(lf, dim=-1)                     # cumulative decay
    # score[t, s] = b_t - b_s + li_s (decay s -> t times input), s <= t
    score = b[..., :, None] - b[..., None, :] + li[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    score = torch.where(tri, score, float("-inf"))
    m_intra = score.amax(-1)
    m_t = torch.maximum(m0[..., None] + b, m_intra)
    w = torch.exp(score - m_t[..., None])
    carry = torch.exp(m0[..., None] + b - m_t)
    qs = q.float() / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    aw = w * torch.einsum("bhtd,bhsd->bhts", qs, kf)
    num = (torch.einsum("bhts,bhsd->bhtd", aw, vf)
           + carry[..., None] * torch.einsum("bhde,bhtd->bhte", C0, qs))
    den = aw.sum(-1) + carry * torch.einsum("bhd,bhtd->bht", n0, qs)
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    y = num / den[..., None]
    mL = m_t[..., -1]
    wL = torch.exp(b[..., -1:] - b + li - mL[..., None])
    decay = torch.exp(m0 + b[..., -1] - mL)
    C = (decay[..., None, None] * C0
         + torch.einsum("bhs,bhsd,bhse->bhde", wL, kf, vf))
    n = decay[..., None] * n0 + torch.einsum("bhs,bhsd->bhd", wL, kf)
    return y, (C, n, mL)


def mlstm_cell(q, k, v, lf, li, state, chunk: int):
    """q, k, v: (B, S, H, dh); lf, li: (B, S, H). Chunks of ``chunk``
    steps, the last padded with zeros as the reference pads it (the
    padded steps enter the final state as they do there). Returns
    (y (B, S, H, dh) f32, state)."""
    B, S, H, dh = q.shape
    c = min(chunk, S)
    n = -(-S // c)
    pad = n * c - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lf, li = (F.pad(t, (0, 0, 0, pad)) for t in (lf, li))
    ys = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        y, state = _mlstm_chunk(
            *(t[:, sl].transpose(1, 2) for t in (q, k, v, lf, li)), state)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)[:, :S], state


def mlstm_state_init(cfg, batch: int, device="cuda"):
    _, H, dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, dh, dh), **f32),
            torch.zeros((batch, H, dh), **f32),
            torch.full((batch, H), -1e30, **f32))


def _mlstm_in(cfg, p, x, conv_state, tp=None):
    """The block's front half: up projection, conv, the q/k/v heads and
    the gates. Returns (xc, z, q, k, v, li, lf, conv_state)."""
    B, S, _ = x.shape
    _, H, dh = mlstm_dims(cfg)
    xm, z = torch.chunk(proj(p, "w_up", comm.copy_to_model(tp, x)), 2,
                        dim=-1)
    xc, conv_state = causal_conv1d(xm, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc.float()).to(x.dtype)
    xcw, xmw = (xc, xm) if tp is None else comm.gather_cols(tp, xc, xm)
    q, k, v = (proj(p, "wq", xcw), proj(p, "wk", xcw), proj(p, "wv", xmw))
    if gathered(cfg):               # columns inside a head: whole heads
        q, k, v = comm.gather_cols(tp, q, k, v)
    q, k, v = (t.reshape(B, S, H, dh) for t in (q, k, v))
    li, lfraw = torch.chunk(proj(p, "w_if", xmw).float(), 2, dim=-1)
    if tp is not None and not gathered(cfg):    # the whole w_if: its heads
        li, lfraw = (t[..., tp.rank * H:(tp.rank + 1) * H]
                     for t in (li, lfraw))
    return xc, z, q, k, v, li, F.logsigmoid(lfraw), conv_state


def _mlstm_out(p, y, xc, z, kernels=ops, tp=None):
    """The block's back half: per-block norm, skip, output gate, down
    projection. ``y`` wider than the rank's channels ``xc`` (gathered:
    every head) is normed whole and the rank keeps its channels."""
    c = xc.shape[-1]
    if tp is None:
        y = kernels.rmsnorm(y, p["gn"])
    elif y.shape[-1] != c:          # every head: norm whole, keep its own
        y = kernels.rmsnorm(y, p["gn"])[..., tp.rank * c:(tp.rank + 1) * c]
    else:                           # the whole gn: this rank's channels
        y = rmsnorm_split(y, p["gn"][tp.rank * c:(tp.rank + 1) * c], tp)
    y = y + p["skip"].to(y.dtype) * xc
    y = y * F.silu(z.float()).to(y.dtype)
    return row_proj(p, "w_down", y, tp)


def mlstm_apply(cfg, p, x, *, state=None, conv_state=None, kernels=ops,
                tp=None):
    """The mLSTM block over x (B, S, d). Returns (out, (cell state,
    conv state))."""
    B, S, _ = x.shape
    xc, z, q, k, v, li, lf, conv_state = _mlstm_in(cfg, p, x, conv_state,
                                                   tp)
    if state is None:
        state = mlstm_state_init(cfg, B, x.device)
    y, state = mlstm_cell(q, k, v, lf, li, state, cfg.xlstm_chunk)
    y = y.reshape(B, S, -1).to(x.dtype)
    return _mlstm_out(p, y, xc, z, kernels, tp), (state, conv_state)


def mlstm_decode_step(cfg, p, x, state, conv_state, tp=None):
    """One token, x (B, 1, d): the recurrence itself, no chunking.
    Returns (out, (C, n, m), conv_state)."""
    B = x.shape[0]
    _, H, dh = mlstm_dims(cfg)
    xc, z, q, k, v, li, lf, conv_state = _mlstm_in(cfg, p, x, conv_state,
                                                   tp)
    q = q.reshape(B, H, dh).float() / math.sqrt(dh)
    k, v = k.reshape(B, H, dh).float(), v.reshape(B, H, dh).float()
    li, lf = li[:, 0], lf[:, 0]                        # (B, H)
    C, n, m = state
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)[..., None]
    iw = torch.exp(li - m_new)[..., None]
    C = fw[..., None] * C + iw[..., None] * k[..., None] * v[..., None, :]
    n = fw * n + iw * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, H * dh).to(x.dtype)
    return _mlstm_out(p, y, xc, z, tp=tp), (C, n, m_new), conv_state


# -- sLSTM --------------------------------------------------------------------


def _slstm_step(r, carry, x_pre):
    """carry (c, n, h, m), each (B, H, dh); x_pre (B, 4, H, dh) the
    input pre-activations of z, i, f, o."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,ghde->bghe", h, r)
    za, ia, fa, oa = (x_pre[:, i] + rec[:, i] for i in range(4))
    z = torch.tanh(za)
    o = torch.sigmoid(oa)
    lf = F.logsigmoid(fa)
    m_new = torch.maximum(lf + m, ia)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(ia - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    h = o * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def slstm_state_init(cfg, batch: int, device="cuda"):
    _, H, dh = slstm_dims(cfg)
    shape = (batch, H, dh)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(shape, **f32), torch.zeros(shape, **f32),
            torch.zeros(shape, **f32), torch.full(shape, -1e30, **f32))


def slstm_apply(cfg, p, x, *, state=None, kernels=ops, tp=None):
    """The sLSTM block over x (B, S, d): a loop over time, then the norm
    and the block's gated FFN. Returns (out, state); one step is the
    decode step."""
    B, S, _ = x.shape
    d, H, dh = slstm_dims(cfg)
    whole = gathered(cfg)
    pre = proj(p, "w_in", comm.copy_to_model(tp, x)).float()
    if whole:       # the rank's channels of each gate: every head's
        pre = comm.gather_from_model(tp, pre.unflatten(-1, (4, -1)), -1)
    pre = pre.reshape(B, S, 4, H, dh)
    # the whole r: this rank's heads (gathered: every head)
    r = p["r"] if tp is None or whole else \
        p["r"][:, tp.rank * H:(tp.rank + 1) * H]
    if state is None:
        state = slstm_state_init(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(r, state, pre[:, t])
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    if tp is not None and not whole:
        y = comm.gather_from_model(tp, y, -1)
    y = comm.copy_to_model(tp, kernels.rmsnorm(y, p["gn"]))
    g, u = torch.chunk(proj(p, "ffn_wi", y), 2, dim=-1)
    return row_proj(p, "ffn_wo", F.gelu(g, approximate="tanh") * u,
                    tp), state


def slstm_decode_step(cfg, p, x, state, tp=None):
    return slstm_apply(cfg, p, x, state=state, tp=tp)
