"""Mamba, the selective SSM of the jamba hybrid (the port of
``repro.models.mamba``).

Prefill runs the diagonal recurrence ``h_t = dA_t * h_(t-1) + dBx_t``
over chunks of at most 512 steps, the last one holding only the steps
left: the state handed on is the one after the prompt's last step (the
JAX package pads the last chunk and keeps the state after the padding,
whose steps decay it; ROADMAP C.4). PyTorch has no ``associative_scan``:
each chunk is a doubling (Hillis-Steele) scan in f32, log2(c + 1) rounds
over the ``(B, c + 1, d_inner, d_state)`` pairs, with the carried state
as an extra first step whose ``dA`` is 1 (the reference's form). It adds
in another order than ``lax.associative_scan``, so the two agree to f32
rounding. The scan is plain PyTorch because the reference's is jnp, not
a Pallas kernel. Decode is one step of the recurrence over the carried
``(conv_state, ssm_state)``. Autograd refuses the in-place scan (each
round overwrites what the last one saved for backward): the training
forward passes ``scan=doubling_scan_out``, the same rounds out of place,
which gives the in-place scan's values bit for bit.

With ``cfg.mamba_inner_norms`` (the published Jamba mixer) the
time-step input, B and C are each RMS-normed at unit gain straight after
``x_proj``, before ``dt_proj``, the softplus and the products; no
parameter is added.

Parameters, one dict a layer: ``in_proj (d, 2 di)``, ``conv_w (d_conv,
di)`` and ``conv_b (di,)`` bf16, ``x_proj (di, dt_rank + 2 d_state)``,
``dt_proj (dt_rank, di)`` bf16 and its f32 bias ``dt_proj_b (di,)``,
``A_log (di, d_state)`` and ``D (di,)`` f32, ``out_proj (di, d)``.

Under tensor parallelism (``tp``, the model axis's ``comm.Group``; the
config a rank's, ``sharding.local_cfg``, whose ``mamba_d_inner`` is the
rank's ``di / n`` channels) a rank holds its channels of ``in_proj``
(of x and of z each), the conv, ``dt_proj``, ``A_log`` and ``D``, and its
rows of ``x_proj``, whose ``(dt_rank + 2 d_state)`` output is then a sum
of partial products, all-reduced (the inner norms act on that whole,
reduced output). ``x_proj``'s product is kept in f32
(:func:`~repro_torch.models.layers.f32_product`: on the card the bf16
GEMM written in f32, the weight never cast), its partials summed in f32,
where the reference rounds it to the stream's type before its f32 cast
(ROADMAP C.4): the inner norms carry a bf16 rounding of it,
which a TP rank's sum and one card's product make apart, into every
step's decay. The scan and its states run on the rank's channels; ``y``
is gathered before the whole ``out_proj`` (the reference's spec leaves
it whole), so every rank computes the layer's whole output.

Under autograd (the sharded training step) ``h`` enters ``in_proj``
through ``comm.copy_to_model``, the reduced ``x_proj`` output feeds the
rank's own channels and so is summed in backward too (``comm.sum_over``
semantics: ``copy_to_model`` after the reduce), and the gathered ``y``
gives each rank its channels' slice of the gradient; ``out_proj``, whole
and computed alike on every rank, takes no collective.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import comm
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.models.layers import causal_conv1d, dense, f32_product

CHUNK = 512            # steps a prefill chunk scans at once


def unit_rmsnorm(t):
    """RMSNorm at gain 1 (the inner norms' initial gain, which the port's
    parameter tree does not carry), eps 1e-6: Jamba's ``rms_norm_eps``."""
    return rmsnorm_ref(t, t.new_zeros(()))


def _selective_terms(cfg, p, xc, tp=None):
    """dA, dBx (B, S, di, ds) f32 and C (B, S, ds) f32 of the conv's
    output xc (B, S, di)."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    proj = comm.sum_over(tp, f32_product(xc, p["x_proj"]))
    dt_r, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    if cfg.mamba_inner_norms:
        dt_r, Bm, Cm = unit_rmsnorm(dt_r), unit_rmsnorm(Bm), unit_rmsnorm(Cm)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_proj_b"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bm[..., None, :]
    return dA, dBx, Cm


def _front(cfg, p, x, conv_state, tp=None):
    """in_proj, the conv and its SiLU: (xc, z, conv_state)."""
    x_, z = torch.chunk(dense(p["in_proj"], comm.copy_to_model(tp, x)), 2,
                        dim=-1)
    xc, conv_state = causal_conv1d(x_, p["conv_w"], p["conv_b"], conv_state)
    return F.silu(xc.float()).to(x.dtype), z, conv_state


def _back(p, y, xc, z, dtype, tp=None):
    y = y + p["D"] * xc.float()
    y = (y * F.silu(z.float())).to(dtype)
    if tp is not None:
        y = comm.gather_from_model(tp, y, -1)
    return dense(p["out_proj"], y)


def doubling_scan(a, b):
    """Inclusive scan of the pairs (a, b) along dim 1 under
    ``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)``, in place in ``b``
    (``a`` is overwritten too): after round r, step t holds the
    composition of steps t - 2^r + 1 .. t. Returns ``b``, whose step t is
    ``h_t``."""
    n, d = a.shape[1], 1
    while d < n:
        t = a[:, d:] * b[:, :-d]
        t += b[:, d:]
        b[:, d:] = t
        del t
        if 2 * d < n:
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def doubling_scan_out(a, b):
    """:func:`doubling_scan` out of place, for autograd: each round builds
    new ``a`` and ``b`` from the same products and sums in the same
    order, so the values are the in-place scan's bit for bit."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < n:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def mamba_apply(cfg, p, x, *, chunk: int = CHUNK, state=None,
                scan=doubling_scan, tp=None):
    """The full-sequence path over x (B, S, d); ``state`` an optional
    carried (conv_state, ssm_state). ``scan`` runs each chunk's
    recurrence (:func:`doubling_scan`, or :func:`doubling_scan_out` under
    autograd); the last chunk holds the ``S - (n - 1) c`` steps left, so
    the state returned is the one after step S. Returns (out, new state);
    under ``tp`` the state is the rank's channels'."""
    B, S, _ = x.shape
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    conv_state = state[0] if state is not None else None
    h = (state[1] if state is not None else
         torch.zeros((B, di, ds), dtype=torch.float32, device=x.device))
    xc, z, conv_state = _front(cfg, p, x, conv_state, tp)
    c = min(chunk, S)
    ys = []
    for lo in range(0, S, c):
        dA, dBx, Cm = _selective_terms(cfg, p, xc[:, lo:lo + c], tp)
        # the carried state enters as an extra first step with dA = 1
        a = torch.cat([torch.ones_like(dA[:, :1]), dA], dim=1)
        del dA
        b = torch.cat([h[:, None], dBx], dim=1)
        del dBx
        hs = scan(a, b)
        del a
        h = hs[:, -1].clone()
        ys.append(torch.einsum("bcns,bcs->bcn", hs[:, 1:], Cm))
        del hs, b
    y = torch.cat(ys, dim=1)
    return _back(p, y, xc, z, x.dtype, tp), (conv_state, h)


def mamba_decode_step(cfg, p, x, state, tp=None):
    """One token, x (B, 1, d); state (conv_state, ssm_state)."""
    conv_state, h = state
    xc, z, conv_state = _front(cfg, p, x, conv_state, tp)
    dA, dBx, Cm = _selective_terms(cfg, p, xc, tp)    # (B, 1, di, ds)
    h = dA[:, 0] * h + dBx[:, 0]
    y = torch.einsum("bns,bs->bn", h, Cm[:, 0])[:, None]
    return _back(p, y, xc, z, x.dtype, tp), (conv_state, h)


def mamba_state_init(cfg, batch: int, dtype=torch.bfloat16, device="cuda"):
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return (torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device))
