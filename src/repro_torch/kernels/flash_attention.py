"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``; it replaces ``repro/kernels/flash_attention.py``).

CUDA tensors only (``kernels/ops.py`` sends CPU tensors to
``ref.flash_attention_ref``); the launch count is
``flash_attention.launches``. q/k/v are read in the model's
``(B, S, H, hd)`` layout, so no transposed copy is made. The dtype picks
the kernel's body: bf16 runs on the tensor cores (16-byte asynchronous
copies, so q/k/v must be 16-byte aligned), f32 on FMAs. A logit
``softcap`` > 0 runs each body's capped instantiation (``s = c tanh(s /
c)`` after the scale, before the mask); 0 the uncapped one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_quant import _require_cuda, no_grad_inputs

HEAD_DIMS = (16, 32, 64, 80, 120, 128, 256)   # the instantiations


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=None,
                    softcap=0.0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd) in q's dtype (bf16/f32);
    ``prefix_len``: None or (B,) int32 (then P = Sk - Sq is the padded
    prefix width and the mask is the suffix mask, causal, no window).
    Returns (B, Sq, H, hd) in ``q.dtype``."""
    no_grad_inputs("flash_attention", q, k, v)
    _require_cuda("flash_attention", q=q, k=k, v=v)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    P = 0
    if prefix_len is not None:
        _require_cuda("flash_attention", prefix_len=prefix_len)
        P = Sk - Sq
    ok = (q.dtype in (torch.bfloat16, torch.float32)
          and k.dtype == v.dtype == q.dtype
          and k.dim() == 4 and tuple(k.shape[::3]) == (B, hd)
          and tuple(v.shape) == tuple(k.shape)
          and Hkv > 0 and H % Hkv == 0 and hd in HEAD_DIMS
          and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
          and window >= 0 and softcap >= 0
          and (prefix_len is None
               or (prefix_len.dtype == torch.int32
                   and tuple(prefix_len.shape) == (B,) and P >= 0
                   and causal and window == 0)))
    if not ok:
        raise ValueError(
            f"flash_attention: bad operands q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}, "
            f"causal={causal} window={window} softcap={softcap}, prefix_len "
            f"{None if prefix_len is None else tuple(prefix_len.shape)}; "
            f"head_dim must be one of {HEAD_DIMS}, q/k/v 16-byte aligned")
    out = torch.empty_like(q)
    status = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if prefix_len is None else prefix_len.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), B, Sq, Sk, H, Hkv,
        hd, P, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
