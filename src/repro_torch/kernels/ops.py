"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a
CUDA tensor goes to the hand-written kernel, which launches or raises.
There is no fallback: a failed build or launch is an error, never a
silent switch to the plain version. ``backend=`` is accepted for
signature parity with ``repro.kernels.ops`` and selects nothing: on a
CUDA tensor the kernel always runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kv_quant as _kq
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn

# name -> wrapper carrying the ``.launches`` count
KERNELS = {
    "kv_quant": _kq.kv_quant,
    "kv_dequant": _kq.kv_dequant,
    "kv_quant_append": _kq.kv_quant_append,
    "paged_decode_attention_int4": _pa.paged_decode_attention_int4,
    "paged_decode_attention_bf16": _pa.paged_decode_attention_bf16,
    "flash_attention": _fa.flash_attention,
    "decode_attention": _da.decode_attention,
    "rmsnorm": _rn.rmsnorm,
    "add_rmsnorm": _rn.add_rmsnorm,
}


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def kv_quant(x, *, backend: str = "auto"):
    if _on_cpu(x):
        return _ref.kv_quant_ref(x)
    return _kq.kv_quant(x)


def kv_dequant(packed, scale, zero, *, out_dtype=torch.bfloat16,
               backend: str = "auto"):
    if _on_cpu(packed):
        return _ref.kv_dequant_ref(packed, scale, zero, dtype=out_dtype)
    return _kq.kv_dequant(packed, scale, zero, out_dtype=out_dtype)


def kv_quant_append(k, v, kpages, vpages, page_table, lengths, *,
                    page_size, backend: str = "auto"):
    """The paged decode step's append to int4 pages, in place: this step's
    k/v (B, 1, Hkv, hd) quantized as ``kv_quant`` and written into each
    slot's tail page (one launch on the card; ``ref.kv_quant_append_ref``
    on the CPU)."""
    if _on_cpu(k):
        return _ref.kv_quant_append_ref(k, v, kpages, vpages, page_table,
                                        lengths, page_size=page_size)
    return _kq.kv_quant_append(k, v, kpages, vpages, page_table, lengths,
                               page_size=page_size)


def decode_attention(q, k, v, kv_len, *, backend: str = "auto"):
    """Dense flash-decode: q (B, Hkv, g, hd), k/v (B, Hkv, S, hd) read in
    place through their strides (never copied), keys at or past
    ``kv_len (B,)`` masked."""
    if _on_cpu(q):
        return _ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    return _da.decode_attention(q, k, v, kv_len.to(torch.int32))


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, *,
                           page_size, backend: str = "auto"):
    """Decode attention over pages reached through ``page_table``. The
    residency picks the kernel: int4 triples go to the kernel that
    dequantizes in its loop, bf16 page tensors to the bf16 body."""
    if _on_cpu(q):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               page_table, kv_len,
                                               page_size=page_size)
    if isinstance(k_pages, torch.Tensor):
        return _pa.paged_decode_attention_bf16(q, k_pages, v_pages,
                                               page_table, kv_len,
                                               page_size=page_size)
    return _pa.paged_decode_attention_int4(q, k_pages, v_pages, page_table,
                                           kv_len, page_size=page_size)


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=None,
                    backend: str = "auto"):
    """Prefill attention, (B, S, H, hd) layout; see
    ``ref.flash_attention_ref`` for the mask (``prefix_len`` selects the
    suffix mask of partial-hit and chunked prefill)."""
    window = int(window or 0)
    if _on_cpu(q):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, prefix_len=prefix_len)
    if prefix_len is not None:
        prefix_len = prefix_len.to(torch.int32).contiguous()
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               prefix_len=prefix_len)


def rmsnorm(x, scale, *, eps: float = 1e-6, backend: str = "auto"):
    """RMSNorm over the last axis with a ``(1 + scale)`` gain."""
    if _on_cpu(x):
        return _ref.rmsnorm_ref(x, scale, eps=eps)
    return _rn.rmsnorm(x.contiguous(),
                       scale.to(torch.float32).contiguous(), eps=eps)


def add_rmsnorm(x, r, scale, *, eps: float = 1e-6, backend: str = "auto"):
    """The residual add fused with the norm after it: returns ``(h, y)``,
    ``h = x + r`` in ``x.dtype`` and ``y = rmsnorm(h, scale)``."""
    if _on_cpu(x):
        return _ref.add_rmsnorm_ref(x, r, scale, eps=eps)
    return _rn.add_rmsnorm(x.contiguous(), r.contiguous(),
                           scale.to(torch.float32).contiguous(), eps=eps)
