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

from repro_torch.kernels import kv_quant as _kq
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref

# name -> wrapper carrying the ``.launches`` count
KERNELS = {
    "kv_quant": _kq.kv_quant,
    "kv_dequant": _kq.kv_dequant,
    "paged_decode_attention_int4": _pa.paged_decode_attention_int4,
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


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, *,
                           page_size, backend: str = "auto"):
    """Decode attention over int4 pages reached through ``page_table``;
    dequantization happens inside the kernel."""
    if _on_cpu(q):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               page_table, kv_len,
                                               page_size=page_size)
    return _pa.paged_decode_attention_int4(q, k_pages, v_pages, page_table,
                                           kv_len, page_size=page_size)
