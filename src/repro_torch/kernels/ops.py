"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a
CUDA tensor goes to the hand-written kernel, which launches or raises.
There is no fallback: a failed build or launch is an error, never a
silent switch to the plain version. ``backend=`` is accepted for
signature parity with ``repro.kernels.ops`` and selects nothing: on a
CUDA tensor the kernel always runs.

A ``meta`` tensor (the dry-run, ``launch/dryrun.py``) runs nothing: the
call returns empty meta outputs of the kernel's shapes and types and
tells the active counter (``roofline/op_cost.py``, pushed on
:data:`COUNTERS`) the kernel's name and its cost (``kernels/cost.py``).
Outside a counter a meta call raises. On the CPU and the card an active
counter is told of the call too: on the card with its cost (a kernel is
no aten op the counter could see), on the CPU without (the plain
version's aten ops are what the counter counts there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost as _cost
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
    "decode_attention_lse": _da.decode_attention_lse,
    "rmsnorm": _rn.rmsnorm,
    "add_rmsnorm": _rn.add_rmsnorm,
}


# the active op counters (roofline/op_cost.py), innermost last
COUNTERS: list = []


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def cta_counts():
    """The CTAs launched so far, by the wrappers that count them."""
    return {name: fn.ctas for name, fn in KERNELS.items()
            if hasattr(fn, "ctas")}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _meta(name: str, lead: torch.Tensor, args, data, outputs):
    """Tell the active counter of one call of kernel ``name`` on ``args``
    (cost data ``data``). On meta returns ``outputs()`` (empty meta
    tensors of the kernel's results) and never runs the plain version;
    raises there when no counter is active. Returns None elsewhere: the
    caller runs the plain version (CPU) or the kernel (CUDA)."""
    on_meta = lead.device.type == "meta"
    if not COUNTERS:
        if on_meta:
            raise RuntimeError(
                f"ops.{name} on meta tensors outside an op counter: a meta "
                f"call runs nothing and must be counted "
                f"(roofline.op_cost.OpCounter)")
        return None
    counted = lead.device.type != "cpu"
    COUNTERS[-1].kernel(name, _cost.of(name, *args, **data) if counted
                        else None)
    return outputs() if on_meta else None


def _empty(like: torch.Tensor, shape=None, dtype=None):
    return torch.empty(like.shape if shape is None else shape,
                       dtype=dtype or like.dtype, device=like.device)


def kv_quant(x, *, backend: str = "auto"):
    N, G = x.shape
    got = _meta("kv_quant", x, (x,), {}, lambda: (
        _empty(x, (N, G // 2), torch.uint8), _empty(x, (N, 1), torch.float32),
        _empty(x, (N, 1), torch.float32)))
    if got is not None:
        return got
    if _on_cpu(x):
        return _ref.kv_quant_ref(x)
    return _kq.kv_quant(x)


def kv_dequant(packed, scale, zero, *, out_dtype=torch.bfloat16,
               backend: str = "auto"):
    got = _meta("kv_dequant", packed, (packed, scale, zero),
                {"out_dtype": out_dtype}, lambda: _empty(
                    packed, (packed.shape[0], 2 * packed.shape[1]),
                    out_dtype))
    if got is not None:
        return got
    if _on_cpu(packed):
        return _ref.kv_dequant_ref(packed, scale, zero, dtype=out_dtype)
    return _kq.kv_dequant(packed, scale, zero, out_dtype=out_dtype)


def kv_quant_append(k, v, kpages, vpages, page_table, lengths, *,
                    page_size, backend: str = "auto"):
    """The paged decode step's append to int4 pages, in place: this step's
    k/v (B, 1, Hkv, hd) quantized as ``kv_quant`` and written into each
    slot's tail page (one launch on the card; ``ref.kv_quant_append_ref``
    on the CPU)."""
    if _meta("kv_quant_append", k, (k, v, kpages, vpages, page_table,
                                     lengths), {}, lambda: True):
        return None
    if _on_cpu(k):
        return _ref.kv_quant_append_ref(k, v, kpages, vpages, page_table,
                                        lengths, page_size=page_size)
    return _kq.kv_quant_append(k, v, kpages, vpages, page_table, lengths,
                               page_size=page_size)


def decode_attention(q, k, v, kv_len, *, return_lse=False, softcap=0.0,
                     backend: str = "auto"):
    """Dense flash-decode: q (B, Hkv, g, hd), k/v (B, Hkv, S, hd) read in
    place through their strides (never copied), keys at or past
    ``kv_len (B,)`` masked. ``return_lse``: the partial mode, ``(o f32,
    lse (B, Hkv, g) f32)`` over this call's keys (-inf and 0 for a row
    with ``kv_len`` 0), for ``comm.merge_partials``. ``softcap`` > 0: the
    scores capped, ``c tanh(s / c)``, before the mask."""
    B, Hkv, g = q.shape[:3]
    softcap = float(softcap or 0.0)
    name = "decode_attention_lse" if return_lse else "decode_attention"
    got = _meta(name, q, (q, k, v, kv_len), {"softcap": softcap},
                lambda: (_empty(q, dtype=torch.float32),
                         _empty(q, (B, Hkv, g), torch.float32))
                if return_lse else _empty(q))
    if got is not None:
        return got
    if _on_cpu(q):
        # in the order of a (B, S, Hkv, hd) cache's storage (a no-op for
        # the s_hkv cache's view), so the plain version's sums, like the
        # kernel's, do not depend on the layout: hkv_s equals s_hkv
        k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                for t in (k, v))
        return _ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                         return_lse=return_lse,
                                         softcap=softcap)
    fn = _da.decode_attention_lse if return_lse else _da.decode_attention
    return fn(q, k, v, kv_len.to(torch.int32), softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, *,
                           page_size, backend: str = "auto"):
    """Decode attention over pages reached through ``page_table``. The
    residency picks the kernel: int4 triples go to the kernel that
    dequantizes in its loop, bf16 page tensors to the bf16 body."""
    name = "paged_decode_attention_" + (
        "bf16" if isinstance(k_pages, torch.Tensor) else "int4")
    got = _meta(name, q, (q, k_pages, v_pages, page_table, kv_len),
                {"page_size": page_size}, lambda: _empty(q))
    if got is not None:
        return got
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
                    softcap=0.0, backend: str = "auto"):
    """Prefill attention, (B, S, H, hd) layout; see
    ``ref.flash_attention_ref`` for the mask (``prefix_len`` selects the
    suffix mask of partial-hit and chunked prefill) and the logit
    ``softcap``."""
    window = int(window or 0)
    softcap = float(softcap or 0.0)
    got = _meta("flash_attention", q, (q, k, v), {
        "causal": causal, "window": window, "softcap": softcap,
        "prefix_len": None if prefix_len is None else "unknown"},
        lambda: _empty(q))
    if got is not None:
        return got
    if _on_cpu(q):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, prefix_len=prefix_len,
                                        softcap=softcap)
    if prefix_len is not None:
        prefix_len = prefix_len.to(torch.int32).contiguous()
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               prefix_len=prefix_len, softcap=softcap)


def rmsnorm(x, scale, *, eps: float = 1e-6, backend: str = "auto"):
    """RMSNorm over the last axis with a ``(1 + scale)`` gain."""
    got = _meta("rmsnorm", x, (x, scale), {}, lambda: _empty(x))
    if got is not None:
        return got
    if _on_cpu(x):
        return _ref.rmsnorm_ref(x, scale, eps=eps)
    return _rn.rmsnorm(x.contiguous(),
                       scale.to(torch.float32).contiguous(), eps=eps)


def add_rmsnorm(x, r, scale, *, eps: float = 1e-6, backend: str = "auto"):
    """The residual add fused with the norm after it: returns ``(h, y)``,
    ``h = x + r`` in ``x.dtype`` and ``y = rmsnorm(h, scale)``."""
    got = _meta("add_rmsnorm", x, (x, r, scale), {},
                lambda: (_empty(x), _empty(x)))
    if got is not None:
        return got
    if _on_cpu(x):
        return _ref.add_rmsnorm_ref(x, r, scale, eps=eps)
    return _rn.add_rmsnorm(x.contiguous(), r.contiguous(),
                           scale.to(torch.float32).contiguous(), eps=eps)
