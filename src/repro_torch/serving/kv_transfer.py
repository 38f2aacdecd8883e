"""KV-cache wire format for the prefill -> decode transfer (the port of
``repro.serving.kv_transfer``).

One-shot int4 group-wise quantization on the sender (``ops.kv_quant``),
dequantization (``ops.kv_dequant``) where the receiver needs floats; both
phases compute in 16 bits. A whole prefill batch is quantized in one
kernel launch (``extract_batch``). Payloads stay device tensors end to
end; :meth:`KVWire.materialize` is the single device -> host point, for a
wire that crosses a real network hop.

A cache slot is one of three things, as in the reference: attention K/V
(``{"k", "v"}``, trimmed to the request and int4-compressed); a
recurrent stack's states (any other dict: Mamba's ``conv``/``ssm``,
mLSTM's ``C``/``n``/``m``/``conv``, sLSTM's ``c``/``n``/``h``/``m``),
which ride raw, a copy of the slot's bytes, so an insert followed by an
extract gives them back bit for bit; or whisper's flat tensors
(``self_*``, trimmed to the request and compressed; ``cross_*``, which
span the encoder's frames and ship whole, carrying their own length).
Only positional tensors (``k``, ``v``, whisper's ``x``) are ever
quantized or spliced: the reference's ``compress_wire`` also quantizes
an mLSTM's 4-D ``C`` state, which the port keeps raw.

Under tensor parallelism each rank extracts and inserts its own cache's
shard: its KV heads (or its one replicated KV head, which each rank that
shares it ships again), its recurrent states' channels or heads, raw,
and whisper's flat tensors on its heads. Nothing here knows the mesh:
the shapes carry it, and an int4 group follows the rank's span
(``kv_layout``'s rule: the largest of 128..2 that divides it). Under the
kv_seq decode cache (``sharding.kv_seq``) the wire holds every KV head at
every position: a kv_seq prefill's cache, which holds the rank's share
of them as the decode cache does, is gathered whole first
(:func:`gather_seq`), and each rank inserts its share of the positions
(``insert_batch(seq_part=)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.kv_layout import pick_group


@dataclass
class WireTensor:
    """Either a quantized (packed, scale, zero) or a raw ("x") tensor."""
    kind: str                      # "int4" | "raw"
    payload: Dict[str, torch.Tensor]
    orig_shape: Tuple[int, ...] = ()
    dtype: str = "bfloat16"

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in self.payload.values()))


@dataclass
class KVWire:
    """Per-request transferable cache state."""
    request_len: int
    slots: Dict[str, Dict[str, WireTensor]]

    def nbytes(self) -> int:
        return sum(t.nbytes() for s in self.slots.values()
                   for t in s.values())

    def materialize(self) -> "KVWire":
        """Pull every payload to host memory with ONE device
        synchronization: all copies are queued, then the stream is
        synchronized once."""
        tensors = [t for s in self.slots.values() for t in s.values()]
        on_card = False
        for t in tensors:
            host = {}
            for k, a in t.payload.items():
                on_card |= a.is_cuda
                host[k] = a.to("cpu", non_blocking=True)
            t.payload = host
        if on_card:
            torch.cuda.synchronize()
        return self


# wire keys that index a position (spliced and compressed); the rest are
# recurrent-state snapshots
POSITIONAL = ("k", "v", "x")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _quantize_stacked(xs: Sequence[torch.Tensor], backend: str,
                      group: Optional[int] = None) -> List[WireTensor]:
    """Quantize same-shaped tensors in ONE kernel launch. Groups never
    cross a tensor, so this is bit-identical to quantizing each alone;
    ``group`` forces the (position-aligned) group width."""
    shape = tuple(xs[0].shape)
    n = int(np.prod(shape))
    g = group if group else pick_group(n)
    if n == 0 or g == 0:
        return [WireTensor("raw", {"x": x}, shape, _dtype_name(x))
                for x in xs]
    flat = torch.cat([x.reshape(-1, g) for x in xs], dim=0)
    packed, scale, zero = ops.kv_quant(flat, backend=backend)
    rows_per = n // g
    out = []
    for t, x in enumerate(xs):
        sl = slice(t * rows_per, (t + 1) * rows_per)
        out.append(WireTensor("int4", {"packed": packed[sl],
                                       "scale": scale[sl],
                                       "zero": zero[sl]},
                              shape, _dtype_name(x)))
    return out


def _dequantize(w: WireTensor, backend: str) -> torch.Tensor:
    if w.kind == "raw":
        return w.payload["x"]
    # bf16 whatever the wire's dtype, as the reference dequantizes
    out = ops.kv_dequant(w.payload["packed"].contiguous(),
                         w.payload["scale"].contiguous(),
                         w.payload["zero"].contiguous(), backend=backend)
    return out.reshape(w.orig_shape)


def _extract_one(cache, batch_index: int, length: int, compress: bool,
                 pad_to: Optional[int] = None):
    """Slice one request out of a prefill or decode cache; returns (slots,
    pending quantization jobs). With ``pad_to`` positional tensors are
    sliced to the padded length (uniform shapes -> one launch for the
    batch); the true length rides along for trimming after
    quantization."""
    slots: Dict[str, Dict[str, WireTensor]] = {}
    jobs = []

    def positional(key, t, ln, lp):
        if compress:
            jobs.append((name, key, t[:, batch_index, :lp], ln))
        else:
            x = t[:, batch_index, :ln]                 # (L, len, Hkv, hd)
            out[key] = WireTensor("raw", {"x": x}, tuple(x.shape),
                                  _dtype_name(x))

    for name, slot in cache.items():
        if name == "lengths":
            continue
        out: Dict[str, WireTensor] = {}
        if isinstance(slot, dict) and "k" in slot:        # attention K/V
            s_cache = slot["k"].shape[2]
            ln = min(length, s_cache)
            lp = max(min(pad_to, s_cache) if pad_to else ln, ln)
            for key in ("k", "v"):
                positional(key, slot[key], ln, lp)
        elif isinstance(slot, dict):                       # recurrent
            for key, arr in slot.items():
                st = arr[:, batch_index].clone()
                out[key] = WireTensor("raw", {"x": st}, tuple(st.shape),
                                      _dtype_name(st))
        else:       # whisper: self_* per token, cross_* the whole encoder
            per_token = name.startswith("self_")
            s_cache = slot.shape[2]
            ln = min(length, s_cache) if per_token else s_cache
            lp = max(min(pad_to, s_cache) if (pad_to and per_token)
                     else ln, ln)
            positional("x", slot, ln, lp)
        slots[name] = out
    return slots, jobs


def _trim_wire_tensor(wt: WireTensor, ln: int) -> WireTensor:
    """Cut a padded-length int4 tensor to the request's true length (views
    only: no dequantization, no launch). Needs position-aligned groups."""
    if wt.kind != "int4":
        return wt
    L, lp, Hkv, hd = wt.orig_shape
    if ln >= lp:
        return wt
    g2 = wt.payload["packed"].shape[1]
    ppr = (Hkv * hd) // (2 * g2)              # quant rows per position
    out = {key: a.reshape(L, lp, ppr, a.shape[1])[:, :ln].reshape(
        -1, a.shape[1]) for key, a in wt.payload.items()}
    return WireTensor("int4", out, (L, ln, Hkv, hd), wt.dtype)


def extract_batch(cache, requests: Sequence[Tuple[int, int]], *,
                  compress: bool = True, backend: str = "auto",
                  pad_to: Optional[int] = None) -> List[KVWire]:
    """Extract several (batch_index, length) requests with one
    ``ops.kv_quant`` launch per distinct sliced shape (one for a whole
    bucket with ``pad_to``), then trim each to its true length."""
    group = None
    if pad_to is not None:
        kv = next(s["k"] if isinstance(s, dict) else s
                  for name, s in cache.items() if name != "lengths"
                  and (not isinstance(s, dict) or "k" in s))
        group = pick_group(int(np.prod(kv.shape[-2:]))) or None
        if group is None:
            pad_to = None
    wires: List[KVWire] = []
    all_jobs = []
    for ri, (bi, length) in enumerate(requests):
        slots, jobs = _extract_one(cache, bi, length, compress, pad_to)
        wires.append(KVWire(request_len=length, slots=slots))
        all_jobs.extend((ri, name, key, t, ln) for name, key, t, ln in jobs)
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for j, job in enumerate(all_jobs):
        by_shape.setdefault(tuple(job[3].shape), []).append(j)
    for idxs in by_shape.values():
        wts = _quantize_stacked([all_jobs[j][3] for j in idxs], backend,
                                group=group)
        for j, wt in zip(idxs, wts):
            ri, name, key, _, ln = all_jobs[j]
            wires[ri].slots[name][key] = _trim_wire_tensor(wt, ln)
    return wires


def extract(cache, batch_index: int, length: int, *, compress: bool = True,
            backend: str = "auto") -> KVWire:
    """One request's state out of a prefill or dense decode cache (the
    dense engine's migration snapshot, recurrent states included): one
    ``ops.kv_quant`` launch per distinct tensor shape."""
    return extract_batch(cache, [(batch_index, length)], compress=compress,
                         backend=backend)[0]


def compress_wire(wire: KVWire, *, backend: str = "auto") -> KVWire:
    """int4-quantize a raw wire's positional tensors (``k``, ``v``, ``x``)
    with position-aligned groups (one launch per distinct shape):
    compressing a spliced chunked wire gives exactly the bytes of a
    one-shot bucketed extraction. Recurrent states stay raw."""
    slots: Dict[str, Dict[str, WireTensor]] = {}
    jobs = []
    for name, slot_wire in wire.slots.items():
        out: Dict[str, WireTensor] = {}
        for key, wt in slot_wire.items():
            if (wt.kind == "raw" and key in POSITIONAL
                    and pick_group(int(np.prod(wt.orig_shape[-2:])))):
                jobs.append((name, key, wt.payload["x"]))
            else:
                out[key] = wt
        slots[name] = out
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for j, (_, _, t) in enumerate(jobs):
        by_shape.setdefault(tuple(t.shape), []).append(j)
    for shape, idxs in by_shape.items():
        group = pick_group(int(np.prod(shape[-2:])))
        wts = _quantize_stacked([jobs[j][2] for j in idxs], backend,
                                group=group)
        for j, wt in zip(idxs, wts):
            name, key, _ = jobs[j]
            slots[name][key] = wt
    return KVWire(request_len=wire.request_len, slots=slots)


def concat_wires(wires: Sequence[KVWire], *,
                 backend: str = "auto") -> KVWire:
    """Splice per-chunk wires along the position axis. int4 payloads
    concatenate without dequantizing (position-aligned groups make chunk
    boundaries group-row boundaries); a MIXED run (int4 prefix wire + raw
    chunk wires) dequantizes the int4 parts and splices raw."""
    wires = list(wires)
    if not wires:
        raise ValueError("concat_wires needs at least one wire")
    if len(wires) == 1:
        return wires[0]
    slots: Dict[str, Dict[str, WireTensor]] = {}
    for name in wires[0].slots:
        out: Dict[str, WireTensor] = {}
        for key in wires[0].slots[name]:
            wts = [w.slots[name][key] for w in wires]
            kinds = {wt.kind for wt in wts}
            lens = [wt.orig_shape[1] for wt in wts]
            if kinds == {"int4"}:
                L, _, Hkv, hd = wts[0].orig_shape
                g2 = wts[0].payload["packed"].shape[1]
                ppr = (Hkv * hd) // (2 * g2)      # quant rows per position
                payload = {}
                for pk in wts[0].payload:
                    parts = [wt.payload[pk].reshape(L, ln, ppr, -1)
                             for wt, ln in zip(wts, lens)]
                    cat = torch.cat(parts, dim=1)
                    payload[pk] = cat.reshape(-1, cat.shape[3])
                out[key] = WireTensor("int4", payload,
                                      (L, sum(lens), Hkv, hd), wts[0].dtype)
            elif key in POSITIONAL:
                cat = torch.cat([_dequantize(wt, backend) for wt in wts],
                                dim=1)
                out[key] = WireTensor("raw", {"x": cat}, tuple(cat.shape),
                                      next(wt.dtype for wt in wts
                                           if wt.kind == "raw"))
            else:
                raise ValueError(
                    f"cannot splice wire slot {name}/{key}: kinds="
                    f"{sorted(kinds)}, shapes="
                    f"{[wt.orig_shape for wt in wts]}")
        slots[name] = out
    return KVWire(request_len=sum(w.request_len for w in wires),
                  slots=slots)


def dequantize_prefix_batch(wires: Sequence[KVWire], pad_to: int, *,
                            backend: str = "auto"):
    """Stack per-request prefix wires into ``prefill_suffix`` inputs:
    ``{slot: (k, v)}`` of (L, B, pad_to, Hkv, hd) (right-padded with
    zeros, masked by ``prefix_len``) and the (B,) true prefix lengths."""
    dev = next(iter(wires[0].slots["slot0"]["k"].payload.values())).device
    out = {}
    lens = torch.tensor([w.request_len for w in wires], dtype=torch.int32,
                        device=dev)
    for name in wires[0].slots:
        stacked = []
        for key in ("k", "v"):
            ts = []
            for w in wires:
                t = _dequantize(w.slots[name][key], backend)  # (L,ln,Hkv,hd)
                if t.shape[1] < pad_to:
                    t = torch.nn.functional.pad(
                        t, (0, 0, 0, 0, 0, pad_to - t.shape[1]))
                ts.append(t[:, :pad_to])
            stacked.append(torch.stack(ts, dim=1))
        out[name] = (stacked[0], stacked[1])
    return out, lens


def insert(cache, wire: KVWire, batch_index: int, *,
           backend: str = "auto"):
    """Insert one transferred request into a dense decode cache."""
    return insert_batch(cache, [(wire, batch_index)], backend=backend)


def gather_seq(cache, tp, *, frames: int = 0):
    """A kv_seq cache (each rank of ``tp`` holding its share of the
    positions, ``transformer.seq_rows``) with the shares gathered end to
    end: attention K/V and whisper's self K/V along their rows, its cross
    K/V where they hold fewer than the encoder's ``frames`` (the axis
    divides them), the recurrent states and ``lengths`` as they are. Rows
    past a prefill's length (the last share's padding) are zeros that no
    extraction reaches. What a kv_seq prefill's wires and a dense
    engine's migration snapshot are extracted from."""

    def one(name, key, t):
        if key in ("k", "v") or (key is None and (
                name.startswith("self_") or t.shape[2] != frames)):
            return tp.all_gather(t.contiguous(), 2)
        return t

    out = {}
    for name, slot in cache.items():
        if name == "lengths":
            out[name] = slot
        elif isinstance(slot, dict):
            out[name] = {k: one(name, k, t) for k, t in slot.items()}
        else:
            out[name] = one(name, None, slot)
    return out


def _share(x, rows: int, seq_part) -> torch.Tensor:
    """The rows (dim 1) of a wire's positional tensor ``x`` that a cache
    of ``rows`` rows holds: all of them, or under ``seq_part = (r, n)``
    (a kv_seq cache: rank r of n, each holding ``rows`` of the ``n *
    rows`` positions) the run ``[r rows, (r + 1) rows)``, where ``x``
    reaches it (a cache whose rows are the wire's whole length, such as
    whisper's cross frames that the axis does not divide, holds them
    all)."""
    if seq_part is None:
        return x[:, -min(x.shape[1], rows):]
    r, n = seq_part
    return x[:, -min(x.shape[1], rows * n):][:, r * rows:(r + 1) * rows]


def insert_batch(cache, items: Sequence[Tuple[KVWire, int]], *,
                 backend: str = "auto", seq_part=None):
    """Insert (wire, slot_index) pairs into a dense decode cache, in place
    (every tensor stays where it was: a captured decode chunk reads it
    there), with one ``ops.kv_dequant`` launch per distinct packed shape
    across all wires and layers. Attention K/V fills the slot's first
    rows; recurrent states overwrite all of the slot's state, cast to the
    cache's types (an f32 conv state to the cache's bf16). ``seq_part``
    ``(r, n)``: the cache is rank r's share of a kv_seq cache split over
    n ranks, and takes its run of the wire's positions (whisper's cross
    frames too, where the cache holds a share of them)."""
    jobs = [(wi, name, key, wt) for wi, (wire, _) in enumerate(items)
            for name, slot_wire in wire.slots.items()
            for key, wt in slot_wire.items() if wt.kind == "int4"]
    deq = {}
    by_shape: Dict[Tuple, List[int]] = {}
    for j, (_, _, _, wt) in enumerate(jobs):
        k = (tuple(wt.payload["packed"].shape), tuple(wt.orig_shape))
        by_shape.setdefault(k, []).append(j)
    for (pshape, oshape), idxs in by_shape.items():
        packed, scale, zero = (
            torch.cat([jobs[j][3].payload[n] for j in idxs], dim=0)
            for n in ("packed", "scale", "zero"))
        out = ops.kv_dequant(packed, scale, zero, backend=backend)
        rows = pshape[0]
        for t, j in enumerate(idxs):
            wi, name, key, _ = jobs[j]
            deq[(wi, name, key)] = out[t * rows:(t + 1) * rows].reshape(
                oshape)
    for wi, (wire, batch_index) in enumerate(items):
        L = wire.request_len
        for name, slot_wire in wire.slots.items():
            slot = cache[name]

            def floats(key):
                x = deq.get((wi, name, key))
                return x if x is not None else \
                    _dequantize(slot_wire[key], backend)

            if "k" in slot_wire:                      # attention K/V
                for key in ("k", "v"):
                    x = _share(floats(key), slot[key].shape[2], seq_part)
                    slot[key][:, batch_index, :x.shape[1]] = x
            elif isinstance(slot, torch.Tensor):      # whisper's flat K/V
                x = floats("x")                       # cross_*: own length
                # the cross frames: a share where the cache holds one
                part = seq_part if name.startswith("self_") or \
                    slot.shape[2] != x.shape[1] else None
                x = _share(x, slot.shape[2], part)
                slot[:, batch_index, :x.shape[1]] = x
            else:                                     # recurrent states
                for key in slot_wire:
                    slot[key][:, batch_index] = floats(key)
        cache["lengths"][batch_index] = L
    return cache


def wire_bytes_uncompressed(wire: KVWire) -> int:
    total = 0
    for s in wire.slots.values():
        for t in s.values():
            if t.kind == "int4":
                total += int(np.prod(t.orig_shape)) * 2
            else:
                total += t.nbytes()
    return total
