"""The wire/page int4 layout contract (the port's copy of
``repro.kernels.kv_layout``).

The prefill->decode wire (``serving/kv_transfer.py``), the paged decode
cache (``models/paged.py``) and the kernels (``kernels/ref.py`` and the
CUDA sources under ``kernels/csrc``) must agree bit for bit on how KV is
laid out in int4, or zero-copy page insertion degrades to a re-encode and
a drifted nibble order corrupts tokens. Everything layout-bearing lives
here:

* :data:`GROUPS` — candidate quantization group widths;
* :func:`pick_group` — the group-selection rule (largest candidate
  dividing the span; with ``span = Hkv * hd`` groups never straddle token
  positions);
* :func:`pack_nibbles` / :func:`unpack_nibbles` /
  :func:`interleave_nibbles` — two int4 values per byte, LOW NIBBLE FIRST
  (element ``2j`` in bits 0-3 of byte ``j``, ``2j+1`` in bits 4-7).

The CUDA kernels repeat the nibble order in C++; ``chip_smoke.py`` and
the GPU tests hold them to these functions byte for byte.
"""
from __future__ import annotations

import torch

GROUPS = (128, 64, 32, 16, 8, 4, 2)


def pick_group(span: int) -> int:
    """Largest candidate group width dividing ``span`` (0 = none: raw)."""
    return next((g for g in GROUPS if span % g == 0), 0)


def pack_nibbles(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Pack two int4 planes (uint8 values 0..15) into one uint8 plane:
    ``even`` in bits 0-3, ``odd`` in bits 4-7."""
    return (even | (odd << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor):
    """Inverse of :func:`pack_nibbles`: uint8 plane -> (low, high) f32."""
    lo = (packed & 0xF).to(torch.float32)
    hi = (packed >> 4).to(torch.float32)
    return lo, hi


def interleave_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., G//2)`` -> f32 ``(..., G)`` in the original element
    order (even indices from low nibbles, odd from high)."""
    lo, hi = unpack_nibbles(packed)
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))
