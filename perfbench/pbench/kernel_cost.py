"""A frozen copy of the functions of ``repro_torch.kernels.cost`` that the
benchmark's roofline shares use (the attention kernels'), copied so that a
later change to the program cannot move the yardstick. The program's own
module says:

The work of each kernel of ``kernels/ops.py``: its FLOPs and the bytes
it must move, from the shapes and types of its tensor arguments.

Each function takes ``(shapes, dtypes, **data)`` -- the shapes and types
of the wrapper's tensor arguments in its order (an int4 page triple as its
three tensors), and the values the work depends on where they are known --
and returns ``(flops, bytes)``:

- bytes: each input read once and each output written once, the least
  any implementation moves (a decode kernel reads the cache rows up to
  ``kv_len`` only, and writes nothing back but its output);
- FLOPs: the arithmetic of the function, the attention kernels' two
  products (4 hd FLOPs a visible query-key pair and query head; a logit
  softcap adds :data:`SOFTCAP_OPS` a pair and query head: the division,
  the tanh counted as one operation, the product).

The work of the attention kernels depends on the data: the tokens a
decode step reads (``kv_len``), the pairs a suffix prefill sees
(``prefix_len``). Pass them as lists of ints where they are known (the
card's checks in ``chip_smoke.py`` phase 3, whose bound column these are);
left out (a meta tensor holds no values) every row counts: ``kv_len`` at
the cache's or page table's length, ``prefix_len`` at the padded prefix.
"""
from __future__ import annotations

from typing import Tuple

Shape = Tuple[int, ...]

# operations a logit softcap adds to a score: s / c, tanh, c * ...
SOFTCAP_OPS = 3


def _n(shape: Shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _tokens(kv_len, B, rows):
    return B * rows if kv_len is None else int(sum(kv_len))


def paged_decode_attention_int4(shapes, dtypes, *, page_size, kv_len=None):
    """q (B, Hkv, gq, hd) over int4 triples kp, ks, kz, vp, vs, vz
    (P, R, g/2 | 1) through page_table (B, W), kv_len (B,)."""
    B, Hkv, gq, hd = shapes[0]
    g = 2 * shapes[1][-1]
    ppr = shapes[1][1] // page_size
    W = shapes[7][1]
    tokens = _tokens(kv_len, B, W * page_size)
    return (4 * Hkv * gq * hd * tokens,
            tokens * 2 * ppr * (g // 2 + 8)
            + 2 * _n(shapes[0]) * dtypes[0].itemsize + 4 * (B * W + B))


def decode_attention(shapes, dtypes, *, kv_len=None, return_lse=False,
                     softcap=0.0):
    """q (B, Hkv, g, hd) over k, v (B, Hkv, S, hd) up to kv_len (B,).
    The partial mode (``return_lse``) writes ``o`` in f32 and one f32
    log-sum-exp a query row."""
    B, Hkv, g, hd = shapes[0]
    tokens = _tokens(kv_len, B, shapes[1][2])
    q_bytes = _n(shapes[0]) * dtypes[0].itemsize
    out_bytes = 4 * _n(shapes[0]) + 4 * B * Hkv * g if return_lse \
        else q_bytes
    cap = SOFTCAP_OPS if softcap else 0
    return ((4 * hd + cap) * Hkv * g * tokens,
            tokens * Hkv * hd * 2 * dtypes[1].itemsize
            + q_bytes + out_bytes + 4 * B)


def flash_pairs(B, Sq, Sk, *, causal=True, window=0, prefix_len=None):
    """Visible (query, key) pairs of a flash call: all of them
    bidirectional; causal ones within the window; with ``prefix_len`` the
    suffix's causal pairs plus each row's prefix (``Sk - Sq`` padded
    prefix positions a row where the lengths are not known)."""
    if not causal:
        return B * Sq * Sk
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(Sq))
    if prefix_len is None:
        return B * pairs
    if isinstance(prefix_len, str):          # known to exist, not its values
        return B * pairs + Sq * B * (Sk - Sq)
    return B * pairs + Sq * int(sum(prefix_len))


def flash_attention(shapes, dtypes, *, causal=True, window=0,
                    prefix_len=None, softcap=0.0):
    """q (B, Sq, H, hd), k, v (B, Sk, Hkv, hd). ``prefix_len``: a list of
    each row's prefix length, or ``"unknown"`` for a suffix call whose
    lengths are not known (every padded prefix position counts)."""
    (B, Sq, H, hd), (_, Sk, _, _) = shapes[0], shapes[1]
    pairs = flash_pairs(B, Sq, Sk, causal=causal, window=window,
                        prefix_len=prefix_len)
    cap = SOFTCAP_OPS if softcap else 0
    return ((4 * hd + cap) * H * pairs,
            (2 * _n(shapes[0]) + _n(shapes[1]) + _n(shapes[2]))
            * dtypes[0].itemsize)
