"""Roofline terms of a counted step (the port of
``repro.roofline.analysis``).

The reference reads its terms off a compiled artifact: FLOPs and bytes
from XLA's HLO (``hlo_cost``), collectives parsed from the partitioned
HLO text. The port counts them as the step runs
(``roofline/op_cost.py``: the aten ops it dispatches, each kernel by its
cost function, each collective of an abstract mesh), per rank, so
:func:`analyze` takes that count. The record keeps the reference's keys
for ``roofline/report.py``; ``hlo_flops`` and ``hlo_bytes`` are the
counted aten and kernel ops' FLOPs and bytes of one rank.

Wire-byte model per op (ring), the reference's, as :func:`wire_bytes`:
  all-reduce:          2 * size * (n-1)/n
  all-gather:          out_size * (n-1)/n
  reduce-scatter:      in_size  * (n-1)/n
  all-to-all:          size * (n-1)/n
  collective-permute:  size  (the port's point-to-point ``send_recv``)
A group of one rank moves nothing.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.roofline.hw import H100, NVLINK_LINKS, ChipSpec


def wire_bytes(op: str, size: float, n: int) -> float:
    """Bytes a rank puts on its links for collective ``op`` (the
    reference's or the port's name: ``all-reduce`` / ``all_reduce``,
    ``collective-permute`` / ``send_recv``) of ``size`` payload bytes
    over a group of ``n`` ranks."""
    op = op.replace("-", "_")
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    if op == "all_reduce":
        return 2.0 * size * ring
    if op in ("collective_permute", "send_recv"):
        return float(size)
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        return size * ring
    raise ValueError(f"no wire model for collective {op!r}")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float            # per device: counted aten + kernel FLOPs
    hlo_bytes: float            # per device: counted aten + kernel bytes
    collective_payload: float   # per device payload bytes
    collective_wire: float      # per device wire bytes
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # analytic useful FLOPs (global)
    useful_ratio: float         # model_flops / (hlo_flops * n_chips)
    step_s: float               # max of the three terms
    roofline_frac: float        # compute_s / step_s (how compute-bound)
    per_device_output_bytes: float = 0.0
    memory_estimate_bytes: float = 0.0

    def to_json(self) -> dict:
        return asdict(self)


def analyze(counted: dict, *, arch: str, shape: str, mesh_desc: str,
            n_chips: int, model_flops: float, chip: ChipSpec = H100,
            n_links: int = NVLINK_LINKS,
            memory: Optional[dict] = None) -> Roofline:
    """Roofline terms of one rank's counted step (``op_cost``'s result):
    compute at ``chip.peak_flops`` (the dense bf16 peak), memory at
    ``chip.hbm_bw``, collectives' wire bytes over ``n_links`` links of
    ``chip.link_bw`` each way. ``memory``: ``{"arg", "temp", "out"}``
    bytes of the rank, for the memory estimate (arguments + peak of
    temporaries)."""
    flops, bytes_acc = float(counted["flops"]), float(counted["bytes"])
    wire = float(counted["coll_wire"])
    compute_s = flops / chip.peak_flops
    memory_s = bytes_acc / chip.hbm_bw
    collective_s = wire / (chip.link_bw * n_links)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    mem_an = memory or {}
    total_flops = flops * n_chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_desc, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=bytes_acc,
        collective_payload=float(counted["coll_payload"]),
        collective_wire=wire, collective_counts=dict(counted["coll_counts"]),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        step_s=step_s,
        roofline_frac=(compute_s / step_s) if step_s else 0.0,
        per_device_output_bytes=float(mem_an.get("out", 0)),
        memory_estimate_bytes=float(mem_an.get("temp", 0)
                                    + mem_an.get("arg", 0)))


def model_flops_for(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step (global).

    train:   6 * N_active * tokens      (fwd+bwd)
    prefill: 2 * N_active * tokens  (+ attention-score term)
    decode:  2 * N_active * batch   (+ KV-read dot products)
    """
    n_act = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    d_attn = 0.0
    attn_layers = sum(1 for l in range(cfg.num_layers) if cfg.is_attn_layer(l)
                      and cfg.family != "ssm")
    if shape.kind == "train":
        toks = B * S
        eff_s = min(S, cfg.sliding_window) if cfg.sliding_window else S
        d_attn = 6 * attn_layers * 2 * B * S * eff_s * cfg.q_dim / 2
        return 6.0 * n_act * toks + d_attn
    if shape.kind == "prefill":
        toks = B * S
        eff_s = min(S, cfg.sliding_window) if cfg.sliding_window else S
        d_attn = 2 * attn_layers * 2 * B * S * eff_s * cfg.q_dim / 2
        return 2.0 * n_act * toks + d_attn
    # decode: one token per sequence
    eff_s = min(S, cfg.sliding_window) if cfg.sliding_window else S
    d_attn = 2 * attn_layers * 2 * B * eff_s * cfg.q_dim
    return 2.0 * n_act * B + d_attn
