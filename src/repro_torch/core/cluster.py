"""Cluster description: heterogeneous device pool + bandwidth matrix.

The port's copy of ``repro.core.cluster``: the paper's GPU cloud (2x4xA6000,
2x4xA5000, 1x8xA40, 2x4x3090Ti rented from vast.ai, §5.1) and its in-house
8xA100 baseline. The reference's TPU fleet profiles are left out (the port
states no TPU figure); ``make_cluster("tpu_fleet")`` raises. The scheduler
is agnostic: it only sees (peak_flops, hbm_bw, memory, price, bw matrix).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.roofline.hw import GPU_SPECS, ChipSpec


@dataclass(frozen=True)
class DeviceSpec:
    idx: int
    chip: ChipSpec
    node: int              # devices on the same node share fast links

    @property
    def type_name(self) -> str:
        return self.chip.name


@dataclass
class ClusterSpec:
    devices: List[DeviceSpec]
    bw: np.ndarray                      # (N, N) bytes/s, symmetric
    alpha: float = 5e-5                 # network latency (s) for alpha-beta

    def __post_init__(self):
        assert self.bw.shape == (len(self.devices),) * 2

    @property
    def n(self) -> int:
        return len(self.devices)

    def types(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.devices:
            out[d.type_name] = out.get(d.type_name, 0) + 1
        return out

    def price_per_hr(self) -> float:
        return sum(d.chip.price_per_hr for d in self.devices)

    def subset(self, idxs: Sequence[int]) -> "ClusterSpec":
        idxs = list(idxs)
        remap = {old: new for new, old in enumerate(idxs)}
        devs = [DeviceSpec(remap[d.idx], d.chip, d.node)
                for d in self.devices if d.idx in remap]
        devs.sort(key=lambda d: d.idx)
        return ClusterSpec(devs, self.bw[np.ix_(idxs, idxs)], self.alpha)

    def remove_nodes(self, nodes: Sequence[int]) -> "ClusterSpec":
        keep = [d.idx for d in self.devices if d.node not in set(nodes)]
        return self.subset(keep)

    def min_bw_between(self, a: Sequence[int], b: Sequence[int]) -> float:
        if not a or not b:
            return float("inf")
        return float(min(self.bw[i, j] for i in a for j in b))


def _build(nodes: List[Tuple[str, int]], *, intra_bw, inter_bw, seed=0,
           jitter=0.15, alpha=5e-5) -> ClusterSpec:
    """nodes: list of (chip_type_name, num_devices)."""
    rng = np.random.default_rng(seed)
    devices: List[DeviceSpec] = []
    idx = 0
    for node_id, (tname, cnt) in enumerate(nodes):
        chip = GPU_SPECS[tname]
        for _ in range(cnt):
            devices.append(DeviceSpec(idx, chip, node_id))
            idx += 1
    n = len(devices)
    bw = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            same = devices[i].node == devices[j].node
            base = intra_bw if same else inter_bw
            val = base * (1.0 + jitter * (rng.random() * 2 - 1))
            bw[i, j] = bw[j, i] = val
        bw[i, i] = 1e15
    return ClusterSpec(devices, bw, alpha)


def make_paper_cloud(seed: int = 0) -> ClusterSpec:
    """The paper's §5.1 heterogeneous rental: 32 GPUs, $13.542/hr.

    PCIe intra-node (~12 GB/s effective), shared-ethernet inter-node
    (~5 Gbit/s = 0.6 GB/s with heterogeneity), cf. paper Fig. 13 heatmap.
    """
    nodes = [("A6000", 4), ("A6000", 4), ("A5000", 4), ("A5000", 4),
             ("A40", 8), ("3090Ti", 4), ("3090Ti", 4)]
    return _build(nodes, intra_bw=12e9, inter_bw=0.6e9, seed=seed,
                  jitter=0.4)


def make_inhouse(seed: int = 0) -> ClusterSpec:
    """The paper's homogeneous baseline: 8xA100-80G with NVLink."""
    return _build([("A100", 8)], intra_bw=300e9, inter_bw=25e9, seed=seed,
                  jitter=0.0)


def make_cluster(name: str, seed: int = 0) -> ClusterSpec:
    if name == "tpu_fleet":
        raise ValueError("tpu_fleet: the port keeps no TPU device profiles "
                         "(ROADMAP A.6); use paper_cloud or inhouse")
    return {"paper_cloud": make_paper_cloud, "inhouse": make_inhouse}[name](
        seed)
