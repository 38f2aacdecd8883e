"""Random weights of a configuration, made on the device from the run's seed.

The benchmark makes the weights and hands the same tensors to the program
and to the plain reference. They are laid out in the port's parameter tree
(``repro_torch.models.transformer``: one dict a layer, projections ``(d_in,
d_out)``), and drawn in a few large calls: every bf16 leaf is a view of one
flat bf16 buffer and every f32 leaf of one flat f32 buffer, each filled by
``normal_`` from one ``torch.Generator`` on the device, a few GiB a call,
then scaled leaf by leaf. :meth:`Weights.fill` draws a seed's values into
the same buffers, so a tensor never moves (a captured CUDA graph reads the
weights where they lie).

Scales follow the port's own init (``1/sqrt(d_in)`` projections, embedding
0.02, Mamba's S4D-real ``A`` and log-uniform ``dt``), except that norm
gains and the Mamba conv bias are drawn at random (0.1 N(0, 1) about their
init) so that the comparison also sees them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from pbench import spec

_STEP = 1 << 30                  # elements a normal_ call fills


class Weights:
    def __init__(self, m: dict, device, dtype=torch.bfloat16):
        self.m, self.device, self.dtype = m, torch.device(device), dtype
        self._leaves: List[Tuple[str, tuple, torch.dtype, str, float]] = []
        self._plan()
        n16 = sum(math.prod(s) for _, s, dt, _, _ in self._leaves
                  if dt == dtype)
        n32 = sum(math.prod(s) for _, s, dt, _, _ in self._leaves
                  if dt == torch.float32)
        self.flat16 = torch.empty(n16, dtype=dtype, device=self.device)
        self.flat32 = torch.empty(n32, dtype=torch.float32,
                                  device=self.device)
        self.tree = self._views()

    # -- the layout --------------------------------------------------------

    def _add(self, path, shape, dt, kind, scale=1.0):
        self._leaves.append((path, tuple(int(s) for s in shape), dt, kind,
                             float(scale)))

    def _norm(self, path, n):
        if spec.layernorm(self.m):
            self._add(path + ".scale", (n,), torch.float32, "gain_ln")
            self._add(path + ".bias", (n,), torch.float32, "zero")
        else:
            self._add(path, (n,), torch.float32, "gain_rms")

    def _proj(self, path, d_in, d_out):
        self._add(path, (d_in, d_out), self.dtype, "normal",
                  1 / math.sqrt(d_in))

    def _plan(self):
        m, bf = self.m, self.dtype
        d, V = int(m["hidden_size"]), int(m["vocab_size"])
        H, Hkv = int(m["num_attention_heads"]), int(m["num_key_value_heads"])
        hd, f = spec.head_dim(m), int(m["intermediate_size"])
        self._add("embed", (V, d), bf, "normal", 0.02)
        for i, (mix, ffn) in enumerate(spec.layer_kinds(m)):
            p = f"layers.{i}"
            self._norm(p + ".norm1", d)
            if mix == "attn":
                self._proj(p + ".attn.wq", d, H * hd)
                self._proj(p + ".attn.wk", d, Hkv * hd)
                self._proj(p + ".attn.wv", d, Hkv * hd)
                self._proj(p + ".attn.wo", H * hd, d)
            else:
                di, ds, dc, dtr = spec.mamba_dims(m)
                q = p + ".mamba"
                self._proj(q + ".in_proj", d, 2 * di)
                self._add(q + ".conv_w", (dc, di), bf, "normal",
                          1 / math.sqrt(dc))
                self._add(q + ".conv_b", (di,), bf, "normal", 0.1)
                self._proj(q + ".x_proj", di, dtr + 2 * ds)
                self._add(q + ".dt_proj", (dtr, di), bf, "normal",
                          dtr ** -0.5)
                self._add(q + ".dt_proj_b", (di,), torch.float32, "dt_bias")
                self._add(q + ".A_log", (di, ds), torch.float32, "a_log")
                self._add(q + ".D", (di,), torch.float32, "one")
                self._proj(q + ".out_proj", di, d)
            if ffn == "moe":
                E = int(m["num_experts"])
                self._add(p + ".moe.router", (d, E), torch.float32, "normal",
                          1 / math.sqrt(d))
                self._add(p + ".moe.wi", (E, d, 2 * f), bf, "normal",
                          1 / math.sqrt(d))
                self._add(p + ".moe.wo", (E, f, d), bf, "normal",
                          1 / math.sqrt(f))
            else:
                self._proj(p + ".mlp.wi", d, 2 * f)
                self._proj(p + ".mlp.wo", f, d)
            if not spec.parallel_block(self.m):
                self._norm(p + ".norm2", d)
        self._norm("final_norm", d)
        if not m.get("tie_word_embeddings"):
            self._proj("unembed", d, V)

    def _views(self) -> dict:
        tree: Dict = {"layers": [{} for _ in spec.layer_kinds(self.m)]}
        at = {self.dtype: 0, torch.float32: 0}
        flat = {self.dtype: self.flat16, torch.float32: self.flat32}
        self._views_of = []
        for path, shape, dt, kind, scale in self._leaves:
            n = math.prod(shape)
            t = flat[dt][at[dt]:at[dt] + n].view(shape)
            at[dt] += n
            self._views_of.append(t)
            keys = path.split(".")
            node = tree
            if keys[0] == "layers":
                node, keys = tree["layers"][int(keys[1])], keys[2:]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
        return tree

    # -- the values --------------------------------------------------------

    def fill(self, seed: int):
        """Draw every leaf from ``seed``: a few ``normal_`` calls over the
        flat buffers, then each leaf's scale or init."""
        g = torch.Generator(device=self.device).manual_seed(
            int(seed) % 2 ** 63)
        for flat in (self.flat16, self.flat32):
            for i in range(0, flat.numel(), _STEP):
                flat[i:i + _STEP].normal_(generator=g)
        with torch.no_grad():
            for (path, shape, dt, kind, scale), t in zip(self._leaves,
                                                         self._views_of):
                if kind == "normal":
                    t.mul_(scale)
                elif kind == "gain_ln":
                    t.mul_(0.1).add_(1.0)
                elif kind == "gain_rms":
                    t.mul_(0.1)
                elif kind == "zero":
                    t.zero_()
                elif kind == "one":
                    t.fill_(1.0)
                elif kind == "a_log":
                    t.copy_(torch.log(torch.arange(
                        1, shape[1] + 1, dtype=torch.float32,
                        device=self.device)).expand(shape))
                elif kind == "dt_bias":
                    # inverse softplus of dt log-uniform in [1e-3, 0.1]
                    u = torch.rand(shape, generator=g, device=self.device)
                    dt_ = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                                    + math.log(1e-3))
                    t.copy_(torch.log(torch.expm1(dt_)))
        return self.tree

    @property
    def nbytes(self) -> int:
        return self.flat16.numel() * self.flat16.element_size() + \
            self.flat32.numel() * 4
