"""The system under test: ``repro_torch``'s gateway over one prefill and one
decode engine that share one copy of the weights on the card (one card's
share of a disaggregated deployment: a prefill and a decode replica,
colocated), the int4 KV wire in-process, and for a pure-attention model
the paged int4-resident decode cache with prefix sharing. Each decode chunk
is one CUDA graph replay; prefill runs eagerly.

Set-up warms what the cell's traffic uses and nothing else: every
(prompt bucket, batch width) its prompts can form for a bucketed model, or
its longest and shortest prompt for an exact-length one (eager prefill
builds nothing per shape; the runs settle the allocator and the GEMM
heuristics), and one decode chunk of the chunk length (the graph's
capture). The page pool then takes the memory left, as a deployment's
would.
"""
from __future__ import annotations

import gc
from typing import List, Optional

import numpy as np
import torch

from pbench import clients, spec

GIB = 1 << 30


def _bucket(n: int, lo: int, hi: int) -> int:
    return min(max(1 << max((n - 1).bit_length(), 0), lo), hi)


class System:
    def __init__(self, cfg_file: dict, params, device, *,
                 rehearse: bool = False):
        from repro_torch.serving.engine import PrefillEngine
        self.cfg_file = cfg_file
        self.serve = dict(cfg_file["serve"])
        if rehearse:
            self.serve.update(cfg_file["rehearsal"]["serve"])
        self.pc = spec.port_config(cfg_file, rehearse)
        spec.check_port_config(cfg_file, self.pc, rehearse)
        self.params, self.device = params, torch.device(device)
        s = self.serve
        self.pre = PrefillEngine(self.pc, params, max_seq=s["max_seq"],
                                 max_batch=s["max_prefill_batch"],
                                 device=device)
        self.dec = None
        self.gw = None

    # -- set-up ---------------------------------------------------------------

    def _prefill(self, lens: List[int], rng):
        from repro_torch.serving.engine import GenRequest
        V = self.pc.vocab_size
        reqs = [GenRequest(-1 - i, rng.integers(1, V, n).astype(np.int32), 2)
                for i, n in enumerate(lens)]
        return self.pre.run(reqs)

    def warm_prefill(self, prompt_lens: List[int]):
        """Every prefill shape the traffic's prompts can form (on the CPU,
        which has nothing to settle, the longest prompt alone)."""
        rng = np.random.default_rng(0)
        s = self.serve
        if self.device.type != "cuda":
            self._prefill([max(prompt_lens)], rng)
        elif self.pre.bucketed:
            buckets = sorted({_bucket(n, self.pre.min_bucket, s["max_seq"])
                              for n in prompt_lens})
            widths = sorted({min(1 << (b - 1).bit_length(),
                                 s["max_prefill_batch"])
                             for b in range(1, s["max_prefill_batch"] + 1)})
            for b in reversed(buckets):          # the peak first
                for w in reversed(widths):
                    self._prefill([b] * w, rng)
        else:
            for n in (max(prompt_lens), min(prompt_lens)):
                self._prefill([n], rng)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def build_decode(self):
        """The decode engine; a paged one's pool takes the memory left."""
        from repro_torch.models import paged as paged_fmt
        from repro_torch.serving.engine import DecodeEngine
        s = self.serve
        kw = dict(max_slots=s["max_slots"], max_seq=s["max_seq"],
                  chunk_size=s["decode_chunk"], paged=s["paged"],
                  device=self.device)
        if s["paged"]:
            kw.update(page_size=s["page_size"],
                      prefix_sharing=s["prefix_sharing"])
            if self.device.type == "cuda":
                gc.collect()
                free = torch.cuda.mem_get_info(self.device)[0]
                meta = paged_fmt.init_paged_cache(
                    self.pc, 1, s["page_size"], 2,
                    page_size=s["page_size"], device="meta")
                per_page = sum(t.numel() * t.element_size()
                               for t in meta["slot0"].values()) / 2
                kw["num_pages"] = int((free - s["reserve_gib"] * GIB)
                                      // per_page)
            else:
                kw["num_pages"] = s["rehearsal_pages"]
        self.dec = DecodeEngine(self.pc, self.params, **kw)
        return self.dec

    def warm_decode(self):
        """Admit one short request and decode it to its end: the chunk's
        graph is captured once, here."""
        from repro_torch.serving.engine import (ADMIT_FRESH, AdmissionBatch,
                                                AdmissionItem, GenRequest)
        rng = np.random.default_rng(1)
        req = GenRequest(-100, rng.integers(
            1, self.pc.vocab_size, 16).astype(np.int32),
            2 * self.serve["decode_chunk"])
        out = self.pre.run([req])
        rejected = self.dec.admit(AdmissionBatch(
            [AdmissionItem(r, f, ADMIT_FRESH, wire=w) for r, w, f in out]))
        if rejected:
            raise RuntimeError("the warm-up request was not admitted")
        while self.dec.active:
            self.dec.step()
        if self.dec.paged:
            self.dec.clear_prefix()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def gateway(self, rec: clients.Recorder, clock):
        from repro_torch.serving.gateway import (Gateway, LocalDecodeClient,
                                                 LocalPrefillClient,
                                                 SchedulerConfig)
        s = self.serve
        self.gw = Gateway(
            [clients.PrefillClient(LocalPrefillClient(self.pre), rec)],
            [clients.DecodeClient(LocalDecodeClient(self.dec), rec,
                                  self.dec.paged)],
            compress=True, clock=clock,
            scheduler=SchedulerConfig(
                max_prefill_batch=s["max_prefill_batch"]))
        return self.gw

    @property
    def pages(self) -> Optional[int]:
        """Pages the pool can hand out (its trash page not counted)."""
        return self.dec.pool.stats()["pages"] if self.dec.paged else None

    def reset(self):
        """Empty the decode engine (every slot released, the prefix index
        dropped) for another stretch of traffic on the same set-up."""
        for i, r in enumerate(self.dec.slots):
            if r is not None:
                self.dec.release(i)
        if self.dec.paged:
            self.dec.clear_prefix()
        self.gw = None

    def free(self):
        """Drop the program's state (engines, caches, graphs), keeping the
        weights, which are the benchmark's."""
        self.gw = self.dec = self.pre = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


