"""Model API over the ported families (``repro.models.registry``).

``build(cfg)`` returns a :class:`ModelApi` for every family of the
reference: dense (the LLaMA-style stack and its variants in the
registered configs: LayerNorm, a parallel block, an embedding scale,
tied embeddings, partial rotary, a sliding window, q/k norms, biases),
MoE (``models/moe.py``), the VLM (patch embeddings in front of the text,
at the model API only, as the reference's engines never pass them), the
hybrid and SSM stacks (``models/mamba.py``, ``models/xlstm.py``: jamba,
xlstm) and the audio encoder-decoder (``models/whisper.py``: its prefill
takes ``frame_embeds`` beside the tokens). ``decode`` and
``decode_chunk`` step the dense cache (``transformer.decode_step`` or
``whisper.decode_step``), ``paged_decode_fns`` the page pool, where
``paged.paged_supported`` (pure full-attention stacks); elsewhere it and
``prefill_suffix`` are None. ``make_decode_chunk`` turns a single
decode step into the engine's multi-token greedy loop: the reference's
device ``lax.scan`` becomes a Python loop over steps whose state (current
tokens, active flags, token counts) stays in device tensors, so a chunk
launches kernels back to back and never waits on the host.
:class:`GraphedDecodeChunk` is what ``jax.jit`` makes of the reference's
chunk: the same loop captured once per ``n_steps`` as a CUDA graph and
replayed, one host launch a chunk. ``loss(params, batch)`` is the
training loss of every family (``transformer.loss_fn``,
``whisper.loss_fn``), differentiable by autograd.

``build(cfg, rt=transformer.Runtime(mesh))`` runs the model tensor- and
expert-parallel over the mesh's ``model`` axis, every family (whisper's
encoder-decoder and the recurrent stacks too): the functions take this
rank's shard of the params and the caches that ``ModelApi.local_cfg``
(``sharding.local_cfg``: this rank's heads, KV heads, FFN columns,
experts and recurrent channels; under ``Runtime(kv_seq=True)``, or where
the axis does not split the heads, the kv_seq decode cache) lays out,
and place the collectives (``distributed/comm.py``). The paged decode
step refuses the kv_seq layout.
On NCCL a graphed chunk captures them with the rest; a gloo group cannot
be captured, and :class:`GraphedDecodeChunk` refuses it.

For the dry-run (``launch/dryrun.py``), as the reference:
``input_specs(shape)`` is a cell's batch and ``cache_specs(shape)`` its
dense decode cache, as ``meta`` tensors (nothing allocated), after the
per-cell adjustments of :func:`_effective_cfg`; :func:`build_for_cell`
builds the model those adjustments give. ``cache_specs`` is the port's
own dense cache (``transformer.init_cache``, ``whisper.init_cache``):
where it differs from the reference's (ROADMAP C.4: one layer-ordered
stack for a multi-slot pure-attention stack) the specs differ too.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import comm, sharding
from repro_torch.kernels import ops
from repro_torch.models import paged, transformer, whisper


@dataclass
class ModelApi:
    cfg: ModelConfig
    prefill: Callable
    # partial-prefix-hit / chunked-prefill path (transformer.prefill_suffix)
    prefill_suffix: Optional[Callable] = None
    # paged_decode_fns(page_size, backend) -> (step_fn, chunk_fn)
    paged_decode_fns: Optional[Callable] = None
    # dense-cache decode: decode(params, cache, tokens) -> (logits, cache)
    # and its device-resident multi-step loop
    decode: Optional[Callable] = None
    decode_chunk: Optional[Callable] = None
    # the training loss: loss(params, batch) -> f32 scalar
    loss: Optional[Callable] = None
    # the config one rank's shard computes and its caches hold (cfg
    # itself without a mesh or at model axis size 1)
    local_cfg: Optional[ModelConfig] = None
    # the model axis's collectives (None without a mesh)
    tp: Optional[comm.Group] = None
    # the mesh the functions run over (None without one): the train step
    # reduces the gradients over its axes
    mesh: Optional[object] = None
    # a cell's batch and dense decode cache as meta tensors
    input_specs: Optional[Callable] = None
    cache_specs: Optional[Callable] = None


def make_decode_chunk(decode_fn: Callable) -> Callable:
    """Greedy multi-token decode around ``decode_fn(params, cache, tokens)
    -> (logits, cache)``.

    state: {"cur": (B,) int32 current token per slot, "active": (B,) bool,
    "n_out": (B,) int32 tokens emitted so far (incl. first), "max_new":
    (B,) int32}. Returns (tokens (n_steps, B) int32 with -1 where a slot
    was inactive, valid (n_steps, B) bool, cache, state). Inactive slots
    keep their old lengths: the new lengths are computed out of place and
    selected with ``torch.where``. Only the lengths are frozen, as in the
    reference: an inactive slot's K/V row and recurrent states are still
    written, and admission overwrites all of a slot's state. The chunk
    ends by copying its final lengths into ``cache["lengths"]``, so the
    cache returned is the one passed in, every tensor where it was (what
    a CUDA graph of the chunk needs). Nothing in the loop reads a device value on the host (no
    ``.item()``, ``int()``, ``.cpu()`` or boolean masks)."""

    def decode_chunk(params, cache, state, *, n_steps: int, eos_id: int,
                     max_seq: int):
        cur, active, n_out = state["cur"], state["active"], state["n_out"]
        max_new = state["max_new"]
        toks, valid = [], []
        step_cache = cache
        for _ in range(n_steps):
            logits, new_cache = decode_fn(params, step_cache, cur[:, None])
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            n_out = n_out + active.to(torch.int32)
            lengths = torch.where(active, new_cache["lengths"],
                                  step_cache["lengths"])
            new_cache["lengths"] = lengths
            done = active & ((nxt == eos_id) | (n_out >= max_new)
                             | (lengths >= max_seq - 1))
            toks.append(torch.where(active, nxt, -1))
            valid.append(active)
            cur = torch.where(active, nxt, cur)
            active = active & ~done
            step_cache = new_cache
        cache["lengths"].copy_(step_cache["lengths"])
        return (torch.stack(toks), torch.stack(valid), cache,
                {"cur": cur, "active": active, "n_out": n_out,
                 "max_new": max_new})

    return decode_chunk


STATE_KEYS = ("cur", "active", "n_out", "max_new")
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # by device index


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for every engine's warm-up and captures:
    cuBLAS keeps a workspace for each stream it has run on, so a stream an
    engine would leave one behind."""
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nest of dicts, lists and tuples, in a fixed
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class GraphedDecodeChunk:
    """The decode chunk as CUDA graphs: one ``torch.cuda.CUDAGraph`` per
    ``(n_steps, eos_id, max_seq)`` around ``chunk_fn`` (a
    :func:`make_decode_chunk` loop, which stays the eager arm), called
    like it. The counterpart of the reference's ``jax.jit`` of its
    ``lax.scan`` chunk, and of its compile cache: ``len()`` is the number
    of graphs captured.

    A call copies the state into static device buffers, replays, and
    returns the static outputs (valid until the next call). The first call
    with a new ``n_steps`` captures first (:meth:`capture`; a capture runs
    nothing), so the first chunk already replays. A graph reads the
    params, the cache and the state buffers at the addresses they had at
    capture: the engine edits its cache in place, this object keeps a
    reference to every captured tensor, and each call checks that the
    params and the cache passed in are still those tensors and raises if
    one moved, so no replay reads or writes stale memory. A failed capture
    raises too: nothing falls back to the eager loop.

    Whatever a kernel wrapper allocates lazily (the kernel library, the
    split decode kernels' merge counters, cuBLAS's handle and workspace
    for the capture stream) must exist before a capture, or it would land
    in the graph's pool. So construction runs one eager decode step
    (``step_fn``) on the capture stream and discards it. The cache must be
    idle then: its slots' writes go to the trash page (paged) or to row 0
    of each slot (dense), which admission overwrites before anything
    reads it, and ``lengths`` is not touched.

    The wrappers count their launches in Python, which a replay does not
    run: the counts a capture adds are taken back, and added again at
    every replay; so are the CTAs the int4 paged kernel counts
    (``ops.cta_counts``) and the collectives' (``comm.counts``). Replays run
    on the current stream, in order, like the eager launches they
    replace (the split decode kernels share one merge counter buffer per
    device and must not overlap).

    Under a mesh (``tp``, the model axis's group) the chunk's NCCL
    collectives are captured with its kernels; the warm-up step has made
    the communicator before. A gloo group cannot be captured (its
    collectives run on the host): it raises."""

    def __init__(self, step_fn: Callable, chunk_fn: Callable, params,
                 cache, max_slots: int, tp: Optional[comm.Group] = None):
        if tp is not None and not tp.graphable:
            raise ValueError(
                f"decode chunk graph: the model axis runs over "
                f"{tp.backend}, whose collectives cannot be captured; "
                f"use cuda_graph=False")
        device = cache["lengths"].device
        self._chunk_fn = chunk_fn
        self._stream = _capture_stream(device)
        self._state = {k: torch.zeros(
            (max_slots,), dtype=torch.bool if k == "active" else torch.int32,
            device=device) for k in STATE_KEYS}
        self._captured = _tensors((params, cache, self._state))
        self._graphs: Dict[Tuple[int, int, int], tuple] = {}
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            step_fn(params, cache, self._state["cur"][:, None])
        torch.cuda.current_stream(device).wait_stream(self._stream)

    def __len__(self) -> int:
        return len(self._graphs)

    def _check(self, params, cache):
        now = _tensors((params, cache, self._state))
        if len(now) != len(self._captured) or any(
                a.data_ptr() != b.data_ptr()
                for a, b in zip(now, self._captured)):
            raise RuntimeError(
                "decode chunk graph: a captured tensor was replaced (the "
                "params or a cache tensor moved); replaying would read and "
                "write stale memory")

    def capture(self, params, cache, *, n_steps: int, eos_id: int,
                max_seq: int):
        """Capture the graph of ``n_steps`` unless it exists. A capture
        synchronizes the device (``torch.cuda.graph``), so callers that
        forbid host syncs around the replay capture first.

        Garbage is collected before the capture and not during it: a
        collection inside would destroy the graphs of engines that died
        in a reference cycle (a dropped gateway), and CUDA refuses to
        destroy a graph while a stream captures, which spoils the
        capture."""
        key = (n_steps, eos_id, max_seq)
        if key in self._graphs:
            return
        self._check(params, cache)
        before, before_ctas = ops.launch_counts(), ops.cta_counts()
        before_comm = comm.counts()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                out = self._chunk_fn(params, cache, self._state,
                                     n_steps=n_steps, eos_id=eos_id,
                                     max_seq=max_seq)
        finally:
            if collecting:
                gc.enable()
        after, after_comm = ops.launch_counts(), comm.counts()
        ctas = {k: n - before_ctas[k] for k, n in ops.cta_counts().items()
                if n != before_ctas[k]}
        for name, n in before.items():          # the capture ran nothing
            ops.KERNELS[name].launches = n
        for name, n in before_ctas.items():
            ops.KERNELS[name].ctas = n
        comm.set_counts(before_comm)
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        collectives = {k: n - before_comm.get(k, 0)
                       for k, n in after_comm.items()
                       if n != before_comm.get(k, 0)}
        self._graphs[key] = (graph, out, launches, collectives, ctas)

    def captured(self, n_steps: int, eos_id: int, max_seq: int):
        """``(graph, launches)`` of a captured chunk: the
        ``torch.cuda.CUDAGraph`` (a replay with the state buffers as they
        are runs the chunk again, for timing) and the kernel launches one
        replay makes, by wrapper, as counted while it was captured."""
        graph, _, launches, _, _ = self._graphs[(n_steps, eos_id, max_seq)]
        return graph, dict(launches)

    def collectives(self, n_steps: int, eos_id: int, max_seq: int):
        """The collectives one replay of a captured chunk makes, by
        call."""
        return dict(self._graphs[(n_steps, eos_id, max_seq)][3])

    def __call__(self, params, cache, state, *, n_steps: int, eos_id: int,
                 max_seq: int):
        self.capture(params, cache, n_steps=n_steps, eos_id=eos_id,
                     max_seq=max_seq)
        self._check(params, cache)
        graph, (toks, valid, _, st), launches, collectives, ctas = \
            self._graphs[(n_steps, eos_id, max_seq)]
        for k in STATE_KEYS:
            self._state[k].copy_(state[k])
        graph.replay()
        for name, n in launches.items():
            ops.KERNELS[name].launches += n
        for name, n in ctas.items():
            ops.KERNELS[name].ctas += n
        comm.add_counts(collectives)
        return toks, valid, cache, st


def _effective_cfg(cfg: ModelConfig, shape: Optional[ShapeSpec]
                   ) -> ModelConfig:
    """Per-cell adjustments (the reference's, DESIGN.md):

    * jamba long_500k: its 4 attention layers fall back to SWA(4096) so the
      decode state is bounded (Mamba layers already are O(1)).
    """
    if shape is None:
        return cfg
    if shape.name == "long_500k" and cfg.family == "hybrid" \
            and not cfg.sliding_window:
        return cfg.replace(sliding_window=4096)
    return cfg


def _token_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The reference's batch of a cell, as meta tensors of its shapes and
    types."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "train":
        if cfg.family == "audio":
            return {"tokens": sds((B, S), i32),
                    "targets": sds((B, S), i32),
                    "frame_embeds": sds((B, cfg.encoder_seq, cfg.d_model),
                                        bf16)}
        if cfg.family == "vlm":
            s_text = S - cfg.num_patches
            return {"tokens": sds((B, s_text), i32),
                    "targets": sds((B, s_text), i32),
                    "patch_embeds": sds((B, cfg.num_patches, cfg.d_model),
                                        bf16)}
        return {"tokens": sds((B, S), i32), "targets": sds((B, S), i32)}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"tokens": sds((B, S), i32),
                    "frame_embeds": sds((B, cfg.encoder_seq, cfg.d_model),
                                        bf16)}
        if cfg.family == "vlm":
            return {"tokens": sds((B, S - cfg.num_patches), i32),
                    "patch_embeds": sds((B, cfg.num_patches, cfg.d_model),
                                        bf16)}
        return {"tokens": sds((B, S), i32)}
    # decode: one new token; the KV/state cache is a separate argument
    return {"tokens": sds((B, 1), i32)}


def _spec_fns(cfg: ModelConfig):
    def input_specs(shape: ShapeSpec):
        return _token_specs(_effective_cfg(cfg, shape), shape)

    def cache_specs(shape: ShapeSpec):
        ecfg = _effective_cfg(cfg, shape)
        init_fn = (whisper.init_cache if ecfg.family == "audio"
                   else transformer.init_cache)
        return init_fn(ecfg, shape.global_batch, shape.seq_len,
                       device="meta")

    return input_specs, cache_specs


def build_for_cell(cfg: ModelConfig, shape: ShapeSpec, rt=None) -> ModelApi:
    """Model with per-cell config adjustments applied (see
    :func:`_effective_cfg`)."""
    return build(_effective_cfg(cfg, shape), rt=rt)


def build(cfg: ModelConfig, *, rt=None) -> ModelApi:
    """The model API of ``cfg``; under ``rt`` (a
    ``transformer.Runtime``) its functions run on this rank's shard, the
    audio model's too (``whisper.prefill``/``decode_step`` take ``rt``),
    and ``local_cfg`` is what this rank's caches hold."""
    mesh = None if rt is None else rt.mesh
    local = sharding.local_cfg(cfg, mesh, rt is not None and rt.kv_seq)
    tp = None if rt is None else rt.tp
    specs = _spec_fns(cfg)
    if cfg.family == "audio":
        def prefill_fn(params, batch, *, max_seq=None):
            return whisper.prefill(
                cfg, params, batch["tokens"], batch["frame_embeds"],
                max_seq=max_seq or batch["tokens"].shape[1],
                last_pos=batch.get("last_pos"),
                true_len=batch.get("true_len"), rt=rt)

        def decode_fn(params, cache, tokens):
            return whisper.decode_step(cfg, params, cache, tokens, rt=rt)

        def loss_fn(params, batch):
            return whisper.loss_fn(cfg, params, batch, rt=rt)

        return ModelApi(cfg=cfg, prefill=prefill_fn, decode=decode_fn,
                        decode_chunk=make_decode_chunk(decode_fn),
                        loss=loss_fn, local_cfg=local, tp=tp, mesh=mesh,
                        input_specs=specs[0], cache_specs=specs[1])

    def prefill_fn(params, batch, *, max_seq=None):
        S = batch["tokens"].shape[1]
        last_pos, true_len = batch.get("last_pos"), batch.get("true_len")
        patches = batch.get("patch_embeds") if cfg.family == "vlm" else None
        if patches is not None:
            n_patch = patches.shape[1]
            S += n_patch
            # token-indexed positions shift past the patch prefix
            if last_pos is not None:
                last_pos = last_pos + n_patch
            if true_len is not None:
                true_len = true_len + n_patch
        return transformer.prefill(
            cfg, params, batch["tokens"], max_seq=max_seq or S,
            last_pos=last_pos, true_len=true_len, patch_embeds=patches,
            rt=rt)

    suffix_fn = paged_fns = None
    if paged.paged_supported(cfg):
        def suffix_fn(params, batch, *, max_seq=None):
            S = batch["tokens"].shape[1]
            return transformer.prefill_suffix(
                cfg, params, batch["tokens"], batch["prefix_kv"],
                batch["prefix_len"], max_seq=max_seq or S,
                last_pos=batch.get("last_pos"),
                true_len=batch.get("true_len"), rt=rt)

        def paged_fns(page_size: int, backend: str = "auto"):
            if sharding.kv_seq(local):
                raise NotImplementedError(
                    f"{cfg.name}: the paged decode step splits its pages by "
                    f"KV heads, not by sequence; the kv_seq cache this "
                    f"runtime lays out is dense only (paged=False; ROADMAP "
                    f"C.4)")

            def step_fn(params, cache, tokens):
                return paged.decode_step_paged(
                    cfg, params, cache, tokens, page_size=page_size,
                    backend=backend, rt=rt)
            return step_fn, make_decode_chunk(step_fn)

    def decode_fn(params, cache, tokens):
        return transformer.decode_step(cfg, params, cache, tokens, rt=rt)

    def loss_fn(params, batch):
        return transformer.loss_fn(cfg, params, batch, rt=rt)

    return ModelApi(cfg=cfg, prefill=prefill_fn,
                    prefill_suffix=suffix_fn, paged_decode_fns=paged_fns,
                    decode=decode_fn,
                    decode_chunk=make_decode_chunk(decode_fn), loss=loss_fn,
                    local_cfg=local, tp=tp, mesh=mesh,
                    input_specs=specs[0], cache_specs=specs[1])
