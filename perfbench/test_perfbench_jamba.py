"""jamba-v0.1-52b's plain reference (``reference/jamba-v0.1-52b.py``) held
to the port at the configuration's rehearsal sizes, both in float32 on the
benchmark's weights: the prefill's logits at a prompt's last position,
then decode steps through the port's dense slotted cache (the prefill's
raw wire admitted into a decode engine, each step fed the token the
reference reads next), against the reference's logits at the same
positions. One prompt is longer than the Mamba prefill's 512-step chunk
and no multiple of it, so the state the prefill hands decode comes out of
a short last chunk.

Prefill agrees to float32 rounding (1e-5 of the largest logit). The decode
cache holds the attention layers' K/V in bfloat16 whatever the model's
type, so the decode steps carry that rounding; they are held to 2e-2, and
the same steps fed one token off (the follow tokens reversed) must miss
by more than ten times that.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from pbench import spec  # noqa: E402
from pbench.weights import Weights  # noqa: E402

torch.set_num_threads(2)
CONFIG = "jamba-v0.1-52b"
MAX_SEQ = 1024
_WEIGHTS = {}


def _setup():
    if not _WEIGHTS:
        cfg_file = spec.config(CONFIG)
        m = spec.model_keys(cfg_file, rehearse=True)
        _WEIGHTS["w"] = (cfg_file, m, Weights(m, "cpu", dtype=torch.float32)
                         .fill(4321))
    return _WEIGHTS["w"]


def _port_logits(cfg_file, params, prompt, follow):
    """The port's prefill logits for ``prompt`` through ``PrefillEngine``,
    then one decode step for each token of ``follow`` through a dense
    decode engine's cache."""
    from repro_torch.serving.engine import (AdmissionBatch, AdmissionItem,
                                            DecodeEngine, GenRequest,
                                            PrefillEngine)
    pc = spec.port_config(cfg_file, rehearse=True).replace(dtype="float32")
    pre = PrefillEngine(pc, params, max_seq=MAX_SEQ, device="cpu")
    dec = DecodeEngine(pc, params, max_slots=2, max_seq=MAX_SEQ,
                       paged=False, device="cpu")
    assert not pre.bucketed
    req = GenRequest(0, prompt.astype(np.int32), len(follow) + 1)
    with torch.no_grad():
        logits, _ = pre.api.prefill(params, {"tokens": torch.as_tensor(
            prompt[None].astype(np.int64))}, max_seq=MAX_SEQ)
        out = pre.run([req], compress=False)
    rows = [logits[0, -1]]
    dec.admit(AdmissionBatch([AdmissionItem(r, f, wire=w)
                              for r, w, f in out]))
    with torch.no_grad():
        for t in follow:
            cur = torch.tensor([[int(t)], [0]], dtype=torch.long)
            lg, cache = dec._decode(params, dec.cache, cur)
            dec.cache["lengths"][0] = cache["lengths"][0]
            rows.append(lg[0, -1])
    return torch.stack(rows)


@pytest.mark.parametrize("prompt_len", [40, 600])
def test_reference_matches_port_in_f32(prompt_len):
    cfg_file, m, params = _setup()
    ref_mod = spec.reference_module(CONFIG)
    rng = np.random.default_rng(prompt_len)
    prompt = rng.integers(1, m["vocab_size"], prompt_len).astype(np.int64)
    follow = rng.integers(1, m["vocab_size"], 6).astype(np.int64)
    got = _port_logits(cfg_file, params, prompt, follow)
    ref, off = ref_mod.logits_many(m, params, [
        (np.concatenate([prompt, follow]), prompt_len, len(follow) + 1),
        (np.concatenate([prompt, follow[::-1]]), prompt_len,
         len(follow) + 1)])
    scale = ref.abs().max()
    first = float((got[0] - ref[0]).abs().max() / scale)
    steps = float((got[1:] - ref[1:]).abs().max() / scale)
    assert first < 1e-5, f"prefill relative error {first:.3g}"
    assert steps < 2e-2, f"decode relative error {steps:.3g}"
    miss = float((got[1:] - off[1:]).abs().max() / scale)
    assert miss > 10 * 2e-2, f"tokens one off read {miss:.3g}"


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}.{k}" if path else str(k)))
    return out


@pytest.mark.parametrize("rehearse", [True, False])
def test_the_file_states_the_ports_model(rehearse):
    """The port's config of the file (as run, and at its rehearsal sizes)
    passes ``check_port_config``, runs the published block's options, and
    its parameter tree is the benchmark's weights' (shapes only at the
    full size)."""
    from repro_torch.models.transformer import init_params
    cfg_file = spec.config(CONFIG)
    m = spec.model_keys(cfg_file, rehearse)
    pc = spec.port_config(cfg_file, rehearse)
    spec.check_port_config(cfg_file, pc, rehearse)
    assert pc.mamba_inner_norms and not pc.moe_renormalize
    assert pc.moe_capacity_factor == m["num_experts"] / \
        m["num_experts_per_tok"]
    assert [k.split("+") for k in pc.layer_kinds()] == \
        [list(k) for k in spec.layer_kinds(m)]
    device = "cpu" if rehearse else "meta"
    ours = _leaves(Weights(m, device).tree)
    port = _leaves(init_params(pc, device=device))
    assert ours == port


def test_the_files_top_level_states_the_model_as_run():
    """The file's top level repeats the published keys as run, where a
    check against the source's config.json reads them, and they are the
    ``model`` block's, which the harness runs."""
    cfg_file = spec.config(CONFIG)
    m = cfg_file["model"]
    assert {k: cfg_file.get(k, "missing") for k in m} == m
    assert set(cfg_file["reduced"]) <= set(m)


def test_new_metrics_read_the_traced_window():
    """The cell's open loop at its rehearsal sizes with the program's
    tracer on: ``moe_pad_pct`` reads 87.5 (capacity the call's tokens, so
    each of the 16 experts computes every token's row and 2 of 16 hold a
    route); ``mamba_ms_per_ktok`` reads CUDA events and is None on the
    CPU. With the tracer off both read None."""
    from pbench import bench
    from repro_torch.serving import trace
    cell = CONFIG + ".coding"
    c = bench.prepare(cell, seed=23, device="cpu", rehearse=True)
    arrivals, prompts = bench.arrivals_for(c, 23, 3.0)
    bench.warm(c, arrivals, trace=False)
    read = {name: spec.metric_reader(name)
            for name in ("moe_pad_pct", "mamba_ms_per_ktok")}
    off = bench.measure(c, arrivals, prompts, seconds=0.5, trace=False)
    assert all(r(off.data) is None for r in read.values())
    c.sys.reset()
    trace.enable()
    try:
        got = bench.measure(c, arrivals, prompts, seconds=3.0, trace=True)
        assert read["moe_pad_pct"](got.data) == pytest.approx(87.5)
        assert read["mamba_ms_per_ktok"](got.data) is None
    finally:
        trace.disable()
        trace.clear()
