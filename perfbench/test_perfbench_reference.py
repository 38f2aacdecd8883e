"""The plain reference (``perfbench/reference/``) held to the port's models
at the configurations' rehearsal sizes, both in float32 on the same
weights: the prefill's logits at a prompt's last position, then decode
steps through the port's dense decode cache (the prefill's raw wire
admitted into a decode engine, each step fed the token the reference
reads next), against the reference's logits at the same positions.

Prefill agrees to float32 rounding. The decode cache holds K/V in
bfloat16 whatever the model's type, so the decode steps carry that
rounding (about 1e-3 of the largest logit here); they are held to 2e-2,
and the same steps fed one token off must miss it by far (the follow
tokens reversed).

The benchmark's weights are laid out in the port's parameter tree, for
the configuration here and for a hybrid Mamba and MoE model (the layer
kinds the port serves, which a later configuration file may name)."""
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


def _port_logits(cfg_file, params, prompt, follow, m):
    """The port's prefill logits for ``prompt``, then one decode step for
    each token of ``follow`` through a dense decode engine's cache."""
    from repro_torch.serving.engine import (AdmissionBatch, AdmissionItem,
                                            DecodeEngine, GenRequest,
                                            PrefillEngine)
    pc = spec.port_config(dict(cfg_file, rehearsal=dict(
        cfg_file["rehearsal"], model=m)), rehearse=True).replace(
        dtype="float32")
    pre = PrefillEngine(pc, params, max_seq=128, device="cpu")
    dec = DecodeEngine(pc, params, max_slots=2, max_seq=128, paged=False,
                       device="cpu")
    req = GenRequest(0, prompt.astype(np.int32), len(follow) + 1)
    api = pre.api
    with torch.no_grad():
        logits, _ = api.prefill(params, {"tokens": torch.as_tensor(
            prompt[None].astype(np.int64))}, max_seq=128)
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


def _logits(ref_mod, m, params, seq, prompt_len, n_read):
    return ref_mod.logits_many(m, params, [(seq, prompt_len, n_read)])[0]


@pytest.mark.parametrize("config,prompt_len", [("command-r-35b", 40)])
def test_reference_matches_port_in_f32(config, prompt_len):
    cfg_file = spec.config(config)
    m = spec.model_keys(cfg_file, rehearse=True)
    params = Weights(m, "cpu", dtype=torch.float32).fill(1234)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, m["vocab_size"], prompt_len).astype(np.int64)
    follow = rng.integers(1, m["vocab_size"], 6).astype(np.int64)
    got = _port_logits(cfg_file, params, prompt, follow, m)
    ref_mod = spec.reference_module(config)
    ref = _logits(ref_mod, m, params, np.concatenate([prompt, follow]),
                  prompt_len, len(follow) + 1)
    scale = ref.abs().max()
    first = float((got[0] - ref[0]).abs().max() / scale)
    steps = float((got[1:] - ref[1:]).abs().max() / scale)
    assert first < 1e-5, f"{config}: prefill relative error {first:.3g}"
    assert steps < 2e-2, f"{config}: decode relative error {steps:.3g}"
    off = _logits(ref_mod, m, params, np.concatenate([prompt, follow[::-1]]),
                  prompt_len, len(follow) + 1)
    miss = float((got[1:] - off[1:]).abs().max() / scale)
    assert miss > 10 * 2e-2, f"{config}: tokens one off read {miss:.3g}"


# a hybrid at small sizes, under the published keys of ai21labs/Jamba-v0.1
HYBRID = {
    "name": "hybrid", "port_config": "jamba-v0.1-52b",
    "model": {"model_type": "jamba", "hidden_size": 64,
              "num_hidden_layers": 8, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 96,
              "vocab_size": 512, "attn_layer_period": 4,
              "attn_layer_offset": 2, "expert_layer_period": 2,
              "expert_layer_offset": 1, "num_experts": 4,
              "num_experts_per_tok": 2, "mamba_d_state": 4,
              "mamba_d_conv": 2, "mamba_expand": 2, "mamba_dt_rank": 4,
              "tie_word_embeddings": False, "torch_dtype": "bfloat16"}}


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), tree.dtype)}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}.{k}" if path else str(k)))
    return out


@pytest.mark.parametrize("which", ["command-r-35b", "hybrid"])
def test_weights_are_laid_out_in_the_ports_tree(which):
    from repro_torch.models.transformer import init_params
    cfg_file = spec.config(which) if which != "hybrid" else HYBRID
    m = spec.model_keys(cfg_file, rehearse=which != "hybrid")
    as_run = dict(cfg_file, rehearsal={"model": m})
    pc = spec.port_config(as_run, rehearse=True)
    spec.check_port_config(as_run, pc, rehearse=True)
    if which == "hybrid":
        assert set(spec.layer_kinds(m)) == {("mamba", "mlp"),
                                            ("mamba", "moe"),
                                            ("attn", "mlp")}
    ours = _leaves(Weights(m, "cpu").tree)
    port = _leaves(init_params(pc, device="cpu"))
    assert ours == port
