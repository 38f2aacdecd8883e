"""The benchmark's files, found by name, and the model a configuration file
describes.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``configs/<config>.json``, ``traffic/<mix>.json``,
``cells/<cell>.json`` (the cell's offered rate and run settings),
``metrics/<metric>.py`` and ``ops/<op>.json``. A later cell, mix, metric
or kernel is an added file, never an edit.

A configuration file holds the model as it is run, under the published
config's own keys (``model``), and how to serve it (``serve``).
:func:`port_config` builds the port's ``ModelConfig`` from those keys and
:func:`check_port_config` holds the port's config to the file, so the
program runs what the file states.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
from typing import Dict, List, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[1]        # perfbench/
REPO = ROOT.parent


def manifest(path=None) -> dict:
    return json.loads(pathlib.Path(path or REPO / "BENCHMARK.json")
                      .read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell_settings(name: str) -> dict:
    return _json("cells", name)


def op_patterns(name: str) -> List[str]:
    return _json("ops", name)["kernels"]


def op_names() -> List[str]:
    return sorted(p.stem for p in (ROOT / "ops").glob("*.json"))


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config_name: str):
    """``reference/<config>.py``: the configuration's plain model."""
    path = ROOT / "reference" / f"{config_name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_" + config_name.replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(manifest_: dict, name: str) -> dict:
    for w in manifest_["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(manifest_: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones,
    each kept where its ``workloads`` key names the cell or is absent."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest_[key]
            if "workloads" not in m or cell in m["workloads"]]


# -- the model a configuration file states ------------------------------------

def model_keys(cfg_file: dict, rehearse: bool = False) -> dict:
    """The published keys as run; the CPU rehearsal's small sizes laid
    over them where ``rehearse``."""
    m = dict(cfg_file["model"])
    if rehearse:
        m.update(cfg_file["rehearsal"]["model"])
    return m


def head_dim(m: dict) -> int:
    return int(m.get("head_dim")
               or m["hidden_size"] // m["num_attention_heads"])


def layer_kinds(m: dict) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer: ``attn`` or ``mamba``; ``mlp`` or
    ``moe`` (Jamba's attention and expert periods and offsets)."""
    out = []
    for i in range(int(m["num_hidden_layers"])):
        mix = "attn"
        if "attn_layer_period" in m:
            mix = "attn" if i % m["attn_layer_period"] == \
                m["attn_layer_offset"] else "mamba"
        ffn = "mlp"
        if m.get("num_experts", 0):
            ffn = "moe" if i % m["expert_layer_period"] == \
                m["expert_layer_offset"] else "mlp"
        out.append((mix, ffn))
    return out


def parallel_block(m: dict) -> bool:
    return m.get("model_type") == "cohere"


def layernorm(m: dict) -> bool:
    return m.get("model_type") == "cohere"


def mamba_dims(m: dict) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    di = int(m["mamba_expand"]) * int(m["hidden_size"])
    dtr = int(m.get("mamba_dt_rank") or math.ceil(m["hidden_size"] / 16))
    return di, int(m["mamba_d_state"]), int(m["mamba_d_conv"]), dtr


# published key -> the port's ModelConfig field
_PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "num_experts": "moe_num_experts", "num_experts_per_tok": "moe_top_k",
    "expert_layer_period": "moe_every", "expert_layer_offset": "moe_offset",
    "attn_layer_period": "attn_period", "attn_layer_offset": "attn_offset",
    "mamba_d_state": "mamba_d_state", "mamba_d_conv": "mamba_d_conv",
    "mamba_expand": "mamba_expand", "mamba_dt_rank": "mamba_dt_rank",
    "expert_capacity_factor": "moe_capacity_factor",
}


def port_config(cfg_file: dict, rehearse: bool = False):
    """The port's ``ModelConfig``: its registered config of the same model
    with every size the file states."""
    from repro_torch.configs import get_config
    m = model_keys(cfg_file, rehearse)
    kw = {f: m[k] for k, f in _PORT_FIELDS.items() if k in m}
    kw["head_dim"] = head_dim(m)
    kw["rope_theta"] = float(m.get("rope_theta") or 0.0)
    if "num_experts" in m:
        kw["moe_d_ff"] = m["intermediate_size"]
    if rehearse:
        kw["name"] = cfg_file["port_config"] + "-rehearsal"
    return get_config(cfg_file["port_config"]).replace(**kw)


def check_port_config(cfg_file: dict, pc, rehearse: bool = False):
    """Raise unless the port's config runs the model the file states."""
    m = model_keys(cfg_file, rehearse)
    want = [(mix + "+" + ffn) for mix, ffn in layer_kinds(m)]
    bad = []
    if list(pc.layer_kinds()) != want:
        bad.append(f"layer kinds {pc.layer_kinds()} != {want}")
    if pc.parallel_block != parallel_block(m):
        bad.append("parallel block")
    if (pc.norm_type == "layernorm") != layernorm(m):
        bad.append("norm type")
    if pc.tie_embeddings != bool(m.get("tie_word_embeddings")):
        bad.append("tied embeddings")
    if pc.mlp_type != "silu" or pc.qk_norm or pc.attn_bias or pc.mlp_bias \
            or pc.sliding_window or pc.attn_logit_softcap \
            or pc.embed_scale or pc.rotary_pct != 1.0:
        bad.append("a block option the file does not state")
    if pc.dtype != m["torch_dtype"]:
        bad.append(f"dtype {pc.dtype}")
    if bad:
        raise ValueError(f"{cfg_file['name']}: the port's config departs "
                         f"from the file: {bad}")


def files_by_name(manifest_: dict) -> Dict[str, pathlib.Path]:
    """Every file ``BENCHMARK.json`` reaches by a name."""
    out = {}
    for c in manifest_["configs"]:
        out[f"configs/{c['name']}"] = REPO / c["file"]
        out[f"reference/{c['name']}"] = ROOT / "reference" / f"{c['name']}.py"
    for w in manifest_["workloads"]:
        out[f"traffic/{w['traffic']}"] = ROOT / "traffic" / \
            f"{w['traffic']}.json"
        out[f"cells/{w['name']}"] = ROOT / "cells" / f"{w['name']}.json"
    for m in manifest_["end_to_end"] + manifest_["per_layer"]:
        out[f"metrics/{m['name']}"] = ROOT / "metrics" / f"{m['name']}.py"
    for op in op_names():
        out[f"ops/{op}"] = ROOT / "ops" / f"{op}.json"
    return out
