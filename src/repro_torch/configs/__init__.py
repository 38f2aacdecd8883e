"""Architecture config registry: ``get_config(arch)`` / ``get_reduced(arch)``.

Every architecture of ``repro.configs``: the paper's own LLaMA-30B, the
reference's other plain dense stacks (stablelm-3b, gemma-2b,
h2o-danube-3-4b, command-r-35b), its MoE stacks (qwen3-moe-235b-a22b,
llama4-maverick-400b-a17b), its VLM (llava-next-mistral-7b), the hybrid
jamba-v0.1-52b, the xLSTM xlstm-125m and the encoder-decoder
whisper-base, in the reference's order. ``all_cells`` lists the dry-run's
(arch, shape) cells (``launch/dryrun.py``), as the reference's does.
"""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, gemma_2b, h2o_danube_3_4b,
                                 jamba_v01_52b, llama4_maverick_400b_a17b,
                                 llama_30b, llava_next_mistral_7b,
                                 qwen3_moe_235b_a22b, stablelm_3b,
                                 whisper_base, xlstm_125m)
from repro_torch.configs.base import (LONG_500K, DECODE_32K, PREFILL_32K,
                                      SHAPES, TRAIN_4K, ModelConfig,
                                      ShapeSpec)

_MODULES = {
    "stablelm-3b": stablelm_3b,
    "gemma-2b": gemma_2b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "command-r-35b": command_r_35b,
    "whisper-base": whisper_base,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "jamba-v0.1-52b": jamba_v01_52b,
    "xlstm-125m": xlstm_125m,
    "llama-30b": llama_30b,
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "llama-30b")
ALL_ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].reduced()


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells():
    """Every runnable (arch, shape) dry-run cell, plus documented skips."""
    runnable, skipped = [], []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name in cfg.shape_cells():
                runnable.append((arch, shape.name))
            else:
                skipped.append((arch, shape.name,
                                "long_500k requires sub-quadratic attention; "
                                f"{arch} is pure full-attention"))
    return runnable, skipped


__all__ = [
    "ModelConfig", "ShapeSpec", "SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "ASSIGNED_ARCHS", "ALL_ARCHS",
    "get_config", "get_reduced", "get_shape", "all_cells",
]
