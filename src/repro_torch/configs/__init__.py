"""Architecture config registry: ``get_config(arch)`` / ``get_reduced(arch)``.

Every architecture of ``repro.configs``: the paper's own LLaMA-30B, the
reference's other plain dense stacks (stablelm-3b, gemma-2b,
h2o-danube-3-4b, command-r-35b), its MoE stacks (qwen3-moe-235b-a22b,
llama4-maverick-400b-a17b), its VLM (llava-next-mistral-7b), the hybrid
jamba-v0.1-52b, the xLSTM xlstm-125m and the encoder-decoder
whisper-base, in the reference's order.
"""
from __future__ import annotations

from repro_torch.configs import (command_r_35b, gemma_2b, h2o_danube_3_4b,
                                 jamba_v01_52b, llama4_maverick_400b_a17b,
                                 llama_30b, llava_next_mistral_7b,
                                 qwen3_moe_235b_a22b, stablelm_3b,
                                 whisper_base, xlstm_125m)
from repro_torch.configs.base import ModelConfig, ShapeSpec

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

ALL_ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].reduced()


__all__ = ["ModelConfig", "ShapeSpec", "ALL_ARCHS", "get_config",
           "get_reduced"]
