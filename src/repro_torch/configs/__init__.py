"""Architecture config registry: ``get_config(arch)`` / ``get_reduced(arch)``.

Only the paper's own LLaMA-30B is registered in the port so far; the other
architectures of ``repro.configs`` arrive with their model families.
"""
from __future__ import annotations

from repro_torch.configs import llama_30b
from repro_torch.configs.base import ModelConfig, ShapeSpec

_MODULES = {
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
