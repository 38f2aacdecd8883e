"""Models of the port: dense layers, the transformer, the paged decode
format, the model API and the converter from the JAX package's weights."""
from repro_torch.models.registry import ModelApi, build

__all__ = ["ModelApi", "build"]
