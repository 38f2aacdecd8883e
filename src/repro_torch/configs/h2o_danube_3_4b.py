"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.

LLaMA+Mistral mix with sliding-window attention (window 4096) -> sub-quadratic,
so the long_500k cell runs for this arch. [arXiv:2401.16818; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="silu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
    sliding_window=4096,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="h2o-danube-3-4b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=32, attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32,
        remat=False)
