"""llama-30b — the paper's own serving model (ThunderServe §5.1 deploys
LLaMA-30B on the heterogeneous cloud). 60L d_model=6656 52H MHA d_ff=17920
vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-30b",
    family="dense",
    num_layers=60,
    d_model=6656,
    num_heads=52,
    num_kv_heads=52,
    head_dim=128,
    d_ff=17920,
    vocab_size=32000,
    mlp_type="silu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama-30b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
