"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256 (q_dim 2048), MQA, embed scaling, RMSNorm.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    norm_type="rmsnorm",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-2b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
