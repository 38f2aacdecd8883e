"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

Cohere Command-R: parallel attention+FFN residual blocks, LayerNorm, no bias,
tied embeddings, logit softcap absent. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    mlp_type="silu",
    norm_type="layernorm",
    parallel_block=True,
    rope_theta=8000000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="command-r-35b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
