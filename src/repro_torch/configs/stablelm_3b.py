"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified]. StableLM-2 family: LayerNorm,
SwiGLU MLP, partial rotary (25%), MHA (kv=32 == heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    mlp_type="silu",
    norm_type="layernorm",
    rotary_pct=0.25,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="stablelm-3b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
