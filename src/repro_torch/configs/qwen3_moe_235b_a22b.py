"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8, QK-norm. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                  # per-expert hidden dim
    vocab_size=151936,
    mlp_type="silu",
    norm_type="rmsnorm",
    qk_norm=True,
    rope_theta=1000000.0,
    moe_num_experts=128,
    moe_top_k=8,
    moe_every=1,
    moe_d_ff=1536,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
        moe_num_experts=8, moe_top_k=2, moe_d_ff=96,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
