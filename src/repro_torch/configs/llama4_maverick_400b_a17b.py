"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, interleaved dense/MoE
(every other layer) which lands total params ~400B / active ~17B.
Early-fusion multimodality is out of backbone scope (text path only).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="silu",
    norm_type="rmsnorm",
    rope_theta=500000.0,
    moe_num_experts=128,
    moe_top_k=1,
    moe_every=2,                 # MoE on odd layers, dense FFN on even
    moe_offset=1,
    moe_d_ff=8192,
    moe_shared_expert=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama4-maverick-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
        moe_num_experts=8, moe_top_k=1, moe_d_ff=96, moe_every=2, moe_offset=1,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
