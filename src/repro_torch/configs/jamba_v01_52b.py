"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 (every other layer), Mamba+attention 1:7
interleave (attention on layers l % 8 == 4, Mamba elsewhere).
Mamba layers keep O(1) decode state -> long_500k runnable; its 4 attention
layers use a sliding-window fallback (4096) for the long_500k cell, noted
in DESIGN.md. [arXiv:2403.19887; hf]

The port runs the published block where the JAX package departs from it
(ROADMAP C.4): the Mamba mixer's unit-gain RMSNorms of the time-step
input, B and C after ``x_proj``; the top 2 of the softmax over all 16
experts as gates, not renormalised; and no dropped route, at a capacity
factor of E / k = 8 (capacity is then the call's token count).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="silu",
    norm_type="rmsnorm",
    rope_theta=0.0,              # jamba uses no positional encoding
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=14336,
    attn_period=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mamba_inner_norms=True,
    moe_renormalize=False,
    moe_capacity_factor=8.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke", num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
        moe_num_experts=4, moe_top_k=2, moe_d_ff=96,
        moe_capacity_factor=2.0,             # E / k: dropless
        attn_period=4, attn_offset=2, mamba_d_state=4, mamba_d_conv=2,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
