"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000. Mistral-7B backbone; anyres vision tower is a STUB —
input_specs() provides 576 precomputed patch embeddings prepended to the
text tokens (patch count folds into seq_len budget).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="silu",
    norm_type="rmsnorm",
    rope_theta=1000000.0,
    num_patches=576,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llava-next-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, num_patches=8,
        attn_chunk_q=16, attn_chunk_kv=16, vocab_chunk=32, remat=False)
