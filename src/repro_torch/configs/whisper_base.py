"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.

Encoder-decoder; conv frontend is a STUB — input_specs() provides precomputed
frame embeddings (1500 frames, d_model). Decoder: causal self-attn + cross-attn.
The assigned seq_len applies to the DECODER token stream (the transformer
backbone under test); the encoder length is the fixed 1500-frame stub.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,               # decoder layers
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    attn_bias=True,
    mlp_bias=True,
    is_encoder_decoder=True,
    encoder_seq=1500,
    rope_theta=0.0,             # whisper uses learned/sinusoidal abs positions
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-base-smoke", num_layers=2, num_encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, encoder_seq=24, attn_chunk_q=16, attn_chunk_kv=16,
        vocab_chunk=32, remat=False)
