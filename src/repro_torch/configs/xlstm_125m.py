"""xlstm-125m [ssm] — 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (no separate FFN; blocks carry their own up/down
projections). Ratio ~ xLSTM[7:1]: sLSTM on layers l % 6 == 1 (2 of 12),
mLSTM elsewhere. Fully recurrent decode state -> long_500k runnable.
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,                      # blocks have internal projections
    vocab_size=50304,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=0.0,
    xlstm_slstm_every=6,
    xlstm_slstm_offset=1,
    xlstm_chunk=64,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, vocab_size=256,
        xlstm_slstm_every=2, xlstm_slstm_offset=1, xlstm_chunk=8,
        vocab_chunk=32, remat=False)
