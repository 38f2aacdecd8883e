"""Model/shape configuration: the port's own copy of ``repro.configs.base``.

The dataclass is stdlib-only and the JAX package's, so a config built
here describes the same model there; the port keeps a copy instead of
importing it (``tests/test_torch_isolation.py`` checks that the two stay
equal). It adds two block options the JAX package lacks (ROADMAP C.4),
whose defaults are the JAX package's behaviour: ``moe_renormalize``
(True: the top-k gates renormalised to sum to 1; jamba turns it off) and
``mamba_inner_norms`` (False; jamba turns on the published mixer's
unit-gain RMSNorms of the time-step input, B and C). ``reduced()`` returns a small
same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned): every (arch x shape) cell is defined by one of these.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

_KINDS_CACHE: dict = {}
_COUNT_CACHE: dict = {}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # Block style
    mlp_type: str = "silu"          # silu (SwiGLU) | geglu | gelu
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    parallel_block: bool = False     # parallel attn+FFN residual (command-r)
    qk_norm: bool = False            # per-head RMSNorm on q,k (qwen3)
    attn_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # fraction of head_dim rotated
    sliding_window: int = 0          # 0 -> full attention
    attn_logit_softcap: float = 0.0
    embed_scale: bool = False        # scale embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1               # MoE replaces FFN on layers l % moe_every == moe_offset
    moe_offset: int = 0
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    moe_shared_expert: bool = False  # llama4-style shared expert
    moe_capacity_factor: float = 1.25
    moe_renormalize: bool = True     # top-k gates renormalised to sum to 1

    # Hybrid (jamba): attention on layers l % attn_period == attn_offset, Mamba elsewhere
    attn_period: int = 0
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    mamba_inner_norms: bool = False  # unit-gain RMSNorms of dt, B, C (jamba)

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)

    # VLM (llava): precomputed patch embeddings prepended to text tokens
    num_patches: int = 0

    # xLSTM
    xlstm_slstm_every: int = 0       # sLSTM on layers l % every == offset; 0 -> none
    xlstm_slstm_offset: int = 1
    xlstm_chunk: int = 64            # mLSTM chunkwise parallel chunk size

    # numerics / runtime
    dtype: str = "bfloat16"
    decode_cache_layout: str = "s_hkv"  # "s_hkv"=(B,S,Hkv,hd) | "hkv_s"=
    #   (B,Hkv,S,hd) flash-decode layout: contraction-innermost, no transpose
    remat: bool = True
    attn_chunk_q: int = 512          # blocked-attention tile sizes (jnp path)
    attn_chunk_kv: int = 1024
    vocab_chunk: int = 2048          # sequence chunk for chunked xent
    scan_layers: bool = True
    use_pallas: bool = False         # TPU runtime path; dry-run/CPU uses jnp path

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank", -(-self.d_model // 16))

    # -- derived quantities -------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def is_attn_layer(self, l: int) -> bool:
        """Hybrid interleave: which layers are attention (vs Mamba)."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return l % self.attn_period == self.attn_offset

    def is_moe_layer(self, l: int) -> bool:
        if not self.moe_num_experts:
            return False
        return l % self.moe_every == self.moe_offset

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string, e.g. ('attn+moe', 'mamba+mlp', ...).
        Cached: hot in the scheduler's cost-model inner loop."""
        cached = _KINDS_CACHE.get(self)
        if cached is not None:
            return cached
        kinds = []
        for l in range(self.num_layers):
            if self.family == "ssm":
                mix = "slstm" if (self.xlstm_slstm_every and
                                  l % self.xlstm_slstm_every == self.xlstm_slstm_offset) else "mlstm"
            elif self.family == "hybrid" and not self.is_attn_layer(l):
                mix = "mamba"
            else:
                mix = "attn"
            ffn = "moe" if self.is_moe_layer(l) else ("mlp" if self.d_ff else "none")
            kinds.append(f"{mix}+{ffn}")
        _KINDS_CACHE[self] = tuple(kinds)
        return _KINDS_CACHE[self]

    def param_count(self) -> int:
        """Total parameter count (analytic). Cached."""
        hit = _COUNT_CACHE.get((self, "total"))
        if hit is not None:
            return hit
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for l in range(self.num_layers):
            kind = self.layer_kinds()[l]
            if "attn" in kind:
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif "mamba" in kind:
                di, ds, dtr = self.mamba_d_inner, self.mamba_d_state, self.mamba_dt_rank
                n += d * 2 * di + di * self.mamba_d_conv + di * (dtr + 2 * ds)
                n += dtr * di + di * ds + di + di * d
            elif "slstm" in kind or "mlstm" in kind:
                di = 2 * d
                n += d * di * 2 + di * 3 * (di // 4 if "mlstm" in kind else 1)
                n += di * d
            if "moe" in kind:
                gate_mult = 3 if self.mlp_type in ("silu", "geglu") else 2
                n += d * self.moe_num_experts  # router
                n_exp = self.moe_num_experts + (1 if self.moe_shared_expert else 0)
                n += n_exp * gate_mult * d * self.moe_d_ff
            elif "mlp" in kind:
                gate_mult = 3 if self.mlp_type in ("silu", "geglu") else 2
                n += gate_mult * d * self.d_ff
            n += 2 * d  # norms
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d  # self
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d  # cross (decoder side counted here)
                gate_mult = 3 if self.mlp_type in ("silu", "geglu") else 2
                n += gate_mult * d * self.d_ff + 2 * d
        _COUNT_CACHE[(self, "total")] = n
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts). Cached."""
        if not self.moe_num_experts:
            return self.param_count()
        hit = _COUNT_CACHE.get((self, "active"))
        if hit is not None:
            return hit
        n = self.param_count()
        gate_mult = 3 if self.mlp_type in ("silu", "geglu") else 2
        per_expert = gate_mult * self.d_model * self.moe_d_ff
        n_moe_layers = sum(self.is_moe_layer(l) for l in range(self.num_layers))
        inactive = n_moe_layers * (self.moe_num_experts - self.moe_top_k) * per_expert
        _COUNT_CACHE[(self, "active")] = n - inactive
        return n - inactive

    def supports_long_context(self) -> bool:
        """Sub-quadratic attention / bounded state -> long_500k runnable."""
        return (self.family in ("ssm", "hybrid")) or self.sliding_window > 0

    def shape_cells(self) -> Tuple[str, ...]:
        cells = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context():
            cells.append("long_500k")
        return tuple(cells)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
