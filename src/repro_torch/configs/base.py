"""Config system: LM architecture configs + input-shape cells.

The port's own copy of ``repro.configs.base``, field for field (the port
imports nothing of ``repro``). Every architecture gets one frozen
``LMConfig`` (its published numbers) plus a ``SMOKE`` reduced config of the
same family for CPU tests. Shape cells (train_4k / prefill_32k / decode_32k
/ long_500k) are ``ShapeSpec``s; (arch x shape) validity is computed here
(long_500k only for sub-quadratic archs).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0               # expert hidden size (deepseek: 2048)
    moe_mode: str = "expert_tp"     # expert_tp | ep_alltoall
    capacity_factor: float = 1.25
    # implementation knobs of the reference's dry run (baseline False/einsum/
    # scan/False; launch/dryrun.py apply_opts)
    moe_dispatch_token_shard: bool = False   # shard dispatch capacity over dp
    moe_impl: str = "einsum"                # einsum | shard_map (explicit EP)
    mamba2_impl: str = "scan"               # scan | ssd (block-matmul form)
    mla_lazy_kv: bool = False               # D4 (refuted) lazy K/V expansion

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False               # multi-token-prediction extra head

    # --- SSM (mamba1/2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64          # mamba2
    ssm_dt_rank: int = 0            # mamba1; 0 -> ceil(d_model/16)
    ssm_chunk: int = 128            # chunked-scan length

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0      # apply the weight-shared attn block every N layers

    # --- enc-dec (seamless) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontend stubs ([audio]/[vlm]: backbone only) ---
    frontend: Optional[str] = None  # vision | audio
    n_frontend_tokens: int = 256

    # --- misc ---
    qkv_bias: bool = False
    act: str = "silu"               # silu | gelu | relu2
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 512           # blockwise-attention kv-chunk
    dynamic_width: bool = False     # ESSR-style width-selective FFN (core/dynamic_width)

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 so the embedding/logits dims
        shard evenly on any mesh axis (MaxText-style logical vocab padding;
        labels never index the pad rows)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 and self.family != "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch hold a 512K context? (ssm / hybrid-with-O(1)-mixer)"""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: LMConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason). long_500k is skipped for pure full-attention archs
    (assignment rule; the 512K KV build is quadratic and the cache is 10s of
    GB/sample) — an explicit skip row."""
    if shape is LONG_500K and not cfg.subquadratic:
        return False, "skip: full-attention arch at 512K context (quadratic prefill)"
    return True, "ok"


def param_count_estimate(cfg: LMConfig) -> int:
    """Closed-form parameter estimate (embeddings + layers), used in the
    roofline MODEL_FLOPS term and dry-run sanity checks."""
    d, v = cfg.d_model, cfg.vocab_size
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        hd = cfg.resolved_head_dim
        if cfg.use_mla:
            attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                    (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + cfg.n_heads * cfg.v_head_dim * d)
        else:
            attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        if cfg.n_experts:
            f = cfg.moe_d_ff or cfg.d_ff
            ffn = cfg.n_experts * 3 * d * f + cfg.n_shared_experts * 3 * d * f + d * cfg.n_experts
        else:
            ffn = 3 * d * cfg.d_ff if cfg.act != "relu2" else 2 * d * cfg.d_ff
        per_layer = attn + ffn
    if cfg.family == "ssm":
        di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        per_layer = d * 2 * di + cfg.ssm_conv * di + di * (r + 2 * n) + r * di + di * n + di + di * d
    if cfg.family == "hybrid":
        di, n = cfg.d_inner, cfg.ssm_state
        heads = di // cfg.ssm_head_dim
        mamba2 = d * (2 * di + 2 * n * 1 + heads) + cfg.ssm_conv * (di + 2 * n) + di + di * d
        per_layer = mamba2
        # one shared attn+mlp block reused across the stack
        hd = cfg.resolved_head_dim
        shared = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
        emb += shared
    n_layers = cfg.n_layers + (cfg.n_encoder_layers if cfg.is_encoder_decoder else 0)
    return emb + n_layers * per_layer


def active_param_count_estimate(cfg: LMConfig) -> int:
    """Active (per-token) params — MoE counts only routed+shared experts."""
    if not cfg.n_experts:
        return param_count_estimate(cfg)
    full = param_count_estimate(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    d = cfg.d_model
    inactive = (cfg.n_experts - cfg.n_experts_per_tok) * 3 * d * f * cfg.n_layers
    return full - inactive
