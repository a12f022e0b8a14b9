"""Analytic per-cell cost model: FLOPs + HBM bytes (twin of
``repro.launch.costmodel``, its coefficients verbatim: they describe the
model, not the card).

FLOPs are closed forms over ``LMConfig``: the layers' matmuls (train: x4,
forward, backward and the remat re-forward; the head x3, not rematted),
the causal attention at the average context, the SSM scans as elementwise
work. The reference cross-checks them against XLA's cost analysis; the port
against ``torch.utils.flop_counter.FlopCounterMode`` (tests/test_torch_lm_train.py).
HBM bytes are analytic only, with the coefficients documented inline.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig, ShapeSpec, param_count_estimate

BF16 = 2
F32 = 4

# train matmul multiplier: fwd(1) + bwd(2) + remat re-forward(1)
TRAIN_MATMUL_X = 4.0
HEAD_MATMUL_X = 3.0          # logits head is not rematted


def _attn_flops_per_tok(cfg: LMConfig, ctx: float) -> float:
    """Projections + score/out matmuls at average context ``ctx``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, g = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        proj = 2 * (d * qr + qr * h * (dn + dr) + d * (kr + dr)
                    + kr * h * (dn + dv) + h * dv * d)
        attn = 2 * ctx * h * (dn + dr) + 2 * ctx * h * dv
        return proj + attn
    proj = 2 * d * hd * (h + 2 * g) + 2 * h * hd * d
    attn = 2 * ctx * h * hd * 2
    return proj + attn


def _ffn_flops_per_tok(cfg: LMConfig) -> float:
    d = cfg.d_model
    if cfg.n_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        router = 2 * d * cfg.n_experts
        routed = cfg.n_experts_per_tok * cfg.capacity_factor * 3 * 2 * d * f
        shared = cfg.n_shared_experts * 3 * 2 * d * f
        return router + routed + shared
    mats = 2 if cfg.act == "relu2" else 3
    return mats * 2 * d * cfg.d_ff


def _ssm_flops_per_tok(cfg: LMConfig) -> float:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    if cfg.family == "ssm":
        r = cfg.dt_rank
        proj = 2 * d * 2 * di + 2 * cfg.ssm_conv * di + 2 * di * (r + 2 * n) + 2 * r * di
        scan = 8.0 * di * n                     # exp/mul/add elementwise recurrence
        out = 2 * di * n + 2 * di * d
        return proj + scan + out
    heads = di // cfg.ssm_head_dim
    proj = 2 * d * (2 * di + 2 * n + heads) + 2 * cfg.ssm_conv * (di + 2 * n)
    scan = 8.0 * di * n
    out = 2 * di * n + 2 * di * d
    return proj + scan + out


def _layer_flops_per_tok(cfg: LMConfig, ctx: float) -> float:
    if cfg.family == "ssm":
        return _ssm_flops_per_tok(cfg)
    if cfg.family == "hybrid":
        per = _ssm_flops_per_tok(cfg)
        if cfg.shared_attn_every:
            shared = (_attn_flops_per_tok(cfg, ctx) + 3 * 2 * cfg.d_model * cfg.d_ff)
            per += shared / cfg.shared_attn_every
        return per
    return _attn_flops_per_tok(cfg, ctx) + _ffn_flops_per_tok(cfg)


@dataclasses.dataclass
class CellCost:
    flops_global: float
    hbm_bytes_global: float
    notes: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


def cell_cost(cfg: LMConfig, shape: ShapeSpec, n_chips: int) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    d, v = cfg.d_model, cfg.vocab_padded
    n_params = param_count_estimate(cfg)
    kind = shape.kind

    if kind in ("train", "prefill"):
        tokens = b * s
        ctx = s / 2.0                            # causal average context
        enc_tokens = tokens if cfg.is_encoder_decoder else 0
        layer = _layer_flops_per_tok(cfg, ctx) * cfg.n_layers * tokens
        if cfg.is_encoder_decoder:               # bidirectional enc + cross attn
            enc_layer = (_attn_flops_per_tok(cfg, s) + 3 * 2 * d * cfg.d_ff)
            layer += enc_layer * cfg.n_encoder_layers * enc_tokens
            layer += 2 * s * cfg.n_heads * cfg.resolved_head_dim * 2 * cfg.n_layers * tokens  # cross
        head = 2.0 * d * v * tokens
        if kind == "train":
            flops = TRAIN_MATMUL_X * layer + HEAD_MATMUL_X * head
            if cfg.mtp:
                flops += TRAIN_MATMUL_X * _layer_flops_per_tok(cfg, ctx) * tokens \
                         + HEAD_MATMUL_X * head / 1.0
        else:
            flops = layer + head
    else:                                        # decode: 1 token per sequence
        tokens = b
        ctx = s                                  # full cache attended
        layer = _layer_flops_per_tok(cfg, ctx if cfg.has_attention else 0) * cfg.n_layers * tokens
        head = 2.0 * d * v * tokens
        flops = layer + head

    # ---------------- HBM bytes (documented coefficients) -----------------
    p_bytes = n_params * BF16
    if kind == "train":
        # weights: 3 reads (fwd/bwd/remat) + grad w+r + adam m,v r+w (f32) + update
        weight_traffic = 3 * p_bytes + 2 * p_bytes + 4 * n_params * F32 + p_bytes
        act_per_tok_layer = BF16 * (8 * d + 4 * _ffn_width(cfg) + 4 * _attn_width(cfg))
        act_traffic = 3 * act_per_tok_layer * cfg.n_layers * tokens   # fwd+bwd+remat
        ce_traffic = 2.0 * tokens * (v / max(1, _mp_guess(n_chips))) * F32 * _mp_guess(n_chips)
        hbm = weight_traffic + act_traffic + ce_traffic
    elif kind == "prefill":
        act_per_tok_layer = BF16 * (6 * d + 2 * _ffn_width(cfg) + 2 * _attn_width(cfg))
        hbm = p_bytes + act_per_tok_layer * cfg.n_layers * tokens + _cache_bytes(cfg, b, s)
    else:
        hbm = p_bytes + _cache_bytes(cfg, b, s) + BF16 * 12 * d * cfg.n_layers * tokens
    return CellCost(flops_global=float(flops), hbm_bytes_global=float(hbm))


def _ffn_width(cfg: LMConfig) -> float:
    if cfg.n_experts:
        return (cfg.n_experts_per_tok * cfg.capacity_factor + cfg.n_shared_experts) \
            * (cfg.moe_d_ff or cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
        return 2 * cfg.d_inner
    return cfg.d_ff


def _attn_width(cfg: LMConfig) -> float:
    if not cfg.has_attention:
        return 0.0
    return cfg.n_heads * cfg.resolved_head_dim


def _mp_guess(n_chips: int) -> int:
    return 16


def _cache_bytes(cfg: LMConfig, b: int, s: int) -> float:
    """Total KV/state cache bytes (read once per decode step)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return F32 * b * L * cfg.d_inner * cfg.ssm_state
    if cfg.family == "hybrid":
        heads = cfg.d_inner // cfg.ssm_head_dim
        ssm = F32 * b * L * heads * cfg.ssm_head_dim * cfg.ssm_state
        n_inv = L // cfg.shared_attn_every if cfg.shared_attn_every else 0
        kv = BF16 * 2 * b * n_inv * s * cfg.n_kv_heads * cfg.resolved_head_dim
        return ssm + kv
    if cfg.use_mla:
        return BF16 * b * L * s * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return BF16 * 2 * b * L * s * cfg.n_kv_heads * cfg.resolved_head_dim
