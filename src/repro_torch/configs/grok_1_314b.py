"""grok-1-314b [moe] — 64L d6144 48H (GQA kv=8) d_ff=32768, MoE 8e top-2,
vocab 131072. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, n_experts_per_tok=2, moe_d_ff=32768,
    moe_mode="expert_tp",          # E=8 < mesh model=16: TP inside experts
    act="gelu", rope_theta=1e4,
)

SMOKE = LMConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    n_experts=4, n_experts_per_tok=2, moe_d_ff=128, moe_mode="expert_tp",
    act="gelu", attn_chunk=32, ssm_chunk=16,
)
