"""deepseek-v3-671b [moe] — 61L d7168 128H, MLA, d_ff(expert)=2048,
1 shared + 256 routed top-8, MTP, vocab 129280. [arXiv:2412.19437; hf]

MLA dims from the tech report: q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v_head 128. Decode runs in absorbed-latent form (the cache is
(B, S, 512+64) — constant in head count).
"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab_size=129280,
    n_experts=256, n_experts_per_tok=8, n_shared_experts=1, moe_d_ff=2048,
    moe_mode="ep_alltoall",        # E=256: experts sharded over 'model'
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp=True, act="silu",
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=512,
    n_experts=8, n_experts_per_tok=2, n_shared_experts=1, moe_d_ff=96,
    moe_mode="ep_alltoall",
    use_mla=True, q_lora_rank=48, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    mtp=True, act="silu", attn_chunk=32,
)
