"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d6144 48H (kv=8)
d_ff 16384, vocab 92553; InternViT frontend is a STUB (input_specs provides
256 precomputed patch embeddings per image). [arXiv:2404.16821; hf]

This is the closest arch analog of the paper's technique: vision-token
compute routing by edge score (models/lm/ffn.py dynamic_width_ffn)."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    frontend="vision", n_frontend_tokens=256, act="silu", rope_theta=1e6,
)

SMOKE = LMConfig(
    name="internvl2-26b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    frontend="vision", n_frontend_tokens=8, act="silu", attn_chunk=32,
)
