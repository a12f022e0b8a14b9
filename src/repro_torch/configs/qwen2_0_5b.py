"""qwen2-0.5b [dense] — 24L d896 14H (GQA kv=2) d_ff 4864, vocab 151936,
QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, act="silu", rope_theta=1e6,
)

SMOKE = LMConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
    d_ff=112, vocab_size=512,
    qkv_bias=True, tie_embeddings=True, act="silu", attn_chunk=32,
)
