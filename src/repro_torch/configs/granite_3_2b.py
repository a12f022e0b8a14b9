"""granite-3-2b [dense] — 40L d2048 32H (GQA kv=8) d_ff 8192, vocab 49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155, act="silu", rope_theta=1e4,
)

SMOKE = LMConfig(
    name="granite-3-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=515,          # deliberately uneven (pad-sharding test)
    act="silu", attn_chunk=32,
)
