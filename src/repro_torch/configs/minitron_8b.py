"""minitron-8b [dense] — pruned nemotron: 32L d4096 32H (kv=8) d_ff 16384,
vocab 256000, squared-ReLU MLP (nemotron lineage). [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000, act="relu2", rope_theta=1e4,
)

SMOKE = LMConfig(
    name="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="relu2", attn_chunk=32,
)
