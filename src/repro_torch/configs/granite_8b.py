"""granite-8b [dense] — llama-arch code model: 36L d4096 32H (kv=8)
d_ff 14336, vocab 49152. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, act="silu", rope_theta=1e4,
)

SMOKE = LMConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="silu", attn_chunk=32,
)

# ESSR-technique variant: dynamic-width FFN (models/lm/ffn.py)
import dataclasses as _dc
FULL_DYNWIDTH = _dc.replace(FULL, name="granite-8b-dynwidth", dynamic_width=True)
SMOKE_DYNWIDTH = _dc.replace(SMOKE, name="granite-8b-smoke-dynwidth", dynamic_width=True)
