"""zamba2-1.2b [hybrid] — 38L mamba2 d2048 (d_inner 4096, state 64, head 64)
with a weight-SHARED attention+MLP block (32H kv=32, d_ff 8192) applied every
6 layers, vocab 32000. [arXiv:2411.15242; hf]

Simplifications vs the HF impl: the shared block's
per-invocation LoRA adapters are omitted; the shared block consumes the
running hidden state (no concat-with-embedding projection)."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, ssm_chunk=128,
    shared_attn_every=6, act="gelu",
)

SMOKE = LMConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    ssm_state=8, ssm_expand=2, ssm_conv=4, ssm_head_dim=16, ssm_chunk=16,
    shared_attn_every=2, act="gelu", attn_chunk=32,
)
