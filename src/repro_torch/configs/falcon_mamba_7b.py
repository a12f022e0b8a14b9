"""falcon-mamba-7b [ssm] — mamba1, attention-free: 64L d4096, d_inner 8192,
ssm_state 16, conv 4, dt_rank 256, vocab 65024. [arXiv:2410.05355; unverified]

The paper's edge-selective patch routing is N/A for an attention-free LM
— implemented WITHOUT the technique."""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
)

SMOKE = LMConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=8, ssm_expand=2, ssm_conv=4, ssm_chunk=16,
)
