"""seamless-m4t-medium [audio] — enc-dec, 12L each, d1024 16H (kv=16)
d_ff 4096, vocab 256206. Modality frontend is a STUB: input_specs provides
precomputed frame embeddings (assignment rule). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import LMConfig

FULL = LMConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    is_encoder_decoder=True, n_encoder_layers=12,
    frontend="audio", act="gelu",
)

SMOKE = LMConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    is_encoder_decoder=True, n_encoder_layers=2,
    frontend="audio", act="gelu", attn_chunk=32,
)
