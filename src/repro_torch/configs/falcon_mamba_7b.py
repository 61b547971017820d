"""Falcon-Mamba-7B — pure Mamba-1, attention-free (sub-quadratic -> runs
long_500k).  [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,             # nominal; attention-free
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    attn_type="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = CONFIG.with_overrides(
    name="falcon-mamba-smoke",
    n_layers=3, d_model=128, vocab_size=384, ssm_state=8, dtype="float32",
)
