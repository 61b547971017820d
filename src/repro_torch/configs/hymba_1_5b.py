"""Hymba-1.5B — hybrid blocks with parallel attention + Mamba heads, SWA on
all layers (sub-quadratic -> eligible for long_500k).  [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=1024,
    swa_interleave=0,      # all attention heads use the sliding window
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = CONFIG.with_overrides(
    name="hymba-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=384, sliding_window=64, ssm_state=8,
    dtype="float32",
)
