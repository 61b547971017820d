"""Granite-20B — dense llama-arch code model with MQA (kv=1).
[arXiv:2405.04324; hf]

Shares d_model / d_ff / vocab with starcoder2-15b: exercises cross-model
linear-operator signature dedup (paper Table 2, aten::linear row).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=10_000.0,
    act="gelu",
)

SMOKE = CONFIG.with_overrides(
    name="granite-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=512, vocab_size=384, dtype="float32",
)
