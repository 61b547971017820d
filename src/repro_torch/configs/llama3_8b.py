"""Llama-3.1-8B-like — paper-corpus model (§7.2): dense GQA 32/8/128.
Shares attention geometry with command-r7b's global layers -> the paper's
headline dedup case (Table 2, GQA 32/8/128 row).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.with_overrides(
    name="llama3-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=384, dtype="float32",
)
