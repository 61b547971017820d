"""Command-R7B-like — paper-corpus model (§2.1/§7.2): interleaved
sliding-window attention (3 SWA : 1 global), GQA 32/8/128 on global layers.
The SWA layers introduce a second attention signature (window=4K) that cannot
be deduplicated (paper Table 2, window=4K row).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=255_029,
    rope_theta=50_000.0,
    sliding_window=4096,
    swa_interleave=4,      # every 4th layer global, rest SWA
    tie_embeddings=True,
)

SMOKE = CONFIG.with_overrides(
    name="command-r7b-smoke",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=384, sliding_window=64, swa_interleave=4,
    dtype="float32",
)
