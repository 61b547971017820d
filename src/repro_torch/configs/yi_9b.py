"""Yi-9B — dense llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=10_000.0,
)

SMOKE = CONFIG.with_overrides(
    name="yi-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=384, dtype="float32",
)
