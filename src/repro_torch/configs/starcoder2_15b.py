"""StarCoder2-15B — dense GQA with RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    rope_theta=100_000.0,
    act="gelu",
)

SMOKE = CONFIG.with_overrides(
    name="starcoder2-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=384, dtype="float32",
)
