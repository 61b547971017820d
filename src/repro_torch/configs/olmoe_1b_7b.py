"""OLMoE-1B-7B — 64 experts, top-8.  [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,             # unused: every layer is MoE
    vocab_size=50_304,
    rope_theta=10_000.0,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    moe_interleave=1,
)

SMOKE = CONFIG.with_overrides(
    name="olmoe-smoke",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=128, vocab_size=384, n_experts=8, top_k=2, moe_d_ff=128,
    dtype="float32",
)
