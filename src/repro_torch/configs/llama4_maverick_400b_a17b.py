"""Llama-4 Maverick 400B-A17B — MoE (128 experts, top-1) with early-fusion
vision frontend (stub).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Per the public architecture, MoE layers interleave with dense layers
(every other layer; ``moe_interleave=2``) and each MoE layer has one shared
expert alongside the 128 routed experts.  With moe_d_ff=8192 (routed/shared)
and dense d_ff=16384 this gives ~400B total / ~17B active parameters,
matching the 400b-a17b designation.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,            # dense (non-MoE) layers
    vocab_size=202_048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    moe_interleave=2,
    n_shared_experts=1,
    frontend="vision",
    n_frontend_tokens=256,
    optimizer="adafactor",  # AdamW state for 400B exceeds 256x16GB HBM
)

SMOKE = CONFIG.with_overrides(
    name="llama4-maverick-smoke",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, n_experts=8, top_k=1, moe_d_ff=256,
    n_frontend_tokens=16, dtype="float32",
)
