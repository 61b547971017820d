"""InternVL2-26B — VLM: InternLM2-20B backbone + InternViT frontend (stub).
[arXiv:2404.16821; hf]

Per the assignment the transformer BACKBONE only is modeled; the vision
frontend is a stub whose precomputed patch embeddings enter via
``input_specs()`` and are concatenated ahead of the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
)

SMOKE = CONFIG.with_overrides(
    name="internvl2-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=384, n_frontend_tokens=16, dtype="float32",
)
