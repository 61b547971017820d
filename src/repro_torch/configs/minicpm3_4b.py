"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]

The assigned spec lists 40 heads with kv=40; under MLA the KV cache stores the
compressed latent (kv_lora_rank + rope dim) rather than per-head K/V, so
n_kv_heads is nominal.  MLA geometry follows the public config:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73_448,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE = CONFIG.with_overrides(
    name="minicpm3-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=384,
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    dtype="float32",
)
