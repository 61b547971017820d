"""SeamlessM4T-large-v2 — encoder-decoder multimodal (audio frontend stub).
[arXiv:2308.11596; hf]

24 encoder + 24 decoder layers at d_model=1024.  The speech frontend is a
STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, frames, d_model).  For the assigned LM shapes,
seq_len parameterizes the decoder; encoder frames = min(seq_len, 4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,           # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    frontend="audio",
    n_frontend_tokens=4096,
    act="gelu",
)

SMOKE = CONFIG.with_overrides(
    name="seamless-smoke",
    n_layers=2, n_enc_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    head_dim=24, d_ff=192, vocab_size=384, n_frontend_tokens=16,
    dtype="float32",
)
