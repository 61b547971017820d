"""Model / shape configuration system.

The port's own copy of ``repro.configs.base``: the port imports nothing of
the JAX package, so the two definitions are kept identical by hand (the
port's tests compare them field by field).

Every integer in ``ModelConfig`` is a MODEL_CONFIG-taint source (paper §4.1):
the Tainted Runner seeds its global taint registry from
``model_config_taint_values``.  Request-derived values (batch size, token
count) come from ``ShapeSpec`` and are tainted NUM_REQS / NUM_TOKS.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def total_tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"                # gqa | mla | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0               # 0 -> full attention
    swa_interleave: int = 0               # every k-th layer is GLOBAL, rest SWA (0 = all global)
    mla: Optional[MLAConfig] = None

    # mixture of experts
    n_experts: int = 0                    # 0 -> dense FFN
    top_k: int = 0
    moe_d_ff: int = 0                     # per-expert hidden size
    moe_interleave: int = 1               # every k-th layer is MoE (1 = all)
    n_shared_experts: int = 0

    # state space (mamba / hybrid)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                  # 0 -> d_model // 16

    # encoder-decoder
    n_enc_layers: int = 0                 # >0 => enc-dec; n_layers = decoder layers

    # modality frontend (stub: precomputed embeddings via input_specs)
    frontend: str = "none"                # none | vision | audio
    n_frontend_tokens: int = 0

    # numerics / misc
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"

    # distribution hints
    remat: bool = True                    # activation checkpointing in train_step
    optimizer: str = "adamw"              # adamw | adafactor

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def subquadratic(self) -> bool:
        """True if attention cost does not grow quadratically without bound
        (SSM / hybrid with sliding windows) -> eligible for long_500k."""
        if self.is_attention_free:
            return True
        if self.family == "hybrid" and self.sliding_window > 0 and self.swa_interleave == 0:
            return True
        return False

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("mamba")
            elif self.family == "hybrid":
                kinds.append("hybrid")
            elif self.n_experts > 0 and (i % self.moe_interleave == self.moe_interleave - 1):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def layer_is_global_attn(self, i: int) -> bool:
        """Interleaved sliding-window pattern: every swa_interleave-th layer global."""
        if self.sliding_window == 0:
            return True
        if self.swa_interleave == 0:
            return False  # all layers SWA
        return i % self.swa_interleave == self.swa_interleave - 1

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs & memory planning)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.attn_type == "mla":
            m = self.mla or MLAConfig()
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        elif self.attn_type == "none":
            attn = 0
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

        mamba = 0
        if self.ssm_state > 0:
            di, st, dtr = self.ssm_d_inner, self.ssm_state, self.resolved_dt_rank
            mamba = (2 * d * di + di * self.ssm_conv + di * (dtr + 2 * st)
                     + dtr * di + di * st + di + di * d)

        def ffn(dff):
            # silu -> SwiGLU (gate, up, down); gelu -> classic MLP (up, down)
            return (3 if self.act == "silu" else 2) * d * dff

        per_layer = []
        for i, kind in enumerate(self.layer_kinds()):
            p = 2 * d  # two norms
            if kind == "mamba":
                p += mamba
            elif kind == "hybrid":
                p += attn + mamba + ffn(self.d_ff)
            elif kind == "moe":
                p += attn + d * self.n_experts
                p += (self.n_experts + self.n_shared_experts) * ffn(self.moe_d_ff)
            else:
                p += attn + ffn(self.d_ff)
            per_layer.append(p)
        total += sum(per_layer)
        if self.n_enc_layers:
            # encoder layers: self-attn + ffn; decoder layers add cross-attn
            total += self.n_enc_layers * (attn + ffn(self.d_ff) + 2 * d)
            total += self.n_layers * attn  # cross-attention in decoder
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        # crude but standard: replace each MoE layer's experts by top_k active ones
        d = self.d_model
        full = self.param_count()
        moe_layers = sum(1 for k in self.layer_kinds() if k == "moe")
        nmat = 3 if self.act == "silu" else 2
        all_experts = moe_layers * (self.n_experts + self.n_shared_experts) * nmat * d * self.moe_d_ff
        active_experts = moe_layers * (self.top_k + self.n_shared_experts) * nmat * d * self.moe_d_ff
        return int(full - all_experts + active_experts)


def model_config_taint_values(cfg: ModelConfig) -> dict:
    """value -> set of field names; seeds the MODEL_CONFIG taint registry (§4.1)."""
    out: dict = {}

    def add(v, name):
        if isinstance(v, int) and v > 1:
            out.setdefault(v, set()).add(name)

    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        add(v, f.name)
    if cfg.mla is not None:
        for f in dataclasses.fields(cfg.mla):
            add(getattr(cfg.mla, f.name), "mla." + f.name)
    # derived values that appear as tensor dimensions
    add(cfg.resolved_head_dim, "head_dim")
    add(cfg.ssm_d_inner, "ssm_d_inner")
    add(cfg.resolved_dt_rank, "ssm_dt_rank")
    add(cfg.n_heads * cfg.resolved_head_dim, "q_proj_dim")
    add(cfg.n_kv_heads * cfg.resolved_head_dim, "kv_proj_dim")
    add(cfg.n_heads // max(cfg.n_kv_heads, 1), "gqa_groups")
    if cfg.mla is not None:
        m = cfg.mla
        add(m.qk_nope_head_dim + m.qk_rope_head_dim, "mla.qk_head_dim")
        add(m.kv_lora_rank + m.qk_rope_head_dim, "mla.kv_cache_dim")
        add(cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim), "mla.kv_up_dim")
        add(cfg.n_heads * m.v_head_dim, "mla.v_proj_dim")
    add(cfg.ssm_state * cfg.ssm_d_inner, "ssm_state_flat")
    add(2 * cfg.ssm_state, "ssm_bc_dim")
    add(cfg.resolved_dt_rank + 2 * cfg.ssm_state, "ssm_xproj_dim")
    return out
