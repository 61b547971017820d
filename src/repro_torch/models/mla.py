"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

Counterpart of ``repro.models.mla``.  Prefill expands the latents to
per-head K/V and runs standard attention.  Decode is the *absorbed* form:
the cache stores only the compressed latent ``c`` (kv_lora_rank) and the
shared rotary key ``k_rope`` (qk_rope_head_dim); W_uk is absorbed into the
query and W_uv applied after the attention-weighted latent sum, every
product in float32 as the reference upcasts it.  MLA reaches no Pallas
kernel in the reference, so none here: its products stay in PyTorch, as the
reference keeps them in XLA.

The module is held by its block as ``mla_attn`` (the reference's
``named_scope``), and its projections are named after the reference's
``linear`` scopes: ``q_down``, ``q_up``, ``kv_down``, ``k_up``, ``v_up``,
``o_proj`` (the reference's ``wdq``, ``wuq``, ``wdkv``, ``wuk``, ``wuv``,
``o``), with the norms ``q_norm`` and ``kv_norm``.

Under a mesh the query is constrained to heads over ``model`` as the
reference's; the per-head views of the up-projections go through
``attention.split_heads`` (see there).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ref
from repro_torch.kernels.flash_xla import flash_attention_xla
from repro_torch.models.attention import (_XLA_MAX_SEQ, _materialized,
                                          _scatter_slot, attend, split_heads)
from repro_torch.models.layers import Linear, RMSNorm, apply_rope
from repro_torch.parallel.sharding import (_is_dtensor, constrain,
                                           current_mesh, placements_for,
                                           spec_for)

#: a (B,S,H,D) query, key or value of MLA: heads over ``model``
HEADS = ("batch", None, "heads", None)


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla or MLAConfig()
        d, h = cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        down, up = ("embed_fsdp", "latent"), ("latent", "q_proj")
        self.q_down = Linear(d, m.q_lora_rank, axes=down, **kw)
        self.q_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, device=device)
        self.q_up = Linear(m.q_lora_rank, h * qk, axes=up, **kw)
        self.kv_down = Linear(d, m.kv_lora_rank + m.qk_rope_head_dim,
                              axes=down, **kw)
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, device=device)
        self.k_up = Linear(m.kv_lora_rank, h * m.qk_nope_head_dim, axes=up,
                           **kw)
        self.v_up = Linear(m.kv_lora_rank, h * m.v_head_dim, axes=up, **kw)
        self.o_proj = Linear(h * m.v_head_dim, d, axes=("q_proj", "embed_fsdp"),
                             **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
        """``mla_attention(self, x, positions=positions, impl=impl)``."""
        return mla_attention(self, x, positions=positions, impl=impl)


def project_q(mla: MLA, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope, q_rope), (B,S,H,nope) and (B,S,H,rope), the latter rotated."""
    cfg, m = mla.cfg, mla.cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = mla.q_norm(mla.q_down(x))
    q = split_heads(mla.q_up(cq), cfg.n_heads, qk, *HEADS)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def project_latent(mla: MLA, x: torch.Tensor, positions: torch.Tensor):
    """(c, k_rope): the normed latent (B,S,r) and the rotated shared key
    (B,S,rope)."""
    cfg, m = mla.cfg, mla.cfg.mla
    c, k_rope = torch.split(mla.kv_down(x),
                            [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = mla.kv_norm(c)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c, k_rope[:, :, 0, :]


def mla_attention(mla: MLA, x: torch.Tensor, *, positions: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Prefill / training path (expanded K/V).  x: (B,S,D).  Above 2048
    tokens ``auto`` and ``chunked`` run ``flash_attention_xla``; every
    other case the materialized attention, as the reference dispatches."""
    cfg, m = mla.cfg, mla.cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = project_q(mla, x, positions)
    c, k_rope = project_latent(mla, x, positions)
    k_nope = split_heads(mla.k_up(c), h, m.qk_nope_head_dim, *HEADS)
    v = split_heads(mla.v_up(c), h, m.v_head_dim, *HEADS)
    q = constrain(torch.cat([q_nope, q_rope], dim=-1), *HEADS)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    if impl in ("auto", "chunked") and s > _XLA_MAX_SEQ:
        out = attend(flash_attention_xla, q, k, v, True, 0, 0)
    else:
        out = attend(_materialized, q, k, v, True, 0, 0)
    return mla.o_proj(out.reshape(b, s, h * m.v_head_dim))


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device,
                   dtype) -> Dict[str, torch.Tensor]:
    """Zeroed cache of one MLA layer: ``c`` (B,Smax,kv_lora_rank) and
    ``k_rope`` (B,Smax,qk_rope_head_dim)."""
    m = cfg.mla or MLAConfig()
    kw = dict(device=device, dtype=dtype)
    return {"c": torch.zeros((batch, max_seq, m.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim), **kw)}


def _absorbed(mla: MLA, name: str, width: int) -> torch.Tensor:
    """A latent up-projection's weight as (r, H, width) float32 (a DTensor
    first laid out as its head view will be: see
    ``attention.split_heads``)."""
    m = mla.cfg.mla
    w = getattr(mla, name).w
    mesh = current_mesh()
    if mesh is not None and _is_dtensor(w):
        spec = spec_for(("latent", "heads", None),
                        dims=(m.kv_lora_rank, mla.cfg.n_heads, width))
        w = w.redistribute(mesh, placements_for(spec[:2], mesh))
    return w.reshape(m.kv_lora_rank, mla.cfg.n_heads, width).float()


def mla_decode(mla: MLA, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
               lengths: torch.Tensor) -> torch.Tensor:
    """Absorbed one-token decode.  x: (B,1,D); lengths (B,): tokens already
    cached.  Writes the token's latent and rotary key into ``cache`` at row
    ``lengths`` in place and returns out (B,1,D).  Every product runs in
    float32 over the whole cache, the keys at or past ``lengths + 1``
    masked."""
    cfg, m = mla.cfg, mla.cfg.mla
    b = x.shape[0]
    c_cache, kr_cache = cache["c"], cache["k_rope"]
    smax = c_cache.shape[1]
    lengths = lengths.to(x.device).long()
    pos = lengths[:, None]
    q_nope, q_rope = project_q(mla, x, pos)                  # (B,1,H,*)
    c_new, kr_new = project_latent(mla, x, pos)              # (B,1,r) (B,1,dr)
    _scatter_slot(c_cache, c_new[:, 0], lengths)
    _scatter_slot(kr_cache, kr_new[:, 0], lengths)

    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         _absorbed(mla, "k_up", m.qk_nope_head_dim))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    cf = c_cache.float()
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, cf)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          kr_cache.float())
    logits = (s_lat + s_rope) * scale
    valid = torch.arange(smax, device=x.device)[None, None, :] < \
        (lengths + 1)[:, None, None]
    probs = torch.softmax(logits.masked_fill(~valid, -math.inf), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs, cf)
    out = torch.einsum("bhr,rhd->bhd", ctx, _absorbed(mla, "v_up", m.v_head_dim))
    out = constrain(out, "batch", "heads", None).reshape(b, 1, cfg.n_heads * m.v_head_dim).to(x.dtype)
    return mla.o_proj(out)


def mla_prefill_chunk(mla: MLA, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], *,
                      lengths: torch.Tensor, write_chunk) -> torch.Tensor:
    """Chunked prefill against the latent cache, as the reference's engine
    runs it: the chunk's latents are written at [lengths, lengths+C) (by
    ``write_chunk``, the engine's cache write), then the *whole* ``c``
    cache is expanded through W_uk and W_uv in float32 and the chunk
    attends it.  x: (B,C,D); returns out (B,C,D)."""
    cfg, m = mla.cfg, mla.cfg.mla
    b, c, _ = x.shape
    nh = cfg.n_heads
    positions = lengths.to(x.device).long()[:, None] + \
        torch.arange(c, device=x.device)
    q_nope, q_rope = project_q(mla, x, positions)
    c_new, kr_new = project_latent(mla, x, positions)
    c_cache = write_chunk(cache["c"], c_new, lengths)
    kr_cache = write_chunk(cache["k_rope"], kr_new, lengths)
    cf = c_cache.float()
    k_nope = (cf @ mla.k_up.w.float()).reshape(b, -1, nh, m.qk_nope_head_dim)
    v_exp = (cf @ mla.v_up.w.float()).reshape(b, -1, nh, m.v_head_dim)
    k_full = torch.cat([k_nope, kr_cache[:, :, None, :].float().expand(
        k_nope.shape[:3] + (m.qk_rope_head_dim,))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    y = ref.chunk_cache_attention(q, k_full.to(x.dtype), v_exp.to(x.dtype),
                                  lengths)
    return mla.o_proj(y.reshape(b, c, nh * m.v_head_dim))
