"""GQA / MQA / MHA attention module with prefill + decode paths.

Counterpart of ``repro.models.attention``.  Attention backends (the Dooly
configuration axis 'S'):

* ``xla``           — full materialized softmax attention (``ref.attention``),
                      the "eager" backend; the name is the reference's.
* ``chunked``       — flash semantics in plain torch
                      (``kernels/flash_xla.py``): online softmax over KV
                      chunks that saves only (out, lse) and recomputes the
                      probabilities in the backward; ``auto`` picks it above
                      ``_XLA_MAX_SEQ`` tokens, as the reference does.
* ``chunked_naive`` — online softmax over KV chunks (``ref.chunked_attention``).
* ``kernel``        — the hand-written CUDA kernels (``kernels/ops.py``); on
                      CPU tensors their plain versions.

Both chunked backends also select the split-KV decode and the
online-softmax chunk-against-cache attention, as the reference's do.

Decode uses a padded KV cache with per-request lengths; sliding-window
layers may use a ring-buffer cache of exactly ``window`` slots.  Caches are
updated in place: a decode step writes its new K/V rows into the cache it
is given.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_xla import flash_attention_xla
from repro_torch.models.layers import Linear, apply_rope

#: the port's backend names -> the reference's
REFERENCE_IMPL = {"xla": "xla", "chunked": "chunked",
                  "chunked_naive": "chunked_naive", "kernel": "pallas"}

_XLA_MAX_SEQ = 2048          # above this the materialized S^2 logits are insane


class Attention(nn.Module):
    """Projections of one attention layer (``q_proj``, ``k_proj``,
    ``v_proj``, ``o_proj``); ``forward`` is the full-sequence path."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(d, cfg.n_heads * hd, **kw)
        self.k_proj = Linear(d, cfg.n_kv_heads * hd, **kw)
        self.v_proj = Linear(d, cfg.n_kv_heads * hd, **kw)
        self.o_proj = Linear(cfg.n_heads * hd, d, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                impl: str = "auto") -> torch.Tensor:
        """Prefill / training attention.  x: (B,S,D_model)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = self.q_proj(x).reshape(b, s, cfg.n_heads, hd)
        k, v = compute_kv(self, x, positions)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
        out = _sdpa(q, k, v, causal=causal, window=window, impl=impl)
        return self.o_proj(out.reshape(b, s, cfg.n_heads * hd))


def _sdpa(q, k, v, *, causal, window, impl, q_offset=0):
    """q (B,Sq,H,D) k,v (B,Sk,KV,D) -> (B,Sq,H,D)."""
    sq, sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "xla" if max(sq, sk) <= _XLA_MAX_SEQ else "chunked"
    if impl == "xla":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if impl == "chunked":
        return flash_attention_xla(q, k, v, causal, window, q_offset)
    if impl == "chunked_naive":
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if impl == "kernel":
        return kops.flash_attention(q, k, v, causal, window, q_offset)
    raise ValueError(f"unknown attention impl {impl!r}; "
                     f"ported: {sorted(REFERENCE_IMPL)} and 'auto'")


def compute_kv(attn: Attention, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None):
    """(k, v), each (B,S,KV,hd), rotated when positions are given."""
    cfg = attn.cfg
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    k = attn.k_proj(x).reshape(b, s, cfg.n_kv_heads, hd)
    v = attn.v_proj(x).reshape(b, s, cfg.n_kv_heads, hd)
    if positions is not None and cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, window: int, *,
                  device, dtype) -> Dict[str, torch.Tensor]:
    """Zeroed cache for one attention layer.  window>0 -> ring buffer."""
    slots = min(window, max_seq) if window > 0 else max_seq
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def decode_attention(attn: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], *, lengths: torch.Tensor,
                     window: int = 0, impl: str = "auto",
                     kv_seq_shards: int = 1) -> torch.Tensor:
    """One-token decode.  x: (B,1,D); lengths (B,): tokens already in cache.

    Writes the new token's K/V into ``cache`` in place and returns out
    (B,1,D).  The new token's position is ``lengths`` (0-based); its cache
    slot is position % slots.  Like the reference, ``window`` is not passed
    to the attention itself (ROADMAP Queue 3)."""
    cfg = attn.cfg
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    slots = k_cache.shape[1]
    q = attn.q_proj(x).reshape(b, 1, cfg.n_heads, hd)
    k = attn.k_proj(x).reshape(b, 1, cfg.n_kv_heads, hd)
    v = attn.v_proj(x).reshape(b, 1, cfg.n_kv_heads, hd)
    if cfg.rope_theta > 0:
        pos = lengths[:, None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    slot = lengths.long() % slots
    _scatter_slot(k_cache, k[:, 0], slot)
    _scatter_slot(v_cache, v[:, 0], slot)
    # effective valid count inside the cache
    eff_len = torch.clamp(lengths + 1, max=slots).to(torch.int32)

    if kv_seq_shards > 1:
        out = _split_kv_decode(q, k_cache, v_cache, eff_len,
                               n_shards=kv_seq_shards)
    elif impl == "kernel":
        out = kops.decode_attention(q, k_cache, v_cache, eff_len)
    elif impl in ("chunked", "chunked_naive") and window == 0:
        # split-KV style decode (distinct kernel selection, as the reference)
        n = max(slots // 512, 1)
        while slots % n:
            n -= 1
        out = _split_kv_decode(q, k_cache, v_cache, eff_len, n_shards=n)
    else:
        out = ref.decode_attention(q, k_cache, v_cache, eff_len)
    return attn.o_proj(out.reshape(b, 1, cfg.n_heads * hd))


def _scatter_slot(cache: torch.Tensor, new: torch.Tensor,
                  slot: torch.Tensor) -> None:
    """cache (B,S,KV,D) <- new (B,KV,D) at row slot[b], for every row (idle
    rows included, as the reference does)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new.to(cache.dtype)


# ---------------------------------------------------------------------------
# split-KV decode: the cache's sequence split into shards, each reduced to
# partial (m, l, o), then merged.
# ---------------------------------------------------------------------------

def _split_kv_decode(q, k_cache, v_cache, lengths, *, n_shards: int):
    """q (B,1,H,D), caches (B,S,KV,D); S divided into n_shards chunks, each
    reduced independently (partial m/l/acc) then merged."""
    b, s, kv, d = k_cache.shape
    h = q.shape[2]
    dv = v_cache.shape[-1]
    group = h // kv
    chunk = s // n_shards
    kc = k_cache.reshape(b, n_shards, chunk, kv, d).float()
    vc = v_cache.reshape(b, n_shards, chunk, kv, dv).float()
    if group > 1:
        kc = kc.repeat_interleave(group, dim=3)
        vc = vc.repeat_interleave(group, dim=3)
    qf = q.float() * (1.0 / math.sqrt(d))
    logits = torch.einsum("bqhd,bnkhd->bnhqk", qf, kc)         # (B,n,H,1,chunk)
    kpos = (torch.arange(chunk, device=q.device)[None, :]
            + (torch.arange(n_shards, device=q.device) * chunk)[:, None])
    valid = kpos[None, :, None, None, :] < lengths.long()[:, None, None, None, None]
    logits = logits.masked_fill(~valid, -math.inf)
    m = logits.amax(-1)                                        # (B,n,H,1)
    msafe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(valid, torch.exp(logits - msafe[..., None]), 0.0)
    l = p.sum(-1)                                              # (B,n,H,1)
    o = torch.einsum("bnhqk,bnkhd->bnqhd", p, vc)              # (B,n,1,H,Dv)
    m_glob = m.amax(1, keepdim=True)
    corr = torch.exp(torch.where(torch.isneginf(m), -math.inf, m - m_glob))
    l_glob = (l * corr).sum(1)                                 # (B,H,1)
    o_glob = (o * corr.transpose(2, 3)[..., None]).sum(1)      # (B,1,H,Dv)
    out = o_glob / torch.clamp(l_glob, min=1e-20)[:, None, :, :]
    return out.to(q.dtype)
