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

Under a mesh (``parallel.sharding``) heads shard over ``model`` when they
divide it, else the sequence does (``seq_model``), and K/V are replicated
over ``model``, as the reference constrains them.  A projection is brought
to the layout of its head view *before* the view (``split_heads``): DTensor
refuses to split a dim whose shards the view would cut unevenly, where XLA
reshards.
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
from repro_torch.parallel.sharding import (_is_dtensor, constrain,
                                           current_mesh, from_local,
                                           local_like, local_offset,
                                           mesh_sizes, placements_for,
                                           spec_for)

#: the port's backend names -> the reference's
REFERENCE_IMPL = {"xla": "xla", "chunked": "chunked",
                  "chunked_naive": "chunked_naive", "kernel": "pallas"}

_XLA_MAX_SEQ = 2048          # above this the materialized S^2 logits are insane

#: logical axes of the projections' weights (the reference's ``attn_spec``)
Q_AXES = ("embed_fsdp", "q_proj")
KV_AXES = ("embed_fsdp", "kv_proj")
O_AXES = ("q_proj", "embed_fsdp")
#: K/V are replicated over the model axis
KV_NAMES = ("batch", None, None, None)


def head_names(n_heads: int) -> tuple:
    """Logical axes of a (B,S,H,D) query or output: heads over ``model``
    when they divide it; otherwise the sequence (context parallelism), so
    activations never replicate over the model axis (llama4's 40 heads on a
    16-way axis)."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names:
        if n_heads % mesh_sizes(mesh)["model"]:
            return ("batch", "seq_model", None, None)
    return ("batch", None, "heads", None)


def split_heads(t: torch.Tensor, n: int, d: int, *names) -> torch.Tensor:
    """(B,S,n*d) -> (B,S,n,d), constrained to ``names``.  A DTensor is
    first given the layout the view will have, so the view never splits a
    sharded dim unevenly; a plain tensor is only viewed."""
    b, s = t.shape[:2]
    mesh = current_mesh()
    if mesh is not None and _is_dtensor(t):
        spec = spec_for(names, dims=(b, s, n, d))
        if spec[3] is not None:
            raise ValueError(f"split_heads: the head dim cannot be sharded "
                             f"({names})")
        placements = placements_for(spec[:3], mesh)
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
    return constrain(t.reshape(b, s, n, d), *names)


class Attention(nn.Module):
    """Projections of one attention layer (``q_proj``, ``k_proj``,
    ``v_proj``, ``o_proj``); ``forward`` is the full-sequence path."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(d, cfg.n_heads * hd, axes=Q_AXES, **kw)
        self.k_proj = Linear(d, cfg.n_kv_heads * hd, axes=KV_AXES, **kw)
        self.v_proj = Linear(d, cfg.n_kv_heads * hd, axes=KV_AXES, **kw)
        self.o_proj = Linear(cfg.n_heads * hd, d, axes=O_AXES, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                impl: str = "auto") -> torch.Tensor:
        """Prefill / training attention.  x: (B,S,D_model)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        qn = head_names(cfg.n_heads)
        q = split_heads(self.q_proj(x), cfg.n_heads, hd, *qn)
        k, v = compute_kv(self, x, positions)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
        q = constrain(q, *qn)
        k, v = constrain(k, *KV_NAMES), constrain(v, *KV_NAMES)
        out = constrain(_sdpa(q, k, v, causal=causal, window=window,
                              impl=impl), *qn)
        return self.o_proj(out.reshape(b, s, cfg.n_heads * hd))


class CrossAttention(nn.Module):
    """Cross-attention of a decoder layer over the encoder's memory: the
    query and output projections (``q_proj``, ``o_proj``).  The memory's
    K/V come from ``compute_kv`` over the encoder output, with projections
    that sit on the decoder block, as the reference computes them in the
    layer's scope, outside ``cross_attn``.  ``forward`` is the reference's
    ``attention(..., kv_override=(k, v))``: q from x alone, no rotary, and
    every key attended (``causal=False``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(d, cfg.n_heads * hd, axes=Q_AXES, **kw)
        self.o_proj = Linear(cfg.n_heads * hd, d, axes=O_AXES, **kw)

    def forward(self, x: torch.Tensor, enc_k: torch.Tensor,
                enc_v: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """x (B,S,D_model), enc_k/enc_v (B,Sk,KV,hd) -> (B,S,D_model)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        qn = head_names(cfg.n_heads)
        q = split_heads(self.q_proj(x), cfg.n_heads, hd, *qn)
        k, v = constrain(enc_k, *KV_NAMES), constrain(enc_v, *KV_NAMES)
        out = constrain(_sdpa(q, k, v, causal=False, window=0, impl=impl),
                        *qn)
        return self.o_proj(out.reshape(b, s, cfg.n_heads * hd))


def _materialized(q, k, v, causal, window, q_offset):
    return ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def _chunked_naive(q, k, v, causal, window, q_offset):
    return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)


#: backend -> attention(q, k, v, causal, window, q_offset)
_ATTENTION = {"xla": _materialized, "chunked": flash_attention_xla,
              "chunked_naive": _chunked_naive,
              "kernel": kops.flash_attention}


def _sdpa(q, k, v, *, causal, window, impl, q_offset=0):
    """q (B,Sq,H,D) k,v (B,Sk,KV,D) -> (B,Sq,H,D)."""
    sq, sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "xla" if max(sq, sk) <= _XLA_MAX_SEQ else "chunked"
    if impl not in _ATTENTION:
        raise ValueError(f"unknown attention impl {impl!r}; "
                         f"ported: {sorted(REFERENCE_IMPL)} and 'auto'")
    return attend(_ATTENTION[impl], q, k, v, causal, window, q_offset)


def attend(fn, q, k, v, causal: bool, window: int, q_offset: int):
    """``fn(q, k, v, causal, window, q_offset)``; on a DTensor query, on
    each device's shard.  Attention is independent across batch rows and
    heads, and across query rows given their offset, so each device attends
    its (batch, heads or sequence) shard of q against the K/V heads those
    heads read, as XLA partitions the reference's batched products: DTensor
    would instead replicate the heads, as its view of a product's batch
    dims cannot flatten two sharded dims into one."""
    if not _is_dtensor(q):
        return fn(q, k, v, causal, window, q_offset)
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    rows_pl = [p if p.is_shard(0) else Replicate() for p in q.placements]
    ql = q.to_local()
    # each device reads the K/V heads (or all the keys) of its own queries
    varies = [i for i, p in enumerate(q.placements) if p.is_shard()
              and not p.is_shard(0)]
    kl, vl = (local_like(t, mesh, rows_pl, varies) for t in (k, v))
    off = local_offset(q)
    h, g = q.shape[2], q.shape[2] // k.shape[2]
    h0, hl = off[2], ql.shape[2]
    if not (hl % g == 0 and h0 % g == 0 or g % hl == 0 and h0 % hl == 0):
        raise ValueError(f"attend: {hl} local heads from head {h0} do not "
                         f"split the GQA groups of {g} heads ({h} heads)")
    k0, k1 = h0 // g, (h0 + hl - 1) // g + 1
    out = fn(ql, kl[:, :, k0:k1], vl[:, :, k0:k1], causal, window,
             q_offset + off[1])
    return from_local(out, mesh, q.placements,
                      tuple(q.shape[:3]) + tuple(out.shape[3:]))


def compute_kv(attn: nn.Module, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None):
    """(k, v), each (B,S,KV,hd), rotated when positions are given, from the
    ``k_proj`` and ``v_proj`` of ``attn`` (an ``Attention``, or a decoder
    block for its cross-attention memory)."""
    cfg = attn.cfg
    hd = cfg.resolved_head_dim
    k = split_heads(attn.k_proj(x), cfg.n_kv_heads, hd, *KV_NAMES)
    v = split_heads(attn.v_proj(x), cfg.n_kv_heads, hd, *KV_NAMES)
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
    q = split_heads(attn.q_proj(x), cfg.n_heads, hd, *head_names(cfg.n_heads))
    k = split_heads(attn.k_proj(x), cfg.n_kv_heads, hd, *KV_NAMES)
    v = split_heads(attn.v_proj(x), cfg.n_kv_heads, hd, *KV_NAMES)
    if cfg.rope_theta > 0:
        pos = lengths[:, None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    slot = lengths.long() % slots
    _scatter_slot(k_cache, k[:, 0], slot)
    _scatter_slot(v_cache, v[:, 0], slot)
    # effective valid count inside the cache
    eff_len = torch.clamp(lengths + 1, max=slots).to(torch.int32)

    if _is_dtensor(k_cache):
        out = _decode_sharded(q, k_cache, v_cache, eff_len)
    elif kv_seq_shards > 1:
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
    """cache (B,S,...) <- new (B,...) at row slot[b], for every row (idle
    rows included, as the reference does).  A DTensor cache is written on
    each device's shard: DTensor has no in-place scatter into a dim sharded
    over the mesh (``cache_seq``), which XLA's scatter is."""
    if _is_dtensor(cache):
        _scatter_slot_sharded(cache, new, slot)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = new.to(cache.dtype)


def _scatter_slot_sharded(cache, new, slot) -> None:
    """``_scatter_slot`` on this device's shard of a DTensor cache: the
    rows it holds take their new values where the slot falls in its range
    of the sequence dim, the others keep theirs (static shapes)."""
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    rows_pl = [p if p.is_shard(0) else Replicate() for p in cache.placements]
    new, slot = (local_like(t, mesh, rows_pl) for t in (new, slot))
    local = cache.to_local()
    idx = slot.long() - local_offset(cache)[1]
    ok = ((idx >= 0) & (idx < local.shape[1])).view(
        (-1,) + (1,) * (new.dim() - 1))
    idx = idx.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, idx] = torch.where(ok, new.to(local.dtype), local[rows, idx])


def _decode_sharded(q, k_cache, v_cache, lengths):
    """``ref.decode_attention`` on a DTensor cache, on each device's shard:
    its rows' queries (every head the shard's KV heads serve) attend its
    keys, and the softmax's max and sums are reduced over the mesh dims that
    shard the cache's sequence (``cache_seq``), as XLA partitions a softmax
    over a sharded dim.  DTensor's own products would flatten the sharded
    batch and head dims into one, which its planner takes minutes over."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, pl = k_cache.device_mesh, k_cache.placements
    rows_pl = [p if p.is_shard(0) else Replicate() for p in pl]

    def reduce(t, op: str, head_dim: int):
        """``t`` summed (or maxed) over the devices that share its rows and
        heads but hold other keys."""
        src = [Partial(op) if p.is_shard(1) else
               Shard(head_dim) if p.is_shard(2) else r
               for p, r in zip(pl, rows_pl)]
        dst = [Replicate() if p.is_shard(1) else d for p, d in zip(pl, src)]
        return DTensor.from_local(t, mesh, src, run_check=False
                                  ).redistribute(mesh, dst).to_local()

    kl, vl = k_cache.to_local(), v_cache.to_local()
    _, s0, kv0, _ = local_offset(k_cache)
    g = q.shape[2] // k_cache.shape[2]
    ql = local_like(q, mesh, rows_pl)[:, :, kv0 * g:(kv0 + kl.shape[2]) * g]
    lens = local_like(lengths, mesh, rows_pl)
    h, dk = ql.shape[2], ql.shape[3]
    k = ref._repeat_kv(kl, h)
    v = ref._repeat_kv(vl, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", ql.float(), k.float()) / math.sqrt(dk)
    kpos = s0 + torch.arange(kl.shape[1], device=kl.device)[None, :]
    valid = kpos < lens.to(kl.device)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    m = reduce(logits.amax(-1, keepdim=True), "max", 1)
    p = torch.exp(logits - m)
    den = reduce(p.sum(-1, keepdim=True), "sum", 1)            # (B,h,1,1)
    num = reduce(torch.einsum("bhqk,bkhd->bqhd", p, v.float()), "sum", 2)
    out = (num / den.permute(0, 2, 1, 3)).to(q.dtype)          # (B,1,h,D)
    out_pl = [Shard(2) if p.is_shard(2) else Replicate() if p.is_shard(1)
              else r for p, r in zip(pl, rows_pl)]
    return from_local(out, mesh, out_pl, tuple(q.shape))


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
