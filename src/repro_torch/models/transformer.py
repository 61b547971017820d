"""Decoder blocks: full-sequence apply (train / prefill), chunked prefill
against a cache, one-token decode, and each block's cache.

Counterpart of ``repro.models.transformer`` for the dense, MLA, MoE, Mamba
and hybrid block kinds.  The reference scans over a repeating period of
layers; PyTorch runs eagerly, so the port keeps one ``Block`` per layer
(``layers.{i}``) and loops over them.  A block of an enc-dec decoder
(``desc.cross``) runs cross-attention over the encoder's memory after its
self-attention; the encoder's blocks are dense blocks run non-causally.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import MLP, Linear, RMSNorm, apply_rope
from repro_torch.parallel.sharding import constrain

Cache = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]
EncKV = Optional[Tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class BlockDesc:
    kind: str          # dense | moe | mamba | hybrid
    window: int        # 0 = global attention
    cross: bool = False


def layer_descs(cfg: ModelConfig) -> List[BlockDesc]:
    kinds = cfg.layer_kinds()
    out = []
    for i, kind in enumerate(kinds):
        win = 0
        if kind != "mamba" and not cfg.layer_is_global_attn(i):
            win = cfg.sliding_window
        out.append(BlockDesc(kind, win, cross=cfg.is_encdec))
    return out


class Block(nn.Module):
    """One decoder layer, its submodules named as the reference's trace
    scopes: ``ln1``, the attention (``self_attn``, or ``mla_attn`` for an
    MLA config), ``mamba`` beside it in a hybrid block, ``ln2`` and the FFN
    (``mlp``, or ``moe``); a Mamba block has ``ln1`` and ``mamba`` only.  A
    cross block (enc-dec decoder) adds ``ln_x``, ``cross_attn`` and the
    ``k_proj``/``v_proj`` of the encoder memory, which the reference runs
    in the layer's scope (``layers.{i}/k_proj``), outside ``cross_attn``."""

    def __init__(self, cfg: ModelConfig, desc: BlockDesc, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.desc = cfg, desc
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if desc.kind == "mamba":
            self.mamba = mamba_mod.Mamba(cfg, **kw)
            return
        if cfg.attn_type == "mla":
            self.mla_attn = mla_mod.MLA(cfg, **kw)
        else:
            self.self_attn = attn_mod.Attention(cfg, **kw)
        if desc.kind == "hybrid":
            self.mamba = mamba_mod.Mamba(cfg, **kw)
        if desc.cross:
            d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
            self.ln_x = RMSNorm(d, cfg.norm_eps, device=device)
            self.cross_attn = attn_mod.CrossAttention(cfg, **kw)
            self.k_proj = Linear(d, kvd, axes=attn_mod.KV_AXES, **kw)
            self.v_proj = Linear(d, kvd, axes=attn_mod.KV_AXES, **kw)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if desc.kind == "moe":
            self.moe = moe_mod.MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                impl: str, causal: bool = True, enc_kv: EncKV = None
                ) -> Tuple[torch.Tensor, Optional[Aux]]:
        """(x_out, the MoE aux losses or None)."""
        return block_apply(self, x, positions=positions, impl=impl,
                           causal=causal, enc_kv=enc_kv)[:2]


def _res(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual stream x + y, in the layout the reference's stream
    keeps from its embedding's constraint, ("batch", None, None): under a
    mesh DTensor would otherwise keep a row-parallel projection's partial
    sum in the stream and reduce-scatter it over the hidden dim."""
    return constrain(x + y, "batch", None, None)


def _cross(block: Block, x: torch.Tensor, enc_kv: EncKV,
           impl: str) -> torch.Tensor:
    """The residual stream after the block's cross-attention, if it has
    one, over the encoder memory ``enc_kv`` = (k, v)."""
    if not block.desc.cross:
        return x
    if enc_kv is None:
        raise ValueError(f"{block.cfg.name}: a cross block needs the "
                         "encoder memory (enc_kv)")
    return _res(x, block.cross_attn(block.ln_x(x), *enc_kv, impl=impl))


def _ffn(block: Block, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[Aux]]:
    h = block.ln2(x)
    if block.desc.kind == "moe":
        return block.moe(h)
    return block.mlp(h), None


# ---------------------------------------------------------------------------
# full-sequence apply (train / prefill)
# ---------------------------------------------------------------------------

def block_apply(block: Block, x: torch.Tensor, *, positions: torch.Tensor,
                impl: str, causal: bool = True, enc_kv: EncKV = None,
                collect_cache: bool = False, max_seq: int = 0
                ) -> Tuple[torch.Tensor, Optional[Aux], Optional[Cache]]:
    """Returns (x_out, aux_or_None, cache_entry_or_None): the MoE aux
    losses, and the layer's decode cache, ``{"k", "v"}`` for attention,
    ``{"c", "k_rope"}`` for MLA, ``{"conv", "h"}`` for Mamba, both for a
    hybrid block.  A cross block attends ``enc_kv`` after its
    self-attention; the caller adds the memory to its cache."""
    desc = block.desc
    h = block.ln1(x)
    cache: Cache = {}
    if desc.kind == "mamba":
        if not collect_cache:
            return _res(x, block.mamba(h, impl=forward_scan(impl))), None, None
        y, (tail, hs) = block.mamba(h, return_state=True, impl=impl)
        return _res(x, y), None, {"conv": tail, "h": hs}
    if block.cfg.attn_type == "mla":
        y = block.mla_attn(h, positions, impl=impl)
        if collect_cache:
            c, k_rope = mla_mod.project_latent(block.mla_attn, h, positions)
            cache.update(c=_fill_linear(c, max_seq),
                         k_rope=_fill_linear(k_rope, max_seq))
    else:
        y = block.self_attn(h, positions, causal=causal, window=desc.window,
                            impl=impl)
        if collect_cache:
            k, v = attn_mod.compute_kv(block.self_attn, h, positions)
            slots = min(desc.window, max_seq) if desc.window > 0 else max_seq
            cache.update(k=_fill_ring(k, slots), v=_fill_ring(v, slots))
    if desc.kind == "hybrid":
        if collect_cache:
            ym, (tail, hs) = block.mamba(h, return_state=True, impl=impl)
            cache.update(conv=tail, h=hs)
        else:
            ym = block.mamba(h, impl=forward_scan(impl))
        y = y + ym
    x = _cross(block, _res(x, y), enc_kv, impl)
    y2, aux = _ffn(block, x)
    return _res(x, y2), aux, (cache or None)


def forward_scan(impl: str) -> str:
    """The backend of a Mamba mixer in the full-sequence forward without a
    cache, the path that training differentiates: the plain chunked scan
    for every attention backend, as the reference's model always runs it.
    The scan kernel has no backward (nor has the reference's); it serves
    ``kernel``'s prefill, chunked-prefill and decode paths."""
    return "chunked" if impl == "kernel" else impl


def _fill_ring(kv: torch.Tensor, slots: int) -> torch.Tensor:
    """(B,S,KV,D) -> ring cache (B,slots,KV,D): last min(S,slots) rows at
    slot = pos % slots."""
    b, s = kv.shape[:2]
    ring = kv.new_zeros((b, slots) + kv.shape[2:])
    if s <= slots:
        ring[:, :s] = kv
        return ring
    pos = torch.arange(s - slots, s, device=kv.device)
    ring[:, pos % slots] = kv[:, s - slots:]
    return ring


def _fill_linear(x: torch.Tensor, max_seq: int) -> torch.Tensor:
    """(B,S,R) -> (B,max_seq,R), zero-padded."""
    out = x.new_zeros((x.shape[0], max_seq) + x.shape[2:])
    out[:, :x.shape[1]] = x
    return out


# ---------------------------------------------------------------------------
# chunked prefill (serving engine: attend a C-token chunk against the cache
# prefix, then append the chunk's K/V — Sarathi-style chunked prefill)
# ---------------------------------------------------------------------------

def _write_chunk(cache: torch.Tensor, new: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """cache (B,Smax,...) <- new (B,C,...) at rows [lengths, lengths+C), in
    place.  Rows at or past Smax are dropped, as JAX's scatter drops them
    silently: bucket padding can reach past the cache, and an index out of
    range would be a device-side assert on the card.

    The drop keeps shapes static, so the write never waits for the device
    and can be captured in a CUDA graph: each dropped row is sent to the
    last slot carrying exactly the value that slot ends with (the chunk's
    row that lands there, else the slot's current value), so the writes
    that meet there agree."""
    b, c = new.shape[:2]
    last = cache.shape[1] - 1
    lengths = lengths.to(cache.device).long()
    cols = lengths[:, None] + torch.arange(c, device=cache.device)
    rows = torch.arange(b, device=cache.device)
    lands = (lengths <= last) & (lengths + c > last)
    landing = new[rows, (last - lengths).clamp(0, c - 1)].to(cache.dtype)
    tail = torch.where(lands.view((b,) + (1,) * (new.dim() - 2)), landing,
                       cache[:, last])
    keep = (cols <= last).view((b, c) + (1,) * (new.dim() - 2))
    vals = torch.where(keep, new.to(cache.dtype), tail[:, None])
    cache[rows[:, None], cols.clamp(max=last)] = vals
    return cache


#: logical axes of each cache entry (the reference's ``CACHE_AXES``)
CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", None),
    "v": ("batch", "cache_seq", "kv_heads", None),
    "c": ("batch", "cache_seq", None),
    "k_rope": ("batch", "cache_seq", None),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "ff", None),
    "enc_out": ("batch", None, None),
    "enc_k": ("batch", None, None, None),
    "enc_v": ("batch", None, None, None),
}


def cache_axes(cache: List[Cache]) -> List[Dict[str, tuple]]:
    """The logical axes of every tensor of a cache (one dict per layer, as
    ``Model.zero_cache`` and ``Model.cache_spec`` give it)."""
    return [{k: _axes_for(k, t.dim()) for k, t in layer.items()}
            for layer in cache]


def _axes_for(key: str, nd: int) -> tuple:
    axes = CACHE_AXES.get(key, ())
    if len(axes) < nd:                      # leading dims without a name
        axes = (None,) * (nd - len(axes)) + tuple(axes)
    return tuple(axes[-nd:]) if nd else ()


def prefill_chunk_attention(attn: attn_mod.Attention, x: torch.Tensor,
                            cache: Dict[str, torch.Tensor], *,
                            lengths: torch.Tensor, window: int = 0,
                            impl: str = "auto") -> torch.Tensor:
    """Chunked prefill against an absolute-position cache.  x: (B,C,D) the
    chunk; lengths (B,): tokens already cached per row.  Writes the chunk's
    K/V into ``cache`` at [lengths, lengths+C) in place, attends the chunk
    against the cache and returns out (B,C,D)."""
    cfg = attn.cfg
    b, c, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = lengths.long()[:, None] + torch.arange(c, device=x.device)
    q = attn.q_proj(x).reshape(b, c, cfg.n_heads, hd)
    k, v = attn_mod.compute_kv(attn, x, positions)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    _write_chunk(cache["k"], k, lengths)
    _write_chunk(cache["v"], v, lengths)
    y = ref.chunk_cache_attention_impl(impl)(
        q, cache["k"], cache["v"], lengths, window=window)
    return attn.o_proj(y.reshape(b, c, cfg.n_heads * hd))


def block_prefill_chunk(block: Block, x: torch.Tensor, cache: Cache, *,
                        lengths: torch.Tensor, impl: str) -> torch.Tensor:
    """x: (B,C,D) chunk; lengths (B,): tokens already cached per row.
    Engine caches are absolute-position (use_ring=False); ``cache`` is
    updated in place.  A Mamba mixer continues from the cache's conv tail
    and SSM state and writes the chunk's into it; a cross block attends
    the cache's encoder memory (``enc_k``, ``enc_v``)."""
    desc = block.desc
    h = block.ln1(x)
    if desc.kind == "mamba":
        return _res(x, _mamba_chunk(block.mamba, h, cache, impl))
    if block.cfg.attn_type == "mla":
        y = mla_mod.mla_prefill_chunk(block.mla_attn, h, cache,
                                      lengths=lengths, write_chunk=_write_chunk)
    else:
        y = prefill_chunk_attention(block.self_attn, h, cache, lengths=lengths,
                                    window=desc.window, impl=impl)
    if desc.kind == "hybrid":
        y = y + _mamba_chunk(block.mamba, h, cache, impl)
    x = _cross(block, _res(x, y), _cache_memory(block, cache), impl)
    return _res(x, _ffn(block, x)[0])


def _cache_memory(block: Block, cache: Cache) -> EncKV:
    return (cache["enc_k"], cache["enc_v"]) if block.desc.cross else None


def _mamba_chunk(mamba: mamba_mod.Mamba, h: torch.Tensor, cache: Cache,
                 impl: str) -> torch.Tensor:
    y, (tail, hs) = mamba(h, h0=cache["h"], conv_tail=cache["conv"],
                          return_state=True, impl=impl)
    cache["conv"].copy_(tail)
    cache["h"].copy_(hs)
    return y


# ---------------------------------------------------------------------------
# one-token decode
# ---------------------------------------------------------------------------

def block_decode(block: Block, x: torch.Tensor, cache: Cache, *,
                 lengths: torch.Tensor, impl: str,
                 kv_seq_shards: int = 1) -> torch.Tensor:
    """x: (B,1,D); ``cache`` is updated in place.  Like the reference, a
    Mamba mixer advances the state of every row, idle ones included, and
    sliding-window attention decodes without its window.  A cross block's
    one query row attends the cache's whole encoder memory."""
    desc = block.desc
    h = block.ln1(x)
    if desc.kind == "mamba":
        return _res(x, _mamba_step(block, h, cache, impl))
    if block.cfg.attn_type == "mla":
        y = mla_mod.mla_decode(block.mla_attn, h, cache, lengths=lengths)
    else:
        y = attn_mod.decode_attention(block.self_attn, h, cache,
                                      lengths=lengths, window=desc.window,
                                      impl=impl, kv_seq_shards=kv_seq_shards)
    if desc.kind == "hybrid":
        y = y + _mamba_step(block, h, cache, impl)
    x = _cross(block, _res(x, y), _cache_memory(block, cache), impl)
    return _res(x, _ffn(block, x)[0])


def _mamba_step(block: Block, h: torch.Tensor, cache: Cache,
                impl: str) -> torch.Tensor:
    y, state = mamba_mod.mamba_step(block.mamba, h, cache, block.cfg,
                                    impl=impl)
    cache["conv"].copy_(state["conv"])
    cache["h"].copy_(state["h"])
    return y


def block_cache(cfg: ModelConfig, desc: BlockDesc, batch: int, max_seq: int,
                *, device, dtype, use_ring: bool = True,
                enc_len: int = 0) -> Cache:
    """One block's zeroed decode cache (the reference's
    ``block_cache_spec``, with a cross block's ``enc_k``/``enc_v`` of
    ``enc_len`` rows, as the reference's ``Model.cache_spec`` adds them).
    use_ring=False (serving engine): absolute-position caches even for
    sliding-window layers, so chunked prefill can address slots directly."""
    kw = dict(device=device, dtype=dtype)
    cache: Cache = {}
    if desc.kind != "mamba":
        if cfg.attn_type == "mla":
            cache.update(mla_mod.init_mla_cache(cfg, batch, max_seq, **kw))
        else:
            cache.update(attn_mod.init_kv_cache(
                cfg, batch, max_seq, desc.window if use_ring else 0, **kw))
    if desc.kind in ("mamba", "hybrid"):
        cache.update(mamba_mod.init_mamba_state(cfg, batch, **kw))
    if desc.cross:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache.update(enc_k=torch.zeros(shape, **kw),
                     enc_v=torch.zeros(shape, **kw))
    return cache


#: logical axes of each cache entry (the reference's ``CACHE_AXES``)
CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", None),
    "v": ("batch", "cache_seq", "kv_heads", None),
    "c": ("batch", "cache_seq", None),
    "k_rope": ("batch", "cache_seq", None),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "ff", None),
    "enc_out": ("batch", None, None),
    "enc_k": ("batch", None, None, None),
    "enc_v": ("batch", None, None, None),
}


def cache_axes(cache: List[Cache]) -> List[Dict[str, tuple]]:
    """The logical axes of every tensor of a cache (one dict per layer, as
    ``Model.zero_cache`` and ``Model.cache_spec`` give it)."""
    return [{k: _axes_for(k, t.dim()) for k, t in layer.items()}
            for layer in cache]


def _axes_for(key: str, nd: int) -> tuple:
    axes = CACHE_AXES.get(key, ())
    if len(axes) < nd:                      # leading dims without a name
        axes = (None,) * (nd - len(axes)) + tuple(axes)
    return tuple(axes[-nd:]) if nd else ()
