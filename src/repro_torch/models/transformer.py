"""Decoder blocks: full-sequence apply (train / prefill), chunked prefill
against a cache, and one-token decode.

Counterpart of ``repro.models.transformer`` for the dense and Mamba block
kinds.  The reference scans over a repeating period of layers; PyTorch runs
eagerly, so the port keeps one ``Block`` per layer (``layers.{i}``) and
loops over them.  Block kinds other than these (MoE, hybrid) and enc-dec
come with their families' slices.
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
from repro_torch.models.layers import MLP, RMSNorm, apply_rope

Cache = Dict[str, torch.Tensor]


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
    """One decoder layer.  Dense: ``ln1``, ``self_attn``, ``ln2``, ``mlp``;
    Mamba: ``ln1`` and ``mamba`` only, as the reference's ``block_spec``."""

    def __init__(self, cfg: ModelConfig, desc: BlockDesc, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dense = desc.kind == "dense" and cfg.attn_type == "gqa"
        if desc.cross or not (dense or desc.kind == "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: block kind {desc.kind!r} (cross={desc.cross}, "
                f"attn={cfg.attn_type!r}) is not ported; the port runs dense "
                "GQA decoders and Mamba blocks")
        self.cfg, self.desc = cfg, desc
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if desc.kind == "mamba":
            self.mamba = mamba_mod.Mamba(cfg, **kw)
            return
        self.self_attn = attn_mod.Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                impl: str) -> torch.Tensor:
        return block_apply(self, x, positions=positions, impl=impl)[0]


# ---------------------------------------------------------------------------
# full-sequence apply (train / prefill)
# ---------------------------------------------------------------------------

def block_apply(block: Block, x: torch.Tensor, *, positions: torch.Tensor,
                impl: str, causal: bool = True, collect_cache: bool = False,
                max_seq: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (x_out, cache_entry_or_None): ``{"k", "v"}`` for attention,
    ``{"conv", "h"}`` for Mamba."""
    desc = block.desc
    h = block.ln1(x)
    if desc.kind == "mamba":
        if not collect_cache:
            return x + block.mamba(h, impl=impl), None
        y, (tail, hs) = block.mamba(h, return_state=True, impl=impl)
        return x + y, {"conv": tail, "h": hs}
    y = block.self_attn(h, positions, causal=causal, window=desc.window,
                        impl=impl)
    cache = None
    if collect_cache:
        k, v = attn_mod.compute_kv(block.self_attn, h, positions)
        slots = min(desc.window, max_seq) if desc.window > 0 else max_seq
        cache = {"k": _fill_ring(k, slots), "v": _fill_ring(v, slots)}
    x = x + y
    x = x + block.mlp(block.ln2(x))
    return x, cache


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
    updated in place.  A Mamba block continues from the cache's conv tail
    and SSM state and writes the chunk's into it."""
    if block.desc.kind == "mamba":
        y, (tail, hs) = block.mamba(block.ln1(x), h0=cache["h"],
                                    conv_tail=cache["conv"], return_state=True,
                                    impl=impl)
        cache["conv"].copy_(tail)
        cache["h"].copy_(hs)
        return x + y
    y = prefill_chunk_attention(
        block.self_attn, block.ln1(x), cache, lengths=lengths,
        window=block.desc.window, impl=impl)
    x = x + y
    return x + block.mlp(block.ln2(x))


# ---------------------------------------------------------------------------
# one-token decode
# ---------------------------------------------------------------------------

def block_decode(block: Block, x: torch.Tensor, cache: Cache, *,
                 lengths: torch.Tensor, impl: str,
                 kv_seq_shards: int = 1) -> torch.Tensor:
    """x: (B,1,D); ``cache`` is updated in place.  Like the reference, a
    Mamba block advances the state of every row, idle ones included."""
    h = block.ln1(x)
    if block.desc.kind == "mamba":
        y, state = mamba_mod.mamba_step(block.mamba, h, cache, block.cfg,
                                        impl=impl)
        cache["conv"].copy_(state["conv"])
        cache["h"].copy_(state["h"])
        return x + y
    y = attn_mod.decode_attention(block.self_attn, h, cache, lengths=lengths,
                                  window=block.desc.window, impl=impl,
                                  kv_seq_shards=kv_seq_shards)
    x = x + y
    return x + block.mlp(block.ln2(x))
