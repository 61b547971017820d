"""Public model API: ``Model(cfg)`` — forward, training loss, full-sequence
prefill, chunked prefill, one-token decode and zeroed caches.

Counterpart of ``repro.models.zoo`` for dense and Mamba decoders.
Submodule names follow the reference trace's scopes
(``layers.{i}.self_attn.q_proj``, ``layers.{i}.mamba.in_proj``, ...) so a
module-hook tracer finds the stateful ``self_attn`` and ``mamba`` modules.

A cache is a list with one dict per layer: ``{"k", "v"}`` for attention,
each tensor (B, slots, KV, hd); ``{"conv", "h"}`` for Mamba, the conv tail
(B, kw-1, Di) and the float32 SSM state (B, Di, N).  ``prefill_chunk`` and
``decode_step`` write into the cache they are given, in place, and return
it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Embedding, Linear, RMSNorm

Cache = List[Dict[str, torch.Tensor]]


class TiedHead(nn.Module):
    """The output projection of a model with tied embeddings: logits from the
    embedding table, as ``lm_head`` so that the head's product runs in the
    ``lm_head`` scope as the reference's does.  It holds no weights."""

    def forward(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return x @ table.T


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: Device = "cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        """Weights are drawn from ``generator`` (default: a generator on
        ``device`` seeded with 0) in ``dtype`` (default: ``cfg.dtype``)."""
        super().__init__()
        if cfg.is_encdec or cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: enc-dec and frontends are "
                                      "not ported")
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.descs = tfm.layer_descs(cfg)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(tfm.Block(cfg, d, **kw) for d in self.descs)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=dev)
        self.lm_head = (TiedHead() if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab_size, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.cfg.tie_embeddings:
            logits = self.lm_head(x, self.embed.table)
        else:
            logits = self.lm_head(x)
        return logits.float()

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------------
    # forward (train / full-sequence)
    # ------------------------------------------------------------------

    def forward(self, tokens, *, impl: str = "auto",
                remat: Optional[bool] = None) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V) float32.

        ``remat`` (default ``cfg.remat``) recomputes each layer in the
        backward instead of keeping its activations, as the reference's
        ``jax.checkpoint`` around its layer period does; it applies only
        while autograd records."""
        remat = self.cfg.remat if remat is None else remat
        x = self.embed(self._tokens(tokens))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for layer in self.layers:
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, impl=impl,
                               use_reentrant=False)
            else:
                x = layer(x, positions, impl=impl)
        return self._head(x)

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def loss(self, batch: Mapping[str, Any], *, impl: str = "auto",
             remat: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy over labels >= 0, plus the MoE
        auxiliary terms (zero for dense layers), as the reference's
        ``Model.loss``.  batch: ``tokens`` and ``labels`` (B,S).  Returns
        (total, metrics) with ``ce``, ``load_balance``, ``router_z`` and
        ``tokens``; the metrics are detached."""
        logits = self.forward(batch["tokens"], impl=impl, remat=remat)
        labels = self._tokens(batch["labels"])
        mask = (labels >= 0).float()
        safe = labels.clamp(min=0)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
        ce = ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)
        zero = torch.zeros((), device=logits.device)
        aux = {"load_balance": zero, "router_z": zero}
        total = ce + 0.01 * aux["load_balance"] + 1e-3 * aux["router_z"]
        metrics = {"ce": ce.detach(), **aux, "tokens": mask.sum()}
        return total, metrics

    # ------------------------------------------------------------------
    # prefill -> cache
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens, *, max_seq: int, impl: str = "auto"
                ) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence pass that fills the decode cache: K/V for
        attention layers, the conv tail and final SSM state for Mamba
        layers.

        Returns (logits at the last position (B, vocab), cache)."""
        x = self.embed(self._tokens(tokens))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cache = []
        for layer in self.layers:
            x, c = tfm.block_apply(layer, x, positions=positions, impl=impl,
                                   collect_cache=True, max_seq=max_seq)
            cache.append(c)
        return self._head(x[:, -1:])[:, 0], cache

    # ------------------------------------------------------------------
    # one-token decode
    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens, lengths: torch.Tensor, *,
                    impl: str = "auto", kv_seq_shards: int = 1
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B,) or (B,1); lengths (B,) int32 = context size so far.
        Returns (logits (B,V), cache updated in place)."""
        tokens = self._tokens(tokens)
        if tokens.dim() == 1:
            tokens = tokens[:, None]
        x = self.embed(tokens)
        for layer, c in zip(self.layers, cache):
            x = tfm.block_decode(layer, x, c, lengths=lengths, impl=impl,
                                 kv_seq_shards=kv_seq_shards)
        return self._head(x)[:, 0], cache

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------

    def zero_cache(self, batch: int, max_seq: int,
                   use_ring: bool = True) -> Cache:
        """use_ring=False (serving engine): absolute-position caches even
        for sliding-window layers, so chunked prefill can address slots.
        A Mamba layer's state does not depend on ``max_seq``."""
        kw = dict(device=self.device, dtype=self.dtype)
        return [mamba_mod.init_mamba_state(self.cfg, batch, **kw)
                if d.kind == "mamba" else attn_mod.init_kv_cache(
                    self.cfg, batch, max_seq, d.window if use_ring else 0, **kw)
                for d in self.descs]

    # ------------------------------------------------------------------
    # chunked prefill (serving engine path; caches are absolute-position)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill_chunk(self, cache: Cache, tokens, lengths: torch.Tensor, *,
                      impl: str = "auto",
                      last_pos: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B,C): next C prompt tokens per row; lengths (B,): tokens
        already cached.  Returns (logits at ``last_pos`` (default: the
        chunk's last position) (B,V), cache updated in place).  last_pos
        (B,) indexes within the chunk — used when the engine pads chunks to
        size buckets."""
        x = self.embed(self._tokens(tokens))
        for layer, c in zip(self.layers, cache):
            x = tfm.block_prefill_chunk(layer, x, c, lengths=lengths,
                                        impl=impl)
        if last_pos is None:
            xl = x[:, -1:]
        else:
            idx = last_pos.to(x.device).long()[:, None, None]
            xl = torch.take_along_dim(x, idx, dim=1)
        return self._head(xl)[:, 0], cache


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict from the reference's parameter tree
    (``repro.models.build_model(cfg).init(key)`` mapped to numpy arrays).

    The reference stacks each position of its layer period along a leading
    dim: layer ``i`` is ``blocks[i % p][...][i // p]``."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    blocks = tree["blocks"]
    p = len(blocks)
    out = {"embed.table": t(tree["embed"]["table"]),
           "final_norm.scale": t(tree["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        out["lm_head.w"] = t(tree["lm_head"]["w"])
    names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}
    kinds = cfg.layer_kinds()
    for i in range(cfg.n_layers):
        blk, j = blocks[i % p], i // p
        pre = f"layers.{i}."
        out[pre + "ln1.scale"] = t(blk["ln1"]["scale"][j])
        if kinds[i] == "mamba":
            m = blk["mamba"]
            for a in ("in_proj", "x_proj", "out_proj"):
                out[pre + f"mamba.{a}.w"] = t(m[a]["w"][j])
            for a in ("conv_w", "conv_b", "dt_w", "dt_b", "A_log", "D"):
                out[pre + f"mamba.{a}"] = t(m[a][j])
            continue
        out[pre + "ln2.scale"] = t(blk["ln2"]["scale"][j])
        for a, name in names.items():
            out[pre + f"self_attn.{name}.w"] = t(blk["attn"][a]["w"][j])
        for a in ("up", "gate", "down"):
            if a in blk["ffn"]:
                out[pre + f"mlp.{a}_proj.w"] = t(blk["ffn"][a]["w"][j])
    return out
