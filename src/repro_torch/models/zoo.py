"""Public model API: ``Model(cfg)`` — forward, training loss, full-sequence
prefill, chunked prefill, one-token decode and zeroed caches.

Counterpart of ``repro.models.zoo`` for decoders of the dense, MLA, MoE,
Mamba and hybrid kinds, encoder-decoders, and stub frontends.  Submodule
names follow the reference trace's scopes (``layers.{i}.self_attn.q_proj``,
``layers.{i}.mla_attn.q_down``, ``layers.{i}.moe.router``,
``layers.{i}.mamba.in_proj``, ``layers.{i}.cross_attn.q_proj``,
``enc_layers.{i}.self_attn``, ...) so a module-hook tracer finds the
stateful ``self_attn``, ``cross_attn``, ``mla_attn``, ``moe`` and ``mamba``
modules.

``frames`` (B, F, d_model) are a stub frontend's precomputed embeddings, as
the reference's ``batch["frames"]``: an enc-dec model encodes them and its
decoder attends the encoder's memory; a vision or audio frontend that is
not enc-dec prepends them to the token embeddings (the ``frontend`` scope),
and ``forward`` drops their logits.

A cache is a list with one dict per layer: ``{"k", "v"}`` for attention,
each tensor (B, slots, KV, hd); ``{"c", "k_rope"}`` for MLA, the latent
(B, Smax, kv_lora_rank) and the rotary key (B, Smax, qk_rope_head_dim);
``{"conv", "h"}`` for Mamba, the conv tail (B, kw-1, Di) and the float32
SSM state (B, Di, N); a hybrid layer holds ``k``, ``v``, ``conv`` and
``h``; a cross layer also holds the encoder memory's ``enc_k`` and
``enc_v``, each (B, enc_len, KV, hd).  ``prefill_chunk`` and
``decode_step`` write into the cache they are given, in place, and return
it.

For the dry run (``launch.dryrun``) the model describes itself without
allocating: ``param_axes`` (each parameter's logical axes: the reference's
``ParamSpec.axes`` without its stacked ``layers`` axis, as the port keeps
one tensor per layer), ``abstract_params``, ``cache_spec`` and
``input_specs``, all meta tensors of the reference's shapes and dtypes.
``param_stacks`` names the port's parameters that each of the reference's
leaves stacks, so an optimizer can treat them as the reference does.
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
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Embedding, Linear, RMSNorm
from repro_torch.parallel.sharding import (_is_dtensor, constrain, from_local,
                                           gathered, local_like, local_offset)

Cache = List[Dict[str, torch.Tensor]]

#: the aux losses of a model without MoE layers (the reference's ZERO_AUX)
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


class TiedHead(nn.Module):
    """The output projection of a model with tied embeddings: logits from the
    embedding table, as ``lm_head`` so that the head's product runs in the
    ``lm_head`` scope as the reference's does.  It holds no weights."""

    def forward(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        return x @ gathered(table, ("vocab", "embed_fsdp")).T


class Frontend(nn.Module):
    """A stub frontend's frames prepended to the token embeddings, as a
    module so that the concatenation runs in the ``frontend`` scope as the
    reference's does.  It holds no weights."""

    def forward(self, frames: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([frames, x], dim=1)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: Device = "cuda",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        """Weights are drawn from ``generator`` (default: a generator on
        ``device`` seeded with 0) in ``dtype`` (default: ``cfg.dtype``)."""
        super().__init__()
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
                        else Linear(cfg.d_model, cfg.vocab_size,
                                    axes=("embed_fsdp", "vocab"), **kw))
        if cfg.is_encdec:
            enc = tfm.BlockDesc("dense", 0, cross=False)
            self.enc_layers = nn.ModuleList(
                tfm.Block(cfg, enc, **kw) for _ in range(cfg.n_enc_layers))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=dev)
        elif cfg.frontend != "none":
            self.frontend = Frontend()

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
        return constrain(logits.float(), "batch", None, "vocab")

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, device=self.device).to(self.dtype)

    def _embed_inputs(self, tokens, frames) -> Tuple[torch.Tensor, int]:
        """Token embeddings, with a non-enc-dec frontend's frames prepended
        when given; and the number of frames prepended."""
        x = self.embed(self._tokens(tokens))
        n_front = 0
        if frames is not None and hasattr(self, "frontend"):
            frames = self._frames(frames)
            x, n_front = self.frontend(frames, x), frames.shape[1]
        return constrain(x, "batch", None, None), n_front

    def _enc_out(self, frames, impl: str) -> Optional[torch.Tensor]:
        if not self.cfg.is_encdec:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name}: an enc-dec model needs frames")
        return self.encode(frames, impl=impl)

    @staticmethod
    def _enc_kv(layer: tfm.Block, enc_out: Optional[torch.Tensor]
                ) -> tfm.EncKV:
        """The encoder memory of a cross layer: its K/V projections of the
        encoder output, in the layer's scope, unrotated."""
        if enc_out is None:
            return None
        return attn_mod.compute_kv(layer, enc_out)

    # ------------------------------------------------------------------
    # encoder (enc-dec only)
    # ------------------------------------------------------------------

    def encode(self, frames, *, impl: str = "auto") -> torch.Tensor:
        """frames (B,F,d_model) -> the encoder output (B,F,d_model): the
        encoder's dense blocks run non-causally, then ``enc_norm``."""
        x = constrain(self._frames(frames), "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for layer in self.enc_layers:
            x, _ = layer(x, positions, impl=impl, causal=False)
        return self.enc_norm(x)

    # ------------------------------------------------------------------
    # forward (train / full-sequence)
    # ------------------------------------------------------------------

    def forward(self, tokens, *, frames=None, impl: str = "auto",
                remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (B,S) -> (logits (B,S,V) float32, aux): ``aux`` sums the
        MoE layers' ``load_balance`` and ``router_z`` (float32 scalars),
        zeros (``ZERO_AUX``) without MoE layers, as the reference's.
        ``frames`` (B,F,d_model): the encoder input of an enc-dec model, or
        a frontend's embeddings, prepended and cut from the logits.

        ``remat`` (default ``cfg.remat``) recomputes each layer in the
        backward instead of keeping its activations, as the reference's
        ``jax.checkpoint`` around its layer period does; it applies only
        while autograd records."""
        remat = self.cfg.remat if remat is None else remat
        enc_out = self._enc_out(frames, impl)
        x, n_front = self._embed_inputs(tokens, frames)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = dict(ZERO_AUX)
        for layer in self.layers:
            enc_kv = self._enc_kv(layer, enc_out)
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(layer, x, positions, impl=impl,
                                  enc_kv=enc_kv, use_reentrant=False)
            else:
                x, a = layer(x, positions, impl=impl, enc_kv=enc_kv)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in aux}
        logits = self._head(x)
        return (logits[:, n_front:] if n_front else logits), aux

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------

    def loss(self, batch: Mapping[str, Any], *, impl: str = "auto",
             remat: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy over labels >= 0, plus the MoE
        auxiliary terms, as the reference's ``Model.loss``.  batch:
        ``tokens`` and ``labels`` (B,S).  Returns (total, metrics) with
        ``ce``, ``load_balance``, ``router_z`` and ``tokens``; the metrics
        are detached."""
        logits, aux = self.forward(batch["tokens"], frames=batch.get("frames"),
                                   impl=impl, remat=remat)
        labels = self._tokens(batch["labels"])
        mask = (labels >= 0).float()
        safe = labels.clamp(min=0)
        lse = _logsumexp_last(logits)
        ll = _pick_last(logits, safe)
        ce = ((lse - ll) * mask).sum() / mask.sum().clamp(min=1.0)
        aux = {k: torch.as_tensor(v, dtype=torch.float32, device=logits.device)
               for k, v in aux.items()}
        total = ce + 0.01 * aux["load_balance"] + 1e-3 * aux["router_z"]
        metrics = {"ce": ce.detach(), **{k: v.detach() for k, v in aux.items()},
                   "tokens": mask.sum()}
        return total, metrics

    # ------------------------------------------------------------------
    # prefill -> cache
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens, *, max_seq: int, frames=None,
                impl: str = "auto") -> Tuple[torch.Tensor, Cache]:
        """Full-sequence pass that fills the decode cache: K/V for
        attention layers, the latent and rotary key for MLA layers, the
        conv tail and final SSM state for Mamba mixers, the encoder memory
        for cross layers.  ``frames`` as in ``forward``; a frontend's frames
        take the first cache rows.

        Returns (logits at the last position (B, vocab), cache)."""
        enc_out = self._enc_out(frames, impl)
        x, _ = self._embed_inputs(tokens, frames)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        cache = []
        for layer in self.layers:
            enc_kv = self._enc_kv(layer, enc_out)
            x, _, c = tfm.block_apply(layer, x, positions=positions,
                                      impl=impl, enc_kv=enc_kv,
                                      collect_cache=True, max_seq=max_seq)
            if enc_kv is not None:
                c = dict(c or {}, enc_k=enc_kv[0], enc_v=enc_kv[1])
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
        x = constrain(self.embed(tokens), "batch", None, None)
        for layer, c in zip(self.layers, cache):
            x = tfm.block_decode(layer, x, c, lengths=lengths, impl=impl,
                                 kv_seq_shards=kv_seq_shards)
        return self._head(x)[:, 0], cache

    # ------------------------------------------------------------------
    # abstract description (dry run)
    # ------------------------------------------------------------------

    def param_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """{parameter name: its logical axes}, from the module that holds
        it (``axes``)."""
        out = {}
        for name, _ in self.named_parameters():
            owner, _, leaf = name.rpartition(".")
            out[name] = self.get_submodule(owner).axes[leaf]
        return out

    def param_stacks(self) -> Dict[str, Tuple[str, ...]]:
        """{stacked reference leaf (``stack_key``): the parameter names it
        stacks, in order}: ``params_from_jax``'s layout inverted, what an
        optimizer needs to treat the per-layer tensors as the reference's
        leaves.  The ``blocks`` and ``enc_blocks`` leaves stack layers j,
        j + p, j + 2p, ... of period position j along a leading dim.  A
        parameter named in no stack is a leaf of the reference's as it is
        (``embed``, ``final_norm``, ``enc_norm``, ``lm_head``), at the
        path its name spells with ``/`` for ``.``."""
        out: Dict[str, List[str]] = {}
        for path, j, name in _leaf_map(self.cfg, period(self.cfg)):
            if j is not None:
                out.setdefault(stack_key(path), []).append(name)
        return {k: tuple(v) for k, v in out.items()}

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        """{parameter name: a meta tensor of its shape and dtype}."""
        return {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in self.named_parameters()}

    def cache_spec(self, batch: int, max_seq: int, enc_len: int = 0,
                   use_ring: bool = True) -> Cache:
        """``zero_cache``'s layout as meta tensors."""
        return [tfm.block_cache(self.cfg, d, batch, max_seq, device="meta",
                                dtype=self.dtype, use_ring=use_ring,
                                enc_len=enc_len)
                for d in self.descs]

    def input_specs(self, shape) -> Dict[str, Any]:
        """Meta tensors standing in for one step's inputs at an assigned
        shape (``configs.SHAPES``), as the reference's: ``{"batch":
        {tokens[, labels][, frames]}}`` for train and prefill, ``{"cache",
        "tokens", "lengths"}`` for decode (one token against a cache of
        ``seq_len``).  Token ids and lengths are int32."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, self.dtype

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        def text_batch(with_labels: bool):
            out = {}
            s_text = s
            if cfg.is_encdec:
                enc_len = min(s, cfg.n_frontend_tokens or s)
                out["frames"] = meta((b, enc_len, cfg.d_model), dt)
            elif cfg.frontend != "none":
                s_text = max(s - cfg.n_frontend_tokens, 1)
                out["frames"] = meta((b, cfg.n_frontend_tokens, cfg.d_model), dt)
            out["tokens"] = meta((b, s_text), i32)
            if with_labels:
                out["labels"] = meta((b, s_text), i32)
            return out

        if shape.kind == "train":
            return {"batch": text_batch(True)}
        if shape.kind == "prefill":
            return {"batch": text_batch(False)}
        enc_len = min(s, cfg.n_frontend_tokens or s) if cfg.is_encdec else 0
        return {"cache": self.cache_spec(b, s, enc_len),
                "tokens": meta((b,), i32), "lengths": meta((b,), i32)}

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------

    def zero_cache(self, batch: int, max_seq: int, enc_len: int = 0,
                   use_ring: bool = True) -> Cache:
        """use_ring=False (serving engine): absolute-position caches even
        for sliding-window layers, so chunked prefill can address slots.
        A Mamba layer's state does not depend on ``max_seq``; a cross
        layer's encoder memory has ``enc_len`` rows."""
        return [tfm.block_cache(self.cfg, d, batch, max_seq, device=self.device,
                                dtype=self.dtype, use_ring=use_ring,
                                enc_len=enc_len)
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
        x = constrain(self.embed(self._tokens(tokens)), "batch", None, None)
        for layer, c in zip(self.layers, cache):
            x = tfm.block_prefill_chunk(layer, x, c, lengths=lengths,
                                        impl=impl)
        if last_pos is None:
            xl = x[:, -1:]
        else:
            idx = last_pos.to(x.device).long()[:, None, None]
            xl = torch.take_along_dim(x, idx, dim=1)
        return self._head(xl)[:, 0], cache


def _shard_rows(x: torch.Tensor, idx=None):
    """For a DTensor whose last dim may be sharded: its rows' placements
    (the last dim's shards replicated), its local shard, the offset of the
    local last dim, and the mesh dims sharding the last dim; and ``idx``'s
    shard laid out as the rows."""
    from torch.distributed.tensor import Replicate
    mesh, last = x.device_mesh, x.dim() - 1
    rows = [p if p.is_shard() and p.dim < last else Replicate()
            for p in x.placements]
    cut = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
    li = None if idx is None else local_like(idx, mesh, rows)
    return rows, x.to_local(), local_offset(x)[-1], cut, li


def _reduce(t: torch.Tensor, x, rows, cut, op: str) -> torch.Tensor:
    """``t`` (a function of this device's shard of ``x``'s last dim)
    reduced by ``op`` over the mesh dims in ``cut``, as a DTensor laid out
    as ``x``'s rows."""
    from torch.distributed.tensor import Partial
    src = [Partial(op) if i in cut else p for i, p in enumerate(rows)]
    return from_local(t, x.device_mesh, src, tuple(x.shape[:-1])
                      ).redistribute(x.device_mesh, rows)


def _logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``; on a DTensor, on each device's shard of
    the last dim (the vocab), the max and the sum reduced over the mesh
    dims that shard it, as vocab-parallel cross-entropy does."""
    if not _is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    rows, local, _, cut, _ = _shard_rows(x)
    m = _reduce(local.detach().amax(-1), x, rows, cut, "max")
    s = _reduce(torch.exp(local - m.to_local()[..., None]).sum(-1), x, rows,
                cut, "sum")
    return m + torch.log(s)


def _pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` row by row (``torch.gather`` on the last dim).  On a
    DTensor each device picks from its own shard of the last dim (the
    vocab), zero where the index is not in it, and the picks are summed
    over the mesh dims that shard it, as vocab-parallel cross-entropy
    does; DTensor's own gather would replicate the logits."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    rows, local, off, cut, li = _shard_rows(x, idx)
    li = li.long() - off
    ok = (li >= 0) & (li < local.shape[-1])
    picked = torch.gather(local, -1, li.clamp(0, local.shape[-1] - 1)[..., None])
    return _reduce(torch.where(ok, picked[..., 0], 0.0), x, rows, cut, "sum")


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict from the reference's parameter tree
    (``repro.models.build_model(cfg).init(key)`` mapped to numpy arrays).

    The reference stacks each position of its layer period along a leading
    dim: layer ``i`` is ``blocks[i % p][...][i // p]``."""
    out = {}
    for path, j, name in _leaf_map(cfg, len(tree["blocks"])):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = torch.from_numpy(np.array(leaf if j is None else leaf[j],
                                              copy=True))
    return out


def period(cfg: ModelConfig) -> int:
    """The length of the reference's layer period: the smallest p whose
    pattern of block descriptions repeats over the layers."""
    descs = tfm.layer_descs(cfg)
    n = len(descs)
    return next((p for p in range(1, n + 1)
                 if n % p == 0 and descs == descs[:p] * (n // p)), n)


def stack_key(path: Tuple) -> str:
    """A reference leaf's path as one string, ``blocks/0/attn/q/w``."""
    return "/".join(str(k) for k in path)


def _leaf_map(cfg: ModelConfig, p: int):
    """(path into the reference's tree, index along its stacked dim or
    None, port parameter name) for every parameter, layer by layer."""
    yield ("embed", "table"), None, "embed.table"
    yield ("final_norm", "scale"), None, "final_norm.scale"
    if not cfg.tie_embeddings:
        yield ("lm_head", "w"), None, "lm_head.w"
    if cfg.is_encdec:
        yield ("enc_norm", "scale"), None, "enc_norm.scale"
        enc = ("enc_blocks", 0)
        for i in range(cfg.n_enc_layers):
            pre = f"enc_layers.{i}."
            for a in ("ln1", "ln2"):
                yield enc + (a, "scale"), i, pre + f"{a}.scale"
            for a, name in _ATTN_NAMES.items():
                yield enc + ("attn", a, "w"), i, pre + f"self_attn.{name}.w"
            yield from _mlp_leaves(enc + ("ffn",), cfg.act, i, pre + "mlp.")
    kinds = cfg.layer_kinds()
    for i in range(cfg.n_layers):
        blk, j = ("blocks", i % p), i // p
        pre = f"layers.{i}."
        yield blk + ("ln1", "scale"), j, pre + "ln1.scale"
        if cfg.is_encdec:
            x = blk + ("xattn",)
            yield blk + ("ln_x", "scale"), j, pre + "ln_x.scale"
            yield x + ("q", "w"), j, pre + "cross_attn.q_proj.w"
            yield x + ("o", "w"), j, pre + "cross_attn.o_proj.w"
            yield x + ("k", "w"), j, pre + "k_proj.w"
            yield x + ("v", "w"), j, pre + "v_proj.w"
        if kinds[i] in ("mamba", "hybrid"):
            m = blk + ("mamba",)
            for a in ("in_proj", "x_proj", "out_proj"):
                yield m + (a, "w"), j, pre + f"mamba.{a}.w"
            for a in ("conv_w", "conv_b", "dt_w", "dt_b", "A_log", "D"):
                yield m + (a,), j, pre + f"mamba.{a}"
        if kinds[i] == "mamba":
            continue
        yield blk + ("ln2", "scale"), j, pre + "ln2.scale"
        attn = blk + ("attn",)
        if cfg.attn_type == "mla":
            for a, name in _MLA_NAMES.items():
                leaf = "scale" if name.endswith("norm") else "w"
                yield attn + (a, leaf), j, pre + f"mla_attn.{name}.{leaf}"
        else:
            for a, name in _ATTN_NAMES.items():
                yield attn + (a, "w"), j, pre + f"self_attn.{name}.w"
        ffn = blk + ("ffn",)
        if kinds[i] == "moe":
            yield ffn + ("router", "w"), j, pre + "moe.router.w"
            for a in ("up", "gate", "down"):
                if a != "gate" or cfg.act == "silu":
                    yield ffn + (a, "w"), j, pre + f"moe.{a}"
            if cfg.n_shared_experts > 0:
                yield from _mlp_leaves(ffn + ("shared",), cfg.act, j,
                                       pre + "moe.shared.")
        else:
            yield from _mlp_leaves(ffn, cfg.act, j, pre + "mlp.")


#: the reference's attention parameters -> the port's projections
_ATTN_NAMES = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}
_MLA_NAMES = {"wdq": "q_down", "q_norm": "q_norm", "wuq": "q_up",
              "wdkv": "kv_down", "kv_norm": "kv_norm", "wuk": "k_up",
              "wuv": "v_up", "o": "o_proj"}


def _mlp_leaves(path: Tuple, act: str, j: int, prefix: str):
    for a in ("up", "gate", "down"):
        if a != "gate" or act == "silu":
            yield path + (a, "w"), j, prefix + f"{a}_proj.w"
