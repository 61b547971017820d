"""Execution context emulation (paper §5.2 / I2) for the stateful
``self_attn``, ``cross_attn``, ``mla_attn``, ``mamba`` and ``moe`` modules.

Counterpart of ``repro.serving.context``.  Decode-phase attention and Mamba
cannot be profiled from a trace alone: they need KV-cache memory and
per-request lengths, the latent cache, or the conv tail and SSM state.  The
builders here reuse the serving engine's own code — the ``Attention``,
``CrossAttention``, ``MLA``, ``Mamba`` and ``MoE`` modules and the same
functions the engine runs — parameterized by phase and backend, so the
profiled computation is exactly the served computation.  A ``self_attn``
entry of an MLA config gets the ``mla_attn`` context; ``cross_attn``
attends a memory of ctx encoder rows with toks query rows in prefill and
one in decode; ``moe`` is profiled in prefill only (a decode step is a
one-token prefill).

``build_context(cfg, kind, ...)`` returns a ``ModuleContext``: ``params``
and ``input_spec(toks, reqs, ctx)`` are ``TensorSpec`` stand-ins,
``materialize`` turns them into tensors on the context's device from a
seeded ``torch.Generator`` (shapes only on the ``meta`` device),
``module(weights)`` binds weights into the engine's module of that kind,
and ``fn(module, *inputs)`` runs one call.  ``cached_build_context``
memoizes the builder, as the reference's does.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import prefill_chunk_attention

#: the engine's module of each stateful kind
MODULES = {"self_attn": attn_mod.Attention,
           "cross_attn": attn_mod.CrossAttention, "mla_attn": mla_mod.MLA,
           "mamba": mamba_mod.Mamba, "moe": moe_mod.MoE}


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet made (``jax.ShapeDtypeStruct``'s
    counterpart)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass
class ModuleContext:
    kind: str
    phase: str                       # 'prefill' | 'decode'
    backend: str
    fn: Callable                     # fn(module, *inputs)
    params: Dict[str, TensorSpec]    # the module's weights (abstract)
    input_spec: Callable             # (toks, reqs, ctx) -> tuple of TensorSpec
    static_attrs: Dict[str, Any]     # signature component 3
    cfg: ModelConfig
    device: torch.device

    def abstract_inputs(self, toks: int, reqs: int, ctx: int):
        return self.input_spec(toks, reqs, ctx)

    def materialize(self, tree, generator: Optional[torch.Generator] = None):
        """TensorSpecs (alone, or in a tuple, list or dict) -> tensors on the
        context's device: integers zero, floats normal * 0.02, as the
        reference's ``materialize``; empty tensors on the meta device."""
        meta = self.device.type == "meta"
        if generator is None and not meta:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def gen(x):
            if isinstance(x, TensorSpec):
                if meta:
                    return torch.empty(x.shape, dtype=x.dtype, device=self.device)
                if not x.dtype.is_floating_point:
                    return torch.zeros(x.shape, dtype=x.dtype,
                                       device=self.device)
                w = torch.randn(x.shape, generator=generator,
                                device=self.device, dtype=torch.float32)
                return w.mul_(0.02).to(x.dtype)
            if isinstance(x, Mapping):
                return {k: gen(v) for k, v in x.items()}
            return type(x)(gen(v) for v in x)
        return gen(tree)

    def module(self, weights: Mapping[str, torch.Tensor]) -> nn.Module:
        """The engine's module of this kind (``MODULES``) holding
        ``weights`` themselves: built on the meta device and the weights
        assigned, so no second copy is drawn (a llama4-maverick ``moe``
        layer is 32 GB in bf16)."""
        mod = MODULES[self.kind](self.cfg, device="meta",
                                 dtype=getattr(torch, self.cfg.dtype))
        mod.load_state_dict(weights, assign=True)
        return mod.requires_grad_(False)


def build_context(cfg: ModelConfig, kind: str, *, phase: str = "prefill",
                  backend: str = "xla", window: int = 0,
                  device: Device = "cuda") -> ModuleContext:
    dev = resolve_device(device)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    # only *latency-relevant* attributes enter the signature digest, so
    # layers of equal geometry in different models dedup (paper Table 2)
    attrs = {"kind": kind, "window": window, "d_model": d}
    if kind == "self_attn" and cfg.attn_type == "mla":
        kind = "mla_attn"
    if kind == "mamba":
        return _mamba_context(cfg, phase, backend, attrs, dev)
    if kind == "mla_attn":
        return _mla_context(cfg, phase, backend, attrs, dev)
    if kind == "moe":
        return _moe_context(cfg, phase, backend, attrs, dev)
    if kind == "cross_attn":
        return _cross_context(cfg, phase, backend, attrs, dev)
    if kind != "self_attn":
        raise KeyError(f"no execution-context builder for module kind "
                       f"{kind!r} in the port yet")
    hd = cfg.resolved_head_dim
    attrs.update({"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                  "head_dim": hd, "causal": True})
    params = _param_specs(kind, cfg)

    if phase == "prefill":
        # engine-faithful chunked prefill: the chunk's queries attend the
        # WHOLE cache (ctx slots) — cost O(toks * ctx).  ctx==0 profiles
        # the plain full-sequence prefill (cache sized to the chunk).
        @torch.no_grad()
        def fn(attn, x, k_cache, v_cache, lengths):
            return prefill_chunk_attention(
                attn, x, {"k": k_cache, "v": v_cache}, lengths=lengths,
                window=window, impl=backend)

        def inputs(toks, reqs, ctx):
            smax = max(ctx, toks)
            return (TensorSpec((reqs, toks, d), dt),
                    TensorSpec((reqs, smax, cfg.n_kv_heads, hd), dt),
                    TensorSpec((reqs, smax, cfg.n_kv_heads, hd), dt),
                    TensorSpec((reqs,), torch.int32))
    else:
        @torch.no_grad()
        def fn(attn, x, k_cache, v_cache, lengths):
            return attn_mod.decode_attention(
                attn, x, {"k": k_cache, "v": v_cache}, lengths=lengths,
                window=window, impl=backend)

        def inputs(toks, reqs, ctx):
            s = min(window, ctx) if window > 0 else ctx
            return (TensorSpec((reqs, 1, d), dt),
                    TensorSpec((reqs, s, cfg.n_kv_heads, hd), dt),
                    TensorSpec((reqs, s, cfg.n_kv_heads, hd), dt),
                    TensorSpec((reqs,), torch.int32))
    return ModuleContext(kind, phase, backend, fn, params, inputs, attrs,
                         cfg, dev)


def _cross_context(cfg: ModelConfig, phase: str, backend: str,
                   attrs: Dict[str, Any], dev: torch.device) -> ModuleContext:
    """Cross-attention of q_len = toks query rows in prefill, one in
    decode, against an encoder memory of ctx rows (``enc_k``, ``enc_v``),
    every key attended, as the reference builds it."""
    d, hd, dt = cfg.d_model, cfg.resolved_head_dim, getattr(torch, cfg.dtype)
    attrs.update({"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                  "head_dim": hd, "causal": False})

    @torch.no_grad()
    def fn(xattn, x, enc_k, enc_v):
        return xattn(x, enc_k, enc_v, impl=backend)

    def inputs(toks, reqs, ctx):
        q_len = toks if phase == "prefill" else 1
        return (TensorSpec((reqs, q_len, d), dt),
                TensorSpec((reqs, ctx, cfg.n_kv_heads, hd), dt),
                TensorSpec((reqs, ctx, cfg.n_kv_heads, hd), dt))
    return ModuleContext("cross_attn", phase, backend, fn,
                         _param_specs("cross_attn", cfg), inputs, attrs, cfg, dev)


def _mamba_context(cfg: ModelConfig, phase: str, backend: str,
                   attrs: Dict[str, Any], dev: torch.device) -> ModuleContext:
    """Prefill: the mixer over a fresh sequence (no state in, as the
    reference builds it); decode: one ``mamba_step`` from a given conv tail
    and SSM state."""
    d, di, st, kw = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = cfg.resolved_dt_rank
    dt, f32 = getattr(torch, cfg.dtype), torch.float32
    attrs.update({"d_inner": di, "state": st, "conv": kw, "dt_rank": dtr})
    if phase == "prefill":
        @torch.no_grad()
        def fn(m, x):
            return mamba_mod.mamba_mixer(m, x, cfg, impl=backend)

        def inputs(toks, reqs, ctx):
            return (TensorSpec((reqs, toks, d), dt),)
    else:
        @torch.no_grad()
        def fn(m, x, conv, h):
            out, _ = mamba_mod.mamba_step(m, x, {"conv": conv, "h": h}, cfg,
                                          impl=backend)
            return out

        def inputs(toks, reqs, ctx):
            return (TensorSpec((reqs, 1, d), dt),
                    TensorSpec((reqs, kw - 1, di), dt),
                    TensorSpec((reqs, di, st), f32))
    return ModuleContext("mamba", phase, backend, fn,
                         _param_specs("mamba", cfg), inputs, attrs, cfg, dev)


def _param_specs(kind: str, cfg: ModelConfig) -> Dict[str, TensorSpec]:
    """The weights of the engine's module of ``kind``, as TensorSpecs read
    from one built on the meta device."""
    mod = MODULES[kind](cfg, device="meta", dtype=getattr(torch, cfg.dtype))
    return {k: TensorSpec(tuple(v.shape), v.dtype)
            for k, v in mod.state_dict().items()}


def _mla_context(cfg: ModelConfig, phase: str, backend: str,
                 attrs: Dict[str, Any], dev: torch.device) -> ModuleContext:
    """Prefill: the expanded-K/V attention over a fresh sequence at given
    positions; decode: one absorbed step against a latent cache of ctx
    rows."""
    m, d, dt = cfg.mla, cfg.d_model, getattr(torch, cfg.dtype)
    attrs.update({"n_heads": cfg.n_heads, "q_lora_rank": m.q_lora_rank,
                  "kv_lora_rank": m.kv_lora_rank, "qk_nope": m.qk_nope_head_dim,
                  "qk_rope": m.qk_rope_head_dim, "v_head": m.v_head_dim})
    if phase == "prefill":
        @torch.no_grad()
        def fn(mla, x, positions):
            return mla_mod.mla_attention(mla, x, positions=positions,
                                         impl=backend)

        def inputs(toks, reqs, ctx):
            return (TensorSpec((reqs, toks, d), dt),
                    TensorSpec((reqs, toks), torch.int32))
    else:
        @torch.no_grad()
        def fn(mla, x, c, k_rope, lengths):
            return mla_mod.mla_decode(mla, x, {"c": c, "k_rope": k_rope},
                                      lengths=lengths)

        def inputs(toks, reqs, ctx):
            return (TensorSpec((reqs, 1, d), dt),
                    TensorSpec((reqs, ctx, m.kv_lora_rank), dt),
                    TensorSpec((reqs, ctx, m.qk_rope_head_dim), dt),
                    TensorSpec((reqs,), torch.int32))
    return ModuleContext("mla_attn", phase, backend, fn,
                         _param_specs("mla_attn", cfg), inputs, attrs, cfg, dev)


def _moe_context(cfg: ModelConfig, phase: str, backend: str,
                 attrs: Dict[str, Any], dev: torch.device) -> ModuleContext:
    """The dropping MoE FFN over (reqs, toks) tokens, one token a request
    in the decode phase."""
    d, dt = cfg.d_model, getattr(torch, cfg.dtype)
    attrs.update({"n_experts": cfg.n_experts, "top_k": cfg.top_k,
                  "moe_d_ff": cfg.moe_d_ff, "n_shared": cfg.n_shared_experts})

    @torch.no_grad()
    def fn(moe, x):
        return moe_mod.moe_ffn(moe, x)[0]

    def inputs(toks, reqs, ctx):
        return (TensorSpec((reqs, toks if phase == "prefill" else 1, d), dt),)
    return ModuleContext("moe", phase, backend, fn, _param_specs("moe", cfg),
                         inputs, attrs, cfg, dev)


_CONTEXT_CACHE: "OrderedDict[Tuple, Tuple[ModelConfig, ModuleContext]]" = \
    OrderedDict()
CONTEXT_CACHE_SIZE = 256


def cached_build_context(cfg: ModelConfig, kind: str, *,
                         phase: str = "prefill", backend: str = "xla",
                         window: int = 0, device: Device = "cuda"
                         ) -> ModuleContext:
    """Bounded LRU memo over ``build_context``, keyed by cfg *object*
    identity (configs are module-level singletons) and the device; the cfg
    is held in the value so an id() cannot be reused by a different live
    config."""
    dev = resolve_device(device)
    key = (id(cfg), kind, phase, backend, window, str(dev))
    hit = _CONTEXT_CACHE.get(key)
    if hit is not None and hit[0] is cfg:
        _CONTEXT_CACHE.move_to_end(key)
        return hit[1]
    mc = build_context(cfg, kind, phase=phase, backend=backend,
                       window=window, device=dev)
    _CONTEXT_CACHE[key] = (cfg, mc)
    while len(_CONTEXT_CACHE) > CONTEXT_CACHE_SIZE:
        _CONTEXT_CACHE.popitem(last=False)
    return mc


def phases_for(kind: str, cfg: ModelConfig) -> Tuple[str, ...]:
    """Which phases a stateful module must be profiled in (App. D)."""
    if kind == "moe":
        return ("prefill",)          # decode == prefill with toks=1
    return ("prefill", "decode")
