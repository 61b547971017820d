"""Execution context emulation (paper §5.2 / I2) for the stateful
``self_attn`` and ``mamba`` modules.

Counterpart of ``repro.serving.context``.  Decode-phase attention and Mamba
cannot be profiled from a trace alone: they need KV-cache memory and
per-request lengths, or the conv tail and SSM state.  The builders here
reuse the serving engine's own code — the ``Attention`` and ``Mamba``
modules and the same functions the engine runs — parameterized by phase and
backend, so the profiled computation is exactly the served computation.

``build_context(cfg, kind, ...)`` returns a ``ModuleContext``: ``params``
and ``input_spec(toks, reqs, ctx)`` are ``TensorSpec`` stand-ins,
``materialize`` turns them into tensors on the context's device from a
seeded ``torch.Generator`` (shapes only on the ``meta`` device),
``module(weights)`` binds weights into the engine's module of that kind,
and ``fn(module, *inputs)`` runs one call.  ``cached_build_context``
memoizes the builder, as the reference's does.  The other module kinds
(MLA, MoE, cross-attention) come with their families' slices.
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
from repro_torch.models.transformer import prefill_chunk_attention


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
                return (w * 0.02).to(x.dtype)
            if isinstance(x, Mapping):
                return {k: gen(v) for k, v in x.items()}
            return type(x)(gen(v) for v in x)
        return gen(tree)

    def module(self, weights: Mapping[str, torch.Tensor]) -> nn.Module:
        """The engine's module of this kind (``Attention`` or ``Mamba``)
        holding ``weights``."""
        cls = mamba_mod.Mamba if self.kind == "mamba" else attn_mod.Attention
        mod = cls(self.cfg, device=self.device,
                  dtype=getattr(torch, self.cfg.dtype))
        mod.load_state_dict(weights)
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
    if kind == "mamba":
        return _mamba_context(cfg, phase, backend, attrs, dev)
    if kind != "self_attn" or cfg.attn_type != "gqa":
        raise KeyError(f"no execution-context builder for module kind {kind!r} "
                       f"(attn_type {cfg.attn_type!r}) in the port yet")
    hd = cfg.resolved_head_dim
    attrs.update({"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                  "head_dim": hd, "causal": True})
    params = {f"{name}.w": TensorSpec(shape, dt) for name, shape in (
        ("q_proj", (d, cfg.n_heads * hd)), ("k_proj", (d, cfg.n_kv_heads * hd)),
        ("v_proj", (d, cfg.n_kv_heads * hd)), ("o_proj", (cfg.n_heads * hd, d)))}

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


def _mamba_context(cfg: ModelConfig, phase: str, backend: str,
                   attrs: Dict[str, Any], dev: torch.device) -> ModuleContext:
    """Prefill: the mixer over a fresh sequence (no state in, as the
    reference builds it); decode: one ``mamba_step`` from a given conv tail
    and SSM state."""
    d, di, st, kw = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    dtr = cfg.resolved_dt_rank
    dt, f32 = getattr(torch, cfg.dtype), torch.float32
    attrs.update({"d_inner": di, "state": st, "conv": kw, "dt_rank": dtr})
    params = {"in_proj.w": TensorSpec((d, 2 * di), dt),
              "conv_w": TensorSpec((kw, di), dt),
              "conv_b": TensorSpec((di,), dt),
              "x_proj.w": TensorSpec((di, dtr + 2 * st), dt),
              "dt_w": TensorSpec((dtr, di), dt),
              "dt_b": TensorSpec((di,), f32),
              "A_log": TensorSpec((di, st), f32),
              "D": TensorSpec((di,), f32),
              "out_proj.w": TensorSpec((di, d), dt)}
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
    return ModuleContext("mamba", phase, backend, fn, params, inputs, attrs,
                         cfg, dev)


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
