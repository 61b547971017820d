"""Execution context emulation (paper §5.2 / I2) for the stateful
``self_attn`` module.

Counterpart of ``repro.serving.context``.  Decode-phase attention cannot be
profiled from a trace alone: it needs KV-cache memory and per-request
lengths.  The builders here reuse the serving engine's own code — the
``Attention`` module and the same cache-write and attention functions the
engine runs — parameterized by phase and backend, so the profiled
computation is exactly the served computation.

``build_context(cfg, "self_attn", ...)`` returns a ``ModuleContext``:
``params`` and ``input_spec(toks, reqs, ctx)`` are ``TensorSpec`` stand-ins,
``materialize`` turns them into tensors on the context's device from a
seeded ``torch.Generator``, ``module(weights)`` binds weights into the
engine's ``Attention`` module, and ``fn(module, *inputs)`` runs one call.
The other module kinds (MLA, Mamba, MoE, cross-attention) come with their
families' slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.models import attention as attn_mod
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
        reference's ``materialize``."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def gen(x):
            if isinstance(x, TensorSpec):
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

    def module(self, weights: Mapping[str, torch.Tensor]) -> attn_mod.Attention:
        """The engine's ``Attention`` module holding ``weights``."""
        attn = attn_mod.Attention(self.cfg, device=self.device,
                                  dtype=getattr(torch, self.cfg.dtype))
        attn.load_state_dict(weights)
        return attn.requires_grad_(False)


def build_context(cfg: ModelConfig, kind: str, *, phase: str = "prefill",
                  backend: str = "xla", window: int = 0,
                  device: Device = "cuda") -> ModuleContext:
    dev = resolve_device(device)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    # only *latency-relevant* attributes enter the signature digest, so
    # layers of equal geometry in different models dedup (paper Table 2)
    attrs = {"kind": kind, "window": window, "d_model": d}
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

