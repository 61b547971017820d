"""Tainted Runner entry point (paper §4 workflow).

Counterpart of ``repro.core.runner``.  ``trace_model(cfg)`` performs the
single pass with a collision-free dummy prompt: it seeds the registry from
the model configuration (MODEL_CONFIG) and the dummy request (NUM_TOKS /
NUM_REQS), runs the forward of a ``Model`` whose parameters are on the
``meta`` device (shapes only: no FLOPs, no memory) under the taint mode,
and returns the tainted trace.  Module scopes are the model's modules, one
``layers.{i}`` per layer, as the reference's unrolled trace.

Ambiguity (App. B): if a dummy dimension collides with a model-configuration
value, seeding raises AmbiguityError and the pass is retraced with the next
collision-free prime, the paper's retrace-with-different-prompt.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, model_config_taint_values
from repro_torch.core.taint import (MODEL_CONFIG, NUM_REQS, NUM_TOKS,
                                    AmbiguityError, TaintRegistry)
from repro_torch.core.tracer import TaintedTrace, trace_tainted
from repro_torch.models.zoo import Model

_PRIMES = (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
           67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113)


def config_taint_values(cfg: ModelConfig) -> Dict[int, set]:
    """MODEL_CONFIG seed values.  Extends the base map with halved rotary
    dims (the scalar `head_dim // 2` a PyTorch pass would taint-propagate)
    and drops n_frontend_tokens (vision/audio token counts are request-
    derived — they enter as NUM_TOKS)."""
    vals = model_config_taint_values(cfg)
    hd = cfg.resolved_head_dim
    for v, name in [(hd // 2, "head_dim_half"),
                    (cfg.d_model // 2, "d_model_half")]:
        if v > 1:
            vals.setdefault(v, set()).add(name)
    if cfg.mla is not None:
        v = cfg.mla.qk_rope_head_dim // 2
        if v > 1:
            vals.setdefault(v, set()).add("mla.rope_half")
    v = cfg.n_frontend_tokens
    if v in vals:
        vals[v].discard("n_frontend_tokens")
        if not vals[v]:
            del vals[v]
    return vals


@dataclass
class ModelTrace:
    trace: TaintedTrace
    cfg: ModelConfig
    batch: int
    seq: int
    n_frontend: int
    retraces: int


def _pick_free(model_vals, used, start_idx=0) -> int:
    for p in _PRIMES[start_idx:]:
        if p not in model_vals and p not in used:
            return p
    raise RuntimeError("no collision-free prime available")


def trace_model(cfg: ModelConfig, *, batch: Optional[int] = None,
                seq: Optional[int] = None, max_retries: int = 4,
                impl: str = "xla") -> ModelTrace:
    """One tainted forward of ``cfg`` on the meta device with a dummy
    (batch, seq) prompt of collision-free primes, as the reference picks
    them; retraced with the next primes on ambiguity.  An enc-dec model or
    a frontend also gets frames (batch, s_front, d_model), s_front a third
    collision-free prime seeded as NUM_TOKS."""
    # parameters on the meta device: shapes and dtypes, no memory
    model = Model(cfg, device="meta", generator=torch.Generator())
    model_vals = config_taint_values(cfg)
    retraces = 0
    b = batch
    s = seq
    for attempt in range(max_retries + 1):
        try:
            if b is None or attempt > 0 and batch is None:
                b = _pick_free(model_vals, set(), attempt)
            if s is None or attempt > 0 and seq is None:
                s = _pick_free(model_vals, {b}, attempt + 3)
            s_front = 0
            if cfg.frontend != "none" or cfg.is_encdec:
                s_front = _pick_free(model_vals, {b, s}, attempt + 6)

            registry = TaintRegistry()
            for v in model_vals:
                registry.seed(v, MODEL_CONFIG)
            registry.seed(b, NUM_REQS)
            registry.seed(s, NUM_TOKS)
            if s_front:
                registry.seed(s_front, NUM_TOKS)

            args = [torch.zeros((b, s), dtype=torch.long, device="meta")]
            if s_front:
                args.append(torch.zeros((b, s_front, cfg.d_model),
                                        dtype=model.dtype, device="meta"))

            def fn(tokens, frames=None):
                return model(tokens, frames=frames, impl=impl, remat=False)[0]

            trace = trace_tainted(
                fn, args, registry=registry, root=model,
                arg_taints=[tuple(registry.lookup(int(d)) for d in a.shape)
                            for a in args])
            return ModelTrace(trace=trace, cfg=cfg, batch=b, seq=s,
                              n_frontend=s_front, retraces=retraces)
        except AmbiguityError:
            retraces += 1
            if attempt == max_retries:
                raise
            if batch is None:
                b = None
            if seq is None:
                s = None
    raise RuntimeError("unreachable")
