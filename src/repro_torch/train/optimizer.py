"""Optimizers over dictionaries of tensors: AdamW and Adafactor (factored
second moments).

Counterpart of ``repro.train.optimizer``, with the same formulas, defaults
and state layout.  A parameter tree is a flat ``{name: tensor}`` dict (for a
model, ``dict(model.named_parameters())``).  The state is float32 whatever
the parameter dtype; each update is computed in float32 and cast back to
the parameter's dtype once.  Where the reference returns new arrays, these
update the parameters and the state **in place** and return them, walking
large tensors in slices so that no update needs float32 temporaries the
size of a whole 525 M-entry embedding.

``torch.optim.AdamW`` is not used: for bf16 parameters it keeps bf16
moments, where the reference keeps float32.

Each optimizer exposes:
  init(params)                     -> opt_state
  update(grads, state, params, lr) -> (params, state), both updated in place
  state_axes(param_axes)           -> the state's logical axes (sharding)

On DTensors (the dry run) the state is made ``zeros_like`` the parameters,
so it keeps their sharding, and an update is not sliced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]

#: elements per slice of an in-place update
_SLICE = 1 << 24


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor):
    the norm of the per-leaf norms, so no leaf is squared into a copy."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tree.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm).  Float32 grads are
    scaled in place; others come back as scaled float32 copies, as the
    reference's product with a float32 scale promotes them."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    out = {n: g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
           for n, g in grads.items()}
    return out, norm


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of same-shaped contiguous tensors; DTensors
    whole, as a flat view of a sharded tensor is not one."""
    if any(type(t) not in (torch.Tensor, torch.nn.Parameter) for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), _SLICE):
        yield tuple(f[i:i + _SLICE] for f in flat)


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's scalar arithmetic is."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "count": 0}

    def state_axes(self, param_axes: Mapping[str, tuple]) -> dict:
        return {"m": dict(param_axes), "v": dict(param_axes), "count": ()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor], lr: float):
        count = state["count"] + 1
        b1c = _f32(1.0 - np.float32(self.b1) ** np.float32(count))
        b2c = _f32(1.0 - np.float32(self.b2) ** np.float32(count))
        for name, p in params.items():
            g = grads[name]
            for gs, ms, vs, ps in _slices(g.contiguous(), state["m"][name],
                                          state["v"][name], p):
                gs = gs.float()
                # the reference's order of roundings: b1 m + ((1 - b1) g)
                ms.mul_(self.b1).add_(gs * (1 - self.b1))
                vs.mul_(self.b2).add_(gs.mul(1 - self.b2).mul_(gs))
                step = torch.div(ms, b1c).div_(
                    torch.div(vs, b2c).sqrt_().add_(self.eps))
                step.add_(ps, alpha=self.weight_decay)     # promoted to fp32
                ps.copy_(step.mul_(-lr).add_(ps))          # p - lr * step
        state["count"] = count
        return params, state


# ---------------------------------------------------------------------------
# Adafactor (simplified: factored 2nd moments, update clipping, no 1st moment)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Adafactor:
    """Factors the second moment of every leaf of two or more dims over its
    last two.  The port's model keeps one tensor per layer where the
    reference stacks layers into one leaf, so on a model the update
    clipping (an RMS over the whole leaf) and the factoring of the stacked
    norm scales differ from the reference; on the same tree they agree."""
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def _factored(p: torch.Tensor) -> bool:
        return p.dim() >= 2

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        def leaf(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if self._factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return {"f": {n: leaf(p) for n, p in params.items()}, "count": 0}

    def state_axes(self, param_axes: Mapping[str, tuple]) -> dict:
        """The axes of ``init``'s state.  The reference's stacked 1-D leaves
        (a norm scale of (layers, d)) are factored into ``vr`` (layers,) and
        ``vc`` (d,); the port's per-layer (d,) leaf keeps one ``v`` (d,)."""
        def leaf(ax):
            ax = tuple(ax)
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"f": {n: leaf(ax) for n, ax in param_axes.items()},
                "count": ()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor], lr: float):
        beta = self.decay
        for name, p in params.items():
            g = grads[name].float()
            s = state["f"][name]
            g2 = g * g + self.eps
            if self._factored(p):
                s["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp(vr.mean(-1, keepdim=True),
                                                    min=self.eps))
                u = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(s["v"])
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        state["count"] += 1
        return params, state


def make_optimizer(name: str):
    return Adafactor() if name == "adafactor" else AdamW()
