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

The reference stacks the layers of each period position into one leaf; the
port keeps a tensor per layer.  ``stacks`` (``Model.param_stacks()``:
{stacked leaf: the parameter names it stacks}) lets an optimizer treat a
model's parameters as the reference's leaves; a parameter named in no
stack is a leaf of its own, keyed by its name.  AdamW is elementwise and
ignores them; Adafactor clips each stacked leaf by its RMS over the whole
stack, factors a stack of 1-D members as the reference factors its
(layers, d) leaf, and keeps its state stacked, keyed by the stack, so that
state and axes equal the reference's leaf by leaf.

Each optimizer exposes:
  init(params, stacks=None)                     -> opt_state
  update(grads, state, params, lr, stacks=None) -> (params, state), both
                                                   updated in place
  state_axes(param_axes, stacks=None)           -> the state's logical axes

On DTensors (the dry run) the state is made ``zeros_like`` the parameters,
so it keeps their sharding, and an update is not sliced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
Stacks = Mapping[str, Sequence[str]]

#: elements per slice of an in-place update
_SLICE = 1 << 24


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor):
    the norm of the per-leaf norms, so no leaf is squared into a copy."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32)
             for x in tree.values()]
    return torch.linalg.vector_norm(torch.stack(norms))


class ScaledGrads(Mapping):
    """Gradients times a float32 scale, as the reference's ``g * scale``:
    float32 leaves are scaled in place once; any other leaf is read as a
    scaled float32 copy each time it is looked up, so the copies of a bf16
    model's grads are made one leaf at a time, inside the update, and never
    held together."""

    def __init__(self, grads: Mapping[str, torch.Tensor], scale: torch.Tensor):
        self._grads, self.scale = dict(grads), scale
        for g in self._grads.values():
            if g.dtype == torch.float32:
                g.mul_(scale)

    def __getitem__(self, name: str) -> torch.Tensor:
        g = self._grads[name]
        return g if g.dtype == torch.float32 else g.float() * self.scale

    def __iter__(self):
        return iter(self._grads)

    def __len__(self) -> int:
        return len(self._grads)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[ScaledGrads, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm).  Float32 grads are
    scaled in place; others come back as scaled float32 copies, as the
    reference's product with a float32 scale promotes them, made leaf by
    leaf as they are read (``ScaledGrads``)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return ScaledGrads(grads, scale), norm


def _leaves(params: Mapping[str, torch.Tensor], stacks: Optional[Stacks] = None
           ) -> Dict[str, Tuple[str, ...]]:
    """{leaf: its parameter names}: each of ``stacks``, then every parameter
    that no stack names as a leaf of its own."""
    out = {k: tuple(v) for k, v in (stacks or {}).items()}
    named = [n for v in out.values() for n in v]
    held = set(named)
    if len(held) != len(named) or not held <= set(params):
        raise ValueError("the stacks name a parameter twice or one that is "
                         "not there")
    out.update((n, (n,)) for n in params if n not in held)
    return out


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

    # elementwise: the same numbers whether the layers are stacked or not,
    # so ``stacks`` is taken and ignored

    def init(self, params: Mapping[str, torch.Tensor],
             stacks: Optional[Stacks] = None) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "count": 0}

    def state_axes(self, param_axes: Mapping[str, tuple],
                   stacks: Optional[Stacks] = None) -> dict:
        return {"m": dict(param_axes), "v": dict(param_axes), "count": ()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor], lr: float,
               stacks: Optional[Stacks] = None):
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
    last two.  With ``stacks`` a leaf is the reference's: a stacked leaf
    has a leading layers dim, so a stack of 1-D norm scales is a (layers,
    d) leaf factored into ``vr`` (layers,) and ``vc`` (d,), and the update
    is clipped by its RMS over every layer of the stack."""
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def _stacked(key: str, stacks: Optional[Stacks]) -> bool:
        return key in (stacks or {})

    def init(self, params: Mapping[str, torch.Tensor],
             stacks: Optional[Stacks] = None) -> dict:
        def leaf(key, names):
            p = params[names[0]]
            shape = tuple(p.shape)
            if self._stacked(key, stacks):
                shape = (len(names),) + shape
            kw = dict(dtype=torch.float32, device=p.device)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], **kw),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **kw)}
            return {"v": torch.zeros(shape, **kw)}
        return {"f": {k: leaf(k, names)
                      for k, names in _leaves(params, stacks).items()},
                "count": 0}

    def state_axes(self, param_axes: Mapping[str, tuple],
                   stacks: Optional[Stacks] = None) -> dict:
        """The axes of ``init``'s state; a stacked leaf's lead with the
        reference's ``layers``."""
        def leaf(key, names):
            ax = tuple(param_axes[names[0]])
            if self._stacked(key, stacks):
                ax = ("layers",) + ax
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"f": {k: leaf(k, names)
                      for k, names in _leaves(param_axes, stacks).items()},
                "count": ()}

    def _moments(self, g: torch.Tensor, s: dict) -> None:
        """Decay the leaf's second moments ``s`` toward g*g + eps."""
        beta = self.decay
        g2 = g * g + self.eps
        if "v" in s:
            s["v"].mul_(beta).add_(g2, alpha=1 - beta)
            return
        s["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
        s["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)

    def _direction(self, g: torch.Tensor, s: dict) -> torch.Tensor:
        """The unclipped update of a leaf from its decayed moments."""
        if "v" in s:
            return g * torch.rsqrt(s["v"])
        vr, vc = s["vr"], s["vc"]
        rfac = torch.rsqrt(vr / torch.clamp(vr.mean(-1, keepdim=True),
                                            min=self.eps))
        return g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]

    def _apply(self, p: torch.Tensor, u: torch.Tensor, rms, lr: float):
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        if self.weight_decay:
            u = u + self.weight_decay * p.float()
        p.copy_(p.float() - lr * u)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor], lr: float,
               stacks: Optional[Stacks] = None):
        for key, names in _leaves(params, stacks).items():
            s = state["f"][key]
            members = [params[n] for n in names]
            if not self._stacked(key, stacks):
                (p,), g = members, grads[names[0]].float()
                self._moments(g, s)
                u = self._direction(g, s)
                self._apply(p, u, torch.sqrt(torch.mean(u * u)), lr)
            elif members[0].dim() == 1:
                # a (layers, d) leaf: vc averages over the layers, so the
                # stack is built (it is small)
                g = torch.stack([grads[n].float() for n in names])
                self._moments(g, s)
                u = self._direction(g, s)
                rms = torch.sqrt(torch.mean(u * u))
                for j, p in enumerate(members):
                    self._apply(p, u[j], rms, lr)
            else:
                # each member's vr and vc are slices of the leaf's; only the
                # clip's RMS crosses layers: a first pass sums the squares,
                # a second recomputes each member's update and applies it
                sq, n = 0.0, 0
                for j, name in enumerate(names):
                    sj = {k: v[j] for k, v in s.items()}
                    g = grads[name].float()
                    self._moments(g, sj)
                    u = self._direction(g, sj)
                    sq, n = sq + torch.sum(u * u), n + u.numel()
                    del g, u
                rms = torch.sqrt(sq / n)
                for j, (name, p) in enumerate(zip(names, members)):
                    sj = {k: v[j] for k, v in s.items()}
                    self._apply(p, self._direction(grads[name].float(), sj),
                                rms, lr)
        state["count"] += 1
        return params, state


def make_optimizer(name: str):
    return Adafactor() if name == "adafactor" else AdamW()
