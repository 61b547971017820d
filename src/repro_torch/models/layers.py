"""Basic layers (norm, linear, embedding, RoPE, MLP) as ``nn.Module``s.

Counterpart of ``repro.models.layers``.  Parameter names and layouts follow
the reference's parameter tree, so ``models.zoo.params_from_jax`` maps one
onto the other without transposes:

* ``Linear.w`` is (d_in, d_out) and the layer computes ``x @ w``;
* ``RMSNorm.scale`` is float32 whatever the model dtype, and the norm runs in
  float32 before casting back;
* ``Embedding.table`` is (vocab, d).

Every module initialises its weights from an explicit ``torch.Generator``:
normal draws scaled by 1/sqrt(fan_in) (embedding: d**-0.5), norms at one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _normal(shape, scale: float, *, device, dtype,
            generator: Optional[torch.Generator]) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype or torch.float32))


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device,
                                             dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = _normal((d_in, d_out), d_in ** -0.5, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table = _normal((vocab, d), d ** -0.5, device=device,
                             dtype=dtype, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


# ---------------------------------------------------------------------------
# RoPE (split-halves form, float32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary over last dim; positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(x.device, torch.float32)[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU for act='silu', classic two-matrix for act='gelu')
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up_proj = Linear(d, d_ff, **kw)
        if act == "silu":
            self.gate_proj = Linear(d, d_ff, **kw)
        self.down_proj = Linear(d_ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up_proj(x)
        if self.act == "silu":
            h = F.silu(self.gate_proj(x)) * up
        else:
            h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
        return self.down_proj(h)
