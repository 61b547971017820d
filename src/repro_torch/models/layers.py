"""Basic layers (norm, linear, embedding, RoPE, MLP) as ``nn.Module``s.

Counterpart of ``repro.models.layers``.  Parameter names and layouts follow
the reference's parameter tree, so ``models.zoo.params_from_jax`` maps one
onto the other without transposes:

* ``Linear.w`` is (d_in, d_out) and the layer computes ``x @ w``;
* ``RMSNorm.scale`` is float32 whatever the model dtype, and the norm runs in
  float32 before casting back;
* ``Embedding.table`` is (vocab, d).

Each module names the logical axes of its own parameters in ``axes``
(parameter name -> the reference's ``ParamSpec.axes``), which
``Model.param_axes`` gathers and ``parallel.sharding`` maps onto a mesh.

Every module initialises its weights from an explicit ``torch.Generator``:
normal draws scaled by 1/sqrt(fan_in) (embedding: d**-0.5), norms at one.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import (_is_dtensor, constrain, from_local,
                                           gathered, grad_placements,
                                           local_like, local_offset)

Axes = Tuple[Optional[str], ...]


def _normal(shape, scale: float, *, device, dtype,
            generator: Optional[torch.Generator]) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter(w.mul_(scale).to(dtype or torch.float32))


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.axes: Dict[str, Axes] = {"scale": (None,)}
        self.scale = nn.Parameter(torch.ones(d, device=device,
                                             dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Linear(nn.Module):
    """``x @ w``; ``axes`` are the logical axes of w (d_in, d_out), the
    reference's ``linear_spec`` default ``("embed_fsdp", None)``."""

    def __init__(self, d_in: int, d_out: int, *,
                 axes: Axes = ("embed_fsdp", None), device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axes: Dict[str, Axes] = {"w": tuple(axes)}
        self.w = _normal((d_in, d_out), d_in ** -0.5, device=device,
                         dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ gathered(self.w, self.axes["w"])


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axes: Dict[str, Axes] = {"table": ("vocab", "embed_fsdp")}
        self.table = _normal((vocab, d), d ** -0.5, device=device,
                             dtype=dtype, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lookup(gathered(self.table, self.axes["table"]), tokens)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: rows of a (V, D) table.  On a DTensor table each
    device looks up the indices its shard of the rows (the vocab) holds,
    zeros for the others, and the rows are left as a partial sum over the
    mesh dims that shard them (vocab-parallel embedding): DTensor's own
    indexing would replicate the table, and some versions refuse indices
    sharded over two mesh dims at once (("pod", "data"))."""
    if not _is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    idx_pl = [Replicate() if t.is_shard() else
              (idx.placements[i] if _is_dtensor(idx) else Replicate())
              for i, t in enumerate(table.placements)]
    out_pl = [Partial() if t.is_shard(0) else Shard(idx.dim()) if t.is_shard(1)
              else q for t, q in zip(table.placements, idx_pl)]
    # each device of a mesh dim sharding the indices reads other rows
    local = table.to_local(grad_placements=grad_placements(
        table.placements, [i for i, q in enumerate(idx_pl) if q.is_shard()]))
    li = local_like(idx, mesh, idx_pl).long() - local_offset(table)[0]
    ok = (li >= 0) & (li < local.shape[0])
    rows = local[li.clamp(0, local.shape[0] - 1)] * ok[..., None].to(local.dtype)
    return from_local(rows, mesh, out_pl, tuple(idx.shape) + (table.shape[1],))


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
        self.up_proj = Linear(d, d_ff, axes=("embed_fsdp", "ff"), **kw)
        if act == "silu":
            self.gate_proj = Linear(d, d_ff, axes=("embed_fsdp", "ff"), **kw)
        self.down_proj = Linear(d_ff, d, axes=("ff", "embed_fsdp"), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.up_proj(x)
        if self.act == "silu":
            h = F.silu(self.gate_proj(x)) * up
        else:
            h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
        h = constrain(h, "batch", *(None,) * (h.dim() - 2), "ff")
        return self.down_proj(h)
