"""Mixture-of-Experts FFN: top-k routing and a sort-based grouped product.

Counterpart of ``repro.models.moe``.  Tokens are sorted by their assigned
expert (a stable sort), scattered into an (experts, capacity, d) padded
layout with one dummy overflow row, and run through a per-expert batched
product (``torch.bmm``, the reference's ``einsum('ecd,edf->ecf')``); a token
past its expert's capacity is dropped, as in the reference.  The grouped
products stay in PyTorch, as the reference keeps them in XLA: MoE reaches
no Pallas kernel.

The dropping path has static shapes and never waits for the card, so it
runs on the meta device (the tainted runner) and inside a CUDA graph (the
engine): experts are counted by ``scatter_add_`` into a fixed length-E
tensor, and the k slots of a token are summed in a fixed order, not by
atomics, so a graph's replays are bit for bit alike.  The inference-only
``ragged`` impl slices the sorted tokens by each expert's count and does
wait for the card; the engine never selects it.

Router logits, probabilities and aux losses are float32 on float32
activations; the router's weight stays float32 in a bf16 model.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, Linear, _normal
from repro_torch.parallel.sharding import _is_dtensor, constrain, gathered

CAPACITY_FACTOR = 1.25
MOE_TOKEN_CHUNK = 65_536

Aux = Dict[str, torch.Tensor]


class MoE(nn.Module):
    """The weights of one MoE FFN, named as the reference's ``moe_spec``:
    ``router`` (float32), ``up``, ``gate`` (SwiGLU only) and ``down`` of
    shape (E, ·, ·), and the ``shared`` expert when the config has one.
    Calling the module runs ``moe_ffn`` and returns (out, aux)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.router = Linear(d, e, axes=("embed_fsdp", None), device=device,
                             dtype=torch.float32, generator=generator)
        self.axes = {"up": ("experts", "embed_fsdp", "moe_ff"),
                     "gate": ("experts", "embed_fsdp", "moe_ff"),
                     "down": ("experts", "moe_ff", "embed_fsdp")}
        self.up = _normal((e, d, f), d ** -0.5, **kw)
        self.down = _normal((e, f, d), f ** -0.5, **kw)
        if cfg.act == "silu":
            self.gate = _normal((e, d, f), d ** -0.5, **kw)
        if cfg.n_shared_experts > 0:
            self.shared = MLP(d, f * cfg.n_shared_experts, cfg.act, **kw)

    def forward(self, x: torch.Tensor, *, impl: str = "dropping"
                ) -> Tuple[torch.Tensor, Aux]:
        return moe_ffn(self, x, impl=impl)


def expert_capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.n_experts * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)        # round up to 8, as the reference


def route(moe: MoE, xt: torch.Tensor):
    """Router top-k.  xt: (T,D) -> (top_p, top_e) each (T,k), logits and
    probs (T,E), all float32 but ``top_e``."""
    logits = moe.router(xt.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_p, top_e, logits, probs


def moe_ffn(moe: MoE, x: torch.Tensor, *, impl: str = "dropping"
            ) -> Tuple[torch.Tensor, Aux]:
    """x: (B,S,D) -> (out (B,S,D), aux losses).

    More than ``MOE_TOKEN_CHUNK`` tokens run chunk by chunk along the
    sequence, as the reference's ``lax.scan`` runs them: routing is per
    token, so chunking bounds the working set without changing results
    (the aux terms are the chunks' means)."""
    b, s, d = x.shape
    t = b * s
    if _is_dtensor(x):
        raise NotImplementedError(
            "moe_ffn under a mesh: the sort-based dispatch orders every "
            "token of the batch at once, and DTensor has no sharded sort "
            "(expert parallelism over the data axes is not ported)")
    if t > MOE_TOKEN_CHUNK:
        n = next((c for c in range(2, s + 1)
                  if s % c == 0 and t // c <= MOE_TOKEN_CHUNK), 1)
        if n > 1:
            xc = x.reshape(b, n, s // n, d).transpose(0, 1)   # (n,B,s/n,D)
            ys, auxs = zip(*(moe_tokens(moe, xc[i], impl=impl)
                             for i in range(n)))
            out = torch.stack(ys).transpose(0, 1).reshape(b, s, d)
            return out, {k: torch.stack([a[k] for a in auxs]).mean()
                         for k in auxs[0]}
    return moe_tokens(moe, x, impl=impl)


def moe_tokens(moe: MoE, x: torch.Tensor, *, impl: str = "dropping"
               ) -> Tuple[torch.Tensor, Aux]:
    cfg = moe.cfg
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_e, logits, probs = route(moe, xt)

    # ---- sort tokens by expert ----------------------------------------
    flat_e = top_e.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    xs = xt[order // k]                                    # (T*k, D), sorted
    group_sizes = torch.zeros(e, dtype=torch.long, device=x.device
                              ).scatter_add_(0, flat_e, torch.ones_like(flat_e))

    if impl == "ragged":
        ys = _expert_mlp_ragged(moe, xs, group_sizes)
    elif impl == "dropping":
        ys = _expert_mlp_dropping(moe, xs, sorted_e, group_sizes, t)
    else:
        raise ValueError(f"unknown moe impl {impl!r}; ported: 'dropping', "
                         "'ragged'")

    # ---- combine: weight by router prob, sum the k slots in order --------
    w = top_p.reshape(t * k)[order]
    slots = ys.new_zeros((t * k, d))
    slots[order] = ys * w[:, None].to(ys.dtype)            # token-major again
    out = slots.reshape(t, k, d).sum(1)
    if cfg.n_shared_experts > 0:
        out = out + moe.shared(xt)

    # ---- aux losses ---------------------------------------------------
    ce = group_sizes.float() / (t * k)
    aux = {"load_balance": e * torch.sum(probs.mean(0) * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return out.reshape(b, s, d).to(x.dtype), aux


def _expert_act(moe: MoE, up: torch.Tensor, gate) -> torch.Tensor:
    """SwiGLU with ``gate()``, the gate product, or gelu (tanh, as
    jax.nn.gelu's default)."""
    if moe.cfg.act == "silu":
        return F.silu(gate()) * up
    return F.gelu(up, approximate="tanh")


def _expert_mlp_dropping(moe: MoE, xs: torch.Tensor, sorted_e: torch.Tensor,
                         group_sizes: torch.Tensor, t: int) -> torch.Tensor:
    """Padded (E,C,D) grouped product; tokens past an expert's capacity go
    to the dummy row E*C and come back as zeros."""
    e = moe.cfg.n_experts
    cap = expert_capacity(t, moe.cfg)
    starts = torch.cumsum(group_sizes, 0) - group_sizes               # (E,)
    pos = torch.arange(xs.shape[0], device=xs.device) - starts[sorted_e]
    dest = torch.where(pos < cap, sorted_e * cap + pos, e * cap)
    xg = xs.new_zeros((e * cap + 1, xs.shape[1]))
    xg[dest] = xs
    xg = constrain(xg[:-1].reshape(e, cap, xs.shape[1]), "experts", None, None)
    up, down = (gathered(getattr(moe, n), moe.axes[n]) for n in ("up", "down"))
    h = _expert_act(moe, torch.bmm(xg, up),
                    lambda: torch.bmm(xg, gathered(moe.gate, moe.axes["gate"])))
    h = constrain(h, "experts", None, "moe_ff")
    yg = torch.bmm(h, down)                                           # (E,C,D)
    ys = torch.cat([yg.reshape(e * cap, -1), yg.new_zeros((1, yg.shape[-1]))])
    return ys[dest]


def _expert_mlp_ragged(moe: MoE, xs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Drop-free grouped product over each expert's slice of the sorted
    tokens (``lax.ragged_dot``'s counterpart; inference only).  The slice
    bounds are read back from the card."""
    out, start = [], 0
    for i, n in enumerate(group_sizes.tolist()):
        seg = xs[start:start + n]
        h = _expert_act(moe, seg @ moe.up[i], lambda: seg @ moe.gate[i])
        out.append(h @ moe.down[i])
        start += n
    return torch.cat(out)
