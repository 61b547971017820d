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

Under a mesh (``parallel.sharding.use_mesh``, DTensor activations) the
dispatch is expert parallel: every device gathers the batch's tokens and
the router, routes, sorts and dispatches them as ``moe_tokens`` does, runs
the (E, C, D) grouped products on the experts of its own shard of the
expert dim only, gathers the experts' outputs, combines, and gives the
result back in the batch's sharding.  DTensor has no sharded sort; the
reference's XLA partitions its sort-based dispatch by itself, so the
collectives of the two differ, not the numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, Linear, _normal
from repro_torch.parallel.sharding import (_is_dtensor, constrain, from_local,
                                           gathered, local_like)

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
        return _moe_ffn_mesh(moe, x, impl=impl)
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
    shared = getattr(moe, "shared", None)
    if shared is not None:
        out = out + shared(xt)

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
    local = isinstance(moe, _LocalMoE)
    if local:
        xg = moe.own(xg)                     # this device's experts' rows
    up, down = (gathered(getattr(moe, n), moe.axes[n]) for n in ("up", "down"))
    h = _expert_act(moe, torch.bmm(xg, up),
                    lambda: torch.bmm(xg, gathered(moe.gate, moe.axes["gate"])))
    h = constrain(h, "experts", None, "moe_ff")
    yg = torch.bmm(h, down)                                           # (E,C,D)
    if local:
        yg = moe.gather(yg, e)
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


# ---------------------------------------------------------------------------
# under a mesh: expert parallel over the expert dim's shards
# ---------------------------------------------------------------------------

class _LocalMoE:
    """One MoE layer's weights as this device's plain tensors, for the
    dispatch under a mesh: the router whole, and the experts of this
    device's shard of the expert dim (``experts``: the placements of that
    shard, replicated on every other mesh dim), each whole along its other
    dims.  The gathers are DTensor redistributions, so their backward
    reduces each weight's gradient onto its shard."""

    shared = None                # the shared expert runs on the DTensors

    def __init__(self, moe: MoE, mesh, experts: list):
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * mesh.ndim
        self.cfg, self.axes = moe.cfg, moe.axes
        self.mesh, self.experts, self.rep = mesh, experts, rep
        w = local_like(moe.router.w, mesh, rep)
        self.router = lambda h: h @ w
        for n in ("up", "gate", "down"):
            if hasattr(moe, n):
                setattr(self, n, local_like(getattr(moe, n), mesh, experts))

    def own(self, xg: torch.Tensor) -> torch.Tensor:
        """The rows of this device's experts of the (E, C, D) dispatch that
        every device built alike."""
        return from_local(xg, self.mesh, self.rep, xg.shape).redistribute(
            self.mesh, self.experts).to_local()

    def gather(self, yg: torch.Tensor, e: int) -> torch.Tensor:
        """Every expert's (C, D) outputs from each device's own."""
        shape = (e,) + tuple(yg.shape[1:])
        return from_local(yg, self.mesh, self.experts, shape).redistribute(
            self.mesh, self.rep).to_local()


def _moe_ffn_mesh(moe: MoE, x: torch.Tensor, *, impl: str
                  ) -> Tuple[torch.Tensor, Aux]:
    """``moe_ffn`` of the DTensor x: the batch's tokens gathered on every
    device, routed, sorted and dispatched as on one device; the grouped
    products on this device's experts (all of them for ``ragged``, which
    slices the experts by their counts); the experts' outputs gathered and
    combined; the result laid out as x, and the shared expert added on the
    DTensors.  The aux terms come back as replicated DTensors."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    experts = list(getattr(moe.up, "placements", rep))
    experts = [p if p.is_shard(0) and impl != "ragged" else Replicate()
               for p in experts]
    out, aux = moe_ffn(_LocalMoE(moe, mesh, experts),
                       local_like(x, mesh, rep), impl=impl)
    out = from_local(out, mesh, rep, tuple(x.shape)).redistribute(
        mesh, x.placements)
    if getattr(moe, "shared", None) is not None:
        out = out + moe.shared(x)
    return out, {k: from_local(v, mesh, rep, ()) for k, v in aux.items()}
