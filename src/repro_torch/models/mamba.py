"""Mamba-1 selective-SSM block (falcon-mamba).

Counterpart of ``repro.models.mamba``.  Prefill runs the causal depthwise
conv and the selective scan over the whole chunk; decode carries two pieces
of state per layer: the conv tail (the last kw-1 raw conv inputs) and the
SSM hidden state (fp32).

The scan follows the backend: ``impl="kernel"`` sends it through
``ops.selective_scan`` (the CUDA kernel on the card, at S=1 for a decode
step); every other backend runs ``selective_scan_chunked`` and
``ref.selective_scan_step``, the plain scans the reference always runs.
The model's full-sequence forward, which training differentiates, asks
for the plain scan under every backend (``transformer.forward_scan``): the
kernel has no backward, nor has the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.layers import Linear, _normal
from repro_torch.parallel.sharding import constrain

SCAN_CHUNK = 512
_PLAIN_IMPLS = ("auto", "xla", "chunked", "chunked_naive")

State = Dict[str, torch.Tensor]


class Mamba(nn.Module):
    """The weights of one mixer, named and shaped as the reference's
    ``mamba_spec``: ``in_proj``, ``conv_w`` (kw, Di), ``conv_b``, ``x_proj``,
    ``dt_w`` (dt_rank, Di), ``dt_b``, ``A_log`` (Di, N), ``D``, ``out_proj``;
    ``dt_b``, ``A_log`` and ``D`` are float32, the rest the model dtype.
    Calling the module runs ``mamba_mixer``, so that its ops run in the
    module's own scope (``layers.{i}.mamba``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, di, st = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        dtr, kw = cfg.resolved_dt_rank, cfg.ssm_conv
        lin = dict(device=device, dtype=dtype, generator=generator)
        f32 = dict(device=device, dtype=torch.float32)
        self.axes = {"conv_w": (None, "ff"), "conv_b": ("ff",),
                     "dt_w": (None, "ff"), "dt_b": ("ff",),
                     "A_log": ("ff", None), "D": ("ff",)}
        self.in_proj = Linear(d, 2 * di, axes=("embed_fsdp", "ff"), **lin)
        self.conv_w = _normal((kw, di), 0.5, **lin)
        self.conv_b = nn.Parameter(torch.zeros(di, device=device,
                                               dtype=dtype or torch.float32))
        self.x_proj = Linear(di, dtr + 2 * st, axes=("ff", None), **lin)
        self.dt_w = _normal((dtr, di), dtr ** -0.5, **lin)
        self.dt_b = nn.Parameter(torch.zeros(di, **f32))
        self.A_log = nn.Parameter(torch.zeros(di, st, **f32))
        self.D = nn.Parameter(torch.ones(di, **f32))
        self.out_proj = Linear(di, d, axes=("ff", "embed_fsdp"), **lin)

    def forward(self, x: torch.Tensor, **kw):
        """``mamba_mixer(self, x, cfg, **kw)``."""
        return mamba_mixer(self, x, self.cfg, **kw)


def _ssm_params(m: Mamba, u: torch.Tensor, cfg: ModelConfig):
    """u: (..., Di) -> dt (..., Di) float32, Bc and Cc (..., N) in u's dtype
    (column views of one ``x_proj`` output)."""
    dtr, st = cfg.resolved_dt_rank, cfg.ssm_state
    dt_in, Bc, Cc = torch.split(m.x_proj(u), [dtr, st, st], dim=-1)
    dt = F.softplus(dt_in.float() @ m.dt_w.float() + m.dt_b)
    return dt, Bc, Cc


def selective_scan_chunked(x, dt, A, Bc, Cc, D, h0=None,
                           chunk: int = SCAN_CHUNK):
    """``ref.selective_scan`` chunk by chunk, carrying the state, so live
    memory is O(B * chunk * Di * N)."""
    s = x.shape[1]
    if s <= chunk:
        return ref.selective_scan(x, dt, A, Bc, Cc, D, h0)
    h = h0 if h0 is not None else x.new_zeros(
        (x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32)
    ys = []
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        y, h = ref.selective_scan(x[:, sl], dt[:, sl], A, Bc[:, sl], Cc[:, sl],
                                  D, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _uses_kernel(impl: str) -> bool:
    """Whether backend ``impl`` runs the scan kernel; raises on a name that
    is not a backend."""
    if impl == "kernel":
        return True
    if impl in _PLAIN_IMPLS:
        return False
    raise ValueError(f"unknown mamba impl {impl!r}; ported: 'kernel', "
                     f"{', '.join(repr(i) for i in _PLAIN_IMPLS)}")


def mamba_mixer(m: Mamba, x: torch.Tensor, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None,
                conv_tail: Optional[torch.Tensor] = None,
                return_state: bool = False, impl: str = "xla"):
    """Full-sequence mixer.  x: (B,S,D) -> (B,S,D) [, (conv_tail, h)].

    h0 / conv_tail continue a previous chunk (chunked prefill): conv_tail is
    the last kw-1 raw conv inputs of the previous chunk."""
    s = x.shape[1]
    kw = cfg.ssm_conv
    u_raw, z = m.in_proj(x).chunk(2, dim=-1)                   # (B,S,Di) each
    u_raw = constrain(u_raw, "batch", None, "ff")
    if conv_tail is not None:
        u_pad = torch.cat([conv_tail.to(u_raw.dtype), u_raw], dim=1)
    else:
        u_pad = F.pad(u_raw, (0, 0, kw - 1, 0))
    conv = sum(u_pad[:, i:i + s] * m.conv_w[i] for i in range(kw))
    u = F.silu(conv + m.conv_b).to(x.dtype)
    dt, Bc, Cc = _ssm_params(m, u, cfg)
    A = -torch.exp(m.A_log)
    scan = kops.selective_scan if _uses_kernel(impl) else selective_scan_chunked
    y, h = scan(u, dt, A, Bc, Cc, m.D, h0)
    out = m.out_proj(y * F.silu(z))
    if return_state:
        return out, (u_pad[:, s:s + kw - 1].clone(), h)   # last kw-1 raw inputs
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, *, device,
                     dtype) -> State:
    """Zeroed decode state of one layer: the conv tail (B, kw-1, Di) in the
    model dtype and the SSM state (B, Di, N) in float32."""
    di, st, kw = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((batch, kw - 1, di), device=device, dtype=dtype),
            "h": torch.zeros((batch, di, st), device=device, dtype=torch.float32)}


def mamba_step(m: Mamba, x: torch.Tensor, state: State, cfg: ModelConfig,
               impl: str = "xla") -> Tuple[torch.Tensor, State]:
    """One-token decode.  x: (B,1,D) -> (out (B,1,D), new state); ``state``
    is left as it is."""
    u_raw, z = m.in_proj(x[:, 0]).chunk(2, dim=-1)             # (B,Di) each
    window = torch.cat([state["conv"], u_raw[:, None].to(state["conv"].dtype)],
                       dim=1)
    conv = torch.einsum("bkd,kd->bd", window.float(), m.conv_w.float())
    u = F.silu(conv + m.conv_b).to(x.dtype)
    dt, Bc, Cc = _ssm_params(m, u, cfg)
    A = -torch.exp(m.A_log)
    if _uses_kernel(impl):
        y, h = kops.selective_scan(u[:, None], dt[:, None], A, Bc[:, None],
                                   Cc[:, None], m.D, state["h"])
        y = y[:, 0]
    else:
        y, h = ref.selective_scan_step(u, dt, A, Bc, Cc, m.D, state["h"])
    out = m.out_proj(y * F.silu(z))[:, None]
    return out, {"conv": window[:, 1:], "h": h}
