"""Model-layout wrappers around the kernels.

Counterpart of ``repro.kernels.ops``.  The model's layout is (B, S, H, D)
and the kernels take it as it is, so these wrappers only reshape.  Each
kernel wrapper runs its plain PyTorch version on CPU tensors and its CUDA
kernel on CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """The flash forward as an autograd node whose backward is the flash
    backward kernel.  The forward saves (q, k, v, out, lse); the backward
    rebuilds P from the LSE and returns dK/dV per KV head directly, where
    the reference's ``_bwd_vjp`` sums per-query-head grads over each group."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                          q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # an upstream grad may be expanded (stride 0); the kernel wants rows
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                            **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D)  k,v (B,Sk,KV,D) -> (B,Sq,H,Dv)."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset)


# ---------------------------------------------------------------------------
# decode attention (inference only)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,1,H,D)  caches (B,S,KV,D[v])  lengths (B,) -> (B,1,H,Dv)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    qh = q.reshape(b, kv, h // kv, d)
    out = da.decode_attention(qh, k_cache, v_cache, lengths, window=window)
    return out.reshape(b, 1, h, -1)


# ---------------------------------------------------------------------------
# mamba selective scan (inference only: the kernel has no backward)
# ---------------------------------------------------------------------------

def selective_scan(x, dt, A, Bc, Cc, D, h0=None):
    """x, dt (B,S,Di)  A (Di,N)  Bc, Cc (B,S,N)  D (Di,)  h0 (B,Di,N)
    -> (y (B,S,Di), h_S (B,Di,N) float32)."""
    return ms.mamba_scan(x, dt, A, Bc, Cc, D, h0)
