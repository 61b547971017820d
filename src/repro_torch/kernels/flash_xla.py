"""Flash-attention semantics in plain PyTorch: the ``chunked`` backend.

Counterpart of ``repro.kernels.flash_xla``, which is not a Pallas kernel but
blockwise online softmax written in jnp under a ``custom_vjp``; here it is
the same loop under a ``torch.autograd.Function``.  The forward walks the
keys in chunks, keeping (m, l, acc) per query row, and saves only (out,
lse); the backward recomputes each chunk's probabilities from the LSE, so
no (B, H, Sq, Sk) tensor is ever stored.  GQA K/V are repeated to H one
chunk at a time.  Masked logits take the reference's finite
``NEG_INF`` (-1e30) and masked probabilities are zeroed, so a row whose
keys are all masked comes out as zeros.

Layouts as the reference: q (B, Sq, H, D), k/v (B, Sk, KV, D[v]) ->
(B, Sq, H, Dv); lse (B, Sq, H) float32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) -> (n, B, chunk, ...) zero-padded along S."""
    s = x.shape[1]
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)
    return x.reshape((x.shape[0], n, chunk) + x.shape[2:]).movedim(1, 0)


def _rep(kch: torch.Tensor, h: int) -> torch.Tensor:
    """(B, C, KV, D) -> (B, C, H, D): the chunk-local GQA repeat."""
    kv = kch.shape[2]
    return kch if kv == h else kch.repeat_interleave(h // kv, dim=2)


def _mask(qpos, kpos, *, causal: bool, window: int, sk: int) -> torch.Tensor:
    m = kpos < sk
    if causal:
        m = m & (kpos <= qpos)
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def _fwd(q, k, v, causal, window, q_offset, chunk):
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    chunk = min(chunk, sk)
    kc, vc = _chunks(k, chunk), _chunks(v, chunk)
    qf = q.float() * (1.0 / math.sqrt(d))
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, sq, h), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, h), device=q.device)
    acc = torch.zeros((b, sq, h, dv), device=q.device)
    for idx in range(kc.shape[0]):
        kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        s = torch.einsum("bqhd,bchd->bqhc", qf, _rep(kc[idx], h).float())
        msk = _mask(qpos, kpos, causal=causal, window=window, sk=sk)[None, :, None, :]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p, _rep(vc[idx], h).float())
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype), lse


def _bwd(q, k, v, out, lse, do, causal, window, q_offset, chunk):
    b, sq, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kv
    chunk = min(chunk, sk)
    n = -(-sk // chunk)
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    delta = (dof * out.float()).sum(-1)                       # (B, Sq, H)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kc, vc = _chunks(k, chunk), _chunks(v, chunk)
    dq = torch.zeros((b, sq, h, d), device=q.device)
    dks, dvs = [], []
    for idx in range(n):
        kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        kr, vr = _rep(kc[idx], h).float(), _rep(vc[idx], h).float()
        s = torch.einsum("bqhd,bchd->bqhc", qf * scale, kr)
        msk = _mask(qpos, kpos, causal=causal, window=window, sk=sk)[None, :, None, :]
        p = torch.where(msk, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bqhd,bchd->bqhc", dof, vr)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bqhc,bchd->bqhd", ds, kr)
        # group-sum the GQA query heads back onto their KV head
        dks.append(torch.einsum("bqhc,bqhd->bchd", ds, qf)
                   .reshape(b, chunk, kv, g, d).sum(3))
        dvs.append(torch.einsum("bqhc,bqhd->bchd", p, dof)
                   .reshape(b, chunk, kv, g, dv).sum(3))
    dk = torch.cat(dks, dim=1)[:, :sk]
    dv_ = torch.cat(dvs, dim=1)[:, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv_.to(v.dtype)


class FlashAttentionXla(torch.autograd.Function):
    """Saves (q, k, v, out, lse) and recomputes the probabilities chunk by
    chunk in the backward, as the reference's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, chunk):
        out, lse = _fwd(q, k, v, causal, window, q_offset, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_offset, chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, do, *ctx.masks)
        return dq, dk, dv, None, None, None, None


def flash_attention_xla(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """q (B,Sq,H,D)  k,v (B,Sk,KV,D[v]) -> (B,Sq,H,Dv)."""
    return FlashAttentionXla.apply(q, k, v, causal, window, q_offset, chunk)
