"""Plain PyTorch references: the port's counterpart of
``repro.kernels.ref``.

Same functions, same layouts (q (B,S,H,D), caches (B,Smax,KV,D)) and the
same masking rules; every computation runs in float32 and casts back to
the input's dtype.  These are the materialized ``xla`` and
``chunked_naive`` backends of ``models.attention``, the plain selective
scan of ``models.mamba``, and the ground truth the kernels are held
against.
"""
from __future__ import annotations

import math

import torch


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,D) -> (B,S,H,D) by repeating each kv head H/KV times."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _softmax_rows(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim with masked keys at -inf; rows that mask
    out every key become zeros (the reference's ``any(mask)`` guard)."""
    probs = torch.softmax(logits.masked_fill(~valid, -math.inf), dim=-1)
    return torch.where(valid.any(-1, keepdim=True), probs,
                       torch.zeros((), dtype=probs.dtype, device=probs.device))


# ---------------------------------------------------------------------------
# attention (prefill / train): q (B,S,H,D) k,v (B,S,KV,D) -> (B,S,H,D)
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Full softmax attention.

    window > 0: sliding-window (key may attend iff q_pos - window < k_pos <= q_pos).
    q_offset: absolute position of q[0] relative to k[0] (chunked prefill).
    """
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    probs = _softmax_rows(logits, mask[None, None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention: q (B,1,H,Dk), caches (B,Smax,KV,Dk/Dv), lengths (B,)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention over a (padded) KV cache.  Supports Dv != Dk.

    Like the reference, a row with length 0 has no valid key and comes out
    NaN; the model never passes 0 and the decode kernel returns zeros."""
    h, dk = q.shape[2], q.shape[3]
    smax = k_cache.shape[1]
    k = _repeat_kv(k_cache, h)
    v = _repeat_kv(v_cache, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dk)
    kpos = torch.arange(smax, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = kpos < lengths
    if window > 0:
        valid &= kpos >= lengths - window
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# chunked (memory-efficient) attention: online softmax over KV chunks
# ---------------------------------------------------------------------------

def _online_softmax(qf, kc, vc, valid_fn, n_chunks: int, chunk: int):
    """Shared body of the two chunked variants.  qf (B,Sq,H,D) pre-scaled,
    kc/vc (B,n*chunk,H,D) padded; valid_fn(idx) -> mask broadcastable to
    (B,H,Sq,chunk)."""
    b, sq, h = qf.shape[:3]
    dv = vc.shape[-1]
    m = torch.full((b, h, sq), -math.inf, device=qf.device)
    l = torch.zeros((b, h, sq), device=qf.device)
    acc = torch.zeros((b, h, sq, dv), device=qf.device)
    for idx in range(n_chunks):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc[:, sl].float())
        valid = valid_fn(idx)
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vc[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3)


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    chunk = min(chunk, sk)
    n_chunks = (sk + chunk - 1) // chunk
    pad = n_chunks * chunk - sk
    k, v = _pad_seq(k, pad), _pad_seq(v, pad)
    qf = q.float() / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset

    def valid(idx):
        kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        return mask.expand(sq, chunk)[None, None]

    out = _online_softmax(qf, k, v, valid, n_chunks, chunk)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# chunked-prefill attention against a (padded, absolute-position) cache:
# q (B,C,H,Dk), caches (B,Smax,KV,Dk/Dv), lengths (B,) = tokens already in
# the cache BEFORE this chunk.  The chunk's K/V must already be written at
# slots [lengths, lengths+C).
# ---------------------------------------------------------------------------

def chunk_cache_attention(q, k_cache, v_cache, lengths, *,
                          window: int = 0) -> torch.Tensor:
    c, h, dk = q.shape[1], q.shape[2], q.shape[3]
    smax = k_cache.shape[1]
    k = _repeat_kv(k_cache, h)
    v = _repeat_kv(v_cache, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dk)
    qpos = lengths.to(q.device).long()[:, None] + torch.arange(c, device=q.device)
    kpos = torch.arange(smax, device=q.device)[None, None, :]
    valid = kpos <= qpos[:, :, None]
    if window > 0:
        valid &= kpos > qpos[:, :, None] - window
    probs = _softmax_rows(logits, valid[:, None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def chunk_cache_attention_chunked(q, k_cache, v_cache, lengths, *,
                                  window: int = 0, chunk: int = 512
                                  ) -> torch.Tensor:
    """Online-softmax variant of chunk_cache_attention (O(C * chunk) live
    memory)."""
    c, h, dk = q.shape[1], q.shape[2], q.shape[3]
    smax = k_cache.shape[1]
    chunk = min(chunk, smax)
    n = -(-smax // chunk)
    k = _pad_seq(_repeat_kv(k_cache, h), n * chunk - smax)
    v = _pad_seq(_repeat_kv(v_cache, h), n * chunk - smax)
    qf = q.float() / math.sqrt(dk)
    qpos = lengths.to(q.device).long()[:, None] + torch.arange(c, device=q.device)

    def valid(idx):
        kpos = idx * chunk + torch.arange(chunk, device=q.device)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos < smax)
        if window > 0:
            mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
        return mask[:, None]

    out = _online_softmax(qf, k, v, valid, n, chunk)
    return out.to(q.dtype)


def chunk_cache_attention_impl(impl: str):
    """The chunk-against-cache attention each backend runs.  Like the
    reference, the kernel backend uses the materialized version here: the
    flash kernel serves full-sequence prefill only."""
    if impl in ("chunked", "chunked_naive"):
        return chunk_cache_attention_chunked
    return chunk_cache_attention


# ---------------------------------------------------------------------------
# mamba selective scan:
#   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t + D*x_t
# x,dt: (B,S,Di)  A: (Di,N)  Bc,Cc: (B,S,N)  D: (Di,)
# ---------------------------------------------------------------------------

def selective_scan(x, dt, A, Bc, Cc, D, h0=None):
    """Returns (y (B,S,Di) in x's dtype, h_S (B,Di,N) float32).

    The reference runs ``jax.lax.associative_scan`` over the pairs
    (exp(dt*A), dt*B*x); this is the same scan by log-step doubling over S
    (log2(S) elementwise passes over (B,S,Di,N)), with h0 folded into the
    first step as the reference folds it."""
    s = x.shape[1]
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf[..., None] * A.float()[None, None])          # (B,S,Di,N)
    dBx = dtf[..., None] * Bc.float()[:, :, None, :] * xf[..., None]
    if h0 is not None:
        dBx[:, 0] += dA[:, 0] * h0.float()
    k = 1
    while k < s:
        # element t absorbs element t-k: (a, b) <- (a_{t-k} a_t, b_t + a_t b_{t-k})
        dBx = torch.cat([dBx[:, :k], dBx[:, k:] + dA[:, k:] * dBx[:, :-k]], 1)
        if 2 * k < s:
            dA = torch.cat([dA[:, :k], dA[:, k:] * dA[:, :-k]], 1)
        k *= 2
    y = torch.einsum("bsdn,bsn->bsd", dBx, Cc.float()) + xf * D.float()
    return y.to(x.dtype), dBx[:, -1]


def selective_scan_step(x, dt, A, Bc, Cc, D, h):
    """Single decode step.  x,dt: (B,Di)  Bc,Cc: (B,N)  h: (B,Di,N)."""
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf[..., None] * A.float()[None])
    h_new = dA * h + dtf[..., None] * Bc.float()[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h_new, Cc.float()) + xf * D.float()
    return y.to(x.dtype), h_new
