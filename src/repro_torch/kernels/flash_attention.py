"""FlashAttention forward with its row log-sum-exp: the CUDA kernel
``csrc/flash_attention_fwd.cu`` and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd``.  The
reference kernel takes head-major (B,H,S,D) tensors, which its wrapper makes
by transposing; here q/k/v stay in the model's (B,S,H|KV,D) layout and the
kernel reads them through their strides.  The backward (training only)
waits for a later slice.

``flash_attention_fwd`` dispatches on the device of its tensors: CPU tensors
go to ``flash_attention_fwd_plain``; CUDA tensors go to the kernel, or the
call raises.  ``flash_attention_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SUPPORTED_DIMS = (32, 64, 128)
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """What the kernel computes, in float32: q (B,Sq,H,D), k/v (B,Sk,KV,D)
    -> out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) float32.  Masked logits
    take the finite NEG_INF and l is clamped at 1e-20, so a fully masked
    row gives zeros and lse = NEG_INF + log(1e-20)."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(d)), kf)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _check(q, k, v):
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: all tensors must be on one CUDA device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: unsupported dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; expects float32 or bfloat16 throughout")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: expects q (B,Sq,H,D), k/v (B,Sk,KV,D)")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3] \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in SUPPORTED_DIMS or v.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: head dims {d}/{v.shape[3]}; "
                         f"the kernel takes Dv == D in {SUPPORTED_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} needs a contiguous "
                             "last dim and 16-byte aligned rows")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q (B,Sq,H,D)  k,v (B,Sk,KV,D)  ->  out (B,Sq,H,Dv), lse (B,H,Sq)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        lse.stride(0), lse.stride(1))
    fn = getattr(_build.load("flash_attention_fwd"), _ENTRY[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, h // kv, sq, sk, d, int(causal),
                 int(window), int(q_offset), 1.0 / math.sqrt(d), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
