"""FlashAttention forward with its row log-sum-exp, and its backward: the
CUDA kernels ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
and their plain PyTorch versions.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fwd`` and
``flash_attention_bwd``.  The reference kernels take head-major (B,H,S,D)
tensors, which its wrapper makes by transposing; here every tensor stays in
the model's (B,S,H|KV,D) layout and the kernels read them through their
strides (TMA tensor maps on the bf16 path).  The backward returns dK/dV per
KV head, summed over each GQA group inside the kernel, where the reference
returns them per query head and sums the groups in its wrapper.

Each wrapper dispatches on the device of its tensors: CPU tensors go to the
plain version; CUDA tensors go to the kernel, or the call raises.  On the
card the dtype picks the kernel, and neither gives way to the other:
bfloat16 runs on Hopper's tensor cores (wgmma, TMA, fp32 accumulators;
``flash_attention_*_bf16``), float32 on the CUDA cores (``*_f32``), since
the tensor cores cannot meet the fp32 tolerances.
``flash_attention_fwd.launches`` and ``flash_attention_bwd.launches`` count
calls that launched the kernel (the backward's one call launches three: the
delta row sums, dQ and dK/dV).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SUPPORTED_DIMS = (32, 64, 128)
_SOURCE, _BWD_SOURCE = "flash_attention_fwd", "flash_attention_bwd"
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float]
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


def _mask(sq: int, sk: int, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query attends."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """What the kernel computes, in float32: q (B,Sq,H,D), k/v (B,Sk,KV,D)
    -> out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) float32.  Masked logits
    take the finite NEG_INF and l is clamped at 1e-20, so a fully masked
    row, and every row against an empty memory (Sk = 0), gives zeros and
    lse = NEG_INF + log(1e-20)."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(d)), kf)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = (s.amax(-1, keepdim=True) if sk else
         s.new_full(s.shape[:-1] + (1,), NEG_INF))
    p = torch.exp(s - m) * mask
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _check(q, k, v, what: str = "flash_attention_fwd", **more):
    """Raises unless q (B,Sq,H,D), k/v (B,Sk,KV,D) and the tensors in
    ``more`` (each shaped like q) are what the kernels take."""
    ts = {"q": q, "k": k, "v": v, **more}
    if not all(t.is_cuda and t.device == q.device for t in ts.values()):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in ts.values()):
        raise TypeError(f"{what}: unsupported dtypes "
                        f"{[str(t.dtype) for t in ts.values()]}; expects "
                        "float32 or bfloat16 throughout")
    if any(t.dim() != 4 for t in ts.values()):
        raise ValueError(f"{what}: expects q (B,Sq,H,D), k/v (B,Sk,KV,D)")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3] \
            or h % k.shape[2] or any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"{what}: shapes disagree: " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in ts.items()))
    if d not in SUPPORTED_DIMS or v.shape[3] != d:
        raise ValueError(f"{what}: head dims {d}/{v.shape[3]}; "
                         f"the kernel takes Dv == D in {SUPPORTED_DIMS}")
    if sq == 0:
        raise ValueError(f"{what}: no query rows (Sq 0)")
    vec = 16 // q.element_size()
    for name, t in ts.items():
        if t.numel() == 0:            # an empty memory: no row is read
            continue
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous "
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
    fn = _build.entry(_SOURCE, _ENTRY[q.dtype], _ARGTYPES)
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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """What the backward kernel computes, in float32: P is rebuilt from the
    forward's ``lse`` (no differentiation through the forward), delta =
    rowsum(dO * O), dS = P (dP - delta) / sqrt(D).  q, out, do (B,Sq,H,D),
    k/v (B,Sk,KV,D), lse (B,H,Sq) -> dq (B,Sq,H,D), dk/dv (B,Sk,KV,D) per
    KV head, in the inputs' dtypes.  A fully masked row gives zeros."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dof = do.float()
    delta = (dof * out.float()).sum(-1).transpose(1, 2)          # (B,H,Sq)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])             # dS / scale: qf holds it
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, sk, kv, g, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, sk, kv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """q, out, do (B,Sq,H,D)  k,v (B,Sk,KV,D)  lse (B,H,Sq) float32  ->
    dq (B,Sq,H,D), dk, dv (B,Sk,KV,D).  One call launches three kernels
    and counts one in ``flash_attention_bwd.launches``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                         window=window, q_offset=q_offset)
    _check(q, k, v, "flash_attention_bwd", out=out, do=do)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be a contiguous float32 "
                         f"(B,H,Sq) = {(b, h, sq)} tensor on q's device")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, sk, kv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, kv, d), dtype=v.dtype, device=v.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, out, do, dq, dk, dv)
                                      for st in t.stride()[:3]))
    fn = _build.entry(_BWD_SOURCE, _BWD_ENTRY[q.dtype], _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, h, h // kv, sq, sk, d,
                 int(causal), int(window), int(q_offset), 1.0 / math.sqrt(d),
                 strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
