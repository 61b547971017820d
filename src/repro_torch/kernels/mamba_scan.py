"""Mamba-1 selective scan: the CUDA kernel ``csrc/mamba_scan.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.mamba_scan``:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

x (B,S,Di) and Bc, Cc (B,S,N) in the model dtype (float32 or bfloat16); dt
(B,S,Di), A (Di,N), D (Di,) and h0 (B,Di,N) in float32, as the mixer's
``_ssm_params`` makes them.  Returns y (B,S,Di) in x's dtype and h_S
(B,Di,N) in float32.  At S=1 with h0 it is exactly one decode step.

``mamba_scan`` dispatches on the device of its tensors: CPU tensors go to
``mamba_scan_plain``; CUDA tensors go to the kernel, or the call raises.
The kernel reads Bc and Cc through their strides, so the column slices of
``x_proj``'s output go in as they are; the wrapper makes x, dt, A, D and
h0 contiguous, which copies only a tensor that is not (the decode step's
input can come out of an einsum transposed).  Like the Pallas kernel it
has no backward: on the card it raises if autograd would record the call.
``mamba_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

SUPPORTED_STATES = (4, 8, 16)
_ENTRY = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 6
             + [ctypes.c_void_p])


def mamba_scan_plain(x, dt, A, Bc, Cc, D, h0=None):
    """What the kernel computes: ``ref.selective_scan`` (float32 inside)."""
    return ref.selective_scan(x, dt, A, Bc, Cc, D, h0)


def _check(x, dt, A, Bc, Cc, D, h0):
    tensors = [x, dt, A, Bc, Cc, D] + ([h0] if h0 is not None else [])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("mamba_scan: all tensors must be on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("mamba_scan: the kernel has no backward (nor has the "
                           "Pallas kernel it replaces); call it under "
                           "torch.no_grad() or on tensors that need no grad")
    if x.dtype not in _ENTRY or Bc.dtype != x.dtype or Cc.dtype != x.dtype:
        raise TypeError(f"mamba_scan: x, Bc, Cc must share float32 or bfloat16; "
                        f"got {x.dtype}, {Bc.dtype}, {Cc.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A, D] + tensors[6:]):
        raise TypeError("mamba_scan: dt, A, D and h0 must be float32")
    if x.dim() != 3:
        raise ValueError(f"mamba_scan: x must be (B,S,Di), got {tuple(x.shape)}")
    b, s, di = x.shape
    n = A.shape[-1]
    want = {"dt": (dt, (b, s, di)), "A": (A, (di, n)), "Bc": (Bc, (b, s, n)),
            "Cc": (Cc, (b, s, n)), "D": (D, (di,))}
    if h0 is not None:
        want["h0"] = (h0, (b, di, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan: {name} is {tuple(t.shape)}, expected "
                             f"{shape} for x {tuple(x.shape)} and A {tuple(A.shape)}")
    if s < 1 or n not in SUPPORTED_STATES:
        raise ValueError(f"mamba_scan: needs S >= 1 and N in {SUPPORTED_STATES}; "
                         f"got S={s}, N={n}")


def mamba_scan(x, dt, A, Bc, Cc, D, h0=None):
    """x, dt (B,S,Di)  A (Di,N)  Bc, Cc (B,S,N)  D (Di,)  h0 (B,Di,N) or None
    -> (y (B,S,Di), h_S (B,Di,N) float32)."""
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, A, Bc, Cc, D, h0)
    _check(x, dt, A, Bc, Cc, D, h0)
    x, dt, A, D = (t.contiguous() for t in (x, dt, A, D))
    h0 = h0.contiguous() if h0 is not None else None
    b, s, di = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load("mamba_scan"), _ENTRY[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), D.data_ptr(),
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 h.data_ptr(), b, s, di, n, *Bc.stride(), *Cc.stride(), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return y, h


mamba_scan.launches = 0
