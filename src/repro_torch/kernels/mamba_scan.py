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
On the card S = 1 runs one step kernel; a longer scan is cut into
``scan_chunks`` chunks of time, scanned in parallel and joined in a second
launch.  The kernel reads Bc and Cc through their strides, so the column
slices of ``x_proj``'s output go in as they are (at S > 1 a row must be
16-byte aligned whole 16-byte vectors, else the wrapper copies Bc or Cc into
rows padded so); the wrapper makes x, dt, A, D and h0 contiguous and
16-byte aligned, which copies only a tensor that is not (the decode step's
input can come out of an einsum transposed).  Like the Pallas kernel it has no backward: on the
card it raises if autograd would record the call.  ``mamba_scan.launches``
counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.device import sm_count
from repro_torch.kernels import _build, ref

SUPPORTED_STATES = (4, 8, 16)
_ENTRY = {torch.float32: "mamba_scan_f32", torch.bfloat16: "mamba_scan_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
#: the prefill kernel's blocks of 32 channels: about this many per SM in
#: each of its two passes (each chunk past the first costs its exponents
#: twice, so no more chunks than fill the card); chunks of at least
#: MIN_CHUNK steps, in whole CHUNK_STEPS
SCAN_BLOCKS_PER_SM, MIN_CHUNK, CHUNK_STEPS = 5, 64, 16
CHANNELS_PER_BLOCK = 32


def scan_chunks(batch: int, seq: int, d_inner: int, sms: int) -> tuple:
    """(chunk, chunks): the prefill kernel cuts S into ``chunks`` chunks of
    ``chunk`` steps (the last may be shorter), enough that each of its two
    passes runs about SCAN_BLOCKS_PER_SM blocks per SM, none shorter than
    MIN_CHUNK steps.  A function of the shapes and the card only."""
    blocks = batch * -(-d_inner // CHANNELS_PER_BLOCK)
    want = 1 + -(-SCAN_BLOCKS_PER_SM * sms // blocks)
    chunks = max(1, min(want, -(-seq // MIN_CHUNK)))
    chunk = -(-(-(-seq // chunks)) // CHUNK_STEPS) * CHUNK_STEPS
    return chunk, -(-seq // chunk)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy only if not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _vector_rows(t: torch.Tensor) -> torch.Tensor:
    """Bc or Cc (B,S,N) as the prefill kernel copies it: rows of whole
    16-byte vectors at 16-byte aligned addresses.  A view that already is
    so goes in as it is; any other is copied into zero-padded rows."""
    esz, n = t.element_size(), t.shape[-1]
    if t.stride(-1) == 1 and (n * esz) % 16 == 0 and t.data_ptr() % 16 == 0 \
            and all((s * esz) % 16 == 0 for s in t.stride()[:-1]):
        return t
    vec = 16 // esz
    rows = t.new_zeros(t.shape[:-1] + (-(-n // vec) * vec,))
    rows[..., :n] = t
    return rows


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
    if s > 1 and di % 8:
        raise ValueError(f"mamba_scan: the prefill kernel copies x and dt in "
                         f"16-byte vectors and needs Di % 8 == 0; got Di={di}")


def mamba_scan(x, dt, A, Bc, Cc, D, h0=None):
    """x, dt (B,S,Di)  A (Di,N)  Bc, Cc (B,S,N)  D (Di,)  h0 (B,Di,N) or None
    -> (y (B,S,Di), h_S (B,Di,N) float32)."""
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, A, Bc, Cc, D, h0)
    _check(x, dt, A, Bc, Cc, D, h0)
    x, dt, A, D = (_aligned(t) for t in (x, dt, A, D))
    h0 = _aligned(h0) if h0 is not None else None
    b, s, di = x.shape
    n = A.shape[1]
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    chunk = chunks = 1
    h_part = dt_part = None
    if s > 1:
        Bc, Cc = _vector_rows(Bc), _vector_rows(Cc)
        chunk, chunks = scan_chunks(b, s, di, sm_count(x.device))
        if chunks > 1:      # the local pass's end states, then its dt sums
            part = torch.empty(b * (chunks - 1) * di * (n + 1), dtype=torch.float32,
                               device=x.device)
            h_part, dt_part = part.split(b * (chunks - 1) * di * n)
    strides = (ctypes.c_int64 * 6)(*Bc.stride(), *Cc.stride())
    fn = _build.entry("mamba_scan", _ENTRY[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), D.data_ptr(),
                 *(t.data_ptr() if t is not None else None
                   for t in (h0, y, h, h_part, dt_part)),
                 b, s, di, n, chunk, chunks, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return y, h


mamba_scan.launches = 0
