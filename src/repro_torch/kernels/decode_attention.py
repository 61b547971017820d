"""Decode attention (one new token against a padded KV cache): the CUDA
kernel ``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``.  The query keeps the
reference kernel's (B, KV, G, D) grouping, but the caches stay in the
model's (B, Smax, KV, D) layout: the kernel reads them through their
strides, where the reference's wrapper transposes the whole cache per call.

``decode_attention`` dispatches on the device of its tensors: CPU tensors
go to ``decode_attention_plain``; CUDA tensors go to the kernel, or the call
raises.  On the card the dtype picks the kernel: bfloat16 splits each (row,
KV head)'s keys over ``num_splits`` blocks on the tensor cores and merges
their partial softmaxes in a second launch (``decode_attention_bf16``);
float32 runs one CUDA-core block per (row, KV head) (``*_f32``), since the
tensor cores cannot meet the fp32 tolerance.  Both take a GQA group of any
size, as the reference's kernel does: it runs in slices of at most
GROUP_SLICE query rows, one grid index each, so a block holds no more rows
of registers than a group of 32 would.  ``decode_attention.launches``
counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.device import sm_count
from repro_torch.kernels import _build

SUPPORTED_DIMS = (32, 64, 128)
#: query rows of the GQA group that one block computes (two 16-row m-tiles
#: of the bf16 kernel); a larger group runs as several slices
GROUP_SLICE = 32
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
#: the bf16 kernel's blocks: about this many per SM over the whole grid (two
#: fit at D = 128), and at least this many keys per split (two 16-key tiles
#: for each of 4 warps, so that a warp's copies run ahead of its products)
SPLIT_BLOCKS_PER_SM, KEYS_PER_SPLIT = 2, 128


def group_slices(group: int) -> int:
    """Blocks that share the query rows of one (row, KV head)."""
    return -(-group // GROUP_SLICE)


def num_splits(batch: int, kv_heads: int, smax: int, sms: int,
               group: int = 1) -> int:
    """Blocks that share the keys of one (row, KV head, slice of the group)
    in the bf16 kernel: enough for about SPLIT_BLOCKS_PER_SM blocks per SM
    over all slices, no more than a cache of ``smax`` keys fills with
    KEYS_PER_SPLIT each.  A function of the shapes and the card only, never
    of the lengths, so that a call can be captured in a CUDA graph and two
    calls split alike."""
    blocks = batch * kv_heads * group_slices(group)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // blocks)
    return max(1, min(want, -(-smax // KEYS_PER_SPLIT)))


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           window: int = 0) -> torch.Tensor:
    """What the kernel computes, in float32: q (B,KV,G,D), caches
    (B,Smax,KV,D[v]), lengths (B,) -> (B,KV,G,Dv) in q's dtype.  A row with
    no valid key (length 0) gives zeros, as the kernel does."""
    smax, d = k_cache.shape[1], q.shape[-1]
    s = torch.einsum("bkgd,bskd->bkgs", q.float(),
                     k_cache.float()) * (1.0 / math.sqrt(d))
    kpos = torch.arange(smax, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()[:, None]
    valid = kpos < lengths
    if window > 0:
        valid &= kpos >= lengths - window
    valid = valid[:, None, None, :]
    probs = torch.softmax(s.masked_fill(~valid, -math.inf), dim=-1)
    probs = torch.where(valid.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.to(q.dtype)


def _check(q, k_cache, v_cache, lengths):
    if not (k_cache.is_cuda and v_cache.is_cuda and lengths.is_cuda
            and k_cache.device == q.device == v_cache.device == lengths.device):
        raise ValueError("decode_attention: all tensors must be on one CUDA device")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: unsupported dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}; "
                        "expects float32 or bfloat16 throughout")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 or not lengths.is_contiguous():
        raise TypeError("decode_attention: lengths must be a contiguous int32 (B,) tensor")
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("decode_attention: expects q (B,KV,G,D) and caches (B,S,KV,D)")
    b, kv, g, d = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (b, kv, d) \
            or v_cache.shape[:3] != k_cache.shape[:3] or lengths.shape[0] != b:
        raise ValueError(f"decode_attention: shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if d not in SUPPORTED_DIMS or v_cache.shape[3] not in SUPPORTED_DIMS:
        raise ValueError(f"decode_attention: head dims {d}/{v_cache.shape[3]} "
                         f"not in {SUPPORTED_DIMS}")
    if q.stride(1) != g * q.stride(2):
        raise ValueError("decode_attention: q's KV and group dims must merge "
                         "into one head dim")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} needs a contiguous last "
                             "dim and 16-byte aligned rows")


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,KV,G,D)  k/v caches (B,Smax,KV,D[v])  lengths (B,) -> (B,KV,G,Dv)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      window=window)
    _check(q, k_cache, v_cache, lengths)
    b, kv, g, d = q.shape
    smax, dv = k_cache.shape[1], v_cache.shape[3]
    out = torch.empty((b, kv, g, dv), dtype=q.dtype, device=q.device)
    splits, part = 1, None
    if q.dtype == torch.bfloat16:
        splits = num_splits(b, kv, smax, sm_count(q.device), g)
    if splits > 1:          # each split's unnormalised acc, then (m, l)
        part = torch.empty(b * kv * splits * g * (dv + 2), dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_int64 * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        out.stride(0), out.stride(2))
    fn = _build.entry("decode_attention", _ENTRY[q.dtype], _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 part.data_ptr() if part is not None else None, b, kv, g, d, dv,
                 smax, int(window), splits, 1.0 / math.sqrt(d), strides, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
