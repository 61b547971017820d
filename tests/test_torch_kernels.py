"""The port's attention kernels and reference attention against the JAX
package's, on the same numpy inputs.

On the CPU every kernel wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode, as tests/test_kernels.py does.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (outputs rounded to bf16 at different places); the backward is
held max-scaled (|a - b| / max|b|) at 2e-6 in float32, as
``test_pallas_flash_backward`` holds it.  Tests marked
``gpu`` hold the CUDA kernels against their plain versions on a card.
"""
import ctypes
import math
import re
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms

torch.set_num_threads(2)

FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 32, True, 0),
    (2, 128, 128, 4, 1, 64, True, 48),
    (1, 100, 100, 2, 2, 64, False, 0),
    (1, 64, 192, 4, 2, 32, True, 0),
]
DECODE_CASES = [
    (2, 4, 2, 256, 64, 0),
    (3, 8, 1, 512, 64, 0),
    (2, 4, 4, 256, 64, 64),
    (1, 8, 2, 128, 32, 0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _both(x, dtype="float32"):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(port, expected, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expected, np.float32),
                               atol=tol, rtol=tol)


def _qkv(case, seed=0, dtype="float32"):
    b, sq, sk, h, kv, d = case[:6]
    xs = _arrays(seed, (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))
    return [_both(x, dtype) for x in xs]


def _decode_inputs(case, seed=0, dtype="float32"):
    b, h, kv, smax, d, _ = case
    q, kc, vc = _arrays(seed, (b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d))
    lengths = np.random.default_rng(seed + 1).integers(1, smax, b).astype(np.int32)
    return ([_both(x, dtype) for x in (q, kc, vc)],
            (jnp.asarray(lengths), torch.from_numpy(lengths)))


# ---------------------------------------------------------------------------
# flash forward: plain version vs the Pallas kernel and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,win", FLASH_CASES)
def test_flash_forward_matches_jax(b, sq, sk, h, kv, d, causal, win):
    (jq, q), (jk, k), (jv, v) = _qkv((b, sq, sk, h, kv, d))
    out = ops.flash_attention(q, k, v, causal, win)
    _close(out, jops.flash_attention(jq, jk, jv, causal, win))
    _close(out, jref.attention(jq, jk, jv, causal=causal, window=win))


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,win", FLASH_CASES)
def test_flash_lse_is_logsumexp_of_reference_logits(b, sq, sk, h, kv, d,
                                                    causal, win):
    (_, q), (_, k), (_, v) = _qkv((b, sq, sk, h, kv, d))
    _, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
    qn, kn = q.double().numpy(), np.repeat(k.double().numpy(), h // kv, axis=2)
    logits = np.einsum("bqhd,bkhd->bhqk", qn, kn) / math.sqrt(d)
    qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if win:
        mask &= kpos > qpos - win
    logits = np.where(mask, logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    expected = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    _close(lse, expected)


def test_flash_forward_bf16():
    case = (1, 128, 128, 4, 2, 64)
    (jq, q), (jk, k), (jv, v) = _qkv(case, dtype="bfloat16")
    out = ops.flash_attention(q, k, v, True, 0)
    assert out.dtype == torch.bfloat16
    _close(out, jops.flash_attention(jq, jk, jv, True, 0).astype(jnp.float32),
           "bfloat16")
    _close(out, jref.attention(jq, jk, jv, causal=True).astype(jnp.float32),
           "bfloat16")


def test_flash_fully_masked_row_is_zero_like_the_pallas_kernel():
    # q_offset far behind the keys with a window: the first rows see no key
    (jq, q), (jk, k), (jv, v) = _qkv((1, 16, 64, 2, 1, 32))
    kw = dict(causal=True, window=4, q_offset=-8)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    assert torch.all(out[:, :8] == 0)
    assert torch.all(lse[..., :8] < -1e29)
    _close(out, jref.attention(jq, jk, jv, **kw))


def _scaled_close(port, expected, tol):
    """Max-scaled agreement, as tests/test_kernels.py holds the backward:
    |port - expected| / max|expected| <= tol."""
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-6
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=tol)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,win", FLASH_CASES[:3])
def test_flash_backward_matches_jax(b, sq, sk, h, kv, d, causal, win):
    """The loss of tests/test_kernels.py through ``ops.flash_attention``'s
    autograd, and through ``flash_attention_bwd_plain`` by hand, against
    jax.grad of the Pallas kernel (interpret mode); max-scaled 2e-6."""
    (jq, q), (jk, k), (jv, v) = _qkv((b, sq, sk, h, kv, d))

    def loss(q, k, v):
        return (jops.flash_attention(q, k, v, causal, win) * (q.sum() + 1.0)).sum()
    expected = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention(*leaves, causal, win) * (leaves[0].sum() + 1)).sum().backward()
    for t, e in zip(leaves, expected):
        _scaled_close(t.grad, e, 2e-6)

    # d loss / d out = q.sum() + 1 everywhere; q.sum() adds out.sum() to dq
    out, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, window=win)
    do = torch.full_like(out, float(q.sum()) + 1.0)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                              causal=causal, window=win)
    for t, e in zip((dq + out.sum(), dk, dv), expected):
        _scaled_close(t, e, 2e-6)


def _vjp_both(case, dtype="float32", seed=4, **kw):
    """(port dq/dk/dv from ``flash_attention_bwd_plain``, JAX's from
    jax.vjp of the Pallas kernel) for one random cotangent."""
    b, sq, sk, h, kv, d = case
    (jq, q), (jk, k), (jv, v) = _qkv(case, seed=seed, dtype=dtype)
    (jdo, do), = [_both(x, dtype) for x in _arrays(seed + 1, (b, sq, h, d))]
    causal, window, q_offset = (kw.get(n, dflt) for n, dflt in
                                (("causal", True), ("window", 0), ("q_offset", 0)))
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, causal, window, q_offset), jq, jk, jv)
    expected = vjp(jdo)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    port = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    return port, [np.asarray(e.astype(jnp.float32)) for e in expected]


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
def test_flash_backward_gqa_groups_match_jax(h, kv):
    """Groups of 1, 2 and 4: the port's per-KV-head dK/dV against the
    reference's per-query-head grads summed in its wrapper; 2e-6."""
    port, expected = _vjp_both((2, 96, 96, h, kv, 32), window=40)
    for t, e in zip(port, expected):
        assert t.shape == e.shape
        _scaled_close(t, e, 2e-6)


def test_flash_backward_bf16():
    """bf16 in and out: grads rounded to bf16 at different places; 2e-2."""
    port, expected = _vjp_both((1, 128, 128, 4, 2, 64), dtype="bfloat16")
    for t, e in zip(port, expected):
        assert t.dtype == torch.bfloat16
        _scaled_close(t, e, 2e-2)


def test_flash_backward_fully_masked_rows_give_zero_grads():
    # the forward's fully-masked case: the first 8 queries see no key
    kw = dict(causal=True, window=4, q_offset=-8)
    (dq, dk, dv), expected = _vjp_both((1, 16, 64, 2, 1, 32), **kw)
    assert torch.all(dq[:, :8] == 0) and torch.isfinite(dq).all()
    for t, e in zip((dq, dk, dv), expected):
        _scaled_close(t, e, 2e-6)


# ---------------------------------------------------------------------------
# decode: plain version vs the Pallas kernel and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,smax,d,win", DECODE_CASES)
def test_decode_matches_jax(b, h, kv, smax, d, win):
    ((jq, q), (jk, kc), (jv, vc)), (jl, lengths) = _decode_inputs(
        (b, h, kv, smax, d, win))
    out = ops.decode_attention(q, kc, vc, lengths, window=win)
    _close(out, jops.decode_attention(jq, jk, jv, jl, window=win))
    _close(out, jref.decode_attention(jq, jk, jv, jl, window=win))


def test_decode_bf16():
    case = (2, 8, 2, 256, 64, 0)
    ((jq, q), (jk, kc), (jv, vc)), (jl, lengths) = _decode_inputs(
        case, dtype="bfloat16")
    out = ops.decode_attention(q, kc, vc, lengths)
    assert out.dtype == torch.bfloat16
    _close(out, jops.decode_attention(jq, jk, jv, jl).astype(jnp.float32),
           "bfloat16")


def test_decode_length_zero_gives_zeros_like_the_pallas_kernel():
    ((jq, q), (jk, kc), (jv, vc)), _ = _decode_inputs((2, 4, 2, 64, 32, 0))
    lengths = np.array([0, 7], np.int32)
    out = ops.decode_attention(q, kc, vc, torch.from_numpy(lengths))
    assert torch.all(out[0] == 0)
    _close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(lengths)))


def test_cpu_wrappers_launch_no_kernel():
    da.decode_attention.launches = fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = ms.mamba_scan.launches = 0
    (_, q), (_, k), (_, v) = _qkv((1, 32, 32, 4, 2, 32))
    q.requires_grad_(True)
    ops.flash_attention(q, k, v).sum().backward()
    ops.decode_attention(q[:, :1].detach(), k, v,
                         torch.tensor([5], dtype=torch.int32))
    x, dt = torch.randn(1, 6, 16), torch.rand(1, 6, 16)
    y, h = ops.selective_scan(x, dt, -torch.rand(16, 4), torch.randn(1, 6, 4),
                              torch.randn(1, 6, 4), torch.randn(16))
    assert y.shape == x.shape and h.shape == (1, 16, 4)
    assert da.decode_attention.launches == 0
    assert fa.flash_attention_fwd.launches == 0
    assert fa.flash_attention_bwd.launches == 0
    assert ms.mamba_scan.launches == 0


def _extern_c(source: str) -> dict:
    """Each ``extern "C"`` entry of ``csrc/<source>.cu``, by name, with its
    body."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    return {m.group(1): text[m.end():text.index("\n}\n", m.end())]
            for m in re.finditer(r'extern "C" int (\w+)\(', text)}


@pytest.mark.parametrize("entries,source", [
    (fa._ENTRY, fa._SOURCE), (fa._BWD_ENTRY, fa._BWD_SOURCE)], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype,route", [
    (torch.float32, "simt::dispatch<float>"), (torch.bfloat16, "tc::dispatch")],
    ids=["float32", "bfloat16"])
def test_flash_entries_are_defined_by_the_loaded_source(entries, source, dtype,
                                                         route):
    """The wrapper's entry for each dtype is an extern "C" function of the
    source it loads, and it reaches its own path: bf16 the tensor-core
    kernels, fp32 the SIMT ones."""
    defined = _extern_c(source)
    assert entries[dtype] in defined
    assert route in defined[entries[dtype]]
    assert sorted(defined) == sorted(entries.values())


@pytest.mark.parametrize("dtype,route", [
    (torch.float32, "simt::launch<float>"), (torch.bfloat16, "tc::dispatch")],
    ids=["float32", "bfloat16"])
def test_decode_entries_are_defined_by_the_loaded_source(dtype, route):
    """The decode wrapper's entry for each dtype is an extern "C" function of
    csrc/decode_attention.cu, and it reaches its own path: bf16 the split-KV
    tensor-core kernels, fp32 the SIMT one; the source defines no entry the
    wrapper does not name."""
    defined = _extern_c("decode_attention")
    assert route in defined[da._ENTRY[dtype]]
    assert sorted(defined) == sorted(da._ENTRY.values())


@pytest.mark.parametrize("b,kv,smax,sms", [
    (8, 8, 2048, 132), (1, 8, 2048, 132), (1, 8, 512, 132), (2, 2, 256, 132),
    (64, 32, 4096, 132), (1, 1, 16, 132), (3, 1, 100, 114)])
def test_decode_splits_fill_the_card_without_empty_tiles(b, kv, smax, sms):
    """Enough blocks for SPLIT_BLOCKS_PER_SM per SM where the cache has the
    keys for it, never a split of fewer than KEYS_PER_SPLIT keys of a full
    cache, and the same answer every time (shapes and card only)."""
    splits = da.num_splits(b, kv, smax, sms)
    assert splits == da.num_splits(b, kv, smax, sms) >= 1
    assert splits <= max(1, math.ceil(smax / da.KEYS_PER_SPLIT))
    assert (b * kv * splits >= da.SPLIT_BLOCKS_PER_SM * sms
            or splits == math.ceil(smax / da.KEYS_PER_SPLIT))
    if (b, kv, smax) == (8, 8, 2048):          # llama3 serving: 9 splits
        assert b * kv * splits >= 2 * sms


# ---------------------------------------------------------------------------
# reference attention: the port's ref against repro.kernels.ref
# ---------------------------------------------------------------------------

def _cache_case(seed=3, b=2, c=16, h=4, kv=2, d=32, smax=64):
    q, kc, vc = _arrays(seed, (b, c, h, d), (b, smax, kv, d), (b, smax, kv, d))
    lengths = np.array([0, 24], np.int32)[:b]
    return [_both(x) for x in (q, kc, vc)], (jnp.asarray(lengths),
                                             torch.from_numpy(lengths))


@pytest.mark.parametrize("causal,win,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 24, 0), (True, 0, 40), (True, 8, -10)])
def test_ref_attention(causal, win, q_offset):
    (jq, q), (jk, k), (jv, v) = _qkv((2, 24, 64, 4, 2, 32), seed=5)
    kw = dict(causal=causal, window=win, q_offset=q_offset)
    _close(ref.attention(q, k, v, **kw), jref.attention(jq, jk, jv, **kw))


@pytest.mark.parametrize("causal,win,chunk", [(True, 0, 16), (False, 0, 24),
                                              (True, 12, 64)])
def test_ref_chunked_attention(causal, win, chunk):
    (jq, q), (jk, k), (jv, v) = _qkv((2, 40, 40, 4, 2, 32), seed=6)
    kw = dict(causal=causal, window=win, chunk=chunk)
    _close(ref.chunked_attention(q, k, v, **kw),
           jref.chunked_attention(jq, jk, jv, **kw))


@pytest.mark.parametrize("win", [0, 64])
def test_ref_decode_attention(win):
    ((jq, q), (jk, kc), (jv, vc)), (jl, lengths) = _decode_inputs(
        (3, 4, 2, 128, 32, win), seed=7)
    _close(ref.decode_attention(q, kc, vc, lengths, window=win),
           jref.decode_attention(jq, jk, jv, jl, window=win))


@pytest.mark.parametrize("name", ["chunk_cache_attention",
                                  "chunk_cache_attention_chunked"])
@pytest.mark.parametrize("win", [0, 10])
def test_ref_chunk_cache_attention(name, win):
    ((jq, q), (jk, kc), (jv, vc)), (jl, lengths) = _cache_case()
    kw = {"window": win} if name == "chunk_cache_attention" \
        else {"window": win, "chunk": 24}
    _close(getattr(ref, name)(q, kc, vc, lengths, **kw),
           getattr(jref, name)(jq, jk, jv, jl, **kw))


def test_ref_chunk_cache_attention_impl_follows_the_reference():
    assert ref.chunk_cache_attention_impl("chunked_naive") \
        is ref.chunk_cache_attention_chunked
    # the kernel backend ('pallas' in the reference) uses the materialized one
    assert jref.chunk_cache_attention_impl("pallas") is jref.chunk_cache_attention
    for impl in ("kernel", "xla"):
        assert ref.chunk_cache_attention_impl(impl) is ref.chunk_cache_attention


# ---------------------------------------------------------------------------
# build: nvcc discovery, rebuild keys and failures, with a stand-in compiler
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return nvcc


def test_build_compiles_each_source_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {calls}\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo "ptxas info    : Used 32 registers"; : > "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() == str(nvcc)
    reports = _build.build()
    assert sorted(reports) == sorted(_build.SOURCES)
    assert "mamba_scan" in _build.SOURCES and len(_build.SOURCES) == 4
    # one nvcc process per source, each compiling its own file for sm_90a
    lines = calls.read_text().splitlines()
    assert sorted(line.split()[-1].rsplit("/", 1)[-1] for line in lines) == \
        sorted(f"{n}.cu" for n in _build.SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in line for line in lines)
    assert all("Used 32 registers" in r for r in reports.values())
    libs = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(p.exists() for p in libs.values())
    nvcc.write_text("#!/bin/sh\nexit 3\n")          # a rebuild would fail now
    assert _build.build() == reports


def test_entry_looks_up_each_symbol_once(monkeypatch):
    """A wrapper's entry is fetched from the loaded library, typed, and kept:
    later launches reuse it."""
    class Lib:
        def __init__(self):
            self.fetched = 0

        def __getattr__(self, symbol):
            self.fetched += 1

            def fn(*args):
                return 0
            return fn
    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    first = _build.entry("decode_attention", "decode_attention_bf16", argtypes)
    again = _build.entry("decode_attention", "decode_attention_bf16", argtypes)
    other = _build.entry("mamba_scan", "mamba_scan_bf16", argtypes)
    assert first is again and other is not first and lib.fetched == 2
    assert first.argtypes == argtypes and first.restype is ctypes.c_int


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, "echo 'error: no sm_90a here'; exit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["decode_attention"])
    assert not any((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _to(dev, *ts):
    return [t.to(dev) for t in ts]


#: the kernel-test cases with q_offset 0, then a negative q_offset (its
#: first rows see no key), llama3's geometry causal and windowed, and
#: seamless-m4t's cross-attention, non-causal (MHA 16/16, D 64): decode's
#: one query row and a prefill chunk against a 4096-row encoder memory,
#: and a ragged Sq != Sk
GPU_FLASH_CASES = [c + (0,) for c in FLASH_CASES] + [
    (1, 16, 64, 2, 1, 32, True, 4, -8), (2, 1024, 1024, 32, 8, 128, True, 0, 0),
    (1, 512, 512, 32, 8, 128, True, 256, 0),
    (8, 1, 4096, 16, 16, 64, False, 0, 0), (2, 128, 4096, 16, 16, 64, False, 0, 0),
    (2, 77, 300, 4, 2, 64, False, 0, 0), (3, 1, 500, 8, 8, 128, False, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,win,q_offset", GPU_FLASH_CASES)
def test_gpu_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kv, d,
                                        causal, win, q_offset):
    (_, q), (_, k), (_, v) = _qkv((b, sq, sk, h, kv, d), dtype=dtype)
    q, k, v = _to(cuda, q, k, v)
    kw = dict(causal=causal, window=win, q_offset=q_offset)
    n = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n + 1
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    _close(out.cpu(), pout.float().cpu(), dtype)
    _close(lse.cpu(), plse.cpu())
    dead = ~fa._mask(sq, sk, causal, win, q_offset, "cpu").any(1)
    assert bool(dead.any()) == (q_offset < 0)
    assert torch.all(out.cpu()[:, dead] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,h,kv,d", [(2, 1, 16, 16, 64), (1, 130, 8, 2, 128)])
def test_gpu_flash_kernel_at_an_empty_memory(cuda, dtype, b, sq, h, kv, d):
    """Sk = 0 (a cross-attention point at ctx 0): the kernel runs zero key
    tiles and writes zeros and a fully masked row's lse, as its plain
    version."""
    q = torch.randn((b, sq, h, d), device=cuda).to(getattr(torch, dtype))
    k = torch.empty((b, 0, kv, d), dtype=q.dtype, device=cuda)
    n = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, k, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n + 1
    pout, plse = fa.flash_attention_fwd_plain(q, k, k, causal=False)
    assert out.shape == q.shape and not out.any() and not pout.any()
    assert torch.equal(lse.cpu(), plse.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,smax,d,win", DECODE_CASES + [
    (8, 32, 8, 2048, 128, 0), (8, 32, 8, 2048, 128, 256),
    # internvl2-26b's G = 6 and llama4-maverick's G = 5 (KV 8, D 128),
    # seamless-m4t's decoder self-attention G = 1 (KV 16, D 64)
    (8, 48, 8, 2048, 128, 0), (8, 40, 8, 2048, 128, 0),
    (8, 16, 16, 2048, 64, 0)])
def test_gpu_decode_kernel_matches_plain(cuda, dtype, b, h, kv, smax, d, win):
    ((_, q), (_, kc), (_, vc)), (_, lengths) = _decode_inputs(
        (b, h, kv, smax, d, win), dtype=dtype)
    q, kc, vc, lengths = _to(cuda, q, kc, vc, lengths)
    qh = q.reshape(b, kv, h // kv, d)
    n = da.decode_attention.launches
    out = da.decode_attention(qh, kc, vc, lengths, window=win)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == n + 1
    _close(out.cpu(), da.decode_attention_plain(qh, kc, vc, lengths,
                                                window=win).float().cpu(), dtype)


@pytest.mark.gpu
def test_gpu_decode_length_zero_gives_zeros(cuda):
    ((_, q), (_, kc), (_, vc)), _ = _decode_inputs((2, 4, 2, 64, 32, 0))
    q, kc, vc = _to(cuda, q, kc, vc)
    lengths = torch.tensor([0, 9], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, kc, vc, lengths)
    assert torch.all(out[0] == 0)
    _close(out[1].cpu(), ref.decode_attention(q, kc, vc, lengths)[1].cpu())


#: (b, h, kv, smax, d, dv, window, lengths): a row shorter than the number
#: of splits, empty and full rows, a window, G in {1, 8, 32}, Dv != D
DECODE_EDGE_CASES = [
    (1, 32, 8, 2048, 128, 128, 0, [3]),
    (3, 8, 2, 512, 64, 64, 0, [0, 512, 17]),
    (2, 32, 8, 2048, 128, 128, 256, [2048, 100]),
    (2, 8, 8, 1024, 64, 64, 0, [1000, 1]),
    (2, 64, 8, 1024, 128, 128, 0, [777, 1024]),
    (2, 32, 1, 512, 64, 64, 0, [300, 512]),
    (2, 8, 2, 512, 128, 64, 0, [400, 33]),
    (1, 4, 2, 256, 32, 128, 16, [200]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,smax,d,dv,win,lens", DECODE_EDGE_CASES)
def test_gpu_decode_edge_cases_match_plain(cuda, dtype, b, h, kv, smax, d, dv,
                                           win, lens):
    q, kc, vc = [_both(x, dtype)[1].to(cuda) for x in _arrays(
        4, (b, kv, h // kv, d), (b, smax, kv, d), (b, smax, kv, dv))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, kc, vc, lengths, window=win)
    torch.cuda.synchronize()
    assert out.shape == (b, kv, h // kv, dv) and out.dtype == q.dtype
    _close(out.cpu(), da.decode_attention_plain(q, kc, vc, lengths,
                                                window=win).float().cpu(), dtype)
    assert all(torch.all(out[i] == 0) for i, n in enumerate(lens) if n == 0)


def _llama_decode(cuda, seed=5):
    """bf16 decode inputs at llama3's geometry, lengths drawn from 1..2048."""
    q, kc, vc = [_both(x, "bfloat16")[1].to(cuda) for x in _arrays(
        seed, (8, 8, 4, 128), (8, 2048, 8, 128), (8, 2048, 8, 128))]
    lens = np.random.default_rng(seed).integers(1, 2049, 8).astype(np.int32)
    return q, kc, vc, torch.from_numpy(lens).to(cuda)


@pytest.mark.gpu
def test_gpu_decode_bf16_is_deterministic(cuda):
    """Two bf16 calls agree bit for bit: the splits' partial softmaxes are
    merged in one fixed order, without atomics."""
    args = _llama_decode(cuda)
    first, second = da.decode_attention(*args), da.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.isfinite(first).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_decode_kernel_captures_in_a_cuda_graph(cuda, dtype):
    """The split count comes from the shapes, not from the lengths on the
    card, and the scratch from PyTorch's allocator: a call captures in a
    CUDA graph and its replay gives the eager result."""
    q, kc, vc, lengths = _llama_decode(cuda)
    q, kc, vc = (t.to(getattr(torch, dtype)) for t in (q, kc, vc))
    eager = da.decode_attention(q, kc, vc, lengths)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, lengths)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
def test_gpu_wrappers_raise_on_unsupported_inputs(cuda):
    q = torch.zeros(1, 1, 4, 48, device=cuda)          # head dim 48
    kc = torch.zeros(1, 16, 2, 48, device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, kc, lengths)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, kc, kc)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), kc.half(), kc.half())



#: the backward on the card: fp32 within 1e-5 and bf16 within 2e-2 of the
#: plain version, max-scaled (sums in another order; bf16 outputs rounded)
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,win,q_offset", [
    c + (0,) for c in FLASH_CASES] + [(1, 16, 64, 2, 1, 32, True, 4, -8),
                                     (2, 1024, 1024, 32, 8, 128, True, 0, 0),
                                     (1, 512, 512, 32, 8, 128, True, 256, 0)])
def test_gpu_flash_bwd_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kv, d,
                                            causal, win, q_offset):
    (_, q), (_, k), (_, v) = _qkv((b, sq, sk, h, kv, d), dtype=dtype)
    do, = [_both(x, dtype)[1] for x in _arrays(9, (b, sq, h, d))]
    q, k, v, do = _to(cuda, q, k, v, do)
    kw = dict(causal=causal, window=win, q_offset=q_offset)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    n = fa.flash_attention_bwd.launches
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == n + 1
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for t, p in zip(grads, plain):
        assert t.dtype == p.dtype and t.shape == p.shape
        _scaled_close(t.cpu(), p.float().cpu(), BWD_TOL[dtype])
    if q_offset < 0:
        assert torch.all(grads[0][:, :-q_offset] == 0)


@pytest.mark.gpu
def test_gpu_flash_bwd_bf16_is_deterministic(cuda):
    """Two bf16 backward calls at llama3's training geometry agree bit for
    bit: no atomics, one fixed order of every sum."""
    b, s, h, kv, d = 2, 1024, 32, 8, 128
    (_, q), (_, k), (_, v) = _qkv((b, s, s, h, kv, d), dtype="bfloat16")
    do, = [_both(x, "bfloat16")[1] for x in _arrays(9, (b, s, h, d))]
    q, k, v, do = _to(cuda, q, k, v, do)
    out, lse = fa.flash_attention_fwd(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.isfinite(x).all() for x in first)


@pytest.mark.gpu
def test_gpu_flash_autograd_runs_both_kernels(cuda):
    (_, q), (_, k), (_, v) = _qkv((2, 128, 128, 4, 2, 64), dtype="bfloat16")
    leaves = [t.to(cuda).requires_grad_(True) for t in (q, k, v)]
    n_fwd, n_bwd = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    ops.flash_attention(*leaves).float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n_fwd + 1
    assert fa.flash_attention_bwd.launches == n_bwd + 1
    assert all(t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad).all()
               for t in leaves)
