#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main paths for llama3-8b, falcon-mamba-7b and
granite-20b at full width in bf16 (random weights from seed 0) and checks
them, one line per phase:

1. device  — the card's name and count, its name and power limit from
             nvidia-smi; TF32 off for matmuls and convolutions.
2. build   — the four CUDA kernels compiled from src/repro_torch/csrc, one
             nvcc each, all at once, with nvcc's -Xptxas -v report; the
             SASS (cuobjdump) of the decode and flash libraries must hold
             tensor-core instructions (HGMMA in the flash forward, HGMMA or
             HMMA in the decode attention and the flash backward) and their
             bf16 kernels must spill nothing.
3. kernels — each kernel against its plain PyTorch version on the card: the
             kernel-test cases in fp32 (tolerance 2e-5; the backward 1e-5
             of the largest gradient) and the main paths' shapes in bf16
             (2e-2); times by CUDA events with the L2 cache flushed before
             each call, beside the least time the card could take (bytes at
             3.35 TB/s, flops at 989 TFLOP/s bf16), one PyTorch call
             computing the same function as a yardstick
             (scaled_dot_product_attention, or its autograd backward) and
             the kernels' device time by torch.profiler; decode attention
             also at one row with a full 2048-key cache, the shape of the
             (1 request, ctx 2048) oracle point, and at granite-20b's
             serving shape (B=8, KV=1, a GQA group of 48 run as two slices
             of 32 rows, D=128), with the K/V bytes the second slice reads
             again; the fp32 cases include groups of 48 and 40.
3b. scan   — the selective-scan kernel against its plain version: the
             kernel-test cases in fp32 with h0 (5e-5) and falcon-mamba's
             shapes in bf16 (2e-2; prefill B=1 at S=256 and 1024, decode
             B=8 at S=1 with h0), y and the final state both; times and
             device times beside the least time the card could take (bytes
             at 3.35 TB/s, fp32 flops at 67 TFLOP/s, one exp per state
             entry and step at 16 per clock per SM); no single PyTorch call
             computes a selective scan, so it has no library yardstick.
4. serving — the Engine serves 8 requests (prompts of 128-1024 tokens, 32
             new tokens each) through the decode kernel, twice, replaying a
             CUDA graph per step (captured outside the clock); decode-kernel
             launches must equal layers x decode iterations in each run and
             every logit must be finite; both makespans, their ratio, TTFT
             and TPOT are printed, and the device's idle share over one
             decode iteration (torch.profiler: the union of its kernels'
             device intervals over the iteration's time on the engine
             clock); then one decode step on the final cache with the
             kernel and with the plain reference must agree (cosine
             similarity >= 0.99 in every row).
5. prefill — Model.prefill on a 1024-token prompt through the flash kernel
             (one launch per layer), its last logits against the plain
             reference's (cosine >= 0.99).
5b. train  — llama3-8b at full width cut to 8 of its 32 layers (the only
             cut: 12 bytes per parameter of bf16 weights and grads plus fp32
             AdamW moments do not fit 80 GB at 32 layers) takes 6 AdamW
             steps of 4 x 1024 tokens in 2 microbatches with remat, through
             the flash forward and backward kernels: every loss and grad
             norm finite, 8 x 2 x 6 = 96 backward calls and twice as many
             forward launches (each layer's forward, then its recompute in
             the backward); then one microbatch's gradients with the kernels
             and with the plain attention agree (cosine >= 0.99 for every
             parameter tensor).  Step time, tokens/s, the share of the bf16
             peak and peak memory are printed beside the card.
6. measure — the self_attn decode points, each timed twice, and one prefill
             point by the cuda_events oracle (replay of a CUDA graph of
             one call); the (8, 2048) decode point must exceed (1, 512).
7. mamba serving — after llama3's weights are released, the Engine serves
             falcon-mamba-7b at full depth (64 layers) with the requests of
             phase 4, twice, from graphs as phase 4: exact-length prefill
             chunks, scan launches equal to layers x (prefill chunks +
             decode iterations), every logit finite, both makespans and the
             idle share; then one decode step on copies of the final state
             with the kernel and with the plain scan (cosine >= 0.99 per
             row).
8. mamba prefill — Model.prefill on a 1024-token prompt (one scan launch per
             layer) against the plain scan: each layer's mixer on the
             kernel path's own input (cosine >= 0.999 for outputs and
             states), and the whole prefill in float32 (cosine >= 0.99 for
             the last logits and every layer's SSM state); the bf16
             end-to-end cosines are printed, not held (64 random layers
             amplify bf16 rounding as much between two plain scan orders).
9. mamba measure — the mamba context's prefill points (256 and 1024
             tokens, 1 request) and decode points (1 and 8 requests), each
             timed twice by cuda_events; (1024, 1) must exceed (256, 1).
10. granite serving — granite-20b at full width and depth (52 layers,
             20.3 B parameters, no cut) serves the phase-4 requests through
             the decode kernel at G = 48: launches equal layers x decode
             iterations, every logit finite, one decode step kernel vs plain
             (cosine >= 0.99 per row); its self_attn decode point at (8
             requests, ctx 2048) is timed twice by cuda_events.
11. tracer — the tainted runner traces llama3-8b and granite-20b at full
             width on the meta device, then runs every op entry of their
             runnable sets once on the card; no op may fall back to a module
             entry where the smoke config's CPU runnable set has it as an op.
12. profile->simulate — Dooly's loop on llama3-8b and command-r7b at full
             width, in a fresh process (its fingerprints come before any
             cuda_events timing there): a plan over both models with a sweep
             that brackets every point the engine asks for (prefill chunks
             of 8-256 tokens against ctx 2048, the decode batch of 8 at ctx
             2048), its coverage table, then its execution by cuda_events:
             the dry run's point count must equal the rows written, the
             GQA 32/8/128 global self_attn task must be measured once and
             shared by both models, no fingerprint may fall back, and the
             profiling GPU-seconds spent and saved are printed.  DoolySim is
             calibrated on one engine run (4 requests of 512 tokens), then
             a ShareGPT-like trace of 32 requests (seed 4) is served twice
             on the engine (its self-noise) and predicted by DoolySim:
             TTFT, TPOT and makespan MAPE, beside the roofline backend's
             makespan.  It fails on a MAPE that is not finite, a DB point
             missing, or a makespan MAPE above 25 %.
A JSON line then lists every kernel with its launches on the main paths,
its largest error against its plain version, and its times.

The last line is {"ok": true, "device": {...}}.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits 1 at once.  Each
phase is a function of (cfg, device), so the tests run them on the CPU at a
smoke configuration, where the kernel wrappers take their plain versions.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api import ProfileStore  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.profiler import SweepConfig  # noqa: E402
from repro_torch.core.signature import fingerprint  # noqa: E402
from repro_torch.parallel.roofline import default_hardware  # noqa: E402
from repro_torch.core.opset import (ModuleEntry, OpEntry,  # noqa: E402
                                    find_runnable_set)
from repro_torch.core.runner import trace_model  # noqa: E402
from repro_torch.core.backends import cpu_wallclock, cuda_events  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.serving import (Engine, Request, SchedulerConfig,  # noqa: E402
                                 bucket_chunk, build_context)
from repro_torch.serving.scheduler import IterationPlan  # noqa: E402
from repro_torch.sim import metrics as M  # noqa: E402
from repro_torch.train import (DataConfig, TokenStream,  # noqa: E402
                               init_train_state, make_optimizer, make_train_step)
from repro_torch.workload import sharegpt_like, synthetic  # noqa: E402

#: H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: exp results per clock per SM (the SFU's rate for compute capability 9.0
#: in NVIDIA's arithmetic-throughput table), and the H100 SXM's SMs and top
#: SM clock, used where no card reports its own
EXP_PER_CLOCK_SM = 16
NOMINAL_SMS, NOMINAL_SM_HZ = 132, 1.98e9

#: the cases of tests/test_kernels.py: (b, h, kv, smax, d, window) and
#: (b, sq, sk, h, kv, d, causal, window); the decode cases also at GQA groups
#: of 48 (granite-20b's) and 40 (an uneven last slice of 32 rows)
DECODE_CASES = [(2, 4, 2, 256, 64, 0), (3, 8, 1, 512, 64, 0),
                (2, 4, 4, 256, 64, 64), (1, 8, 2, 128, 32, 0),
                (2, 48, 1, 256, 64, 0), (3, 80, 2, 128, 32, 0)]
FLASH_CASES = [(2, 128, 128, 4, 2, 64, True, 0), (1, 256, 256, 8, 8, 32, True, 0),
               (2, 128, 128, 4, 1, 64, True, 48), (1, 100, 100, 2, 2, 64, False, 0),
               (1, 64, 192, 4, 2, 32, True, 0)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the scan: tests/test_kernels.py test_pallas_mamba_scan's (b, s, di, n)
#: cases, held at its 5e-5 in fp32
SCAN_CASES = [(2, 64, 32, 8), (1, 300, 64, 16), (2, 50, 16, 4)]
SCAN_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
SCAN_PREFILL_LENS = (256, 1024)
#: the backward, max-scaled: |kernel - plain| / max|plain|
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

SCHED = SchedulerConfig(max_num_seqs=8, max_batch_tokens=512, chunk_size=256)
MAX_SEQ = 2048
N_REQUESTS, NEW_TOKENS, PROMPT_LENS = 8, 32, (128, 1024)
PREFILL_LEN = 1024
WINDOW = 256                 # the windowed kernel cases
MEASURE_POINTS = [(1, 512), (1, 2048), (8, 512), (8, 2048)]   # (reqs, ctx)
PREFILL_POINT = (256, 1, 2048)                                 # (toks, reqs, ctx)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 1024
TRAIN_STEPS, MICROBATCHES, LEARNING_RATE = 6, 2, 3e-4
MAMBA = "falcon-mamba-7b"
GRANITE = "granite-20b"
GRANITE_POINT = (8, 2048)                                      # (reqs, ctx)
MAMBA_PREFILL_POINTS = [(256, 1), (1024, 1)]                   # (toks, reqs)
MAMBA_DECODE_REQS = (1, 8)
#: phase 12: the sweep brackets every point the engine asks for (chunk
#: buckets 8-256 at one request against the full 2048-slot cache, the decode
#: batch of 8 rows at ctx 2048); 20 repeats, as cuda_events replays each
#: point 20 times
PROFILE_MODELS = ("llama3-8b", "command-r7b")
PROFILE_SWEEP = SweepConfig(toks=(8, 16, 32, 64, 128, 256), reqs=(1, 8),
                            ctx=(512, 2048),
                            op_points=((8, 1), (16, 1), (32, 1), (64, 1),
                                       (128, 1), (256, 1), (1, 8)),
                            repeats=20)
PROFILE_BACKEND = "kernel"
CALIBRATION = dict(n=4, rate=1.0, prompt_len=512, out_len=32, seed=9)
SCORE = dict(n=32, rate=4.0, seed=4, scale=0.25)
SHARED_VARIANT = "32/8/128"          # the GQA geometry llama3 shares
MAKESPAN_MAPE_LIMIT = 25.0
PAPER_MAPE = {"ttft_mape": 5.0, "tpot_mape": 8.0}

#: the libraries whose bf16 path runs on the tensor cores, and the SASS
#: instructions of which one must appear: wgmma (HGMMA), or mma.sync (HMMA)
TENSOR_CORE_LIBS = {"decode_attention": ("HGMMA", "HMMA"),
                    "flash_attention_fwd": ("HGMMA",),
                    "flash_attention_bwd": ("HGMMA", "HMMA")}

SOURCES = {"decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:78"),
           "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention_fwd.cu",
                                   "src/repro/kernels/flash_attention.py:93"),
           "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                   "src/repro/kernels/flash_attention.py:227"),
           "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                          "src/repro/kernels/mamba_scan.py:62")}


def _zero_counts():
    da.decode_attention.launches = fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = ms.mamba_scan.launches = 0


def _counts() -> tuple:
    """(decode, flash forward, flash backward, scan) kernel launches since
    ``_zero_counts``."""
    return (da.decode_attention.launches, fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches, ms.mamba_scan.launches)


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _randn(rng, shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(device=device, dtype=dtype)


def _time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of one call.  On the card: CUDA events around each call,
    with the 50 MB L2 cache flushed before it, as a caller that moves on to
    the next layer finds it cold."""
    if device.type != "cuda":
        return cpu_wallclock(fn, (), repeats=3, warmup=1) * 1e3
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _device_ms(fn, device, name: str, reps: int = 10):
    """Mean device time of one call's kernels whose name holds ``name`` by
    torch.profiler, calls back to back with the L2 cache warm: the card's own
    time, without the host's launch path and the cold cache that
    ``_time_ms`` includes.  None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if name in e.key)
    return us / reps / 1e3


def _sdpa(q, k, v, **kw):
    """scaled_dot_product_attention with grouped KV heads, the yardstick."""
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:        # torch without enable_gqa: expand the groups
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def _exp_per_s(device) -> float:
    """The card's exp rate: SMs x 16 per clock x its top SM clock
    (nvidia-smi clocks.max.sm)."""
    if device.type != "cuda":
        return NOMINAL_SMS * EXP_PER_CLOCK_SM * NOMINAL_SM_HZ
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * EXP_PER_CLOCK_SM * float(mhz) * 1e6


def _bound(nbytes: int, flops: int, dtype, exps: int = 0, device=None) -> tuple:
    """(least ms, what bounds it): bytes over the memory rate, flops over
    the dtype's peak, and ``exps`` over the card's exp rate."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": flops / PEAK_FLOPS[dtype]}
    if exps:
        terms["exp"] = exps / _exp_per_s(device)
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def _err(out, ref, dtype, what: str, tol: float = 0.0) -> float:
    out, ref = out.float(), ref.float()
    tol = tol or TOL[dtype]
    _require(bool(((out - ref).abs() <= tol + tol * ref.abs()).all()),
             f"{what} within {tol} of its plain version")
    return float((out - ref).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cfg, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = _card(device)
    print(f"[1 device] {kind} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off")
    print(smi)
    return {"kind": kind, "count": count, "smi": smi}


def ptxas_spills(report: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} from an ``-Xptxas -v``
    report."""
    spills, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
    return spills


def sass_counts(sass: str) -> dict:
    """Tensor-core instructions in a ``cuobjdump --dump-sass`` listing:
    ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync)."""
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}


def check_tensor_cores(reports: dict, sass: dict) -> dict:
    """Raises unless each library of TENSOR_CORE_LIBS holds the tensor-core
    instructions it must, and unless its bf16 kernels (those of namespace
    ``tc``, the ``wgmma`` kernels and every bf16 instantiation) spill
    nothing.  ``sass`` maps a library
    to its SASS listing; returns each one's instruction counts."""
    counts = {}
    for name, ops in TENSOR_CORE_LIBS.items():
        counts[name] = sass_counts(sass[name])
        _require(any(counts[name][op] for op in ops),
                 f"{name}: SASS holds {' or '.join(ops)} ({counts[name]})")
        bf16 = {fn: sp for fn, sp in ptxas_spills(reports[name]).items()
                if "repro_torch2tc" in fn or "wgmma" in fn or "bfloat16" in fn}
        _require(bool(bf16) and not any(a or b for a, b in bf16.values()),
                 f"{name}: bf16 kernels spill nothing ({bf16})")
    return counts


def _sass(name: str) -> str:
    """``cuobjdump --dump-sass`` of a built library (cuobjdump beside nvcc)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "--dump-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def phase_build(cfg, device) -> dict:
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"[2 build] {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    counts = check_tensor_cores(reports, {n: _sass(n) for n in TENSOR_CORE_LIBS})
    for name, c in counts.items():
        print(f"[2 build] {name}: SASS {c['HGMMA']} HGMMA, {c['HMMA']} HMMA; "
              "bf16 kernels spill 0 bytes")
    return reports


def _decode_case(rng, b, kv, g, smax, d, window, dtype, device, timed: bool,
                 full: bool = False):
    """One decode call on the kernel and on the plain version; lengths drawn
    from 1..smax, or every row's cache full with ``full``."""
    q = _randn(rng, (b, kv, g, d), dtype, device)
    kc = _randn(rng, (b, smax, kv, d), dtype, device)
    vc = _randn(rng, (b, smax, kv, d), dtype, device)
    lens = np.full(b, smax) if full else rng.integers(1, smax + 1, b)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=device)
    out = da.decode_attention(q, kc, vc, lengths, window=window)
    plain = da.decode_attention_plain(q, kc, vc, lengths, window=window)
    res = {"max_abs_err": _err(out, plain, dtype,
                               f"decode_attention {(b, kv, g, smax, d, window)} {dtype}")}
    if timed:
        lo = np.maximum(lens - window, 0) if window else np.zeros_like(lens)
        keys = int((np.minimum(lens, smax) - lo).sum())
        esz = q.element_size()
        nbytes = (q.numel() + out.numel()) * esz + lengths.numel() * 4 \
            + keys * kv * 2 * d * esz
        res["bound_ms"], res["bound_by"] = _bound(nbytes, 2 * keys * kv * g * 2 * d,
                                                  dtype)
        # a group above 32 rows runs in slices, each reading the keys again
        res["reread_bytes"] = (da.group_slices(g) - 1) * keys * kv * 2 * d * esz
        res["ms"] = _time_ms(lambda: da.decode_attention(q, kc, vc, lengths,
                                                         window=window), device)
        res["device_ms"] = _device_ms(lambda: da.decode_attention(
            q, kc, vc, lengths, window=window), device, "decode_")
        res["plain_ms"] = _time_ms(lambda: da.decode_attention_plain(
            q, kc, vc, lengths, window=window), device)
        qh = q.reshape(b, kv * g, 1, d)
        kh, vh = kc.transpose(1, 2), vc.transpose(1, 2)
        mask = (torch.arange(smax, device=device)[None, :] < lengths[:, None])
        mask = mask[:, None, None, :]
        res["library_ms"] = _time_ms(lambda: _sdpa(qh, kh, vh, attn_mask=mask),
                                     device)
    return res


def _flash_case(rng, b, sq, sk, h, kv, d, causal, window, dtype, device,
                timed: bool):
    q = _randn(rng, (b, sq, h, d), dtype, device)
    k = _randn(rng, (b, sk, kv, d), dtype, device)
    v = _randn(rng, (b, sk, kv, d), dtype, device)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    what = f"flash_attention_fwd {(b, sq, sk, h, kv, d, causal, window)} {dtype}"
    res = {"max_abs_err": max(_err(out, pout, dtype, what),
                              _err(lse, plse, torch.float32, what + " lse"))}
    if timed:
        pairs = _pairs(sq, sk, causal, window)
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
            * q.element_size() + lse.numel() * 4
        res["bound_ms"], res["bound_by"] = _bound(nbytes, 4 * b * h * pairs * d,
                                                  dtype)
        res["ms"] = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), device)
        res["device_ms"] = _device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                      device, "flash_")
        res["plain_ms"] = _time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                                   device)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        res["library_ms"] = _time_ms(lambda: _sdpa(qh, kh, vh, is_causal=causal),
                                     device)
    return res


def _pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the masks leave, per batch row and head."""
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return int(mask.sum())


def _flash_bwd_case(rng, b, sq, sk, h, kv, d, causal, window, dtype, device,
                    timed: bool):
    q = _randn(rng, (b, sq, h, d), dtype, device)
    k = _randn(rng, (b, sk, kv, d), dtype, device)
    v = _randn(rng, (b, sk, kv, d), dtype, device)
    do = _randn(rng, (b, sq, h, d), dtype, device)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    what = f"flash_attention_bwd {(b, sq, sk, h, kv, d, causal, window)} {dtype}"
    err = scaled = 0.0
    for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
        diff = float((g.float() - p.float()).abs().max())
        err, scaled = max(err, diff), max(scaled, diff / float(p.float().abs().max()))
        _require(scaled <= BWD_TOL[dtype],
                 f"{what} {name} within {BWD_TOL[dtype]} of the largest plain "
                 f"gradient ({scaled:.3g})")
    res = {"max_abs_err": err, "max_scaled_err": scaled}
    if timed:
        pairs = _pairs(sq, sk, causal, window)
        esz = q.element_size()
        nbytes = (3 * q.numel() + 2 * k.numel() + out.numel() + do.numel()
                  + 2 * v.numel()) * esz + 2 * lse.numel() * 4
        res["bound_ms"], res["bound_by"] = _bound(nbytes, 10 * b * h * pairs * d,
                                                  dtype)
        res["ms"] = _time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), device)
        res["device_ms"] = _device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, **kw), device, "flash_")
        res["plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw), device)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        o = _sdpa(*leaves, is_causal=causal)
        doh = do.transpose(1, 2)
        res["library_ms"] = _time_ms(lambda: torch.autograd.grad(
            o, leaves, doh, retain_graph=True), device)
    return res


def phase_kernels(cfg, device, gqa_cfg=None) -> dict:
    """Each kernel against its plain version; returns, per kernel, the
    largest error over all cases and the main path's times.  Decode attention
    is also timed at ``gqa_cfg``'s serving shape (default granite-20b: a GQA
    group of 48, run as two slices of the group)."""
    gqa_cfg = gqa_cfg or get_config(GRANITE)
    rng = np.random.default_rng(0)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    bf16 = torch.bfloat16
    errs = {"decode_attention": [], "flash_attention_fwd": [],
            "flash_attention_bwd": []}
    for b, h, kvh, smax, d, win in DECODE_CASES:
        errs["decode_attention"].append(_decode_case(
            rng, b, kvh, h // kvh, smax, d, win, torch.float32, device, False))
    for b, sq, sk, h, kvh, d, causal, win in FLASH_CASES:
        errs["flash_attention_fwd"].append(_flash_case(
            rng, b, sq, sk, h, kvh, d, causal, win, torch.float32, device, False))
    for b, sq, sk, h, kvh, d, causal, win in FLASH_CASES[:3]:
        errs["flash_attention_bwd"].append(_flash_bwd_case(
            rng, b, sq, sk, h, kvh, d, causal, win, torch.float32, device, False))
    b = SCHED.max_num_seqs
    main = {
        "decode_attention": _decode_case(rng, b, kv, g, MAX_SEQ, hd, 0, bf16,
                                         device, True),
        "flash_attention_fwd": _flash_case(rng, 1, PREFILL_LEN, PREFILL_LEN,
                                           cfg.n_heads, kv, hd, True, 0, bf16,
                                           device, True),
        "flash_attention_bwd": _flash_bwd_case(
            rng, TRAIN_BATCH // MICROBATCHES, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads,
            kv, hd, True, 0, bf16, device, True)}
    errs["decode_attention"].append(_decode_case(
        rng, b, kv, g, MAX_SEQ, hd, WINDOW, bf16, device, False))
    # the (1 request, ctx 2048) oracle point's shape: one row, a full cache
    full = _decode_case(rng, 1, kv, g, MAX_SEQ, hd, 0, bf16, device, True,
                        full=True)
    errs["decode_attention"].append(full)
    gg = gqa_cfg.n_heads // gqa_cfg.n_kv_heads
    gqa = _decode_case(rng, b, gqa_cfg.n_kv_heads, gg, MAX_SEQ,
                       gqa_cfg.resolved_head_dim, 0, bf16, device, True)
    errs["decode_attention"].append(gqa)
    main["decode_attention"]["timed"] = {
        f"B={b} random lengths": dict(main["decode_attention"]),
        f"B=1 full ctx {MAX_SEQ}": full,
        f"{gqa_cfg.name} B={b} G={gg} random lengths": gqa}
    errs["flash_attention_fwd"].append(_flash_case(
        rng, 1, PREFILL_LEN, PREFILL_LEN, cfg.n_heads, kv, hd, True, WINDOW,
        bf16, device, False))
    errs["flash_attention_bwd"].append(_flash_bwd_case(
        rng, TRAIN_BATCH // MICROBATCHES, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, kv,
        hd, True, WINDOW, bf16, device, False))
    card = _card(device)
    for name, res in main.items():
        for key in ("max_abs_err", "max_scaled_err"):
            if key in res:
                res[key] = max([res[key]] + [e[key] for e in errs[name]])
        scaled = (f", max scaled err {res['max_scaled_err']:.3g}"
                  if "max_scaled_err" in res else "")
        dev = (f" (device {res['device_ms']:.4f} ms by the profiler, warm L2)"
               if res.get("device_ms") is not None else "")
        print(f"[3 kernels] {name}: {len(errs[name]) + 1} cases agree with the "
              f"plain version (max abs err {res['max_abs_err']:.3g}{scaled}); "
              f"main path {res['ms']:.4f} ms{dev}, plain {res['plain_ms']:.4f} ms, "
              f"library {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
              f"ms ({res['bound_by']}); {card}")
        for shape, r in res.get("timed", {}).items():
            reread = (f"; slices re-read {r['reread_bytes'] / 2**20:.1f} MiB of "
                      "K/V (from L2 when they run side by side)"
                      if r.get("reread_bytes") else "")
            print(f"  {shape}: kernel {r['ms']:.4f} ms{_dev(r)}, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){reread}")
    return main


def _dev(res) -> str:
    return (f" (device {res['device_ms']:.4f} ms)"
            if res.get("device_ms") is not None else "")


def _scan_case(rng, b, s, di, n, dtype, device, *, h0: bool, timed: bool,
               dt_rank: int = 0):
    """One scan call on the kernel and on the plain version.  With
    ``dt_rank``, Bc and Cc are column slices of one (B, S, dt_rank + 2N)
    tensor, as the mixer's ``x_proj`` output gives them."""
    f32 = torch.float32
    x = _randn(rng, (b, s, di), dtype, device)
    dt = F.softplus(_randn(rng, (b, s, di), f32, device))
    A = -torch.exp(0.3 * _randn(rng, (di, n), f32, device))
    if dt_rank:
        xdbc = _randn(rng, (b, s, dt_rank + 2 * n), dtype, device)
        Bc, Cc = xdbc[..., dt_rank:dt_rank + n], xdbc[..., dt_rank + n:]
    else:
        Bc, Cc = _randn(rng, (b, s, n), dtype, device), _randn(rng, (b, s, n),
                                                                dtype, device)
    D = _randn(rng, (di,), f32, device)
    args = (x, dt, A, Bc, Cc, D,
            _randn(rng, (b, di, n), f32, device) if h0 else None)
    y, h = ms.mamba_scan(*args)
    py, ph = ms.mamba_scan_plain(*args)
    what, tol = f"mamba_scan {(b, s, di, n)} {dtype}", SCAN_TOL[dtype]
    res = {"max_abs_err": max(_err(y, py, dtype, what + " y", tol),
                              _err(h, ph, dtype, what + " h", tol))}
    if timed:
        nbytes = (x.numel() + Bc.numel() + Cc.numel() + y.numel()) \
            * x.element_size() + (dt.numel() + A.numel() + D.numel()
                                  + (args[-1].numel() if h0 else 0)
                                  + h.numel()) * 4
        # per (b, t, d, n): dt*A, the state's fma, B times dt*x, C*h and its
        # sum; per (b, t, d): dt*x, D*x and its add
        res["bound_ms"], res["bound_by"] = _bound(
            nbytes, b * s * di * (6 * n + 3), f32, exps=b * s * di * n,
            device=device)
        res["ms"] = _time_ms(lambda: ms.mamba_scan(*args), device)
        res["device_ms"] = _device_ms(lambda: ms.mamba_scan(*args), device, "scan_")
        res["plain_ms"] = _time_ms(lambda: ms.mamba_scan_plain(*args), device)
        res["library_ms"] = None      # no PyTorch call computes the scan
    return res


def phase_scan(cfg, device) -> dict:
    """The scan kernel against its plain version (``cfg``: the Mamba
    model); returns ``{"mamba_scan": ...}`` with the largest error over all
    cases and the times of the 1024-token prefill, plus the other timed
    shapes under ``"timed"``."""
    rng = np.random.default_rng(0)
    di, n, dtr = cfg.ssm_d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    bf16 = torch.bfloat16
    errs = [_scan_case(rng, b, s, d, k, torch.float32, device, h0=True,
                       timed=False)["max_abs_err"] for b, s, d, k in SCAN_CASES]
    timed = {f"prefill B=1 S={s}": _scan_case(rng, 1, s, di, n, bf16, device,
                                              h0=False, timed=True, dt_rank=dtr)
             for s in SCAN_PREFILL_LENS}
    timed[f"decode B={SCHED.max_num_seqs} S=1"] = _scan_case(
        rng, SCHED.max_num_seqs, 1, di, n, bf16, device, h0=True, timed=True,
        dt_rank=dtr)
    main = dict(timed[f"prefill B=1 S={max(SCAN_PREFILL_LENS)}"])
    main["max_abs_err"] = max(errs + [t["max_abs_err"] for t in timed.values()])
    main["timed"] = timed
    print(f"[3b kernels] mamba_scan: {len(errs) + len(timed)} cases agree with "
          f"the plain version (max abs err {main['max_abs_err']:.3g}); Di={di}, "
          f"N={n}, bf16; library: none (no single PyTorch call computes a "
          f"selective scan); {_card(device)}")
    for shape, res in timed.items():
        print(f"  {shape}: kernel {res['ms']:.4f} ms{_dev(res)}, plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']})")
    return {"mamba_scan": main}


def _requests(cfg):
    """The phase-4 workload: 8 requests at t=0, prompts of 128-1024 tokens
    (numpy seed 0), 32 new tokens each."""
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return lens, [Request(i, 0.0, rng.integers(0, cfg.vocab_size, n).tolist(),
                          NEW_TOKENS) for i, n in enumerate(lens)]


def _idle_share(engine, requests, device):
    """The device's idle share over one steady decode iteration of all the
    requests' rows: 1 - (union of the kernels' device intervals) / (the
    iteration's time on the engine clock), from torch.profiler; also against
    the same iteration's time without the profiler, which slows the
    replay's launches, and the kernels that take most of the busy time.
    Run after the workload; each iteration advances every row by one
    token.  None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import DeviceType, ProfilerActivity, profile
    plan = IterationPlan([], list(requests))
    engine.execute(plan)
    plain_wall = engine.execute(plan)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = engine.execute(plan)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _require(bool(kernels), "the profiler saw the decode iteration's kernels")
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy_s = busy * 1e-6
    return {"wall_s": wall, "plain_wall_s": plain_wall, "busy_s": busy_s,
            "kernels": len(kernels), "idle_share": 1.0 - busy_s / wall,
            "idle_share_unprofiled": 1.0 - busy_s / plain_wall,
            "top": [(name[:60], us * 1e-3) for name, us in top]}


def _serve(cfg, device, runs: int = 2) -> dict:
    """The Engine serves the phase-4 requests ``runs`` times through the
    kernel backend (``Engine.reset`` between runs, keeping its graphs),
    counts zeroed just before each ``run`` and read just after; then the
    device's idle share over one decode iteration."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    engine = Engine(cfg, sched_config=SCHED, max_seq=MAX_SEQ, impl="kernel",
                    seed=0, device=device)
    finite = []

    def watch(step):
        def run(*a, **kw):
            logits = step(*a, **kw)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits
        return run
    for name in ("_chunk_graph", "_chunk_eager", "_decode_graph", "_decode_eager"):
        setattr(engine, name, watch(getattr(engine, name)))

    out = {"engine": engine, "runs": []}
    for i in range(runs):
        if i:
            engine.reset()
        lens, requests = _requests(cfg)
        _zero_counts()
        t0 = time.perf_counter()
        engine.run(requests)
        wall = time.perf_counter() - t0
        counts = _counts()
        _require(all(finite), "every logit of the run is finite")
        _require(all(r.done and r.generated == NEW_TOKENS for r in requests),
                 "every request finished with its new tokens")
        out["runs"].append({
            "makespan": engine.clock, "wall": wall, "counts": counts,
            "iterations": len(engine.records),
            "decode_iters": sum(1 for r in engine.records if r.n_decodes),
            "ttft": [r.first_token_t - r.arrival for r in requests],
            "tpot": [(r.finish_t - r.first_token_t) / (r.generated - 1)
                     for r in requests]})
    first = out["runs"][0]
    _require(all((r["counts"], r["decode_iters"]) == (first["counts"],
                                                       first["decode_iters"])
                 for r in out["runs"]),
             "every run launches the same kernels the same number of times")
    out.update(requests=requests, lens=lens, counts=first["counts"],
               decode_iters=first["decode_iters"],
               peak=torch.cuda.max_memory_allocated(device) if cuda else 0,
               graphs=len(engine.graphs))
    out["idle"] = _idle_share(engine, requests, device)
    return out


def _print_runs(tag: str, run: dict, card: str):
    """Each run's makespan, TTFT and TPOT, the makespans' ratio and the
    idle share."""
    spans = [r["makespan"] for r in run["runs"]]
    print(f"  makespans {', '.join(f'{x:.4f}' for x in spans)} s (engine clock; "
          f"ratio {max(spans) / min(spans):.4f}), {run['graphs']} CUDA graphs "
          f"(captured outside the clock); {card}")
    for i, r in enumerate(run["runs"]):
        print(f"  run {i + 1}: ttft_s " + " ".join(f"{t:.4f}" for t in r["ttft"]))
        print(f"  run {i + 1}: tpot_s " + " ".join(f"{t:.5f}" for t in r["tpot"]))
    if run["idle"] is not None:
        idle = run["idle"]
        print(f"  {tag}: one decode iteration {idle['plain_wall_s'] * 1e3:.3f} ms "
              f"({idle['wall_s'] * 1e3:.3f} ms under torch.profiler), kernels "
              f"busy {idle['busy_s'] * 1e3:.3f} ms over {idle['kernels']} device "
              f"activities: device idle share {idle['idle_share']:.4f} of the "
              f"profiled iteration, {idle['idle_share_unprofiled']:.4f} of the "
              f"unprofiled one; most busy: "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in idle["top"]))


def _run_summary(run: dict) -> dict:
    return {"makespans_s": [r["makespan"] for r in run["runs"]],
            "ttft_s": [r["ttft"] for r in run["runs"]],
            "tpot_s": [r["tpot"] for r in run["runs"]],
            "idle": run["idle"], "peak_bytes": run["peak"],
            "decode_iterations": run["decode_iters"]}


def phase_serving(cfg, device) -> dict:
    cuda = device.type == "cuda"
    run = _serve(cfg, device)
    engine, requests, decode_iters = run["engine"], run["requests"], run["decode_iters"]
    launches, flash, flash_bwd, scan = run["counts"]
    expect = cfg.n_layers * decode_iters if cuda else 0
    _require(launches == expect,
             f"decode-kernel launches {launches} == {expect} (layers x decode iterations)")
    # chunked prefill attends against the cache without the flash kernel,
    # as the reference dispatches it
    _require(flash == flash_bwd == scan == 0,
             f"no flash- or scan-kernel launch while serving ({flash}, "
             f"{flash_bwd}, {scan})")
    peak = run["peak"]
    print(f"[4 serving] {cfg.name}: {len(requests)} requests, prompts "
          f"{sorted(run['lens'].tolist())}, served {len(run['runs'])} times, "
          f"{run['runs'][0]['iterations']} iterations ({decode_iters} with "
          f"decodes), peak memory {peak / 2**30:.2f} GiB, decode-kernel launches "
          f"{launches} a run")
    _print_runs("4 serving", run, _card(device))
    cos = _decode_vs_plain(engine, device)
    print(f"  decode step on the final cache, kernel vs plain: min cosine "
          f"{cos:.6f}")
    out = {"decode_launches": launches, **_run_summary(run), "min_cosine": cos}
    del engine, run
    _release(device)
    return out


def _decode_vs_plain(engine, device) -> float:
    """One decode step on the final cache with the kernel and with the plain
    reference (cosine >= 0.99 in every row); returns the least cosine."""
    lengths = torch.tensor(engine.lengths, dtype=torch.int32, device=device)
    toks = [1] * SCHED.max_num_seqs
    lk, _ = engine.model.decode_step(engine.cache, toks, lengths, impl="kernel")
    lx, _ = engine.model.decode_step(engine.cache, toks, lengths, impl="xla")
    cos = F.cosine_similarity(lk, lx, dim=-1)
    _require(bool((cos >= 0.99).all()),
             f"decode logits kernel vs plain cosine >= 0.99 (min {float(cos.min()):.5f})")
    return float(cos.min())


def phase_prefill(cfg, device) -> dict:
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    model.requires_grad_(False)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PREFILL_LEN))
    _zero_counts()
    t0 = time.perf_counter()
    lk, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="kernel")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    decode, launches, backward, scan = _counts()
    expect = cfg.n_layers if device.type == "cuda" else 0
    _require(launches == expect and decode == backward == scan == 0,
             f"flash-kernel launches {launches} == {expect}, decode {decode}, "
             f"backward {backward} and scan {scan} == 0")
    _require(bool(torch.isfinite(lk).all()), "prefill logits are finite")
    lx, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    cos = float(F.cosine_similarity(lk, lx, dim=-1).min())
    _require(cos >= 0.99, f"prefill logits kernel vs plain cosine >= 0.99 ({cos:.5f})")
    print(f"[5 prefill] {PREFILL_LEN} tokens in {wall:.4f} s (first call, host "
          f"clock), flash-kernel launches {launches}, last-position cosine "
          f"kernel vs plain {cos:.6f}")
    del model
    _release(device)
    return {"flash_launches": launches, "cosine": cos}


def phase_train(cfg, device, *, seq: int = TRAIN_SEQ,
                steps: int = TRAIN_STEPS) -> dict:
    """AdamW steps of llama3 cut to TRAIN_LAYERS layers through the kernel
    backend, then one microbatch's gradients with the kernels against the
    plain attention's.  ``seq`` and ``steps`` let the CPU tests run it
    small."""
    tcfg = cfg.with_overrides(n_layers=TRAIN_LAYERS)
    cuda = device.type == "cuda"
    model = Model(tcfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    state = init_train_state(model, make_optimizer(tcfg.optimizer))
    step_fn = make_train_step(model, microbatches=MICROBATCHES,
                              learning_rate=LEARNING_RATE, impl="kernel")
    stream = TokenStream(DataConfig(tcfg.vocab_size, TRAIN_BATCH, seq))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, gnorms, times = [], [], []
    _zero_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, stream.batch_at(i))
        losses.append(float(metrics["loss"]))        # waits for the step
        gnorms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
    decode, fwd, bwd, scan = _counts()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    calls = TRAIN_LAYERS * MICROBATCHES * steps
    # remat: each layer's forward runs again inside its backward
    expect_bwd, expect_fwd = (calls, 2 * calls) if cuda else (0, 0)
    _require(bwd == expect_bwd and fwd == expect_fwd and decode == scan == 0,
             f"flash backward calls {bwd} == {expect_bwd} (layers x microbatches "
             f"x steps), forward launches {fwd} == {expect_fwd} (twice that: "
             f"remat), decode {decode} and scan {scan} == 0")
    _require(all(np.isfinite(losses + gnorms)),
             f"every loss and grad norm is finite ({losses}, {gnorms})")

    tokens = TRAIN_BATCH * seq
    n_params = sum(p.numel() for p in model.parameters())
    n_layer_params = sum(p.numel() for p in model.layers.parameters())
    flops = 6 * n_params * tokens + 2 * n_layer_params * tokens
    step_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    card = _card(device)
    print(f"[5b train] {tcfg.name} at full width, cut to {TRAIN_LAYERS} of "
          f"{cfg.n_layers} layers (the only cut), {n_params / 1e9:.3f} B "
          f"parameters, {tcfg.dtype}, AdamW, remat, {steps} steps of "
          f"{TRAIN_BATCH} x {seq} tokens in {MICROBATCHES} microbatches; {card}")
    print("  loss " + " ".join(f"{x:.4f}" for x in losses))
    print("  grad_norm " + " ".join(f"{x:.4f}" for x in gnorms))
    print(f"  step {step_s:.4f} s (median after the first, host clock; first "
          f"{times[0]:.3f} s), {tokens / step_s:.0f} tokens/s, "
          f"{flops / step_s / PEAK_FLOPS[torch.bfloat16] * 100:.2f} % of the "
          f"989 TFLOP/s bf16 peak (6 P T + 2 P_layers T), peak memory "
          f"{peak / 2**30:.2f} GiB; flash launches forward {fwd}, backward {bwd}; "
          f"{card}")

    mb = {k: v[:TRAIN_BATCH // MICROBATCHES]
          for k, v in stream.batch_at(steps).items()}
    params = list(model.parameters())
    gk = torch.autograd.grad(model.loss(mb, impl="kernel")[0], params)
    gx = torch.autograd.grad(model.loss(mb, impl="xla")[0], params)
    cos = [float(F.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                     dim=0)) for a, b in zip(gk, gx)]
    _require(min(cos) >= 0.99, f"gradient cosine kernel vs plain >= 0.99 for "
             f"every parameter tensor (min {min(cos):.5f})")
    print(f"  one microbatch's gradients, kernel vs plain attention: min cosine "
          f"{min(cos):.6f} over {len(cos)} tensors")
    out = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
           "first_step_s": times[0], "tokens_per_s": tokens / step_s,
           "peak_bytes": peak, "flash_fwd_launches": fwd,
           "flash_bwd_launches": bwd, "min_cosine": min(cos)}
    del model, state, step_fn, gk, gx
    _release(device)
    return out


def _decode_point(cfg, device, reqs: int, ctx: int, gen, oracle) -> list:
    """One self_attn decode point through the oracle, timed twice, with
    every row's cache full up to ``ctx``."""
    cuda = device.type == "cuda"
    mc = build_context(cfg, "self_attn", phase="decode", backend="kernel",
                       device=device)
    attn = mc.module(mc.materialize(mc.params, gen))
    x, kc, vc, lengths = mc.materialize(mc.abstract_inputs(1, reqs, ctx), gen)
    # materialize leaves integer inputs at 0, which would time an empty
    # context; a full cache is what this point stands for
    lengths.fill_(ctx - 1)
    args = (attn, x, kc, vc, lengths)
    return [oracle(mc.fn, args, device=device) if cuda else oracle(mc.fn, args)
            for _ in range(2)]


def phase_measure(cfg, device) -> dict:
    """Each decode point twice and one prefill point through the oracle:
    cuda_events (a CUDA graph's replay) on the card, cpu_wallclock here."""
    cuda = device.type == "cuda"
    oracle = cuda_events if cuda else cpu_wallclock
    gen = torch.Generator(device=device).manual_seed(0)
    out = {("decode", 1, r, c): _decode_point(cfg, device, r, c, gen, oracle)
           for r, c in MEASURE_POINTS}
    mc = build_context(cfg, "self_attn", phase="prefill", backend="kernel",
                       device=device)
    attn = mc.module(mc.materialize(mc.params, gen))
    toks, reqs, ctx = PREFILL_POINT
    x, kc, vc, lengths = mc.materialize(mc.abstract_inputs(toks, reqs, ctx), gen)
    lengths.fill_(ctx - toks)
    args = (attn, x, kc, vc, lengths)
    out[("prefill", toks, reqs, ctx)] = [
        oracle(mc.fn, args, device=device) if cuda else oracle(mc.fn, args)
        for _ in range(2)]
    low, high = out[("decode", 1, 1, 512)], out[("decode", 1, 8, 2048)]
    if cuda:
        _require(min(high) > max(low), f"decode point (8, 2048) {high} above "
                 f"(1, 512) {low}")
    print(f"[6 measure] self_attn, {oracle.__name__}, two measurements each: "
          + "; ".join(f"{ph} toks={t} reqs={r} ctx={c}: "
                      + ", ".join(f"{x * 1e6:.1f}" for x in xs) + " us"
                      for (ph, t, r, c), xs in out.items())
          + f"; {_card(device)}")
    return out


def phase_granite_serving(cfg, device) -> dict:
    """granite-20b at full width and depth serves the phase-4 requests
    through the decode kernel at a GQA group of 48: launches equal layers x
    decode iterations, every logit finite, one decode step on the final
    cache kernel vs plain (cosine >= 0.99 per row); then its self_attn
    decode point at (8 requests, ctx 2048), timed twice."""
    cuda = device.type == "cuda"
    run = _serve(cfg, device, runs=1)
    engine, requests, decode_iters = run["engine"], run["requests"], run["decode_iters"]
    launches, flash, flash_bwd, scan = run["counts"]
    expect = cfg.n_layers * decode_iters if cuda else 0
    _require(launches == expect,
             f"decode-kernel launches {launches} == {expect} (layers x decode iterations)")
    _require(flash == flash_bwd == scan == 0,
             f"no flash- or scan-kernel launch while serving ({flash}, "
             f"{flash_bwd}, {scan})")
    card = _card(device)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"[10 granite serving] {cfg.name}, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}, GQA "
          f"{cfg.n_heads}/{cfg.n_kv_heads} (G = {cfg.n_heads // cfg.n_kv_heads}), "
          f"no cut: {len(requests)} requests, {run['runs'][0]['iterations']} "
          f"iterations ({decode_iters} with decodes), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB, decode-kernel launches {launches}")
    _print_runs("10 granite serving", run, card)
    cos = _decode_vs_plain(engine, device)
    print(f"  decode step on the final cache, kernel vs plain: min cosine "
          f"{cos:.6f}")
    summary = _run_summary(run)
    del engine, run
    _release(device)
    oracle = cuda_events if cuda else cpu_wallclock
    reqs, ctx = GRANITE_POINT
    point = _decode_point(cfg, device, reqs, ctx,
                          torch.Generator(device=device).manual_seed(0), oracle)
    print(f"  self_attn decode point reqs={reqs} ctx={ctx}, {oracle.__name__}: "
          + ", ".join(f"{x * 1e6:.1f}" for x in point) + f" us; {card}")
    _release(device)
    return {"decode_launches": launches, "min_cosine": cos, "n_params": n_params,
            "point_s": point, **summary}


def _cosine_rows(a, b) -> torch.Tensor:
    return F.cosine_similarity(a.float(), b.float(), dim=-1)


def phase_mamba_serving(cfg, device) -> dict:
    """The Engine serves falcon-mamba through the scan kernel: exact-length
    chunks, one launch per layer for each chunk and each decode
    iteration."""
    cuda = device.type == "cuda"
    run = _serve(cfg, device)
    engine, requests, decode_iters = run["engine"], run["requests"], run["decode_iters"]
    decode, flash, flash_bwd, scan = run["counts"]
    chunks = sum(r.n_chunks for r in engine.records)
    expect = cfg.n_layers * (chunks + decode_iters) if cuda else 0
    _require(scan == expect, f"scan launches {scan} == {expect} (layers x "
             f"({chunks} prefill chunks + {decode_iters} decode iterations))")
    _require(decode == flash == flash_bwd == 0,
             f"no attention-kernel launch ({decode}, {flash}, {flash_bwd})")
    peak = run["peak"]
    card = _card(device)
    print(f"[7 mamba serving] {cfg.name}, {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in engine.model.parameters()) / 1e9:.3f} B "
          f"parameters, {cfg.dtype}: {len(requests)} requests, prompts "
          f"{sorted(run['lens'].tolist())}, served {len(run['runs'])} times, "
          f"{run['runs'][0]['iterations']} iterations ({chunks} exact-length "
          f"prefill chunks, {decode_iters} with decodes), peak memory "
          f"{peak / 2**30:.2f} GiB, scan launches {scan} a run; {card}")
    _print_runs("7 mamba serving", run, card)

    # one more decode step on copies of the final state, kernel vs plain
    lengths = torch.tensor(engine.lengths, dtype=torch.int32, device=device)
    toks = [1] * SCHED.max_num_seqs

    def state():
        return [{k: t.clone() for k, t in c.items()} for c in engine.cache]
    lk, _ = engine.model.decode_step(state(), toks, lengths, impl="kernel")
    lx, _ = engine.model.decode_step(state(), toks, lengths, impl="xla")
    cos = _cosine_rows(lk, lx)
    _require(bool((cos >= 0.99).all()),
             f"decode logits kernel vs plain cosine >= 0.99 (min {float(cos.min()):.5f})")
    print(f"  decode step on the final state, kernel vs plain: min cosine "
          f"{float(cos.min()):.6f}")
    out = {"scan_launches": scan, "chunks": chunks, **_run_summary(run),
           "min_cosine": float(cos.min())}
    del engine, run
    _release(device)
    return out


def _states_cosine(a, b) -> float:
    """The least cosine over layers between two caches' SSM states."""
    return min(float(_cosine_rows(x["h"].flatten(), y["h"].flatten()))
               for x, y in zip(a, b))


def _stepwise_scan(x, dt, A, Bc, Cc, D, h0=None):
    """The plain scan one step at a time, ``ref.selective_scan_step`` over
    t: the order in which the kernel sums."""
    h = h0 if h0 is not None else x.new_zeros(
        (x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32)
    ys = []
    for t in range(x.shape[1]):
        y, h = ref.selective_scan_step(x[:, t], dt[:, t], A, Bc[:, t], Cc[:, t],
                                       D, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


@torch.no_grad()
def _mamba_layers_vs_plain(model, tokens) -> tuple:
    """Each layer's mixer through the kernel and through the plain scan on
    the same input, the kernel path's own activation at that layer: the
    least cosine over layers and positions of the outputs, and over layers
    of the final SSM states."""
    cfg = model.cfg
    x = model.embed(torch.as_tensor(tokens, device=model.device).long())
    out_cos = h_cos = 1.0
    for layer in model.layers:
        h = layer.ln1(x)
        yk, (_, hk) = mamba_mod.mamba_mixer(layer.mamba, h, cfg,
                                            return_state=True, impl="kernel")
        yx, (_, hx) = mamba_mod.mamba_mixer(layer.mamba, h, cfg,
                                            return_state=True, impl="xla")
        out_cos = min(out_cos, float(_cosine_rows(yk[0], yx[0]).min()))
        h_cos = min(h_cos, float(_cosine_rows(hk.flatten(), hx.flatten())))
        x = x + yk
    return out_cos, h_cos


def phase_mamba_prefill(cfg, device) -> dict:
    """Model.prefill on a 1024-token prompt through the scan kernel (one
    launch per layer), in the model dtype, against the plain scan: layer by
    layer on the kernel path's activations (cosine >= 0.999), and end to
    end in float32 (cosine >= 0.99 for the last logits and every layer's
    state).  End to end in bf16 the two are printed, not held, beside the
    plain scan against itself taken one step at a time (the kernel's order
    of the sums): 64 random layers amplify bf16 rounding (1 ulp of some y
    entries) whichever order makes it."""
    def model_in(dtype):
        return Model(cfg, device=device, dtype=dtype,
                     generator=torch.Generator(device=device).manual_seed(0)
                     ).requires_grad_(False)
    model = model_in(None)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PREFILL_LEN))
    _zero_counts()
    t0 = time.perf_counter()
    lk, ck = model.prefill(tokens, max_seq=MAX_SEQ, impl="kernel")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    *attention, scan = _counts()
    expect = cfg.n_layers if device.type == "cuda" else 0
    _require(scan == expect and not any(attention),
             f"scan launches {scan} == {expect} (one per layer), attention "
             f"kernels {attention} none")
    _require(bool(torch.isfinite(lk).all()), "prefill logits are finite")
    lx, cx = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    cos, h_cos = float(_cosine_rows(lk, lx).min()), _states_cosine(ck, cx)
    plain = mamba_mod.selective_scan_chunked
    mamba_mod.selective_scan_chunked = _stepwise_scan
    try:
        lh, ch = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    finally:
        mamba_mod.selective_scan_chunked = plain
    order_cos, order_h_cos = float(_cosine_rows(lh, lx).min()), _states_cosine(ch, cx)
    layer_cos, layer_h_cos = _mamba_layers_vs_plain(model, tokens)
    _require(layer_cos >= 0.999 and layer_h_cos >= 0.999,
             f"every layer's mixer, kernel vs plain scan on the same input: "
             f"cosine >= 0.999 (outputs {layer_cos:.6f}, states {layer_h_cos:.6f})")
    del model, ck, cx, ch
    _release(device)

    model = model_in(torch.float32)
    lk32, ck32 = model.prefill(tokens, max_seq=MAX_SEQ, impl="kernel")
    lx32, cx32 = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    cos32, h_cos32 = float(_cosine_rows(lk32, lx32).min()), _states_cosine(ck32, cx32)
    _require(cos32 >= 0.99 and h_cos32 >= 0.99,
             f"float32 prefill kernel vs plain cosine >= 0.99: logits "
             f"{cos32:.6f}, SSM states (least over layers) {h_cos32:.6f}")
    print(f"[8 mamba prefill] {PREFILL_LEN} tokens in {wall:.4f} s ({cfg.dtype}, "
          f"first call, host clock), scan launches {scan}; kernel vs plain "
          f"scan, cosine: each layer on the same input, outputs "
          f"{layer_cos:.6f}, states {layer_h_cos:.6f}; end to end in float32, "
          f"last logits {cos32:.6f}, states {h_cos32:.6f}; end to end in "
          f"{cfg.dtype}, last logits {cos:.6f}, states {h_cos:.6f} (least over "
          f"layers), where the plain scan one step at a time against the "
          f"plain scan gives {order_cos:.6f} and {order_h_cos:.6f}")
    del model, ck32, cx32
    _release(device)
    return {"scan_launches": scan, "cosine": cos, "h_cosine": h_cos,
            "order_cosine": order_cos, "order_h_cosine": order_h_cos,
            "layer_cosine": layer_cos, "layer_h_cosine": layer_h_cos,
            "fp32_cosine": cos32, "fp32_h_cosine": h_cos32}


def phase_mamba_measure(cfg, device) -> dict:
    """The mamba context's points through the oracle, two timings each."""
    cuda = device.type == "cuda"
    oracle = cuda_events if cuda else cpu_wallclock
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for phase, points in (("prefill", MAMBA_PREFILL_POINTS),
                          ("decode", [(1, r) for r in MAMBA_DECODE_REQS])):
        mc = build_context(cfg, "mamba", phase=phase, backend="kernel",
                           device=device)
        mamba = mc.module(mc.materialize(mc.params, gen))
        for toks, reqs in points:
            # the state's size does not depend on the context length
            args = (mamba, *mc.materialize(mc.abstract_inputs(toks, reqs, 0), gen))
            out[(phase, toks, reqs)] = [oracle(mc.fn, args, device=device)
                                        if cuda else oracle(mc.fn, args)
                                        for _ in range(2)]
        del mamba
    low, high = out[("prefill", 256, 1)], out[("prefill", 1024, 1)]
    if cuda:
        _require(min(high) > max(low), f"prefill point (1024, 1) {high} above "
                 f"(256, 1) {low}")
    print(f"[9 mamba measure] mamba, {oracle.__name__}, two measurements each: "
          + "; ".join(f"{ph} toks={t} reqs={r}: "
                      + ", ".join(f"{x * 1e6:.1f}" for x in xs) + " us"
                      for (ph, t, r), xs in out.items())
          + f"; {_card(device)}")
    _release(device)
    return out


def phase_tracer(pairs, device) -> dict:
    """The tainted runner at full width: for each (cfg, smoke cfg), one
    trace of the forward on the meta device, then ``find_runnable_set``
    runs every op entry once on ``device``.  No op may fall back to its
    module's entry where the smoke config's runnable set, resolved on the
    CPU, has the same (module, op) as an op entry."""
    out = {}
    for cfg, smoke in pairs:
        t0 = time.perf_counter()
        mt = trace_model(cfg)
        traced = time.perf_counter() - t0
        t0 = time.perf_counter()
        entries = find_runnable_set(mt.trace, device=device)
        resolved = time.perf_counter() - t0
        ops = [e for e in entries if isinstance(e, OpEntry)]
        modules = [e for e in entries if isinstance(e, ModuleEntry)]
        cpu_ops = {(e.module, e.kind) for e in find_runnable_set(
            trace_model(smoke).trace, device="cpu") if isinstance(e, OpEntry)}
        fell_back = sorted({(e.module, op.name) for e in modules
                            if e.context_kind is None for op in e.ops}
                           & cpu_ops)
        _require(not fell_back, f"{cfg.name}: op entries that ran on the CPU "
                 f"fell back to module entries on {device}: {fell_back}")
        linear = sum(1 for e in ops if e.kind in ("mm", "addmm", "bmm"))
        kinds = {}
        for e in ops:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        print(f"[11 tracer] {cfg.name} at full width on the meta device: "
              f"{len(mt.trace.ops)} aten ops traced in {traced:.2f} s (dummy "
              f"prompt {mt.batch} x {mt.seq}, {mt.retraces} retraces); runnable "
              f"set {len(entries)} entries, every op entry run once on "
              f"{device.type} in {resolved:.2f} s: {len(ops)} op entries "
              f"({linear} linear, {len(ops) - linear} other: "
              + ", ".join(f"{k} {n}" for k, n in sorted(kinds.items()))
              + "), module entries "
              + ", ".join(f"{e.kind} x{e.count} at {e.module}" for e in modules))
        out[cfg.name] = {"ops": len(mt.trace.ops), "retraces": mt.retraces,
                         "trace_s": traced, "resolve_s": resolved,
                         "op_entries": len(ops), "linear": linear,
                         "modules": [(e.kind, e.count, e.module) for e in modules]}
        del mt, entries, ops, modules
        _release(device)
    return out


def _mapes(cmp: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in cmp.items())


def _card_state(device) -> str:
    """The card's SM clock, power draw and temperature, as nvidia-smi reads
    them now."""
    if device.type != "cuda":
        return "no card"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _decode_ms(records) -> float:
    """Median ms of a run's decode-only iterations."""
    return float(np.median([r.model_s for r in records if not r.n_chunks])) * 1e3


def _iteration_errors(sim, records) -> dict:
    """The engine's iterations against DoolySim's price of each, by kind
    (decode only, chunks only, chunks with decodes) and, for chunk-only
    iterations of one chunk, by bucket: count, median measured and
    predicted ms, MAPE and mean signed error (%)."""
    groups = {}
    for r in records:
        kind = ("decode" if not r.n_chunks else
                "chunks" if not r.n_decodes else "mixed")
        pred = (sim.overhead_s + sim.chunk_overhead_s * r.n_chunks
                + sim.predict_record(r))
        groups.setdefault(kind, []).append((r.model_s, pred))
        if kind == "chunks" and r.n_chunks == 1:
            groups.setdefault(f"chunk {bucket_chunk(r.chunks[0][0], SCHED.chunk_size)}",
                              []).append((r.model_s, pred))
    out = {}
    for kind, pairs in groups.items():
        real, pred = np.array(pairs).T
        err = (pred - real) / real * 100.0
        out[kind] = {"n": len(pairs), "ms": float(np.median(real)) * 1e3,
                     "pred_ms": float(np.median(pred)) * 1e3,
                     "mape": float(np.abs(err).mean()), "bias": float(err.mean())}
    return out


def phase_profile_simulate(cfgs, device, *, oracle: str, hardware: str,
                           sweep: SweepConfig, sched: SchedulerConfig,
                           max_seq: int, calibration: dict, score: dict,
                           shared_variant: str) -> dict:
    """Dooly's loop: plan and profile ``cfgs`` (the first is the served
    model), calibrate DoolySim on one engine run, then serve the score trace
    twice on the engine and predict it.  Kernel counts are zeroed just
    before the plan's execution and read after the last engine run."""
    cfg = cfgs[0]
    cuda = device.type == "cuda"
    fallbacks = fingerprint.fallbacks
    with ProfileStore(hardware=hardware, oracle=oracle, sweep=sweep,
                      device=device) as store:
        t0 = time.perf_counter()
        plan = store.plan(cfgs, backends=(PROFILE_BACKEND,))
        plan_s = time.perf_counter() - t0
        _require(fingerprint.fallbacks == fallbacks,
                 f"no fingerprint fell back ({fingerprint.fallbacks - fallbacks} "
                 f"did; the last with {fingerprint.last_error})")
        cov = plan.coverage()
        print(f"[12 profile->simulate] plan of {', '.join(c.name for c in cfgs)} "
              f"({PROFILE_BACKEND} backend, {oracle}, hardware {hardware}) built in "
              f"{plan_s:.1f} s: {len(plan.tasks)} tasks; {_card(device)}")
        print(cov.table())
        _zero_counts()
        t0 = time.perf_counter()
        rep = store.execute(plan, workers=1)
        exec_s = time.perf_counter() - t0
        rows = store.stats()["measurements"]
        _require(cov.plan_points == rep.rows_written == rows,
                 f"dry-run points {cov.plan_points} == rows written "
                 f"{rep.rows_written} == DB rows {rows}")
        shared = {e.sig_hash for _, entries in plan.entries for e in entries
                  if e.name == "self_attn" and e.variant == shared_variant}
        _require(len(shared) == 1, f"one {shared_variant} self_attn signature "
                 f"across the corpus ({len(shared)})")
        task = plan.task(shared.pop())
        _require(len(task.owners) == len(cfgs) and task.n_points == len(
            store.db.measurement_map(task.sig_hash, hardware)),
                 f"the {shared_variant} self_attn task is measured once and "
                 f"shared ({task.owners})")
        reports = [plan.legacy_report(store.db, key) for key in plan.models]
        print(f"  executed {rep.measured} tasks, {rep.rows_written} points in "
              f"{exec_s:.1f} s (wall); profiling GPU-seconds at "
              f"{sweep.repeats} repeats a point: "
              + "; ".join(f"{r.model} spent {r.spent_s:.4f} s, saved "
                          f"{r.saved_s:.4f} s ({r.n_new} new, {r.n_reused} "
                          f"reused)" for r in reports))
        sim = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                              backend=PROFILE_BACKEND)
        _require(not sim.latency.unprofiled_sigs(), "every call-graph signature "
                 f"has DB points ({sim.latency.unprofiled_sigs()})")
        engine = Engine(cfg, sched_config=sched, max_seq=max_seq,
                        impl=PROFILE_BACKEND, seed=0, device=device)
        calib = synthetic(calibration["n"], rate=calibration["rate"],
                          prompt_len=calibration["prompt_len"],
                          out_len=calibration["out_len"],
                          seed=calibration["seed"], vocab=cfg.vocab_size)
        engine.run(calib)
        fit = sim.calibrate(engine.records)
        drift = [(_decode_ms(engine.records), _card_state(device))]

        def trace():
            return sharegpt_like(score["n"], rate=score["rate"], seed=score["seed"],
                                 scale=score["scale"], vocab=cfg.vocab_size)
        longest = max(r.prompt_len + r.max_new_tokens for r in trace())
        _require(longest <= max_seq, f"every request fits max_seq ({longest} "
                 f"<= {max_seq})")
        real, iterations = [], []
        for _ in range(2):
            engine.reset()
            real.append(M.request_metrics(engine.run(trace())["requests"]))
            iterations.append((len(engine.records),
                               sum(1 for r in engine.records if not r.n_chunks)))
            drift.append((_decode_ms(engine.records), _card_state(device)))
            if len(real) == 1:
                by_kind = _iteration_errors(sim, engine.records)
        counts = _counts()
        noise = M.compare(real[1], real[0])
        sim_run = sim.run(trace())
        predicted = M.request_metrics(sim_run["requests"])
        cmp = M.compare(predicted, real[0])
        roof = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                               latency="roofline")
        roof_run = roof.run(trace())
        roof_cmp = M.compare(M.request_metrics(roof_run["requests"]), real[0])
    bad = [k for k, v in cmp.items() if not math.isfinite(v)]
    _require(not bad, f"finite MAPEs ({bad})")
    _require(cmp["makespan_mape"] <= MAKESPAN_MAPE_LIMIT,
             f"makespan MAPE {cmp['makespan_mape']:.2f} <= {MAKESPAN_MAPE_LIMIT}")
    if cuda:
        _require(counts[0] > 0, "the loop launched the decode kernel")
    print(f"  calibration on {calibration['n']} requests of "
          f"{calibration['prompt_len']} tokens: " + ", ".join(
              f"{k} {v:.6g}" for k, v in fit.items()))
    print(f"  score trace: ShareGPT-like, {score['n']} requests, rate "
          f"{score['rate']}/s, seed {score['seed']}, scale {score['scale']}; "
          f"engine makespans {real[0]['finish'][-1]:.4f}, "
          f"{real[1]['finish'][-1]:.4f} s over "
          + ", ".join(f"{n} iterations ({d} decode-only)" for n, d in iterations)
          + f"; DoolySim {predicted['finish'][-1]:.4f} s over "
          f"{len(sim_run['iterations'])} iterations; roofline "
          f"{roof_run['makespan']:.4f} s")
    print("  iterations of engine run 1 against DoolySim's price: " + "; ".join(
        f"{k} x{v['n']}: {v['ms']:.3f} ms measured, {v['pred_ms']:.3f} predicted "
        f"(median), MAPE {v['mape']:.2f} %, bias {v['bias']:+.2f} %"
        for k, v in by_kind.items()))
    ttft_bias = float(np.mean((predicted["ttft"] - real[0]["ttft"]) / real[0]["ttft"]))
    print(f"  TTFT mean signed error of DoolySim vs engine run 1: "
          f"{100 * ttft_bias:+.2f} %")
    print("  median decode-only iteration, calibration run and score runs 1 "
          "and 2, with the card's SM clock, power and temperature after each: "
          + "; ".join(f"{ms:.3f} ms ({state})" for ms, state in drift))
    print(f"  engine self-noise (run 2 vs run 1): {_mapes(noise)}")
    print(f"  DoolySim vs the engine: {_mapes(cmp)}; paper bars TTFT 5 %, "
          f"TPOT 8 %: " + ", ".join(
              f"{k} {'held' if cmp[k] <= bar else 'failed'}"
              for k, bar in PAPER_MAPE.items()))
    print(f"  roofline vs the engine: {_mapes(roof_cmp)}")
    print(f"  kernel launches (decode, flash fwd, flash bwd, scan) over the "
          f"execution and the engine runs: {counts}")
    return {"coverage": cov.to_json(), "plan_s": plan_s, "execute_s": exec_s,
            "rows": rows, "spent_s": [r.spent_s for r in reports],
            "saved_s": [r.saved_s for r in reports], "calibration": fit,
            "noise": noise, "sim": cmp, "roofline": roof_cmp,
            "roofline_makespan_s": roof_run["makespan"],
            "engine_makespans_s": [float(r["finish"][-1]) for r in real],
            "engine_iterations": iterations, "iteration_errors": by_kind,
            "decode_ms": [ms for ms, _ in drift],
            "ttft_bias": ttft_bias,
            "sim_iterations": len(sim_run["iterations"]),
            "decode_launches": counts[0], "flash_launches": counts[1]}


RESULT_TAG = "profile-simulate result: "


def profile_simulate_main() -> int:
    """Phase 12 on its own, as the parent script runs it in a fresh process;
    its result goes to the parent as one tagged JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = phase_profile_simulate(
        [get_config(n) for n in PROFILE_MODELS], device, oracle="cuda_events",
        hardware=default_hardware(), sweep=PROFILE_SWEEP,
        sched=SCHED, max_seq=MAX_SEQ, calibration=CALIBRATION, score=SCORE,
        shared_variant=SHARED_VARIANT)
    print(RESULT_TAG + json.dumps(out))
    return 0


def phase_profile_simulate_process() -> dict:
    """Runs phase 12 in a child process and returns its result."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--profile-simulate"], capture_output=True, text=True,
                         timeout=900)
    lines = run.stdout.splitlines()
    print("\n".join(line for line in lines if not line.startswith(RESULT_TAG)))
    if run.returncode != 0:
        print(run.stderr[-8000:], file=sys.stderr)
        raise RuntimeError(f"phase 12 failed with exit code {run.returncode}")
    tagged = [line for line in lines if line.startswith(RESULT_TAG)]
    _require(len(tagged) == 1, "phase 12 reported one result")
    return json.loads(tagged[0][len(RESULT_TAG):])


def kernels_line(kernels: dict, serving: dict, granite: dict, prefill: dict,
                 train: dict, mamba_serving: dict, mamba_prefill: dict,
                 loop: dict) -> dict:
    """Launches are counted on the main paths: decode while serving llama3
    (one run) and granite-20b and over phase 12's loop, the flash forward
    over the prefill, the train steps and the loop, the backward over the
    train steps, the scan while serving falcon-mamba (one run) and over its
    prefill."""
    launches = {"decode_attention": serving["decode_launches"]
                + granite["decode_launches"] + loop["decode_launches"],
                "flash_attention_fwd": prefill["flash_launches"]
                + train["flash_fwd_launches"] + loop["flash_launches"],
                "flash_attention_bwd": train["flash_bwd_launches"],
                "mamba_scan": mamba_serving["scan_launches"]
                + mamba_prefill["scan_launches"]}
    times = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": res["max_abs_err"], **{k: res.get(k) for k in times},
         "timed": {shape: {k: r.get(k) for k in times}
                   for shape, r in res.get("timed", {}).items()}}
        for name, res in kernels.items()]}
    print(json.dumps(line))
    return line


def _release(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--profile-simulate"]:
        return profile_simulate_main()
    cfg, mcfg = get_config("llama3-8b"), get_config(MAMBA)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    info = phase_device(cfg, device)
    phase_build(cfg, device)
    kernels = phase_kernels(cfg, device)
    kernels.update(phase_scan(mcfg, device))
    serving = phase_serving(cfg, device)
    prefill = phase_prefill(cfg, device)
    train = phase_train(cfg, device)
    phase_measure(cfg, device)
    mamba_serving = phase_mamba_serving(mcfg, device)
    mamba_prefill = phase_mamba_prefill(mcfg, device)
    phase_mamba_measure(mcfg, device)
    granite = phase_granite_serving(get_config(GRANITE), device)
    phase_tracer([(get_config(n), get_smoke_config(n)) for n in ("llama3-8b", GRANITE)],
                 device)
    _release(device)
    loop = phase_profile_simulate_process()
    print(f"[13] all phases passed in {time.perf_counter() - t0:.1f} s")
    kernels_line(kernels, serving, granite, prefill, train, mamba_serving,
                 mamba_prefill, loop)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": info["kind"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
