#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main paths for llama3-8b, falcon-mamba-7b,
granite-20b, minicpm3-4b (MLA), olmoe-1b-7b (MoE), hymba-1.5b (hybrid),
internvl2-26b and llama4-maverick-400b-a17b (stub frontends) and
seamless-m4t-large-v2 (enc-dec) at full width in bf16 (random weights from
seed 0), and lays the ten assigned architectures out on the production
meshes (the dry run), and checks them, one line per phase:

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
             again; the fp32 cases include groups of 48 and 40.  Decode
             is also timed at olmoe-1b-7b's G = 1 (KV 16, D 128) and
             hymba-1.5b's G = 5 (KV 5, D 64), the flash forward at
             hymba's 25/5 heads, D 64, window 1024 (S 1024, where the
             window cuts no key, so SDPA computes the same function).
             Phase 15's shapes: decode at internvl2-26b's G = 6 and
             llama4-maverick's G = 5 (KV 8, D 128) and seamless-m4t's
             decoder G = 1 (KV 16, D 64); the flash forward non-causal at
             seamless's encoder (B 8, S 4096, 16/16 heads, D 64), its
             cross-attention prefill (Sq 128 against 4096 keys) and decode
             (Sq 1 against 4096), causal at internvl2's and llama4's
             prefill (S 768, 48/8 and 40/8 heads, D 128); and untimed at
             an empty memory (Sk 0: zeros), in fp32 and bf16.
3b. scan   — the selective-scan kernel against its plain version: the
             kernel-test cases in fp32 with h0 (5e-5) and falcon-mamba's
             shapes in bf16 (2e-2; prefill B=1 at S=256 and 1024, decode
             B=8 at S=1 with h0), y and the final state both; times and
             device times beside the least time the card could take (bytes
             at 3.35 TB/s, fp32 flops at 67 TFLOP/s, one exp per state
             entry and step at 16 per clock per SM); no single PyTorch call
             computes a selective scan, so it has no library yardstick;
             also at hymba-1.5b's Di = 3200 (prefill S=1024, decode B=8).
4. serving — the Engine serves 8 requests (prompts of 128-1024 tokens, 32
             new tokens each) through the decode kernel, twice, replaying a
             CUDA graph per step (each captured at warm-up, before any
             clock; every serving phase prints its engine's warm-up seconds
             and the graphs captured after it); decode-kernel
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
             width, in a fresh process: a plan over both models with a sweep
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
             makespan.  The engine's warm-up seconds, graphs and peak
             memory are printed; it then settles (Engine.settle: decode
             replays until the decode graph alone has fallen 5 % or more,
             from the slow state to the fast one, and holds within 1 %, at
             most 30 s; on the H100 captures leave every graph kernel about
             0.35 us slower until sustained graph work), and prints whether
             it settled; the decode graph alone (behind a busy kernel) is
             read after the settle and after each run, beside each run's
             median decode-only iteration, and the summary marks whether
             the three runs shared one state of the card (within 1 %);
             each run must capture no graph after warm-up (the sweep's
             engine below too).  It fails on a
             MAPE that is not finite, a DB point missing, or a makespan
             MAPE above 25 %.  Then the same child
             sweeps llama3-8b at full width on that DB (Sweep, uncalibrated,
             as the reference prices a grid: max_num_seqs {4, 8} x
             max_batch_tokens {256, 512}, chunks of 256, on the score
             trace), the engine serves the (4, 256, 256) scenario once, and
             the sweep's DoolySim, bare and with phase 12's calibration
             terms, is scored against it by TTFT, TPOT and makespan MAPE
             beside the paper's bars; it fails on a failed scenario or a
             MAPE that is not finite.  Then olmoe-1b-7b is planned, as a
             user adds a model to a DB filled earlier in the same process
             (no fingerprint may fall back), profiled into the same DB,
             calibrated and scored the same way: its TTFT, TPOT and
             makespan MAPE beside the paper's bars.  For both scored models
             each request's TTFT is split into the wait before the
             iteration that admits it and the iterations that carry its
             chunks, each part's error printed over the requests whose
             admission kept or moved, beside the admitting iterations'
             price by bucket.  For both, ``[12 mixed]`` then runs each
             iteration shape (a chunk of 64, 128 or 256 tokens after 256
             cached tokens, its prompt's last or not, beside the decode
             batch or alone) 20 times on the same engine and prints (a)
             execute's host clock, (b) CUDA events over its graphs, (c)
             each graph alone, (d) the DB's raw points, (e) DoolySim's
             price in its terms, and the differences e-d, d-c, b-c and
             a-b, which sum to DoolySim's error on (a); then the score
             trace priced on the raw points (the oracle backend) under the
             same calibration.  Last, the llama3-8b + command-r7b plan is
             built again: the same plan id, nothing left to measure.
13. cli     — Dooly's configuration-search surface through its command
             lines, each step a fresh process that runs the CLI module as
             ``python -m repro_torch.<cli>`` does (launched through this
             script, which reports the process's kernel launches), files
             under build/chip/cli: ``profile plan --full`` of llama3-8b and
             command-r7b (kernel backend, quick sweep; the dry run), ``run
             --shards 2`` for each shard into its own scratch DB, ``merge``
             (must report "exact, all shards merged"), ``run --resume`` on
             the merged DB (must measure 0) and ``audit`` (must exit 0); the
             merged rows must equal the dry run's points and the GQA
             32/8/128 self_attn signature must be shared by both models and
             measured by one shard only; the points the shards measured
             and phase 12 measured too (a third process, its DB under
             build/chip) must agree, by a median relative difference of at
             most 10 %; each process's wall and execute seconds and the
             profiling GPU-seconds spent and saved (the plan's accounting,
             at the sweep's 100 repeats a point) are printed.  Then
             ``sweep --eval-workers 2`` on that DB (32 scenarios over the
             two smoke configs, which it profiles on the card first: failed
             0, workers 2), the same with
             ``--compare-latency oracle`` (its corpus-wide errors printed)
             and ``optimize`` at its defaults (a recommendation, no failed
             scenario).
14. families — minicpm3-4b (MLA, 62 layers), olmoe-1b-7b (MoE, 64
             experts top-8) and hymba-1.5b (hybrid: GQA 25/5/64 with window
             1024 beside Mamba heads of Di 3200), each at full width and
             depth, released before the next (``[14 mla]``, ``[14 moe]``,
             ``[14 hybrid]``): the Engine serves the phase-4 requests twice
             from CUDA graphs, with the kernel launches each family must
             make (decode per GQA layer and decode iteration, the scan per
             mixer and chunk or decode iteration; MLA and MoE none of their
             own), both makespans, their ratio, the median decode iteration
             and the idle share; a graph-replayed decode step against the
             eager path (cosine >= 0.9999); the ``mla_attn``, ``moe``, or
             ``self_attn`` (window 1024) and ``mamba`` context points, two
             timings each by cuda_events; for hymba a 1024-token
             Model.prefill through the flash forward and the scan (float32
             logits against the plain path, cosine >= 0.99).  ``[14 plan]``
             (``phase_family_plan``: llama3-8b, command-r7b and the three
             profiled in one CLI process on a copy of phase 13's merged DB,
             its tasks, dedup and GPU-seconds) runs in the CPU tests; the
             whole script leaves it to ``[15 plan]``, which profiles these
             five models among the twelve in the same CLI on a copy of the
             same DB.
15. enc-dec and frontends — ``[15 vlm]``: internvl2-26b at full width and
             depth (48 layers, GQA 48/8/128) and ``[15 llama4]``:
             llama4-maverick-400b-a17b at full width with its depth cut to
             2 layers (one dense, one MoE: 128 experts top-1 and a shared
             expert; printed as ``reduced``), each served text-only as
             phase 14 serves (twice from graphs, the decode kernel once per
             layer and decode iteration, graph-replayed decode against
             eager cosine >= 0.9999), beside its weight-read bound per
             decode step; Model.prefill of 2 requests of 256 frames and 512
             tokens through the flash forward (once per layer) against the
             ``chunked`` backend (cosine >= 0.999); its ``self_attn`` (and
             llama4's ``moe``) context points, two timings each; peak
             memory printed at each step.  ``[15 encdec]``:
             seamless-m4t-large-v2 at full width and depth (24 encoder + 24
             decoder layers), which the engine refuses as the reference's
             does: Model.prefill of 8 requests of 4096 frames and 128
             tokens (the flash forward once per encoder layer and twice per
             decoder layer), then 32 decode steps (the decode kernel and the
             flash forward at Sq = 1 once per decoder layer each), all
             against the ``chunked`` backend (cosine >= 0.999): the encoder,
             prefill and median decode-step times beside the decode step's
             bound; the ``cross_attn`` context points (prefill toks {64,
             256} x reqs {1, 8} x ctx {0, 1024, 4096}, decode reqs {1, 8} x
             ctx {1024, 4096}), two timings each.  ``[15 plan]``: the
             twelve corpus models at full width in one CLI process (quick
             sweep, ``kernel`` and ``chunked`` backends) on a copy of phase
             13's merged DB: per-model Table-2 rows, the task dedup beside
             the reference's 83.7 % (smoke, dry run) and the paper's 56.4 %,
             the GPU-seconds spent and saved.
16. parallel and launch — ``[16 dryrun]``: ``python -m
             repro_torch.launch.dryrun`` in child processes started first
             and run beside the rest of the phase: llama3-8b at the four
             assigned shapes on both production meshes, every other
             assigned architecture at decode_32k on the single-pod mesh, all
             at full configs on meta over fake 256/512-rank process groups;
             every cell's line and each child's wall seconds; every
             llama3-8b cell must be ok (long_500k: the reference's skip).
             ``[16 mesh]`` (a child process over a one-rank NCCL group,
             ``python3 chip_smoke.py --mesh-serving``): llama3-8b at full
             width serves the phase-4 requests from graphs outside and
             inside ``use_mesh(make_host_mesh(), SERVE_RULES)``, and
             prefills 1024 tokens each way: equal tokens, logits and kernel
             launches; the dry run's per-device parameter bytes on the host
             mesh equal the bytes the card holds.  ``[16 comm]`` and
             ``[16 roofline]``: ``profile_comm`` into a copy of phase 12's
             DB and the roofline backend's makespans of phase 12's score
             trace at tp 1, 2, 4 and 8, a model on NVLink's data-sheet
             figure.  The phase is held to 180 s.
17. train families — ``[17 hybrid]``: hymba-1.5b at full width and depth
             (32 layers, bf16) takes 2 AdamW steps, then 2 Adafactor steps
             on a fresh model and state, each of 4 microbatches of 1 x 2048
             tokens with remat, through the flash forward and backward at
             window 1024 and the plain chunked scan (the scan kernel has no
             backward, nor has the reference's): every loss and grad norm
             finite, 2 x 32 x 4 forward and 32 x 4 backward launches a
             step, no scan launch; one microbatch's bf16 gradients through
             the kernels are held against a float32 copy of the same
             weights: every parameter tensor's relative L2 error within 2x
             that of the plain attention's bf16 gradients (+ 1e-5), as
             FlashAttention's tests hold a kernel (random 32-layer hybrid
             gradients in bf16 lie ~40 % from float32 by any attention, so
             the kernel-vs-plain cosine is printed); step time,
             tokens/s, the share of the bf16 peak and peak memory; then
             the Adafactor state is saved by
             ``AsyncCheckpointer`` under build/chip/phase17, restored into a
             fresh model, and one more step from each gives the same loss
             bit for bit (bytes and seconds printed; the checkpoint is
             deleted).  ``[17 dense]``: yi-9b at full width and depth (48
             layers, 8.8 B parameters) under Adafactor on the reference's
             stacked leaves, 3 steps of 4 x 1024 tokens in one microbatch,
             the same checks but the checkpoint, except that its gradients
             are held to cosine >= 0.99 against the plain attention's (a
             float32 copy, 70 GB with its gradients, would not fit beside
             it), peak memory beside the card's.  ``[17 examples]``: ``examples/torch_quickstart.py``,
             ``torch_serve_demo.py``, ``torch_trace_sweep_demo.py`` and
             ``torch_train_demo.py --steps 30`` as child processes on the
             card, side by side: each exits 0 and prints its summary
             lines.  The phase is held to 240 s.  Phase 3 also holds and
             times the flash forward and backward at the two train shapes
             (hymba's B 1, S 2048, 25/5 heads, D 64, window 1024, where
             the window cuts keys, against SDPA with a boolean window mask;
             yi-9b's B 4, S 1024, 32/4 heads, D 128, causal).
18. pool    — ``[18 pool]``: ``profile run --workers 2`` over phase 13's
             corpus in one CLI process, its two spawn workers taking turns
             on the card (each task's measurement holds it); the card shim
             ``card_shim`` in the workers logs each task's seconds on the
             card, kernel launches and the SM clock read after it.  Its
             rows are the dry run's points, the report says workers 2 and
             nothing failed, every signature it measured is one phase 12's
             DB holds, and its points agree with phase 12's DB (median
             relative difference <= 10 %), printed beside phase 13's serial
             shards' with both runs' wall and executing seconds and each
             worker's medians by op kind and by turn, and no two workers'
             measurements overlap on the card.  ``[18 faults]``: llama3-8b's plan at
             full width in two runs side by side: ``profile run --workers 2
             --task-timeout T`` (T three times 18a's longest task) through
             the shim's faults — a crash, a hang and a device-side assert
             that leaves the worker's CUDA context unusable, once each, an
             allocation of twice the card's memory and NaN rows on every
             attempt — and ``--kill-run`` of the same plan, SIGKILLed
             after 6 commits, then resumed by ``profile run``.  The one-shot faults heal, exactly
             the OOM and garbage tasks are quarantined, no healthy task
             times out, the poisoned worker leaves once, a worker measures
             on after its OOM, the healthy points agree with phase 12's
             (median <= 10 %), the resume measures exactly the tasks the
             killed run left, no two processes' measurements overlap on
             the card, and the decode kernel ran in the workers (a
             prefill ``self_attn`` point runs the materialized chunk-against-
             cache attention, as the reference's does, not the flash
             kernel).  Files under build/chip/pool/.
A JSON line then lists every kernel with its launches on the main paths,
its largest error against its plain version, and its times.
``python3 chip_smoke.py --profile-simulate`` runs phase 12 alone,
``python3 chip_smoke.py --cli MODULE ARGS...`` runs one CLI step of phase 13,
``python3 chip_smoke.py --mesh-serving`` runs phase 16's mesh serving,
``python3 chip_smoke.py --phase18`` runs phases 1, 2, 12, 13 and 18,
``python3 chip_smoke.py --kill-run ARGS --kill-after N`` runs phase 18's
killed ``profile run ARGS``,
and ``python3 chip_smoke.py --phase15`` runs phases 1-3 and 15 (its plan on
the merged DB that phase 13 of a whole run left in build/; it exits 1
without one).

The last line is {"ok": true, "device": {...}}.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits 1 at once.  Each
phase is a function of (cfg, device), so the tests run them on the CPU at a
smoke configuration, where the kernel wrappers take their plain versions.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import math
import os
import re
import runpy
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.api import (ProfileStore, SchedSpec,  # noqa: E402
                              WorkloadSpec, expand_grid)
from repro_torch.configs import (ASSIGNED_ARCHS, CORPUS_ARCHS,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.core.profiler import QUICK_SWEEP, SweepConfig  # noqa: E402
from repro_torch.core.signature import LINEAR_OPS, fingerprint  # noqa: E402
from repro_torch.parallel.roofline import default_hardware  # noqa: E402
from repro_torch.core.opset import (ModuleEntry, OpEntry,  # noqa: E402
                                    find_runnable_set)
from repro_torch.core.runner import trace_model  # noqa: E402
from repro_torch.core.backends import (BUSY_CYCLES, cpu_wallclock,  # noqa: E402
                                       cuda_events, launch_floor)
from repro_torch.core.device import synchronize  # noqa: E402
from repro_torch.core.database import LatencyDB  # noqa: E402
from repro_torch.core.journal import read_journal_state  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.serving import (Engine, Request, SchedulerConfig,  # noqa: E402
                                 bucket_chunk, build_context, phases_for)
from repro_torch.serving.engine import SETTLED, mark, span_s  # noqa: E402
from repro_torch.serving.scheduler import IterationPlan, PrefillChunk  # noqa: E402
from repro_torch.sim import metrics as M  # noqa: E402
from repro_torch.train import (DataConfig, TokenStream,  # noqa: E402
                               init_train_state, make_optimizer, make_train_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
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
                (2, 48, 1, 256, 64, 0), (3, 80, 2, 128, 32, 0),
                # the decode points phase 13's sweep CLI profiles on the two
                # smoke configs: reqs {1, 2} x ctx {64, 128}, 4/2/32, fp32
                (1, 4, 2, 64, 32, 0), (2, 4, 2, 64, 32, 0),
                (1, 4, 2, 128, 32, 0), (2, 4, 2, 128, 32, 0)]
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
#: phase 17: (microbatches, rows a microbatch, tokens a row, steps) of the
#: hybrid (under AdamW, then Adafactor) and of the dense model (Adafactor);
#: two hybrid steps an optimizer (≈ 13 s each) keep the script in its time
TRAIN_HYBRID, TRAIN_DENSE = "hymba-1.5b", "yi-9b"
HYBRID_RUN, DENSE_RUN = (4, 1, 2048, 2), (1, 4, 1024, 3)
PHASE17_LIMIT_S = 240.0
#: how much larger than the plain attention's a gradient's relative error
#: to float32 may be through the kernels (FlashAttention's tests allow 2),
#: and the error below which two paths are not told apart (float32's
#: rounding over a product's terms; the plain path's own in a float32 model)
GRAD_ERR_MARGIN, GRAD_ERR_FLOOR = 2.0, 1e-5
PHASE17_DIR = Path(__file__).resolve().parent / "build" / "chip" / "phase17"
#: the example counterparts phase 17 runs on the card: (script, arguments,
#: lines its summary must print)
EXAMPLES = [("torch_quickstart.py", [], ["traced yi-smoke: ", "runnable set: ",
                                          "profiled on ", "db: "]),
            ("torch_serve_demo.py", [], ["yi-smoke (kernel, cuda", "  ttft: p50=",
                                          "  tpot: p50="]),
            ("torch_trace_sweep_demo.py", [],
             ["profiled llama3-8b on ", "trace under load warps and shapes:",
              "TTFT strictly improves"]),
            ("torch_train_demo.py", ["--steps", "30"],
             ["step    0 loss=", "final loss=", "restored checkpoint @ step 30",
              "resumed loss="])]
MAMBA = "falcon-mamba-7b"
GRANITE = "granite-20b"
GRANITE_POINT = (8, 2048)                                      # (reqs, ctx)
MAMBA_PREFILL_POINTS = [(256, 1), (1024, 1)]                   # (toks, reqs)
MAMBA_DECODE_REQS = (1, 8)
#: phase 14: the MLA, MoE and hybrid families at full width and depth; the
#: context points (prefill toks x reqs, decode reqs x ctx), the plan of five
#: models at the CLI's quick sweep, against a copy of phase 13's merged DB
MLA, MOE, HYBRID = "minicpm3-4b", "olmoe-1b-7b", "hymba-1.5b"
FAMILY_PREFILL_TOKS = {"mla_attn": (64, 256), "moe": (8, 64, 256),
                       "self_attn": (64, 256), "mamba": (64, 256)}
FAMILY_REQS, FAMILY_CTX = (1, 8), (512, 2048)
PLAN_MODELS = ("llama3-8b", "command-r7b", MLA, MOE, HYBRID)
#: phase 15: the stub frontends and the enc-dec model; llama4's depth cut
#: (one dense and one MoE layer of its 48: the whole model is about 800 GB
#: in bf16); the frontend prefill (requests, tokens after the frames); the
#: enc-dec run (requests, prompt tokens, decode steps; frames are the
#: config's n_frontend_tokens); the cross_attn context points; the corpus
VLM, LLAMA4, SEAMLESS = ("internvl2-26b", "llama4-maverick-400b-a17b",
                         "seamless-m4t-large-v2")
LLAMA4_LAYERS = 2
FRONT_PREFILL = (2, 512)
ENCDEC_RUN = (8, 128, 32)
CROSS_PREFILL_TOKS, CROSS_REQS = (64, 256), (1, 8)
CROSS_PREFILL_CTX, CROSS_DECODE_CTX = (0, 1024, 4096), (1024, 4096)
CORPUS_BACKENDS = ("kernel", "chunked")
#: the reference's corpus task dedup (12 smoke models x 2 backends, dry run;
#: CHANGES.md) and the paper's profiling GPU-hours saved (Table 2)
REFERENCE_DEDUP, PAPER_SAVED = 0.837, 0.564
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
#: ``[12 mixed]``: one chunk of each bucket after ``start`` cached tokens,
#: the other rows ``decode_len`` tokens in, each iteration shape ``repeats``
#: times
MIXED = dict(buckets=(64, 128, 256), start=256, decode_len=384, repeats=20)
SCORE = dict(n=32, rate=4.0, seed=4, scale=0.25)
SHARED_VARIANT = "32/8/128"          # the GQA geometry llama3 shares
MAKESPAN_MAPE_LIMIT = 25.0
PAPER_MAPE = {"ttft_mape": 5.0, "tpot_mape": 8.0}
#: phase 12's sweep: scheduler specs inside the points its profile brackets
#: (decode batches <= 8, chunks <= 256), and the one the engine serves
SCORING = dict(seqs=(4, 8), tokens=(256, 512), chunk=256, served=(4, 256, 256))
#: phase 13: the CLI steps' files, and the tag of a step's kernel launches
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip" / "cli"
LAUNCHES_TAG = "cli kernel launches: "
#: phase 12's DB, against which phase 13 holds the points its CLI processes
#: measure, and the most their median relative difference may be
PHASE12_DB = CLI_DIR.parent / "phase12.sqlite"
PHASE15_DB = CLI_DIR.parent / "phase15.sqlite"
AGREE_LIMIT = 0.10
#: phase 16: the dry run's cells, as groups of (arch, shape or None for
#: every shape, mesh) run one after the other in one child process per
#: group, the groups side by side: llama3-8b at every shape on both meshes,
#: every other assigned architecture at decode_32k on the single-pod mesh
#: (three or two a group: each cell is a process of its own, ~20 s of it
#: start-up, and the longest group sets the phase's time)
DRYRUN_MAIN = "llama3-8b"
DRYRUN_GROUPS = [[(DRYRUN_MAIN, None, "both")]] + [
    [(a, "decode_32k", "single") for a in ASSIGNED_ARCHS[i:j]]
    for i, j in ((0, 3), (3, 6), (6, 8), (8, 10))]
DRYRUN_LEFT_OUT = ("every other architecture's train_4k, prefill_32k and "
                   "long_500k, and its decode_32k on the multi-pod mesh")
PHASE16_LIMIT_S = 180.0
PHASE16_DB = CLI_DIR.parent / "phase16.sqlite"
COMM_TP, COMM_TP_OPS = (1, 2, 4, 8), "(all-reduce, all-gather, reduce-scatter)"

#: phase 18: the pooled run's files and workers; the card shim (in the
#: workers), its faults (mode -> the op whose one task in llama3-8b's plan it
#: hits) and those that fire once (the others on every attempt), the
#: retries, the commits after which the kill run dies, and the task deadline:
#: a multiple of 18a's longest task, at least POOL_TIMEOUT_MIN_S
POOL_DIR = CLI_DIR.parent / "pool"
POOL_WORKERS, POOL_RETRIES = 2, 2
SHIM = "chip_smoke:card_shim"
POOL_FAULTS = {"crash": "pow", "hang": "rsqrt", "poison": "silu", "oom": "mean",
               "garbage": "index"}
ONE_SHOT = ("crash", "hang", "poison")
FAULT_MODEL = "llama3-8b"
KILL_AFTER = 6
POOL_TIMEOUT_PER_LONGEST, POOL_TIMEOUT_MIN_S = 3.0, 10.0
PLAN_TAG = "kill-run plan: "
#: the error an allocation beyond the device's memory raises, by device
OOM_REASON = {"cuda": "OutOfMemoryError", "cpu": "can't allocate memory"}
#: what a card worker says on its way out when a task left its CUDA
#: context unusable (``repro_torch.core.plan._plan_worker_run``)
UNUSABLE = "the CUDA context is unusable, the worker exits"

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


def _device_ms(fn, device, name: str = "", reps: int = 10):
    """Mean device time of one call's kernels whose name holds ``name`` (all
    of its device activity, kernels, copies and fills, without a name) by
    torch.profiler, calls back to back with the L2 cache warm: the card's own
    time, without the host's launch path and the cold cache that
    ``_time_ms`` includes.  None off the card, or where three sessions saw
    no device time."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    # a profiler session can come back without device events (as the
    # fingerprints' can, core/signature.py): take another
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                 if (name in e.key if name else e.device_type == DeviceType.CUDA))
        if us > 0:
            return us / reps / 1e3
    return None


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
        res["library_device_ms"] = _device_ms(
            lambda: _sdpa(qh, kh, vh, attn_mask=mask), device)
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
        mask = _sdpa_masks(sq, sk, causal, window, device)
        res["library_ms"] = _time_ms(lambda: _sdpa(qh, kh, vh, **mask), device)
        res["library_device_ms"] = _device_ms(lambda: _sdpa(qh, kh, vh, **mask),
                                              device)
    return res


def _sdpa_masks(sq: int, sk: int, causal: bool, window: int, device) -> dict:
    """SDPA's arguments for the kernel's masks: ``is_causal``, or where the
    window cuts keys a boolean mask of the pairs left (SDPA has no window
    of its own), so that the yardstick computes the same function."""
    if not window or window >= sk:
        return {"is_causal": causal}
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return {"attn_mask": mask}


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
        o = _sdpa(*leaves, **_sdpa_masks(sq, sk, causal, window, device))
        doh = do.transpose(1, 2)
        res["library_ms"] = _time_ms(lambda: torch.autograd.grad(
            o, leaves, doh, retain_graph=True), device)
        res["library_device_ms"] = _device_ms(lambda: torch.autograd.grad(
            o, leaves, doh, retain_graph=True), device)
    return res


def phase_kernels(cfg, device, gqa_cfg=None, family_cfgs=(),
                  flash_shapes=(), train_shapes=()) -> dict:
    """Each kernel against its plain version; returns, per kernel, the
    largest error over all cases and the main path's times.  Decode attention
    is also timed at ``gqa_cfg``'s serving shape (default granite-20b: a GQA
    group of 48, run as two slices of the group) and at the serving shape
    of each attention config of ``family_cfgs``; the flash forward also at
    the prefill shape of each of them with a sliding window, and at each of
    ``flash_shapes`` (``frontend_flash_shapes``); the flash forward and
    backward at each of ``train_shapes`` (``train_flash_shapes``)."""
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
    main["flash_attention_fwd"]["timed"] = {}
    for fc in family_cfgs:
        if fc.attn_type != "gqa":
            continue
        fkv, fd = fc.n_kv_heads, fc.resolved_head_dim
        fg = fc.n_heads // fkv
        res = _decode_case(rng, b, fkv, fg, MAX_SEQ, fd, 0, bf16, device, True)
        errs["decode_attention"].append(res)
        main["decode_attention"]["timed"][
            f"{fc.name} B={b} G={fg} D={fd} random lengths"] = res
        if fc.sliding_window:
            main["flash_attention_fwd"]["timed"].setdefault(
                f"B=1 S={PREFILL_LEN} {cfg.n_heads}/{kv} heads D={hd}",
                dict(main["flash_attention_fwd"]))
            res = _flash_case(rng, 1, PREFILL_LEN, PREFILL_LEN, fc.n_heads, fkv,
                              fd, True, fc.sliding_window, bf16, device, True)
            errs["flash_attention_fwd"].append(res)
            main["flash_attention_fwd"]["timed"][
                f"{fc.name} B=1 S={PREFILL_LEN} {fc.n_heads}/{fkv} heads D={fd} "
                f"window {fc.sliding_window}"] = res
    for label, fb, sq, sk, fh, fkv, fd, causal in flash_shapes:
        main["flash_attention_fwd"]["timed"].setdefault(
            f"B=1 S={PREFILL_LEN} {cfg.n_heads}/{kv} heads D={hd}",
            dict(main["flash_attention_fwd"]))
        res = _flash_case(rng, fb, sq, sk, fh, fkv, fd, causal, 0, bf16, device,
                          True)
        errs["flash_attention_fwd"].append(res)
        main["flash_attention_fwd"]["timed"][label] = res
    main["flash_attention_bwd"]["timed"] = {}
    for label, tb, ts, th, tkv, td, twin in train_shapes:
        for name, case in (("flash_attention_fwd", _flash_case),
                           ("flash_attention_bwd", _flash_bwd_case)):
            timed = main[name]["timed"]
            timed.setdefault(f"B=1 S={PREFILL_LEN} {cfg.n_heads}/{kv} heads D={hd}"
                             if name == "flash_attention_fwd" else
                             f"B={TRAIN_BATCH // MICROBATCHES} S={TRAIN_SEQ} "
                             f"{cfg.n_heads}/{kv} heads D={hd}",
                             {k: v for k, v in main[name].items() if k != "timed"})
            res = case(rng, tb, ts, ts, th, tkv, td, True, twin, bf16, device,
                       True)
            errs[name].append(res)
            timed[label] = res
    errs["flash_attention_fwd"].append(_flash_case(
        rng, 1, PREFILL_LEN, PREFILL_LEN, cfg.n_heads, kv, hd, True, WINDOW,
        bf16, device, False))
    # an empty memory (a cross_attn point at ctx 0): zero key tiles, zeros
    for dtype in (torch.float32, bf16):
        errs["flash_attention_fwd"].append(_flash_case(
            rng, 2, 33, 0, 4, 2, 64, False, 0, dtype, device, False))
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
              f"library {res['library_ms']:.4f} ms{_dev(res, 'library_')}, bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']}); {card}")
        for shape, r in res.get("timed", {}).items():
            reread = (f"; slices re-read {r['reread_bytes'] / 2**20:.1f} MiB of "
                      "K/V (from L2 when they run side by side)"
                      if r.get("reread_bytes") else "")
            library = ("none" if r["library_ms"] is None else
                       f"{r['library_ms']:.4f} ms{_dev(r, 'library_')}")
            print(f"  {shape}: kernel {r['ms']:.4f} ms{_dev(r)}, plain "
                  f"{r['plain_ms']:.4f} ms, library {library}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}){reread}")
    return main


def train_flash_shapes(hybrid, dense, hybrid_run=HYBRID_RUN,
                       dense_run=DENSE_RUN) -> list:
    """Phase 17's flash shapes, (label, B, S, H, KV, D, window): a
    microbatch of the hybrid's windowed layers and of the dense model."""
    out = []
    for c, (_, rows, seq, _) in ((hybrid, hybrid_run), (dense, dense_run)):
        win = c.sliding_window if 0 < c.sliding_window < seq else 0
        out.append((f"{c.name} train B={rows} S={seq} {c.n_heads}/{c.n_kv_heads}"
                    f" heads D={c.resolved_head_dim}"
                    + (f" window {win}" if win else " causal"),
                    rows, seq, c.n_heads, c.n_kv_heads, c.resolved_head_dim, win))
    return out


def _dev(res, prefix: str = "") -> str:
    """The profiler's device time of the kernel (or, with ``prefix``
    "library_", of the library call), where the card gave one."""
    ms = res.get(f"{prefix}device_ms")
    return f" (device {ms:.4f} ms)" if ms is not None else ""


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


def phase_scan(cfg, device, family_cfgs=()) -> dict:
    """The scan kernel against its plain version (``cfg``: the Mamba
    model; ``family_cfgs``: more configs with SSM state, timed at their own
    width); returns ``{"mamba_scan": ...}`` with the largest error over all
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
    for fc in family_cfgs:
        fdi, fn, fr = fc.ssm_d_inner, fc.ssm_state, fc.resolved_dt_rank
        timed[f"{fc.name} prefill B=1 S={PREFILL_LEN} Di={fdi}"] = _scan_case(
            rng, 1, PREFILL_LEN, fdi, fn, bf16, device, h0=False, timed=True,
            dt_rank=fr)
        timed[f"{fc.name} decode B={SCHED.max_num_seqs} S=1 Di={fdi}"] = _scan_case(
            rng, SCHED.max_num_seqs, 1, fdi, fn, bf16, device, h0=True,
            timed=True, dt_rank=fr)
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
    plan = IterationPlan([], list(requests))
    engine.execute(plan)
    plain_wall = engine.execute(plan)
    wall, busy_s, n, top = _profile_busy(lambda: engine.execute(plan))
    return {"wall_s": wall, "plain_wall_s": plain_wall, "busy_s": busy_s,
            "kernels": n, "idle_share": 1.0 - busy_s / wall,
            "idle_share_unprofiled": 1.0 - busy_s / plain_wall, "top": top}


def _profile_busy(fn) -> tuple:
    """``fn()`` under torch.profiler: (its return value, the union of its
    kernels' device intervals in s, their number, the five kernels that
    take most of the busy time with their ms)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    _require(bool(kernels), "the profiler saw the call's kernels")
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
    return out, busy * 1e-6, len(kernels), [(name[:60], us * 1e-3)
                                            for name, us in top]


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
            "decode_ms": _decode_ms(engine.records),
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
               graphs=len(engine.graphs), warmup_s=engine.warmup_s,
               captures=engine.captures)
    out["idle"] = _idle_share(engine, requests, device)
    return out


def _print_runs(tag: str, run: dict, card: str):
    """Each run's makespan, TTFT and TPOT, the makespans' ratio and the
    idle share."""
    spans = [r["makespan"] for r in run["runs"]]
    print(f"  makespans {', '.join(f'{x:.4f}' for x in spans)} s (engine clock; "
          f"ratio {max(spans) / min(spans):.4f}), {run['graphs']} CUDA graphs, "
          f"warm-up {run['warmup_s']:.2f} s, {run['captures']} captured after "
          f"it; {card}")
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
            "decode_iterations": run["decode_iters"], "graphs": run["graphs"],
            "warmup_s": run["warmup_s"], "captures": run["captures"]}


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
    run = (MICROBATCHES, TRAIN_BATCH // MICROBATCHES, seq, steps)
    out, model, state, step_fn, stream = _train_family(
        tcfg, device, tcfg.optimizer, run, "5b train",
        depth=f"cut to {TRAIN_LAYERS} of {cfg.n_layers} layers (the only cut)")
    del state, step_fn
    _release(device)
    mb = {k: v[:run[1]] for k, v in stream.batch_at(steps).items()}
    out.update(_kernel_vs_plain_grads(model, mb, tcfg.name))
    del model
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


# ---------------------------------------------------------------------------
# phase 14: the MLA, MoE and hybrid families
# ---------------------------------------------------------------------------

def _graph_vs_eager(engine, device):
    """One decode step on the engine's final cache, replayed from its decode
    graph and run eagerly (the kernel backend), each on the same cache:
    the least cosine over rows of the logits (>= 0.9999).  None off the
    card, where the engine has no graphs."""
    if device.type != "cuda":
        return None
    saved = [{k: t.clone() for k, t in c.items()} for c in engine.cache]

    def restore():
        for c, kept in zip(engine.cache, saved):
            for k, t in c.items():
                t.copy_(kept[k])
    toks = [1] * SCHED.max_num_seqs
    replayed = engine._decode_graph(toks).clone()
    restore()
    eager = engine._decode_eager(toks)
    restore()
    cos = _cosine_rows(replayed, eager)
    _require(bool((cos >= 0.9999).all()), f"graph-replayed decode logits against "
             f"the eager path: cosine >= 0.9999 (min {float(cos.min()):.6f})")
    return float(cos.min())


def _family_kinds(cfg) -> list:
    """(stateful module kind, window) whose context points phase 14 times."""
    if cfg.attn_type == "mla":
        return [("mla_attn", 0)]
    if "moe" in cfg.layer_kinds():
        return [("moe", 0)]
    return [("self_attn", cfg.sliding_window), ("mamba", 0)]


def _context_points(cfg, device, kind: str, prefill: list, decode: list,
                    window: int = 0) -> dict:
    """The ``kind`` context's (toks, reqs, ctx) points, prefill and decode,
    through the oracle, two timings each, on one module of drawn weights;
    an attention decode point's rows full up to ctx."""
    cuda = device.type == "cuda"
    oracle = cuda_events if cuda else cpu_wallclock
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for phase, points in (("prefill", prefill), ("decode", decode)):
        if not points:
            continue
        mc = build_context(cfg, kind, phase=phase, backend="kernel",
                           window=window, device=device)
        module = mc.module(mc.materialize(mc.params, gen))
        for toks, reqs, ctx in points:
            inputs = mc.materialize(mc.abstract_inputs(toks, reqs, ctx), gen)
            if phase == "decode" and kind in ("self_attn", "mla_attn"):
                inputs[-1].fill_(ctx - 1)             # the lengths
            args = (module, *inputs)
            out[(phase, toks, reqs, ctx)] = [
                oracle(mc.fn, args, device=device) if cuda else oracle(mc.fn, args)
                for _ in range(2)]
            del inputs, args
        del module
        _release(device)
    return out


def _print_points(kind: str, points: dict, device, peak: str = None):
    print(f"  {kind} points, {'cuda_events' if device.type == 'cuda' else 'cpu_wallclock'}"
          f", two timings each{'' if peak is None else f' (peak memory {peak})'}: "
          + "; ".join(f"{ph} toks={t} reqs={r} ctx={c}: "
                      + ", ".join(f"{x * 1e6:.1f}" for x in xs) + " us"
                      for (ph, t, r, c), xs in points.items()))


def _family_points(cfg, device, kind: str, window: int = 0) -> dict:
    """The ``kind`` context's points (``_context_points``): prefill at
    FAMILY_PREFILL_TOKS x FAMILY_REQS on a fresh sequence, decode at
    FAMILY_REQS x FAMILY_CTX."""
    decode = "decode" in phases_for(kind, cfg)
    return _context_points(
        cfg, device, kind,
        [(t, r, 0) for t in FAMILY_PREFILL_TOKS[kind] for r in FAMILY_REQS],
        [(1, r, c) for r in FAMILY_REQS for c in FAMILY_CTX] if decode else [],
        window=window)


def _expected_launches(cfg, decode_iters: int, chunks: int, cuda: bool) -> tuple:
    """(decode, flash fwd, flash bwd, scan) launches of one served run: the
    decode kernel once per GQA attention layer and decode iteration, the
    scan once per Mamba mixer and chunk or decode iteration; MLA and MoE
    run no kernel of their own, and chunked prefill no flash kernel."""
    if not cuda:
        return (0, 0, 0, 0)
    kinds = cfg.layer_kinds()
    attn = sum(k != "mamba" for k in kinds) if cfg.attn_type == "gqa" else 0
    mixers = sum(k in ("mamba", "hybrid") for k in kinds)
    return (attn * decode_iters, 0, 0, mixers * (chunks + decode_iters))


def _family_prefill(cfg, device) -> dict:
    """Model.prefill on a PREFILL_LEN-token prompt through the kernels (a
    config with windowed attention and SSM state: the flash forward and the
    scan once per layer), its last logits against the plain path's: in the
    model dtype printed, in float32 held (cosine >= 0.99), as phase 8
    holds the Mamba prefill."""
    cuda = device.type == "cuda"
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PREFILL_LEN))

    def model_in(dtype):
        return Model(cfg, device=device, dtype=dtype,
                     generator=torch.Generator(device=device).manual_seed(0)
                     ).requires_grad_(False)
    model = model_in(None)
    _zero_counts()
    t0 = time.perf_counter()
    lk, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="kernel")
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    counts = _counts()
    mixers = sum(k in ("mamba", "hybrid") for k in cfg.layer_kinds())
    expect = (0, cfg.n_layers, 0, mixers) if cuda else (0, 0, 0, 0)
    _require(counts == expect, f"prefill launches (decode, flash fwd, flash bwd, "
             f"scan) {counts} == {expect}")
    _require(bool(torch.isfinite(lk).all()), "prefill logits are finite")
    lx, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    cos = float(_cosine_rows(lk, lx).min())
    del model
    _release(device)
    model = model_in(torch.float32)
    lk32, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="kernel")
    lx32, _ = model.prefill(tokens, max_seq=MAX_SEQ, impl="xla")
    cos32 = float(_cosine_rows(lk32, lx32).min())
    _require(cos32 >= 0.99, f"float32 prefill kernel vs plain cosine >= 0.99 "
             f"({cos32:.6f})")
    del model
    _release(device)
    print(f"  {PREFILL_LEN}-token Model.prefill ({cfg.dtype}) in {wall:.4f} s "
          f"(first call, host clock): kernel launches (decode, flash fwd, flash "
          f"bwd, scan) {counts}, window {cfg.sliding_window}, D "
          f"{cfg.resolved_head_dim}; last logits kernel vs plain cosine "
          f"{cos:.6f} in {cfg.dtype} (printed), {cos32:.6f} in float32 (held)")
    return {"launches": counts, "flash_launches": counts[1],
            "scan_launches": counts[3], "cosine": cos, "fp32_cosine": cos32}


def _serve_family(cfg, device, tag: str, *, depth: str = "full width and depth",
                  bound_ms: float = None):
    """Phase 14's serving of one model: the Engine serves the phase-4
    requests twice from CUDA graphs (launches as ``_expected_launches``),
    then a graph-replayed decode step against the eager path; ``bound_ms``,
    the decode step's least time, is printed beside the median decode
    iteration.  Returns (results, engine): the caller releases the engine."""
    cuda = device.type == "cuda"
    run = _serve(cfg, device)
    engine, requests, decode_iters = run["engine"], run["requests"], run["decode_iters"]
    chunks = sum(r.n_chunks for r in engine.records)
    counts = run["counts"]
    expect = _expected_launches(cfg, decode_iters, chunks, cuda)
    _require(counts == expect, f"{cfg.name} serving launches (decode, flash fwd, "
             f"flash bwd, scan) {counts} == {expect}")
    card = _card(device)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers "
          f"({', '.join(sorted(set(cfg.layer_kinds())))}), {n_params / 1e9:.3f} B "
          f"parameters, {cfg.dtype}, {depth}: {len(requests)} "
          f"requests, prompts {sorted(run['lens'].tolist())}, served "
          f"{len(run['runs'])} times, {run['runs'][0]['iterations']} iterations "
          f"({chunks} prefill chunks, {decode_iters} with decodes), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB, kernel launches (decode, flash fwd, "
          f"flash bwd, scan) {counts} a run; {card}")
    _print_runs(tag, run, card)
    decode_ms = [r["decode_ms"] for r in run["runs"]]
    cos = _graph_vs_eager(engine, device)
    bound = ("" if bound_ms is None else f" against a weight-read bound of "
             f"{bound_ms:.3f} ms (every weight but the embedding table at 3.35 TB/s)")
    print(f"  median decode-only iteration {', '.join(f'{ms:.3f}' for ms in decode_ms)}"
          f" ms{bound}; graph-replayed decode step against the eager path: "
          + ("n/a (no graphs off the card)" if cos is None else
             f"min cosine {cos:.6f}"))
    out = {"launches": counts, "decode_launches": counts[0],
           "scan_launches": counts[3], "chunks": chunks, "graph_cosine": cos,
           "n_params": n_params, "decode_ms": decode_ms, **_run_summary(run)}
    return out, engine


def phase_family(cfg, device, tag: str) -> dict:
    """Phase 14 for one family at full width and depth: ``_serve_family``,
    then the stateful modules' context points; for a config with SSM state
    also a full-sequence prefill through the kernels."""
    out, engine = _serve_family(cfg, device, f"14 {tag}")
    del engine
    _release(device)
    points = {}
    for kind, window in _family_kinds(cfg):
        points[kind] = _family_points(cfg, device, kind, window)
        _print_points(f"{kind}{f' (window {window})' if window else ''}",
                      points[kind], device)
    out["points"] = points
    if cfg.ssm_state and cfg.attn_type == "gqa":
        out["prefill"] = _family_prefill(cfg, device)
    return out


def phase_family_plan(cli_args, device, *, models, full: bool, base_db: Path,
                      db: Path, backends=(PROFILE_BACKEND,),
                      tag: str = "14 plan") -> dict:
    """Phase 14's plan: ``models`` profiled in one process through the
    profile CLI (quick sweep, ``backends``) on a copy of ``base_db``
    (phase 13's merged DB, which holds llama3-8b's and command-r7b's
    points): the plan's tasks, shared tasks, tasks satisfied by the DB and
    measured, and the profiling GPU-seconds, each point at the sweep's
    repeats, spent on the tasks this run measured and over every model,
    against what per-model profiling would spend."""
    for old in db.parent.glob(db.name + "*"):
        old.unlink()
    shutil.copyfile(base_db, db)
    res = _ok(_cli(tag, "profile", "run", "--models", ",".join(models),
                   "--backends", ",".join(backends), "--sweep", "quick",
                   *(["--full"] if full else []), *cli_args, "--db", db.name,
                   "--json", "-", cwd=db.parent), tag)
    rep = json.loads(res["stdout"])
    cov = rep["coverage"]
    hardware = cov["hardware"]
    with LatencyDB(str(base_db)) as base:
        before = set(base.measured_hashes(hardware))
    with LatencyDB(str(db)) as d:
        cost = {sig: QUICK_SWEEP.repeats * sum(
            d.measurement_map(sig, hardware).values()) / 1e6
            for sig in d.measured_hashes(hardware)}
        users = dict(d.conn.execute(
            "SELECT o.sig_hash, COUNT(DISTINCT c.model) FROM model_operations o "
            "JOIN configurations c ON c.id = o.config_id GROUP BY o.sig_hash"))
        kinds = dict(d.conn.execute("SELECT hash, op_name FROM signatures"))
    new = [sig for sig in cost if sig not in before]
    spent_new = sum(cost[sig] for sig in new)
    spent = sum(cost.values())
    naive = sum(v * users.get(sig, 1) for sig, v in cost.items())
    by_kind = {}
    for sig in new:
        k = kinds.get(sig, "?")
        k = k if k in ("self_attn", "cross_attn", "mla_attn", "moe",
                       "mamba") else "op"
        by_kind[k] = by_kind.get(k, 0.0) + cost[sig]
    _require(rep["measured"] > 0 and len(new) == rep["measured"],
             f"the plan measures the new models' tasks ({rep['measured']}, "
             f"{len(new)} new signatures)")
    print(f"[{tag}] {', '.join(models)} ({'full width' if full else 'smoke'}, "
          f"{' and '.join(backends)} backend, quick sweep, {hardware}) on a copy of "
          f"{base_db.name}: {cov['naive_tasks']} tasks model by model, "
          f"{cov['plan_tasks']} in the plan ({100 * cov['dedup_frac']:.1f} % task "
          f"dedup), {cov['shared_tasks']} shared between models, "
          f"{cov['satisfied_tasks']} already in the DB, {rep['measured']} measured "
          f"({rep['rows_written']} points, {rep['elapsed_s']:.2f} s executing, "
          f"{res['wall_s']:.1f} s wall in its own process); {_card(device)}")
    print(f"  profiling GPU-seconds at {QUICK_SWEEP.repeats} repeats a point: "
          f"{spent_new:.4f} s on the tasks this run measured ("
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_kind.items()))
          + f"); the {len(models)} models {spent:.4f} s, saved {naive - spent:.4f} s of "
          f"{naive:.4f} s that per-model profiling would spend")
    return {"coverage": cov, "measured": rep["measured"],
            "rows": rep["rows_written"], "spent_new_s": spent_new,
            "spent_s": spent, "naive_s": naive, "saved_s": naive - spent,
            "by_kind_s": by_kind, "wall_s": res["wall_s"],
            "decode_launches": res["counts"][0], "flash_launches": res["counts"][1]}


# ---------------------------------------------------------------------------
# phase 15: enc-dec and stub frontends, and the twelve-model corpus plan
# ---------------------------------------------------------------------------

def frontend_flash_shapes(vlm, llama4, encdec) -> list:
    """Phase 15's flash-forward shapes as (label, b, sq, sk, h, kv, d,
    causal): the frontends' prefill (frames then tokens, causal), the
    enc-dec encoder (non-causal), its cross-attention prefill and decode
    against the encoder's memory."""
    n, toks = FRONT_PREFILL
    out = []
    for c in (vlm, llama4):
        s, h, kv, d = (c.n_frontend_tokens + toks, c.n_heads, c.n_kv_heads,
                       c.resolved_head_dim)
        out.append((f"{c.name} prefill B={n} S={s} {h}/{kv} heads D={d}",
                    n, s, s, h, kv, d, True))
    b, prompt, _ = ENCDEC_RUN
    f, h, kv, d = (encdec.n_frontend_tokens, encdec.n_heads, encdec.n_kv_heads,
                   encdec.resolved_head_dim)
    return out + [
        (f"{encdec.name} encoder B={b} S={f} {h}/{kv} heads D={d} non-causal",
         b, f, f, h, kv, d, False),
        (f"{encdec.name} cross prefill B={b} Sq={prompt} Sk={f}", b, prompt, f,
         h, kv, d, False),
        (f"{encdec.name} cross decode B={b} Sq=1 Sk={f}", b, 1, f, h, kv, d, False)]


def _peak_gib(device) -> str:
    if device.type != "cuda":
        return "n/a (cpu)"
    return f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"


def _weight_bytes(model, skip=("embed.",)) -> int:
    """Bytes of the weights a decode step reads: every parameter but those
    under ``skip`` (a step gathers a few rows of the embedding table)."""
    return sum(p.numel() * p.element_size() for name, p in model.named_parameters()
               if not name.startswith(skip))


def _frontend_prefill(model, cfg, device) -> dict:
    """Model.prefill of FRONT_PREFILL's requests, the config's frames then
    the tokens, through the flash forward (once per layer) against the
    ``chunked`` backend on the same weights (cosine >= 0.999)."""
    cuda = device.type == "cuda"
    n, toks = FRONT_PREFILL
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (n, toks))
    frames = _randn(rng, (n, cfg.n_frontend_tokens, cfg.d_model), model.dtype,
                    device) * 0.02
    _zero_counts()
    t0 = time.perf_counter()
    lk, _ = model.prefill(tokens, frames=frames, max_seq=MAX_SEQ, impl="kernel")
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    counts = _counts()
    expect = (0, cfg.n_layers, 0, 0) if cuda else (0, 0, 0, 0)
    _require(counts == expect, f"frontend prefill launches (decode, flash fwd, "
             f"flash bwd, scan) {counts} == {expect}")
    _require(bool(torch.isfinite(lk).all()), "frontend prefill logits are finite")
    lc, _ = model.prefill(tokens, frames=frames, max_seq=MAX_SEQ, impl="chunked")
    cos = float(_cosine_rows(lk, lc).min())
    _require(cos >= 0.999, f"frontend prefill kernel vs chunked cosine >= 0.999 "
             f"({cos:.6f})")
    print(f"  Model.prefill of {n} requests, {cfg.n_frontend_tokens} frames + "
          f"{toks} tokens, in {wall:.4f} s (first call, host clock): kernel "
          f"launches (decode, flash fwd, flash bwd, scan) {counts}; last logits "
          f"kernel vs chunked min cosine {cos:.6f}; peak memory {_peak_gib(device)}")
    return {"launches": counts, "flash_launches": counts[1], "cosine": cos,
            "wall_s": wall}


def phase_frontend(cfg, device, tag: str, *, layers: int = 0,
                   kinds=("self_attn",)) -> dict:
    """Phase 15 for a stub-frontend model, text-only on the engine as the
    reference's engine serves it: ``_serve_family`` (graph-replayed decode
    against eager at cosine >= 0.9999) beside the decode step's weight-read
    bound, a prefill with frames against the ``chunked`` backend, and the
    ``kinds`` context points.  ``layers`` cuts the depth (printed as
    ``reduced``)."""
    full_layers = cfg.n_layers
    if layers:
        cfg = cfg.with_overrides(n_layers=layers)
    depth = (f"full width, reduced: n_layers {full_layers} → {cfg.n_layers}"
             if layers else "full width and depth")
    bound_ms = _weight_bytes(Model(cfg, device="meta", generator=torch.Generator())
                             ) / HBM_BYTES_PER_S * 1e3
    out, engine = _serve_family(cfg, device, f"15 {tag}", bound_ms=bound_ms,
                                depth=f"{depth}, frontend {cfg.frontend} "
                                "served text-only")
    out["prefill"] = _frontend_prefill(engine.model, cfg, device)
    del engine
    _release(device)
    cuda = device.type == "cuda"
    points = {}
    for kind in kinds:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        points[kind] = _family_points(cfg, device, kind)
        _print_points(kind, points[kind], device, _peak_gib(device))
    return {**out, "points": points, "bound_ms": bound_ms,
            "flash_launches": out["prefill"]["flash_launches"],
            "layers": (full_layers, cfg.n_layers)}


def _encdec_bound_ms(model, cache) -> float:
    """A decode step's least time: the decoder's weights and the head (not
    the encoder, not the embedding table) and every layer's encoder memory
    read once, at 3.35 TB/s."""
    nbytes = _weight_bytes(model, skip=("embed.", "enc_layers.", "enc_norm."))
    nbytes += sum(c[k].numel() * c[k].element_size() for c in cache
                  for k in ("enc_k", "enc_v"))
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_encdec(cfg, device) -> dict:
    """Phase 15 for the enc-dec model at full width and depth: the engine
    refuses it, as the reference's does; Model.prefill of ENCDEC_RUN's
    requests (the config's frames, the prompts) and its decode steps
    through the kernels, each step's logits against the ``chunked``
    backend's on the same weights and caches (cosine >= 0.999); the
    encoder, prefill and median decode-step times beside the step's bound;
    then the ``cross_attn`` context points."""
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    try:
        Engine(cfg, sched_config=SCHED, max_seq=MAX_SEQ, device=device)
        refused = False
    except NotImplementedError:
        refused = True
    _require(refused, f"the engine refuses {cfg.name} (enc-dec), as the reference's")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0)
                  ).requires_grad_(False)
    n, prompt, steps = ENCDEC_RUN
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (n, prompt))
    frames = _randn(rng, (n, cfg.n_frontend_tokens, cfg.d_model), model.dtype,
                    device) * 0.02
    new = rng.integers(0, cfg.vocab_size, (steps, n))
    max_seq = prompt + steps
    with torch.no_grad():
        model.encode(frames, impl="kernel")                  # warm-up
        sync()
        t0 = time.perf_counter()
        model.encode(frames, impl="kernel")
        sync()
        enc_s = time.perf_counter() - t0
    model.prefill(tokens, frames=frames, max_seq=max_seq, impl="kernel")
    sync()                                                   # warm-up
    _zero_counts()
    t0 = time.perf_counter()
    lk, cache = model.prefill(tokens, frames=frames, max_seq=max_seq, impl="kernel")
    sync()
    prefill_s = time.perf_counter() - t0
    counts = _counts()
    expect = (0, cfg.n_enc_layers + 2 * cfg.n_layers, 0, 0) if cuda else (0, 0, 0, 0)
    _require(counts == expect, f"{cfg.name} prefill launches (decode, flash fwd, "
             f"flash bwd, scan) {counts} == {expect}")
    lc, ccache = model.prefill(tokens, frames=frames, max_seq=max_seq,
                               impl="chunked")
    cosines = [float(_cosine_rows(lk, lc).min())]
    step_ms = []
    _zero_counts()
    for i in range(steps):
        lengths = torch.full((n,), prompt + i, dtype=torch.int32, device=device)
        sync()                      # the chunked step's work is not timed
        t0 = time.perf_counter()
        lk, cache = model.decode_step(cache, new[i], lengths, impl="kernel")
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _require(bool(torch.isfinite(lk).all()), "decode logits are finite")
        lc, ccache = model.decode_step(ccache, new[i], lengths, impl="chunked")
        cosines.append(float(_cosine_rows(lk, lc).min()))
    decode_counts = _counts()
    busy = None
    if cuda:                  # the last step again, under the profiler

        def step():
            t0 = time.perf_counter()
            model.decode_step(cache, new[-1], lengths, impl="kernel")
            sync()
            return time.perf_counter() - t0
        busy = _profile_busy(step)
    dexpect = (steps * cfg.n_layers, steps * cfg.n_layers, 0, 0) if cuda \
        else (0, 0, 0, 0)
    _require(decode_counts == dexpect, f"{cfg.name} decode launches {decode_counts}"
             f" == {dexpect}")
    _require(min(cosines) >= 0.999, f"{cfg.name} kernel vs chunked logits cosine "
             f">= 0.999 (min {min(cosines):.6f})")
    bound_ms = _encdec_bound_ms(model, cache)
    n_params = sum(p.numel() for p in model.parameters())
    median = sorted(step_ms)[len(step_ms) // 2]
    card = _card(device)
    print(f"[15 encdec] {cfg.name}, {cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, full width and depth, {n_params / 1e9:.3f} B "
          f"parameters, {cfg.dtype}; the engine refuses enc-dec, as the "
          f"reference's: {n} requests of {cfg.n_frontend_tokens} frames and "
          f"{prompt} tokens, then {steps} decode steps; encoder {enc_s * 1e3:.3f}"
          f" ms, prefill {prefill_s * 1e3:.3f} ms (host clock, each the "
          f"second call), median decode step {median:.3f} ms against a "
          f"{bound_ms:.3f} ms bound (decoder weights, head and the encoder "
          f"memory at 3.35 TB/s); kernel launches (decode, flash fwd, flash bwd, "
          f"scan) prefill {counts}, decode {decode_counts}; logits kernel vs "
          f"chunked min cosine {min(cosines):.6f} over the prefill and every "
          f"step; peak memory {_peak_gib(device)}; {card}")
    if busy is not None:
        wall, busy_s, n_k, top = busy
        print(f"  one decode step under torch.profiler {wall * 1e3:.3f} ms, "
              f"kernels busy {busy_s * 1e3:.3f} ms over {n_k} device "
              f"activities: device idle share {1 - busy_s / wall:.4f} "
              f"(eager: the host launches each op); most busy: "
              + ", ".join(f"{k} {ms:.3f} ms" for k, ms in top))
    del model, cache, ccache
    _release(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    points = _context_points(
        cfg, device, "cross_attn",
        [(t, r, c) for t in CROSS_PREFILL_TOKS for r in CROSS_REQS
         for c in CROSS_PREFILL_CTX],
        [(1, r, c) for r in CROSS_REQS for c in CROSS_DECODE_CTX])
    _print_points("cross_attn", points, device, _peak_gib(device))
    return {"prefill_launches": counts, "decode_launch_counts": decode_counts,
            "decode_busy": busy,
            "decode_launches": decode_counts[0],
            "flash_launches": counts[1] + decode_counts[1],
            "encoder_ms": enc_s * 1e3, "prefill_ms": prefill_s * 1e3,
            "step_ms": step_ms, "median_step_ms": median, "bound_ms": bound_ms,
            "min_cosine": min(cosines), "points": points}


def phase_corpus_plan(cli_args, device, *, models, full: bool, base_db: Path,
                      db: Path) -> dict:
    """The corpus models planned and profiled in one CLI process at both
    CORPUS_BACKENDS (phase 14's plan, ``[15 plan]``), with the per-model
    Table-2 rows and the task dedup beside the reference's and the
    paper's."""
    out = phase_family_plan(cli_args, device, models=models, full=full,
                            base_db=base_db, db=db, backends=CORPUS_BACKENDS,
                            tag="15 plan")
    cov = out["coverage"]
    for m in cov["models"]:
        print(f"  {m['model']}/{m['backend']}: {m['n_entries']} entries, "
              f"{m['n_tasks']} tasks, {m['n_satisfied']} satisfied, "
              f"{m['n_shared']} shared, {m['n_to_measure']} to measure")
    saved = out["saved_s"] / out["naive_s"] if out["naive_s"] else 0.0
    print(f"  corpus task dedup {100 * cov['dedup_frac']:.1f} % (reference "
          f"{100 * REFERENCE_DEDUP:.1f} % on the smoke corpus, dry run; paper "
          f"{100 * PAPER_SAVED:.1f} % fewer profiling GPU-hours); GPU-seconds "
          f"{out['spent_s']:.4f} spent, {out['saved_s']:.4f} saved "
          f"({100 * saved:.1f} % of {out['naive_s']:.4f}) against each model "
          f"profiled alone")
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


def _priced(sim, r) -> tuple:
    """(kind, DoolySim's price in s) of one engine iteration record: decode
    only, chunks only, or chunks with decodes."""
    kind = ("decode" if not r.n_chunks else
            "chunks" if not r.n_decodes else "mixed")
    return kind, (sim.overhead_s + sim.chunk_overhead_s * r.n_chunks
                  + sim.predict_record(r))


def _iteration_errors(sim, records) -> dict:
    """The engine's iterations against DoolySim's price of each, by kind
    (decode only, chunks only, chunks with decodes) and, for chunk-only
    iterations of one chunk, by bucket (``_error_stats``)."""
    groups = {}
    for r in records:
        kind, pred = _priced(sim, r)
        groups.setdefault(kind, []).append((r.model_s, pred))
        if kind == "chunks" and r.n_chunks == 1:
            groups.setdefault(f"chunk {bucket_chunk(r.chunks[0][0], SCHED.chunk_size)}",
                              []).append((r.model_s, pred))
    return _error_stats(groups)


def _admitting_errors(sim, records, admitting) -> dict:
    """``_iteration_errors`` over the iterations that admitted a request
    (``admitting``: their indices), by kind and the bucket of their longest
    chunk."""
    groups = {}
    for i in sorted(admitting):
        kind, pred = _priced(sim, records[i])
        longest = max(length for length, _ in records[i].chunks)
        groups.setdefault(f"{kind} {bucket_chunk(longest, SCHED.chunk_size)}",
                          []).append((records[i].model_s, pred))
    return _error_stats(groups)


def _error_stats(groups: dict) -> dict:
    """For each group of (measured, predicted) seconds: count, median
    measured and predicted ms, MAPE and mean signed error (%)."""
    out = {}
    for kind, pairs in groups.items():
        real, pred = np.array(pairs).T
        err = (pred - real) / real * 100.0
        out[kind] = {"n": len(pairs), "ms": float(np.median(real)) * 1e3,
                     "pred_ms": float(np.median(pred)) * 1e3,
                     "mape": float(np.abs(err).mean()), "bias": float(err.mean())}
    return out


def _admissions(requests, plans) -> dict:
    """{rid: index of the iteration that admitted it (its first chunk)} of
    one run, from its requests and its plans (``(chunk lengths, decodes)``
    an iteration, as DoolySim records them).  The scheduler gives every
    request still prefilling a chunk, in admission order, before it admits
    any (the budget that stops it stops admissions too), and admits by
    arrival: so an iteration with more chunks than requests still
    prefilling admitted the rest, in order."""
    waiting = sorted(requests, key=lambda r: r.arrival)[::-1]
    prefilling, out = [], {}
    for i, (lengths, _) in enumerate(plans):
        for j, length in enumerate(lengths):
            if j >= len(prefilling):
                if not waiting:
                    raise ValueError(f"iteration {i} admits more requests "
                                     "than arrived")
                r = waiting.pop()
                out[r.rid] = i
                prefilling.append([r, r.cache_hit_tokens])
            entry = prefilling[j]
            if not 0 < length <= entry[0].prompt_len - entry[1]:
                raise ValueError(f"iteration {i}: a chunk of {length} tokens "
                                 f"for request {entry[0].rid} at {entry[1]} of "
                                 f"{entry[0].prompt_len}")
            entry[1] += length
        prefilling = [e for e in prefilling if e[1] < e[0].prompt_len]
    if waiting or prefilling:
        raise ValueError(f"{len(waiting)} requests never admitted, "
                         f"{len(prefilling)} never prefilled")
    return out


def _engine_plans(records) -> list:
    """An engine run's plans as DoolySim records them: (chunk lengths,
    decodes) an iteration."""
    return [(tuple(length for length, _ in r.chunks), r.n_decodes)
            for r in records]


def _agree(a, b) -> int:
    """How many leading iterations two runs' plans share."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _ttft_split(pred: dict, real: dict, moved) -> dict:
    """TTFT MAPE of ``pred`` against ``real`` (``request_metrics``) over
    every request, over those whose admission did not move and over those
    that did (``moved``: one bool a request, in their order), with the
    counts."""
    moved = np.asarray(moved, bool)
    out = {"all": M.mape(pred["ttft"], real["ttft"]),
           "n_moved": int(moved.sum()), "n_kept": int((~moved).sum())}
    for key, mask in (("kept", ~moved), ("moved", moved)):
        out[key] = (M.mape(pred["ttft"][mask], real["ttft"][mask])
                    if mask.any() else None)
    return out


def _moved(requests, a: dict, b: dict) -> list:
    """One bool a finished request of ``requests`` (``request_metrics``'
    order): did its admission iteration differ between ``a`` and ``b``?"""
    return [a[r.rid] != b[r.rid] for r in requests if r.done]


def _admission_split(pred: dict, pred_run, real: dict, real_run) -> dict:
    """``_ttft_split`` of one run against another over the requests whose
    admission iteration moved, and how many leading iterations their
    schedules share; ``*_run``: (requests, plans)."""
    moved = _moved(pred_run[0], _admissions(*pred_run), _admissions(*real_run))
    return {**_ttft_split(pred, real, moved),
            "agree": _agree(pred_run[1], real_run[1])}


def _ttft_parts(requests, plans, starts) -> tuple:
    """Each finished request's TTFT (``request_metrics``' order) in two
    parts: the wait from its arrival to the start of the iteration that
    admits it, and the time of the iterations that carry its chunks, from
    that start to its first token (the scheduler gives a request still
    prefilling a chunk in every iteration).  ``plans``: the run's
    ``(chunk lengths, decodes)`` an iteration; ``starts``: each
    iteration's start on the run's clock.  Returns (wait, chunks) arrays."""
    admitted = _admissions(requests, plans)
    done = [r for r in requests if r.done]
    begin = np.array([starts[admitted[r.rid]] for r in done])
    return (begin - np.array([r.arrival for r in done]),
            np.array([r.first_token_t for r in done]) - begin)


def _parts_errors(pred: tuple, real: tuple, moved) -> dict:
    """The error of each TTFT part of ``pred`` against ``real``
    (``_ttft_parts``) as a share of ``real``'s TTFT (%), so the parts' signed
    errors sum to TTFT's: MAPE and mean signed error over every request,
    over those whose admission kept its iteration and over those whose
    admission moved (``moved``: one bool a request)."""
    moved = np.asarray(moved, bool)
    ttft = real[0] + real[1]
    out = {}
    for name, p, r in zip(("wait", "chunks"), pred, real):
        err = (p - r) / ttft * 100.0
        out[name] = {key: ({"mape": float(np.abs(err[mask]).mean()),
                            "bias": float(err[mask].mean())}
                           if mask.any() else None)
                     for key, mask in (("all", np.ones_like(moved)),
                                       ("kept", ~moved), ("moved", moved))}
    return out


def _nearest(pts, t: int, r: int, c: int):
    """The point of ``pts`` ((toks, reqs, ctx, us) each) at the workload
    (t, r, c), or else the nearest in log tokens, then in log context."""
    return min(pts, key=lambda p: (
        p[:3] != (t, r, c),
        abs(math.log(max(p[0], 1) * max(p[1], 1)) - math.log(max(t * r, 1))),
        abs(math.log(max(p[2], 1)) - math.log(max(c, 1)))))


def _row_prices(lat, points, key) -> list:
    """Each call-graph row of ``lat`` (a ``DoolyBackend``) in one model call
    ``key`` ((phase, toks, reqs, ctx)): the row, its mapped workload point
    (``_map_row``), the DB's point there in µs, or else the nearest
    (``_nearest``; ``points`` as ``_near_floor_share`` takes them), whether
    the DB holds that exact key, and the fit's seconds there."""
    phase, toks, reqs, ctx = key
    out = []
    for row in lat.rows:
        ph, t, r, c = lat._map_row(row, phase, toks, reqs, ctx)
        pts = points.get((row.sig, ph)) or points.get(
            (row.sig, "decode" if ph == "prefill" else "prefill"), [])
        near = _nearest(pts, t, r, c) if pts else None
        out.append({"row": row, "key": (ph, t, r, c),
                    "point_us": near[3] if near else None,
                    "exact": near is not None and near[:3] == (t, r, c),
                    "fit_s": lat.lm.predict(row.sig, ph, toks=t, reqs=r, ctx=c)})
    return out


def _row_group(row) -> str:
    """The group a call-graph row's price is reported under: its module
    kind if stateful (``self_attn``, ``moe``, ...), ``linear`` for a
    matmul op, else ``other``."""
    if row.stateful:
        return row.kind
    return "linear" if row.kind.split(".")[1:2] in ([k] for k in LINEAR_OPS) \
        else "other"


def _call_price(lat, points, key) -> dict:
    """One model call's price two ways: ``raw``, the DB's points with no fit
    (each row's count x its point, ``_row_prices``), and ``fit``, DoolySim's
    rows (count x the fit), in seconds; both by ``_row_group``; the timed
    calls it sums (the rows' counts) and the rows priced at an exact key."""
    raw = fit = 0.0
    groups, calls, exact, errors = {}, 0, 0, []
    rows = _row_prices(lat, points, key)
    for p in rows:
        n = p["row"].count
        r_s = n * (p["point_us"] or 0.0) * 1e-6
        f_s = n * p["fit_s"]
        raw += r_s
        fit += f_s
        g = groups.setdefault(_row_group(p["row"]), [0.0, 0.0])
        g[0] += r_s
        g[1] += f_s
        calls += n
        exact += p["exact"]
        errors.append((f_s - r_s, p["row"].kind, n, p["key"]))
    _require(abs(fit - lat.predict_points([key])[0]) <= 1e-9 + 1e-9 * fit,
             f"the rows walked sum to DoolySim's price of the call {key}")
    worst = sorted(errors, key=lambda e: -abs(e[0]))[:3]
    return {"raw": raw, "fit": fit, "groups": groups, "calls": calls,
            "exact": exact, "rows": len(rows),
            "worst": [{"fit_minus_raw": e, "kind": k, "count": n, "key": list(at)}
                      for e, k, n, at in worst]}


def _iteration_price(lat, points, bucket, decodes: bool) -> dict:
    """(d) and (e) of one iteration of one chunk of ``bucket`` tokens (None:
    no chunk) with the decode batch or without: each call's ``_call_price``
    and DoolySim's fitted price in its four terms, ``overhead_s``,
    ``chunk_overhead_s`` a chunk, the chunk's rows and ``decode_scale`` x
    the decode rows (s), whose sum is DoolySim's price of the plan."""
    calls = {"chunk": None if bucket is None else _call_price(
                 lat, points, ("prefill", bucket, 1, lat.max_seq)),
             "decode": _call_price(lat, points, lat._decode_key())
             if decodes else None}
    terms = {"overhead": lat.overhead_s,
             "chunk_overhead": 0.0 if bucket is None else lat.chunk_overhead_s,
             "chunk": 0.0 if bucket is None else calls["chunk"]["fit"],
             "decode": lat.decode_scale * calls["decode"]["fit"] if decodes else 0.0}
    fitted = sum(terms.values())
    n_dec = lat.sched_config.max_num_seqs if decodes else 0
    plan = (() if bucket is None else (bucket,), n_dec)
    _require(abs(fitted - lat.predict_plan(plan)) <= 1e-12 + 1e-9 * fitted,
             f"the terms sum to DoolySim's price of {plan}")
    raw = sum(c["raw"] for c in calls.values() if c)
    return {"calls": calls, "terms": terms, "raw_s": raw, "fit_s": fitted}


def _near_floor_share(sim, points, plans, *, margin_us: float = 1.0) -> dict:
    """The share of DoolySim's predicted time of each decode-only iteration
    (``plans``: its run's ``(chunk lengths, decodes)``) that rests on DB
    points measured less than ``margin_us`` above the oracle's launch floor.
    ``points``: {(sig, phase): [(toks, reqs, ctx, us)]} as the DB holds
    them, floor already subtracted (``cuda_events`` stores a point's median
    less the floor, or 5 % of the median where that is more, both under
    the margin), so a point is near the floor when it holds less than
    ``margin_us``.  A call-graph row rests on the point of its signature
    and mapped phase at its mapped workload, or else the nearest
    (``_row_prices``); a decode call is priced at one workload point, so
    every decode-only iteration has the same share."""
    lat = sim.latency
    rows = _row_prices(lat, points, lat._decode_key())
    total_s = sum(p["row"].count * p["fit_s"] for p in rows)
    near = [p for p in rows
            if p["point_us"] is not None and p["point_us"] < margin_us]
    near_s = sum(p["row"].count * p["fit_s"] for p in near)
    _require(abs(total_s - lat.predict_points([lat._decode_key()])[0])
             <= 1e-9 + 1e-9 * total_s,
             "the rows walked sum to DoolySim's price of a decode call")
    per_iter = lat.overhead_s + lat.decode_scale * total_s
    share = lat.decode_scale * near_s / per_iter if per_iter > 0 else 0.0
    shares = [share for lengths, n_dec in plans if not lengths and n_dec]
    return {"median": float(np.median(shares)) if shares else None,
            "max": max(shares) if shares else None, "iterations": len(shares),
            "near_rows": len(near), "rows": len(lat.rows),
            "predicted_ms": per_iter * 1e3, "margin_us": margin_us}


def _iteration_kinds(records) -> dict:
    """{kind and bucket: iterations} of an engine run: ``decode``, or
    ``chunks B`` / ``mixed B`` (chunks alone / beside decodes) by the bucket
    of the iteration's longest chunk."""
    out = {}
    for r in records:
        if r.n_chunks:
            longest = max(length for length, _ in r.chunks)
            kind = (f"{'mixed' if r.n_decodes else 'chunks'} "
                    f"{bucket_chunk(longest, SCHED.chunk_size)}")
        else:
            kind = "decode"
        out[kind] = out.get(kind, 0) + 1
    return out


def _mixed_plan(engine, bucket: int, last: bool, decodes: bool, *,
                start: int, decode_len: int) -> tuple:
    """One iteration shape of ``[12 mixed]``: a chunk of ``bucket`` tokens
    in cache row 0 after ``start`` cached tokens, the last of its prompt or
    not, beside a decode of every other row (each ``decode_len`` tokens in)
    or alone; as (the plan, the engine's row lengths before it)."""
    rows = engine.sched.config.max_num_seqs
    req = Request(0, 0.0, [1] * (start + bucket * (1 if last else 2)), 1,
                  slot=0)
    decs = [Request(i, 0.0, [1] * decode_len, 2, prefilled=decode_len, slot=i)
            for i in range(1, rows)] if decodes else []
    return (IterationPlan([PrefillChunk(req, start, bucket)], decs),
            [start] + [decode_len] * (rows - 1))


def _alone_s(engine, run, key, repeats: int) -> list:
    """Seconds of one engine step alone, ``repeats`` times: on the card the
    engine's captured graph ``key`` replayed behind a busy kernel, as
    ``cuda_events`` times a point (its inputs as one ``run()`` of the
    engine's step method left them); on the CPU ``run()`` itself."""
    engine.timeline = []
    run()
    synchronize(engine.device)
    if engine.device.type == "cuda":
        g = engine.graphs[key]
        for _ in range(repeats):
            torch.cuda._sleep(BUSY_CYCLES)
            engine._marked(g.replay)
    else:
        for _ in range(repeats - 1):
            run()
    synchronize(engine.device)
    marks, engine.timeline = engine.timeline, None
    if engine.device.type == "cuda":
        marks = marks[1:]
    return [span_s(a, b) for a, b in marks]


def _card_reading(engine) -> tuple:
    """``Engine.decode_alone_ms`` (the decode graph alone, which tells which
    of the card's per-kernel states the engine is in) and the MiB in use on
    the card as the CUDA driver counts them (graphs and modules included; 0
    off the card)."""
    ms = engine.decode_alone_ms()
    if engine.device.type != "cuda":
        return ms, 0.0
    free, total = torch.cuda.mem_get_info(engine.device)
    return ms, (total - free) / 2**20


def _settle_summary(engine, settled: bool) -> dict:
    """What ``Engine.settle`` did: whether it settled, its seconds, its
    readings and the reading warm-up took with the decode graph alone
    captured (ms; None off the card)."""
    return {"settled": settled, "settle_s": engine.settle_s,
            "settle_ms": engine.settle_ms, "first_alone_ms": engine.first_alone_ms}


def _settle_text(warm: dict) -> str:
    if warm["first_alone_ms"] is None:
        return "no settle off the card"
    ms = warm["settle_ms"]
    return (f"the decode graph alone {warm['first_alone_ms']:.3f} ms with only "
            f"itself captured, {ms[0]:.3f} ms after warm-up; Engine.settle "
            + ("settled" if warm["settled"] else "saw no fall to the fast state "
               "(fast throughout, or slow throughout)")
            + f" in {warm['settle_s']:.1f} s ({len(ms)} readings, the last "
            f"{ms[-1]:.3f} ms)")


def _spread(values: list) -> float:
    """(max - min) / min."""
    return (max(values) - min(values)) / min(values)


def _set_counts(counts: tuple):
    """Put back the kernel launch counts ``_counts`` returned."""
    (da.decode_attention.launches, fa.flash_attention_fwd.launches,
     fa.flash_attention_bwd.launches, ms.mamba_scan.launches) = counts


def _launch_s(engine, key, repeats: int) -> dict:
    """The engine's graph ``key`` launched on an idle card, ``repeats``
    times: the median device span from an event recorded just before the
    launch to one just after (``idle_s``; against ``_alone_s`` the time the
    card waits for the launch), and the median host seconds the launch call
    takes (``host_s``); None off the card."""
    if engine.device.type != "cuda":
        return None
    g = engine.graphs[key]
    idle, host = [], []
    for _ in range(repeats):
        synchronize(engine.device)
        start = mark(engine.device)
        t0 = time.perf_counter()
        g.replay()
        host.append(time.perf_counter() - t0)
        end = mark(engine.device)
        synchronize(engine.device)
        idle.append(span_s(start, end))
    return {"idle_s": float(np.median(idle)), "host_s": float(np.median(host))}


def _mixed_decomposition(engine, sim, points, *, buckets, start: int,
                         decode_len: int, repeats: int) -> dict:
    """``[12 mixed]``: each iteration shape (``_mixed_plan``: a chunk of each
    bucket, its prompt's last or not, with the decode batch or alone) run
    ``repeats`` times through ``Engine.execute`` on the engine of the score
    runs, and five readings of it (medians, s):

    (a) ``execute``'s host-clock seconds; (b) the device time from the
    first graph's start to the last graph's end (``Engine.timeline``), and
    each graph's span inside the iteration; (c) the chunk graph and the
    decode graph each alone (``_alone_s``, half the repeats, taken just
    before the bucket's shapes); (d) the DB's raw points for the
    iteration's calls, and (e) DoolySim's fitted price in its terms
    (``_iteration_price``).  Each graph is also launched on an idle card
    (``_launch_s``).  The engine is ``reset`` afterwards."""
    cuda = engine.device.type == "cuda"
    alone, launch, shapes = {}, {}, []
    for b in buckets:
        plan, lengths = _mixed_plan(engine, b, True, True, start=start,
                                    decode_len=decode_len)
        chunk = plan.prefills[0]
        engine.lengths = list(lengths)
        engine.execute(plan)
        engine.lengths = list(lengths)
        ids, toks = chunk.req.prompt[start:start + b], engine._decode_tokens(plan)
        alone[b] = {
            "chunk": float(np.median(_alone_s(
                engine, lambda: (engine._chunk_graph if cuda else
                                 engine._chunk_eager)(chunk, b, ids),
                ("chunk", b, 0), max(repeats // 2, 1)))),
            "decode": float(np.median(_alone_s(
                engine, lambda: (engine._decode_graph if cuda else
                                 engine._decode_eager)(toks),
                ("decode",), max(repeats // 2, 1))))}
        launch[b] = {"chunk": _launch_s(engine, ("chunk", b, 0), repeats // 2),
                     "decode": _launch_s(engine, ("decode",), repeats // 2)}
        for last in (True, False):
            for decodes in (True, False):
                plan, lengths = _mixed_plan(engine, b, last, decodes,
                                            start=start, decode_len=decode_len)
                host, dev, steps = [], [], []
                for _ in range(repeats):
                    engine.lengths = list(lengths)
                    engine.timeline = []
                    host.append(engine.execute(plan))
                    marks, engine.timeline = engine.timeline, None
                    dev.append(span_s(marks[0][0], marks[-1][1]))
                    steps.append([span_s(s, e) for s, e in marks])
                price = _iteration_price(sim.latency, points, b, decodes)
                c_dec = alone[b]["decode"] if decodes else 0.0
                c = alone[b]["chunk"] + c_dec
                a, bb = float(np.median(host)), float(np.median(dev))
                shapes.append({
                    "bucket": b, "last": last, "decodes": decodes,
                    "a": a, "b": bb,
                    "in_iteration": [float(x) for x in np.median(steps, axis=0)],
                    "c": c, "c_chunk": alone[b]["chunk"], "c_decode": c_dec,
                    "d": price["raw_s"], "e": price["fit_s"],
                    "terms": price["terms"], "calls": price["calls"],
                    "fit_error": price["fit_s"] - price["raw_s"],
                    "oracle_error": price["raw_s"] - c,
                    "interaction": bb - c, "host": a - bb})
    engine.reset()
    return {"shapes": shapes, "alone": alone, "launch": launch,
            "start": start, "decode_len": decode_len, "repeats": repeats}


def _bias(pred: dict, real: dict, key: str) -> float:
    """Mean signed relative error of the predicted per-request ``key``
    against the engine's."""
    return float(np.mean((pred[key] - real[key]) / real[key]))


def _sweep_scoring(store, cfg, device, *, config_fn, sched: SchedulerConfig,
                   max_seq: int, score: dict, scoring: dict, fit: dict) -> dict:
    """The sweep on phase 12's DB: ``cfg`` (registered as
    ``PROFILE_MODELS[0]``) over ``scoring``'s scheduler specs on the score
    trace, priced by Sweep with no calibration, as the reference's sweep
    prices a grid.  Then the engine settles and serves the ``served``
    scenario once, and the sweep's own DoolySim for it is scored against
    that run bare and with phase 12's calibration terms ``fit`` applied."""
    model = PROFILE_MODELS[0]
    _require(config_fn(model) == cfg, f"{model} resolves to the served config")
    specs = [SchedSpec(s, t, scoring["chunk"], sched.prefix_caching)
             for s in scoring["seqs"] for t in scoring["tokens"]]
    workload = WorkloadSpec(kind="sharegpt", n=score["n"], rate=score["rate"],
                            seed=score["seed"], scale=score["scale"],
                            vocab=cfg.vocab_size)
    grid = expand_grid([model], specs, [workload], backends=(PROFILE_BACKEND,),
                       hardware=store.hardware, max_seq=max_seq)
    sweep = store.sweep(config_fn=config_fn)
    _require(sweep.profile_plan(grid) is None,
             "the sweep finds its model profiled and measures nothing")
    t0 = time.perf_counter()
    out = sweep.run(grid)
    sweep_s = time.perf_counter() - t0
    _require(not out.failures and len(out.results) == len(grid),
             f"every scenario of the sweep evaluated ({out.failure_table()})")
    served = SchedSpec(*scoring["served"], prefix_caching=sched.prefix_caching)
    scn = next(s for s in grid if s.sched == served)
    row = out.results[grid.index(scn)]
    engine = Engine(cfg, sched_config=served.to_config(), max_seq=max_seq,
                    impl=PROFILE_BACKEND, seed=0, device=device)
    settled = engine.settle()
    real = M.request_metrics(engine.run(workload.build())["requests"])
    warm = {"warmup_s": engine.warmup_s, "graphs": len(engine.graphs),
            "captures": engine.captures, **_settle_summary(engine, settled)}
    _require(engine.captures == 0, f"the sweep's engine captured no graph after "
             f"warm-up ({engine.captures})")
    del engine
    _release(device)
    sim = sweep.sim(scn)
    bare = sim.run(workload.build())
    _require(abs(bare["makespan"] - row.makespan) <= 1e-9,
             f"the sweep's makespan {row.makespan} is its DoolySim's "
             f"{bare['makespan']}")
    bare = M.request_metrics(bare["requests"])
    for k, v in fit.items():
        setattr(sim, k, v)
    calibrated = M.request_metrics(sim.run(workload.build())["requests"])
    forms = {"uncalibrated": bare, "calibrated": calibrated}
    cmp = {k: M.compare(v, real) for k, v in forms.items()}
    bias = {k: {m: _bias(v, real, m) for m in ("ttft", "tpot")}
            for k, v in forms.items()}
    bad = [(k, m) for k, c in cmp.items() for m, v in c.items()
           if not math.isfinite(v)]
    _require(not bad, f"finite MAPEs of the sweep's prediction ({bad})")
    print(f"[12 sweep] {model} ({cfg.name}) on the loop's DB: {len(grid)} "
          f"scenarios ({', '.join(s.label() for s in specs)}; "
          f"{workload.label()}) in {sweep_s:.3f} s, failed 0, summary "
          f"{out.summary}; frontier (tpot_mean): "
          + ", ".join(r.scenario.sched.label() for r in out.frontier()))
    for r in out.results:
        print(f"  {r.scenario.sched.label()}: {r.mode}, TTFT mean {r.ttft_mean:.5f} "
              f"s, TPOT mean {r.tpot_mean:.6f} s, makespan {r.makespan:.4f} s, "
              f"cost {r.cost:.4f}")
    print(f"  engine served {served.label()} once: makespan "
          f"{real['finish'][-1]:.4f} s, TTFT mean {real['ttft'].mean():.5f} s, "
          f"TPOT mean {real['tpot'].mean():.6f} s; warm-up {warm['warmup_s']:.2f} "
          f"s, {warm['graphs']} CUDA graphs, {_settle_text(warm)}, "
          f"{warm['captures']} captured after warm-up; {_card(device)}")
    for k in forms:
        terms = ("" if k == "uncalibrated" else " (" + ", ".join(
            f"{n} {v:.6g}" for n, v in fit.items()) + ")")
        bars = ", ".join(f"{m} {'held' if cmp[k][m] <= bar else 'failed'}"
                         for m, bar in PAPER_MAPE.items())
        print(f"  sweep's DoolySim {k}{terms} vs the engine: {_mapes(cmp[k])}; "
              f"signed TTFT {100 * bias[k]['ttft']:+.2f} %, TPOT "
              f"{100 * bias[k]['tpot']:+.2f} %; paper bars TTFT 5 %, TPOT 8 %: "
              f"{bars}")
    return {"scenarios": len(grid), "sweep_s": sweep_s, "summary": out.summary,
            "served": served.label(),
            "engine_makespan_s": float(real["finish"][-1]),
            "mape": cmp, "bias": bias, **warm}


def _engine_vs_sim(store, cfg, device, *, sched: SchedulerConfig,
                   max_seq: int, calibration: dict, score: dict,
                   mixed: dict = None) -> dict:
    """DoolySim for ``cfg`` on the store's DB, calibrated on one engine run;
    the score trace served twice on the engine (its self-noise) and
    predicted by DoolySim (MAPE against the first run); then, with
    ``mixed`` (``_mixed_decomposition``'s settings), the mixed iterations
    taken apart on the same engine (its kernel launches not counted).  The
    engine settles (``Engine.settle``) before the calibration run; the
    decode graph alone (``_card_reading``) is read after the settle and
    after each run, and every run must capture no graph after warm-up."""
    sim = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                          backend=PROFILE_BACKEND)
    _require(not sim.latency.unprofiled_sigs(), "every call-graph signature "
             f"of {cfg.name} has DB points ({sim.latency.unprofiled_sigs()})")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    engine = Engine(cfg, sched_config=sched, max_seq=max_seq,
                    impl=PROFILE_BACKEND, seed=0, device=device)
    warm = {"warmup_s": engine.warmup_s, "graphs": len(engine.graphs),
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
            "state_len": engine.state_len}
    warm.update(_settle_summary(engine, engine.settle()))
    alone = [_card_reading(engine)]
    captures = []

    def after_run():
        captures.append(engine.captures)
        _require(engine.captures == 0, f"{cfg.name}'s engine captured no "
                 f"graph after warm-up by run {len(captures)} ({captures})")
        alone.append(_card_reading(engine))
    calib = synthetic(calibration["n"], rate=calibration["rate"],
                      prompt_len=calibration["prompt_len"],
                      out_len=calibration["out_len"],
                      seed=calibration["seed"], vocab=cfg.vocab_size)
    engine.run(calib)
    calib_records = list(engine.records)
    fit = sim.calibrate(calib_records)
    calib_kinds = _iteration_kinds(calib_records)
    drift = [(_decode_ms(engine.records), _card_state(device))]
    after_run()

    def trace():
        return sharegpt_like(score["n"], rate=score["rate"], seed=score["seed"],
                             scale=score["scale"], vocab=cfg.vocab_size)
    longest = max(r.prompt_len + r.max_new_tokens for r in trace())
    _require(longest <= max_seq, f"every request fits max_seq ({longest} "
             f"<= {max_seq})")
    real, iterations, runs, parts = [], [], [], []
    for _ in range(2):
        engine.reset()
        served = engine.run(trace())["requests"]
        real.append(M.request_metrics(served))
        runs.append((served, _engine_plans(engine.records)))
        iterations.append((len(engine.records),
                           sum(1 for r in engine.records if not r.n_chunks)))
        drift.append((_decode_ms(engine.records), _card_state(device)))
        parts.append(_ttft_parts(served, runs[-1][1],
                                 [r.t_start for r in engine.records]))
        if len(real) == 1:
            by_kind = _iteration_errors(sim, engine.records)
            admitting_at = set(_admissions(served, runs[-1][1]).values())
            admitting = _admitting_errors(sim, engine.records, admitting_at)
            records_1 = list(engine.records)
        after_run()
    points = {}
    for sig, phase, t, r, c, us in store.db.measurements_for_hardware(
            store.hardware):
        points.setdefault((sig, phase), []).append((t, r, c, us))
    if mixed:
        t0, counts = time.perf_counter(), _counts()
        mixed = {**_mixed_decomposition(engine, sim, points, **mixed),
                 "s": time.perf_counter() - t0}
        _set_counts(counts)     # its launches are readings, not served work
        # the fit's share: the same calibration and trace on the raw points
        raw = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                              backend=PROFILE_BACKEND, latency="oracle")
        raw_fit = raw.calibrate(calib_records)
        raw_run = raw.run(trace())
        mixed["raw"] = {
            "fit": raw_fit,
            "cmp": M.compare(M.request_metrics(raw_run["requests"]), real[0]),
            "admitting": _admitting_errors(raw, records_1, admitting_at)}
    del engine
    _release(device)
    sim_run = sim.run(trace(), record_plans=True)
    predicted = M.request_metrics(sim_run["requests"])
    cmp = M.compare(predicted, real[0])
    bad = [k for k, v in cmp.items() if not math.isfinite(v)]
    _require(not bad, f"finite MAPEs of {cfg.name} ({bad})")
    # the admission iteration of each request, and TTFT scored apart over
    # the requests whose admission moved: the clock is the measured (or
    # predicted) time, so a small shift can admit a request an iteration
    # earlier or later
    ttft = {"noise": _admission_split(real[1], runs[1], real[0], runs[0]),
            "sim": _admission_split(predicted, (sim_run["requests"],
                                                sim_run["plans"]),
                                    real[0], runs[0])}
    # which part of a request's TTFT carries the error: the wait before its
    # admitting iteration, or the iterations that carry its chunks
    sim_parts = _ttft_parts(sim_run["requests"], sim_run["plans"],
                            [end - dt for end, _, dt in sim_run["iterations"]])
    moved = {"noise": _moved(runs[1][0], _admissions(*runs[1]), _admissions(*runs[0])),
             "sim": _moved(sim_run["requests"],
                           _admissions(sim_run["requests"], sim_run["plans"]),
                           _admissions(*runs[0]))}
    ttft_parts = {"noise": _parts_errors(parts[1], parts[0], moved["noise"]),
                  "sim": _parts_errors(sim_parts, parts[0], moved["sim"]),
                  "admitting": admitting}
    return {"model": cfg.name, "sim": sim, "trace": trace, "fit": fit,
            "calibration_kinds": calib_kinds, "mixed": mixed, "drift": drift,
            "alone_ms": alone, "captures": captures, "warm": warm,
            "real": real, "iterations": iterations, "by_kind": by_kind,
            "noise": M.compare(real[1], real[0]), "sim_run": sim_run,
            "predicted": predicted, "cmp": cmp, "ttft_split": ttft,
            "ttft_parts": ttft_parts,
            "near_floor": _near_floor_share(sim, points, sim_run["plans"])}


def _print_scored(res: dict, calibration: dict, score: dict, floor_us=None):
    """The engine's warm-up, the calibration, the engine's and DoolySim's
    makespans, the iterations by kind and the near-floor share of a
    predicted decode iteration (``floor_us``: the oracle's launch floor, or
    None), the drift and the decode graph alone around the runs, the
    self-noise and the MAPEs, and TTFT apart over the requests whose
    admission moved."""
    real, predicted, cmp = res["real"], res["predicted"], res["cmp"]
    warm = res["warm"]
    print(f"  engine warm-up {warm['warmup_s']:.2f} s: {warm['graphs']} CUDA "
          f"graphs, peak memory {warm['peak_bytes'] / 2**30:.2f} GiB; "
          f"{_settle_text(warm)}; graphs captured after warm-up in the "
          f"calibration run and score runs 1 and 2: "
          f"{', '.join(str(n) for n in res['captures'])}")
    print(f"  calibration on {calibration['n']} requests of "
          f"{calibration['prompt_len']} tokens: " + ", ".join(
              f"{k} {v:.6g}" for k, v in res["fit"].items())
          + "; its iterations by kind (bucket of the longest chunk): " + ", ".join(
              f"{k} x{n}" for k, n in sorted(res["calibration_kinds"].items())))
    print(f"  score trace: ShareGPT-like, {score['n']} requests, rate "
          f"{score['rate']}/s, seed {score['seed']}, scale {score['scale']}; "
          f"engine makespans {real[0]['finish'][-1]:.4f}, "
          f"{real[1]['finish'][-1]:.4f} s over "
          + ", ".join(f"{n} iterations ({d} decode-only)"
                      for n, d in res["iterations"])
          + f"; DoolySim {predicted['finish'][-1]:.4f} s over "
          f"{len(res['sim_run']['iterations'])} iterations")
    print("  iterations of engine run 1 against DoolySim's price: " + "; ".join(
        f"{k} x{v['n']}: {v['ms']:.3f} ms measured, {v['pred_ms']:.3f} predicted "
        f"(median), MAPE {v['mape']:.2f} %, bias {v['bias']:+.2f} %"
        for k, v in res["by_kind"].items()))
    near = res["near_floor"]
    floor = ("no launch floor" if floor_us is None
             else f"the {floor_us:.3f} us launch floor")
    print(f"  near-floor share of DoolySim's decode-only iterations (rows on DB "
          f"points < {near['margin_us']:g} us above {floor}): "
          + ("none predicted" if near["iterations"] == 0 else
             f"median {100 * near['median']:.2f} %, max {100 * near['max']:.2f} "
             f"% over {near['iterations']} iterations")
          + f"; {near['near_rows']} of {near['rows']} call-graph rows, "
          f"{near['predicted_ms']:.4f} ms predicted an iteration")
    print(f"  TTFT mean signed error of DoolySim vs engine run 1: "
          f"{100 * _bias(predicted, real[0], 'ttft'):+.2f} %")
    print("  median decode-only iteration, calibration run and score runs 1 "
          "and 2, with the card's SM clock, power and temperature after each: "
          + "; ".join(f"{ms:.3f} ms ({state})" for ms, state in res["drift"]))
    alone = [ms for ms, _ in res["alone_ms"]]
    spread = _spread(alone)
    print(f"  decode graph alone (Engine.decode_alone_ms: {warm['state_len']} "
          f"tokens a row, behind a busy kernel, median of 10) after the settle and "
          f"after the calibration run and score runs 1 and 2: "
          + ", ".join(f"{ms:.3f}" for ms in alone)
          + f" ms; spread {100 * spread:.2f} % ("
          + ("on the host clock" if warm["first_alone_ms"] is None else
             "one state of the card" if spread <= SETTLED else
             "MORE THAN ONE STATE: the runs are compared across states")
          + "); MiB in use on the card at each: "
          + ", ".join(f"{mib:.1f}" for _, mib in res["alone_ms"]))
    print(f"  engine self-noise (run 2 vs run 1): {_mapes(res['noise'])}")
    print(f"  DoolySim vs the engine: {_mapes(cmp)}; paper bars TTFT 5 %, "
          f"TPOT 8 %: " + ", ".join(
              f"{k} {'held' if cmp[k] <= bar else 'failed'}"
              for k, bar in PAPER_MAPE.items()))
    for key, what in (("noise", "engine run 2 vs run 1"),
                      ("sim", "DoolySim vs engine run 1")):
        t = res["ttft_split"][key]
        print(f"  admission moved, {what}: {t['n_moved']} of "
              f"{t['n_moved'] + t['n_kept']} requests (the schedules agree "
              f"for the first {t['agree']} iterations); TTFT MAPE {t['all']:.2f} "
              f"over all, " + ", ".join(
                  f"{'n/a' if t[k] is None else format(t[k], '.2f')} over the "
                  f"{t['n_' + k]} that {w}"
                  for k, w in (("kept", "kept theirs"), ("moved", "moved"))))
    parts = res["ttft_parts"]
    for key, what in (("noise", "engine run 2 vs run 1"),
                      ("sim", "DoolySim vs engine run 1")):
        print(f"  TTFT parts, {what} (error as a share of run 1's TTFT, "
              f"MAPE / mean signed %; all, kept, moved): " + "; ".join(
                  f"{part} " + ", ".join(
                      "n/a" if e is None else f"{e['mape']:.2f} / {e['bias']:+.2f}"
                      for e in (parts[key][part][k] for k in ("all", "kept", "moved")))
                  for part in ("wait", "chunks")))
    print("  iterations of engine run 1 that admitted a request, against "
          "DoolySim's price (kind, bucket of the longest chunk): " + "; ".join(
              f"{k} x{v['n']}: {v['ms']:.3f} ms measured, {v['pred_ms']:.3f} "
              f"predicted (median), MAPE {v['mape']:.2f} %, bias {v['bias']:+.2f} %"
              for k, v in sorted(parts["admitting"].items())))
    if res["mixed"]:
        _print_mixed(res["model"], res["mixed"])


def _ms(x: float) -> str:
    return f"{x * 1e3:.3f}"


def _print_mixed(model: str, mixed: dict):
    """``[12 mixed]``: for each iteration shape its five readings (a)-(e) and
    the four differences, which sum to DoolySim's error on (a); then each
    chunk bucket's rows by group, raw against fitted."""
    print(f"[12 mixed] {model}: one chunk in row 0 after {mixed['start']} cached "
          f"tokens, the decode batch beside it ({mixed['decode_len']} tokens a "
          f"row) or not; median of {mixed['repeats']} iterations, ms: (a) "
          f"execute's host clock, (b) CUDA events from the first graph's start "
          f"to the last's end [each graph's span in it], (c) the chunk graph "
          f"and the decode graph each alone, (d) the DB's raw points, (e) "
          f"DoolySim's price (overhead_s + chunk_overhead_s + chunk rows + "
          f"decode_scale x decode rows); e-d the fit's error, d-c the oracle's "
          f"against the engine's graphs, b-c the interaction, a-b the host's "
          f"(% of (a)); {mixed['s']:.1f} s")
    for sh in mixed["shapes"]:
        t, calls = sh["terms"], sh["calls"]
        d = " + ".join(_ms(calls[k]["raw"]) for k in ("chunk", "decode") if calls[k])
        diffs = [("e-d", sh["fit_error"]), ("d-c", sh["oracle_error"]),
                 ("b-c", sh["interaction"]), ("a-b", sh["host"])]
        print(f"  {'mixed' if sh['decodes'] else 'chunk'} {sh['bucket']} "
              f"{'last' if sh['last'] else 'not last'}: (a) {_ms(sh['a'])} (b) "
              f"{_ms(sh['b'])} [{', '.join(_ms(x) for x in sh['in_iteration'])}] "
              f"(c) {_ms(sh['c_chunk'])}"
              + (f" + {_ms(sh['c_decode'])}" if sh["decodes"] else "")
              + f" (d) {d} (e) {' + '.join(_ms(t[k]) for k in ('overhead', 'chunk_overhead', 'chunk', 'decode'))}"
              f" = {_ms(sh['e'])}; " + ", ".join(
                  f"{k} {x * 1e3:+.3f} ({100 * x / sh['a']:+.2f} %)" for k, x in diffs)
              + f"; e-a {100 * (sh['e'] - sh['a']) / sh['a']:+.2f} %")
    for b in sorted({sh["bucket"] for sh in mixed["shapes"]}):
        _print_rows(f"chunk {b}", next(sh["calls"]["chunk"] for sh in mixed["shapes"]
                                       if sh["bucket"] == b))
    _print_rows("decode batch", next(sh["calls"]["decode"] for sh in mixed["shapes"]
                                     if sh["decodes"]))
    for b, graphs in mixed["launch"].items():
        for k, v in graphs.items():
            if v:
                print(f"  {k} graph (bucket {b}'s readings): alone "
                      f"{_ms(mixed['alone'][b][k])} ms behind a busy kernel, "
                      f"{_ms(v['idle_s'])} ms launched on an idle card, its "
                      f"launch call {_ms(v['host_s'])} ms on the host")
    raw = mixed.get("raw")
    if raw:
        print(f"  DoolySim on the DB's raw points (the oracle backend, no fit), "
              f"calibrated on the same run ({', '.join(f'{k} {v:.6g}' for k, v in raw['fit'].items())}): "
              f"{_mapes(raw['cmp'])}; admitting iterations (kind, bucket): " + "; ".join(
                  f"{k} x{v['n']}: {v['ms']:.3f} ms measured, {v['pred_ms']:.3f} "
                  f"predicted, bias {v['bias']:+.2f} %"
                  for k, v in sorted(raw["admitting"].items())))


def _print_rows(what: str, call: dict):
    print(f"  {what} rows by group, raw / fitted ms: " + ", ".join(
        f"{g} {_ms(r)} / {_ms(f)}" for g, (r, f) in sorted(call["groups"].items()))
        + f"; {call['calls']} timed calls, {call['exact']} of {call['rows']} "
        f"rows at an exact DB key; the fit's largest row errors, ms: " + ", ".join(
            f"{w['kind']} x{w['count']} at {tuple(w['key'])} "
            f"{w['fit_minus_raw'] * 1e3:+.3f}" for w in call["worst"]))


def _scored_summary(res: dict) -> dict:
    return {"calibration": res["fit"], "noise": res["noise"], "sim": res["cmp"],
            "engine_makespans_s": [float(r["finish"][-1]) for r in res["real"]],
            "engine_iterations": res["iterations"],
            "iteration_errors": res["by_kind"],
            "decode_ms": [ms for ms, _ in res["drift"]],
            "decode_alone_ms": [ms for ms, _ in res["alone_ms"]],
            "card_mib": [mib for _, mib in res["alone_ms"]],
            "one_state": (res["warm"]["first_alone_ms"] is not None and
                          _spread([ms for ms, _ in res["alone_ms"]]) <= SETTLED),
            "captures": res["captures"],
            "warmup": res["warm"],
            "ttft_bias": _bias(res["predicted"], res["real"][0], "ttft"),
            "sim_iterations": len(res["sim_run"]["iterations"]),
            "ttft_split": res["ttft_split"], "ttft_parts": res["ttft_parts"],
            "near_floor": res["near_floor"],
            "calibration_kinds": res["calibration_kinds"], "mixed": res["mixed"]}


def phase_profile_simulate(cfgs, device, *, oracle: str, hardware: str,
                           sweep: SweepConfig, sched: SchedulerConfig,
                           max_seq: int, calibration: dict, score: dict,
                           shared_variant: str, scoring: dict,
                           config_fn, db: str, also=(), mixed: dict = None) -> dict:
    """Dooly's loop: plan and profile ``cfgs`` (the first is the served
    model), calibrate DoolySim on one engine run, then serve the score trace
    twice on the engine and predict it; then sweep the served model on that
    DB (``_sweep_scoring``; ``config_fn`` resolves its registry name).  Each
    config of ``also`` is then planned on that DB, as a user adds a model to
    a DB filled earlier in the process, profiled into it and scored the same
    way.  Last, ``cfgs``' plan is built again: it must keep its id and find
    every task measured.  Kernel counts are zeroed just before each plan's
    execution and read after its last engine run.  ``db``: where the store
    keeps its points; ``mixed``: ``[12 mixed]``'s settings, or None to skip
    it."""
    cfg = cfgs[0]
    cuda = device.type == "cuda"
    fallbacks = fingerprint.fallbacks

    def no_fallback(what: str):
        _require(fingerprint.fallbacks == fallbacks,
                 f"no fingerprint of {what} fell back ({fingerprint.fallbacks - fallbacks} "
                 f"did; the last with {fingerprint.last_error})")
    with ProfileStore(db, hardware=hardware, oracle=oracle, sweep=sweep,
                      device=device) as store:
        t0 = time.perf_counter()
        plan = store.plan(cfgs, backends=(PROFILE_BACKEND,))
        plan_s = time.perf_counter() - t0
        no_fallback("the plan")
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
        # each point is one graph replay less this floor, so a model step
        # priced from calls_per_step points has it subtracted that often
        floor_us = launch_floor(device) * 1e6 if cuda else None
        calls_per_step = sum(row.count for row in store.simulator(
            cfg, sched_config=sched, max_seq=max_seq,
            backend=PROFILE_BACKEND).latency.rows)
        if cuda:
            print(f"  cuda_events launch floor {floor_us:.3f} us a point; "
                  f"{calls_per_step} timed calls price one step of {cfg.name} "
                  f"({calls_per_step * floor_us / 1e3:.3f} ms of floor)")
        res = _engine_vs_sim(store, cfg, device, sched=sched, max_seq=max_seq,
                             calibration=calibration, score=score, mixed=mixed)
        roof = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                               latency="roofline")
        roof_run = roof.run(res["trace"]())
        roof_cmp = M.compare(M.request_metrics(roof_run["requests"]),
                             res["real"][0])
        cmp = res["cmp"]
        _require(cmp["makespan_mape"] <= MAKESPAN_MAPE_LIMIT,
                 f"makespan MAPE {cmp['makespan_mape']:.2f} <= {MAKESPAN_MAPE_LIMIT}")
        _print_scored(res, calibration, score, floor_us)
        print(f"  roofline makespan {roof_run['makespan']:.4f} s; roofline vs "
              f"the engine: {_mapes(roof_cmp)}")
        scored = _sweep_scoring(store, cfg, device, config_fn=config_fn,
                                sched=sched, max_seq=max_seq, score=score,
                                scoring=scoring, fit=res["fit"])
        counts = _counts()
        if cuda:
            _require(counts[0] > 0, "the loop launched the decode kernel")
        print(f"  kernel launches (decode, flash fwd, flash bwd, scan) over the "
              f"execution and the engine runs: {counts}")
        more = {}
        for other in also:
            t0 = time.perf_counter()
            other_plan = store.plan([other], backends=(PROFILE_BACKEND,))
            other_plan_s = time.perf_counter() - t0
            no_fallback(f"{other.name}'s plan")
            _zero_counts()
            other_cov = other_plan.coverage()
            t0 = time.perf_counter()
            other_rep = store.execute(other_plan, workers=1)
            other_s = time.perf_counter() - t0
            other_res = _engine_vs_sim(store, other, device, sched=sched,
                                       max_seq=max_seq, calibration=calibration,
                                       score=score, mixed=mixed)
            other_counts = _counts()
            print(f"[12 profile->simulate] {other.name} through the same loop "
                  f"(planned after the timing above in {other_plan_s:.1f} s): "
                  f"{len(other_plan.tasks)} tasks, "
                  f"{other_rep.measured} measured ({other_rep.satisfied} already "
                  f"in the DB), {other_rep.rows_written} points in {other_s:.1f} s; "
                  f"kernel launches (decode, flash fwd, flash bwd, scan) "
                  f"{other_counts}; {_card(device)}")
            _print_scored(other_res, calibration, score, floor_us)
            more[other.name] = {**_scored_summary(other_res),
                                "tasks": len(other_plan.tasks),
                                "plan_s": other_plan_s,
                                "planned_points": other_cov.plan_points,
                                "rows": other_rep.rows_written, "execute_s": other_s,
                                "decode_launches": other_counts[0],
                                "launches": list(other_counts)}
        # the first plan again, after every measurement and engine run of
        # this process: a resume of it must find its journal's id and
        # measure nothing
        t0 = time.perf_counter()
        again = store.plan(cfgs, backends=(PROFILE_BACKEND,))
        rebuild = {"s": time.perf_counter() - t0, "plan_id": again.plan_id,
                   "same_id": again.plan_id == plan.plan_id,
                   "todo": len(again.todo), "tasks": len(again.tasks)}
        no_fallback("the rebuilt plan")
        print(f"[12 profile->simulate] the plan of {', '.join(c.name for c in cfgs)} "
              f"built again after every measurement and engine run above, in "
              f"{rebuild['s']:.1f} s: id {again.plan_id} "
              f"({'the same' if rebuild['same_id'] else 'not ' + plan.plan_id}), "
              f"{rebuild['todo']} of {rebuild['tasks']} tasks left to measure")
        _require(rebuild["same_id"] and rebuild["todo"] == 0,
                 f"the rebuilt plan keeps its id {plan.plan_id} and measures "
                 f"nothing ({rebuild})")
    return {"coverage": cov.to_json(), "plan_s": plan_s, "execute_s": exec_s,
            "rows": rows, "spent_s": [r.spent_s for r in reports],
            "saved_s": [r.saved_s for r in reports], **_scored_summary(res),
            "roofline": roof_cmp, "roofline_makespan_s": roof_run["makespan"],
            "launch_floor_us": floor_us, "calls_per_step": calls_per_step,
            "sweep": scored, "decode_launches": counts[0]
            + sum(m["decode_launches"] for m in more.values()),
            "flash_launches": counts[1], "also": more, "rebuild": rebuild}


RESULT_TAG = "profile-simulate result: "


def profile_simulate_main() -> int:
    """Phase 12 on its own, as the parent script runs it in a fresh process;
    its result goes to the parent as one tagged JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    PHASE12_DB.parent.mkdir(parents=True, exist_ok=True)
    for old in PHASE12_DB.parent.glob(PHASE12_DB.name + "*"):
        old.unlink()
    out = phase_profile_simulate(
        [get_config(n) for n in PROFILE_MODELS], device, oracle="cuda_events",
        hardware=default_hardware(), sweep=PROFILE_SWEEP,
        sched=SCHED, max_seq=MAX_SEQ, calibration=CALIBRATION, score=SCORE,
        shared_variant=SHARED_VARIANT, scoring=SCORING, config_fn=get_config,
        db=str(PHASE12_DB), also=[get_config(MOE)], mixed=MIXED)
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


def cli_main(argv) -> int:
    """One CLI step of phase 13: runs ``repro_torch.<argv[0]>`` as
    ``python -m`` does, with ``argv[1:]`` as its arguments, then reports the
    process's kernel launches as one tagged line on standard error (standard
    output stays the CLI's own)."""
    module, sys.argv = argv[0], [f"repro_torch.{argv[0]}"] + list(argv[1:])
    code = 0
    try:
        runpy.run_module(f"repro_torch.{module}", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        print(LAUNCHES_TAG + json.dumps(_counts()), file=sys.stderr)
    return code


def _cli_start(*argv, cwd: Path, env: dict = None) -> tuple:
    """Starts this script with ``argv`` in a fresh process (``--cli MODULE
    ARGS...`` for one CLI step); returns (process, start time)."""
    return (subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              *map(str, argv)], cwd=cwd, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def _cli_wait(step: str, started: tuple, timeout: float = 900) -> dict:
    """Waits for a step ``_cli_start`` started; returns its exit code,
    output, wall seconds and kernel launches."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    wall = time.perf_counter() - t0
    tagged = [line for line in stderr.splitlines() if line.startswith(LAUNCHES_TAG)]
    if len(tagged) != 1:
        print(stdout[-4000:] + stderr[-8000:], file=sys.stderr)
        raise RuntimeError(f"CLI step {step!r} reported no kernel launches "
                           f"(exit code {proc.returncode})")
    return {"rc": proc.returncode, "stdout": stdout, "stderr": stderr,
            "wall_s": wall, "counts": json.loads(tagged[0][len(LAUNCHES_TAG):])}


def _cli(step: str, module: str, *args, cwd: Path, env: dict = None) -> dict:
    """Runs one CLI step in a fresh process (``cli_main``); returns its exit
    code, output, wall seconds and kernel launches."""
    return _cli_wait(step, _cli_start("--cli", module, *args, cwd=cwd, env=env))


def _ok(res: dict, step: str, rc: int = 0) -> dict:
    if res["rc"] != rc:
        print(res["stdout"][-4000:] + res["stderr"][-8000:], file=sys.stderr)
    _require(res["rc"] == rc, f"CLI step {step!r} exits with {rc} "
             f"(got {res['rc']})")
    return res


def _agreement(path: Path, other: Path, hardware: str, shift: dict = None) -> dict:
    """The relative differences |a - b| / b of the points that two DBs,
    filled by different processes, both hold, and the point that differs
    most: its op, (phase, toks, reqs, ctx) and both latencies in µs; the
    signatures ``path`` measured and how many of them ``other`` measured
    too, and each common signature's differences (``by_sig``).  ``shift``
    (signature -> µs) is added to ``path``'s points first."""
    shift = shift or {}
    with LatencyDB(str(path)) as a, LatencyDB(str(other)) as b:
        diffs, by_sig = [], {}
        own = set(a.measured_hashes(hardware))
        for sig in own & set(b.measured_hashes(hardware)):
            pa, pb = a.measurement_map(sig, hardware), b.measurement_map(sig, hardware)
            op = a.signature(sig)[0]
            pa = {k: v + shift.get(sig, 0.0) for k, v in pa.items()}
            mine = [(abs(pa[k] - pb[k]) / pb[k], op, list(k), pa[k], pb[k])
                    for k in pa.keys() & pb.keys()]
            by_sig[sig] = [d[0] for d in mine]
            diffs += mine
    _require(diffs, f"{path.name} and {other.name} hold common points")
    worst = max(diffs)
    return {"points": len(diffs),
            "median": float(np.median([d[0] for d in diffs])),
            "max": float(worst[0]), "worst": list(worst[1:]),
            "sigs": len(by_sig), "own_sigs": len(own), "by_sig": by_sig}


def _shared_attn(paths, variant: str) -> dict:
    """The self_attn signatures of ``variant`` (heads/kv heads/head dim,
    no window) in the merged DB ``paths[0]``: for each, the configs that use
    it and the shard DBs ``paths[1:]`` that measured it."""
    h, kv, d = map(int, variant.split("/"))
    with LatencyDB(str(paths[0])) as db:
        sigs = {}
        for sig, attrs in db.conn.execute(
                "SELECT hash, attrs FROM signatures WHERE op_name='self_attn'"):
            a = json.loads(attrs)
            if (a["n_heads"], a["n_kv_heads"], a["head_dim"], a["window"]) == (
                    h, kv, d, 0):
                sigs[sig] = {"configs": sorted(r[0] for r in db.conn.execute(
                    "SELECT DISTINCT c.model FROM model_operations o JOIN "
                    "configurations c ON c.id = o.config_id WHERE o.sig_hash=?",
                    (sig,)))}
    for sig, info in sigs.items():
        info["shards"] = []
        for i, path in enumerate(paths[1:]):
            with LatencyDB(str(path)) as db:
                if db.conn.execute("SELECT COUNT(*) FROM measurements WHERE "
                                   "sig_hash=?", (sig,)).fetchone()[0]:
                    info["shards"].append(i)
    return sigs


def phase_cli(workdir: Path, cli_args: list, device, *, models, full: bool,
              shared_variant: str, compare_db: Path) -> dict:
    """Phase 13: the profile, sweep and optimize CLIs, each step in its own
    process with ``cli_args`` (the device, hardware and oracle flags; none on
    the card, whose defaults they are) and its files under ``workdir``.  The
    points its profile measures are held against those that another process
    stored in ``compare_db`` (phase 12's)."""
    workdir.mkdir(parents=True, exist_ok=True)
    for old in workdir.iterdir():       # a journal left by an earlier run
        old.unlink()                    # would resume it
    corpus = ["--models", ",".join(models), "--backends", PROFILE_BACKEND,
              "--sweep", "quick", *(["--full"] if full else []), *cli_args]
    steps = {}

    def step(name, module, *args, rc=0):
        steps[name] = _ok(_cli(name, module, *args, cwd=workdir), name, rc)
        return steps[name]

    dry = json.loads(step("plan", "profile", "plan", *corpus, "--json", "-")["stdout"])
    hardware = dry["hardware"]
    for i in range(2):
        step(f"shard {i}", "profile", "run", *corpus, "--db", f"shard{i}.sqlite",
             "--resume", "--shards", 2, "--shard-index", i, "--json",
             f"shard{i}.json")
    shard_reports = [json.loads((workdir / f"shard{i}.json").read_text())
                     for i in range(2)]
    merged = step("merge", "profile", "merge", *corpus, "--db", "merged.sqlite",
                  "--resume", "shard0.sqlite", "shard1.sqlite",
                  "shard0.sqlite.plan-journal", "shard1.sqlite.plan-journal",
                  "--json", "merge.json")
    _require("exact, all shards merged" in merged["stdout"],
             "the merge reports exact, all shards merged")
    resume = json.loads(step("resume", "profile", "run", *corpus, "--db",
                             "merged.sqlite", "--resume", "--json", "-")["stdout"])
    _require(resume["measured"] == 0 and resume["rows_written"] == 0,
             f"a resumed run on the merged DB measures 0 ({resume['measured']})")
    step("audit", "profile", "audit", "--db", "merged.sqlite")
    with LatencyDB(str(workdir / "merged.sqlite")) as db:
        rows = db.stats()["measurements"]
        # the plan's accounting: each point at the sweep's repeats
        spent = QUICK_SWEEP.repeats * sum(
            sum(db.measurement_map(sig, hardware).values())
            for sig in db.measured_hashes(hardware)) / 1e6
    naive = resume["coverage"]["est_naive_s"]
    _require(rows == dry["plan_points"] == sum(r["rows_written"]
                                               for r in shard_reports),
             f"merged rows {rows} == the dry run's points {dry['plan_points']} "
             "== the shards' rows")
    shared = _shared_attn([workdir / "merged.sqlite", workdir / "shard0.sqlite",
                           workdir / "shard1.sqlite"], shared_variant)
    names = sorted(m["model"] for m in dry["models"])
    _require(len(shared) == 1 and all(v["configs"] == names and len(v["shards"]) == 1
                                      for v in shared.values()),
             f"the {shared_variant} self_attn task is measured once and shared "
             f"by {names} ({shared})")
    agree = _agreement(workdir / "merged.sqlite", compare_db, hardware)
    _require(agree["median"] <= AGREE_LIMIT,
             f"the points of two processes agree: median relative difference "
             f"{agree['median']:.4f} <= {AGREE_LIMIT}")
    execute = {"shard 0": shard_reports[0]["elapsed_s"],
               "shard 1": shard_reports[1]["elapsed_s"],
               "resume": resume["elapsed_s"]}
    print(f"[13 cli] profile: dry run of {', '.join(names)} on {hardware}: "
          f"{dry['plan_tasks']} tasks of {dry['naive_tasks']} "
          f"({100 * dry['dedup_frac']:.1f} % dedup), {dry['plan_points']} points; "
          f"2 shards measured {shard_reports[0]['measured']} + "
          f"{shard_reports[1]['measured']} tasks, merged {rows} rows (exact), "
          f"resume measured 0, audit clean; the {shared_variant} self_attn task "
          f"shared by both models, measured by one shard; {_card(device)}")
    print("  per process: " + "; ".join(
        f"{name} {res['wall_s']:.1f} s wall"
        + (f" ({execute[name]:.2f} s executing, {res['wall_s'] - execute[name]:.1f}"
           " s start-up and plan build)" if name in execute else "")
        for name, res in steps.items()))
    print(f"  profiling GPU-seconds at the quick sweep's {QUICK_SWEEP.repeats} "
          f"repeats a point: spent {spent:.4f} s, saved {naive - spent:.4f} s of "
          f"{naive:.4f} s that per-model profiling would spend (the resume's "
          "coverage)")
    floor = f"{launch_floor(device) * 1e6:.3f} us" if device.type == "cuda" else "none"
    op, key, us, other_us = agree["worst"]
    print(f"  the shards' points against {compare_db.name}'s, filled by another "
          f"process: {agree['points']} in common, relative difference median "
          f"{100 * agree['median']:.3f} %, max {100 * agree['max']:.3f} % "
          f"({op} at {key}: {us:.3f} against {other_us:.3f} us); cuda_events' "
          f"launch floor in this process {floor}")

    common = ["--db", "merged.sqlite", "--backends", PROFILE_BACKEND, *cli_args]
    swept = json.loads(step("sweep", "sweep", *common, "--eval-workers", 2,
                            "--json", "-")["stdout"])
    summary = swept["summary"]
    _require(summary["failed"] == 0 and summary.get("workers") == 2,
             f"the sweep evaluates every scenario on 2 workers ({summary})")
    diff = json.loads(step("sweep oracle", "sweep", *common, "--compare-latency",
                           "oracle", "--json", "-")["stdout"])["calibration_diff"]
    agg = diff["aggregate"]
    print(f"[13 cli] sweep: {summary['scenarios']} scenarios on "
          f"{summary['workers']} workers, failed 0 ({steps['sweep']['wall_s']:.1f} s "
          f"wall, profiling the smoke configs included); frontier: "
          + ", ".join(swept["frontier"]))
    print("  dooly vs oracle over the corpus: " + "; ".join(
        f"{m} mean {100 * a['mean_abs_rel_err']:.3f} %, max "
        f"{100 * a['max_abs_rel_err']:.3f} %" for m, a in agg.items()))
    plan = json.loads(step("optimize", "optimize", *common, "--json", "-")["stdout"])
    rec = plan["recommendation"]
    failed = [c["scenario"] for c in plan["candidates"]
              if c["reason"].startswith("exact tier failed")]
    _require(rec is not None and not failed
             and plan["counters"]["exact_tier"]["failed"] == 0,
             f"the optimizer recommends a candidate with no failed scenario "
             f"({failed})")
    print(f"[13 cli] optimize: {plan['counters']['candidates']} candidates, "
          f"{plan['counters']['pruned']} pruned, {plan['counters']['confirmed']} "
          f"confirmed, {plan['counters']['feasible']} feasible; recommended "
          f"{rec['scenario']} x{rec['replicas']} at cost {rec['cost']:.6g} "
          f"(TTFT p90 {rec['exact']['ttft_p90']:.6g} s, TPOT p90 "
          f"{rec['exact']['tpot_p90']:.6g} s, makespan "
          f"{rec['exact']['makespan']:.6g} s)")
    launches = [sum(res["counts"][i] for res in steps.values()) for i in range(4)]
    print(f"  kernel launches over the CLI processes (decode, flash fwd, flash "
          f"bwd, scan): {tuple(launches)}")
    return {"dry": dry, "rows": rows, "spent_s": spent, "saved_s": naive - spent,
            "agreement": agree,
            "wall_s": {k: v["wall_s"] for k, v in steps.items()},
            "execute_s": execute, "sweep": summary, "compare": agg,
            "recommendation": rec, "decode_launches": launches[0],
            "flash_launches": launches[1]}


# ---------------------------------------------------------------------------
# phase 18: the pooled profile run and its faults
# ---------------------------------------------------------------------------

def _shim_log(record: dict) -> None:
    """Appends one record to this process's file under ``$CHIP_SHIM_LOG``."""
    with open(Path(os.environ["CHIP_SHIM_LOG"]) / f"{os.getpid()}.jsonl", "a") as f:
        f.write(json.dumps(record) + "\n")


def _fires(mode: str, sig: str) -> bool:
    """A fault of ``ONE_SHOT`` fires on the first attempt only (it claims a
    marker file under ``$CHIP_FAULT_STATE``, which outlives the worker);
    the others fire on every attempt."""
    if mode not in ONE_SHOT:
        return True
    try:
        os.close(os.open(Path(os.environ["CHIP_FAULT_STATE"]) / f"{mode}-{sig}",
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    return True


def card_shim(prof, payload, cfg, backend):
    """Phase 18's ``REPRO_MEASURE_SHIM`` (``chip_smoke:card_shim``), run by
    the pool's workers inside their turn on the card.  ``$CHIP_FAULTS``
    (``mode:op,...``) makes the task of each named op fault: ``crash`` (the
    worker exits), ``hang`` (it sleeps ``$CHIP_FAULT_HANG_S``) and
    ``poison`` (a device-side assert, which leaves the CUDA context
    unusable; on the CPU an index error) on the first attempt, ``oom`` (an
    allocation of twice the device's memory) and ``garbage`` (NaN rows) on
    every attempt.  Every call that measures logs its op, its seconds, its
    span on the monotonic clock (``t0``, ``t1``: one clock for every
    process of the machine), its kernel launches, its process's launch
    floor and the card's SM clock read just after the span (``sm_mhz``,
    read-only through NVML) under ``$CHIP_SHIM_LOG``."""
    module = payload[0] == "module"
    sig, op = (payload[3], payload[1]) if module else (payload[1], payload[2].kind)
    faults = {o: m for m, o in (f.split(":") for f in
                                os.environ.get("CHIP_FAULTS", "").split(",") if f)}
    mode, dev = faults.get(op), prof.device
    if mode and _fires(mode, sig):
        _shim_log({"fault": mode, "op": op, "sig": sig})
        if mode == "crash":
            os._exit(17)
        elif mode == "hang":
            time.sleep(float(os.environ["CHIP_FAULT_HANG_S"]))
        elif mode == "poison":
            x = torch.zeros(4, device=dev)
            x[torch.full((1,), 1 << 20, device=dev)] += 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        elif mode == "oom":
            torch.empty(2 * torch.cuda.get_device_properties(dev).total_memory
                        if dev.type == "cuda" else 1 << 50,
                        dtype=torch.uint8, device=dev)
        elif mode == "garbage":
            return [(sig, prof.hardware, "prefill", 8, 1, 0, prof.oracle,
                     float("nan"))]
    t0, before = time.monotonic(), _counts()
    rows = prof.measure_payload_rows(payload, cfg, backend)
    t1 = time.monotonic()
    sm_mhz = _sm_clock() if dev.type == "cuda" else None
    sm_read_s = time.monotonic() - t1
    floor = (launch_floor(torch.device("cuda", dev.index if dev.index is not None
                                       else torch.cuda.current_device()))
             if dev.type == "cuda" else None)
    _shim_log({"op": op, "sig": sig, "s": t1 - t0, "t0": t0, "t1": t1,
               "launches": [a - b for a, b in zip(_counts(), before)],
               "floor_us": floor and floor * 1e6, "sm_mhz": sm_mhz,
               "sm_read_s": sm_read_s if sm_mhz else None})
    return rows


def _sm_clock() -> int:
    """The SM clock of the machine's first card (the one this script runs
    on) now, in MHz, read-only through NVML, the library nvidia-smi reads:
    microseconds a read, where an nvidia-smi process takes a good part of a
    second inside the worker's turn on the card."""
    if not hasattr(_sm_clock, "handle"):
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        handle = ctypes.c_void_p()
        for call, args in (("nvmlInit_v2", ()),
                           ("nvmlDeviceGetHandleByIndex_v2",
                            (ctypes.c_uint(0), ctypes.byref(handle)))):
            if getattr(nvml, call)(*args):
                raise RuntimeError(f"NVML's {call} failed")
        _sm_clock.nvml, _sm_clock.handle = nvml, handle
    mhz = ctypes.c_uint()
    if _sm_clock.nvml.nvmlDeviceGetClockInfo(_sm_clock.handle, 1,  # NVML_CLOCK_SM
                                             ctypes.byref(mhz)):
        raise RuntimeError("NVML's nvmlDeviceGetClockInfo failed")
    return mhz.value


def _shim_env(log: Path, **extra) -> dict:
    log.mkdir(parents=True, exist_ok=True)
    return {**os.environ, "REPRO_MEASURE_SHIM": SHIM, "CHIP_SHIM_LOG": str(log),
            **extra}


def _shim_records(log: Path) -> list:
    """The card shim's records under ``log``, each with its worker's pid, in
    each worker's order."""
    return [dict(json.loads(line), pid=int(f.stem)) for f in sorted(log.glob("*.jsonl"))
            for line in f.read_text().splitlines()]


def _worker_launches(records) -> list:
    """(decode, flash forward, flash backward, scan) launches in the workers."""
    return [sum(r["launches"][i] for r in records if "launches" in r)
            for i in range(4)]


def _measured_after(records, mode: str) -> list:
    """The tasks a worker measured after the fault ``mode`` fired in it."""
    out = []
    for pid in {r["pid"] for r in records if r.get("fault") == mode}:
        own = [r for r in records if r["pid"] == pid]
        first = next(i for i, r in enumerate(own) if r.get("fault") == mode)
        out += [r for r in own[first:] if "s" in r]
    return out


def _op_kind(op: str) -> str:
    return ("mm" if op in ("mm", "addmm", "bmm") else
            op if op == "self_attn" else "elementwise")


def _worker_spread(records, by_sig: dict) -> dict:
    """Each worker's median relative difference against another DB
    (``by_sig``: a signature's point differences, ``_agreement``'s) by op
    kind (``mm``-like, ``self_attn``, elementwise and the rest) and by its
    turn (the first, middle and last third of its tasks, in its order),
    with the point counts and the SM clocks it read while measuring."""
    out = {}
    for pid in sorted({r["pid"] for r in records if "s" in r}):
        own = [r for r in records if r["pid"] == pid and "s" in r]
        groups = {}
        for i, r in enumerate(own):
            diffs = by_sig.get(r["sig"], [])
            for key in ("all", _op_kind(r["op"]),
                        ("first", "middle", "last")[3 * i // len(own)] + " third"):
                groups.setdefault(key, []).extend(diffs)
        out[pid] = {"tasks": len(own),
                    "median": {k: float(np.median(v)) if v else None
                               for k, v in groups.items()},
                    "points": {k: len(v) for k, v in groups.items()},
                    "sm_mhz": sorted({r["sm_mhz"] for r in own
                                      if r.get("sm_mhz") is not None})}
    return out


def _overlaps(records) -> list:
    """The pairs of measurements by different processes whose spans on the
    card overlap: (op, pid, op, pid, seconds of overlap).  With the card
    lock held around each task's measurement there are none."""
    spans = sorted((r["t0"], r["t1"], r["pid"], r["op"]) for r in records if "t0" in r)
    out = []
    for i, (a0, a1, apid, aop) in enumerate(spans):
        for b0, b1, bpid, bop in spans[i + 1:]:
            if b0 >= a1:
                break
            if bpid != apid:
                out.append((aop, apid, bop, bpid, min(a1, b1) - b0))
    return out


def kill_run_main(argv) -> int:
    """``--kill-run ARGS --kill-after N``: ``profile run ARGS``, its plan
    built as the CLI builds it and executed through ``ProfileStore.execute``,
    which SIGKILLs its own process once N tasks have committed (their rows
    and journal records durable), as a machine that dies mid-corpus.  Prints
    the plan's id and task count first."""
    from repro_torch.profile.__main__ import _build, build_parser
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--kill-after", type=int, required=True)
    kill, rest = extra.parse_known_args(argv)
    args = build_parser().parse_args(["run", *rest])
    store, plan = _build(args)
    print(f"{PLAN_TAG}{plan.plan_id} {len(plan.todo)}", flush=True)

    def progress(task, i, n):
        if i >= kill.kill_after:
            os.kill(os.getpid(), signal.SIGKILL)
    with store:
        store.execute(plan, workers=args.workers, checkpoint=args.checkpoint,
                      progress=progress)
    return 0            # only reached when the plan has N tasks or fewer


def _deferred(checks: list):
    """A ``_require`` that records (ok, what) in ``checks`` for later, so a
    phase prints all it measured before any check fails."""
    return lambda ok, what: checks.append((bool(ok), what))


def phase_pool(workdir: Path, cli_args: list, device, *, models, full: bool,
               compare_db: Path, serial: dict) -> dict:
    """Phase 18a: ``profile run --workers 2`` over phase 13's corpus in one
    CLI process, its workers measuring through the card shim with no fault
    (it logs each task's seconds on the card and kernel launches).  Its rows
    are the dry run's points, no task fails, and its points agree with
    ``compare_db``'s (phase 12's) as phase 13's serial shards do
    (``serial``: phase 13's result)."""
    checks = []
    check = _deferred(checks)
    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    corpus = ["--models", ",".join(models), "--backends", PROFILE_BACKEND,
              "--sweep", "quick", *(["--full"] if full else []), *cli_args]
    log = workdir / "log-pool"
    res = _cli("pool", "profile", "run", *corpus, "--db", "pool.sqlite",
               "--workers", POOL_WORKERS, "--json", "pool.json", cwd=workdir,
               env=_shim_env(log))
    _ok(res, "pool")
    report = json.loads((workdir / "pool.json").read_text())
    dry, hardware = serial["dry"], serial["dry"]["hardware"]
    with LatencyDB(str(workdir / "pool.sqlite")) as db:
        rows = db.stats()["measurements"]
    agree, shards = _agreement(workdir / "pool.sqlite", compare_db, hardware), serial["agreement"]
    records = _shim_records(log)
    longest, *_ = slowest = sorted(records, key=lambda r: -r["s"])[:3]
    launches = _worker_launches(records)
    overlaps = _overlaps(records)
    # each process subtracts its own launch floor from every point: the
    # pooled points again with this process's (phase 12's) floor instead
    floors = {r["pid"]: r["floor_us"] for r in records if r.get("floor_us")}
    own_floor = launch_floor(device) * 1e6 if device.type == "cuda" else None
    rebased = (_agreement(workdir / "pool.sqlite", compare_db, hardware,
                          {r["sig"]: floors[r["pid"]] - own_floor
                           for r in records if r["pid"] in floors})
               if floors and own_floor else None)
    serial_s = serial["execute_s"]["shard 0"] + serial["execute_s"]["shard 1"]
    serial_wall = serial["wall_s"]["shard 0"] + serial["wall_s"]["shard 1"]
    print(f"[18 pool] profile run --workers {POOL_WORKERS} of {', '.join(models)}: "
          f"{report['measured']} tasks measured by {len({r['pid'] for r in records})} "
          f"workers, {rows} rows (the dry run's {dry['plan_points']} points), "
          f"{report['quarantined']} quarantined, workers {report.get('workers')}; "
          f"{_card(device)}")
    spread = _worker_spread(records, agree["by_sig"])
    print(f"  points against {compare_db.name}'s: {agree['points']} in common "
          f"({agree['sigs']} of the pooled DB's {agree['own_sigs']} signatures), "
          f"relative difference median {100 * agree['median']:.3f} %, max "
          f"{100 * agree['max']:.3f} % ({agree['worst'][0]} at {agree['worst'][1]}); "
          f"phase 13's serial shards: median {100 * shards['median']:.3f} %, max "
          f"{100 * shards['max']:.3f} %")
    print(f"  executing {report['elapsed_s']:.2f} s, {res['wall_s']:.1f} s wall; the "
          f"serial shards {serial_s:.2f} s executing ({serial_s and report['elapsed_s'] / serial_s:.3f}x), "
          f"{serial_wall:.1f} s wall; the longest tasks held the card "
          + ", ".join(f"{r['s']:.3f} s ({r['op']})" for r in slowest)
          + f"; kernel launches in the workers (decode, flash fwd, flash bwd, "
          f"scan): {tuple(launches)}")
    print(f"  launch floors: the workers' "
          + ", ".join(f"{v:.3f}" for v in floors.values())
          + (f" us, this process's (phase 12's) {own_floor:.3f} us; the pooled points "
             f"with phase 12's floor: median {100 * rebased['median']:.3f} %, max "
             f"{100 * rebased['max']:.3f} %" if rebased else " (none)")
          + f"; measurements of two workers overlapping on the card: {len(overlaps)}")
    for pid, w in spread.items():
        print(f"  worker {pid}: {w['tasks']} tasks, median relative difference "
              f"against {compare_db.name}'s (points) " + ", ".join(
                  f"{k} " + ("n/a" if w["median"].get(k) is None else
                             f"{100 * w['median'][k]:.3f} % ({w['points'][k]})")
                  for k in ("all", "mm", "self_attn", "elementwise", "first third",
                            "middle third", "last third"))
              + "; SM clock while measuring "
              + (", ".join(map(str, w["sm_mhz"])) + " MHz" if w["sm_mhz"]
                 else "not read (no card)"))
    sm_read_s = sum(r.get("sm_read_s") or 0.0 for r in records)
    if device.type == "cuda":
        print(f"  the SM clock reads took {sm_read_s:.4f} s in all")
    check(agree["sigs"] == agree["own_sigs"],
          f"every signature the pooled run measured is one {compare_db.name} "
          f"holds ({agree['sigs']} of {agree['own_sigs']})")
    check(device.type != "cuda" or not overlaps,
          f"no two workers' measurements overlap on the card "
          f"({overlaps[:3]})")
    check(report.get("workers") == POOL_WORKERS and report["quarantined"] == 0
          and report["retried"] == 0,
          f"the pooled run reports workers {POOL_WORKERS}, failed 0 ({report})")
    check(rows == report["rows_written"] == dry["plan_points"],
          f"the pooled rows {rows} == the dry run's points {dry['plan_points']}")
    check(agree["median"] <= AGREE_LIMIT,
          f"the pooled points agree with {compare_db.name}'s: median relative "
          f"difference {agree['median']:.4f} <= {AGREE_LIMIT}")
    check(device.type != "cuda" or launches[0] > 0,
          f"the decode kernel ran in the pool's workers ({launches})")
    return {"checks": checks, "agreement": agree, "serial_agreement": shards,
            "rows": rows,
            "execute_s": report["elapsed_s"], "wall_s": res["wall_s"],
            "serial_execute_s": serial_s, "serial_wall_s": serial_wall,
            "longest_s": longest["s"], "longest_op": longest["op"],
            "workers": report.get("workers"), "worker_launches": launches,
            "worker_floors_us": list(floors.values()), "own_floor_us": own_floor,
            "rebased_agreement": rebased, "overlaps": len(overlaps),
            "spread": spread, "sm_read_s": sm_read_s,
            "decode_launches": launches[0] + res["counts"][0],
            "flash_launches": launches[1] + res["counts"][1]}


def phase_pool_faults(workdir: Path, cli_args: list, device, *, model: str,
                      full: bool, compare_db: Path, hardware: str,
                      longest_s: float) -> dict:
    """Phase 18b, two runs of ``model``'s plan side by side on the card,
    taking turns on it: ``profile run --workers 2 --task-timeout T`` (T
    ``POOL_TIMEOUT_PER_LONGEST`` times 18a's longest task) with the card
    shim's faults, and a run of the same plan (``--kill-run``) SIGKILLed
    after ``KILL_AFTER`` commits, then its resume.  The one-shot faults heal, exactly the
    every-attempt tasks are quarantined, no healthy task times out or is
    quarantined, the healthy points agree with ``compare_db``'s, the
    resume measures exactly the tasks the killed run left, and no two
    processes' measurements overlap on the card."""
    checks = []
    check = _deferred(checks)
    timeout = max(POOL_TIMEOUT_MIN_S, POOL_TIMEOUT_PER_LONGEST * longest_s)
    corpus = ["--models", model, "--backends", PROFILE_BACKEND, "--sweep", "quick",
              *(["--full"] if full else []), *cli_args]
    state = workdir / "fault-state"
    state.mkdir()
    flog, klog = workdir / "log-faults", workdir / "log-kill"
    t0 = time.perf_counter()
    faults = _cli_start(
        "--cli", "profile", "run", *corpus, "--db", "faults.sqlite", "--workers",
        POOL_WORKERS, "--task-timeout", f"{timeout:.1f}", "--max-retries",
        POOL_RETRIES, "--json", "faults.json", cwd=workdir,
        env=_shim_env(flog, CHIP_FAULTS=",".join(f"{m}:{o}" for m, o in POOL_FAULTS.items()),
                      CHIP_FAULT_STATE=str(state), CHIP_FAULT_HANG_S=str(10 * timeout)))
    killed, k0 = _cli_start("--kill-run", *corpus, "--db", "kill.sqlite",
                            "--checkpoint", "kill.journal", "--kill-after",
                            KILL_AFTER, "--workers", POOL_WORKERS, cwd=workdir,
                            env=_shim_env(klog))
    kout, kerr = killed.communicate(timeout=600)
    kill_wall = time.perf_counter() - k0
    if killed.returncode != -signal.SIGKILL:
        print(kout[-4000:] + kerr[-8000:], file=sys.stderr)
    _require(killed.returncode == -signal.SIGKILL,
             f"the kill run dies by SIGKILL (exit {killed.returncode})")
    (plan_id, kill_tasks), = [line[len(PLAN_TAG):].split() for line in
                              kout.splitlines() if line.startswith(PLAN_TAG)]
    kill_tasks = int(kill_tasks)
    journaled = read_journal_state(str(workdir / "kill.journal"), plan_id)
    resumed = _ok(_cli("resume", "profile", "run", *corpus, "--db", "kill.sqlite",
                       "--checkpoint", "kill.journal", "--workers", POOL_WORKERS,
                       "--json", "-", cwd=workdir, env=_shim_env(klog)), "resume")
    resume = json.loads(resumed["stdout"])
    fres = _cli_wait("faults", faults)
    wall = time.perf_counter() - t0
    frep = json.loads((workdir / "faults.json").read_text())
    n_tasks = frep["coverage"]["plan_tasks"]
    records = _shim_records(flog)
    fired = {m: [r for r in records if r.get("fault") == m] for m in POOL_FAULTS}
    sigs = {m: {r["sig"] for r in rs} for m, rs in fired.items()}
    every = [m for m in POOL_FAULTS if m not in ONE_SHOT]
    quarantined = {tid.split(":", 1)[1]: reason for tid, reason in frep["quarantine"]}
    with LatencyDB(str(workdir / "faults.sqlite")) as db:
        measured = set(db.measured_hashes(hardware))
    after_oom = _measured_after(records, "oom")
    unusable = fres["stderr"].count(UNUSABLE)
    agree = _agreement(workdir / "faults.sqlite", compare_db, hardware)
    launches = _worker_launches(records + _shim_records(klog))
    overlaps = _overlaps(records + _shim_records(klog))
    print(f"[18 faults] {model}: {n_tasks} tasks, --workers {POOL_WORKERS} "
          f"--task-timeout {timeout:.1f} (18a's longest task x "
          f"{POOL_TIMEOUT_PER_LONGEST:g}); faults fired: "
          + ", ".join(f"{m} {len(fired[m])}x on {POOL_FAULTS[m]}" for m in POOL_FAULTS)
          + f"; report: measured {frep['measured']}, retried {frep['retried']}, "
          f"timed out {frep['timed_out']}, quarantined {frep['quarantined']} ("
          + "; ".join(f"{s[:12]}: {r[:60]}" for s, r in quarantined.items())
          + f"); workers that left an unusable context: {unusable}; {_card(device)}")
    print(f"  the healthy points against {compare_db.name}'s: {agree['points']} in "
          f"common, median {100 * agree['median']:.3f} %, max {100 * agree['max']:.3f} %; "
          f"tasks measured after an OOM in the same worker: {len(after_oom)}")
    print(f"  kill run of the same plan: SIGKILL after "
          f"{len(journaled.done)} commits (journal), "
          f"{kill_wall:.1f} s wall; resume: {resume['satisfied']} satisfied by the DB, "
          f"measured {resume['measured']} of {kill_tasks}, {resumed['wall_s']:.1f} s wall; "
          f"fault run {fres['wall_s']:.1f} s wall ({frep['elapsed_s']:.2f} s executing); "
          f"18b {wall:.1f} s; kernel launches in the workers (decode, flash fwd, "
          f"flash bwd, scan): {tuple(launches)}; measurements of two processes "
          f"overlapping on the card: {len(overlaps)}")
    check(fres["rc"] == 1, f"the fault run exits 1, as a run that quarantines "
          f"does ({fres['rc']}): {fres['stderr'][-2000:]}")
    check(all(len(fired[m]) == 1 for m in ONE_SHOT)
          and all(len(fired[m]) == POOL_RETRIES + 1 and len(sigs[m]) == 1
                  for m in every),
          f"each one-shot fault fired once and each other on every attempt "
          f"of one task ({ {m: len(r) for m, r in fired.items()} })")
    check(all(sigs[m] <= measured for m in ONE_SHOT),
          "the crashed, hung and poisoned tasks healed and were measured")
    check(set(quarantined) == set().union(*(sigs[m] for m in every))
          and all(OOM_REASON[device.type] in quarantined.get(sig, "")
                  for sig in sigs["oom"])
          and all("invalid" in quarantined.get(sig, "") for sig in sigs["garbage"]),
          f"exactly the OOM and garbage tasks are quarantined ({quarantined})")
    check(frep["timed_out"] == 1 and frep["measured"] == n_tasks - len(every)
          and frep["retried"] == len(ONE_SHOT) + POOL_RETRIES * len(every),
          "no healthy task timed out, failed or was retried (timed out "
          f"{frep['timed_out']}, retried {frep['retried']}, measured "
          f"{frep['measured']} of {n_tasks})")
    check(device.type != "cuda" or unusable == 1,
          f"the poisoned worker left once ({unusable})")
    check(after_oom, "a worker measured tasks after its OOM")
    check(agree["median"] <= AGREE_LIMIT,
          f"the fault run's healthy points agree with {compare_db.name}'s: "
          f"median {agree['median']:.4f} <= {AGREE_LIMIT}")
    check(len(journaled.done) == KILL_AFTER and not journaled.quarantined
          and resume["plan_id"] == plan_id and resume["satisfied"] == KILL_AFTER
          and resume["measured"] == kill_tasks - KILL_AFTER
          and resume["quarantined"] == 0,
          f"the resume measures exactly the {kill_tasks - KILL_AFTER} tasks the "
          f"killed run left ({resume['measured']}, satisfied {resume['satisfied']})")
    check(device.type != "cuda" or launches[0] > 0,
          f"the self_attn task ran the decode kernel in the workers ({launches})")
    check(device.type != "cuda" or not overlaps,
          f"no two processes' measurements overlap on the card ({overlaps[:3]})")
    return {"checks": checks, "timeout_s": timeout,
            "fired": {m: len(r) for m, r in fired.items()},
            "retried": frep["retried"], "timed_out": frep["timed_out"],
            "quarantined": sorted(quarantined), "agreement": agree,
            "unusable_exits": unusable, "after_oom": len(after_oom),
            "killed_after": len(journaled.done), "resume_measured": resume["measured"],
            "overlaps": len(overlaps),
            "wall_s": wall, "decode_launches": launches[0] + fres["counts"][0]
            + resumed["counts"][0],
            "flash_launches": launches[1] + fres["counts"][1] + resumed["counts"][1]}


def phase18(device, cli_args: list, *, cli: dict, compare_db: Path, full: bool = True,
            models=PROFILE_MODELS, workdir: Path = POOL_DIR) -> dict:
    """Phase 18: the pooled profile run (18a) and its faults (18b) on the
    card, against phase 12's DB (``compare_db``) and phase 13's result."""
    t0 = time.perf_counter()
    pool = phase_pool(workdir, cli_args, device, models=models, full=full,
                      compare_db=compare_db, serial=cli)
    faults = phase_pool_faults(workdir, cli_args, device, model=FAULT_MODEL,
                               full=full, compare_db=compare_db,
                               hardware=cli["dry"]["hardware"],
                               longest_s=pool["longest_s"])
    wall = time.perf_counter() - t0
    print(f"[18 end] phase 18 in {wall:.1f} s")
    for ok, what in pool["checks"] + faults["checks"]:
        _require(ok, what)
    return {"pool": pool, "faults": faults, "wall_s": wall,
            "decode_launches": pool["decode_launches"] + faults["decode_launches"],
            "flash_launches": pool["flash_launches"] + faults["flash_launches"]}


# ---------------------------------------------------------------------------
# phase 16: parallel and launch
# ---------------------------------------------------------------------------

def _dryrun_args(arch: str, shape, mesh: str) -> str:
    """``python -m repro_torch.launch.dryrun``'s arguments for one command
    (``shape`` None: every shape)."""
    return f"--arch {arch} --mesh {mesh}" + (f" --shape {shape}" if shape else "")


def phase_dryrun_start(groups, workdir: Path) -> list:
    """Starts one child process for each group of cells, all at once: each
    runs its cells one after the other (``python -m
    repro_torch.launch.dryrun``), its output in ``workdir``."""
    workdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, group in enumerate(groups):
        log = workdir / f"dryrun{i}.log"
        script = "; ".join(
            f"{sys.executable} -m repro_torch.launch.dryrun {_dryrun_args(*c)} "
            f"--out {workdir / f'dryrun{i}.jsonl'} || true" for c in group)
        for old in (log, workdir / f"dryrun{i}.jsonl"):
            old.unlink(missing_ok=True)
        env = dict(os.environ,
                   PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        procs.append((group, log, workdir / f"dryrun{i}.jsonl",
                       time.perf_counter(), subprocess.Popen(
                           ["bash", "-c", script], stdout=log.open("w"),
                           stderr=subprocess.STDOUT, env=env,
                           cwd=Path(__file__).resolve().parent)))
    return procs


def phase_dryrun_finish(procs, main_arch: str, timeout: float,
                        n_main: int = 8) -> dict:
    """Waits for the dry run's children; prints every cell's line and each
    child's wall seconds.  Fails unless ``main_arch`` has ``n_main`` cells,
    each ok or the reference's long_500k skip."""
    recs, walls = [], []
    for group, log, out, t0, proc in procs:
        try:
            proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"phase 16 dry run of {group} passed {timeout} s")
        walls.append(time.perf_counter() - t0)
        lines = [x for x in log.read_text().splitlines()
                 if re.match(r"\[(ok|skip|error)\] ", x)]
        got = [json.loads(x) for x in out.read_text().splitlines()] \
            if out.exists() else []
        _require(len(lines) == len(got) > 0,
                 f"the dry run of {group} reported its cells ({len(got)})")
        print(f"  child {len(walls)} ({len(got)} cells) in {walls[-1]:.1f} s "
              "wall:")
        for line in lines:
            print(f"    {line}")
        recs += got
    main = [r for r in recs if r["arch"] == main_arch]
    bad = [r for r in main if not (r["status"] == "ok" or (
        r["status"] == "skip" and r["shape"] == "long_500k"))]
    _require(len(main) == n_main and not bad,
             f"every {main_arch} cell is ok or the long_500k skip "
             f"({[(r['shape'], r['mesh'], r['status']) for r in bad]})")
    errors = [(r["arch"], r["shape"], r["mesh"], r["error"].splitlines()[0])
              for r in recs if r["status"] == "error"]
    return {"cells": [{k: r.get(k) for k in (
        "arch", "shape", "mesh", "status", "compile_s", "bytes_per_device",
        "peak_bytes_per_device", "roofline", "useful_flops_ratio")}
        for r in recs], "errors": errors, "wall_s": walls}


def _argmaxes(engine) -> list:
    """Wraps the engine's step functions to keep each step's argmax tokens;
    returns the list they are appended to."""
    seen = []

    def watch(step):
        def run(*a, **kw):
            logits = step(*a, **kw)
            seen.append(torch.argmax(logits, dim=-1).tolist())
            return logits
        return run
    for name in ("_chunk_graph", "_chunk_eager", "_decode_graph", "_decode_eager"):
        setattr(engine, name, watch(getattr(engine, name)))
    return seen


def phase_mesh_serving(cfg, device, mesh) -> dict:
    """The same model code on the card under a mesh: the Engine serves the
    phase-4 requests once outside and once inside ``use_mesh(mesh,
    SERVE_RULES)`` (graphs captured at the engine's warm-up, outside the
    mesh), then a prefill of PREFILL_LEN tokens each way; the tokens,
    logits and kernel launches must be equal.  The dry run's per-device
    parameter bytes on ``mesh`` must be the bytes the card holds."""
    from contextlib import nullcontext

    from repro_torch.launch.dryrun import shard_bytes, tree_shardings
    from repro_torch.parallel.sharding import SERVE_RULES, use_mesh
    engine = Engine(cfg, sched_config=SCHED, max_seq=MAX_SEQ, impl="kernel",
                    seed=0, device=device)
    seen = _argmaxes(engine)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, PREFILL_LEN))
    runs = {}
    for where in ("plain", "mesh"):
        engine.reset()
        del seen[:]
        _, requests = _requests(cfg)
        with (use_mesh(mesh, SERVE_RULES) if where == "mesh" else nullcontext()):
            _zero_counts()
            engine.run(requests)
            serve_counts = _counts()
            _zero_counts()
            logits, _ = engine.model.prefill(tokens, max_seq=MAX_SEQ,
                                             impl="kernel")
            prefill_counts = _counts()
        _require(all(r.done and r.generated == NEW_TOKENS for r in requests),
                 f"every request finished ({where})")
        runs[where] = {"tokens": [list(t) for t in seen], "serve": serve_counts,
                       "prefill": prefill_counts, "logits": logits.float().cpu(),
                       "makespan": engine.clock}
    plain, meshed = runs["plain"], runs["mesh"]
    _require(plain["tokens"] == meshed["tokens"],
             "the engine gives the same tokens under the mesh")
    _require((plain["serve"], plain["prefill"]) == (meshed["serve"],
                                                    meshed["prefill"]),
             f"the same kernel launches under the mesh ({plain['serve']}, "
             f"{plain['prefill']} vs {meshed['serve']}, {meshed['prefill']})")
    _require(torch.equal(plain["logits"], meshed["logits"]),
             "the same prefill logits under the mesh")
    if device.type == "cuda":
        _require(plain["serve"][0] > 0 and plain["prefill"][1] > 0,
                 "serving launched the decode kernel and the prefill the "
                 "flash forward")
    model = engine.model
    abstract = model.abstract_params()
    dry = shard_bytes(abstract, tree_shardings(model.param_axes(), abstract,
                                               mesh, SERVE_RULES))
    held = sum(p.nbytes for p in model.parameters())
    _require(dry == held, f"the dry run's per-device parameter bytes {dry} "
             f"== the bytes the card holds {held}")
    n_tok = sum(len(t) for t in plain["tokens"])
    print(f"[16 mesh] {cfg.name}: {len(requests)} requests served from graphs "
          f"outside and inside use_mesh({tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}, SERVE_RULES): {n_tok} step argmaxes equal; "
          f"kernel launches (decode, flash fwd, flash bwd, scan) serving "
          f"{plain['serve']} both times, prefill of {PREFILL_LEN} tokens "
          f"{plain['prefill']} both times, logits equal; makespans "
          f"{plain['makespan']:.4f} / {meshed['makespan']:.4f} s; warm-up "
          f"{engine.warmup_s:.2f} s, {len(engine.graphs)} CUDA graphs, "
          f"{engine.captures} captured after it; parameter "
          f"bytes per device {dry} (dry run on the host mesh) == {held} "
          f"(held on the card); {_card(device)}")
    out = {"decode_launches": plain["serve"][0] + meshed["serve"][0],
           "flash_launches": plain["prefill"][1] + meshed["prefill"][1],
           "serve_counts": list(plain["serve"]),
           "prefill_counts": list(plain["prefill"]),
           "param_bytes": held, "steps": len(plain["tokens"])}
    del engine, model
    _release(device)
    return out


MESH_TAG = "mesh-serving result: "


def mesh_serving_main() -> int:
    """``--mesh-serving``: phase 16b in this process, over a one-rank NCCL
    group on the card."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        out = phase_mesh_serving(get_config("llama3-8b"), device,
                                 make_host_mesh())
    finally:
        dist.destroy_process_group()
    print(MESH_TAG + json.dumps(out))
    return 0


def phase_mesh_serving_process() -> dict:
    """Runs phase 16b in a child process and returns its result."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--mesh-serving"], capture_output=True, text=True,
                         timeout=600)
    lines = run.stdout.splitlines()
    print("\n".join(line for line in lines if not line.startswith(MESH_TAG)))
    if run.returncode != 0:
        print(run.stderr[-8000:], file=sys.stderr)
        raise RuntimeError(f"phase 16b failed with exit code {run.returncode}")
    tagged = [line for line in lines if line.startswith(MESH_TAG)]
    _require(len(tagged) == 1, "phase 16b reported one result")
    return json.loads(tagged[0][len(MESH_TAG):])


def phase_comm(cfg, device, *, base_db: Path, db: Path, hardware: str,
               tps=COMM_TP) -> dict:
    """``profile_comm`` into a copy of ``base_db`` (its 54 rows' span), and
    the roofline backend's makespans of phase 12's score trace at each tp:
    a model on NVLink's data-sheet figure, not a measurement."""
    from repro_torch.parallel.roofline import NVLINK_BIDIR_BW, NVLINK_BW
    for old in db.parent.glob(db.name + "*"):
        old.unlink()
    shutil.copyfile(base_db, db)
    with ProfileStore(str(db), hardware=hardware, oracle="h100_analytical",
                      device=device) as store:
        rows = store.profile_comm()
        comm = store.db.conn.execute(
            "SELECT MIN(latency_us), MAX(latency_us), COUNT(*) FROM comm_ops "
            "WHERE topology = 'nvlink-ring'").fetchone()
        _require(rows == comm[2] == 54, f"profile_comm landed 54 rows ({rows}, "
                 f"{comm[2]})")
        spans = {}
        for tp in tps:
            trace = sharegpt_like(SCORE["n"], rate=SCORE["rate"],
                                  seed=SCORE["seed"], scale=SCORE["scale"],
                                  vocab=cfg.vocab_size)
            sim = store.simulator(cfg, sched_config=SCHED, max_seq=MAX_SEQ,
                                  latency="roofline", tp=tp)
            spans[tp] = sim.run(trace)["makespan"]
    _require(all(math.isfinite(v) and v > 0 for v in spans.values()),
             f"finite roofline makespans ({spans})")
    print(f"[16 comm] profile_comm: {rows} rows (nvlink-ring, tp (2, 4, 8) x "
          f"{COMM_TP_OPS} x 128 KiB-128 MiB) from {comm[0]:.4f} to "
          f"{comm[1]:.4f} us: a ring model on NVLink's data-sheet figure "
          f"({NVLINK_BW / 1e9:.0f} GB/s a direction, {NVLINK_BIDIR_BW / 1e9:.0f} "
          f"GB/s both), not measured")
    print(f"[16 roofline] {cfg.name}, phase 12's score trace ({SCORE['n']} "
          f"requests): RooflineBackend makespans "
          + ", ".join(f"tp {tp} {v:.6f} s" for tp, v in spans.items())
          + " (a model on the H100's data-sheet peaks and NVLink's data-sheet "
          f"figure, not a measurement; the card: {_card(device)})")
    return {"comm_rows": rows, "comm_us": [comm[0], comm[1]],
            "roofline_makespan_s": {str(k): v for k, v in spans.items()}}


def phase16(device, *, groups=None, workdir: Path = None) -> dict:
    """Phase 16: the dry run's children start first and run beside 16b (on
    the card) and 16c; the phase's wall time is printed and held to its
    limit."""
    t0 = time.perf_counter()
    groups = DRYRUN_GROUPS if groups is None else groups
    workdir = workdir or CLI_DIR.parent / "dryrun"
    procs = phase_dryrun_start(groups, workdir)
    print(f"[16 dryrun] {sum(len(g) for g in groups)} commands in "
          f"{len(groups)} child processes: {DRYRUN_MAIN} at every shape on both "
          f"meshes, every other assigned architecture at decode_32k on the "
          f"single-pod mesh, on meta over fake 256/512-rank groups; left out "
          f"(the README's CPU command): {DRYRUN_LEFT_OUT}")
    mesh = phase_mesh_serving_process()
    comm = phase_comm(get_config("llama3-8b"), device, base_db=PHASE12_DB,
                      db=PHASE16_DB, hardware=default_hardware())
    dry = phase_dryrun_finish(procs, DRYRUN_MAIN, PHASE16_LIMIT_S)
    wall = time.perf_counter() - t0
    for arch, shape, mesh_name, err in dry["errors"]:
        print(f"  error cell {arch} x {shape} ({mesh_name}): {err}")
    print(f"[16 end] phase 16 in {wall:.1f} s (limit {PHASE16_LIMIT_S} s)")
    _require(wall <= PHASE16_LIMIT_S, f"phase 16 took {wall:.1f} s")
    return {"dryrun": dry, "mesh": mesh, "comm": comm, "wall_s": wall,
            "decode_launches": mesh["decode_launches"],
            "flash_launches": mesh["flash_launches"]}


# ---------------------------------------------------------------------------
# phase 17: training across the families
# ---------------------------------------------------------------------------

def _train_family(cfg, device, opt: str, run: tuple, tag: str, seed: int = 0,
                  depth: str = "") -> tuple:
    """``run`` = (microbatches, rows, tokens a row, steps) of ``cfg`` under
    optimizer ``opt`` from a fresh model (weights from ``seed``) through
    the kernel backend with remat: the launch counts of those steps, finite
    losses and grad norms, and the step's time, rate and peak memory,
    printed under ``[tag]`` with ``depth`` (default: full depth).
    Returns (result, model, state, step function, data stream)."""
    mbs, rows, seq, steps = run
    cuda = device.type == "cuda"
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(seed))
    state = init_train_state(model, make_optimizer(opt))
    step_fn = make_train_step(model, microbatches=mbs, impl="kernel",
                              learning_rate=LEARNING_RATE,
                              optimizer=make_optimizer(opt))
    stream = TokenStream(DataConfig(cfg.vocab_size, mbs * rows, seq))
    if cuda:
        torch.cuda.synchronize(device)
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
    attn_layers = sum(d.kind != "mamba" for d in model.descs)
    calls = attn_layers * mbs * steps
    expect_bwd, expect_fwd = (calls, 2 * calls) if cuda else (0, 0)
    _require(bwd == expect_bwd and fwd == expect_fwd and decode == scan == 0,
             f"{cfg.name}: flash backward launches {bwd} == {expect_bwd} "
             f"(attention layers x microbatches x steps), forward {fwd} == "
             f"{expect_fwd} (twice that: remat), decode {decode} and scan "
             f"{scan} == 0 (training takes the plain chunked scan)")
    _require(all(np.isfinite(losses + gnorms)),
             f"{cfg.name}: every loss and grad norm is finite ({losses}, "
             f"{gnorms})")
    tokens = mbs * rows * seq
    n_params = sum(p.numel() for p in model.parameters())
    n_layer_params = sum(p.numel() for p in model.layers.parameters())
    flops = 6 * n_params * tokens + 2 * n_layer_params * tokens
    step_s = float(np.median(times[1:])) if len(times) > 1 else times[0]
    share = flops / step_s / PEAK_FLOPS[torch.bfloat16]
    card = _card(device)
    depth = depth or f"and depth ({cfg.n_layers} layers)"
    print(f"[{tag}] {cfg.name} at full width {depth}, {n_params / 1e9:.3f} B "
          f"parameters, {cfg.dtype}, {opt}, "
          f"remat, {steps} steps of {mbs} microbatch(es) of {rows} x {seq} "
          f"tokens; {card}")
    print("  loss " + " ".join(f"{x:.4f}" for x in losses))
    print("  grad_norm " + " ".join(f"{x:.4f}" for x in gnorms))
    print(f"  step {step_s:.4f} s (median after the first, host clock; first "
          f"{times[0]:.3f} s), {tokens / step_s:.0f} tokens/s, "
          f"{share * 100:.2f} % of the 989 TFLOP/s bf16 peak (6 P T + 2 "
          f"P_layers T), peak memory {peak / 2**30:.2f} GiB of "
          f"{_card_gib(device):.2f} GiB; flash launches forward {fwd}, "
          f"backward {bwd}, scan {scan}; {card}")
    out = {"model": cfg.name, "optimizer": opt, "losses": losses,
           "grad_norms": gnorms, "step_s": step_s, "first_step_s": times[0],
           "tokens_per_s": tokens / step_s, "peak_share": share,
           "peak_bytes": peak, "flash_fwd_launches": fwd,
           "flash_bwd_launches": bwd}
    return out, model, state, step_fn, stream


def _card_gib(device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.get_device_properties(device).total_memory / 2**30


def _kernel_vs_plain_grads(model, batch, tag: str,
                           reference: bool = False) -> dict:
    """One microbatch's gradients in the model's dtype through the kernels
    and through the plain attention (``xla``).  Without ``reference``,
    held: cosine >= 0.99 for every parameter tensor.  With it, also the
    gradients of a float32 copy of the same weights through the plain
    attention, and held: every tensor's relative L2 error against them
    through the kernels within GRAD_ERR_MARGIN times the plain path's, plus
    GRAD_ERR_FLOOR (the kernel's own rounding no worse than the plain
    attention's, as FlashAttention's tests hold it); the cosine is then
    printed only."""
    params = list(model.parameters())
    ref = None
    if reference:
        copy = Model(model.cfg, device=model.device, dtype=torch.float32)
        copy.load_state_dict(model.state_dict())
        ref = torch.autograd.grad(copy.loss(batch, impl="xla")[0],
                                  list(copy.parameters()))
        del copy
        _release(model.device)
    gk = torch.autograd.grad(model.loss(batch, impl="kernel")[0], params)
    gx = torch.autograd.grad(model.loss(batch, impl="xla")[0], params)
    cos = [float(F.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                     dim=0)) for a, b in zip(gk, gx)]
    out = {"min_cosine": min(cos)}
    line = (f"  one microbatch's gradients in {model.dtype}, kernel vs plain "
            f"attention: min cosine {min(cos):.6f} over {len(cos)} tensors")
    if ref is None:
        _require(min(cos) >= 0.99, f"{tag}: gradient cosine kernel vs plain "
                 f">= 0.99 for every parameter tensor (min {min(cos):.5f})")
        print(line)
        return out

    def rel(g, r):
        r = r.double()
        return float(torch.linalg.vector_norm(g.double() - r)
                     / torch.linalg.vector_norm(r).clamp(min=1e-30))
    ek = np.array([rel(g, r) for g, r in zip(gk, ref)])
    ex = np.array([rel(g, r) for g, r in zip(gx, ref)])
    ratio = ek / np.maximum(ex, 1e-30)
    worst = int(np.argmax(ratio))
    names = [n for n, _ in model.named_parameters()]
    out.update(max_err_ratio=float(ratio.max()),
               kernel_err_median=float(np.median(ek)),
               plain_err_median=float(np.median(ex)))
    _require(bool((ek <= GRAD_ERR_MARGIN * ex + GRAD_ERR_FLOOR).all()),
             f"{tag}: every gradient tensor's relative error to float32 "
             f"through the kernels within {GRAD_ERR_MARGIN} x the plain "
             f"attention's + {GRAD_ERR_FLOOR} (largest ratio "
             f"{ratio[worst]:.3f}, {names[worst]}: {ek[worst]:.4g} vs "
             f"{ex[worst]:.4g})")
    print(line + " (printed, not held: two plain attentions differ as much)")
    print(f"  against a float32 copy of the same weights, relative L2 error "
          f"per tensor: kernels median {np.median(ek):.4g}, largest "
          f"{ek.max():.4g}; plain median {np.median(ex):.4g}, largest "
          f"{ex.max():.4g}; kernel / plain median {np.median(ratio):.3f}, "
          f"largest {ratio[worst]:.3f} ({names[worst]}; held <= "
          f"{GRAD_ERR_MARGIN})")
    return out


def _checkpoint_resume(cfg, device, state, step_fn, stream, run: tuple,
                       workdir: Path) -> dict:
    """Save ``state`` with ``AsyncCheckpointer``, restore it into a fresh
    model and state, and take one step from each on the same batch: the
    losses must be equal bit for bit.  The checkpoint is deleted."""
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    saver = ckpt.AsyncCheckpointer(str(workdir))
    saver.save(state["step"], state)
    saver.wait()
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in workdir.rglob("*") if f.is_file())
    fresh = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(1))
    opt = "adafactor" if "f" in state["opt"] else "adamw"
    t0 = time.perf_counter()
    restored, at = ckpt.restore(str(workdir), init_train_state(
        fresh, make_optimizer(opt)))
    restore_s = time.perf_counter() - t0
    fresh_step = make_train_step(fresh, microbatches=run[0], impl="kernel",
                                 learning_rate=LEARNING_RATE,
                                 optimizer=make_optimizer(opt))
    batch = stream.batch_at(at)
    _, m_live = step_fn(state, batch)
    _, m_back = fresh_step(restored, batch)
    live, back = m_live["loss"].detach().cpu(), m_back["loss"].detach().cpu()
    _require(at == state["step"] - 1 and torch.equal(live, back),
             f"the step from the restored state gives the live state's loss "
             f"bit for bit ({float(live)!r} vs {float(back)!r})")
    shutil.rmtree(workdir)
    print(f"  checkpoint of the {opt} state at step {at}: {nbytes / 2**30:.3f} "
          f"GiB in {save_s:.2f} s (AsyncCheckpointer, host copy and write), "
          f"restored into a fresh model in {restore_s:.2f} s; the next step's "
          f"loss {float(live):.6f} both ways, bit for bit; deleted")
    del fresh, restored, fresh_step
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "loss": float(live)}


def phase_train_hybrid(cfg, device, run: tuple = HYBRID_RUN,
                       workdir: Path = PHASE17_DIR) -> dict:
    """``[17 hybrid]``: AdamW steps, then Adafactor steps on a fresh model
    and state; the trained model's bf16 gradients against a float32
    reference, beside the plain attention's; the checkpoint resume of the
    Adafactor state."""
    out = {}
    for opt in ("adamw", "adafactor"):
        res, model, state, step_fn, stream = _train_family(cfg, device, opt,
                                                           run, "17 hybrid")
        out[opt] = res
        if opt == "adamw":
            mb = {k: v[:run[1]] for k, v in stream.batch_at(run[3]).items()}
            del state, step_fn
            _release(device)
            res.update(_kernel_vs_plain_grads(model, mb, cfg.name,
                                              reference=True))
        else:
            out["checkpoint"] = _checkpoint_resume(cfg, device, state, step_fn,
                                                   stream, run, workdir)
            del state, step_fn
        del model
        _release(device)
    return out


def phase_train_dense(cfg, device, run: tuple = DENSE_RUN) -> dict:
    """``[17 dense]``: Adafactor steps at full width and depth, and the
    gradients against the plain attention's."""
    res, model, state, step_fn, stream = _train_family(cfg, device,
                                                       "adafactor", run,
                                                       "17 dense")
    del state, step_fn
    _release(device)
    mb = {k: v[:run[1]] for k, v in stream.batch_at(run[3]).items()}
    res.update(_kernel_vs_plain_grads(model, mb, cfg.name))
    del model
    _release(device)
    return res


def phase_examples(examples=EXAMPLES, cpu: bool = False,
                   timeout: float = 200.0) -> dict:
    """The example counterparts as child processes side by side, as a user
    runs them (``--cpu`` appended off the card): each must exit 0 and
    print its summary lines.  Returns their wall seconds."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = []
    for script, args, _ in examples:
        cmd = [sys.executable, str(root / "examples" / script)] + list(args)
        procs.append((time.perf_counter(), subprocess.Popen(
            cmd + (["--cpu"] if cpu else []), cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    walls = {}
    for (script, args, lines), (t0, proc) in zip(examples, procs):
        try:
            text, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for _, other in procs:
                other.kill()
            raise
        walls[script] = time.perf_counter() - t0
        if proc.returncode != 0:
            print(text[-8000:], file=sys.stderr)
        _require(proc.returncode == 0, f"{script} {' '.join(args)} exited 0 "
                 f"({proc.returncode})")
        missing = [x for x in lines if x not in text]
        _require(not missing, f"{script} printed its summary lines ({missing})")
        summary = [x for x in text.splitlines()
                   if any(x.strip().startswith(y.strip()[:12]) for y in lines)]
        print(f"[17 examples] {script} {' '.join(args)}: exit 0 in "
              f"{walls[script]:.1f} s; " + " | ".join(x.strip() for x in summary[:4]))
    return walls


def phase17(device, *, hybrid=None, dense=None, hybrid_run=HYBRID_RUN,
            dense_run=DENSE_RUN, examples=EXAMPLES,
            limit_s: float = PHASE17_LIMIT_S,
            workdir: Path = PHASE17_DIR) -> dict:
    """Phase 17: the hybrid and the dense model trained at full width, then
    the examples; the phase's wall time is printed and held to its
    limit."""
    t0 = time.perf_counter()
    hybrid = hybrid or get_config(TRAIN_HYBRID)
    dense = dense or get_config(TRAIN_DENSE)
    hyb = phase_train_hybrid(hybrid, device, hybrid_run, workdir)
    den = phase_train_dense(dense, device, dense_run)
    walls = phase_examples(examples, cpu=device.type != "cuda")
    wall = time.perf_counter() - t0
    print(f"[17 end] phase 17 in {wall:.1f} s (limit {limit_s} s)")
    _require(wall <= limit_s, f"phase 17 took {wall:.1f} s")
    runs = [hyb["adamw"], hyb["adafactor"], den]
    return {"hybrid": hyb, "dense": den, "examples_s": walls, "wall_s": wall,
            "flash_fwd_launches": sum(r["flash_fwd_launches"] for r in runs),
            "flash_bwd_launches": sum(r["flash_bwd_launches"] for r in runs)}


def kernels_line(kernels: dict, serving: dict, granite: dict, prefill: dict,
                 train: dict, mamba_serving: dict, mamba_prefill: dict,
                 loop: dict, cli: dict, families: dict = None,
                 plan: dict = None, phase15: dict = None,
                 phase16: dict = None, phase17: dict = None,
                 phase18: dict = None) -> dict:
    """Launches are counted on the main paths: decode while serving llama3
    (one run), granite-20b and phase 14's families (one run each), over
    phase 12's loop (olmoe-1b-7b's scoring included) and sweep scoring and
    over the CLI processes of phase 13 (and of ``plan``, a family plan's),
    the flash forward over the
    prefills (hymba-1.5b's too), the train steps, the loop and the CLIs, the
    backward over the train steps, the scan while serving falcon-mamba and
    hymba-1.5b (one run each) and over their prefills; phase 15's paths
    (``phase15``: its frontends' serving runs and prefills, the enc-dec
    prefill and decode steps, the corpus plan's CLI process) add their
    decode and flash-forward launches, and so do phase 16's serving and
    prefill under the mesh and outside it (``phase16``), and phase 17's
    train steps their flash forward and backward launches (``phase17``);
    phase 18's CLI processes and their pool workers add their decode and
    flash-forward launches (``phase18``)."""
    families, plan = families or {}, plan or {}
    fam = list(families.values())
    p15 = (list((phase15 or {}).values()) + ([phase16] if phase16 else [])
           + ([phase18] if phase18 else []))
    launches = {"decode_attention": serving["decode_launches"]
                + granite["decode_launches"] + loop["decode_launches"]
                + cli["decode_launches"] + plan.get("decode_launches", 0)
                + sum(f["decode_launches"] for f in fam + p15),
                "flash_attention_fwd": prefill["flash_launches"]
                + train["flash_fwd_launches"] + loop["flash_launches"]
                + cli["flash_launches"] + plan.get("flash_launches", 0)
                + sum(f["prefill"]["flash_launches"] for f in fam if "prefill" in f)
                + sum(f["flash_launches"] for f in p15)
                + (phase17 or {}).get("flash_fwd_launches", 0),
                "flash_attention_bwd": train["flash_bwd_launches"]
                + (phase17 or {}).get("flash_bwd_launches", 0),
                "mamba_scan": mamba_serving["scan_launches"]
                + mamba_prefill["scan_launches"]
                + sum(f["scan_launches"] + f.get("prefill", {}).get("scan_launches", 0)
                      for f in fam)}
    times = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_device_ms")
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


def phase15(frontends, device, base_db: Path) -> dict:
    """Phase 15: the two stub frontends, the enc-dec model and the corpus
    plan on a copy of ``base_db``."""
    return {"vlm": phase_frontend(frontends[0], device, "vlm"),
            "llama4": phase_frontend(frontends[1], device, "llama4",
                                     layers=LLAMA4_LAYERS,
                                     kinds=("self_attn", "moe")),
            "encdec": phase_encdec(frontends[2], device),
            "plan": phase_corpus_plan([], device, models=CORPUS_ARCHS, full=True,
                                      base_db=base_db, db=PHASE15_DB)}


def phase18_main() -> int:
    """``--phase18``: phases 1, 2, 12 (its child), 13 and 18 alone."""
    cfg, device = get_config("llama3-8b"), torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_device(cfg, device)
    phase_build(cfg, device)
    phase_profile_simulate_process()
    cli = phase_cli(CLI_DIR, [], device, models=PROFILE_MODELS, full=True,
                    shared_variant=SHARED_VARIANT, compare_db=PHASE12_DB)
    phase18(device, [], cli=cli, compare_db=PHASE12_DB)
    print(f"[end] phases 1, 2, 12, 13 and 18 passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


def phase15_main() -> int:
    """``--phase15``: phases 1-3 (the kernels at every shape, phase 15's
    included) and phase 15 alone, its plan on phase 13's merged DB."""
    base = CLI_DIR / "merged.sqlite"
    if not base.exists():
        print(f"chip_smoke --phase15: the corpus plan starts from phase 13's "
              f"{base}, which a whole run of this script leaves; none is there",
              file=sys.stderr)
        return 1
    cfg, device = get_config("llama3-8b"), torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_device(cfg, device)
    phase_build(cfg, device)
    frontends = [get_config(n) for n in (VLM, LLAMA4, SEAMLESS)]
    phase_kernels(cfg, device, family_cfgs=frontends,
                  flash_shapes=frontend_flash_shapes(*frontends))
    phase15(frontends, device, base)
    print(f"[end] phases 1-3 and 15 passed in {time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--cli"]:
        return cli_main(sys.argv[2:])
    if sys.argv[1:2] == ["--kill-run"]:
        return kill_run_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # where the interpreter's packages hold no bytecode it may read (on the
    # card's machine every process compiled ~1600 of torch's modules, ~6 s
    # of its start-up), a bytecode cache under build/ is written by the
    # first process that imports a module and read by every later one: the
    # child processes of every phase inherit the variable
    os.environ.setdefault("PYTHONPYCACHEPREFIX",
                          str(Path(__file__).resolve().parent / "build" / "pycache"))
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False
    if sys.argv[1:] == ["--profile-simulate"]:
        return profile_simulate_main()
    if sys.argv[1:] == ["--phase15"]:
        return phase15_main()
    if sys.argv[1:] == ["--mesh-serving"]:
        return mesh_serving_main()
    if sys.argv[1:] == ["--phase18"]:
        return phase18_main()
    cfg, mcfg = get_config("llama3-8b"), get_config(MAMBA)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    info = phase_device(cfg, device)
    phase_build(cfg, device)
    families = [get_config(n) for n in (MLA, MOE, HYBRID)]
    frontends = [get_config(n) for n in (VLM, LLAMA4, SEAMLESS)]
    kernels = phase_kernels(cfg, device, family_cfgs=families + frontends,
                            flash_shapes=frontend_flash_shapes(*frontends),
                            train_shapes=train_flash_shapes(
                                get_config(TRAIN_HYBRID), get_config(TRAIN_DENSE)))
    kernels.update(phase_scan(mcfg, device,
                              family_cfgs=[c for c in families if c.ssm_state]))
    ends = []                   # (last phase, seconds since the start)

    def end(phase: str):
        ends.append(f"{phase} {time.perf_counter() - t0:.1f}")
    end("3b")
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
    end("11")
    loop = phase_profile_simulate_process()
    end("12")
    cli = phase_cli(CLI_DIR, [], device, models=PROFILE_MODELS, full=True,
                    shared_variant=SHARED_VARIANT, compare_db=PHASE12_DB)
    end("13")
    served = {}
    for tag, fcfg in zip(("mla", "moe", "hybrid"), families):
        served[tag] = phase_family(fcfg, device, tag)
    end("14")
    p15 = phase15(frontends, device, CLI_DIR / "merged.sqlite")
    end("15")
    p16 = phase16(device)
    _release(device)
    end("16")
    p17 = phase17(device)
    _release(device)
    end("17")
    p18 = phase18(device, [], cli=cli, compare_db=PHASE12_DB)
    print(f"[end] all phases passed in {time.perf_counter() - t0:.1f} s (each "
          f"phase's end, s: {', '.join(ends)})")
    kernels_line(kernels, serving, granite, prefill, train, mamba_serving,
                 mamba_prefill, loop, cli, families=served, phase15=p15,
                 phase16=p16, phase17=p17, phase18=p18)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": info["kind"],
                                             "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
