"""Trace-driven workloads through the port's public API: record a serving
trace, sweep it under load warps and traffic shapes, and watch the prefix
cache pay for multi-turn sessions.  The counterpart of
``examples/trace_sweep_demo.py``.

Saves a synthetic multi-turn session trace in the ``dooly-trace`` JSONL
format (``save_trace`` returns its content hash), then evaluates one
profiled model against:

* the trace as recorded, and time-warped to 2x / 4x offered load
  (``WorkloadSpec.for_trace`` pins the trace's content hash into every
  sweep cache key);
* the trace under a diurnal traffic shape (deterministic time-change —
  same requests, same lengths, different arrival clustering);
* a file-less ``sessions`` workload with the prefix cache on vs off,
  showing cache hits in the metrics and the TTFT they buy.

On the card (the default) the model is profiled by ``cuda_events``; with
``--cpu`` by the ``h100_analytical`` oracle on the CPU::

    PYTHONPATH=src python examples/torch_trace_sweep_demo.py [--cpu]
"""
import argparse
import os
import tempfile

import torch

from repro_torch.api import (ProfileStore, SchedSpec, WorkloadSpec,
                             expand_grid, load_trace, save_trace, to_requests)
from repro_torch.configs import get_smoke_config
from repro_torch.core.profiler import SweepConfig
from repro_torch.workload import synthetic_session_rows

MODEL = "llama3-8b"
BACKEND = "kernel"
PROFILE_SWEEP = SweepConfig(toks=(8, 64), reqs=(1, 2), ctx=(64, 128),
                            op_points=((8, 1), (16, 1), (64, 1), (32, 4)))


def main(cpu: bool):
    kw = (dict(hardware="cpu", oracle="h100_analytical", device="cpu") if cpu
          else dict(oracle="cuda_events"))
    with ProfileStore(sweep=PROFILE_SWEEP, **kw) as store:
        rep = store.ensure_profiled(get_smoke_config(MODEL), backend=BACKEND)
        print(f"profiled {MODEL} on {store.hardware}: {rep.n_new} new "
              "signatures")

        # -- record a trace: 6 conversations, 3 turns each --------------
        rows = synthetic_session_rows(6, rate=10.0, turns=3, prompt_len=24,
                                      out_len=6, think_time=0.25, seed=0)
        path = os.path.join(tempfile.mkdtemp(), "sessions.jsonl")
        digest = save_trace(path, rows)
        print(f"saved {len(rows)}-row trace -> {path}\n"
              f"  trace_key {digest[:16]}… (pinned into every sweep key)")

        # round-trip is bit-identical: same rows, same key, same requests
        assert load_trace(path) == rows
        reqs = to_requests(rows)
        shared = sum(r.cached_prefix for r in reqs)
        print(f"  {len(reqs)} requests, {shared} prompt tokens arrive "
              "with a cached prefix")

        # -- sweep: recorded load, warped load, shaped load ---------------
        sched = SchedSpec(max_num_seqs=4, max_batch_tokens=64, chunk_size=32)
        grid_kw = dict(backends=(BACKEND,), hardware=store.hardware)
        workloads = [
            WorkloadSpec.for_trace(path),                  # as recorded
            WorkloadSpec.for_trace(path, warp=2.0),        # 2x offered load
            WorkloadSpec.for_trace(path, warp=4.0),        # 4x offered load
            WorkloadSpec.for_trace(path,                   # diurnal shaping
                                   shape="diurnal:period=2,amplitude=0.9"),
        ]
        out = store.sweep().run(expand_grid([MODEL], [sched], workloads,
                                            **grid_kw))
        print("\ntrace under load warps and shapes:")
        for r in out.results:
            print(f"  {r.scenario.workload.label():44s} "
                  f"makespan {r.makespan:8.5f}s  ttft_p90 {r.ttft_p90:.6f}  "
                  f"cache hits {r.cache_hit_tokens}")

        # -- prefix cache on vs off -------------------------------------
        sessions = WorkloadSpec(kind="sessions", n=6, rate=10.0, turns=3,
                                prompt_len=24, out_len=6, think_time=0.25)
        grid = expand_grid(
            [MODEL], [sched, SchedSpec(max_num_seqs=4, max_batch_tokens=64,
                                       chunk_size=32, prefix_caching=False)],
            [sessions], **grid_kw)
        out = store.sweep().run(grid)
        print("\nmulti-turn sessions, prefix cache on vs off:")
        for r in out.results:
            cache = "on " if r.scenario.sched.prefix_caching else "off"
            print(f"  cache {cache}  ttft_mean {r.ttft_mean:.6f}  "
                  f"hits {r.cache_hit_tokens:4d}  ({r.mode})")
        on, off = out.results
        if not on.scenario.sched.prefix_caching:
            on, off = off, on
        assert on.cache_hit_tokens > 0 and off.cache_hit_tokens == 0
        assert on.ttft_mean < off.ttft_mean
        print("  -> cached prefixes skip prefill work; TTFT strictly improves")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the h100_analytical oracle")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --cpu to run on the CPU")
    main(args.cpu)
