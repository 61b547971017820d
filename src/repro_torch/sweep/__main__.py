"""Sweep CLI: evaluate a scenario grid end-to-end against one profile
store, profiling missing (model, backend) pairs on the fly.

    PYTHONPATH=src python -m repro_torch.sweep                       # 32-scenario default grid
    PYTHONPATH=src python -m repro_torch.sweep --models llama3-8b \
        --seqs 4,8 --tokens 64,128 --rates burst,20 --json sweep.json
    PYTHONPATH=src python -m repro_torch.sweep --stream              # results as they complete

The default grid is 2 models x 2 scheduler seq limits x 2 token budgets x
2 workload kinds x 2 arrival rates = 32 scenarios; burst-arrival scenarios
evaluate by exact scheduler replay (shared across models), finite-rate
ones by the interleaved loop.  Prints per-scenario TTFT/TPOT/makespan and
the cost/latency frontier.  ``--stream`` switches to the
``Sweep.iter_results`` generator: each scenario's line prints the moment
its fit group's batched prediction completes, so huge grids emit results
incrementally instead of materializing the whole ``SweepResult`` first.
``--latency`` picks the registered latency backend (dooly / roofline /
oracle) every scenario is priced with.

Profiling is plan-first: the grid's distinct (model, backend, tp) pairs
build ONE corpus-wide ``ProfilePlan`` up front (shared signatures planned
once across the whole grid, dedup'd against the DB), whose coverage
summary prints before execution — instead of the old one-`ensure_profiled`
-per-pair loop.

``--compare-latency REF`` re-runs the grid under a second backend and
prints the calibration diff: per-scenario TTFT/TPOT/makespan relative
error of ``--latency`` against REF (e.g. ``oracle``), plus corpus-wide
mean/max — the regression-fit quality report.

``--engine`` routes staggered-arrival scenarios: ``auto``/``events``
(the default) use the event-driven engine with prefix-shared traces;
``loop`` forces the per-scenario interleaved reference loop.

``--eval-workers N`` shards the grid's evaluation units (fit groups /
trace-sharing groups) across N spawn processes, each reopening the store
read-share-safely — results stay bit-identical to serial because a
group's batched prediction never splits across workers.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import List

from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,
                              add_json_arg, add_latency_arg, add_shape_arg,
                        add_workload_trace_arg, emit, json_to_stdout)
from repro_torch.api import ProfileStore
from repro_torch.core.profiler import SweepConfig
from repro_torch.parallel.roofline import default_hardware
from repro_torch.sweep.grid import (SchedSpec, WorkloadSpec, expand_grid,
                              grid_summary)
from repro_torch.sweep.runner import SweepResult, compare_results, compare_table

PROFILE_SWEEP = SweepConfig(toks=(8, 64), reqs=(1, 2), ctx=(64, 128),
                            op_points=((8, 1), (16, 1), (64, 1), (32, 4)))


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x]


def _rates(s: str) -> List[float]:
    return [math.inf if x in ("burst", "inf") else float(x)
            for x in s.split(",") if x]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="Batch simulation across a scenario grid")
    p.add_argument("--models", default="llama3-8b,command-r7b",
                   help="comma-separated config registry names")
    p.add_argument("--backends", default="xla")
    add_hardware_arg(p)
    p.add_argument("--oracle", default="cuda_events")
    add_device_arg(p)
    add_latency_arg(p)
    p.add_argument("--engine", default="auto",
                   choices=("auto", "events", "loop"),
                   help="staggered-arrival scheduling tier: auto/events = "
                        "event-driven with prefix-shared traces, loop = "
                        "per-scenario interleaved reference loop")
    p.add_argument("--compare-latency", default=None, metavar="REF",
                   help="also run the grid under this reference backend "
                        "and print the per-scenario fit-error diff "
                        "(e.g. 'oracle')")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--seqs", default="4,8", help="scheduler max_num_seqs axis")
    p.add_argument("--tokens", default="64,128",
                   help="scheduler max_batch_tokens axis")
    p.add_argument("--chunks", default="32", help="prefill chunk_size axis")
    p.add_argument("--workloads", default=None,
                   help="comma-separated workload kinds (sharegpt, "
                        "synthetic, sessions); defaults to "
                        "'sharegpt,synthetic', or to none when "
                        "--workload-trace is given")
    p.add_argument("--n", type=int, default=24,
                   help="requests per workload (sessions per 'sessions' "
                        "workload; truncation for --workload-trace, "
                        "0 = whole trace)")
    p.add_argument("--rates", default="burst,20",
                   help="arrival rates; 'burst' = all at t=0 (exact replay)")
    p.add_argument("--seeds", default="0")
    p.add_argument("--turns", type=int, default=3,
                   help="turns per conversation for 'sessions' workloads")
    p.add_argument("--think-time", type=float, default=0.0,
                   help="gap between a conversation's turns (seconds) "
                        "for 'sessions' workloads")
    add_workload_trace_arg(p)
    p.add_argument("--warps", default="1",
                   help="offered-load factors for --workload-trace "
                        "(arrivals divide by each; 'burst' collapses "
                        "the trace to t=0)")
    add_shape_arg(p)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--metric", default="tpot_mean",
                   help="frontier latency metric (a ScenarioResult field)")
    p.add_argument("--stream", action="store_true",
                   help="print each result as its fit group completes "
                        "(Sweep.iter_results) instead of one final table")
    p.add_argument("--eval-workers", type=int, default=1, metavar="N",
                   help="shard evaluation units across N spawn processes "
                        "(clamped to cpu count and unit count; results "
                        "bit-identical to serial)")
    p.add_argument("--oversubscribe", action="store_true",
                   help="allow --eval-workers above the cpu count "
                        "(testing/benchmark escape hatch)")
    add_db_arg(p, help_suffix="profiles persist across runs")
    add_json_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # --json '-' promises bare JSON on stdout: tables/progress stay off it
    quiet = json_to_stdout(args)
    models = [m for m in args.models.split(",") if m]
    backends = [b for b in args.backends.split(",") if b]
    scheds = [SchedSpec(max_num_seqs=s, max_batch_tokens=t, chunk_size=c)
              for s in _ints(args.seqs) for t in _ints(args.tokens)
              for c in _ints(args.chunks)]
    kinds = args.workloads
    if kinds is None:
        kinds = "" if args.workload_trace else "sharegpt,synthetic"
    workloads = [WorkloadSpec(kind=k, n=args.n, rate=r, seed=seed,
                              turns=args.turns,
                              think_time=args.think_time,
                              shape=args.shape)
                 for k in kinds.split(",") if k
                 for r in _rates(args.rates)
                 for seed in _ints(args.seeds)]
    workloads += [WorkloadSpec.for_trace(path, n=max(args.n, 0), warp=w,
                                         shape=args.shape, seed=seed)
                  for path in (args.workload_trace or [])
                  for w in _rates(args.warps)
                  for seed in _ints(args.seeds)]
    if not workloads:
        print("no workloads: pass --workloads and/or --workload-trace",
              file=sys.stderr)
        return 2
    scenarios = expand_grid(models, scheds, workloads, backends=backends,
                            hardware=args.hardware or default_hardware(),
                            tp=args.tp, max_seq=args.max_seq)
    if not quiet:
        print(f"grid: {grid_summary(scenarios)}")

    with ProfileStore(args.db, hardware=args.hardware, oracle=args.oracle,
                      sweep=PROFILE_SWEEP, device=args.device) as store:
        sweep = store.sweep(latency=args.latency, engine=args.engine)
        # one corpus plan for the whole grid, not one ensure_profiled per
        # (model, backend): shared signatures are planned + measured once
        plan = sweep.profile_plan(scenarios)
        if plan is not None:
            cov = plan.coverage()
            if not quiet:
                print(f"profiling plan {plan.plan_id}: {cov.naive_tasks} "
                      f"naive -> {cov.plan_tasks} tasks "
                      f"({100 * cov.dedup_frac:.0f}% dedup, "
                      f"{cov.satisfied_tasks} satisfied, "
                      f"{cov.shared_tasks} shared)")
            rep = store.execute(plan)
            if not quiet:
                print(f"profiled {rep.models} configs: {rep.measured} "
                      f"tasks, {rep.rows_written} rows in "
                      f"{rep.elapsed_s:.2f}s")
        workers_kw = dict(workers=args.eval_workers,
                          oversubscribe=args.oversubscribe)
        if args.stream:
            results = []
            for r in sweep.iter_results(scenarios, **workers_kw):
                results.append(r)
                if not quiet:
                    print(f"[{len(results):4d}/{len(scenarios)}] "
                          f"{r.scenario.label():58s} {r.mode:12s} "
                          f"makespan {r.makespan:9.4f}  tpot.p50 "
                          f"{r.tpot_p50:9.4f}  cost {r.cost:8.3f}")
            out = SweepResult(
                results=sorted(results, key=lambda r: r.index),
                summary=dict(sweep.last_summary),
                failures=list(sweep.last_failures))
        else:
            out = sweep.run(scenarios, **workers_kw)

        diff = None
        if args.compare_latency:
            ref_sweep = store.sweep(latency=args.compare_latency)
            ref = ref_sweep.run(scenarios)
            diff = compare_results(out, ref)

    if not quiet:
        if not args.stream:
            print(out.table(args.metric))
        if out.failures:
            print(f"\n{len(out.failures)} scenario(s) failed:")
            print(out.failure_table())
        if out.summary.get("degraded"):
            print(f"\n{out.summary['degraded']} scenario(s) priced by a "
                  "degraded (fallback) backend")
        print(f"\nsummary: {out.summary}")
        front = out.frontier(args.metric)
        print(f"cost/latency frontier ({args.metric}):")
        for r in front:
            print(f"  cost {r.cost:8.3f}  {args.metric} "
                  f"{getattr(r, args.metric):.5f}  {r.scenario.label()}")
        if diff is not None:
            print(f"\ncalibration diff: {args.latency} vs "
                  f"{args.compare_latency} (reference)")
            print(compare_table(diff))
    if args.json:
        payload = out.to_json(metric=args.metric)
        if diff is not None:
            payload["calibration_diff"] = diff
        emit(args, payload, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
