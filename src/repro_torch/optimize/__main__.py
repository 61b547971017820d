"""Capacity-optimizer CLI: staged SLO-driven search over a candidate
grid, plus the optional autoscaler transient check.

    PYTHONPATH=src python -m repro_torch.optimize \
        --models llama3-8b,command-r7b --seqs 4,8 --tokens 64,128 \
        --rate 3000 --replicas 1,2,4 --slo-tpot-p90 0.0001 --json -

The candidate axes reuse the sweep CLI's vocabulary (models x scheduler
specs, one traffic forecast built from ``--workload``/``--rate`` or a
recorded ``--workload-trace``, optionally shaped with ``--shape``).
``--replicas`` adds the replica-count axis; ``--slo-ttft-p90`` /
``--slo-tpot-p90`` set the targets.  The staged search prunes with the
``--analytic-latency`` backend (roofline by default — pruned models are
never profiled), ranks survivors with ``--latency`` fits, and confirms
finalists through the exact sweep tier (``--eval-workers`` shards the
confirmation sweep).  ``--json`` follows the shared convention ('-' =
bare JSON on stdout).

``--autoscale`` additionally replays the recommended candidate's
configuration through the deterministic target-utilization autoscaler
(``--autoscale-*`` knobs) against the same — typically shaped —
workload and reports transient SLO violations.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,
                              add_json_arg, add_latency_arg, add_shape_arg,
                        add_workload_trace_arg, emit, json_to_stdout)
from repro_torch.api import ProfileStore
from repro_torch.optimize.autoscale import AutoscalePolicy, simulate_autoscale
from repro_torch.optimize.search import SLO, OptimizeSpec, Optimizer
from repro_torch.parallel.roofline import default_hardware
from repro_torch.sweep.grid import SchedSpec, WorkloadSpec, expand_grid
from repro_torch.sweep.__main__ import PROFILE_SWEEP


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.optimize",
        description="SLO-driven capacity search over a candidate grid")
    p.add_argument("--models", default="llama3-8b,command-r7b",
                   help="comma-separated config registry names")
    p.add_argument("--backends", default="xla")
    add_hardware_arg(p)
    p.add_argument("--oracle", default="cuda_events")
    add_device_arg(p)
    add_latency_arg(p)
    p.add_argument("--analytic-latency", default="roofline",
                   help="backend the analytic pruning tier prices with "
                        "(default roofline: configuration-agnostic, no "
                        "profiling needed)")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "events", "loop"),
                   help="exact-confirmation scheduling tier")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--seqs", default="4,8",
                   help="scheduler max_num_seqs axis")
    p.add_argument("--tokens", default="64,128",
                   help="scheduler max_batch_tokens axis")
    p.add_argument("--chunks", default="32",
                   help="prefill chunk_size axis")
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--workload", default="sharegpt",
                   help="traffic-forecast workload kind (sharegpt, "
                        "synthetic, sessions); ignored when "
                        "--workload-trace is given")
    p.add_argument("--n", type=int, default=48,
                   help="requests in the forecast (truncation for "
                        "--workload-trace, 0 = whole trace)")
    p.add_argument("--rate", type=float, default=2000.0,
                   help="forecast offered load, requests/s")
    p.add_argument("--seed", type=int, default=0)
    add_workload_trace_arg(p)
    p.add_argument("--warp", type=float, default=1.0,
                   help="offered-load factor for --workload-trace")
    add_shape_arg(p)
    p.add_argument("--replicas", default="1,2,4",
                   help="replica-count axis")
    p.add_argument("--slo-ttft-p90", type=float, default=None,
                   metavar="S", help="TTFT p90 target, seconds")
    p.add_argument("--slo-tpot-p90", type=float, default=None,
                   metavar="S", help="TPOT p90 target, seconds")
    p.add_argument("--top-k", type=int, default=4,
                   help="exact-confirmation batch size")
    p.add_argument("--eval-workers", type=int, default=1, metavar="N",
                   help="shard the confirmation sweep across N spawn "
                        "processes")
    p.add_argument("--oversubscribe", action="store_true",
                   help="allow --eval-workers above the cpu count")
    p.add_argument("--autoscale", action="store_true",
                   help="also replay the recommended candidate through "
                        "the deterministic autoscaler")
    p.add_argument("--autoscale-min", type=int, default=1)
    p.add_argument("--autoscale-max", type=int, default=8)
    p.add_argument("--autoscale-target", type=float, default=0.7,
                   help="autoscaler target utilization in (0, 1]")
    p.add_argument("--autoscale-up-cooldown", type=float, default=0.0)
    p.add_argument("--autoscale-down-cooldown", type=float, default=60.0)
    p.add_argument("--autoscale-interval", type=float, default=10.0)
    add_db_arg(p, help_suffix="profiles persist across runs")
    add_json_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    quiet = json_to_stdout(args)
    models = [m for m in args.models.split(",") if m]
    backends = [b for b in args.backends.split(",") if b]
    scheds = [SchedSpec(max_num_seqs=s, max_batch_tokens=t, chunk_size=c)
              for s in _ints(args.seqs) for t in _ints(args.tokens)
              for c in _ints(args.chunks)]
    if args.workload_trace:
        if len(args.workload_trace) > 1:
            print("optimize takes ONE traffic forecast; pass a single "
                  "--workload-trace", file=sys.stderr)
            return 2
        forecast = WorkloadSpec.for_trace(
            args.workload_trace[0], n=max(args.n, 0), warp=args.warp,
            shape=args.shape, seed=args.seed)
    else:
        forecast = WorkloadSpec(kind=args.workload, n=args.n,
                                rate=args.rate, seed=args.seed,
                                shape=args.shape)
    candidates = expand_grid(models, scheds, [forecast],
                             backends=backends,
                             hardware=args.hardware or default_hardware(),
                             tp=args.tp, max_seq=args.max_seq)
    slo = SLO(ttft_p90=args.slo_ttft_p90, tpot_p90=args.slo_tpot_p90)
    spec = OptimizeSpec(candidates=tuple(candidates),
                        replicas=tuple(_ints(args.replicas)),
                        slo=slo, top_k=args.top_k)
    if not quiet:
        print(f"grid: {len(spec.candidates)} candidate scenario(s) x "
              f"{len(spec.replicas)} replica count(s) = "
              f"{len(spec.points())} points, slo {slo.label()}")

    with ProfileStore(args.db, hardware=args.hardware,
                      oracle=args.oracle, sweep=PROFILE_SWEEP,
                      device=args.device) as store:
        opt = Optimizer(store, latency=args.latency,
                        analytic_latency=args.analytic_latency,
                        engine=args.engine)
        plan = opt.run(spec, workers=args.eval_workers,
                       oversubscribe=args.oversubscribe, quiet=quiet)
        payload = plan.to_json()
        table = plan.table()

        if args.autoscale:
            rec = plan.recommendation
            if rec is None:
                print("no recommendation to autoscale", file=sys.stderr)
                return 1
            scn = rec.scenario
            be = opt._backend(scn, args.latency)
            policy = AutoscalePolicy(
                min_replicas=args.autoscale_min,
                max_replicas=args.autoscale_max,
                target_utilization=args.autoscale_target,
                scale_up_cooldown=args.autoscale_up_cooldown,
                scale_down_cooldown=args.autoscale_down_cooldown,
                interval=args.autoscale_interval)
            rep = simulate_autoscale(
                opt.sweep.requests(scn.workload), scn.sched.to_config(),
                be, policy, slo, hw_price=opt._hw_price(scn), tp=scn.tp)
            payload["autoscale"] = rep.to_json()
            table += "\n\n" + rep.table()

    emit(args, payload, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
