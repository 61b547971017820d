"""Find a cell's knee once, on the card: the highest arrival rate at which
the backlog does not grow through a trace.

    python3 h100bench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --fractions 0.6,0.8,1.0,1.2

One engine (the cell's configuration, scheduler and mix; the cell's rate
is ignored) first serves one trace as a burst, all requests at 0: its
requests per engine-clock second are the capacity.  Then, for each
fraction, it serves whole traces at that fraction of the capacity for
``--seconds`` of wall time and prints, per rate: TTFT p50 and p90, the
requests in the system (arrived, not finished) at each arrival over the
first and the last third of a trace's arrivals, the engine's busy share of
its clock, and the requests served.  The backlog grows where the last
third's count exceeds the first's by more than a request and the busy
share nears 1.  Prints one JSON line per rate.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import run  # noqa: E402


def in_system(reqs) -> list:
    """Requests arrived and not finished at each arrival, in arrival order."""
    order = sorted(reqs, key=lambda r: r.arrival)
    return [sum(1 for q in order[:i + 1] if q.finish_t is None or q.finish_t > r.arrival)
            for i, r in enumerate(order)]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fractions", default="0.6,0.8,1.0,1.2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run._caches()
    import numpy as np
    import torch

    from h100bench.metrics.stats import percentile, request_metrics
    from h100bench.serve import build_engine, serve
    from h100bench.traffic.generator import traces

    cell = run._load("workloads", args.workload)
    m = run._load("configs", cell["config"])["model"]
    mix = run._load("traffic", cell["traffic"])
    engine = build_engine(m, cell, args.seed, torch.device(args.device))
    run.report_engine(engine)
    burst = serve(engine, traces(mix, 1e9, args.seed, m["vocab_size"]), 0.0)
    span = max(r.finish_t for r in burst.requests)
    capacity = len(burst.requests) / span
    print(json.dumps({"burst_requests": len(burst.requests), "makespan_s": span,
                      "capacity_rps": capacity}), flush=True)
    for f in (float(x) for x in args.fractions.split(",")):
        rate = f * capacity
        win = serve(engine, traces(mix, rate, args.seed + 1, m["vocab_size"]), args.seconds)
        per = mix["trace_requests"]
        firsts, lasts = [], []
        for t in range(win.traces):
            reqs = win.requests[t * per:(t + 1) * per]
            n = in_system(reqs)
            third = max(len(n) // 3, 1)
            firsts.append(np.mean(n[:third]))
            lasts.append(np.mean(n[-third:]))
        met = request_metrics(win.requests)
        model_s = sum(r.model_s for r in win.records)
        clock = sum(max(r.finish_t for r in win.requests[t * per:(t + 1) * per])
                    for t in range(win.traces))
        print(json.dumps({
            "fraction": f, "rate_rps": rate, "traces": win.traces,
            "requests": len(win.requests), "wall_s": win.wall_s,
            "ttft_p50_ms": percentile(met["ttft"], 50) * 1e3,
            "ttft_p90_ms": percentile(met["ttft"], 90) * 1e3,
            "tpot_p90_ms": percentile(met["tpot"], 90) * 1e3,
            "in_system_first_third": float(np.mean(firsts)),
            "in_system_last_third": float(np.mean(lasts)),
            "busy_share": model_s / clock,
            "output_tok_per_s": sum(r.generated for r in win.requests) / win.wall_s}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
