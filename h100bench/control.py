"""Readings that set a cell's limit, on the card at the cell's own size.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds <s>

One engine serves, for each seed, that seed's weights (loaded in place)
and traffic for ``--seconds`` of wall time at the cell's load, and the
check reads the widest logit gap of its served tokens against the float32
reference, as a run does (``check.served_gap``): the lower reading is the
largest over the seeds.  For each control seed the control is read too:
the reference computed with every matrix in float8 e4m3, at the same
positions (``check.control_gap``): the upper reading is the smallest.
Prints one JSON line per seed, then both readings.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--witness-all", action="store_true")
    args = ap.parse_args(argv)
    run._caches()
    import torch
    if args.capacity_factor is not None:
        from repro_torch.models import moe

        from h100bench.reference import decoder
        moe.CAPACITY_FACTOR = decoder.CAPACITY_FACTOR = args.capacity_factor

    from h100bench import check, weights
    from h100bench.serve import build_engine, serve
    from h100bench.traffic.generator import traces

    cell = run._load("workloads", args.workload)
    m = run._load("configs", cell["config"])["model"]
    mix = run._load("traffic", cell["traffic"])
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    engine = build_engine(m, cell, seeds[0], device)
    run.report_engine(engine)
    names = ("logit_gap", "mean_logit_gap", "token_mismatch_pct",
             "gap_over_0.1_pct", "gap_over_0.2_pct")
    lower = dict.fromkeys(names, 0.0)
    upper = dict.fromkeys(names, float("inf"))
    for seed in seeds:
        if seed != seeds[0]:
            engine.model.load_state_dict(weights.state_dict(m, seed, device))
        engine.chunk_log.clear()
        engine._emitted.clear()
        win = serve(engine, traces(mix, cell["rate_rps"], seed, m["vocab_size"]),
                    args.seconds)
        emitted = engine.emitted()
        picked = check.sample(win.requests, emitted, cell["check"]["requests"], seed)
        t0 = time.perf_counter()
        ref, gap, missing = check.served_gaps(m, seed, picked, emitted,
                                              engine.chunk_log, device)
        got = check.readings(torch.cat(gap))
        row = {"seed": seed, "requests": len(win.requests), "sampled": len(picked),
               "missing": missing, **got, "reference_s": time.perf_counter() - t0,
               "prefill": check.readings(torch.stack([g[0] for g in gap])),
               "decode": check.readings(torch.cat([g[1:] for g in gap]))}
        for n in names:
            lower[n] = max(lower[n], got[n])
        if seed in controls or args.witness_all:
            row["bf16_witness"] = check.lower_precision(m, seed, picked, engine.chunk_log,
                                                        device, ref, "bf16")
        if seed in controls:
            t0 = time.perf_counter()
            row["control"] = check.lower_precision(m, seed, picked, engine.chunk_log,
                                                   device, ref, "fp8")
            row["control_s"] = time.perf_counter() - t0
            for n in names:
                upper[n] = min(upper[n], row["control"][n])
        del ref
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "seeds": len(seeds), "control_seeds": len(controls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
