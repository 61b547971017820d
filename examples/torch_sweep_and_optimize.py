"""Configuration search through the port's public API (`repro_torch.api`),
the counterpart of ``examples/sweep_demo.py`` and
``examples/optimize_demo.py``: profile two models into one store (their
shared GQA attention is measured once), sweep a grid of scheduler specs x
workloads against it and print the cost/latency frontier, then ask the
capacity optimizer for the cheapest (model, scheduler, replicas) that meets
a TPOT SLO.

On the card (the default) it profiles llama3-8b and command-r7b at full
width with the ``cuda_events`` oracle::

    PYTHONPATH=src python examples/torch_sweep_and_optimize.py

On the CPU it profiles the smoke configs with the ``h100_analytical``
oracle (the H100's roofline, counted on meta tensors)::

    PYTHONPATH=src python examples/torch_sweep_and_optimize.py --cpu
"""
import argparse
import math

import numpy as np

from repro_torch.api import (SLO, OptimizeSpec, ProfileStore, SchedSpec,
                             WorkloadSpec, expand_grid)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.profiler import SweepConfig
from repro_torch.sweep.__main__ import PROFILE_SWEEP

MODELS = ("llama3-8b", "command-r7b")
#: configs, profiling sweep (bracketing every point the grid asks for),
#: scheduler axes, chunk, max_seq, ShareGPT length scale and offered load
CARD = dict(configs=get_config,
            sweep=SweepConfig(toks=(8, 32, 128, 256), reqs=(1, 8),
                              ctx=(512, 2048),
                              op_points=((8, 1), (32, 1), (128, 1), (256, 1),
                                         (1, 8)), repeats=20),
            seqs=(4, 8), tokens=(256, 512), chunk=256, max_seq=2048,
            scale=0.25, rate=8.0)
CPU = dict(configs=get_smoke_config, sweep=PROFILE_SWEEP, seqs=(4, 8),
           tokens=(64, 128), chunk=32, max_seq=128, scale=0.05, rate=2000.0)


def main(cpu: bool):
    s = CPU if cpu else CARD
    configs = s["configs"]
    store_kw = (dict(hardware="cpu", oracle="h100_analytical", device="cpu")
                if cpu else {})
    with ProfileStore(sweep=s["sweep"], **store_kw) as store:
        plan = store.plan([configs(m) for m in MODELS], backends=("kernel",))
        print(plan.coverage().table())
        rep = store.execute(plan)
        print(f"measured {rep.measured} tasks, {rep.rows_written} points in "
              f"{rep.elapsed_s:.1f} s on {store.hardware}\n")

        scheds = [SchedSpec(max_num_seqs=q, max_batch_tokens=t,
                            chunk_size=s["chunk"])
                  for q in s["seqs"] for t in s["tokens"]]
        workloads = [WorkloadSpec(kind="sharegpt", n=24, rate=r, scale=s["scale"])
                     for r in (math.inf, s["rate"])]
        grid = expand_grid(MODELS, scheds, workloads, backends=("kernel",),
                           hardware=store.hardware, max_seq=s["max_seq"])
        out = store.sweep(config_fn=configs).run(grid)
        print(out.table())
        print(f"\nsummary: {out.summary}")
        print("cost/latency frontier (tpot_mean):")
        for r in out.frontier():
            print(f"  cost {r.cost:10.6f}  tpot {r.tpot_mean:.6f}  "
                  f"{r.scenario.label()}")

        # the SLO: the sweep's median TPOT p90, so that some candidates
        # meet it and some do not on either device
        slo = SLO(tpot_p90=float(np.median([r.tpot_p90 for r in out.results])))
        forecast = WorkloadSpec(kind="sharegpt", n=48, rate=s["rate"],
                                scale=s["scale"])
        spec = OptimizeSpec(
            candidates=tuple(expand_grid(MODELS, scheds, [forecast],
                                         backends=("kernel",),
                                         hardware=store.hardware,
                                         max_seq=s["max_seq"])),
            replicas=(1, 2, 4), slo=slo, top_k=4)
        print(f"\nsearching {len(spec.points())} (scenario, replicas) points "
              f"for slo {slo.label()}\n")
        cap = store.optimize(spec, config_fn=configs, quiet=False)
        print(cap.table())
        rec = cap.recommendation
        if rec is None:
            print("\nno candidate could be confirmed")
        else:
            print(f"\nrecommended: {rec.label()} at exact cost {rec.cost:.6f}"
                  f" ({'meets' if cap.feasible else 'best effort for'} the slo;"
                  f" the analytic tier pruned {cap.counters['pruned']} of "
                  f"{cap.counters['candidates']} points)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the smoke configs on the CPU, without a card")
    main(ap.parse_args().cpu)
