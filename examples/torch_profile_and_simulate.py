"""End-to-end Dooly workflow through the port's public API
(`repro_torch.api`), the counterpart of ``examples/profile_and_simulate.py``:
open a ProfileStore, plan and profile two models (watch the dedup of their
shared GQA attention), serve a trace on the port's engine, predict it with
DoolySim, and compare the pluggable latency backends (regression fits,
raw-measurement replay, the H100 roofline).

On the card (the default) it profiles llama3-8b and command-r7b at full
width with the ``cuda_events`` oracle::

    PYTHONPATH=src python examples/torch_profile_and_simulate.py

On the CPU it runs the smoke configs with the ``cpu_wallclock`` oracle::

    PYTHONPATH=src python examples/torch_profile_and_simulate.py --cpu
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.api import ProfileStore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.profiler import SweepConfig
from repro_torch.serving import Engine, SchedulerConfig
from repro_torch.sim import metrics as M
from repro_torch.workload import sharegpt_like, synthetic

#: (configs, sweep, scheduler, max_seq, trace scale) on the card and on the CPU
CARD = (get_config, SweepConfig(toks=(8, 16, 32, 64, 128, 256), reqs=(1, 8),
                                ctx=(512, 2048),
                                op_points=((8, 1), (16, 1), (32, 1), (64, 1),
                                           (128, 1), (256, 1), (1, 8)),
                                repeats=20),
        SchedulerConfig(8, 512, 256), 2048, 0.25)
CPU = (get_smoke_config, SweepConfig(toks=(8, 16, 32, 64), reqs=(1, 4),
                                     ctx=(64, 256),
                                     op_points=((8, 1), (16, 1), (32, 1),
                                                (64, 1), (1, 4))),
       SchedulerConfig(8, 128, 64), 256, 0.05)


def main(cpu: bool):
    configs, sweep, sched, max_seq, scale = CPU if cpu else CARD
    cfg, cfg2 = configs("llama3-8b"), configs("command-r7b")
    device = "cpu" if cpu else "cuda"
    store_kw = (dict(hardware="cpu", oracle="cpu_wallclock") if cpu else {})
    with ProfileStore(sweep=sweep, device=device, **store_kw) as store:
        plan = store.plan([cfg, cfg2], backends=("kernel",))
        print(plan.coverage().table())
        rep = store.execute(plan)
        print(f"measured {rep.measured} tasks, {rep.rows_written} points in "
              f"{rep.elapsed_s:.1f} s on {store.hardware}")
        for key in plan.models:
            r = plan.legacy_report(store.db, key)
            print(f"{r.model}: {r.n_new} new signatures ({r.spent_s:.4f} s), "
                  f"{r.n_reused} reused ({r.saved_s:.4f} s saved)")

        eng = Engine(cfg, sched_config=sched, max_seq=max_seq, impl="kernel",
                     device=device)
        eng.run(synthetic(4, rate=1.0, prompt_len=max_seq // 4, out_len=20,
                          seed=9, vocab=cfg.vocab_size))
        sim = store.simulator(cfg, sched_config=sched, max_seq=max_seq,
                              backend="kernel")
        print("calibration:", sim.calibrate(eng.records))

        def trace(rate=2.0):
            return sharegpt_like(20, rate=rate, seed=4, scale=scale,
                                 vocab=cfg.vocab_size)
        eng.reset()
        real = M.request_metrics(eng.run(trace())["requests"])
        simm = M.request_metrics(sim.run(trace())["requests"])
        for name, m in (("engine", real), ("sim", simm)):
            print(f"{name:6s} ttft p50/p90:",
                  [round(float(np.percentile(m["ttft"], p)), 4) for p in (50, 90)])
        print("MAPE:", {k: round(v, 1) for k, v in M.compare(simm, real).items()})

        # one recorded trace through three backends of the same seam
        plans = sim.run(trace(math.inf), record_plans=True)["plans"]
        for name in ("dooly", "oracle", "roofline"):
            be = store.backend(name, cfg, sched_config=sched, max_seq=max_seq,
                               backend="kernel")
            lat = be.predict_trace(plans)
            print(f"  backend {name:9s}: makespan {lat.sum():.4f}s over "
                  f"{len(lat)} iterations")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the smoke configs on the CPU")
    args = parser.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --cpu to run on the CPU")
    main(args.cpu)
