"""Quickstart on the port: trace a model with the Tainted Runner, inspect
the taint labels, resolve the runnable set, and profile it into a latency
database.  The counterpart of ``examples/quickstart.py``.

On the card (the default) the runnable set is measured by the
``cuda_events`` oracle::

    PYTHONPATH=src python examples/torch_quickstart.py [--arch yi-9b]

On the CPU it is priced by the ``h100_analytical`` oracle (the H100's
roofline, counted on meta tensors)::

    PYTHONPATH=src python examples/torch_quickstart.py --cpu
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.opset import ModuleEntry, OpEntry, find_runnable_set
from repro_torch.core.profiler import QUICK_SWEEP, DoolyProf
from repro_torch.core.runner import trace_model


def main(arch: str, cpu: bool):
    cfg = get_smoke_config(arch)
    device = "cpu" if cpu else "cuda"

    # 1. single abstract inference pass with a dummy prompt (§4)
    mt = trace_model(cfg)
    print(f"traced {cfg.name}: {len(mt.trace.ops)} ops, "
          f"dummy prompt b={mt.batch} s={mt.seq}, {mt.retraces} retraces")
    for op in mt.trace.ops[:6]:
        taints = ["".join(str(t) for t in ts) for ts in op.out_taints]
        print(f"  {op.prim:16s} {op.name_stack:40s} "
              f"{list(zip(op.out_shapes, taints))}")

    # 2. bottom-up resolution into the runnable set (§5)
    entries = find_runnable_set(mt.trace, device=device)
    ops = [e for e in entries if isinstance(e, OpEntry)]
    mods = [e for e in entries if isinstance(e, ModuleEntry)]
    print(f"\nrunnable set: {len(ops)} operator entries, "
          f"{len(mods)} stateful module entries "
          f"({[m.kind for m in mods]})")

    # 3. duplication-aware profiling into the latency DB (§6)
    kw = (dict(oracle="h100_analytical", hardware="cpu") if cpu
          else dict(oracle="cuda_events"))
    with LatencyDB() as db:
        prof = DoolyProf(db, sweep=QUICK_SWEEP, device=device, **kw)
        rep = prof.profile_model(cfg, backend="kernel", trace=mt)
        print(f"\nprofiled on {prof.hardware} ({prof.oracle}): {rep.n_new} "
              f"new signatures, {rep.n_reused} reused, {rep.spent_s:.3f}s "
              "spent")
        print("db:", db.stats())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the h100_analytical oracle")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --cpu to run on the CPU")
    main(args.arch, args.cpu)
