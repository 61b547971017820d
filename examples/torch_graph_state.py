"""What one more CUDA graph, or one torch.profiler session, does to the time
of every other graph's kernels.

On the card this builds the serving engine for ``--model`` at full width
(``--layers`` cuts its depth), captures its chunk graph of ``--bucket``
tokens on cache row 0 as the engine does on first use, and times two of
its graphs alone, each replay queued behind a busy kernel as
``cuda_events`` times a point: the chunk graph of ``--bucket`` tokens and
the decode graph.  Then it captures ``--dummies`` graphs of
``--dummy-nodes`` trivial kernels each, one at a time and kept alive, and
times the engine's graphs again after each; then it deletes them, and last
it runs one torch.profiler session over a replay of each (which also
counts their kernels).  Each line gives both
graphs' medians, their difference from the first reading in µs a kernel
of the graph, and the dummy graph's own time.  Needs an NVIDIA GPU::

    PYTHONPATH=src python examples/torch_graph_state.py --layers 32
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import BUSY_CYCLES  # noqa: E402
from repro_torch.serving import Engine, SchedulerConfig  # noqa: E402

SCHED = SchedulerConfig(max_num_seqs=8, max_batch_tokens=512, chunk_size=256)


def graph_s(graph: torch.cuda.CUDAGraph, repeats: int) -> float:
    """Median seconds of ``repeats`` replays of ``graph``, each between two
    CUDA events queued behind a busy kernel."""
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(BUSY_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    return float(np.median(times))


def kernels(step) -> int:
    """The kernels one replay of a step graph runs, from torch.profiler."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--dummies", type=int, default=12)
    ap.add_argument("--dummy-nodes", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this example times CUDA graphs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.model)
    if args.layers:
        cfg = cfg.with_overrides(n_layers=args.layers)
    engine = Engine(cfg, sched_config=SCHED, max_seq=2048, impl="kernel",
                    device="cuda")
    steps = {"chunk": engine._step_graph(("chunk", args.bucket, 0)),
             "decode": engine.graphs[("decode",)]}
    readings = []

    def reading(what: str, extra: str = ""):
        readings.append((what, {k: graph_s(g.graph, args.repeats)
                                for k, g in steps.items()}, extra))

    reading("first reading")
    x = torch.zeros(1024, device="cuda")
    dummies = []
    for i in range(args.dummies):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(args.dummy_nodes):
                x.add_(1)
        g.replay()
        torch.cuda.synchronize()
        dummies.append(g)
        reading(f"after dummy graph {i + 1} of {args.dummy_nodes} kernels",
                f"; the dummy {graph_s(g, 3) * 1e3:.3f} ms")
    del dummies, g
    gc.collect()
    torch.cuda.synchronize()
    reading("dummies deleted")
    counts = {k: kernels(g) for k, g in steps.items()}    # one session each
    reading("after torch.profiler sessions")
    print(f"{cfg.name}, {cfg.n_layers} layers; kernels a replay: " + ", ".join(
              f"{k} {v}" for k, v in counts.items())
          + f"; {torch.cuda.get_device_name(0)}")
    first = readings[0][1]
    for what, now, extra in readings:
        print(f"  {what}: " + ", ".join(
            f"{k} {now[k] * 1e3:.3f} ms "
            f"({(now[k] - first[k]) / counts[k] * 1e6:+.3f} us a kernel)"
            for k in steps) + extra, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
