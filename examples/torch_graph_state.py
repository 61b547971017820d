"""What the serving engine's own events, more CUDA graphs, or one
torch.profiler session do to the time of every other graph's kernels.

On the card this builds the serving engine for ``--model`` at full width
(``--layers`` cuts its depth) and takes readings of two of its graphs: each
alone, each replay queued behind a busy kernel as ``cuda_events`` times a
point, the chunk graph of ``--bucket`` tokens on cache row 0 and the decode
graph.  The first reading comes right after the engine is built (an engine
that has no chunk graph of ``--bucket`` tokens after warm-up gets it first,
captured, launched and its row put back, as on first use).  ``--settle``
then runs steps that capture nothing, a reading after each: ``idle`` (the
card idle for 2 s), ``busy`` (one kernel for about 5 s), ``replay`` (every
graph of the engine replayed once more), ``load`` (the decode graph
replayed back to back for 1 s, as ``Engine.decode_alone_ms`` does before
each of ``Engine.settle``'s readings).  Then a reading after each event that an engine capturing chunk
graphs on first use meets while serving, for each of ``--events`` more
chunk graphs of the engine's own step (buckets 8 to 128 on row 1, then
row 2, ...; kept alive):

- ``capture B@R``: the chunk step of B tokens on cache row R captured in a
  graph through the engine's ``_capture`` (nothing runs on the card);
- ``row cloned``: the row's tensors copied aside;
- ``first launch``: the graph's first replay, which uploads it to the card
  and writes the row;
- ``row restored``: the copies written back into the row;

then one after ``torch.cuda.empty_cache()``, which a process calls between
models.  Then probes that change what the card maps, ``--probes`` times
each with a reading after each: 64 MiB allocated on the card, 64 MiB of
pinned host memory, a 64 MiB copy from pageable host memory, an
``nvidia-smi`` query, 1000 CUDA events; then they are freed.  With
``--serve`` the engine then serves phase 12's calibration trace and its
score trace twice, with a reading of the decode graph alone after every
iteration.  Then it captures
``--dummies`` graphs of ``--dummy-nodes`` trivial kernels each, one at a
time, kept alive and launched once, with a reading after each; then it
deletes them and the extra chunk graphs, and last it runs one
torch.profiler session over a replay of each engine graph (which also
counts their kernels).

Each reading line gives both graphs' medians, their difference from the
first reading in µs a kernel of the graph, and in brackets how far the
caching allocator's reserved bytes and the card's used bytes (as the
CUDA driver counts them) moved since the reading before.  The next line names
the events after which the decode graph moved by more than 0.1 µs a
kernel from the reading before; with ``--serve``, each trace's decode
readings and the iterations after which it moved follow.  Needs an
NVIDIA GPU::

    PYTHONPATH=src python examples/torch_graph_state.py --serve
"""
from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backends import BUSY_CYCLES  # noqa: E402
from repro_torch.serving import Engine, SchedulerConfig  # noqa: E402

SCHED = SchedulerConfig(max_num_seqs=8, max_batch_tokens=512, chunk_size=256)
EVENT_BUCKETS = (8, 16, 32, 64, 128)
MOVED_US = 0.1


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


def chunk_capture(engine: Engine, length: int, slot: int):
    """The engine's chunk step of ``length`` tokens on cache row ``slot``,
    captured through ``Engine._capture`` (nothing runs); with the row's
    views."""
    key = ("chunk", length, slot)
    return engine._capture(key, *engine._step(key)), engine._row_cache(slot)


def first_use(engine: Engine, length: int, slot: int, reading=None) -> object:
    """Capture a chunk graph, clone its row, launch it once and put the row
    back, calling ``reading(what)`` after each of the four events."""
    note = reading or (lambda what: None)
    g, row = chunk_capture(engine, length, slot)
    note(f"capture {length}@{slot}")
    saved = [{k: t.clone() for k, t in c.items()} for c in row]
    torch.cuda.synchronize()
    note("  row cloned")
    g.graph.replay()
    torch.cuda.synchronize()
    note("  first launch")
    for c, kept in zip(row, saved):
        for k, t in c.items():
            t.copy_(kept[k])
    torch.cuda.synchronize()
    note("  row restored")
    return g


def memory() -> tuple:
    """(bytes the caching allocator holds, bytes in use on the card as the
    CUDA driver counts them, graphs and modules included)."""
    free, total = torch.cuda.mem_get_info()
    return torch.cuda.memory_reserved(), total - free


def probes(reading, times: int):
    """``times`` of each: a 64 MiB tensor allocated on the card (kept), 64
    MiB of pinned host memory (kept), 64 MiB copied from pageable host
    memory, one ``nvidia-smi`` query (as phase 12 reads the card after each
    run), 1000 CUDA events created and recorded; a reading after each;
    then all of it freed and the cache emptied."""
    kept, mib = [], 64 << 20
    for i in range(times):
        kept.append(torch.empty(mib, dtype=torch.uint8, device="cuda"))
        reading(f"allocate 64 MiB on the card ({i + 1})")
    for i in range(times):
        kept.append(torch.empty(mib, dtype=torch.uint8, pin_memory=True))
        reading(f"pin 64 MiB of host memory ({i + 1})")
    for i in range(times):
        kept[0].copy_(torch.full((mib,), i, dtype=torch.uint8))
        torch.cuda.synchronize()
        reading(f"copy 64 MiB from pageable host memory ({i + 1})")
    for i in range(times):
        subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                        "temperature.gpu", "--format=csv,noheader"],
                       capture_output=True, check=True, timeout=60)
        reading(f"nvidia-smi reads the clock, power and temperature ({i + 1})")
    for i in range(times):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(1000)]
        for e in events:
            e.record()
        torch.cuda.synchronize()
        kept.append(events)
        reading(f"create and record 1000 CUDA events ({i + 1})")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    reading("probes freed, cache emptied")


def _load(engine: Engine):
    """The decode graph replayed back to back for 1 s, as
    ``Engine.decode_alone_ms`` does before it times the graph."""
    graph, t0 = engine.graphs[("decode",)].graph, time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()


def _replay_all(engine: Engine):
    for g in engine.graphs.values():
        g.graph.replay()
    engine.reset()          # the chunk graphs wrote their rows


#: steps that capture nothing: the card idle for 2 s, busy for about 5 s
#: in one kernel, every graph of the engine replayed once more, the decode
#: graph replayed back to back for 1 s (``Engine.settle``)
SETTLE = {"idle": lambda engine: time.sleep(2.0),
          "busy": lambda engine: (torch.cuda._sleep(10_000 * BUSY_CYCLES),
                                  torch.cuda.synchronize()),
          "replay": _replay_all, "load": _load}


def serve(engine: Engine, decode, repeats: int) -> list:
    """Serve phase 12's calibration trace, then its score trace twice
    (``Engine.reset`` before each), reading the decode graph alone after
    every iteration.  A reading replays the graph on the inputs of the
    last decode step, which rewrites cache slots with what that step wrote
    there, or with stale values where a row was reused; no output of the
    engine is read.
    Returns (trace, iteration, what it ran, seconds, memory()) a reading."""
    from repro_torch.workload import sharegpt_like, synthetic
    vocab = engine.cfg.vocab_size
    traces = [("calibration", synthetic(4, rate=1.0, prompt_len=512, out_len=32,
                                        seed=9, vocab=vocab))]
    traces += [(f"score {i}", sharegpt_like(32, rate=4.0, seed=4, scale=0.25,
                                            vocab=vocab)) for i in (1, 2)]
    seen, log = set(), []
    execute = engine.execute
    for name, trace in traces:
        def timed(plan, name=name):
            out = execute(plan)
            keys = [("chunk", engine._chunk_len(c), c.req.slot)
                    for c in plan.prefills]
            what = ", ".join(f"chunk {k[1]}@{k[2]}"
                             + (" (first)" if k not in seen else "")
                             for k in keys) or "decode only"
            if plan.decodes and ("decode",) not in seen:
                what += ", first decode"
            seen.update(keys + ([("decode",)] if plan.decodes else []))
            log.append((name, len(engine.records), what,
                        graph_s(decode.graph, repeats), memory()))
            return out
        engine.reset()
        engine.execute = timed
        engine.run(trace)
    engine.execute = execute
    engine.reset()
    return log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--events", type=int, default=4,
                    help="chunk graphs captured, each with its four events")
    ap.add_argument("--settle", default="",
                    help="comma-separated steps run right after the engine is "
                         f"built, a reading after each: {', '.join(SETTLE)}")
    ap.add_argument("--probes", type=int, default=4,
                    help="times each probe runs (0: none)")
    ap.add_argument("--serve", action="store_true",
                    help="serve phase 12's traces, a reading after every iteration")
    ap.add_argument("--dummies", type=int, default=4)
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
    key = ("chunk", args.bucket, 0)
    built = (f"engine built ({len(engine.graphs)} graphs after warm-up, "
             f"{engine.warmup_s:.2f} s)")
    steps = {"chunk": engine.graphs.get(key) or first_use(engine, args.bucket, 0),
             "decode": engine.graphs[("decode",)]}
    readings = []

    def reading(what: str, extra: str = ""):
        readings.append((what, {k: graph_s(g.graph, args.repeats)
                                for k, g in steps.items()}, memory(), extra))

    reading(built if key in engine.graphs else
            built + f"; chunk {args.bucket}@0 captured on first use")
    for what in filter(None, args.settle.split(",")):
        SETTLE[what](engine)
        reading(f"settle: {what}")
    rows = range(1, SCHED.max_num_seqs)
    extra = [first_use(engine, b, r, reading)
             for r, b in [(r, b) for r in rows for b in EVENT_BUCKETS][:args.events]]
    torch.cuda.empty_cache()
    reading("torch.cuda.empty_cache()")
    if args.probes:
        probes(reading, args.probes)
    served = serve(engine, steps["decode"], args.repeats) if args.serve else []
    if served:
        reading("after serving")
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
    del dummies, extra
    gc.collect()
    torch.cuda.synchronize()
    reading("dummies and the extra chunk graphs deleted")
    counts = {k: kernels(g) for k, g in steps.items()}    # one session each
    reading("after torch.profiler sessions")
    print(f"{cfg.name}, {cfg.n_layers} layers; kernels a replay: " + ", ".join(
              f"{k} {v}" for k, v in counts.items())
          + f"; {torch.cuda.get_device_name(0)}")
    first = readings[0][1]
    moved, before, mem = [], first, readings[0][2]
    for what, now, now_mem, extra_text in readings:
        print(f"  {what}: " + ", ".join(
            f"{k} {now[k] * 1e3:.3f} ms "
            f"({(now[k] - first[k]) / counts[k] * 1e6:+.3f} us a kernel)"
            for k in steps) + extra_text + _memory_moved(mem, now_mem), flush=True)
        step_us = (now["decode"] - before["decode"]) / counts["decode"] * 1e6
        if abs(step_us) > MOVED_US:
            moved.append(f"{what.strip()} ({step_us:+.3f} us)")
        before, mem = now, now_mem
    print(f"decode graph moved by more than {MOVED_US} us a kernel after: "
          + ("; ".join(moved) or "no event"))
    if served:
        _print_served(served, counts["decode"])
    return 0


def _memory_moved(before: tuple, now: tuple) -> str:
    """The change of ``memory()`` between two readings, if any, in MiB."""
    d = [(b - a) / 2**20 for a, b in zip(before, now)]
    return ("" if not any(d) else
            f" [cache {d[0]:+.1f} MiB, card {d[1]:+.1f} MiB]")


def _print_served(served: list, kernels: int):
    """Each trace's decode readings (first, median, last) and every
    iteration after which the decode graph moved by more than ``MOVED_US``
    a kernel, with what the iteration ran and the memory it moved."""
    prev_s, prev_mem = None, None
    for name in dict.fromkeys(t for t, *_ in served):
        times = [s for t, _, _, s, _ in served if t == name]
        print(f"served {name}: {len(times)} iterations, decode graph alone "
              f"{times[0] * 1e3:.3f} ms after the first, median "
              f"{float(np.median(times)) * 1e3:.3f}, {times[-1] * 1e3:.3f} after "
              f"the last")
    for name, i, what, sec, mem in served:
        if prev_s is not None and abs(sec - prev_s) / kernels * 1e6 > MOVED_US:
            print(f"  moved after {name} iteration {i} ({what}): "
                  f"{prev_s * 1e3:.3f} -> {sec * 1e3:.3f} ms "
                  f"({(sec - prev_s) / kernels * 1e6:+.3f} us a kernel)"
                  + _memory_moved(prev_mem, mem))
        prev_s, prev_mem = sec, mem


if __name__ == "__main__":
    sys.exit(main())
