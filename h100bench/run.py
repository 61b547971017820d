"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``workloads/<cell>.json``: a configuration (``configs/<name>.json``),
a traffic mix (``traffic/<name>.json``), the arrival rate, the scheduler and
the check's limits.  The metrics a cell reports are ``BENCHMARK.json``'s,
each read by ``metrics/readers/<metric>.py``.  Set-up draws the weights on
the card from the seed, builds the port's engine (which captures every step
graph) and settles it; the window serves whole traces through
``Engine.run`` until ``--seconds`` have passed; then the served tokens are
checked against the float32 reference.  ``--trace 1`` records the window
with the profiler and reports the per-layer metrics instead of the
end-to-end ones.  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.  Without a CUDA device (or with fewer than the cell asks for) it
exits 2 and prints no result; ``--device cpu`` runs the same path on the
CPU, for the tests.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds at the start of a ``--trace 1`` window that the profiler collects
TRACE_S = 12.0


def _caches():
    """Every cache a run writes inside the checkout, at fixed paths, so that
    only a checkout's first run builds: the port builds its kernels into
    ``build/`` there itself.  Where the environment forbids bytecode
    (``PYTHONDONTWRITEBYTECODE``, as on the H100's machine, whose installed
    packages ship none), the imports' bytecode is kept there too: otherwise
    every run compiles some 1600 modules again."""
    cache = ROOT / "build" / "h100bench"
    if os.environ.get("PYTHONDONTWRITEBYTECODE"):
        sys.pycache_prefix = str(cache / "pycache")
        sys.dont_write_bytecode = False
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def _reader(name: str):
    path = BENCH / "metrics" / "readers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics ``BENCHMARK.json`` asks of this cell: the end-to-end ones,
    or with ``trace`` the per-layer ones, each kept where its
    ``workloads`` (if any) names the cell."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [r for r in rows if workload in r.get("workloads", [workload])]


def card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def report_engine(engine) -> None:
    _say(f"h100bench: warmup_s {engine.warmup_s} graphs {len(engine.graphs)} "
         f"first_alone_ms {engine.first_alone_ms}")
    r = engine.settle_ms
    if not r:
        _say("h100bench: settle: no readings off the card")
        return
    _say(f"h100bench: settle {'saw the fall to the fast state' if engine.settled else 'saw no fall'}"
         f" in {engine.settle_s} s; last two readings within "
         f"{(max(r[-2:]) / min(r) - 1) * 100} % of the least;"
         f" readings ms {r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    _caches()

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = _load("workloads", args.workload)
    conf = _load("configs", cell["config"])
    mix = _load("traffic", cell["traffic"])
    metrics = cell_metrics(bench, args.workload, bool(args.trace))

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            _say("h100bench: no CUDA device; no result")
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            _say(f"h100bench: {args.workload} needs {cell['chips']} CUDA devices, "
                 f"found {torch.cuda.device_count()}; no result")
            return 2
    device = torch.device(args.device)

    from h100bench import check
    from h100bench.devtrace import DeviceTrace, Summary
    from h100bench.serve import build_engine, serve
    from h100bench.traffic.generator import traces

    m = conf["model"]
    engine = build_engine(m, cell, args.seed, device)
    report_engine(engine)
    traffic = traces(mix, cell["rate_rps"], args.seed, m["vocab_size"])

    setup_s = time.time() - T_START
    summary = None
    if args.trace:
        engine.spans = True
        with DeviceTrace(device.type == "cuda", TRACE_S) as prof:
            engine.collecting = True
            engine.after_execute = lambda: prof.maybe_stop(engine)
            win = serve(engine, traffic, args.seconds)
            prof.maybe_stop(engine, now=True)
        t_read = time.perf_counter()
        summary = Summary(prof.events)
        _say(f"h100bench: profiler ended in {prof.stop_s} s, its trace read in "
             f"{time.perf_counter() - t_read} s: {summary.n_device} device "
             f"activities in {summary.window_s} s")
        del prof
    else:
        win = serve(engine, traffic, args.seconds)
    device_info = card(device)
    if summary is not None and device.type == "cuda":
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)

    attempted = len(win.requests)
    failed = sum(r.finish_t is None for r in win.requests)
    _say(f"h100bench: {power_limit()}")
    _say(f"h100bench: traces {win.traces} requests completed {attempted - failed} "
         f"of {attempted} window wall_s {win.wall_s} captures after warm-up "
         f"{engine.captures}")

    ctx = SimpleNamespace(model=m, cell=cell, window=win, trace=summary,
                          setup_s=setup_s, root=BENCH,
                          peaks=json.loads((BENCH / "metrics" / "peaks.json").read_text()),
                          lengths=[(r.prompt_len, r.generated) for r in win.requests
                                   if r.finish_t is not None],
                          traced_decodes=[p for on, rows in engine.decode_log if on
                                          for p in rows],
                          traced_chunks=[c for on, c in engine.work_log if on])
    values = {}
    for row in metrics:
        v = _reader(row["name"])(ctx)
        if v is not None:
            values[row["name"]] = {"value": v, "unit": row["unit"]}

    # the check, once the program's state is freed
    emitted, chunk_log = engine.emitted(), dict(engine.chunk_log)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    picked = check.sample(win.requests, emitted, cell["check"]["requests"], args.seed)
    got = check.served(m, args.seed, picked, emitted, chunk_log, device)
    _say(f"h100bench: reference over {len(picked)} requests, {got['positions']} "
         f"positions, in {time.perf_counter() - t_ref} s; readings {json.dumps(got)}")
    checked = {name: {"value": got[name], "limit": limit}
               for name, limit in cell["check"]["limits"].items()}
    checked.update(missing_tokens={"value": got["missing"], "limit": 0},
                   failed_requests={"value": failed, "limit": 0})
    correct = all(c["value"] <= c["limit"] for c in checked.values()) and bool(picked)

    loaded = sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
    if loaded:
        _say(f"h100bench: the run loaded {loaded}; no result")
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checked"] = checked
    for name, c in checked.items():
        _say(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
