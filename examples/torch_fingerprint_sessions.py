"""How often a torch.profiler session loses a kernel of a fingerprint's call.

On the card, for every probe call that ``chip_smoke.py`` phase 13's plan
fingerprints (the op and module entries of llama3-8b and command-r7b at
full width), this takes ``--reps`` profiler sessions of the call in each of
``--processes`` fresh processes and prints, per process, how many sessions
kept their sentinels and how many of those gave a kernel set other than the
call's usual one (``raw``).  Then it takes ``--reps`` fingerprints of each
call through ``repro_torch.core.signature._cuda_kernels`` and prints how
many differ from the usual set (``helper``).  A signature does not rest on
these sets: its component 2 is the aten overloads and the port's kernels a
call dispatches (``core/signature.py``).  Needs an NVIDIA GPU::

    PYTHONPATH=src python examples/torch_fingerprint_sessions.py --reps 100
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

MODELS = ("llama3-8b", "command-r7b")
SENTINEL = "spin_kernel"


def raw_sessions(fn, args, reps: int) -> list:
    """Each session as the fingerprint's first version took it: three
    sentinels, one call, one sentinel.  Returns (kept, kernel set) a
    session."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                torch.cuda._sleep(1)
            fn(*args)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        kept = bool(names) and SENTINEL in names[0] and SENTINEL in names[-1]
        out.append((kept, frozenset(n for n in names if SENTINEL not in n)))
    return out


def probe_calls():
    """(name, fn, args) of every distinct probe call of the plan."""
    from repro_torch.configs import get_config
    from repro_torch.core.database import LatencyDB
    from repro_torch.core.opset import ModuleEntry, OpEntry, find_runnable_set
    from repro_torch.core.profiler import (QUICK_SWEEP, DoolyProf, phases_for,
                                           window_for_path)
    from repro_torch.core.runner import trace_model
    from repro_torch.core.signature import PROBE_REQS, PROBE_TOKS, _probe_call
    dev = torch.device("cuda", 0)
    prof = DoolyProf(LatencyDB(":memory:"), sweep=QUICK_SWEEP, device=dev)
    seen = set()
    for name in MODELS:
        cfg = get_config(name)
        for entry in find_runnable_set(trace_model(cfg).trace, device=dev):
            if isinstance(entry, ModuleEntry) and entry.context_kind:
                w = window_for_path(cfg, entry.node.path)
                key = (entry.context_kind, w)
                calls = [_probe_call(prof._context(cfg, entry.context_kind, ph,
                                                   "kernel", w))
                         for ph in phases_for(entry.context_kind, cfg)]
            elif isinstance(entry, OpEntry):
                key = (entry.kind, str(entry.op.in_shapes), str(entry.op.params))
                calls = [entry.callable(
                    toks=PROBE_TOKS if entry.sweepable else None,
                    reqs=PROBE_REQS if entry.sweepable else None, device=dev)]
            else:
                continue
            if key not in seen:
                seen.add(key)
                yield from ((f"{name}: {key[0]}", fn, args) for fn, args in calls)


def child(mode: str, reps: int) -> dict:
    from repro_torch.core.signature import _cuda_kernels
    counts, odd = collections.Counter(), []
    for name, fn, args in probe_calls():
        if mode == "raw":
            runs = raw_sessions(fn, args, reps)
        else:
            runs = [(True, frozenset(_cuda_kernels(fn, args))) for _ in range(reps)]
        usual = collections.Counter(s for kept, s in runs if kept).most_common(1)
        usual = usual[0][0] if usual else None
        counts["calls"] += 1
        counts["sessions"] += len(runs)
        counts["kept"] += sum(kept for kept, _ in runs)
        wrong = sum(kept and s != usual for kept, s in runs)
        counts["kept, another set"] += wrong
        if wrong:
            odd.append({"call": name, "usual": len(usual), "wrong": wrong})
    return {"mode": mode, **counts, "calls with another set": odd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--child", choices=("raw", "helper"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fingerprint_sessions: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(args.child, args.reps)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for mode in ("raw", "helper"):
        for i in range(args.processes):
            run = subprocess.run([sys.executable, __file__, "--child", mode,
                                  "--reps", str(args.reps)],
                                 capture_output=True, text=True, timeout=900)
            if run.returncode:
                print(run.stderr[-4000:], file=sys.stderr)
                return 1
            print(f"{mode} process {i}: {run.stdout.strip().splitlines()[-1]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
