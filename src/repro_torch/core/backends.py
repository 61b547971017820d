"""Measurement oracles.

Counterpart of ``repro.core.backends``:

* ``cuda_events`` — the paper's oracle: CUDA events around each call on the
  card, after warm-up; the median, less the launch floor (the event time of
  one trivial kernel, the counterpart of the reference's jit-dispatch
  floor).  It runs on the card only.
* ``cpu_wallclock`` — host timing of one call on CPU tensors, for the CPU
  tests.

Both return seconds.  The reference's ``tpu_analytical`` roofline has no
counterpart here; an H100 roofline comes with the latency-DB slice.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.device import Device, resolve_device


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _cuda_times(fn: Callable, args: Sequence[Any], repeats: int, warmup: int,
                device: torch.device) -> list:
    """Seconds of each of ``repeats`` calls, each between two CUDA events."""
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn(*args)
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(device)
    return [start.elapsed_time(end) * 1e-3 for start, end in pairs]


@functools.lru_cache(maxsize=None)
def launch_floor(device: torch.device) -> float:
    """Median event-timed seconds of one trivial kernel on ``device``."""
    x = torch.zeros(1, device=device)
    return _median(_cuda_times(lambda: x.add_(0), (), 20, 3, device))


def cuda_events(fn: Callable, args: Sequence[Any], *, repeats: int = 20,
                warmup: int = 3, device: Device = "cuda") -> float:
    """Median CUDA-event seconds of one call on the card, launch floor
    subtracted."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"cuda_events times the card; got device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    med = _median(_cuda_times(fn, args, repeats, warmup, dev))
    return max(med - launch_floor(dev), med * 0.05, 1e-8)


def cpu_wallclock(fn: Callable, args: Sequence[Any], *, repeats: int = 5,
                  warmup: int = 2) -> float:
    """Median wall-clock seconds of one call on CPU tensors."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return max(_median(times), 1e-8)

