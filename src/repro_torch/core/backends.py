"""Measurement oracles.

Counterpart of ``repro.core.backends``:

* ``cuda_events`` — the paper's oracle on the card.  The reference times
  one jit-compiled program and subtracts the dispatch floor; here the
  counterpart of one compiled program is one CUDA graph.  After warm-up on
  a side stream, one call is captured in a ``torch.cuda.CUDAGraph``, its
  replay is timed between two CUDA events ``repeats`` times, and the
  median less the launch floor (the same measurement of a graph holding
  one trivial kernel) is returned.  Host launch gaps between the call's
  kernels are therefore not timed.  A call that cannot be captured (a host
  sync, a data-dependent shape) raises; there is no eager fallback.  A
  kernel wrapper's launch counter moves on the warm-up calls and once at
  capture, not on replays.  It runs on the card only.
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


def _graph_times(fn: Callable, args: Sequence[Any], repeats: int, warmup: int,
                 device: torch.device) -> list:
    """Seconds of each of ``repeats`` replays of a CUDA graph of one
    ``fn(*args)``, each between two CUDA events."""
    name = getattr(fn, "__qualname__", repr(fn))
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):     # builds kernels, fills caches
            for _ in range(max(warmup, 1)):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                fn(*args)
        except RuntimeError as e:
            raise RuntimeError(f"cuda_events: {name} cannot be captured in a "
                               f"CUDA graph (a host sync or a data-dependent "
                               f"shape?): {e}") from e
        graph.replay()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
        for start, end in pairs:
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize(device)
        del graph
    return [start.elapsed_time(end) * 1e-3 for start, end in pairs]


@functools.lru_cache(maxsize=None)
def launch_floor(device: torch.device) -> float:
    """Median event-timed seconds of replaying a graph of one trivial
    kernel on ``device``."""
    x = torch.zeros(1, device=device)

    def trivial():
        x.add_(0)
    return _median(_graph_times(trivial, (), 20, 3, device))


def cuda_events(fn: Callable, args: Sequence[Any], *, repeats: int = 20,
                warmup: int = 3, device: Device = "cuda") -> float:
    """Median seconds of one ``fn(*args)`` on the card, timed as the replay
    of a CUDA graph of it, launch floor subtracted."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"cuda_events times the card; got device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    med = _median(_graph_times(fn, args, repeats, warmup, dev))
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

