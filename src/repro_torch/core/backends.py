"""Measurement oracles.

Counterpart of ``repro.core.backends``:

* ``cuda_events`` — the paper's oracle on the card.  The reference times
  one jit-compiled program and subtracts the dispatch floor; here the
  counterpart of one compiled program is one CUDA graph.  After warm-up on
  a side stream, one call is captured in a ``torch.cuda.CUDAGraph``, its
  replay is timed between two CUDA events ``repeats`` times, and the
  median less the launch floor (the same measurement of a graph holding
  one trivial kernel) is returned.  Each timed replay is queued behind a
  busy kernel (``torch.cuda._sleep``) that keeps the card working while
  the host queues the start event, the replay and the end event, so the
  host's launch latency, which varies from process to process, is not
  timed: neither between the call's kernels nor before the first, and the
  floor is the card's own.  A call that cannot be captured (a host
  sync, a data-dependent shape) raises; there is no eager fallback.  A
  kernel wrapper's launch counter moves on the warm-up calls and once at
  capture, not on replays.  It runs on the card only, holding the card
  (``card_lock``) for the whole measurement, launch floor included.
* ``card_lock`` — one timer on a card at a time.  Two processes on one card
  (no MPS) take turns on it, so a timed window could hold another process's
  time slice.  Every process that measures on a card holds an exclusive
  ``flock`` on ``build/locks/card-<uuid>.lock`` while it puts work on the
  card for a measurement; the kernel drops the lock when its holder dies,
  so a killed worker never leaves the card locked.
* ``cpu_wallclock`` — host timing of one call on CPU tensors, for the CPU
  tests.
* ``h100_analytical`` — the counterpart of the reference's
  ``tpu_analytical``: the H100's roofline over one call, max(FLOPs / peak,
  bytes / HBM bandwidth).  FLOPs are counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on meta tensors, bytes are
  the call's tensor inputs (a module's weights included) read once and its
  outputs written once, and the peaks are ``parallel.roofline``'s.  It
  allocates nothing and is deterministic, so the CPU tests use it where the
  reference's use ``tpu_analytical``.  The hand-written kernels neither run
  on meta tensors nor show their FLOPs to the counter, so a caller passes a
  call through its plain path.

All return seconds.
"""
from __future__ import annotations

import contextlib
import fcntl
import functools
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.device import Device, resolve_device
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.parallel.roofline import H100, peaks


#: the card locks' directory: one file for each card, named by its UUID
LOCK_DIR = BUILD_DIR / "locks"

#: the locks this process holds: key -> (descriptor, depth)
_HELD: Dict[str, Tuple[int, int]] = {}


@contextlib.contextmanager
def hold_card(key: str, lock_dir: Path = LOCK_DIR):
    """Holds the card named ``key`` for this process: an exclusive
    ``flock`` on ``lock_dir/card-<key>.lock``, waiting while another process
    holds it.  Re-entrant within a process; the kernel releases it when the
    process dies, however it dies."""
    fd, depth = _HELD.get(key, (-1, 0))
    if not depth:
        lock_dir.mkdir(parents=True, exist_ok=True)
        fd = os.open(lock_dir / f"card-{key}.lock", os.O_RDWR | os.O_CREAT,
                     0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except BaseException:
            os.close(fd)
            raise
    _HELD[key] = (fd, depth + 1)
    try:
        yield
    finally:
        if depth:
            _HELD[key] = (fd, depth)
        else:
            del _HELD[key]
            os.close(fd)            # the only descriptor: the lock goes


@functools.lru_cache(maxsize=None)
def card_key(device: torch.device) -> str:
    """The UUID of the card ``device`` names (its index, else the current
    one), the same in every process whatever ``CUDA_VISIBLE_DEVICES`` says."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return str(torch.cuda.get_device_properties(index).uuid)


def card_lock(device: Device):
    """``hold_card`` of ``device``'s card; on the CPU a no-op."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return hold_card(card_key(dev))


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


#: cycles of the busy kernel queued before each timed replay (about 0.5 ms
#: on an H100), far longer than the host takes to queue the replay and its
#: two events
BUSY_CYCLES = 1_000_000


def _graph_times(fn: Callable, args: Sequence[Any], repeats: int, warmup: int,
                 device: torch.device) -> list:
    """Seconds of each of ``repeats`` replays of a CUDA graph of one
    ``fn(*args)``, each between two CUDA events queued behind a busy
    kernel."""
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
            torch.cuda._sleep(BUSY_CYCLES)
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize(device)
        del graph
    return [start.elapsed_time(end) * 1e-3 for start, end in pairs]


@functools.lru_cache(maxsize=None)
def launch_floor(device: torch.device) -> float:
    """Median event-timed seconds of replaying a graph of one trivial
    kernel on ``device``, measured once a process with the card held."""
    with card_lock(device):
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
    with card_lock(dev):
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



def _to_meta(x):
    """Tensors and TensorSpecs (anything with ``shape`` and ``dtype``) ->
    meta tensors, through tuples, lists and dicts; anything else (a module
    on the meta device) as it is."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, Mapping):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "shape"):
        return type(x)(_to_meta(v) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif isinstance(x, Mapping):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def h100_analytical(fn: Callable, args: Sequence[Any]) -> float:
    """Roofline seconds of one ``fn(*args)`` on an H100 80GB HBM3, counted
    on meta tensors: max(FLOPs at the peak of the inputs' floating dtype,
    bytes read and written at the HBM rate)."""
    margs = _to_meta(tuple(args))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*margs)
    ins = list(_tensors(margs))
    floats = [t.dtype for t in ins if t.dtype.is_floating_point]
    dtype = max(set(floats), key=floats.count) if floats else torch.float32
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    nbytes += sum(t.numel() * t.element_size() for t in _tensors(out))
    p = peaks(H100)
    return max(counter.get_total_flops() / p.peak_flops(dtype),
               nbytes / p.hbm_bw, 1e-7)


ORACLES = {"cuda_events": cuda_events, "cpu_wallclock": cpu_wallclock,
           "h100_analytical": h100_analytical}


def measure(oracle: str, fn: Callable, args: Sequence[Any],
            materialize: Callable = None) -> float:
    """Seconds of one ``fn(*args)`` by the named oracle; ``materialize``
    turns ``args`` into what the oracle calls ``fn`` with."""
    if oracle not in ORACLES:
        raise KeyError(f"unknown oracle {oracle!r}; known: "
                       f"{', '.join(sorted(ORACLES))}")
    if materialize is not None:
        args = materialize(args)
    return ORACLES[oracle](fn, args)
