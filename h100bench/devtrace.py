"""A profiler trace of the serving window, and what the readers take from it.

``DeviceTrace`` runs ``torch.profiler``'s Kineto collector through its
low-level calls and keeps the raw events, without building the
per-operator tables, and collects only the first seconds of the window:
on the H100 a second of graph replays is about 90,000 kernels, and the
profiler's own processing at its end took about a second for every
40,000.  The harness marks its own host spans with ``record_function``
(names starting ``h100bench.``): each trace, each engine iteration and
each reset, and the start and end of collection.

From the events: device busy seconds (the union of every activity on the
card), device time by name, and the idle gaps inside the window labelled
by the innermost harness span that was open at their midpoint.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

START, END = "h100bench.traced_start", "h100bench.traced_end"
#: harness spans, innermost first, and the label of an idle gap inside one
SPAN_LABELS = (("h100bench.execute", "host inside Engine.execute"),
               ("h100bench.reset", "Engine.reset between traces"),
               ("h100bench.trace", "host in Engine.run outside execute: scheduler, bookkeeping"))


class DeviceTrace:
    """Collects from entering until ``seconds`` have passed, as checked
    between iterations by ``maybe_stop``, which then ends the profiler
    (its processing stalls the window once) and keeps its events."""

    def __init__(self, cuda: bool, seconds: float):
        from torch.autograd import ProfilerActivity
        self.activities = {ProfilerActivity.CPU}
        if cuda:
            self.activities.add(ProfilerActivity.CUDA)
        self.seconds = seconds
        self.events = None

    def __enter__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        _prepare_profiler(config, self.activities)
        _enable_profiler(config, self.activities)
        with torch.profiler.record_function(START):
            self.t0 = time.perf_counter()
        return self

    def maybe_stop(self, engine, now: bool = False) -> None:
        """End collection once its seconds have passed (or ``now``), and
        tell ``engine`` so."""
        if self.events is not None or not (
                now or time.perf_counter() - self.t0 >= self.seconds):
            return
        from torch.autograd import _disable_profiler
        with torch.profiler.record_function(END):
            pass
        engine.collecting = False
        t = time.perf_counter()
        self.events = _disable_profiler().events()
        self.stop_s = time.perf_counter() - t

    def __exit__(self, *exc):
        return False


class Summary:
    """What the readers need from a trace: ``window_s``, ``busy_s``,
    ``by_name`` (device seconds per activity name) and the idle gaps."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        device: List[Tuple[int, int, str]] = []
        for e in events:
            if e.device_type() == cuda:
                if e.duration_ns() > 0 and not e.is_user_annotation() \
                        and not e.name().startswith("h100bench."):
                    device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                   e.name()))
            elif e.name().startswith("h100bench."):
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        lo = spans[START][0][0] if spans.get(START) else min(
            (a for a, _, _ in device), default=0)
        hi = spans[END][0][0] if spans.get(END) else max(
            (b for _, b, _ in device), default=0)
        self.window_s = (hi - lo) * 1e-9
        self.by_name: Dict[str, float] = defaultdict(float)
        busy: List[Tuple[int, int]] = []
        for a, b, name in sorted(device):
            self.by_name[name] += (b - a) * 1e-9
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if busy and a <= busy[-1][1]:
                busy[-1] = (busy[-1][0], max(busy[-1][1], b))
            else:
                busy.append((a, b))
        self.n_device = len(device)
        self.busy_s = sum(b - a for a, b in busy) * 1e-9
        gaps = [(a, b) for a, b in zip([lo] + [b for _, b in busy],
                                       [a for a, _ in busy] + [hi]) if b > a]
        self.idle = self._label(gaps, spans)

    @staticmethod
    def _label(gaps, spans) -> Dict[str, float]:
        """Idle seconds by the innermost harness span open at each gap's
        midpoint ("outside the harness's spans" if none)."""
        index = {}
        for name, _ in SPAN_LABELS:
            s = sorted(spans.get(name, []))
            index[name] = ([a for a, _ in s], [b for _, b in s])
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            label = "outside the harness's spans"
            for name, text in SPAN_LABELS:
                starts, ends = index[name]
                k = bisect.bisect_right(starts, mid) - 1
                if k >= 0 and ends[k] >= mid:
                    label = text
                    break
            out[label] += (b - a) * 1e-9
        return out

    def device_seconds(self, patterns: List[str]) -> Optional[float]:
        """Device seconds of the activities whose name matches any of the
        regular expressions; None when no activity matched."""
        rx = [re.compile(p) for p in patterns]
        hits = [s for n, s in self.by_name.items() if any(r.search(n) for r in rx)]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_patterns(root: Path, metric: str) -> List[str]:
    """The name patterns that attribute device time to ``metric``'s kernel:
    every non-blank, non-comment line of every file under
    ``kernels/<metric>/``."""
    out = []
    for f in sorted((root / "kernels" / metric).glob("*")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]
    return out
