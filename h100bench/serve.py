"""The system under test: the port's serving engine, driven through its own
``Engine.run`` over consecutive traces until the window's seconds pass.

``RecordingEngine`` is the port's ``Engine`` unchanged but for what it
keeps of its own timed path, for the check after the window: each
request's prefill chunks as (start, length, bucket), and the token each
emitting step put first, the argmax of the logits the step returned (one
more argmax on the device per emitting step, read back after the window);
and for the readers, the position of every row of every decode step and
the place of every chunk, and whether the profiler was collecting then.  With ``spans`` set it marks
each iteration and reset for the trace, and calls ``after_execute`` after
each iteration.

``settle`` replaces ``Engine.settle``'s stop rule by a fixed time: the same
readings (``Engine.decode_alone_ms``, each primed by decode replays, which
end the card's slow state) for ``SETTLE_S`` seconds, judged afterwards by
the port's own ``settled`` rule, so that set-up takes the same time whether
the captures left the card slow or not.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import Engine, settled
from repro_torch.serving.scheduler import Request, SchedulerConfig

from h100bench import weights

#: ``settle``: seconds of decode-graph readings in set-up at least and at
#: most (on the H100 the slow state the captures leave ended within 2-12 s
#: of decode replays in most processes, and lasted over 20 s in one)
SETTLE_S, SETTLE_MAX_S = 20.0, 40.0
#: how far above the least reading the last two may lie to end ``settle``
SETTLED = 0.01


class RecordingEngine(Engine):
    def __init__(self, *args, **kwargs):
        self.chunk_log: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
        self._emitted: List[Tuple[List[Tuple[int, int]], torch.Tensor]] = []
        self.decode_log: List[Tuple[bool, List[int]]] = []
        self.work_log: List[Tuple[bool, Tuple[int, int, bool]]] = []
        self.spans = False
        self.collecting = False
        self.after_execute = None
        super().__init__(*args, **kwargs)

    def execute(self, plan):
        self._plan = plan
        if not self.spans:
            return super().execute(plan)
        with record_function("h100bench.execute"):
            out = super().execute(plan)
        if self.after_execute is not None:
            self.after_execute()
        return out

    def reset(self):
        if not self.spans:
            return super().reset()
        with record_function("h100bench.reset"):
            return super().reset()

    def _chunk_done(self, chunk, length: int, logits: torch.Tensor):
        r = chunk.req
        self.chunk_log[r.rid].append((chunk.start, chunk.length, length))
        last = chunk.start + chunk.length >= r.prompt_len
        self.work_log.append((self.collecting, (chunk.start, chunk.length, last)))
        if last:
            self._emitted.append(([(r.rid, 0)], torch.argmax(logits, -1)))
        return logits

    def _chunk_graph(self, chunk, length, ids):
        return self._chunk_done(chunk, length, super()._chunk_graph(chunk, length, ids))

    def _chunk_eager(self, chunk, length, ids):
        return self._chunk_done(chunk, length, super()._chunk_eager(chunk, length, ids))

    def _decode_done(self, logits: torch.Tensor):
        rows = [(r.rid, r.slot) for r in self._plan.decodes]
        self._emitted.append((rows, torch.argmax(logits, -1)))
        self.decode_log.append((self.collecting,
                                [self.lengths[r.slot] for r in self._plan.decodes]))
        return logits

    def _decode_graph(self, toks):
        return self._decode_done(super()._decode_graph(toks))

    def _decode_eager(self, toks):
        return self._decode_done(super()._decode_eager(toks))

    def emitted(self) -> Dict[int, List[int]]:
        """The tokens each request was served, in order (read back from the
        device)."""
        out: Dict[int, List[int]] = defaultdict(list)
        for rows, best in self._emitted:
            best = best.tolist()
            for rid, row in rows:
                out[rid].append(best[row])
        return out


def build_engine(m: dict, cell: dict, seed: int, device: torch.device) -> RecordingEngine:
    """The port's engine on the benchmark's weights for ``seed`` (drawn on
    the device, handed over and freed), warmed up (every step graph
    captured) and settled (``Engine.settle``)."""
    params = weights.state_dict(m, seed, device)
    engine = RecordingEngine(ModelConfig(**m), sched_config=SchedulerConfig(**cell["sched"]),
                             max_seq=cell["max_seq"], params=params, impl="kernel",
                             seed=seed, device=device)
    del params
    settle(engine)
    return engine


def settle(engine: RecordingEngine) -> None:
    """Read the decode graph alone (``Engine.decode_alone_ms``) for
    ``SETTLE_S`` seconds, and on until the last two readings lie within
    ``SETTLED`` of the least of them and of warm-up's reading (taken with
    the decode graph alone captured), or ``SETTLE_MAX_S`` have passed; then
    reset.  ``settle_ms``, ``settle_s`` and ``settled`` (the port's own
    rule on warm-up's reading and these: a fall to the fast state seen)
    say what happened.  Nothing is read on the CPU."""
    t0 = time.perf_counter()
    readings: List[float] = []
    while engine.device.type == "cuda":
        readings.append(engine.decode_alone_ms())
        spent = time.perf_counter() - t0
        least = min(readings + [engine.first_alone_ms])
        if spent >= SETTLE_MAX_S or (spent >= SETTLE_S and len(readings) > 1 and
                                     max(readings[-2:]) <= (1 + SETTLED) * least):
            break
    engine.reset()
    engine.settle_ms, engine.settle_s = readings, time.perf_counter() - t0
    engine.settled = engine.device.type != "cuda" or settled(
        [engine.first_alone_ms] + readings)


@dataclass
class Window:
    """What one serving window did: its requests and iteration records,
    trace by trace, and its wall seconds."""
    requests: List[Request] = field(default_factory=list)
    records: list = field(default_factory=list)
    traces: int = 0
    wall_s: float = 0.0


def serve(engine: RecordingEngine, traffic: Iterator[list], seconds: float) -> Window:
    """Serve whole traces on a reset engine until ``seconds`` of wall time
    have passed; the window ends with the trace during which they did."""
    win = Window()
    t0 = time.perf_counter()
    while True:
        reqs = [Request(rid=win.traces * 100_000 + i, arrival=a, prompt=p,
                        max_new_tokens=o)
                for i, (a, p, o) in enumerate(next(traffic))]
        engine.reset()
        if engine.spans:
            with record_function("h100bench.trace"):
                engine.run(reqs)
        else:
            engine.run(reqs)
        win.requests += reqs
        win.records += engine.records
        win.traces += 1
        if time.perf_counter() - t0 >= seconds:
            break
    win.wall_s = time.perf_counter() - t0
    return win
