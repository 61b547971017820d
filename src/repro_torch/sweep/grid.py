"""Declarative scenario grids.

A :class:`Scenario` is one fully-specified simulation: a model config (by
registry name), an attention backend, target hardware, a scheduler config,
a workload spec, and the sim's sequence budget.  ``expand_grid`` takes the
axes and yields the cross product.  Everything is a frozen dataclass so
scenarios and their projections are directly usable as memo keys:

* ``plan_key``  — (workload, sched): scenarios sharing it share one pure
  scheduler replay (the runner additionally collapses different workload
  specs whose generated *request structure* is identical);
* ``fit_key``   — (model, hardware, backend, tp): scenarios sharing it
  share one fitted latency model and one batched prediction pass;
* ``sim_key``   — everything prediction depends on: one DoolySim per key.

Workload kinds span the synthetic generators (``sharegpt``,
``synthetic``), file-less multi-turn conversations (``sessions`` —
prefix-sharing turns driving the scheduler's prefix-cache model), and
recorded serving traces (``trace`` — the ``dooly-trace`` JSONL format of
:mod:`repro.workload.trace`).  Trace specs carry the trace's content
hash (``trace_digest``), so the spec's value identity — and every memo
key derived from it — tracks the file's *content*, never its path:
build :class:`WorkloadSpec` trace specs via :meth:`WorkloadSpec.
for_trace` and a changed file can never alias a stale cache entry.
``shape`` composes diurnal/spike traffic shapes onto any kind.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.serving.scheduler import Request, SchedulerConfig
from repro_torch.workload import (load_trace, shaped_arrivals, sharegpt_like,
                            synthetic, synthetic_sessions, time_warp,
                            to_requests, trace_key, truncate_trace,
                            warp_times)

#: burst arrival rate: every request arrives at t=0, which makes scheduler
#: replay latency-independent (the exact-replay scenario class)
BURST = math.inf

#: valid WorkloadSpec.kind values (the build router below)
WORKLOAD_KINDS = ("sharegpt", "synthetic", "sessions", "trace")


@dataclass(frozen=True)
class WorkloadSpec:
    """Reproducible workload: generator kind + parameters + seed.

    ``rate=BURST`` (infinity) produces equal arrivals — the
    latency-independent class that sweeps evaluate by pure replay
    (``sim.replay``); finite rates produce staggered Poisson arrivals,
    which route through the event-driven ``sim.events`` engine with
    prefix-shared traces across scenarios (the interleaved scalar loop
    is only used when forced with ``engine="loop"``).

    Kinds: ``sharegpt`` / ``synthetic`` (seeded generators),
    ``sessions`` (``n`` multi-turn conversations of ``turns`` turns,
    prompts sharing prefixes — ``prompt_len`` fresh prompt tokens and
    ``out_len`` output tokens per turn, ``think_time`` between turns),
    and ``trace`` (a recorded ``dooly-trace`` file: ``n > 0`` truncates,
    ``warp`` scales offered load, ``trace_digest`` pins the content
    hash — use :meth:`for_trace`).  ``shape`` composes a diurnal/spike
    traffic shape (``repro.workload.shapes``) onto any kind: seeded
    inhomogeneous-Poisson thinning for the generators, deterministic
    time-change for sessions/traces.
    """
    kind: str = "sharegpt"          # one of WORKLOAD_KINDS
    n: int = 32
    rate: float = BURST
    seed: int = 0
    scale: float = 0.05             # sharegpt length scale
    prompt_len: int = 64            # synthetic / sessions per-turn fresh
    out_len: int = 16               # synthetic / sessions
    vocab: int = 1000
    turns: int = 1                  # sessions only
    think_time: float = 0.0         # sessions: gap between turns
    trace: str = ""                 # trace only: dooly-trace path
    trace_digest: str = ""          # trace only: pinned trace_key()
    warp: float = 1.0               # trace only: offered-load factor
    shape: str = ""                 # traffic shape, parse_shape() form
    split: int = 1                  # replica fan-out (round-robin router)
    split_index: int = 0            # which replica's share this spec is

    def __post_init__(self):
        if self.split < 1:
            raise ValueError(f"split must be >= 1, got {self.split}")
        if not (0 <= self.split_index < self.split):
            raise ValueError(f"split_index must be in [0, {self.split}), "
                             f"got {self.split_index}")

    def shard(self, split: int, index: int) -> "WorkloadSpec":
        """This workload's share under a ``split``-replica deterministic
        round-robin router: requests are ordered by arrival and replica
        ``index`` serves every ``split``-th one.  Used by
        ``repro.optimize`` to express an R-replica deployment as R
        ordinary scenarios the exact sweep tier can evaluate (prefix-
        cache credit is preserved, i.e. the router is assumed
        cache-affine)."""
        from dataclasses import replace
        return replace(self, split=split, split_index=index)

    @classmethod
    def for_trace(cls, path: str, *, n: int = 0, warp: float = 1.0,
                  shape: str = "", seed: int = 0,
                  vocab: int = 1000) -> "WorkloadSpec":
        """Trace-kind spec with the file's content hash pinned, so every
        cache key derived from this spec is content-correct.  ``n > 0``
        truncates to the first n rows; ``warp`` scales offered load
        (``math.inf`` = burst)."""
        digest = trace_key(load_trace(path))
        return cls(kind="trace", n=n, seed=seed, vocab=vocab,
                   trace=str(path), trace_digest=digest, warp=warp,
                   shape=shape)

    def build(self) -> List[Request]:
        return self._split(self._build_full())

    def _build_full(self) -> List[Request]:
        if self.kind == "sharegpt":
            reqs = sharegpt_like(self.n, rate=self.rate, seed=self.seed,
                                 scale=self.scale, vocab=self.vocab)
            return self._reshape_thinning(reqs)
        if self.kind == "synthetic":
            reqs = synthetic(self.n, rate=self.rate, seed=self.seed,
                             prompt_len=self.prompt_len,
                             out_len=self.out_len, vocab=self.vocab)
            return self._reshape_thinning(reqs)
        if self.kind == "sessions":
            reqs = synthetic_sessions(
                self.n, rate=self.rate, turns=self.turns,
                prompt_len=self.prompt_len, out_len=self.out_len,
                think_time=self.think_time, seed=self.seed,
                vocab=self.vocab)
            return self._reshape_warp(reqs)
        if self.kind == "trace":
            rows = load_trace(self.trace)
            if self.trace_digest and trace_key(rows) != self.trace_digest:
                raise ValueError(
                    f"trace {self.trace!r} content changed: its "
                    f"trace_key no longer matches the spec's pinned "
                    f"digest {self.trace_digest[:12]}…; rebuild the "
                    "spec with WorkloadSpec.for_trace")
            if self.n:
                rows = truncate_trace(rows, self.n)
            if self.warp != 1.0:
                rows = time_warp(rows, self.warp)
            reqs = to_requests(rows, seed=self.seed, vocab=self.vocab)
            return self._reshape_warp(reqs)
        raise KeyError(f"unknown workload kind {self.kind!r}; "
                       f"known: {', '.join(WORKLOAD_KINDS)}")

    def _split(self, reqs: List[Request]) -> List[Request]:
        """Round-robin router share (see :meth:`shard`): stable-sort by
        arrival, keep every ``split``-th request starting at
        ``split_index``."""
        if self.split == 1:
            return reqs
        ordered = sorted(reqs, key=lambda r: r.arrival)
        return ordered[self.split_index::self.split]

    def _reshape_thinning(self, reqs: List[Request]) -> List[Request]:
        """Replace a generator's Poisson arrivals with a seeded
        inhomogeneous-Poisson draw (thinning); lengths/content keep
        their common random numbers.  No-op without a shape or for
        burst workloads (shapes cannot modulate an instant)."""
        if not self.shape or math.isinf(self.rate):
            return reqs
        arrivals = shaped_arrivals(len(reqs), rate=self.rate,
                                   shape=self.shape, seed=self.seed)
        for r, t in zip(reqs, arrivals):
            r.arrival = float(t)
        return reqs

    def _reshape_warp(self, reqs: List[Request]) -> List[Request]:
        """Compose a shape onto recorded/derived arrivals by the
        deterministic time-change (order-preserving, so session turn
        order survives)."""
        if not self.shape:
            return reqs
        arrivals = [r.arrival for r in reqs]
        if not arrivals or max(arrivals) == 0.0:
            return reqs                   # burst: nothing to modulate
        warped = warp_times(arrivals, self.shape)
        for r, t in zip(reqs, warped):
            r.arrival = float(t)
        return reqs

    def label(self) -> str:
        tail = f"~{self.shape}" if self.shape else ""
        if self.split > 1:
            tail += f"%{self.split_index}/{self.split}"
        rate = "burst" if math.isinf(self.rate) else f"r{self.rate:g}"
        if self.kind == "synthetic":
            return (f"syn[{self.prompt_len}->{self.out_len}]x{self.n}"
                    f"@{rate}/s{self.seed}{tail}")
        if self.kind == "sessions":
            return (f"sess[{self.turns}t,{self.prompt_len}+{self.out_len}]"
                    f"x{self.n}@{rate}/s{self.seed}{tail}")
        if self.kind == "trace":
            name = os.path.basename(self.trace) or self.trace
            digest = f"#{self.trace_digest[:6]}" if self.trace_digest \
                else ""
            cut = f"x{self.n}" if self.n else ""
            w = "burst" if math.isinf(self.warp) else f"w{self.warp:g}"
            return f"trace[{name}{digest}]{cut}@{w}/s{self.seed}{tail}"
        return f"sgpt[x{self.scale:g}]x{self.n}@{rate}/s{self.seed}{tail}"


@dataclass(frozen=True)
class SchedSpec:
    """Hashable mirror of ``SchedulerConfig`` (which is mutable)."""
    max_num_seqs: int = 4
    max_batch_tokens: int = 64
    chunk_size: int = 32
    prefix_caching: bool = True

    def to_config(self) -> SchedulerConfig:
        return SchedulerConfig(max_num_seqs=self.max_num_seqs,
                               max_batch_tokens=self.max_batch_tokens,
                               chunk_size=self.chunk_size,
                               prefix_caching=self.prefix_caching)

    def label(self) -> str:
        return (f"s{self.max_num_seqs}/b{self.max_batch_tokens}"
                f"/c{self.chunk_size}"
                + ("" if self.prefix_caching else "/nopc"))


@dataclass(frozen=True)
class Scenario:
    model: str
    sched: SchedSpec
    workload: WorkloadSpec
    backend: str = "xla"
    hardware: str = "h100-80gb-hbm3"
    tp: int = 1
    max_seq: int = 128

    @property
    def fit_key(self) -> Tuple:
        return (self.model, self.hardware, self.backend, self.tp)

    @property
    def plan_key(self) -> Tuple:
        return (self.workload, self.sched)

    @property
    def sim_key(self) -> Tuple:
        return self.fit_key + (self.sched, self.max_seq)

    def label(self) -> str:
        return (f"{self.model}/{self.backend}/{self.sched.label()}"
                f"/{self.workload.label()}")


def expand_grid(models: Sequence[str],
                scheds: Sequence[SchedSpec],
                workloads: Sequence[WorkloadSpec],
                backends: Sequence[str] = ("xla",),
                hardware: str = "h100-80gb-hbm3",
                tp: int = 1,
                max_seq: int = 128) -> List[Scenario]:
    """Cross product of the axes, in a deterministic order (models
    outermost so fit groups are contiguous)."""
    return [Scenario(model=m, sched=s, workload=w, backend=b,
                     hardware=hardware, tp=tp, max_seq=max_seq)
            for m in models for b in backends
            for s in scheds for w in workloads]


def grid_summary(scenarios: Iterable[Scenario]) -> Dict[str, int]:
    scenarios = list(scenarios)
    return {"scenarios": len(scenarios),
            "fit_groups": len({s.fit_key for s in scenarios}),
            "plan_groups": len({s.plan_key for s in scenarios}),
            "sims": len({s.sim_key for s in scenarios})}
