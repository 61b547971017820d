"""DoolySim (paper §7.1): end-to-end serving simulation.

Counterpart of ``repro.sim.simulator``: the same code over the port's
latency backends, scheduler and replay tiers.

Drives the *same* Scheduler class the real engine runs (bit-identical batch
composition), advances virtual time by predicted iteration latency, and
consumes those predictions exclusively through the
:class:`repro_torch.api.backends.LatencyBackend` protocol — the simulator
schedules, the backend prices.

The default backend is :class:`repro_torch.api.backends.DoolyBackend` (the
paper's path: per-signature regression models over the latency database,
counts from the model_operations table), constructed from the legacy
``(cfg, db, hardware, backend, ...)`` arguments so existing call sites
keep working unchanged.  Pass ``latency=`` to drop in any other backend —
``repro_torch.api.ProfileStore.simulator(...)`` is the facade entry point.
The prediction engine itself (row groups, memoized call cache, batched
``predict_batch_points`` evaluation, the ``predict_call_scalar`` reference
path) lives in the backend module; `DoolySim`'s ``predict_*`` methods are
thin delegates kept for compatibility, bitwise-identical because they run
the same code.

``run`` is tiered by how the workload's scheduling interacts with the
clock (``engine=``, default ``"auto"``):

* ``"replay"`` — latency-independent workloads (equal arrivals): pure
  ``sim.replay.replay_schedule`` plus one batched ``predict_trace``;
* ``"events"`` — staggered arrivals: the event-driven ``sim.events``
  engine, which speculates iteration chunks between arrival events and
  prices each chunk in one batched call;
* ``"loop"`` — the interleaved scalar reference loop (one prediction per
  iteration), kept for equivalence gates and benchmarks; never
  auto-selected.

``via_replay=`` is a deprecated alias (``True`` -> ``"replay"``,
``False`` -> ``"loop"``).  ``predict_traces`` extends the batching across
*scenarios*, and the module-level ``predict_scenarios`` groups
(sim, trace) pairs by latency backend so an N-scenario sweep runs one
batched prediction per fitted (cfg, hardware, backend, tp) group.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.backends import DoolyBackend, LatencyBackend
from repro_torch.configs.base import ModelConfig
from repro_torch.core.database import LatencyDB
from repro_torch.core.latency_model import LatencyModel
from repro_torch.serving.scheduler import (IterationPlan, Request, Scheduler,
                                     SchedulerConfig)
from repro_torch.sim.events import run_events
from repro_torch.sim.replay import is_latency_independent, replay_schedule

#: ``DoolySim.run`` scheduling tiers (``"auto"`` resolves per workload)
ENGINES = ("auto", "replay", "events", "loop")


class DoolySim:
    def __init__(self, cfg: Optional[ModelConfig] = None,
                 db: Optional[LatencyDB] = None, *,
                 hardware: Optional[str] = None,
                 backend: Optional[str] = None,
                 sched_config: Optional[SchedulerConfig] = None,
                 max_seq: Optional[int] = None,
                 overhead_s: float = 0.0, chunk_overhead_s: float = 0.0,
                 tp: int = 1, lm: Optional[LatencyModel] = None,
                 latency: Optional[LatencyBackend] = None,
                 engine: str = "auto"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"expected one of {ENGINES}")
        self.engine = engine
        if latency is None:
            if None in (cfg, db, hardware, backend, sched_config, max_seq):
                raise TypeError(
                    "DoolySim needs either a latency backend (latency=...) "
                    "or the full legacy argument set (cfg, db, hardware=, "
                    "backend=, sched_config=, max_seq=) to build the "
                    "default DoolyBackend")
            latency = DoolyBackend(
                cfg, db, hardware=hardware, backend=backend,
                sched_config=sched_config, max_seq=max_seq, tp=tp, lm=lm,
                overhead_s=overhead_s, chunk_overhead_s=chunk_overhead_s)
        self.latency = latency
        self.cfg = cfg if cfg is not None else latency.cfg
        self.sched_config = (sched_config if sched_config is not None
                             else latency.sched_config)
        self.max_seq = max_seq if max_seq is not None else latency.max_seq

    # -- delegated prediction surface ----------------------------------
    # The engine lives on the backend; these stay for compatibility (and
    # because "the simulator's prediction" is a natural way to ask).

    @property
    def db(self):
        return self.latency.db

    @property
    def lm(self):
        return self.latency.lm

    @property
    def rows(self):
        return self.latency.rows

    @property
    def _call_cache(self):
        return self.latency._call_cache

    @property
    def overhead_s(self) -> float:
        return self.latency.overhead_s

    @overhead_s.setter
    def overhead_s(self, v: float):
        self.latency.overhead_s = v

    @property
    def chunk_overhead_s(self) -> float:
        return self.latency.chunk_overhead_s

    @chunk_overhead_s.setter
    def chunk_overhead_s(self, v: float):
        self.latency.chunk_overhead_s = v

    @property
    def decode_scale(self) -> float:
        return self.latency.decode_scale

    @decode_scale.setter
    def decode_scale(self, v: float):
        self.latency.decode_scale = v

    def predict_call(self, *, phase: str, toks: int, reqs: int,
                     ctx: int) -> float:
        return self.latency.predict_call(phase=phase, toks=toks, reqs=reqs,
                                         ctx=ctx)

    def predict_call_scalar(self, *, phase: str, toks: int, reqs: int,
                            ctx: int) -> float:
        return self.latency.predict_call_scalar(phase=phase, toks=toks,
                                                reqs=reqs, ctx=ctx)

    def predict_points(self, points) -> np.ndarray:
        return self.latency.predict_points(points)

    def predict_trace(self, plans) -> np.ndarray:
        return self.latency.predict_trace(plans)

    def predict_iteration(self, plan: IterationPlan) -> float:
        return float(self.latency.predict_plan(plan))

    def predict_traces(self, traces: Sequence[Sequence]) -> List[np.ndarray]:
        return self.latency.predict_traces(traces)

    def predict_record(self, rec) -> float:
        return self.latency.predict_record(rec)

    def calibrate(self, records) -> Dict[str, float]:
        """Fit the engine's CPU overhead model (a + b * n_chunks) from a
        calibration run — the Vidur-style CPU-overhead profiling step.
        Median residuals per iteration composition (robust to queue noise,
        avoids chunk/decode colinearity).  Writes the fitted terms onto the
        latency backend (any backend can be calibrated)."""
        # reset so recalibration is idempotent: predict_record applies
        # decode_scale, and fitting the ratio on already-scaled predictions
        # would compound corrections across calls
        self.decode_scale = 1.0
        # decode program: stable multiplicative correction (op-sum vs the
        # fused compiled program), then additive residual
        dec_pred = [self.predict_record(r) for r in records
                    if r.n_chunks == 0]
        dec_meas = [r.model_s for r in records if r.n_chunks == 0]
        if dec_pred and np.median(dec_pred) > 0:
            self.decode_scale = float(np.median(
                np.array(dec_meas) / np.array(dec_pred)))
        # predict_record now applies decode_scale itself
        dec_only = [m - self.predict_record(r)
                    for m, r in zip(dec_meas,
                                    [r for r in records if r.n_chunks == 0])]
        a = float(np.median(dec_only)) if dec_only else 0.0
        a = max(a, 0.0)
        with_chunks = [(r.model_s - self.predict_record(r) - a) / r.n_chunks
                       for r in records if r.n_chunks > 0]
        b = float(np.median(with_chunks)) if with_chunks else 0.0
        self.overhead_s = a
        self.chunk_overhead_s = max(b, 0.0)
        return {"overhead_s": self.overhead_s,
                "chunk_overhead_s": self.chunk_overhead_s,
                "decode_scale": self.decode_scale}

    # ------------------------------------------------------------------

    def run(self, requests: List[Request], *, record_plans: bool = False,
            engine: Optional[str] = None,
            via_replay: Optional[bool] = None) -> Dict[str, Any]:
        """Simulate serving ``requests``.

        ``engine`` selects the scheduling tier (defaulting to the
        constructor's, normally ``"auto"``):

        * ``"auto"`` — ``"replay"`` for latency-independent workloads
          (equal arrivals), ``"events"`` for staggered arrivals;
        * ``"replay"`` — pure ``replay_schedule`` + one batched
          ``predict_trace`` (raises ``ValueError`` on a staggered
          workload);
        * ``"events"`` — event-driven chunked speculation with batched
          prediction between arrival events (``sim.events.run_events``);
        * ``"loop"`` — the interleaved scalar reference loop, one
          prediction per iteration (equivalence gates + benchmark
          baselines).

        The result dict carries the resolved tier under ``"engine"``.
        ``via_replay`` is a deprecated alias: ``True`` -> ``"replay"``,
        ``False`` -> ``"loop"``."""
        if via_replay is not None:
            warnings.warn(
                "DoolySim.run(via_replay=...) is deprecated; use "
                "engine='replay' / engine='loop' (removal: two releases "
                "after 0.2)", DeprecationWarning, stacklevel=2)
            if engine is not None:
                raise TypeError("pass engine= or the deprecated "
                                "via_replay=, not both")
            engine = "replay" if via_replay else "loop"
        if engine is None:
            engine = self.engine
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"expected one of {ENGINES}")
        if engine == "auto":
            engine = ("loop" if not requests else
                      "replay" if is_latency_independent(requests)
                      else "events")
        if engine == "replay":
            out = self._run_replayed(requests, record_plans)
        elif engine == "events":
            out = self._run_events(requests, record_plans)
        else:
            out = self._run_interleaved(requests, record_plans)
        out["engine"] = engine
        return out

    def _run_events(self, requests: List[Request],
                    record_plans: bool) -> Dict[str, Any]:
        return run_events(requests, self.sched_config, self.latency,
                          record_plans=record_plans)

    def _run_replayed(self, requests: List[Request],
                      record_plans: bool) -> Dict[str, Any]:
        trace = replay_schedule(requests, self.sched_config)
        lat = self.predict_trace(trace.plans)
        clocks = trace.times(lat)
        trace.apply(requests, lat, times=clocks)
        iterations = [(float(clocks[i]), int(trace.n_tokens[i]),
                       float(lat[i])) for i in range(trace.n_iterations)]
        out = {"requests": requests, "iterations": iterations,
               "makespan": trace.makespan(lat, times=clocks)}
        if record_plans:
            out["plans"] = list(trace.plans)
        return out

    def _run_interleaved(self, requests: List[Request],
                         record_plans: bool) -> Dict[str, Any]:
        sched = Scheduler(self.sched_config)
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        clock = 0.0
        iterations = []
        plans: List[Tuple[Tuple[int, ...], int]] = []
        while i < len(pending) or sched.has_work():
            while i < len(pending) and pending[i].arrival <= clock:
                sched.add_request(pending[i])
                i += 1
            plan = sched.schedule()
            if plan.empty:
                if i < len(pending):
                    clock = pending[i].arrival
                    continue
                break
            dt = self.predict_iteration(plan)
            clock += dt
            sched.complete_iteration(plan, clock)
            iterations.append((clock, plan.n_tokens, dt))
            if record_plans:
                plans.append((tuple(c.length for c in plan.prefills),
                              len(plan.decodes)))
        out = {"requests": requests, "iterations": iterations,
               "makespan": clock}
        if record_plans:
            out["plans"] = plans
        return out


def predict_scenarios(items: Sequence[Tuple[Any, Sequence]]
                      ) -> List[np.ndarray]:
    """Batched prediction across scenarios: ``items`` is a sequence of
    ``(sim_or_backend, plans)`` pairs.  Scenarios are grouped by latency
    backend — i.e. by fitted (cfg, hardware, backend, tp) model — and each
    group's traces evaluate together through ``predict_traces``, so every
    distinct workload point in the group costs one row of one matmul
    regardless of how many scenarios share it.  Returns per-scenario
    latency arrays in input order."""
    groups: Dict[int, Tuple[Any, List[int], List[Sequence]]] = {}
    for i, (sim, plans) in enumerate(items):
        be = getattr(sim, "latency", sim)
        be_, idxs, traces = groups.setdefault(id(be), (be, [], []))
        idxs.append(i)
        traces.append(plans)
    out: List[Optional[np.ndarray]] = [None] * len(items)
    for be, idxs, traces in groups.values():
        for i, lat in zip(idxs, be.predict_traces(traces)):
            out[i] = lat
    return out
