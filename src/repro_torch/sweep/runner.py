"""Sweep driver: evaluate many scenarios against one profile store.

The driver composes the two decoupled simulation layers:

1. *Plan generation* — one pure ``replay_schedule`` per distinct
   (request structure, scheduler config), where structure is the
   (prompt_len, arrival, max_new_tokens, cached_prefix) tuple sequence
   the scheduler actually sees; scenarios differing in model / hardware
   / backend — or
   in workload content that doesn't change structure — share the
   replayed :class:`PlanTrace`.
2. *Cross-scenario prediction* — one batched pass per fitted (model,
   hardware, backend, tp) group through the
   :class:`~repro.api.backends.LatencyBackend` protocol; scenarios
   sharing a group evaluate the union of their workload points in one
   matmul per (row group, phase), against latency models shared per
   hardware (``ProfileStore.model``) so persisted fits load once per
   sweep.  ``latency="roofline"``/``"oracle"`` drops a different
   registered backend into the same machinery.

Scenario classification (the latency-(in)dependence split): equal-arrival
workloads are *exact-replay* — the replayed plans are provably the plans
``DoolySim.run`` would schedule, so metrics come straight from
``PlanTrace.metrics``.  Staggered-arrival workloads route through the
event-driven ``sim.events`` engine (mode ``"events"``) with
**prefix-shared replay** on top: scenarios sharing request structure and
scheduler config share one recorded :class:`StaggeredTrace`; each
follower prices the trace's plans in one batched ``predict_trace`` call
and walks ``StaggeredTrace.divergence`` — a fully-valid walk reuses the
whole schedule with zero scheduler work (``"events-dedup"`` under the
same simulator, ``"events-shared"`` under another), and a divergent one
fast-forwards the validated prefix for free and simulates only the tail.
``Sweep(engine="loop")`` restores the interleaved per-scenario reference
loop (mode ``"loop"``), which is also what ``latency_dependence`` can
never route to automatically.

On top, scenarios that resolve to an identical (plan-trace content,
sim) pair — e.g. synthetic workloads differing only in the token-content
seed — are deduplicated: evaluated once, results shared.  That is the
paper's redundancy-awareness applied to simulation instead of profiling.

``iter_results`` is the streaming form: results are yielded per scenario
as each fit group's batched prediction completes, so a large grid never
materializes the whole ``SweepResult`` before the first number is
available (``python -m repro_torch.sweep --stream``).  ``run`` consumes it and
reassembles input order.
"""
from __future__ import annotations

import heapq
import multiprocessing
import os
import pickle
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.api.store import ProfileStore
from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.serving.scheduler import Request
from repro_torch.sim.events import StaggeredTrace, run_events
from repro_torch.sim.metrics import request_metrics
from repro_torch.sim.replay import (PlanTrace, clone_sorted, latency_dependence,
                              replay_schedule)
from repro_torch.sim.simulator import DoolySim
from repro_torch.sweep.grid import Scenario, WorkloadSpec

#: relative accelerator price per second, per hardware name (tp multiplies)
DEFAULT_HW_COST = {"h100-80gb-hbm3": 1.0, "cpu": 0.1}


@dataclass
class ScenarioResult:
    scenario: Scenario
    #: "replay" / "replay-dedup" (exact replay), "events" (event-driven
    #: simulation, possibly prefix-resumed), "events-dedup" /
    #: "events-shared" (full StaggeredTrace reuse), "loop" (forced
    #: reference loop)
    mode: str
    makespan: float
    n_iterations: int
    ttft_mean: float
    ttft_p50: float
    ttft_p90: float
    tpot_mean: float
    tpot_p50: float
    tpot_p90: float
    tokens_per_s: float             # generated tokens / makespan
    cost: float                     # accelerator-seconds x price x tp
    index: int = -1                 # position in the submitted grid
    degraded: bool = False          # priced by a fallback backend stage
    cache_hit_tokens: int = 0       # prompt tokens served by prefix cache

    def to_json(self) -> Dict:
        out = {k: getattr(self, k) for k in
               ("mode", "makespan", "n_iterations", "ttft_mean", "ttft_p50",
                "ttft_p90", "tpot_mean", "tpot_p50", "tpot_p90",
                "tokens_per_s", "cost", "degraded", "cache_hit_tokens")}
        out["scenario"] = self.scenario.label()
        return out


@dataclass
class ScenarioFailure:
    """One scenario the sweep could not evaluate, and why.

    ``stage`` names the pipeline step that raised: ``"workload"``
    (request building / scheduler replay), ``"build"`` (simulator or
    latency-backend construction), ``"predict"`` (a fit group's batched
    prediction), ``"events"`` (the event-driven staggered run or its
    trace-sharing walk), or ``"loop"`` (the forced interleaved run)."""
    index: int
    scenario: Scenario
    stage: str
    error: str

    def to_json(self) -> Dict:
        return {"index": self.index, "scenario": self.scenario.label(),
                "stage": self.stage, "error": self.error}


@dataclass
class SweepResult:
    results: List[ScenarioResult]
    summary: Dict[str, float] = field(default_factory=dict)
    failures: List[ScenarioFailure] = field(default_factory=list)

    def frontier(self, metric: str = "tpot_mean") -> List[ScenarioResult]:
        """Pareto frontier minimizing (cost, metric): the scenarios for
        which no cheaper scenario is also faster."""
        pts = sorted(self.results, key=lambda r: (r.cost,
                                                  getattr(r, metric)))
        out: List[ScenarioResult] = []
        best = float("inf")
        for r in pts:
            v = getattr(r, metric)
            if v < best:
                out.append(r)
                best = v
        return out

    def table(self, metric: str = "tpot_mean") -> str:
        front = {id(r) for r in self.frontier(metric)}
        head = (f"{'scenario':58s} {'mode':12s} {'makespan':>9s} "
                f"{'ttft.p50':>9s} {'tpot.p50':>9s} {'tok/s':>8s} "
                f"{'cost':>8s}  frontier")
        lines = [head, "-" * len(head)]
        for r in self.results:
            lines.append(
                f"{r.scenario.label():58s} {r.mode:12s} {r.makespan:9.4f} "
                f"{r.ttft_p50:9.4f} {r.tpot_p50:9.4f} {r.tokens_per_s:8.1f} "
                f"{r.cost:8.3f}  {'*' if id(r) in front else ''}")
        return "\n".join(lines)

    def failure_table(self) -> str:
        if not self.failures:
            return "no failed scenarios"
        head = f"{'scenario':58s} {'stage':9s} error"
        lines = [head, "-" * len(head)]
        for f in self.failures:
            lines.append(f"{f.scenario.label():58s} {f.stage:9s} {f.error}")
        return "\n".join(lines)

    def to_json(self, metric: str = "tpot_mean") -> Dict:
        """JSON payload; ``metric`` selects the frontier's latency axis,
        matching :meth:`frontier`/:meth:`table` (and the CLI's
        ``--metric``) so the serialized frontier agrees with the one
        printed."""
        return {"summary": self.summary,
                "metric": metric,
                "results": [r.to_json() for r in self.results],
                "failures": [f.to_json() for f in self.failures],
                "frontier": [r.scenario.label()
                             for r in self.frontier(metric)]}


class Sweep:
    """Batch-evaluates scenario grids against one profile store.

    The first argument may be a :class:`repro.api.ProfileStore` or a bare
    ``LatencyDB`` (wrapped on the fly).  ``config_fn`` resolves a
    scenario's model name to a ModelConfig (defaults to the smoke registry
    — the profile store must have been built with the same configs);
    ``latency`` names the registered backend every scenario is priced
    with.  ``engine`` routes *staggered* scenarios: ``"auto"``/
    ``"events"`` use the event-driven engine with prefix-shared traces,
    ``"loop"`` restores the per-scenario interleaved reference loop
    (equal-arrival scenarios always use exact replay)."""

    def __init__(self, db, *,
                 config_fn: Callable = get_smoke_config,
                 hw_cost: Optional[Dict[str, float]] = None,
                 use_saved_fits: bool = True,
                 latency: str = "dooly",
                 engine: str = "auto"):
        if engine not in ("auto", "events", "loop"):
            raise ValueError(f"unknown sweep engine {engine!r}; expected "
                             "'auto', 'events', or 'loop'")
        self.engine = engine
        if isinstance(db, ProfileStore):
            self.store = db
        elif isinstance(db, LatencyDB):
            self.store = ProfileStore.wrap(db)
        else:
            raise TypeError(f"expected ProfileStore or LatencyDB, got "
                            f"{type(db).__name__}")
        self.config_fn = config_fn
        self.hw_cost = dict(DEFAULT_HW_COST if hw_cost is None else hw_cost)
        self.use_saved_fits = use_saved_fits
        self.latency_name = latency
        #: summary counters of the most recent iter_results/run pass
        self.last_summary: Optional[Dict[str, float]] = None
        #: per-scenario failures of the most recent pass (on_error="report")
        self.last_failures: List[ScenarioFailure] = []
        self._requests: Dict[WorkloadSpec, List[Request]] = {}
        self._struct_keys: Dict[WorkloadSpec, Tuple] = {}
        self._traces: Dict[Tuple, PlanTrace] = {}
        self._trace_keys: Dict[int, Tuple] = {}     # id(trace) -> content key
        self._sims: Dict[Tuple, DoolySim] = {}

    @property
    def db(self) -> LatencyDB:
        return self.store.db

    # -- profiling ------------------------------------------------------

    def profile_plan(self, scenarios: Sequence[Scenario], *,
                     sweep=None, skip_profiled: bool = True):
        """One corpus-wide :class:`~repro.core.plan.ProfilePlan` covering
        every distinct (model, backend, tp) a grid needs — the plan-first
        replacement for calling ``ensure_profiled`` once per pair.  The
        whole grid dedups as one corpus, so shared signatures are planned
        (and measured) once no matter how many models share them.

        ``skip_profiled`` drops pairs whose call graph the store already
        has (the old per-model fast path).  Grids spanning several
        hardware kinds need one plan per hardware: scenarios whose
        hardware differs from the store's are rejected here.  Only the
        exact (model, backend) pairs the grid references are planned —
        a ragged grid never measures configurations it doesn't use.
        Returns None when nothing needs planning."""
        keys = []
        for s in scenarios:
            if s.hardware != self.store.hardware:
                raise ValueError(
                    f"scenario hardware {s.hardware!r} differs from the "
                    f"store's {self.store.hardware!r}; build one plan per "
                    "hardware")
            k = (s.model, s.backend, s.tp)
            if k not in keys:
                keys.append(k)
        if skip_profiled:
            keys = [k for k in keys
                    if not self.store.is_profiled(self.config_fn(k[0]),
                                                  backend=k[1], tp=k[2])]
        if not keys:
            return None
        tps = {tp for _, _, tp in keys}
        if len(tps) > 1:
            raise ValueError(f"mixed tp degrees {sorted(tps)} in one grid; "
                             "build one plan per tp")
        cfgs: Dict[str, object] = {}
        for m, _b, _tp in keys:
            if m not in cfgs:
                cfgs[m] = self.config_fn(m)
        return self.store.plan(list(cfgs.values()), tp=tps.pop(),
                               sweep=sweep,
                               pairs=[(cfgs[m], b) for m, b, _tp in keys])

    # -- memoized layers ------------------------------------------------

    def requests(self, spec: WorkloadSpec) -> List[Request]:
        """Pristine request list per workload spec (consumers must clone
        before mutating — ``replay_schedule`` and the loop path both do)."""
        reqs = self._requests.get(spec)
        if reqs is None:
            reqs = self._requests[spec] = spec.build()
        return reqs

    def _structure_key(self, spec: WorkloadSpec) -> Tuple:
        """Scheduling only sees request *structure* — lengths, arrivals,
        output budgets, cached prefixes — never token content, so
        workload specs generating structurally identical requests (e.g.
        synthetic loads differing only in the content seed) can share
        one replay."""
        key = self._struct_keys.get(spec)
        if key is None:
            key = tuple((r.prompt_len, r.arrival, r.max_new_tokens,
                         r.cached_prefix)
                        for r in self.requests(spec))
            self._struct_keys[spec] = key
        return key

    def plan_trace(self, scn: Scenario) -> PlanTrace:
        """One scheduler replay per (request structure, sched config);
        shared by every scenario whose workload schedules identically."""
        tkey = (self._structure_key(scn.workload), scn.sched)
        trace = self._traces.get(tkey)
        if trace is None:
            trace = replay_schedule(self.requests(scn.workload),
                                    scn.sched.to_config())
            self._traces[tkey] = trace
        return trace

    def _trace_content_key(self, trace: PlanTrace) -> Tuple:
        key = self._trace_keys.get(id(trace))
        if key is None:
            key = self._trace_keys[id(trace)] = trace.content_key()
        return key

    def sim(self, scn: Scenario) -> DoolySim:
        """One DoolySim per sim_key, its latency source built through the
        store so all backends on one hardware share one LatencyModel and
        each persisted fit loads exactly once."""
        sim = self._sims.get(scn.sim_key)
        if sim is None:
            cfg = self.config_fn(scn.model)
            be = self.store.backend(
                self.latency_name, cfg, sched_config=scn.sched.to_config(),
                max_seq=scn.max_seq, backend=scn.backend, tp=scn.tp,
                hardware=scn.hardware, use_saved_fits=self.use_saved_fits)
            rows = getattr(be, "rows", None)
            if rows is not None and not rows:
                raise RuntimeError(
                    f"no call-graph rows for ({scn.model}, {scn.backend}, "
                    f"{scn.hardware}, tp={scn.tp}) — profile the model "
                    "into this database first")
            sim = DoolySim(cfg, sched_config=scn.sched.to_config(),
                           max_seq=scn.max_seq, latency=be)
            self._sims[scn.sim_key] = sim
        return sim

    # -- evaluation -----------------------------------------------------

    def _cost(self, scn: Scenario, makespan: float) -> float:
        return self.hw_cost.get(scn.hardware, 1.0) * scn.tp * makespan

    def _result(self, scn: Scenario, mode: str, makespan: float,
                n_iterations: int, met: Dict[str, np.ndarray],
                index: int, degraded: bool = False) -> ScenarioResult:
        ttft, tpot = met["ttft"], met["tpot"]
        n_generated = int(met["_n_generated"])
        hits = met.get("cache_hit_tokens")
        return ScenarioResult(
            scenario=scn, mode=mode, makespan=makespan,
            n_iterations=n_iterations,
            ttft_mean=float(ttft.mean()) if len(ttft) else 0.0,
            ttft_p50=float(np.percentile(ttft, 50)) if len(ttft) else 0.0,
            ttft_p90=float(np.percentile(ttft, 90)) if len(ttft) else 0.0,
            tpot_mean=float(tpot.mean()) if len(tpot) else 0.0,
            tpot_p50=float(np.percentile(tpot, 50)) if len(tpot) else 0.0,
            tpot_p90=float(np.percentile(tpot, 90)) if len(tpot) else 0.0,
            tokens_per_s=n_generated / makespan if makespan > 0 else 0.0,
            cost=self._cost(scn, makespan), index=index, degraded=degraded,
            cache_hit_tokens=int(hits.sum()) if hits is not None else 0)

    @staticmethod
    def _degraded(sim: DoolySim) -> bool:
        return bool(getattr(sim.latency, "degraded", False))

    def iter_results(self, scenarios: Sequence[Scenario], *,
                     on_error: str = "report", workers: int = 1,
                     oversubscribe: bool = False
                     ) -> Iterator[ScenarioResult]:
        """Stream per-scenario results as fit groups complete.

        Exact-replay scenarios are grouped by simulator (i.e. fitted
        model); each group's traces evaluate in one batched
        ``predict_traces`` pass and its scenarios yield immediately —
        identical numerics to ``run``, but a million-scenario grid
        produces its first results after one group instead of after the
        whole grid.  Staggered scenarios follow, grouped by (request
        structure, scheduler config): the group leader runs the
        event-driven engine once and records a :class:`StaggeredTrace`;
        every other member prices the trace in one batched
        ``predict_trace``, reuses it outright when its admission walk
        validates end-to-end, and otherwise fast-forwards the validated
        prefix and simulates only the tail.  Forced-loop scenarios
        (``engine="loop"``) trail, one at a time.  Yield order is
        completion order; ``ScenarioResult.index`` maps back to the
        submitted grid.  ``self.last_summary`` carries the run counters
        once the generator is exhausted.

        ``workers > 1`` shards the grid's evaluation units across spawn
        processes, each reopening the store's database read-only-in-
        practice (WAL readers share safely) and running this same serial
        evaluator on its shard — results are bit-identical to serial
        because shards are closed under the grouping keys above (a fit
        group's batch never splits).  The effective worker count clamps
        to ``min(workers, os.cpu_count(), n_units)`` with a warning
        (``oversubscribe=True`` lifts the cpu clamp); in-memory stores
        and unpicklable ``config_fn``s fall back to serial with a
        warning.

        ``on_error="report"`` (default) collects per-scenario evaluation
        errors into ``self.last_failures`` (each a
        :class:`ScenarioFailure`) and keeps going, so one poisoned
        scenario — an unprofiled model, a backend that can't build —
        costs that scenario, not the grid; a crashed worker process
        fails its shard's scenarios with ``stage="worker"``.
        ``on_error="raise"`` restores fail-fast propagation."""
        if on_error not in ("report", "raise"):
            raise ValueError(f"on_error must be 'report' or 'raise', "
                             f"got {on_error!r}")
        scenarios = list(scenarios)
        if workers > 1 and self._parallel_ok():
            return self._iter_parallel(scenarios, on_error=on_error,
                                       workers=workers,
                                       oversubscribe=oversubscribe)
        return self._iter_serial(scenarios, on_error=on_error)

    def _iter_serial(self, scenarios: List[Scenario], *,
                     on_error: str) -> Iterator[ScenarioResult]:
        t0 = time.perf_counter()
        self.last_summary = None
        self.last_failures = []

        def fail(i: int, stage: str, exc: Exception):
            if on_error == "raise":
                raise exc
            self.last_failures.append(ScenarioFailure(
                index=i, scenario=scenarios[i], stage=stage,
                error=f"{type(exc).__name__}: {exc}"))

        # classify: exact-replay (latency-independent) vs staggered
        # (event-driven, or forced-loop under engine="loop").
        # used_* track THIS run's distinct traces/sims — the memos persist
        # across calls, so their sizes would overcount on reuse.
        exact_groups: Dict[Tuple, List[int]] = {}
        stag_groups: Dict[Tuple, List[int]] = {}
        loop_idx: List[int] = []
        used_traces: set = set()
        n_degraded = 0
        for i, scn in enumerate(scenarios):
            try:
                dependence = latency_dependence(
                    self.requests(scn.workload))
                if dependence != "staggered":
                    trace = self.plan_trace(scn)
            except Exception as e:
                fail(i, "workload", e)
                continue
            if dependence != "staggered":
                used_traces.add(id(trace))
                key = (self._trace_content_key(trace), scn.sim_key)
                exact_groups.setdefault(key, []).append(i)
            elif self.engine == "loop":
                loop_idx.append(i)
            else:
                key = (self._structure_key(scn.workload), scn.sched)
                stag_groups.setdefault(key, []).append(i)

        # one batched prediction pass per fit group (= per simulator);
        # dict insertion order keeps the flattened trace order identical
        # to the pre-streaming single predict_scenarios pass.  A sim that
        # fails to build fails every scenario in its exact group; a
        # failed batched prediction fails every scenario under that sim.
        by_sim: Dict[int, Tuple[DoolySim,
                                List[Tuple[PlanTrace, List[int]]]]] = {}
        for key, idxs in exact_groups.items():
            try:
                sim = self.sim(scenarios[idxs[0]])
            except Exception as e:
                for i in idxs:
                    fail(i, "build", e)
                continue
            trace = self.plan_trace(scenarios[idxs[0]])
            by_sim.setdefault(id(sim), (sim, []))[1].append((trace, idxs))
        for sim, group in by_sim.values():
            try:
                lats = sim.predict_traces([trace.plans
                                           for trace, _ in group])
            except Exception as e:
                for _, idxs in group:
                    for i in idxs:
                        fail(i, "predict", e)
                continue
            degraded = self._degraded(sim)
            for (trace, idxs), lat in zip(group, lats):
                clocks = trace.times(lat)
                met = trace.metrics(lat, times=clocks)
                met["_n_generated"] = int(trace.generated.sum())
                makespan = trace.makespan(lat, times=clocks)
                n_degraded += len(idxs) if degraded else 0
                for j, i in enumerate(idxs):
                    yield self._result(
                        scenarios[i], "replay" if j == 0 else "replay-dedup",
                        makespan, trace.n_iterations, met, index=i,
                        degraded=degraded)

        # staggered scenarios: event-driven engine with prefix-shared
        # traces.  Every completed run in a group records its trace, and
        # each follower validates against *all* cached traces — a
        # divergence walk costs microseconds, a prefix-resumed simulation
        # costs milliseconds, so trying every trace for a full validation
        # (or the deepest prefix) is almost always a win.  The cache is
        # per-call on purpose — traces depend on backend latencies, and
        # reusing them across runs would make mode labels (and counters)
        # order-dependent.
        n_events = 0
        n_events_shared = 0
        for key, idxs in stag_groups.items():
            cached: List[Tuple[StaggeredTrace, int]] = []
            for i in idxs:
                scn = scenarios[i]
                try:
                    sim = self.sim(scn)
                except Exception as e:
                    fail(i, "build", e)
                    continue
                try:
                    reqs = clone_sorted(self.requests(scn.workload))
                    sched_cfg = scn.sched.to_config()
                    # best = (d, trace, lat, clocks, origin): the first
                    # fully-valid trace, else the deepest valid prefix
                    best = None
                    for trace, origin in cached:
                        lat = sim.predict_trace(trace.plans)
                        clocks, d = trace.divergence(lat)
                        if best is None or d > best[0]:
                            best = (d, trace, lat, clocks, origin)
                        if d == trace.n_iterations:
                            break
                    if best is not None and best[0] == best[1].n_iterations:
                        d, trace, lat, clocks, origin = best
                        mode = ("events-dedup" if id(sim) == origin
                                else "events-shared")
                        makespan = (float(clocks[-1]) if len(clocks)
                                    else 0.0)
                        n_iter = trace.n_iterations
                        met = trace.metrics_at(clocks)
                        met["_n_generated"] = int(trace.generated.sum())
                    else:
                        pre = None
                        if best is not None and best[0] > 0:
                            pre = (best[1], best[2], best[0])
                        res = run_events(reqs, sched_cfg, sim.latency,
                                         record_trace=True, prefix=pre)
                        cached.append((res["trace"], id(sim)))
                        mode = "events"
                        makespan = res["makespan"]
                        n_iter = len(res["iterations"])
                        met = request_metrics(res["requests"])
                        met["_n_generated"] = sum(
                            r.generated for r in res["requests"])
                except Exception as e:
                    fail(i, "events", e)
                    continue
                degraded = self._degraded(sim)
                n_degraded += 1 if degraded else 0
                n_events += 1
                n_events_shared += mode in ("events-dedup", "events-shared")
                yield self._result(scn, mode, makespan, n_iter, met,
                                   index=i, degraded=degraded)

        # forced-loop scenarios (engine="loop"): per-scenario interleaved
        # reference run (predictions still memoized per fit group)
        for i in loop_idx:
            scn = scenarios[i]
            try:
                sim = self.sim(scn)
            except Exception as e:
                fail(i, "build", e)
                continue
            try:
                res = sim.run(clone_sorted(self.requests(scn.workload)),
                              engine="loop")
                met = request_metrics(res["requests"])
                met["_n_generated"] = sum(r.generated
                                          for r in res["requests"])
            except Exception as e:
                fail(i, "loop", e)
                continue
            degraded = self._degraded(sim)
            n_degraded += 1 if degraded else 0
            yield self._result(scn, "loop", res["makespan"],
                               len(res["iterations"]), met, index=i,
                               degraded=degraded)

        n_dedup = sum(len(idxs) - 1 for idxs in exact_groups.values())
        self.last_summary = {
            "scenarios": len(scenarios),
            "exact_replay": sum(len(v) for v in exact_groups.values()),
            "events": n_events,
            "events_shared": n_events_shared,
            "full_loop": len(loop_idx),
            "deduped": n_dedup,
            "plan_replays": len(used_traces),
            "sims": len({s.sim_key for s in scenarios}),
            "fit_groups": len({s.fit_key for s in scenarios}),
            "failed": len(self.last_failures),
            "degraded": n_degraded,
            "elapsed_s": time.perf_counter() - t0,
        }

    # -- parallel evaluation --------------------------------------------

    def _parallel_ok(self) -> bool:
        """Whether this sweep can shard evaluation across processes;
        warns and returns False (serial fallback) when it can't."""
        if self.store.closed or self.store.path == ":memory:":
            warnings.warn(
                "parallel sweep evaluation needs a file-backed store "
                "(workers reopen the database by path); evaluating "
                "serially", RuntimeWarning, stacklevel=3)
            return False
        try:
            pickle.dumps((self.config_fn, self.hw_cost))
        except Exception as e:
            warnings.warn(
                "parallel sweep evaluation needs a picklable config_fn "
                f"({type(e).__name__}: {e}); evaluating serially",
                RuntimeWarning, stacklevel=3)
            return False
        return True

    def _parallel_units(self, scenarios: List[Scenario],
                        fail: Callable) -> List[List[int]]:
        """Partition scenario indices into evaluation units closed under
        the serial grouping keys — every exact-replay scenario of one
        simulator, every staggered scenario of one (structure, sched)
        trace-sharing group — so a unit's batched predictions and shared
        traces never split across workers and per-worker evaluation is
        bit-identical to serial.  Forced-loop scenarios are independent
        and shard singly."""
        units: Dict[Tuple, List[int]] = {}
        for i, scn in enumerate(scenarios):
            try:
                dependence = latency_dependence(
                    self.requests(scn.workload))
            except Exception as e:
                fail(i, "workload", e)
                continue
            if dependence != "staggered":
                key: Tuple = ("exact", scn.sim_key)
            elif self.engine == "loop":
                key = ("loop", i)
            else:
                key = ("stag", self._structure_key(scn.workload),
                       scn.sched)
            units.setdefault(key, []).append(i)
        return list(units.values())

    @staticmethod
    def _bundle_units(units: List[List[int]],
                      n: int) -> List[List[int]]:
        """Greedy longest-first packing of units into ``n`` worker
        bundles balanced by scenario count; deterministic (ties break on
        first scenario index)."""
        order = sorted(range(len(units)),
                       key=lambda u: (-len(units[u]), units[u][0]))
        heap = [(0, b) for b in range(n)]
        heapq.heapify(heap)
        bundles: List[List[int]] = [[] for _ in range(n)]
        for u in order:
            load, b = heapq.heappop(heap)
            bundles[b].extend(units[u])
            heapq.heappush(heap, (load + len(units[u]), b))
        # original submission order within a bundle keeps the worker's
        # group-discovery order identical to serial's on that subset
        return [sorted(b) for b in bundles if b]

    def _iter_parallel(self, scenarios: List[Scenario], *,
                       on_error: str, workers: int,
                       oversubscribe: bool) -> Iterator[ScenarioResult]:
        t0 = time.perf_counter()
        self.last_summary = None
        self.last_failures = []

        def fail(i: int, stage: str, exc: Exception):
            if on_error == "raise":
                raise exc
            self.last_failures.append(ScenarioFailure(
                index=i, scenario=scenarios[i], stage=stage,
                error=f"{type(exc).__name__}: {exc}"))

        units = self._parallel_units(scenarios, fail)
        eff = min(workers, max(1, len(units)))
        cpu = os.cpu_count() or 1
        if not oversubscribe:
            eff = min(eff, cpu)
        if eff < workers:
            warnings.warn(
                f"clamping sweep evaluation workers {workers} -> {eff} "
                f"({len(units)} evaluation unit(s), {cpu} cpu(s))",
                RuntimeWarning, stacklevel=3)
        if eff <= 1 or not units:
            # classification failures re-derive identically in the
            # serial pass, so delegating wholesale is safe
            yield from self._iter_serial(scenarios, on_error=on_error)
            return

        store_kw = dict(path=self.store.path,
                        hardware=self.store.hardware,
                        oracle=self.store.oracle,
                        sweep=self.store.profile_sweep,
                        wal=self.store.wal,
                        device=self.store.device)
        sweep_kw = dict(config_fn=self.config_fn, hw_cost=self.hw_cost,
                        use_saved_fits=self.use_saved_fits,
                        latency=self.latency_name, engine=self.engine)
        bundles = self._bundle_units(units, eff)
        summaries: List[Dict[str, float]] = []
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=eff, mp_context=ctx) as pool:
            futs = {pool.submit(_eval_worker, store_kw, sweep_kw,
                                [scenarios[i] for i in bundle],
                                on_error): bundle
                    for bundle in bundles}
            for fut in as_completed(futs):
                bundle = futs[fut]
                try:
                    results, failures, summary = fut.result()
                except Exception as e:
                    if on_error == "raise":
                        raise
                    for i in bundle:
                        self.last_failures.append(ScenarioFailure(
                            index=i, scenario=scenarios[i],
                            stage="worker",
                            error=f"{type(e).__name__}: {e}"))
                    continue
                for f in failures:
                    f.index = bundle[f.index]
                    f.scenario = scenarios[f.index]
                    self.last_failures.append(f)
                summaries.append(summary)
                for r in results:
                    r.index = bundle[r.index]
                    r.scenario = scenarios[r.index]
                    yield r
        agg = {k: sum(s[k] for s in summaries) for k in
               ("exact_replay", "events", "events_shared", "full_loop",
                "deduped", "plan_replays", "degraded")}
        self.last_summary = {
            "scenarios": len(scenarios),
            "exact_replay": agg["exact_replay"],
            "events": agg["events"],
            "events_shared": agg["events_shared"],
            "full_loop": agg["full_loop"],
            "deduped": agg["deduped"],
            "plan_replays": agg["plan_replays"],
            "sims": len({s.sim_key for s in scenarios}),
            "fit_groups": len({s.fit_key for s in scenarios}),
            "failed": len(self.last_failures),
            "degraded": agg["degraded"],
            "elapsed_s": time.perf_counter() - t0,
            "workers": eff,
        }

    def run(self, scenarios: Sequence[Scenario], *,
            on_error: str = "report", workers: int = 1,
            oversubscribe: bool = False) -> SweepResult:
        """Evaluate the grid; failed scenarios (``on_error="report"``)
        are dropped from ``results`` and itemized in ``.failures``.
        ``workers > 1`` shards evaluation units across spawn processes
        (see :meth:`iter_results`)."""
        scenarios = list(scenarios)
        slots: List[Optional[ScenarioResult]] = [None] * len(scenarios)
        for r in self.iter_results(scenarios, on_error=on_error,
                                   workers=workers,
                                   oversubscribe=oversubscribe):
            slots[r.index] = r
        return SweepResult(results=[r for r in slots if r is not None],
                           summary=dict(self.last_summary),
                           failures=list(self.last_failures))


def _eval_worker(store_kw: Dict, sweep_kw: Dict,
                 scenarios: List[Scenario], on_error: str):
    """Evaluate one shard of a scenario grid in a spawned process.

    Reopens the profile store by path (WAL readers share the file; fit
    write-back degrades to in-memory on contention with identical
    coefficients), runs the serial evaluator on the shard, and returns
    the shard-local results/failures/summary for the coordinator to
    remap into grid indices."""
    from repro_torch.api.store import ProfileStore
    with ProfileStore(**store_kw) as store:
        sweep = Sweep(store, **sweep_kw)
        results = list(sweep._iter_serial(list(scenarios),
                                          on_error=on_error))
        return results, sweep.last_failures, sweep.last_summary


#: metrics the calibration diff reports (ScenarioResult fields)
COMPARE_METRICS = ("ttft_mean", "tpot_mean", "makespan")


def compare_results(primary: SweepResult, reference: SweepResult,
                    metrics: Sequence[str] = COMPARE_METRICS) -> Dict:
    """Per-scenario fit-error report between two sweeps of the *same*
    grid under different latency backends — the calibration diff
    (``python -m repro_torch.sweep --compare-latency oracle``).

    For each scenario and metric: relative error of the primary backend
    against the reference, ``(primary - reference) / reference`` (0 when
    both are 0; None when the reference is 0 and the primary is not —
    undefined, kept out of the aggregates but counted).  Aggregates are
    mean/max of |rel err| per metric, the corpus-wide fit-quality
    number."""
    if len(primary.results) != len(reference.results):
        raise ValueError("sweeps cover different grids "
                         f"({len(primary.results)} vs "
                         f"{len(reference.results)} scenarios)")
    rows = []
    for a, b in zip(primary.results, reference.results):
        if a.scenario != b.scenario:
            raise ValueError(f"scenario mismatch at index {a.index}: "
                             f"{a.scenario.label()} vs "
                             f"{b.scenario.label()}")
        errs = {}
        for m in metrics:
            va, vb = getattr(a, m), getattr(b, m)
            errs[m] = 0.0 if va == vb else \
                (va - vb) / vb if vb else None
        rows.append({"scenario": a.scenario.label(), "index": a.index,
                     "mode": a.mode, **{f"err_{m}": e
                                        for m, e in errs.items()}})
    agg = {}
    for m in metrics:
        defined = np.array([abs(r[f"err_{m}"]) for r in rows
                            if r[f"err_{m}"] is not None])
        agg[m] = {"mean_abs_rel_err": float(defined.mean())
                  if len(defined) else 0.0,
                  "max_abs_rel_err": float(defined.max())
                  if len(defined) else 0.0,
                  "n_undefined": sum(r[f"err_{m}"] is None for r in rows)}
    return {"metrics": list(metrics), "scenarios": rows, "aggregate": agg}


def compare_table(diff: Dict) -> str:
    """Render a ``compare_results`` report as the CLI table."""
    metrics = diff["metrics"]
    head = f"{'scenario':58s} " + " ".join(f"{'err.' + m:>14s}"
                                           for m in metrics)
    lines = [head, "-" * len(head)]
    for r in diff["scenarios"]:
        lines.append(f"{r['scenario']:58s} "
                     + " ".join(f"{r[f'err_{m}'] * 100:+13.3f}%"
                                if r[f"err_{m}"] is not None
                                else f"{'undef':>14s}"
                                for m in metrics))
    lines.append("-" * len(head))
    lines.append("corpus " + "  ".join(
        f"{m}: mean {diff['aggregate'][m]['mean_abs_rel_err'] * 100:.3f}% "
        f"max {diff['aggregate'][m]['max_abs_rel_err'] * 100:.3f}%"
        + (f" ({diff['aggregate'][m]['n_undefined']} undef)"
           if diff['aggregate'][m]['n_undefined'] else "")
        for m in metrics))
    return "\n".join(lines)
