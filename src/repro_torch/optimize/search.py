"""SLO-driven capacity search: analytic pruning, fitted ranking, exact
confirmation.

The prescriptive question a capacity planner asks — *given this traffic
forecast and these latency SLOs, which (model, scheduler, hardware,
replica count) meets them at minimum cost?* — is answered in three
stages over a declarative :class:`OptimizeSpec` grid:

1. **Prune (analytic tier)** — every (scenario, replica count) point is
   priced by :func:`repro.optimize.analytic.analytic_estimate` under the
   ``analytic_latency`` backend (default ``roofline``: configuration-
   agnostic, needs no profiling).  Points are rejected only when the
   gated error bound says the exact tier could not disagree: a point is
   ``slo``-pruned when its *optimistic* estimate (deflated by the bound)
   still violates the SLO, ``overloaded``-pruned when utilization
   exceeds 1 beyond the bound, and ``dominated``-pruned when a cheaper
   replica count of the same scenario is already analytically safe with
   the bound as margin (plus a one-replica cushion).  Every pruned
   point's report carries the reason.
2. **Rank (fitted tier)** — survivors are re-estimated under the fitted
   ``latency`` backend (default ``dooly``; missing models are profiled
   plan-first through the store) and ordered by estimated cost.
3. **Confirm (exact tier)** — finalists are expanded into one ordinary
   scenario per replica (``WorkloadSpec.shard`` — the deterministic
   round-robin router) and evaluated by the existing :class:`~repro.
   sweep.Sweep` (exact replay / event engine, ``workers=N`` supported).
   Confirmation is *bound-aware*: after each batch of ``top_k``, the
   next candidate is only skipped when even its bound-deflated estimated
   cost cannot beat the best exactly-confirmed feasible cost — so under
   the gated analytic bound, staged search returns the same winner the
   exhaustive exact sweep would.

The result is a :class:`CapacityPlan`: per-candidate SLO attainment,
cost, and rejection reasons, plus the exact-confirmed recommendation.
Aggregation across replicas is conservative — a candidate's TTFT/TPOT
p90 is the *worst replica's* p90, its cost the sum of per-replica
accelerator cost, its makespan the slowest replica's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.optimize.analytic import (ANALYTIC_MAKESPAN_BOUND,
                                     ANALYTIC_TPOT_BOUND,
                                     AnalyticEstimate, WorkloadStats,
                                     analytic_estimate)
from repro_torch.sweep.grid import Scenario
from repro_torch.sweep.runner import DEFAULT_HW_COST, ScenarioResult

#: analytic TTFT has no gated bound (queueing-wait estimates are the
#: model's weakest output), so SLO pruning on TTFT deflates by this
#: loose factor instead of the TPOT/makespan bounds
_TTFT_PRUNE_FACTOR = 4.0


@dataclass(frozen=True)
class SLO:
    """Latency service-level objectives, in seconds (None = don't care).
    p90s are checked against the exact tier's worst-replica p90."""
    ttft_p90: Optional[float] = None
    tpot_p90: Optional[float] = None

    def __post_init__(self):
        for name in ("ttft_p90", "tpot_p90"):
            v = getattr(self, name)
            if v is not None and not (v > 0):
                raise ValueError(f"slo {name} must be > 0, got {v!r}")

    @property
    def empty(self) -> bool:
        return self.ttft_p90 is None and self.tpot_p90 is None

    def violations(self, *, ttft_p90: float,
                   tpot_p90: float) -> Dict[str, float]:
        """metric -> attained/target ratio, for each violated target."""
        out: Dict[str, float] = {}
        if self.ttft_p90 is not None and ttft_p90 > self.ttft_p90:
            out["ttft_p90"] = ttft_p90 / self.ttft_p90
        if self.tpot_p90 is not None and tpot_p90 > self.tpot_p90:
            out["tpot_p90"] = tpot_p90 / self.tpot_p90
        return out

    def label(self) -> str:
        parts = [f"{k}<={getattr(self, k):g}s"
                 for k in ("ttft_p90", "tpot_p90")
                 if getattr(self, k) is not None]
        return ",".join(parts) if parts else "none"

    def to_json(self) -> Dict:
        return {"ttft_p90": self.ttft_p90, "tpot_p90": self.tpot_p90}


@dataclass(frozen=True)
class OptimizeSpec:
    """Declarative capacity-search grid: candidate scenarios (each
    carrying the traffic-forecast workload — build them with
    ``sweep.grid.expand_grid``) x replica counts, an :class:`SLO`, and
    staging knobs.  ``top_k`` sizes each exact-confirmation batch;
    ``replica_cushion`` keeps that many replica counts above the first
    analytically-safe one per scenario (domination safety margin)."""
    candidates: Tuple[Scenario, ...]
    replicas: Tuple[int, ...] = (1, 2, 4)
    slo: SLO = field(default_factory=SLO)
    top_k: int = 4
    replica_cushion: int = 1

    def __post_init__(self):
        object.__setattr__(self, "candidates", tuple(self.candidates))
        object.__setattr__(self, "replicas",
                           tuple(sorted(set(self.replicas))))
        if not self.candidates:
            raise ValueError("OptimizeSpec needs at least one candidate "
                             "scenario")
        if not self.replicas or self.replicas[0] < 1:
            raise ValueError(f"replica counts must be >= 1, got "
                             f"{self.replicas!r}")
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.replica_cushion < 0:
            raise ValueError("replica_cushion must be >= 0, got "
                             f"{self.replica_cushion}")

    def points(self) -> List[Tuple[Scenario, int]]:
        return [(s, r) for s in self.candidates for r in self.replicas]


@dataclass
class CandidateReport:
    """One (scenario, replica count) point's fate through the stages."""
    scenario: Scenario
    replicas: int
    #: "pruned" (analytic tier rejected it), "ranked" (survived pruning,
    #: not exactly confirmed), "confirmed" (exact tier evaluated it)
    stage: str = "ranked"
    reason: str = ""                # why pruned / skipped / failed
    analytic: Optional[AnalyticEstimate] = None   # pruning-tier estimate
    ranked: Optional[AnalyticEstimate] = None     # fitted-tier estimate
    exact: Optional[Dict] = None    # aggregated exact-tier metrics
    slo_ok: Optional[bool] = None   # exact-tier SLO attainment
    violations: Dict[str, float] = field(default_factory=dict)

    @property
    def cost(self) -> float:
        """Best-known cost: exact when confirmed, else estimated."""
        if self.exact is not None:
            return self.exact["cost"]
        est = self.ranked or self.analytic
        return est.cost if est is not None else math.inf

    def label(self) -> str:
        return f"{self.scenario.label()} xR{self.replicas}"

    def to_json(self) -> Dict:
        return {"scenario": self.scenario.label(),
                "replicas": self.replicas,
                "stage": self.stage,
                "reason": self.reason,
                "cost": self.cost if math.isfinite(self.cost) else None,
                "analytic": self.analytic.to_json()
                if self.analytic else None,
                "ranked": self.ranked.to_json() if self.ranked else None,
                "exact": self.exact,
                "slo_ok": self.slo_ok,
                "violations": self.violations}


@dataclass
class CapacityPlan:
    """The optimizer's report: every candidate's fate, the exact-
    confirmed recommendation (None when nothing could be confirmed),
    and stage counters.  ``feasible`` is True when the recommendation
    meets the SLO at the exact tier; otherwise the recommendation is
    the best-effort confirmed candidate with the smallest violation."""
    slo: SLO
    candidates: List[CandidateReport]
    recommendation: Optional[CandidateReport]
    feasible: bool
    counters: Dict[str, float] = field(default_factory=dict)

    def table(self) -> str:
        head = (f"{'candidate':64s} {'stage':10s} {'util':>6s} "
                f"{'tpot.p90':>9s} {'ttft.p90':>9s} {'cost':>9s} "
                f"{'slo':>4s}  note")
        lines = [head, "-" * len(head)]
        for c in self.candidates:
            est = c.ranked or c.analytic
            util = est.utilization if est else float("nan")
            tpot = c.exact["tpot_p90"] if c.exact else \
                (est.tpot if est else float("nan"))
            ttft = c.exact["ttft_p90"] if c.exact else \
                (est.ttft if est else float("nan"))
            slo = ("ok" if c.slo_ok else "VIOL") \
                if c.slo_ok is not None else "-"
            mark = " <== recommended" if c is self.recommendation else ""
            note = (c.reason + mark) if c.reason else mark.strip()
            util_s = f"{util:6.2f}" if math.isfinite(util) else "   inf"
            lines.append(
                f"{c.label():64s} {c.stage:10s} {util_s} "
                f"{tpot:9.5f} {ttft:9.5f} {c.cost:9.3f} {slo:>4s}  "
                f"{note}")
        lines.append("-" * len(head))
        if self.recommendation is not None:
            verdict = "meets the SLO" if self.feasible else \
                "BEST EFFORT (no candidate meets the SLO)"
            lines.append(f"recommendation: "
                         f"{self.recommendation.label()} — {verdict} "
                         f"at cost {self.recommendation.cost:.3f} "
                         f"(slo: {self.slo.label()})")
        else:
            lines.append("recommendation: none (no candidate could be "
                         f"confirmed; slo: {self.slo.label()})")
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {"slo": self.slo.to_json(),
                "feasible": self.feasible,
                "counters": self.counters,
                "recommendation": self.recommendation.to_json()
                if self.recommendation else None,
                "candidates": [c.to_json() for c in self.candidates]}


def _shard_scenarios(scn: Scenario, replicas: int) -> List[Scenario]:
    """An R-replica deployment as R ordinary scenarios, one per router
    share (``WorkloadSpec.shard``)."""
    if replicas == 1:
        return [scn]
    return [replace(scn, workload=scn.workload.shard(replicas, i))
            for i in range(replicas)]


def _aggregate_exact(results: Sequence[ScenarioResult]) -> Dict:
    """Conservative cross-replica aggregation: worst-replica latency
    percentiles, summed cost, slowest-replica makespan."""
    makespan = max(r.makespan for r in results)
    generated = sum(r.tokens_per_s * r.makespan for r in results)
    return {"replicas": len(results),
            "ttft_p90": max(r.ttft_p90 for r in results),
            "tpot_p90": max(r.tpot_p90 for r in results),
            "ttft_mean": max(r.ttft_mean for r in results),
            "tpot_mean": max(r.tpot_mean for r in results),
            "makespan": makespan,
            "cost": sum(r.cost for r in results),
            "tokens_per_s": generated / makespan if makespan > 0 else 0.0,
            "modes": sorted({r.mode for r in results})}


class Optimizer:
    """Binds the staged search to one profile store.

    ``latency`` prices the ranking and exact tiers (default the fitted
    ``dooly`` backend); ``analytic_latency`` prices the pruning tier
    (default ``roofline`` — no profiling needed, so pruned models are
    never measured).  ``engine``/``workers`` pass through to the exact
    :class:`~repro.sweep.Sweep`.  See :func:`optimize` for the
    one-call form."""

    def __init__(self, store, *, latency: str = "dooly",
                 analytic_latency: str = "roofline",
                 engine: str = "auto", hw_cost: Optional[Dict] = None,
                 config_fn=None, use_saved_fits: bool = True):
        from repro_torch.configs import get_smoke_config
        self.store = store
        self.config_fn = config_fn or get_smoke_config
        self.hw_cost = dict(DEFAULT_HW_COST if hw_cost is None
                            else hw_cost)
        self.latency = latency
        self.analytic_latency = analytic_latency
        self.sweep = store.sweep(latency=latency, engine=engine,
                                 hw_cost=self.hw_cost,
                                 config_fn=self.config_fn,
                                 use_saved_fits=use_saved_fits)
        self._stats: Dict[Tuple, WorkloadStats] = {}
        self._prune_be: Dict[Tuple, object] = {}

    # -- helpers --------------------------------------------------------

    def _hw_price(self, scn: Scenario) -> float:
        return self.hw_cost.get(scn.hardware, 1.0)

    def stats(self, scn: Scenario) -> WorkloadStats:
        key = (scn.workload, scn.sched.chunk_size,
               scn.sched.prefix_caching)
        st = self._stats.get(key)
        if st is None:
            st = WorkloadStats.of(self.sweep.requests(scn.workload),
                                  scn.sched.to_config())
            self._stats[key] = st
        return st

    def _backend(self, scn: Scenario, name: str):
        """Pruning/ranking backends, memoized like ``Sweep.sim``."""
        if name == self.latency:
            return self.sweep.sim(scn).latency
        key = (name,) + scn.sim_key
        be = self._prune_be.get(key)
        if be is None:
            be = self.store.backend(
                name, self.config_fn(scn.model),
                sched_config=scn.sched.to_config(), max_seq=scn.max_seq,
                backend=scn.backend, tp=scn.tp, hardware=scn.hardware)
            self._prune_be[key] = be
        return be

    def estimate(self, scn: Scenario, replicas: int, *,
                 tier: str = "rank") -> AnalyticEstimate:
        """Analytic estimate of one point under the pruning
        (``tier="prune"``) or fitted ranking backend."""
        name = self.analytic_latency if tier == "prune" else self.latency
        return analytic_estimate(
            self.stats(scn), scn.sched.to_config(),
            self._backend(scn, name), replicas=replicas,
            hw_price=self._hw_price(scn), tp=scn.tp)

    # -- stages ---------------------------------------------------------

    def _prune(self, spec: OptimizeSpec,
               reports: Dict[Tuple, CandidateReport]) -> None:
        slo = spec.slo
        for scn in spec.candidates:
            safe_r: Optional[int] = None
            for r in spec.replicas:
                rep = reports[(scn, r)]
                est = self.estimate(scn, r, tier="prune")
                rep.analytic = est
                rho = est.utilization
                # domination: a cheaper replica count of this scenario
                # is analytically safe even under pessimistic error
                if safe_r is not None and r > safe_r + \
                        spec.replica_cushion:
                    rep.stage = "pruned"
                    rep.reason = (f"dominated: replicas={safe_r} "
                                  "analytically meets the slo at lower "
                                  "cost")
                    continue
                # overload: no steady state, latency slos unmeetable
                if not slo.empty and math.isfinite(rho) \
                        and rho > 1.0 + ANALYTIC_MAKESPAN_BOUND:
                    rep.stage = "pruned"
                    rep.reason = (f"overloaded: utilization "
                                  f"{rho:.2f} > "
                                  f"{1.0 + ANALYTIC_MAKESPAN_BOUND:.2f}")
                    continue
                # slo-infeasible even under the optimistic bound
                opt_tpot = est.tpot / (1.0 + ANALYTIC_TPOT_BOUND)
                if slo.tpot_p90 is not None and opt_tpot > slo.tpot_p90:
                    rep.stage = "pruned"
                    rep.reason = (f"analytic tpot {est.tpot:.5f}s "
                                  f"exceeds slo {slo.tpot_p90:g}s even "
                                  f"optimistically (bound "
                                  f"{ANALYTIC_TPOT_BOUND:g})")
                    continue
                opt_ttft = est.ttft / _TTFT_PRUNE_FACTOR
                if slo.ttft_p90 is not None and opt_ttft > slo.ttft_p90:
                    rep.stage = "pruned"
                    rep.reason = (f"analytic ttft {est.ttft:.5f}s "
                                  f"exceeds slo {slo.ttft_p90:g}s even "
                                  f"at 1/{_TTFT_PRUNE_FACTOR:g}")
                    continue
                # pessimistically safe -> later replica counts dominated
                if safe_r is None and not slo.empty:
                    pess_tpot = est.tpot * (1.0 + ANALYTIC_TPOT_BOUND)
                    pess_ttft = est.ttft * _TTFT_PRUNE_FACTOR
                    tpot_ok = slo.tpot_p90 is None \
                        or pess_tpot <= slo.tpot_p90
                    ttft_ok = slo.ttft_p90 is None \
                        or pess_ttft <= slo.ttft_p90
                    if tpot_ok and ttft_ok and (
                            not math.isfinite(rho) or rho <= 0.75):
                        safe_r = r

    def _profile(self, scenarios: Sequence[Scenario], quiet: bool):
        plan = self.sweep.profile_plan(scenarios)
        if plan is None:
            return
        cov = plan.coverage()
        if not quiet:
            print(f"profiling plan {plan.plan_id}: {cov.naive_tasks} "
                  f"naive -> {cov.plan_tasks} tasks "
                  f"({100 * cov.dedup_frac:.0f}% dedup)")
        self.store.execute(plan)

    def _confirm(self, batch: List[CandidateReport], slo: SLO, *,
                 workers: int, oversubscribe: bool) -> None:
        """Exactly evaluate a batch of candidates in ONE sweep over all
        their replica-shard scenarios."""
        shards: List[Scenario] = []
        spans: List[Tuple[CandidateReport, int, int]] = []
        for rep in batch:
            sub = _shard_scenarios(rep.scenario, rep.replicas)
            spans.append((rep, len(shards), len(shards) + len(sub)))
            shards.extend(sub)
        res = self.sweep.run(shards, on_error="report", workers=workers,
                             oversubscribe=oversubscribe)
        by_index = {r.index: r for r in res.results}
        failed = {f.index: f for f in res.failures}
        for rep, lo, hi in spans:
            errs = [failed[i] for i in range(lo, hi) if i in failed]
            if errs:
                rep.reason = (f"exact tier failed "
                              f"[{errs[0].stage}]: {errs[0].error}")
                rep.slo_ok = False
                continue
            rep.stage = "confirmed"
            rep.exact = _aggregate_exact([by_index[i]
                                          for i in range(lo, hi)])
            rep.violations = slo.violations(
                ttft_p90=rep.exact["ttft_p90"],
                tpot_p90=rep.exact["tpot_p90"])
            rep.slo_ok = not rep.violations

    # -- driver ---------------------------------------------------------

    def run(self, spec: OptimizeSpec, *, workers: int = 1,
            oversubscribe: bool = False, profile: bool = True,
            quiet: bool = True) -> CapacityPlan:
        t0 = time.perf_counter()
        reports = {(scn, r): CandidateReport(scenario=scn, replicas=r)
                   for scn, r in spec.points()}
        ordered = [reports[p] for p in spec.points()]

        self._prune(spec, reports)
        survivors = [c for c in ordered if c.stage != "pruned"]

        # fitted ranking (profile survivors' models plan-first)
        if survivors and profile:
            self._profile([c.scenario for c in survivors], quiet)
        for c in survivors:
            c.ranked = self.estimate(c.scenario, c.replicas, tier="rank")
        ranked = sorted(survivors,
                        key=lambda c: (c.ranked.cost, c.ranked.tpot,
                                       c.label()))

        # bound-aware exact confirmation in top_k batches: stop once no
        # unconfirmed candidate could beat the best feasible exact cost
        # even with its estimate deflated by the makespan bound
        n_confirmed = 0
        best: Optional[float] = None
        pos = 0
        while pos < len(ranked):
            batch = ranked[pos:pos + spec.top_k]
            pos += len(batch)
            self._confirm(batch, spec.slo, workers=workers,
                          oversubscribe=oversubscribe)
            n_confirmed += len(batch)
            feas = [c.exact["cost"] for c in ranked[:pos]
                    if c.stage == "confirmed" and c.slo_ok]
            best = min(feas) if feas else None
            if best is not None and pos < len(ranked):
                nxt = ranked[pos].ranked.cost \
                    / (1.0 + ANALYTIC_MAKESPAN_BOUND)
                if nxt >= best:
                    for c in ranked[pos:]:
                        c.reason = (f"not confirmed: estimated cost "
                                    f"{c.ranked.cost:.3f} cannot beat "
                                    f"confirmed optimum {best:.3f}")
                    break

        confirmed = [c for c in ordered if c.stage == "confirmed"]
        feasible = [c for c in confirmed if c.slo_ok]
        if feasible:
            rec = min(feasible,
                      key=lambda c: (c.exact["cost"],
                                     c.exact["tpot_p90"], c.label()))
            is_feasible = True
        elif confirmed:
            rec = min(confirmed,
                      key=lambda c: (max(c.violations.values(),
                                         default=math.inf),
                                     c.exact["cost"], c.label()))
            is_feasible = False
        else:
            rec, is_feasible = None, False

        counters = {
            "candidates": len(ordered),
            "pruned": sum(c.stage == "pruned" for c in ordered),
            "ranked": len(survivors),
            "confirmed": n_confirmed,
            "feasible": len(feasible),
            "elapsed_s": time.perf_counter() - t0,
        }
        if self.sweep.last_summary:
            counters["exact_tier"] = dict(self.sweep.last_summary)
        return CapacityPlan(slo=spec.slo, candidates=ordered,
                            recommendation=rec, feasible=is_feasible,
                            counters=counters)


def optimize(store, spec: OptimizeSpec, *, workers: int = 1,
             oversubscribe: bool = False, profile: bool = True,
             quiet: bool = True, **kw) -> CapacityPlan:
    """One-call staged capacity search (see :class:`Optimizer`):
    ``optimize(store, spec)`` -> :class:`CapacityPlan`.  Keyword
    arguments split between the :class:`Optimizer` constructor
    (``latency``, ``analytic_latency``, ``engine``, ``hw_cost``,
    ``config_fn``) and the run (``workers``, ``profile``)."""
    return Optimizer(store, **kw).run(spec, workers=workers,
                                      oversubscribe=oversubscribe,
                                      profile=profile, quiet=quiet)
