"""Analytic queueing tier: price a (scenario, replicas, load) point
from fitted per-iteration latencies alone — no scheduler replay.

The exact tiers (``sim.replay`` / ``sim.events``) walk every iteration
the scheduler would run.  Capacity search over (model x sched x replica
count) grids needs something orders of magnitude cheaper to prune with,
so this module prices a deployment point with a **fluid-limit / M/G/c-
style** model built on two observations about the Sarathi-style
continuous-batching scheduler (``repro.serving.scheduler``):

1. A running request receives exactly one token per iteration while
   decoding and one ``chunk_size`` chunk per iteration while prefilling,
   so its *slot-iteration* demand is structural::

       I_req = ceil(prefill_tokens / chunk_size) + (max_new_tokens - 1)

   (the first token is emitted with the final prefill chunk; prefix
   caching removes ``cached_prefix`` tokens from the prefill demand,
   with at least one token always prefilling).

2. In steady state at concurrency ``c``, the *composition* of an
   iteration follows from the per-request demand mix: ``c * frac_dec``
   decode tokens plus ``c * frac_pre_tokens`` prefill tokens, clamped
   to the scheduler's ``max_batch_tokens`` budget (a binding budget
   stretches prefill over proportionally more iterations).  That
   representative iteration is a plain ``(chunk_lengths, n_decodes)``
   plan the :class:`~repro.api.backends.LatencyBackend` protocol prices
   directly — the only latency information the model consumes.

A damped fixed point couples concurrency to load through Little's law
(``c = lambda_r * residence``); a second, saturated evaluation at
``c = max_num_seqs`` gives the per-replica capacity ``lambda_max`` and
hence utilization ``rho = lambda_r / lambda_max``.  Estimates:

* ``tpot``     — the converged iteration time (one token per iteration);
* ``ttft``     — prefill iterations at the operating point plus an
  M/G/c queueing wait (Sakasegawa's approximation below saturation, the
  mean fluid backlog above);
* ``makespan`` — ``max(horizon + residence, work)``: arrival-bound when
  underloaded, work-bound when the per-replica busy time exceeds the
  arrival horizon (burst workloads are the pure work-bound limit);
* ``cost``     — ``hw_price * tp * replicas * makespan``, the sweep's
  cost convention summed over replicas.

Accuracy bound
--------------
The estimator is gated against the exact event engine on staggered
(finite-rate) scenarios: relative error of TPOT (vs the exact mean) and
makespan stays within :data:`ANALYTIC_TPOT_BOUND` /
:data:`ANALYTIC_MAKESPAN_BOUND` on the gated scenarios of the
``optimize`` perf section (``benchmarks/perf.py``) and the tier-1 test
suite.  The bound is deterministic — fits, workloads, and the fixed
point are all seeded/closed-form — so it is a hard gate, not a
statistical one.  Near saturation (``rho ~ 1``) fluid models are at
their weakest; ``repro.optimize.search`` therefore treats analytic
numbers only as a pruning/ranking signal and confirms finalists with
the exact tier.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.scheduler import Request, SchedulerConfig

#: documented relative-error bound of the analytic TPOT estimate vs the
#: exact event engine's mean TPOT on the gated staggered scenarios
#: (which span underload through ~2x overload; observed errors peak
#: around 0.31 at saturation, where fluid mixing is coarsest)
ANALYTIC_TPOT_BOUND = 0.40
#: documented relative-error bound of the analytic makespan estimate vs
#: the exact event engine's makespan on the gated staggered scenarios
#: (observed errors stay under ~0.09; arrival-bound regimes are near
#: exact by construction)
ANALYTIC_MAKESPAN_BOUND = 0.25

#: fixed-point iterations (damped; converges in a handful)
_FP_ITERS = 16


def _finite(x: float) -> Optional[float]:
    return float(x) if math.isfinite(x) else None


@dataclass(frozen=True)
class WorkloadStats:
    """Structural summary of a request list — everything the fluid model
    needs, nothing the scheduler's token content would add."""
    n: int                     # requests
    horizon: float             # last arrival time (0 for burst)
    rate: float                # offered requests/s (inf for burst)
    mean_prefill_tokens: float  # post-prefix-cache prompt tokens/request
    mean_chunks: float         # prefill iterations/request
    mean_decodes: float        # decode iterations/request
    mean_generated: float      # emitted tokens/request

    @classmethod
    def of(cls, requests: Sequence[Request],
           sched: SchedulerConfig) -> "WorkloadStats":
        if not requests:
            raise ValueError("cannot summarize an empty workload")
        n = len(requests)
        chunk = max(1, sched.chunk_size)
        pre = chunks = dec = gen = 0.0
        horizon = 0.0
        for r in requests:
            p = r.prompt_len
            if sched.prefix_caching and r.cached_prefix > 0:
                p = max(p - r.cached_prefix, 1)
            pre += p
            chunks += math.ceil(p / chunk)
            dec += max(r.max_new_tokens - 1, 0)
            gen += r.max_new_tokens
            horizon = max(horizon, r.arrival)
        rate = n / horizon if horizon > 0 else math.inf
        return cls(n=n, horizon=horizon, rate=rate,
                   mean_prefill_tokens=pre / n, mean_chunks=chunks / n,
                   mean_decodes=dec / n, mean_generated=gen / n)


@dataclass(frozen=True)
class AnalyticEstimate:
    """One priced (scenario, replicas, offered load) point."""
    replicas: int
    rate: float                # offered requests/s across the deployment
    utilization: float         # rho = per-replica rate / capacity
    capacity: float            # per-replica sustainable requests/s
    concurrency: float         # steady-state busy slots per replica
    iter_time: float           # representative iteration latency (s)
    tpot: float                # est. seconds per output token
    ttft: float                # est. queueing wait + prefill service (s)
    makespan: float            # est. completion time of the workload (s)
    tokens_per_s: float        # est. generated-token throughput
    cost: float                # hw_price * tp * replicas * makespan

    def to_json(self) -> Dict:
        return {k: _finite(getattr(self, k)) if k != "replicas"
                else self.replicas
                for k in ("replicas", "rate", "utilization", "capacity",
                          "concurrency", "iter_time", "tpot", "ttft",
                          "makespan", "tokens_per_s", "cost")}


def _iteration_plan(prefill_tokens: float, decodes: float,
                    chunk: int) -> tuple:
    """The representative steady-state iteration as a recorded-plan
    tuple ``(chunk_lengths, n_decodes)`` the backend protocol prices."""
    k, rem = divmod(max(prefill_tokens, 0.0), chunk)
    lengths = [chunk] * int(k)
    if rem >= 1.0:
        lengths.append(int(round(rem)))
    return tuple(lengths), int(round(decodes))


def _compose(stats: WorkloadStats, sched: SchedulerConfig, backend,
             c: float) -> tuple:
    """Iteration composition and latency at concurrency ``c``: returns
    ``(iter_time, slot_iters_eff, decodes, prefill_tokens)`` where
    ``slot_iters_eff`` is the per-request slot-iteration demand after
    any budget-bound prefill stretch."""
    budget = max(1, sched.max_batch_tokens)
    chunk = max(1, sched.chunk_size)
    slot_iters = stats.mean_chunks + stats.mean_decodes
    stretch = 1.0
    d = p = 0.0
    for _ in range(4):
        eff = stats.mean_chunks * stretch + stats.mean_decodes
        d = c * stats.mean_decodes / eff if eff > 0 else 0.0
        d = min(d, float(budget))
        p_want = c * stats.mean_prefill_tokens / eff if eff > 0 else 0.0
        p = min(p_want, max(budget - d, float(min(chunk, budget))))
        new_stretch = p_want / p if p > 0 and p_want > p else 1.0
        if abs(new_stretch - stretch) < 1e-9:
            stretch = new_stretch
            break
        stretch = new_stretch
    slot_iters_eff = stats.mean_chunks * stretch + stats.mean_decodes
    if slot_iters_eff <= 0:
        slot_iters_eff = max(slot_iters, 1.0)
    plan = _iteration_plan(p, d, chunk)
    if not plan[0] and plan[1] == 0:
        plan = ((), 1) if stats.mean_decodes > 0 else ((chunk,), 0)
    t_iter = float(backend.predict_plan(plan))
    return t_iter, slot_iters_eff, d, p


def analytic_estimate(requests_or_stats, sched: SchedulerConfig, backend,
                      *, replicas: int = 1, hw_price: float = 1.0,
                      tp: int = 1) -> AnalyticEstimate:
    """Price one deployment point from per-iteration latencies alone.

    ``requests_or_stats`` is a built request list or a precomputed
    :class:`WorkloadStats`; ``backend`` is any
    :class:`~repro.api.backends.LatencyBackend` (roofline for the
    configuration-agnostic pruning pass, dooly for fitted ranking).
    ``replicas`` splits the offered load evenly (the round-robin router
    of ``WorkloadSpec.shard``); ``hw_price``/``tp`` feed the sweep's
    cost convention.  See the module docstring for the model and its
    gated accuracy bound.
    """
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    stats = (requests_or_stats
             if isinstance(requests_or_stats, WorkloadStats)
             else WorkloadStats.of(requests_or_stats, sched))
    B = max(1, sched.max_num_seqs)
    n_r = stats.n / replicas
    rate_r = stats.rate / replicas

    # saturated composition: per-replica capacity (requests/s at c = B)
    c_sat = min(float(B), max(n_r, 1.0))
    t_sat, eff_sat, _, _ = _compose(stats, sched, backend, c_sat)
    capacity = c_sat / (eff_sat * t_sat) if eff_sat * t_sat > 0 \
        else math.inf
    rho = rate_r / capacity if capacity > 0 else math.inf

    # operating point: Little's-law fixed point for the concurrency the
    # replica actually runs at (saturated workloads stay at c_sat)
    c = c_sat
    t_iter, eff, _, _ = t_sat, eff_sat, None, None
    if math.isfinite(rate_r) and rho < 1.0:
        for _ in range(_FP_ITERS):
            t_iter, eff, _, _ = _compose(stats, sched, backend, c)
            resid = eff * t_iter
            c_new = min(c_sat, max(rate_r * resid, 1.0))
            if abs(c_new - c) < 1e-6:
                c = c_new
                break
            c = 0.5 * c + 0.5 * c_new
        t_iter, eff, _, _ = _compose(stats, sched, backend, c)

    # TPOT: the iteration a *decoding* request experiences — itself as
    # one decode plus the other (c - 1) busy slots' pro-rata mix (a
    # request never shares an iteration with its own prefill)
    others = max(c - 1.0, 0.0)
    d_tpot = 1.0 + others * stats.mean_decodes / eff
    budget = max(1, sched.max_batch_tokens)
    chunkw = max(1, sched.chunk_size)
    p_tpot = min(others * stats.mean_prefill_tokens / eff,
                 max(budget - d_tpot, 0.0))
    tpot = float(backend.predict_plan(
        _iteration_plan(p_tpot, max(d_tpot, 1.0), chunkw)))

    resid = eff * t_iter
    # queueing wait for a slot: Sakasegawa's M/G/c approximation below
    # saturation, mean fluid backlog above it
    work = n_r * eff * t_iter / max(c, 1e-12)
    if math.isfinite(rho) and rho < 0.99:
        wait = (rho ** math.sqrt(2.0 * (B + 1)) / (B * (1.0 - rho))) \
            * resid
    else:
        wait = max(work - stats.horizon, 0.0) / 2.0
    stretch = (eff - stats.mean_decodes) / max(stats.mean_chunks, 1e-12)
    ttft = wait + stats.mean_chunks * max(stretch, 1.0) * t_iter
    makespan = max(stats.horizon + resid, work)
    tokens = stats.n * stats.mean_generated
    return AnalyticEstimate(
        replicas=replicas, rate=stats.rate, utilization=rho,
        capacity=capacity, concurrency=c, iter_time=t_iter,
        tpot=tpot, ttft=ttft, makespan=makespan,
        tokens_per_s=tokens / makespan if makespan > 0 else 0.0,
        cost=hw_price * tp * replicas * makespan)


def accuracy_report(estimates: Sequence[AnalyticEstimate],
                    exact: Sequence[Dict]) -> Dict:
    """Relative-error report of analytic estimates against exact-tier
    results (dicts with ``tpot_mean``/``makespan`` — e.g.
    ``ScenarioResult.to_json()``).  The max errors are what the perf
    gate holds under :data:`ANALYTIC_TPOT_BOUND` /
    :data:`ANALYTIC_MAKESPAN_BOUND`."""
    if len(estimates) != len(exact):
        raise ValueError(f"length mismatch: {len(estimates)} estimates "
                         f"vs {len(exact)} exact results")
    rows: List[Dict] = []
    for est, ref in zip(estimates, exact):
        err_t = abs(est.tpot - ref["tpot_mean"]) / ref["tpot_mean"] \
            if ref["tpot_mean"] else 0.0
        err_m = abs(est.makespan - ref["makespan"]) / ref["makespan"] \
            if ref["makespan"] else 0.0
        rows.append({"tpot_est": est.tpot,
                     "tpot_exact": ref["tpot_mean"],
                     "tpot_rel_err": err_t,
                     "makespan_est": est.makespan,
                     "makespan_exact": ref["makespan"],
                     "makespan_rel_err": err_m})
    return {"scenarios": rows,
            "max_tpot_rel_err": max((r["tpot_rel_err"] for r in rows),
                                    default=0.0),
            "max_makespan_rel_err": max(
                (r["makespan_rel_err"] for r in rows), default=0.0),
            "tpot_bound": ANALYTIC_TPOT_BOUND,
            "makespan_bound": ANALYTIC_MAKESPAN_BOUND}
