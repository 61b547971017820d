"""Deterministic replica-autoscaling simulation over shaped traces.

A :class:`CapacityPlan` answers the static question — how many replicas
for the *forecast*.  Real traffic has shape (``repro.workload.shapes``:
diurnal swings, spikes), and the operational question is whether a
reactive target-utilization autoscaler keeps the SLO through the
transients: how long does a spike violate latency targets before the
scale-up lands, does the down-scale cooldown prevent flapping, what
does the replica trajectory cost?

:func:`simulate_autoscale` replays a built workload (typically a
diurnal/spike-shaped ``WorkloadSpec``) through a control loop that is
deterministic end to end — no randomness beyond the workload's own
seed:

* time is divided into fixed ``interval``-second control windows;
* each window's offered rate is measured from the arrivals actually in
  it, and the desired replica count is
  ``ceil(rate / (target_utilization * capacity))``, where per-replica
  capacity comes from the analytic tier
  (:func:`~repro.optimize.analytic.analytic_estimate`) — fitted
  per-iteration latencies, no scheduler replay;
* scale-ups/downs apply only after their cooldowns (scale-down also
  requires the rate to have stayed low for a full cooldown, the usual
  anti-flap rule), and replicas are clamped to
  ``[min_replicas, max_replicas]``;
* every window is then priced analytically at (window rate, current
  replicas) and checked against the :class:`~repro.optimize.search.SLO`
  — windows the autoscaler lags behind are the *transient violations*
  the report itemizes.

The report is intentionally analytic (windows x analytic estimate, not
an exact event replay): its purpose is policy comparison — cooldown and
target sweeps over the same shaped trace — where determinism and speed
matter more than per-request fidelity, and the gated analytic bound
says steady-state windows are priced within the documented error.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.optimize.analytic import (AnalyticEstimate, WorkloadStats,
                                     analytic_estimate)
from repro_torch.optimize.search import SLO
from repro_torch.serving.scheduler import Request, SchedulerConfig


@dataclass(frozen=True)
class AutoscalePolicy:
    """Target-utilization reactive autoscaler with cooldowns."""
    min_replicas: int = 1
    max_replicas: int = 8
    target_utilization: float = 0.7
    scale_up_cooldown: float = 0.0      # s between scale-ups
    scale_down_cooldown: float = 60.0   # s of low load before down-scale
    interval: float = 10.0              # control-loop window (s)

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(f"max_replicas {self.max_replicas} < "
                             f"min_replicas {self.min_replicas}")
        if not (0.0 < self.target_utilization <= 1.0):
            raise ValueError(f"target_utilization must be in (0, 1], "
                             f"got {self.target_utilization!r}")
        if self.scale_up_cooldown < 0 or self.scale_down_cooldown < 0:
            raise ValueError("cooldowns must be >= 0")
        if not (self.interval > 0):
            raise ValueError(f"interval must be > 0, got "
                             f"{self.interval!r}")

    def desired(self, rate: float, capacity: float) -> int:
        """Replicas wanted for ``rate`` at ``target_utilization``."""
        if not math.isfinite(rate) or capacity <= 0:
            return self.max_replicas
        want = math.ceil(rate / (self.target_utilization * capacity)) \
            if rate > 0 else self.min_replicas
        return max(self.min_replicas, min(self.max_replicas, want))

    def label(self) -> str:
        return (f"[{self.min_replicas},{self.max_replicas}]"
                f"@{self.target_utilization:g}"
                f"/up{self.scale_up_cooldown:g}s"
                f"/down{self.scale_down_cooldown:g}s"
                f"/i{self.interval:g}s")

    def to_json(self) -> Dict:
        return {k: getattr(self, k) for k in
                ("min_replicas", "max_replicas", "target_utilization",
                 "scale_up_cooldown", "scale_down_cooldown", "interval")}


@dataclass
class AutoscaleWindow:
    """One control window of the trajectory."""
    t: float                  # window start
    arrivals: int             # requests arriving in the window
    rate: float               # offered requests/s in the window
    replicas: int             # replicas serving the window
    desired: int              # what the policy wanted
    utilization: float
    tpot: float               # analytic estimate at (rate, replicas)
    ttft: float
    slo_ok: bool
    violations: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"t": self.t, "arrivals": self.arrivals,
                "rate": self.rate, "replicas": self.replicas,
                "desired": self.desired,
                "utilization": self.utilization
                if math.isfinite(self.utilization) else None,
                "tpot": self.tpot, "ttft": self.ttft,
                "slo_ok": self.slo_ok, "violations": self.violations}


@dataclass
class AutoscaleReport:
    """Deterministic trajectory + transient-SLO accounting."""
    policy: AutoscalePolicy
    slo: SLO
    capacity_per_replica: float       # analytic requests/s per replica
    windows: List[AutoscaleWindow]
    scale_events: List[Dict]          # {"t", "from", "to", "reason"}

    @property
    def violation_seconds(self) -> float:
        return sum(self.policy.interval for w in self.windows
                   if not w.slo_ok)

    @property
    def replica_seconds(self) -> float:
        return sum(w.replicas * self.policy.interval
                   for w in self.windows)

    @property
    def peak_replicas(self) -> int:
        return max((w.replicas for w in self.windows), default=0)

    def table(self) -> str:
        head = (f"{'t':>7s} {'rate':>8s} {'repl':>5s} {'want':>5s} "
                f"{'util':>6s} {'tpot':>9s} {'ttft':>9s}  slo")
        lines = [head, "-" * len(head)]
        for w in self.windows:
            util = f"{w.utilization:6.2f}" \
                if math.isfinite(w.utilization) else "   inf"
            lines.append(f"{w.t:7.3f} {w.rate:8.2f} {w.replicas:5d} "
                         f"{w.desired:5d} {util} {w.tpot:9.5f} "
                         f"{w.ttft:9.5f}  "
                         f"{'ok' if w.slo_ok else 'VIOL'}")
        lines.append("-" * len(head))
        lines.append(f"policy {self.policy.label()}  slo "
                     f"{self.slo.label()}: "
                     f"{self.violation_seconds:g}s in violation over "
                     f"{len(self.windows)} windows, "
                     f"{len(self.scale_events)} scale events, peak "
                     f"{self.peak_replicas} replicas, "
                     f"{self.replica_seconds:g} replica-seconds")
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {"policy": self.policy.to_json(),
                "slo": self.slo.to_json(),
                "capacity_per_replica": self.capacity_per_replica,
                "violation_seconds": self.violation_seconds,
                "replica_seconds": self.replica_seconds,
                "peak_replicas": self.peak_replicas,
                "n_windows": len(self.windows),
                "scale_events": self.scale_events,
                "windows": [w.to_json() for w in self.windows]}


def simulate_autoscale(requests: Sequence[Request],
                       sched: SchedulerConfig, backend,
                       policy: AutoscalePolicy,
                       slo: Optional[SLO] = None, *,
                       hw_price: float = 1.0,
                       tp: int = 1) -> AutoscaleReport:
    """Replay ``requests`` (a built, typically shaped workload) through
    the reactive autoscaler; see the module docstring for the control
    loop.  ``backend`` is any latency backend; all estimates are
    analytic, so the whole trajectory is deterministic."""
    if not requests:
        raise ValueError("cannot autoscale an empty workload")
    slo = slo if slo is not None else SLO()
    stats = WorkloadStats.of(requests, sched)
    sat = analytic_estimate(stats, sched, backend, replicas=1,
                            hw_price=hw_price, tp=tp)
    capacity = sat.capacity

    arrivals = sorted(r.arrival for r in requests)
    horizon = arrivals[-1] if arrivals else 0.0
    n_windows = max(1, math.ceil((horizon + 1e-9) / policy.interval)) \
        if horizon > 0 else 1

    # per-window request mixes stay the workload's mean mix: the shape
    # modulates *rate*, not length distributions (common random numbers)
    replicas = policy.min_replicas          # cold start at the floor
    windows: List[AutoscaleWindow] = []
    events: List[Dict] = []
    last_up = -math.inf
    low_since: Optional[float] = None
    ai = 0
    for k in range(n_windows):
        t0, t1 = k * policy.interval, (k + 1) * policy.interval
        n_arr = 0
        while ai < len(arrivals) and arrivals[ai] < t1:
            n_arr += 1
            ai += 1
        rate = n_arr / policy.interval
        desired = policy.desired(rate, capacity)

        if desired > replicas:
            if t0 - last_up >= policy.scale_up_cooldown:
                events.append({"t": t0, "from": replicas, "to": desired,
                               "reason": f"rate {rate:.2f}/s wants "
                                         f"{desired}"})
                replicas = desired
                last_up = t0
            low_since = None
        elif desired < replicas:
            if low_since is None:
                low_since = t0
            if t0 - low_since >= policy.scale_down_cooldown:
                events.append({"t": t0, "from": replicas, "to": desired,
                               "reason": f"rate {rate:.2f}/s low for "
                                         f"{t0 - low_since:g}s"})
                replicas = desired
                low_since = None
        else:
            low_since = None

        if rate > 0:
            # price the window: the workload's mix at this window's rate
            wstats = WorkloadStats(
                n=max(n_arr, 1), horizon=policy.interval
                if rate > 0 else 0.0, rate=rate,
                mean_prefill_tokens=stats.mean_prefill_tokens,
                mean_chunks=stats.mean_chunks,
                mean_decodes=stats.mean_decodes,
                mean_generated=stats.mean_generated)
            est: AnalyticEstimate = analytic_estimate(
                wstats, sched, backend, replicas=replicas,
                hw_price=hw_price, tp=tp)
            viol = slo.violations(ttft_p90=est.ttft, tpot_p90=est.tpot)
            # a lagging autoscaler is itself a violation signal: wanting
            # more replicas than cooldowns allow marks the transient
            if desired > replicas:
                viol.setdefault("scale_lag",
                                desired / max(replicas, 1))
            windows.append(AutoscaleWindow(
                t=t0, arrivals=n_arr, rate=rate, replicas=replicas,
                desired=desired, utilization=est.utilization,
                tpot=est.tpot, ttft=est.ttft, slo_ok=not viol,
                violations=viol))
        else:
            windows.append(AutoscaleWindow(
                t=t0, arrivals=0, rate=0.0, replicas=replicas,
                desired=desired, utilization=0.0, tpot=0.0, ttft=0.0,
                slo_ok=True))
    return AutoscaleReport(policy=policy, slo=slo,
                           capacity_per_replica=capacity,
                           windows=windows, scale_events=events)
