"""SLO-driven capacity optimizer with an analytic queueing tier.

The sweep layer's Pareto frontier is descriptive; this package is
prescriptive: given a traffic forecast and TTFT/TPOT SLOs, which
(model, scheduler, hardware, replica count) meets them at minimum cost
(cf. AIConfigurator's problem statement on Dooly's cheap-profiling
advantage)?  Three tiers, cheapest first:

* :mod:`repro.optimize.analytic`  — fluid-limit/M-G-c queueing
  estimates from fitted per-iteration latencies alone (no scheduler
  replay), with a documented, test-gated accuracy bound;
* :mod:`repro.optimize.search`    — the staged search (analytic prune
  -> fitted rank -> exact confirm through the existing ``Sweep``)
  producing a :class:`CapacityPlan`;
* :mod:`repro.optimize.autoscale` — deterministic target-utilization
  autoscaler replay over diurnal/spike shaped traces, itemizing SLO
  violations during transients.

    PYTHONPATH=src python -m repro_torch.optimize --help
"""
from repro_torch.optimize.analytic import (ANALYTIC_MAKESPAN_BOUND,  # noqa: F401
                                     ANALYTIC_TPOT_BOUND,
                                     AnalyticEstimate, WorkloadStats,
                                     analytic_estimate)
from repro_torch.optimize.autoscale import (AutoscalePolicy,  # noqa: F401
                                      AutoscaleReport,
                                      simulate_autoscale)
from repro_torch.optimize.search import (SLO, CandidateReport,  # noqa: F401
                                   CapacityPlan, OptimizeSpec,
                                   Optimizer, optimize)

__all__ = ["ANALYTIC_MAKESPAN_BOUND", "ANALYTIC_TPOT_BOUND",
           "AnalyticEstimate", "WorkloadStats", "analytic_estimate",
           "AutoscalePolicy", "AutoscaleReport", "simulate_autoscale",
           "SLO", "CandidateReport", "CapacityPlan", "OptimizeSpec",
           "Optimizer", "optimize"]
