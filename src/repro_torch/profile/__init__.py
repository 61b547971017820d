"""`repro.profile` — the plan-first profiling CLI.

``python -m repro_torch.profile plan`` prints a corpus coverage report (the
paper's redundancy metric, as a dry run); ``python -m repro_torch.profile run``
executes a plan resumably.  See ``__main__.py``.
"""
from repro_torch.core.plan import (CoverageReport, ExecuteReport,  # noqa: F401
                             PlanTask, ProfilePlan, build_plan,
                             execute_plan)

__all__ = ["CoverageReport", "ExecuteReport", "PlanTask", "ProfilePlan",
           "build_plan", "execute_plan"]
