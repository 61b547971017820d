"""Scenario sweep engine: batch simulation across many
(model x backend x scheduler x workload) configurations against one
profile store — the paper's one-profile-serves-many-configurations thesis
applied to the simulator itself (cf. AIConfigurator / Vidur config search).

    PYTHONPATH=src python -m repro_torch.sweep --help
"""
from repro_torch.sweep.grid import (BURST, WORKLOAD_KINDS,  # noqa: F401
                              SchedSpec, Scenario, WorkloadSpec,
                              expand_grid)
from repro_torch.sweep.runner import (ScenarioResult, Sweep,  # noqa: F401
                                SweepResult)

__all__ = ["BURST", "WORKLOAD_KINDS", "SchedSpec", "Scenario",
           "WorkloadSpec", "expand_grid", "ScenarioResult", "Sweep",
           "SweepResult"]
