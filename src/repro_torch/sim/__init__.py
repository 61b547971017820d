"""DoolySim, its replay and event-driven tiers, and request metrics."""
from repro_torch.sim import metrics
from repro_torch.sim.simulator import DoolySim, predict_scenarios

__all__ = ["DoolySim", "metrics", "predict_scenarios"]
