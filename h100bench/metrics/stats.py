"""The arithmetic of the serving metrics, copied from the port's
``repro_torch.sim.metrics`` (``request_metrics``, ``percentiles``) so that
a later change to the program cannot move the yardstick."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def request_metrics(requests: Sequence) -> Dict[str, np.ndarray]:
    """TTFT and TPOT (seconds) of the finished requests, on the clock their
    times were stamped with."""
    done = [r for r in requests if r.finish_t is not None]
    ttft = np.array([r.first_token_t - r.arrival for r in done])
    tpot = np.array([(r.finish_t - r.first_token_t) / max(r.generated - 1, 1)
                     for r in done])
    return {"ttft": ttft, "tpot": tpot}


def percentile(x: np.ndarray, p: float) -> float:
    """numpy's linear-interpolation percentile, as the port's
    ``percentiles`` takes it."""
    return float(np.percentile(x, p))
