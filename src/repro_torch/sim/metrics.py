"""Serving metrics: TTFT / TPOT / throughput + MAPE comparisons."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.serving.scheduler import Request


def request_metrics(requests: Sequence[Request]) -> Dict[str, np.ndarray]:
    done = [r for r in requests if r.done]
    ttft = np.array([r.first_token_t - r.arrival for r in done])
    tpot = np.array([
        (r.finish_t - r.first_token_t) / max(r.generated - 1, 1)
        for r in done])
    return {"ttft": ttft, "tpot": tpot,
            "finish": np.array([r.finish_t for r in done]),
            "n_done": np.array([len(done)]),
            # prefix-cache hit accounting: prompt tokens served from
            # cache instead of prefilled (see SchedulerConfig.
            # prefix_caching); all-zero when caching is off or no
            # request carried a cached_prefix
            "cache_hit_tokens": np.array(
                [r.cache_hit_tokens for r in done])}


def cache_hit_rate(requests: Sequence[Request]) -> float:
    """Fraction of all prompt tokens served by the prefix cache across
    ``requests`` (0.0 when there are no prompt tokens)."""
    total = sum(r.prompt_len for r in requests)
    if total == 0:
        return 0.0
    return sum(r.cache_hit_tokens for r in requests) / total


def percentiles(x: np.ndarray, ps=(50, 90, 99)) -> Dict[str, float]:
    return {f"p{p}": float(np.percentile(x, p)) for p in ps} if len(x) \
        else {f"p{p}": 0.0 for p in ps}


def mape(pred: np.ndarray, ref: np.ndarray) -> float:
    ref = np.asarray(ref, float)
    pred = np.asarray(pred, float)
    m = ref > 1e-12
    if not m.any():
        return 0.0
    return float(np.mean(np.abs(pred[m] - ref[m]) / ref[m]) * 100.0)


def percentile_mape(pred: np.ndarray, ref: np.ndarray,
                    ps=(50, 90, 99)) -> Dict[str, float]:
    return {f"p{p}": mape(np.array([np.percentile(pred, p)]),
                          np.array([np.percentile(ref, p)]))
            for p in ps} if len(pred) and len(ref) else {}


def compare(sim: Dict[str, np.ndarray], real: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    out = {}
    for key in ("ttft", "tpot"):
        out[f"{key}_mape"] = mape(sim[key], real[key])
        for p, v in percentile_mape(sim[key], real[key]).items():
            out[f"{key}_{p}_mape"] = v
    out["makespan_mape"] = mape(sim["finish"][-1:], real["finish"][-1:]) \
        if len(sim["finish"]) and len(real["finish"]) else 0.0
    return out
