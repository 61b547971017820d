"""Synthetic workload generators: ShareGPT-like + fixed-length loads.

ShareGPT-like: lognormal prompt/output lengths (matching the shape of the
paper's trace: median < mean), Poisson arrivals at a target request rate.
Scales down for the CPU smoke engine via the ``scale`` factor.

``rate=math.inf`` produces a *burst* workload — every request arrives at
t=0.  Burst workloads are latency-independent (scheduler replay never
waits on the predicted clock), which is what lets the scenario sweep
engine (``repro.sweep``) evaluate them by pure plan replay shared across
models/backends.  Both generators draw lengths/content and arrivals from
one seeded rng, so a (kind, params, seed) triple is fully reproducible.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.serving.scheduler import Request


def sharegpt_like(n: int, *, rate: float, seed: int = 0,
                  prompt_median: int = 950, prompt_mean: int = 1232,
                  out_median: int = 388, out_mean: int = 397,
                  scale: float = 1.0, vocab: int = 1000) -> List[Request]:
    rng = np.random.default_rng(seed)

    def lognormal(median, mean, size):
        # sigma^2 = 2 * (ln(mean) - ln(median)) requires mean > median —
        # the right-skew that defines the distribution's shape.  A
        # non-positive spread would silently degenerate to a constant.
        if mean <= median:
            raise ValueError(
                f"lognormal lengths require mean > median, got "
                f"mean={mean}, median={median} (sigma^2 = "
                "2*(ln(mean)-ln(median)) would be <= 0)")
        mu = math.log(max(median, 1))
        sigma = math.sqrt(max(2 * (math.log(max(mean, 1)) - mu), 0.0))
        return rng.lognormal(mu, sigma, size)

    prompts = np.maximum(1, (lognormal(prompt_median, prompt_mean, n)
                             * scale).astype(int))
    outs = np.maximum(1, (lognormal(out_median, out_mean, n)
                          * scale).astype(int))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt=list(rng.integers(0, vocab, prompts[i])),
                    max_new_tokens=int(outs[i]))
            for i in range(n)]


def synthetic(n: int, *, rate: float, prompt_len: int, out_len: int,
              seed: int = 0, vocab: int = 1000) -> List[Request]:
    """prefill-heavy: large prompt_len, small out_len; decode-heavy: the
    reverse (paper Fig. 1)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt=list(rng.integers(0, vocab, prompt_len)),
                    max_new_tokens=out_len)
            for i in range(n)]
