"""The benchmark's traffic: one general generator that every mix file feeds.

``sharegpt_like`` is a frozen copy of the port's
``repro_torch.workload.generators.sharegpt_like`` (lognormal prompt and
output lengths, Poisson arrivals), returning plain tuples so that nothing
here imports the program.  A test holds its draws equal to the port's.

A mix file (``traffic/<name>.json``) gives the lognormal lengths, their
clips, the draw's own seed and the requests of one trace.  ``traces``
draws the trace's lengths and arrival gaps once from the mix's
``draw_seed``; trace k of a window shuffles them by (``draw_seed``, k), and
the run's ``--seed`` draws the prompts' token ids.  So every run serves the
same schedule: with the order drawn from the seed too, TTFT p90 over a
window's 96 requests spread 23 % between seeds and under 1 % between two
runs of one seed (an H100, cmdr7b.rag).  The arrival rate comes from the
cell.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np


def sharegpt_like(n: int, *, rate: float, seed: int = 0,
                  prompt_median: int = 950, prompt_mean: int = 1232,
                  out_median: int = 388, out_mean: int = 397,
                  scale: float = 1.0, vocab: int = 1000
                  ) -> List[Tuple[float, List[int], int]]:
    """(arrival, prompt ids, max new tokens) per request, drawn as the
    port's generator draws them."""
    rng = np.random.default_rng(seed)

    def lognormal(median, mean, size):
        if mean <= median:
            raise ValueError(
                f"lognormal lengths require mean > median, got "
                f"mean={mean}, median={median}")
        mu = math.log(max(median, 1))
        sigma = math.sqrt(max(2 * (math.log(max(mean, 1)) - mu), 0.0))
        return rng.lognormal(mu, sigma, size)

    prompts = np.maximum(1, (lognormal(prompt_median, prompt_mean, n)
                             * scale).astype(int))
    outs = np.maximum(1, (lognormal(out_median, out_mean, n)
                          * scale).astype(int))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    return [(float(arrivals[i]), list(rng.integers(0, vocab, prompts[i])),
             int(outs[i])) for i in range(n)]


def trace_shape(mix: Dict, rate: float) -> Tuple[List[Tuple[int, int]], List[float]]:
    """The (prompt, output) lengths and the arrival gaps of one trace, drawn
    from the mix's ``draw_seed`` and clipped: each length to its range, then
    the output so that prompt plus output stays within ``max_total``."""
    drawn = sharegpt_like(mix["trace_requests"], rate=rate, seed=mix["draw_seed"],
                          prompt_median=mix["prompt_median"],
                          prompt_mean=mix["prompt_mean"],
                          out_median=mix["out_median"], out_mean=mix["out_mean"],
                          vocab=1)
    lengths, gaps, last = [], [], 0.0
    for arrival, prompt, out in drawn:
        p = min(max(len(prompt), mix["prompt_min"]), mix["prompt_max"])
        o = min(max(out, mix["out_min"]), mix["out_max"], mix["max_total"] - p)
        if o < 1:
            raise ValueError(f"mix leaves no output for a {p}-token prompt")
        lengths.append((p, o))
        gaps.append(arrival - last)
        last = arrival
    return lengths, gaps


def traces(mix: Dict, rate: float, seed: int, vocab: int
           ) -> Iterator[List[Tuple[float, List[int], int]]]:
    """Endless traces for one run: trace k shuffles the mix's lengths and
    gaps with a generator seeded by (``draw_seed``, k), and draws prompt ids
    in [0, vocab) with one seeded by (``seed``, k).  Yields (arrival, prompt
    ids, max new tokens)."""
    lengths, gaps = trace_shape(mix, rate)
    k = 0
    while True:
        shuffle = np.random.default_rng([mix["draw_seed"], k])
        order = shuffle.permutation(len(lengths))
        arrivals = np.cumsum(np.asarray(gaps)[shuffle.permutation(len(gaps))])
        ids = np.random.default_rng([seed, k])
        yield [(float(arrivals[i]),
                ids.integers(0, vocab, lengths[j][0]).tolist(), lengths[j][1])
               for i, j in enumerate(order)]
        k += 1
