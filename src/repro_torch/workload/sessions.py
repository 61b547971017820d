"""Multi-turn sessions: trace rows -> prefix-sharing ``Request`` lists.

A session-grouped trace (rows sharing a ``session`` id, in order) models
one conversation: turn k's prompt is the whole accumulated context —
previous prompts and previous model outputs — plus the new user turn.
:func:`to_requests` expands that literally: turn k+1's prompt token list
*starts with* turn k's prompt followed by turn k's (simulated) output
tokens, and the request's ``cached_prefix`` is set to that shared-context
length.  The scheduler's prefix-cache model
(``SchedulerConfig.prefix_caching``) then skips those tokens at prefill
admission, so multi-turn TTFT reflects cache hits the way a real serving
engine's automatic prefix caching would.

All token content is drawn from one seeded rng in row order, so the
expansion is deterministic and trace transforms that preserve lengths
(``time_warp``) share common random numbers.

:func:`synthetic_session_rows` / :func:`synthetic_sessions` generate
file-less multi-turn workloads with the same semantics — the sessions
analogue of ``repro.workload.generators``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.scheduler import Request
from repro_torch.workload.trace import TraceRow, validate_trace


def to_requests(rows: Sequence[TraceRow], *, seed: int = 0,
                vocab: int = 1000) -> List[Request]:
    """Expand trace rows into ``Request``s (rid = row index, arrival from
    the row).  Rows sharing a ``session`` become turns whose prompts
    share token prefixes, with ``cached_prefix`` set to the shared
    context length; sessionless rows are independent single-turn
    requests."""
    validate_trace(rows)
    rng = np.random.default_rng(seed)
    history: Dict[str, List[int]] = {}
    out: List[Request] = []
    for i, row in enumerate(rows):
        prefix: List[int] = []
        if row.session is not None:
            prefix = history.get(row.session, [])
        fresh = rng.integers(0, vocab,
                             row.prompt_tokens - len(prefix)).tolist()
        prompt = prefix + fresh
        out.append(Request(rid=i, arrival=row.arrival, prompt=prompt,
                           max_new_tokens=row.output_tokens,
                           cached_prefix=len(prefix)))
        if row.session is not None:
            # next turn's context: this prompt plus this turn's output
            history[row.session] = prompt + rng.integers(
                0, vocab, row.output_tokens).tolist()
    return out


def synthetic_session_rows(n_sessions: int, *, rate: float,
                           turns: int = 3, prompt_len: int = 32,
                           out_len: int = 8, think_time: float = 0.0,
                           seed: int = 0) -> List[TraceRow]:
    """Trace rows for ``n_sessions`` conversations of ``turns`` turns.

    Session starts are Poisson at ``rate`` (``math.inf`` = all at t=0);
    turn k+1 arrives ``think_time`` after turn k.  Each turn adds
    ``prompt_len`` fresh prompt tokens on top of the accumulated context,
    so turn k's total prompt is ``k*prompt_len + (k-1)*out_len``."""
    if n_sessions < 1 or turns < 1:
        raise ValueError(f"need n_sessions >= 1 and turns >= 1, got "
                         f"{n_sessions}, {turns}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n_sessions)
    starts = np.zeros(n_sessions) if math.isinf(rate) else np.cumsum(gaps)
    rows: List[TraceRow] = []
    for s in range(n_sessions):
        for k in range(turns):
            rows.append(TraceRow(
                arrival=float(starts[s]) + k * think_time,
                prompt_tokens=(k + 1) * prompt_len + k * out_len,
                output_tokens=out_len,
                session=f"s{s}"))
    # arrival order with turn order preserved on ties (stable sort over
    # the session-major build)
    rows.sort(key=lambda r: r.arrival)
    return rows


def synthetic_sessions(n_sessions: int, *, rate: float, turns: int = 3,
                       prompt_len: int = 32, out_len: int = 8,
                       think_time: float = 0.0, seed: int = 0,
                       vocab: int = 1000) -> List[Request]:
    """``synthetic_session_rows`` expanded through :func:`to_requests`
    (one seed drives both structure and content)."""
    rows = synthetic_session_rows(
        n_sessions, rate=rate, turns=turns, prompt_len=prompt_len,
        out_len=out_len, think_time=think_time, seed=seed)
    return to_requests(rows, seed=seed, vocab=vocab)
