"""Plan-generation layer: pure scheduler replay, decoupled from latency.

``DoolySim.run`` historically interleaved two concerns in one scalar loop:
(1) driving the Scheduler to compose iteration batches and (2) predicting
each iteration's latency.  For a *latency-independent* workload — every
request present at the start (equal arrivals, e.g. a burst / closed-loop
trace) — batch composition is a pure function of (requests, scheduler
config): the plan sequence never depends on the predicted clock, because no
admission decision waits on it.  ``replay_schedule`` extracts exactly that
loop into a standalone pass producing a :class:`PlanTrace` — the full
iteration-plan sequence plus, per request, the iteration index of every
emitted token.

A PlanTrace is latency-*parametric*: give it a vector of per-iteration
latencies and it yields wall-clock metrics (TTFT / TPOT / makespan) without
re-running the scheduler.  That is what lets a configuration sweep replay
the scheduler once per (workload, scheduler config) and share the trace
across every scenario that differs only in model / hardware / backend —
the paper's redundancy thesis lifted from profiling to simulation.

Workloads with staggered (Poisson) arrivals are latency-*dependent*: which
iteration admits a request depends on how fast previous iterations ran, so
a replayed trace is only exact for scenarios sharing iteration timing.
``latency_dependence`` is the classifier (``is_latency_independent`` is
its boolean form); callers (``DoolySim.run``, ``repro.sweep``) route
staggered workloads to the event-driven ``sim.events`` engine — chunked
speculation between arrival events with batched prediction and, across
scenarios, prefix-shared replay up to the first admission divergence.
The scalar interleaved loop survives only as the explicit
``engine="loop"`` reference tier.

``replay_schedule`` is pure with respect to its inputs: the caller's
Request objects are never mutated (the scheduler drives private clones).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig


def latency_dependence(requests: Sequence[Request]) -> str:
    """Classify how a workload's scheduling interacts with the clock:

    * ``"equal"`` — every request arrives at the same instant; the whole
      queue is admitted before the first iteration;
    * ``"immediate"`` — arrivals differ but all are ``<= 0``, so the
      simulation clock (which starts at 0) admits everything at once —
      latency-independent all the same;
    * ``"staggered"`` — some admission waits on the predicted clock; the
      plan sequence is latency-dependent (the ``"events"`` engine tier).
    """
    arrivals = {r.arrival for r in requests}
    if len(arrivals) <= 1:
        return "equal"
    if max(arrivals) <= 0.0:
        return "immediate"
    return "staggered"


def is_latency_independent(requests: Sequence[Request]) -> bool:
    """True when scheduler replay cannot depend on iteration latency —
    ``latency_dependence`` is anything but ``"staggered"``, i.e. every
    request is already present when the clock starts and no admission
    waits on a predicted iteration time."""
    return latency_dependence(requests) != "staggered"


def clone_sorted(requests: Sequence[Request]) -> List[Request]:
    """Fresh-progress copies in the scheduler's arrival order (stable sort,
    matching ``DoolySim.run``'s ``sorted(requests, key=arrival)``)."""
    return [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    cached_prefix=r.cached_prefix)
            for r in sorted(requests, key=lambda r: r.arrival)]


@dataclass
class PlanTrace:
    """Latency-independent scheduler replay of one (workload, sched config).

    ``plans`` uses the same normalized form ``DoolySim.run(record_plans=
    True)`` records — ``(chunk_lengths, n_decodes)`` per iteration — so it
    feeds straight into ``predict_trace`` / ``predict_scenarios``.
    ``token_iters[i]`` holds, for the i-th request in arrival order, the
    iteration index of each emitted token.
    """
    plans: List[Tuple[Tuple[int, ...], int]]
    start: float                     # clock at which iteration 0 begins
    arrivals: np.ndarray             # per request, arrival-sorted
    rids: np.ndarray
    token_iters: List[np.ndarray]    # per request, iteration idx per token
    n_tokens: np.ndarray             # per iteration, total batch tokens
    first_iter: np.ndarray           # token_iters[i][0]
    finish_iter: np.ndarray          # token_iters[i][-1]
    generated: np.ndarray            # len(token_iters[i])
    cache_hits: np.ndarray           # prefix-cache tokens served, per req

    @property
    def n_iterations(self) -> int:
        return len(self.plans)

    @property
    def n_requests(self) -> int:
        return len(self.rids)

    def content_key(self) -> Tuple:
        """Value-identity of the replay: two traces with equal keys yield
        identical metrics under any latency vector.  Lets a sweep dedup
        scenarios whose workloads *generate* different requests but
        *schedule* identically (e.g. synthetic workloads differing only in
        the token-content seed)."""
        return (tuple(self.plans), self.start,
                self.arrivals.tobytes(), self.generated.tobytes(),
                self.cache_hits.tobytes(),
                tuple(ti.tobytes() for ti in self.token_iters))

    def times(self, latencies: np.ndarray) -> np.ndarray:
        """Completion clock of each iteration given per-iteration seconds.
        Compute once and pass to ``makespan``/``metrics``/``apply`` when
        evaluating several of them for one latency vector."""
        return self.start + np.cumsum(np.asarray(latencies, dtype=np.float64))

    def makespan(self, latencies: np.ndarray, *,
                 times: Optional[np.ndarray] = None) -> float:
        t = self.times(latencies) if times is None else times
        return float(t[-1]) if len(t) else self.start

    def metrics(self, latencies: np.ndarray, *,
                times: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
        """Same keys/semantics as ``sim.metrics.request_metrics`` applied to
        a finished ``DoolySim.run``, computed directly from the trace."""
        t = self.times(latencies) if times is None else times
        first = t[self.first_iter] if len(t) else np.empty(0)
        finish = t[self.finish_iter] if len(t) else np.empty(0)
        return {"ttft": first - self.arrivals,
                "tpot": (finish - first) / np.maximum(self.generated - 1, 1),
                "finish": finish,
                "n_done": np.array([self.n_requests]),
                "cache_hit_tokens": self.cache_hits.copy()}

    def evaluate(self, backend) -> Dict[str, np.ndarray]:
        """Price this trace through any
        :class:`repro.api.backends.LatencyBackend` and return the metric
        dict of :meth:`metrics` plus ``latencies`` (per iteration) and
        ``makespan`` — the one-call form of the replay/predict split."""
        lat = np.asarray(backend.predict_trace(self.plans))
        t = self.times(lat)
        met = self.metrics(lat, times=t)
        met["latencies"] = lat
        met["makespan"] = np.array([self.makespan(lat, times=t)])
        return met

    def apply(self, requests: Sequence[Request], latencies: np.ndarray, *,
              times: Optional[np.ndarray] = None):
        """Write wall-clock token times back onto the caller's Request
        objects — makes a replayed ``DoolySim.run`` observationally
        identical to the interleaved loop."""
        t = self.times(latencies) if times is None else times
        order = sorted(range(len(requests)),
                       key=lambda i: requests[i].arrival)
        for i, idx in enumerate(order):
            r = requests[idx]
            ti = self.token_iters[i]
            r.prefilled = r.prompt_len
            r.cache_hit_tokens = int(self.cache_hits[i])
            r.generated = int(self.generated[i])
            r.token_times = [float(t[j]) for j in ti]
            r.first_token_t = float(t[ti[0]])
            r.finish_t = float(t[ti[-1]])


def replay_schedule(requests: Sequence[Request],
                    sched_config: SchedulerConfig) -> PlanTrace:
    """Pure scheduler replay: the iteration-plan sequence for a
    latency-independent workload, with per-request token events recorded
    as iteration indices.  Raises ``ValueError`` for latency-dependent
    (staggered-arrival) workloads — those go through the event-driven
    ``sim.events`` engine (``DoolySim.run(engine="events")``)."""
    if not is_latency_independent(requests):
        raise ValueError(
            "replay_schedule requires a latency-independent workload "
            "(all arrivals equal, or all <= 0); staggered arrivals make "
            "batch composition depend on iteration latency — use the "
            "event-driven engine (DoolySim.run(engine='events'))")
    clones = clone_sorted(requests)
    start = max(clones[0].arrival, 0.0) if clones else 0.0
    sched = Scheduler(sched_config)
    for r in clones:
        sched.add_request(r)
    plans: List[Tuple[Tuple[int, ...], int]] = []
    n_tokens: List[int] = []
    # events keyed by clone *identity*, not rid — workload concatenations
    # can carry duplicate rids and must not share token-event lists
    index: Dict[int, int] = {id(r): i for i, r in enumerate(clones)}
    events: List[List[int]] = [[] for _ in clones]
    it = 0
    while sched.has_work():
        plan = sched.schedule()
        if plan.empty:       # unreachable with equal arrivals; stay safe
            raise RuntimeError("scheduler produced an empty plan with "
                               "work outstanding")
        for chunk in plan.prefills:
            if chunk.req.prefilled + chunk.length >= chunk.req.prompt_len:
                events[index[id(chunk.req)]].append(it)  # first token
        for r in plan.decodes:
            events[index[id(r)]].append(it)
        plans.append((tuple(c.length for c in plan.prefills),
                      len(plan.decodes)))
        n_tokens.append(plan.n_tokens)
        sched.complete_iteration(plan, float(it))
        it += 1
    token_iters = [np.asarray(ev, dtype=np.intp) for ev in events]
    return PlanTrace(
        plans=plans, start=start,
        arrivals=np.array([r.arrival for r in clones], dtype=np.float64),
        rids=np.array([r.rid for r in clones], dtype=np.int64),
        token_iters=token_iters,
        n_tokens=np.asarray(n_tokens, dtype=np.int64),
        first_iter=np.array([ti[0] for ti in token_iters], dtype=np.intp),
        finish_iter=np.array([ti[-1] for ti in token_iters], dtype=np.intp),
        generated=np.array([len(ti) for ti in token_iters], dtype=np.int64),
        cache_hits=np.array([r.cache_hit_tokens for r in clones],
                            dtype=np.int64))
