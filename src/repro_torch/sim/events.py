"""Event-driven staggered-arrival simulation: the ``"events"`` engine tier.

``DoolySim._run_interleaved`` prices one iteration at a time — a scalar
``predict_plan`` per scheduler step — because with staggered (Poisson)
arrivals the *admission* of a request depends on the predicted clock, so
the plan sequence cannot be replayed up front like the equal-arrival
(``sim.replay``) case.  But the dependence is sparse: **between two
arrival events the plan sequence is latency-independent** — no admission
decision can fire until the clock crosses the next arrival, and everything
the scheduler does until then is a pure function of its queue state.

``run_events`` exploits exactly that window.  It advances simulated time
event-by-event:

* **arrival / admission events** are handled at the loop top exactly as
  the interleaved loop does (admit every ``arrival <= clock``; if the
  scheduler drains with arrivals still pending, jump the clock to the
  next arrival);
* between events it **speculates a chunk of iterations** — runs the
  scheduler forward, recording plans and token events, *without* knowing
  their latencies — then prices the whole chunk in one batched
  ``LatencyBackend.predict_trace`` call and scans the predicted clock for
  the admission boundary (the first iteration that should not have run
  because an arrival lands before it);
* a fully-valid chunk commits as-is and the chunk size doubles (up to
  ``CHUNK_DRAIN_CAP`` once no arrivals remain — the drain phase can never
  mis-speculate); a partial chunk restores the scheduler snapshot and
  re-runs only the valid prefix (latencies already known, no re-predict).

The clock accumulates sequentially (``clock += float(dt)``) — the same
association as the interleaved loop — so the engine is equivalent to
``_run_interleaved`` to within the batched-vs-scalar prediction
difference (~1e-16 per iteration, far inside the 1e-9 gate).

``record_trace=True`` additionally returns a :class:`StaggeredTrace` —
the staggered analogue of :class:`~repro.sim.replay.PlanTrace`: the plan
sequence plus the *admission vector* (how many requests had been admitted
before each iteration, and where drain-jumps happened).  A recorded trace
is a pure function of (request structure, scheduler config, admission
vector), so another scenario with the same structure can **prefix-share**
it: predict the trace's plans under its own backend in one batched call,
walk :meth:`StaggeredTrace.divergence` to find the first iteration where
its admission timing disagrees, reuse everything before it (via the
``prefix=`` fast-forward, zero extra predictions), and only simulate the
tail.  When the walk validates the whole trace, the scenario's metrics
come straight from :meth:`StaggeredTrace.metrics_at` with no scheduler
work at all — ``repro.sweep`` uses this for its ``events-shared`` /
``events-dedup`` modes.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig
from repro_torch.sim.replay import is_latency_independent

#: iterations speculated per chunk before the first commit
CHUNK_INIT = 8
#: chunk ceiling while arrivals are still pending (a mis-speculated chunk
#: re-runs its valid prefix, so the ceiling bounds wasted scheduler work)
CHUNK_ARRIVAL_CAP = 64
#: chunk ceiling once every request has arrived — the drain phase cannot
#: mis-speculate, so batches grow until the scheduler empties
CHUNK_DRAIN_CAP = 4096


def recommend_engine(requests: Sequence[Request]) -> str:
    """The engine tier ``DoolySim.run(engine="auto")`` resolves to:
    ``"replay"`` when the workload is latency-independent (pure scheduler
    replay + one batched prediction), ``"events"`` otherwise (chunked
    speculation between arrival events).  The scalar ``"loop"`` tier is
    never auto-selected — it survives as the reference implementation."""
    return "replay" if is_latency_independent(requests) else "events"


@dataclass
class StaggeredTrace:
    """One recorded staggered-arrival simulation, admission vector included.

    ``plans`` uses the same normalized ``(chunk_lengths, n_decodes)`` form
    as :class:`~repro.sim.replay.PlanTrace`, so it feeds straight into
    ``predict_trace``.  Arrays are indexed in arrival-sorted request order
    (``arrivals``/``rids``/``token_iters``/...) or per iteration
    (``n_tokens``/``admit_before``/``drained``).

    Unlike a PlanTrace, the plan sequence here is only valid for latency
    vectors under which every recorded admission happens at the same
    iteration — :meth:`divergence` is the validity check, and it doubles
    as the prefix-sharing boundary finder.
    """
    plans: List[Tuple[Tuple[int, ...], int]]
    arrivals: np.ndarray            # per request, arrival-sorted
    rids: np.ndarray
    token_iters: List[np.ndarray]   # per request, iteration idx per token
    n_tokens: np.ndarray            # per iteration, total batch tokens
    admit_before: np.ndarray        # per iteration, requests admitted so far
    drained: np.ndarray             # per iteration, clock-jump preceded it
    first_iter: np.ndarray
    finish_iter: np.ndarray
    generated: np.ndarray
    cache_hits: np.ndarray          # prefix-cache tokens served, per req

    @property
    def n_iterations(self) -> int:
        return len(self.plans)

    @property
    def n_requests(self) -> int:
        return len(self.arrivals)

    def divergence(self, latencies) -> Tuple[np.ndarray, int]:
        """Walk the recorded admission vector under a new latency vector.

        Replays the interleaved loop's *control flow* — clock jumps on
        recorded drain points, admission whenever ``arrival <= clock`` —
        without any scheduler work, checking at each iteration that the
        requests recorded as admitted are exactly the ones this latency
        vector would admit.  Returns ``(times, d)``: iteration-completion
        clocks for the valid prefix and the first divergent iteration
        index (``d == n_iterations`` means the whole trace is valid and
        ``times`` prices it end-to-end)."""
        lat = np.asarray(latencies, dtype=np.float64)
        n = len(self.plans)
        arr = self.arrivals
        n_req = len(arr)
        admit = self.admit_before
        drain = self.drained
        times = np.empty(n, dtype=np.float64)
        if n == 0:
            return times, 0
        clock = 0.0
        j = 0
        # scalar handling only where something can happen: recorded
        # admission steps and drain-jumps.  The stretches between them
        # carry no recorded admissions, so they cumsum-fill in one shot
        # with a single searchsorted for the would-admit-more check.
        steps = np.nonzero((np.diff(admit, prepend=0) > 0) | drain)[0]
        pos = 0
        for k in [int(s) for s in steps] + [n]:
            if k > pos:
                seg = clock + np.cumsum(lat[pos:k])
                if j < n_req:
                    a = arr[j]
                    if a <= clock:      # would admit more at `pos` already
                        return times[:pos], pos
                    # iteration pos+m+1 starts at seg[m]; the first start
                    # that reaches the next arrival is the divergence
                    m = int(np.searchsorted(seg[:k - pos - 1], a))
                    if m < k - pos - 1:
                        times[pos:pos + m + 1] = seg[:m + 1]
                        return times[:pos + m + 1], pos + m + 1
                times[pos:k] = seg
                clock = float(seg[-1])
                pos = k
            if k == n:
                break
            target = int(admit[k])
            if drain[k] and j < n_req and clock < arr[j]:
                clock = arr[j]          # the loop's empty-plan clock jump
            while j < target:
                if arr[j] > clock:      # recorded admission hasn't arrived
                    return times[:k], k
                j += 1
            if j < n_req and arr[j] <= clock:
                return times[:k], k     # this vector would admit more
            clock += float(lat[k])
            times[k] = clock
            pos = k + 1
        return times, n

    def metrics_at(self, times: np.ndarray) -> Dict[str, np.ndarray]:
        """Request metrics (same keys as ``sim.metrics.request_metrics``)
        from a *fully-validated* divergence walk's iteration clocks."""
        first = times[self.first_iter] if len(times) else np.empty(0)
        finish = times[self.finish_iter] if len(times) else np.empty(0)
        return {"ttft": first - self.arrivals,
                "tpot": (finish - first) / np.maximum(self.generated - 1, 1),
                "finish": finish,
                "n_done": np.array([self.n_requests]),
                "cache_hit_tokens": self.cache_hits.copy()}


def _snapshot(sched: Scheduler, events: Dict[int, List[int]]):
    """Checkpoint everything a speculated chunk can mutate: the scheduler's
    queues/slots and, per queued request, its progress counters plus the
    lengths of its (placeholder) token-time and token-event lists."""
    reqs = list(sched.waiting) + list(sched.running)
    return (list(sched.waiting), list(sched.running),
            list(sched._free_slots),
            [(r, r.prefilled, r.generated, r.slot, r.cache_hit_tokens,
              r.first_token_t, r.finish_t, len(r.token_times),
              len(events[id(r)]))
             for r in reqs])


def _restore(sched: Scheduler, events: Dict[int, List[int]], snap):
    waiting, running, free_slots, req_state = snap
    sched.waiting = deque(waiting)
    sched.running = list(running)
    sched._free_slots = list(free_slots)
    for r, prefilled, generated, slot, cache_hit, first_t, finish_t, \
            n_tt, n_ev in req_state:
        r.prefilled = prefilled
        r.generated = generated
        r.slot = slot
        r.cache_hit_tokens = cache_hit
        r.first_token_t = first_t
        r.finish_t = finish_t
        del r.token_times[n_tt:]
        del events[id(r)][n_ev:]


def run_events(requests: Sequence[Request], sched_config: SchedulerConfig,
               latency, *, record_plans: bool = False,
               record_trace: bool = False,
               prefix: Optional[Tuple["StaggeredTrace", Any, int]] = None
               ) -> Dict[str, Any]:
    """Event-driven simulation of ``requests`` under ``sched_config``,
    pricing iterations through ``latency`` (any
    :class:`~repro.api.backends.LatencyBackend`) in batched
    ``predict_trace`` chunks.  Returns the same result dict shape as
    ``DoolySim._run_interleaved`` (requests mutated in place,
    ``iterations`` as ``(clock, n_tokens, dt)`` tuples, ``makespan``),
    plus ``stats`` (chunks / speculated / restores / prefix_iters) and —
    with ``record_trace=True`` — a :class:`StaggeredTrace` under
    ``"trace"``.

    ``prefix=(trace, latencies, d)`` fast-forwards the first ``d``
    iterations mechanically from a recorded trace whose admission vector
    ``trace.divergence(latencies)`` validated up to ``d`` — the
    admissions are known, the latencies are known, so the prefix costs
    scheduler bookkeeping only (zero predictions)."""
    sched = Scheduler(sched_config)
    pending = sorted(requests, key=lambda r: r.arrival)
    # token events keyed by request *identity*, not rid (duplicate-rid
    # safety, matching replay_schedule)
    events: Dict[int, List[int]] = {id(r): [] for r in pending}
    i = 0                   # next pending arrival
    clock = 0.0
    committed = 0
    iterations: List[Tuple[float, int, float]] = []
    plans: List[Tuple[Tuple[int, ...], int]] = []
    admit_before: List[int] = []
    drained: List[bool] = []
    jump = False            # a drain-jump precedes the next iteration
    stats = {"chunks": 0, "speculated": 0, "restores": 0, "prefix_iters": 0}

    def record(plan, it: int) -> Tuple[Tuple[Tuple[int, ...], int], int]:
        """Token events + (normalized form, token count) of one scheduled
        plan (the same event logic as ``replay_schedule``)."""
        lengths: List[int] = []
        n_tok = 0
        for c in plan.prefills:
            length = c.length
            lengths.append(length)
            n_tok += length
            rq = c.req
            if rq.prefilled + length >= rq.prompt_len:
                events[id(rq)].append(it)       # prefill emits first token
        decodes = plan.decodes
        for r in decodes:
            events[id(r)].append(it)
        return (tuple(lengths), len(decodes)), n_tok + len(decodes)

    if prefix is not None and prefix[2] > 0:
        trace, pre_lat, d = prefix
        pre_lat = np.asarray(pre_lat, dtype=np.float64)
        for k in range(d):
            target = int(trace.admit_before[k])
            if trace.drained[k] and i < len(pending) \
                    and clock < pending[i].arrival:
                clock = pending[i].arrival
            while i < target:
                sched.add_request(pending[i])
                i += 1
            plan = sched.schedule()
            norm, n_tok = record(plan, committed)
            sched.complete_iteration(plan, 0.0, record_times=False)
            dt = float(pre_lat[k])
            clock += dt
            iterations.append((clock, n_tok, dt))
            plans.append(norm)
            admit_before.append(i)
            drained.append(bool(trace.drained[k]))
            committed += 1
        stats["prefix_iters"] = d

    chunk = CHUNK_INIT
    while i < len(pending) or sched.has_work():
        while i < len(pending) and pending[i].arrival <= clock:
            sched.add_request(pending[i])
            i += 1
        if not sched.has_work():
            if i < len(pending):        # the loop's empty-plan clock jump
                clock = pending[i].arrival
                jump = True
                continue
            break
        t_next = pending[i].arrival if i < len(pending) else math.inf
        cap = CHUNK_ARRIVAL_CAP if i < len(pending) else CHUNK_DRAIN_CAP
        while sched.has_work():
            # -- speculate one chunk (placeholder times, events recorded)
            snap = _snapshot(sched, events) if t_next != math.inf else None
            spec: List[Tuple[Tuple[int, ...], int]] = []
            spec_ntok: List[int] = []
            n = min(chunk, cap)
            while len(spec) < n and sched.has_work():
                plan = sched.schedule()
                norm, n_tok = record(plan, committed + len(spec))
                spec.append(norm)
                spec_ntok.append(n_tok)
                sched.complete_iteration(plan, 0.0, record_times=False)
            # -- one batched prediction for the whole chunk
            lat = np.asarray(latency.predict_trace(spec), dtype=np.float64)
            stats["chunks"] += 1
            stats["speculated"] += len(spec)
            # -- admission-boundary scan: iteration k is valid iff the
            # next arrival is still in the future when it *starts*
            # (sequential accumulation, same association as the loop)
            m = len(spec)
            if t_next != math.inf:    # drain chunks can never overshoot
                c = clock
                for k in range(1, len(spec)):
                    c += float(lat[k - 1])
                    if t_next <= c:
                        m = k
                        break
            if m < len(spec):
                # overshoot: roll back, re-run only the valid prefix
                # (plans are deterministic — latencies already priced)
                _restore(sched, events, snap)
                for k in range(m):
                    plan = sched.schedule()
                    record(plan, committed + k)
                    sched.complete_iteration(plan, 0.0, record_times=False)
                stats["restores"] += 1
            # -- commit the valid prefix (the arrival pointer is frozen
            # for the whole chunk, so admit_before extends as a constant)
            lat_m = lat[:m].tolist()
            for k in range(m):
                dt = lat_m[k]
                clock += dt
                iterations.append((clock, spec_ntok[k], dt))
            plans.extend(spec[:m])
            admit_before.extend([i] * m)
            drained.append(jump)
            if m > 1:
                drained.extend([False] * (m - 1))
            committed += m
            jump = False
            if m < len(spec):
                chunk = max(CHUNK_INIT, m)
                break                   # admission boundary: go admit
            chunk = min(chunk * 2, cap)
            if t_next <= clock:
                break                   # boundary landed on the chunk edge

    # one final pass rewrites every placeholder with the committed clocks
    times = np.array([it[0] for it in iterations], dtype=np.float64)
    for r in pending:
        ev = events[id(r)]
        r.token_times = times[ev].tolist()
        if ev:
            r.first_token_t = r.token_times[0]
            r.finish_t = r.token_times[-1]

    out: Dict[str, Any] = {"requests": list(requests),
                           "iterations": iterations,
                           "makespan": clock, "stats": stats}
    if record_plans:
        out["plans"] = list(plans)
    if record_trace:
        token_iters = [np.asarray(events[id(r)], dtype=np.intp)
                       for r in pending]
        out["trace"] = StaggeredTrace(
            plans=plans,
            arrivals=np.array([r.arrival for r in pending],
                              dtype=np.float64),
            rids=np.array([r.rid for r in pending], dtype=np.int64),
            token_iters=token_iters,
            n_tokens=np.array([it[1] for it in iterations], dtype=np.int64),
            admit_before=np.asarray(admit_before, dtype=np.int64),
            drained=np.asarray(drained, dtype=bool),
            first_iter=np.array([ti[0] if len(ti) else 0
                                 for ti in token_iters], dtype=np.intp),
            finish_iter=np.array([ti[-1] if len(ti) else 0
                                  for ti in token_iters], dtype=np.intp),
            generated=np.array([len(ti) for ti in token_iters],
                               dtype=np.int64),
            cache_hits=np.array([r.cache_hit_tokens for r in pending],
                                dtype=np.int64))
    return out
