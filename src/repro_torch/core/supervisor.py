"""A supervised process pool for fault-tolerant task fan-out.

``concurrent.futures.ProcessPoolExecutor`` is the wrong tool once
workers are expected to die: a single crashed process breaks the whole
pool (``BrokenProcessPool``), ``map`` returns nothing until an entire
shard finishes, and there is no per-task wall-clock timeout.  This
module provides the small supervisor that plan execution actually
needs:

* one duplex :class:`multiprocessing.Pipe` per worker — a SIGKILLed
  worker corrupts only its own channel (unlike a shared ``mp.Queue``,
  whose feeder thread and shared lock can be left in a broken state);
* results stream back per task the moment they finish, in completion
  order, so the coordinator can commit+journal incrementally;
* per-task wall-clock deadlines: a worker that blows its deadline is
  terminated (then killed) and replaced, and the task retries;
* bounded retries with exponential backoff for crashed / timed-out /
  erroring tasks, after which the task is reported failed (the caller
  decides what "failed" means — plan execution quarantines it);
* a ready handshake: tasks are only assigned to workers whose setup
  completed, and setup failures never consume task retry budget (but
  repeated consecutive setup failures abort the pool — the environment,
  not a task, is broken).

Workers run two picklable module-level callables: ``setup(init) ->
state`` once per process, then ``run(state, payload) -> result`` per
task.  The pool uses the spawn start method so worker state never
aliases the parent (and so it behaves identically under pytest and the
CLI).
"""
from __future__ import annotations

import heapq
import itertools
import multiprocessing as mp
import time
from collections import deque
from dataclasses import dataclass
from multiprocessing.connection import wait as _conn_wait
from typing import (Any, Callable, Deque, Dict, Iterable, List, Optional,
                    Tuple)

_READY = "__ready__"
_SETUP_ERROR = "__setup_error__"


class WorkerSetupError(RuntimeError):
    """Worker processes cannot initialize; the pool refuses to spin."""


@dataclass
class TaskOutcome:
    """Terminal fate of one task after supervision."""
    task_id: str
    ok: bool
    result: Any = None
    error: Optional[str] = None
    attempts: int = 1               # attempts actually started
    n_timeouts: int = 0             # deadline kills along the way
    n_crashes: int = 0              # worker deaths along the way


@dataclass
class _TaskState:
    payload: Any
    attempts: int = 0
    n_timeouts: int = 0
    n_crashes: int = 0


class _Sched:
    """Mutable scheduling state for one ``run`` call."""

    def __init__(self, tasks: Iterable[Tuple[str, Any]]):
        self.states: Dict[str, _TaskState] = {}
        # ready to assign, FIFO — submission order IS the schedule (plan
        # execution submits longest-first), so assignment must preserve
        # it; a deque keeps the head-pop O(1) on 10k-task plans
        self.queue: Deque[str] = deque()
        self.retry: List[Tuple[float, int, str]] = []   # (due, seq, id)
        self.outcomes: List[TaskOutcome] = []   # terminal, to yield
        self._seq = itertools.count()
        for task_id, payload in tasks:
            if task_id in self.states:
                raise ValueError(f"duplicate task id {task_id!r}")
            self.states[task_id] = _TaskState(payload=payload)
            self.queue.append(task_id)
        self.pending = len(self.states)

    def promote_due_retries(self, now: float) -> None:
        while self.retry and self.retry[0][0] <= now:
            self.queue.append(heapq.heappop(self.retry)[2])

    def schedule_retry(self, task_id: str, due: float) -> None:
        heapq.heappush(self.retry, (due, next(self._seq), task_id))

    @property
    def backlog(self) -> int:
        return len(self.queue) + len(self.retry)


def _worker_main(setup: Callable, run: Callable, init: Any, conn) -> None:
    try:
        state = setup(init)
    except BaseException as e:                  # noqa: BLE001
        try:
            conn.send((_SETUP_ERROR, f"{type(e).__name__}: {e}"))
        except OSError:
            pass
        return
    try:
        conn.send((_READY, None))
        while True:
            msg = conn.recv()
            if msg is None:
                return
            task_id, payload = msg
            try:
                conn.send((task_id, ("ok", run(state, payload))))
            except BaseException as e:          # noqa: BLE001
                conn.send((task_id, ("error", f"{type(e).__name__}: {e}")))
    except (EOFError, OSError, KeyboardInterrupt):
        return                                  # parent went away


class _Worker:
    def __init__(self, ctx, setup, run, init):
        self.conn, child = mp.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=_worker_main, args=(setup, run, init, child),
            daemon=True)
        self.proc.start()
        child.close()
        self.ready = False
        self.eof = False            # our end of the pipe hit EOF
        self.handled = False        # death fully processed; inert
        self.task_id: Optional[str] = None
        self.deadline: Optional[float] = None

    def unassign(self) -> Optional[str]:
        task_id, self.task_id, self.deadline = self.task_id, None, None
        return task_id

    def kill(self) -> None:
        try:
            self.proc.terminate()
            self.proc.join(0.5)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(0.5)
        finally:
            self.conn.close()


class SupervisedPool:
    """Run tasks across supervised worker processes, yielding each
    task's :class:`TaskOutcome` as it completes (completion order)."""

    def __init__(self, setup: Callable, run: Callable, init: Any = None, *,
                 workers: int = 1, task_timeout: Optional[float] = None,
                 max_retries: int = 2, backoff_s: float = 0.1,
                 max_setup_failures: int = 3):
        self.setup = setup
        self.run_fn = run
        self.init = init
        self.workers = max(1, int(workers))
        self.task_timeout = task_timeout
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = backoff_s
        self.max_setup_failures = max_setup_failures
        self._ctx = mp.get_context("spawn")
        self._pool: List[_Worker] = []
        self._setup_failures = 0

    # -- public ---------------------------------------------------------

    def __enter__(self) -> "SupervisedPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for w in self._pool:
            if (not w.handled and w.ready and w.task_id is None
                    and w.proc.is_alive()):
                try:
                    w.conn.send(None)           # polite shutdown
                except OSError:
                    pass
        for w in self._pool:
            if w.handled:
                continue
            w.proc.join(0.5)
            if w.proc.is_alive():
                w.kill()
            else:
                w.conn.close()
        self._pool = []

    def run(self, tasks: Iterable[Tuple[str, Any]]):
        """Generator over terminal :class:`TaskOutcome`\\ s."""
        sched = _Sched(tasks)
        try:
            while sched.pending:
                self._reap_dead(sched)
                now = time.monotonic()
                sched.promote_due_retries(now)
                self._reap_timeouts(now, sched)
                self._spawn_up_to(sched.backlog)
                self._assign_idle(sched)
                self._poll(self._wait_timeout(sched), sched)
                for out in sched.outcomes:
                    sched.pending -= 1
                    yield out
                sched.outcomes = []
        finally:
            self.close()

    # -- internals ------------------------------------------------------

    def _reap_dead(self, sched: _Sched) -> None:
        """Process worker deaths no matter how they were noticed —
        including ones that slipped between polls (EOF can fire while
        the process is still mid-exit and ``is_alive()`` is True)."""
        for w in self._pool:
            if w.handled:
                continue
            if w.eof and w.proc.is_alive():
                w.proc.join(0.05)   # pipe closed: exit is imminent
            if w.proc.is_alive():
                continue
            # salvage any result that raced the death
            self._drain_conn(w, sched)
            if w.task_id is not None:
                task_id = w.unassign()
                st = sched.states[task_id]
                st.n_crashes += 1
                self._attempt_failed(
                    task_id, st,
                    f"worker died (exit code {w.proc.exitcode})", sched)
            elif not w.ready:
                # died before the ready handshake: a setup failure even
                # though no message made it out
                self._setup_failure(
                    f"worker exited during setup "
                    f"(exit code {w.proc.exitcode})")
            w.conn.close()
            w.handled = True

    def _spawn_up_to(self, backlog: int) -> None:
        live = [w for w in self._pool
                if not w.handled and w.proc.is_alive()]
        busy = sum(1 for w in live if w.task_id is not None)
        want = min(self.workers, busy + max(backlog, 0))
        while len(live) < want:
            w = _Worker(self._ctx, self.setup, self.run_fn, self.init)
            self._pool.append(w)
            live.append(w)

    def _assign_idle(self, sched: _Sched) -> None:
        for w in self._pool:
            if not sched.queue:
                return
            if w.handled or not (w.ready and w.task_id is None
                                 and w.proc.is_alive()):
                continue
            task_id = sched.queue[0]
            st = sched.states[task_id]
            st.attempts += 1
            try:
                w.conn.send((task_id, st.payload))
            except (OSError, ValueError):
                st.attempts -= 1        # worker died; task stays queued
                continue
            sched.queue.popleft()
            w.task_id = task_id
            if self.task_timeout is not None:
                w.deadline = time.monotonic() + self.task_timeout

    def _wait_timeout(self, sched: _Sched) -> Optional[float]:
        if sched.outcomes:
            return 0.0                  # results already waiting to yield
        now = time.monotonic()
        cands = [w.deadline for w in self._pool
                 if w.deadline is not None and w.task_id is not None]
        if sched.retry:
            cands.append(sched.retry[0][0])
        if not cands:
            return None                 # a conn/sentinel event will wake us
        return max(0.0, min(cands) - now) + 0.005

    def _poll(self, timeout: Optional[float], sched: _Sched) -> None:
        """Wait for worker events and drain results; death handling
        itself happens in ``_reap_dead`` on the next loop pass."""
        watch: List[Any] = []
        by_obj: Dict[Any, _Worker] = {}
        for w in self._pool:
            if w.handled:
                continue
            if not w.eof:
                watch.append(w.conn)
                by_obj[w.conn] = w
            watch.append(w.proc.sentinel)
            by_obj[w.proc.sentinel] = w
        if not watch:
            return
        fired = _conn_wait(watch, timeout)
        seen: set = set()
        for obj in fired:
            w = by_obj[obj]
            if id(w) in seen:
                continue
            seen.add(id(w))
            self._drain_conn(w, sched)

    def _drain_conn(self, w: _Worker, sched: _Sched) -> None:
        while True:
            try:
                if not w.conn.poll():
                    return
                tag, body = w.conn.recv()
            except (EOFError, OSError):
                w.eof = True            # death handled by _reap_dead
                return
            if tag == _READY:
                w.ready = True
                self._setup_failures = 0
            elif tag == _SETUP_ERROR:
                self._setup_failure(body)
            else:
                if tag != w.task_id:
                    continue            # stale echo from a killed attempt
                task_id = w.unassign()
                st = sched.states[task_id]
                status, value = body
                if status == "ok":
                    sched.outcomes.append(TaskOutcome(
                        task_id=task_id, ok=True, result=value,
                        attempts=st.attempts, n_timeouts=st.n_timeouts,
                        n_crashes=st.n_crashes))
                else:
                    self._attempt_failed(task_id, st, value, sched)

    def _reap_timeouts(self, now: float, sched: _Sched) -> None:
        for w in self._pool:
            if (w.handled or w.task_id is None or w.deadline is None
                    or now < w.deadline or not w.proc.is_alive()):
                continue
            # one last look: the result may have just landed
            self._drain_conn(w, sched)
            if w.task_id is None:
                continue
            task_id = w.unassign()
            st = sched.states[task_id]
            st.n_timeouts += 1
            w.kill()
            w.handled = True
            self._attempt_failed(
                task_id, st,
                f"task exceeded {self.task_timeout}s deadline", sched)

    def _setup_failure(self, detail: str) -> None:
        self._setup_failures += 1
        if self._setup_failures >= self.max_setup_failures:
            raise WorkerSetupError(
                f"{self._setup_failures} consecutive worker setup "
                f"failures; last: {detail}")

    def _attempt_failed(self, task_id: str, st: _TaskState, error: str,
                        sched: _Sched) -> None:
        if st.attempts > self.max_retries:
            sched.outcomes.append(TaskOutcome(
                task_id=task_id, ok=False, error=error,
                attempts=st.attempts, n_timeouts=st.n_timeouts,
                n_crashes=st.n_crashes))
            return
        due = time.monotonic() + self.backoff_s * (2 ** (st.attempts - 1))
        sched.schedule_retry(task_id, due)
