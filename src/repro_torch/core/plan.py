"""Declarative profiling plans: the paper's redundancy metric as an IR.

Counterpart of ``repro.core.plan``, with the port's profiler under it.  A
plan records the device its signatures were taken on (``device``, the card
unless ``build_plan`` is given ``device="cpu"``), and its execution
measures there; the device is not part of ``plan_id``.  The supervisor's spawn
workers each open their own CUDA context.

On a card, the workers share it in turn: each task's measurement holds the
card (``core.backends.card_lock``), so no timed window overlaps another
worker's work, and ``task_timeout`` runs from the moment a task takes the
card (a wait for it of up to ``CARD_WAIT_TURNS`` × ``workers`` ×
``task_timeout`` is not counted).  Host work — spawn, imports, the CUDA context, unpickling,
validation, the pipe — still overlaps.  A task
whose failure leaves the worker's CUDA context unusable (an illegal
address, a device-side assert: every later call fails) ends its worker, so
the supervisor counts a crash and retries the task in a fresh context; the
serial path raises ``DeviceContextError`` instead of failing every task
after it.

The paper's headline result — 56.4% fewer profiling GPU-hours across the
12-model corpus — comes from deciding *what not to measure* before
running anything.  ``build_plan`` makes that decision a first-class,
inspectable artifact: it traces every (model, backend) pair in a corpus,
resolves runnable sets, computes signatures (all via the profiler's
``entry_specs`` build half), and dedups measurement tasks corpus-wide —
against the latency DB *and* against each other.  The result is a frozen
:class:`ProfilePlan` whose :class:`CoverageReport` is Table 2 computable
as a dry run with zero measurements: per-model op counts, tasks already
satisfied, tasks shared between models, and exact measurement-point
(= DB-write) accounting, plus a GPU-time savings estimate replayed from
stored measurements where they exist.

``execute_plan`` runs the remaining tasks through the profiler's
measurement machinery (``measure_payload_rows`` — rows bit-identical to
a sequential ``profile_model`` over the same corpus) under supervision:
tasks stream back per-task from a replaceable worker pool, each task's
rows commit atomically before its id is journaled (checksummed, fsynced)
to the checkpoint file, failures retry with backoff, and tasks that
exhaust their retries are quarantined in the journal so an interrupted
or partially-poisoned corpus sweep resumes where it stopped instead of
restarting — or re-tripping.
"""
from __future__ import annotations

import contextlib
import hashlib
import heapq
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import card_lock
from repro_torch.core.database import LatencyDB
from repro_torch.core.device import Device
from repro_torch.core.opset import entry_task_id
from repro_torch.core.profiler import (DoolyProf, EntryReport, ProfileReport,
                                       SweepConfig, validate_rows,
                                       warm_process)
from repro_torch.core.runner import ModelTrace, trace_model
from repro_torch.core.signature import Signature
from repro_torch.core.supervisor import SupervisedPool

#: (model name, attention backend, tp) — one profiled configuration
ModelKey = Tuple[str, str, int]

#: dry-run price of one unmeasured sweep point (seconds per repeat); only
#: used for tasks with no stored measurements to replay
NOMINAL_POINT_S = 1e-3


@dataclass(frozen=True)
class PlanTask:
    """One measurement task: a signature swept once on one hardware.

    ``cfg``/``backend`` belong to the task's *first owner* — the model
    that would have measured it under sequential per-model profiling —
    so execution builds the exact context that owner would have built.
    ``est_cost_s`` is the dry-run GPU-time estimate: replayed from stored
    measurements when ``est_measured`` (the task is satisfied), priced at
    :data:`NOMINAL_POINT_S` per point otherwise."""
    task_id: str
    sig_hash: str
    kind: str                       # "module" | "op"
    payload: Tuple                  # profiler measurement payload
    cfg: ModelConfig
    backend: str
    n_points: int
    owners: Tuple[str, ...]         # "model/backend" labels sharing it
    satisfied: bool                 # already in the DB at plan time
    est_cost_s: float
    est_measured: bool


@dataclass(frozen=True)
class PlanEntry:
    """Per-model runnable-set entry metadata, enough to reconstruct the
    legacy ``ProfileReport`` and the model_operations rows at execute
    time.  ``reused`` carries sequential-profiling semantics: True when
    the signature was already in the DB, claimed by an earlier model in
    the plan, or by an earlier entry of the same model."""
    sig_hash: str
    name: str
    group: str
    variant: str
    module: str
    count: int
    reused: bool


@dataclass(frozen=True)
class ModelCoverage:
    model: str
    backend: str
    tp: int
    n_entries: int          # runnable-set entries profiled
    n_ops: int              # call-graph occurrences (sum of counts)
    n_tasks: int            # distinct signatures this model needs
    n_satisfied: int        # already measured in the DB at plan time
    n_shared: int           # first-owned by an earlier model in the plan
    n_to_measure: int       # tasks this model must measure itself
    points: int             # measurement rows a naive profile would write
    est_naive_s: float      # dry-run GPU-time of profiling it alone

    def label(self) -> str:
        return f"{self.model}/{self.backend}/tp{self.tp}"


@dataclass(frozen=True)
class CoverageReport:
    """The paper's Table-2 redundancy accounting, from a dry run."""
    hardware: str
    models: Tuple[ModelCoverage, ...]
    naive_tasks: int        # sum of per-model task counts (no sharing)
    plan_tasks: int         # distinct unsatisfied tasks the plan measures
    satisfied_tasks: int    # distinct tasks the DB already covers
    shared_tasks: int       # distinct tasks with more than one owner
    naive_points: int       # DB writes naive per-model profiling would do
    plan_points: int        # DB writes executing this plan will do
    est_naive_s: float      # dry-run GPU-time, naive
    est_spent_s: float      # dry-run GPU-time, this plan
    est_estimated_tasks: int  # tasks priced nominally (no stored data)

    @property
    def dedup_frac(self) -> float:
        return (1.0 - self.plan_tasks / self.naive_tasks
                if self.naive_tasks else 0.0)

    @property
    def point_savings_frac(self) -> float:
        return (1.0 - self.plan_points / self.naive_points
                if self.naive_points else 0.0)

    @property
    def est_saved_s(self) -> float:
        return self.est_naive_s - self.est_spent_s

    @property
    def est_savings_frac(self) -> float:
        return (self.est_saved_s / self.est_naive_s
                if self.est_naive_s else 0.0)

    def table(self) -> str:
        head = (f"{'model':34s} {'entries':>7s} {'ops':>6s} {'tasks':>6s} "
                f"{'in-db':>6s} {'shared':>6s} {'measure':>7s} "
                f"{'points':>7s} {'est-s':>9s}")
        lines = [head, "-" * len(head)]
        for m in self.models:
            lines.append(
                f"{m.label():34s} {m.n_entries:7d} {m.n_ops:6d} "
                f"{m.n_tasks:6d} {m.n_satisfied:6d} {m.n_shared:6d} "
                f"{m.n_to_measure:7d} {m.points:7d} {m.est_naive_s:9.3f}")
        lines.append("-" * len(head))
        lines.append(
            f"naive: {self.naive_tasks} tasks / {self.naive_points} points"
            f" / {self.est_naive_s:.3f} est-s   ->   plan: "
            f"{self.plan_tasks} tasks / {self.plan_points} points / "
            f"{self.est_spent_s:.3f} est-s")
        lines.append(
            f"dedup: {100 * self.dedup_frac:.1f}% of tasks "
            f"({self.satisfied_tasks} satisfied by the DB, "
            f"{self.shared_tasks} shared between models); est GPU-time "
            f"saved {self.est_saved_s:.3f}s "
            f"({100 * self.est_savings_frac:.1f}%"
            + (f", {self.est_estimated_tasks} tasks priced nominally)"
               if self.est_estimated_tasks else ")"))
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "hardware": self.hardware,
            "models": [{
                "model": m.model, "backend": m.backend, "tp": m.tp,
                "n_entries": m.n_entries, "n_ops": m.n_ops,
                "n_tasks": m.n_tasks, "n_satisfied": m.n_satisfied,
                "n_shared": m.n_shared, "n_to_measure": m.n_to_measure,
                "points": m.points, "est_naive_s": m.est_naive_s,
            } for m in self.models],
            "naive_tasks": self.naive_tasks, "plan_tasks": self.plan_tasks,
            "satisfied_tasks": self.satisfied_tasks,
            "shared_tasks": self.shared_tasks,
            "naive_points": self.naive_points,
            "plan_points": self.plan_points,
            "dedup_frac": self.dedup_frac,
            "point_savings_frac": self.point_savings_frac,
            "est_naive_s": self.est_naive_s,
            "est_spent_s": self.est_spent_s,
            "est_saved_s": self.est_saved_s,
            "est_savings_frac": self.est_savings_frac,
            "est_estimated_tasks": self.est_estimated_tasks,
        }


@dataclass(frozen=True)
class ProfilePlan:
    """Frozen profiling plan: what to measure, for whom, at what cost.

    Built by :func:`build_plan`; executed by :func:`execute_plan`.  Task
    order is deterministic (corpus order, first-owner-first), so the same
    corpus against the same DB state always produces the same
    ``plan_id`` — the checkpoint journal binds to it."""
    hardware: str
    oracle: str
    sweep: SweepConfig
    models: Tuple[ModelKey, ...]
    tasks: Tuple[PlanTask, ...]
    entries: Tuple[Tuple[ModelKey, Tuple[PlanEntry, ...]], ...]
    signatures: Tuple[Signature, ...]
    device: str = "cuda"            # where the plan was signed and measures

    @property
    def plan_id(self) -> str:
        """Digest of what the corpus needs measured: hardware, oracle,
        sweep points, model keys, and the ordered task ids.  Deliberately
        independent of DB state (``satisfied`` flags), so a plan rebuilt
        after a partially-executed run keeps its id and the checkpoint
        journal still matches — already-landed tasks simply come back
        satisfied and are skipped."""
        h = hashlib.sha256()
        h.update(self.hardware.encode())
        h.update(self.oracle.encode())
        h.update(repr(self.sweep).encode())
        for m, b, tp in self.models:
            h.update(f"|{m}/{b}/{tp}".encode())
        for t in self.tasks:
            h.update(f"|{t.task_id}".encode())
        return h.hexdigest()[:16]

    @property
    def todo(self) -> Tuple[PlanTask, ...]:
        return tuple(t for t in self.tasks if not t.satisfied)

    def task(self, sig_hash: str) -> PlanTask:
        return self._by_hash()[sig_hash]

    def _by_hash(self) -> Dict[str, PlanTask]:
        cache = getattr(self, "_by_hash_cache", None)
        if cache is None:
            cache = {t.sig_hash: t for t in self.tasks}
            object.__setattr__(self, "_by_hash_cache", cache)
        return cache

    def coverage(self) -> CoverageReport:
        by_hash = self._by_hash()
        models = []
        claimed: set = set()        # sigs first-owned by an earlier model
        for key, pentries in self.entries:
            name, backend, tp = key
            owner = f"{name}/{backend}"
            sigs = []
            seen: set = set()
            for e in pentries:
                if e.sig_hash not in seen:
                    seen.add(e.sig_hash)
                    sigs.append(e.sig_hash)
            satisfied = [h for h in sigs if by_hash[h].satisfied]
            shared = [h for h in sigs if not by_hash[h].satisfied
                      and h in claimed]
            to_measure = [h for h in sigs if not by_hash[h].satisfied
                          and h not in claimed]
            claimed.update(sigs)
            models.append(ModelCoverage(
                model=name, backend=backend, tp=tp,
                n_entries=len(pentries),
                n_ops=sum(e.count for e in pentries),
                n_tasks=len(sigs), n_satisfied=len(satisfied),
                n_shared=len(shared), n_to_measure=len(to_measure),
                points=sum(by_hash[h].n_points for h in sigs),
                est_naive_s=sum(by_hash[h].est_cost_s for h in sigs)))
        todo = self.todo
        return CoverageReport(
            hardware=self.hardware, models=tuple(models),
            naive_tasks=sum(m.n_tasks for m in models),
            plan_tasks=len(todo),
            satisfied_tasks=sum(t.satisfied for t in self.tasks),
            shared_tasks=sum(len(t.owners) > 1 for t in self.tasks),
            naive_points=sum(m.points for m in models),
            plan_points=sum(t.n_points for t in todo),
            est_naive_s=sum(m.est_naive_s for m in models),
            est_spent_s=sum(t.est_cost_s for t in todo),
            est_estimated_tasks=sum(not t.est_measured
                                    for t in self.tasks))

    # -- legacy bridge --------------------------------------------------

    def legacy_report(self, db: LatencyDB,
                      model: Optional[ModelKey] = None) -> ProfileReport:
        """Reconstruct the ``ProfileReport`` a sequential
        ``profile_model`` call would have returned for one model of an
        *executed* plan: entry order, reuse flags, and replay-accounted
        costs all match (costs bitwise, since replay returns the stored
        measurements in sweep-point order)."""
        key = model or self.models[0]
        entries = dict(self.entries).get(key)
        if entries is None:
            raise KeyError(f"model {key!r} is not part of this plan")
        prof = DoolyProf(db, oracle=self.oracle, hardware=self.hardware,
                         sweep=self.sweep, device=self.device)
        report = ProfileReport(model=key[0], backend=key[1])
        for e in entries:
            task = self.task(e.sig_hash)
            # per-point multiply-then-accumulate, exactly as profile_model
            # sums costs — keeps the reconstruction bitwise equal
            cost = 0.0
            for k in prof.task_point_keys(task.payload, task.cfg):
                cost += prof._replay(e.sig_hash, k) * self.sweep.repeats
            report.entries.append(EntryReport(
                e.sig_hash, e.name, e.group, e.variant, e.count, e.reused,
                cost))
        return report


@dataclass
class ExecuteReport:
    """What one ``execute_plan`` call actually did."""
    plan_id: str
    n_tasks: int                    # unsatisfied tasks in the plan
    measured: int                   # tasks measured in this call
    skipped_journal: int            # completed earlier, per the checkpoint
    satisfied: int                  # never needed measuring
    rows_written: int               # measurement rows landed in this call
    models: int
    elapsed_s: float = 0.0
    checkpoint: Optional[str] = None
    workers: int = 1
    retried: int = 0                # extra attempts beyond the first
    timed_out: int = 0              # attempts killed by the task deadline
    quarantined: int = 0            # tasks poisoned in THIS call
    skipped_quarantined: int = 0    # quarantined earlier, per the journal
    quarantine: Tuple[Tuple[str, str], ...] = ()    # (task_id, reason)


# ---------------------------------------------------------------------------
# plan build (the dry run)
# ---------------------------------------------------------------------------

def build_plan(db: LatencyDB, cfgs: Sequence[ModelConfig], *,
               backends: Sequence[str] = ("xla",), tp: int = 1,
               hardware: Optional[str] = None, oracle: str = "cuda_events",
               sweep: Optional[SweepConfig] = None,
               traces: Optional[Dict[str, ModelTrace]] = None,
               pairs: Optional[Sequence[Tuple[ModelConfig, str]]] = None,
               device: Device = "cuda") -> ProfilePlan:
    """Trace + resolve + sign the whole corpus, dedup corpus-wide, and
    return the frozen plan.  Zero measurements are taken; the only DB
    access is the dedup read (``measured_hashes``) and measurement replay
    for the cost estimates of already-satisfied tasks.

    The corpus is the ``cfgs`` x ``backends`` cross product; ``pairs``
    (an explicit (cfg, backend) sequence) overrides it for ragged
    corpora, so callers like a sweep grid never plan — or measure —
    configurations they don't need.  Each model is traced once no matter
    how many backends sweep it (the runnable set is backend-independent;
    signatures are not)."""
    prof = DoolyProf(db, oracle=oracle, hardware=hardware, sweep=sweep,
                     device=device)
    hardware = prof.hardware
    known = frozenset(db.measured_hashes(hardware))
    traces = dict(traces or {})
    if pairs is None:
        pairs = [(cfg, b) for cfg in cfgs for b in backends]
    entries_cache: Dict[str, List] = {}
    builders: Dict[str, Dict] = {}          # sig_hash -> mutable task state
    sig_map: Dict[str, Signature] = {}
    plan_entries: List[Tuple[ModelKey, Tuple[PlanEntry, ...]]] = []
    model_keys: List[ModelKey] = []

    from repro_torch.core.opset import find_runnable_set
    for cfg, backend in pairs:
        if cfg.name not in entries_cache:
            mt = traces.get(cfg.name) or trace_model(cfg)
            entries_cache[cfg.name] = find_runnable_set(mt.trace,
                                                        device=prof.device)
        key: ModelKey = (cfg.name, backend, tp)
        owner = f"{cfg.name}/{backend}"
        model_keys.append(key)
        pentries: List[PlanEntry] = []
        seen_here: set = set()
        for entry, spec in prof.entry_specs(
                cfg, backend, entries=entries_cache[cfg.name]):
            h = spec.sig.hash
            sig_map.setdefault(h, spec.sig)
            builder = builders.get(h)
            reused = (h in known or builder is not None
                      or h in seen_here)
            if builder is None and spec.payload is not None:
                builder = builders[h] = {
                    "payload": spec.payload, "cfg": cfg,
                    "backend": backend, "kind": spec.payload[0],
                    "n_points": spec.n_points, "owners": []}
            if builder is not None and owner not in builder["owners"]:
                builder["owners"].append(owner)
            seen_here.add(h)
            pentries.append(PlanEntry(
                sig_hash=h, name=spec.name, group=spec.group,
                variant=spec.variant, module=spec.module,
                count=spec.count, reused=reused))
        plan_entries.append((key, tuple(pentries)))

    tasks: List[PlanTask] = []
    for h, b in builders.items():
        satisfied = h in known
        keys = prof.task_point_keys(b["payload"], b["cfg"])
        if satisfied:
            est = (sum(prof._replay(h, k) for k in keys)
                   * prof.sweep.repeats)
            est_measured = True
        else:
            est = len(keys) * prof.sweep.repeats * NOMINAL_POINT_S
            est_measured = False
        tasks.append(PlanTask(
            task_id=entry_task_id(h, hardware), sig_hash=h,
            kind=b["kind"], payload=b["payload"], cfg=b["cfg"],
            backend=b["backend"], n_points=len(keys),
            owners=tuple(b["owners"]), satisfied=satisfied,
            est_cost_s=est, est_measured=est_measured))

    return ProfilePlan(
        hardware=hardware, oracle=oracle, sweep=prof.sweep,
        models=tuple(model_keys), tasks=tuple(tasks),
        entries=tuple(plan_entries), signatures=tuple(sig_map.values()),
        device=str(prof.device))


# ---------------------------------------------------------------------------
# packing + sharding (the multi-host seam)
# ---------------------------------------------------------------------------

def _nominal_cost(task: PlanTask) -> float:
    """Content-deterministic task price: a pure function of the task's
    sweep-point count, never of DB state.  Unsatisfied tasks' ``est_cost_s``
    equals this already; satisfied tasks replay stored measurements, which
    would make shard assignment drift as rows land — so packing always
    prices nominally."""
    return float(task.n_points)


def lpt_order(tasks: Sequence[PlanTask]) -> Tuple[PlanTask, ...]:
    """Longest-processing-time-first schedule: tasks sorted by descending
    nominal cost, ties broken by task id.  Deterministic for a given task
    set, independent of worker count and DB state — the supervised pool
    drains this order so its makespan is not tail-dominated by a long
    task landing last."""
    return tuple(sorted(
        tasks, key=lambda t: (-_nominal_cost(t), t.task_id)))


def lpt_assign(tasks: Sequence[PlanTask], n: int,
               cost: Optional[Callable[[PlanTask], float]] = None
               ) -> List[List[PlanTask]]:
    """Greedy LPT bin packing of ``tasks`` onto ``n`` bins: longest first,
    each task onto the currently-lightest bin (ties to the lowest bin
    index).  Deterministic; bins partition the input exactly."""
    n = max(1, int(n))
    cost = cost or _nominal_cost
    bins: List[List[PlanTask]] = [[] for _ in range(n)]
    loads = [(0.0, i) for i in range(n)]
    heapq.heapify(loads)
    for t in lpt_order(tasks):
        load, i = heapq.heappop(loads)
        bins[i].append(t)
        heapq.heappush(loads, (load + cost(t), i))
    return bins


def packing_report(tasks: Sequence[PlanTask], n: int) -> Dict[str, float]:
    """Structural packing accounting for ``n`` parallel workers, priced
    nominally (so it is deterministic on any machine): total cost, the
    LPT makespan, the FIFO (submission-order list scheduling) makespan,
    Graham's list-scheduling bound ``total/n + (1 - 1/n) * max_task``
    (which LPT must respect), and the resulting estimated speedup
    ``total / lpt_makespan``."""
    n = max(1, int(n))
    costs = [_nominal_cost(t) for t in tasks]
    total = float(sum(costs))
    max_task = float(max(costs, default=0.0))

    def _makespan(ordered: Sequence[PlanTask]) -> float:
        loads = [(0.0, i) for i in range(n)]
        heapq.heapify(loads)
        for t in ordered:
            load, i = heapq.heappop(loads)
            heapq.heappush(loads, (load + _nominal_cost(t), i))
        return max(load for load, _ in loads) if tasks else 0.0

    lpt = _makespan(lpt_order(tasks))
    fifo = _makespan(list(tasks))
    bound = total / n + (1.0 - 1.0 / n) * max_task
    return {
        "n_tasks": len(tasks), "n_bins": n,
        "total_cost": total, "max_task_cost": max_task,
        "lpt_makespan": lpt, "fifo_makespan": fifo,
        "bound": bound,
        "lpt_within_bound": bool(lpt <= bound * (1 + 1e-12)),
        "fifo_over_lpt": fifo / lpt if lpt else 1.0,
        "est_speedup": total / lpt if lpt else float(n),
    }


def shard_plan(plan: ProfilePlan, n: int) -> Tuple[ProfilePlan, ...]:
    """Split a corpus plan into at most ``n`` content-addressed sub-plans
    balanced by nominal task cost (LPT bin packing over the *full* task
    set, satisfied tasks included).

    Each shard is a full :class:`ProfilePlan` — same hardware / oracle /
    sweep / model keys, its own task subset and matching signatures, and
    therefore its own ``plan_id`` — executable independently against a
    scratch DB with its own journal.  Shards carry no ``entries``: the
    per-model call-graph rows land once, at the coordinator, when
    :func:`merge_shards` (or a final ``execute_plan`` of the parent plan)
    folds shard results back into the canonical DB.

    The assignment is a pure function of task content (ids and sweep
    point counts), never of DB state: rebuilding the parent plan after a
    partially-executed shard run re-shards identically, so each shard's
    journal still matches its shard's ``plan_id`` and a killed shard
    resumes without touching the others.  Empty bins (``n`` larger than
    the task count) are dropped."""
    bins = lpt_assign(plan.tasks, n)
    shards = []
    for bin_tasks in bins:
        if not bin_tasks:
            continue
        hashes = {t.sig_hash for t in bin_tasks}
        shards.append(ProfilePlan(
            hardware=plan.hardware, oracle=plan.oracle, sweep=plan.sweep,
            models=plan.models, tasks=tuple(bin_tasks), entries=(),
            signatures=tuple(s for s in plan.signatures
                             if s.hash in hashes), device=plan.device))
    return tuple(shards)


@dataclass(frozen=True)
class ShardMergeReport:
    """Coordinator accounting for one :func:`merge_shards` call."""
    plan_id: str
    n_dbs: int                      # scratch DBs folded in
    n_journals: int                 # shard journals folded in
    rows_merged: int                # measurement rows newly landed
    rows_skipped: int               # identical rows already present
    conflicts: int                  # same key, different latency
    signatures_merged: int
    tasks_done: int                 # done records now in the checkpoint
    tasks_quarantined: int
    points_planned: int             # plan.todo points at merge time
    checkpoint: Optional[str] = None

    @property
    def points_merged(self) -> int:
        """Measurement points accounted for across this merge and any
        earlier ones (exactness gate: equals ``points_planned`` once all
        shards merged)."""
        return self.rows_merged + self.rows_skipped


def merge_shards(db: LatencyDB, plan: ProfilePlan, *,
                 dbs: Sequence[Union[str, LatencyDB]] = (),
                 journals: Sequence[str] = (),
                 checkpoint: Optional[str] = None,
                 on_conflict: str = "error") -> ShardMergeReport:
    """The coordinator merge step: fold shard scratch DBs and shard
    journals back into the canonical DB (and parent checkpoint journal),
    then land the parent plan's idempotent tail — every signature and the
    per-model call-graph rows shard executions deliberately skip.

    ``dbs`` are scratch :class:`LatencyDB` handles or paths (paths are
    opened read-only for the copy and closed); ``journals`` are shard
    journal files, each bound to its shard's ``plan_id`` — accepted only
    if every record names a task of ``plan`` (foreign-plan journals are
    refused).  The whole operation is idempotent: re-merging the same
    shards reports rows as skipped, not merged, and appends no duplicate
    journal records.  Point accounting is exact — once every shard has
    merged, ``points_merged == points_planned``."""
    from repro_torch.core.journal import merge_journals
    rows_merged = rows_skipped = conflicts = sigs = 0
    for src in dbs:
        owned = isinstance(src, (str, os.PathLike))
        sdb = LatencyDB(os.fspath(src), wal=False) if owned else src
        try:
            rep = db.merge_from(sdb, hardware=plan.hardware,
                                on_conflict=on_conflict)
        finally:
            if owned:
                sdb.close()
        rows_merged += rep.rows_merged
        rows_skipped += rep.rows_skipped
        conflicts += rep.conflicts
        sigs += rep.signatures_merged

    tasks_done = tasks_quar = 0
    if journals:
        if not checkpoint:
            raise ValueError("merging journals needs a target checkpoint")
        jrep = merge_journals(
            checkpoint, plan.plan_id, journals,
            known_ids={t.task_id for t in plan.tasks})
        tasks_done = jrep.done_total
        tasks_quar = jrep.quarantined_total
    _land_plan_tail(db, plan)
    return ShardMergeReport(
        plan_id=plan.plan_id, n_dbs=len(list(dbs)),
        n_journals=len(list(journals)), rows_merged=rows_merged,
        rows_skipped=rows_skipped, conflicts=conflicts,
        signatures_merged=sigs, tasks_done=tasks_done,
        tasks_quarantined=tasks_quar,
        points_planned=sum(t.n_points for t in plan.todo),
        checkpoint=checkpoint)


def _land_plan_tail(db: LatencyDB, plan: ProfilePlan) -> None:
    """The idempotent execution tail: every signature (satisfied and
    quarantined ones included) plus the per-model call-graph counts, in
    one transaction.  Shared by ``execute_plan`` and ``merge_shards``."""
    with db.transaction():
        db.insert_signatures_bulk(plan.signatures)
        for (name, backend, tp), pentries in plan.entries:
            cid = db.config_id(name, backend, plan.hardware, tp)
            counts: Dict[Tuple[str, str], int] = {}
            for e in pentries:
                k = (e.sig_hash, e.module)
                counts[k] = counts.get(k, 0) + e.count
            db.add_model_operations_bulk(
                [(cid, sig, module, count)
                 for (sig, module), count in counts.items()])


# ---------------------------------------------------------------------------
# plan execution (resumable, parallel, supervised)
# ---------------------------------------------------------------------------

#: env hook: "module:function" resolving to a measure shim with signature
#: ``(prof, payload, cfg, backend) -> rows``.  Applied by every execution
#: path — in-process and spawned workers alike — so fault-injection tests
#: can make specific tasks crash, hang, or emit garbage deterministically.
MEASURE_SHIM_ENV = "REPRO_MEASURE_SHIM"


class PlanExecutionError(RuntimeError):
    """A task exhausted its retries and ``fail_fast`` was requested."""

    def __init__(self, task_id: str, reason: str):
        super().__init__(
            f"task {task_id} failed after retries: {reason}")
        self.task_id = task_id
        self.reason = reason


class DeviceContextError(PlanExecutionError):
    """A task's failure left the CUDA context unusable; the serial path
    stops, since every later task in this process would fail too."""

    def __init__(self, task_id: str, reason: str):
        RuntimeError.__init__(
            self, f"task {task_id} left the CUDA context unusable ({reason}); "
            "committed tasks stay journaled: resume in a fresh process")
        self.task_id = task_id
        self.reason = reason


#: a card worker's exit code when a task left its CUDA context unusable
POISONED_EXIT = 86

#: how long a pool's task may wait for the card, in turns of every worker at
#: its longest (``workers`` × ``task_timeout`` each): room for another run
#: sharing the card and for ``flock``'s unordered wake-ups
CARD_WAIT_TURNS = 4


def _context_ok(device: torch.device) -> bool:
    """Whether ``device`` still takes work after a task raised.  A sticky
    CUDA error (an illegal address, a device-side assert) fails every later
    call, this synchronize first; an out-of-memory error does not.  The CPU
    has no such state."""
    if device.type != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
    except RuntimeError:                        # torch.AcceleratorError too
        return False
    return True


def _write_turn(path: str, task_id: str, state: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(f"{task_id} {state} {time.monotonic()!r}")
    os.replace(tmp, path)


def _read_turn(path: str) -> Optional[Tuple[str, str, float]]:
    try:
        with open(path) as f:
            task_id, state, since = f.read().split()
    except (OSError, ValueError):
        return None
    return task_id, state, float(since)


@contextlib.contextmanager
def _card_turn(lock, turns: Optional[str], task_id: str):
    """One task's turn on the card, holding ``lock`` (its ``card_lock``).
    In a pool on a card (``turns`` set) the worker records in
    ``turns/<pid>`` that the task waits for the card, then since when it
    holds it, for ``_CardPool``'s deadline."""
    if turns is None:
        with lock:
            yield
        return
    mark = os.path.join(turns, str(os.getpid()))
    _write_turn(mark, task_id, "waiting")
    with lock:
        _write_turn(mark, task_id, "holding")
        yield


class _CardPool(SupervisedPool):
    """``execute_plan``'s supervised pool.  On a card (``card``) each worker
    records its turns on the card (``_card_turn``) in a directory of the
    pool's own, handed to the workers' setup after ``init``, and a task's
    deadline runs from the moment it takes the card.  The supervisor starts
    it at assignment, so at each expiry the pool reads the worker's turn
    record: while the task waits for the card, the deadline moves on by
    ``task_timeout`` at most, up to ``wait_limit`` after it began to wait
    (by default ``CARD_WAIT_TURNS`` × ``workers`` × ``task_timeout``);
    once it holds the card, to ``task_timeout`` after it took it.  So a
    task that hangs holding the card is found within ``task_timeout`` of
    its deadline, however long it waited first.  A task that has not yet
    asked for the card keeps the supervisor's deadline, and one that waits
    past ``wait_limit`` (a process that holds the card and does not let
    go) times out as before.  Off a card it is the supervisor's pool."""

    def __init__(self, setup, run, init, *, card: bool,
                 wait_limit: Optional[float] = None, **kw):
        self.turns = (tempfile.mkdtemp(prefix="repro-card-turns-") if card
                      else None)
        super().__init__(setup, run, (init, self.turns), **kw)
        self.wait_limit = wait_limit
        if wait_limit is None and self.task_timeout is not None:
            self.wait_limit = (CARD_WAIT_TURNS * self.workers
                               * self.task_timeout)

    def close(self) -> None:
        super().close()
        if self.turns is not None:
            shutil.rmtree(self.turns, ignore_errors=True)

    def _reap_timeouts(self, now: float, sched) -> None:
        for w in self._pool if self.turns is not None else ():
            if (w.handled or w.task_id is None or w.deadline is None
                    or now < w.deadline):
                continue
            turn = _read_turn(os.path.join(self.turns, str(w.proc.pid)))
            if turn is None or turn[0] != w.task_id:
                continue
            _, state, since = turn
            if state == "holding":
                w.deadline = max(w.deadline, since + self.task_timeout)
            elif now < since + self.wait_limit:
                w.deadline = min(now + self.task_timeout,
                                 since + self.wait_limit)
        super()._reap_timeouts(now, sched)


def _resolve_measure_fn(prof: DoolyProf,
                        measure_fn: Optional[Callable] = None) -> Callable:
    """The per-task measure callable: an explicit override, the env-var
    shim, or the profiler's own ``measure_payload_rows``."""
    if measure_fn is None:
        spec = os.environ.get(MEASURE_SHIM_ENV)
        if spec:
            import importlib
            mod, _, fn = spec.partition(":")
            measure_fn = getattr(importlib.import_module(mod), fn)
    if measure_fn is None:
        return lambda payload, cfg, backend: prof.measure_payload_rows(
            payload, cfg, backend)
    bound = measure_fn
    return lambda payload, cfg, backend: bound(prof, payload, cfg, backend)


def _plan_worker_setup(init):
    """Supervised-worker setup: a throwaway in-memory DB, a profiler
    matching the plan's oracle/hardware/sweep, and the corpus config
    table.  Module-level so it pickles under the spawn start method.

    The config table ships each distinct ``ModelConfig`` once per worker
    at setup; per-task payloads then reference configs by name, so a
    10k-task plan does not re-pickle the same config 10k times.  Workers
    never re-trace: the measure payloads were fully built at plan time.
    On a card each worker opens its own CUDA context and warms itself on
    ``warm`` (the schedule's first task: config name, backend, payload)
    here, before its first task and its first turn on the card
    (``warm_process``); ``turns`` is the directory of the card turns'
    records (None off a card)."""
    (oracle, hardware, sweep, device, cfgs, warm), turns = init
    prof = DoolyProf(LatencyDB(), oracle=oracle, hardware=hardware,
                     sweep=sweep, device=device)
    cfg_name, backend, payload = warm
    warm_process(prof, payload, cfgs[cfg_name], backend)
    return _resolve_measure_fn(prof), cfgs, prof, turns


def _plan_worker_run(state, payload) -> List[Tuple]:
    """Supervised-worker task: measure one plan task, holding the card,
    and validate its rows *in the worker*, so garbage measurements fail
    the attempt (and consume retry budget) instead of reaching the
    coordinator.  A failure that leaves the CUDA context unusable ends
    the worker: the supervisor counts a crash and retries the task in a
    fresh worker."""
    measure, cfgs, prof, turns = state
    task_id, cfg_name, backend, tpayload = payload
    try:
        with _card_turn(card_lock(prof.device), turns, task_id):
            rows = measure(tpayload, cfgs[cfg_name], backend)
    except Exception as e:                      # noqa: BLE001
        if not _context_ok(prof.device):
            print(f"task {task_id}: {type(e).__name__}: {e}; the CUDA "
                  "context is unusable, the worker exits", file=sys.stderr,
                  flush=True)
            os._exit(POISONED_EXIT)
        raise
    return validate_rows(rows)


def read_journal(path: str, plan: ProfilePlan) -> set:
    """Completed task ids from a checkpoint file; refuses a journal
    written for a different plan.  Quarantined tasks are not included —
    use :func:`repro_torch.core.journal.read_journal_state` for the full
    picture."""
    return _journal_state(path, plan).done


def _journal_state(path: Optional[str], plan: ProfilePlan):
    from repro_torch.core.journal import read_journal_state
    return read_journal_state(path, plan.plan_id,
                              known_ids={t.task_id for t in plan.tasks})


def execute_plan(db: LatencyDB, plan: ProfilePlan, *, workers: int = 1,
                 checkpoint: Optional[str] = None,
                 progress: Optional[Callable] = None,
                 task_timeout: Optional[float] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.1,
                 fail_fast: bool = False, journal_fsync: bool = True,
                 measure_fn: Optional[Callable] = None) -> ExecuteReport:
    """Measure every unsatisfied, un-journaled, un-quarantined task and
    land the plan's signatures + per-model call-graph rows.

    Each task's measurement rows and its signature commit in one
    transaction *before* its id is appended to the checkpoint journal
    (flushed and fsynced), so a crash can lose at most in-flight tasks
    and a resume re-measures only what never committed.

    Execution is supervised: a task whose measurement raises, returns
    invalid rows, crashes its worker, or (``task_timeout``) hangs is
    retried up to ``max_retries`` times with exponential backoff
    (``retry_backoff_s * 2**attempt``), then **quarantined** — recorded
    in the journal so resumes skip it — while the rest of the corpus
    completes.  ``fail_fast=True`` raises :class:`PlanExecutionError` on
    the first exhausted task instead (committed tasks stay journaled for
    resume).  With ``workers > 1`` or a ``task_timeout``, tasks run on a
    replaceable spawn-process pool, submitted longest-first
    (:func:`lpt_order` — a deterministic schedule, so the parallel
    makespan is not tail-dominated) and streaming back in completion
    order; rows are bit-identical to a serial run either way.  Commit,
    journal-append, and ``progress`` failures are never swallowed — only
    measurement failures are supervised.

    On a card every task's measurement holds the card, so the workers
    measure one at a time and overlap only their host work; there
    ``task_timeout`` counts from the moment a task takes the card, after a
    wait for it of at most ``CARD_WAIT_TURNS`` × ``workers`` ×
    ``task_timeout``.  A
    failure that leaves the CUDA context unusable replaces the worker (a
    crash, retried); in the serial path it raises
    :class:`DeviceContextError`, quarantining nothing."""
    t0 = time.perf_counter()
    from repro_torch.core.journal import PlanJournal
    prof = DoolyProf(db, oracle=plan.oracle, hardware=plan.hardware,
                     sweep=plan.sweep, device=plan.device)
    sig_by_hash = {s.hash: s for s in plan.signatures}
    state = _journal_state(checkpoint, plan)
    todo = [t for t in plan.todo if t.task_id not in state.done
            and t.task_id not in state.quarantined]
    skipped = sum(t.task_id in state.done for t in plan.todo)
    skipped_quar = sum(t.task_id in state.quarantined for t in plan.todo)

    journal = None
    if checkpoint:
        journal = PlanJournal(checkpoint, plan.plan_id,
                              fsync=journal_fsync).open()

    measured = 0
    rows_written = 0
    retried = 0
    timed_out = 0
    quarantined: List[Tuple[str, str]] = []

    def _commit(task: PlanTask, rows: List[Tuple]):
        nonlocal measured, rows_written
        validate_rows(rows, where=f"task {task.task_id}")
        with db.transaction():
            db.insert_signatures_bulk([sig_by_hash[task.sig_hash]])
            db.add_measurements_bulk(rows)
        if journal is not None:
            journal.record_done(task.task_id)
        measured += 1
        rows_written += len(rows)
        if progress is not None:
            progress(task, measured + skipped, len(plan.todo))

    def _quarantine(task: PlanTask, reason: str):
        if fail_fast:
            raise PlanExecutionError(task.task_id, reason)
        if journal is not None:
            journal.record_quarantine(task.task_id, reason)
        quarantined.append((task.task_id, reason))

    try:
        if todo and (workers > 1 or task_timeout is not None):
            by_id = {t.task_id: t for t in todo}
            # longest-first submission: the pool drains its queue FIFO,
            # so lpt_order keeps a long task from landing last and
            # tail-dominating the makespan.  Rows stay bit-identical to
            # any other order — each task commits independently and the
            # measurement table is primary-keyed.
            schedule = lpt_order(todo)
            cfg_table = {}
            for t in schedule:
                cfg_table.setdefault(t.cfg.name, t.cfg)
            with _CardPool(
                    _plan_worker_setup, _plan_worker_run,
                    (plan.oracle, plan.hardware, plan.sweep, plan.device,
                     cfg_table, (schedule[0].cfg.name, schedule[0].backend,
                                 schedule[0].payload)),
                    card=prof.device.type == "cuda", workers=workers,
                    task_timeout=task_timeout, max_retries=max_retries,
                    backoff_s=retry_backoff_s) as pool:
                for out in pool.run(
                        [(t.task_id, (t.task_id, t.cfg.name, t.backend,
                                      t.payload))
                         for t in schedule]):
                    retried += out.attempts - 1
                    timed_out += out.n_timeouts
                    task = by_id[out.task_id]
                    if out.ok:
                        _commit(task, out.result)
                    else:
                        _quarantine(task, out.error or "unknown failure")
        elif todo:
            measure = _resolve_measure_fn(prof, measure_fn)
            for task in todo:
                attempts = 0
                while True:
                    attempts += 1
                    try:
                        with card_lock(prof.device):
                            rows = measure(task.payload, task.cfg,
                                           task.backend)
                        rows = validate_rows(rows,
                                             where=f"task {task.task_id}")
                    except Exception as e:      # noqa: BLE001
                        if not _context_ok(prof.device):
                            raise DeviceContextError(
                                task.task_id,
                                f"{type(e).__name__}: {e}") from e
                        if attempts > max_retries:
                            _quarantine(task,
                                        f"{type(e).__name__}: {e}")
                            break
                        retried += 1
                        time.sleep(retry_backoff_s
                                   * (2 ** (attempts - 1)))
                        continue
                    _commit(task, rows)
                    break

        # idempotent tail: every signature (satisfied ones included) and
        # the per-model call-graph counts, one transaction.  Quarantined
        # signatures land here too — without measurements — which is
        # exactly what lets degraded-mode backends see and report them.
        _land_plan_tail(db, plan)
    finally:
        if journal is not None:
            journal.close()

    return ExecuteReport(
        plan_id=plan.plan_id, n_tasks=len(plan.todo), measured=measured,
        skipped_journal=skipped,
        satisfied=sum(t.satisfied for t in plan.tasks),
        rows_written=rows_written, models=len(plan.models),
        elapsed_s=time.perf_counter() - t0, checkpoint=checkpoint,
        workers=workers, retried=retried, timed_out=timed_out,
        quarantined=len(quarantined),
        skipped_quarantined=skipped_quar,
        quarantine=tuple(quarantined))
