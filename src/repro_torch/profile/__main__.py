"""Profiling CLI: build, inspect, and resumably execute ProfilePlans.

    # dry run: corpus-wide coverage report, zero measurements
    PYTHONPATH=src python -m repro_torch.profile plan \
        --models llama3-8b,command-r7b,yi-9b --backends xla,chunked

    # execute (measure) the same plan; journal progress; resume on rerun.
    # N workers on one card share it in turn: each holds the card while it
    # measures a task, so only their start-up and host work overlap
    PYTHONPATH=src python -m repro_torch.profile run \
        --models llama3-8b,command-r7b,yi-9b --backends xla,chunked \
        --db corpus.sqlite --workers 2 --resume

``plan`` prints the coverage table (or JSON with ``--json``): per-model
op counts, tasks already satisfied by the DB, tasks shared between
models, measurement-point accounting, and the estimated GPU-time saved
vs naive per-model profiling.  ``run`` executes; with ``--resume`` (or an
explicit ``--checkpoint``) completed task ids are journaled next to the
DB, so an interrupted corpus sweep picks up where it stopped.

Distributed profiling splits one corpus plan across hosts/processes::

    # each shard measures its slice into a scratch DB + journal
    PYTHONPATH=src python -m repro_torch.profile run --models ... \
        --db shard0.sqlite --resume --shards 4 --shard-index 0

    # the coordinator folds scratch DBs and shard journals back in
    PYTHONPATH=src python -m repro_torch.profile merge --models ... \
        --db corpus.sqlite --resume shard0.sqlite shard0.sqlite.plan-journal ...

``run --shards N --shard-index I`` re-derives the same content-addressed
shard decomposition on every host (sharding depends only on plan
content, never DB state) and executes shard I.  ``merge`` sniffs each
positional source (SQLite scratch DB vs journal), refuses journals whose
records fall outside the plan, reports exact merged/skipped/conflict row
accounting, and is idempotent — re-merging a shard skips its rows.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,
                              add_json_arg, emit, json_to_stdout)
from repro_torch.api import ProfileStore
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.profiler import QUICK_SWEEP, SweepConfig

#: CLI-scale sweep: small enough to demo a corpus plan in seconds
CLI_SWEEP = QUICK_SWEEP


def _sweep(name: str) -> SweepConfig:
    if name == "quick":
        return CLI_SWEEP
    if name == "default":
        return SweepConfig()
    raise KeyError(name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.profile",
        description="Plan-first profiling: dedup a model corpus before "
                    "measuring anything")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, doc in (("plan", "dry-run coverage report (no measurements)"),
                      ("run", "execute the plan (resumable)"),
                      ("merge", "fold shard scratch DBs / journals into "
                                "the target DB")):
        sp = sub.add_parser(name, help=doc)
        sp.add_argument("--models", required=True,
                        help="comma-separated config registry names")
        sp.add_argument("--backends", default="xla")
        sp.add_argument("--tp", type=int, default=1)
        add_hardware_arg(sp)
        sp.add_argument("--oracle", default="cuda_events")
        add_device_arg(sp)
        add_db_arg(sp, help_suffix="dedup runs against it")
        sp.add_argument("--full", action="store_true",
                        help="full-size configs instead of smoke configs")
        sp.add_argument("--sweep", default="quick",
                        choices=("quick", "default"))
        add_json_arg(sp)
        if name in ("run", "merge"):
            sp.add_argument("--checkpoint", default=None,
                            help="journal file for completed task ids")
            sp.add_argument("--resume", action="store_true",
                            help="journal to <db>.plan-journal (implied "
                                 "when --checkpoint is given)")
        if name == "run":
            sp.add_argument("--workers", type=int, default=1)
            sp.add_argument("--task-timeout", type=float, default=None,
                            help="per-task wall-clock limit in seconds; "
                                 "a hung measurement is killed and "
                                 "retried.  On a card it counts from "
                                 "the moment the task takes the card, "
                                 "which the workers hold one at a time: "
                                 "a wait for it of up to 4 x N workers x "
                                 "this "
                                 "is not counted")
            sp.add_argument("--max-retries", type=int, default=2,
                            help="attempts beyond the first before a "
                                 "task is quarantined (default 2)")
            sp.add_argument("--fail-fast", action="store_true",
                            help="abort on the first task that exhausts "
                                 "its retries instead of quarantining "
                                 "it")
            sp.add_argument("--shards", type=int, default=1, metavar="N",
                            help="split the plan into N content-"
                                 "addressed shards and execute only "
                                 "--shard-index (scratch-DB workflow; "
                                 "fold results back with 'merge')")
            sp.add_argument("--shard-index", type=int, default=0,
                            metavar="I",
                            help="which shard to execute (0-based, "
                                 "with --shards)")
        if name == "merge":
            sp.add_argument("sources", nargs="+", metavar="SOURCE",
                            help="shard scratch DBs (SQLite) and/or "
                                 "shard journal files, sniffed by "
                                 "content")
            sp.add_argument("--on-conflict", default="error",
                            choices=("error", "keep", "replace"),
                            help="policy for rows that disagree with "
                                 "the target DB (default: error)")
    audit = sub.add_parser(
        "audit", help="scan a latency DB for poisoned measurement rows")
    add_db_arg(audit, required=True)
    add_hardware_arg(audit, default=None)
    add_json_arg(audit)
    return p


def _build(args) -> tuple:
    models = [m for m in args.models.split(",") if m]
    backends = [b for b in args.backends.split(",") if b]
    get = get_config if args.full else get_smoke_config
    cfgs = [get(m) for m in models]
    store = ProfileStore(args.db, hardware=args.hardware,
                         oracle=args.oracle, sweep=_sweep(args.sweep),
                         device=args.device)
    plan = store.plan(cfgs, backends=backends, tp=args.tp)
    return store, plan


def _audit(args) -> int:
    from repro_torch.core.database import LatencyDB
    with LatencyDB(args.db) as db:
        bad = db.audit_measurements(args.hardware)
    payload = {"db": args.db, "hardware": args.hardware,
               "poisoned_rows": len(bad),
               "rows": [list(r) for r in bad[:50]]}
    if bad:
        table = "\n".join(
            [f"{len(bad)} poisoned measurement rows in {args.db}:"]
            + [f"  {r[0][:12]} {r[2]}@{r[3]}/{r[4]}/{r[5]} "
               f"latency_us={r[7]!r}" for r in bad[:20]])
    else:
        table = f"no poisoned measurement rows in {args.db}"
    emit(args, payload, table)
    return 1 if bad else 0


def _checkpoint_path(args):
    """Resolve --checkpoint/--resume to a journal path; returns
    (path_or_None, error_or_None)."""
    if args.checkpoint is not None:
        return args.checkpoint, None
    if args.resume:
        if args.db == ":memory:":
            return None, "--resume needs an on-disk --db (or --checkpoint)"
        return args.db + ".plan-journal", None
    return None, None


def _merge(args, store, plan) -> int:
    from repro_torch.core.database import MergeConflictError
    from repro_torch.core.journal import JournalError
    checkpoint, err = _checkpoint_path(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    dbs, journals = [], []
    for src in args.sources:
        try:
            with open(src, "rb") as fh:
                head = fh.read(16)
        except OSError as e:
            print(f"cannot read {src!r}: {e}", file=sys.stderr)
            return 2
        (dbs if head.startswith(b"SQLite format 3")
         else journals).append(src)
    try:
        rep = store.merge(plan, dbs=dbs, journals=journals,
                          checkpoint=checkpoint,
                          on_conflict=args.on_conflict)
    except (JournalError, MergeConflictError, ValueError) as e:
        print(f"merge refused: {e}", file=sys.stderr)
        return 2
    summary = (f"plan {rep.plan_id}: merged {rep.rows_merged} rows "
               f"({rep.rows_skipped} already present, {rep.conflicts} "
               f"conflicts) from {rep.n_dbs} scratch DB(s); "
               f"{rep.signatures_merged} new signatures\n"
               f"points: {rep.points_merged} accounted for, "
               f"{rep.points_planned} outstanding before this merge")
    if rep.points_planned and rep.points_merged == rep.points_planned:
        summary += " — exact, all shards merged"
    if rep.n_journals:
        summary += (f"\njournal: {rep.tasks_done} tasks done, "
                    f"{rep.tasks_quarantined} quarantined "
                    f"-> {rep.checkpoint}")
    emit(args, {"plan_id": rep.plan_id, "n_dbs": rep.n_dbs,
                "n_journals": rep.n_journals,
                "rows_merged": rep.rows_merged,
                "rows_skipped": rep.rows_skipped,
                "conflicts": rep.conflicts,
                "signatures_merged": rep.signatures_merged,
                "tasks_done": rep.tasks_done,
                "tasks_quarantined": rep.tasks_quarantined,
                "points_planned": rep.points_planned,
                "points_merged": rep.points_merged,
                "checkpoint": rep.checkpoint}, summary)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "audit":
        return _audit(args)
    store, plan = _build(args)
    with store:
        if args.cmd == "merge":
            return _merge(args, store, plan)
        cov = plan.coverage()
        if args.cmd == "plan":
            emit(args, {"plan_id": plan.plan_id, **cov.to_json()},
                  cov.table() + f"\nplan {plan.plan_id}: "
                  f"{cov.plan_tasks} tasks to measure")
            return 0

        shard_note = None
        if args.shards > 1:
            parent_id = plan.plan_id
            shards = store.shard(plan, args.shards)
            if not 0 <= args.shard_index < len(shards):
                print(f"--shard-index {args.shard_index} out of range "
                      f"(plan {parent_id} sharded into {len(shards)})",
                      file=sys.stderr)
                return 2
            plan = shards[args.shard_index]
            cov = plan.coverage()
            shard_note = (f"shard {args.shard_index}/{len(shards)} of "
                          f"plan {parent_id}: {len(plan.tasks)} tasks "
                          f"({cov.plan_points} points) -> shard plan "
                          f"{plan.plan_id}")

        checkpoint, err = _checkpoint_path(args)
        if err:
            print(err, file=sys.stderr)
            return 2

        def progress(task, i, n):
            print(f"  [{i:4d}/{n}] measured {task.kind:6s} "
                  f"{task.sig_hash[:12]}  ({task.n_points} points, "
                  f"owners: {', '.join(task.owners)})")

        # --json '-' promises bare JSON on stdout for both subcommands:
        # keep the table and progress chatter off it
        to_stdout = json_to_stdout(args)
        if not to_stdout:
            print(shard_note if shard_note else cov.table())
        rep = store.execute(plan, workers=args.workers,
                            checkpoint=checkpoint,
                            progress=None if to_stdout else progress,
                            task_timeout=args.task_timeout,
                            max_retries=args.max_retries,
                            fail_fast=args.fail_fast)
        summary = (f"plan {rep.plan_id}: measured {rep.measured}, "
                   f"resumed past {rep.skipped_journal}, "
                   f"{rep.satisfied} already satisfied; "
                   f"{rep.rows_written} rows in {rep.elapsed_s:.2f}s")
        if rep.retried or rep.timed_out:
            summary += (f"\nsupervision: {rep.retried} retries, "
                        f"{rep.timed_out} timeouts")
        if rep.quarantined or rep.skipped_quarantined:
            summary += (f"\nquarantined: {rep.quarantined} new, "
                        f"{rep.skipped_quarantined} skipped from the "
                        "journal")
            for task_id, reason in rep.quarantine:
                summary += f"\n  {task_id}: {reason}"
        if shard_note and not to_stdout:
            summary = shard_note + "\n" + summary
        emit(args, {"plan_id": rep.plan_id, "shards": args.shards,
                     "shard_index": args.shard_index,
                     "measured": rep.measured,
                     "skipped_journal": rep.skipped_journal,
                     "satisfied": rep.satisfied,
                     "rows_written": rep.rows_written,
                     "elapsed_s": rep.elapsed_s,
                     "workers": rep.workers,
                     "checkpoint": rep.checkpoint,
                     "retried": rep.retried,
                     "timed_out": rep.timed_out,
                     "quarantined": rep.quarantined,
                     "skipped_quarantined": rep.skipped_quarantined,
                     "quarantine": [list(q) for q in rep.quarantine],
                     "coverage": cov.to_json()}, summary)
        return 1 if rep.quarantined else 0


if __name__ == "__main__":
    sys.exit(main())
