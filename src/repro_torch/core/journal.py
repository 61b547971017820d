"""Crash-safe checkpoint journals for plan execution (format v2).

The v1 journal was a header line plus one bare task id per line,
appended after each task's rows committed.  That protocol has a torn-
tail hazard: a crash (power cut, SIGKILL) mid-append leaves a partial
task id on the last line, and a resume that trusts it skips re-measuring
a task whose rows never landed — silent data loss.

v2 records carry a per-line CRC-32 so a torn or corrupt *final* line is
detected, dropped, and warned about (the task simply re-measures on
resume); a corrupt line anywhere *else* means the file was damaged after
the fact and reading refuses rather than guessing.  v2 also persists
quarantine entries — tasks that exhausted their retries — so a resumed
run skips known-poisoned tasks instead of re-tripping on them.

Format (one record per line, space-separated)::

    # dooly-plan <plan_id> v2
    done <crc32hex> <task_id>
    quar <crc32hex> <task_id> <reason...>

The checksum covers everything after it on the line (``<task_id>`` or
``<task_id> <reason...>``).  v1 journals (bare ids under a ``# dooly-
plan <plan_id>`` header) still read: bare lines are validated against
the plan's known task-id set, which catches a torn v1 tail the same way.
Appends to an existing v1 journal keep its header and simply add v2
records — both record shapes are classified per line.

Durability is a policy knob: ``fsync=True`` (the default for execution)
fsyncs after every record, so "journaled" means "on disk"; callers that
prefer throughput over the last-task guarantee can turn it off and keep
flush-only semantics.

Sharded execution (``repro.core.plan.shard_plan``) gives every shard its
own journal bound to the shard's content-addressed plan id;
:func:`merge_journals` folds those back into one parent journal after
the coordinator merge, refusing sources whose records fall outside the
parent plan's task set.
"""
from __future__ import annotations

import os
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, TextIO

JOURNAL_MAGIC = "# dooly-plan"
JOURNAL_VERSION = 2


def journal_header(plan_id: str, version: int = JOURNAL_VERSION) -> str:
    if version < 2:
        return f"{JOURNAL_MAGIC} {plan_id}"
    return f"{JOURNAL_MAGIC} {plan_id} v{version}"


def _crc(body: str) -> str:
    return f"{zlib.crc32(body.encode()):08x}"


class JournalError(RuntimeError):
    """The journal is unreadable or belongs to a different plan."""


@dataclass
class JournalState:
    """What a checkpoint journal says already happened."""
    done: Set[str] = field(default_factory=set)
    quarantined: Dict[str, str] = field(default_factory=dict)
    dropped_torn: int = 0           # torn/corrupt tail lines dropped
    version: int = JOURNAL_VERSION

    @property
    def empty(self) -> bool:
        return not self.done and not self.quarantined


def _classify(line: str, known_ids: Optional[Set[str]]):
    """Parse one record line -> ("done"|"quar", task_id, reason) or
    raise ValueError for a torn/corrupt line."""
    parts = line.split(" ")
    if parts[0] in ("done", "quar"):
        if len(parts) < 3:
            raise ValueError(f"truncated {parts[0]} record")
        body = " ".join(parts[2:])
        if _crc(body) != parts[1]:
            raise ValueError(f"checksum mismatch on {parts[0]} record")
        task_id = parts[2]
        reason = " ".join(parts[3:]) if parts[0] == "quar" else ""
        return parts[0], task_id, reason
    # v1 record: a bare task id.  Without a checksum the only torn-tail
    # detector is plan membership.
    if len(parts) != 1:
        raise ValueError("unrecognized record")
    if known_ids is not None and line not in known_ids:
        raise ValueError("unknown task id (torn v1 record?)")
    return "done", line, ""


def read_journal_state(path: Optional[str], plan_id: str,
                       known_ids: Optional[Set[str]] = None
                       ) -> JournalState:
    """Read a checkpoint journal, tolerating a torn final record.

    Raises :class:`JournalError` if the journal belongs to a different
    plan or is corrupt anywhere other than its final line.  A bad final
    line — the signature of a crash mid-append — is dropped with a
    warning: the affected task just re-measures on resume.
    """
    state = JournalState()
    if not path or not os.path.exists(path):
        return state
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    lines = [ln.strip() for ln in lines if ln.strip()]
    if not lines:
        return state
    head = lines[0].split(" ")
    if len(head) < 3 or " ".join(head[:2]) != JOURNAL_MAGIC:
        raise JournalError(
            f"checkpoint {path!r} is not a plan journal "
            f"(header {lines[0]!r})")
    if head[2] != plan_id:
        raise JournalError(
            f"checkpoint {path!r} belongs to a different plan "
            f"({lines[0]!r}, expected "
            f"{journal_header(plan_id)!r}); delete it or pass the "
            "matching plan")
    state.version = (int(head[3][1:])
                     if len(head) > 3 and head[3].startswith("v") else 1)
    last = len(lines) - 1
    for i, line in enumerate(lines[1:], start=1):
        try:
            tag, task_id, reason = _classify(line, known_ids)
        except ValueError as e:
            if i == last:
                state.dropped_torn += 1
                warnings.warn(
                    f"checkpoint {path!r}: dropping torn final record "
                    f"{line!r} ({e}); its task will re-measure",
                    RuntimeWarning, stacklevel=2)
                continue
            raise JournalError(
                f"checkpoint {path!r} is corrupt at line {i + 1}: "
                f"{line!r} ({e}); delete it to re-measure from scratch")
        if tag == "quar":
            state.quarantined[task_id] = reason
        else:
            state.done.add(task_id)
    return state


def journal_plan_id(path: str) -> Optional[str]:
    """The plan id a journal's header is bound to, or None for a missing
    or empty file.  Raises :class:`JournalError` when the file exists but
    is not a plan journal."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            head = line.split(" ")
            if len(head) < 3 or " ".join(head[:2]) != JOURNAL_MAGIC:
                raise JournalError(
                    f"{path!r} is not a plan journal (header {line!r})")
            return head[2]
    return None


@dataclass
class JournalMergeReport:
    """What one :func:`merge_journals` call folded in."""
    sources: int = 0
    done_merged: int = 0            # records newly appended
    done_skipped: int = 0           # already present in the target
    quarantined_merged: int = 0
    quarantined_skipped: int = 0
    dropped_torn: int = 0           # torn source tails ignored

    @property
    def done_total(self) -> int:
        return self.done_merged + self.done_skipped

    @property
    def quarantined_total(self) -> int:
        return self.quarantined_merged + self.quarantined_skipped


def merge_journals(target_path: str, plan_id: str, sources,
                   *, known_ids: Optional[Set[str]] = None,
                   fsync: bool = True) -> JournalMergeReport:
    """Fold shard journals into one parent journal bound to ``plan_id``.

    Each source journal is read under its *own* header plan id — shards
    are content-addressed sub-plans with their own ids — but every record
    must name a task in ``known_ids`` (the parent plan's task set);
    otherwise the source is refused as a foreign-plan journal.  The merge
    is idempotent: records already present in the target are skipped, so
    re-running after adding one more shard appends only the new work.
    Records are appended in sorted task-id order per source, making the
    merged file deterministic for a given source set."""
    report = JournalMergeReport()
    target = read_journal_state(target_path, plan_id, known_ids)
    states = []
    for src in sources:
        sid = journal_plan_id(src)
        if sid is None:
            raise JournalError(f"{src!r} is missing or empty; nothing "
                               "to merge")
        st = read_journal_state(src, sid, known_ids)
        if known_ids is not None:
            foreign = (st.done | set(st.quarantined)) - known_ids
            if foreign:
                raise JournalError(
                    f"journal {src!r} (plan {sid}) records "
                    f"{len(foreign)} task(s) outside plan {plan_id} "
                    f"(e.g. {sorted(foreign)[0]!r}); refusing to merge "
                    "a foreign-plan journal")
        states.append(st)
        report.dropped_torn += st.dropped_torn
    report.sources = len(states)
    with PlanJournal(target_path, plan_id, fsync=fsync) as journal:
        for st in states:
            for task_id in sorted(st.done):
                if task_id in target.done:
                    report.done_skipped += 1
                    continue
                journal.record_done(task_id)
                target.done.add(task_id)
                report.done_merged += 1
            for task_id in sorted(st.quarantined):
                if (task_id in target.quarantined
                        or task_id in target.done):
                    report.quarantined_skipped += 1
                    continue
                journal.record_quarantine(task_id,
                                          st.quarantined[task_id])
                target.quarantined[task_id] = st.quarantined[task_id]
                report.quarantined_merged += 1
    return report


class PlanJournal:
    """Append-only journal writer bound to one plan id.

    Use as a context manager; every record is written, flushed, and
    (by default) fsynced before the call returns, so the commit-then-
    journal protocol in ``execute_plan`` guarantees a journaled task's
    rows are durable in the DB *and* its record is durable on disk.
    """

    def __init__(self, path: str, plan_id: str, *, fsync: bool = True):
        self.path = path
        self.plan_id = plan_id
        self.fsync = fsync
        self._fh: Optional[TextIO] = None

    # -- lifecycle ------------------------------------------------------

    def open(self) -> "PlanJournal":
        fresh = True
        if os.path.exists(self.path):
            with open(self.path) as fh:
                fresh = not fh.read().strip()
        self._fh = open(self.path, "a")
        if fresh:
            self._write_line(journal_header(self.plan_id))
        return self

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "PlanJournal":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- records --------------------------------------------------------

    def record_done(self, task_id: str) -> None:
        self._write_line(f"done {_crc(task_id)} {task_id}")

    def record_quarantine(self, task_id: str, reason: str) -> None:
        # reasons are free text from exceptions; keep the record one line
        reason = " ".join(str(reason).split()) or "unknown"
        body = f"{task_id} {reason}"
        self._write_line(f"quar {_crc(body)} {body}")

    def _write_line(self, line: str) -> None:
        if self._fh is None:
            raise RuntimeError("journal is not open")
        self._fh.write(line + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
