"""Latency database (paper App. E): SQLite, keyed by signature hash and
workload configuration.  Deduplication is a primary-key lookup.

Three orthogonal axes: profiled configurations (hardware x model x backend x
tp), unique signatures, and workload-dependent measurements.  Communication
ops live in a separate sub-schema keyed by (topology, tp_degree) — their
latency does not depend on model architecture.

Write model: the connection runs in autocommit (``isolation_level=None``)
with WAL journaling, so single-row writers remain safe, while hot paths
batch through ``transaction()`` + the ``*_bulk`` ``executemany`` APIs —
one fsync per profiled model instead of one per measurement row.

Read model: point lookups ride the measurements primary key
(sig_hash, hardware, phase, num_toks, num_reqs, ctx_len, ...), and
``measurement_map``/``lookup_measurement`` keep a read-through in-memory
cache per (sig_hash, hardware) so replay never re-fetches or linearly
scans the measurement list.  Writes invalidate the affected cache entries.

The ``fits`` table makes the *fitted* latency model a persisted artifact:
ridge coefficient vectors (float64 blobs) keyed by (sig_hash, hardware,
phase), bulk-saved/loaded so a warm-started simulator skips refitting
entirely.  Measurement writes delete the fits they invalidate, keeping the
two tables consistent; a ``meta`` schema-version row guards against opening
a database written by a newer schema.
"""
from __future__ import annotations

import sqlite3
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple)

from repro_torch.core.signature import Signature


class MergeConflictError(RuntimeError):
    """Two databases disagree on a measurement's latency."""


@dataclass(frozen=True)
class DBMergeReport:
    """Exact row accounting for one :meth:`LatencyDB.merge_from` call."""
    rows_merged: int                # measurement rows newly inserted
    rows_skipped: int               # identical rows already present
    conflicts: int                  # same key, different latency
    signatures_merged: int          # signature rows newly inserted

_SCHEMA = """
CREATE TABLE IF NOT EXISTS configurations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    model TEXT NOT NULL, backend TEXT NOT NULL,
    hardware TEXT NOT NULL, tp INTEGER NOT NULL DEFAULT 1,
    UNIQUE(model, backend, hardware, tp));
CREATE TABLE IF NOT EXISTS signatures (
    hash TEXT PRIMARY KEY, op_name TEXT, spec TEXT,
    fingerprint TEXT, attrs TEXT);
CREATE TABLE IF NOT EXISTS model_operations (
    config_id INTEGER NOT NULL, sig_hash TEXT NOT NULL,
    module TEXT NOT NULL, count INTEGER NOT NULL,
    PRIMARY KEY(config_id, sig_hash, module));
CREATE TABLE IF NOT EXISTS measurements (
    sig_hash TEXT NOT NULL, hardware TEXT NOT NULL,
    phase TEXT NOT NULL, num_toks INTEGER NOT NULL,
    num_reqs INTEGER NOT NULL, ctx_len INTEGER NOT NULL,
    oracle TEXT NOT NULL, latency_us REAL NOT NULL,
    PRIMARY KEY(sig_hash, hardware, phase, num_toks, num_reqs,
                ctx_len, oracle));
CREATE INDEX IF NOT EXISTS idx_measurements_hw ON measurements(hardware);
CREATE TABLE IF NOT EXISTS comm_ops (
    topology TEXT NOT NULL, tp_degree INTEGER NOT NULL,
    op TEXT NOT NULL, bytes INTEGER NOT NULL, latency_us REAL NOT NULL,
    PRIMARY KEY(topology, tp_degree, op, bytes));
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY, value TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS fits (
    sig_hash TEXT NOT NULL, hardware TEXT NOT NULL, phase TEXT NOT NULL,
    n_features INTEGER NOT NULL, coef BLOB NOT NULL, floor REAL NOT NULL,
    n_points INTEGER NOT NULL,
    PRIMARY KEY(sig_hash, hardware, phase));
"""

SCHEMA_VERSION = 2

# (phase, num_toks, num_reqs, ctx_len) -> latency_us
MeasKey = Tuple[str, int, int, int]

# (sig_hash, hardware, phase, n_features, coef_blob, floor, n_points)
FitRow = Tuple[str, str, str, int, bytes, float, int]


class LatencyDB:
    def __init__(self, path: str = ":memory:", *, wal: bool = True):
        # autocommit + explicit BEGIN/COMMIT in transaction(): sqlite3's
        # implicit transaction handling would otherwise fight executescript
        self.conn = sqlite3.connect(path, isolation_level=None)
        if wal:
            self.conn.execute("PRAGMA journal_mode=WAL")
            self.conn.execute("PRAGMA synchronous=NORMAL")
        self.conn.executescript(_SCHEMA)
        self._check_schema_version()
        self._txn_depth = 0
        self._meas_cache: Dict[Tuple[str, str], Dict[MeasKey, float]] = {}
        # bumped on every measurement write; readers (LatencyModel) use it
        # to invalidate their bulk-loaded snapshots
        self.measurement_generation = 0
        # bumped on every fits-table write/delete, same contract
        self.fit_generation = 0

    def _check_schema_version(self):
        row = self.conn.execute(
            "SELECT value FROM meta WHERE key='schema_version'").fetchone()
        if row is not None and int(row[0]) > SCHEMA_VERSION:
            raise RuntimeError(
                f"latency DB schema v{row[0]} is newer than this code "
                f"(v{SCHEMA_VERSION})")
        if row is None or int(row[0]) != SCHEMA_VERSION:
            self.conn.execute(
                "INSERT OR REPLACE INTO meta VALUES('schema_version', ?)",
                (str(SCHEMA_VERSION),))

    def schema_version(self) -> int:
        return int(self.conn.execute(
            "SELECT value FROM meta WHERE key='schema_version'"
        ).fetchone()[0])

    # -- lifecycle ------------------------------------------------------------

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self._meas_cache.clear()

    def __enter__(self) -> "LatencyDB":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    @contextmanager
    def transaction(self):
        """Explicit transaction scope; reentrant (inner scopes join the
        outermost one).  All bulk writes inside commit with one fsync."""
        if self._txn_depth == 0:
            self.conn.execute("BEGIN")
        self._txn_depth += 1
        try:
            yield self
        except BaseException:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                self.conn.execute("ROLLBACK")
                # drop any cache entries warmed from now-rolled-back rows
                self._meas_cache.clear()
                self.measurement_generation += 1
                self.fit_generation += 1
            raise
        else:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                self.conn.execute("COMMIT")

    # -- configurations -----------------------------------------------------

    def config_id(self, model: str, backend: str, hardware: str,
                  tp: int = 1) -> int:
        self.conn.execute(
            "INSERT OR IGNORE INTO configurations(model,backend,hardware,tp)"
            " VALUES(?,?,?,?)", (model, backend, hardware, tp))
        row = self.conn.execute(
            "SELECT id FROM configurations WHERE model=? AND backend=? AND "
            "hardware=? AND tp=?", (model, backend, hardware, tp)).fetchone()
        return row[0]

    # -- signatures ----------------------------------------------------------

    def has_signature(self, sig_hash: str, hardware: str) -> bool:
        """Dedup check: do measurements already exist for this signature on
        this hardware? (primary-key lookup, §6)."""
        cached = self._meas_cache.get((sig_hash, hardware))
        if cached:
            return True
        row = self.conn.execute(
            "SELECT 1 FROM measurements WHERE sig_hash=? AND hardware=? "
            "LIMIT 1", (sig_hash, hardware)).fetchone()
        return row is not None

    def insert_signature(self, sig: Signature):
        self.conn.execute(
            "INSERT OR IGNORE INTO signatures VALUES(?,?,?,?,?)",
            (sig.hash, sig.op_name, sig.spec, sig.fingerprint, sig.attrs))

    def insert_signatures_bulk(self, sigs: Iterable[Signature]):
        self.conn.executemany(
            "INSERT OR IGNORE INTO signatures VALUES(?,?,?,?,?)",
            [(s.hash, s.op_name, s.spec, s.fingerprint, s.attrs)
             for s in sigs])

    def add_model_operation(self, config_id: int, sig_hash: str,
                            module: str, count: int):
        self.conn.execute(
            "INSERT OR REPLACE INTO model_operations VALUES(?,?,?,?)",
            (config_id, sig_hash, module, count))

    def add_model_operations_bulk(
            self, rows: Iterable[Tuple[int, str, str, int]]):
        """rows: (config_id, sig_hash, module, count)."""
        self.conn.executemany(
            "INSERT OR REPLACE INTO model_operations VALUES(?,?,?,?)",
            list(rows))

    # -- measurements ---------------------------------------------------------

    def add_measurement(self, sig_hash: str, hardware: str, phase: str,
                        num_toks: int, num_reqs: int, ctx_len: int,
                        oracle: str, latency_us: float):
        self.conn.execute(
            "INSERT OR REPLACE INTO measurements VALUES(?,?,?,?,?,?,?,?)",
            (sig_hash, hardware, phase, num_toks, num_reqs, ctx_len,
             oracle, latency_us))
        self._meas_cache.pop((sig_hash, hardware), None)
        self.measurement_generation += 1
        self._invalidate_fits([(sig_hash, hardware)])

    def add_measurements_bulk(self, rows: Sequence[Tuple]):
        """rows: (sig_hash, hardware, phase, num_toks, num_reqs, ctx_len,
        oracle, latency_us) tuples, written with one executemany."""
        rows = list(rows)
        self.conn.executemany(
            "INSERT OR REPLACE INTO measurements VALUES(?,?,?,?,?,?,?,?)",
            rows)
        for r in rows:
            self._meas_cache.pop((r[0], r[1]), None)
        self.measurement_generation += 1
        self._invalidate_fits({(r[0], r[1]) for r in rows})

    def measurements(self, sig_hash: str, hardware: Optional[str] = None,
                     phase: Optional[str] = None) -> List[Tuple]:
        q = ("SELECT phase,num_toks,num_reqs,ctx_len,latency_us FROM "
             "measurements WHERE sig_hash=?")
        args: List[Any] = [sig_hash]
        if hardware:
            q += " AND hardware=?"
            args.append(hardware)
        if phase:
            q += " AND phase=?"
            args.append(phase)
        return self.conn.execute(q, args).fetchall()

    def measurements_for_hardware(
            self, hardware: str) -> List[Tuple[str, str, int, int, int,
                                               float]]:
        """All (sig_hash, phase, num_toks, num_reqs, ctx_len, latency_us)
        rows for one hardware in a single query — the latency model's
        bulk-load path."""
        return self.conn.execute(
            "SELECT sig_hash,phase,num_toks,num_reqs,ctx_len,latency_us "
            "FROM measurements WHERE hardware=?", (hardware,)).fetchall()

    def measured_hashes(self, hardware: str) -> List[str]:
        """Distinct signature hashes with measurements on one hardware —
        the dedup set handed to parallel sweep workers."""
        return [r[0] for r in self.conn.execute(
            "SELECT DISTINCT sig_hash FROM measurements WHERE hardware=?",
            (hardware,)).fetchall()]

    def measurement_map(self, sig_hash: str,
                        hardware: str) -> Dict[MeasKey, float]:
        """Read-through cached {(phase, toks, reqs, ctx): latency_us} for one
        (signature, hardware).  One fetch, then O(1) point lookups."""
        key = (sig_hash, hardware)
        cached = self._meas_cache.get(key)
        if cached is None:
            cached = {(p, t, r, c): lat
                      for p, t, r, c, lat in self.measurements(
                          sig_hash, hardware)}
            self._meas_cache[key] = cached
        return cached

    def lookup_measurement(self, sig_hash: str, hardware: str, phase: str,
                           num_toks: int, num_reqs: int,
                           ctx_len: int) -> Optional[float]:
        """Point lookup (latency_us), index-backed on a cold cache and
        dict-backed after."""
        return self.measurement_map(sig_hash, hardware).get(
            (phase, num_toks, num_reqs, ctx_len))

    def merge_from(self, other: "LatencyDB", *,
                   hardware: Optional[str] = None,
                   on_conflict: str = "error") -> DBMergeReport:
        """Fold another latency DB's measurements and signatures into
        this one with exact accounting — the coordinator half of sharded
        profiling (each shard measures into a scratch DB; the canonical
        DB merges them all).

        Every source measurement row is classified: **merged** (key not
        present here — inserted), **skipped** (present with a bitwise-
        identical latency — untouched, which makes re-merging the same
        shard a no-op), or a **conflict** (present with a different
        latency).  Conflicts ``"error"`` (default) raise
        :class:`MergeConflictError`; ``"keep"`` preserves this DB's row;
        ``"replace"`` takes the source's.  ``hardware`` restricts the
        copy to one hardware's rows.  Fits and comm rows are not merged:
        fits are derived artifacts (and measurement inserts invalidate
        the affected ones here), comm rows are not produced by plan
        execution."""
        if on_conflict not in ("error", "keep", "replace"):
            raise ValueError(f"on_conflict must be 'error', 'keep', or "
                             f"'replace', got {on_conflict!r}")
        q = ("SELECT sig_hash,hardware,phase,num_toks,num_reqs,ctx_len,"
             "oracle,latency_us FROM measurements")
        args: Tuple = ()
        if hardware is not None:
            q += " WHERE hardware=?"
            args = (hardware,)
        src_rows = other.conn.execute(
            q + " ORDER BY sig_hash,hardware,phase,num_toks,num_reqs,"
                "ctx_len,oracle", args).fetchall()

        # existing rows for the affected (sig, hardware) pairs only —
        # keyed on the full measurement primary key (incl. oracle)
        existing: Dict[Tuple, float] = {}
        for sig, hw in {(r[0], r[1]) for r in src_rows}:
            for row in self.conn.execute(
                    "SELECT phase,num_toks,num_reqs,ctx_len,oracle,"
                    "latency_us FROM measurements WHERE sig_hash=? AND "
                    "hardware=?", (sig, hw)):
                existing[(sig, hw) + tuple(row[:5])] = row[5]

        new: List[Tuple] = []
        skipped = conflicts = 0
        for row in src_rows:
            have = existing.get(tuple(row[:7]))
            if have is None:
                new.append(row)
            elif have == row[7]:
                skipped += 1
            else:
                conflicts += 1
                if on_conflict == "error":
                    raise MergeConflictError(
                        f"measurement {row[:7]} is {have!r} here but "
                        f"{row[7]!r} in the source; pass "
                        "on_conflict='keep' or 'replace' to resolve")
                if on_conflict == "replace":
                    new.append(row)

        src_sigs = other.conn.execute(
            "SELECT hash,op_name,spec,fingerprint,attrs FROM signatures"
            " ORDER BY hash").fetchall()
        before = self.conn.total_changes
        with self.transaction():
            if new:
                self.add_measurements_bulk(new)
            changes_after_meas = self.conn.total_changes
            self.conn.executemany(
                "INSERT OR IGNORE INTO signatures VALUES(?,?,?,?,?)",
                src_sigs)
            sigs_merged = self.conn.total_changes - changes_after_meas
        assert self.conn.total_changes - before >= len(new)
        return DBMergeReport(
            rows_merged=len(new) - (conflicts
                                    if on_conflict == "replace" else 0),
            rows_skipped=skipped, conflicts=conflicts,
            signatures_merged=sigs_merged)

    def model_operations(self, config_id: int) -> List[Tuple[str, str, int]]:
        return self.conn.execute(
            "SELECT sig_hash, module, count FROM model_operations WHERE "
            "config_id=?", (config_id,)).fetchall()

    def signature(self, sig_hash: str) -> Optional[Tuple]:
        return self.conn.execute(
            "SELECT op_name, spec, fingerprint, attrs FROM signatures "
            "WHERE hash=?", (sig_hash,)).fetchone()

    # -- persisted fits -------------------------------------------------------

    def _invalidate_fits(self, pairs: Iterable[Tuple[str, str]]):
        """New measurements make stored coefficients stale — drop them."""
        pairs = list(pairs)
        if not pairs:
            return
        self.conn.executemany(
            "DELETE FROM fits WHERE sig_hash=? AND hardware=?", pairs)
        self.fit_generation += 1

    def save_fits_bulk(self, rows: Sequence[FitRow]):
        """rows: (sig_hash, hardware, phase, n_features, coef_blob, floor,
        n_points) tuples — one executemany, like the measurement bulk path."""
        rows = list(rows)
        if not rows:
            return
        self.conn.executemany(
            "INSERT OR REPLACE INTO fits VALUES(?,?,?,?,?,?,?)", rows)
        self.fit_generation += 1

    def load_fits(self, hardware: str) -> List[Tuple[str, str, int, bytes,
                                                     float, int]]:
        """All (sig_hash, phase, n_features, coef_blob, floor, n_points)
        fits for one hardware in a single query — the warm-start path."""
        return self.conn.execute(
            "SELECT sig_hash,phase,n_features,coef,floor,n_points "
            "FROM fits WHERE hardware=?", (hardware,)).fetchall()

    def clear_fits(self, hardware: Optional[str] = None):
        if hardware is None:
            self.conn.execute("DELETE FROM fits")
        else:
            self.conn.execute("DELETE FROM fits WHERE hardware=?",
                              (hardware,))
        self.fit_generation += 1

    # -- communication sub-schema ---------------------------------------------

    def add_comm(self, topology: str, tp_degree: int, op: str, nbytes: int,
                 latency_us: float):
        self.conn.execute(
            "INSERT OR REPLACE INTO comm_ops VALUES(?,?,?,?,?)",
            (topology, tp_degree, op, nbytes, latency_us))

    def record_comm_bulk(self, rows: Sequence[Tuple[str, int, str, int,
                                                    float]]):
        """rows: (topology, tp_degree, op, bytes, latency_us) tuples,
        written with one executemany — the comm analogue of
        ``add_measurements_bulk`` (previously comm writes were per-row)."""
        self.conn.executemany(
            "INSERT OR REPLACE INTO comm_ops VALUES(?,?,?,?,?)", list(rows))

    def comm_latency(self, topology: str, tp_degree: int, op: str,
                     nbytes: int) -> Optional[float]:
        row = self.conn.execute(
            "SELECT latency_us FROM comm_ops WHERE topology=? AND "
            "tp_degree=? AND op=? AND bytes=?",
            (topology, tp_degree, op, nbytes)).fetchone()
        return row[0] if row else None

    def stats(self) -> Dict[str, int]:
        out = {}
        for table in ("configurations", "signatures", "model_operations",
                      "measurements", "comm_ops", "fits"):
            out[table] = self.conn.execute(
                f"SELECT COUNT(*) FROM {table}").fetchone()[0]
        return out

    def audit_measurements(self, hardware: Optional[str] = None
                           ) -> List[Tuple]:
        """Rows whose latency could not have come from a healthy
        measurement: NULL (sqlite stores NaN as NULL, which the NOT NULL
        constraint normally rejects, but older DBs may predate it),
        non-positive, or infinite.  Returns full measurement rows so the
        caller can show — or delete — exactly what is poisoned."""
        where = ("latency_us IS NULL OR latency_us <= 0 "
                 "OR latency_us >= 1e308 OR latency_us != latency_us")
        q = f"SELECT * FROM measurements WHERE ({where})"
        args: Tuple = ()
        if hardware is not None:
            q += " AND hardware=?"
            args = (hardware,)
        return self.conn.execute(
            q + " ORDER BY sig_hash, phase, num_toks, num_reqs, ctx_len",
            args).fetchall()
