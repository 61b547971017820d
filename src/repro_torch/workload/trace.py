"""Serving-trace ingestion: a versioned JSONL format + transforms.

Format (``dooly-trace`` v1): one JSON object per line.  The first line is
the header ``{"format": "dooly-trace", "version": 1}``; every following
line is a row with

* ``arrival``        — seconds since trace start (finite, >= 0);
* ``prompt_tokens``  — total prompt length of the request (>= 1).  For a
  session turn this is the *whole* context: shared prefix + new turn;
* ``output_tokens``  — generation budget (>= 1);
* ``session``        — optional session id (string or int); rows sharing
  it form one multi-turn conversation, in file order.

Schema errors are strict: :class:`TraceError` names the line number and
the offending value — a malformed trace never half-loads.  Within a
session, arrivals must be nondecreasing and every turn's
``prompt_tokens`` must exceed the previous turn's
``prompt_tokens + output_tokens`` (the context the turn extends), which
is what lets :func:`repro.workload.sessions.to_requests` expand turns
into prefix-sharing requests.

``save_trace`` writes rows in a canonical serialization (sorted keys,
compact separators, repr-roundtripping floats), and :func:`trace_key`
hashes exactly those bytes — so a save -> load round-trip is
bit-identical and the key is a *content* identity usable in sweep cache
keys (``WorkloadSpec.for_trace`` pins it so a changed file can never
alias a stale memo entry).

Transforms (all pure, all preserving lengths so scenarios built from one
trace share common random numbers):

* :func:`time_warp` — scale offered load by ``factor`` (arrivals divide
  by it; ``factor=math.inf`` collapses to a burst at t=0);
* :func:`resample_trace` — seeded bootstrap of whole sessions;
* :func:`truncate_trace` — first-n rows / time-horizon cut.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

TRACE_FORMAT = "dooly-trace"
TRACE_VERSION = 1

_ROW_KEYS = {"arrival", "prompt_tokens", "output_tokens", "session"}


class TraceError(ValueError):
    """A trace violated the dooly-trace schema; message names the line."""


@dataclass(frozen=True)
class TraceRow:
    """One request of a serving trace (one turn, when ``session`` set)."""
    arrival: float
    prompt_tokens: int
    output_tokens: int
    session: Optional[str] = None

    def to_json(self) -> Dict:
        out: Dict = {"arrival": self.arrival,
                     "prompt_tokens": self.prompt_tokens,
                     "output_tokens": self.output_tokens}
        if self.session is not None:
            out["session"] = self.session
        return out


def _row_error(where: str, msg: str) -> TraceError:
    return TraceError(f"{where}: {msg}")


def _parse_row(obj: Dict, where: str) -> TraceRow:
    if not isinstance(obj, dict):
        raise _row_error(where, f"expected a JSON object, got "
                                f"{type(obj).__name__}")
    unknown = set(obj) - _ROW_KEYS
    if unknown:
        raise _row_error(where, f"unknown key(s) {sorted(unknown)}; "
                                f"expected {sorted(_ROW_KEYS)}")
    missing = {"arrival", "prompt_tokens", "output_tokens"} - set(obj)
    if missing:
        raise _row_error(where, f"missing required key(s) "
                                f"{sorted(missing)}")
    arrival = obj["arrival"]
    if isinstance(arrival, bool) or not isinstance(arrival, (int, float)):
        raise _row_error(where, f"arrival must be a number, got "
                                f"{arrival!r}")
    arrival = float(arrival)
    if not math.isfinite(arrival) or arrival < 0:
        raise _row_error(where, f"arrival must be finite and >= 0, got "
                                f"{arrival!r}")
    counts = {}
    for key in ("prompt_tokens", "output_tokens"):
        v = obj[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise _row_error(where, f"{key} must be an integer, got "
                                    f"{v!r}")
        if v < 1:
            raise _row_error(where, f"{key} must be >= 1, got {v}")
        counts[key] = v
    session = obj.get("session")
    if session is not None:
        if isinstance(session, bool) or \
                not isinstance(session, (str, int)):
            raise _row_error(where, f"session must be a string or int, "
                                    f"got {session!r}")
        session = str(session)
    return TraceRow(arrival=arrival, prompt_tokens=counts["prompt_tokens"],
                    output_tokens=counts["output_tokens"], session=session)


def validate_trace(rows: Sequence[TraceRow]) -> None:
    """Strict semantic validation (per-row schema is enforced on parse):
    within each session arrivals are nondecreasing and each turn's prompt
    strictly extends the previous turn's context."""
    last: Dict[str, TraceRow] = {}
    turn: Dict[str, int] = {}
    for i, r in enumerate(rows):
        if not isinstance(r, TraceRow):
            raise _row_error(f"row {i}", f"expected a TraceRow, got "
                                         f"{type(r).__name__}")
        # re-check ranges so programmatically-built rows get the same
        # guarantees as parsed ones
        _parse_row(r.to_json(), f"row {i}")
        if r.session is None:
            continue
        prev = last.get(r.session)
        if prev is not None:
            k = turn[r.session]
            if r.arrival < prev.arrival:
                raise _row_error(
                    f"row {i}", f"session {r.session!r} turn {k + 1} "
                    f"arrives at {r.arrival} before turn {k} "
                    f"({prev.arrival})")
            context = prev.prompt_tokens + prev.output_tokens
            if r.prompt_tokens <= context:
                raise _row_error(
                    f"row {i}", f"session {r.session!r} turn {k + 1} "
                    f"prompt_tokens={r.prompt_tokens} must exceed the "
                    f"previous turn's context "
                    f"({prev.prompt_tokens} prompt + "
                    f"{prev.output_tokens} output = {context})")
        last[r.session] = r
        turn[r.session] = turn.get(r.session, 0) + 1


def _canonical_lines(rows: Sequence[TraceRow]) -> List[str]:
    header = {"format": TRACE_FORMAT, "version": TRACE_VERSION}
    dump = lambda obj: json.dumps(obj, sort_keys=True,
                                  separators=(",", ":"))
    return [dump(header)] + [dump(r.to_json()) for r in rows]


def trace_key(rows: Sequence[TraceRow]) -> str:
    """Content hash of the canonical serialization (the exact bytes
    ``save_trace`` writes) — the identity sweeps key caches on."""
    h = hashlib.sha256()
    for line in _canonical_lines(rows):
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def save_trace(path: Union[str, os.PathLike],
               rows: Sequence[TraceRow]) -> str:
    """Validate + write ``rows`` canonically; returns their
    :func:`trace_key`."""
    validate_trace(rows)
    with open(path, "w") as f:
        for line in _canonical_lines(rows):
            f.write(line + "\n")
    return trace_key(rows)


def load_trace(path: Union[str, os.PathLike]) -> List[TraceRow]:
    """Parse + validate a dooly-trace file; any violation raises
    :class:`TraceError` naming ``path`` and the line."""
    rows: List[TraceRow] = []
    with open(path) as f:
        lines = f.read().splitlines()
    body = [(i, line) for i, line in enumerate(lines, 1) if line.strip()]
    if not body:
        raise TraceError(f"{path}: empty file (expected a "
                         f"{TRACE_FORMAT} header line)")
    head_no, head_line = body[0]
    try:
        header = json.loads(head_line)
    except json.JSONDecodeError as e:
        raise TraceError(f"{path}:{head_no}: invalid JSON header: {e}")
    if not isinstance(header, dict) \
            or header.get("format") != TRACE_FORMAT:
        raise TraceError(
            f"{path}:{head_no}: missing {TRACE_FORMAT} header; expected "
            f'{{"format": "{TRACE_FORMAT}", "version": {TRACE_VERSION}}}')
    version = header.get("version")
    if version != TRACE_VERSION:
        raise TraceError(f"{path}:{head_no}: unsupported trace version "
                         f"{version!r} (this code reads v{TRACE_VERSION})")
    for lineno, line in body[1:]:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceError(f"{path}:{lineno}: invalid JSON: {e}")
        rows.append(_parse_row(obj, f"{path}:{lineno}"))
    validate_trace(rows)
    return rows


# -- transforms ---------------------------------------------------------


def time_warp(rows: Sequence[TraceRow], factor: float) -> List[TraceRow]:
    """Scale offered load by ``factor`` (> 0): arrivals divide by it, so
    ``factor=2`` doubles the request rate and ``factor=math.inf``
    collapses the trace to a burst at t=0.  Lengths are untouched —
    every warp of one trace shares common random numbers."""
    if not (factor > 0):
        raise ValueError(f"time_warp factor must be > 0, got {factor!r}")
    if math.isinf(factor):
        return [TraceRow(arrival=0.0, prompt_tokens=r.prompt_tokens,
                         output_tokens=r.output_tokens, session=r.session)
                for r in rows]
    return [TraceRow(arrival=r.arrival / factor,
                     prompt_tokens=r.prompt_tokens,
                     output_tokens=r.output_tokens, session=r.session)
            for r in rows]


def _session_groups(rows: Sequence[TraceRow]) -> List[List[TraceRow]]:
    """Rows grouped into sessions (file order preserved); a sessionless
    row is its own single-turn group."""
    groups: List[List[TraceRow]] = []
    by_session: Dict[str, List[TraceRow]] = {}
    for r in rows:
        if r.session is None:
            groups.append([r])
        else:
            g = by_session.get(r.session)
            if g is None:
                g = by_session[r.session] = []
                groups.append(g)
            g.append(r)
    return groups


def resample_trace(rows: Sequence[TraceRow], n: int, *,
                   seed: int = 0) -> List[TraceRow]:
    """Seeded bootstrap: draw ``n`` whole sessions (a sessionless row
    counts as a single-turn session) uniformly with replacement, keeping
    each draw's arrivals and intra-session structure.  Draws are
    relabeled ``"<draw>/<original>"`` so a session sampled twice stays
    two distinct conversations.  Result is ordered by first arrival."""
    if n < 1:
        raise ValueError(f"resample_trace needs n >= 1, got {n}")
    groups = _session_groups(rows)
    if not groups:
        raise ValueError("cannot resample an empty trace")
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, len(groups), n)
    picked = sorted(((groups[g][0].arrival, i, int(g))
                     for i, g in enumerate(draws)))
    out: List[TraceRow] = []
    for _, i, g in picked:
        for r in groups[g]:
            session = None if r.session is None and len(groups[g]) == 1 \
                else f"{i}/{r.session}"
            out.append(TraceRow(arrival=r.arrival,
                                prompt_tokens=r.prompt_tokens,
                                output_tokens=r.output_tokens,
                                session=session))
    return out


def truncate_trace(rows: Sequence[TraceRow],
                   max_rows: Optional[int] = None, *,
                   max_time: Optional[float] = None) -> List[TraceRow]:
    """Keep the first ``max_rows`` rows (file order) and/or drop rows
    arriving after ``max_time``.  Sessions whose early turns survive the
    cut keep them — a truncated conversation is still a valid prefix."""
    out = list(rows)
    if max_time is not None:
        out = [r for r in out if r.arrival <= max_time]
    if max_rows is not None:
        if max_rows < 0:
            raise ValueError(f"max_rows must be >= 0, got {max_rows}")
        out = out[:max_rows]
    return out
