"""Shared argparse vocabulary for the ``repro.*`` CLIs.

``python -m repro_torch.profile`` and ``python -m repro_torch.sweep`` grew their flag
sets independently; this module is the single source of truth for the
flags they share, so spellings, defaults, and help text cannot drift:

* ``--db``             — latency DB path (default in-memory);
* ``--hardware``       — hardware name measurements/fits are keyed by
  (default: the card's tag);
* ``--device``         — the device to profile on (``cuda`` unless the
  caller passes ``cpu``; a missing card is an error);
* ``--latency``        — registered latency backend (or an ``a->b``
  chain);
* ``--json``           — machine-readable report path, ``'-'`` for bare
  JSON on stdout (tables and progress chatter stay off it);
* ``--workload-trace`` — a recorded ``dooly-trace`` JSONL file to build
  trace-kind workloads from (repeatable);
* ``--shape``          — a diurnal/spike traffic shape composed onto
  every workload (``repro.workload.shapes.parse_shape`` syntax).

``emit`` implements the ``--json`` convention for any CLI that renders
both a human table and a JSON payload.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional


def add_db_arg(p: argparse.ArgumentParser, *, default: str = ":memory:",
               required: bool = False, help_suffix: str = "") -> None:
    help_text = "latency DB path" + (f" ({help_suffix})" if help_suffix
                                     else "")
    if required:
        p.add_argument("--db", required=True, help=help_text)
    else:
        p.add_argument("--db", default=default, help=help_text)


def add_hardware_arg(p: argparse.ArgumentParser, *,
                     default: Optional[str] = None) -> None:
    p.add_argument("--hardware", default=default,
                   help="hardware name measurements and fits are keyed by")


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device to profile on ('cpu' runs without a "
                        "card; without one, 'cuda' is an error)")


def add_json_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the report to this path ('-' = bare JSON "
                        "on stdout)")


def add_latency_arg(p: argparse.ArgumentParser, *,
                    default: str = "dooly") -> None:
    from repro_torch.api import available_backends
    p.add_argument("--latency", default=default,
                   help="registered latency backend to price scenarios "
                        f"with (one of {', '.join(available_backends())}, "
                        "or an 'a->b' fallback chain such as "
                        "'dooly->roofline')")


def add_workload_trace_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workload-trace", action="append", default=None,
                   metavar="PATH",
                   help="dooly-trace JSONL file to replay as a workload "
                        "(repeatable; content hash is pinned into the "
                        "scenario cache keys)")


def _shape_spec(spec: str) -> str:
    """argparse ``type=`` for ``--shape``: validate eagerly so malformed
    specs fail at the parser with parse_shape's message (naming the
    valid forms) instead of deep inside workload building."""
    if spec:
        from repro_torch.workload import parse_shape
        try:
            parse_shape(spec)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from e
    return spec


def add_shape_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shape", default="", metavar="SPEC",
                   type=_shape_spec,
                   help="traffic shape composed onto every workload: "
                        "'diurnal:period=P,amplitude=A' or "
                        "'spike:at=T,width=W,magnitude=M'")


def json_to_stdout(args: argparse.Namespace) -> bool:
    """True when ``--json -`` promised bare JSON on stdout — the CLI must
    keep tables and progress chatter off it."""
    return getattr(args, "json", None) == "-"


def emit(args: argparse.Namespace, payload: dict, table: str) -> None:
    """The shared ``--json`` convention: ``'-'`` prints the bare payload
    to stdout (no table); a path prints the table and writes the file;
    no ``--json`` prints the table only."""
    if json_to_stdout(args):
        print(json.dumps(payload, indent=2))
    else:
        if table:
            print(table)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2)
            print(f"wrote {args.json}")
