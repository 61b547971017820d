"""``repro.workload`` — workload construction for the simulator/sweeps.

Three pillars (plus the synthetic generators the package grew from):

* **trace ingestion** (:mod:`repro.workload.trace`) — the versioned
  ``dooly-trace`` JSONL format: ``load_trace`` / ``save_trace`` /
  ``validate_trace`` with strict schema errors, content-hash
  ``trace_key`` for sweep dedup, and ``time_warp`` / ``resample_trace``
  / ``truncate_trace`` transforms so one public trace drives many
  offered-load scenarios with common random numbers;
* **multi-turn sessions** (:mod:`repro.workload.sessions`) —
  ``to_requests`` expands session-grouped rows into per-turn requests
  whose prompts literally share prefixes (``Request.cached_prefix``
  feeds the scheduler's prefix-cache model), plus the
  ``synthetic_sessions`` file-less generator;
* **traffic shapes** (:mod:`repro.workload.shapes`) — diurnal/spike
  relative-intensity specs, drawn by seeded thinning over generators
  (``shaped_arrivals``) and composed onto traces by deterministic
  time-change (``warp_times``).

``repro.sim.workload`` remains as a *deprecated* import shim for the
original two generators (warns on import; removal slated for 0.5).
"""
from repro_torch.workload.generators import sharegpt_like, synthetic
from repro_torch.workload.sessions import (synthetic_session_rows,
                                     synthetic_sessions, to_requests)
from repro_torch.workload.shapes import (SHAPE_KINDS, ShapeSpec, parse_shape,
                                   shaped_arrivals, warp_times)
from repro_torch.workload.trace import (TRACE_FORMAT, TRACE_VERSION, TraceError,
                                  TraceRow, load_trace, resample_trace,
                                  save_trace, time_warp, trace_key,
                                  truncate_trace, validate_trace)

__all__ = [
    # generators
    "sharegpt_like", "synthetic",
    # trace ingestion
    "TRACE_FORMAT", "TRACE_VERSION", "TraceError", "TraceRow",
    "load_trace", "save_trace", "validate_trace", "trace_key",
    "time_warp", "resample_trace", "truncate_trace",
    # sessions
    "to_requests", "synthetic_sessions", "synthetic_session_rows",
    # shapes
    "SHAPE_KINDS", "ShapeSpec", "parse_shape", "shaped_arrivals",
    "warp_times",
]
