"""`LatencyBackend`: the pluggable latency-source seam of the public API.

Counterpart of ``repro.api.backends``, with the same arithmetic: chunk
buckets come from the port's engine and the roofline's peaks from the
port's ``parallel.roofline`` (the H100's by default), its collective term
from NVLink's data-sheet figure (``parallel.roofline.NVLINK_BW``).

The paper's headline deliverable is that Dooly's latency database becomes a
*drop-in backend* for existing simulators (cf. Vidur's execution-time
predictor seam, LLMServingSim's hardware-simulator plug).  This module
defines that seam for the reproduction: everything downstream of "how long
does one iteration take" — `DoolySim.run`, `chip_smoke.py` —
consumes latency exclusively through the three-method
:class:`LatencyBackend` protocol, so swapping the latency source is a
constructor argument, not a code change.

Protocol (all latencies in seconds):

* ``predict_points(points)`` — model-call latency for ``(phase, toks,
  reqs, ctx)`` workload points, the evaluation primitive;
* ``predict_plan(plan)`` — one iteration plan (a live
  ``IterationPlan`` or the recorded ``(chunk_lengths, n_decodes)`` form);
* ``predict_trace(plans)`` — per-iteration latency for a whole trace;

plus the batch/calibration surface consumers rely on
(``predict_traces``, ``predict_record``, and the ``overhead_s`` /
``chunk_overhead_s`` / ``decode_scale`` attributes).  Implementors
subclass :class:`PlanBackend`, which derives all of it from a single
``predict_points`` override.

Three registered implementations:

* :class:`DoolyBackend` — the paper's path: per-signature ridge
  regressions over the latency DB.  This class *is* the prediction engine
  that used to live inside ``DoolySim`` (row groups, memoized call cache,
  batched `predict_batch_points` evaluation), moved verbatim so
  predictions are bitwise-identical to the pre-refactor simulator.
* :class:`RooflineBackend` — the analytic model from
  ``parallel/roofline.py`` lifted to workload points: max(compute, memory)
  per model call, no profiling required.  Useful as a
  zero-measurement baseline and for hardware what-ifs.
* :class:`OracleBackend` — replays *raw measurements* (no fitting): on
  profiled sweep points it returns exactly what the oracle measured, which
  makes it the accuracy-audit reference for the regression fits.

``register_backend``/``make_backend`` form the registry; every factory
takes the uniform ``(cfg, db, hardware=..., backend=..., sched_config=...,
max_seq=..., tp=..., lm=...)`` signature (analytic backends ignore the DB
arguments).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.database import LatencyDB
from repro_torch.core.latency_model import LatencyModel, nearest_point_scale
from repro_torch.parallel import roofline as R
from repro_torch.serving.engine import bucket_chunk
from repro_torch.serving.scheduler import IterationPlan, SchedulerConfig

_STATEFUL = ("self_attn", "cross_attn", "mla_attn", "mamba", "moe")

#: (phase, toks, reqs, ctx) — one model call's workload
PointKey = Tuple[str, int, int, int]


@dataclass
class _OpRow:
    sig: str
    module: str
    count: int
    kind: str            # op_name from signatures table
    stateful: bool


@runtime_checkable
class LatencyBackend(Protocol):
    """The simulator-facing latency seam.  Implementations are pure with
    respect to their inputs (same points -> same floats) so simulation
    stays deterministic and sweep dedup stays sound.

    This is the FULL surface `DoolySim`/`predict_scenarios` consume: the
    three prediction methods plus the cross-scenario batch form, record
    pricing, and the calibratable overhead attributes.  Don't implement
    it from scratch — subclass :class:`PlanBackend`, which provides
    everything here from a single ``predict_points`` override."""

    #: calibration surface (written by ``DoolySim.calibrate``)
    overhead_s: float
    chunk_overhead_s: float
    decode_scale: float

    def predict_points(self, points: Sequence[PointKey]) -> np.ndarray:
        """Seconds per (phase, toks, reqs, ctx) model-call point."""
        ...

    def predict_plan(self, plan) -> float:
        """Seconds for one iteration plan."""
        ...

    def predict_trace(self, plans) -> np.ndarray:
        """Per-iteration seconds for a whole trace of plans."""
        ...

    def predict_traces(self, traces: Sequence[Sequence]) -> List[np.ndarray]:
        """Per-trace slices of one batched pass over many traces."""
        ...

    def predict_record(self, rec) -> float:
        """Model-time seconds for an engine IterationRecord."""
        ...


class PlanBackend:
    """Shared plan/trace scaffolding over an abstract ``predict_points``.

    Owns the serving-shape parameters every backend needs to turn an
    iteration plan into model-call points (chunk bucketing, the static
    decode batch shape) plus the calibratable overhead terms
    (``overhead_s`` + ``chunk_overhead_s`` per chunk, ``decode_scale`` on
    the decode program) that ``DoolySim.calibrate`` fits.
    """

    name = "?"

    def __init__(self, cfg: ModelConfig, *, sched_config: SchedulerConfig,
                 max_seq: int, overhead_s: float = 0.0,
                 chunk_overhead_s: float = 0.0):
        self.cfg = cfg
        self.sched_config = sched_config
        self.max_seq = max_seq
        self.overhead_s = overhead_s
        self.chunk_overhead_s = chunk_overhead_s
        self.decode_scale = 1.0
        self._point_cache: Dict[PointKey, float] = {}

    # -- abstract ------------------------------------------------------

    def predict_points(self, points: Sequence[PointKey]) -> np.ndarray:
        raise NotImplementedError

    def _sync_cache(self):
        """Hook: drop memoized points when the underlying latency source
        changed.  The base class is pure (nothing to go stale); DB-backed
        subclasses override with a generation check."""

    # -- shared plan handling ------------------------------------------

    def _decode_key(self) -> PointKey:
        return ("decode", 1, self.sched_config.max_num_seqs, self.max_seq)

    def _normalize_plan(self, plan) -> Tuple[Tuple[int, ...], bool]:
        """(bucketed chunk token counts, has_decodes) for an IterationPlan
        or a recorded (chunk_lengths, n_decodes) tuple."""
        if isinstance(plan, IterationPlan):
            lengths: Tuple[int, ...] = tuple(c.length for c in plan.prefills)
            n_dec = len(plan.decodes)
        else:
            lengths, n_dec = plan
        if self.cfg.ssm_state <= 0:
            lengths = tuple(bucket_chunk(length,
                                         self.sched_config.chunk_size)
                            for length in lengths)
        return lengths, bool(n_dec)

    def _cached_points(self, keys: List[PointKey]) -> None:
        missing = [k for k in keys if k not in self._point_cache]
        if missing:
            vals = self.predict_points(missing)
            for k, v in zip(missing, vals):
                self._point_cache[k] = float(v)

    def predict_plan(self, plan) -> float:
        return float(self.predict_trace((plan,))[0])

    def predict_trace(self, plans) -> np.ndarray:
        self._sync_cache()
        norm = [self._normalize_plan(p) for p in plans]
        dec_key = self._decode_key()
        keys = sorted({("prefill", c, 1, self.max_seq)
                       for chunks, _ in norm for c in chunks})
        has_dec = any(d for _, d in norm)
        self._cached_points(keys + ([dec_key] if has_dec else []))
        cache = self._point_cache
        out = np.empty(len(norm))
        for i, (chunks, dec) in enumerate(norm):
            total = self.overhead_s + self.chunk_overhead_s * len(chunks)
            for c in chunks:
                total += cache[("prefill", c, 1, self.max_seq)]
            if dec:
                total += self.decode_scale * cache[dec_key]
            out[i] = total
        return out

    def predict_traces(self, traces: Sequence[Sequence]) -> List[np.ndarray]:
        """Per-trace slices of one flattened ``predict_trace`` pass."""
        flat = [p for trace in traces for p in trace]
        lat = self.predict_trace(flat)
        out: List[np.ndarray] = []
        off = 0
        for trace in traces:
            out.append(lat[off:off + len(trace)])
            off += len(trace)
        return out

    def predict_record(self, rec) -> float:
        """Model-time prediction for an engine IterationRecord (no
        overhead terms) — used for calibration."""
        self._sync_cache()
        total = 0.0
        for length, start in rec.chunks:
            c = length if self.cfg.ssm_state > 0 else bucket_chunk(
                length, self.sched_config.chunk_size)
            self._cached_points([("prefill", c, 1, self.max_seq)])
            total += self._point_cache[("prefill", c, 1, self.max_seq)]
        if rec.n_decodes:
            dec_key = self._decode_key()
            self._cached_points([dec_key])
            total += self.decode_scale * self._point_cache[dec_key]
        return total


class _CallGraphBackend(PlanBackend):
    """Plan backend over the profiled call graph: loads the collapsed
    canonical (signature, module, count) rows for one (model, backend,
    hardware, tp) configuration from the latency DB."""

    def __init__(self, cfg: ModelConfig, db: LatencyDB, *, hardware: str,
                 backend: str, sched_config: SchedulerConfig, max_seq: int,
                 tp: int = 1, overhead_s: float = 0.0,
                 chunk_overhead_s: float = 0.0):
        super().__init__(cfg, sched_config=sched_config, max_seq=max_seq,
                         overhead_s=overhead_s,
                         chunk_overhead_s=chunk_overhead_s)
        self.db = db
        self.hardware = hardware
        self.backend = backend
        self.tp = tp
        self._meas_gen = db.measurement_generation
        cid = db.config_id(cfg.name, backend, hardware, tp)
        self.rows: List[_OpRow] = []
        for sig, module, count in db.model_operations(cid):
            meta = db.signature(sig)
            kind = meta[0] if meta else "?"
            self.rows.append(_OpRow(sig, module, count, kind,
                                    kind in _STATEFUL))

    def _sync_cache(self):
        """Measurement writes make memoized points stale — drop them (the
        DB's own read-through caches already invalidate themselves)."""
        gen = self.db.measurement_generation
        if gen != self._meas_gen:
            self._point_cache.clear()
            self._meas_gen = gen

    @staticmethod
    def _map_point(follows_phase: bool, lm_head: bool, phase: str,
                   toks: int, reqs: int, ctx: int
                   ) -> Tuple[str, int, int, int]:
        """THE workload mapping, single copy for every call-graph
        consumer: stateful non-MoE rows (``follows_phase``) follow the
        call's phase/ctx; MoE and stateless rows always evaluate as
        prefill with ctx=0; ``lm_head`` rows clamp to the chunk's last
        position on prefill."""
        t = 1 if lm_head and phase == "prefill" else toks
        if follows_phase:
            return (phase, t, reqs, ctx)
        return ("prefill", t, reqs, 0)

    @classmethod
    def _map_row(cls, row: _OpRow, phase: str, toks: int, reqs: int,
                 ctx: int) -> Tuple[str, int, int, int]:
        return cls._map_point(row.stateful and row.kind != "moe",
                              "lm_head" in row.module,
                              phase, toks, reqs, ctx)

    def unprofiled_sigs(self) -> List[str]:
        """Call-graph signatures with no measurements on this hardware —
        quarantined or never-profiled ops.  LatencyModel silently prices
        such signatures at 0.0s, so health checks must ask *up front*
        rather than wait for an exception that never comes."""
        known = set(self.db.measured_hashes(self.hardware))
        return sorted({r.sig for r in self.rows} - known)


class DoolyBackend(_CallGraphBackend):
    """Regression-fit latency from the profile store — the paper's path.

    Construction splits the call-graph rows into groups that share a
    workload mapping; each group evaluates through
    ``LatencyModel.predict_batch``/``predict_batch_points`` as one matmul,
    and call totals are memoized on (phase, toks, reqs, ctx).  Decode
    batches and power-of-two-bucketed prefill chunks draw from a tiny
    discrete set, so a long trace collapses to a handful of distinct
    evaluations.  The scalar reference path is kept as
    ``predict_call_scalar`` (equivalence tests and the perf benchmark's
    baseline).

    The call cache invalidates itself when the underlying LatencyModel
    drops its fits (``lm.epoch``), so a store that re-profiles mid-session
    never serves predictions from superseded measurements.
    """

    name = "dooly"

    def __init__(self, cfg: ModelConfig, db: LatencyDB, *, hardware: str,
                 backend: str, sched_config: SchedulerConfig, max_seq: int,
                 tp: int = 1, lm: Optional[LatencyModel] = None,
                 overhead_s: float = 0.0, chunk_overhead_s: float = 0.0):
        super().__init__(cfg, db, hardware=hardware, backend=backend,
                         sched_config=sched_config, max_seq=max_seq, tp=tp,
                         overhead_s=overhead_s,
                         chunk_overhead_s=chunk_overhead_s)
        # a ProfileStore passes its shared per-hardware model so N
        # scenarios load each persisted fit exactly once
        self.lm = lm if lm is not None else LatencyModel(db, hardware)
        # group rows by workload mapping, built once: (follows_call_phase,
        # lm_head) -> (sig tuple, counts vector).  follows_call_phase is
        # stateful non-MoE; everything else evaluates as prefill/ctx=0.
        self._groups: Dict[Tuple[bool, bool],
                           Tuple[Tuple[str, ...], np.ndarray]] = {}
        buckets: Dict[Tuple[bool, bool], List[_OpRow]] = {}
        for row in self.rows:
            k = (row.stateful and row.kind != "moe", "lm_head" in row.module)
            buckets.setdefault(k, []).append(row)
        for k, rows in buckets.items():
            self._groups[k] = (tuple(r.sig for r in rows),
                               np.array([float(r.count) for r in rows]))
        self._call_cache: Dict[PointKey, float] = {}
        # raw (chunk_lengths, n_decodes) plan -> (prefill model time,
        # n_chunks).  Keyed by the *raw* plan so warm iterations skip
        # normalization; overhead and decode terms apply at assembly so
        # the calibration setters (overhead_s / chunk_overhead_s /
        # decode_scale) never stale it
        self._plan_cache: Dict[Tuple[Tuple[int, ...], int],
                               Tuple[float, int]] = {}
        self._lm_epoch = self.lm.epoch

    def _sync_cache(self):
        """Drop memoized call totals when the fit cache was invalidated
        (a measurement/fit write landed since they were computed).  The
        inherited ``_point_cache`` (fed by the base ``predict_record``)
        holds the same values, so it dies with them."""
        self.lm.refresh()
        if self.lm.epoch != self._lm_epoch:
            self._call_cache.clear()
            self._point_cache.clear()
            self._plan_cache.clear()
            self._lm_epoch = self.lm.epoch

    # ------------------------------------------------------------------

    def predict_call(self, *, phase: str, toks: int, reqs: int,
                     ctx: int) -> float:
        """One model call: sum per-signature predictions over the call
        graph.  Vectorized (one predict_batch matmul per row group) and
        memoized on the workload key."""
        self._sync_cache()
        key = (phase, toks, reqs, ctx)
        cached = self._call_cache.get(key)
        if cached is not None:
            return cached
        total = 0.0
        for (follows_phase, lm_head), (sigs, counts) in self._groups.items():
            ph, t, r, c = self._map_point(follows_phase, lm_head,
                                          phase, toks, reqs, ctx)
            preds = self.lm.predict_batch(sigs, ph, toks=t, reqs=r, ctx=c)
            total += float(counts @ preds)
        self._call_cache[key] = total
        return total

    def predict_call_scalar(self, *, phase: str, toks: int, reqs: int,
                            ctx: int) -> float:
        """Reference scalar path: per-row LatencyModel.predict, no caching.
        predict_call must match this within 1e-9."""
        total = 0.0
        for row in self.rows:
            ph, t, r, c = self._map_row(row, phase, toks, reqs, ctx)
            total += row.count * self.lm.predict(row.sig, ph, toks=t,
                                                 reqs=r, ctx=c)
        return total

    def _eval_calls(self, keys: List[PointKey]):
        """Evaluate predict_call for many (phase, toks, reqs, ctx) keys at
        once — per row group and mapped phase, one feature matrix and one
        predict_batch_points matmul — and memoize the totals."""
        totals = np.zeros(len(keys))
        for (follows_phase, lm_head), (sigs, counts) in self._groups.items():
            by_phase: Dict[str, Tuple[List[int], List[Tuple[int, int, int]]]]
            by_phase = {}
            for j, (phase, toks, reqs, ctx) in enumerate(keys):
                ph, t, r, c = self._map_point(follows_phase, lm_head,
                                              phase, toks, reqs, ctx)
                idx, pts = by_phase.setdefault(ph, ([], []))
                idx.append(j)
                pts.append((t, r, c))
            for ph, (idx, pts) in by_phase.items():
                preds = self.lm.predict_batch_points(sigs, ph, pts)
                totals[idx] += preds @ counts
        for j, key in enumerate(keys):
            self._call_cache[key] = float(totals[j])

    def predict_points(self, points: Sequence[PointKey]) -> np.ndarray:
        self._sync_cache()
        keys = [tuple(p) for p in points]
        missing = sorted({k for k in keys if k not in self._call_cache})
        if missing:
            self._eval_calls(missing)
        return np.fromiter((self._call_cache[k] for k in keys),
                           dtype=np.float64, count=len(keys))

    def predict_trace(self, plans) -> np.ndarray:
        """Per-iteration predicted latency (seconds) for a whole trace of
        plans, batched: each distinct raw plan's prefill model time is
        memoized per fit epoch (decode-heavy traces repeat a handful of
        plans, so re-pricing a chunk is dict lookups), only the misses
        are normalized and priced (vectorized unique/bincount when a
        fresh trace brings many), and the overhead / decode terms apply
        at assembly so the calibration setters never stale the memo.
        predict_plan(p) == predict_trace([p])[0]."""
        self._sync_cache()
        cache = self._call_cache
        pcache = self._plan_cache
        # recorded (chunk_lengths, n_decodes) tuples are memo keys as-is;
        # IterationPlans reduce to the same raw form first
        raw = [p if type(p) is tuple
               else (tuple(c.length for c in p.prefills), len(p.decodes))
               for p in plans]
        missing = [k for k in dict.fromkeys(raw) if k not in pcache]
        if missing:
            normed = [self._normalize_plan(p) for p in missing]
            if len(missing) < 16:
                # a few misses (predict_plan's single plan): plain Python
                # keeps run()'s per-iteration cost at dict-lookup level
                keys = sorted({("prefill", c, 1, self.max_seq)
                               for chunks, _ in normed for c in chunks})
                eval_keys = [k for k in keys if k not in cache]
                if eval_keys:
                    self._eval_calls(eval_keys)
                for rk, (chunks, _) in zip(missing, normed):
                    total = 0.0
                    for c in chunks:
                        total += cache[("prefill", c, 1, self.max_seq)]
                    pcache[rk] = (total, len(chunks))
            else:
                # a fresh trace: price the distinct plans vectorized
                # (chunks already bucketed by _normalize_plan)
                m = len(missing)
                counts = np.array([len(chunks) for chunks, _ in normed],
                                  dtype=np.intp)
                flat = np.asarray(
                    [c for chunks, _ in normed for c in chunks],
                    dtype=np.int64)
                uniq, inv = np.unique(flat, return_inverse=True)
                keys = [("prefill", int(c), 1, self.max_seq) for c in uniq]
                eval_keys = [k for k in keys if k not in cache]
                if eval_keys:
                    self._eval_calls(eval_keys)
                lat_uniq = np.fromiter((cache[k] for k in keys),
                                       dtype=np.float64, count=len(uniq))
                plan_idx = np.repeat(np.arange(m, dtype=np.intp), counts)
                chunk_sum = np.bincount(plan_idx, weights=lat_uniq[inv],
                                        minlength=m)
                for rk, s, c in zip(missing, chunk_sum, counts):
                    pcache[rk] = (float(s), int(c))
        dec_lat = 0.0
        if any(k[1] for k in raw):
            dec_key = self._decode_key()
            if dec_key not in cache:
                self._eval_calls([dec_key])
            dec_lat = self.decode_scale * cache[dec_key]
        out = np.empty(len(raw))
        oh, coh = self.overhead_s, self.chunk_overhead_s
        for i, k in enumerate(raw):
            pref, n_chunks = pcache[k]
            total = oh + coh * n_chunks + pref
            if k[1]:
                total += dec_lat
            out[i] = total
        return out

    # predict_record: inherited from PlanBackend — it routes through
    # predict_points, which reads this backend's memoized call cache


class OracleBackend(_CallGraphBackend):
    """Raw-measurement replay — the accuracy-audit reference.

    No fitting: each call-graph row looks its mapped workload point up in
    the measurements table directly, so on profiled sweep points the
    prediction is exactly (sum of count x measured latency).  Off-grid
    points fall back to nearest-point-by-total-tokens scaling with the
    same semantics LatencyModel's under-measured fallback uses.  Auditing
    the regression fits = comparing DoolyBackend against this on the
    profiled grid.
    """

    name = "oracle"

    def _row_point_us(self, row: _OpRow, key: PointKey) -> float:
        phase, toks, reqs, ctx = key
        meas = self.db.measurement_map(row.sig, self.hardware)
        lat = meas.get((phase, toks, reqs, ctx))
        if lat is not None:
            return lat
        # off-grid: nearest measured point of this phase (any phase if
        # none), scaled by total token count — LatencyModel's fallback
        pts = [(t, r, v) for (p, t, r, _c), v in meas.items() if p == phase]
        if not pts:
            pts = [(t, r, v) for (_p, t, r, _c), v in meas.items()]
        return nearest_point_scale(pts, toks, reqs) * 1e6

    def predict_points(self, points: Sequence[PointKey]) -> np.ndarray:
        out = np.zeros(len(points))
        for j, point in enumerate(points):
            phase, toks, reqs, ctx = point
            total = 0.0
            for row in self.rows:
                key = self._map_row(row, phase, toks, reqs, ctx)
                total += row.count * self._row_point_us(row, key)
            out[j] = total / 1e6
        return out


class RooflineBackend(PlanBackend):
    """Analytic latency from the roofline model — no profiling at all.

    Adapts ``parallel/roofline.py``'s hardware model (the H100's peak
    FLOP/s of the bf16 tensor cores and its HBM bandwidth) to per-call
    workload points: a model call costs max(compute, memory) seconds where

    * compute    = 2 * N_active * tokens / (peak * tp)
      (+ the attention score/value term, quadratic in context),
    * memory     = (weight bytes / tp + KV-cache traffic) / HBM bw,
    * collective = one ring all-reduce of the activations per layer over
      NVLink (0 at tp = 1): a model on NVIDIA's data-sheet figure, not a
      measurement.

    Deliberately coarse — it exists as the zero-measurement baseline a
    drop-in backend seam makes possible, and for hardware what-ifs (pass
    custom peaks).
    """

    name = "roofline"

    def __init__(self, cfg: ModelConfig, *, sched_config: SchedulerConfig,
                 max_seq: int, tp: int = 1, dtype_bytes: int = 2,
                 peak_flops: Optional[float] = None,
                 hbm_bw: Optional[float] = None,
                 overhead_s: float = 0.0, chunk_overhead_s: float = 0.0):
        super().__init__(cfg, sched_config=sched_config, max_seq=max_seq,
                         overhead_s=overhead_s,
                         chunk_overhead_s=chunk_overhead_s)
        peaks = R.peaks(R.H100)
        self.tp = tp
        self.dtype_bytes = dtype_bytes
        self.peak_flops = (peaks.peak_flops(torch.bfloat16)
                           if peak_flops is None else peak_flops)
        self.hbm_bw = peaks.hbm_bw if hbm_bw is None else hbm_bw
        self.link_bw = R.NVLINK_BW
        self.n_active = float(cfg.active_param_count())

    def _point_seconds(self, phase: str, toks: int, reqs: int,
                       ctx: int) -> float:
        cfg, b = self.cfg, float(self.dtype_bytes)
        new_toks = float(max(toks, 1)) * max(reqs, 1)
        kv_heads = 0 if cfg.is_attention_free else max(cfg.n_kv_heads, 1)
        head = cfg.resolved_head_dim
        layers = max(cfg.n_layers, 1)
        span = float(max(ctx, 1))
        # compute: 2 FLOPs per active param per token, plus attention
        # scores/values (2 matmuls over the attended span per layer/head)
        flops = 2.0 * self.n_active * new_toks
        if kv_heads:
            flops += (4.0 * layers * cfg.n_heads * head * new_toks * span)
        # memory: every active weight read once per call, plus the KV cache
        # read over the attended span and written for new toks
        hbm = self.n_active * b / self.tp
        if kv_heads:
            kv_row = 2.0 * layers * kv_heads * head * b
            hbm += kv_row * (span * max(reqs, 1) + new_toks)
        # collective: one ring all-reduce of the activations per layer
        coll = 0.0
        if self.tp > 1:
            wire = 2.0 * (self.tp - 1) / self.tp
            coll = (layers * new_toks * cfg.d_model * b * wire) / self.link_bw
        return max(flops / (self.peak_flops * self.tp / 1.0),
                   hbm / self.hbm_bw, coll)

    def predict_points(self, points: Sequence[PointKey]) -> np.ndarray:
        return np.array([self._point_seconds(*p) for p in points])


# -- graceful degradation ----------------------------------------------


class FallbackBackend:
    """A fallback chain over latency backends (graceful degradation).

    Stage health is decided at *construction* time: a call-graph stage
    (one with ``rows``) is healthy only if its rows exist and every
    signature has measurements on this hardware.  That up-front check is
    load-bearing — ``LatencyModel`` prices unmeasured signatures at 0.0s
    without raising, so an exception-driven fallback would silently
    simulate with zeroed operators instead of degrading.  Quarantined
    ops (whose signatures landed without measurements) and never-
    profiled models therefore route to the next stage — typically the
    analytic ``roofline`` — and the sweep layer surfaces ``degraded`` /
    ``degraded_reason`` per scenario.

    Prediction calls still carry a runtime safety net: an exception in
    the active stage advances to the next one for the remainder of the
    session.
    """

    name = "fallback"

    def __init__(self, stages: Sequence[Tuple[str, LatencyBackend]],
                 reasons: Optional[Dict[str, str]] = None):
        if not stages:
            raise ValueError("FallbackBackend needs at least one stage")
        self.stages = list(stages)
        #: stage name -> why it was skipped at construction
        self.reasons: Dict[str, str] = dict(reasons or {})
        self._active_i = 0
        self.name = "->".join(n for n, _ in self.stages)

    # -- degradation status --------------------------------------------

    @property
    def active(self) -> LatencyBackend:
        return self.stages[self._active_i][1]

    @property
    def active_name(self) -> str:
        return self.stages[self._active_i][0]

    @property
    def degraded(self) -> bool:
        return self._active_i > 0

    @property
    def degraded_reason(self) -> Optional[str]:
        if not self.degraded:
            return None
        skipped = [f"{name}: {self.reasons.get(name, 'runtime failure')}"
                   for name, _ in self.stages[:self._active_i]]
        return "; ".join(skipped)

    @property
    def rows(self):
        """The active stage's call-graph rows (None for analytic
        stages) — so consumers that inspect ``rows`` see the stage that
        actually answers."""
        return getattr(self.active, "rows", None)

    # -- calibration surface (proxied to the active stage) -------------

    @property
    def overhead_s(self) -> float:
        return self.active.overhead_s

    @overhead_s.setter
    def overhead_s(self, v: float):
        self.active.overhead_s = v

    @property
    def chunk_overhead_s(self) -> float:
        return self.active.chunk_overhead_s

    @chunk_overhead_s.setter
    def chunk_overhead_s(self, v: float):
        self.active.chunk_overhead_s = v

    @property
    def decode_scale(self) -> float:
        return self.active.decode_scale

    @decode_scale.setter
    def decode_scale(self, v: float):
        self.active.decode_scale = v

    # -- prediction (runtime safety net) -------------------------------

    def _call(self, method: str, *args):
        first = self._active_i
        err: Optional[BaseException] = None
        for i in range(first, len(self.stages)):
            name, be = self.stages[i]
            try:
                out = getattr(be, method)(*args)
            except Exception as e:              # noqa: BLE001
                err = e
                self.reasons.setdefault(
                    name, f"{type(e).__name__}: {e}")
                continue
            if i != self._active_i:
                self._active_i = i              # stay degraded
            return out
        raise err if err is not None else RuntimeError(
            f"no fallback stage could serve {method}")

    def predict_points(self, points) -> np.ndarray:
        return self._call("predict_points", points)

    def predict_plan(self, plan) -> float:
        return self._call("predict_plan", plan)

    def predict_trace(self, plans) -> np.ndarray:
        return self._call("predict_trace", plans)

    def predict_traces(self, traces) -> List[np.ndarray]:
        return self._call("predict_traces", traces)

    def predict_record(self, rec) -> float:
        return self._call("predict_record", rec)


def _stage_skip_reason(be: LatencyBackend, db: Optional[LatencyDB],
                       hardware: str) -> Optional[str]:
    """None when the stage can serve honest predictions; otherwise why
    not.  Analytic stages (no ``rows``) are always healthy."""
    rows = getattr(be, "rows", None)
    if rows is None:
        return None
    if not rows:
        return "no call-graph rows (model not profiled)"
    unprofiled = (be.unprofiled_sigs()
                  if hasattr(be, "unprofiled_sigs") else [])
    if unprofiled:
        return (f"{len(unprofiled)}/{len({r.sig for r in rows})} "
                f"signatures unmeasured on {hardware} (quarantined or "
                f"unprofiled): {', '.join(s[:12] for s in unprofiled[:3])}"
                + ("..." if len(unprofiled) > 3 else ""))
    return None


def make_fallback_backend(names: Sequence[str], cfg: ModelConfig,
                          db: Optional[LatencyDB] = None, *,
                          hardware: str, **kw) -> FallbackBackend:
    """Build every stage of a chain and activate the first healthy one
    (falling back to the last stage if none is)."""
    stages: List[Tuple[str, LatencyBackend]] = []
    reasons: Dict[str, str] = {}
    for name in names:
        try:
            be = make_backend(name, cfg, db, hardware=hardware, **kw)
        except Exception as e:                  # noqa: BLE001
            reasons[name] = f"{type(e).__name__}: {e}"
            continue
        stages.append((name, be))
    if not stages:
        raise RuntimeError(
            f"no stage of fallback chain {'->'.join(names)} could be "
            f"built: {reasons}")
    chain = FallbackBackend(stages, reasons)
    for i, (name, be) in enumerate(stages):
        skip = _stage_skip_reason(be, db, hardware)
        if skip is None:
            chain._active_i = i
            break
        chain.reasons.setdefault(name, skip)
    else:
        chain._active_i = len(stages) - 1       # best effort
    return chain


# -- registry ----------------------------------------------------------

BackendFactory = Callable[..., LatencyBackend]

_REGISTRY: Dict[str, BackendFactory] = {}


def register_backend(name: str, factory: BackendFactory):
    """Register a latency-backend factory under ``name``.  Factories take
    ``(cfg, db, *, hardware, backend, sched_config, max_seq, tp, lm)``
    and may ignore arguments they don't need."""
    _REGISTRY[name] = factory


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_backend(name: str, cfg: ModelConfig,
                 db: Optional[LatencyDB] = None, *, hardware: str,
                 backend: str = "xla", sched_config: SchedulerConfig,
                 max_seq: int, tp: int = 1,
                 lm: Optional[LatencyModel] = None,
                 **kw) -> LatencyBackend:
    """Construct a registered backend by name (the sweep/CLI entry).

    ``"a->b"`` names build a :class:`FallbackBackend` chain: each stage
    is a registered backend, and the first stage healthy for this
    (model, hardware) answers predictions — graceful degradation for
    quarantined or unprofiled models."""
    if "->" in name:
        parts = [p.strip() for p in name.split("->") if p.strip()]
        if len(parts) < 2:
            raise KeyError(f"malformed fallback chain {name!r}")
        return make_fallback_backend(
            parts, cfg, db, hardware=hardware, backend=backend,
            sched_config=sched_config, max_seq=max_seq, tp=tp, lm=lm,
            **kw)
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(f"unknown latency backend {name!r}; "
                       f"registered: {', '.join(available_backends())} "
                       f"(or an 'a->b' fallback chain)")
    return factory(cfg, db, hardware=hardware, backend=backend,
                   sched_config=sched_config, max_seq=max_seq, tp=tp,
                   lm=lm, **kw)


register_backend(
    "dooly",
    lambda cfg, db, *, hardware, backend, sched_config, max_seq, tp=1,
    lm=None, **kw: DoolyBackend(
        cfg, db, hardware=hardware, backend=backend,
        sched_config=sched_config, max_seq=max_seq, tp=tp, lm=lm, **kw))
register_backend(
    "oracle",
    lambda cfg, db, *, hardware, backend, sched_config, max_seq, tp=1,
    lm=None, **kw: OracleBackend(
        cfg, db, hardware=hardware, backend=backend,
        sched_config=sched_config, max_seq=max_seq, tp=tp, **kw))
register_backend(
    "roofline",
    lambda cfg, db=None, *, hardware=None, backend=None, sched_config,
    max_seq, tp=1, lm=None, **kw: RooflineBackend(
        cfg, sched_config=sched_config, max_seq=max_seq, tp=tp, **kw))
register_backend(
    "degraded",
    lambda cfg, db, *, hardware, backend, sched_config, max_seq, tp=1,
    lm=None, **kw: make_fallback_backend(
        ("dooly", "roofline"), cfg, db, hardware=hardware,
        backend=backend, sched_config=sched_config, max_seq=max_seq,
        tp=tp, lm=lm, **kw))
