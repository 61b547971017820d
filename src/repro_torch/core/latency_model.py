"""Per-signature latency regression models (paper §7.1 / App. F).

One ridge regression per (signature, phase), trained on the latency DB.
Features follow Vidur/Revati: token count for non-attention operations;
(prefill tokens, batch size, context length) for attention operations.

    prefill: [1, T*R, T^2*R, R]      (T = num_toks, R = num_reqs)
    decode:  [1, R, R*ctx, ctx]

Signatures with fewer than 3 measurements fall back to nearest-point
scaling by total token count.

Measurements for the target hardware are bulk-loaded in one query on first
use and fits are cached; ``precompile`` stacks every fitted coefficient
vector into one matrix per phase so ``predict_batch`` evaluates all
signatures of a model call with a single matmul instead of N scalar
``predict`` calls, and ``predict_batch_points`` extends that to a whole
trace's workload points at once (one feature matrix, one matmul).

The fitted model is a first-class persisted artifact: fits computed from
measurements are staged and written back to the DB ``fits`` table (bulk,
one transaction), and a fresh ``LatencyModel`` on a warm database loads the
stored coefficient blobs instead of re-solving the ridge systems —
predictions are bitwise-identical because the float64 coefficients
round-trip exactly.  Measurement writes invalidate the stored fits (the DB
deletes them), so a stale warm start silently degrades to refitting.

In-memory fit caches follow the same contract: every prediction entry point
checks the DB's generation counters (``refresh``) and drops cached
fits/batches when a foreign write landed, bumping ``epoch`` so downstream
prediction memos (DoolyBackend's call cache) invalidate too.  Long-lived
shared instances are owned by :class:`repro.api.ProfileStore` (the
deprecated ``LatencyModel.shared`` per-connection shim was removed after
its 0.2 grace period).
"""
from __future__ import annotations

import math
import sqlite3
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.database import LatencyDB

RIDGE = 1e-8

_N_FEATURES = {"prefill": 5, "decode": 4}


def nearest_point_scale(points, toks: int, reqs: int) -> float:
    """Under-measured fallback shared by LatencyModel and DoolyProf._replay:
    pick the measured point nearest in log total-token count and scale its
    latency linearly.  ``points`` is an ordered iterable of
    (toks, reqs, latency_us); returns seconds."""
    pts = list(points)
    if not pts:
        return 0.0
    tot = max(toks, 1) * max(reqs, 1)
    best = min(pts, key=lambda p: abs(
        math.log(max(p[0], 1) * max(p[1], 1)) - math.log(tot)))
    bt = max(best[0], 1) * max(best[1], 1)
    return best[2] / 1e6 * (tot / bt)


def _features(phase: str, toks: int, reqs: int, ctx: int) -> np.ndarray:
    t, r, c = float(max(toks, 1)), float(max(reqs, 1)), float(max(ctx, 0))
    if phase == "decode":
        return np.array([1.0, r, r * c, c])
    # ctx*t*r: chunked prefill attends the whole cache (O(toks * ctx))
    return np.array([1.0, t * r, t * t * r, r, c * t * r])


def _features_matrix(phase: str, points) -> np.ndarray:
    """Vectorized ``_features`` over an (n, 3) array of (toks, reqs, ctx)
    workload points -> (n, d) feature matrix (same elementwise float ops as
    the scalar path)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    t = np.maximum(pts[:, 0], 1.0)
    r = np.maximum(pts[:, 1], 1.0)
    c = np.maximum(pts[:, 2], 0.0)
    one = np.ones_like(t)
    if phase == "decode":
        return np.stack([one, r, r * c, c], axis=1)
    return np.stack([one, t * r, t * t * r, r, c * t * r], axis=1)


@dataclass
class _Fit:
    coef: Optional[np.ndarray]
    points: List[Tuple[int, int, int, float]]     # (toks, reqs, ctx, us)
    floor: float = 0.0                            # min latency_us * 0.05


@dataclass
class _BatchFit:
    """Stacked fits for an ordered signature tuple at one phase."""
    coef: np.ndarray                 # (n, d); zero rows where not fitted
    floor: np.ndarray                # (n,)   ; 0 where not fitted
    fallback: List[int]              # indices needing the scalar path


class LatencyModel:
    def __init__(self, db: LatencyDB, hardware: str, *,
                 use_saved_fits: bool = True):
        self.db = db
        self.hardware = hardware
        self.use_saved_fits = use_saved_fits
        self._fits: Dict[Tuple[str, str], _Fit] = {}
        self._batches: Dict[Tuple[Tuple[str, ...], str], _BatchFit] = {}
        # (sig_hash, phase) -> points, bulk-loaded once per hardware
        self._points: Optional[Dict[Tuple[str, str],
                                    List[Tuple[int, int, int, float]]]] = None
        self._points_gen = -1
        # (sig_hash, phase) -> _Fit decoded from the DB fits table
        self._saved: Optional[Dict[Tuple[str, str], _Fit]] = None
        self._saved_gen = -1
        # fits computed from points this session, not yet written back
        self._dirty: Dict[Tuple[str, str],
                          Tuple[np.ndarray, float, int]] = {}
        # set when a write-back fails (read-only DB): stop retrying, the
        # fits live in memory for this session only
        self._persist_failed = False
        # (measurement_generation, fit_generation) the fit caches were
        # built against; any foreign write drops them (stale-fit fix)
        self._cache_gen = (db.measurement_generation, db.fit_generation)
        #: bumped whenever cached fits are dropped; consumers memoizing
        #: *predictions* (DoolyBackend's call cache) key their own
        #: invalidation off it
        self.epoch = 0

    # -- fitting -------------------------------------------------------------

    def refresh(self):
        """Drop every cached fit if the DB changed since they were built.
        Called on the prediction entry points, so a shared instance never
        serves fits computed from measurements that a re-profile has since
        replaced (previously ``_fits`` was never evicted — the
        stale-fit-after-reprofile bug)."""
        gen = (self.db.measurement_generation, self.db.fit_generation)
        if gen == self._cache_gen:
            return
        self._cache_gen = gen
        if self._fits or self._batches or self._dirty:
            self._fits.clear()
            self._batches.clear()
            self._dirty.clear()
            self.epoch += 1

    def _load_points(self) -> Dict[Tuple[str, str],
                                   List[Tuple[int, int, int, float]]]:
        gen = self.db.measurement_generation
        if self._points is None or self._points_gen != gen:
            # reload the snapshot on DB writes; existing fits stay cached
            # (matching the old per-signature lazy-query semantics)
            self._points_gen = gen
            self._points = {}
            for sig, p, t, r, c, lat in self.db.measurements_for_hardware(
                    self.hardware):
                self._points.setdefault((sig, p), []).append((t, r, c, lat))
        return self._points

    def _load_saved(self) -> Dict[Tuple[str, str], _Fit]:
        """Decode the persisted coefficient blobs for this hardware (one
        query); reloaded whenever the DB's fits table changes."""
        gen = self.db.fit_generation
        if self._saved is None or self._saved_gen != gen:
            self._saved_gen = gen
            self._saved = {}
            for sig, phase, d, blob, floor, _n in self.db.load_fits(
                    self.hardware):
                if d != _N_FEATURES.get(phase) or len(blob) != 8 * d:
                    continue        # stale row from an older feature set
                coef = np.frombuffer(blob, dtype=np.float64).copy()
                self._saved[(sig, phase)] = _Fit(coef, [], floor)
        return self._saved

    def _fit(self, sig_hash: str, phase: str) -> _Fit:
        self.refresh()
        key = (sig_hash, phase)
        fit = self._fits.get(key)
        if fit is not None:
            return fit
        if self.use_saved_fits:
            saved = self._load_saved().get(key)
            if saved is not None:
                self._fits[key] = saved
                return saved
        pts = self._load_points().get(key, [])
        coef = None
        floor = 0.0
        if len(pts) >= 4:
            X = np.stack([_features(phase, t, r, c) for t, r, c, _ in pts])
            y = np.array([lat for *_, lat in pts])
            A = X.T @ X + RIDGE * np.eye(X.shape[1])
            coef = np.linalg.solve(A, X.T @ y)
            floor = min(lat for *_, lat in pts) * 0.05
            self._dirty[key] = (coef, floor, len(pts))
        fit = _Fit(coef, pts, floor)
        self._fits[key] = fit
        return fit

    def persist_fits(self) -> int:
        """Write fits computed this session back to the DB ``fits`` table in
        one bulk transaction; returns the number written.  A read-only
        database keeps them in memory only (first failure disables further
        attempts — the rollback churn would otherwise invalidate the DB's
        read caches on every compile)."""
        if not self._dirty or self._persist_failed:
            return 0
        rows = [(sig, self.hardware, phase, int(coef.shape[0]),
                 np.ascontiguousarray(coef, dtype=np.float64).tobytes(),
                 float(floor), int(n))
                for (sig, phase), (coef, floor, n) in self._dirty.items()]
        try:
            with self.db.transaction():
                self.db.save_fits_bulk(rows)
        except sqlite3.OperationalError:
            self._persist_failed = True
            self._dirty.clear()
            # the failed transaction's rollback bumped the generations;
            # don't let refresh() treat our own no-op as a foreign write
            self._cache_gen = (self.db.measurement_generation,
                               self.db.fit_generation)
            return 0
        if self._saved is not None:
            for key in self._dirty:
                self._saved[key] = self._fits[key]
            self._saved_gen = self.db.fit_generation
        # our own write-back is not an invalidation
        self._cache_gen = (self.db.measurement_generation,
                           self.db.fit_generation)
        n = len(self._dirty)
        self._dirty.clear()
        return n

    def precompile(self, sig_hashes: Optional[Sequence[str]] = None, *,
                   persist: bool = True):
        """Fit every (signature, phase) up front and (by default) persist
        freshly computed coefficients.  Defaults to every signature
        measured on this hardware (a cheap DISTINCT query); on a warm
        database each fit is a stored-coefficient decode instead of a
        ridge solve, and the raw measurements are only loaded if some
        (signature, phase) has no persisted fit."""
        if sig_hashes is None:
            sig_hashes = sorted(self.db.measured_hashes(self.hardware))
        for sig in sig_hashes:
            for phase in ("prefill", "decode"):
                self._fit(sig, phase)
        if persist:
            self.persist_fits()

    def _compile_batch(self, sigs: Tuple[str, ...], phase: str) -> _BatchFit:
        self.refresh()
        key = (sigs, phase)
        batch = self._batches.get(key)
        if batch is None:
            d = _N_FEATURES[phase]
            coef = np.zeros((len(sigs), d))
            floor = np.zeros(len(sigs))
            fallback = []
            for i, sig in enumerate(sigs):
                fit = self._fit(sig, phase)
                if fit.coef is not None:
                    coef[i] = fit.coef
                    floor[i] = fit.floor
                else:
                    fallback.append(i)
            batch = _BatchFit(coef, floor, fallback)
            self._batches[key] = batch
            # write-back point: simulators compile a handful of batches per
            # lifetime, so fresh fits land in the DB without an explicit call
            self.persist_fits()
        return batch

    # -- prediction ----------------------------------------------------------

    def predict(self, sig_hash: str, phase: str, *, toks: int = 1,
                reqs: int = 1, ctx: int = 0) -> float:
        """Predicted latency in seconds."""
        fit = self._fit(sig_hash, phase)
        if fit.coef is None:
            return self._predict_fallback(sig_hash, phase, toks, reqs)
        y = float(fit.coef @ _features(phase, toks, reqs, ctx))
        return max(y, fit.floor, 0.0) / 1e6

    def _predict_fallback(self, sig_hash: str, phase: str,
                          toks: int, reqs: int) -> float:
        pts = self._load_points().get((sig_hash, phase), [])
        if not pts:
            # fall back to any phase's measurements
            alt = "prefill" if phase == "decode" else "decode"
            pts = self._load_points().get((sig_hash, alt), [])
            if not pts:
                return 0.0
        return nearest_point_scale(
            ((t, r, lat) for t, r, _, lat in pts), toks, reqs)

    def predict_batch(self, sig_hashes: Sequence[str], phase: str, *,
                      toks: int = 1, reqs: int = 1,
                      ctx: int = 0) -> np.ndarray:
        """Predicted latency (seconds) for every signature at one workload
        point — one matmul over the stacked coefficient matrix, scalar
        fallback only for under-measured signatures."""
        sigs = tuple(sig_hashes)
        batch = self._compile_batch(sigs, phase)
        feat = _features(phase, toks, reqs, ctx)
        out = np.maximum(batch.coef @ feat, batch.floor)
        np.maximum(out, 0.0, out=out)
        out /= 1e6
        for i in batch.fallback:
            out[i] = self._predict_fallback(sigs[i], phase, toks, reqs)
        return out

    def predict_batch_points(self, sig_hashes: Sequence[str], phase: str,
                             points) -> np.ndarray:
        """Predicted latency (seconds) for every signature at every workload
        point: ``points`` is an (n, 3) array-like of (toks, reqs, ctx);
        returns (n_points, n_sigs).  One feature matrix and one matmul for
        the whole set — the trace-level evaluation primitive."""
        sigs = tuple(sig_hashes)
        batch = self._compile_batch(sigs, phase)
        X = _features_matrix(phase, points)
        out = np.maximum(X @ batch.coef.T, batch.floor[None, :])
        np.maximum(out, 0.0, out=out)
        out /= 1e6
        if batch.fallback:
            pts = np.asarray(points, dtype=np.int64).reshape(-1, 3)
            for i in batch.fallback:
                for j in range(pts.shape[0]):
                    out[j, i] = self._predict_fallback(
                        sigs[i], phase, int(pts[j, 0]), int(pts[j, 1]))
        return out
