"""Duplication-Aware Profiler (paper §6) — DoolyProf.

Counterpart of ``repro.core.profiler``.  It runs where its ``device`` is:
the card unless the caller passes ``device="cpu"``.  Its default oracle is
``cuda_events`` and its default hardware tag the card's
(``parallel.roofline.hardware_tag``); without a card the defaults raise,
so the CPU tests name ``hardware="cpu"`` and ``h100_analytical`` or
``cpu_wallclock``.  Under ``cuda_events`` a decode-phase ``self_attn`` point
runs with every row's length at ctx - 1: the reference materializes
lengths of 0, which times a one-token context under the split-KV kernel
whatever ``ctx`` says.

Per (model, backend): trace once (Tainted Runner), resolve the runnable set
(Operation Set Finder), compute signatures, and sweep ONLY signatures absent
from the latency database.  Dedup is a primary-key lookup; for skipped
entries we replay the stored measurements to account the GPU-hours a naive
per-configuration profiler would have spent (Table 2's N / R / Profile /
Saved columns).

Sweeps are taint-driven (§5.2): MODEL_CONFIG dims fixed, NUM_TOKS/NUM_REQS
dims set per sweep point, MIX dims recalculated.  Stateful modules sweep
both phases — prefill over (toks x reqs), decode over (ctx x reqs) — with
execution contexts built by the serving engine (App. D).

Writes are staged in memory during profile_model and flushed in one DB
transaction per model (signatures, measurements, and call-graph counts via
the bulk APIs); replay for deduplicated signatures uses the DB's cached
point lookup, falling back to the nearest point by total token count with
the same scaling semantics as LatencyModel.

``profile_model(..., workers=N)`` parallelizes the sweep across processes
without re-tracing the model per worker: the parent traces once, resolves
the runnable set once, computes every signature once, and serializes a
picklable *measurement task* per signature shard (stateful modules ship as
(kind, window) — workers rebuild the execution context through the cached
serving builders; operator entries ship *detached*, their aten overload
replaced by its name).  Workers measure
only the disjoint shard they own (stable hash partition, minus signatures
the parent DB already knows) and ship raw latency rows back; the parent
then runs the normal profiling pass with those pre-measured latencies
substituted for oracle calls, so reports, dedup accounting, and the
one-transaction flush are identical to a serial run (bit-identical rows
under a deterministic oracle).

The reference's ``profile_comm`` models a TPU interconnect and comes with
the multi-GPU slice; the DB keeps its comm tables.
"""
from __future__ import annotations

import math
import re
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import backends as oracles
from repro_torch.core.database import LatencyDB
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.latency_model import nearest_point_scale
from repro_torch.core.opset import (ModuleEntry, OpEntry, detach_op_entry,
                                    find_runnable_set)
from repro_torch.core.runner import ModelTrace, trace_model
from repro_torch.core.signature import (LINEAR_OPS, Signature,
                                        module_entry_signature,
                                        op_entry_signature)
from repro_torch.parallel.roofline import default_hardware
from repro_torch.serving.context import (ModuleContext, cached_build_context,
                                         phases_for)


def _module_of(entry) -> str:
    return entry.module


#: the oracle that counts on meta tensors: module contexts go through their
#: plain path, which the flop counter can see
ANALYTICAL = "h100_analytical"

REPEATS = 100           # measurements per sweep point in a real profiler


@dataclass
class SweepConfig:
    toks: Tuple[int, ...] = (256, 1024, 4096)
    reqs: Tuple[int, ...] = (1, 8)
    ctx: Tuple[int, ...] = (2048, 16384)
    op_points: Tuple[Tuple[int, int], ...] = ((256, 1), (1024, 1),
                                              (4096, 1), (1024, 8))
    repeats: int = REPEATS


QUICK_SWEEP = SweepConfig(toks=(64, 256), reqs=(1, 2), ctx=(128, 512),
                          op_points=((64, 1), (256, 1), (64, 2)))


class MeasurementError(RuntimeError):
    """A measurement produced unusable data (NaN/inf/non-positive)."""


def _valid_latency(value) -> bool:
    return (isinstance(value, (int, float)) and math.isfinite(value)
            and value > 0)


def validate_rows(rows: List[Tuple], *, where: str = "") -> List[Tuple]:
    """Reject measurement rows whose latency is NaN, infinite, or
    non-positive — garbage that would otherwise poison fits and
    simulations silently.  Returns the rows unchanged when clean."""
    bad = [r for r in rows if not _valid_latency(r[-1])]
    if bad:
        label = f" for {where}" if where else ""
        sample = ", ".join(f"{r[2]}@{r[3]}/{r[4]}/{r[5]}={r[-1]!r}"
                           for r in bad[:3])
        raise MeasurementError(
            f"{len(bad)}/{len(rows)} invalid latency rows{label}: "
            f"{sample}")
    return rows


@dataclass(frozen=True)
class ValidationPolicy:
    """How raw oracle measurements are vetted before landing.

    ``reject_invalid`` grants one silent re-measure when a sample comes
    back NaN/inf/non-positive, then raises :class:`MeasurementError`.
    ``max_rel_spread``, when set, takes a second sample per point and —
    if the pair's relative spread exceeds the threshold (a flaky
    measurement) — one more, landing the final sample.  It defaults to
    off because the repo's oracles are deterministic and the plan /
    serial bit-identity gates assume one sample per point."""
    reject_invalid: bool = True
    max_rel_spread: Optional[float] = None

    def check(self, measure_once, what: str) -> float:
        val = measure_once()
        if self.reject_invalid and not _valid_latency(val):
            val = measure_once()            # one benefit-of-the-doubt
            if not _valid_latency(val):
                raise MeasurementError(
                    f"oracle returned invalid latency {val!r} for "
                    f"{what} (twice)")
        if self.max_rel_spread is not None:
            second = measure_once()
            lo, hi = sorted((val, second))
            if not _valid_latency(second) or \
                    (hi - lo) / max(lo, 1e-30) > self.max_rel_spread:
                val = measure_once()        # flagged: re-measure once
                if self.reject_invalid and not _valid_latency(val):
                    raise MeasurementError(
                        f"oracle returned invalid latency {val!r} for "
                        f"{what} on re-measure")
        return val

def _measure_task_shard(payload) -> List[Tuple]:
    """ProcessPoolExecutor worker: measure a shard of pre-traced tasks —
    no model trace, no runnable-set resolution, no signature computation.
    Each task is either ("module", kind, window, sig_hash) — the execution
    context is rebuilt through the serving builders — or ("op", sig_hash,
    entry) with a detached OpEntry.  Returns
    (sig_hash, phase, toks, reqs, ctx, latency_us) rows.
    Module-level so it pickles under the spawn start method."""
    (cfg, backend, oracle, hardware, sweep, device, tasks) = payload
    with LatencyDB() as db:
        prof = DoolyProf(db, oracle=oracle, hardware=hardware, sweep=sweep,
                         device=device)
        return [(sig, phase, toks, reqs, ctx, lat_us)
                for task in tasks
                for (sig, _hw, phase, toks, reqs, ctx, _o, lat_us)
                in prof.measure_payload_rows(task, cfg, backend)]


@dataclass(frozen=True)
class EntrySpec:
    """Everything the plan layer needs to know about one runnable-set
    entry without holding the live trace: its signature, report metadata
    (group/variant as ``profile_model`` would emit them), the picklable
    measurement payload, and the exact number of measurement rows one
    sweep of it writes (the dry-run cost-accounting unit).

    ``payload`` is None when an earlier entry in the same resolution pass
    carries the same signature — duplicate signatures share one task."""
    sig: Signature
    name: str                     # primitive name or context kind
    group: str
    variant: str
    module: str
    count: int
    n_points: int
    payload: Optional[Tuple]


@dataclass
class EntryReport:
    sig: str
    name: str
    group: str
    variant: str
    count: int
    reused: bool
    cost_s: float                 # profiling seconds (spent or would-spend)


@dataclass
class ProfileReport:
    model: str
    backend: str
    entries: List[EntryReport] = field(default_factory=list)
    trace_s: float = 0.0

    @property
    def spent_s(self) -> float:
        return sum(e.cost_s for e in self.entries if not e.reused)

    @property
    def saved_s(self) -> float:
        return sum(e.cost_s for e in self.entries if e.reused)

    @property
    def n_new(self) -> int:
        return sum(not e.reused for e in self.entries)

    @property
    def n_reused(self) -> int:
        return sum(e.reused for e in self.entries)


def window_for_path(cfg: ModelConfig, path: Tuple[str, ...]) -> int:
    """Sliding window of the layer this module instance came from."""
    for comp in path:
        m = re.match(r"(?:enc_)?layers\.(\d+)$", comp)
        if m:
            i = int(m.group(1))
            if comp.startswith("enc_"):
                return 0
            if cfg.layer_is_global_attn(i):
                return 0
            return cfg.sliding_window
    return 0


class DoolyProf:
    def __init__(self, db: LatencyDB, *, oracle: str = "cuda_events",
                 hardware: Optional[str] = None,
                 sweep: Optional[SweepConfig] = None,
                 validation: Optional[ValidationPolicy] = None,
                 device: Device = "cuda"):
        self.db = db
        self.oracle = oracle
        self.hardware = default_hardware() if hardware is None else hardware
        self.device = resolve_device(device)
        self.sweep = sweep or SweepConfig()
        self.validation = (ValidationPolicy() if validation is None
                           else validation)
        # measurements staged during the current profile_model, flushed in
        # one transaction per model; indexed for same-model dedup/replay
        self._pending_rows: List[Tuple] = []
        self._pending_sigs: Dict[str, Signature] = {}   # deduped by hash
        self._pending_index: Dict[str, Dict[Tuple, float]] = {}
        # parallel-sweep state (parent side): the pre-measured latency map
        # substituted for oracle calls, and per-entry signatures computed
        # during task building so the main pass doesn't re-lower them
        self._premeasured: Optional[Dict[Tuple[str, Tuple], float]] = None
        self._entry_sigs: Dict[int, Signature] = {}

    # ------------------------------------------------------------------

    def profile_model(self, cfg: ModelConfig, backend: str = "xla",
                      tp: int = 1, trace: Optional[ModelTrace] = None,
                      workers: int = 1,
                      entries: Optional[List] = None) -> ProfileReport:
        if workers > 1:
            # trace + resolve ONCE in the parent; workers get serialized
            # measurement tasks instead of re-tracing the model
            mt = trace or trace_model(cfg)
            if entries is None:
                entries = find_runnable_set(mt.trace, device=self.device)
            pre, sigs = self._parallel_premeasure(cfg, backend, workers,
                                                  entries)
            prev, prev_sigs = self._premeasured, self._entry_sigs
            self._premeasured, self._entry_sigs = pre, sigs
            try:
                return self.profile_model(cfg, backend, tp, mt,
                                          entries=entries)
            finally:
                self._premeasured, self._entry_sigs = prev, prev_sigs
        t0 = time.time()
        # discard any staging left by a previous profile_model that raised —
        # stale pending rows would corrupt this model's dedup accounting
        self._clear_pending()
        if entries is None:
            mt = trace or trace_model(cfg)
            entries = find_runnable_set(mt.trace, device=self.device)
        report = ProfileReport(model=cfg.name, backend=backend)
        report.trace_s = time.time() - t0
        config_id = self.db.config_id(cfg.name, backend, self.hardware, tp)

        counts: Dict[Tuple[str, str], int] = {}
        try:
            for entry in entries:
                if isinstance(entry, ModuleEntry) and entry.context_kind:
                    rep = self._profile_stateful(entry, cfg, backend,
                                                 config_id)
                elif isinstance(entry, OpEntry):
                    rep = self._profile_op(entry, cfg, backend, config_id)
                else:
                    continue    # absorbed non-stateful module: rare; skip
                if rep is not None:
                    report.entries.append(rep)
                    key = (rep.sig, _module_of(entry))
                    counts[key] = counts.get(key, 0) + entry.count
        except Exception as profile_err:
            # flush the measurements already paid for before propagating,
            # so a retry dedups against them instead of re-measuring.
            # Exception only: a KeyboardInterrupt must not commit a
            # partially-swept model that later runs treat as measured.
            try:
                self._flush(())
            except Exception:
                pass        # keep the original profiling error
            raise profile_err
        # aggregate duplicate (sig, module) pairs (e.g. q_proj & o_proj share
        # a signature inside the same canonical layer)
        self._flush([(config_id, sig, module, count)
                     for (sig, module), count in counts.items()])
        return report

    # -- parallel sweeps ------------------------------------------------

    def entry_specs(self, cfg: ModelConfig, backend: str,
                    entries: Optional[List] = None,
                    trace: Optional[ModelTrace] = None
                    ) -> List[Tuple[Any, EntrySpec]]:
        """The build half of the plan/execute split: resolve the runnable
        set (tracing if needed) and describe every profilable entry —
        signature, report metadata, picklable measurement payload, and the
        exact measurement-row count its sweep writes — WITHOUT measuring
        anything.  ``profile_model``'s parallel path, ``build_plan``, and
        the dry-run coverage report all consume this one serialization.

        Returns (entry, spec) pairs in runnable-set order; entries that
        ``profile_model`` would skip (absorbed non-stateful modules) are
        skipped here too."""
        if entries is None:
            mt = trace or trace_model(cfg)
            entries = find_runnable_set(mt.trace, device=self.device)
        specs: List[Tuple[Any, EntrySpec]] = []
        seen: set = set()
        for entry in entries:
            is_module = (isinstance(entry, ModuleEntry)
                         and entry.context_kind)
            if is_module:
                kind = entry.context_kind
                window = window_for_path(cfg, entry.node.path)
                ctx_pre = self._context(cfg, kind, "prefill", backend, window)
                sig = self._module_signature(entry, cfg, backend, window)
                group = ("attention" if "attn" in kind
                         or kind in ("mamba",) else kind)
                variant = self._variant(ctx_pre)
                n_points = sum(len(self._phase_points(ph))
                               for ph in phases_for(kind, cfg))
                payload = ("module", kind, window, sig.hash)
            elif isinstance(entry, OpEntry):
                sig = op_entry_signature(entry, self.device)
                kind, variant = entry.kind, ""
                group = "linear" if entry.kind in LINEAR_OPS else "other"
                n_points = (len(self.sweep.op_points) if entry.sweepable
                            else 1)
                payload = None      # detached lazily below (first sig only)
            else:
                continue
            if sig.hash in seen:
                payload = None      # duplicate signature: no task, no detach
            else:
                seen.add(sig.hash)
                if not is_module:
                    payload = ("op", sig.hash, detach_op_entry(entry))
            specs.append((entry, EntrySpec(
                sig=sig, name=kind, group=group, variant=variant,
                module=_module_of(entry), count=entry.count,
                n_points=n_points, payload=payload)))
        return specs

    def task_point_keys(self, payload: Tuple, cfg: ModelConfig
                        ) -> List[Tuple]:
        """The exact (phase, toks, reqs, ctx) measurement keys one task's
        sweep visits — shared by the dry-run accounting (row counts and
        replay-based cost estimates) and the execute path, so a plan's
        predicted DB writes match the realized ones row-for-row."""
        if payload[0] == "module":
            _, kind, _window, _ = payload
            return [(phase, toks, reqs, ctx)
                    for phase in phases_for(kind, cfg)
                    for toks, reqs, ctx in self._phase_points(phase)]
        entry = payload[2]
        points = (self.sweep.op_points if entry.sweepable else ((0, 0),))
        return [("prefill", toks, reqs, 0) for toks, reqs in points]

    def measure_payload_rows(self, payload: Tuple, cfg: ModelConfig,
                             backend: str) -> List[Tuple]:
        """Measure every sweep point of one task payload, returning full
        DB measurement rows (sig_hash, hardware, phase, toks, reqs, ctx,
        oracle, latency_us) — the execute half.  Identical unit handling
        to the serial ``profile_model`` pass (worker µs values are stored
        verbatim), so plan execution stays bit-identical to it."""
        rows: List[Tuple] = []
        if payload[0] == "module":
            _, kind, window, sig_hash = payload
            for phase in phases_for(kind, cfg):
                mc = self._context(cfg, kind, phase, backend, window)
                for toks, reqs, ctx in self._phase_points(phase):
                    lat_us = self._measure_module(mc, toks, reqs, ctx) * 1e6
                    rows.append((sig_hash, self.hardware, phase, toks, reqs,
                                 ctx, self.oracle, lat_us))
        else:
            _, sig_hash, entry = payload
            points = (self.sweep.op_points if entry.sweepable else ((0, 0),))
            for toks, reqs in points:
                lat_us = self._measure_op(entry, toks or None,
                                          reqs or None) * 1e6
                rows.append((sig_hash, self.hardware, "prefill", toks, reqs,
                             0, self.oracle, lat_us))
        return rows

    def _entry_tasks(self, cfg: ModelConfig, backend: str, entries: List
                     ) -> Tuple[List[Tuple], Dict[int, Signature]]:
        """Serialize the runnable set once: one picklable measurement task
        per distinct signature, plus the per-entry signatures (memoized so
        the parent's main pass reuses them instead of re-lowering)."""
        tasks: List[Tuple] = []
        sigs: Dict[int, Signature] = {}
        for entry, spec in self.entry_specs(cfg, backend, entries=entries):
            sigs[id(entry)] = spec.sig
            if spec.payload is not None:
                tasks.append(spec.payload)
        return tasks, sigs

    def _parallel_premeasure(self, cfg: ModelConfig, backend: str,
                             workers: int, entries: List
                             ) -> Tuple[Dict[Tuple[str, Tuple], float],
                                        Dict[int, Signature]]:
        """Fan the pre-traced measurement tasks out to ``workers``
        processes over disjoint signature shards (minus signatures the
        parent DB already knows); merge their rows into a {(sig_hash, key):
        latency_us} map the parent pass reads instead of measuring."""
        import multiprocessing as mp
        known = frozenset(self.db.measured_hashes(self.hardware))
        tasks, sigs = self._entry_tasks(cfg, backend, entries)
        shards: List[List[Tuple]] = [[] for _ in range(workers)]
        for task in tasks:
            sig_hash = task[3] if task[0] == "module" else task[1]
            if sig_hash in known:
                continue
            shards[int(sig_hash, 16) % workers].append(task)
        payloads = [(cfg, backend, self.oracle, self.hardware, self.sweep,
                     str(self.device), shard) for shard in shards if shard]
        pre: Dict[Tuple[str, Tuple], float] = {}
        if payloads:
            # spawn, not fork: the parent may hold a CUDA context, and each
            # worker opens its own
            with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=mp.get_context("spawn")) as ex:
                for rows in ex.map(_measure_task_shard, payloads):
                    for sig, phase, toks, reqs, ctx, lat_us in rows:
                        pre[(sig, (phase, toks, reqs, ctx))] = lat_us
        return pre, sigs

    def _premeasured_us(self, sig_hash: str, key: Tuple) -> Optional[float]:
        if self._premeasured is None:
            return None
        return self._premeasured.get((sig_hash, key))

    # -- staged writes --------------------------------------------------

    def _flush(self, op_rows):
        # one transaction per model: signatures, measurements, and the
        # call-graph counts land with a single commit
        with self.db.transaction():
            self.db.insert_signatures_bulk(self._pending_sigs.values())
            self.db.add_measurements_bulk(self._pending_rows)
            if op_rows:
                self.db.add_model_operations_bulk(op_rows)
        self._clear_pending()

    def _clear_pending(self):
        self._pending_rows.clear()
        self._pending_sigs.clear()
        self._pending_index.clear()

    def _record_sig(self, sig: Signature):
        self._pending_sigs[sig.hash] = sig

    def _record_measurement(self, sig_hash: str, key: Tuple,
                            latency_us: float):
        self._pending_rows.append(
            (sig_hash, self.hardware) + key + (self.oracle, latency_us))
        self._pending_index.setdefault(sig_hash, {})[key] = latency_us

    def _known(self, sig_hash: str) -> bool:
        """Dedup check, including measurements staged for this model."""
        return (sig_hash in self._pending_index
                or self.db.has_signature(sig_hash, self.hardware))

    # ------------------------------------------------------------------

    def _profile_op(self, entry: OpEntry, cfg, backend, config_id
                    ) -> Optional[EntryReport]:
        sig = (self._entry_sigs.get(id(entry))
               or op_entry_signature(entry, self.device))
        self._record_sig(sig)
        group = "linear" if entry.kind in LINEAR_OPS else "other"
        reused = self._known(sig.hash)
        points = (self.sweep.op_points if entry.sweepable
                  else ((0, 0),))
        cost = 0.0
        for toks, reqs in points:
            key = ("prefill", toks, reqs, 0)
            if reused:
                lat = self._replay(sig.hash, key)
            else:
                # store the worker's exact µs value: no unit round-trip,
                # so parallel rows are bit-identical to a serial sweep
                lat_us = self._premeasured_us(sig.hash, key)
                if lat_us is None:
                    lat_us = self._measure_op(
                        entry, toks or None, reqs or None) * 1e6
                self._record_measurement(sig.hash, key, lat_us)
                lat = lat_us / 1e6
            cost += lat * self.sweep.repeats
        return EntryReport(sig.hash, entry.kind, group, "", entry.count,
                           reused, cost)

    def _profile_stateful(self, entry: ModuleEntry, cfg, backend, config_id
                          ) -> Optional[EntryReport]:
        window = window_for_path(cfg, entry.node.path)
        ctx_pre = self._context(cfg, entry.context_kind, "prefill", backend,
                                window)
        sig = (self._entry_sigs.get(id(entry))
               or self._module_signature(entry, cfg, backend, window))
        self._record_sig(sig)
        reused = self._known(sig.hash)
        variant = self._variant(ctx_pre)
        cost = 0.0
        for phase in phases_for(entry.context_kind, cfg):
            mc = ctx_pre if phase == "prefill" else self._context(
                cfg, entry.context_kind, "decode", backend, window)
            for toks, reqs, ctx in self._phase_points(phase):
                key = (phase, toks, reqs, ctx)
                if reused:
                    lat = self._replay(sig.hash, key)
                else:
                    lat_us = self._premeasured_us(sig.hash, key)
                    if lat_us is None:
                        lat_us = self._measure_module(
                            mc, toks, reqs, ctx) * 1e6
                    self._record_measurement(sig.hash, key, lat_us)
                    lat = lat_us / 1e6
                cost += lat * self.sweep.repeats
        return EntryReport(sig.hash, entry.context_kind, "attention"
                           if "attn" in entry.context_kind
                           or entry.context_kind in ("mamba",)
                           else entry.context_kind, variant, entry.count,
                           reused, cost)

    # ------------------------------------------------------------------

    def _phase_points(self, phase: str):
        s = self.sweep
        if phase == "prefill":
            # ctx sweep covers chunked prefill against a part-filled cache
            return [(t, r, c) for t in s.toks for r in s.reqs
                    for c in (0,) + s.ctx]
        return [(1, r, c) for c in s.ctx for r in s.reqs]

    def _variant(self, mc: ModuleContext) -> str:
        a = mc.static_attrs
        if mc.kind in ("self_attn", "cross_attn"):
            v = f"{a['n_heads']}/{a['n_kv_heads']}/{a['head_dim']}"
            w = a.get("window", 0)
            if w:
                v += f" window={w // 1024}K" if w >= 1024 else f" window={w}"
            return v
        if mc.kind == "mla_attn":
            return (f"mla r{a['kv_lora_rank']} "
                    f"{a['n_heads']}x{a['qk_nope']}+{a['qk_rope']}")
        if mc.kind == "mamba":
            return f"di={a['d_inner']} n={a['state']}"
        if mc.kind == "moe":
            return f"{a['n_experts']}e top{a['top_k']} ff={a['moe_d_ff']}"
        return ""

    def _context(self, cfg: ModelConfig, kind: str, phase: str,
                 backend: str, window: int) -> ModuleContext:
        return cached_build_context(cfg, kind, phase=phase, backend=backend,
                                    window=window, device=self.device)

    def _module_signature(self, entry: ModuleEntry, cfg: ModelConfig,
                          backend: str, window: int) -> Signature:
        """The prefill context's signature, its fingerprint taken over
        every phase the entry is profiled in (prefill first)."""
        return module_entry_signature(entry, *(
            self._context(cfg, entry.context_kind, phase, backend, window)
            for phase in phases_for(entry.context_kind, cfg)))

    def _measure_op(self, entry: OpEntry, toks, reqs) -> float:
        device = "meta" if self.oracle == ANALYTICAL else self.device
        fn, args = entry.callable(toks=toks, reqs=reqs, device=device)
        return self.validation.check(
            lambda: oracles.measure(self.oracle, fn, args),
            f"op {entry.kind} toks={toks} reqs={reqs}")

    def _measure_module(self, mc: ModuleContext, toks, reqs, ctx) -> float:
        """One point of a module context: the engine's module and inputs
        made on the profiler's device (on the meta device through the plain
        path for the analytical oracle), then timed or counted."""
        if self.oracle == ANALYTICAL:
            mc = cached_build_context(mc.cfg, mc.kind, phase=mc.phase,
                                      backend="xla",
                                      window=mc.static_attrs["window"],
                                      device="meta")
        args = mc.abstract_inputs(max(toks, 1), max(reqs, 1), max(ctx, 1))
        full_lengths = (self.oracle == "cuda_events"
                        and mc.kind == "self_attn" and mc.phase == "decode")

        def bind(specs):
            gen = (None if mc.device.type == "meta" else
                   torch.Generator(device=mc.device).manual_seed(0))
            module = mc.module(mc.materialize(mc.params, gen))
            inputs = mc.materialize(specs, gen)
            if full_lengths:
                # the point stands for a cache full up to ctx; lengths of 0
                # would time one key under the split-KV kernel
                inputs[-1].fill_(max(ctx, 1) - 1)
            return (module,) + tuple(inputs)
        return self.validation.check(
            lambda: oracles.measure(self.oracle, mc.fn, args,
                                    materialize=bind),
            f"module {mc.kind} toks={toks} reqs={reqs} ctx={ctx}")

    def _replay(self, sig_hash: str, key) -> float:
        pending = self._pending_index.get(sig_hash)
        if pending is not None and key in pending:
            return pending[key] / 1e6
        stored = self.db.measurement_map(sig_hash, self.hardware)
        lat = stored.get(key)
        if lat is not None:
            return lat / 1e6
        points = dict(stored)
        if pending:
            points.update(pending)
        return self._replay_nearest(points, key)

    # ------------------------------------------------------------------

    @staticmethod
    def _replay_nearest(points: Dict[Tuple, float], key) -> float:
        """Exact sweep point missing: nearest point by total token count,
        scaled — the exact fallback LatencyModel uses."""
        _, toks, reqs, _ = key
        return nearest_point_scale(
            ((t, r, lat) for (_, t, r, _), lat in points.items()),
            toks, reqs)
