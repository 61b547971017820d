"""`ProfileStore`: one session object that owns the profiling state.

Counterpart of ``repro.api.store``.  The store profiles on its ``device``
(the card unless the caller passes ``device="cpu"``) with the
``cuda_events`` oracle and the card's hardware tag by default; without a
card those defaults raise.  ``sweep()`` and ``optimize()`` bind the
configuration-search consumers (``repro_torch.sweep``,
``repro_torch.optimize``) to the store, as the reference's do.

Before this facade existed, a caller had to wire `LatencyDB`,
`DoolyProf`, `LatencyModel.shared`, `DoolySim`, and `repro_torch.sweep`
by hand in the right order; the per-(db, hardware) fit cache hid inside
`LatencyModel.shared` with no owner and no lifecycle.  `ProfileStore`
collects all of it behind one handle:

* **lifecycle** — ``open()``/``close()`` (idempotent) or a context
  manager; closing tears down the DB connection *and* the fit cache, so a
  reopened store can never serve fits bound to a dead connection;
* **profiling** — plan-first: ``plan(cfgs, ...)`` builds a corpus-wide
  deduplicated :class:`~repro_torch.core.plan.ProfilePlan` (a dry run with a
  coverage report — the paper's redundancy metric), ``execute(plan, ...)``
  measures it resumably; ``ensure_profiled(cfg, ...)`` is the one-model
  plan+execute shim (rows bit-identical to the old direct
  ``profile_model`` path);
* **fit cache** — ``model(hardware)`` returns the shared per-hardware
  `LatencyModel`, owned here; generation-checked invalidation
  (``LatencyModel.refresh``) keeps it coherent with measurement writes;
* **backends** — ``backend(name, cfg, ...)`` constructs any registered
  :class:`~repro_torch.api.backends.LatencyBackend` against this store, and
  ``simulator(...)``/``sweep(...)`` build the consumer layers on top.

Typical session::

    with ProfileStore("latency.sqlite") as store:       # on the card
        store.ensure_profiled(cfg)
        be = store.backend("dooly", cfg, sched_config=sched, max_seq=128)
        sim = store.simulator(cfg, sched_config=sched, max_seq=128)
        result = sim.run(requests)
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.database import LatencyDB
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.plan import (ExecuteReport, ProfilePlan,
                                   ShardMergeReport, build_plan, execute_plan,
                                   merge_shards, shard_plan)
from repro_torch.core.profiler import DoolyProf, ProfileReport, SweepConfig
from repro_torch.parallel.roofline import default_hardware


class ProfileStore:
    """Session facade over one latency database.

    ``hardware`` and ``oracle`` are session defaults — every method that
    takes them accepts an override; ``hardware=None`` is the card's tag.
    A store constructed with ``db=`` wraps an existing (caller-owned)
    connection and will not close it.
    """

    def __init__(self, path: str = ":memory:", *,
                 hardware: Optional[str] = None,
                 oracle: str = "cuda_events",
                 sweep: Optional[SweepConfig] = None,
                 wal: bool = True,
                 db: Optional[LatencyDB] = None,
                 device: Device = "cuda"):
        self.path = path
        self.hardware = default_hardware() if hardware is None else hardware
        self.oracle = oracle
        self.device = resolve_device(device)
        self.profile_sweep = sweep
        self.wal = wal
        self._db: Optional[LatencyDB] = db
        self._owns_db = db is None
        self._models: Dict[Tuple[str, bool], LatencyModel] = {}
        if self._owns_db:
            self.open()

    @classmethod
    def wrap(cls, db: LatencyDB, *, hardware: Optional[str] = None,
             oracle: str = "cuda_events",
             sweep: Optional[SweepConfig] = None,
             device: Device = "cuda") -> "ProfileStore":
        """Adopt an existing LatencyDB without taking ownership (the
        store's ``close`` leaves it open)."""
        return cls(hardware=hardware, oracle=oracle, sweep=sweep, db=db,
                   device=device)

    # -- lifecycle -----------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._db is None or self._db.conn is None

    @property
    def db(self) -> LatencyDB:
        if self.closed:
            raise RuntimeError("ProfileStore is closed (use open() or a "
                               "fresh context manager)")
        return self._db

    def open(self) -> "ProfileStore":
        """Open (or reopen) the underlying database.  Idempotent."""
        if self.closed:
            if not self._owns_db:
                raise RuntimeError("cannot reopen a wrapped LatencyDB; "
                                   "the owner must reopen it")
            self._db = LatencyDB(self.path, wal=self.wal)
        return self

    def close(self):
        """Close the DB (if owned) and drop the fit cache.  The cache
        eviction is load-bearing: cached LatencyModels hold the dead
        connection, and the old ``LatencyModel.shared`` pattern had no
        owner to do this."""
        self._models.clear()
        if self._db is not None and self._owns_db:
            self._db.close()
            self._db = None

    def __enter__(self) -> "ProfileStore":
        return self.open()

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- profiling -----------------------------------------------------

    def profiler(self, *, hardware: Optional[str] = None,
                 oracle: Optional[str] = None,
                 sweep: Optional[SweepConfig] = None) -> DoolyProf:
        return DoolyProf(self.db, oracle=oracle or self.oracle,
                         hardware=hardware or self.hardware,
                         sweep=sweep or self.profile_sweep,
                         device=self.device)

    def profile_comm(self, **kw) -> int:
        """Fill the communication sub-schema (see
        ``DoolyProf.profile_comm``); returns the row count."""
        return self.profiler().profile_comm(**kw)

    def is_profiled(self, cfg: ModelConfig, *, backend: str = "xla",
                    tp: int = 1, hardware: Optional[str] = None) -> bool:
        cid = self.db.config_id(cfg.name, backend,
                                hardware or self.hardware, tp)
        return bool(self.db.model_operations(cid))

    def plan(self, cfgs: Union[ModelConfig, Sequence[ModelConfig]], *,
             backends: Sequence[str] = ("xla",), tp: int = 1,
             hardware: Optional[str] = None, oracle: Optional[str] = None,
             sweep: Optional[SweepConfig] = None,
             traces=None, pairs=None) -> ProfilePlan:
        """Build a corpus-wide deduplicated :class:`ProfilePlan` for the
        given model configs x ``backends`` (or an explicit ``pairs``
        sequence of (cfg, backend) for ragged corpora): a dry run (zero
        measurements) whose ``coverage()`` reports per-model op counts,
        tasks already satisfied by this store, tasks shared between
        models, and the estimated GPU-time saved vs naive per-model
        profiling."""
        if isinstance(cfgs, ModelConfig):
            cfgs = [cfgs]
        return build_plan(self.db, list(cfgs), backends=tuple(backends),
                          tp=tp, hardware=hardware or self.hardware,
                          oracle=oracle or self.oracle,
                          sweep=sweep or self.profile_sweep, traces=traces,
                          pairs=pairs, device=self.device)

    def execute(self, plan: ProfilePlan, *, workers: int = 1,
                checkpoint: Optional[str] = None, progress=None,
                task_timeout: Optional[float] = None,
                max_retries: int = 2,
                fail_fast: bool = False) -> ExecuteReport:
        """Measure a plan's remaining tasks into this store.  Rows are
        bit-identical to sequential per-model ``profile_model`` calls
        over the same corpus; with ``checkpoint`` each completed task id
        is journaled after its rows commit, so an interrupted execute
        resumes instead of restarting.  Execution is supervised: failed
        or hung (``task_timeout``) measurements retry up to
        ``max_retries`` times, then quarantine (or raise, with
        ``fail_fast``) — see :func:`repro_torch.api.execute_plan`.  On a
        card the workers take turns on it, and ``task_timeout`` counts
        from the moment a task takes the card, after a wait for it of at
        most 4 × ``workers`` × ``task_timeout``."""
        return execute_plan(self.db, plan, workers=workers,
                            checkpoint=checkpoint, progress=progress,
                            task_timeout=task_timeout,
                            max_retries=max_retries, fail_fast=fail_fast)

    def shard(self, plan: ProfilePlan, n: int) -> Tuple[ProfilePlan, ...]:
        """Split ``plan`` into up to ``n`` content-addressed sub-plans
        balanced by estimated cost, each independently executable against
        its own scratch store/journal — the distributed-profiling seam
        (see :func:`repro_torch.core.plan.shard_plan`).  Sharding depends only
        on plan content, so rebuilding and re-sharding after a partial
        execution yields identical shards."""
        return shard_plan(plan, n)

    def merge(self, plan: ProfilePlan, *, dbs: Sequence = (),
              journals: Sequence[str] = (),
              checkpoint: Optional[str] = None,
              on_conflict: str = "error") -> ShardMergeReport:
        """Fold shard scratch databases and/or journals back into this
        store with exact point accounting, then land the plan's
        call-graph rows (see :func:`repro_torch.core.plan.merge_shards`).
        Idempotent: re-merging already-landed shards skips their rows."""
        return merge_shards(self.db, plan, dbs=dbs, journals=journals,
                            checkpoint=checkpoint, on_conflict=on_conflict)

    def ensure_profiled(self, cfg: ModelConfig, *, backend: str = "xla",
                        tp: int = 1, hardware: Optional[str] = None,
                        oracle: Optional[str] = None,
                        sweep: Optional[SweepConfig] = None,
                        workers: int = 1,
                        force: bool = False) -> Optional[ProfileReport]:
        """Profile ``cfg`` into the store unless its call graph is already
        present (dedup against prior sessions comes free from the DB);
        returns the report, or None when nothing needed doing.

        This is the one-model plan+execute shim: it builds a single-model
        :class:`ProfilePlan`, executes it, and reconstructs the legacy
        report — rows and report costs bit-identical to the old direct
        ``profile_model`` path."""
        if not force and self.is_profiled(cfg, backend=backend, tp=tp,
                                          hardware=hardware):
            return None
        plan = self.plan(cfg, backends=(backend,), tp=tp,
                         hardware=hardware, oracle=oracle, sweep=sweep)
        self.execute(plan, workers=workers)
        return plan.legacy_report(self.db)

    # -- fit cache -----------------------------------------------------

    def model(self, hardware: Optional[str] = None, *,
              use_saved_fits: bool = True) -> LatencyModel:
        """The shared per-(store, hardware) LatencyModel — each persisted
        fit is loaded/decoded once per store session no matter how many
        simulators or sweep scenarios consume it.  Replaces the removed
        ``LatencyModel.shared``, whose cache had no owner."""
        hw = hardware or self.hardware
        key = (hw, use_saved_fits)
        lm = self._models.get(key)
        if lm is None:
            lm = self._models[key] = LatencyModel(
                self.db, hw, use_saved_fits=use_saved_fits)
        return lm

    # -- consumers -----------------------------------------------------

    def backend(self, name: str, cfg: ModelConfig, *, sched_config,
                max_seq: int, backend: str = "xla", tp: int = 1,
                hardware: Optional[str] = None,
                use_saved_fits: bool = True, **kw):
        """Construct a registered :class:`LatencyBackend` against this
        store (fit-backed backends share ``self.model(hardware)``)."""
        from repro_torch.api.backends import make_backend
        hw = hardware or self.hardware
        return make_backend(name, cfg, self.db, hardware=hw,
                            backend=backend, sched_config=sched_config,
                            max_seq=max_seq, tp=tp,
                            lm=self.model(hw, use_saved_fits=use_saved_fits),
                            **kw)

    def simulator(self, cfg: ModelConfig, *, sched_config, max_seq: int,
                  backend: str = "xla", tp: int = 1,
                  hardware: Optional[str] = None,
                  latency: str = "dooly", engine: str = "auto", **kw):
        """A DoolySim whose latency source is the named backend.

        ``engine`` is the default scheduling tier for ``run`` —
        ``"auto"`` routes latency-independent workloads through exact
        replay and staggered arrivals through the event-driven engine;
        ``"replay"`` / ``"events"`` / ``"loop"`` pin a tier."""
        from repro_torch.sim.simulator import DoolySim
        return DoolySim(
            cfg, sched_config=sched_config, max_seq=max_seq,
            engine=engine,
            latency=self.backend(latency, cfg, sched_config=sched_config,
                                 max_seq=max_seq, backend=backend, tp=tp,
                                 hardware=hardware, **kw))

    def sweep(self, **kw):
        """A :class:`repro_torch.sweep.Sweep` bound to this store."""
        from repro_torch.sweep.runner import Sweep
        return Sweep(self, **kw)

    def optimize(self, spec, *, workers: int = 1,
                 oversubscribe: bool = False, profile: bool = True,
                 quiet: bool = True, **kw):
        """Run the staged SLO-driven capacity search for ``spec`` (an
        :class:`repro_torch.optimize.OptimizeSpec`) and return the resulting
        :class:`repro_torch.optimize.CapacityPlan`.

        Extra keyword arguments configure the underlying
        :class:`repro_torch.optimize.Optimizer` (``latency=``,
        ``analytic_latency=``, ``engine=``, ``hw_cost=`` ...)."""
        from repro_torch.optimize.search import Optimizer
        return Optimizer(self, **kw).run(
            spec, workers=workers, oversubscribe=oversubscribe,
            profile=profile, quiet=quiet)

    def stats(self) -> Dict[str, int]:
        return self.db.stats()

    def __repr__(self) -> str:
        state = "closed" if self.closed else "open"
        return (f"ProfileStore({self.path!r}, hardware={self.hardware!r}, "
                f"oracle={self.oracle!r}, {state})")
