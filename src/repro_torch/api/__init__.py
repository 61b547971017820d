"""`repro_torch.api` — the port's public surface for the profile ->
predict -> simulate loop, the counterpart of ``repro.api``:

    from repro_torch.api import ProfileStore

    with ProfileStore("latency.sqlite") as store:       # on the card
        plan = store.plan(corpus_cfgs, backends=("kernel",))  # dry run
        print(plan.coverage().table())                  # paper Table 2
        store.execute(plan, checkpoint="plan.journal")  # resumable
        sim = store.simulator(cfg, sched_config=sched, max_seq=2048,
                              backend="kernel")
        print(sim.run(requests)["makespan"])

The latency source is a constructor argument: any registered
:class:`LatencyBackend` (``"dooly"`` regression fits, ``"roofline"``
analytic, ``"oracle"`` raw-measurement replay) drops into `DoolySim`.
`DoolySim` and the workload helpers are re-exported lazily (PEP 562), as
the reference does.  The reference's ``sweep`` and ``optimize`` surfaces
come with the port's ``sweep/`` and ``optimize/``.
"""
from repro_torch.api.backends import (DoolyBackend,  # noqa: F401
                                      FallbackBackend, LatencyBackend,
                                      OracleBackend, PlanBackend,
                                      RooflineBackend, available_backends,
                                      make_backend, make_fallback_backend,
                                      register_backend)
from repro_torch.api.store import ProfileStore  # noqa: F401
from repro_torch.core.plan import (CoverageReport,  # noqa: F401
                                   ExecuteReport, PlanTask, ProfilePlan,
                                   ShardMergeReport, build_plan, execute_plan,
                                   merge_shards, shard_plan)

__all__ = [
    # session + profiling
    "ProfileStore",
    # the profiling-plan IR (plan-first surface)
    "ProfilePlan", "PlanTask", "CoverageReport", "ExecuteReport",
    "build_plan", "execute_plan",
    # distributed profiling (shard -> execute -> merge)
    "shard_plan", "merge_shards", "ShardMergeReport",
    # the latency seam
    "LatencyBackend", "PlanBackend",
    "DoolyBackend", "RooflineBackend", "OracleBackend",
    "FallbackBackend",
    "register_backend", "make_backend", "make_fallback_backend",
    "available_backends",
    # consumer layers (lazy re-exports)
    "DoolySim", "predict_scenarios",
    "latency_dependence", "recommend_engine", "run_events",
    "StaggeredTrace",
    # workload subsystem (trace ingestion / sessions / traffic shapes)
    "TraceRow", "TraceError", "load_trace", "save_trace", "trace_key",
    "time_warp", "resample_trace", "truncate_trace",
    "to_requests", "synthetic_sessions",
    "ShapeSpec", "parse_shape", "shaped_arrivals", "warp_times",
]

_LAZY = {
    "DoolySim": ("repro_torch.sim.simulator", "DoolySim"),
    "predict_scenarios": ("repro_torch.sim.simulator", "predict_scenarios"),
    "latency_dependence": ("repro_torch.sim.replay", "latency_dependence"),
    "recommend_engine": ("repro_torch.sim.events", "recommend_engine"),
    "run_events": ("repro_torch.sim.events", "run_events"),
    "StaggeredTrace": ("repro_torch.sim.events", "StaggeredTrace"),
    "TraceRow": ("repro_torch.workload", "TraceRow"),
    "TraceError": ("repro_torch.workload", "TraceError"),
    "load_trace": ("repro_torch.workload", "load_trace"),
    "save_trace": ("repro_torch.workload", "save_trace"),
    "trace_key": ("repro_torch.workload", "trace_key"),
    "time_warp": ("repro_torch.workload", "time_warp"),
    "resample_trace": ("repro_torch.workload", "resample_trace"),
    "truncate_trace": ("repro_torch.workload", "truncate_trace"),
    "to_requests": ("repro_torch.workload", "to_requests"),
    "synthetic_sessions": ("repro_torch.workload", "synthetic_sessions"),
    "ShapeSpec": ("repro_torch.workload", "ShapeSpec"),
    "parse_shape": ("repro_torch.workload", "parse_shape"),
    "shaped_arrivals": ("repro_torch.workload", "shaped_arrivals"),
    "warp_times": ("repro_torch.workload", "warp_times"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(target[0]), target[1])


def __dir__():
    return sorted(set(globals()) | set(__all__))
