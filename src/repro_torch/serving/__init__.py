"""Serving substrate: scheduler, engine and execution contexts."""
from repro_torch.serving.context import (ModuleContext, TensorSpec, build_context,
                                        cached_build_context, phases_for)
from repro_torch.serving.engine import Engine, IterationRecord, bucket_chunk
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["ModuleContext", "TensorSpec", "build_context", "cached_build_context",
           "phases_for", "Engine",
           "IterationRecord", "bucket_chunk", "Request", "Scheduler",
           "SchedulerConfig"]
