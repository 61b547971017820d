"""Device selection and measurement oracles of the port."""
from repro_torch.core.backends import (ORACLES, cpu_wallclock, cuda_events,
                                       h100_analytical, measure)
from repro_torch.core.device import resolve_device, synchronize

__all__ = ["ORACLES", "cpu_wallclock", "cuda_events", "h100_analytical",
           "measure", "resolve_device", "synchronize"]
