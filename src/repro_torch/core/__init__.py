"""Device selection and measurement oracles of the port."""
from repro_torch.core.backends import cpu_wallclock, cuda_events
from repro_torch.core.device import resolve_device, synchronize

__all__ = ["cpu_wallclock", "cuda_events", "resolve_device", "synchronize"]
