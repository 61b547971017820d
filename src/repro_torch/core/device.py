"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and run on the card unless the
caller asks for the CPU.  A CUDA device that is not there is an error, never
a silent move to the CPU.
"""
from __future__ import annotations

import functools
from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, asked once per device: the
    kernels size their grids by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
