"""Production meshes.

Counterpart of ``repro.launch.mesh``.  Functions (not module-level
constants) so importing never starts a process group: the production meshes
need a world of 256 or 512 ranks, which only the dry run sets up
(``launch.dryrun.fake_world``, a ``fake``-backend group on one process);
``make_host_mesh`` spans the GPUs of a group the caller started.
"""
from __future__ import annotations

import math

import torch


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def _device_type() -> str:
    import torch.distributed as dist
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks (16x16, data x model).
    Multi-pod: 2 pods = 512 ranks (2x16x16, pod x data x model)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} "
            f"(dry-run must start a fake process group of {n} ranks, as "
            "repro_torch.launch.dryrun.fake_world does, before building it)")
    if have != n:
        raise RuntimeError(f"mesh {shape} spans the whole default group; "
                           f"the group has {have} ranks")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """The GPUs of this host, (n // model_axis, model_axis) as (data,
    model), over the default process group, which the caller starts with
    one rank per GPU (``device_type="cpu"``: one rank per process, for
    runs without a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world_size()
    if n == 0:
        raise RuntimeError("make_host_mesh needs a process group (one rank "
                           "per GPU of this host)")
    if device_type == "cuda" and n != torch.cuda.device_count():
        raise RuntimeError(f"the process group has {n} ranks and this host "
                           f"{torch.cuda.device_count()} GPUs")
    assert n % model_axis == 0
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
