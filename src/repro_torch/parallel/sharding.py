"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh``.

Counterpart of ``repro.parallel.sharding``.  Model code annotates tensors
with *logical* axis names; a rules table maps logical names to mesh axes.
Outside a mesh context, and on a plain tensor, annotations are no-ops, so
the same model code runs on one card and, as DTensors, on a 512-rank mesh.

Training uses FSDP+TP: parameters are sharded over the ("pod","data") axes
(ZeRO-3) *and* the "model" axis (tensor parallel).  Serving shards batch over
("pod","data") and heads/experts over "model".

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dim: ``None``, a mesh-axis name, or a tuple of names, major to minor.
``placements_for`` turns it into DTensor placements.

Tensors the model makes itself (positions, rotary tables, masks, zero
caches) stay plain.  ``use_mesh`` runs its body inside DTensor's
``implicit_replication()``, so under a mesh a plain tensor meets a DTensor
as a replicated one; no model code makes DTensors of its own.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisName, ...]

# logical axis -> mesh axes, per regime.  'fsdp' means ("pod","data") when a
# pod axis exists, else ("data",).
TRAIN_RULES: Dict[str, str] = {
    # activations
    "batch": "fsdp",
    "seq": None,
    "seq_model": "model",    # context-parallel fallback (heads % tp != 0)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "q_proj": "model",       # fused head*dim projection dim
    "kv_proj": "model",
    "ff": "model",
    "moe_ff": "model",
    "vocab": "model",
    "experts": "fsdp",       # expert dim of MoE weights (EP over fsdp axes)
    "expert_groups": "fsdp", # dispatched token groups
    # weights: second weight axis sharded over fsdp for ZeRO-3
    "embed_fsdp": "fsdp",
    "layers": None,
    "conv": None,
    "state": None,
    "latent": None,
}

SERVE_RULES: Dict[str, str] = dict(TRAIN_RULES)
SERVE_RULES.update({
    "batch": "fsdp",
    "embed_fsdp": None,      # weights replicated over data axes when serving
    "experts": "fsdp",       # EP: experts spread over the data axis (llama4
                             # 400B does not fit with model-axis-only sharding)
    "expert_groups": None,
    "cache_seq": "model",    # KV caches sequence-sharded over the model axis
})


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, str] = {}


_CTX = _Ctx()


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh-axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axes(mesh, logical: str, rules: Dict[str, str]) -> AxisName:
    target = rules.get(logical, None)
    if target is None:
        return None
    names = mesh.mesh_dim_names
    if target == "fsdp":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes or None
    return target if target in names else None


def spec_for(names: Sequence[Optional[str]], mesh=None,
             rules: Optional[Dict[str, str]] = None,
             dims: Optional[Sequence[int]] = None) -> Spec:
    """Spec for a tensor whose dims have the given logical names.

    If ``dims`` is given, a mesh-axis assignment that does not evenly divide
    the dim is dropped (e.g. batch=1 on a 16-way data axis -> replicated).
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return (None,) * len(names)
    shape = mesh_sizes(mesh)
    used = set()
    out: List[AxisName] = []
    for i, n in enumerate(names):
        ax = _mesh_axes(mesh, n, rules) if n else None
        if ax is not None:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a not in used)
            if dims is not None and axes:
                size = 1
                for a in axes:
                    size *= shape[a]
                # drop trailing axes until divisible
                while axes and dims[i] % size != 0:
                    size //= shape[axes[-1]]
                    axes = axes[:-1]
            used.update(axes)
            ax = axes if len(axes) > 1 else (axes[0] if axes else None)
        out.append(ax)
    return tuple(out)


def placements_for(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d is sharded over that mesh axis, else
    ``Replicate()``.  A dim sharded over several axes gets one ``Shard`` on
    each, in mesh order, as a PartitionSpec shards major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape`` (every sharded dim
        divides evenly when the spec came from ``spec_for`` with dims)."""
        sizes = mesh_sizes(self.mesh)
        out = list(shape)
        for d, ax in enumerate(self.spec):
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                out[d] = -(-out[d] // sizes[a])
        return tuple(out)


def sharding_for(names: Sequence[Optional[str]],
                 dims: Optional[Sequence[int]] = None
                 ) -> Optional[NamedSharding]:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(names, dims=dims))


def constrain(x, *names: Optional[str]):
    """Redistribute a DTensor to the placements its logical names give on
    the current mesh (the reference's ``with_sharding_constraint``); a no-op
    outside a mesh and on a plain tensor, so it launches nothing on the
    card's paths and never reaches a CUDA-graph capture with a DTensor."""
    mesh = _CTX.mesh
    if mesh is None or not _is_dtensor(x):
        return x
    placements = placements_for(spec_for(names, dims=x.shape), mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def gathered(w, axes: Sequence[Optional[str]]):
    """A weight as a product uses it: gathered over the data axes its
    ``embed_fsdp`` dim is sharded on (ZeRO-3), still sharded over
    ``model``.  XLA gathers it so because the activations it meets are
    sharded over the same axes by batch; DTensor would rather move the
    activations.  Its backward reduce-scatters the gradient back onto the
    shard.  A no-op wherever ``constrain`` is one, and when serving."""
    return constrain(w, *(None if a == "embed_fsdp" else a for a in axes))


def local_offset(x) -> tuple:
    """The global index of the first element of this device's shard of the
    DTensor ``x`` (evenly sharded, as ``spec_for`` lays tensors out)."""
    coord = x.device_mesh.get_coordinate()
    sizes = x.device_mesh.shape
    chunk, off = list(x.shape), [0] * x.dim()
    for i, p in enumerate(x.placements):
        if p.is_shard():
            chunk[p.dim] //= sizes[i]
            off[p.dim] += coord[i] * chunk[p.dim]
    return tuple(off)


def local_like(t, mesh, placements, varies=()) -> torch.Tensor:
    """This device's shard of ``t`` laid out by ``placements`` (a plain
    tensor is taken as replicated).  ``varies``: mesh dims over which the
    shard is replicated but what the caller computes from it differs from
    device to device; its gradient is the sum over them."""
    from torch.distributed.tensor import DTensor, Replicate
    if not _is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    elif t.device_mesh is not mesh:
        # an equal mesh of an earlier process group (DTensor's sharding
        # cache hands back the spec, mesh and all, that it first saw for a
        # shape, as a ``Parameter``'s detach does): collectives run on the
        # live one
        t = from_local(t.to_local(), mesh, t.placements, tuple(t.shape))
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements(placements, varies))


def grad_placements(placements, varies=()) -> list:
    """``placements`` with the replicated mesh dims in ``varies`` made
    partial: the layout of the gradient of a shard that each device of
    those dims uses differently."""
    from torch.distributed.tensor import Partial
    return [Partial() if i in varies and p.is_replicate() else p
            for i, p in enumerate(placements)]


def from_local(t: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` whose shard here is ``t``."""
    from torch.distributed.tensor import DTensor
    t = t.contiguous()
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=tuple(shape), stride=tuple(reversed(strides)))


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def use_mesh(mesh, rules: Dict[str, str]):
    """Make ``mesh`` and ``rules`` current; inside, plain tensors meet
    DTensors as replicated ones (``implicit_replication``)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules)
    try:
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def override_rule(logical: str, target: Optional[str]):
    """Point a logical axis at a different mesh axis (perf hillclimbing knob)."""
    _CTX.rules[logical] = target
