"""Operation Set Finder (paper §5): bottom-up resolution of the tainted
trace into the minimal runnable set.

Counterpart of ``repro.core.opset``.

* Leaf operations are tested for standalone execution by re-running their
  aten overload on taint-generated inputs ("import and run", §5.2).
* Stateful modules (attention, Mamba, MoE — identified by the serving
  engine's stateful-module registry, the vLLM AttentionGroup analogue) are
  resolved at module granularity with *execution context emulation*: the
  profiler rebuilds them through the serving engine's own contexts,
  which also supply the decode-phase context (KV cache, lengths) that the
  prefill trace alone cannot provide (App. D).
* Leaves that fail standalone execution are absorbed into their enclosing
  module, which re-runs as an ``nn.Module`` on generated inputs, the
  paper's fallback.

Taint-driven input generation (§5.2): MODEL_CONFIG dims stay fixed,
NUM_TOKS / NUM_REQS dims are substituted per sweep point, MIX dims are
recalculated from H with the workload component replaced, untainted dims
are kept.  Inputs are drawn from an explicit ``torch.Generator`` on the
device the entry runs on: the card unless the caller passes
``device="cpu"``; on the ``meta`` device they are shapes only.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.callgraph import Node, build_hierarchy, collapse
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.taint import NUM_REQS, NUM_TOKS, Taint
from repro_torch.core.tracer import (DeviceSlot, ModuleCall, TaintedTrace,
                                     TensorSlot, TraceOp)

# the serving engine's stateful-module registry (serving/context.py builds
# execution contexts for exactly these kinds)
STATEFUL_MODULES = ("self_attn", "cross_attn", "mla_attn", "mamba", "moe")

#: aten ops whose arguments encode sizes that a sweep cannot rewrite
_NO_SWEEP_OPS = {"slice", "select", "index", "index_select", "gather",
                 "scatter", "scatter_add", "index_put", "cat",
                 "constant_pad_nd", "flip", "split", "split_with_sizes",
                 "unbind", "embedding", "convolution"}


# ---------------------------------------------------------------------------
# taint-driven size substitution
# ---------------------------------------------------------------------------

def resize_dim(size: int, taint: Taint, *, toks: Optional[int],
               reqs: Optional[int]) -> int:
    if taint.is_bot:
        return size
    if taint.is_mix:
        out = 1
        for v, label in taint.h:
            if label == NUM_TOKS:
                out *= toks if toks is not None else v
            elif label == NUM_REQS:
                out *= reqs if reqs is not None else v
            else:
                out *= v
        return out
    if taint.kind == NUM_TOKS:
        return toks if toks is not None else size
    if taint.kind == NUM_REQS:
        return reqs if reqs is not None else size
    return size                                   # MODEL_CONFIG fixed


def resize_shape(shape: Sequence[int], taints: Sequence[Taint], *,
                 toks: Optional[int], reqs: Optional[int]) -> Tuple[int, ...]:
    return tuple(resize_dim(s, t, toks=toks, reqs=reqs)
                 for s, t in zip(shape, taints))


def generate_tensor(shape, dtype: torch.dtype, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """Integers zero (valid indices everywhere), booleans true, floats
    normal * 0.02 from ``generator``, as the reference's ``generate_array``;
    on the meta device an empty tensor of that shape."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.bool:
        return torch.ones(shape, dtype=dtype, device=device)
    if not dtype.is_floating_point:
        return torch.zeros(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def _generator(device: torch.device, seed: int) -> Optional[torch.Generator]:
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def generate_inputs(op: TraceOp, *, toks: Optional[int] = None,
                    reqs: Optional[int] = None,
                    device: Device = "cuda") -> List[torch.Tensor]:
    """The op's tensor inputs at (toks, reqs), the i-th drawn from a
    generator seeded with i + 1."""
    dev = resolve_device(device)
    out = []
    for i, (shape, dtype, taints) in enumerate(
            zip(op.in_shapes, op.in_dtypes, op.in_taints)):
        rs = resize_shape(shape, taints, toks=toks, reqs=reqs)
        out.append(generate_tensor(rs, getattr(torch, dtype), _generator(dev, i + 1),
                                   dev))
    return out


def _fill(template, tensors: Sequence[torch.Tensor], device: torch.device,
          sizes: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None):
    """(args, kwargs) of a recorded call with its slots filled: tensors,
    the device, and (``sizes`` = (traced, resized) output shape) every size
    argument that spells the traced output shape."""
    leaves, spec = tree_flatten(template)
    out = []
    for leaf in leaves:
        if isinstance(leaf, TensorSlot):
            out.append(tensors[leaf.index])
        elif isinstance(leaf, DeviceSlot):
            out.append(device)
        else:
            out.append(leaf)
    args, kwargs = tree_unflatten(out, spec)
    if sizes is not None and sizes[0] != sizes[1]:
        args = tuple(list(sizes[1]) if isinstance(a, (list, tuple))
                     and tuple(a) == sizes[0] else a for a in args)
    return args, kwargs


# ---------------------------------------------------------------------------
# runnable-set entries
# ---------------------------------------------------------------------------

def entry_task_id(sig_hash: str, hardware: str) -> str:
    """Canonical identity of one measurement task: a signature swept on one
    hardware.  This is the unit of corpus-wide dedup (two models needing
    the same id share one measurement), of DB satisfaction checks, and of
    ProfilePlan journaling/resume — one string, so a checkpoint file and a
    plan built in another process agree byte-for-byte."""
    return f"{hardware}:{sig_hash}"


def resolve_overload(name: str):
    """``"aten.mm.default"`` -> ``torch.ops.aten.mm.default``."""
    namespace, packet, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, namespace), packet), overload)


@dataclass
class OpEntry:
    """Operator-level entry: one aten overload that runs on its own."""
    kind: str                       # aten op name ("mm", "add", ...)
    op: TraceOp
    count: int                      # occurrences across collapsed layers
    module: str                     # canonical module path
    sweepable: bool = True
    #: detached form: the overload's name, for a trace op without ``func``
    bind: Optional[str] = None

    def callable(self, *, toks=None, reqs=None, device: Device = "cuda"):
        """(fn, tensors): ``fn(*tensors)`` runs the op at (toks, reqs)."""
        dev = resolve_device(device)
        tensors = generate_inputs(self.op, toks=toks, reqs=reqs, device=dev)
        sizes = None
        if self.op.out_shapes and (toks is not None or reqs is not None):
            sizes = (self.op.out_shapes[0],
                     resize_shape(self.op.out_shapes[0], self.op.out_taints[0],
                                  toks=toks, reqs=reqs))
        func, template = self.op.func, self.op.template
        if func is None:
            if self.bind is None:
                raise ValueError(f"OpEntry {self.kind!r} has neither a live "
                                 "overload nor a detached name")
            func = resolve_overload(self.bind)

        def fn(*ts):
            args, kwargs = _fill(template, ts, dev, sizes)
            return func(*args, **kwargs)
        return fn, tensors

    def run(self, *, toks=None, reqs=None, device: Device = "cuda"):
        fn, tensors = self.callable(toks=toks, reqs=reqs, device=device)
        return fn(*tensors)


def detach_op_entry(entry: OpEntry) -> OpEntry:
    """Picklable copy of an OpEntry, for a spawn-started worker: the aten
    overload (which does not pickle) is replaced by its name, which
    ``callable`` resolves back.  The trace op's template and taints pickle
    as they are, and the inputs are generated from shapes on the worker's
    side, so nothing else needs detaching."""
    return dataclasses.replace(
        entry, op=dataclasses.replace(entry.op, func=None),
        bind=entry.op.prim)


@dataclass
class ModuleEntry:
    """Module-level entry (stateful, or absorbed failed leaves).

    ``context_kind`` selects the serving engine's context
    (``serving.context.build_context``) that reconstructs the execution
    context (phase-dependent for attention-like modules).  ``call``
    is the module's first call in the trace, which ``run`` repeats on the
    device with generated weights and inputs."""
    kind: str                       # module name ("self_attn", "mlp", ...)
    node: Node
    count: int
    module: str
    context_kind: Optional[str] = None   # one of STATEFUL_MODULES or None
    ops: List[TraceOp] = field(default_factory=list)
    call: Optional[ModuleCall] = None

    def run(self, *, device: Device = "cuda", seed: int = 0):
        """The ``nn.Module`` subtree on ``device``: its parameters drawn
        normal * 0.02 (norm scales too), its tensor arguments generated from
        their traced shapes."""
        if self.call is None:
            raise ValueError(f"module entry {self.module!r} has no traced call")
        dev = resolve_device(device)
        mod = copy.deepcopy(self.call.module).to_empty(device=dev)
        gen = _generator(dev, seed)
        with torch.no_grad():
            for p in mod.parameters():
                p.copy_(generate_tensor(tuple(p.shape), p.dtype, gen, dev))
            tensors = [generate_tensor(t.shape, t.dtype, _generator(dev, i + 1), dev)
                       for i, t in enumerate(self.call.tensors)]
            args, kwargs = _fill(self.call.template, tensors, dev)
            return mod(*args, **kwargs)


Entry = Any  # OpEntry | ModuleEntry


# ---------------------------------------------------------------------------
# bottom-up resolution (§5.2)
# ---------------------------------------------------------------------------

def find_runnable_set(trace: TaintedTrace, *, device: Device = "cuda"
                      ) -> List[Entry]:
    """Each op entry runs once on ``device`` to show it runs standalone;
    one that fails is absorbed into its module's entry."""
    dev = resolve_device(device)
    root = build_hierarchy(trace)
    canon = collapse(root)
    entries: List[Entry] = []
    for cm in canon:
        entries.extend(_resolve_module(cm.node, cm.count, trace, dev))
    return entries


def _stateful_kind(path: Tuple[str, ...]) -> Optional[str]:
    for comp in path:
        base = comp.split(".")[0]
        if base in STATEFUL_MODULES:
            return base
    return None


def _module_entry(kind, node: Node, count: int, trace: TaintedTrace,
                  context_kind=None, ops=None) -> ModuleEntry:
    return ModuleEntry(kind=kind, node=node, count=count,
                       module="/".join(node.path), context_kind=context_kind,
                       ops=node.all_ops() if ops is None else ops,
                       call=trace.modules.get(node.path))


def _resolve_module(node: Node, count: int, trace: TaintedTrace,
                    device: torch.device) -> List[Entry]:
    sk = _stateful_kind(node.path)
    if sk is not None:
        # stateful: stop here, absorb the whole subtree (context emulation)
        return [_module_entry(sk, node, count, trace, context_kind=sk)]
    out: List[Entry] = []
    failed: List[TraceOp] = []
    for op in node.ops:
        if op.func is None:
            failed.append(op)
            continue
        # skip untainted dispatch-mechanics leaves (§5.2 bottom-up rule)
        if all(t.is_bot for ts in op.in_taints for t in ts) and op.in_shapes:
            if all(len(s) == 0 for s in op.in_shapes):
                continue
        entry = OpEntry(kind=op.name, op=op, count=count,
                        module="/".join(node.path),
                        sweepable=op.name.lstrip("_") not in _NO_SWEEP_OPS)
        try:
            entry.run(device=device)
            out.append(entry)
        except Exception:
            failed.append(op)
    for name in node.children:
        child = node.children[name]
        sk_child = _stateful_kind(child.path)
        if sk_child is not None:
            out.append(_module_entry(sk_child, child, count, trace,
                                     context_kind=sk_child))
        else:
            out.extend(_resolve_module(child, count, trace, device))
    if failed:
        # absorb the failed leaves into an entry that re-runs this node's
        # module; a node whose module does not run either is dropped, as
        # the reference drops it
        me = _module_entry(node.name or "root", node, count, trace, ops=failed)
        try:
            me.run(device=device)
            out.append(me)
        except Exception:
            pass
    return out
