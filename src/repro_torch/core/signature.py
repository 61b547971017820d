"""Operation signatures (paper §6).

Counterpart of ``repro.core.signature``.  A signature canonically
identifies an operation by what is invariant across workloads — three
components:

1. op name + MODEL_CONFIG-tainted dimension values (workload dims replaced
   by their taint label) + size-invariant static params.  A module entry's
   boundary is its first and last linear projection, each as (activation,
   weight) with the (B*S) dim an aten ``mm`` merges split back into its
   request and token labels, so that it reads as the reference's first and
   last ``dot_general``; its ``n_ops`` counts aten ops, not jaxpr
   equations;
2. the kernel fingerprint at a canonical probe point.  On the card it is
   the sorted set of CUDA kernel names that ``torch.profiler`` records for
   one eager call, the CUPTI kernel symbols the paper names; on the CPU it
   is the sorted set of aten overloads one call dispatches, recorded by a
   ``TorchDispatchMode``.  The reference lowers to StableHLO instead, so
   this component differs from its by design.  A module entry's
   fingerprint covers every phase it is profiled in (the decode phase runs
   other kernels than the prefill phase);
3. a digest of the module's primitive attributes (window, head counts, …)
   capturing runtime branching invisible at kernel level.

SHA-256 over the canonical serialization is the primary key of the latency
database; dedup is a key lookup.

A fingerprint that cannot be taken falls back to ``prim:<op>`` or
``module:<kind>``, as the reference's does; each fallback adds one to
``fingerprint.fallbacks`` (its error in ``fingerprint.last_error``), so a
caller can refuse a profile in which one fell back.  Take fingerprints before any ``cuda_events`` timing in a
process: an active profiler slows graph replays.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.opset import ModuleEntry, OpEntry
from repro_torch.core.taint import MODEL_CONFIG, NUM_REQS, NUM_TOKS

PROBE_TOKS = 8
PROBE_REQS = 2
PROBE_CTX = 16


#: the aten overloads of a linear projection (the reference's dot_general)
LINEAR_OPS = ("mm", "addmm", "bmm")
#: a merged workload dim splits batch-major, as the port's views merge it
_SPLIT_ORDER = {NUM_REQS: 0, NUM_TOKS: 1}


def dim_template(shape, taints) -> Tuple[Any, ...]:
    out = []
    for s, t in zip(shape, taints):
        if t.is_bot:
            out.append(int(s))
        elif t.is_mix:
            # keep only the model-derived factors; request factors -> label
            out.append("x".join(f"{l}{v if l == 'M' else ''}"
                                for l, v in t.canonical_factors))
        elif t.kind == MODEL_CONFIG:
            out.append(int(s))
        elif t.kind == NUM_TOKS:
            out.append("T")
        elif t.kind == NUM_REQS:
            out.append("R")
        else:
            out.append(str(t.kind))
    return tuple(out)


def unmerged_template(shape, taints) -> Tuple[Any, ...]:
    """``dim_template`` with each dim merged from workload dims alone split
    back into its request and token labels."""
    out = []
    for s, t in zip(shape, taints):
        labels = sorted({l for _, l in t.h}, key=lambda l: _SPLIT_ORDER.get(l, 2))
        if t.is_mix and labels and all(l in _SPLIT_ORDER for l in labels):
            out.extend("R" if l == NUM_REQS else "T" for l in labels)
        else:
            out.extend(dim_template([s], [t]))
    return tuple(out)


def _linear_boundary(op) -> list:
    """[activation, weight] templates of a linear projection's operands
    (``addmm``'s bias left out)."""
    x, w = list(zip(op.in_shapes, op.in_taints))[-2:]
    return [list(unmerged_template(*x)), list(dim_template(*w))]


class _AtenOps(TorchDispatchMode):
    """Records the name of every aten overload dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


#: the sentinel kernel that brackets a profiled call (``torch.cuda._sleep``),
#: how many lead it, and how many sessions may lose them before one fails
_SENTINEL, _LEADING, _ATTEMPTS = "spin_kernel", 3, 5


def _cuda_kernels(fn: Callable, args: Sequence[Any]) -> set:
    """Names of the device activities (kernels, copies) of one eager call,
    after a first call that builds kernels and fills library caches.

    A profiler session can lose the first device activity it should record
    (seen on an H100, once a session has profiled a kernel of the port's
    own), and an empty set is a real fingerprint (a view launches
    nothing).  So sentinel kernels lead and close the call; a session is
    kept when its first and last activities are sentinels, and taken again
    otherwise."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(_LEADING):
                torch.cuda._sleep(1)
            fn(*args)
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if names and _SENTINEL in names[0] and _SENTINEL in names[-1]:
            return {n for n in names if _SENTINEL not in n}
    raise RuntimeError(f"torch.profiler lost the sentinels of {_ATTEMPTS} "
                       "sessions in a row")


def fingerprint(calls: Sequence[Tuple[Callable, Sequence[Any]]]) -> str:
    """Sorted kernel set of ``fn(*args)`` for every (fn, args) of
    ``calls``: CUDA kernel names where the first tensor argument lies on
    the card, aten overloads otherwise."""
    names: set = set()
    for fn, args in calls:
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if tensors and tensors[0].is_cuda:
            names |= _cuda_kernels(fn, args)
        else:
            with torch.no_grad(), _AtenOps() as mode:
                fn(*args)
            names |= mode.ops
    return ",".join(sorted(names))


fingerprint.fallbacks = 0
fingerprint.last_error = None


def _fell_back(err: Exception):
    fingerprint.fallbacks += 1
    fingerprint.last_error = f"{type(err).__name__}: {err}"


@dataclass(frozen=True)
class Signature:
    hash: str
    op_name: str
    spec: str            # component 1 (canonical json)
    fingerprint: str     # component 2
    attrs: str           # component 3 (canonical json)

    @classmethod
    def build(cls, op_name: str, spec: Any, fingerprint: str,
              attrs: Dict[str, Any]) -> "Signature":
        spec_s = json.dumps(spec, sort_keys=True, default=str)
        attrs_s = json.dumps(attrs, sort_keys=True, default=str)
        h = hashlib.sha256(
            f"{op_name}|{spec_s}|{fingerprint}|{attrs_s}".encode()
        ).hexdigest()
        return cls(h, op_name, spec_s, fingerprint, attrs_s)


def op_entry_signature(entry: OpEntry, device) -> Signature:
    """``device``: where the fingerprint's probe call runs."""
    op = entry.op
    spec = {
        "in": [list(dim_template(s, t))
               for s, t in zip(op.in_shapes, op.in_taints)],
        "dtypes": list(op.in_dtypes),
        "params": {k: v for k, v in sorted(op.params.items())},
    }
    try:
        fn, args = entry.callable(
            toks=PROBE_TOKS if entry.sweepable else None,
            reqs=PROBE_REQS if entry.sweepable else None, device=device)
        fp = fingerprint([(fn, args)])
    except Exception as e:
        _fell_back(e)
        fp = f"prim:{op.prim}"
    return Signature.build(op.prim, spec, fp, {})


def module_entry_signature(entry: ModuleEntry, context,
                           *phase_contexts) -> Signature:
    """``context``: the prefill-phase ModuleContext (its static attributes
    are component 3); ``phase_contexts``: the contexts of the entry's
    other phases, whose kernels join the fingerprint."""
    ops = entry.ops or entry.node.all_ops()
    linear = [op for op in ops if op.name in LINEAR_OPS]
    if linear:
        boundary = [_linear_boundary(op) for op in linear[:1] + linear[-1:]]
    else:
        boundary = [[list(dim_template(s, t))
                     for s, t in zip(op.in_shapes, op.in_taints)]
                    for op in ops[:1] + ops[-1:]]
    spec = {"boundary": boundary, "n_ops": len(ops)}
    try:
        calls = [_probe_call(mc) for mc in (context,) + phase_contexts]
        fp = fingerprint(calls)
    except Exception as e:
        _fell_back(e)
        fp = f"module:{entry.kind}"
    return Signature.build(entry.kind, spec, fp,
                           dict(context.static_attrs))


def _probe_call(mc) -> Tuple[Callable, Tuple]:
    """(fn, args) of one call of a context at the probe point on its
    device, weights and inputs from a generator seeded with 0."""
    gen = torch.Generator(device=mc.device).manual_seed(0)
    module = mc.module(mc.materialize(mc.params, gen))
    inputs = mc.materialize(mc.abstract_inputs(PROBE_TOKS, PROBE_REQS,
                                               PROBE_CTX), gen)
    return mc.fn, (module,) + tuple(inputs)
