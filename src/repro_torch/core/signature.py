"""Operation signatures (paper §6).

Counterpart of ``repro.core.signature``.  A signature canonically
identifies an operation by what is invariant across workloads — three
components:

1. op name + MODEL_CONFIG-tainted dimension values (workload dims replaced
   by their taint label) + size-invariant static params.  A module entry's
   boundary is its first and last linear projection, each as (activation,
   weight) with the (B*S) dim an aten ``mm`` merges split back into its
   request and token labels, so that it reads as the reference's first and
   last ``dot_general``; a ``moe`` entry's is its first and last op, as
   the reference reads every module's, since both traces open the FFN
   with the reshape that flattens its tokens and close it with the one
   that restores them; its ``n_ops`` counts aten ops, not jaxpr
   equations;
2. the kernel fingerprint at a canonical probe point: the sorted set of
   aten overloads one eager call dispatches, recorded by a
   ``TorchDispatchMode``, and of the port's own kernels it launched, read
   from their wrappers' launch counters (``repro_torch::decode_attention``
   and the like; on the CPU a wrapper runs its plain version and counts
   nothing).  It is what the call asks of the device, as the reference's
   compile-time StableHLO op set is, so it differs from the reference's by
   design.  It is not the CUDA kernel names ``torch.profiler`` records
   (the paper's CUPTI symbols): which library kernels run, and whether a
   session records them, depends on what the process ran before (after
   ``cuda_events`` timing its sessions can fail to agree), so the same
   call could sign apart in two builds and a plan lose its id.  A module
   entry's fingerprint covers every phase it is profiled in (the decode
   phase runs other kernels than the prefill phase);
3. a digest of the module's primitive attributes (window, head counts, …)
   capturing runtime branching invisible at kernel level.

SHA-256 over the canonical serialization is the primary key of the latency
database; dedup is a key lookup.

A fingerprint that cannot be taken falls back to ``prim:<op>`` or
``module:<kind>``, as the reference's does; each fallback adds one to
``fingerprint.fallbacks`` (its error in ``fingerprint.last_error``), so a
caller can refuse a profile in which one fell back.
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
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.mamba_scan import mamba_scan

PROBE_TOKS = 8
PROBE_REQS = 2
PROBE_CTX = 16


#: the aten overloads of a linear projection (the reference's dot_general)
LINEAR_OPS = ("mm", "addmm", "bmm")
#: module kinds whose boundary is their first and last op (see above)
_OP_BOUNDARY = ("moe",)
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


#: the port's kernel wrappers, each counting the launches of its kernel
_KERNELS = (decode_attention, flash_attention_fwd, flash_attention_bwd,
            mamba_scan)


#: the sentinel kernel that brackets a profiled call (``torch.cuda._sleep``),
#: how many lead the first call, how many calls a session makes (each
#: closed by a sentinel), and how many sessions may be taken before one fails
_SENTINEL, _LEADING, _CALLS, _ATTEMPTS = "spin_kernel", 3, 3, 8


def _cuda_kernels(fn: Callable, args: Sequence[Any]) -> set:
    """Names of the device activities (kernels, copies) of one eager call,
    after a first call that builds kernels and fills library caches, as
    ``torch.profiler`` records them: the library kernels a call runs, which
    a fingerprint leaves out (see the module's docstring);
    ``examples/torch_fingerprint_sessions.py`` measures how often a session
    loses one.

    A profiler session can lose device activities it should record (seen
    on an H100: in some processes the first activity of most sessions, and
    now and then others, the call's own among them, even in two sessions
    in a row), and an empty set is a real fingerprint (a view launches
    nothing).  So sentinel kernels lead the call and close it, a session
    makes the call ``_CALLS`` times and counts when its first and last
    activities are sentinels, its set is the union over its calls, and a
    set is kept once two sessions that count give it.  A lost kernel
    would otherwise change the set from one process to the next."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    seen = []
    for _ in range(_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(_LEADING):
                torch.cuda._sleep(1)
            for _ in range(_CALLS):
                fn(*args)
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if names and _SENTINEL in names[0] and _SENTINEL in names[-1]:
            got = frozenset(n for n in names if _SENTINEL not in n)
            if got in seen:
                return set(got)
            seen.append(got)
    raise RuntimeError(f"no two of {_ATTEMPTS} torch.profiler sessions kept "
                       "their sentinels and agreed")


def fingerprint(calls: Sequence[Tuple[Callable, Sequence[Any]]]) -> str:
    """Sorted kernel set of ``fn(*args)`` for every (fn, args) of
    ``calls``: the aten overloads it dispatches and the port's kernels it
    launches (``repro_torch::<wrapper>``), on any device."""
    names: set = set()
    for fn, args in calls:
        before = [k.launches for k in _KERNELS]
        with torch.no_grad(), _AtenOps() as mode:
            fn(*args)
        names |= mode.ops | {f"repro_torch::{k.__name__}"
                             for k, n in zip(_KERNELS, before) if k.launches > n}
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
    if linear and entry.kind not in _OP_BOUNDARY:
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
