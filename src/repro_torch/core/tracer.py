"""Tainted Runner (paper §4): one forward pass under a ``TorchDispatchMode``
that labels every tensor dimension of every aten operation with its origin.

Counterpart of ``repro.core.tracer``, which walks a jaxpr; this is the
paper's own design: dispatch-time interception of a dummy-prompt pass.  The
model's parameters sit on the ``meta`` device, so the pass computes shapes
only (zero FLOPs, zero allocation), as the reference's abstract trace does.

* Dimension-mapping aten ops get explicit rules: view (aten's reshape
  dispatches as view or ``_unsafe_view``: the MIX(H) merge/split of Table
  1, ``reshape_taints``), expand, permute/transpose, (un)squeeze, cat,
  mm/addmm/bmm, slice/select, split, reductions.
* Everything else goes through the paper's shape-matching heuristic backed
  by the global value -> taint registry.
* Module scopes come from ``nn.Module`` forward pre- and post-hooks: a
  module's path is its attribute path with each ``ModuleList`` index joined
  to its list's name (``layers.0/self_attn/q_proj``), the reference's
  ``named_scope`` stack.  Each module's first call is kept (its tensor
  arguments as shape, dtype and taints), so a module can be re-run.

Each recorded op keeps its aten overload and its arguments with every
tensor replaced by a slot, so ``core.opset`` can re-run it on generated
inputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.taint import (BOT, REQS, TOKS, Taint, TaintRegistry,
                                    combine, merge_dims, split_mix)

DimTaints = Tuple[Taint, ...]


class TensorSlot:
    """Stands for the ``index``-th tensor argument of a recorded call."""
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"<tensor {self.index}>"


class DeviceSlot:
    """Stands for a device argument (the trace's is ``meta``): a re-run
    puts its own device here."""

    def __repr__(self):
        return "<device>"


DEVICE = DeviceSlot()


@dataclass
class TraceOp:
    """One aten operation of the tainted trace."""
    eqn_id: int
    prim: str                                   # aten overload, "aten.mm.default"
    name_stack: str
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_dtypes: Tuple[str, ...]
    in_taints: Tuple[DimTaints, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    out_taints: Tuple[DimTaints, ...]
    params: Dict[str, Any] = field(default_factory=dict)
    #: the overload and its (args, kwargs) with tensors as TensorSlots
    func: Any = field(default=None, repr=False, compare=False)
    template: Any = field(default=None, repr=False, compare=False)

    @property
    def path(self) -> Tuple[str, ...]:
        return tuple(p for p in self.name_stack.split("/") if p)

    @property
    def name(self) -> str:
        """The op without its namespace and overload: ``mm``, ``view``."""
        return self.prim.split(".")[1] if "." in self.prim else self.prim


@dataclass
class TracedTensor:
    """A tensor argument of a traced module call, as a re-run needs it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    taints: DimTaints


@dataclass
class ModuleCall:
    """A module's first call in the trace: the module and its (args,
    kwargs) with tensors as TensorSlots into ``tensors``."""
    module: nn.Module
    template: Any
    tensors: List[TracedTensor]


@dataclass
class TaintedTrace:
    ops: List[TraceOp]
    registry: TaintRegistry
    in_taints: List[DimTaints]
    out_taints: List[DimTaints]
    modules: Dict[Tuple[str, ...], ModuleCall] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# reshape merge/split (the MIX(H) mechanics), as the reference writes it
# ---------------------------------------------------------------------------

def reshape_taints(in_shape, in_taints, out_shape, registry) -> DimTaints:
    """Group input and output dims into product-matched factors; merged dims
    get MIX(H), split dims recover factors from H / the registry."""
    out: List[Taint] = []
    i = j = 0
    n, m = len(in_shape), len(out_shape)
    while i < n or j < m:
        # skip size-1 dims greedily
        if i < n and in_shape[i] == 1 and (j >= m or out_shape[j] != 1):
            i += 1
            continue
        if j < m and out_shape[j] == 1 and (i >= n or in_shape[i] != 1):
            out.append(BOT)
            j += 1
            continue
        if i >= n or j >= m:
            while j < m:
                out.append(registry.lookup(int(out_shape[j]))
                           if out_shape[j] > 1 else BOT)
                j += 1
            break
        # grow a group until products match
        pi, pj = in_shape[i], out_shape[j]
        gi, gj = [i], [j]
        while pi != pj:
            if pi < pj:
                i2 = gi[-1] + 1
                if i2 >= n:
                    break
                gi.append(i2)
                pi *= in_shape[i2]
            else:
                j2 = gj[-1] + 1
                if j2 >= m:
                    break
                gj.append(j2)
                pj *= out_shape[j2]
        if pi != pj:
            # ragged tail: registry per remaining out dim
            while j < m:
                out.append(registry.lookup(int(out_shape[j]))
                           if out_shape[j] > 1 else BOT)
                j += 1
            break
        in_group = [(in_taints[k], int(in_shape[k])) for k in gi]
        out_sizes = tuple(int(out_shape[k]) for k in gj)
        if len(gi) == 1 and len(gj) == 1:
            out.append(in_taints[gi[0]])
        elif len(gj) == 1:                       # merge
            out.append(merge_dims(in_group))
        elif len(gi) == 1:                       # split
            t = in_taints[gi[0]]
            rec = split_mix(t, out_sizes)
            if rec is not None:
                out.extend(rec)
            else:
                resolved = [registry.lookup(s) if s > 1 else BOT
                            for s in out_sizes]
                unknown = [k for k, r in enumerate(resolved) if r.is_bot
                           and out_sizes[k] > 1]
                if len(unknown) == 1 and not t.is_bot and not t.is_mix:
                    resolved[unknown[0]] = t
                out.extend(resolved)
        else:                                     # n->m: merge then split
            merged = merge_dims(in_group)
            rec = split_mix(merged, out_sizes)
            if rec is not None:
                out.extend(rec)
            else:
                out.extend(registry.lookup(s) if s > 1 else BOT
                           for s in out_sizes)
        i, j = gi[-1] + 1, gj[-1] + 1
    return tuple(out[:m]) if len(out) >= m else tuple(
        list(out) + [BOT] * (m - len(out)))


# ---------------------------------------------------------------------------
# per-op taint rules
# ---------------------------------------------------------------------------

def _dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _dims_arg(args, kwargs, pos: int, name: str = "dim"):
    """An op's ``dim`` argument as a list, or None for "every dim"."""
    d = args[pos] if len(args) > pos else kwargs.get(name)
    if d is None:
        return None
    return [d] if isinstance(d, int) else list(d)


class Tracer:
    """The taint state of one pass: each tensor's dimension taints, the
    recorded ops and the module scopes."""

    def __init__(self, registry: TaintRegistry):
        self.registry = registry
        self.ops: List[TraceOp] = []
        self.modules: Dict[Tuple[str, ...], ModuleCall] = {}
        self._taints: Dict[int, DimTaints] = {}
        self._alive: List[torch.Tensor] = []    # keeps ids from being reused
        self._stack: List[Tuple[str, ...]] = [()]

    # -- taints of tensors --------------------------------------------------

    def _reg(self, size: int) -> Taint:
        return self.registry.lookup(int(size))

    def set(self, t: torch.Tensor, taints: DimTaints):
        self._taints[id(t)] = tuple(taints)
        self._alive.append(t)

    def get(self, t: torch.Tensor) -> DimTaints:
        """A tensor's taints; one the pass has not seen (a parameter, a
        constant) takes the registry's label of each of its sizes."""
        if id(t) not in self._taints:
            self.set(t, tuple(self._reg(d) for d in t.shape))
        return self._taints[id(t)]

    # -- module scopes --------------------------------------------------------

    def attach(self, root: nn.Module) -> List[Any]:
        """Forward hooks on every module of ``root`` that push and pop its
        path; returns the handles."""
        paths: Dict[int, Tuple[str, ...]] = {id(root): ()}

        def walk(mod: nn.Module, path: Tuple[str, ...]):
            for name, child in mod.named_children():
                if isinstance(child, nn.ModuleList):
                    for idx, sub in child.named_children():
                        paths[id(sub)] = path + (f"{name}.{idx}",)
                        walk(sub, paths[id(sub)])
                else:
                    paths[id(child)] = path + (name,)
                    walk(child, paths[id(child)])
        walk(root, ())

        def pre(mod, args, kwargs):
            path = paths.get(id(mod), self._stack[-1])
            if path not in self.modules:
                self.modules[path] = self._module_call(mod, args, kwargs)
            self._stack.append(path)

        def post(mod, args, kwargs, out):
            self._stack.pop()

        handles = []
        for mod in root.modules():
            if id(mod) in paths:
                handles.append(mod.register_forward_pre_hook(pre, with_kwargs=True))
                handles.append(mod.register_forward_hook(post, with_kwargs=True,
                                                         always_call=True))
        return handles

    def _module_call(self, mod, args, kwargs) -> ModuleCall:
        leaves, spec = tree_flatten((args, kwargs))
        tensors, out = [], []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                out.append(TensorSlot(len(tensors)))
                tensors.append(TracedTensor(tuple(leaf.shape), leaf.dtype,
                                          self.get(leaf)))
            else:
                out.append(leaf)
        return ModuleCall(mod, tree_unflatten(out, spec), tensors)

    # -- recording ------------------------------------------------------------

    def record(self, func, args, kwargs, out):
        leaves, spec = tree_flatten((args, kwargs))
        ins: List[torch.Tensor] = []
        template, params = [], {}
        for k, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                template.append(TensorSlot(len(ins)))
                ins.append(leaf)
            elif isinstance(leaf, torch.device):
                template.append(DEVICE)
            else:
                template.append(leaf)
                params[f"arg{k}"] = leaf
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        in_t = [self.get(t) for t in ins]
        out_t = self._rule(func, args, kwargs, ins, in_t, outs)
        for t, taints in zip(outs, out_t):
            self.set(t, taints)
        self.ops.append(TraceOp(
            eqn_id=len(self.ops) + 1, prim=str(func),
            name_stack="/".join(self._stack[-1]),
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(str(t.dtype).split(".")[-1] for t in ins),
            in_taints=tuple(in_t),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(str(t.dtype).split(".")[-1] for t in outs),
            out_taints=tuple(out_t), params=params, func=func,
            template=tree_unflatten(template, spec)))

    def _rule(self, func, args, kwargs, ins, in_t, outs) -> List[DimTaints]:
        name = func.overloadpacket.__name__
        rule = getattr(self, f"_rule_{name.lstrip('_')}", None)
        if rule is not None and ins:
            got = rule(args, kwargs, ins, in_t, outs)
            if got is not None:
                return got
        return self._default_rule(ins, in_t, outs)

    # the paper's dimension-preserving heuristic (§4.2): match by shape,
    # then by size via the registry, else BOT
    def _default_rule(self, ins, in_t, outs) -> List[DimTaints]:
        res = []
        in_shapes = [tuple(t.shape) for t in ins]
        for o in outs:
            oshape = tuple(o.shape)
            # tier 1: inputs with the identical shape -> positional combine
            same = [t for s, t in zip(in_shapes, in_t) if s == oshape]
            if same and len(oshape) > 0:
                dims = []
                for i in range(len(oshape)):
                    t = BOT
                    for st in same:
                        t = combine(t, st[i])
                        if t.is_mix:      # conflicting positional taints ->
                            t = st[i]     # keep the first non-bot
                            break
                    dims.append(t)
                res.append(tuple(dims))
                continue
            # tier 2: per-dim size matching against any input dim
            dims = []
            for d in oshape:
                cands = set()
                for s, t in zip(in_shapes, in_t):
                    for sz, tt in zip(s, t):
                        if sz == d and not tt.is_bot:
                            cands.add(tt)
                dims.append(next(iter(cands)) if len(cands) == 1 else self._reg(d))
            res.append(tuple(dims))
        return res

    # ---- dimension-mapping rules ----

    def _rule_view(self, args, kwargs, ins, in_t, outs):
        return [reshape_taints(tuple(ins[0].shape), in_t[0], tuple(outs[0].shape),
                               self.registry)]

    _rule_unsafe_view = _rule_view

    def _rule_expand(self, args, kwargs, ins, in_t, outs):
        xs, os_ = tuple(ins[0].shape), tuple(outs[0].shape)
        lead = len(os_) - len(xs)
        dims = [self._reg(d) for d in os_[:lead]]
        for i, d in enumerate(os_[lead:]):
            dims.append(in_t[0][i] if xs[i] == d else self._reg(d))
        return [tuple(dims)]

    def _rule_permute(self, args, kwargs, ins, in_t, outs):
        rank = ins[0].dim()
        return [tuple(in_t[0][_dim(p, rank)] for p in args[1])]

    def _rule_transpose(self, args, kwargs, ins, in_t, outs):
        rank = ins[0].dim()
        a, b = _dim(args[1], rank), _dim(args[2], rank)
        t = list(in_t[0])
        t[a], t[b] = t[b], t[a]
        return [tuple(t)]

    def _rule_t(self, args, kwargs, ins, in_t, outs):
        return [tuple(reversed(in_t[0]))]

    def _rule_unsqueeze(self, args, kwargs, ins, in_t, outs):
        d = _dim(args[1], ins[0].dim() + 1)
        t = list(in_t[0])
        t.insert(d, BOT)
        return [tuple(t)]

    def _rule_squeeze(self, args, kwargs, ins, in_t, outs):
        shape, rank = tuple(ins[0].shape), ins[0].dim()
        dims = _dims_arg(args, kwargs, 1)
        drop = {i for i in (range(rank) if dims is None else
                            (_dim(d, rank) for d in dims)) if shape[i] == 1}
        return [tuple(t for i, t in enumerate(in_t[0]) if i not in drop)]

    def _rule_cat(self, args, kwargs, ins, in_t, outs):
        out_shape = tuple(outs[0].shape)
        d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), len(out_shape))
        parts = [t for x, t in zip(ins, in_t) if x.dim() == len(out_shape)]
        dims = []
        for j in range(len(out_shape)):
            if j == d:
                first = parts[0][j]
                same = all(p[j] == first for p in parts)
                dims.append(first if same else self._reg(out_shape[j]))
            else:
                t = BOT
                for p in parts:
                    t = combine(t, p[j])
                    if t.is_mix:
                        t = p[j]
                        break
                dims.append(t)
        return [tuple(dims)]

    def _rule_mm(self, args, kwargs, ins, in_t, outs):
        a, b = in_t[-2], in_t[-1]
        return [(a[0], b[1])]

    _rule_addmm = _rule_mm

    def _rule_bmm(self, args, kwargs, ins, in_t, outs):
        a, b = in_t[-2], in_t[-1]
        return [(a[0], a[1], b[2])]

    def _rule_slice(self, args, kwargs, ins, in_t, outs):
        dims = []
        for i, (si, so) in enumerate(zip(ins[0].shape, outs[0].shape)):
            t = in_t[0][i]
            if si == so or t.kind in (TOKS.kind, REQS.kind):
                # a subrange of a request-derived dim is request-derived
                dims.append(t)
            else:
                dims.append(self._reg(so))
        return [tuple(dims)]

    def _rule_select(self, args, kwargs, ins, in_t, outs):
        d = _dim(args[1], ins[0].dim())
        return [tuple(t for i, t in enumerate(in_t[0]) if i != d)]

    def _rule_split(self, args, kwargs, ins, in_t, outs):
        rank = ins[0].dim()
        d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), rank)
        res = []
        for o in outs:
            t = list(in_t[0])
            if o.shape[d] != ins[0].shape[d]:
                t[d] = self._reg(o.shape[d])
            res.append(tuple(t))
        return res

    _rule_split_with_sizes = _rule_split

    def _reduce(self, args, kwargs, ins, in_t, outs, dim_pos=1):
        rank = ins[0].dim()
        dims = _dims_arg(args, kwargs, dim_pos)
        keep = args[dim_pos + 1] if len(args) > dim_pos + 1 else kwargs.get(
            "keepdim", False)
        axes = set(range(rank)) if not dims else {_dim(d, rank) for d in dims}
        t = tuple(BOT if i in axes else x for i, x in enumerate(in_t[0])
                  if keep or i not in axes)
        if any(len(t) != o.dim() for o in outs):
            return None
        return [t] * len(outs)

    _rule_sum = _reduce
    _rule_mean = _reduce
    _rule_amax = _reduce
    _rule_amin = _reduce
    _rule_argmax = _reduce
    _rule_max = _reduce
    _rule_min = _reduce
    _rule_any = _reduce
    _rule_all = _reduce


# ---------------------------------------------------------------------------
# the dispatch mode and the public entry
# ---------------------------------------------------------------------------

class TaintMode(TorchDispatchMode):
    """Runs every aten op as it comes and records it, with its taints, in
    the tracer."""

    def __init__(self, tracer: Tracer):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tracer.record(func, args, kwargs, out)
        return out


def trace_tainted(fn: Callable, args: Sequence[Any], *, registry: TaintRegistry,
                  root: nn.Module,
                  arg_taints: Optional[Sequence[Optional[DimTaints]]] = None
                  ) -> TaintedTrace:
    """Run ``fn(*args)`` once under the taint mode, with module scopes from
    ``root``'s modules.  ``arg_taints`` gives the per-dim taints of each
    tensor argument (None: the registry's); every other tensor (a
    parameter, a constant) takes the registry's label of each size."""
    tracer = Tracer(registry)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    for t, taints in zip(tensors, arg_taints or [None] * len(tensors)):
        if taints is not None:
            tracer.set(t, taints)
    in_taints = [tracer.get(t) for t in tensors]
    handles = tracer.attach(root)
    try:
        with torch.no_grad(), TaintMode(tracer):
            out = fn(*args)
    finally:
        for h in handles:
            h.remove()
    outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
    return TaintedTrace(ops=tracer.ops, registry=registry, in_taints=in_taints,
                        out_taints=[tracer.get(o) for o in outs],
                        modules=tracer.modules)
