"""Hierarchy Constructor (paper §5.1).

Parses the tainted trace into the module -> operation tree (from name
stacks) and collapses structurally identical subtrees across repeated layers
(``layers.0.self_attn`` == ``layers.17.self_attn``) into canonical subtrees
with a multiplicity count, reducing the resolution workload to one
representative per repeated module.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from repro_torch.core.tracer import TaintedTrace, TraceOp

_IDX_RE = re.compile(r"\.(\d+)$|^(\d+)$")


def normalize_name(name: str) -> str:
    """layers.0 -> layers.*  (index-invariant structural name)."""
    return re.sub(r"\d+", "*", name)


@dataclass
class Node:
    name: str                                   # path component ("self_attn")
    path: Tuple[str, ...]                       # full path
    children: Dict[str, "Node"] = field(default_factory=dict)
    ops: List[TraceOp] = field(default_factory=list)

    def child(self, name: str) -> "Node":
        if name not in self.children:
            self.children[name] = Node(name, self.path + (name,))
        return self.children[name]

    def all_ops(self) -> List[TraceOp]:
        out = list(self.ops)
        for c in self.children.values():
            out.extend(c.all_ops())
        out.sort(key=lambda o: o.eqn_id)
        return out

    # ------------------------------------------------------------------
    def struct_key(self) -> str:
        """Structural identity: op sequence (prim, shapes, dtypes, params)
        + normalized child names recursively.  Two subtrees with equal keys
        compute the same thing (same dims -> same cost)."""
        parts: List[Any] = []
        for op in self.ops:
            parts.append((op.prim, op.in_shapes, op.in_dtypes,
                          op.out_shapes, _stable(op.params)))
        for name in sorted(self.children):
            c = self.children[name]
            parts.append((normalize_name(name), c.struct_key()))
        return hashlib.sha256(
            json.dumps(parts, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]


def build_hierarchy(trace: TaintedTrace) -> Node:
    root = Node("", ())
    for op in trace.ops:
        node = root
        for comp in op.path:
            # strip transform frames jax inserts (jvp(...), transpose(...))
            if comp.startswith(("jvp(", "transpose(", "vmap(")):
                continue
            node = node.child(comp)
        node.ops.append(op)
    return root


@dataclass
class CanonicalModule:
    """A collapsed subtree: one representative + where it occurs."""
    node: Node
    count: int
    paths: List[Tuple[str, ...]]

    @property
    def name(self) -> str:
        return "/".join(normalize_name(p) for p in self.node.path)


def collapse(root: Node) -> List[CanonicalModule]:
    """Group the root's layer-level children by structural identity.

    Returns canonical modules in first-occurrence order; each carries its
    multiplicity (the per-layer collapse of §5.1).
    """
    groups: Dict[str, CanonicalModule] = {}
    order: List[str] = []

    def visit(node: Node):
        key = node.struct_key()
        if key in groups:
            groups[key].count += 1
            groups[key].paths.append(node.path)
            return
        groups[key] = CanonicalModule(node=node, count=1, paths=[node.path])
        order.append(key)

    # collapse at the "layer" level: every direct child of root whose
    # normalized name repeats (layers.*, enc_layers.*), then the rest
    for name, child in root.children.items():
        visit(child)
    return [groups[k] for k in order]


def layer_sequence(root: Node) -> List[Tuple[str, str]]:
    """(path, struct_key) for every top-level module in execution order —
    the simulator walks this to sum per-layer latencies."""
    out = []
    for name, child in root.children.items():
        out.append(("/".join(child.path), child.struct_key()))
    return out


def _stable(params: Dict[str, Any]) -> str:
    return json.dumps(params, sort_keys=True, default=str)
