"""Taint lattice + Table-1 scalar rules + global taint registry (paper §4).

Base labels L = {MODEL_CONFIG, NUM_TOKS, NUM_REQS}; a taint is either
untainted (BOT), a base label, or MIX(H) where H maps concrete factor values
to their base labels (the paper's value-to-taint map, used to recover taints
when a merged dimension splits again).

The registry maps concrete values to labels, seeded at the serving engine's
model-configuration and request entry points (§4.1), and detects *ambiguity*
(same value carrying conflicting labels — paper App. B) so the tracer can
retrace with a collision-free dummy prompt.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Optional, Set, Tuple

MODEL_CONFIG = "MODEL_CONFIG"
NUM_TOKS = "NUM_TOKS"
NUM_REQS = "NUM_REQS"
BASE_LABELS = (MODEL_CONFIG, NUM_TOKS, NUM_REQS)


@dataclass(frozen=True)
class Taint:
    kind: str                                   # 'bot' | base label | 'mix'
    h: FrozenSet[Tuple[int, str]] = frozenset()  # MIX: {(value, label)}

    @property
    def is_bot(self) -> bool:
        return self.kind == "bot"

    @property
    def is_mix(self) -> bool:
        return self.kind == "mix"

    @property
    def labels(self) -> FrozenSet[str]:
        if self.is_bot:
            return frozenset()
        if self.is_mix:
            return frozenset(l for _, l in self.h)
        return frozenset({self.kind})

    @property
    def canonical_factors(self) -> Tuple[Tuple[str, int], ...]:
        """Deterministic (label-initial, value) ordering of a MIX
        dimension's factor map.  Task-identity keys — the signature dim
        templates that become latency-DB primary keys and ProfilePlan task
        ids — are built from this, so equal taints always serialize
        identically regardless of frozenset iteration order."""
        return tuple(sorted((label[0], v) for v, label in self.h))

    def __repr__(self):
        if self.is_mix:
            inner = ",".join(f"{v}:{l[0]}" for v, l in sorted(self.h))
            return f"MIX({inner})"
        return {"bot": "⊥", MODEL_CONFIG: "M", NUM_TOKS: "T",
                NUM_REQS: "R"}.get(self.kind, self.kind)


BOT = Taint("bot")
MODEL = Taint(MODEL_CONFIG)
TOKS = Taint(NUM_TOKS)
REQS = Taint(NUM_REQS)
_BASE = {MODEL_CONFIG: MODEL, NUM_TOKS: TOKS, NUM_REQS: REQS}


def base(label: str) -> Taint:
    return _BASE[label]


def combine(t1: Taint, t2: Taint, v1: Optional[int] = None,
            v2: Optional[int] = None) -> Taint:
    """Table 1: absorption / preservation / conflict / extend / merge.

    v1/v2 are the concrete values carried by each side (needed to build H on
    a Conflict); when omitted, conflicts degrade to a valueless MIX entry.
    """
    if t1.is_bot:
        return t2
    if t2.is_bot:
        return t1
    if t1 == t2:
        return t1
    h1 = t1.h if t1.is_mix else frozenset({(v1 if v1 is not None else -1,
                                            t1.kind)})
    h2 = t2.h if t2.is_mix else frozenset({(v2 if v2 is not None else -1,
                                            t2.kind)})
    return Taint("mix", h1 | h2)


def merge_dims(taints_values: Iterable[Tuple[Taint, int]]) -> Taint:
    """Merging dimensions (reshape n->1): fold with values recorded in H."""
    out = BOT
    out_v: Optional[int] = None
    for t, v in taints_values:
        out = combine(out, t, out_v, v)
        out_v = (out_v or 1) * v
    return out


def split_mix(t: Taint, sizes: Tuple[int, ...]) -> Optional[Tuple[Taint, ...]]:
    """Splitting a MIX dimension: recover per-factor taints by consulting H
    (paper §4.2 'when dimensions split, it recovers the original taints')."""
    if not t.is_mix:
        return None
    avail = dict(t.h)          # value -> label (collisions already resolved)
    out = []
    for s in sizes:
        if s in avail:
            out.append(base(avail.pop(s)))
        else:
            out.append(None)
    if any(o is None for o in out):
        # one unmatched factor may absorb the remaining labels
        rest = frozenset(avail.items())
        unmatched = [i for i, o in enumerate(out) if o is None]
        if len(unmatched) == 1 and len(rest) == 1:
            (_, lbl), = rest
            out[unmatched[0]] = base(lbl)
        else:
            return None
    return tuple(out)


class AmbiguityError(Exception):
    """Same concrete value seeded with conflicting labels (paper App. B)."""

    def __init__(self, value: int, labels: Set[str]):
        self.value, self.labels = value, labels
        super().__init__(f"taint ambiguity: value {value} carries {labels}; "
                         "retrace with a collision-free dummy prompt")


@dataclass
class TaintRegistry:
    """Global value -> label map (§4.1)."""
    values: Dict[int, Set[str]] = field(default_factory=dict)
    strict: bool = True

    def seed(self, value: int, label: str):
        if not isinstance(value, int) or value <= 1:
            return
        labels = self.values.setdefault(value, set())
        labels.add(label)
        # MODEL_CONFIG-internal collisions are benign (same taint); cross-
        # source collisions are ambiguity (App. B)
        if self.strict and len(labels) > 1:
            raise AmbiguityError(value, labels)

    def seed_many(self, values: Iterable[int], label: str):
        for v in values:
            self.seed(v, label)

    def lookup(self, value: int) -> Taint:
        labels = self.values.get(value)
        if not labels:
            return BOT
        if len(labels) == 1:
            return base(next(iter(labels)))
        raise AmbiguityError(value, labels)

    def register(self, value: int, taint: Taint):
        """Record a derived value discovered during propagation."""
        if taint.is_bot or taint.is_mix or not isinstance(value, int) \
                or value <= 1:
            return
        self.values.setdefault(value, set()).add(taint.kind)
