"""Traffic shapes: diurnal/spike rate modulation over generators + traces.

A :class:`ShapeSpec` is a *relative* intensity function ``rel_rate(t)``
(dimensionless, baseline 1) describing how offered load varies over time:

* ``diurnal`` — ``1 + amplitude*sin(2*pi*t/period)``: the day/night swing
  a "millions of users" service sees, mean 1 over a period;
* ``spike``   — ``magnitude`` inside the window ``[at, at+width)``,
  baseline 1 outside: a flash crowd / incident replay.

Two composition modes, both seeded/deterministic:

* **generators** — :func:`shaped_arrivals` draws an inhomogeneous
  Poisson process at base ``rate`` via thinning: candidates arrive
  homogeneously at ``rate * peak`` and survive with probability
  ``rel_rate(t)/peak``.  One seeded rng, so (rate, shape, seed) is fully
  reproducible.
* **traces** — :func:`warp_times` maps recorded arrivals through the
  inverse cumulative intensity (``u = Lambda^{-1}(t)``, the time-change
  theorem): high-intensity stretches compress more arrivals into less
  wall-clock, no randomness involved, so every shaped variant of one
  trace shares common random numbers with the original.

``parse_shape`` turns the CLI/``WorkloadSpec.shape`` string form —
``"diurnal:period=50,amplitude=0.8"``, ``"spike:at=2,width=5,
magnitude=4"`` — into a spec; bare kinds take the defaults.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Sequence, Union

import numpy as np

SHAPE_KINDS = ("diurnal", "spike")


@dataclass(frozen=True)
class ShapeSpec:
    kind: str = "diurnal"
    period: float = 60.0        # diurnal: seconds per cycle
    amplitude: float = 0.5      # diurnal: swing in [0, 1]
    at: float = 0.0             # spike: window start
    width: float = 10.0         # spike: window length
    magnitude: float = 4.0      # spike: rate multiplier inside the window

    def __post_init__(self):
        if self.kind not in SHAPE_KINDS:
            raise ValueError(f"unknown shape kind {self.kind!r}; known: "
                             f"{', '.join(SHAPE_KINDS)}")
        if self.kind == "diurnal":
            if not (self.period > 0):
                raise ValueError(f"diurnal period must be > 0, got "
                                 f"{self.period!r}")
            if not (0.0 <= self.amplitude <= 1.0):
                raise ValueError(f"diurnal amplitude must be in [0, 1], "
                                 f"got {self.amplitude!r}")
        else:
            if self.at < 0 or not (self.width >= 0):
                raise ValueError(f"spike window needs at >= 0 and "
                                 f"width >= 0, got at={self.at!r}, "
                                 f"width={self.width!r}")
            if not (self.magnitude > 0):
                raise ValueError(f"spike magnitude must be > 0, got "
                                 f"{self.magnitude!r}")

    @property
    def peak(self) -> float:
        """max of ``rel_rate`` — the thinning envelope."""
        if self.kind == "diurnal":
            return 1.0 + self.amplitude
        return max(1.0, self.magnitude)

    def rel_rate(self, t: float) -> float:
        if self.kind == "diurnal":
            return 1.0 + self.amplitude * math.sin(
                2.0 * math.pi * t / self.period)
        return self.magnitude if self.at <= t < self.at + self.width \
            else 1.0

    def cumulative(self, t: float) -> float:
        """``Lambda(t) = integral_0^t rel_rate`` (closed form)."""
        if t <= 0:
            return 0.0
        if self.kind == "diurnal":
            w = 2.0 * math.pi / self.period
            return t + self.amplitude / w * (1.0 - math.cos(w * t))
        inside = min(max(t - self.at, 0.0), self.width)
        return t + (self.magnitude - 1.0) * inside

    def label(self) -> str:
        if self.kind == "diurnal":
            return f"diurnal(p{self.period:g},a{self.amplitude:g})"
        return f"spike(@{self.at:g}+{self.width:g}x{self.magnitude:g})"


def parse_shape(spec: Union[ShapeSpec, str]) -> ShapeSpec:
    """``"kind:key=val,key=val"`` -> :class:`ShapeSpec` (bare ``"kind"``
    takes the defaults; an already-built spec passes through); unknown
    kinds/keys raise ``ValueError``."""
    if isinstance(spec, ShapeSpec):
        return spec
    kind, _, params = spec.partition(":")
    kind = kind.strip()
    shape = ShapeSpec(kind=kind)      # validates the kind
    fields = {"diurnal": ("period", "amplitude"),
              "spike": ("at", "width", "magnitude")}[kind]
    for item in params.split(","):
        item = item.strip()
        if not item:
            continue
        key, eq, val = item.partition("=")
        key = key.strip()
        if not eq or key not in fields:
            raise ValueError(
                f"bad shape parameter {item!r} for {kind!r}; expected "
                f"key=value with key in {fields}")
        try:
            shape = replace(shape, **{key: float(val)})
        except ValueError as e:
            raise ValueError(f"bad shape parameter {item!r}: {e}")
    return shape


def shaped_arrivals(n: int, *, rate: float,
                    shape: Union[ShapeSpec, str],
                    seed: int = 0) -> np.ndarray:
    """``n`` arrival times of an inhomogeneous Poisson process with
    intensity ``rate * shape.rel_rate(t)``, drawn by thinning a
    homogeneous process at ``rate * shape.peak`` (seeded)."""
    if isinstance(shape, str):
        shape = parse_shape(shape)
    if n < 0:
        raise ValueError(f"need n >= 0, got {n}")
    if math.isinf(rate):
        return np.zeros(n)           # burst: shapes are a no-op
    if not (rate > 0):
        raise ValueError(f"shaped_arrivals needs rate > 0, got {rate!r}")
    rng = np.random.default_rng(seed)
    envelope = rate * shape.peak
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / envelope))
        if float(rng.uniform()) * shape.peak <= shape.rel_rate(t):
            out.append(t)
    return np.asarray(out, dtype=np.float64)


def warp_times(times: Sequence[float],
               shape: Union[ShapeSpec, str]) -> np.ndarray:
    """Deterministic time-change of recorded arrivals: each ``t`` maps to
    ``u`` solving ``shape.cumulative(u) = t``, so a unit-rate stretch of
    the original lands where the shaped intensity says it should.
    Monotone (order-preserving) and randomness-free."""
    if isinstance(shape, str):
        shape = parse_shape(shape)
    out = np.empty(len(times), dtype=np.float64)
    for i, t in enumerate(times):
        t = float(t)
        if t <= 0:
            out[i] = 0.0
            continue
        lo, hi = 0.0, max(t, 1e-9)
        while shape.cumulative(hi) < t:
            hi *= 2.0
        for _ in range(100):          # bisection to ~1e-12 relative
            mid = 0.5 * (lo + hi)
            if shape.cumulative(mid) < t:
                lo = mid
            else:
                hi = mid
        out[i] = 0.5 * (lo + hi)
    return out
