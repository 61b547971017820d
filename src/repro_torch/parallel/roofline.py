"""Roofline constants of the card, and the useful-compute baseline.

Counterpart of the part of ``repro.parallel.roofline`` that the
profile-then-simulate loop reads.  The reference's constants are a TPU
v5e's; here each card is keyed by its hardware tag, the lower-cased name
``torch.cuda.get_device_name()`` reports without its vendor word
(``"NVIDIA H100 80GB HBM3"`` -> ``"h100-80gb-hbm3"``).  The H100 figures
are NVIDIA's data-sheet peaks for the SXM part, dense, at its 700 W limit.

The reference's ``Roofline``, ``analyze``, ``analyze_text`` and
``collective_bytes`` parse XLA's HLO and have no counterpart: FLOPs come
from ``torch.utils.flop_counter`` instead (``core.backends.h100_analytical``).
Interconnect constants come with the multi-GPU slice; until then nothing
here models a collective.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class Peaks:
    flops: Dict[torch.dtype, float]      # dense FLOP/s by operand dtype
    hbm_bw: float                        # bytes/s

    def peak_flops(self, dtype: torch.dtype) -> float:
        return self.flops.get(dtype, self.flops[torch.float32])


H100 = "h100-80gb-hbm3"

PEAKS: Dict[str, Peaks] = {
    H100: Peaks(flops={torch.bfloat16: 989e12, torch.float16: 989e12,
                       torch.float32: 67e12},
                hbm_bw=3.35e12),
}


def hardware_tag(device_name: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` -> ``"h100-80gb-hbm3"``."""
    name = re.sub(r"^nvidia\s+", "", device_name.strip().lower())
    return re.sub(r"[^a-z0-9]+", "-", name).strip("-")


def default_hardware() -> str:
    """The hardware tag of the current card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass hardware= (for instance "
                           "'cpu') to profile or simulate without a card")
    return hardware_tag(torch.cuda.get_device_name())


def peaks(hardware: str) -> Peaks:
    try:
        return PEAKS[hardware]
    except KeyError:
        raise KeyError(f"no roofline constants for hardware {hardware!r}; "
                       f"known: {', '.join(sorted(PEAKS))}") from None


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful-compute baseline; decode
    shapes process global_batch tokens per step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.total_tokens
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.total_tokens
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch            # decode: 1 tok/request
