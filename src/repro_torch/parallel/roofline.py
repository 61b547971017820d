"""Roofline constants of the card, the dry run's roofline terms, and the
useful-compute baseline.

Counterpart of ``repro.parallel.roofline``.  The reference's constants are a
TPU v5e's; here each card is keyed by its hardware tag, the lower-cased name
``torch.cuda.get_device_name()`` reports without its vendor word
(``"NVIDIA H100 80GB HBM3"`` -> ``"h100-80gb-hbm3"``).  The H100 figures
are NVIDIA's data-sheet peaks for the SXM part, dense, at its 700 W limit.

    compute term    = FLOPs_per_device / peak FLOP/s (bf16)
    memory term     = bytes_per_device / HBM bw
    collective term = collective_bytes_per_device / NVLink bw (one direction)

The reference's ``analyze``, ``analyze_text`` and ``collective_bytes``
parse XLA's HLO and have no counterpart: the dry run counts FLOPs, bytes and
collective bytes on each device's shards as the step runs
(``launch.dryrun.StepMeter``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
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


#: NVLink 4 on the H100 SXM: 900 GB/s per GPU both ways together, 450 GB/s
#: each way.  NVIDIA's data-sheet figures, not measured: the card this port
#: is measured on is a single one.
NVLINK_BIDIR_BW = 900e9
NVLINK_BW = 450e9            # bytes/s a GPU sends (or receives) over NVLink


@dataclass
class Roofline:
    """Per-device roofline terms of one dry-run cell, priced at the H100's
    data-sheet peaks (``PEAKS[H100]``, bf16) and NVLink figure."""
    flops: float                 # per device
    hbm_bytes: float             # per device
    coll_bytes: float            # per device
    coll_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAKS[H100].peak_flops(torch.bfloat16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / PEAKS[H100].hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "collective_by_kind": dict(self.coll_by_kind),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
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
