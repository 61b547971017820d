"""Deterministic sharded data pipeline.

Synthetic LM token stream (per the scope: build the substrate, no external
data): each global batch is a pure function of (seed, step), and each host
process materializes only its shard — ``shard = f(step, process_index)`` —
so (a) any pod can recompute any other pod's shard after a failure or
re-balance (straggler mitigation / elasticity), and (b) restart from a
checkpoint resumes the exact stream with no state to restore.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


class TokenStream:
    def __init__(self, config: DataConfig, *, process_index: int = 0,
                 process_count: int = 1):
        assert config.global_batch % process_count == 0
        self.config = config
        self.process_index = process_index
        self.process_count = process_count
        self.shard_size = config.global_batch // process_count

    def batch_at(self, step: int, process_index: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """The (step, process) shard — recomputable by ANY process."""
        pi = self.process_index if process_index is None else process_index
        c = self.config
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, pi]))
        # learnable stream: arithmetic progressions mod vocab (the +1 rule
        # is learnable in a few steps, so descent tests are meaningful)
        start = rng.integers(0, c.vocab_size, (self.shard_size, 1),
                             dtype=np.int64)
        stride = rng.integers(1, 4, (self.shard_size, 1), dtype=np.int64)
        smooth = (start + stride * np.arange(c.seq_len + 1)) % c.vocab_size
        tokens = smooth[:, :-1].astype(np.int32)
        labels = smooth[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
