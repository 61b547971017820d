"""Serving engine: real execution of the scheduler's iteration plans.

Counterpart of ``repro.serving.engine``, with the same static-shape
discipline: one padded cache of ``max_num_seqs`` rows is allocated up front
(absolute-position slots, no ring); decode runs the full row batch every
iteration (inactive rows masked by lengths), prefill chunks run per row
through ``Model.prefill_chunk``, padded to power-of-two buckets, except for
configs with SSM state, whose chunks run at their exact length.  A chunk
runs on a view of its row of the cache and writes into it in place.

The engine clock advances by *measured model time* per iteration: host
time around the iteration's work, closed by a device synchronize on the
card.  A trace replay is therefore directly comparable with DoolySim, which
advances the same clock by *predicted* time, driving the same Scheduler.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device, synchronize
from repro_torch.models.zoo import Cache, Model
from repro_torch.serving.scheduler import (IterationPlan, Request, Scheduler,
                                           SchedulerConfig)


def bucket_chunk(c: int, chunk_size: int) -> int:
    """Round a prefill chunk up to a power-of-two bucket <= chunk_size, so
    the engine runs a handful of fixed shapes and the sim predicts the same
    bucketed compute."""
    b = 8
    while b < c:
        b *= 2
    return min(b, chunk_size) if c <= chunk_size else c


@dataclass
class IterationRecord:
    t_start: float
    t_end: float
    n_prefill_tokens: int
    n_decodes: int
    model_s: float
    n_chunks: int = 0
    chunks: Tuple[Tuple[int, int], ...] = ()    # (length, start) per chunk


class Engine:
    def __init__(self, cfg: ModelConfig, *, sched_config: SchedulerConfig,
                 max_seq: int, params: Optional[Mapping[str, torch.Tensor]] = None,
                 impl: str = "auto", seed: int = 0, device: Device = "cuda"):
        """``params`` is a state dict for ``Model`` (for instance from
        ``params_from_jax``); without it the weights are drawn from a
        generator on ``device`` seeded with ``seed``."""
        if cfg.is_encdec:
            raise NotImplementedError(
                "the engine serves decoder-only archs; enc-dec is covered by "
                "prefill/decode dry-runs and profiling")
        self.device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = Model(cfg, device=self.device, generator=gen)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        self.sched = Scheduler(sched_config)
        self.max_seq = max_seq
        self.impl = impl
        r = sched_config.max_num_seqs
        self.cache: Cache = self.model.zero_cache(r, max_seq, use_ring=False)
        self.lengths = [0] * r
        self.clock = 0.0
        self.records: List[IterationRecord] = []
        self.warmup()

    # ------------------------------------------------------------------

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def warmup(self):
        """Run the decode step and every chunk bucket once, so that kernel
        builds (the scan kernel's too, through the decode step of an SSM
        config), library set-up and allocator growth land outside timed
        iterations; the cache is zeroed afterwards."""
        r = self.sched.config.max_num_seqs
        self.model.decode_step(self.cache, [0] * r, self._ints(self.lengths),
                               impl=self.impl)
        b = 8
        while b <= self.sched.config.chunk_size:
            self.model.prefill_chunk(self._row_cache(0), [[0] * b],
                                     self._ints([0]), impl=self.impl,
                                     last_pos=self._ints([0]))
            b *= 2
        for c in self.cache:
            for t in c.values():
                t.zero_()
        synchronize(self.device)

    def _row_cache(self, slot: int) -> Cache:
        """Views of one row of every layer's cache."""
        return [{k: t[slot:slot + 1] for k, t in c.items()} for c in self.cache]

    # ------------------------------------------------------------------

    def execute(self, plan: IterationPlan) -> float:
        """Run one iteration plan; returns measured model seconds."""
        t0 = time.perf_counter()
        new_tokens: Dict[int, int] = {}
        for chunk in plan.prefills:
            r = chunk.req
            # SSM state is sequential: pad tokens would advance it, so
            # configs with SSM state run exact-length chunks (no bucketing)
            b = chunk.length if self.cfg.ssm_state > 0 else \
                bucket_chunk(chunk.length, self.sched.config.chunk_size)
            ids = r.prompt[chunk.start:chunk.start + chunk.length]
            ids = ids + [0] * (b - chunk.length)        # pad to the bucket
            logits, _ = self.model.prefill_chunk(
                self._row_cache(r.slot), [ids], self._ints([chunk.start]),
                impl=self.impl, last_pos=self._ints([chunk.length - 1]))
            self.lengths[r.slot] = chunk.start + chunk.length
            if chunk.start + chunk.length >= r.prompt_len:
                new_tokens[r.rid] = int(torch.argmax(logits[0]))
        if plan.decodes:
            # replay mode: deterministic dummy token ids (latency-identical)
            toks = [0] * self.sched.config.max_num_seqs
            for r in plan.decodes:
                toks[r.slot] = 1 + (r.generated % 7)
            logits, _ = self.model.decode_step(
                self.cache, toks, self._ints(self.lengths), impl=self.impl)
            best = torch.argmax(logits, dim=-1).tolist()
            for r in plan.decodes:
                new_tokens[r.rid] = best[r.slot]
                self.lengths[r.slot] += 1
        synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------

    def run(self, requests: List[Request]) -> Dict[str, Any]:
        """Replay a workload trace; the clock advances by measured model
        time (plus arrival gaps when idle)."""
        pending = sorted(requests, key=lambda r: r.arrival)
        i = 0
        self.clock = 0.0
        while i < len(pending) or self.sched.has_work():
            while i < len(pending) and pending[i].arrival <= self.clock:
                self.sched.add_request(pending[i])
                i += 1
            plan = self.sched.schedule()
            if plan.empty:
                if i < len(pending):
                    self.clock = pending[i].arrival
                    continue
                break
            model_s = self.execute(plan)
            t_start = self.clock
            self.clock += model_s
            self.sched.complete_iteration(plan, self.clock)
            self.records.append(IterationRecord(
                t_start, self.clock,
                sum(c.length for c in plan.prefills), len(plan.decodes),
                model_s, n_chunks=len(plan.prefills),
                chunks=tuple((c.length, c.start) for c in plan.prefills)))
        return {"requests": requests, "iterations": self.records,
                "makespan": self.clock}
