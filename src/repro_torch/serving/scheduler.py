"""Continuous-batching scheduler with chunked prefill (Sarathi-style).

THE central design point of DoolySim (paper §7): the simulator does not
re-implement scheduling — it drives THIS class, the same one the real
engine runs, so batch composition is bit-identical between real serving and
simulation (Figure 3c: scheduling MAPE < 0.5%).

Policy: per iteration, all running decode requests get one token each; the
remaining token budget is filled with prefill chunks (FCFS), admitting new
requests while slots are free.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional


@dataclass
class Request:
    rid: int
    arrival: float
    prompt: List[int]
    max_new_tokens: int
    #: leading prompt tokens already resident in the KV cache (a shared
    #: session prefix — see ``repro.workload.sessions``); the scheduler's
    #: prefix-cache model skips them at admission
    cached_prefix: int = 0
    # progress
    prefilled: int = 0
    generated: int = 0
    slot: int = -1
    #: prompt tokens the prefix cache actually served (set at admission:
    #: ``min(cached_prefix, prompt_len - 1)`` under ``prefix_caching``,
    #: else 0) — the hit accounting ``sim.metrics`` surfaces
    cache_hit_tokens: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def in_decode(self) -> bool:
        return self.prefilled >= self.prompt_len and self.finish_t is None

    @property
    def done(self) -> bool:
        return self.finish_t is not None


@dataclass
class SchedulerConfig:
    max_num_seqs: int = 8            # concurrent requests (cache rows)
    max_batch_tokens: int = 512      # per-iteration token budget
    chunk_size: int = 128            # prefill chunk size
    #: serve ``Request.cached_prefix`` tokens from the prefix cache at
    #: admission instead of prefilling them (vLLM-style automatic prefix
    #: caching).  At least one prompt token always prefills so a fully
    #: cached prompt still runs a chunk to emit its first token.
    prefix_caching: bool = True


@dataclass
class PrefillChunk:
    req: Request
    start: int
    length: int


@dataclass
class IterationPlan:
    prefills: List[PrefillChunk]
    decodes: List[Request]

    @property
    def empty(self) -> bool:
        return not self.prefills and not self.decodes

    @property
    def n_tokens(self) -> int:
        return sum(c.length for c in self.prefills) + len(self.decodes)


class Scheduler:
    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self._free_slots = list(range(config.max_num_seqs))[::-1]

    # ------------------------------------------------------------------

    def add_request(self, req: Request):
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def schedule(self) -> IterationPlan:
        """Build the next iteration's batch (pure function of queue state)."""
        budget = self.config.max_batch_tokens
        decodes = [r for r in self.running if r.in_decode]
        budget -= len(decodes)
        prefills: List[PrefillChunk] = []
        # continue partially-prefilled running requests first (FCFS)
        for r in self.running:
            if budget <= 0:
                break
            if not r.done and r.prefilled < r.prompt_len:
                c = min(self.config.chunk_size, r.prompt_len - r.prefilled,
                        budget)
                if c > 0:
                    prefills.append(PrefillChunk(r, r.prefilled, c))
                    budget -= c
        # admit new requests while slots + budget remain
        while (self.waiting and self._free_slots and budget > 0
               and len(self.running) < self.config.max_num_seqs):
            r = self.waiting.popleft()
            r.slot = self._free_slots.pop()
            self.running.append(r)
            # prefix-cache hit: cached session-context tokens skip
            # prefill, but the last prompt token always runs so prefill
            # completion can emit the first token
            hit = 0
            if self.config.prefix_caching and r.cached_prefix > 0:
                hit = min(r.cached_prefix, r.prompt_len - 1)
            r.prefilled = hit
            r.cache_hit_tokens = hit
            c = min(self.config.chunk_size, r.prompt_len - r.prefilled,
                    budget)
            prefills.append(PrefillChunk(r, r.prefilled, c))
            budget -= c
        return IterationPlan(prefills, decodes)

    # ------------------------------------------------------------------

    def complete_iteration(self, plan: IterationPlan, now: float,
                           record_times: bool = True):
        """Advance request states after the engine/sim executed ``plan`` and
        clocked its end at ``now``.  ``record_times=False`` skips the
        per-token timestamp bookkeeping (progress counters and finish
        state still advance) — the event-driven engine records token
        events itself and rewrites every timestamp at the end, so the
        placeholder appends would be pure waste on its hot path."""
        for chunk in plan.prefills:
            r = chunk.req
            r.prefilled += chunk.length
            if r.prefilled >= r.prompt_len:
                # prefill completion emits the first token
                r.generated += 1
                if record_times:
                    r.first_token_t = now
                    r.token_times.append(now)
                self._maybe_finish(r, now)
        for r in plan.decodes:
            r.generated += 1
            if record_times:
                r.token_times.append(now)
            self._maybe_finish(r, now)

    def _maybe_finish(self, r: Request, now: float):
        if r.generated >= r.max_new_tokens:
            r.finish_t = now
            self.running.remove(r)
            self._free_slots.append(r.slot)
