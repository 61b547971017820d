"""Serving engine: real execution of the scheduler's iteration plans.

Counterpart of ``repro.serving.engine``, with the same static-shape
discipline: one padded cache of ``max_num_seqs`` rows is allocated up front
(absolute-position slots, no ring); decode runs the full row batch every
iteration (inactive rows masked by lengths), prefill chunks run per row
through ``Model.prefill_chunk``, padded to power-of-two buckets, except for
configs with SSM state, whose chunks run at their exact length.  A chunk
runs on a view of its row of the cache and writes into it in place.

On the card every step runs as a CUDA graph, the counterpart of the
reference's jit-compiled programs: one graph for the decode step, captured
at warm-up, and one per (chunk shape, cache row), captured the first time
the plan asks for it and before that iteration's clock starts.  Each graph
is launched once when it is captured, since a graph's first launch also
uploads it to the card.  Inputs go
through static device buffers (tokens, lengths and the chunk's ``last_pos``)
and the logits come back in the graph's static output.  A step that cannot
be captured raises; there is no eager fallback on the card.  CPU tensors run
the same steps eagerly, since CPU graphs do not exist.

The kernel wrappers count their launches when a graph is captured, not when
it replays; the engine keeps each graph's captured launches apart and adds
them to the wrappers' counters on every replay, so the counts are those of
the eager path.

The engine clock advances by *measured model time* per iteration: host
time around the iteration's work, closed by a device synchronize on the
card.  A trace replay is therefore directly comparable with DoolySim, which
advances the same clock by *predicted* time, driving the same Scheduler.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device, synchronize
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
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


#: the kernel wrappers whose ``.launches`` a graph's replay adds to
COUNTED_WRAPPERS = (_da.decode_attention, _fa.flash_attention_fwd,
                    _fa.flash_attention_bwd, _ms.mamba_scan)


@dataclass
class StepGraph:
    """One captured step: its graph, its static inputs and output, and the
    kernel launches (per ``COUNTED_WRAPPERS``) its capture counted."""
    graph: Any
    inputs: Dict[str, torch.Tensor]
    logits: torch.Tensor
    launches: Tuple[int, ...]

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for wrapper, n in zip(COUNTED_WRAPPERS, self.launches):
            wrapper.launches += n
        return self.logits


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
        self.graphs: Dict[tuple, StepGraph] = {}
        self._pool = None
        self.warmup()

    # ------------------------------------------------------------------

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def warmup(self):
        """Run the decode step and every chunk bucket once, so that kernel
        builds (the scan kernel's too, through the decode step of an SSM
        config), library set-up and allocator growth land outside timed
        iterations; the cache is zeroed afterwards.  On the card the decode
        step's graph is captured here and launched once."""
        r = self.sched.config.max_num_seqs
        self.model.decode_step(self.cache, [0] * r, self._ints(self.lengths),
                               impl=self.impl)
        b = 8
        while b <= self.sched.config.chunk_size:
            self.model.prefill_chunk(self._row_cache(0), [[0] * b],
                                     self._ints([0]), impl=self.impl,
                                     last_pos=self._ints([0]))
            b *= 2
        if self.device.type == "cuda":
            self._step_graph(("decode",)).graph.replay()    # its first launch
        self._zero_cache()
        synchronize(self.device)

    def _zero_cache(self):
        for c in self.cache:
            for t in c.values():
                t.zero_()

    def reset(self):
        """Back to an empty engine (zeroed cache, lengths, clock, records and
        a fresh scheduler) that keeps its weights and captured graphs, so
        that a workload can be served again."""
        self._zero_cache()
        synchronize(self.device)
        self.sched = Scheduler(self.sched.config)
        self.lengths = [0] * self.sched.config.max_num_seqs
        self.clock = 0.0
        self.records = []

    def _row_cache(self, slot: int) -> Cache:
        """Views of one row of every layer's cache."""
        return [{k: t[slot:slot + 1] for k, t in c.items()} for c in self.cache]

    # ------------------------------------------------------------------
    # CUDA graphs
    # ------------------------------------------------------------------

    def _step_graph(self, key: tuple) -> StepGraph:
        """The graph of ``key``: ``("decode",)``, or ``("chunk", length,
        slot)`` for a prefill chunk of ``length`` tokens (bucketed, or exact
        for SSM configs) on cache row ``slot``; captured on first use.  A
        chunk runs on views of its row of the cache, so its graph is tied to
        the row."""
        if key in self.graphs:
            return self.graphs[key]
        if key[0] == "decode":
            r = self.sched.config.max_num_seqs
            inputs = {"tokens": torch.zeros(r, dtype=torch.long, device=self.device),
                      "lengths": torch.zeros(r, dtype=torch.int32,
                                             device=self.device)}

            def step():
                return self.model.decode_step(self.cache, inputs["tokens"],
                                              inputs["lengths"], impl=self.impl)[0]
        else:
            _, length, slot = key
            inputs = {"tokens": torch.zeros((1, length), dtype=torch.long,
                                            device=self.device),
                      "lengths": torch.zeros(1, dtype=torch.int32, device=self.device),
                      "last_pos": torch.zeros(1, dtype=torch.int32,
                                              device=self.device)}
            row = self._row_cache(slot)

            def step():
                return self.model.prefill_chunk(
                    row, inputs["tokens"], inputs["lengths"], impl=self.impl,
                    last_pos=inputs["last_pos"])[0]
        self.graphs[key] = g = self._capture(key, step, inputs)
        if key[0] == "chunk":
            # a graph's first launch uploads it to the card, which a timed
            # iteration must not pay: launch it here on the row it writes,
            # then put the row back (the decode graph's is at warm-up)
            saved = [{k: t.clone() for k, t in c.items()} for c in row]
            g.graph.replay()
            for c, kept in zip(row, saved):
                for k, t in c.items():
                    t.copy_(kept[k])
            synchronize(self.device)    # all of it before the clock starts
        return g

    def _capture(self, key: tuple, step: Callable[[], torch.Tensor],
                 inputs: Dict[str, torch.Tensor]) -> StepGraph:
        """Capture one ``step()`` (nothing runs) and move the launches its
        kernel wrappers counted into the graph's own count.

        All graphs share one memory pool: a replay may reuse memory that
        another graph's intermediates used.  That is safe because replays
        run one after another on one stream, and each graph's logits stay
        allocated as its static output, which the engine reads (argmax)
        right after the replay and before the next one."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [w.launches for w in COUNTED_WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                logits = step()
        except RuntimeError as e:
            raise RuntimeError(f"Engine: step {key} cannot be captured in a "
                               f"CUDA graph: {e}") from e
        finally:
            launches = tuple(w.launches - n for w, n in zip(COUNTED_WRAPPERS, before))
            for w, n in zip(COUNTED_WRAPPERS, before):
                w.launches = n
        return StepGraph(graph, inputs, logits, launches)

    # ------------------------------------------------------------------

    def _chunk_len(self, chunk) -> int:
        # SSM state is sequential: pad tokens would advance it, so configs
        # with SSM state run exact-length chunks (no bucketing)
        return chunk.length if self.cfg.ssm_state > 0 else \
            bucket_chunk(chunk.length, self.sched.config.chunk_size)

    def _decode_tokens(self, plan: IterationPlan) -> List[int]:
        # replay mode: deterministic dummy token ids (latency-identical)
        toks = [0] * self.sched.config.max_num_seqs
        for r in plan.decodes:
            toks[r.slot] = 1 + (r.generated % 7)
        return toks

    def _chunk_graph(self, chunk, length: int, ids: List[int]) -> torch.Tensor:
        g = self.graphs[("chunk", length, chunk.req.slot)]
        g.inputs["tokens"].copy_(torch.tensor([ids]))
        g.inputs["lengths"].fill_(chunk.start)
        g.inputs["last_pos"].fill_(chunk.length - 1)
        return g.replay()

    def _chunk_eager(self, chunk, length: int, ids: List[int]) -> torch.Tensor:
        return self.model.prefill_chunk(
            self._row_cache(chunk.req.slot), [ids], self._ints([chunk.start]),
            impl=self.impl, last_pos=self._ints([chunk.length - 1]))[0]

    def _decode_graph(self, toks: List[int]) -> torch.Tensor:
        g = self.graphs[("decode",)]
        g.inputs["tokens"].copy_(torch.tensor(toks))
        g.inputs["lengths"].copy_(torch.tensor(self.lengths, dtype=torch.int32))
        return g.replay()

    def _decode_eager(self, toks: List[int]) -> torch.Tensor:
        return self.model.decode_step(self.cache, toks, self._ints(self.lengths),
                                      impl=self.impl)[0]

    def execute(self, plan: IterationPlan) -> float:
        """Run one iteration plan; returns measured model seconds.  On the
        card the iteration replays graphs, any missing one captured before
        the clock starts; CPU tensors run eagerly."""
        on_card = self.device.type == "cuda"
        if on_card:
            for chunk in plan.prefills:
                self._step_graph(("chunk", self._chunk_len(chunk), chunk.req.slot))
        run_chunk = self._chunk_graph if on_card else self._chunk_eager
        run_decode = self._decode_graph if on_card else self._decode_eager
        t0 = time.perf_counter()
        new_tokens: Dict[int, int] = {}
        for chunk in plan.prefills:
            r = chunk.req
            b = self._chunk_len(chunk)
            ids = r.prompt[chunk.start:chunk.start + chunk.length]
            ids = ids + [0] * (b - chunk.length)        # pad to the bucket
            logits = run_chunk(chunk, b, ids)
            self.lengths[r.slot] = chunk.start + chunk.length
            if chunk.start + chunk.length >= r.prompt_len:
                new_tokens[r.rid] = int(torch.argmax(logits[0]))
        if plan.decodes:
            logits = run_decode(self._decode_tokens(plan))
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
