"""Serving engine: real execution of the scheduler's iteration plans.

Counterpart of ``repro.serving.engine``, with the same static-shape
discipline: one padded cache of ``max_num_seqs`` rows is allocated up front
(absolute-position slots, no ring); decode runs the full row batch every
iteration (inactive rows masked by lengths), prefill chunks run per row
through ``Model.prefill_chunk``, padded to power-of-two buckets, except for
configs with SSM state, whose chunks run at their exact length.  A chunk
runs on a view of its row of the cache and writes into it in place.

On the card every step runs as a CUDA graph, the counterpart of the
reference's jit-compiled programs, and as the reference compiles the decode
program and every chunk bucket in ``warmup``, the engine captures its graphs
there, before any clock starts: the decode step's, and for a config whose
chunks are bucketed one per (bucket, cache row) (``warmup_keys``).  Each
graph is launched once when it is captured, since a graph's first launch
also uploads it to the card.  Capturing all of them up front keeps the
port's own capture events out of served runs: on the H100 every kernel of
every graph runs about 0.35 us slower in one of two states of the card,
and a capture flipped that state in 8 of 66 tries, a clone of a cache row
in 3 of 66, while 2176 iterations served from graphs captured up front
flipped it in none (``examples/torch_graph_state.py``); ``Engine.settle``
waits for the end of the slow state the captures leave, and tells whether
it saw it.  Configs with SSM state run exact-length chunks, whose (length,
row) graphs cannot all be captured up front; each is captured the first
time a plan asks for it, before that iteration's clock starts (the
reference too compiles such a chunk on first use).  ``Engine.captures`` counts the graphs captured after warm-up.
Inputs go through static device buffers (tokens, lengths and the chunk's
``last_pos``) and the logits come back in the graph's static output.  A
step that cannot be captured raises; there is no eager fallback on the
card.  CPU tensors run the same steps eagerly, since CPU graphs do not
exist.

The kernel wrappers count their launches when a graph is captured, not when
it replays; the engine keeps each graph's captured launches apart and adds
them to the wrappers' counters on every replay, so the counts are those of
the eager path.

The engine clock advances by *measured model time* per iteration: host
time around the iteration's work, closed by a device synchronize on the
card.  A trace replay is therefore directly comparable with DoolySim, which
advances the same clock by *predicted* time, driving the same Scheduler.

With ``Engine.timeline`` set to a list, every step an iteration runs (a
graph replay on the card, an eager step on the CPU) appends its start and
end marks to it: CUDA events on the card, host-clock seconds on the CPU
(``span_s`` reads a pair).  It is ``None`` unless a caller asks.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backends import BUSY_CYCLES
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


#: the tokens a row of ``Engine.decode_alone_ms`` holds (fewer if
#: ``max_seq`` is shorter)
STATE_LEN = 384
#: ``Engine.decode_alone_ms``: seconds of back-to-back decode replays before
#: the timed ones
PRIME_S = 1.0
#: ``Engine.settle``: the least fall between two readings that is a flip of
#: the card's state (the H100's two states differ by 8-9 %), how far above
#: the least reading the last two may lie, and the seconds it gives up after
FLIP = 0.05
SETTLED = 0.01
SETTLE_LIMIT_S = 30.0


def settled(readings: List[float]) -> bool:
    """``Engine.settle``'s rule on its readings so far (ms, oldest first):
    one reading lies at least ``FLIP`` below an earlier one, so the card
    went from the slow state to the fast one, and the last two lie within
    ``SETTLED`` of the least.  A card that was fast at every reading never
    passes: the rule cannot tell that from one that stayed slow."""
    if len(readings) < 2:
        return False
    fell = any(r <= (1 - FLIP) * max(readings[:i])
               for i, r in enumerate(readings) if i)
    return fell and max(readings[-2:]) <= (1 + SETTLED) * min(readings)


def chunk_buckets(chunk_size: int) -> List[int]:
    """The chunk lengths a bucketed config runs: the image of
    ``bucket_chunk`` over 1..``chunk_size``, which holds ``chunk_size``
    itself when it is not a power of two."""
    return sorted({bucket_chunk(c, chunk_size) for c in range(1, chunk_size + 1)})


def warmup_keys(cfg: ModelConfig, sched_config: SchedulerConfig) -> List[tuple]:
    """The step graphs an engine captures at warm-up on the card: the decode
    step's, and for a config without SSM state one chunk graph per bucket
    and cache row.  A config with SSM state runs exact-length chunks, whose
    graphs are captured on first use."""
    keys = [("decode",)]
    if cfg.ssm_state == 0:
        keys += [("chunk", b, slot) for b in chunk_buckets(sched_config.chunk_size)
                 for slot in range(sched_config.max_num_seqs)]
    return keys


def mark(device: torch.device):
    """A point in time on ``device``'s work: a CUDA event recorded on the
    current stream on the card, the host clock on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def span_s(start, end) -> float:
    """Seconds between two ``mark``s (the card's must have completed)."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) * 1e-3


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
        self.state_len = min(STATE_LEN, max_seq - 1)
        self.impl = impl
        r = sched_config.max_num_seqs
        self.cache: Cache = self.model.zero_cache(r, max_seq, use_ring=False)
        self.lengths = [0] * r
        self.clock = 0.0
        self.records: List[IterationRecord] = []
        self.graphs: Dict[tuple, StepGraph] = {}
        self.captures = 0           # graphs captured after warm-up
        self._pool = None
        self.timeline: Optional[List[tuple]] = None
        self.warmup()

    # ------------------------------------------------------------------

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def warmup(self):
        """Run the decode step and every chunk bucket once, so that kernel
        builds (the scan kernel's too, through the decode step of an SSM
        config), library set-up and allocator growth land outside timed
        iterations.  On the card, capture and launch once every graph of
        ``warmup_keys``, as the reference compiles every bucket up front:
        on the H100 a capture can flip the card into a state where every
        graph kernel runs about 0.35 us slower, or back (the module
        docstring), and a run must not change state partway because of
        the engine.  The decode graph is captured first and read alone
        (``decode_alone_ms``) before any other graph exists:
        ``first_alone_ms``, the first reading ``settle`` compares.  The
        cache is zeroed afterwards, which also undoes the chunk graphs'
        first launches; ``warmup_s`` keeps the wall seconds all of it
        took."""
        t0 = time.perf_counter()
        r = self.sched.config.max_num_seqs
        self.model.decode_step(self.cache, [0] * r, self._ints(self.lengths),
                               impl=self.impl)
        for b in chunk_buckets(self.sched.config.chunk_size):
            self.model.prefill_chunk(self._row_cache(0), [[0] * b],
                                     self._ints([0]), impl=self.impl,
                                     last_pos=self._ints([0]))
        self.first_alone_ms = None
        if self.device.type == "cuda":
            for key in warmup_keys(self.cfg, self.sched.config):
                self._new_graph(key).graph.replay()     # its first launch
                if key == ("decode",):
                    self.first_alone_ms = self.decode_alone_ms()
        self._zero_cache()
        synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def decode_alone_ms(self, repeats: int = 10) -> float:
        """The decode step alone, every row ``state_len`` tokens into a
        zeroed cache, ``repeats`` times; the median ms.  On the card its
        graph is first replayed back to back for ``PRIME_S`` (on the H100 a
        reading taken right after other graphs ran lies about 1 % above one
        taken after decode replays, in either state of the card), then
        ``repeats`` times, each replay behind a busy kernel (so that no
        launch is timed) between two CUDA events; no replay counts a kernel
        launch.  On the H100 the reading tells which of the card's two
        per-kernel states the engine is in.  On the CPU the eager step runs
        on the host clock.  The engine is ``reset`` before and after, since
        the steps write into the cache."""
        self.reset()
        rows = self.sched.config.max_num_seqs
        on_card = self.device.type == "cuda"
        if on_card:
            g = self.graphs[("decode",)]
            g.inputs["tokens"].fill_(1)
            g.inputs["lengths"].fill_(self.state_len)
            step = g.graph.replay
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < PRIME_S:
                for _ in range(10):
                    step()
                synchronize(self.device)
        else:
            self.lengths = [self.state_len] * rows
            step = lambda: self._decode_eager([1] * rows)      # noqa: E731
        marks = []
        for _ in range(repeats):
            if on_card:
                torch.cuda._sleep(BUSY_CYCLES)
            start = mark(self.device)
            step()
            marks.append((start, mark(self.device)))
        synchronize(self.device)
        self.reset()
        return statistics.median(span_s(a, b) for a, b in marks) * 1e3

    def settle(self, limit_s: float = SETTLE_LIMIT_S) -> bool:
        """Read the decode graph alone (``decode_alone_ms``, whose priming
        replays it back to back) until the readings, warm-up's
        ``first_alone_ms`` first, have ``settled`` or ``limit_s`` seconds
        have passed; then ``reset``.  Returns whether it settled;
        ``settle_ms`` keeps the readings and ``settle_s`` the seconds.  On
        the H100 captures usually leave every graph kernel about 0.35 us
        slower (8-9 % of a decode graph), and sustained graph work ends
        that state: 6 of 6 llama3-8b engines left it within 11 s of decode
        replays, and none went back while serving
        (``examples/torch_graph_state.py``).  A caller that times runs
        against each other settles first, so that they start in the state
        they end in.  False also when the card was fast at every reading,
        which no reading can tell from slow.  Nothing runs on the CPU."""
        t0 = time.perf_counter()
        self.settle_ms: List[float] = []
        done = self.device.type != "cuda"
        while not done and time.perf_counter() - t0 < limit_s:
            self.settle_ms.append(self.decode_alone_ms())
            done = settled([self.first_alone_ms] + self.settle_ms)
        self.reset()
        self.settle_s = time.perf_counter() - t0
        return done

    def _zero_cache(self):
        for c in self.cache:
            for t in c.values():
                t.zero_()

    def reset(self):
        """Back to an empty engine (zeroed cache, lengths, clock, records and
        a fresh scheduler) that keeps its weights, its captured graphs and
        their count, so that a workload can be served again."""
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

    def _step(self, key: tuple) -> Tuple[Callable[[], torch.Tensor],
                                         Dict[str, torch.Tensor]]:
        """The step of ``key`` and its static inputs: ``("decode",)``, or
        ``("chunk", length, slot)`` for a prefill chunk of ``length`` tokens
        (bucketed, or exact for SSM configs) on cache row ``slot``.  A chunk
        runs on views of its row of the cache, so its graph is tied to the
        row."""
        if key[0] == "decode":
            r = self.sched.config.max_num_seqs
            inputs = {"tokens": torch.zeros(r, dtype=torch.long, device=self.device),
                      "lengths": torch.zeros(r, dtype=torch.int32,
                                             device=self.device)}

            def step():
                return self.model.decode_step(self.cache, inputs["tokens"],
                                              inputs["lengths"], impl=self.impl)[0]
            return step, inputs
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
        return step, inputs

    def _new_graph(self, key: tuple) -> StepGraph:
        """Capture the graph of ``key`` (nothing runs) and keep it."""
        self.graphs[key] = g = self._capture(key, *self._step(key))
        return g

    def _graph(self, key: tuple) -> StepGraph:
        """The graph an iteration replays for ``key``.  A bucketed config's
        graphs all exist after warm-up, so a missing one is an error; a
        config with SSM state captures an exact-length chunk's graph here on
        first use, before the iteration's clock starts, and launches it
        once on the row it writes, then puts the row back."""
        if key in self.graphs:
            return self.graphs[key]
        if self.cfg.ssm_state == 0:
            raise KeyError(f"Engine: no graph for step {key}: a config with "
                           f"bucketed chunks captures every graph at warm-up")
        g = self._new_graph(key)
        self.captures += 1
        row = self._row_cache(key[2])
        saved = [{k: t.clone() for k, t in c.items()} for c in row]
        g.graph.replay()        # its first launch, which also uploads it
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

    def _marked(self, step: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``step()``, its start and end marked on ``timeline`` if one is
        kept."""
        if self.timeline is None:
            return step()
        start = mark(self.device)
        out = step()
        self.timeline.append((start, mark(self.device)))
        return out

    def _chunk_graph(self, chunk, length: int, ids: List[int]) -> torch.Tensor:
        g = self.graphs[("chunk", length, chunk.req.slot)]
        g.inputs["tokens"].copy_(torch.tensor([ids]))
        g.inputs["lengths"].fill_(chunk.start)
        g.inputs["last_pos"].fill_(chunk.length - 1)
        return self._marked(g.replay)

    def _chunk_eager(self, chunk, length: int, ids: List[int]) -> torch.Tensor:
        return self._marked(lambda: self.model.prefill_chunk(
            self._row_cache(chunk.req.slot), [ids], self._ints([chunk.start]),
            impl=self.impl, last_pos=self._ints([chunk.length - 1]))[0])

    def _decode_graph(self, toks: List[int]) -> torch.Tensor:
        g = self.graphs[("decode",)]
        g.inputs["tokens"].copy_(torch.tensor(toks))
        g.inputs["lengths"].copy_(torch.tensor(self.lengths, dtype=torch.int32))
        return self._marked(g.replay)

    def _decode_eager(self, toks: List[int]) -> torch.Tensor:
        return self._marked(lambda: self.model.decode_step(
            self.cache, toks, self._ints(self.lengths), impl=self.impl)[0])

    def execute(self, plan: IterationPlan) -> float:
        """Run one iteration plan; returns measured model seconds.  On the
        card the iteration replays graphs (an SSM config's new chunk graph
        captured before the clock starts, ``_graph``); CPU tensors run
        eagerly."""
        on_card = self.device.type == "cuda"
        if on_card:
            for chunk in plan.prefills:
                self._graph(("chunk", self._chunk_len(chunk), chunk.req.slot))
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
