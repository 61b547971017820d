"""The engine's warm-up key list (``repro_torch.serving.engine.warmup_keys``).

On the card an engine whose config has bucketed chunks (no SSM state)
captures the decode graph and one chunk graph per (bucket, cache row) at
warm-up, as the reference compiles the decode program and every chunk
bucket in ``warmup``, and ``execute`` captures nothing.  On the CPU the
engine runs eagerly, so the list is held here against the (length, row)
keys a trace served eagerly actually uses (recorded from ``_chunk_eager``)
and against the chunk programs the JAX engine compiles for the same trace.
The reference's warm-up loop (``while b <= chunk_size``) misses
``chunk_size`` when it is not a power of two and compiles that chunk inside
a timed iteration; the port's list holds it.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving import scheduler as jax_scheduler
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import bucket_chunk as jax_bucket_chunk
from repro_torch.configs import get_smoke_config
from repro_torch.serving import Engine, SchedulerConfig, bucket_chunk
from repro_torch.serving import scheduler as port_scheduler
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import chunk_buckets, warmup_keys

torch.set_num_threads(2)

#: (prompt tokens, new tokens), all arriving at t=0
SPECS = [(40, 3), (9, 2), (57, 2), (23, 3), (100, 1), (14, 2), (48, 1), (5, 2)]
ROWS, BUDGET, MAX_SEQ = 4, 64, 128


class _Keys(Engine):
    """Records the step keys the eager engine runs while serving."""

    def __init__(self, *a, **kw):
        self.keys = []
        super().__init__(*a, **kw)

    def _chunk_eager(self, chunk, length, ids):
        self.keys.append(("chunk", length, chunk.req.slot))
        return super()._chunk_eager(chunk, length, ids)

    def _decode_eager(self, toks):
        self.keys.append(("decode",))
        return super()._decode_eager(toks)


def _requests(module, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [module.Request(i, 0.0, rng.integers(0, vocab, p).tolist(), o)
            for i, (p, o) in enumerate(SPECS)]


def _sched(module, chunk_size):
    return module.SchedulerConfig(max_num_seqs=ROWS, max_batch_tokens=BUDGET,
                                  chunk_size=chunk_size)


def _serve(arch, chunk_size):
    cfg = get_smoke_config(arch)
    eng = _Keys(cfg, sched_config=_sched(port_scheduler, chunk_size),
                max_seq=MAX_SEQ, impl="kernel", seed=0, device="cpu")
    eng.run(_requests(port_scheduler, cfg.vocab_size))
    return cfg, eng


@pytest.mark.parametrize("arch,chunk_size", [("llama3-8b", 32), ("llama3-8b", 48),
                                             ("falcon-mamba-7b", 32)])
def test_warmup_keys_hold_every_step_a_trace_runs(arch, chunk_size):
    cfg, eng = _serve(arch, chunk_size)
    used = set(eng.keys)
    keys = warmup_keys(cfg, eng.sched.config)
    assert keys[0] == ("decode",) and ("decode",) in used
    assert eng.graphs == {} and eng.captures == 0      # the CPU runs eagerly
    widths = {n for r in eng.records for n, _ in r.chunks}
    if cfg.ssm_state:
        # exact-length chunks: only the decode graph is known up front
        assert keys == [("decode",)]
        assert {k[1] for k in used if k[0] == "chunk"} == widths
        return
    assert used <= set(keys) and len(keys) == len(set(keys))
    buckets = sorted({k[1] for k in keys[1:]})
    assert buckets == sorted({bucket_chunk(c, chunk_size)
                              for c in range(1, chunk_size + 1)})
    assert buckets == [b for b in (8, 16, 32, 64, 128, 256) if b < chunk_size] \
        + [chunk_size]
    assert {k[2] for k in keys[1:]} == set(range(ROWS))
    assert len(keys) == 1 + len(buckets) * ROWS
    assert {bucket_chunk(n, chunk_size) for n in widths} == \
        {k[1] for k in used if k[0] == "chunk"}


@pytest.mark.parametrize("chunk_size", [32, 48])
def test_warmup_buckets_against_the_reference_engine(chunk_size):
    """The JAX engine compiles its warm-up buckets, then, serving the same
    trace, whatever chunk length it meets first inside a timed iteration.
    The port's list holds all of them before any clock starts."""
    cfg, eng = _serve("llama3-8b", chunk_size)
    jeng = JaxEngine(jax_smoke_config("llama3-8b"),
                     sched_config=_sched(jax_scheduler, chunk_size),
                     max_seq=MAX_SEQ, impl="xla", seed=0)
    at_warmup = set(jeng._chunk_fns)
    jeng.run(_requests(jax_scheduler, cfg.vocab_size))
    compiled = set(jeng._chunk_fns)
    buckets = set(chunk_buckets(chunk_size))
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert at_warmup <= compiled <= buckets
    assert {k[1] for k in eng.keys if k[0] == "chunk"} == compiled
    # the reference's loop misses a chunk_size that is not a power of two,
    # which this trace then compiles inside the clock
    assert buckets - at_warmup == ({chunk_size} if chunk_size & (chunk_size - 1)
                                   else set())
    assert chunk_size in compiled


@pytest.mark.parametrize("chunk_size", [1, 7, 8, 48, 100, 256])
def test_chunk_buckets_are_the_image_of_bucket_chunk(chunk_size):
    buckets = chunk_buckets(chunk_size)
    assert buckets == sorted(set(buckets)) and buckets[-1] == chunk_size
    for c in range(1, chunk_size + 1):
        b = bucket_chunk(c, chunk_size)
        assert b == jax_bucket_chunk(c, chunk_size)
        assert b in buckets and c <= b


def test_a_missing_graph_of_a_bucketed_config_is_an_error():
    """``_graph`` captures nothing for a bucketed config: a key that warm-up
    did not capture is an error naming it (on the CPU no key is captured)."""
    eng = Engine(get_smoke_config("llama3-8b"),
                 sched_config=SchedulerConfig(max_num_seqs=2, max_batch_tokens=32,
                                              chunk_size=16),
                 max_seq=64, impl="kernel", seed=0, device="cpu")
    with pytest.raises(KeyError, match=r"\('chunk', 8, 1\)"):
        eng._graph(("chunk", 8, 1))
    assert eng.graphs == {} and eng.captures == 0 and eng.warmup_s > 0
    eng.reset()
    assert eng.captures == 0 and eng.warmup_s > 0



@pytest.mark.parametrize("readings, expect", [
    ([10.64, 10.52, 9.64, 9.63], True),         # slow after warm-up, then fast
    ([10.63, 9.74, 9.64, 9.64], True),          # fast once the captures were done
    ([9.44, 10.30, 10.32, 9.38, 9.45], True),   # slowed by the captures, then fast
    ([10.64, 10.64, 10.52, 10.52], False),      # slow throughout: no fall
    ([9.64, 9.63, 9.64], False),                # fast throughout: cannot tell
    ([10.64, 9.64], False),                     # one reading after the fall
    ([10.64, 9.64, 10.50], False),              # back to slow
    ([10.64, 9.64, 9.75], False),               # not yet steady
])
def test_settle_rule(readings, expect):
    """``Engine.settle`` stops once one reading has fallen at least 5 %
    below an earlier one (the H100's two per-kernel states differ by 8-9
    %) and the last two lie within 1 % of the least; the first reading is
    the decode graph's with only itself captured."""
    assert engine_mod.settled(readings) is expect


def test_settle_and_the_decode_reading_on_the_cpu():
    """On the CPU ``settle`` runs nothing and settles; ``decode_alone_ms``
    times the eager decode step and leaves the engine reset."""
    eng = Engine(get_smoke_config("llama3-8b"),
                 sched_config=SchedulerConfig(max_num_seqs=2, max_batch_tokens=32,
                                              chunk_size=16),
                 max_seq=64, impl="kernel", seed=0, device="cpu")
    assert eng.first_alone_ms is None and eng.state_len == 63
    assert eng.settle() is True and eng.settle_ms == []
    ms = eng.decode_alone_ms(repeats=3)
    assert np.isfinite(ms) and ms > 0
    assert eng.lengths == [0, 0] and eng.records == []
    assert all(float(t.abs().sum()) == 0 for c in eng.cache for t in c.values())
