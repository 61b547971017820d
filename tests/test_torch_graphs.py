"""The serving engine's CUDA graphs: on the card ``Engine.execute`` replays
one graph for the decode step and one per (chunk shape, cache row), and must
give what the same steps give run eagerly on the card — the same
``IterationRecord`` schedule, the same logits and final caches (bit for bit
in float32, where both run the same kernels on the same inputs; within bf16
rounding in bfloat16) and the same kernel launches.  The eager reference is
the engine with its two step methods taken from the eager path.

On the CPU the engine runs eagerly (there are no CPU graphs); the tests
here that need no card check the graph keys and the launch bookkeeping.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving import Engine, Request, SchedulerConfig
from repro_torch.serving import engine as engine_mod
from repro_torch.workload import sharegpt_like, synthetic

ROOT = Path(__file__).resolve().parents[1]

SCHED = dict(max_num_seqs=4, max_batch_tokens=64, chunk_size=32)
SPECS = [(40, 5), (9, 3), (57, 2), (23, 6), (31, 1), (14, 4)]
BF16_TOL = 2e-2


class _Recording(Engine):
    """Keeps a copy of every step's logits."""

    def __init__(self, *a, **kw):
        self.logits = []
        super().__init__(*a, **kw)

    def _chunk_graph(self, *a):
        out = super()._chunk_graph(*a)
        self.logits.append(out.clone())
        return out

    def _decode_graph(self, *a):
        out = super()._decode_graph(*a)
        self.logits.append(out.clone())
        return out


class _EagerOnCard(_Recording):
    """The same steps run eagerly on the card."""

    def _chunk_graph(self, *a):
        out = Engine._chunk_eager(self, *a)
        self.logits.append(out.clone())
        return out

    def _decode_graph(self, *a):
        out = Engine._decode_eager(self, *a)
        self.logits.append(out.clone())
        return out


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, 0.0, rng.integers(0, cfg.vocab_size, p).tolist(), o)
            for i, (p, o) in enumerate(SPECS)]


def _launches():
    return tuple(w.launches for w in engine_mod.COUNTED_WRAPPERS)


def _serve(cls, cfg, device):
    eng = cls(cfg, sched_config=SchedulerConfig(**SCHED), max_seq=128,
              impl="kernel", seed=0, device=device)
    before = _launches()
    eng.run(_requests(cfg))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return eng, tuple(a - b for a, b in zip(_launches(), before))


def test_counted_wrappers_are_the_kernel_wrappers():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    assert engine_mod.COUNTED_WRAPPERS == (
        da.decode_attention, fa.flash_attention_fwd, fa.flash_attention_bwd,
        ms.mamba_scan)


def test_step_graph_replay_adds_its_captured_launches():
    """A replay adds the launches its capture counted to the wrappers'
    counters, as many times as it replays."""
    calls = []

    class FakeGraph:
        def replay(self):
            calls.append(1)
    logits = torch.zeros(2)
    g = engine_mod.StepGraph(FakeGraph(), {}, logits, (3, 0, 0, 2))
    before = _launches()
    for _ in range(4):
        assert g.replay() is logits
    after = _launches()
    assert len(calls) == 4
    assert tuple(a - b for a, b in zip(after, before)) == (12, 0, 0, 8)
    for w, n in zip(engine_mod.COUNTED_WRAPPERS, before):
        w.launches = n


def test_cpu_engine_runs_eagerly_and_captures_nothing():
    cfg = get_smoke_config("llama3-8b")
    eng, _ = _serve(_Recording, cfg, torch.device("cpu"))
    assert eng.graphs == {} and eng.logits == []
    assert not eng.sched.has_work() and eng.records


def test_reset_serves_the_same_schedule_again():
    cfg = get_smoke_config("llama3-8b")
    eng, _ = _serve(Engine, cfg, torch.device("cpu"))
    first = [(r.chunks, r.n_decodes) for r in eng.records]
    eng.reset()
    assert eng.records == [] and eng.clock == 0.0 and not any(eng.lengths)
    assert all(not t.any() for c in eng.cache for t in c.values())
    eng.run(_requests(cfg))
    assert [(r.chunks, r.n_decodes) for r in eng.records] == first


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b"])
def test_gpu_graph_engine_matches_eager_steps(cuda, arch, dtype):
    cfg = get_smoke_config(arch).with_overrides(dtype=dtype)
    graphed, graphed_launches = _serve(_Recording, cfg, cuda)
    eager, eager_launches = _serve(_EagerOnCard, cfg, cuda)
    assert [(r.chunks, r.n_decodes) for r in graphed.records] == \
        [(r.chunks, r.n_decodes) for r in eager.records]
    assert graphed_launches == eager_launches
    kernel = 3 if cfg.ssm_state else 0          # the scan, else decode attention
    assert graphed_launches[kernel] > 0
    keys = {k for k in graphed.graphs if k[0] == "chunk"}
    widths = {n for r in graphed.records for n, _ in r.chunks}
    if cfg.ssm_state:                            # exact lengths
        assert {k[1] for k in keys} == widths
    assert ("decode",) in graphed.graphs
    assert len(graphed.logits) == len(eager.logits) > 0
    pairs = list(zip(graphed.logits, eager.logits))
    pairs += [(a, b) for ca, cb in zip(graphed.cache, eager.cache)
              for a, b in zip(ca.values(), cb.values())]
    for a, b in pairs:
        if dtype == "float32":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a.float(), b.float(), atol=BF16_TOL,
                                       rtol=BF16_TOL)


@pytest.mark.gpu
def test_gpu_graphs_are_captured_outside_the_clock(cuda):
    """A bucketed config's engine holds every graph of ``warmup_keys`` once
    it is built, so serving captures none: the first iteration is not
    slower than a later one by a capture's time, and serving twice adds no
    key and no capture."""
    cfg = get_smoke_config("llama3-8b")
    eng = Engine(cfg, sched_config=SchedulerConfig(**SCHED), max_seq=128,
                 impl="kernel", seed=0, device=cuda)
    keys = engine_mod.warmup_keys(cfg, eng.sched.config)
    assert sorted(eng.graphs) == sorted(keys) and eng.captures == 0
    assert len(keys) == 1 + 3 * SCHED["max_num_seqs"]     # buckets 8, 16, 32
    for _ in range(2):
        eng.reset()
        eng.run(_requests(cfg))
        assert sorted(eng.graphs) == sorted(keys) and eng.captures == 0
    assert all(r.model_s < 1.0 for r in eng.records)


@pytest.mark.gpu
def test_gpu_ssm_chunk_graphs_are_captured_on_first_use(cuda):
    """A config with SSM state holds only the decode graph after warm-up;
    each exact-length chunk graph is captured the first time a plan asks
    for it, and serving the trace again captures none."""
    cfg = get_smoke_config("falcon-mamba-7b")
    eng, _ = _serve(Engine, cfg, cuda)
    n = len(eng.graphs)
    assert eng.captures == n - 1 > 0
    eng.reset()
    eng.run(_requests(cfg))
    assert len(eng.graphs) == n and eng.captures == n - 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state_readings() -> dict:
    """llama3-8b at full width on phase 12's engine (every graph captured
    at warm-up, then ``Engine.settle``): its calibration trace, then its
    score trace twice, with the decode graph alone read after the settle
    and after each run (ms).  The engine is freed before anything is
    asserted on the readings, so that a failure does not keep its 18 GB for
    the tests after it."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3-8b")
    eng = Engine(cfg, sched_config=cs.SCHED, max_seq=cs.MAX_SEQ,
                 impl=cs.PROFILE_BACKEND, seed=0, device="cuda")
    try:
        keys = sorted(eng.graphs) == sorted(engine_mod.warmup_keys(cfg, cs.SCHED))
        settled = eng.settle()
        c, s = cs.CALIBRATION, cs.SCORE
        traces = [synthetic(c["n"], rate=c["rate"], prompt_len=c["prompt_len"],
                            out_len=c["out_len"], seed=c["seed"],
                            vocab=cfg.vocab_size)]
        traces += [sharegpt_like(s["n"], rate=s["rate"], seed=s["seed"],
                                 scale=s["scale"], vocab=cfg.vocab_size)
                   for _ in range(2)]
        alone = [eng.decode_alone_ms()]
        for trace in traces:
            eng.reset()
            eng.run(trace)
            alone.append(eng.decode_alone_ms())
        return {"warmup_keys": keys, "captures": eng.captures,
                "settled": settled, "settle_s": eng.settle_s,
                "settle_ms": eng.settle_ms, "first_ms": eng.first_alone_ms,
                "alone_ms": alone}
    finally:
        del eng
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_gpu_phase12_runs_share_one_state_of_the_card(cuda):
    """``_state_readings``: after ``Engine.settle`` (which replays the decode
    graph until it has fallen from the card's slow per-kernel state to the
    fast one and holds, or 30 s), the decode graph alone read after the
    settle and after each of phase 12's three runs agrees within 1 %, so no
    run moves the card to the other state (``examples/torch_graph_state.py``)."""
    out = _state_readings()
    assert out["warmup_keys"] and out["captures"] == 0
    alone = out["alone_ms"]
    spread = (max(alone) - min(alone)) / min(alone)
    assert spread <= 0.01, (
        f"decode graph alone {alone} ms: spread {spread:.4f}; settle "
        f"{'settled' if out['settled'] else 'saw no fall'} in "
        f"{out['settle_s']:.1f} s from {out['first_ms']} ms with only the "
        f"decode graph captured through {out['settle_ms']}")
