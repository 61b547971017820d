"""The port's simulate half of Dooly's loop — ``sim.simulator``,
``api.backends`` and the copied ``sim.{replay,events,metrics}`` and
``workload`` — against the JAX package's, at smoke sizes on the CPU.

A latency DB that the port profiles is read by both packages' DoolySim,
whose predictions must agree within 1e-9.  Against the port's own engine
the test is structural (schedules, not wall-clock MAPE): the MAPE is taken
on the card by ``chip_smoke.py`` phase 12.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api.backends import make_backend as jax_make_backend
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.database import LatencyDB as JaxLatencyDB
from repro.serving import scheduler as jax_scheduler
from repro.sim.simulator import DoolySim as JaxDoolySim
from repro.workload import sharegpt_like as jax_sharegpt_like
from repro_torch.api import ProfileStore, make_backend
from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.profiler import QUICK_SWEEP, DoolyProf
from repro_torch.serving import Engine, Scheduler, SchedulerConfig
from repro_torch.sim import metrics as M
from repro_torch.sim.simulator import DoolySim
from repro_torch.workload import sharegpt_like, synthetic

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
SCHED = dict(max_num_seqs=4, max_batch_tokens=64, chunk_size=32)
MAX_SEQ = 256
COPIES = ["sim/replay", "sim/events", "sim/metrics", "workload/__init__",
          "workload/generators", "workload/trace", "workload/sessions",
          "workload/shapes"]


def _as_copy(ref_text: str) -> str:
    return "\n".join(line.replace("from repro.", "from repro_torch.")
                     if line.startswith("from repro.") else line
                     for line in ref_text.split("\n"))


@pytest.mark.parametrize("name", COPIES)
def test_module_is_a_copy(name):
    ref = (ROOT / "src/repro" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch" / f"{name}.py").read_text()
    assert port == _as_copy(ref)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """(cfg, DB path): llama3-smoke profiled by the port into a file."""
    cfg = get_smoke_config("llama3-8b")
    path = str(tmp_path_factory.mktemp("db") / "latency.sqlite")
    with LatencyDB(path) as db:
        DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                  device="cpu").profile_model(cfg, backend=BACKEND)
    return cfg, path


def _trace(module, cfg, rate=3.0):
    return module(15, rate=rate, seed=3, scale=0.05, vocab=cfg.vocab_size)


@pytest.mark.parametrize("engine", ["events", "loop"])
def test_both_simulators_read_the_ports_db(profiled, engine):
    """The reference's DoolySim and the port's, on one DB file the port
    wrote: equal predictions within 1e-9, calibration terms included."""
    cfg, path = profiled
    jcfg = jax_smoke_config("llama3-8b")
    with LatencyDB(path) as db, JaxLatencyDB(path) as jdb:
        sim = DoolySim(cfg, db, hardware=HW, backend=BACKEND,
                       sched_config=SchedulerConfig(**SCHED), max_seq=MAX_SEQ,
                       overhead_s=1e-4, chunk_overhead_s=2e-5, engine=engine)
        jsim = JaxDoolySim(jcfg, jdb, hardware=HW, backend=BACKEND,
                           sched_config=jax_scheduler.SchedulerConfig(**SCHED),
                           max_seq=MAX_SEQ, overhead_s=1e-4,
                           chunk_overhead_s=2e-5, engine=engine)
        sim.decode_scale = jsim.decode_scale = 1.7
        got, want = sim.run(_trace(sharegpt_like, cfg)), \
            jsim.run(_trace(jax_sharegpt_like, jcfg))
        assert got["engine"] == want["engine"] == engine
        assert len(got["iterations"]) == len(want["iterations"]) > 0
        np.testing.assert_allclose(got["makespan"], want["makespan"], rtol=0,
                                   atol=1e-9)
        gm, wm = M.request_metrics(got["requests"]), \
            M.request_metrics(want["requests"])
        for key in ("ttft", "tpot", "finish"):
            np.testing.assert_allclose(gm[key], wm[key], rtol=0, atol=1e-9)
        points = [("prefill", 32, 1, MAX_SEQ), ("decode", 1, 4, MAX_SEQ),
                  ("prefill", 8, 2, 0)]
        np.testing.assert_allclose(sim.predict_points(points),
                                   jsim.predict_points(points), rtol=0, atol=1e-9)


def test_scalar_and_batched_predictions_agree(profiled):
    cfg, path = profiled
    with LatencyDB(path) as db:
        sim = DoolySim(cfg, db, hardware=HW, backend=BACKEND,
                       sched_config=SchedulerConfig(**SCHED), max_seq=MAX_SEQ)
        for point in (("prefill", 16, 1, MAX_SEQ), ("decode", 1, 4, MAX_SEQ)):
            phase, toks, reqs, ctx = point
            assert abs(sim.predict_call(phase=phase, toks=toks, reqs=reqs, ctx=ctx)
                       - sim.predict_call_scalar(phase=phase, toks=toks,
                                                 reqs=reqs, ctx=ctx)) < 1e-9
        assert not sim.latency.unprofiled_sigs()


def test_oracle_backend_reads_the_db_as_the_reference_does(profiled):
    """Raw-measurement replay on the port's DB, on and off the profiled
    grid, equals the reference's OracleBackend on the same file."""
    cfg, path = profiled
    jcfg = jax_smoke_config("llama3-8b")
    toks, reqs = QUICK_SWEEP.op_points[0]
    points = [("prefill", toks, reqs, 0), ("prefill", 32, 1, MAX_SEQ),
              ("decode", 1, 4, MAX_SEQ)]
    with ProfileStore(path, hardware=HW, oracle=ORACLE, sweep=QUICK_SWEEP,
                      device="cpu") as store, JaxLatencyDB(path) as jdb:
        be = store.backend("oracle", cfg, sched_config=SchedulerConfig(**SCHED),
                           max_seq=MAX_SEQ, backend=BACKEND)
        jbe = jax_make_backend("oracle", jcfg, jdb, hardware=HW, backend=BACKEND,
                               sched_config=jax_scheduler.SchedulerConfig(**SCHED),
                               max_seq=MAX_SEQ)
        np.testing.assert_allclose(be.predict_points(points),
                                   jbe.predict_points(points), rtol=0, atol=1e-9)
        degraded = make_backend("dooly->roofline", cfg, store.db, hardware=HW,
                                backend=BACKEND,
                                sched_config=SchedulerConfig(**SCHED),
                                max_seq=MAX_SEQ)
        assert not degraded.degraded and degraded.active_name == "dooly"


def test_engine_and_sim_schedule_alike(profiled):
    """Structural engine-vs-sim check: the port's engine serves a trace on
    the CPU; DoolySim, calibrated on an engine run, schedules the same
    workload into the same iterations (every request arrives at t=0, so
    the schedule does not depend on latency), and both finish every
    request with its tokens."""
    cfg, path = profiled
    sched = SchedulerConfig(**SCHED)
    engine = Engine(cfg, sched_config=sched, max_seq=MAX_SEQ, impl=BACKEND,
                    device="cpu")
    engine.run(synthetic(3, rate=1.0, prompt_len=40, out_len=4, seed=9,
                         vocab=cfg.vocab_size))
    with LatencyDB(path) as db:
        sim = DoolySim(cfg, db, hardware=HW, backend=BACKEND, sched_config=sched,
                       max_seq=MAX_SEQ)
        fit = sim.calibrate(engine.records)
        assert fit["decode_scale"] > 0 and fit["overhead_s"] >= 0
        engine.reset()
        real = engine.run(_trace(sharegpt_like, cfg, rate=float("inf")))
        predicted = sim.run(_trace(sharegpt_like, cfg, rate=float("inf")),
                            record_plans=True)
    assert predicted["engine"] == "replay"
    assert [(tuple(c for c, _ in r.chunks), r.n_decodes) for r in engine.records] \
        == [(tuple(chunks), n) for chunks, n in predicted["plans"]]
    for run in (real, predicted):
        assert all(r.done and r.generated == r.max_new_tokens
                   for r in run["requests"])
    cmp = M.compare(M.request_metrics(predicted["requests"]),
                    M.request_metrics(real["requests"]))
    assert all(np.isfinite(v) for v in cmp.values())


def test_schedule_reproduction():
    """Identical iteration latencies give identical batch composition: the
    simulator reuses the engine's scheduler."""
    cfg = get_smoke_config("llama3-8b")
    sched_a, sched_b = Scheduler(SchedulerConfig(**SCHED)), \
        Scheduler(SchedulerConfig(**SCHED))
    for r in _trace(sharegpt_like, cfg):
        sched_a.add_request(r)
    for r in _trace(sharegpt_like, cfg):
        sched_b.add_request(r)
    for i in range(50):
        pa, pb = sched_a.schedule(), sched_b.schedule()
        assert [(c.req.rid, c.start, c.length) for c in pa.prefills] == \
            [(c.req.rid, c.start, c.length) for c in pb.prefills]
        assert [r.rid for r in pa.decodes] == [r.rid for r in pb.decodes]
        if pa.empty:
            break
        sched_a.complete_iteration(pa, float(i + 1))
        sched_b.complete_iteration(pb, float(i + 1))
