"""chip_smoke.py's ``[12 mixed]`` pricing on the CPU: the raw price of a
model call (the DB's points at each call-graph row's mapped key, no fit),
DoolySim's fitted price in its terms, and the gap between them, which is
the fit's residual at those keys; both packages' DoolySim pricing one
mixed iteration (a chunk of each bucket beside the decode batch) alike on
one DB; and the engine's timeline marks, which the decomposition reads.

The DB is llama3-smoke profiled by the port with ``h100_analytical`` (a
roofline counted on meta tensors, deterministic) over a sweep whose token
points hold the chunk buckets and whose context holds the engine's cache
length, so that every row but the head's at a chunk is at an exact key.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.database import LatencyDB as JaxLatencyDB
from repro.serving import scheduler as jax_scheduler
from repro.sim.simulator import DoolySim as JaxDoolySim
from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.profiler import DoolyProf, SweepConfig
from repro_torch.serving import Engine, SchedulerConfig
from repro_torch.serving.engine import IterationRecord, span_s
from repro_torch.sim.simulator import DoolySim

ROOT = Path(__file__).resolve().parents[1]
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
SCHED = dict(max_num_seqs=4, max_batch_tokens=512, chunk_size=256)
MAX_SEQ = 512
BUCKETS = (64, 128, 256)
SWEEP = SweepConfig(toks=(8, 64, 128, 256), reqs=(1, 4), ctx=(MAX_SEQ,),
                    op_points=((8, 1), (64, 1), (128, 1), (256, 1), (1, 4)),
                    repeats=20)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """(cfg, DB path): llama3-smoke profiled by the port into a file."""
    cfg = get_smoke_config("llama3-8b")
    path = str(tmp_path_factory.mktemp("db") / "mixed.sqlite")
    with LatencyDB(path) as db:
        DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=SWEEP,
                  device="cpu").profile_model(cfg, backend=BACKEND)
    return cfg, path


def _sim(cfg, db):
    sim = DoolySim(cfg, db, hardware=HW, backend=BACKEND,
                   sched_config=SchedulerConfig(**SCHED), max_seq=MAX_SEQ,
                   overhead_s=3e-5, chunk_overhead_s=2e-5)
    sim.decode_scale = 1.25
    return sim


def _points(db):
    points = {}
    for sig, phase, t, r, c, us in db.measurements_for_hardware(HW):
        points.setdefault((sig, phase), []).append((t, r, c, us))
    return points


def _keys(sim, bucket):
    return [("prefill", bucket, 1, MAX_SEQ), sim.latency._decode_key()]


@pytest.mark.parametrize("bucket", BUCKETS)
def test_raw_price_is_the_dbs_points_at_exact_keys(profiled, bucket):
    """The raw price of a chunk call and of the decode call: every row's
    count times the DB's point at its mapped key, read straight from the
    measurements table.  Every row is at an exact key but the head's at a
    chunk (clamped to one token, which the sweep does not hold) and the
    ops measured at one point only (the embedding's gather), which take
    their nearest point."""
    cfg, path = profiled
    with LatencyDB(path) as db:
        sim = _sim(cfg, db)
        lat = sim.latency
        for key in _keys(sim, bucket):
            price = cs._call_price(lat, _points(db), key)
            want, inexact = 0.0, []
            for row in lat.rows:
                stored = db.measurement_map(row.sig, HW)
                us = stored.get(lat._map_row(row, *key))
                if us is None:
                    inexact.append(row)
                    assert "lm_head" in row.module or list(stored) == [
                        ("prefill", 0, 0, 0)], (row.module, sorted(stored))
                    # the nearest in log tokens: one token of 4 requests
                    us = next(iter(stored.values())) if len(stored) == 1 else \
                        stored[("prefill", 1, 4, 0)]
                want += row.count * us * 1e-6
            assert price["rows"] == len(lat.rows)
            assert price["exact"] == len(lat.rows) - len(inexact) > 0
            assert any("lm_head" in r.module for r in inexact) == (key[0] == "prefill")
            assert price["raw"] == pytest.approx(want, rel=1e-12)
            assert price["calls"] == sum(row.count for row in lat.rows)
            assert sum(g[0] for g in price["groups"].values()) == \
                pytest.approx(price["raw"], rel=1e-12)
            assert {"self_attn", "linear", "other"} <= set(price["groups"])


@pytest.mark.parametrize("bucket", BUCKETS)
def test_fitted_minus_raw_is_the_fits_residual(profiled, bucket):
    """DoolySim's price of a mixed iteration less the raw price is the
    calibration terms plus, row by row, the fit's residual at the row's
    key: count x (the fit's prediction - the DB's point)."""
    cfg, path = profiled
    with LatencyDB(path) as db:
        sim = _sim(cfg, db)
        lat, points = sim.latency, _points(db)
        price = cs._iteration_price(lat, points, bucket, True)
        assert price["fit_s"] == pytest.approx(
            sim.predict_trace([((bucket,), SCHED["max_num_seqs"])])[0],
            rel=1e-12)
        residual = {}
        for key in _keys(sim, bucket):
            residual[key[0]] = sum(
                p["row"].count * (p["fit_s"] - p["point_us"] * 1e-6)
                for p in cs._row_prices(lat, points, key))
            fitted = cs._call_price(lat, points, key)
            assert fitted["fit"] - fitted["raw"] == pytest.approx(
                residual[key[0]], abs=1e-15)
        terms = price["terms"]
        assert terms["overhead"] == 3e-5 and terms["chunk_overhead"] == 2e-5
        # decode_scale 1.25 scales the fitted decode rows, not the raw ones
        dec_raw = price["calls"]["decode"]["raw"]
        assert price["fit_s"] - price["raw_s"] == pytest.approx(
            3e-5 + 2e-5 + residual["prefill"] + 1.25 * residual["decode"]
            + 0.25 * dec_raw, rel=1e-9)
        alone = cs._iteration_price(lat, points, bucket, False)
        assert alone["terms"]["decode"] == 0 and alone["calls"]["decode"] is None
        assert alone["raw_s"] == price["calls"]["chunk"]["raw"]


@pytest.mark.parametrize("bucket", BUCKETS)
def test_both_simulators_price_a_mixed_iteration_alike(profiled, bucket):
    """One chunk of each bucket beside the decode batch, and alone, priced
    by the reference's DoolySim and the port's on one DB file within 1e-9,
    calibration terms included."""
    cfg, path = profiled
    jcfg = jax_smoke_config("llama3-8b")
    plans = [((bucket,), SCHED["max_num_seqs"]), ((bucket,), 0),
             ((bucket, 8), 2)]
    with LatencyDB(path) as db, JaxLatencyDB(path) as jdb:
        sim = _sim(cfg, db)
        jsim = JaxDoolySim(jcfg, jdb, hardware=HW, backend=BACKEND,
                           sched_config=jax_scheduler.SchedulerConfig(**SCHED),
                           max_seq=MAX_SEQ, overhead_s=3e-5,
                           chunk_overhead_s=2e-5)
        jsim.decode_scale = 1.25
        got, want = sim.predict_trace(plans), jsim.predict_trace(plans)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        assert got[0] > got[1] > 0
        rec = IterationRecord(0.0, 1.0, bucket, 3, 1.0, n_chunks=1,
                              chunks=((bucket, 0),))
        assert abs(sim.predict_record(rec) - jsim.predict_record(rec)) < 1e-9


def test_iteration_kinds_by_bucket():
    """Engine records by kind and the bucket of their longest chunk, as the
    calibration run is printed."""
    recs = [IterationRecord(0, 1, 256, 0, 1, n_chunks=1, chunks=((256, 0),)),
            IterationRecord(0, 1, 300, 3, 1, n_chunks=2,
                            chunks=((44, 256), (256, 0))),
            IterationRecord(0, 1, 40, 3, 1, n_chunks=1, chunks=((40, 0),)),
            IterationRecord(0, 1, 0, 4, 1), IterationRecord(0, 1, 0, 4, 1)]
    assert cs._iteration_kinds(recs) == {"chunks 256": 1, "mixed 256": 1,
                                         "mixed 64": 1, "decode": 2}


@pytest.mark.parametrize("last", [True, False])
def test_mixed_shapes_run_through_the_engines_timeline(last):
    """``_mixed_plan``'s shapes on a CPU engine: ``execute`` marks one span a
    step on ``Engine.timeline`` (the chunk, then the decode batch), writes
    the chunk's row and advances every decoding row by one, and the
    timeline stays off unless asked."""
    cfg = get_smoke_config("llama3-8b")
    engine = Engine(cfg, sched_config=SchedulerConfig(**SCHED), max_seq=MAX_SEQ,
                    impl=BACKEND, device="cpu")
    assert engine.timeline is None
    for decodes, steps in ((True, 2), (False, 1)):
        plan, lengths = cs._mixed_plan(engine, 64, last, decodes, start=32,
                                       decode_len=48)
        assert plan.prefills[0].req.prompt_len == 32 + 64 * (1 if last else 2)
        assert len(plan.decodes) == (SCHED["max_num_seqs"] - 1 if decodes else 0)
        engine.lengths = list(lengths)
        engine.timeline = []
        host = engine.execute(plan)
        marks, engine.timeline = engine.timeline, None
        assert len(marks) == steps
        spans = [span_s(a, b) for a, b in marks]
        assert all(0 < s <= host for s in spans)
        assert span_s(marks[0][0], marks[-1][1]) <= host
        assert engine.lengths == [96] + [48 + decodes] * (SCHED["max_num_seqs"] - 1)
    assert torch.count_nonzero(engine.cache[0]["k"][0, 32:96]) > 0


def test_decomposition_on_a_cpu_engine(profiled):
    """``_mixed_decomposition`` on a CPU engine at smoke size: every shape
    (3 buckets x last or not x with the decode batch or alone), its
    readings, and the four differences summing to DoolySim's error on (a);
    the engine reset afterwards with its timeline off."""
    cfg, path = profiled
    with LatencyDB(path) as db:
        sim = _sim(cfg, db)
        engine = Engine(cfg, sched_config=SchedulerConfig(**SCHED),
                        max_seq=MAX_SEQ, impl=BACKEND, device="cpu")
        out = cs._mixed_decomposition(engine, sim, _points(db), buckets=BUCKETS,
                                      start=32, decode_len=48, repeats=2)
    assert [(sh["bucket"], sh["last"], sh["decodes"]) for sh in out["shapes"]] \
        == [(b, last, dec) for b in BUCKETS for last in (True, False)
            for dec in (True, False)]
    for sh in out["shapes"]:
        assert len(sh["in_iteration"]) == 1 + sh["decodes"]
        assert sh["a"] >= sh["b"] > 0 and sh["c_chunk"] > 0
        assert (sh["c_decode"] > 0) == sh["decodes"]
        diffs = sh["fit_error"] + sh["oracle_error"] - sh["interaction"] - sh["host"]
        assert diffs == pytest.approx(sh["e"] - sh["a"], rel=1e-9, abs=1e-12)
    assert set(out["alone"]) == set(BUCKETS) and out["launch"][64]["chunk"] is None
    assert engine.timeline is None and engine.records == [] and engine.clock == 0


# ---------------------------------------------------------------------------
# the fit's form: a cost in the cache length alone, which the prefill
# features [1, T, T^2, R, ctx*T] cannot hold, as the port's chunk attention
# has one (it materializes the whole cache whatever the chunk's length)
# ---------------------------------------------------------------------------

#: phase 12's sweep of prefill points (``PROFILE_SWEEP``: tokens, requests,
#: cache lengths, 0 included)
GRID = [(t, r, c) for t in (8, 16, 32, 64, 128, 256) for r in (1, 8)
        for c in (0, 512, 2048)]


def _ctx_only_us(t: int, r: int, c: int, per_slot_us: float) -> float:
    """A chunk attention's µs a layer: 30 µs of projections, 1.9 µs a token
    and ``per_slot_us`` a cache slot a request whatever the chunk's length
    (0.18: at 2048 slots about the 0.37 ms a layer that llama3-8b's
    self_attn points carry on an H100 beside their 1.9 µs a token;
    PERF.md)."""
    return 30.0 + 1.9 * t * r + per_slot_us * c * r


@pytest.mark.parametrize("per_slot_us", [0.18, 0.0])
def test_the_reference_fit_misprices_a_ctx_only_cost_as_the_port_does(
        tmp_path, per_slot_us):
    """Item 28's carried cause, pinned on both packages: on points with a
    cost in the cache length alone, the reference's LatencyModel and the
    port's (a verbatim copy) fit the same coefficients and leave the same
    residual at the engine's chunk keys (bucket, 1 request, the full 2048
    slots): short at 64 and 128 tokens, long at 256, where calibration
    fits ``chunk_overhead_s`` on 256-token chunks.  Without that term the
    same fit holds every key."""
    from repro.core.latency_model import LatencyModel as JaxLatencyModel
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.core.signature import Signature
    path = str(tmp_path / "ctx.sqlite")
    sig = Signature.build("self_attn", {"op": "self_attn"}, "", {})
    with LatencyDB(path) as db:
        db.insert_signature(sig)
        for t, r, c in GRID:
            db.add_measurement(sig.hash, "card", "prefill", t, r, c,
                               "cuda_events", _ctx_only_us(t, r, c, per_slot_us))
    with LatencyDB(path) as db, JaxLatencyDB(path) as jdb:
        port, ref = LatencyModel(db, "card"), JaxLatencyModel(jdb, "card")
        residual = {}
        for t in BUCKETS:
            got = port.predict(sig.hash, "prefill", toks=t, reqs=1, ctx=2048)
            want = ref.predict(sig.hash, "prefill", toks=t, reqs=1, ctx=2048)
            assert got * 1e6 == pytest.approx(want * 1e6, abs=1e-9)
            true = _ctx_only_us(t, 1, 2048, per_slot_us)
            residual[t] = (got * 1e6 - true) / true
    if per_slot_us:
        assert residual[64] < -0.05 and residual[128] < 0 < residual[256]
    else:
        assert all(abs(e) < 1e-6 for e in residual.values()), residual
