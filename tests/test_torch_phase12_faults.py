"""chip_smoke.py's phase-12 readings of its own noise, on the CPU: the
iteration that admitted each request (from a run's chunk lengths and its
requests), TTFT MAPE apart over the requests whose admission moved, the
share of a predicted decode iteration that rests on DB points measured near
the oracle's launch floor, and each request's TTFT split into its wait and
the iterations that carry its chunks."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.signature import Signature
from repro_torch.serving.engine import IterationRecord
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig
from repro_torch.sim import metrics as M

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


# ---------------------------------------------------------------------------
# admissions and the TTFT split on hand-built runs
# ---------------------------------------------------------------------------

def _requests(ttft):
    """Three requests (prompts of 6, 3 and 2 tokens, arriving at 0, 0.5 and
    1.0 s), finished, with the given TTFTs."""
    out = []
    for rid, (arrival, n, t) in enumerate(zip((0.0, 0.5, 1.0), (6, 3, 2),
                                              ttft)):
        r = Request(rid, arrival, list(range(n)), 2)
        r.first_token_t, r.finish_t = arrival + t, arrival + t + 0.1
        out.append(r)
    return out


def _records(chunks, dt=0.1):
    """Engine records of ``dt`` seconds, one a chunk tuple ((length,
    start), ...)."""
    return [IterationRecord(dt * i, dt * (i + 1), sum(c for c, _ in ch), 0,
                            dt, n_chunks=len(ch), chunks=ch)
            for i, ch in enumerate(chunks)]


#: run 1: request 0 prefills 4 + 2, request 1 is admitted beside its second
#: chunk, request 2 waits for a free slot (two rows) until iteration 3
RUN_1 = (((4, 0),), ((2, 4), (3, 0)), (), ((2, 0),))
#: request 1 arrives after the second iteration's schedule: admitted one
#: iteration later
SHIFTED = (((4, 0),), ((2, 4),), ((3, 0),), ((2, 0),))
#: the same admissions (at other times: ``_records(SAME, dt=0.12)``)
SAME = RUN_1


@pytest.mark.parametrize("run, want", [(RUN_1, {0: 0, 1: 1, 2: 3}),
                                       (SHIFTED, {0: 0, 1: 2, 2: 3}),
                                       (SAME, {0: 0, 1: 1, 2: 3})])
def test_admissions_of_hand_built_records(run, want):
    plans = cs._engine_plans(_records(run))
    assert cs._admissions(_requests((1, 1, 1)), plans) == want


def test_admissions_refuse_records_that_do_not_fit_the_requests():
    with pytest.raises(ValueError, match="admits more"):
        cs._admissions(_requests((1, 1, 1))[:1], [((4,), 0), ((2, 3), 0)])
    with pytest.raises(ValueError, match="chunk of 5"):
        cs._admissions(_requests((1, 1, 1)), [((4,), 0), ((5,), 0)])
    with pytest.raises(ValueError, match="never admitted"):
        cs._admissions(_requests((1, 1, 1)), [((4,), 0), ((2,), 0)])


@pytest.mark.parametrize("second, moved", [(SHIFTED, [False, True, False]),
                                           (SAME, [False, False, False])])
def test_ttft_split_against_a_hand_computation(second, moved):
    """Run 2 against run 1: which requests moved, and TTFT MAPE over all,
    over those that kept their admission and over those that moved."""
    real, again = _requests((0.4, 0.2, 0.5)), _requests((0.5, 0.3, 0.4))
    a = cs._admissions(real, cs._engine_plans(_records(RUN_1)))
    b = cs._admissions(again, cs._engine_plans(_records(second, dt=0.12)))
    assert cs._moved(again, b, a) == moved
    assert cs._agree(cs._engine_plans(_records(second)),
                     cs._engine_plans(_records(RUN_1))) == (1 if any(moved)
                                                            else 4)
    split = cs._ttft_split(M.request_metrics(again), M.request_metrics(real),
                           moved)
    errs = [abs(0.5 - 0.4) / 0.4, abs(0.3 - 0.2) / 0.2, abs(0.4 - 0.5) / 0.5]
    assert split["all"] == pytest.approx(100 * np.mean(errs))
    kept = [e for e, m in zip(errs, moved) if not m]
    assert split["kept"] == pytest.approx(100 * np.mean(kept))
    assert split["n_kept"] == len(kept) and split["n_moved"] == sum(moved)
    if any(moved):
        assert split["moved"] == pytest.approx(100 * errs[1])
    else:
        assert split["moved"] is None


class _Recording(Scheduler):
    """The scheduler, noting the iteration that admits each request."""

    def __init__(self, config):
        super().__init__(config)
        self.admitted, self.iteration = {}, 0

    def schedule(self):
        plan = super().schedule()
        for c in plan.prefills:
            self.admitted.setdefault(c.req.rid, self.iteration)
        self.iteration += 1
        return plan


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admissions_recover_the_schedulers(seed):
    """A virtual-clock run of the scheduler over staggered requests with
    cached prefixes: the admissions read back from its chunk lengths are
    the scheduler's own."""
    rng = np.random.default_rng(seed)
    cfg = SchedulerConfig(max_num_seqs=4, max_batch_tokens=64, chunk_size=16)
    reqs = [Request(i, float(t), list(range(int(n))), int(k),
                    cached_prefix=int(c))
            for i, (t, n, k, c) in enumerate(zip(
                np.sort(rng.uniform(0, 2, 24)), rng.integers(1, 90, 24),
                rng.integers(1, 12, 24), rng.integers(0, 40, 24)))]
    sched, plans, clock, i = _Recording(cfg), [], 0.0, 0
    while i < len(reqs) or sched.has_work():
        while i < len(reqs) and reqs[i].arrival <= clock:
            sched.add_request(reqs[i])
            i += 1
        plan = sched.schedule()
        if plan.empty:
            sched.iteration -= 1
            clock = reqs[i].arrival
            continue
        clock += 0.01 + 1e-4 * plan.n_tokens
        sched.complete_iteration(plan, clock)
        plans.append((tuple(c.length for c in plan.prefills),
                      len(plan.decodes)))
    assert any(r.cache_hit_tokens for r in reqs)
    assert cs._admissions(reqs, plans) == sched.admitted


# ---------------------------------------------------------------------------
# the near-floor share of a predicted decode iteration
# ---------------------------------------------------------------------------

#: (op, stateful kind?, count, {(phase, toks, reqs, ctx): us}): a norm all
#: under 1 us above the floor, a matmul near it only at the decode batch,
#: and attention well above it
POINTS = {
    "rms_norm": (False, 4, {("prefill", t, r, 0): 0.4
                            for t, r in ((8, 1), (16, 1), (32, 1), (1, 8))}),
    "linear": (False, 2, {("prefill", 8, 1, 0): 3.0, ("prefill", 16, 1, 0): 5.0,
                          ("prefill", 32, 1, 0): 9.0, ("prefill", 1, 8, 0): 0.9}),
    "self_attn": (True, 1, {("decode", 1, r, c): 2.0 + r * c / 64
                            for r in (1, 8) for c in (64, 256)}),
}


@pytest.fixture
def near_floor_sim(tmp_path):
    from repro_torch.api.backends import DoolyBackend
    from repro_torch.sim.simulator import DoolySim
    cfg = get_smoke_config("llama3-8b")
    sched = SchedulerConfig(max_num_seqs=8, max_batch_tokens=64, chunk_size=32)
    db = LatencyDB(str(tmp_path / "floor.sqlite"))
    cid = db.config_id(cfg.name, "kernel", "card")
    points = {}
    for op, (_, count, pts) in POINTS.items():
        sig = Signature.build(op, {"op": op}, "", {})
        db.insert_signature(sig)
        db.add_model_operation(cid, sig.hash, f"layers.0/{op}", count)
        for (phase, t, r, c), us in pts.items():
            db.add_measurement(sig.hash, "card", phase, t, r, c, "cuda_events",
                               us)
            points.setdefault((sig.hash, phase), []).append((t, r, c, us))
    backend = DoolyBackend(cfg, db, hardware="card", backend="kernel",
                           sched_config=sched, max_seq=256)
    sim = DoolySim(cfg, sched_config=sched, max_seq=256, latency=backend)
    sim.overhead_s, sim.decode_scale = 2e-6, 1.5
    yield sim, points
    db.close()


@pytest.mark.parametrize("margin_us, near", [(1.0, ("rms_norm", "linear")),
                                             (0.5, ("rms_norm",)),
                                             (0.1, ())])
def test_near_floor_share_on_points_straddling_the_margin(near_floor_sim,
                                                          margin_us, near):
    """Each row's price at the decode point (the norm and matmul as
    prefill at 1 token x 8 requests, attention at 8 requests x 256), and
    the share of the decode-only iterations' price (overhead included)
    held by the rows whose nearest point is under the margin."""
    sim, points = near_floor_sim
    lm, rows = sim.latency.lm, {r.kind: r for r in sim.latency.rows}
    price = {op: rows[op].count * lm.predict(
        rows[op].sig, "decode" if st else "prefill", toks=1, reqs=8,
        ctx=256 if st else 0) for op, (st, _, _) in POINTS.items()}
    assert price["rms_norm"] == pytest.approx(4 * 0.4e-6, rel=1e-6)
    per_iter = 2e-6 + 1.5 * sum(price.values())
    want = 1.5 * sum(price[op] for op in near) / per_iter
    plans = [((), 8), ((32,), 8), ((), 3), ((16, 16), 0)]
    out = cs._near_floor_share(sim, points, plans, margin_us=margin_us)
    assert out["iterations"] == 2 and out["rows"] == 3
    assert out["near_rows"] == len(near)
    assert out["median"] == out["max"] == pytest.approx(want, rel=1e-12)
    assert out["predicted_ms"] == pytest.approx(per_iter * 1e3, rel=1e-12)
    assert sim.run([])["iterations"] == []
    assert cs._near_floor_share(sim, points, [((8,), 0)])["median"] is None


# ---------------------------------------------------------------------------
# which part of a request's TTFT carries the error
# ---------------------------------------------------------------------------

def test_ttft_parts_of_a_hand_built_run():
    """RUN_1 at half a second an iteration: request 0 is admitted at 0 and
    prefills until 1.0; request 1 arrives at 0.5, is admitted at once and
    done at 1.0; request 2 arrives at 1.0, waits for a row until 1.5 and is
    done at 2.0.  Wait and chunks sum to each TTFT."""
    records = _records(RUN_1, dt=0.5)
    requests = _requests((1.0, 0.5, 1.0))
    wait, chunks = cs._ttft_parts(requests, cs._engine_plans(records),
                                  [r.t_start for r in records])
    assert wait.tolist() == [0.0, 0.0, 0.5]
    assert chunks.tolist() == [1.0, 0.5, 0.5]
    assert (wait + chunks).tolist() == list(
        M.request_metrics(requests)["ttft"])


def test_parts_errors_sum_to_the_ttft_error():
    """Each part's error is a share of the real TTFT: the wait's and the
    chunks' signed errors sum to TTFT's, over every request and apart over
    the kept and the moved ones."""
    real = (np.array([0.0, 0.0, 0.5]), np.array([1.0, 0.5, 0.5]))
    pred = (np.array([0.1, 0.0, 0.25]), np.array([1.2, 0.5, 0.45]))
    out = cs._parts_errors(pred, real, [False, False, True])
    ttft = real[0] + real[1]
    wait = (pred[0] - real[0]) / ttft * 100
    chunks = (pred[1] - real[1]) / ttft * 100
    assert out["wait"]["all"]["bias"] == pytest.approx(wait.mean())
    assert out["chunks"]["all"]["mape"] == pytest.approx(np.abs(chunks).mean())
    assert out["wait"]["kept"]["mape"] == pytest.approx(np.abs(wait[:2]).mean())
    assert out["chunks"]["moved"]["bias"] == pytest.approx(chunks[2])
    total = ((pred[0] + pred[1]) - ttft) / ttft * 100
    for key, mask in (("all", [0, 1, 2]), ("kept", [0, 1]), ("moved", [2])):
        assert out["wait"][key]["bias"] + out["chunks"][key]["bias"] == \
            pytest.approx(total[mask].mean())
    assert cs._parts_errors(pred, real, [False] * 3)["wait"]["moved"] is None


class _Priced:
    """DoolySim's pricing as ``_iteration_errors`` reads it: a tenth over
    each iteration's measured time, no overheads."""
    overhead_s = chunk_overhead_s = 0.0

    @staticmethod
    def predict_record(r):
        return 1.1 * r.model_s


def test_admitting_iterations_by_kind_and_bucket():
    """Only the iterations that admitted a request, keyed by their kind and
    the bucket of their longest chunk."""
    records = _records(RUN_1, dt=0.5)
    records[1].n_decodes = 1                     # a mixed iteration
    admitting = set(cs._admissions(_requests((1.0, 0.5, 1.0)),
                                   cs._engine_plans(records)).values())
    assert admitting == {0, 1, 3}
    out = cs._admitting_errors(_Priced(), records, admitting)
    assert sorted(out) == ["chunks 8", "mixed 8"]
    assert out["chunks 8"]["n"] == 2 and out["mixed 8"]["n"] == 1
    assert all(v["bias"] == pytest.approx(10.0) for v in out.values())
    assert "decode" in cs._iteration_errors(_Priced(), records)
