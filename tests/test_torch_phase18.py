"""chip_smoke.py's phase 18 — the pooled ``profile run --workers 2`` and its
faults (a crash, a hang, an error where the card has a device-side assert,
an allocation beyond the device's memory and NaN rows; a run SIGKILLed
after 6 commits and its resume) — run on the CPU at the smoke configs,
where ``h100_analytical`` makes every point deterministic.  The card's
numbers come from ``python3 chip_smoke.py`` on an H100."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.plan import build_plan, execute_plan
from repro_torch.core.profiler import QUICK_SWEEP

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
#: chip_smoke's CLI flags on the CPU (the card's are the defaults)
CLI_ARGS = ["--device", "cpu", "--hardware", "cpu", "--oracle", "h100_analytical"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_18_on_cpu(capsys, tmp_path):
    cs = _chip_smoke()
    serial_db = tmp_path / "phase12.sqlite"
    with LatencyDB(str(serial_db)) as db:
        plan = build_plan(db, [get_smoke_config(m) for m in cs.PROFILE_MODELS],
                          backends=(cs.PROFILE_BACKEND,), hardware="cpu",
                          oracle="h100_analytical", sweep=QUICK_SWEEP,
                          device="cpu")
        rep = execute_plan(db, plan)
    # phase 13's result as phase 18 reads it: the dry run, the serial
    # shards' agreement and seconds (here one serial execute)
    cli = {"dry": {"hardware": "cpu", "plan_points": plan.coverage().plan_points},
           "agreement": {"median": 0.0, "max": 0.0},
           "execute_s": {"shard 0": rep.elapsed_s, "shard 1": 0.0},
           "wall_s": {"shard 0": rep.elapsed_s, "shard 1": 0.0}}
    out = cs.phase18(torch.device("cpu"), CLI_ARGS, cli=cli, compare_db=serial_db,
                     full=False, workdir=tmp_path / "pool")
    printed = capsys.readouterr().out
    assert "[18 pool]" in printed and "[18 faults]" in printed

    pool = out["pool"]
    assert pool["workers"] == cs.POOL_WORKERS
    assert pool["rows"] == cli["dry"]["plan_points"] == rep.rows_written
    assert pool["agreement"]["median"] == pool["agreement"]["max"] == 0.0
    assert pool["longest_s"] > 0 and pool["worker_launches"] == [0, 0, 0, 0]
    # every signature the pooled run measured is one phase 12's DB holds;
    # each worker's medians by op kind and turn, no clock off the card
    assert pool["agreement"]["sigs"] == pool["agreement"]["own_sigs"] == len(plan.tasks)
    assert 1 <= len(pool["spread"]) <= cs.POOL_WORKERS
    assert sum(w["tasks"] for w in pool["spread"].values()) == len(plan.tasks)
    assert all(w["median"]["all"] == 0.0 and w["sm_mhz"] == []
               for w in pool["spread"].values())
    assert f"({len(plan.tasks)} of the pooled DB's {len(plan.tasks)} signatures)" in printed
    assert printed.count("SM clock while measuring not read (no card)") == len(pool["spread"])

    faults = out["faults"]
    assert faults["fired"] == {"crash": 1, "hang": 1, "poison": 1,
                               "oom": cs.POOL_RETRIES + 1,
                               "garbage": cs.POOL_RETRIES + 1}
    assert len(faults["quarantined"]) == 2 and faults["timed_out"] == 1
    assert faults["retried"] == 3 + 2 * cs.POOL_RETRIES
    assert faults["agreement"]["median"] == faults["agreement"]["max"] == 0.0
    assert faults["unusable_exits"] == 0        # the CPU has no such state
    assert faults["after_oom"] >= 1
    assert faults["timeout_s"] == cs.POOL_TIMEOUT_MIN_S
    assert faults["killed_after"] == cs.KILL_AFTER
    with LatencyDB(str(tmp_path / "pool" / "faults.sqlite")) as db:
        sigs = {h for (h,) in db.conn.execute("SELECT hash FROM signatures")}
        assert set(db.measured_hashes("cpu")) == sigs - set(faults["quarantined"])


def test_worker_spread_by_op_kind_and_turn():
    """Hand-built shim records of two workers: each worker's median by op
    kind and by the third of its tasks, its point counts and the SM clocks
    it read; a fault record and a signature the other DB lacks count for
    nothing."""
    cs = _chip_smoke()
    by_sig = {"a": [0.01, 0.03], "b": [0.02], "c": [0.10, 0.20, 0.30],
              "d": [0.05], "e": [0.04], "f": [0.0, 0.02]}
    records = [dict(op, pid=pid, s=0.1, sm_mhz=mhz) for pid, op, mhz in (
        (7, {"op": "mm", "sig": "a"}, 1980),
        (7, {"op": "self_attn", "sig": "c"}, 1980),
        (7, {"op": "mul", "sig": "b"}, 1755),
        (9, {"op": "addmm", "sig": "d"}, None),
        (9, {"op": "rsqrt", "sig": "e"}, None),
        (9, {"op": "silu", "sig": "f"}, None),
        (9, {"op": "mean", "sig": "missing"}, None),
        (9, {"op": "bmm", "sig": "a"}, None),
        (9, {"op": "index", "sig": "b"}, None),
        (9, {"op": "self_attn", "sig": "c"}, None))]
    records.insert(3, {"fault": "crash", "op": "pow", "sig": "x", "pid": 9})
    out = cs._worker_spread(records, by_sig)
    assert sorted(out) == [7, 9]
    w7, w9 = out[7], out[9]
    assert w7["tasks"] == 3 and w9["tasks"] == 7
    assert w7["median"]["mm"] == pytest.approx(0.02)
    assert w7["median"]["self_attn"] == pytest.approx(0.20)
    assert w7["median"]["elementwise"] == pytest.approx(0.02)
    assert w7["median"]["first third"] == pytest.approx(0.02)
    assert w7["median"]["last third"] == pytest.approx(0.02)
    assert w7["median"]["all"] == pytest.approx(0.065)
    assert w7["sm_mhz"] == [1755, 1980]
    # worker 9's seven tasks: thirds of 3, 2 and 2 (3 * i // 7)
    assert w9["points"]["first third"] == 4 and w9["points"]["middle third"] == 2
    assert w9["median"]["middle third"] == pytest.approx(0.02)
    assert w9["median"]["last third"] == pytest.approx(0.15)
    assert w9["median"]["mm"] == pytest.approx(0.03)
    assert w9["points"]["all"] == 10 and w9["sm_mhz"] == []
    assert {cs._op_kind(o) for o in ("mm", "addmm", "bmm")} == {"mm"}
    assert cs._op_kind("self_attn") == "self_attn"
    assert cs._op_kind("embedding") == "elementwise"
