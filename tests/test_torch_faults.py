"""The reference's fault gates (``tests/test_faults.py``) held for the port:
supervised plan execution of ``repro_torch`` under deterministic fault
injection (``tests/_faults.py``'s shim through ``REPRO_MEASURE_SHIM``).

Every recovery path keeps the contract the reference's gates hold: a run
that crashed, hung, retried or quarantined lands exactly the rows a
fault-free serial execute of the port lands (quarantined signatures'
measurements apart).  The port profiles yi-9b-smoke at ``kernel`` with
``h100_analytical`` on the CPU, which is deterministic, so the tables
compare bit for bit.

Beyond the reference's gates: the card lock (``core.backends.hold_card``)
on a fake card key, the pool's task deadline counted from the moment a task
takes the card (``core.plan._CardPool``), every task's measurement made
inside the card lock, and the serial path's stop on a CUDA context that a
task left unusable.  The ``gpu`` tests run the pool under ``cuda_events``
on the card.  The kill harness is ``chip_smoke.py --kill-run``, which
phase 18 runs on the card.
"""
import contextlib
import fcntl
import gc
import json
import multiprocessing as mp
import os
import re
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import backends
from repro_torch.core import plan as plan_mod
from repro_torch.core.backends import hold_card
from repro_torch.core.database import LatencyDB
from repro_torch.core.journal import (JournalError, PlanJournal,
                                      read_journal_state)
from repro_torch.core.plan import (PlanExecutionError, build_plan,
                                   execute_plan, read_journal)
from repro_torch.core.profiler import QUICK_SWEEP, DoolyProf, _measure_task_shard
from repro_torch.core.runner import trace_model

ROOT = Path(__file__).resolve().parents[1]
MODEL = "yi-9b"
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
SHIM = "_faults:shim"
FAULT_ENV = ("REPRO_MEASURE_SHIM", "REPRO_FAULT_MODE", "REPRO_FAULT_SIGS",
             "REPRO_FAULT_STATE", "REPRO_FAULT_HANG_S")
#: the hang gate's deadline, as the reference's, and hang (the reference's
#: 120 s; the task is killed at the deadline either way)
TASK_TIMEOUT_S, HANG_S = 15.0, 60.0
#: the most the points of two executions on the card may differ (median
#: relative difference), as chip_smoke.py holds two processes' points
AGREE_LIMIT = 0.10

MEAS_Q = ("SELECT * FROM measurements ORDER BY sig_hash, hardware, phase, "
          "num_toks, num_reqs, ctx_len, oracle")
SIGS_Q = "SELECT * FROM signatures ORDER BY hash"
OPS_Q = ("SELECT * FROM model_operations ORDER BY config_id, sig_hash, "
         "module")


def _tables(db: LatencyDB):
    return {q: db.conn.execute(q).fetchall()
            for q in (MEAS_Q, SIGS_Q, OPS_Q)}


def _build(db, cfgs, traces=None, *, hardware=HW, oracle=ORACLE,
           device="cpu"):
    return build_plan(db, cfgs, backends=(BACKEND,), hardware=hardware,
                      oracle=oracle, sweep=QUICK_SWEEP, traces=traces,
                      device=device)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(MODEL)


@pytest.fixture(scope="module")
def traces(cfg):
    return {cfg.name: trace_model(cfg)}


def _plan(db, cfg, traces):
    return _build(db, [cfg], traces)


@pytest.fixture(autouse=True)
def _no_fault_env(monkeypatch):
    for k in FAULT_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def reference(cfg, traces):
    """(tables, n_tasks) from a fault-free serial execute of the port —
    the bit-identity reference every recovery test compares against."""
    saved = {k: os.environ.pop(k) for k in FAULT_ENV if k in os.environ}
    try:
        with LatencyDB() as db:
            plan = _plan(db, cfg, traces)
            execute_plan(db, plan)
            return _tables(db), len(plan.todo)
    finally:
        os.environ.update(saved)


# -- crash-safe journal --------------------------------------------------

def test_torn_tail_warns_drops_and_remeasures(cfg, traces, tmp_path,
                                              reference):
    ref_tables, n_todo = reference
    ckpt = str(tmp_path / "journal")

    class Boom(RuntimeError):
        pass

    def boom(task, i, n):
        if i >= 2:
            raise Boom

    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        with pytest.raises(Boom):
            execute_plan(db, plan, checkpoint=ckpt, progress=boom)
        assert len(read_journal(ckpt, plan)) == 2
        # tear the tail mid-record, as a crash mid-write would
        with open(ckpt, "rb+") as f:
            f.seek(-5, os.SEEK_END)
            f.truncate()
        with pytest.warns(RuntimeWarning, match="torn final record"):
            done = read_journal(ckpt, plan)
        assert len(done) == 1                   # torn record dropped...
        with pytest.warns(RuntimeWarning, match="torn final record"):
            rep = execute_plan(db, plan, checkpoint=ckpt)
        assert rep.skipped_journal == 1
        assert rep.measured == n_todo - 1       # ...and re-measured
        assert _tables(db) == ref_tables


def test_corrupt_mid_file_is_refused(tmp_path):
    ckpt = str(tmp_path / "journal")
    with PlanJournal(ckpt, "feedc0ffee123456") as j:
        j.record_done("task-a")
        j.record_done("task-b")
    lines = Path(ckpt).read_text().splitlines()
    lines[1] = lines[1][:-4] + "zzzz"           # damage a NON-final record
    Path(ckpt).write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalError, match="corrupt at line 2"):
        read_journal_state(ckpt, "feedc0ffee123456")


def test_quarantine_record_round_trips(tmp_path):
    ckpt = str(tmp_path / "journal")
    with PlanJournal(ckpt, "feedc0ffee123456") as j:
        j.record_done("task-a")
        j.record_quarantine("task-b", "oracle kept\nreturning NaN")
    state = read_journal_state(ckpt, "feedc0ffee123456")
    assert state.done == {"task-a"}
    # multi-line reasons are flattened so they can't forge records
    assert state.quarantined == {"task-b": "oracle kept returning NaN"}
    assert state.dropped_torn == 0


def _harness_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in FAULT_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return env


def test_killed_run_resumes_with_zero_lost_tasks(cfg, traces, tmp_path,
                                                 reference):
    """SIGKILL mid-corpus (``chip_smoke.py --kill-run``: ``profile run``
    of the smoke config, workers=2): every committed task is journaled,
    resume re-measures only the rest, and the final tables are
    indistinguishable from a never-killed run."""
    ref_tables, n_todo = reference
    dbp = str(tmp_path / "lat.sqlite")
    ckpt = str(tmp_path / "journal")
    kill_after = 3
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--kill-run",
         "--models", MODEL, "--backends", BACKEND, "--sweep", "quick",
         "--device", "cpu", "--hardware", HW, "--oracle", ORACLE,
         "--db", dbp, "--checkpoint", ckpt, "--kill-after", str(kill_after),
         "--workers", "2"],
        env=_harness_env(), capture_output=True, text=True, timeout=270)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    (killed_plan, _), = [line.split()[-2:] for line in proc.stdout.splitlines()
                         if line.startswith("kill-run plan: ")]

    with LatencyDB(dbp) as db:
        # the rebuilt plan sees the committed rows as satisfied — dedup
        # against the DB, not the journal — so nothing re-measures
        plan = _plan(db, cfg, traces)
        assert plan.plan_id == killed_plan
        state = read_journal_state(ckpt, plan.plan_id)
        assert len(state.done) == kill_after    # exactly the commits
        rep = execute_plan(db, plan, checkpoint=ckpt)
        assert rep.satisfied == kill_after      # never re-measured
        assert rep.measured == n_todo - kill_after
        assert _tables(db) == ref_tables


# -- supervised retries --------------------------------------------------

def test_worker_crash_is_retried_and_heals(cfg, traces, tmp_path,
                                           monkeypatch, reference):
    ref_tables, n_todo = reference
    state_dir = tmp_path / "state"
    state_dir.mkdir()
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        monkeypatch.setenv("REPRO_MEASURE_SHIM", SHIM)
        monkeypatch.setenv("REPRO_FAULT_MODE", "crash")
        monkeypatch.setenv("REPRO_FAULT_SIGS", plan.todo[3].sig_hash)
        monkeypatch.setenv("REPRO_FAULT_STATE", str(state_dir))
        rep = execute_plan(db, plan, workers=2)
        assert rep.retried >= 1                 # the crash consumed one
        assert rep.quarantined == 0             # ...but the retry healed
        assert rep.measured == n_todo
        assert _tables(db) == ref_tables


def test_hung_task_trips_timeout_and_retries(cfg, traces, tmp_path,
                                             monkeypatch, reference):
    ref_tables, n_todo = reference
    state_dir = tmp_path / "state"
    state_dir.mkdir()
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        monkeypatch.setenv("REPRO_MEASURE_SHIM", SHIM)
        monkeypatch.setenv("REPRO_FAULT_MODE", "hang")
        monkeypatch.setenv("REPRO_FAULT_SIGS", plan.todo[0].sig_hash)
        monkeypatch.setenv("REPRO_FAULT_STATE", str(state_dir))
        monkeypatch.setenv("REPRO_FAULT_HANG_S", str(HANG_S))
        rep = execute_plan(db, plan, workers=1, task_timeout=TASK_TIMEOUT_S)
        assert rep.timed_out >= 1
        assert rep.retried >= 1
        assert rep.quarantined == 0
        assert rep.measured == n_todo
        assert _tables(db) == ref_tables


def test_garbage_quarantined_healthy_rows_bit_identical(cfg, traces,
                                                        tmp_path,
                                                        monkeypatch,
                                                        reference):
    """A persistently-garbage measurement (NaN rows every attempt) is
    rejected by validation, consumes its retries, quarantines — and the
    remaining tasks still land bit-identical to the fault-free run.  The
    quarantine persists in the journal (resume skips it) and leaves the
    signature unmeasured, which a dooly->roofline fallback chain detects
    at construction and degrades on."""
    ref_tables, n_todo = reference
    ckpt = str(tmp_path / "journal")
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        target = plan.todo[0]
        monkeypatch.setenv("REPRO_MEASURE_SHIM", SHIM)
        monkeypatch.setenv("REPRO_FAULT_MODE", "garbage")
        monkeypatch.setenv("REPRO_FAULT_SIGS", target.sig_hash)
        rep = execute_plan(db, plan, checkpoint=ckpt, max_retries=1,
                           retry_backoff_s=0.01)
        assert rep.quarantined == 1 and rep.retried == 1
        (qid, reason), = rep.quarantine
        assert qid == target.task_id
        assert "invalid" in reason
        assert rep.measured == n_todo - 1
        got = _tables(db)
        assert got[MEAS_Q] == [r for r in ref_tables[MEAS_Q]
                               if r[0] != target.sig_hash]
        assert got[SIGS_Q] == ref_tables[SIGS_Q]    # sig lands regardless
        assert got[OPS_Q] == ref_tables[OPS_Q]

        # resume skips the poisoned task instead of re-poisoning the run
        for k in ("REPRO_MEASURE_SHIM", "REPRO_FAULT_MODE",
                  "REPRO_FAULT_SIGS"):
            monkeypatch.delenv(k)
        rep2 = execute_plan(db, plan, checkpoint=ckpt)
        assert rep2.skipped_quarantined == 1
        assert rep2.measured == 0 and rep2.quarantined == 0

        # the unmeasured signature degrades a fallback chain to roofline
        from repro_torch.api import ProfileStore
        from repro_torch.sweep.grid import SchedSpec
        store = ProfileStore.wrap(db, hardware=HW, oracle=ORACLE,
                                  device="cpu")
        be = store.backend("dooly->roofline", cfg, backend=BACKEND,
                           sched_config=SchedSpec().to_config(),
                           max_seq=128)
        assert be.degraded and be.active_name == "roofline"
        assert target.sig_hash[:12] in be.degraded_reason


def test_fail_fast_raises_instead_of_quarantining(cfg, traces,
                                                  monkeypatch):
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        monkeypatch.setenv("REPRO_MEASURE_SHIM", SHIM)
        monkeypatch.setenv("REPRO_FAULT_MODE", "error")
        monkeypatch.setenv("REPRO_FAULT_SIGS", plan.todo[0].sig_hash)
        with pytest.raises(PlanExecutionError,
                           match="failed after retries"):
            execute_plan(db, plan, max_retries=0, fail_fast=True)


def test_unusable_context_stops_the_serial_path(cfg, traces, tmp_path,
                                                monkeypatch, reference):
    """A task whose failure leaves the CUDA context unusable (on the CPU:
    the context check patched to say so after an injected error) stops the
    serial path with an error naming the task.  Nothing is quarantined, the
    journal holds exactly the committed tasks, and a resume measures the
    rest, bit-identical to the clean run."""
    ref_tables, n_todo = reference
    ckpt = str(tmp_path / "journal")
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        target = plan.todo[3]
        monkeypatch.setenv("REPRO_MEASURE_SHIM", SHIM)
        monkeypatch.setenv("REPRO_FAULT_MODE", "error")
        monkeypatch.setenv("REPRO_FAULT_SIGS", target.sig_hash)
        checked = []

        def unusable(device):
            checked.append(device)
            return False
        monkeypatch.setattr(plan_mod, "_context_ok", unusable)
        with pytest.raises(PlanExecutionError,
                           match=re.escape(target.task_id)) as err:
            execute_plan(db, plan, checkpoint=ckpt)
        assert err.value.task_id == target.task_id
        assert "injected failure" in err.value.reason
        assert [d.type for d in checked] == ["cpu"]     # checked once
        state = read_journal_state(ckpt, plan.plan_id)
        assert state.done == {t.task_id for t in plan.todo[:3]}
        assert state.quarantined == {}

        monkeypatch.undo()
        for k in FAULT_ENV:
            monkeypatch.delenv(k, raising=False)
        rep = execute_plan(db, plan, checkpoint=ckpt)
        assert rep.skipped_journal == 3 and rep.quarantined == 0
        assert rep.measured == n_todo - 3
        assert _tables(db) == ref_tables


# -- hygiene -------------------------------------------------------------

def test_execute_plan_closes_journal_handles(cfg, traces, tmp_path,
                                             reference):
    _, n_todo = reference
    ckpt = str(tmp_path / "journal")
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        with warnings.catch_warnings():
            warnings.simplefilter("error", ResourceWarning)
            execute_plan(db, plan, checkpoint=ckpt)
            # second pass exercises the journal freshness probe + resume
            rep = execute_plan(db, plan, checkpoint=ckpt)
            gc.collect()                # unclosed handles would warn here
        assert rep.skipped_journal == n_todo


def test_audit_flags_poisoned_rows(tmp_path, capsys):
    from repro_torch.profile.__main__ import main
    dbp = str(tmp_path / "bad.sqlite")
    with LatencyDB(dbp) as db:
        db.add_measurement("sig-ok", HW, "prefill", 8, 1, 0, ORACLE, 12.5)
        db.add_measurement("sig-neg", HW, "prefill", 8, 1, 0, ORACLE, -1.0)
        db.add_measurement("sig-inf", HW, "prefill", 8, 1, 0, ORACLE,
                           float("inf"))
        bad = db.audit_measurements()
        assert {r[0] for r in bad} == {"sig-inf", "sig-neg"}
        assert db.audit_measurements("other-hw") == []
    assert main(["audit", "--db", dbp, "--json", "-"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["poisoned_rows"] == 2

    clean = str(tmp_path / "clean.sqlite")
    with LatencyDB(clean) as db:
        db.add_measurement("sig-ok", HW, "prefill", 8, 1, 0, ORACLE, 12.5)
    assert main(["audit", "--db", clean]) == 0


def test_validation_policy_remeasures_then_rejects():
    from repro_torch.core.profiler import MeasurementError, ValidationPolicy
    pol = ValidationPolicy()
    vals = iter([float("nan"), 2.5])
    assert pol.check(lambda: next(vals), "op x") == 2.5     # healed once
    with pytest.raises(MeasurementError, match="invalid latency"):
        pol.check(lambda: float("nan"), "op y")
    # high-variance pair flags one re-measure; the final sample lands
    seq = iter([1.0, 5.0, 1.01])
    flaky = ValidationPolicy(max_rel_spread=0.5)
    assert flaky.check(lambda: next(seq), "op z") == 1.01
    # tight pair passes straight through with the first sample
    tight = iter([1.0, 1.01])
    assert flaky.check(lambda: next(tight), "op w") == 1.0


# -- degraded-mode sweep -------------------------------------------------

def test_sweep_32_scenarios_one_failure_reports(cfg, traces):
    """The acceptance grid: 32 scenarios, one referencing an unprofiled
    model — 31 results plus a structured failure report, not an abort."""
    from repro_torch.api import ProfileStore
    from repro_torch.sweep.grid import Scenario, SchedSpec, WorkloadSpec
    with ProfileStore(hardware=HW, oracle=ORACLE, sweep=QUICK_SWEEP,
                      device="cpu") as store:
        store.execute(store.plan(cfg, backends=(BACKEND,), traces=traces))
        wl = WorkloadSpec()
        scns = [Scenario(model=MODEL, sched=SchedSpec(max_num_seqs=s),
                         workload=wl, backend=BACKEND, hardware=HW)
                for s in range(2, 33)]
        scns.append(Scenario(model="command-r7b", sched=SchedSpec(),
                             workload=wl, backend=BACKEND, hardware=HW))
        assert len(scns) == 32
        sweep = store.sweep()
        out = sweep.run(scns)
        assert len(out.results) == 31
        assert len(out.failures) == 1
        fail = out.failures[0]
        assert fail.index == 31 and fail.stage == "build"
        assert fail.scenario.model == "command-r7b"
        assert out.summary["failed"] == 1
        assert "command-r7b" in out.failure_table()
        json.dumps(out.to_json())                   # report is valid JSON
        # raise mode restores the old fail-fast contract
        with pytest.raises(RuntimeError, match="no call-graph rows"):
            sweep.run(scns, on_error="raise")


# -- the card lock and the pool's deadline on a card ---------------------

def _hold_and_report(key: str, lock_dir: str, out: str, hold_s: float,
                     turns: str = None):
    """Spawn target: write ``<out>.asking``, take the card, write the
    monotonic time it was taken to ``out``, hold it ``hold_s`` seconds
    (forever when negative); with ``turns``, ``hold_s`` more once two pool
    workers' turn records there say they wait for the card."""
    Path(f"{out}.asking").write_text(repr(time.monotonic()))
    with hold_card(key, Path(lock_dir)):
        Path(out).write_text(repr(time.monotonic()))
        while turns and sum(" waiting " in f.read_text()
                            for f in Path(turns).iterdir()
                            if not f.name.endswith(".tmp")) < 2:
            time.sleep(0.02)
        time.sleep(hold_s if hold_s >= 0 else 3600)


def _locked(key: str, lock_dir: Path) -> bool:
    """Whether another process holds the card: a non-blocking attempt."""
    fd = os.open(lock_dir / f"card-{key}.lock", os.O_RDWR | os.O_CREAT)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        return True
    finally:
        os.close(fd)
    return False


def _wait_for(path: Path, timeout: float = 60.0) -> float:
    deadline = time.monotonic() + timeout
    while not path.exists() or not path.read_text():
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.02)
    return float(path.read_text())


def test_card_lock_waits_for_the_holder(tmp_path):
    """A second process's acquire waits until the first releases; one
    process may take its own lock again without waiting."""
    key, ctx = "fake-card-wait", mp.get_context("spawn")
    out = tmp_path / "taken"
    with hold_card(key, tmp_path):
        with hold_card(key, tmp_path):          # re-entrant
            pass
        assert _locked(key, tmp_path)           # still held after the inner
        child = ctx.Process(target=_hold_and_report,
                            args=(key, str(tmp_path), str(out), 0.0))
        child.start()
        _wait_for(Path(f"{out}.asking"))
        time.sleep(1.0)                         # the child waits meanwhile
        assert not out.exists()
        released = time.monotonic()
    child.join(60)
    assert child.exitcode == 0
    assert float(out.read_text()) >= released
    assert not _locked(key, tmp_path)


def test_card_lock_is_released_when_its_holder_is_killed(tmp_path):
    key, ctx = "fake-card-kill", mp.get_context("spawn")
    out = tmp_path / "taken"
    child = ctx.Process(target=_hold_and_report,
                        args=(key, str(tmp_path), str(out), -1.0))
    child.start()
    _wait_for(out)
    assert _locked(key, tmp_path)
    os.kill(child.pid, signal.SIGKILL)
    child.join(30)
    assert child.exitcode == -signal.SIGKILL
    assert not _locked(key, tmp_path)
    with hold_card(key, tmp_path):              # taken at once
        assert _locked(key, tmp_path)


def _turn_setup(init):
    (key, lock_dir), turns = init
    return key, lock_dir, turns


def _turn_run(state, payload):
    """Pool task on a fake card: take it as a card worker does
    (``plan._card_turn``), hold it ``hold_s`` seconds (a hang when
    negative), return when it was taken."""
    key, lock_dir, turns = state
    task_id, hold_s = payload
    with plan_mod._card_turn(hold_card(key, Path(lock_dir)), turns, task_id):
        taken = time.monotonic()
        time.sleep(hold_s if hold_s >= 0 else 3600)
    return taken


@pytest.mark.parametrize("fault", [None, "hang", "hang-after-wait",
                                   "outside-holder"],
                         ids=["healthy", "one-hangs", "one-waits-then-hangs",
                              "outside-holder-hangs"])
def test_card_pool_deadline_counts_from_taking_the_card(tmp_path, fault):
    """Two workers share a fake card: each task holds it 1.5 s against a
    2.5 s deadline, so a task that waited for the other's turn would blow
    a deadline counted from its assignment.  Counted from the moment it
    takes the card, no healthy task times out; a task that hangs holding
    the card times out once, and the task waiting behind it does not, also
    when the hung task had waited for the card past its first deadline (a
    process outside the pool holds it until both tasks wait, then 3 s
    more): the pool finds the hang well before the wait limit.  A process outside the pool that
    holds the card and never lets go does not hold the pool forever: each
    task times out once it has waited the pool's ``wait_limit`` (here 5 s;
    by default four turns of each worker at its longest)."""
    key, lock_dir = f"fake-card-pool-{fault}", str(tmp_path)
    tasks = [(f"t{i}", (f"t{i}", 1.5)) for i in range(4)]
    holder = None
    if fault in ("hang", "hang-after-wait"):
        tasks[0] = ("t0", ("t0", -1.0))
    pool = plan_mod._CardPool(
        _turn_setup, _turn_run, (key, lock_dir), card=True, workers=2,
        task_timeout=2.5, max_retries=0,
        wait_limit=5.0 if fault == "outside-holder" else None)
    if fault in ("hang-after-wait", "outside-holder"):
        tasks = tasks[:2]
        holder = mp.get_context("spawn").Process(
            target=_hold_and_report, daemon=True,
            args=(key, lock_dir, str(tmp_path / "outside"), -1.0)
            if fault == "outside-holder" else
            (key, lock_dir, str(tmp_path / "outside"), 3.0, pool.turns))
        holder.start()

    def stuck(*_):
        raise TimeoutError("the pool waited for the card without a limit")
    signal.signal(signal.SIGALRM, stuck)
    signal.alarm(60)
    try:
        if holder is not None:
            _wait_for(tmp_path / "outside")
        t0 = time.monotonic()
        with pool:
            outs = {o.task_id: o for o in pool.run(tasks)}
        took = time.monotonic() - t0
    finally:
        signal.alarm(0)
        if holder is not None:
            holder.kill()
            holder.join(30)
    assert pool.wait_limit == (5.0 if fault == "outside-holder"
                               else plan_mod.CARD_WAIT_TURNS * 2 * 2.5)
    assert not os.path.exists(pool.turns)           # the pool's own records
    if fault == "outside-holder":
        assert all(not o.ok and o.n_timeouts == 1 for o in outs.values()), outs
        assert pool.wait_limit <= took < pool.wait_limit + 2 * 2.5 + 30
        return
    healthy = [o for t, o in outs.items() if not (fault and t == "t0")]
    assert all(o.ok and o.n_timeouts == 0 for o in healthy), outs
    taken = sorted(o.result for o in healthy)
    assert all(b - a >= 1.4 for a, b in zip(taken, taken[1:]))  # in turn
    if fault:
        assert not outs["t0"].ok and outs["t0"].n_timeouts == 1
        assert took < pool.wait_limit


@pytest.mark.parametrize("path", ["pool-worker", "serial", "shard"])
def test_every_measurement_holds_the_card(cfg, traces, monkeypatch, path):
    """Each task's measurement runs inside the card lock on every path that
    measures a plan task: a pool worker's task, the serial execute and
    ``profile_model``'s shard workers.  The lock is a no-op off a card, so
    a recording stand-in takes its place here."""
    held, measured = [], []

    @contextlib.contextmanager
    def lock(device):
        held.append(device)
        try:
            yield
        finally:
            held.pop()
    monkeypatch.setattr(plan_mod, "card_lock", lock)
    monkeypatch.setattr(backends, "card_lock", lock)
    measure = DoolyProf.measure_payload_rows

    def checked(self, payload, cfg, backend):
        assert held, "a task measured outside the card lock"
        measured.append(payload)
        return measure(self, payload, cfg, backend)
    monkeypatch.setattr(DoolyProf, "measure_payload_rows", checked)
    with LatencyDB() as db:
        plan = _plan(db, cfg, traces)
        if path == "serial":
            execute_plan(db, plan)
        tasks = plan.todo[:3]
        for t in tasks if path == "pool-worker" else ():
            prof = DoolyProf(LatencyDB(), oracle=ORACLE, hardware=HW,
                             sweep=QUICK_SWEEP, device="cpu")
            state = (plan_mod._resolve_measure_fn(prof), {cfg.name: cfg}, prof,
                     None)
            plan_mod._plan_worker_run(
                state, (t.task_id, cfg.name, t.backend, t.payload))
        if path == "shard":
            _measure_task_shard((cfg, BACKEND, ORACLE, HW, QUICK_SWEEP, "cpu",
                                 [t.payload for t in tasks]))
    assert not held
    assert len(measured) == (len(plan.todo) if path == "serial" else 3)


# -- on the card ---------------------------------------------------------

def card_fault_shim(prof, payload, cfg, backend):
    """``REPRO_MEASURE_SHIM`` for the card: the targeted task, once, makes a
    device-side assert (an out-of-range index), which leaves the worker's
    CUDA context unusable; every other call measures."""
    from _faults import _fires_once, _payload_sig, _targeted
    sig = _payload_sig(payload)
    if _targeted(sig) and _fires_once("poison", sig):
        x = torch.zeros(4, device=prof.device)
        x[torch.full((1,), 1 << 20, device=prof.device)] += 1
        torch.cuda.synchronize(prof.device)
    return prof.measure_payload_rows(payload, cfg, backend)


def _card_plan():
    """llama3-8b-smoke's plan for ``cuda_events`` on the card.  Each test
    builds it once and executes it twice, serial and pooled, each into a
    fresh DB: the comparison then holds the executions, not two builds'
    kernel fingerprints (``core.signature``), which name the signatures."""
    from repro_torch.parallel.roofline import default_hardware
    cfg = get_smoke_config("llama3-8b")
    with LatencyDB() as db:
        return _build(db, [cfg], {cfg.name: trace_model(cfg)},
                      hardware=default_hardware(), oracle="cuda_events",
                      device="cuda")


def _card_tables(plan, workers: int):
    """(report, {point: µs}) of ``plan`` executed into a fresh DB."""
    with LatencyDB() as db:
        rep = execute_plan(db, plan, workers=workers)
        return rep, {r[:6]: r[7] for r in db.conn.execute(MEAS_Q).fetchall()}


def _median_rel(a: dict, b: dict) -> float:
    diffs = sorted(abs(a[k] - b[k]) / b[k] for k in b)
    return diffs[len(diffs) // 2]


@pytest.mark.gpu
def test_gpu_pool_writes_the_serial_rows(tmp_path, monkeypatch):
    """``execute_plan(workers=2)`` under ``cuda_events`` on one card: the
    rows of a serial execute, the points within the two processes'
    agreement, and no two workers' measurements overlapping on the card
    (``chip_smoke.py``'s card shim logs each measurement's span)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.syspath_prepend(str(ROOT))      # the spawn workers' too
    import chip_smoke
    plan = _card_plan()
    serial, want = _card_tables(plan, 1)
    monkeypatch.setenv("REPRO_MEASURE_SHIM", chip_smoke.SHIM)
    monkeypatch.setenv("CHIP_SHIM_LOG", str(tmp_path))
    pooled, got = _card_tables(plan, 2)
    assert pooled.workers == 2 and pooled.quarantined == 0
    assert pooled.measured == serial.measured == len(plan.todo)
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:8]
    assert _median_rel(got, want) <= AGREE_LIMIT
    records = chip_smoke._shim_records(tmp_path)
    assert len(records) == len(plan.todo)
    assert len({r["pid"] for r in records}) == 2
    assert chip_smoke._overlaps(records) == []


@pytest.mark.gpu
def test_gpu_unusable_context_replaces_the_worker(tmp_path, monkeypatch):
    """A device-side assert in one task leaves its worker's CUDA context
    unusable: the worker exits, a fresh one retries the task, and it heals
    — nothing quarantined, every task measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    plan = _card_plan()
    _, want = _card_tables(plan, 1)
    state = tmp_path / "state"
    state.mkdir()
    target = plan.todo[2].sig_hash
    monkeypatch.setenv("REPRO_MEASURE_SHIM",
                       f"{Path(__file__).stem}:card_fault_shim")
    monkeypatch.setenv("REPRO_FAULT_SIGS", target)
    monkeypatch.setenv("REPRO_FAULT_STATE", str(state))
    rep, got = _card_tables(plan, 2)
    assert (state / f"poison-{target}").exists()
    assert rep.retried >= 1 and rep.quarantined == 0
    assert rep.measured == len(plan.todo)
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:8]
