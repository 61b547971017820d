"""The port's configuration-search surface — ``_cli``, ``sweep/``,
``profile/`` and the ``profile`` and ``sweep`` CLIs — against the JAX
package's, at smoke sizes on the CPU.

The port profiles one DB with ``h100_analytical`` (``hardware="cpu"``,
``device="cpu"``, ``kernel`` backend) over llama3-smoke and
command-r7b-smoke, once per module; each test reads its own copy.  The
reference's ``Sweep`` and CLIs read the same DB and measure nothing; all
they report but elapsed times agrees with the port's within 1e-9.  The
copied modules are held to the reference's text, the port's lines named.
"""
import contextlib
import inspect
import io
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as jax_api
from repro.api import ProfileStore as JaxProfileStore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.sweep import Sweep as JaxSweep
from repro.sweep import expand_grid as jax_expand_grid
from repro.sweep import grid as jax_grid
from repro.sweep.runner import compare_results as jax_compare_results
import repro_torch.api as port_api
from repro_torch.api import ProfileStore
from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.profiler import QUICK_SWEEP
from repro_torch.sweep import SchedSpec, Sweep, WorkloadSpec, expand_grid
from repro_torch.sweep import grid as port_grid
from repro_torch.sweep.__main__ import PROFILE_SWEEP
from repro_torch.sweep.runner import compare_results

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
MODELS = ("llama3-8b", "command-r7b")
CLI = ["--device", "cpu", "--hardware", HW, "--oracle", ORACLE,
       "--backends", BACKEND]
MEAS_Q = ("SELECT * FROM measurements ORDER BY sig_hash, hardware, phase, "
          "num_toks, num_reqs, ctx_len, oracle")

#: module -> [(reference text, port text, count)], applied after the
#: rewrite of ``as_port``: the port's own lines in each copied module
PORT_EDITS = {
    "_cli": [
        ("* ``--hardware``       — hardware name measurements/fits are keyed by;\n",
         "* ``--hardware``       — hardware name measurements/fits are keyed by\n"
         "  (default: the card's tag);\n"
         "* ``--device``         — the device to profile on (``cuda`` unless the\n"
         "  caller passes ``cpu``; a missing card is an error);\n", 1),
        ('default: Optional[str] = "tpu-v5e") -> None:',
         "default: Optional[str] = None) -> None:", 1),
        ('                   help="hardware name measurements and fits are keyed by")\n',
         '                   help="hardware name measurements and fits are keyed by")\n'
         "\n\n"
         "def add_device_arg(p: argparse.ArgumentParser) -> None:\n"
         '    p.add_argument("--device", default="cuda",\n'
         '                   help="device to profile on (\'cpu\' runs without a "\n'
         '                        "card; without one, \'cuda\' is an error)")\n', 1),
    ],
    "sweep/grid": [('"tpu-v5e"', '"h100-80gb-hbm3"', 2)],
    "sweep/runner": [
        ('DEFAULT_HW_COST = {"tpu-v5e": 1.0, "cpu": 0.1}',
         'DEFAULT_HW_COST = {"h100-80gb-hbm3": 1.0, "cpu": 0.1}', 1),
        ("                        wal=self.store.wal)\n",
         "                        wal=self.store.wal,\n"
         "                        device=self.store.device)\n", 1),
    ],
    "sweep/__init__": [
        ("                                SweepResult)\n",
         "                                SweepResult)\n\n"
         '__all__ = ["BURST", "WORKLOAD_KINDS", "SchedSpec", "Scenario",\n'
         '           "WorkloadSpec", "expand_grid", "ScenarioResult", "Sweep",\n'
         '           "SweepResult"]\n', 1),
    ],
    "sweep/__main__": [
        ("from repro_torch._cli import (add_db_arg, add_hardware_arg, add_json_arg,\n"
         "                        add_latency_arg, add_shape_arg,\n",
         "from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,\n"
         "                              add_json_arg, add_latency_arg, add_shape_arg,\n", 1),
        ("from repro_torch.core.profiler import SweepConfig\n",
         "from repro_torch.core.profiler import SweepConfig\n"
         "from repro_torch.parallel.roofline import default_hardware\n", 1),
        ('    p.add_argument("--oracle", default="tpu_analytical")\n',
         '    p.add_argument("--oracle", default="cuda_events")\n'
         "    add_device_arg(p)\n", 1),
        ("                            hardware=args.hardware, tp=args.tp,\n"
         "                            max_seq=args.max_seq)\n",
         "                            hardware=args.hardware or default_hardware(),\n"
         "                            tp=args.tp, max_seq=args.max_seq)\n", 1),
        ("                      sweep=PROFILE_SWEEP) as store:\n",
         "                      sweep=PROFILE_SWEEP, device=args.device) as store:\n", 1),
    ],
    "optimize/__init__": [
        ("                                   Optimizer, optimize)\n",
         "                                   Optimizer, optimize)\n\n"
         '__all__ = ["ANALYTIC_MAKESPAN_BOUND", "ANALYTIC_TPOT_BOUND",\n'
         '           "AnalyticEstimate", "WorkloadStats", "analytic_estimate",\n'
         '           "AutoscalePolicy", "AutoscaleReport", "simulate_autoscale",\n'
         '           "SLO", "CandidateReport", "CapacityPlan", "OptimizeSpec",\n'
         '           "Optimizer", "optimize"]\n', 1),
    ],
    "optimize/analytic": [],
    "optimize/autoscale": [],
    "optimize/search": [],
    "optimize/__main__": [
        ("from repro_torch._cli import (add_db_arg, add_hardware_arg, add_json_arg,\n"
         "                        add_latency_arg, add_shape_arg,\n",
         "from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,\n"
         "                              add_json_arg, add_latency_arg, add_shape_arg,\n", 1),
        ("from repro_torch.optimize.search import SLO, OptimizeSpec, Optimizer\n",
         "from repro_torch.optimize.search import SLO, OptimizeSpec, Optimizer\n"
         "from repro_torch.parallel.roofline import default_hardware\n", 1),
        ('    p.add_argument("--oracle", default="tpu_analytical")\n',
         '    p.add_argument("--oracle", default="cuda_events")\n'
         "    add_device_arg(p)\n", 1),
        ("                             backends=backends, hardware=args.hardware,\n",
         "                             backends=backends,\n"
         "                             hardware=args.hardware or default_hardware(),\n", 1),
        ("                      oracle=args.oracle, sweep=PROFILE_SWEEP) as store:\n",
         "                      oracle=args.oracle, sweep=PROFILE_SWEEP,\n"
         "                      device=args.device) as store:\n", 1),
    ],
    "profile/__init__": [
        ("                             execute_plan)\n",
         "                             execute_plan)\n\n"
         '__all__ = ["CoverageReport", "ExecuteReport", "PlanTask", "ProfilePlan",\n'
         '           "build_plan", "execute_plan"]\n', 1),
    ],
    "profile/__main__": [
        ("from repro_torch._cli import (add_db_arg, add_hardware_arg, add_json_arg, emit,\n"
         "                        json_to_stdout)\n",
         "from repro_torch._cli import (add_db_arg, add_device_arg, add_hardware_arg,\n"
         "                              add_json_arg, emit, json_to_stdout)\n", 1),
        ('        sp.add_argument("--oracle", default="tpu_analytical")\n',
         '        sp.add_argument("--oracle", default="cuda_events")\n'
         "        add_device_arg(sp)\n", 1),
        ("                         oracle=args.oracle, sweep=_sweep(args.sweep))\n",
         "                         oracle=args.oracle, sweep=_sweep(args.sweep),\n"
         "                         device=args.device)\n", 1),
        ("    # execute (measure) the same plan; journal progress; resume on rerun\n",
         "    # execute (measure) the same plan; journal progress; resume on rerun.\n"
         "    # N workers on one card share it in turn: each holds the card while it\n"
         "    # measures a task, so only their start-up and host work overlap\n", 1),
        ("        --db corpus.sqlite --workers 4 --resume\n",
         "        --db corpus.sqlite --workers 2 --resume\n", 1),
        ('                                 "retried")\n',
         '                                 "retried.  On a card it counts from "\n'
         '                                 "the moment the task takes the card, "\n'
         '                                 "which the workers hold one at a time: "\n'
         '                                 "a wait for it of up to 4 x N workers x "\n'
         '                                 "this "\n'
         '                                 "is not counted")\n', 1),
        ('                     "elapsed_s": rep.elapsed_s,\n',
         '                     "elapsed_s": rep.elapsed_s,\n'
         '                     "workers": rep.workers,\n', 1),
    ],
}


def as_port(ref_text: str) -> str:
    """``repro.`` -> ``repro_torch.`` in every import line, indented ones
    included, and in ``python -m repro.<cli>`` invocations."""
    out = []
    for line in ref_text.split("\n"):
        if line.lstrip().startswith("from repro."):
            line = line.replace("from repro.", "from repro_torch.", 1)
        out.append(line.replace("-m repro.", "-m repro_torch."))
    return "\n".join(out)


@pytest.mark.parametrize("name", sorted(PORT_EDITS))
def test_module_is_a_copy(name):
    want = as_port((ROOT / "src/repro" / f"{name}.py").read_text())
    for old, new, count in PORT_EDITS[name]:
        assert want.count(old) == count, (name, old)
        want = want.replace(old, new)
    assert (ROOT / "src/repro_torch" / f"{name}.py").read_text() == want


def test_api_surface_is_the_references():
    assert set(port_api.__all__) == set(jax_api.__all__)
    for name in port_api.__all__:
        obj = getattr(port_api, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch."), name


# ---------------------------------------------------------------------------
# one DB, profiled by the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A DB file the port profiled at the sweep CLI's sweep."""
    path = tmp_path_factory.mktemp("db") / "latency.sqlite"
    with ProfileStore(str(path), hardware=HW, oracle=ORACLE, sweep=PROFILE_SWEEP,
                      device="cpu") as store:
        store.execute(store.plan([get_smoke_config(m) for m in MODELS],
                                 backends=(BACKEND,)))
    return path


@pytest.fixture
def db(profiled, tmp_path):
    path = tmp_path / "latency.sqlite"
    shutil.copy(profiled, path)
    return str(path)


def _grid(expand, grid_mod):
    """The sweep CLI's default grid: 2 models x 4 scheduler specs x
    (sharegpt, synthetic) x (burst, 20/s)."""
    scheds = [grid_mod.SchedSpec(max_num_seqs=s, max_batch_tokens=t)
              for s in (4, 8) for t in (64, 128)]
    workloads = [grid_mod.WorkloadSpec(kind=k, n=24, rate=r)
                 for k in ("sharegpt", "synthetic") for r in (math.inf, 20.0)]
    return expand(MODELS, scheds, workloads, backends=(BACKEND,), hardware=HW)


FIELDS = ("makespan", "ttft_mean", "ttft_p50", "ttft_p90", "tpot_mean",
          "tpot_p50", "tpot_p90", "tokens_per_s", "cost")


def _assert_close(got, want, path="payload"):
    """Equal structures, floats within 1e-9, elapsed times skipped."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "elapsed_s":
                _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert (math.isinf(got) and got == want) or abs(got - want) <= 1e-9, path
    else:
        assert got == want, path


@pytest.mark.parametrize("engine", ["events", "loop"])
def test_sweep_matches_the_reference(db, engine):
    """Both packages' Sweep over the DB the port profiled: the reference
    measures nothing, every scenario agrees within 1e-9, and so do the
    frontier, the summary counts and the calibration diff against the
    ``oracle`` backend."""
    scenarios = _grid(expand_grid, port_grid)
    jscenarios = _grid(jax_expand_grid, jax_grid)
    with ProfileStore(db, hardware=HW, oracle=ORACLE, sweep=PROFILE_SWEEP,
                      device="cpu") as store, \
            JaxProfileStore(db, hardware=HW, sweep=PROFILE_SWEEP) as jstore:
        rows = store.stats()["measurements"]
        sweep = store.sweep(engine=engine)
        jsweep = JaxSweep(jstore, config_fn=jax_smoke_config, engine=engine)
        assert sweep.profile_plan(scenarios) is None
        assert jsweep.profile_plan(jscenarios) is None
        got, want = sweep.run(scenarios), jsweep.run(jscenarios)
        oracle = store.sweep(latency="oracle").run(scenarios)
        joracle = JaxSweep(jstore, latency="oracle").run(jscenarios)
        assert store.stats()["measurements"] == rows
    assert not got.failures and not want.failures
    assert len(got.results) == len(want.results) == len(scenarios) == 32
    for a, b in zip(got.results, want.results):
        assert a.scenario.label() == b.scenario.label()
        assert (a.mode, a.n_iterations, a.degraded, a.cache_hit_tokens) == \
            (b.mode, b.n_iterations, b.degraded, b.cache_hit_tokens)
        np.testing.assert_allclose([getattr(a, f) for f in FIELDS],
                                   [getattr(b, f) for f in FIELDS],
                                   rtol=0, atol=1e-9)
    for metric in ("tpot_mean", "ttft_p90", "makespan"):
        assert [r.scenario.label() for r in got.frontier(metric)] == \
            [r.scenario.label() for r in want.frontier(metric)]
    _assert_close(got.summary, want.summary)
    _assert_close(compare_results(got, oracle),
                  jax_compare_results(want, joracle))


def test_parallel_evaluation_is_bit_identical_to_serial(db):
    """Two spawn workers reopen the store on its device: without the
    device they would ask for the card and fail their shards."""
    scenarios = _grid(expand_grid, port_grid)
    with ProfileStore(db, hardware=HW, oracle=ORACLE, device="cpu") as store:
        serial = store.sweep().run(scenarios)
        parallel = store.sweep().run(scenarios, workers=2, oversubscribe=True)
    assert parallel.summary["workers"] == 2
    assert not parallel.failures and serial.summary["failed"] == 0
    assert [r.to_json() for r in parallel.results] == \
        [r.to_json() for r in serial.results]


def test_sweep_refuses_a_scenario_of_other_hardware(db):
    with ProfileStore(db, hardware=HW, oracle=ORACLE, device="cpu") as store:
        scn = expand_grid([MODELS[0]], [SchedSpec()], [WorkloadSpec(n=4)],
                          backends=(BACKEND,))
        assert scn[0].hardware == "h100-80gb-hbm3"
        with pytest.raises(ValueError, match="differs from the store's"):
            store.sweep().profile_plan(scn)
        assert isinstance(store.sweep(), Sweep)


# ---------------------------------------------------------------------------
# the CLIs, in process
# ---------------------------------------------------------------------------

def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_sweep_cli_payload_matches_the_reference(db, tmp_path):
    from repro.sweep.__main__ import main as jax_main
    from repro_torch.sweep.__main__ import main
    jdb = str(tmp_path / "reference.sqlite")
    shutil.copy(db, jdb)
    args = ["--json", "-", "--compare-latency", "oracle"]
    rc, out = _main(main, CLI + ["--db", db] + args)
    jrc, jout = _main(jax_main, ["--hardware", HW, "--backends", BACKEND,
                                 "--db", jdb] + args)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert got["summary"]["scenarios"] == 32 and got["summary"]["failed"] == 0
    _assert_close(got, want)


def _coverage(cfgs):
    with ProfileStore(hardware=HW, oracle=ORACLE, sweep=QUICK_SWEEP,
                      device="cpu") as store:
        plan = store.plan(cfgs, backends=(BACKEND,))
        return {"plan_id": plan.plan_id, **plan.coverage().to_json()}


def test_profile_cli_plan_is_the_stores_coverage():
    from repro_torch.profile.__main__ import main
    corpus = ["--models", ",".join(MODELS)] + CLI
    rc, out = _main(main, ["plan", *corpus, "--json", "-"])
    assert rc == 0
    assert json.loads(out) == _coverage([get_smoke_config(m) for m in MODELS])


def _rows(path):
    with LatencyDB(str(path)) as db:
        return db.conn.execute(MEAS_Q).fetchall()


def test_profile_cli_shards_merge_and_resume(tmp_path):
    """Two shards, each into its own scratch DB, merged: the rows of a
    one-shot run; a resumed run on the merged DB measures nothing."""
    from repro_torch.profile.__main__ import main
    corpus = ["--models", ",".join(MODELS)] + CLI
    for i in range(2):
        rc, _ = _main(main, ["run", *corpus, "--db", str(tmp_path / f"s{i}.sqlite"),
                             "--resume", "--shards", "2", "--shard-index", str(i)])
        assert rc == 0
    sources = [str(tmp_path / f) for f in ("s0.sqlite", "s1.sqlite",
                                           "s0.sqlite.plan-journal",
                                           "s1.sqlite.plan-journal")]
    merged = tmp_path / "merged.sqlite"
    rc, out = _main(main, ["merge", *corpus, "--db", str(merged), "--resume",
                           *sources])
    assert rc == 0 and "exact, all shards merged" in out
    rc, out = _main(main, ["run", *corpus, "--db", str(merged), "--resume",
                           "--json", "-"])
    assert rc == 0 and json.loads(out)["measured"] == 0
    one_shot = tmp_path / "one.sqlite"
    rc, _ = _main(main, ["run", *corpus, "--db", str(one_shot)])
    assert rc == 0
    assert _rows(merged) == _rows(one_shot) and len(_rows(merged)) > 0


def test_profile_cli_audit(tmp_path):
    from repro_torch.profile.__main__ import main
    bad = str(tmp_path / "bad.sqlite")
    with LatencyDB(bad) as db:
        db.add_measurement("sig-ok", HW, "prefill", 8, 1, 0, ORACLE, 12.5)
        db.add_measurement("sig-neg", HW, "prefill", 8, 1, 0, ORACLE, -1.0)
        db.add_measurement("sig-inf", HW, "prefill", 8, 1, 0, ORACLE,
                           float("inf"))
    rc, out = _main(main, ["audit", "--db", bad, "--json", "-"])
    assert rc == 1 and json.loads(out)["poisoned_rows"] == 2
    clean = str(tmp_path / "clean.sqlite")
    with LatencyDB(clean) as db:
        db.add_measurement("sig-ok", HW, "prefill", 8, 1, 0, ORACLE, 12.5)
    assert _main(main, ["audit", "--db", clean])[0] == 0


@pytest.mark.parametrize("argv", [
    ["sweep", "--n", "4"],
    ["optimize", "--hardware", HW, "--oracle", ORACLE, "--n", "4"],
    ["profile", "plan", "--models", MODELS[0], "--hardware", HW],
], ids=["sweep", "optimize", "profile"])
def test_clis_need_a_card_without_device_cpu(argv, tmp_path):
    """Without ``--device cpu`` every CLI asks for the card, and without
    one it exits non-zero, naming the missing device; nothing falls back."""
    run = subprocess.run([sys.executable, "-m", f"repro_torch.{argv[0]}",
                          *argv[1:]], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr, run.stderr[-2000:]
