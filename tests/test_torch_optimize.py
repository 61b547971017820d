"""The port's capacity optimizer (``optimize/``) and its CLI against the JAX
package's, at smoke sizes on the CPU, and the port's configuration-search
example.

One DB profiled by the port (``h100_analytical``, ``hardware="cpu"``,
``device="cpu"``, ``kernel`` backend; llama3-smoke and command-r7b-smoke) is
read by both packages.  With ``analytic_latency="dooly"`` their capacity
plans, candidate reports and autoscaler replays agree within 1e-9.  The
roofline pruning tier differs by design: the port's prices with the H100's
peaks, which the reference's roofline, given the same peaks, reproduces.
"""
import contextlib
import io
import json
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from repro.api import ProfileStore as JaxProfileStore
from repro.api.backends import RooflineBackend as JaxRooflineBackend
from repro.configs import get_smoke_config as jax_smoke_config
from repro.optimize import SLO as JaxSLO
from repro.optimize import AutoscalePolicy as JaxAutoscalePolicy
from repro.optimize import OptimizeSpec as JaxOptimizeSpec
from repro.optimize import Optimizer as JaxOptimizer
from repro.optimize import WorkloadStats as JaxWorkloadStats
from repro.optimize import analytic_estimate as jax_analytic_estimate
from repro.optimize import simulate_autoscale as jax_simulate_autoscale
from repro.sweep import grid as jax_grid
from repro_torch.api import ProfileStore
from repro_torch.configs import get_smoke_config
from repro_torch.optimize import (SLO, AutoscalePolicy, OptimizeSpec,
                                  Optimizer, simulate_autoscale)
from repro_torch.parallel import roofline
from repro_torch.sweep import grid as port_grid
from repro_torch.sweep.__main__ import PROFILE_SWEEP
from test_torch_sweep import _assert_close, _main

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
MODELS = ("llama3-8b", "command-r7b")
CLI = ["--device", "cpu", "--hardware", HW, "--oracle", ORACLE,
       "--backends", BACKEND]
#: exercises every stage: dominated and pruned points, confirmed points that
#: meet it and that do not; and one no candidate meets (a best-effort pick)
SLOS = {"tpot": dict(tpot_p90=1.5e-5), "ttft": dict(ttft_p90=2e-5)}
SPIKE = "spike:at=0.01,width=0.005,magnitude=3"


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
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


def _spec(grid_mod, spec_cls, slo_cls, slo, shape=""):
    """The optimize CLI's default grid: 2 models x 4 scheduler specs, one
    ShareGPT forecast of 48 requests at 2000/s, 1, 2 or 4 replicas."""
    scheds = [grid_mod.SchedSpec(max_num_seqs=s, max_batch_tokens=t)
              for s in (4, 8) for t in (64, 128)]
    forecast = grid_mod.WorkloadSpec(kind="sharegpt", n=48, rate=2000.0,
                                     shape=shape)
    return spec_cls(candidates=tuple(grid_mod.expand_grid(
        MODELS, scheds, [forecast], backends=(BACKEND,), hardware=HW)),
        replicas=(1, 2, 4), slo=slo_cls(**slo), top_k=2)


@pytest.mark.parametrize("slo", sorted(SLOS))
def test_optimizer_matches_the_reference(db, slo):
    """Staged search with a ``dooly`` pruning tier, and the autoscaler
    replaying the recommendation against a spiky forecast: both packages
    within 1e-9, and the reference measures nothing."""
    spec = _spec(port_grid, OptimizeSpec, SLO, SLOS[slo])
    jspec = _spec(jax_grid, JaxOptimizeSpec, JaxSLO, SLOS[slo])
    policy = dict(min_replicas=1, max_replicas=8, target_utilization=0.4,
                  scale_down_cooldown=0.01, interval=0.005)
    with ProfileStore(db, hardware=HW, oracle=ORACLE, sweep=PROFILE_SWEEP,
                      device="cpu") as store, \
            JaxProfileStore(db, hardware=HW, sweep=PROFILE_SWEEP) as jstore:
        rows = store.stats()["measurements"]
        opt = Optimizer(store, analytic_latency="dooly")
        jopt = JaxOptimizer(jstore, analytic_latency="dooly")
        got, want = opt.run(spec), jopt.run(jspec)
        assert jstore.stats()["measurements"] == rows
        _assert_close(got.to_json(), want.to_json())
        assert got.recommendation is not None
        stages = {c.stage for c in got.candidates}
        assert stages == ({"pruned", "ranked", "confirmed"} if slo == "tpot"
                          else {"confirmed"})
        assert got.feasible == (slo == "tpot")
        scn = got.recommendation.scenario
        jscn = jspec.candidates[spec.candidates.index(scn)]
        spiky = port_grid.WorkloadSpec(kind="sharegpt", n=48, rate=2000.0,
                                       shape=SPIKE)
        jspiky = jax_grid.WorkloadSpec(kind="sharegpt", n=48, rate=2000.0,
                                       shape=SPIKE)
        rep = simulate_autoscale(
            opt.sweep.requests(spiky), scn.sched.to_config(),
            opt._backend(scn, "dooly"), AutoscalePolicy(**policy), spec.slo,
            hw_price=opt._hw_price(scn))
        jrep = jax_simulate_autoscale(
            jopt.sweep.requests(jspiky), jscn.sched.to_config(),
            jopt._backend(jscn, "dooly"), JaxAutoscalePolicy(**policy),
            jspec.slo, hw_price=jopt._hw_price(jscn))
    _assert_close(rep.to_json(), jrep.to_json())
    assert rep.to_json()["windows"]


def test_roofline_tier_prices_with_the_h100s_constants(db):
    """The default pruning tier is the port's roofline: each point's
    analytic estimate equals the reference's analytic tier over the
    reference's RooflineBackend given the H100's peaks, and differs from
    the reference's own (TPU v5e) constants."""
    spec = _spec(port_grid, OptimizeSpec, SLO, SLOS["tpot"])
    peaks = roofline.peaks(roofline.H100)
    with ProfileStore(db, hardware=HW, oracle=ORACLE, device="cpu") as store:
        opt = Optimizer(store)
        plan = opt.run(spec)
        assert opt.analytic_latency == "roofline"
        for c in plan.candidates:
            scn, jcfg = c.scenario, jax_smoke_config(c.scenario.model)
            sched = jax_grid.SchedSpec(**asdict(scn.sched)).to_config()
            reqs = jax_grid.WorkloadSpec(**asdict(scn.workload)).build()
            stats = JaxWorkloadStats.of(reqs, sched)

            def estimate(**kw):
                be = JaxRooflineBackend(jcfg, sched_config=sched,
                                        max_seq=scn.max_seq, **kw)
                return jax_analytic_estimate(stats, sched, be,
                                             replicas=c.replicas,
                                             hw_price=opt._hw_price(scn))
            h100 = estimate(peak_flops=peaks.peak_flops(torch.bfloat16),
                            hbm_bw=peaks.hbm_bw)
            _assert_close(c.analytic.to_json(), h100.to_json())
            assert abs(estimate().tpot - h100.tpot) > 1e-3 * h100.tpot


def test_optimize_cli_payload_matches_the_reference(db, tmp_path):
    from repro.optimize.__main__ import main as jax_main
    from repro_torch.optimize.__main__ import main
    jdb = str(tmp_path / "reference.sqlite")
    shutil.copy(db, jdb)
    args = ["--json", "-", "--analytic-latency", "dooly", "--slo-tpot-p90",
            "1.5e-5", "--autoscale", "--shape", SPIKE]
    rc, out = _main(main, CLI + ["--db", db] + args)
    jrc, jout = _main(jax_main, ["--hardware", HW, "--backends", BACKEND,
                                 "--db", jdb] + args)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert got["recommendation"] is not None and got["autoscale"]["windows"]
    _assert_close(got, want)


def test_optimize_cli_defaults_recommend_on_the_cpu(db):
    """At its defaults (the roofline pruning tier) the port's CLI recommends
    a confirmed candidate and no scenario of the exact tier fails."""
    from repro_torch.optimize.__main__ import main
    rc, out = _main(main, CLI + ["--db", db, "--json", "-"])
    plan = json.loads(out)
    assert rc == 0 and plan["recommendation"]["stage"] == "confirmed"
    assert plan["counters"]["exact_tier"]["failed"] == 0


def test_example_runs_on_the_cpu():
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples/torch_sweep_and_optimize.py"),
         "--cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "cost/latency frontier" in out and "recommended:" in out
    assert "'failed': 0" in out
