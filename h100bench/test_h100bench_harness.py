"""The harness end to end at smoke size on the CPU's eager path: the result
line, its refusals, the files a later cell or metric adds, and the faults
its check must catch.  Each run is a fresh process, one thread."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import _smoke

#: a per-layer metric added as files alone: its reader and its entry
EXTRA_READER = '''"""Iterations the window ran."""


def read(ctx):
    return float(len(ctx.window.records))
'''
EXTRA_METRIC = {"name": "sched.iterations", "unit": "iterations", "better": "higher",
                "source": "program_counter", "layer": "scheduler",
                "moves": "output_tok_per_s"}


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(_smoke.REPO / "src"), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A checkout-like copy with the smoke cells, mix and configurations and
    one more per-layer metric, each added as new files."""
    root = _smoke.make_bench(tmp_path_factory.mktemp("bench"), {
        "s.cmdr": _smoke.smoke_cell("command-r7b-smoke"),
        "s.olmoe": _smoke.smoke_cell("olmoe-smoke")})
    (root / "h100bench" / "metrics" / "readers" / "sched.iterations.py").write_text(
        EXTRA_READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(EXTRA_METRIC)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, *args, env=None):
    return subprocess.run([sys.executable, str(root / "h100bench" / "run.py"), *args],
                          capture_output=True, text=True, env=env or _env(),
                          cwd=root, timeout=240)


def _cell_args(cell, trace):
    return ["--workload", cell, "--seed", "2147483659", "--seconds", "0.05",
            "--trace", str(trace), "--device", "cpu"]


@pytest.mark.parametrize("cell,trace", [("s.cmdr", 0), ("s.olmoe", 1)])
def test_a_cell_runs_end_to_end(bench, cell, trace):
    p = _run(bench, *_cell_args(cell, trace))
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True
    assert result["attempted"] == _smoke.SMOKE_MIX["trace_requests"]
    assert result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    if trace:
        # the device's metrics read nothing off the card; the new one reads
        assert set(result["metrics"]) == {"sched.decode_rows", "engine.decode_iter_ms",
                                          "engine.chunk_ms_per_ktok", "sched.iterations"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"ttft_p90_ms", "tpot_p90_ms",
                                          "output_tok_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    checked = result["checked"]
    assert list(result)[-1] == "checked"
    tail = p.stderr.strip().splitlines()[-len(checked):]
    assert [line.split()[0] for line in tail] == list(checked)
    assert all(" limit " in line for line in tail)


def test_no_card_means_no_result(bench):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _run(bench, *_cell_args("s.cmdr", 0)[:-2])
    assert p.returncode == 2 and not p.stdout.strip()


def test_benchmark_files_alone_give_no_result(bench, tmp_path):
    """Without the program beside it (a checkout of only ``BENCHMARK.json``
    and the benchmark's folder), a run fails and prints nothing."""
    shutil.copytree(bench / "h100bench", tmp_path / "h100bench")
    shutil.copy(bench / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, *_cell_args("s.cmdr", 0), env=env)
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_run_that_loaded_jax_gives_no_result(bench):
    """The guard compares whole top-level names: the port, ``repro_torch``,
    passes (the runs above), ``jax`` does not."""
    code = ("import runpy, sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            f"sys.argv = ['run.py'] + {_cell_args('s.cmdr', 0)!r};"
            f"runpy.run_path({str(bench / 'h100bench' / 'run.py')!r}, run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), cwd=bench, timeout=240)
    assert p.returncode == 3 and not p.stdout.strip()
    assert "['jax']" in p.stderr


def test_planted_faults_make_the_check_fail(bench):
    p = subprocess.run([sys.executable, str(bench / "h100bench" / "_faults.py"),
                        "2147483660", "s.cmdr", "s.olmoe"],
                       capture_output=True, text=True, env=_env(), cwd=bench, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    for cell, faults in got.items():
        assert faults and all(v is False for v in faults.values()), (cell, faults)
