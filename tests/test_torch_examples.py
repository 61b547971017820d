"""The port's counterparts of the reference's examples, each run as a user
runs it, in its own process: with ``--cpu`` at smoke size (its summary
lines checked), and without ``--cpu`` where no card is visible, where it
must exit non-zero rather than carry on on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: example -> (extra arguments at smoke size, lines its summary prints)
EXAMPLES = {
    "torch_quickstart": ([], ["traced yi-smoke: ", "runnable set: ",
                              "profiled on cpu (h100_analytical): ", "db: "]),
    "torch_serve_demo": (["-n", "4"], ["yi-smoke (kernel, cpu): served 4 "
                                       "requests in ", "  ttft: p50=",
                                       "  tpot: p50="]),
    "torch_trace_sweep_demo": ([], ["profiled llama3-8b on cpu: ",
                                    "trace under load warps and shapes:",
                                    "multi-turn sessions, prefix cache on vs off:",
                                    "TTFT strictly improves"]),
    "torch_grad_precision": ([], ["[attention] smoke: relative L2 error",
                                  "[model] hymba-smoke bf16 through kernel",
                                  "[model] error ratio kernel / chunked",
                                  "grad precision: done"]),
    "torch_train_demo": (["--steps", "6", "--batch", "4", "--seq", "32",
                          "--compress-grads"],
                         ["step    0 loss=", "final loss=",
                          "restored checkpoint @ step 6; resuming one step...",
                          "resumed loss="]),
}


def _run(name, args, **env):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")] + args,
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
                 **env))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, lines = EXAMPLES[name]
    run = _run(name, args + ["--cpu"], TMPDIR=str(tmp_path))
    assert run.returncode == 0, run.stdout + run.stderr
    for line in lines:
        assert line in run.stdout, (line, run.stdout)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_to_run_without_a_card(name):
    run = _run(name, EXAMPLES[name][0], CUDA_VISIBLE_DEVICES="")
    assert run.returncode != 0
    assert "no CUDA device: pass --cpu" in run.stderr
