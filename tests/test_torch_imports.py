"""The port stands alone: importing every module of ``repro_torch``,
``chip_smoke.py`` and the port's examples (``examples/torch_*.py``) loads
neither JAX nor any module of the JAX package.

Checked in a fresh interpreter, because tests/conftest.py imports jax into
this one."""
import ast
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import glob, os, runpy
for path in sorted(glob.glob(os.path.join(sys.argv[1], "examples", "torch_*.py"))):
    runpy.run_path(path, run_name="not_main")
import torch.distributed as dist
assert "repro_torch.launch.dryrun" in sys.modules
if dist.is_initialized():
    print("a process group was started by an import")
    sys.exit(1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
mains = sorted(n for n in names if n.endswith(".__main__"))
print(len(names), ",".join(mains), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    run = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT)], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stdout + run.stderr
    n_modules, mains, bad = run.stdout.split(maxsplit=2)
    # train, parallel, models.mamba, kernels.mamba_scan, the falcon-mamba
    # config, the profile-then-simulate loop (core.{signature,database,
    # latency_model,journal,supervisor,profiler,plan}, parallel.roofline,
    # sim, workload, api) and the configuration-search surface (_cli,
    # profile, sweep, optimize, each CLI's __main__), and the MLA, MoE and
    # hybrid families (models.{mla,moe} and three configs), and the launch
    # package (launch, launch.mesh, launch.dryrun) with parallel.sharding
    # included
    assert int(n_modules) >= 83 and bad.strip() == "[]"
    assert mains.split(",") == [f"repro_torch.{m}.__main__"
                                for m in ("optimize", "profile", "sweep")]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


#: the port's counterparts of the reference's examples
EXAMPLES = ("torch_quickstart", "torch_serve_demo", "torch_trace_sweep_demo",
            "torch_train_demo")


def test_no_source_names_jax_or_repro():
    # also catches imports inside functions, which an import probe misses
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {f.stem for f in examples} >= set(EXAMPLES)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f


def test_packages_define_all():
    for init in sorted(PKG.rglob("__init__.py")):
        names = [n.id for n in ast.walk(ast.parse(init.read_text()))
                 if isinstance(n, ast.Name) and n.id == "__all__"]
        assert names, f"{init} defines no __all__"
    assert all(hasattr(repro_torch, n) for n in repro_torch.__all__)
