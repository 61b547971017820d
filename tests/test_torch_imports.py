"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke.py`` loads neither JAX nor any module of the JAX package.

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    run = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT)], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stdout + run.stderr
    n_modules, bad = run.stdout.split(maxsplit=1)
    # train, parallel, models.mamba, kernels.mamba_scan, the falcon-mamba
    # config, and the profile-then-simulate loop (core.{signature,database,
    # latency_model,journal,supervisor,profiler,plan}, parallel.roofline,
    # sim, workload, api) included
    assert int(n_modules) >= 62 and bad.strip() == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_names_jax_or_repro():
    # also catches imports inside functions, which an import probe misses
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f


def test_packages_define_all():
    for init in sorted(PKG.rglob("__init__.py")):
        names = [n.id for n in ast.walk(ast.parse(init.read_text()))
                 if isinstance(n, ast.Name) and n.id == "__all__"]
        assert names, f"{init} defines no __all__"
    assert all(hasattr(repro_torch, n) for n in repro_torch.__all__)
