"""The port's CPU results do not depend on which call of a process comes
first.

torch's CPU sqrt, exp, log and tanh call MKL's vector math library (VML)
from each thread of a parallel loop, and VML sets itself up on its first
call with no lock.  When a process's first such call is a parallel loop,
one thread can run VML's 11-bit kernel on its chunk (sqrt as
x * rsqrtps(x)): an AdamW step of ``embed.table`` then moved 4289 of 49152
entries of yi-smoke by up to 3.2e-6 against the reference, past the 1e-6
of ``test_torch_train_families.py``.  Importing ``repro_torch`` makes one
VML call on the importing thread first.  Each case runs in a fresh
interpreter, where the call under test is the process's first."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

#: VML's mode word before and after torch's VML path has run on a thread
#: (torch asks for high accuracy with denormals kept: VML_HA | VML_FTZDAZ_OFF)
PROBE_MODE = """
import ctypes, json, os, sys
import torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
if not hasattr(lib, "vmlGetMode"):
    print(json.dumps(None)); sys.exit()
lib.vmlGetMode.restype = ctypes.c_uint
before = lib.vmlGetMode()
import repro_torch
print(json.dumps([before, lib.vmlGetMode()]))
"""

#: the port's AdamW step on one 384 x 128 leaf (yi-smoke's embed.table
#: shape) as the process's first VML call, with ``threads`` threads, then
#: again on copies of the same inputs; each result against float64
PROBE_ADAMW = """
import json, sys
import numpy as np
from repro_torch.train import optimizer
import torch
torch.set_num_threads(int(sys.argv[1]))
rng = np.random.default_rng(0)
p0 = rng.standard_normal((384, 128)).astype(np.float32)
g = (rng.standard_normal((384, 128)) * 1e-3).astype(np.float32)
runs = []
for _ in range(2):
    p = {"w": torch.from_numpy(p0.copy())}
    opt = optimizer.AdamW()
    state = opt.init(p)
    opt.update({"w": torch.from_numpy(g.copy())}, state, p, 1e-2)
    runs.append(p["w"].numpy().copy())
g64 = g.astype(np.float64)
want = p0 - 1e-2 * (g64 / (np.abs(g64) + 1e-8) + 0.1 * p0)
print(json.dumps({"same": bool(np.array_equal(runs[0], runs[1])),
                  "err": float(np.abs(runs[0] - want).max())}))
"""


def _probe(code: str, *args):
    run = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=_ENV)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.splitlines()[-1])


def test_importing_the_port_sets_up_vml_on_the_importing_thread():
    modes = _probe(PROBE_MODE)
    if modes is None:
        pytest.skip("this torch has no MKL VML")
    before, after = modes
    assert before & 0x3c0000 == 0 and after & 0x3c0000 == 0x140000, \
        [hex(m) for m in modes]


@pytest.mark.parametrize("threads", [8, 2, 1])
def test_adamw_step_repeats_bit_for_bit_as_a_first_call(threads):
    """Two steps on the same inputs agree bit for bit, and each lands every
    entry within 5e-7 of float64's step: half a float32 ulp at |p| < 4 is
    2.4e-7, where the 11-bit kernel's error of up to 3.7e-4 in the step's
    sqrt moves an entry by up to 3.7e-6."""
    out = _probe(PROBE_ADAMW, threads)
    assert out["same"]
    assert out["err"] <= 5e-7, out


@pytest.mark.skipif(shutil.which("cc") is None, reason="needs a C compiler")
def test_a_raced_first_sqrt_fails_the_optimizer_parity():
    """``examples/torch_vml_first_call.py --only replay``: the yi-smoke
    AdamW case with its first sqrt of ``embed.table`` taken as
    x * rsqrtps(x) on one thread's chunk moves thousands of entries past the
    parity test's 1e-6, by up to a few 1e-6."""
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_vml_first_call.py"),
         "--only", "replay"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=_ENV)
    assert run.returncode == 0, run.stderr[-2000:]
    moved, largest = re.search(r"moves (\d+) of 49152 entries .* largest by "
                               r"([0-9.e-]+)", run.stdout).groups()
    assert int(moved) > 1000 and 1e-6 < float(largest) < 1e-5, run.stdout
