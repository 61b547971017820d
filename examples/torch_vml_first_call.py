"""Why an AdamW step of the port once differed from the reference on the CPU.

torch's CPU sqrt, exp, log and tanh call MKL's vector math library (VML)
from each thread of a parallel loop, and VML sets itself up on its first
call with no lock.  This script shows both halves of that on the CPU it
runs on (it needs a C compiler, ``cc``, and an x86 CPU):

* ``race``: ``--processes`` fresh processes each call VML's float32 sqrt
  (high accuracy asked for) from 8 threads at once as the process's first
  VML call, and compare each thread's result with a later call.  It prints
  how many processes gave a thread another result, how many of those
  results are exactly ``x * rsqrtps(x)`` (11 bits) and their largest
  relative error, then the same with one call on one thread first (what
  ``import repro_torch`` does) and for exp.
* ``replay``: the yi-smoke AdamW case of
  ``tests/test_torch_train_families.py::test_optimizer_on_stacked_leaves_matches_the_reference``
  through the port, drawing the test's random numbers in the reference's
  leaf order, once as it runs and once with the first step's sqrt of
  ``embed.table`` taken as ``x * rsqrtps(x)`` on the first of two threads'
  chunks.  It prints the second against the first at the test's tolerance
  (rtol = atol = 1e-6) and the first row's values.

    PYTHONPATH=src python examples/torch_vml_first_call.py --processes 320
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: VML_HA | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE: the mode torch passes
MODE = 0x2 | 0x140000 | 0x100
N = 24576

PROBE = r"""
#include <dlfcn.h>
#include <immintrin.h>
#include <math.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
typedef void (*vml_t)(long long, const float *, float *, unsigned long long);
static vml_t fn;
static pthread_barrier_t bar;
static float x[N], out[8][N], ref[N], emu[N];
static void *run(void *arg) {
  pthread_barrier_wait(&bar);
  fn(N, x, out[(long)arg], MODE);
  return 0;
}
/* argv: libtorch_cpu.so, VML function, warm-up (0/1) */
int main(int argc, char **argv) {
  void *h = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (!h) { printf("dlopen failed\n"); return 2; }
  fn = (vml_t)dlsym(h, argv[2]);
  for (int i = 0; i < N; i++) x[i] = 1e-9f + 1e-4f * (float)i / N;
  if (atoi(argv[3])) fn(1, x, ref, MODE);
  pthread_t th[8];
  pthread_barrier_init(&bar, 0, 8);
  for (long t = 0; t < 8; t++) pthread_create(&th[t], 0, run, (void *)t);
  for (int t = 0; t < 8; t++) pthread_join(th[t], 0);
  fn(N, x, ref, MODE);
  for (int i = 0; i < N; i += 4)
    _mm_storeu_ps(emu + i, _mm_mul_ps(_mm_loadu_ps(x + i),
                                      _mm_rsqrt_ps(_mm_loadu_ps(x + i))));
  int bad = 0, rsqrt = 0;
  double worst = 0;
  for (int t = 0; t < 8; t++)
    if (memcmp(ref, out[t], sizeof ref)) {
      bad++;
      rsqrt += !memcmp(emu, out[t], sizeof emu);
      for (int i = 0; i < N; i++) {
        double e = fabs((double)out[t][i] / ref[i] - 1);
        if (e > worst) worst = e;
      }
    }
  printf("%d %d %g\n", bad, rsqrt, worst);
  return 0;
}
"""

HELPER = r"""
#include <immintrin.h>
#include <stddef.h>
void x_rsqrtps(const float *x, float *y, size_t n) {
  for (size_t i = 0; i + 4 <= n; i += 4)
    _mm_storeu_ps(y + i, _mm_mul_ps(_mm_loadu_ps(x + i),
                                    _mm_rsqrt_ps(_mm_loadu_ps(x + i))));
}
"""


def _cc(src: str, out: Path, *flags: str):
    path = out.with_suffix(".c")
    path.write_text(src)
    subprocess.run(["cc", "-O2", "-msse", *flags, "-o", str(out), str(path)],
                   check=True)


def race(work: Path, processes: int):
    exe = work / "probe"
    _cc(f"#define N {N}\n#define MODE {MODE}\n" + PROBE, exe, "-ldl",
        "-lpthread", "-lm")
    lib = Path(torch.__file__).parent / "lib" / "libtorch_cpu.so"

    def one(args):
        out = subprocess.run([str(exe), str(lib), *args], capture_output=True,
                             text=True, check=True).stdout.split()
        return int(out[0]), int(out[1]), float(out[2])
    for fn, warm in (("vmsSqrt", "0"), ("vmsSqrt", "1"), ("vmsExp", "0"),
                     ("vmsExp", "1")):
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            res = list(pool.map(one, [(fn, warm)] * processes))
        raced = [r for r in res if r[0]]
        print(f"race {fn} {'after one call on one thread' if warm == '1' else 'as the first call'}: "
              f"{len(raced)} of {processes} processes gave a thread another "
              f"result ({sum(r[0] for r in raced)} threads"
              + (f", {sum(r[1] for r in raced)} of them exactly x * rsqrtps(x)"
                 if fn == "vmsSqrt" else "")
              + f"; largest relative error {max((r[2] for r in raced), default=0):.3g})")


def _draws(cfg):
    """The test's random parameters and three gradients (as port state
    dicts), drawn leaf by leaf in the reference's tree order."""
    from repro_torch.models import Model, params_from_jax
    model = Model(cfg, device="meta", generator=torch.Generator())
    stacks = model.param_stacks()
    shapes = {k.replace(".", "/"): tuple(p.shape)
              for k, p in model.named_parameters()}
    leaves = {}
    for key, members in stacks.items():
        leaves[key] = (len(members),) + shapes[members[0].replace(".", "/")]
        for m in members:
            shapes.pop(m.replace(".", "/"))
    leaves.update(shapes)

    def order(path):
        return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                     for c in path.split("/"))
    paths = sorted(leaves, key=order)

    def insert(node, parts, a):
        key = int(parts[0]) if parts[0].isdigit() else parts[0]
        if isinstance(node, list):
            node.extend([None] * (key + 1 - len(node)))
        if len(parts) == 1:
            node[key] = a
            return
        if (node[key] if isinstance(node, list) else node.get(key)) is None:
            node[key] = [] if parts[1].isdigit() else {}
        insert(node[key], parts[1:], a)

    def tree(arrays):
        root: dict = {}
        for path, a in zip(paths, arrays):
            insert(root, path.split("/"), a)
        return params_from_jax(root, cfg)
    rng = np.random.default_rng(0)
    p = tree([rng.standard_normal(leaves[k]).astype(np.float32) for k in paths])
    grads = [tree([rng.standard_normal(leaves[k]).astype(np.float32) * 0.1
                   for k in paths]) for _ in range(3)]
    return p, grads


def replay(work: Path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import optimizer
    lib_path = work / "helper.so"
    _cc(HELPER, lib_path, "-shared", "-fPIC")
    lib = ctypes.CDLL(str(lib_path))
    torch.set_num_threads(2)
    p0, grads = _draws(get_smoke_config("yi-9b"))
    clipped = [optimizer.clip_by_global_norm(
        {n: g.clone() for n, g in gs.items()}, 1.0)[0]["embed.table"]
        for gs in grads]

    def steps(first_chunk_raced: bool) -> np.ndarray:
        """AdamW's update of one leaf as ``optimizer.AdamW.update`` runs
        it, its sqrt by hand."""
        opt, f32 = optimizer.AdamW(), optimizer._f32
        p = p0["embed.table"].clone()
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        for k, g in enumerate(clipped, start=1):
            b1c = f32(1.0 - np.float32(opt.b1) ** np.float32(k))
            b2c = f32(1.0 - np.float32(opt.b2) ** np.float32(k))
            m.mul_(opt.b1).add_(g * (1 - opt.b1))
            v.mul_(opt.b2).add_(g.mul(1 - opt.b2).mul_(g))
            vh = torch.div(v, b2c)
            den = vh.sqrt()
            if first_chunk_raced and k == 1:
                half = vh.numel() // 2
                x = vh.view(-1)[:half].contiguous().numpy()
                y = den.view(-1)[:half].numpy()
                lib.x_rsqrtps(ctypes.c_void_p(x.ctypes.data),
                              ctypes.c_void_p(y.ctypes.data),
                              ctypes.c_size_t(half))
            step = torch.div(m, b1c).div_(den.add_(opt.eps))
            step.add_(p, alpha=opt.weight_decay)
            p.copy_(step.mul_(-1e-2).add_(p))
        return p.numpy()
    want, got = steps(False), steps(True)
    diff = np.abs(got - want)
    over = diff > 1e-6 + 1e-6 * np.abs(want)
    print(f"replay: the first step's sqrt of embed.table as x * rsqrtps(x) on "
          f"the first of two threads' chunks moves {int(over.sum())} of "
          f"{want.size} entries past rtol = atol = 1e-6; the largest by "
          f"{diff[over].max():.8g} ({(diff / np.abs(want))[over].max():.8g} "
          f"relative)")
    np.set_printoptions(precision=7)
    print(f"  first row, first and last three entries: as run "
          f"{want[0, :3]} ... {want[0, -3:]}; raced {got[0, :3]} ... "
          f"{got[0, -3:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=320)
    ap.add_argument("--only", choices=("race", "replay"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        if args.only != "replay":
            race(Path(tmp), args.processes)
        if args.only != "race":
            replay(Path(tmp))


if __name__ == "__main__":
    main()
