"""Signature component 2 on the card is a function of the probe call, not
of what the process ran before it (``core.signature``).

A plan's id digests its ordered task ids, and a task id is a signature's
hash; the checkpoint journal binds to the id, and a DB is reused by hash.
So the same corpus must sign the same in any process, whatever that
process measured or served first.  The ``gpu`` tests build
llama3-8b-smoke's ``cuda_events`` plan on the card before and after
measuring in one process, and in two fresh processes; on a mismatch they
name every entry whose hash differs, with the symmetric difference of its
two kernel sets.

Repeat them on the card with::

    for i in 1 2 3 4 5; do PYTHONPATH=src python -m pytest -q -m gpu \\
        tests/test_torch_signature_stability.py; done
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.plan import build_plan, execute_plan
from repro_torch.core.profiler import QUICK_SWEEP
from repro_torch.core.runner import trace_model

ROOT = Path(__file__).resolve().parents[1]
MODEL = "llama3-8b"
RECORD_TAG = "plan record: "


# ---------------------------------------------------------------------------
# the rule, on the CPU: a scripted dispatch and a scripted profiler
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so a fingerprint takes
    whatever path it takes for a card's tensors."""

    @property
    def is_cuda(self):
        return True


def _on_card(*shape) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, torch.ones(*shape))


S = "spin_kernel"


def _script_profiler(monkeypatch, library_kernel: str, *, lose_all=False):
    """``torch.profiler.profile`` as a process whose sessions record the
    call's library kernel ``library_kernel`` between sentinels (or, with
    ``lose_all``, lose every activity)."""
    from torch.profiler import DeviceType
    names = [] if lose_all else [S, S, S] + [library_kernel, S] * 3

    class Event:
        def __init__(self, name, start):
            self.name, self.device_type = name, DeviceType.CUDA
            self.time_range = type("Range", (), {"start": start})()

    class Session:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event(n, t) for t, n in enumerate(names)]

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


@pytest.mark.parametrize("history", [
    ("sm80_xmma_gemm_f32f32_tilesize32x128", "cutlass_80_simt_sgemm_64x64"),
    ("nvjet_tst_128x8", None),          # the second process's sessions lose all
])
def test_fingerprint_is_the_same_whatever_the_library_ran(monkeypatch, history):
    """One call on a card's tensors signed in two processes whose library
    chose another GEMM kernel, or whose profiler lost every session: the
    same fingerprint, the aten overloads the call dispatches."""
    from repro_torch.core.signature import fingerprint
    a, b = _on_card(4, 8), _on_card(8, 2)
    got = []
    for kernel in history:
        _script_profiler(monkeypatch, kernel, lose_all=kernel is None)
        got.append(fingerprint([(torch.mm, (a, b))]))
    assert got == ["aten.mm.default"] * 2


@pytest.mark.parametrize("launches", [0, 1, 2])
def test_fingerprint_names_the_port_kernels_a_call_launches(launches):
    """A call that launches the port's decode kernel ``launches`` times (a
    scripted wrapper: it counts as the wrapper does on the card) is signed
    with the kernel's name once; the counts before the call and the other
    wrappers' counters count for nothing."""
    from repro_torch.core.signature import fingerprint
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mamba_scan as ms
    saved = da.decode_attention.launches, ms.mamba_scan.launches
    da.decode_attention.launches, ms.mamba_scan.launches = 5, 3

    def call(x):
        da.decode_attention.launches += launches
        return x * 2
    try:
        fp = fingerprint([(call, (torch.ones(3),))])
    finally:
        da.decode_attention.launches, ms.mamba_scan.launches = saved
    want = {"aten.mul.Tensor"} | ({"repro_torch::decode_attention"}
                                  if launches else set())
    assert set(fp.split(",")) == want


def _card_plan(db: LatencyDB, trace=None):
    """llama3-8b-smoke's plan for ``cuda_events`` on the card, as
    ``tests/test_torch_faults.py::_card_plan`` builds it."""
    from repro_torch.parallel.roofline import default_hardware
    cfg = get_smoke_config(MODEL)
    return build_plan(db, [cfg], backends=("kernel",),
                      hardware=default_hardware(), oracle="cuda_events",
                      sweep=QUICK_SWEEP, traces={cfg.name: trace or trace_model(cfg)},
                      device="cuda")


def plan_record(plan) -> dict:
    """What names a plan: its id, its ordered task ids, and each entry's
    kind, signature hash and kernel set (component 2)."""
    sigs = {s.hash: s for s in plan.signatures}
    return {"plan_id": plan.plan_id, "tasks": [t.task_id for t in plan.tasks],
            "entries": [[e.name, e.sig_hash, sigs[e.sig_hash].fingerprint]
                        for _, entries in plan.entries for e in entries]}


def differences(a: dict, b: dict) -> list:
    """Every entry of two plan records whose hash differs: its kind and the
    kernels only ``a``'s set holds, then only ``b``'s (both empty where
    component 1 or 3 differ instead)."""
    out = []
    for (name, ha, fa), (_, hb, fb) in zip(a["entries"], b["entries"]):
        if ha != hb:
            sa, sb = set(fa.split(",")), set(fb.split(","))
            out.append((name, sorted(sa - sb), sorted(sb - sa)))
    if len(a["entries"]) != len(b["entries"]):
        out.append(("entries", [len(a["entries"])], [len(b["entries"])]))
    return out


def _same(a: dict, b: dict, what: str):
    diff = differences(a, b)
    for name, only_a, only_b in diff:
        print(f"{what}: {name} signs apart; only in the first: {only_a}; "
              f"only in the second: {only_b}")
    assert not diff, f"{what}: {len(diff)} entries sign apart: {diff}"
    assert a["tasks"] == b["tasks"] and a["plan_id"] == b["plan_id"], what


def _measure(order: str, plan):
    """What the process runs between the two builds."""
    if order in ("serial", "pooled"):
        with LatencyDB() as db:
            rep = execute_plan(db, plan, workers=1 if order == "serial" else 2)
        assert rep.measured == len(plan.todo)
        return
    from repro_torch.serving import Engine, SchedulerConfig
    from repro_torch.workload import synthetic
    cfg = get_smoke_config(MODEL)
    engine = Engine(cfg, sched_config=SchedulerConfig(4, 256, 64), max_seq=512,
                    impl="kernel", seed=0, device="cuda")
    served = engine.run(synthetic(6, rate=50.0, prompt_len=96, out_len=12,
                                  seed=3, vocab=cfg.vocab_size))["requests"]
    assert all(r.done for r in served)


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["serial", "pooled", "serving"])
def test_gpu_plan_signs_the_same_after_measuring(order):
    """The plan built, then executed into a fresh DB (serially, or by two
    pool workers) or the engine serving a few requests through CUDA
    graphs, then built again in the same process: the same id and the same
    task ids in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.core.signature import fingerprint
    trace = trace_model(get_smoke_config(MODEL))
    fallbacks = fingerprint.fallbacks
    with LatencyDB() as db:
        first = _card_plan(db, trace)
    _measure(order, first)
    with LatencyDB() as db:
        again = _card_plan(db, trace)
    _same(plan_record(first), plan_record(again),
          f"rebuilt after {order} ({fingerprint.fallbacks - fallbacks} "
          f"fingerprints fell back, the last with {fingerprint.last_error})")
    assert fingerprint.fallbacks == fallbacks, fingerprint.last_error


def _child_record() -> dict:
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-4000:]
    tagged = [line for line in run.stdout.splitlines()
              if line.startswith(RECORD_TAG)]
    assert len(tagged) == 1, run.stdout[-2000:]
    return json.loads(tagged[0][len(RECORD_TAG):])


@pytest.mark.gpu
def test_gpu_plan_signs_the_same_in_two_processes():
    """The plan built in two fresh processes: the same id, task ids and
    signatures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    a, b = _child_record(), _child_record()
    _same(a, b, "two processes")


def child_main() -> int:
    """One fresh process's plan record, as one tagged JSON line."""
    with LatencyDB() as db:
        print(RECORD_TAG + json.dumps(plan_record(_card_plan(db))), flush=True)
    return 0


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    sys.exit(child_main())
