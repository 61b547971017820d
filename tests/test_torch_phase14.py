"""chip_smoke.py's phase 14 — the MLA, MoE and hybrid families served, their
contexts timed, the five-model plan — and phase 3's timings at their
kernels' shapes, run on the CPU at the smoke configs, where the kernel
wrappers take their plain versions and the engine runs eagerly.  The
card's numbers come from ``python3 chip_smoke.py`` on an H100."""
import importlib.util
from pathlib import Path

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
#: chip_smoke's CLI flags on the CPU (the card's are the defaults)
CLI_ARGS = ["--device", "cpu", "--hardware", "cpu", "--oracle", "h100_analytical"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_14_on_cpu(capsys, tmp_path):
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    fams = [get_smoke_config(n) for n in (cs.MLA, cs.MOE, cs.HYBRID)]
    kernels = cs.phase_kernels(get_smoke_config("llama3-8b"), cpu,
                               get_smoke_config(cs.GRANITE), family_cfgs=fams)
    kernels.update(cs.phase_scan(get_smoke_config(cs.MAMBA), cpu,
                                 family_cfgs=fams[2:]))
    assert sorted(kernels["decode_attention"]["timed"]) == [
        "B=1 full ctx 2048", "B=8 random lengths",
        "granite-smoke B=8 G=4 random lengths",
        "hymba-smoke B=8 G=2 D=32 random lengths",
        "olmoe-smoke B=8 G=1 D=24 random lengths"]
    assert sorted(kernels["flash_attention_fwd"]["timed"]) == [
        "B=1 S=1024 4/2 heads D=32",
        "hymba-smoke B=1 S=1024 4/2 heads D=32 window 64"]
    windowed = kernels["flash_attention_fwd"]["timed"][
        "hymba-smoke B=1 S=1024 4/2 heads D=32 window 64"]
    # SDPA has no window of its own: its yardstick is SDPA with a boolean
    # mask of the pairs the window and causality leave
    assert windowed["library_ms"] > 0
    assert {"hymba-smoke prefill B=1 S=1024 Di=256",
            "hymba-smoke decode B=8 S=1 Di=256"} <= set(kernels["mamba_scan"]["timed"])

    served = {tag: cs.phase_family(c, cpu, tag)
              for tag, c in zip(("mla", "moe", "hybrid"), fams)}
    for tag, out in served.items():
        assert out["launches"] == (0, 0, 0, 0) and out["graph_cosine"] is None
        assert len(out["makespans_s"]) == 2 and all(m > 0 for m in out["makespans_s"])
        assert out["decode_iterations"] > 0 and len(out["decode_ms"]) == 2
    points = {tag: out["points"] for tag, out in served.items()}
    assert set(points["mla"]) == {"mla_attn"} and set(points["moe"]) == {"moe"}
    assert set(points["hybrid"]) == {"self_attn", "mamba"}
    assert set(points["mla"]["mla_attn"]) == {
        ("prefill", t, r, 0) for t in (64, 256) for r in (1, 8)} | {
        ("decode", 1, r, c) for r in (1, 8) for c in (512, 2048)}
    assert set(points["moe"]["moe"]) == {
        ("prefill", t, r, 0) for t in (8, 64, 256) for r in (1, 8)}
    assert all(len(v) == 2 and min(v) > 0 for p in points.values()
               for kind in p.values() for v in kind.values())
    hybrid = served["hybrid"]
    assert hybrid["chunks"] > 0 and hybrid["prefill"]["fp32_cosine"] > 0.99
    assert "prefill" not in served["mla"] and "prefill" not in served["moe"]

    base = tmp_path / "base.sqlite"
    LatencyDB(str(base)).close()
    plan = cs.phase_family_plan(CLI_ARGS, cpu, models=cs.PLAN_MODELS, full=False,
                                base_db=base, db=tmp_path / "phase14.sqlite")
    cov = plan["coverage"]
    assert plan["measured"] == cov["plan_tasks"] > 0 and cov["shared_tasks"] > 0
    assert {"mla_attn", "moe", "mamba", "self_attn"} <= set(plan["by_kind_s"])
    assert 0 < plan["spent_s"] < plan["naive_s"]

    line = cs.kernels_line(kernels, *(dict(decode_launches=0, flash_launches=0,
                                           scan_launches=0, flash_fwd_launches=0,
                                           flash_bwd_launches=0)
                                      for _ in range(8)), served, plan)
    assert all(k["launches"] == 0 for k in line["kernels"])
    out = capsys.readouterr().out
    for tag in ("mla", "moe", "hybrid"):
        assert f"[14 {tag}]" in out
    assert "[14 plan]" in out and "-token Model.prefill" in out
