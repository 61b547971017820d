"""Smoke-size cells for the CPU tests: a copy of the benchmark in a
temporary directory, with small configurations, a short mix and their
cells added as new files, and a ``BENCHMARK.json`` that lists them.  The
harness runs them on the CPU's eager path (``--device cpu``)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent

SMOKE_CONFIGS = {
    "command-r7b-smoke": {
        "name": "command-r7b-smoke", "family": "dense", "n_layers": 4, "d_model": 128,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 384, "vocab_size": 384,
        "rope_theta": 50000.0, "sliding_window": 128, "swa_interleave": 4,
        "tie_embeddings": True, "norm_eps": 1e-05, "dtype": "float32"},
    "olmoe-smoke": {
        "name": "olmoe-smoke", "family": "moe", "n_layers": 3, "d_model": 96,
        "n_heads": 4, "n_kv_heads": 4, "head_dim": 24, "d_ff": 128, "vocab_size": 384,
        "rope_theta": 10000.0, "n_experts": 8, "top_k": 2, "moe_d_ff": 128,
        "moe_interleave": 1, "tie_embeddings": False, "norm_eps": 1e-05,
        "dtype": "float32"},
}
SMOKE_MIX = {"trace_requests": 6, "draw_seed": 5, "prompt_median": 40,
             "prompt_mean": 52, "prompt_min": 8, "prompt_max": 100,
             "out_median": 6, "out_mean": 8, "out_min": 2, "out_max": 16,
             "max_total": 120}
#: float32 on both sides: the gap is rounding, well under a logit's spread
SMOKE_LIMIT = 1e-3


def smoke_cell(config: str, limit: float = SMOKE_LIMIT) -> dict:
    return {"config": config, "traffic": "smoke", "chips": 1, "rate_rps": 50.0,
            "max_seq": 128,
            "sched": {"max_num_seqs": 4, "max_batch_tokens": 64, "chunk_size": 32,
                      "prefix_caching": False},
            "check": {"requests": 3, "limits": {"logit_gap": limit}}}


def make_bench(dest: Path, cells: dict) -> Path:
    """A checkout-like directory: ``h100bench/`` copied, the smoke configs,
    mix and ``cells`` ({name: cell}) added as files, and a
    ``BENCHMARK.json`` whose cells are ``cells`` and whose metrics are the
    repository's."""
    shutil.copytree(BENCH, dest / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = dest / "h100bench"
    for name, model in SMOKE_CONFIGS.items():
        (b / "configs" / f"{name}.json").write_text(json.dumps(
            {"source": "smoke size", "reduced": [], "model": model}))
    (b / "traffic" / "smoke.json").write_text(json.dumps(SMOKE_MIX))
    for name, cell in cells.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for row in bench["per_layer"] + bench["end_to_end"]:
        row.pop("workloads", None)
    bench["workloads"] = [{"name": n, "config": c["config"], "traffic": c["traffic"],
                           "chips": 1, "why": "smoke"} for n, c in cells.items()]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run_cell(root: Path, workload: str, seed: int = 3, trace: int = 0,
             timeout: float = 120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, str(root / "h100bench" / "run.py"), "--workload", workload,
         "--seed", str(seed), "--seconds", "0.05", "--trace", str(trace),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=timeout, cwd=root)
