"""The frozen traffic generator against the port's, the schedule every seed
serves, and the benchmark's files: every cell, configuration, mix and
metric of ``BENCHMARK.json`` has its file."""
import json

import pytest

from h100bench import run
from h100bench.traffic.generator import sharegpt_like, trace_shape, traces


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (7, {"scale": 0.25}),
    (2147483659, {"prompt_median": 2048, "prompt_mean": 2304, "out_median": 24,
                  "out_mean": 32, "vocab": 50304})])
def test_frozen_copy_draws_as_the_port(seed, kw):
    from repro_torch.workload import sharegpt_like as port
    ours = sharegpt_like(12, rate=1.5, seed=seed, **kw)
    theirs = port(12, rate=1.5, seed=seed, **kw)
    assert [(a, p, o) for a, p, o in ours] == [
        (r.arrival, [int(t) for t in r.prompt], r.max_new_tokens) for r in theirs]


@pytest.mark.parametrize("mix", ["rag", "chat"])
def test_every_seed_serves_one_schedule(mix):
    spec = json.loads((run.BENCH / "traffic" / f"{mix}.json").read_text())
    a, b = traces(spec, 1.2, 1, 1000), traces(spec, 1.2, 2, 1000)
    first_a, first_b, second_a = next(a), next(b), next(a)
    shape = lambda tr: [(t, len(p), o) for t, p, o in tr]  # noqa: E731
    assert shape(first_a) == shape(first_b)
    assert shape(second_a) != shape(first_a)
    assert sorted((len(p), o) for _, p, o in second_a) == sorted(
        (len(p), o) for _, p, o in first_a)
    assert [p for _, p, _ in first_a] != [p for _, p, _ in first_b]
    lengths, _ = trace_shape(spec, 1.2)
    assert len(lengths) == spec["trace_requests"]
    for p, o in lengths:
        assert spec["prompt_min"] <= p <= spec["prompt_max"]
        assert spec["out_min"] <= o <= spec["out_max"] and p + o <= spec["max_total"]


def test_benchmark_names_only_files_that_exist():
    from repro_torch.configs.base import ModelConfig
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        conf = json.loads((run.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"].split(" ")[0] or c["source"] in conf["source"]
        assert conf["reduced"] == c["reduced"]
        ModelConfig(**conf["model"])
    for w in spec["workloads"]:
        cell = json.loads((run.BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert cell["config"] in names
        assert (run.BENCH / "traffic" / f"{cell['traffic']}.json").exists()
        assert run.cell_metrics(spec, w["name"], False) and run.cell_metrics(spec, w["name"], True)
    for row in spec["end_to_end"] + spec["per_layer"]:
        assert (run.BENCH / "metrics" / "readers" / f"{row['name']}.py").exists()
