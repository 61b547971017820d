"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's layout: per-device argument bytes of the ten assigned
architectures at the two serving shapes on both production meshes, equal
to the integer the reference's ``abstract_params``, ``spec_for`` and
``input_specs`` give on a ``jax.sharding.AbstractMesh`` (nothing is
compiled on either side); whole cells on the fake 256- and 512-rank groups;
the command line.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models import build_model
from repro.models import transformer as jax_tfm
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun

MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _ref_bytes(tree, axes, mesh) -> int:
    """Per-device bytes of the reference's abstract ``tree`` laid out by
    its logical ``axes`` with ``SERVE_RULES`` on ``mesh``."""
    total = 0
    for sds, ax in zip(jax.tree.leaves(tree),
                       jax.tree.leaves(axes, is_leaf=_is_axes)):
        spec = jax_sharding.spec_for(list(ax), mesh, jax_sharding.SERVE_RULES,
                                     dims=sds.shape)
        local = list(sds.shape)
        for d, a in enumerate(spec):
            for name in ((a,) if isinstance(a, str) else a or ()):
                local[d] //= mesh.shape[name]
        total += math.prod(local) * np.dtype(sds.dtype).itemsize
    return total


def reference_argument_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    mesh, jm = MESHES[multi_pod], build_model(jax_config(arch))
    specs = jm.input_specs(JAX_SHAPES[shape])
    total = _ref_bytes(jm.abstract_params(), jm.param_axes(), mesh)
    if "batch" in specs:
        batch_axes = jax.tree.map(
            lambda s: ("batch",) + (None,) * (len(s.shape) - 1), specs["batch"])
        return total + _ref_bytes(specs["batch"], batch_axes, mesh)
    total += _ref_bytes(specs["cache"], jax_tfm.cache_axes(specs["cache"]), mesh)
    for k in ("tokens", "lengths"):
        total += _ref_bytes(specs[k], ("batch",), mesh)
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_argument_bytes_match_the_reference(multi_pod):
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    with dryrun.fake_world(512 if multi_pod else 256):
        for arch in ASSIGNED_ARCHS:
            for shape in ("prefill_32k", "decode_32k"):
                lowered, meta = dryrun.lower_cell(arch, shape,
                                                  multi_pod=multi_pod)
                assert meta["status"] == "ok"
                want = reference_argument_bytes(arch, shape, multi_pod)
                assert lowered["argument_bytes"] == want, (arch, shape)


@pytest.mark.parametrize("arch", ["llama3-8b", "command-r7b"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_decode_cells_run(arch, multi_pod):
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) >= {"arch", "shape", "mesh", "status", "kind", "lower_s",
                        "compile_s", "bytes_per_device",
                        "peak_bytes_per_device", "roofline",
                        "model_flops_total", "useful_flops_ratio",
                        "kv_seq_shards"}
    b = rec["bytes_per_device"]
    assert b["argument"] > b["alias"] > 0 and b["temp"] > 0
    # the cache is written in place: every output but the logits aliases;
    # the float32 logits (B, vocab) are sharded by batch, and by vocab
    # where 16 divides it (llama3's 128256; not command-r7b's 255029)
    vocab = get_config(arch).vocab_size
    local_vocab = vocab // 16 if vocab % 16 == 0 else vocab
    assert b["output"] - b["alias"] == (128 // (32 if multi_pod else 16)
                                        * local_vocab * 4)
    assert rec["peak_bytes_per_device"] == (b["argument"] + b["output"]
                                            + b["temp"] - b["alias"])
    assert 0 < rec["useful_flops_ratio"] <= 1
    roof = rec["roofline"]
    assert set(roof) == {"flops_per_chip", "hbm_bytes_per_chip",
                         "collective_bytes_per_chip", "collective_by_kind",
                         "compute_s", "memory_s", "collective_s", "dominant"}
    assert roof["collective_bytes_per_chip"] == sum(
        roof["collective_by_kind"].values()) > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b"])
def test_moe_decode_cells_run_with_the_references_argument_bytes(arch):
    """The MoE FFN's expert-parallel dispatch under the mesh: the whole
    cell runs, and its per-device arguments are the reference's.  Its
    FLOPs and collectives are the port's own dispatch's (every device
    routes the whole batch and gathers the experts' outputs), not XLA's
    partitioning of the reference's."""
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["bytes_per_device"]["argument"] == reference_argument_bytes(
        arch, "decode_32k", False)
    assert rec["roofline"]["collective_by_kind"].get("all-gather", 0) > 0
    assert not torch.distributed.is_initialized()


def test_skips_and_refusals():
    rec = dryrun.run_cell("llama3-8b", "long_500k", multi_pod=False)
    assert rec["status"] == "skip" and "quadratic" in rec["reason"]
    rec = dryrun.run_cell("llama3-8b", "decode_32k", multi_pod=False,
                          impl="kernel")
    assert rec["status"] == "error" and "meta" in rec["error"]
    assert not torch.distributed.is_initialized()


def test_command_line(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "command-r7b", "--shape", "long_500k",
                     "--mesh", "both", "--out", str(out)])
    assert done.value.code == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[skip] command-r7b x long_500k (single): ")
    assert lines[1].startswith("[skip] command-r7b x long_500k (multi): ")
    assert lines[-1] == "dry-run: 0 ok, 2 skip, 0 error / 2 cells"
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["single", "multi"]
