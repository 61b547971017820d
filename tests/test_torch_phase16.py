"""chip_smoke.py's phase 16 — the dry run's child processes, the engine
under a host mesh, the comm profile and the roofline at tp > 1 — on the CPU
at the smoke configuration (a one-rank gloo group stands in for the card's
NCCL one), and the model's DTensor paths on four CPU ranks (gloo, a 2 x 2
``("data", "model")`` mesh with real shards) against the same model on
plain tensors.  The card's numbers come from ``python3 chip_smoke.py`` on
an H100; the ``gpu`` test runs phase 16's mesh serving there at the smoke
configuration.

Tolerance of the four-rank comparison: 2e-5 of each output's largest
entry (float32; sums over shards reduce in other orders).  The MoE FFN's
expert-parallel dispatch on the same mesh: 1e-6 of each output's largest
entry (float32), outputs, aux terms and gradients, under both rule sets."""
import importlib.util
import json
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core.database import LatencyDB

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_chip_smoke_phase_16_on_cpu(capsys, tmp_path):
    from repro_torch.launch.mesh import make_host_mesh
    cs = _chip_smoke()
    cpu, cfg = torch.device("cpu"), get_smoke_config("llama3-8b")
    groups = [[("command-r7b", "long_500k", "both")],
              [("llama3-8b", "decode_32k", "single"),
               ("olmoe-1b-7b", "decode_32k", "single")]]
    procs = cs.phase_dryrun_start(groups, tmp_path / "dryrun")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_port()}",
                            rank=0, world_size=1)
    try:
        mesh = cs.phase_mesh_serving(cfg, cpu, make_host_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert mesh["serve_counts"] == [0, 0, 0, 0] == mesh["prefill_counts"]
    assert mesh["steps"] > 0
    assert mesh["param_bytes"] == sum(
        p.numel() * p.element_size() for p in cs.Model(
            cfg, device="meta", generator=torch.Generator()).parameters())
    LatencyDB(str(tmp_path / "base.sqlite")).close()
    comm = cs.phase_comm(cfg, cpu, base_db=tmp_path / "base.sqlite",
                         db=tmp_path / "phase16.sqlite", hardware="cpu")
    assert comm["comm_rows"] == 54 and 1.0 < comm["comm_us"][0] < comm["comm_us"][1]
    spans = comm["roofline_makespan_s"]
    assert list(spans) == ["1", "2", "4", "8"] and all(v > 0 for v in spans.values())
    dry = cs.phase_dryrun_finish(procs, "command-r7b", 300, n_main=2)
    out = capsys.readouterr().out
    assert "[16 mesh] llama3-smoke:" in out and "[16 roofline]" in out
    assert "[16 comm] profile_comm: 54 rows" in out
    assert out.count("[skip] command-r7b x long_500k") == 2
    assert "[ok] llama3-8b x decode_32k (single): peak=" in out
    assert len(dry["wall_s"]) == 2
    cells = {(c["arch"], c["mesh"]): c["status"] for c in dry["cells"]}
    assert cells[("llama3-8b", "single")] == "ok"
    # the MoE dispatch runs expert parallel under the mesh
    assert cells[("olmoe-1b-7b", "single")] == "ok"
    assert dry["errors"] == []


# -- the DTensor paths on four ranks ----------------------------------------

def _four_ranks(rank: int, port: int, out: str):
    """One rank of a 2 x 2 mesh: the smoke llama3's decode step, prefill
    (``xla`` and ``chunked``) and loss and every parameter's gradient
    (``chunked``: the flash semantics' own backward) with its parameters,
    inputs and caches sharded by the logical axes, gathered and compared
    on rank 0 with the same model on plain tensors."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import tree_shardings
    from repro_torch.models import Model
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES,
                                               use_mesh)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = get_smoke_config("llama3-8b")
        rng = np.random.default_rng(0)
        b, s, smax = 4, 12, 32
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
        step_tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b,)))
        lengths = torch.tensor([12, 3, 7, 12], dtype=torch.int32)

        def model():
            return Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))

        def sharded(m, rules):
            ab = {n: p.detach() for n, p in m.named_parameters()}
            sh = tree_shardings(m.param_axes(), ab, mesh, rules)
            for n, t in ab.items():
                owner, _, leaf = n.rpartition(".")
                setattr(m.get_submodule(owner), leaf, torch.nn.Parameter(
                    distribute_tensor(t, mesh, sh[n].placements)))
            return m

        def dist_tree(tree, axes, rules):
            sh = tree_shardings(axes, tree, mesh, rules)
            if isinstance(tree, dict):
                return {k: distribute_tensor(v, mesh, sh[k].placements)
                        for k, v in tree.items()}
            return [dist_tree(t, a, rules) for t, a in zip(tree, axes)]

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        plain, res = model(), {}
        with torch.no_grad():
            want_pf, cache = plain.prefill(tokens, max_seq=smax)
            want_dec, cache = plain.decode_step(
                [{k: v.clone() for k, v in c.items()} for c in cache],
                step_tok, lengths)
        want_loss, _ = plain.loss({"tokens": tokens, "labels": tokens},
                                  impl="chunked")
        with torch.no_grad():
            want_chunked = plain.prefill(tokens, max_seq=smax, impl="chunked")[0]
        names = [n for n, _ in plain.named_parameters()]
        want_grad = torch.autograd.grad(want_loss, list(plain.parameters()))

        m = sharded(model(), SERVE_RULES)
        with use_mesh(mesh, SERVE_RULES), torch.no_grad():
            batch = dist_tree({"tokens": tokens}, {"tokens": ("batch", None)},
                              SERVE_RULES)
            got_pf, dcache = m.prefill(batch["tokens"], max_seq=smax)
            got_chunked = m.prefill(batch["tokens"], max_seq=smax,
                                    impl="chunked")[0]
            axes = tfm.cache_axes(cache)
            plain_cache = plain.prefill(tokens, max_seq=smax)[1]
            dc = dist_tree(plain_cache, axes, SERVE_RULES)
            lens = dist_tree({"l": lengths, "t": step_tok},
                             {"l": ("batch",), "t": ("batch",)}, SERVE_RULES)
            got_dec, dc = m.decode_step(dc, lens["t"], lens["l"])
        res["prefill"] = (full(got_pf), want_pf)
        res["prefill chunked"] = (full(got_chunked), want_chunked)
        res["decode"] = (full(got_dec), want_dec)
        res["cache_k"] = (full(dc[1]["k"]), cache[1]["k"])

        m = sharded(model(), TRAIN_RULES)
        with use_mesh(mesh, TRAIN_RULES):
            batch = dist_tree({"tokens": tokens, "labels": tokens},
                              {"tokens": ("batch", None),
                               "labels": ("batch", None)}, TRAIN_RULES)
            loss, _ = m.loss(batch, impl="chunked")
            grads = torch.autograd.grad(loss, list(m.parameters()))
        res["loss"] = (full(loss), want_loss.detach())
        for n, g, w in zip(names, grads, want_grad):
            res[f"grad {n}"] = (full(g), w)
        if rank == 0:
            errs = {k: float((a - w).abs().max() / w.abs().max().clamp(min=1e-30))
                    for k, (a, w) in res.items()}
            Path(out).write_text(json.dumps(errs))
    finally:
        dist.destroy_process_group()


def test_sharded_model_matches_plain_on_four_ranks(tmp_path):
    out = tmp_path / "errs.json"
    torch.multiprocessing.spawn(_four_ranks, args=(_port(), str(out)),
                                nprocs=4, join=True)
    errs = json.loads(out.read_text())
    grads = {k for k in errs if k.startswith("grad ")}
    assert set(errs) - grads == {"prefill", "prefill chunked", "decode",
                                 "cache_k", "loss"}
    assert {"grad embed.table", "grad lm_head.w",
            "grad layers.0.self_attn.k_proj.w"} <= grads and len(grads) > 20
    assert all(e <= TOL for e in errs.values()), errs


MOE_TOL = 1e-6


def _four_ranks_moe(rank: int, port: int, out: str):
    """One rank of a 2 x 2 mesh: ``moe_ffn`` of olmoe-smoke and of
    llama4-maverick-smoke (a shared expert), its weights and input sharded
    by the logical axes under each rule set, against the plain path:
    outputs, aux terms, and the gradients of the weights and the input."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import tree_shardings
    from repro_torch.models.moe import MoE, moe_ffn
    from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES,
                                               use_mesh)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        res = {}
        for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
            cfg = get_smoke_config(arch)
            x = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (4, 6, cfg.d_model), dtype=np.float32))
            r = torch.from_numpy(np.random.default_rng(2).standard_normal(
                (4, 6, cfg.d_model), dtype=np.float32))

            def full(t):
                return t.full_tensor() if hasattr(t, "full_tensor") else t

            def moe():
                return MoE(cfg, device="cpu", dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0))

            def run(m, xi):
                y, aux = moe_ffn(m, xi)
                obj = (y * r).sum() + aux["load_balance"] + aux["router_z"]
                names = [n for n, _ in m.named_parameters()]
                g = torch.autograd.grad(obj, [xi] + list(m.parameters()))
                return y, aux, dict(zip(["x"] + names, g))

            plain = moe()
            want = run(plain, x.clone().requires_grad_())
            for label, rules in (("train", TRAIN_RULES), ("serve", SERVE_RULES)):
                m = moe()
                params = {n: p.detach() for n, p in m.named_parameters()}
                axes = {n: m.get_submodule(n.rpartition(".")[0]).axes[
                    n.rpartition(".")[2]] for n in params}
                sh = tree_shardings(axes, params, mesh, rules)
                for n, t in params.items():
                    owner, _, leaf = n.rpartition(".")
                    setattr(m.get_submodule(owner), leaf, torch.nn.Parameter(
                        distribute_tensor(t, mesh, sh[n].placements)))
                with use_mesh(mesh, rules):
                    xs = tree_shardings({"x": ("batch", None, None)}, {"x": x},
                                        mesh, rules)["x"]
                    xd = distribute_tensor(x, mesh, xs.placements
                                           ).requires_grad_()
                    got = run(m, xd)
                pre = f"{arch} {label} "
                res[pre + "out"] = (full(got[0]), want[0])
                for k in want[1]:
                    res[pre + k] = (full(got[1][k]), want[1][k])
                for n, g in want[2].items():
                    res[pre + "grad " + n] = (full(got[2][n]), g)
        if rank == 0:
            errs = {k: float((a.detach() - w.detach()).abs().max()
                             / w.detach().abs().max().clamp(min=1e-30))
                    for k, (a, w) in res.items()}
            Path(out).write_text(json.dumps(errs))
    finally:
        dist.destroy_process_group()


def test_moe_ffn_under_a_mesh_matches_plain_on_four_ranks(tmp_path):
    out = tmp_path / "errs.json"
    torch.multiprocessing.spawn(_four_ranks_moe, args=(_port(), str(out)),
                                nprocs=4, join=True)
    errs = json.loads(out.read_text())
    for arch in ("olmoe-1b-7b", "llama4-maverick-400b-a17b"):
        for label in ("train", "serve"):
            pre = f"{arch} {label} "
            assert {pre + k for k in ("out", "load_balance", "router_z",
                                      "grad x", "grad router.w", "grad up",
                                      "grad down")} <= set(errs)
    assert any(k.endswith("grad shared.up_proj.w") for k in errs)
    assert all(e <= MOE_TOL for e in errs.values()), errs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_gpu_mesh_serving_gives_the_same_tokens_and_launches(cuda):
    from repro_torch.launch.mesh import make_host_mesh
    cs = _chip_smoke()
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_port()}",
                            rank=0, world_size=1)
    try:
        out = cs.phase_mesh_serving(get_smoke_config("llama3-8b"), cuda,
                                    make_host_mesh())
    finally:
        dist.destroy_process_group()
    layers = get_smoke_config("llama3-8b").n_layers
    assert out["serve_counts"][0] > 0 and out["serve_counts"][0] % layers == 0
    assert out["prefill_counts"] == [0, layers, 0, 0]
