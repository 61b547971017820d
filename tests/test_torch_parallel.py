"""The port's logical-axis sharding against the JAX package's: ``spec_for``
on the production meshes (a ``jax.sharding.AbstractMesh`` on the reference
side, a fake-group ``DeviceMesh`` on the port's), every model's parameter
axes, the abstract inputs and caches of the twelve full configurations at
the four assigned shapes, the optimizers' state axes; the dry run's
per-device FLOPs on hand-built products; the comm profile and the
roofline backend at ``tp > 1`` on the reference's constants.

Exact comparisons, but for the comm rows (1e-12 absolute, µs) and the
roofline's makespans (1e-9 relative): the same formulas in float64.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.api import backends as jax_backends
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.database import LatencyDB as JaxLatencyDB
from repro.core.profiler import DoolyProf as JaxProf
from repro.models import build_model
from repro.models import transformer as jax_tfm
from repro.parallel import roofline as jax_roofline
from repro.parallel import sharding as jax_sharding
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.train import optimizer as jax_opt
from repro_torch.api import backends
from repro_torch.configs import CORPUS_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.profiler import COMM_OPS, COMM_SIZES, DoolyProf
from repro_torch.launch.dryrun import StepMeter, fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.parallel import roofline
from repro_torch.parallel import sharding
from repro_torch.serving import SchedulerConfig
from repro_torch.train import optimizer, trainer

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
NAMES = sorted(set(sharding.TRAIN_RULES) | set(sharding.SERVE_RULES)) + [None]
#: dims that every mesh axis divides, that only 16 does, and that none does
DIMS = (512, 16, 2, 1)


def _meta_model(cfg) -> Model:
    return Model(cfg, device="meta", generator=torch.Generator())


@pytest.fixture(scope="module", params=[False, True], ids=["single", "multi"])
def meshes(request):
    sizes, axes = MESHES[request.param]
    with fake_world(int(np.prod(sizes))):
        yield AbstractMesh(sizes, axes), make_production_mesh(
            multi_pod=request.param)


def test_rules_are_the_references():
    assert sharding.TRAIN_RULES == jax_sharding.TRAIN_RULES
    assert sharding.SERVE_RULES == jax_sharding.SERVE_RULES


def test_spec_for_matches_the_reference(meshes):
    jmesh, mesh = meshes
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == dict(jmesh.shape)
    n = 0
    for rules in (sharding.TRAIN_RULES, sharding.SERVE_RULES):
        for names in itertools.chain(((a,) for a in NAMES),
                                     itertools.permutations(NAMES[:8], 2),
                                     [("batch", "cache_seq", "kv_heads", None),
                                      ("experts", "embed_fsdp", "moe_ff"),
                                      ("batch", "seq_model", "heads", None)]):
            for dims in [None] + [d for d in itertools.product(
                    DIMS, repeat=len(names))][:9]:
                want = tuple(jax_sharding.spec_for(list(names), jmesh, rules,
                                                   dims=dims))
                got = sharding.spec_for(list(names), mesh, rules, dims=dims)
                assert got == want, (names, dims)
                n += 1
    assert n > 1000


def test_spec_for_after_override_rule(meshes):
    jmesh, mesh = meshes
    names = ["batch", "heads", "embed_fsdp"]
    for logical, target in (("heads", None), ("embed_fsdp", "model"),
                            ("batch", "model"), ("seq", "fsdp")):
        with jax_sharding.use_mesh(None, jax_sharding.SERVE_RULES), \
                sharding.use_mesh(None, sharding.SERVE_RULES):
            jax_sharding.override_rule(logical, target)
            sharding.override_rule(logical, target)
            for dims in (None, (32, 32, 4096), (1, 8, 16)):
                want = tuple(jax_sharding.spec_for(names + ["seq"], jmesh,
                                                   dims=dims and dims + (64,)))
                got = sharding.spec_for(names + ["seq"], mesh,
                                        dims=dims and dims + (64,))
                assert got == want, (logical, target, dims)


def test_placements_shard_major_to_minor(meshes):
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = meshes
    spec = sharding.spec_for(["batch", "heads"], mesh, sharding.TRAIN_RULES,
                             dims=(64, 32))
    want = [Shard(0)] * (mesh.ndim - 1) + [Shard(1)]
    assert sharding.placements_for(spec, mesh) == want
    assert sharding.placements_for((None, None), mesh) == [Replicate()] * mesh.ndim
    with pytest.raises(ValueError):
        sharding.placements_for((tuple(reversed(mesh.mesh_dim_names[:2])),),
                                mesh)


def test_constrain_is_a_no_op_off_a_mesh_and_on_plain_tensors(meshes):
    _, mesh = meshes
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", "heads") is x
    with sharding.use_mesh(mesh, sharding.SERVE_RULES):
        assert sharding.current_mesh() is mesh
        assert sharding.constrain(x, "batch", "heads") is x
    assert sharding.current_mesh() is None


def _reference_axes_by_port_name(name: str):
    """{port parameter name: the reference's axes without the stacked
    ``layers`` axis}, through ``params_from_jax``'s naming: the reference's
    tree is given leaves of ids, stacked ones one per layer."""
    jm = build_model(jax_smoke_config(name))
    axes = jax.tree.leaves(jm.param_axes(),
                           is_leaf=lambda a: isinstance(a, tuple))
    shapes = jax.tree.leaves(jm.abstract_params())
    ids = [np.full(s.shape[:1] if ax and ax[0] == "layers" else (), i)
           for i, (ax, s) in enumerate(zip(axes, shapes))]
    tree = jax.tree.unflatten(jax.tree.structure(jm.abstract_params()), ids)
    out = {}
    for n, i in params_from_jax(tree, get_smoke_config(name)).items():
        ax = axes[int(i)]
        out[n] = ax[1:] if ax and ax[0] == "layers" else ax
    return out


@pytest.mark.parametrize("name", CORPUS_ARCHS)
def test_param_axes_match_the_reference(name):
    model = _meta_model(get_smoke_config(name))
    got = model.param_axes()
    assert got == _reference_axes_by_port_name(name)
    abstract = model.abstract_params()
    assert list(abstract) == list(got)
    assert all(t.device.type == "meta" and len(got[n]) == t.dim()
               for n, t in abstract.items())


def _same(port, ref):
    assert tuple(port.shape) == tuple(ref.shape)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype)


@pytest.mark.parametrize("name", CORPUS_ARCHS)
def test_input_specs_and_caches_match_the_reference(name):
    cfg = get_config(name)
    model, jm = _meta_model(cfg), build_model(jax_config(name))
    p = len(jm.pattern)
    for shape in SHAPES:
        got, want = model.input_specs(SHAPES[shape]), jm.input_specs(JAX_SHAPES[shape])
        assert sorted(got) == sorted(want)
        if "batch" in got:
            assert sorted(got["batch"]) == sorted(want["batch"])
            for k in got["batch"]:
                _same(got["batch"][k], want["batch"][k])
            continue
        for k in ("tokens", "lengths"):
            _same(got[k], want[k])
        cache, ref = got["cache"], want["cache"]["blocks"]
        axes, ref_axes = tfm.cache_axes(cache), jax_tfm.cache_axes(want["cache"])["blocks"]
        assert len(cache) == cfg.n_layers
        for i, layer in enumerate(cache):
            assert sorted(layer) == sorted(ref[i % p])
            for k, t in layer.items():
                assert t.device.type == "meta"
                _same(t, jax.ShapeDtypeStruct(ref[i % p][k].shape[1:],
                                              ref[i % p][k].dtype))
                assert axes[i][k] == ref_axes[i % p][k][1:]


def _by_reference_leaf(tree, is_leaf):
    """{``zoo.stack_key`` of a reference leaf: its subtree} of a tree laid
    out as the reference's parameters."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_state_axes_match_the_reference(opt):
    name = "llama3-8b"
    axes = _reference_axes_by_port_name(name)
    model = _meta_model(get_smoke_config(name))
    jm = build_model(jax_smoke_config(name))
    port = optimizer.make_optimizer(opt).state_axes(model.param_axes(),
                                                     model.param_stacks())
    ref = jax_opt.make_optimizer(opt).state_axes(jm.param_axes())
    state = trainer.train_state_axes(model, optimizer.make_optimizer(opt))
    assert state == {"step": (), "params": axes, "opt": port}
    assert port["count"] == ref["count"] == ()
    if opt == "adamw":
        assert port == {"m": axes, "v": axes, "count": ()}
        assert ref["m"] == ref["v"] == jm.param_axes()
        return
    # Adafactor's state axes are the reference's, leaf by leaf: a stacked
    # norm scale (layers, d) is factored as the reference factors it
    want = _by_reference_leaf(ref["f"], lambda x: isinstance(x, dict) and all(
        isinstance(v, tuple) for v in x.values()))
    # (a leaf that stacks nothing is keyed by its parameter's name)
    assert {k.replace(".", "/"): v for k, v in port["f"].items()} == want
    assert port["f"]["blocks/0/ln1/scale"] == {"vr": ("layers",),
                                               "vc": (None,)}
    assert port["f"]["final_norm.scale"] == ref["f"]["final_norm"]["scale"]


def test_abstract_train_state_is_meta_and_matches_the_axes():
    model = _meta_model(get_smoke_config("llama4-maverick-400b-a17b"))
    state = trainer.abstract_train_state(model)
    axes = trainer.train_state_axes(model)
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    assert state["step"].shape == () and axes["step"] == ()
    for n, p in state["params"].items():
        assert p.device.type == "meta" and len(axes["params"][n]) == p.dim()
    # the optimizer's state is laid out by the reference's leaves: the
    # stacks, and each parameter that no stack names
    stacks = model.param_stacks()
    stacked = {n for v in stacks.values() for n in v}
    assert sorted(state["opt"]["f"]) == sorted(
        list(stacks) + [n for n in state["params"] if n not in stacked])
    for key, leaf in state["opt"]["f"].items():
        ax = axes["opt"]["f"][key]
        assert sorted(leaf) == sorted(ax)
        assert all(leaf[k].device.type == "meta" and leaf[k].dtype ==
                   torch.float32 and leaf[k].dim() == len(ax[k]) for k in leaf)


# -- per-device FLOPs -------------------------------------------------------

def _dt(shape, mesh, spec):
    from torch.distributed.tensor import DTensor
    s = sharding.NamedSharding(mesh, spec)
    return DTensor.from_local(torch.empty(s.shard_shape(shape), device="meta"),
                              mesh, s.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _sharded_size(t, mesh) -> int:
    """The product of the sizes of the mesh dims on which ``t`` is sharded
    or partial."""
    return int(np.prod([n for p, n in zip(t.placements, mesh.shape)
                        if p.is_shard() or p.is_partial()]))


@pytest.mark.parametrize("case", ["batch", "contraction", "output", "both",
                                  "replicated"])
def test_per_device_flops_divide_by_the_sharded_mesh_dims(meshes, case):
    """Two layers, (B,D) @ (D,F) @ (F,D): each product's global FLOPs over
    the sizes of the mesh dims its output is sharded or partial on, but
    where a partial sum goes into a product (``contraction``'s second):
    each device holds a whole-size partial sum and multiplies all of it,
    so the meter, which counts each device's own ops, counts it whole."""
    _, mesh = meshes
    sizes = sharding.mesh_sizes(mesh)
    fsdp = tuple(a for a in ("pod", "data") if a in sizes)
    fsdp = fsdp if len(fsdp) > 1 else fsdp[0]
    n_fsdp = int(np.prod([sizes[a] for a in sizes if a != "model"]))
    b, d, f = 512, 256, 1024
    x_spec, w1_spec, w2_spec, divs = {
        "batch": ((fsdp, None), (None, None), (None, None), (n_fsdp, n_fsdp)),
        "contraction": ((None, "model"), ("model", None), (None, None),
                        (16, 1)),
        "output": ((None, None), (None, "model"), ("model", None), (16, 16)),
        "both": ((fsdp, None), (None, "model"), ("model", None),
                 (n_fsdp * 16, n_fsdp * 16)),
        "replicated": ((None, None), (None, None), (None, None), (1, 1))}[case]
    x, w1, w2 = (_dt(s, mesh, sp) for s, sp in
                 (((b, d), x_spec), ((d, f), w1_spec), ((f, d), w2_spec)))
    meters = StepMeter(), StepMeter()
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        with meters[0]:
            h = x @ w1
        with meters[1]:
            y = h @ w2
    assert tuple(y.shape) == (b, d)
    for meter, out, div in zip(meters, (h, y), divs):
        assert meter.flops * div == 2 * b * d * f
        assert meter.peak > 0
        if not (case == "contraction" and out is y):
            assert _sharded_size(out, mesh) == div


def test_every_rule_off_gives_the_global_flops(meshes):
    """The two-layer case through the model's own layers with every rule
    set to None: nothing is sharded, each device does all the work."""
    from repro_torch.models.layers import MLP
    _, mesh = meshes
    rules = {k: None for k in sharding.TRAIN_RULES}
    mlp = MLP(256, 1024, "silu", device="meta", generator=torch.Generator())
    x = _dt((8, 64, 256), mesh, (None, None, None))
    for n, p in list(mlp.named_parameters()):
        owner, _, leaf = n.rpartition(".")
        setattr(mlp.get_submodule(owner), leaf, torch.nn.Parameter(
            _dt(tuple(p.shape), mesh, (None, None)), requires_grad=False))
    meter = StepMeter()
    with sharding.use_mesh(mesh, rules), meter:
        mlp(x)
    assert meter.flops == 3 * 2 * 8 * 64 * 256 * 1024
    assert not meter.coll


# -- comm profile and the roofline at tp > 1 --------------------------------

def test_profile_comm_matches_the_reference_on_its_figure(monkeypatch):
    monkeypatch.setattr(roofline, "NVLINK_BW",
                        jax_roofline.ICI_LINKS * jax_roofline.ICI_BW)
    assert (COMM_OPS, COMM_SIZES) == (jax_profiler_consts())
    with LatencyDB() as db, JaxLatencyDB() as jdb:
        prof = DoolyProf(db, oracle="h100_analytical", hardware="cpu",
                         device="cpu")
        jprof = JaxProf(jdb, oracle="tpu_analytical", hardware="cpu")
        assert prof.profile_comm(topology="t") == 54
        assert jprof.profile_comm(topology="t") == 54
        rows = db.conn.execute("SELECT * FROM comm_ops ORDER BY 1,2,3,4").fetchall()
        jrows = jdb.conn.execute("SELECT * FROM comm_ops ORDER BY 1,2,3,4").fetchall()
    assert [r[:4] for r in rows] == [r[:4] for r in jrows]
    assert max(abs(a[4] - b[4]) for a, b in zip(rows, jrows)) <= 1e-12


def jax_profiler_consts():
    from repro.core import profiler as jp
    return jp.COMM_OPS, jp.COMM_SIZES


def test_profile_comm_defaults_to_nvlink():
    with LatencyDB() as db:
        prof = DoolyProf(db, oracle="h100_analytical", hardware="cpu",
                         device="cpu")
        assert prof.profile_comm() == 54
        lat = db.comm_latency("nvlink-ring", 8, "all-reduce", 1 << 27)
    assert lat == pytest.approx(1.0 + (1 << 27) * 2 * 7 / 8 / 450e9 * 1e6,
                                rel=1e-12)


POINTS = [("prefill", 256, 1, 2048), ("decode", 1, 8, 2048),
          ("prefill", 64, 4, 512), ("decode", 1, 1, 32768)]


@pytest.mark.parametrize("name", ["llama3-8b", "granite-20b",
                                  "falcon-mamba-7b"])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_roofline_backend_matches_the_reference(monkeypatch, name, tp):
    monkeypatch.setattr(roofline, "NVLINK_BW",
                        jax_roofline.ICI_LINKS * jax_roofline.ICI_BW)
    kw = dict(max_seq=4096, tp=tp)
    port = backends.RooflineBackend(
        get_config(name), sched_config=SchedulerConfig(),
        peak_flops=jax_roofline.PEAK_FLOPS, hbm_bw=jax_roofline.HBM_BW, **kw)
    ref = jax_backends.RooflineBackend(
        jax_config(name), sched_config=JaxSchedulerConfig(), **kw)
    got, want = port.predict_points(POINTS), ref.predict_points(POINTS)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_roofline_backend_tp1_has_no_collective_term():
    """At tp = 1 the collective term is 0: the makespans are those of
    max(compute, memory), whatever the link."""
    cfg = get_config("llama3-8b")
    a = backends.RooflineBackend(cfg, sched_config=SchedulerConfig(),
                                 max_seq=4096)
    b = backends.RooflineBackend(cfg, sched_config=SchedulerConfig(),
                                 max_seq=4096)
    b.link_bw = 1.0
    assert np.array_equal(a.predict_points(POINTS), b.predict_points(POINTS))
    tp8 = backends.RooflineBackend(cfg, sched_config=SchedulerConfig(),
                                   max_seq=4096, tp=8)
    assert tp8.link_bw == roofline.NVLINK_BW == roofline.NVLINK_BIDIR_BW / 2
