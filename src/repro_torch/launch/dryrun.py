"""Multi-pod dry run: every (architecture x input shape) laid out on the
production meshes, with its per-device memory, FLOPs and collective bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
        --shape decode_32k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun.jsonl

Counterpart of ``repro.launch.dryrun``, and the one entry point of the port
that runs on the meta device by nature, as the reference's runs on
placeholder host devices: no tensor is ever allocated.  Each cell starts a
``fake``-backend process group of 256 or 512 ranks in this one process
(``fake_world``; torch's own test backend, whose collectives do nothing),
builds the production ``DeviceMesh`` over it and tears both down after.

The reference's ``lower()`` becomes building the model's parameters, the
inputs and the caches as DTensors of meta shards, laid out by the logical
axes (``parallel.sharding``); its ``compile()`` becomes one execution of
the step on meta under ``StepMeter``, which sees every op on each device's
local shards:

* argument and output bytes are exact, from the shards' shapes;
* temp is the peak of the live bytes the step allocates beyond its
  outputs, from the lifetimes of the storages it makes;
* FLOPs are ``torch.utils.flop_counter``'s (matmuls, convolutions,
  attention) counted on local shards: an op whose output is sharded or
  partial over a mesh dim does 1/size of the work on each device, a
  replicated one all of it;
* collective bytes, by kind, are the operand bytes of the functional
  collectives DTensor runs, as the reference sums HLO collective operands;
* HBM bytes are the bytes each op reads and writes, views excluded.

No CUDA kernel runs on meta, so ``--impl`` must name a plain backend.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.parallel import roofline as rl
from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES,
                                           NamedSharding, constrain,
                                           from_local, spec_for, use_mesh)
from repro_torch.train.trainer import (abstract_train_state,
                                       default_microbatches, make_train_step,
                                       train_state_axes)

Tree = Any

#: backends with no CUDA kernel behind them
PLAIN_IMPLS = ("auto", "xla", "chunked", "chunked_naive")

#: functional collectives -> the reference's HLO collective names
COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd")
_PLAIN = (torch.Tensor, torch.nn.Parameter)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake``-backend default process group of ``n`` ranks in this
    process (rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shardings and DTensors
# ---------------------------------------------------------------------------

def _map(f, tree, *rest):
    """``f`` over the leaves of ``tree`` (dicts and lists of tensors), with
    the matching leaves of ``rest`` (the same structure, tuples of axes as
    leaves)."""
    if isinstance(tree, dict):
        return {k: _map(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(f, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return f(tree, *rest)


def tree_shardings(axes: Tree, abstract: Tree, mesh, rules) -> Tree:
    return _map(lambda t, ax: NamedSharding(mesh, spec_for(
        list(ax), mesh, rules, dims=t.shape)), abstract, axes)


def batch_axes(batch_spec: Tree) -> Tree:
    return _map(lambda t: ("batch",) + (None,) * (t.dim() - 1), batch_spec)


def shard_bytes(abstract: Tree, shardings: Tree) -> int:
    """Per-device bytes of the tensors of ``abstract`` laid out so."""
    total = []
    _map(lambda t, s: total.append(math.prod(s.shard_shape(t.shape))
                                   * t.element_size()), abstract, shardings)
    return sum(total)


def distribute(abstract: Tree, shardings: Tree) -> Tree:
    """DTensors of meta shards, laid out by ``shardings``."""
    return _map(lambda t, s: from_local(torch.empty(
        s.shard_shape(t.shape), dtype=t.dtype, device="meta"), s.mesh,
        s.placements, t.shape), abstract, shardings)


def _shard_model(model: Model, params: Dict[str, torch.Tensor],
                 requires_grad: bool):
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(t, requires_grad=requires_grad))


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepMeter(TorchDispatchMode):
    """Sees every op of a step on local tensors: DTensor ops are passed on
    (``NotImplemented``) so that DTensor runs them on its shards, whose ops
    then come back here.  Counts FLOPs, bytes read and written, collective
    operand bytes by kind, and the live bytes of the storages the step
    allocates (their lifetimes by weak reference)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.coll: Dict[str, int] = defaultdict(int)
        self.live = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(t not in _PLAIN for t in types) or _propagating(func):
            # DTensor's own shape propagation (the global-shaped stand-ins
            # it makes, and fake tensors), or a wrapper around a
            # collective's result: no work on a device's shard
            return out
        packet = func._overloadpacket
        ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
        name = packet.__name__
        if ns in _COLLECTIVE_NS:
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.coll[kind] += sum(t.nbytes for t in _tensors((args, kwargs)))
            return out
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view:
            self.hbm_bytes += sum(t.nbytes for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t.untyped_storage())
        return out

    def scan(self, body, items: list) -> list:
        """The train step's microbatch loop, as the reference's cost
        analysis takes a scan: ``body`` runs on the first item and its
        FLOPs, bytes and collective bytes count once per item.  Every pass
        runs the same ops on the same shapes and layouts, so the totals are
        those of running them all, and its live bytes are every pass's."""
        flops, hbm, coll = self.flops, self.hbm_bytes, dict(self.coll)
        out = body(items[0])
        n = len(items) - 1
        self.flops += n * (self.flops - flops)
        self.hbm_bytes += n * (self.hbm_bytes - hbm)
        for k, v in list(self.coll.items()):
            self.coll[k] += n * (v - coll.get(k, 0))
        return [out] * len(items)

    def _track(self, st):
        key = id(st)
        if key in self._refs and self._refs[key]() is st:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=nbytes:
                                      self._free(k, n))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, nbytes: int):
        self._refs.pop(key, None)
        self.live -= nbytes


def _propagating(func) -> bool:
    """Whether ``func`` makes one of the global-shaped stand-ins DTensor's
    sharding propagation builds from a spec (and keeps in its cache)."""
    if func is not torch.ops.aten.empty_strided.default:
        return False
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name == "_rebuild_tensor_from_dtensor_meta":
            return True
        f = f.f_back
    return False


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if type(t) not in _PLAIN else t


def local_bytes(tree) -> int:
    """Bytes of this device's shards of the tensors of ``tree``."""
    return sum(_local(t).nbytes for t in _tensors(tree))


def _storage_ids(tree) -> set:
    return {id(_local(t).untyped_storage()) for t in _tensors(tree)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               kv_seq_shards: int = 1, rules_override: Optional[dict] = None,
               microbatches: Optional[int] = None, impl: str = "auto"):
    """Returns (lowered, meta) for one cell, or (None, a skip record).
    ``lowered`` holds the step as a closure over its DTensor arguments,
    the mesh and rules it runs under, and the per-device argument bytes.
    Needs the fake world of the cell's mesh."""
    if impl not in PLAIN_IMPLS:
        raise ValueError(f"the dry run runs on meta, where no CUDA kernel "
                         f"runs: --impl must be one of {PLAIN_IMPLS}, not "
                         f"{impl!r}")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return None, {"arch": arch, "shape": shape_name,
                      "mesh": _mesh_name(multi_pod),
                      "status": "skip",
                      "reason": "full attention at 512K context is quadratic "
                                "(noted in DESIGN.md §Shape applicability)"}
    model = Model(cfg, device="meta", generator=torch.Generator())
    mesh = make_production_mesh(multi_pod=multi_pod)
    specs = model.input_specs(shape)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": _mesh_name(multi_pod), "status": "ok",
            "kind": shape.kind}

    if shape.kind == "train":
        rules = dict(TRAIN_RULES)
        rules.update(rules_override or {})
        dp = (2 * 16) if multi_pod else 16
        mb = microbatches or default_microbatches(cfg, shape, dp_size=dp)
        meta["microbatches"] = mb
        state = abstract_train_state(model)
        st_shard = tree_shardings(train_state_axes(model), state, mesh, rules)
        b_shard = tree_shardings(batch_axes(specs["batch"]), specs["batch"],
                                 mesh, rules)
        live = distribute(state, st_shard)
        batch = distribute(specs["batch"], b_shard)
        arg_bytes = local_bytes((live, batch))
        _shard_model(model, live["params"], requires_grad=True)
        # the step runs on the model's parameters; it counts in Python
        live.update(step=0, params=dict(model.named_parameters()))
        live["opt"]["count"] = 0
        def run(meter):
            step = make_train_step(model, microbatches=mb, impl=impl,
                                   scan=meter.scan)
            _, metrics = step(live, batch)
            return (live["params"], live["opt"]), metrics
        args = (live["params"], live["opt"], batch)
    else:
        rules = dict(SERVE_RULES)
        rules.update(rules_override or {})
        params = model.abstract_params()
        p_shard = tree_shardings(model.param_axes(), params, mesh, rules)
        _shard_model(model, distribute(params, p_shard), requires_grad=False)
        if shape.kind == "prefill":
            b_shard = tree_shardings(batch_axes(specs["batch"]),
                                     specs["batch"], mesh, rules)
            batch = distribute(specs["batch"], b_shard)

            def run(meter):
                logits, cache = model.prefill(
                    batch["tokens"], max_seq=shape.seq_len,
                    frames=batch.get("frames"), impl=impl)
                # the reference's out_shardings: the cache in its layout
                axes = tfm.cache_axes(cache)
                return logits, _map(lambda t, ax: constrain(t, *ax), cache,
                                    axes)
            args = (dict(model.named_parameters()), batch)
        else:  # decode
            cache_spec = specs["cache"]
            c_shard = tree_shardings(tfm.cache_axes(cache_spec), cache_spec,
                                     mesh, rules)
            tok = NamedSharding(mesh, spec_for(["batch"], mesh, rules,
                                               dims=specs["tokens"].shape))
            cache = distribute(cache_spec, c_shard)
            tokens, lengths = (distribute(specs[k], tok)
                               for k in ("tokens", "lengths"))

            def run(meter):
                return model.decode_step(cache, tokens, lengths, impl=impl,
                                         kv_seq_shards=kv_seq_shards)
            args = (dict(model.named_parameters()), cache, tokens, lengths)
        meta["kv_seq_shards"] = kv_seq_shards
        arg_bytes = local_bytes(args)
    lowered = {"run": run, "args": args, "mesh": mesh, "rules": rules,
               "argument_bytes": arg_bytes}
    return lowered, meta


def compile_cell(lowered: dict) -> dict:
    """Runs the step once on meta under ``StepMeter``; the per-device
    bytes (argument, output, temp, alias) and the meter."""
    meter = StepMeter()
    args = _storage_ids(lowered["args"])
    with use_mesh(lowered["mesh"], lowered["rules"]), meter:
        out = lowered["run"](meter)
    outs = {id(_local(t).untyped_storage()): _local(t).untyped_storage().nbytes()
            for t in _tensors(out)}
    output = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in args)
    # the step's own live storages at the peak, beyond the outputs it made
    made = sum(n for k, n in outs.items() if k not in args)
    return {"meter": meter,
            "bytes_per_device": {"argument": lowered["argument_bytes"],
                                 "output": output,
                                 "temp": max(meter.peak - made, 0),
                                 "alias": alias}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             kv_seq_shards: int = 1, rules_override: Optional[dict] = None,
             microbatches: Optional[int] = None, impl: str = "auto",
             want_roofline: bool = True) -> Dict[str, Any]:
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            lowered, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                       kv_seq_shards=kv_seq_shards,
                                       rules_override=rules_override,
                                       microbatches=microbatches, impl=impl)
            if lowered is None:
                return meta
            t1 = time.time()
            compiled = compile_cell(lowered)
            t2 = time.time()
        rec = dict(meta)
        rec.update({"lower_s": round(t1 - t0, 2),
                    "compile_s": round(t2 - t1, 2),
                    "bytes_per_device": compiled["bytes_per_device"]})
        b = rec["bytes_per_device"]
        rec["peak_bytes_per_device"] = (b["argument"] + b["output"]
                                        + b["temp"] - b["alias"])
        if want_roofline:
            m = compiled["meter"]
            roof = rl.Roofline(flops=m.flops, hbm_bytes=m.hbm_bytes,
                               coll_bytes=sum(m.coll.values()),
                               coll_by_kind=dict(m.coll))
            rec["roofline"] = roof.as_dict()
            mf = rl.model_flops(get_config(arch), SHAPES[shape_name])
            n_chips = 512 if multi_pod else 256
            rec["model_flops_total"] = mf
            total = roof.flops * n_chips
            rec["useful_flops_ratio"] = (mf / total) if total else 0.0
        return rec
    except Exception as e:  # noqa: BLE001 — dry-run reports failures as data
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod),
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
                "wall_s": round(time.time() - t0, 2)}


def status_line(rec: Dict[str, Any]) -> str:
    status, mesh_name = rec["status"], rec["mesh"]
    head = f"[{status}] {rec['arch']} x {rec['shape']} ({mesh_name}): "
    if status != "ok":
        return head + str(rec.get("reason", rec.get("error", "")))
    r = rec.get("roofline", {})
    return (head + f"peak={rec['peak_bytes_per_device']/2**30:.2f}GiB/dev "
            f"compute={r.get('compute_s', 0):.4g}s "
            f"memory={r.get('memory_s', 0):.4g}s "
            f"collective={r.get('collective_s', 0):.4g}s "
            f"dominant={r.get('dominant', '?')} "
            f"(compile {rec['compile_s']}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kv-seq-shards", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_skip = n_err = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, multi_pod=mp,
                       kv_seq_shards=args.kv_seq_shards,
                       microbatches=args.microbatches, impl=args.impl,
                       want_roofline=not args.no_roofline)
        status = rec["status"]
        n_ok += status == "ok"
        n_skip += status == "skip"
        n_err += status == "error"
        print(status_line(rec), flush=True)
        if out_f:
            slim = {k: v for k, v in rec.items() if k != "traceback"}
            out_f.write(json.dumps(slim) + "\n")
            out_f.flush()
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"/ {len(cells)} cells")
    if out_f:
        out_f.close()
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
