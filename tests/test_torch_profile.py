"""The port's profile-then-fit half of Dooly's loop — ``core.{signature,
profiler,plan}``, ``core.backends.h100_analytical``, ``parallel.roofline``
and ``api.store`` — against the JAX package's, at smoke sizes on the CPU.

The port profiles with ``h100_analytical`` (a roofline counted on meta
tensors) where the reference's tests use ``tpu_analytical``: both are
deterministic, so rows and fits compare bit for bit.  Signature component 2
(the kernel fingerprint) differs by design; components 1 (but for
``n_ops``, which counts aten ops, not jaxpr equations) and 3 are held equal.
The plan's stateful and linear tasks are held to the reference plan's.
"""
import json
import pickle

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.database import LatencyDB as JaxLatencyDB
from repro.core.latency_model import LatencyModel as JaxLatencyModel
from repro.core.opset import ModuleEntry as JaxModuleEntry
from repro.core.opset import find_runnable_set as jax_find_runnable_set
from repro.core.plan import build_plan as jax_build_plan
from repro.core.profiler import QUICK_SWEEP as JAX_QUICK_SWEEP
from repro.core.profiler import window_for_path as jax_window_for_path
from repro.core.runner import trace_model as jax_trace_model
from repro.core.signature import module_entry_signature as jax_module_signature
from repro.parallel import roofline as jax_roofline
from repro.serving.context import cached_build_context as jax_context
from repro_torch.api import ProfileStore, RooflineBackend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import backends as oracles
from repro_torch.core.database import LatencyDB
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.opset import (ModuleEntry, OpEntry, detach_op_entry,
                                    find_runnable_set)
from repro_torch.core.plan import build_plan, execute_plan, read_journal
from repro_torch.core.profiler import QUICK_SWEEP, DoolyProf
from repro_torch.core.runner import trace_model
from repro_torch.core import signature as signature_mod
from repro_torch.core.signature import (fingerprint, module_entry_signature,
                                        op_entry_signature)
from repro_torch.parallel import roofline
from repro_torch.serving import SchedulerConfig, TensorSpec
from repro_torch.serving.context import build_context

torch.set_num_threads(2)

ARCHS = ["llama3-8b", "command-r7b", "yi-9b", "starcoder2-15b", "granite-20b",
         "falcon-mamba-7b", "minicpm3-4b", "olmoe-1b-7b", "hymba-1.5b"]
MODELS = ("llama3-8b", "command-r7b")
HW, ORACLE, BACKEND = "cpu", "h100_analytical", "kernel"
MEAS_Q = ("SELECT * FROM measurements ORDER BY sig_hash, hardware, phase, "
          "num_toks, num_reqs, ctx_len, oracle")
SIGS_Q = "SELECT * FROM signatures ORDER BY hash"
OPS_Q = "SELECT * FROM model_operations ORDER BY config_id, sig_hash, module"


def _tables(db):
    return {q: db.conn.execute(q).fetchall() for q in (MEAS_Q, SIGS_Q, OPS_Q)}


@pytest.fixture(scope="module")
def corpus():
    return [get_smoke_config(m) for m in MODELS]


@pytest.fixture(scope="module")
def traces(corpus):
    return {cfg.name: trace_model(cfg) for cfg in corpus}


def _plan(db, corpus, traces, **kw):
    return build_plan(db, corpus, backends=(BACKEND,), hardware=HW,
                      oracle=ORACLE, sweep=QUICK_SWEEP, traces=traces,
                      device="cpu", **kw)


@pytest.fixture(scope="module")
def executed(corpus, traces):
    """(plan, coverage, report, tables) of the corpus plan executed on a
    fresh DB."""
    with LatencyDB() as db:
        plan = _plan(db, corpus, traces)
        cov = plan.coverage()
        rep = execute_plan(db, plan)
        return plan, cov, rep, _tables(db)


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_stateful_signature_components_match_the_reference(arch):
    """Op name, component 1's boundary and component 3 of every stateful
    entry equal the reference's; ``n_ops`` counts the module's aten ops."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    port = [e for e in find_runnable_set(trace_model(cfg).trace, device="cpu")
            if isinstance(e, ModuleEntry) and e.context_kind]
    ref = [e for e in jax_find_runnable_set(jax_trace_model(jcfg).trace)
           if isinstance(e, JaxModuleEntry) and e.context_kind]
    assert [e.module for e in port] == [e.module for e in ref] and port
    for pe, je in zip(port, ref):
        window = jax_window_for_path(jcfg, je.node.path)
        ps = module_entry_signature(pe, build_context(
            cfg, pe.context_kind, phase="prefill", backend=BACKEND,
            window=window, device="cpu"))
        js = jax_module_signature(je, jax_context(
            jcfg, je.context_kind, phase="prefill", backend="xla",
            window=window))
        assert ps.op_name == js.op_name
        assert ps.attrs == js.attrs                                # component 3
        pspec, jspec = (json.loads(s.spec) for s in (ps, js))
        assert pspec["boundary"] == jspec["boundary"]              # component 1
        assert pspec["n_ops"] == len(pe.ops)
        assert ps.fingerprint.startswith("aten.")                  # component 2


def test_module_fingerprint_covers_both_phases():
    """The decode context's aten ops join the prefill context's."""
    cfg = get_smoke_config("llama3-8b")
    entry = next(e for e in find_runnable_set(trace_model(cfg).trace, device="cpu")
                 if isinstance(e, ModuleEntry) and e.context_kind)
    pre, dec = (build_context(cfg, "self_attn", phase=ph, backend=BACKEND,
                              device="cpu") for ph in ("prefill", "decode"))
    alone = set(module_entry_signature(entry, pre).fingerprint.split(","))
    both = set(module_entry_signature(entry, pre, dec).fingerprint.split(","))
    assert alone < both


def test_fingerprint_fallbacks_are_counted(monkeypatch):
    cfg = get_smoke_config("llama3-8b")
    entry = next(e for e in find_runnable_set(trace_model(cfg).trace, device="cpu")
                 if isinstance(e, OpEntry) and e.kind == "mm")
    before = fingerprint.fallbacks
    assert op_entry_signature(entry, "cpu").fingerprint == "aten.mm.default"
    assert fingerprint.fallbacks == before

    def cannot_run(**kw):
        raise RuntimeError("the probe cannot run")
    monkeypatch.setattr(entry, "callable", cannot_run)
    sig = op_entry_signature(entry, "cpu")
    assert sig.fingerprint == f"prim:{entry.op.prim}"
    assert fingerprint.fallbacks == before + 1


S, K = "spin_kernel", "gemm"
FULL = [S, S, S, K, S, K, S, K, S]         # three calls, each closed by S


@pytest.mark.parametrize("sessions,expected,taken", [
    # every call's kernel lost in a session that kept its outer sentinels
    ([[S, S, S, S, S, S], FULL, [K, S, K, S, K, S], FULL], {K}, 4),
    # the three leading sentinels and every call's kernel lost
    ([[S], FULL, FULL], {K}, 3),
    # each session lost the kernels of two of its three calls
    ([[S, S, S, S, S, K, S], [S, S, K, S, S, S]], {K}, 2),
    # a view launches nothing: two empty sessions agree
    ([[S] * 6, [S] * 6], set(), 2),
    # in eight sessions no two that count agree; a ninth is not taken
    ([FULL, [S] * 6] + [[K, S]] * 6 + [FULL], RuntimeError, 8),
])
def test_cuda_fingerprint_needs_two_sessions_that_agree(monkeypatch, sessions,
                                                        expected, taken):
    """A profiler session on the card can lose activities between its
    sentinels; a session's set is the union over its three calls, and a
    set is kept only once two sessions give it."""
    from torch.profiler import DeviceType
    script = iter(sessions)

    class Event:
        def __init__(self, name, start):
            self.name, self.device_type = name, DeviceType.CUDA
            self.time_range = type("Range", (), {"start": start})()

    class Session:
        def __init__(self, activities):
            self.names = next(script)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [Event(n, t) for t, n in enumerate(self.names)]

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    if expected is RuntimeError:
        with pytest.raises(RuntimeError, match="agreed"):
            signature_mod._cuda_kernels(lambda: calls.append(1), ())
    else:
        assert signature_mod._cuda_kernels(lambda: calls.append(1), ()) == expected
    assert len(sessions) - sum(1 for _ in script) == taken
    assert len(calls) == 1 + 3 * taken         # a first call, three a session


def test_detached_op_entry_pickles_and_runs_alike():
    cfg = get_smoke_config("llama3-8b")
    ops = [e for e in find_runnable_set(trace_model(cfg).trace, device="cpu")
           if isinstance(e, OpEntry)]
    with pytest.raises(Exception):
        pickle.dumps(ops[0])          # the live aten overload does not pickle
    for entry in ops:
        back = pickle.loads(pickle.dumps(detach_op_entry(entry)))
        assert back.op.func is None and back.bind == entry.op.prim
        want = entry.run(toks=8, reqs=2, device="cpu") if entry.sweepable \
            else entry.run(device="cpu")
        got = back.run(toks=8, reqs=2, device="cpu") if back.sweepable \
            else back.run(device="cpu")
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# oracles and the roofline constants
# ---------------------------------------------------------------------------

def test_h100_analytical_is_a_roofline():
    bf16 = torch.bfloat16
    a, b = TensorSpec((1024, 4096), bf16), TensorSpec((4096, 4096), bf16)
    flops = 2 * 1024 * 4096 * 4096
    nbytes = 2 * (1024 * 4096 + 4096 * 4096 + 1024 * 4096)
    got = oracles.h100_analytical(torch.matmul, (a, b))
    assert got == max(flops / 989e12, nbytes / 3.35e12) == flops / 989e12
    # tensors count as their shapes do, and measure() dispatches by name
    x, y = torch.ones(256, 64, dtype=bf16), torch.ones(64, 4096, dtype=bf16)
    want = 2 * (256 * 64 + 64 * 4096 + 256 * 4096) / 3.35e12
    assert oracles.measure(ORACLE, torch.matmul, (x, y)) == want
    assert oracles.h100_analytical(torch.matmul, (TensorSpec(x.shape, bf16),
                                                  TensorSpec(y.shape, bf16))) == want
    # fp32 runs on the CUDA cores' 67 TFLOP/s
    big = TensorSpec((2048, 2048), torch.float32)
    assert oracles.h100_analytical(torch.matmul, (big, big)) == \
        2 * 2048 ** 3 / 67e12
    with pytest.raises(KeyError, match="unknown oracle"):
        oracles.measure("tpu_analytical", torch.matmul, (x, y))


def test_h100_analytical_counts_attention_through_the_plain_path():
    """A module context on the meta device: the projections' FLOPs and the
    attention's, from the plain path, never 0."""
    cfg = get_smoke_config("llama3-8b")
    with LatencyDB() as db:
        prof = DoolyProf(db, oracle=ORACLE, hardware=HW, device="cpu")
        for phase, (toks, reqs, ctx) in (("prefill", (64, 2, 128)),
                                         ("decode", (1, 2, 128))):
            mc = build_context(cfg, "self_attn", phase=phase, backend=BACKEND,
                               device="cpu")
            s = prof._measure_module(mc, toks, reqs, ctx)
            proj = 2 * toks * reqs * cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
                * cfg.resolved_head_dim
            assert s > proj / 67e12       # the attention's FLOPs come on top


def test_roofline_constants_are_the_h100s():
    assert roofline.hardware_tag("NVIDIA H100 80GB HBM3") == roofline.H100
    p = roofline.peaks(roofline.H100)
    assert (p.peak_flops(torch.bfloat16), p.peak_flops(torch.float32),
            p.hbm_bw) == (989e12, 67e12, 3.35e12)
    with pytest.raises(KeyError, match="tpu-v5e"):
        roofline.peaks("tpu-v5e")
    cfg = get_config("llama3-8b")
    for kind, seq, batch in (("train", 4096, 8), ("prefill", 1024, 4),
                             ("decode", 1, 64)):
        shape = ShapeSpec(kind, seq, batch, kind)
        assert roofline.model_flops(cfg, shape) == \
            jax_roofline.model_flops(cfg, shape)


def test_roofline_backend_refuses_tensor_parallelism():
    cfg = get_config("llama3-8b")
    sched = SchedulerConfig(8, 512, 256)
    be = RooflineBackend(cfg, sched_config=sched, max_seq=2048)
    # a decode step of 8 rows reads every weight once: bytes bound
    assert be.predict_points([("decode", 1, 8, 2048)])[0] > \
        cfg.active_param_count() * 2 / 3.35e12
    # tp > 1 was refused until the NVLink figure came; it now prices the
    # activations' ring all-reduce per layer on it
    tp2 = RooflineBackend(cfg, sched_config=sched, max_seq=2048, tp=2)
    toks = 256
    coll = cfg.n_layers * toks * cfg.d_model * 2 * 1.0 / 450e9
    assert tp2.predict_points([("prefill", toks, 1, 2048)])[0] >= coll
    assert tp2.predict_points([("decode", 1, 8, 2048)])[0] < \
        be.predict_points([("decode", 1, 8, 2048)])[0]


def test_profiler_defaults_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults are valid here")
    with LatencyDB() as db:
        with pytest.raises(RuntimeError, match="hardware="):
            DoolyProf(db)
    with pytest.raises(RuntimeError, match="hardware="):
        ProfileStore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProfileStore(hardware=HW)


# ---------------------------------------------------------------------------
# Queue 3 item 3: decode lengths under cuda_events
# ---------------------------------------------------------------------------

def test_cuda_events_decode_points_run_full_caches(monkeypatch):
    """Under cuda_events the port's decode points run every row's length at
    ctx - 1; the reference materializes lengths of 0 (and so does the port
    under the other oracles), which the split-KV kernel reads as one key."""
    cfg = get_smoke_config("llama3-8b")
    seen = {}

    def recorder(name):
        def oracle(fn, args):
            seen[name] = args[-1].clone()
            return 1e-6
        return oracle
    for name in ("cuda_events", "cpu_wallclock"):
        monkeypatch.setitem(oracles.ORACLES, name, recorder(name))
    mc = build_context(cfg, "self_attn", phase="decode", backend=BACKEND,
                       device="cpu")
    with LatencyDB() as db:
        for name in ("cuda_events", "cpu_wallclock"):
            DoolyProf(db, oracle=name, hardware=HW, device="cpu"
                      )._measure_module(mc, 1, 3, 48)
    assert seen["cuda_events"].tolist() == [47] * 3
    assert seen["cpu_wallclock"].tolist() == [0] * 3
    jmc = jax_context(jax_smoke_config("llama3-8b"), "self_attn",
                      phase="decode", backend="xla")
    lengths = jmc.materialize(jmc.abstract_inputs(1, 3, 48))[-1]
    assert np.asarray(lengths).tolist() == [0] * 3


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------

def test_fits_are_bit_identical_to_the_reference(tmp_path, corpus, traces):
    path = str(tmp_path / "latency.sqlite")
    with LatencyDB(path) as db:
        DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                  device="cpu").profile_model(corpus[0], backend=BACKEND,
                                              trace=traces[corpus[0].name])
    points = [(8, 1, 0), (64, 2, 128), (256, 1, 512), (1, 2, 512)]
    with LatencyDB(path) as pdb, JaxLatencyDB(path) as jdb:
        sigs = sorted(pdb.measured_hashes(HW))
        assert sigs == sorted(jdb.measured_hashes(HW)) and sigs
        plm = LatencyModel(pdb, HW, use_saved_fits=False)
        jlm = JaxLatencyModel(jdb, HW, use_saved_fits=False)
        for phase in ("prefill", "decode"):
            for sig in sigs:
                pf, jf = plm._fit(sig, phase), jlm._fit(sig, phase)
                assert (pf.coef is None) == (jf.coef is None)
                if pf.coef is not None:
                    assert pf.coef.tobytes() == jf.coef.tobytes()
                    assert pf.floor == jf.floor
            assert np.array_equal(plm.predict_batch_points(sigs, phase, points),
                                  jlm.predict_batch_points(sigs, phase, points))


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def _structure(plan, module_kind, linear):
    """Per model, (name, variant, reused) of the stateful and linear
    entries, and the stateful and linear tasks as (owner models, points)."""
    def model(owner):
        return owner.split("/")[0]
    entries = [(key[0], [(e.group, e.variant, e.reused) for e in ents
                         if e.group != "other"])
               for key, ents in plan.entries]
    tasks = [(t.kind, tuple(model(o) for o in t.owners), t.n_points)
             for t in plan.tasks
             if t.kind == module_kind or t.payload[2].kind in linear]
    return entries, tasks


def test_plan_dedups_like_the_reference(executed):
    plan, cov, _, _ = executed
    with JaxLatencyDB() as jdb:
        ref = jax_build_plan(jdb, [jax_smoke_config(m) for m in MODELS],
                             backends=("xla",), hardware="tpu-v5e",
                             oracle="tpu_analytical", sweep=JAX_QUICK_SWEEP)
    assert _structure(plan, "module", ("mm", "addmm", "bmm")) == \
        _structure(ref, "module", ("dot_general",))
    jcov = ref.coverage()
    assert (cov.shared_tasks, cov.satisfied_tasks) == (jcov.shared_tasks,
                                                       jcov.satisfied_tasks)
    # the shared GQA task: one signature, both models, measured once
    shared = [t for t in plan.tasks if t.kind == "module" and len(t.owners) == 2]
    assert len(shared) == 1 and cov.dedup_frac > 0.3


def test_plan_over_every_ported_config_dedups_like_the_reference():
    """The plan over the nine ported smoke configs (the dense family, the
    Mamba, MLA, MoE and hybrid blocks): per model its stateful and linear
    entries, and the stateful and linear tasks with their owners and
    points, as the reference plan's."""
    with LatencyDB() as db:
        plan = build_plan(db, [get_smoke_config(a) for a in ARCHS],
                          backends=(BACKEND,), hardware=HW, oracle=ORACLE,
                          sweep=QUICK_SWEEP, device="cpu")
    with JaxLatencyDB() as jdb:
        ref = jax_build_plan(jdb, [jax_smoke_config(a) for a in ARCHS],
                             backends=("xla",), hardware="tpu-v5e",
                             oracle="tpu_analytical", sweep=JAX_QUICK_SWEEP)
    assert _structure(plan, "module", ("mm", "addmm", "bmm")) == \
        _structure(ref, "module", ("dot_general",))
    kinds = {e.name for _, ents in plan.entries for e in ents}
    assert {"self_attn", "mla_attn", "mamba", "moe"} <= kinds


def test_plan_build_is_a_deterministic_dry_run(corpus, traces, executed):
    with LatencyDB() as db:
        p1 = _plan(db, corpus, traces)
        assert db.stats()["measurements"] == db.stats()["signatures"] == 0
        p2 = _plan(db, corpus, traces)
    assert p1.plan_id == p2.plan_id == executed[0].plan_id
    assert [t.task_id for t in p1.tasks] == [t.task_id for t in p2.tasks]
    assert p1.device == "cpu"


def test_dry_run_points_match_realized_writes(executed, corpus, traces):
    plan, cov, rep, tables = executed
    assert cov.plan_points == rep.rows_written == len(tables[MEAS_Q]) > 0
    with LatencyDB() as db:
        DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                  device="cpu").profile_model(corpus[0], backend=BACKEND,
                                              trace=traces[corpus[0].name])
        assert cov.models[0].points == db.stats()["measurements"]


def test_parallel_execute_is_bit_identical_to_sequential(executed, corpus,
                                                         traces):
    _, _, _, tables = executed
    with LatencyDB() as db:
        prof = DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                         device="cpu")
        for cfg in corpus:
            prof.profile_model(cfg, backend=BACKEND, trace=traces[cfg.name])
        assert _tables(db) == tables
    with LatencyDB() as db:
        rep = execute_plan(db, _plan(db, corpus, traces), workers=2)
        assert rep.workers == 2 and rep.quarantined == 0
        assert _tables(db) == tables


def test_profile_model_workers_ship_detached_tasks(corpus, traces, executed):
    """``profile_model(workers=2)``: the parent traces and signs once, two
    spawn workers measure detached tasks, and the rows equal a serial
    sweep's."""
    cfg = corpus[0]
    tables = []
    for workers in (1, 2):
        with LatencyDB() as db:
            rep = DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                            device="cpu").profile_model(
                cfg, backend=BACKEND, trace=traces[cfg.name], workers=workers)
            tables.append((_tables(db), [(e.sig, e.reused, e.cost_s)
                                         for e in rep.entries]))
    assert tables[0] == tables[1] and tables[0][0][MEAS_Q]


def test_execute_resumes_after_an_interrupt(corpus, traces, tmp_path, executed):
    _, _, _, clean = executed
    ckpt = str(tmp_path / "journal")
    crash_after = 4

    class Boom(RuntimeError):
        pass

    def crashing_progress(task, i, n):
        if i >= crash_after:
            raise Boom
    with LatencyDB() as db:
        plan = _plan(db, corpus, traces)
        n_todo = len(plan.todo)
        with pytest.raises(Boom):
            execute_plan(db, plan, checkpoint=ckpt, progress=crashing_progress)
        assert len(read_journal(ckpt, plan)) == crash_after
        rows = db.stats()["measurements"]
        rep = execute_plan(db, plan, checkpoint=ckpt)
        assert (rep.skipped_journal, rep.measured) == (crash_after,
                                                       n_todo - crash_after)
        # nothing was measured twice: the resume wrote only the rest
        assert rows + rep.rows_written == len(clean[MEAS_Q])
        assert _tables(db) == clean


def test_store_shards_and_merges_to_the_same_rows(executed, corpus, traces,
                                                  tmp_path):
    plan, _, _, clean = executed
    with ProfileStore(hardware=HW, oracle=ORACLE, sweep=QUICK_SWEEP,
                      device="cpu") as store:
        shards = store.shard(plan, 2)
        assert len(shards) == 2 and all(s.device == "cpu" for s in shards)
        paths = []
        for i, shard in enumerate(shards):
            paths.append(str(tmp_path / f"shard{i}.sqlite"))
            with LatencyDB(paths[-1]) as sdb:
                execute_plan(sdb, shard)
        rep = store.merge(plan, dbs=paths)
        assert rep.points_merged == rep.points_planned
        assert _tables(store.db) == clean


def test_ensure_profiled_matches_profile_model(corpus, traces):
    cfg = corpus[0]
    with LatencyDB() as db:
        legacy = DoolyProf(db, oracle=ORACLE, hardware=HW, sweep=QUICK_SWEEP,
                           device="cpu").profile_model(
            cfg, backend=BACKEND, trace=traces[cfg.name])
    with ProfileStore(hardware=HW, oracle=ORACLE, sweep=QUICK_SWEEP,
                      device="cpu") as store:
        rep = store.ensure_profiled(cfg, backend=BACKEND)
        assert store.ensure_profiled(cfg, backend=BACKEND) is None
        fields = ("sig", "name", "group", "variant", "count", "reused", "cost_s")
        assert [tuple(getattr(e, f) for f in fields) for e in rep.entries] == \
            [tuple(getattr(e, f) for f in fields) for e in legacy.entries]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_cuda_events_profiles_an_op_and_self_attn():
    """One op entry and the self_attn entry profiled by cuda_events on the
    card: positive latencies, and the self_attn fingerprint names the
    port's decode kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = get_smoke_config("llama3-8b")
    entries = find_runnable_set(trace_model(cfg).trace, device="cuda")
    op = next(e for e in entries if isinstance(e, OpEntry) and e.kind == "mm")
    attn = next(e for e in entries if isinstance(e, ModuleEntry)
                and e.context_kind == "self_attn")
    before = fingerprint.fallbacks
    with LatencyDB() as db:
        prof = DoolyProf(db, hardware=roofline.default_hardware(),
                         sweep=QUICK_SWEEP)
        rep = prof.profile_model(cfg, backend=BACKEND, entries=[op, attn])
        assert fingerprint.fallbacks == before
        assert [e.name for e in rep.entries] == ["mm", "self_attn"]
        lat = db.conn.execute("SELECT latency_us FROM measurements").fetchall()
        assert len(lat) == len(QUICK_SWEEP.op_points) + sum(
            len(prof._phase_points(ph)) for ph in ("prefill", "decode"))
        assert all(0 < x < 1e5 for (x,) in lat)
        fp = db.signature(rep.entries[1].sig)[2]
    kernels = fp.split(",")
    assert any("repro_torch" in k and "decode" in k for k in kernels), kernels
