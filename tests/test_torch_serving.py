"""The port's serving engine, execution contexts, oracles and chip smoke
script against the JAX package's, on the same parameters and requests
(``llama3-smoke``, float32, CPU).

Every request arrives at t=0, so the schedule does not depend on measured
latency and both engines must produce the same ``IterationRecord``
schedule.  The JAX side runs ``impl="xla"`` where the kernel is not the
point.  Cache tolerance: 1e-4 of the cache's largest entry (see
tests/test_torch_models.py).
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import scheduler as jax_scheduler
from repro.serving.context import build_context as jax_build_context
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import bucket_chunk as jax_bucket_chunk
from repro_torch.configs import get_smoke_config
from repro_torch.core.backends import cpu_wallclock, cuda_events
from repro_torch.core.profiler import SweepConfig
from repro_torch.models import params_from_jax
from repro_torch.serving import (Engine, SchedulerConfig,
                                 build_context, bucket_chunk)
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SCHED = dict(max_num_seqs=4, max_batch_tokens=64, chunk_size=32)


@pytest.fixture(scope="module")
def params():
    """(cfg, jax cfg, jax params, the port's state dict of them)."""
    cfg, jcfg = get_smoke_config("llama3-8b"), jax_smoke_config("llama3-8b")
    jp = build_model(jcfg).init(jax.random.key(0))
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _requests(module, specs, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [module.Request(i, 0.0, rng.integers(0, vocab, p).tolist(), o)
            for i, (p, o) in enumerate(specs)]


def _close_scaled(port, expected):
    expected = np.asarray(expected)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=TOL)


def _serve_both(params, specs, max_seq, impl="kernel"):
    cfg, jcfg, jp, state = params
    jeng = JaxEngine(jcfg, sched_config=jax_scheduler.SchedulerConfig(**SCHED),
                     max_seq=max_seq, params=jp, impl="xla")
    jeng.run(_requests(jax_scheduler, specs, cfg.vocab_size))
    eng = Engine(cfg, sched_config=SchedulerConfig(**SCHED), max_seq=max_seq,
                 params=state, impl=impl, device="cpu")
    reqs = _requests(port_scheduler, specs, cfg.vocab_size)
    eng.run(reqs)
    return jeng, eng, reqs


# ---------------------------------------------------------------------------
# scheduler and buckets
# ---------------------------------------------------------------------------

def test_scheduler_is_a_verbatim_copy():
    # the sim-vs-engine claim rests on both running the same scheduler
    assert Path(port_scheduler.__file__).read_text() == \
        Path(jax_scheduler.__file__).read_text()


def test_bucket_chunk_matches_reference():
    for chunk_size in (32, 64, 256):
        for c in range(1, 3 * chunk_size):
            assert bucket_chunk(c, chunk_size) == jax_bucket_chunk(c, chunk_size)


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine(params):
    specs = [(40, 5), (9, 3), (57, 2), (23, 6), (31, 1), (64, 4)]
    jeng, eng, reqs = _serve_both(params, specs, max_seq=128)
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert all(r.done and r.generated == o for r, (_, o) in zip(reqs, specs))
    assert all(r.model_s > 0 for r in eng.records)
    for i, layer in enumerate(eng.cache):
        for name in ("k", "v"):
            _close_scaled(layer[name], jeng.cache["blocks"][0][name][i])


def test_engine_bucket_padding_past_max_seq(params):
    """A 36-token prompt in chunks of 32 leaves a 4-token chunk whose bucket
    of 8 reaches past a 40-slot cache: the rows past the end are dropped,
    as the JAX engine drops them."""
    jeng, eng, reqs = _serve_both(params, [(36, 3)], max_seq=40)
    assert reqs[0].done and eng.lengths[0] == 36 + 2
    for i, layer in enumerate(eng.cache):
        _close_scaled(layer["k"], jeng.cache["blocks"][0]["k"][i])


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(get_smoke_config("llama3-8b"),
               sched_config=SchedulerConfig(**SCHED), max_seq=64)


# ---------------------------------------------------------------------------
# self_attn execution contexts against the JAX contexts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["xla", "kernel", "chunked_naive"])
def test_self_attn_context_matches_jax(params, phase, backend):
    cfg, jcfg, jp, state = params
    toks, reqs, ctx = (8, 2, 32) if phase == "prefill" else (1, 3, 48)
    jmc = jax_build_context(jcfg, "self_attn", phase=phase, backend="xla")
    mc = build_context(cfg, "self_attn", phase=phase, backend=backend,
                       device="cpu")
    specs = mc.abstract_inputs(toks, reqs, ctx)
    assert [tuple(s.shape) for s in specs] == \
        [tuple(s.shape) for s in jmc.abstract_inputs(toks, reqs, ctx)]
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(s.shape, dtype=np.float32) for s in specs[:3]]
    lengths = (np.array([0, 17], np.int32) if phase == "prefill"
               else np.array([5, 47, 20], np.int32))
    jattn = jp["blocks"][0]["attn"]
    jparams = jax.tree.map(lambda a: a[0], jattn)
    expected = jmc.fn(jparams, *[jnp.asarray(a) for a in arrays],
                      jnp.asarray(lengths))
    weights = {f"{n}_proj.w": torch.tensor(np.asarray(jattn[n]["w"][0]))
               for n in ("q", "k", "v", "o")}
    assert {k: tuple(v.shape) for k, v in weights.items()} == \
        {k: tuple(s.shape) for k, s in mc.params.items()}
    out = mc.fn(mc.module(weights), *[torch.from_numpy(a) for a in arrays],
                torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=TOL,
                               rtol=TOL)


def test_context_materialize_is_seeded(params):
    cfg = params[0]
    mc = build_context(cfg, "self_attn", phase="decode", device="cpu")
    a = mc.materialize(mc.abstract_inputs(1, 2, 16),
                       torch.Generator().manual_seed(3))
    b = mc.materialize(mc.abstract_inputs(1, 2, 16),
                       torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[3].dtype == torch.int32 and not a[3].any()
    w = mc.materialize(mc.params)
    assert sorted(w) == sorted(mc.params) and float(w["q_proj.w"].std()) < 0.05


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def test_oracles():
    x = torch.ones(64, 64)
    assert cpu_wallclock(torch.matmul, (x, x)) > 0
    with pytest.raises((ValueError, RuntimeError)):
        cuda_events(torch.matmul, (x, x), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_gpu_cuda_events_captures_self_attn_contexts(params, phase):
    """Both contexts run without a host sync, so the oracle captures one
    call in a CUDA graph; the replays write the same cache as one eager
    call (the writes are idempotent for fixed lengths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = params[0]
    mc = build_context(cfg, "self_attn", phase=phase, backend="kernel",
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = mc.module(mc.materialize(mc.params, gen))
    toks, ctx = (24, 40) if phase == "prefill" else (1, 48)
    x, kc, vc, lengths = mc.materialize(mc.abstract_inputs(toks, 2, ctx), gen)
    lengths.copy_(torch.tensor([ctx - toks, 3], dtype=torch.int32))
    eager_k = kc.clone()
    eager = mc.fn(attn, x, eager_k, vc.clone(), lengths)
    seconds = cuda_events(mc.fn, (attn, x, kc, vc, lengths), repeats=5)
    assert 0 < seconds < 1
    torch.testing.assert_close(kc, eager_k)
    torch.testing.assert_close(mc.fn(attn, x, kc, vc, lengths), eager)


@pytest.mark.gpu
def test_gpu_cuda_events_refuses_a_call_with_a_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = torch.ones(8, device="cuda")

    def masked_sum(t):
        return t[t > 0].sum()       # the mask's shape needs the host
    with pytest.raises(RuntimeError, match="masked_sum cannot be captured"):
        cuda_events(masked_sum, (x,))


# ---------------------------------------------------------------------------
# chip_smoke.py: its phases at llama3-smoke on the CPU, and its refusal to
# run without a card
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phases_on_cpu(capsys):
    cs = _chip_smoke()
    cfg, cpu = get_smoke_config("llama3-8b"), torch.device("cpu")
    mcfg, gcfg = get_smoke_config(cs.MAMBA), get_smoke_config(cs.GRANITE)
    kernels = cs.phase_kernels(cfg, cpu, gcfg)
    kernels.update(cs.phase_scan(mcfg, cpu))
    serving = cs.phase_serving(cfg, cpu)
    prefill = cs.phase_prefill(cfg, cpu)
    train = cs.phase_train(cfg, cpu, seq=32)
    measured = cs.phase_measure(cfg, cpu)
    mamba_serving = cs.phase_mamba_serving(mcfg, cpu)
    mamba_prefill = cs.phase_mamba_prefill(mcfg, cpu)
    mamba_measured = cs.phase_mamba_measure(mcfg, cpu)
    granite = cs.phase_granite_serving(gcfg, cpu)
    traced = cs.phase_tracer([(cfg, cfg), (gcfg, gcfg)], cpu)
    loop = cs.phase_profile_simulate(
        [cfg, get_smoke_config("command-r7b")], cpu, oracle="h100_analytical",
        hardware="cpu", sweep=SweepConfig(toks=(8, 16, 32), reqs=(1, 4),
                                          ctx=(64, 256),
                                          op_points=((8, 1), (16, 1), (32, 1),
                                                     (1, 4)), repeats=20),
        sched=SchedulerConfig(**SCHED), max_seq=256,
        calibration=dict(n=4, rate=1.0, prompt_len=64, out_len=8, seed=9),
        score=dict(n=12, rate=4.0, seed=4, scale=0.05), shared_variant="4/2/32")
    line = cs.kernels_line(kernels, serving, granite, prefill, train,
                           mamba_serving, mamba_prefill, loop)
    assert [k["name"] for k in line["kernels"]] == [
        "decode_attention", "flash_attention_fwd", "flash_attention_bwd",
        "mamba_scan"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed"}
    for k in line["kernels"]:
        assert set(k) == keys and k["launches"] == 0 and k["max_abs_err"] == 0
        assert k["device_ms"] is None           # no profiler time off the card
        assert all(set(r) == keys & {"ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms"}
                   for r in k["timed"].values())
        assert (ROOT / k["source"]).is_file()
        path, line_no = k["replaces"].split(":")
        assert "pallas_call" in "".join(
            (ROOT / path).read_text().splitlines()[int(line_no) - 1:int(line_no) + 40])
    assert serving["decode_iterations"] > 0 and len(serving["ttft_s"]) == 2
    assert all(len(t) == 8 for t in serving["ttft_s"] + serving["tpot_s"])
    assert len(serving["makespans_s"]) == 2 and serving["idle"] is None
    assert len(mamba_serving["makespans_s"]) == 2
    assert granite["decode_iterations"] > 0 and len(granite["point_s"]) == 2
    assert granite["min_cosine"] > 0.999
    assert sorted(traced) == ["granite-smoke", "llama3-smoke"]
    # up, gate and down projections and the head; gelu has no gate
    assert [traced[n]["linear"] for n in ("llama3-smoke", "granite-smoke")] == [4, 3]
    assert all(t["modules"] == [("self_attn", 3, "layers.0/self_attn")]
               for t in traced.values())
    assert len(train["losses"]) == cs.TRAIN_STEPS and train["min_cosine"] > 0.999
    assert set(measured) == {("decode", 1, r, c) for r, c in cs.MEASURE_POINTS} \
        | {("prefill",) + cs.PREFILL_POINT}
    assert all(len(v) == 2 and min(v) > 0 for v in measured.values())
    scan = line["kernels"][-1]
    assert scan["library_ms"] is None and scan["bound_by"] in (
        "bytes", "operations", "exp")
    assert sorted(scan["timed"]) == ["decode B=8 S=1", "prefill B=1 S=1024",
                                     "prefill B=1 S=256"]
    assert sorted(line["kernels"][0]["timed"]) == [
        "B=1 full ctx 2048", "B=8 random lengths",
        "granite-smoke B=8 G=4 random lengths"]
    assert mamba_serving["chunks"] > 0 and mamba_serving["min_cosine"] > 0.999
    assert min(mamba_prefill[k] for k in (
        "cosine", "h_cosine", "layer_cosine", "layer_h_cosine", "fp32_cosine",
        "fp32_h_cosine")) > 0.999
    assert set(mamba_measured) == {("prefill", t, r) for t, r in cs.MAMBA_PREFILL_POINTS} \
        | {("decode", 1, r) for r in cs.MAMBA_DECODE_REQS}
    assert all(len(v) == 2 and min(v) > 0 for v in mamba_measured.values())
    out = capsys.readouterr().out
    assert "[4 serving]" in out and "[5b train]" in out and "8 of 3 layers" in out
    assert "[3b kernels] mamba_scan" in out and "[8 mamba prefill]" in out
    assert "[10 granite serving]" in out and "makespans" in out
    assert "[11 tracer]" in out
    # phase 12: the plan dedups the shared self_attn task, every planned point
    # lands, and the sim is scored against the engine
    cov = loop["coverage"]
    assert cov["shared_tasks"] > 0 and cov["plan_points"] == loop["rows"] > 0
    assert all(np.isfinite(v) for v in loop["sim"].values())
    assert loop["sim"]["makespan_mape"] <= cs.MAKESPAN_MAPE_LIMIT
    assert len(loop["engine_makespans_s"]) == 2 and loop["decode_launches"] == 0
    assert loop["spent_s"][0] > 0 and loop["saved_s"][1] > 0
    assert "[12 profile->simulate]" in out and "dedup:" in out
    assert "engine self-noise" in out and "DoolySim vs the engine" in out


def test_chip_smoke_train_counts_remat_launches(monkeypatch):
    """The train phase's count check, with the plain versions counted as the
    kernels would be: remat runs every layer's flash forward twice."""
    cs = _chip_smoke()
    counted = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention_fwd_plain", "fwd"),
                      ("flash_attention_bwd_plain", "bwd")):
        plain = getattr(cs.fa, name)

        def wrapped(*a, _plain=plain, _key=key, **kw):
            counted[_key] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(cs.fa, name, wrapped)
    cs.phase_train(get_smoke_config("llama3-8b"), torch.device("cpu"), seq=16,
                   steps=2)
    per_step = cs.TRAIN_LAYERS * cs.MICROBATCHES
    # 2 steps, then one microbatch's gradients through the kernel backend
    assert counted == {"fwd": 2 * (2 * per_step + cs.TRAIN_LAYERS),
                       "bwd": 2 * per_step + cs.TRAIN_LAYERS}


def test_chip_smoke_exits_nonzero_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:      # the script alone, without the package
            script.write_text((ROOT / "chip_smoke.py").read_text())
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


def _ptxas(*kernels):
    """A fake -Xptxas -v report: (mangled name, spill stores, spill loads)."""
    return "\n".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {n}\n"
        f"    0 bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads\n"
        f"ptxas info    : Used 168 registers" for n, st, ld in kernels)


_FWD_OK = _ptxas(("_ZN11repro_torch2tc22flash_fwd_wgmma_kernelILi128EEEvv", 0, 0),
                 ("_ZN11repro_torch4simt16flash_fwd_kernelIfLi128EEEvv", 8, 8))
_BWD_OK = _ptxas(("_ZN11repro_torch2tc25flash_bwd_dq_wgmma_kernelILi64EEEvv", 0, 0),
                 ("_ZN11repro_torch22flash_bwd_delta_kernelI13__nv_bfloat16Li64EEEvv",
                  0, 0))
_HGMMA = "  /*0410*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;\n"
_HMMA = "  /*0200*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"


_DEC_OK = _ptxas(
    ("_ZN11repro_torch2tc19decode_split_kernelILi128ELi128ELi1EEEvPK13__nv_bfloat16",
     0, 0),
    ("_ZN11repro_torch2tc19decode_merge_kernelILi128EEEvPKfP13__nv_bfloat16", 0, 0),
    ("_ZN11repro_torch4simt23decode_attention_kernelIfEEvPKT_", 24, 24))


@pytest.mark.parametrize("fwd_report,bwd_report,fwd_sass,bwd_sass,dec_report,"
                         "dec_sass,fails", [
    (_FWD_OK, _BWD_OK, _HGMMA * 3, _HGMMA, _DEC_OK, _HMMA, None),
    (_FWD_OK, _BWD_OK, _HGMMA, _HMMA * 2, _DEC_OK, _HMMA, None),  # mma.sync backward
    (_FWD_OK, _BWD_OK, _HMMA, _HGMMA, _DEC_OK, _HMMA, "flash_attention_fwd: SASS"),
    (_FWD_OK, _BWD_OK, _HGMMA, "FFMA R1, R2, R3, R4 ;", _DEC_OK, _HMMA,
     "flash_attention_bwd: SASS"),
    (_FWD_OK, _BWD_OK.replace("0 bytes spill stores", "16 bytes spill stores", 1),
     _HGMMA, _HGMMA, _DEC_OK, _HMMA, "flash_attention_bwd: bf16 kernels spill"),
    (_ptxas(("_ZN11repro_torch4simt16flash_fwd_kernelIfLi128EEEvv", 0, 0)), _BWD_OK,
     _HGMMA, _HGMMA, _DEC_OK, _HMMA,
     "flash_attention_fwd: bf16 kernels spill"),  # no bf16 kernel
    (_FWD_OK, _BWD_OK, _HGMMA, _HGMMA, _DEC_OK, _HGMMA, None),    # wgmma decode
    (_FWD_OK, _BWD_OK, _HGMMA, _HGMMA, _DEC_OK, "FFMA R1, R2, R3, R4 ;",
     "decode_attention: SASS"),
    (_FWD_OK, _BWD_OK, _HGMMA, _HGMMA,
     _DEC_OK.replace("0 bytes spill loads", "8 bytes spill loads", 1), _HMMA,
     "decode_attention: bf16 kernels spill"),
], ids=["wgmma", "mma-sync-bwd", "fwd-no-hgmma", "bwd-no-tensor-cores",
        "bwd-spills", "fwd-no-bf16-kernel", "wgmma-decode",
        "decode-no-tensor-cores", "decode-spills"])
def test_chip_smoke_checks_the_tensor_cores(fwd_report, bwd_report, fwd_sass,
                                            bwd_sass, dec_report, dec_sass, fails):
    """Phase 2's check: the SASS of the decode and flash libraries holds the
    tensor-core instructions and their bf16 kernels spill nothing (an fp32
    kernel's spills are not its business)."""
    cs = _chip_smoke()
    reports = {"flash_attention_fwd": fwd_report, "flash_attention_bwd": bwd_report,
               "decode_attention": dec_report}
    sass = {"flash_attention_fwd": fwd_sass, "flash_attention_bwd": bwd_sass,
            "decode_attention": dec_sass}
    if fails:
        with pytest.raises(RuntimeError, match=fails):
            cs.check_tensor_cores(reports, sass)
    else:
        counts = cs.check_tensor_cores(reports, sass)
        assert counts["flash_attention_fwd"]["HGMMA"] >= 1
        assert sum(counts["flash_attention_bwd"].values()) >= 1
        assert sum(counts["decode_attention"].values()) >= 1
