"""The port's Mamba slice against the JAX package's, on the same numpy inputs
and parameters: the plain selective scan and its decode step, the scan
kernel's entry point (its plain version on the CPU) against the Pallas
kernel in interpret mode, the chunked scan, the mixer and step, the
``falcon-mamba-smoke`` model (3 layers, d_model 128, state 8, float32),
the serving engine and the ``mamba`` execution context.

Tolerances: the scans 5e-5, as ``test_pallas_mamba_scan`` holds the Pallas
kernel against ``ref.selective_scan`` (the port scans by log-step doubling,
the reference by ``associative_scan``: the same sums in another order);
model logits 1e-4, as tests/test_models.py; SSM states and the outputs of
the mixer, the step and the contexts on random inputs 1e-4 of their
largest entry, since random weights drive them to 1e5 and beyond here and
rounding shows up as absolute error on small entries.  Tests
marked ``gpu`` hold the CUDA kernel against its plain version on a card.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.models import build_model
from repro.models import mamba as jmamba
from repro.serving import scheduler as jax_scheduler
from repro.serving.context import build_context as jax_build_context
from repro.serving.context import phases_for as jax_phases_for
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.backends import cuda_events
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, params_from_jax
from repro_torch.models import mamba
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig, build_context, phases_for
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SCAN_TOL, TOL = 5e-5, 1e-4
MAX_SEQ = 64
#: tests/test_kernels.py test_pallas_mamba_scan: (b, s, di, n, chunk, bd)
SCAN_CASES = [(2, 64, 32, 8, 48, 16), (1, 300, 64, 16, 128, 64),
              (2, 50, 16, 4, 16, 16)]
ARCH = "falcon-mamba-7b"


def _scan_inputs(b, s, di, n, seed=0):
    """x, dt, A, Bc, Cc, D, h0 as numpy float32, drawn as the Pallas
    kernel's test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di), dtype=np.float32)))
    A = -np.exp(0.3 * rng.standard_normal((di, n), dtype=np.float32))
    Bc = rng.standard_normal((b, s, n), dtype=np.float32)
    Cc = rng.standard_normal((b, s, n), dtype=np.float32)
    D = rng.standard_normal((di,), dtype=np.float32)
    h0 = rng.standard_normal((b, di, n), dtype=np.float32)
    return x, dt, A, Bc, Cc, D, h0


def _close(port, expected, tol=SCAN_TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(expected, np.float32), atol=tol,
                               rtol=tol)


def _scaled_close(port, expected, tol=TOL):
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-12
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=tol)


def _t(arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model on the same params, cfg, jax cfg)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg, jcfg


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the plain scan and step, the kernel's entry point, the chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,s,di,n,chunk,bd", SCAN_CASES)
def test_ref_selective_scan_matches_jax(b, s, di, n, chunk, bd, with_h0):
    *args, h0 = _scan_inputs(b, s, di, n)
    h0 = h0 if with_h0 else None
    y, h = ref.selective_scan(*_t(args + [h0]))
    ey, eh = jref.selective_scan(*_j(args + [h0]))
    assert y.dtype == torch.float32 and h.shape == (b, di, n)
    _close(y, ey)
    _close(h, eh)


@pytest.mark.parametrize("b,s,di,n,chunk,bd", SCAN_CASES)
def test_ref_selective_scan_step_matches_jax(b, s, di, n, chunk, bd):
    x, dt, A, Bc, Cc, D, h0 = _scan_inputs(b, 1, di, n, seed=1)
    args = [x[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0], D, h0]
    y, h = ref.selective_scan_step(*_t(args))
    ey, eh = jref.selective_scan_step(*_j(args))
    _close(y, ey)
    _close(h, eh)


@pytest.mark.parametrize("b,s,di,n,chunk,bd", SCAN_CASES)
def test_ops_selective_scan_matches_the_pallas_kernel(b, s, di, n, chunk, bd):
    """On CPU tensors the entry point takes the plain version and counts no
    launch; the JAX side runs the Pallas kernel in interpret mode, as
    tests/test_kernels.py runs it."""
    args = _scan_inputs(b, s, di, n, seed=2)
    ms.mamba_scan.launches = 0
    y, h = ops.selective_scan(*_t(args))
    ey, eh = jax_mamba_scan(*_j(args), chunk=chunk, block_d=bd, interpret=True)
    _close(y, ey)
    _close(h, eh)
    # the reference's own entry point reaches the same kernel
    jy, jh = jops.selective_scan(*_j(args))
    _close(y, jy)
    _close(h, jh)
    assert ms.mamba_scan.launches == 0


def test_ops_selective_scan_at_one_step_is_the_decode_step():
    x, dt, A, Bc, Cc, D, h0 = _scan_inputs(3, 1, 32, 16, seed=3)
    y, h = ops.selective_scan(*_t([x, dt, A, Bc, Cc, D, h0]))
    ey, eh = jref.selective_scan_step(*_j([x[:, 0], dt[:, 0], A, Bc[:, 0],
                                           Cc[:, 0], D, h0]))
    assert y.shape == (3, 1, 32)
    _close(y[:, 0], ey)
    _close(h, eh)


@pytest.mark.parametrize("with_h0", [True, False])
def test_selective_scan_chunked_carries_the_state_across_chunks(with_h0):
    *args, h0 = _scan_inputs(2, 600, 16, 4, seed=4)
    h0 = h0 if with_h0 else None
    y, h = mamba.selective_scan_chunked(*_t(args + [h0]))
    ey, eh = jmamba.selective_scan_chunked(*_j(args + [h0]))
    assert mamba.SCAN_CHUNK == jmamba.SCAN_CHUNK == 512
    _close(y, ey)
    _close(h, eh)


def test_mamba_scan_plain_is_the_reference_scan():
    args = _t(_scan_inputs(1, 20, 16, 8, seed=5))
    for a, b in zip(ms.mamba_scan_plain(*args), ref.selective_scan(*args)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# mixer and step against repro.models.mamba
# ---------------------------------------------------------------------------

def _layer0(pair):
    jm, jp, model, cfg, jcfg = pair
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"]),
            model.layers[0].mamba, cfg, jcfg)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_mamba_mixer_matches_jax(pair, impl):
    jparams, m, cfg, jcfg = _layer0(pair)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    h0 = rng.standard_normal((2, cfg.ssm_d_inner, cfg.ssm_state), dtype=np.float32)
    tail = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                               dtype=np.float32)
    out, (etail, eh) = jmamba.mamba_mixer(jparams, jnp.asarray(x), jcfg,
                                          h0=jnp.asarray(h0),
                                          conv_tail=jnp.asarray(tail),
                                          return_state=True)
    with torch.no_grad():
        y, (ptail, ph) = mamba.mamba_mixer(m, *_t([x]), cfg, *_t([h0, tail]),
                                           return_state=True, impl=impl)
        fresh = mamba.mamba_mixer(m, *_t([x]), cfg, impl=impl)
    _scaled_close(y, out)
    _close(ptail, etail, TOL)
    _scaled_close(ph, eh)
    _scaled_close(fresh, jmamba.mamba_mixer(jparams, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_mamba_step_matches_jax(pair, impl):
    jparams, m, cfg, jcfg = _layer0(pair)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    state = {"conv": rng.standard_normal((3, cfg.ssm_conv - 1, cfg.ssm_d_inner),
                                         dtype=np.float32),
             "h": rng.standard_normal((3, cfg.ssm_d_inner, cfg.ssm_state),
                                      dtype=np.float32)}
    out, est = jmamba.mamba_step(jparams, jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, state), jcfg)
    port_state = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    with torch.no_grad():
        y, st = mamba.mamba_step(m, torch.from_numpy(x), port_state, cfg,
                                 impl=impl)
    _scaled_close(y, out)
    _close(st["conv"], est["conv"], TOL)
    _scaled_close(st["h"], est["h"])
    # the state it was given is left as it was
    assert all(np.array_equal(port_state[k].numpy(), state[k]) for k in state)


def test_mamba_rejects_an_unknown_backend(pair):
    _, m, cfg, _ = _layer0(pair)
    with pytest.raises(ValueError, match="unknown mamba impl"):
        mamba.mamba_mixer(m, torch.zeros(1, 4, cfg.d_model), cfg, impl="pallas")


def test_init_mamba_state_matches_the_reference_spec(pair):
    *_, cfg, jcfg = pair
    st = mamba.init_mamba_state(cfg, 3, device="cpu", dtype=torch.bfloat16)
    spec = jmamba.init_mamba_state(jcfg, 3, jnp.bfloat16)
    for k in ("conv", "h"):
        assert tuple(st[k].shape) == spec[k].shape and not st[k].any()
        assert str(st[k].dtype).split(".")[-1] == str(spec[k].dtype)


# ---------------------------------------------------------------------------
# the falcon-mamba-smoke model
# ---------------------------------------------------------------------------

def test_params_and_module_names_follow_the_reference(pair):
    _, jp, model, cfg, _ = pair
    names = dict(model.named_modules())
    for i in range(cfg.n_layers):
        assert f"layers.{i}.mamba" in names
        assert f"layers.{i}.mamba.in_proj" in names
        assert f"layers.{i}.ln2" not in names and f"layers.{i}.mlp" not in names
    state = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert sorted(state) == sorted(model.state_dict())
    bf16 = Model(cfg.with_overrides(dtype="bfloat16"), device="cpu")
    assert {n for n, p in bf16.layers[0].mamba.named_parameters()
            if p.dtype == torch.float32} == {"dt_b", "A_log", "D"}


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_forward_matches_jax(pair, impl):
    jm, jp, model, cfg, _ = pair
    toks = _tokens(0, (2, 40), cfg.vocab_size)
    expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                             impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        _close(model(toks, impl=impl)[0], expected, TOL)


def _close_state(port_cache, jax_cache):
    for i, layer in enumerate(port_cache):
        _close(layer["conv"], jax_cache["blocks"][0]["conv"][i], TOL)
        _scaled_close(layer["h"], jax_cache["blocks"][0]["h"][i])


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_then_decode_matches_jax(pair, impl):
    jm, jp, model, cfg, _ = pair
    toks = _tokens(1, (2, 24), cfg.vocab_size)
    expected, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                  max_seq=MAX_SEQ, impl=REFERENCE_IMPL[impl])
    logits, cache = model.prefill(toks, max_seq=MAX_SEQ, impl=impl)
    _close(logits, expected, TOL)
    _close_state(cache, jcache)
    lengths = np.array([24, 24], np.int32)
    for step in range(2):
        new = _tokens(2 + step, (2,), cfg.vocab_size)
        expected, jcache = jm.decode_step(jp, jcache, jnp.asarray(new),
                                          jnp.asarray(lengths + step),
                                          impl=REFERENCE_IMPL[impl])
        logits, cache = model.decode_step(cache, new,
                                          torch.from_numpy(lengths + step),
                                          impl=impl)
        _close(logits, expected, TOL)
    _close_state(cache, jcache)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_chunks_of_8_match_jax(pair, impl):
    jm, jp, model, cfg, _ = pair
    toks = _tokens(4, (1, 27), cfg.vocab_size)
    jcache = jm.zero_cache(1, MAX_SEQ, use_ring=False)
    cache = model.zero_cache(1, MAX_SEQ, use_ring=False)
    assert [sorted(c) for c in cache] == [["conv", "h"]] * cfg.n_layers
    for start in range(0, 27, 8):
        ids = toks[:, start:start + 8]
        lens = np.array([start], np.int32)
        expected, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(ids),
                                            jnp.asarray(lens),
                                            impl=REFERENCE_IMPL[impl])
        logits, out = model.prefill_chunk(cache, ids, torch.from_numpy(lens),
                                          impl=impl)
        assert out is cache
        _close(logits, expected, TOL)
    _close_state(cache, jcache)
    # the chunks leave the state a single prefill leaves
    _, whole = model.prefill(toks, max_seq=MAX_SEQ, impl=impl)
    for a, b in zip(cache, whole):
        _scaled_close(a["h"], b["h"].numpy())


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

def _serve_both(pair, specs, sched):
    _, jp, model, cfg, jcfg = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, p).tolist() for p, _ in specs]
    jeng = JaxEngine(jcfg, sched_config=jax_scheduler.SchedulerConfig(**sched),
                     max_seq=MAX_SEQ, params=jp, impl="xla")
    jrows = []
    write_row = jeng._write_row

    def record_row(slot, row):
        jrows.append((slot, np.asarray(row["blocks"][0]["h"][0, 0])))
        write_row(slot, row)
    jeng._write_row = record_row
    jeng.run([jax_scheduler.Request(i, 0.0, list(p), o)
              for i, (p, (_, o)) in enumerate(zip(prompts, specs))])
    eng = Engine(cfg, sched_config=SchedulerConfig(**sched), max_seq=MAX_SEQ,
                 params=model.state_dict(), impl="kernel", device="cpu")
    rows, widths = [], []
    chunk_fn = eng.model.prefill_chunk

    def record_chunk(cache, tokens, *a, **kw):
        widths.append(len(tokens[0]))
        out = chunk_fn(cache, tokens, *a, **kw)
        rows.append(cache[0]["h"][0].clone())
        return out
    eng.model.prefill_chunk = record_chunk
    reqs = [port_scheduler.Request(i, 0.0, list(p), o)
            for i, (p, (_, o)) in enumerate(zip(prompts, specs))]
    eng.run(reqs)
    return jeng, eng, reqs, prompts, (jrows, rows, widths)


def test_engine_matches_jax_engine(pair):
    """The same schedule, exact-length chunks (no bucket padding: pad tokens
    would advance the SSM state) and the same final state of every layer
    and row; slots are reused, and a reused slot starts from the state its
    last request left, in both engines."""
    specs = [(40, 5), (9, 3), (57, 2), (23, 6), (31, 1), (14, 4)]
    sched = dict(max_num_seqs=4, max_batch_tokens=64, chunk_size=32)
    jeng, eng, reqs, _, (_, _, widths) = _serve_both(pair, specs, sched)
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert widths == [n for r in eng.records for n, _ in r.chunks]
    assert any(n % 8 for n in widths)        # lengths no bucket would give
    assert all(r.done and r.generated == o for r, (_, o) in zip(reqs, specs))
    _close_state(eng.cache, jeng.cache)


def test_engine_decodes_advance_rows_still_in_prefill_like_jax(pair):
    """Pinned reference behaviour (ROADMAP Queue 3): decode runs the whole
    row batch, so the state of a row whose prompt is still in prefill is
    advanced by the decodes interleaved with its chunks.  A 24-token prompt
    prefilled in three chunks beside an 8-token prompt that decodes ends its
    last chunk with a layer-0 state far from ``Model.prefill``'s, in both
    engines alike; alone, it ends within rounding of it."""
    *_, model, cfg, _ = pair
    sched = dict(max_num_seqs=2, max_batch_tokens=16, chunk_size=8)

    def after_last_chunk(specs):
        _, _, reqs, prompts, (jrows, rows, _) = _serve_both(pair, specs, sched)
        _, whole = model.prefill(np.array([prompts[-1]]), max_seq=MAX_SEQ,
                                 impl="xla")
        slot = reqs[-1].slot
        last = [i for i, (s, _) in enumerate(jrows) if s == slot][-1]
        return rows[last], jrows[last][1], whole[0]["h"][0]

    port, jax_row, prefill = after_last_chunk([(8, 6), (24, 1)])
    _scaled_close(port, jax_row)
    gap = float((port - prefill).abs().max() / prefill.abs().max())
    assert gap > 1e-2, gap
    port, jax_row, prefill = after_last_chunk([(24, 1)])
    _scaled_close(port, jax_row)
    _scaled_close(port, prefill.numpy())


# ---------------------------------------------------------------------------
# the mamba execution context against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_mamba_context_matches_jax(pair, phase, backend):
    _, jp, model, cfg, jcfg = pair
    toks, reqs = (12, 2) if phase == "prefill" else (1, 3)
    jmc = jax_build_context(jcfg, "mamba", phase=phase, backend="xla")
    mc = build_context(cfg, "mamba", phase=phase, backend=backend, device="cpu")
    assert mc.static_attrs == jmc.static_attrs
    specs = mc.abstract_inputs(toks, reqs, 32)
    jspecs = jmc.abstract_inputs(toks, reqs, 32)
    assert [(tuple(s.shape), str(s.dtype).split(".")[-1]) for s in specs] == \
        [(tuple(s.shape), str(s.dtype)) for s in jspecs]
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal(s.shape, dtype=np.float32) for s in specs]
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mamba"])
    expected = jmc.fn(jparams, *[jnp.asarray(a) for a in arrays])
    weights = {k[len("layers.0.mamba."):]: v for k, v in model.state_dict().items()
               if k.startswith("layers.0.mamba.")}
    assert {k: (tuple(v.shape), v.dtype) for k, v in weights.items()} == \
        {k: (tuple(s.shape), s.dtype) for k, s in mc.params.items()}
    out = mc.fn(mc.module(weights), *[torch.from_numpy(a) for a in arrays])
    _scaled_close(out, expected)


def test_phases_for_matches_the_reference(pair):
    cfg, jcfg = pair[3], pair[4]
    for kind in ("self_attn", "mamba", "moe"):
        assert phases_for(kind, cfg) == jax_phases_for(kind, jcfg)


# ---------------------------------------------------------------------------
# the kernel's source, work split and row staging
# ---------------------------------------------------------------------------

def test_scan_entries_are_defined_by_the_loaded_source():
    """Every extern "C" entry of csrc/mamba_scan.cu is one the wrapper names,
    each for its own dtype, and both reach the step kernel at S = 1 and the
    two chunk passes otherwise, on the special-function unit's exponent."""
    import re
    text = (ROOT / "src/repro_torch/csrc/mamba_scan.cu").read_text()
    entries = dict(re.findall(r"^REPRO_SCAN_ENTRY\((\w+), ([\w:]+)\)$", text,
                              re.MULTILINE))
    assert entries == {ms._ENTRY[torch.float32]: "float",
                       ms._ENTRY[torch.bfloat16]: "__nv_bfloat16"}
    launch = text[text.index("cudaError_t launch_n("):text.index("int launch(")]
    assert "scan_step_kernel<T, N>" in launch
    assert launch.count("scan_chunk_kernel<T, N>") == 2
    assert "expf(" not in text and text.count("ex2_approx(") >= 3


@pytest.mark.parametrize("b,s,di", [(1, 1024, 8192), (1, 256, 8192), (8, 2, 8192),
                                    (1, 300, 64), (2, 50, 16), (1, 2048, 64),
                                    (4, 4097, 256), (1, 17, 8)])
def test_scan_chunks_cover_the_sequence(b, s, di):
    """Chunks of whole 16-step units, at least MIN_CHUNK steps where S has
    them, covering S exactly once (the last one may be shorter), and enough
    at falcon-mamba's prefill to fill the card several times over."""
    chunk, chunks = ms.scan_chunks(b, s, di, 132)
    assert chunk % ms.CHUNK_STEPS == 0 and (chunks - 1) * chunk < s <= chunks * chunk
    assert chunks == 1 or chunk >= ms.MIN_CHUNK - ms.CHUNK_STEPS
    assert (chunk, chunks) == ms.scan_chunks(b, s, di, 132)
    if (b, s, di) == (1, 1024, 8192):
        blocks = (chunks - 1) * di // ms.CHANNELS_PER_BLOCK
        assert chunks >= 4 and blocks >= ms.SCAN_BLOCKS_PER_SM * 132


def test_scan_rows_are_staged_only_when_the_kernel_cannot_copy_them():
    """x_proj's column slices go to the kernel as they are; a B or C whose
    rows are not whole aligned 16-byte vectors is copied into padded rows
    with the same values."""
    xdbc = torch.randn(2, 5, 256 + 32).to(torch.bfloat16)
    Bc = xdbc[..., 256:272]
    assert ms._vector_rows(Bc) is Bc
    narrow = torch.randn(2, 5, 4 + 8).to(torch.bfloat16)[..., 4:8]   # N=4 bf16
    rows = ms._vector_rows(narrow)
    assert rows.shape == (2, 5, 8) and rows.stride(-1) == 1
    assert torch.equal(rows[..., :4], narrow) and not rows[..., 4:].any()
    strided = torch.randn(2, 16, 5).transpose(1, 2)                   # n stride 5
    assert torch.equal(ms._vector_rows(strided)[..., :16], strided)


# ---------------------------------------------------------------------------
# chip_smoke.py's falcon-mamba phases on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_mamba_serving_counts_scan_launches(monkeypatch, capsys):
    """The mamba serving phase at falcon-mamba-smoke, with the plain scan
    counted as the kernel would be: after the warm-up, one call per layer
    for each exact-length chunk and each decode iteration of each of the
    phase's runs, and one per layer for the kernel's decode step on the
    final state."""
    cs = _chip_smoke()
    calls = []
    plain = cs.ms.mamba_scan_plain
    monkeypatch.setattr(cs.ms, "mamba_scan_plain",
                        lambda *a: calls.append(a[0].shape[1]) or plain(*a))
    cfg = get_smoke_config(ARCH)
    out = cs.phase_mamba_serving(cfg, torch.device("cpu"))
    buckets = len([b for b in (8, 16, 32, 64, 128, 256)
                   if b <= cs.SCHED.chunk_size])
    warmup = cfg.n_layers * (1 + buckets)
    runs = len(out["makespans_s"])
    assert runs == 2
    assert len(calls) == warmup + cfg.n_layers * (
        runs * (out["chunks"] + out["decode_iterations"]) + 1)
    assert out["chunks"] > 0 and out["min_cosine"] > 0.999
    assert "[7 mamba serving]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_inputs(dev, b, s, di, n, dtype, *, seed=0, dt_rank=0):
    """The scan's inputs on the card; with ``dt_rank``, Bc and Cc are
    column slices of one (B, S, dt_rank + 2N) tensor, as in the mixer."""
    x, dt, A, Bc, Cc, D, h0 = _t(_scan_inputs(b, s, di, n, seed=seed))
    if dt_rank:
        pre = torch.randn(b, s, dt_rank, generator=torch.Generator().manual_seed(seed))
        xdbc = torch.cat([pre, Bc, Cc], dim=-1)
        Bc, Cc = xdbc[..., dt_rank:dt_rank + n], xdbc[..., dt_rank + n:]
    return [x.to(dev, dtype), dt.to(dev), A.to(dev), Bc.to(dev, dtype),
            Cc.to(dev, dtype), D.to(dev), h0.to(dev)]


#: kernel against plain on the card: fp32 at the Pallas test's 5e-5, bf16
#: at 2e-2 (y rounded to bf16 at different places)
GPU_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,di,n,dt_rank,with_h0", [
    c[:4] + (0, True) for c in SCAN_CASES] + [
    (1, 1024, 8192, 16, 256, False), (8, 1, 8192, 16, 256, True),
    (2, 70, 48, 8, 0, False), (8, 1, 96, 16, -1, True)])
def test_gpu_scan_kernel_matches_plain(cuda, dtype, b, s, di, n, dt_rank,
                                       with_h0):
    """dt_rank > 0: Bc and Cc are column slices; -1: x and dt are
    transposed views (made contiguous by the wrapper), as an einsum can
    leave the decode step's input."""
    *args, h0 = _card_inputs(cuda, b, s, di, n, dtype, dt_rank=max(dt_rank, 0))
    if dt_rank < 0:
        args[:2] = [t.transpose(0, 2).contiguous().transpose(0, 2) for t in args[:2]]
        assert not args[0].is_contiguous()
    args.append(h0 if with_h0 else None)
    launches = ms.mamba_scan.launches
    y, h = ms.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == launches + 1
    py, ph = ms.mamba_scan_plain(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, ph, atol=tol, rtol=tol)


#: (b, s, di, n): S spanning many chunks, S not a multiple of the chunk,
#: N = 4 (bf16 rows staged), several rows
GPU_CHUNK_CASES = [(1, 2048, 64, 8), (1, 300, 8192, 16), (3, 777, 96, 4),
                   (2, 1000, 256, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,s,di,n", GPU_CHUNK_CASES)
def test_gpu_scan_chunks_match_plain(cuda, dtype, b, s, di, n, with_h0):
    chunk, chunks = ms.scan_chunks(b, s, di, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert chunks > 1
    *args, h0 = _card_inputs(cuda, b, s, di, n, dtype, seed=3)
    args.append(h0 if with_h0 else None)
    y, h = ms.mamba_scan(*args)
    py, ph = ms.mamba_scan_plain(*args)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, ph, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(1, 1024), (8, 1)], ids=["prefill", "decode"])
def test_gpu_scan_bf16_is_deterministic(cuda, b, s):
    """Two bf16 calls at falcon-mamba's width agree bit for bit: chunks are
    joined in one fixed order, without atomics."""
    args = _card_inputs(cuda, b, s, 8192, 16, torch.bfloat16, dt_rank=256)
    (y1, h1), (y2, h2) = ms.mamba_scan(*args), ms.mamba_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    assert torch.isfinite(y1.float()).all() and torch.isfinite(h1).all()


@pytest.mark.gpu
def test_gpu_scan_wrapper_raises_on_unsupported_inputs(cuda):
    x, dt, A, Bc, Cc, D, h0 = _card_inputs(cuda, 1, 8, 32, 8, torch.float32)
    with pytest.raises(TypeError):
        ms.mamba_scan(x.half(), dt, A, Bc.half(), Cc.half(), D, h0)
    with pytest.raises(TypeError):
        ms.mamba_scan(x, dt.bfloat16(), A, Bc, Cc, D, h0)
    with pytest.raises(ValueError):
        ms.mamba_scan(x, dt, A, Bc, Cc, D.cpu(), h0)
    with pytest.raises(ValueError):
        ms.mamba_scan(x, dt, A, Bc[:, :4], Cc, D, h0)
    with pytest.raises(RuntimeError, match="no backward"):
        ms.mamba_scan(x.clone().requires_grad_(True), dt, A, Bc, Cc, D, h0)
    with torch.no_grad():       # autograd would record nothing: allowed
        ms.mamba_scan(x.clone().requires_grad_(True), dt, A, Bc, Cc, D, h0)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [96, 1], ids=["prefill", "decode"])
def test_gpu_scan_kernel_captures_in_a_cuda_graph(cuda, s):
    args = _card_inputs(cuda, 2, s, 8192, 16, torch.bfloat16, dt_rank=256)
    eager_y, eager_h = ms.mamba_scan(*args)
    seconds = cuda_events(ms.mamba_scan, args, repeats=5)
    assert 0 < seconds < 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, h = ms.mamba_scan(*args)
    y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager_y) and torch.equal(h, eager_h)
