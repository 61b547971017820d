"""The port's hybrid block — hymba-1.5b's ``self_attn`` and ``mamba`` on the
same normed input, summed — against the JAX package's, on the same
parameters and inputs (``hymba-smoke``: 3 layers, d_model 128, GQA 4/2/32,
sliding window 64 on every layer, SSM state 8, float32, CPU), and the two
reference faults the port pins for it.

Tolerances: logits within 1e-4 of the largest logit, as
tests/test_torch_dense.py holds the dense family; caches, SSM states and
the contexts' outputs within 1e-4 of their largest entry, as
tests/test_torch_mamba.py holds them (random weights drive the states far
above most of their entries).  Tests marked ``gpu`` hold the three kernels
at hymba-1.5b's shapes against their plain versions on a card: decode at
G = 5 (D 64 and 128), the flash forward at 25/5 heads, D 64, window 1024,
and the scan at Di 3200.
"""

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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.models import Model, params_from_jax
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig, build_context
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
TOL = 1e-4
MAX_SEQ = 128


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model on the same params, cfg, jax cfg)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg, jcfg


def _scaled_close(port, expected, tol=TOL):
    """Within ``tol`` of the largest entry of ``expected``."""
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=tol)


def _close_cache(cache, jcache):
    for i, layer in enumerate(cache):
        assert sorted(layer) == ["conv", "h", "k", "v"]
        for name in layer:
            _scaled_close(layer[name], jcache["blocks"][0][name][i])


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_full_config_shapes():
    """The shapes the card meets: GQA 25/5/64 (G = 5), window 1024 on
    every layer, Di = 3200 (a multiple of 8, as the scan's prefill kernel
    needs)."""
    cfg = get_config(ARCH)
    assert cfg.layer_kinds() == ("hybrid",) * cfg.n_layers
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (25, 5, 64)
    assert cfg.sliding_window == 1024 and not any(
        cfg.layer_is_global_attn(i) for i in range(cfg.n_layers))
    assert cfg.ssm_d_inner == 3200 and cfg.ssm_d_inner % 8 == 0


def test_params_and_module_names_follow_the_reference(pair):
    _, jp, model, cfg, _ = pair
    names = dict(model.named_modules())
    for i in range(cfg.n_layers):
        for sub in ("self_attn.q_proj", "mamba.in_proj", "mamba.out_proj",
                    "mlp.down_proj", "ln1", "ln2"):
            assert f"layers.{i}.{sub}" in names
    assert sorted(params_from_jax(jax.tree.map(np.asarray, jp), cfg)) == \
        sorted(model.state_dict())


# ---------------------------------------------------------------------------
# the model's paths against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_forward_matches_jax(pair, impl):
    """80 tokens, past the window of 64."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(0, (2, 80), cfg.vocab_size)
    expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                             impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        logits, aux = model(toks, impl=impl)
    _scaled_close(logits, expected)
    assert aux == {"load_balance": 0.0, "router_z": 0.0}


@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_prefill_then_decode_matches_jax(pair, impl):
    """Prefill fills a ring cache of window slots and the SSM state; two
    decode steps follow, the rows at different lengths."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(3, (3, 20), cfg.vocab_size)
    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                               max_seq=MAX_SEQ, impl=REFERENCE_IMPL[impl])
    last, cache = model.prefill(toks, max_seq=MAX_SEQ, impl=impl)
    _scaled_close(last, jlast)
    assert cache[0]["k"].shape[1] == cfg.sliding_window
    lengths = np.array([20, 11, 3], np.int32)
    new = _tokens(4, (3,), cfg.vocab_size)
    for step in range(2):
        expected, jcache = jm.decode_step(
            jp, jcache, jnp.asarray(new), jnp.asarray(lengths + step),
            impl=REFERENCE_IMPL[impl])
        logits, _ = model.decode_step(cache, new,
                                      torch.from_numpy(lengths + step), impl=impl)
        _scaled_close(logits, expected)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_exact_length_chunks_match_jax(pair, impl):
    """Chunks of 8, 8, 8 and 3 tokens (exact lengths, as the engine runs an
    SSM config's) against the absolute-position cache."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(4, (1, 27), cfg.vocab_size)
    jcache = jm.zero_cache(1, MAX_SEQ, use_ring=False)
    cache = model.zero_cache(1, MAX_SEQ, use_ring=False)
    assert cache[0]["k"].shape[1] == MAX_SEQ
    for start in range(0, 27, 8):
        ids = toks[:, start:start + 8]
        lens = np.array([start], np.int32)
        expected, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(ids),
                                            jnp.asarray(lens),
                                            impl=REFERENCE_IMPL[impl])
        logits, _ = model.prefill_chunk(cache, ids, torch.from_numpy(lens),
                                        impl=impl)
        _scaled_close(logits, expected)
    _close_cache(cache, jcache)


# ---------------------------------------------------------------------------
# the hybrid block's two contexts against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,phase", [("self_attn", "prefill"),
                                        ("self_attn", "decode"),
                                        ("mamba", "prefill"),
                                        ("mamba", "decode")])
def test_contexts_match_jax(pair, kind, phase):
    """Hybrid needs no context of its own: its entries are ``self_attn`` at
    the layer's window and ``mamba``."""
    _, jp, model, cfg, jcfg = pair
    window = cfg.sliding_window
    toks, reqs, ctx = (12, 2, 32) if phase == "prefill" else (1, 3, 32)
    jmc = jax_build_context(jcfg, kind, phase=phase, backend="xla", window=window)
    mc = build_context(cfg, kind, phase=phase, backend="kernel", window=window,
                       device="cpu")
    assert mc.static_attrs == jmc.static_attrs
    specs = mc.abstract_inputs(toks, reqs, ctx)
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal(s.shape, dtype=np.float32)
              if s.dtype.is_floating_point else np.full(s.shape, 5, np.int32)
              for s in specs]
    scope = "attn" if kind == "self_attn" else "mamba"
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0][scope])
    expected = jmc.fn(jparams, *[jnp.asarray(a) for a in arrays])
    weights = {k[len(f"layers.0.{kind}."):]: v
               for k, v in model.state_dict().items()
               if k.startswith(f"layers.0.{kind}.")}
    out = mc.fn(mc.module(weights), *[torch.from_numpy(a) for a in arrays])
    _scaled_close(out, expected)


# ---------------------------------------------------------------------------
# the engine against the JAX engine, and the two pinned reference faults
# ---------------------------------------------------------------------------

def _serve_both(pair, specs, sched):
    """Both engines serve ``specs`` (prompt, output lengths); the port's
    records each chunk's width and the layer-0 SSM state of its row after
    it, the JAX engine the row it writes back."""
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
    """The same schedule, exact-length chunks (hymba has SSM state) and the
    same final K/V, conv tails and states of every layer and row."""
    specs = [(40, 5), (9, 3), (57, 2), (23, 6), (31, 1)]
    sched = dict(max_num_seqs=3, max_batch_tokens=64, chunk_size=32)
    jeng, eng, reqs, _, (_, _, widths) = _serve_both(pair, specs, sched)
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert widths == [n for r in eng.records for n, _ in r.chunks]
    assert any(n % 8 for n in widths)
    assert all(r.done and r.generated == o for r, (_, o) in zip(reqs, specs))
    _close_cache(eng.cache, jeng.cache)


def test_engine_decodes_advance_rows_still_in_prefill_like_jax(pair):
    """Pinned reference behaviour (ROADMAP Queue 3 item 5): decode runs the
    whole row batch, so the SSM state of a row still in prefill advances
    with the decodes between its chunks, in both engines alike; alone, the
    row ends within rounding of ``Model.prefill``'s state."""
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
    assert float((port - prefill).abs().max() / prefill.abs().max()) > 1e-2
    port, jax_row, prefill = after_last_chunk([(24, 1)])
    _scaled_close(port, jax_row)
    _scaled_close(port, prefill.numpy())


def test_decode_ignores_the_window_like_jax(pair):
    """Pinned reference behaviour (ROADMAP Queue 3 item 4): after a 96-token
    chunked prefill (window 64), decoding position 96 attends all 97 keys,
    so it differs from the full forward's logits there, by the same error
    in both packages, and the two decodes agree.  The Mamba heads' output
    projection is zeroed in both packages: on random weights their states
    grow so large that they drown the attention's share of the logits."""
    jm, jp, _, cfg, _ = pair
    assert cfg.sliding_window == 64
    jp = jax.tree.map(lambda a: a, jp)
    jp["blocks"][0]["mamba"]["out_proj"]["w"] = jnp.zeros_like(
        jp["blocks"][0]["mamba"]["out_proj"]["w"])
    model = Model(cfg, device="cpu").requires_grad_(False)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    toks = _tokens(7, (1, 97), cfg.vocab_size)
    jcache = jm.zero_cache(1, MAX_SEQ, use_ring=False)
    cache = model.zero_cache(1, MAX_SEQ, use_ring=False)
    for start in range(0, 96, 32):
        ids = toks[:, start:start + 32]
        lens = np.array([start], np.int32)
        _, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(ids),
                                     jnp.asarray(lens), impl="xla")
        model.prefill_chunk(cache, ids, torch.from_numpy(lens), impl="xla")
    pos = np.array([96], np.int32)
    jdec, _ = jm.decode_step(jp, jcache, jnp.asarray(toks[:, 96]),
                             jnp.asarray(pos), impl="xla")
    dec, _ = model.decode_step(cache, toks[:, 96], torch.from_numpy(pos),
                               impl="xla")
    jfull, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl="xla")
    with torch.no_grad():
        full = model(toks, impl="xla")[0]
    _scaled_close(dec, jdec)
    jerr = float(np.abs(np.asarray(jdec) - np.asarray(jfull)[:, 96]).max())
    err = float((dec - full[:, 96]).abs().max())
    assert jerr > 0.1 and abs(err - jerr) <= 1e-3 * jerr, (err, jerr)


# ---------------------------------------------------------------------------
# on a card: the kernels at hymba-1.5b's shapes
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


GPU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_gpu_decode_group_of_five_matches_plain(cuda, dtype, d):
    """hymba's decode: 25 heads on 5 KV heads (G = 5), B = 8, Smax 2048."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, (8, 5, 5, d), dtype, cuda)          # (B, KV, G, D)
    kc, vc = (_randn(gen, (8, 2048, 5, d), dtype, cuda) for _ in range(2))
    lengths = torch.randint(1, 2049, (8,), generator=gen, device=cuda,
                            dtype=torch.int32)
    n = da.decode_attention.launches
    out = da.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == n + 1
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(q, kc, vc, lengths).float(),
        atol=GPU_TOL[dtype], rtol=GPU_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1024, 1500])
def test_gpu_flash_forward_at_hymba_shape_matches_plain(cuda, dtype, s):
    """The flash forward at 25 query heads on 5 KV heads, D = 64, causal
    with hymba's window of 1024; at 1500 tokens the window cuts keys."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (1, s, 25, 64), dtype, cuda)
    k, v = (_randn(gen, (1, s, 5, 64), dtype, cuda) for _ in range(2))
    n = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=1024)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n + 1
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=1024)
    tol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), pout.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 1024), (8, 1), (1, 37)])
def test_gpu_scan_at_hymba_width_matches_plain(cuda, dtype, b, s):
    """The selective scan at Di = 3200, N = 16: a 1024-token prefill, a
    decode step of 8 rows, and an exact-length chunk of 37."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    di, n = 3200, 16
    x = _randn(gen, (b, s, di), dtype, cuda)
    dt = torch.nn.functional.softplus(_randn(gen, (b, s, di), torch.float32, cuda))
    A = -torch.exp(0.3 * _randn(gen, (di, n), torch.float32, cuda))
    Bc, Cc = (_randn(gen, (b, s, n), dtype, cuda) for _ in range(2))
    D = _randn(gen, (di,), torch.float32, cuda)
    h0 = _randn(gen, (b, di, n), torch.float32, cuda)
    launches = ms.mamba_scan.launches
    y, h = ms.mamba_scan(x, dt, A, Bc, Cc, D, h0)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == launches + 1
    py, ph = ms.mamba_scan_plain(x, dt, A, Bc, Cc, D, h0)
    tol = {torch.float32: 5e-5, torch.bfloat16: 2e-2}[dtype]
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, ph, atol=tol, rtol=tol)
