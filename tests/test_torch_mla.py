"""The port's MLA family — ``models/mla.py``, the ``mla_attn`` block and
context, minicpm3-4b — against the JAX package's, on the same parameters and
inputs (``minicpm3-smoke``: 3 layers, d_model 128, 4 heads, latent rank 32,
float32, CPU).

Tolerances: logits within 1e-4 of the largest logit, as
tests/test_torch_dense.py holds the dense family (the frameworks sum their
float32 products in other orders); the 2049-token forward runs the JAX
model op by op, as tests/test_torch_models.py explains; caches and the
context outputs within 1e-4 of their largest entry, since random weights
drive a few entries far above the rest.  Tests marked ``gpu`` hold the
module captured in a CUDA graph against its eager calls on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import mla as jmla
from repro.serving import scheduler as jax_scheduler
from repro.serving.context import build_context as jax_build_context
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, params_from_jax
from repro_torch.models import mla
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig, build_context
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ARCH = "minicpm3-4b"
TOL = 1e-4
MAX_SEQ = 64


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


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_params_and_module_names_follow_the_reference(pair):
    _, jp, model, cfg, _ = pair
    names = dict(model.named_modules())
    for i in range(cfg.n_layers):
        for sub in ("q_down", "q_norm", "q_up", "kv_down", "kv_norm", "k_up",
                    "v_up", "o_proj"):
            assert f"layers.{i}.mla_attn.{sub}" in names
        assert f"layers.{i}.self_attn" not in names
    assert sorted(params_from_jax(jax.tree.map(np.asarray, jp), cfg)) == \
        sorted(model.state_dict())
    assert model.layers[0].mla_attn.q_norm.scale.dtype == torch.float32


def test_init_mla_cache_matches_the_reference_spec(pair):
    *_, cfg, jcfg = pair
    cache = mla.init_mla_cache(cfg, 3, 40, device="cpu", dtype=torch.bfloat16)
    spec = jmla.init_mla_cache(jcfg, 3, 40, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in spec.items()}
    assert all(v.dtype == torch.bfloat16 and not v.any() for v in cache.values())


# ---------------------------------------------------------------------------
# the model's paths against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_forward_matches_jax(pair, impl):
    jm, jp, model, cfg, _ = pair
    toks = _tokens(0, (2, 40), cfg.vocab_size)
    expected, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        logits, aux = model(toks, impl=impl)
    _scaled_close(logits, expected)
    assert aux == {"load_balance": 0.0, "router_z": 0.0}
    assert {k: float(v) for k, v in jaux.items()} == aux


def test_forward_above_2048_tokens_runs_flash_xla(pair):
    """Above 2048 tokens ``auto`` (and ``chunked``) expand K/V and run
    ``flash_attention_xla``, the materialized attention otherwise, as
    ``repro/models/mla.py:81-86`` switches; the JAX model runs op by op
    (its compiled RoPE drifts near position 2048)."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(8, (1, 2049), cfg.vocab_size)
    with jax.disable_jit():
        expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl="auto")
    calls = []
    flash = mla.flash_attention_xla

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return flash(*args, **kw)
    mla.flash_attention_xla = spy
    try:
        with torch.no_grad():
            auto = model(toks, impl="auto")[0]
            chunked = model(toks, impl="chunked")[0]
            model(toks[:, :2048], impl="auto")
    finally:
        mla.flash_attention_xla = flash
    assert calls == [2049] * (2 * cfg.n_layers)
    assert torch.equal(auto, chunked)
    _scaled_close(auto, expected)


@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_prefill_then_decode_matches_jax(pair, impl):
    """Prefill fills the latent cache; two absorbed decode steps follow,
    the rows at different lengths."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(3, (3, 20), cfg.vocab_size)
    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                               max_seq=MAX_SEQ, impl=REFERENCE_IMPL[impl])
    last, cache = model.prefill(toks, max_seq=MAX_SEQ, impl=impl)
    _scaled_close(last, jlast)
    assert [sorted(c) for c in cache] == [["c", "k_rope"]] * cfg.n_layers
    lengths = np.array([20, 11, 3], np.int32)
    new = _tokens(4, (3,), cfg.vocab_size)
    for step in range(2):
        expected, jcache = jm.decode_step(
            jp, jcache, jnp.asarray(new), jnp.asarray(lengths + step),
            impl=REFERENCE_IMPL[impl])
        logits, out = model.decode_step(
            cache, new, torch.from_numpy(lengths + step), impl=impl)
        assert out is cache
        _scaled_close(logits, expected)
    for i, layer in enumerate(cache):
        for name in ("c", "k_rope"):
            _scaled_close(layer[name], jcache["blocks"][0][name][i])


@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_bucketed_prefill_chunks_match_jax(pair, impl):
    """Chunks of 13 and 5 real tokens padded to buckets of 16 and 8, as the
    engine pads them, logits at ``last_pos``; each chunk expands the whole
    latent cache, as the reference's engine path does."""
    jm, jp, model, cfg, _ = pair
    toks = _tokens(2, (1, 18), cfg.vocab_size)
    jcache = jm.zero_cache(1, MAX_SEQ, use_ring=False)
    cache = model.zero_cache(1, MAX_SEQ, use_ring=False)
    start = 0
    for n, bucket in ((13, 16), (5, 8)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = toks[0, start:start + n]
        lens, last = np.array([start], np.int32), np.array([n - 1], np.int32)
        expected, jcache = jm.prefill_chunk(
            jp, jcache, jnp.asarray(ids), jnp.asarray(lens),
            impl=REFERENCE_IMPL[impl], last_pos=jnp.asarray(last))
        logits, _ = model.prefill_chunk(
            cache, ids, torch.from_numpy(lens), impl=impl,
            last_pos=torch.from_numpy(last))
        _scaled_close(logits, expected)
        start += n


# ---------------------------------------------------------------------------
# the mla_attn execution context against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_mla_context_matches_jax(pair, phase, backend):
    """The reference builds ``mla_attn`` for a ``self_attn`` entry of an MLA
    config; the port does too.  Inputs: random activations and caches,
    positions 0..toks-1, lengths at the last cached row."""
    _, jp, model, cfg, jcfg = pair
    toks, reqs, ctx = (12, 2, 0) if phase == "prefill" else (1, 3, 24)
    jmc = jax_build_context(jcfg, "self_attn", phase=phase, backend="xla")
    mc = build_context(cfg, "self_attn", phase=phase, backend=backend,
                       device="cpu")
    assert mc.kind == jmc.kind == "mla_attn"
    assert mc.static_attrs == jmc.static_attrs
    specs = mc.abstract_inputs(toks, reqs, ctx)
    jspecs = jmc.abstract_inputs(toks, reqs, ctx)
    assert [(tuple(s.shape), str(s.dtype).split(".")[-1]) for s in specs] == \
        [(tuple(s.shape), str(s.dtype)) for s in jspecs]
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal(s.shape, dtype=np.float32)
              if s.dtype.is_floating_point else None for s in specs]
    if phase == "prefill":
        arrays[1] = np.broadcast_to(np.arange(toks, dtype=np.int32),
                                    (reqs, toks)).copy()
    else:
        arrays[3] = np.array([23, 5, 0], np.int32)
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"])
    expected = jmc.fn(jparams, *[jnp.asarray(a) for a in arrays])
    weights = {k[len("layers.0.mla_attn."):]: v
               for k, v in model.state_dict().items()
               if k.startswith("layers.0.mla_attn.")}
    assert {k: (tuple(v.shape), v.dtype) for k, v in weights.items()} == \
        {k: (tuple(s.shape), s.dtype) for k, s in mc.params.items()}
    out = mc.fn(mc.module(weights), *[torch.from_numpy(a) for a in arrays])
    _scaled_close(out, expected)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine(pair):
    """The same schedule on the latent cache, every request served to its
    length, and every layer's ``c`` and ``k_rope`` rows as the JAX
    engine's."""
    _, jp, model, cfg, jcfg = pair
    sched = dict(max_num_seqs=3, max_batch_tokens=48, chunk_size=16)
    specs = [(30, 4), (9, 3), (21, 2), (12, 3)]

    def requests(module):
        rng = np.random.default_rng(0)
        return [module.Request(i, 0.0, rng.integers(0, cfg.vocab_size, p).tolist(),
                               o) for i, (p, o) in enumerate(specs)]
    jeng = JaxEngine(jcfg, sched_config=jax_scheduler.SchedulerConfig(**sched),
                     max_seq=MAX_SEQ, params=jp, impl="xla")
    jeng.run(requests(jax_scheduler))
    eng = Engine(cfg, sched_config=SchedulerConfig(**sched), max_seq=MAX_SEQ,
                 params=model.state_dict(), impl="kernel", device="cpu")
    reqs = requests(port_scheduler)
    eng.run(reqs)
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert all(r.done and r.generated == o for r, (_, o) in zip(reqs, specs))
    for i, layer in enumerate(eng.cache):
        assert sorted(layer) == ["c", "k_rope"]
        for name in ("c", "k_rope"):
            _scaled_close(layer[name], jeng.cache["blocks"][0][name][i])


# ---------------------------------------------------------------------------
# on a card: the module in a CUDA graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_mla_captures_in_a_cuda_graph(cuda):
    """Absorbed decode and chunked prefill of one float32 MLA layer replay
    from a CUDA graph bit for bit as their eager calls (TF32 stays off, as
    the float32 parity above needs)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config(ARCH)
    layer = mla.MLA(cfg, device=cuda, dtype=torch.float32,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device=cuda)
    chunk = torch.randn((1, 16, cfg.d_model), generator=gen, device=cuda)
    fresh = mla.init_mla_cache(cfg, 4, 64, device=cuda, dtype=torch.float32)
    for t in fresh.values():
        t.normal_(generator=gen)
    lengths = torch.tensor([5, 40, 0, 63], dtype=torch.int32, device=cuda)
    from repro_torch.models.transformer import _write_chunk

    def decode(cache):
        return mla.mla_decode(layer, x, cache, lengths=lengths)

    def prefill(cache):
        row = {k: v[1:2] for k, v in cache.items()}
        return mla.mla_prefill_chunk(layer, chunk, row, lengths=lengths[:1],
                                     write_chunk=_write_chunk)
    with torch.no_grad():
        for step in (decode, prefill):
            eager_cache = {k: v.clone() for k, v in fresh.items()}
            eager = step(eager_cache)
            graph_cache = {k: v.clone() for k, v in fresh.items()}
            step({k: v.clone() for k, v in fresh.items()})      # warm-up
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = step(graph_cache)
            for k in graph_cache:
                graph_cache[k].copy_(fresh[k])
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
            assert all(torch.equal(graph_cache[k], eager_cache[k])
                       for k in fresh)
