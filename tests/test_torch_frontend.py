"""The port's stub frontends — internvl2-26b (a VLM backbone) and
llama4-maverick-400b-a17b (MoE with early-fusion vision) — against the JAX
package's, on the same parameters, tokens and frames (``internvl2-smoke``,
``llama4-maverick-smoke``, float32, CPU).

A frontend's frames (B, F, d_model) are prepended to the token embeddings
in the weightless ``frontend`` module (the reference's ``frontend`` scope),
and ``forward`` drops their logits; the engine serves text only, as the
reference's.  Frames are normal * 0.02, the scale the reference's
``ModuleContext.materialize`` gives a module's activations.

Tolerances: logits and caches within 1e-4 of their largest entry, as
tests/test_torch_models.py holds llama3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving import scheduler as jax_scheduler
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, params_from_jax
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ARCHS = ["internvl2-26b", "llama4-maverick-400b-a17b"]
TOL = 1e-4
MAX_SEQ = 64


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model on the same params, cfg)."""
    arch = request.param
    cfg = get_smoke_config(arch)
    jm = build_model(jax_smoke_config(arch))
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg


def _scaled_close(port, expected, tol=TOL):
    """Within ``tol`` of the largest entry of ``expected``."""
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-30
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=tol)


def _inputs(seed, cfg, batch, n_tokens):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, n_tokens)).astype(np.int32)
    frames = 0.02 * rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model))
    return toks, frames.astype(np.float32)


def _close_cache(cache, jcache):
    """Each attention layer's K/V: layer i is the reference's period
    position i % p, stacked entry i // p."""
    p = len(jcache["blocks"])
    for i, layer in enumerate(cache):
        for name in ("k", "v"):
            _scaled_close(layer[name], jcache["blocks"][i % p][name][i // p])


def test_frontend_is_a_weightless_module(pair):
    _, jp, model, cfg = pair
    names = dict(model.named_modules())
    assert "frontend" in names and not list(model.frontend.parameters())
    assert "enc_layers" not in names and not hasattr(model.layers[0], "cross_attn")
    state = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert sorted(state) == sorted(model.state_dict())


@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_forward_with_frames_matches_jax(pair, impl):
    """The frames' logits are cut: (B, S, V) for S tokens."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(0, cfg, 2, 12)
    expected, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)},
                                impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        logits, aux = model(toks, frames=frames, impl=impl)
    assert logits.shape == (2, 12, cfg.vocab_size)
    _scaled_close(logits, expected)
    for k in aux:
        _scaled_close(torch.as_tensor(aux[k]), jaux[k])


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_with_frames_and_decode_match_jax(pair, impl):
    """The frames take the first cache rows; decode continues after them."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(1, cfg, 2, 10)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    expected, jcache = jm.prefill(jp, batch, max_seq=MAX_SEQ,
                                  impl=REFERENCE_IMPL[impl])
    logits, cache = model.prefill(toks, frames=frames, max_seq=MAX_SEQ,
                                  impl=impl)
    _scaled_close(logits, expected)
    _close_cache(cache, jcache)
    n = cfg.n_frontend_tokens + toks.shape[1]
    assert cache[0]["k"][:, n:].abs().sum() == 0 and cache[0]["k"][:, n - 1].any()
    lengths, new = np.array([n, n - 3], np.int32), np.array([5, 9], np.int32)
    expected, jcache = jm.decode_step(jp, jcache, jnp.asarray(new),
                                      jnp.asarray(lengths), impl=REFERENCE_IMPL[impl])
    logits, cache = model.decode_step(cache, new, torch.from_numpy(lengths),
                                      impl=impl)
    _scaled_close(logits, expected)
    _close_cache(cache, jcache)


def test_engine_serves_text_only_like_the_jax_engine(pair):
    """The engine feeds tokens alone, as the reference's: the same chunks,
    decodes and final caches."""
    jm, jp, model, cfg = pair
    sched = dict(max_num_seqs=3, max_batch_tokens=48, chunk_size=16)
    specs = [(30, 3), (9, 2), (21, 2)]

    def requests(module):
        rng = np.random.default_rng(0)
        return [module.Request(i, 0.0, rng.integers(0, cfg.vocab_size, p).tolist(),
                               o) for i, (p, o) in enumerate(specs)]
    jeng = JaxEngine(jm.cfg, sched_config=jax_scheduler.SchedulerConfig(**sched),
                     max_seq=MAX_SEQ, params=jp, impl="xla")
    jeng.run(requests(jax_scheduler))
    eng = Engine(cfg, sched_config=SchedulerConfig(**sched), max_seq=MAX_SEQ,
                 params=model.state_dict(), impl="kernel", device="cpu")
    reqs = requests(port_scheduler)
    eng.run(reqs)
    assert [(r.chunks, r.n_decodes) for r in eng.records] == \
        [(r.chunks, r.n_decodes) for r in jeng.records]
    assert all(r.done and r.generated == o for r, (_, o) in zip(reqs, specs))
    _close_cache(eng.cache, jeng.cache)
