"""The port's encoder-decoder family — the encoder, cross-attention blocks,
their caches and the ``cross_attn`` context, seamless-m4t-large-v2 — against
the JAX package's, on the same parameters and inputs (``seamless-smoke``: 2
encoder and 2 decoder layers, MHA 4/4/24, float32, CPU), and the port's
registry against the reference's twelve-model corpus.

Tolerances: 1e-4 of the largest entry, as tests/test_torch_models.py holds
llama3's logits, beyond the reference's own float32 rounding: this
configuration is ill-conditioned enough that the JAX package's float32
logits and caches are up to 1.4e-4 of the largest entry from its own
float64 run of the same weights and inputs, so each model output is held
as |port - jax| <= 1e-4 + |jax - exact| (``_held``), the exact values from
the JAX package's model in float64 (its ``xla`` path; its rmsnorm and
rotary still round through float32, as written).  A planted fault in the
port's decoder (``ln_x`` skipped, the memory's values projected by
``k_proj``) fails that hold.  The encoder and the ``cross_attn`` context
are held within 1e-4 of their largest entry.  Frames are normal * 0.02, the
scale the reference's ``ModuleContext.materialize`` gives a module's
activations (at unit-normal frames the JAX package's compiled logits are
8.7e-4 from its own op-by-op ones).  Tests marked ``gpu`` run
seamless-smoke's prefill and decode steps on a card against the CPU
(float32, logits within 1e-4 of the largest: the card sums its matmuls in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.serving.context import build_context as jax_build_context
from repro.serving.context import phases_for as jax_phases_for
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import Model, params_from_jax
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig, build_context, phases_for

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4
MAX_SEQ = 48
IMPLS = ["xla", "kernel", "chunked"]


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model on the same params, cfg)."""
    cfg = get_smoke_config(ARCH)
    jm = build_model(jax_smoke_config(ARCH))
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg


def _f64(a):
    a = np.asarray(a)
    return jnp.asarray(a, jnp.float64 if a.dtype.kind == "f" else a.dtype)


@pytest.fixture(scope="module")
def exact(pair):
    """``run(method, *args, **kw)``: the JAX package's model on the same
    weights in float64 through its ``xla`` path, as numpy arrays."""
    jm, jp, *_ = pair
    with jax.enable_x64(True):
        jm64 = build_model(jax_smoke_config(ARCH).with_overrides(dtype="float64"))
        jp64 = jax.tree.map(_f64, jp)

    def run(method, *args, **kw):
        with jax.enable_x64(True):
            out = getattr(jm64, method)(jp64, *jax.tree.map(_f64, args),
                                        impl="xla", **kw)
            return jax.tree.map(np.asarray, out)
    return run


def _scaled_close(port, expected, tol=TOL):
    """Within ``tol`` of the largest entry of ``expected``."""
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-30
    np.testing.assert_allclose(port.float().numpy() / scale, expected / scale,
                               atol=tol)


def _held(port, expected, exact):
    """|port - jax| within 1e-4 of the largest exact entry beyond the
    reference's own distance from its float64 values ``exact``."""
    expected = np.asarray(expected, np.float64)
    exact = np.asarray(exact, np.float64)
    scale = float(np.abs(exact).max()) + 1e-30
    own = float(np.abs(expected - exact).max()) / scale
    err = float(np.abs(port.double().numpy() - expected).max()) / scale
    assert err <= TOL + own, (err, own)


def _inputs(seed, cfg, batch, n_tokens, n_frames):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, n_tokens)).astype(np.int32)
    frames = 0.02 * rng.standard_normal((batch, n_frames, cfg.d_model))
    return toks, frames.astype(np.float32)


def _close_cache(cache, jcache, exact_cache):
    """Every decoder layer's self-attention cache and encoder memory."""
    for i, layer in enumerate(cache):
        for name in ("k", "v", "enc_k", "enc_v"):
            _held(layer[name], jcache["blocks"][0][name][i],
                  exact_cache["blocks"][0][name][i])


# ---------------------------------------------------------------------------
# the registry: the reference's twelve-model corpus
# ---------------------------------------------------------------------------

def test_registry_is_the_reference_corpus():
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.CORPUS_ARCHS == jconfigs.CORPUS_ARCHS
    port, ref = configs.all_configs(), jconfigs.all_configs()
    assert list(port) == list(ref)
    assert all(dataclasses.asdict(port[n]) == dataclasses.asdict(ref[n])
               for n in ref)


# ---------------------------------------------------------------------------
# parameters and module names
# ---------------------------------------------------------------------------

def test_module_names_follow_the_trace_scopes(pair):
    """The encoder's blocks are ``enc_layers.{i}``; a decoder block holds
    ``cross_attn`` (q and o) and, in the layer's own scope as the
    reference's ``compute_kv``, the memory's ``k_proj`` and ``v_proj``."""
    _, jp, model, cfg = pair
    names = dict(model.named_modules())
    for i in range(cfg.n_enc_layers):
        assert f"enc_layers.{i}.self_attn" in names
        assert f"enc_layers.{i}.cross_attn" not in names
    for i in range(cfg.n_layers):
        for name in ("self_attn", "ln_x", "cross_attn.q_proj",
                     "cross_attn.o_proj", "k_proj", "v_proj"):
            assert f"layers.{i}.{name}" in names
        assert not hasattr(model.layers[i].cross_attn, "k_proj")
    assert "frontend" not in names and "enc_norm" in names
    state = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert sorted(state) == sorted(model.state_dict())


# ---------------------------------------------------------------------------
# encoder, forward, prefill, chunked prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(pair, impl):
    """The encoder's blocks run non-causally."""
    jm, jp, model, cfg = pair
    _, frames = _inputs(0, cfg, 2, 1, cfg.n_frontend_tokens)
    expected = jm.encode(jp, jnp.asarray(frames), impl=REFERENCE_IMPL[impl])
    _scaled_close(model.encode(frames, impl=impl), expected)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(pair, exact, impl):
    jm, jp, model, cfg = pair
    toks, frames = _inputs(1, cfg, 2, 12, cfg.n_frontend_tokens)
    expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)},
                             impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        logits, aux = model(toks, frames=frames, impl=impl)
    ex, _ = exact("forward", {"tokens": toks, "frames": frames})
    assert logits.shape == (2, 12, cfg.vocab_size)
    _held(logits, expected, ex)


def test_forward_needs_frames(pair):
    *_, model, cfg = pair
    with pytest.raises(ValueError, match="frames"):
        model(np.zeros((1, 4), np.int32), impl="xla")


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_matches_jax(pair, exact, impl):
    """Last logits, the decoder's K/V and the encoder memory of each layer."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(2, cfg, 2, 10, 13)
    expected, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                       "frames": jnp.asarray(frames)},
                                  max_seq=MAX_SEQ, impl=REFERENCE_IMPL[impl])
    logits, cache = model.prefill(toks, frames=frames, max_seq=MAX_SEQ,
                                  impl=impl)
    ex, ecache = exact("prefill", {"tokens": toks, "frames": frames},
                       max_seq=MAX_SEQ)
    _held(logits, expected, ex)
    assert cache[0]["enc_k"].shape == (2, 13, cfg.n_kv_heads,
                                       cfg.resolved_head_dim)
    _close_cache(cache, jcache, ecache)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefill_chunk_matches_jax(pair, exact, impl):
    """A prompt prefilled with its frames, then a chunk of 7 tokens
    padded to a bucket of 8 against the cache and the encoder memory."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(3, cfg, 2, 9, 11)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(frames)},
                           max_seq=MAX_SEQ, impl="xla")
    _, cache = model.prefill(toks, frames=frames, max_seq=MAX_SEQ, impl="xla")
    _, ecache = exact("prefill", {"tokens": toks, "frames": frames},
                      max_seq=MAX_SEQ)
    chunk = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)
                                              ).astype(np.int32)
    lens, last = np.array([9, 9], np.int32), np.array([6, 6], np.int32)
    expected, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(chunk),
                                        jnp.asarray(lens), impl=REFERENCE_IMPL[impl],
                                        last_pos=jnp.asarray(last))
    logits, cache = model.prefill_chunk(cache, chunk, torch.from_numpy(lens),
                                        impl=impl, last_pos=torch.from_numpy(last))
    ex, ecache = exact("prefill_chunk", ecache, chunk, lens, last_pos=last)
    _held(logits, expected, ex)
    _close_cache(cache, jcache, ecache)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_jax(pair, exact, impl):
    """Two decode steps of rows at different positions, each query row
    attending its request's whole encoder memory."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(5, cfg, 3, 8, cfg.n_frontend_tokens)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(frames)},
                           max_seq=MAX_SEQ, impl="xla")
    _, cache = model.prefill(toks, frames=frames, max_seq=MAX_SEQ, impl="xla")
    _, ecache = exact("prefill", {"tokens": toks, "frames": frames},
                      max_seq=MAX_SEQ)
    lengths = np.array([8, 5, 2], np.int32)
    new = np.array([3, 17, 40], np.int32)
    for step in range(2):
        expected, jcache = jm.decode_step(jp, jcache, jnp.asarray(new),
                                          jnp.asarray(lengths + step),
                                          impl=REFERENCE_IMPL[impl])
        logits, cache = model.decode_step(cache, new,
                                          torch.from_numpy(lengths + step),
                                          impl=impl)
        ex, ecache = exact("decode_step", ecache, new, lengths + step)
        _held(logits, expected, ex)
    _close_cache(cache, jcache, ecache)


def _skip_ln_x(block, monkeypatch):
    monkeypatch.setattr(block.ln_x, "forward", lambda x: x)


def _values_by_k_proj(block, monkeypatch):
    monkeypatch.setattr(block.v_proj, "forward", block.k_proj.forward)


@pytest.mark.parametrize("fault", [_skip_ln_x, _values_by_k_proj])
def test_held_catches_a_planted_decoder_fault(pair, exact, monkeypatch, fault):
    """The hold the parity tests use fails once the port's decoder blocks
    carry a fault: the limit comes from the reference alone."""
    jm, jp, model, cfg = pair
    toks, frames = _inputs(1, cfg, 2, 12, cfg.n_frontend_tokens)
    expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(frames)}, impl="xla")
    ex, _ = exact("forward", {"tokens": toks, "frames": frames})
    for block in model.layers:
        fault(block, monkeypatch)
    with torch.no_grad():
        logits, _ = model(toks, frames=frames, impl="xla")
    with pytest.raises(AssertionError):
        _held(logits, expected, ex)


def test_zero_cache_holds_the_encoder_memory_like_jax(pair):
    jm, _, model, cfg = pair
    jcache = jm.zero_cache(3, MAX_SEQ, 7, use_ring=False)
    cache = model.zero_cache(3, MAX_SEQ, enc_len=7, use_ring=False)
    for i, layer in enumerate(cache):
        assert sorted(layer) == sorted(jcache["blocks"][0])
        for name, t in layer.items():
            assert tuple(t.shape) == jcache["blocks"][0][name].shape[1:]
            assert not t.any()


def test_engine_refuses_encdec_like_the_reference():
    """The engine serves decoder-only archs, as the reference's."""
    with pytest.raises(NotImplementedError, match="enc-dec"):
        JaxEngine(jax_smoke_config(ARCH), sched_config=JaxSchedulerConfig(),
                  max_seq=MAX_SEQ)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        Engine(get_smoke_config(ARCH), sched_config=SchedulerConfig(),
               max_seq=MAX_SEQ, device="cpu")


# ---------------------------------------------------------------------------
# the cross_attn context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("ctx", [5, 40])
def test_cross_attn_context_matches_jax(phase, impl, ctx):
    """q_len = toks rows in prefill and 1 in decode against ctx memory
    rows, every key attended; the same static attributes and phases."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jmc = jax_build_context(jcfg, "cross_attn", phase=phase,
                            backend=REFERENCE_IMPL[impl])
    mc = build_context(cfg, "cross_attn", phase=phase, backend=impl,
                       device="cpu")
    assert mc.static_attrs == jmc.static_attrs
    assert mc.static_attrs["causal"] is False
    assert phases_for("cross_attn", cfg) == jax_phases_for("cross_attn", jcfg)
    specs = jmc.abstract_inputs(7, 2, ctx)
    assert [tuple(s.shape) for s in mc.abstract_inputs(7, 2, ctx)] == \
        [tuple(s.shape) for s in specs]
    rng = np.random.default_rng(ctx)
    inputs = [rng.standard_normal(s.shape).astype(np.float32) for s in specs]
    jparams = jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        jmc.params)
    expected = jmc.fn(jparams, *map(jnp.asarray, inputs))
    module = mc.module({"q_proj.w": torch.from_numpy(jparams["q"]["w"]),
                        "o_proj.w": torch.from_numpy(jparams["o"]["w"])})
    _scaled_close(mc.fn(module, *map(torch.from_numpy, inputs)), expected)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_cross_attn_at_an_empty_memory_gives_zeros(phase):
    """Pinned reference behaviour (ROADMAP Queue 3 item 12): at ctx = 0 the
    reference's ``xla`` path gives o_proj of zeros while its ``chunked``
    and ``pallas`` paths raise; the port's ``kernel`` path gives the zeros
    too (its flash forward runs zero key tiles), and ``chunked`` raises."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jmc = jax_build_context(jcfg, "cross_attn", phase=phase, backend="xla")
    specs = jmc.abstract_inputs(7, 2, 0)
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(s.shape).astype(np.float32) for s in specs]
    jparams = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                           jmc.params)
    expected = np.asarray(jmc.fn(jparams, *map(jnp.asarray, inputs)))
    assert not expected.any()
    weights = {"q_proj.w": torch.from_numpy(jparams["q"]["w"]),
               "o_proj.w": torch.from_numpy(jparams["o"]["w"])}
    for impl in ("xla", "kernel"):
        mc = build_context(cfg, "cross_attn", phase=phase, backend=impl,
                           device="cpu")
        out = mc.fn(mc.module(weights), *map(torch.from_numpy, inputs))
        assert out.shape == expected.shape and not out.any()
    with pytest.raises(ZeroDivisionError):
        jax_build_context(jcfg, "cross_attn", phase=phase, backend="chunked"
                          ).fn(jparams, *map(jnp.asarray, inputs))
    mc = build_context(cfg, "cross_attn", phase=phase, backend="chunked",
                       device="cpu")
    with pytest.raises(ZeroDivisionError):
        mc.fn(mc.module(weights), *map(torch.from_numpy, inputs))


@pytest.mark.parametrize("sq", [1, 9])
def test_flash_plain_at_an_empty_memory(sq):
    """Zero keys: out zeros, lse that of a fully masked row."""
    q = torch.randn((2, sq, 4, 32))
    k = torch.zeros((2, 0, 2, 32))
    out, lse = fa.flash_attention_fwd_plain(q, k, k, causal=False)
    assert out.shape == q.shape and not out.any()
    expected = torch.tensor(fa.NEG_INF) + torch.log(torch.tensor(1e-20))
    assert lse.shape == (2, 4, sq) and torch.equal(lse, expected.expand(2, 4, sq))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_decode_step_matches_the_cpu(cuda):
    """seamless-smoke's prefill and two decode steps on the card (the flash
    forward in the encoder, non-causal, and in cross-attention at Sq = 1;
    the decode kernel at G = 1) against the same steps on the CPU, at head
    dim 32: the flash kernel takes D in (32, 64, 128), and the smoke
    config's 24 is none of them."""
    cfg = get_smoke_config(ARCH).with_overrides(head_dim=32)
    model = Model(cfg, device="cpu").requires_grad_(False)
    card = Model(cfg, device=cuda).requires_grad_(False)
    card.load_state_dict(model.state_dict())
    toks, frames = _inputs(6, cfg, 3, 8, cfg.n_frontend_tokens)
    lengths = torch.tensor([8, 5, 2], dtype=torch.int32)
    new = np.array([3, 17, 40], np.int32)
    _, cache = model.prefill(toks, frames=frames, max_seq=MAX_SEQ, impl="kernel")
    _, gcache = card.prefill(toks, frames=frames, max_seq=MAX_SEQ, impl="kernel")
    for step in range(2):
        expected, cache = model.decode_step(cache, new, lengths + step,
                                            impl="kernel")
        logits, gcache = card.decode_step(gcache, new, (lengths + step).to(cuda),
                                          impl="kernel")
        torch.cuda.synchronize()
        _scaled_close(logits.cpu(), expected.numpy())
