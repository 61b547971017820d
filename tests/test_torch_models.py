"""The port's llama3 model against the JAX package's ``Model`` on the same
parameters and tokens (``llama3-smoke``, float32, CPU).

Tolerance 1e-4 (absolute and relative): the two frameworks sum matmuls in
different orders, and the JAX package's own ``pallas``-vs-``xla`` logits
already differ by about 4e-5 on this configuration.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import get_config as jax_config
from repro.configs.base import model_config_taint_values as jax_taint_values
from repro.models import build_model
from repro.models.transformer import _write_chunk as jax_write_chunk
from repro_torch.configs import (get_config, get_smoke_config,
                                 model_config_taint_values)
from repro_torch.models import Model, params_from_jax
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.models.transformer import _write_chunk

torch.set_num_threads(2)

TOL = 1e-4
MAX_SEQ = 64


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model on the same params, cfg)."""
    cfg = get_smoke_config("llama3-8b")
    jm = build_model(jax_smoke_config("llama3-8b"))
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg


def _close(port, expected, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(expected),
                               atol=tol, rtol=tol)


def _close_cache(port_cache, jax_cache):
    """Caches agree within 1e-4 of their largest entry: K reaches about 30
    here, so rounding in the residual stream shows up as absolute error on
    small entries."""
    for i, layer in enumerate(port_cache):
        for name in ("k", "v"):
            expected = np.asarray(jax_cache["blocks"][0][name][i])
            scale = float(np.abs(expected).max())
            np.testing.assert_allclose(layer[name].float().numpy() / scale,
                                       expected / scale, atol=TOL)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke, arch):
    port = get_smoke_config(arch) if smoke else get_config(arch)
    ref = jax_smoke_config(arch) if smoke else jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.param_count() == ref.param_count()
    assert model_config_taint_values(port) == jax_taint_values(ref)


def test_module_names_follow_the_trace_scopes(pair):
    _, jp, model, cfg = pair
    names = dict(model.named_modules())
    for i in range(cfg.n_layers):
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            assert f"layers.{i}.self_attn.{proj}" in names
    state = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert sorted(state) == sorted(model.state_dict())
    assert model.final_norm.scale.dtype == torch.float32


def test_reference_impl_map():
    assert REFERENCE_IMPL == {"xla": "xla", "chunked": "chunked",
                              "chunked_naive": "chunked_naive",
                              "kernel": "pallas"}


# ---------------------------------------------------------------------------
# forward, prefill, chunked prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked_naive"])
def test_forward_matches_jax(pair, impl):
    jm, jp, model, cfg = pair
    toks = _tokens(0, (2, 40), cfg.vocab_size)
    expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                             impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        _close(model(toks, impl=impl)[0], expected)


def test_auto_backend_above_2048_tokens_runs_chunked(pair):
    """Above 2048 tokens ``auto`` picks the ``chunked`` backend, as the
    reference does, and the logits match the JAX model's ``auto``.

    The JAX model runs op by op here: compiled, XLA's fused sin and cos on
    the CPU are off by 2.2e-4 at positions near 2048 (against its own
    op-by-op RoPE and the port's), which grows to 1e-2 in the logits.  Over
    2049 positions the float32 sums of the two frameworks still part by
    2.4e-4 of logits that reach 4, so the logits are held within 1e-4 of
    the largest one."""
    jm, jp, model, cfg = pair
    toks = _tokens(8, (1, 2049), cfg.vocab_size)
    with jax.disable_jit():
        expected, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl="auto")
    with torch.no_grad():
        auto = model(toks, impl="auto")[0]
        assert torch.equal(auto, model(toks, impl="chunked")[0])
    expected = np.asarray(expected)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(auto.numpy() / scale, expected / scale, atol=TOL)


def test_prefill_matches_jax(pair):
    jm, jp, model, cfg = pair
    toks = _tokens(1, (2, 24), cfg.vocab_size)
    expected, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                  max_seq=MAX_SEQ, impl="pallas")
    logits, cache = model.prefill(toks, max_seq=MAX_SEQ, impl="kernel")
    _close(logits, expected)
    _close_cache(cache, jcache)


def test_bucketed_prefill_chunks_match_jax(pair):
    """Two chunks of 13 and 5 real tokens, padded to buckets of 16 and 8 as
    the engine pads them, with logits taken at ``last_pos``."""
    jm, jp, model, cfg = pair
    toks = _tokens(2, (1, 18), cfg.vocab_size)
    jcache = jm.zero_cache(1, MAX_SEQ, use_ring=False)
    cache = model.zero_cache(1, MAX_SEQ, use_ring=False)
    start = 0
    for n, bucket in ((13, 16), (5, 8)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = toks[0, start:start + n]
        lens, last = np.array([start], np.int32), np.array([n - 1], np.int32)
        expected, jcache = jm.prefill_chunk(
            jp, jcache, jnp.asarray(ids), jnp.asarray(lens), impl="xla",
            last_pos=jnp.asarray(last))
        logits, cache = model.prefill_chunk(
            cache, ids, torch.from_numpy(lens), impl="kernel",
            last_pos=torch.from_numpy(last))
        _close(logits, expected)
        start += n
    _close_cache(cache, jcache)


@pytest.mark.parametrize("impl,shards", [("kernel", 1), ("xla", 1),
                                         ("chunked_naive", 1), ("kernel", 4)])
def test_decode_step_matches_jax(pair, impl, shards):
    jm, jp, model, cfg = pair
    toks = _tokens(3, (3, 20), cfg.vocab_size)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=MAX_SEQ,
                           impl="xla")
    _, cache = model.prefill(toks, max_seq=MAX_SEQ, impl="xla")
    lengths = np.array([20, 11, 3], np.int32)   # rows at different positions
    new = _tokens(4, (3,), cfg.vocab_size)
    for step in range(2):
        expected, jcache = jm.decode_step(
            jp, jcache, jnp.asarray(new), jnp.asarray(lengths + step),
            impl=REFERENCE_IMPL[impl], kv_seq_shards=shards)
        logits, cache = model.decode_step(
            cache, new, torch.from_numpy(lengths + step), impl=impl,
            kv_seq_shards=shards)
        _close(logits, expected)
    _close_cache(cache, jcache)


# ---------------------------------------------------------------------------
# cache writes past the end of the cache
# ---------------------------------------------------------------------------

def test_write_chunk_drops_rows_past_max_seq_like_jax():
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((2, 10, 2, 4), dtype=np.float32)
    new = rng.standard_normal((2, 8, 2, 4), dtype=np.float32)
    lengths = np.array([6, 1], np.int32)        # row 0's bucket crosses 10
    expected = jax_write_chunk(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(lengths))
    out = _write_chunk(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(expected))


@pytest.mark.parametrize("lengths,c", [([9, 3], 4), ([10, 12], 3), ([0, 2], 12),
                                       ([7, 0], 3)])
def test_write_chunk_without_a_host_sync_matches_jax(lengths, c):
    """Dropped rows go to the last slot with the value it ends with, so the
    write keeps static shapes: a chunk that lands on the last slot, one
    wholly past the end, one longer than the cache, one inside it."""
    rng = np.random.default_rng(len(lengths) + c + lengths[0])
    cache = rng.standard_normal((2, 10, 2, 4), dtype=np.float32)
    new = rng.standard_normal((2, c, 2, 4), dtype=np.float32)
    lengths = np.array(lengths, np.int32)
    expected = jax_write_chunk(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(lengths))
    out = _write_chunk(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(expected))
