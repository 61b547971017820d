"""The port's MoE family — ``models/moe.py``, the ``moe`` block and context,
olmoe-1b-7b — against the JAX package's, on the same parameters and inputs:
``olmoe-smoke`` (3 MoE layers, 8 experts top-2, float32, CPU) and
``llama4-maverick-smoke`` (MoE on every other layer, ``moe_interleave=2``,
one shared expert, top-1), here without frames: its vision frontend is held
in tests/test_torch_frontend.py.

Tolerances: logits within 1e-4 of the largest logit, as
tests/test_torch_dense.py holds the dense family; the MoE outputs and aux
losses within 1e-4 of their largest entry (the router's z-loss reaches 240
on random weights).  The tokens dropped past an expert's capacity are the
same in both packages.  Tests marked ``gpu`` hold the dropping path in a
CUDA graph against its eager calls, and the decode kernel at olmoe's GQA
group of 1, on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import moe as jmoe
from repro.serving import scheduler as jax_scheduler
from repro.serving.context import build_context as jax_build_context
from repro.serving.context import phases_for as jax_phases_for
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention as da
from repro_torch.models import Model, params_from_jax
from repro_torch.models import moe
from repro_torch.models.attention import REFERENCE_IMPL
from repro_torch.serving import Engine, SchedulerConfig, build_context, phases_for
from repro_torch.serving import scheduler as port_scheduler

torch.set_num_threads(2)

ARCH = "olmoe-1b-7b"
LLAMA4 = "llama4-maverick-400b-a17b"
TOL = 1e-4
MAX_SEQ = 64


def _pair(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, model.requires_grad_(False), cfg, jcfg


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


@pytest.fixture(scope="module")
def llama4():
    return _pair(LLAMA4)


def _scaled_close(port, expected, tol=TOL):
    """Within ``tol`` of the largest entry of ``expected``."""
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-30
    np.testing.assert_allclose(np.asarray(port.float().numpy()
                                          if isinstance(port, torch.Tensor)
                                          else port, np.float32) / scale,
                               expected / scale, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _layer(pair_, i):
    """(jax params, port module) of layer ``i``'s MoE FFN."""
    jm, jp, model, cfg, _ = pair_
    p = len(jp["blocks"])
    jparams = jax.tree.map(lambda a: a[i // p], jp["blocks"][i % p]["ffn"])
    return jparams, model.layers[i].moe


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, LLAMA4])
def test_params_and_module_names_follow_the_reference(pair, llama4, arch):
    jm, jp, model, cfg, _ = pair if arch == ARCH else llama4
    names = dict(model.named_modules())
    for i, kind in enumerate(cfg.layer_kinds()):
        assert (f"layers.{i}.moe" in names) == (kind == "moe")
        assert (f"layers.{i}.mlp" in names) == (kind != "moe")
        if kind == "moe":
            m = model.layers[i].moe
            assert m.router.w.dtype == torch.float32
            assert tuple(m.up.shape) == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
            assert hasattr(m, "shared") == (cfg.n_shared_experts > 0)
    assert sorted(params_from_jax(jax.tree.map(np.asarray, jp), cfg)) == \
        sorted(model.state_dict())
    if arch == LLAMA4:
        assert cfg.layer_kinds() == ("dense", "moe") * 2 and len(jp["blocks"]) == 2


def test_router_stays_float32_in_a_bf16_model():
    cfg = get_smoke_config(ARCH).with_overrides(dtype="bfloat16")
    model = Model(cfg, device="meta", generator=torch.Generator())
    assert model.layers[0].moe.router.w.dtype == torch.float32
    assert model.layers[0].moe.up.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the MoE FFN against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, LLAMA4])
@pytest.mark.parametrize("impl", ["dropping", "ragged"])
def test_moe_ffn_matches_jax(pair, llama4, arch, impl):
    pair_ = pair if arch == ARCH else llama4
    cfg = pair_[3]
    i = cfg.layer_kinds().index("moe")
    jparams, m = _layer(pair_, i)
    x = np.random.default_rng(5).standard_normal((2, 24, cfg.d_model),
                                                 dtype=np.float32)
    expected, jaux = jmoe.moe_ffn(jparams, jnp.asarray(x), pair_[4], impl=impl)
    with torch.no_grad():
        out, aux = moe.moe_ffn(m, torch.from_numpy(x), impl=impl)
    _scaled_close(out, expected)
    assert sorted(aux) == sorted(jaux) == ["load_balance", "router_z"]
    for k in aux:
        _scaled_close(aux[k], jaux[k])


def test_moe_rejects_an_unknown_impl(pair):
    _, m = _layer(pair, 0)
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_ffn(m, torch.zeros(1, 4, pair[3].d_model), impl="einsum")


def test_capacity_drops_the_same_tokens_as_the_reference(pair):
    """A router forced onto experts 0 and 1 for every token (positive
    activations, router columns in strictly falling order): 40 tokens x 2
    slots against a capacity of 16 an expert, so both experts keep the
    first 16 tokens in sort order and drop the other 24 — whose outputs are
    exactly zero in both packages — and the kept ones agree."""
    _, jp, model, cfg, jcfg = pair
    jparams, m = _layer(pair, 0)
    e, d = cfg.n_experts, cfg.d_model
    w = np.zeros((d, e), np.float32)
    w[:] = np.linspace(1.0, 0.1, e, dtype=np.float32)
    jparams = dict(jparams, router={"w": jnp.asarray(w)})
    forced = moe.MoE(cfg, device="cpu")
    forced.load_state_dict({**m.state_dict(), "router.w": torch.from_numpy(w)})
    x = np.abs(np.random.default_rng(6).standard_normal((1, 40, d),
                                                        dtype=np.float32)) + 0.1
    assert moe.expert_capacity(40, cfg) == jmoe.expert_capacity(40, jcfg) == 16
    expected, _ = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg)
    with torch.no_grad():
        out, _ = moe.moe_ffn(forced, torch.from_numpy(x))
        top_e = moe.route(forced, torch.from_numpy(x[0]))[1]
    assert (top_e == torch.tensor([0, 1])).all()
    expected = np.asarray(expected)
    assert np.all(expected[0, 16:] == 0) and np.all(out[0, 16:].numpy() == 0)
    assert np.all(np.abs(expected[0, :16]).max(-1) > 0)
    _scaled_close(out, expected)


def test_token_chunking_matches_jax(pair, monkeypatch):
    """``MOE_TOKEN_CHUNK`` patched to 16 in both packages: 48 tokens run as
    three chunks of 8 positions x 2 rows, the aux terms the chunks' means."""
    jparams, m = _layer(pair, 1)
    monkeypatch.setattr(jmoe, "MOE_TOKEN_CHUNK", 16)
    monkeypatch.setattr(moe, "MOE_TOKEN_CHUNK", 16)
    calls = []
    tokens = moe.moe_tokens
    monkeypatch.setattr(moe, "moe_tokens",
                        lambda mod, x, **kw: calls.append(x.shape) or
                        tokens(mod, x, **kw))
    x = np.random.default_rng(7).standard_normal((2, 24, pair[3].d_model),
                                                 dtype=np.float32)
    expected, jaux = jmoe.moe_ffn(jparams, jnp.asarray(x), pair[4])
    with torch.no_grad():
        out, aux = moe.moe_ffn(m, torch.from_numpy(x))
    assert calls == [(2, 8, pair[3].d_model)] * 3
    _scaled_close(out, expected)
    for k in aux:
        _scaled_close(aux[k], jaux[k])


# ---------------------------------------------------------------------------
# the models' paths against the JAX models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, LLAMA4])
@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_forward_and_aux_match_jax(pair, llama4, arch, impl):
    jm, jp, model, cfg, _ = pair if arch == ARCH else llama4
    toks = _tokens(0, (2, 40), cfg.vocab_size)
    expected, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                impl=REFERENCE_IMPL[impl])
    with torch.no_grad():
        logits, aux = model(toks, impl=impl)
    _scaled_close(logits, expected)
    for k in ("load_balance", "router_z"):
        _scaled_close(aux[k], jaux[k])


def test_loss_adds_the_aux_terms_like_jax(pair):
    jm, jp, model, cfg, _ = pair
    toks = _tokens(1, (2, 16), cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jtotal, jmetrics = jm.loss(jp, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)}, impl="xla")
    with torch.no_grad():
        total, metrics = model.loss({"tokens": toks, "labels": labels},
                                    impl="xla")
    _scaled_close(total, jtotal)
    for k in ("ce", "load_balance", "router_z", "tokens"):
        _scaled_close(metrics[k], jmetrics[k])


@pytest.mark.parametrize("impl", ["xla", "kernel", "chunked"])
def test_prefill_chunks_and_decode_match_jax(pair, impl):
    """Bucketed chunks (13 in 16, 5 in 8), then prefill of three rows and
    two decode steps, each a one-token MoE pass."""
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
        logits, _ = model.prefill_chunk(cache, ids, torch.from_numpy(lens),
                                        impl=impl, last_pos=torch.from_numpy(last))
        _scaled_close(logits, expected)
        start += n
    toks = _tokens(3, (3, 20), cfg.vocab_size)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=MAX_SEQ,
                           impl="xla")
    _, cache = model.prefill(toks, max_seq=MAX_SEQ, impl="xla")
    lengths = np.array([20, 11, 3], np.int32)
    new = _tokens(4, (3,), cfg.vocab_size)
    for step in range(2):
        expected, jcache = jm.decode_step(
            jp, jcache, jnp.asarray(new), jnp.asarray(lengths + step),
            impl=REFERENCE_IMPL[impl])
        logits, _ = model.decode_step(cache, new,
                                      torch.from_numpy(lengths + step), impl=impl)
        _scaled_close(logits, expected)


def test_llama4_decode_matches_jax(llama4):
    """The interleaved dense and MoE layers (shared expert, top-1) through
    prefill and one decode step."""
    jm, jp, model, cfg, _ = llama4
    toks = _tokens(3, (2, 12), cfg.vocab_size)
    jlast, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                               max_seq=MAX_SEQ, impl="xla")
    last, cache = model.prefill(toks, max_seq=MAX_SEQ, impl="xla")
    _scaled_close(last, jlast)
    lengths, new = np.array([12, 7], np.int32), np.array([3, 9], np.int32)
    expected, _ = jm.decode_step(jp, jcache, jnp.asarray(new),
                                 jnp.asarray(lengths), impl="pallas")
    logits, _ = model.decode_step(cache, new, torch.from_numpy(lengths),
                                  impl="kernel")
    _scaled_close(logits, expected)


def test_meta_device_paths_have_static_shapes():
    """Chunked prefill and decode run on the meta device, where any op that
    reads data back (``bincount``, ``.item()``, a boolean mask) would
    raise: the dropping path is what a CUDA graph and the tainted runner
    can take.  (The kernel wrappers refuse meta tensors, so the plain
    attention runs here.)"""
    cfg = get_config(ARCH).with_overrides(n_layers=2)
    model = Model(cfg, device="meta", generator=torch.Generator())
    cache = model.zero_cache(4, 256, use_ring=False)
    lengths = torch.zeros(4, dtype=torch.int32, device="meta")
    logits, _ = model.prefill_chunk([{k: v[:1] for k, v in c.items()} for c in cache],
                                    torch.zeros((1, 64), dtype=torch.long,
                                                device="meta"),
                                    lengths[:1], impl="xla")
    assert logits.shape == (1, cfg.vocab_size) and logits.is_meta
    logits, _ = model.decode_step(cache, torch.zeros(4, dtype=torch.long,
                                                     device="meta"),
                                  lengths, impl="xla")
    assert logits.shape == (4, cfg.vocab_size)


# ---------------------------------------------------------------------------
# the moe execution context against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_moe_context_matches_jax(pair, phase):
    _, jp, model, cfg, jcfg = pair
    jmc = jax_build_context(jcfg, "moe", phase=phase, backend="xla")
    mc = build_context(cfg, "moe", phase=phase, backend="kernel", device="cpu")
    assert mc.static_attrs == jmc.static_attrs
    specs, jspecs = mc.abstract_inputs(12, 2, 0), jmc.abstract_inputs(12, 2, 0)
    assert [(tuple(s.shape), str(s.dtype).split(".")[-1]) for s in specs] == \
        [(tuple(s.shape), str(s.dtype)) for s in jspecs]
    x = np.random.default_rng(8).standard_normal(specs[0].shape, dtype=np.float32)
    expected = jmc.fn(_layer(pair, 0)[0], jnp.asarray(x))
    weights = {k[len("layers.0.moe."):]: v for k, v in model.state_dict().items()
               if k.startswith("layers.0.moe.")}
    assert {k: (tuple(v.shape), v.dtype) for k, v in weights.items()} == \
        {k: (tuple(s.shape), s.dtype) for k, s in mc.params.items()}
    _scaled_close(mc.fn(mc.module(weights), torch.from_numpy(x)), expected)
    assert phases_for("moe", cfg) == jax_phases_for("moe", jcfg) == ("prefill",)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine(pair):
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
        for name in ("k", "v"):
            _scaled_close(layer[name], jeng.cache["blocks"][0][name][i])


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [8, 64])
def test_gpu_moe_captures_in_a_cuda_graph(cuda, tokens):
    """The float32 dropping path (olmoe-smoke's layer: 8 experts, top-2)
    replays from a CUDA graph bit for bit as its eager call, aux included:
    no atomics in the combine, no read-back."""
    cfg = get_smoke_config(ARCH)
    layer = moe.MoE(cfg, device=cuda, dtype=torch.float32,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((2, tokens // 2, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        eager, eager_aux = moe.moe_ffn(layer, x)
        moe.moe_ffn(layer, x)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out, aux = moe.moe_ffn(layer, x)
        for _ in range(2):
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
            assert all(torch.equal(aux[k], eager_aux[k]) for k in aux)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_gpu_decode_group_of_one_matches_plain(cuda, dtype, d):
    """olmoe's decode: 16 heads and 16 KV heads, so one query row a GQA
    group (15 of a 16-row tile idle), at lengths 1..2048; q is the
    kernel's (B, KV, G, D)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((8, 16, 1, d), generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn((8, 2048, 16, d), generator=gen, device=cuda).to(dtype)
              for _ in range(2))
    lengths = torch.randint(1, 2049, (8,), generator=gen, device=cuda,
                            dtype=torch.int32)
    n = da.decode_attention.launches
    out = da.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == n + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(q, kc, vc, lengths).float(),
        atol=tol, rtol=tol)


def test_moe_signature_boundary_keeps_the_reference_dummy_token_count():
    """Pinned reference behaviour (ROADMAP Queue 3 item 11): the reference
    sums the k slots with ``segment_sum(..., num_segments=T)``, a static
    int, so the token dim of its last op carries no taint and component 1
    of the ``moe`` signature holds the dummy prompt's B x S (5 x 11 = 55)
    as a number.  The port's fixed-order combine writes into a buffer made
    from that number too, and its boundary reads the same."""
    import json
    from repro.core import opset as jopset
    from repro.core import runner as jrunner
    from repro.core.signature import module_entry_signature as jsig
    from repro.serving.context import build_context as jctx
    from repro_torch.core import opset, runner
    from repro_torch.core.signature import module_entry_signature
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    ptrace, jtrace = runner.trace_model(cfg), jrunner.trace_model(jcfg)
    pe = next(e for e in opset.find_runnable_set(ptrace.trace, device="cpu")
              if isinstance(e, opset.ModuleEntry) and e.context_kind == "moe")
    je = next(e for e in jopset.find_runnable_set(jtrace.trace)
              if isinstance(e, jopset.ModuleEntry) and e.context_kind == "moe")
    ps = json.loads(module_entry_signature(pe, build_context(
        cfg, "moe", backend="kernel", device="cpu")).spec)
    js = json.loads(jsig(je, jctx(jcfg, "moe")).spec)
    tokens = ptrace.batch * ptrace.seq
    assert (ptrace.batch, ptrace.seq) == (jtrace.batch, jtrace.seq) == (5, 11)
    assert ps["boundary"] == js["boundary"] == [
        [["R", "T", cfg.d_model]], [[tokens, cfg.d_model]]]
