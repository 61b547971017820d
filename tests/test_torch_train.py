"""The port's training substrate against the JAX package's: optimizers on
the same numpy trees, train steps on the same parameters and batches
(``llama3-smoke``, float32, CPU), gradients through the flash kernel's
plain versions against the Pallas kernel's in interpret mode, checkpoints,
data and gradient compression.

Tolerances: optimizer updates 1e-6 (float32, the same formulas; sums and
square roots round at other places).  Through the model: losses 1e-5
relative; grad norms 1e-4 relative; one step's gradients 5e-4 of each
tensor's largest entry, and parameters and AdamW moments after three
steps 1e-3.  The two frameworks sum matmuls in different orders and this
configuration amplifies it: on the same parameters and batch the JAX
package's own ``pallas`` and ``xla`` gradients differ by 2.4e-4 of a
tensor's largest entry and their global norms by 4.3e-5 relative (float32,
CPU); three steps compound it.
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.parallel import compression as jax_compression
from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro.train import trainer as jax_trainer
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.models import Model, params_from_jax
from repro_torch.parallel import compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, optimizer, trainer
from repro_torch.train.data import DataConfig, TokenStream

torch.set_num_threads(2)

GRAD_TOL, STATE_TOL, NORM_TOL = 5e-4, 1e-3, 1e-4


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}


def _torch(tree, dtype=torch.float32):
    return {n: torch.from_numpy(np.array(a)).to(dtype) for n, a in tree.items()}


def _scaled_close(port, expected, tol):
    expected = np.asarray(expected, np.float32)
    scale = float(np.abs(expected).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(port, np.float32) / scale,
                               expected / scale, atol=tol)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

SHAPES_TREE = {"w": (8, 12), "b": (12,), "s": (3, 4, 5)}


@pytest.mark.parametrize("name", ["AdamW", "Adafactor"])
def test_optimizer_updates_match_jax(name):
    jopt, opt = getattr(jax_opt, name)(weight_decay=0.1), \
        getattr(optimizer, name)(weight_decay=0.1)
    params = _tree(0, SHAPES_TREE)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    p = _torch(params)
    jstate, state = jopt.init(jp), opt.init(p)
    for i in range(3):
        grads = _tree(10 + i, SHAPES_TREE)
        jp, jstate = jopt.update({n: jnp.asarray(g) for n, g in grads.items()},
                                 jstate, jp, 1e-2)
        p, state = opt.update(_torch(grads), state, p, 1e-2)
        for n in params:
            np.testing.assert_allclose(p[n].numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-6)
    assert state["count"] == int(jstate["count"]) == 3
    moments = ({"m": state["m"], "v": state["v"]} if name == "AdamW"
               else state["f"])
    expected = ({"m": jstate["m"], "v": jstate["v"]} if name == "AdamW"
                else jstate["f"])
    for port_leaf, jax_leaf in zip(jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), moments)),
            jax.tree.leaves(expected)):
        assert port_leaf.dtype == np.float32
        np.testing.assert_allclose(port_leaf, np.asarray(jax_leaf), rtol=1e-6,
                                   atol=1e-9)


def test_adamw_keeps_fp32_moments_for_bf16_params():
    """bf16 parameters, fp32 state, one cast back per update: the same
    bf16 values as the reference (within one bf16 step)."""
    params = _tree(1, {"w": (64, 32)})
    grads = _tree(2, {"w": (64, 32)})
    jopt, opt = jax_opt.AdamW(), optimizer.AdamW()
    jp = {"w": jnp.asarray(params["w"], jnp.bfloat16)}
    p = _torch(params, torch.bfloat16)
    jstate, state = jopt.init(jp), opt.init(p)
    for _ in range(2):
        jp, jstate = jopt.update({"w": jnp.asarray(grads["w"])}, jstate, jp, 1e-3)
        p, state = opt.update(_torch(grads), state, p, 1e-3)
    assert p["w"].dtype == torch.bfloat16
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
    np.testing.assert_allclose(p["w"].float().numpy(),
                               np.asarray(jp["w"].astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


def test_adamw_slices_large_tensors(monkeypatch):
    """The in-place update walks a tensor in slices; the slices cover it."""
    monkeypatch.setattr(optimizer, "_SLICE", 7)
    params, grads = _tree(3, {"w": (10, 9)}), _tree(4, {"w": (10, 9)})
    jopt, opt = jax_opt.AdamW(), optimizer.AdamW()
    jp, _ = jopt.update({"w": jnp.asarray(grads["w"])},
                        jopt.init({"w": jnp.asarray(params["w"])}),
                        {"w": jnp.asarray(params["w"])}, 1e-2)
    p = _torch(params)
    opt.update(_torch(grads), opt.init(p), p, 1e-2)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(5, SHAPES_TREE)
    jclipped, jnorm = jax_opt.clip_by_global_norm(
        {n: jnp.asarray(g) for n, g in grads.items()}, max_norm)
    clipped, norm = optimizer.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for n in grads:
        np.testing.assert_allclose(clipped[n].numpy(), np.asarray(jclipped[n]),
                                   rtol=1e-6, atol=1e-7)
    # non-float32 grads come back as scaled float32 copies, as JAX promotes
    bf = optimizer.clip_by_global_norm({"w": torch.ones(4, dtype=torch.bfloat16)},
                                       1.0)[0]["w"]
    assert bf.dtype == torch.float32 and torch.allclose(bf, torch.full((4,), 0.5))


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """(cfg, jax model, jax train state, batches)."""
    cfg, jcfg = get_smoke_config("llama3-8b"), jax_smoke_config("llama3-8b")
    jm = build_model(jcfg)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0))
    stream = TokenStream(DataConfig(cfg.vocab_size, 4, 32))
    return cfg, jm, jstate, [stream.batch_at(i) for i in range(3)]


def _port_model(cfg, jax_params):
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params),
                                          cfg))
    return model


def test_train_steps_match_jax(smoke):
    cfg, jm, jstate, batches = smoke
    jstep = jax.jit(jax_trainer.make_train_step(jm, microbatches=2, impl="xla"))
    model = _port_model(cfg, jstate["params"])
    state = trainer.init_train_state(model)
    step = trainer.make_train_step(model, microbatches=2, impl="xla")
    for batch in batches:
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        for key in ("loss", "ce", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=NORM_TOL)
    assert state["step"] == int(jstate["step"]) == 3
    expected = {"params": params_from_jax(jax.tree.map(np.asarray,
                                                       jstate["params"]), cfg),
                **{k: params_from_jax(jax.tree.map(np.asarray, jstate["opt"][k]),
                                      cfg) for k in ("m", "v")}}
    port = {"params": {n: p.detach() for n, p in state["params"].items()},
            "m": state["opt"]["m"], "v": state["opt"]["v"]}
    for kind in expected:
        assert sorted(port[kind]) == sorted(expected[kind])
        for n, e in expected[kind].items():
            _scaled_close(port[kind][n].numpy(), e.numpy(), STATE_TOL)
    # the model itself was trained: its parameters are the state's
    assert model.embed.table is state["params"]["embed.table"]


def _jax_grads(jm, params, batch, impl):
    loss = lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             impl=impl)[0]
    return jax.tree.map(np.asarray, jax.grad(loss)(params))


def _port_grads(model, batch, impl, remat=None):
    loss, _ = model.loss(batch, impl=impl, remat=remat)
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def test_kernel_backend_grads_match_jax_pallas(smoke):
    """One microbatch's gradients through the flash autograd node (its plain
    versions here) against jax.grad through the Pallas kernels."""
    cfg, jm, jstate, batches = smoke
    model = _port_model(cfg, jstate["params"])
    expected = params_from_jax(_jax_grads(jm, jstate["params"], batches[0],
                                          "pallas"), cfg)
    port = _port_grads(model, batches[0], "kernel")
    for n, e in expected.items():
        _scaled_close(port[n].numpy(), e.numpy(), GRAD_TOL)


def test_remat_gives_the_same_grads(smoke):
    cfg, _, jstate, batches = smoke
    model = _port_model(cfg, jstate["params"])
    on = _port_grads(model, batches[1], "kernel", remat=True)
    off = _port_grads(model, batches[1], "kernel", remat=False)
    for n in on:
        torch.testing.assert_close(on[n], off[n], rtol=1e-6, atol=1e-7)


def test_loss_masks_negative_labels_like_jax(smoke):
    cfg, jm, jstate, batches = smoke
    batch = dict(batches[2])
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, ::3] = -1
    expected, jmetrics = jm.loss(jstate["params"],
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 impl="xla")
    model = _port_model(cfg, jstate["params"])
    with torch.no_grad():
        total, metrics = model.loss(batch, impl="xla")
    np.testing.assert_allclose(float(total), float(expected), rtol=1e-5)
    for key in ("ce", "load_balance", "router_z", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5)


def test_microbatches_must_divide_the_batch(smoke):
    cfg, _, jstate, batches = smoke
    model = _port_model(cfg, jstate["params"])
    step = trainer.make_train_step(model, microbatches=3, impl="xla")
    with pytest.raises(ValueError, match="3 microbatches"):
        step(trainer.init_train_state(model), batches[0])


def test_train_step_with_compression_matches_jax(smoke):
    cfg, jm, jstate, batches = smoke
    jstep = jax.jit(jax_trainer.make_train_step(
        jm, impl="xla", grad_transform=jax_compression.make_grad_compression()))
    _, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    model = _port_model(cfg, jstate["params"])
    before = model.embed.table.detach().clone()
    step = trainer.make_train_step(model, impl="xla",
                                   grad_transform=compression.make_grad_compression())
    _, m = step(trainer.init_train_state(model), batches[0])
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=NORM_TOL)
    assert not torch.equal(before, model.embed.table)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_default_microbatches_matches_jax(name, arch):
    cfg = get_config("llama3-8b") if arch == "full" else get_smoke_config("llama3-8b")
    jcfg = jax_config("llama3-8b") if arch == "full" \
        else jax_smoke_config("llama3-8b")
    assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(JAX_SHAPES[name])
    for dp in (1, 2, 4, 8, 16, 64):
        assert trainer.default_microbatches(cfg, SHAPES[name], dp) == \
            jax_trainer.default_microbatches(jcfg, JAX_SHAPES[name], dp)


# ---------------------------------------------------------------------------
# data, checkpoints, compression
# ---------------------------------------------------------------------------

def test_data_is_a_verbatim_copy():
    # restarts resume the exact stream only if both read the same batches
    assert Path(data.__file__).read_text() == Path(jax_data.__file__).read_text()


def _bf16_state():
    cfg = get_smoke_config("llama3-8b").with_overrides(dtype="bfloat16")
    model = Model(cfg, device="cpu")
    return model, trainer.init_train_state(model)


def test_checkpoint_roundtrip_bf16_bitexact_and_crash_safety(tmp_path):
    model, state = _bf16_state()
    state["step"], state["opt"]["count"] = 3, 3
    state["opt"]["m"]["embed.table"].normal_()
    saved = ckpt.host_state(state)
    d = str(tmp_path)
    ckpt.save(d, 3, state)
    # a crashed later save: its stray .tmp directory must be ignored
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    _, fresh = _bf16_state()
    restored, step = ckpt.restore(d, state)
    assert step == 3 and ckpt.latest_step(d) == 3
    assert restored["step"] == 3 and restored["opt"]["count"] == 3
    assert restored["params"]["embed.table"] is model.embed.table
    for (path, a), (_, b) in zip(ckpt._leaves(restored), ckpt._leaves(saved)):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype, path
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                               else a, b.view(torch.int16)
                               if b.dtype == torch.bfloat16 else b), path
    assert model.embed.table.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, {"other": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), state)


def test_async_checkpointer(tmp_path):
    model, state = _bf16_state()
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, state)
    with torch.no_grad():            # training goes on; the snapshot does not
        model.embed.table.zero_()
    saver.save(2, state)
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2
    restored, _ = ckpt.restore(str(tmp_path), state, step=1)
    assert restored["params"]["embed.table"].abs().sum() > 0


def test_compress_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((1000, 257)).astype(np.float32) * 0.01
    y = compression.compress_roundtrip(torch.from_numpy(x))
    expected = np.asarray(jax_compression.compress_roundtrip(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), expected, rtol=1e-6, atol=1e-9)
    rel = float(np.linalg.norm(y.numpy() - x) / np.linalg.norm(x))
    assert rel < 0.012, rel
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jax_compression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == jq.shape and s.shape == js.shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_train_step_through_the_kernels(smoke):
    """One step on the card through the flash kernels (fp32 smoke model):
    its gradients against the plain attention's on the card, and its loss
    against the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg, jm, jstate, batches = smoke
    model = _port_model(cfg, jstate["params"]).to("cuda")
    kernel = _port_grads(model, batches[0], "kernel")
    plain = _port_grads(model, batches[0], "xla")
    for n in kernel:
        _scaled_close(kernel[n].cpu().numpy(), plain[n].cpu().numpy(), GRAD_TOL)
    state = trainer.init_train_state(model)
    _, m = trainer.make_train_step(model, microbatches=2, impl="kernel")(
        state, batches[0])
    jstep = jax_trainer.make_train_step(jm, microbatches=2, impl="xla")
    _, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), rtol=1e-4)
