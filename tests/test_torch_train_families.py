"""Training across the families against the JAX package: the port's
``Model.param_stacks`` against the reference's parameter tree, one train
step of each family's smoke configuration under AdamW and under Adafactor
(Adafactor on the reference's stacked leaves), yi-smoke's loss falling,
falcon-mamba-smoke's checkpoints, the clip's numbers and memory, and a
step of hymba-smoke through the flash kernels on the card.

Tolerances (float32, CPU).  The optimizers on the same gradients: 1e-6,
the same formulas; Adafactor's moments 1e-5 relative (its means over a
stacked leaf's rows and columns reduce in other orders: 1.3e-6 seen).  A train step from the reference's parameters: loss
1e-5 relative, grad norm 1e-4 relative (the two frameworks sum products in
other orders: gradients differ by up to 3.6e-4 of a tensor's largest
entry).  The optimizers then amplify those differences where a gradient
is small against its neighbours, each in its own way:

* AdamW's first step moves every entry by lr times the sign of its
  gradient (m / sqrt(v) = g / |g|), so an entry whose gradient is near 0
  may move the other way.  Held: the moments at 5e-4 (m) and 1e-3 (v,
  squared) of each tensor's largest entry; the parameters at 1e-6 of their
  largest entry where the reference's m is at least 1e-3 of its largest
  (its sign settled), and within 2 lr (one step each way) everywhere.
* Adafactor divides each gradient by its row's and column's RMS, so a row
  of small gradients is read relative to itself.  Held: the parameters'
  moves at 2e-2 of each tensor's largest move (at most 8.8e-3 seen), the
  state at 1e-3 of each leaf's largest entry (at most 3.5e-4 seen).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CORPUS_ARCHS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model
from repro.train import optimizer as jax_opt
from repro.train import trainer as jax_trainer
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import StepMeter
from repro_torch.models import Model, params_from_jax
from repro_torch.models.zoo import period
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer, trainer
from repro_torch.train.data import DataConfig, TokenStream

torch.set_num_threads(2)

FAMILIES = ["yi-9b", "minicpm3-4b", "olmoe-1b-7b", "falcon-mamba-7b",
            "hymba-1.5b"]
LR = 3e-4


def _flat(tree, is_leaf=None):
    """{``zoo.stack_key`` of each leaf: the leaf} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _reference_key(key: str) -> str:
    """The reference leaf of a port state key: a stack's key as it is, a
    parameter's name with ``/`` for ``.``."""
    return key.replace(".", "/")


def _state_leaves(tree):
    """{key/slot: array} of an Adafactor state's ``f`` (slots vr, vc, v)."""
    moments = _flat(tree, lambda x: isinstance(x, dict) and x and all(
        not isinstance(v, (dict, list)) for v in x.values()))
    return {f"{k}/{slot}": np.asarray(v) for k, m in moments.items()
            for slot, v in m.items()}


def _scaled_err(port, expected) -> float:
    port, expected = np.asarray(port, np.float64), np.asarray(expected, np.float64)
    return float(np.abs(port - expected).max() / (np.abs(expected).max() + 1e-30))


def _port_model(cfg, jax_params) -> Model:
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params),
                                          cfg))
    return model


# ---------------------------------------------------------------------------
# param_stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CORPUS_ARCHS)
def test_param_stacks_round_trip_params_from_jax(arch):
    """Stacking the port's tensors by ``param_stacks`` gives back the
    reference's tree, leaf by leaf; each parameter is in one stack."""
    cfg, jm = get_smoke_config(arch), build_model(jax_smoke_config(arch))
    # every entry of every leaf distinct
    shapes, n = jax.tree.leaves(jm.abstract_params()), 0
    leaves = []
    for sds in shapes:
        size = int(np.prod(sds.shape))
        leaves.append(np.arange(n, n + size, dtype=np.float64).reshape(
            sds.shape))
        n += size
    tree = jax.tree.unflatten(jax.tree.structure(jm.abstract_params()), leaves)
    state = params_from_jax(tree, cfg)
    stacks = Model(cfg, device="meta", generator=torch.Generator()
                   ).param_stacks()
    assert period(cfg) == len(jm.pattern)
    names = [n for v in stacks.values() for n in v]
    assert len(set(names)) == len(names) and set(names) <= set(state)
    singles = sorted(set(state) - set(names))
    want = _flat(tree)
    assert sorted([*stacks, *map(_reference_key, singles)]) == sorted(want)
    assert all(k.split("/", 1)[0] in ("blocks", "enc_blocks") for k in stacks)
    for key, members in stacks.items():
        got = np.stack([state[n].numpy() for n in members])
        assert got.dtype == want[key].dtype and np.array_equal(got, want[key]), key
    for n in singles:
        got, key = state[n].numpy(), _reference_key(n)
        assert got.dtype == want[key].dtype and np.array_equal(got, want[key]), n


# ---------------------------------------------------------------------------
# the optimizers on the reference's stacked leaves, the same gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_optimizer_on_stacked_leaves_matches_the_reference(arch, opt):
    """Three clipped updates of the port's per-layer tensors with the
    model's stacks against the reference's update of its stacked tree, on
    the same random gradients: parameters and state to 1e-6."""
    cfg, jm = get_smoke_config(arch), build_model(jax_smoke_config(arch))
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                      jm.abstract_params())
    model = _port_model(cfg, jp)
    params = dict(model.named_parameters())
    stacks = model.param_stacks()
    jo, po = jax_opt.make_optimizer(opt), optimizer.make_optimizer(opt)
    jstate, state = jo.init(jp), po.init(params, stacks)

    @jax.jit
    def jstep(g, st, p):
        clipped, norm = jax_opt.clip_by_global_norm(g, 1.0)
        return jo.update(clipped, st, p, 1e-2) + (norm,)

    for _ in range(3):
        jg = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 0.1, jp)
        g = params_from_jax(jg, cfg)
        jp, jstate, jnorm = jstep(jg, jstate, jp)
        clipped, norm = optimizer.clip_by_global_norm(g, 1.0)
        po.update(clipped, state, params, 1e-2, stacks)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    for n, w in want.items():
        np.testing.assert_allclose(params[n].detach().numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    assert state["count"] == int(jstate["count"]) == 3
    if opt == "adamw":
        for k in ("m", "v"):
            for n, w in params_from_jax(jax.tree.map(np.asarray, jstate[k]),
                                        cfg).items():
                np.testing.assert_allclose(state[k][n].numpy(), w.numpy(),
                                           rtol=1e-6, atol=1e-9)
        return
    got = _state_leaves({_reference_key(k): {s: t.numpy() for s, t in v.items()}
                         for k, v in state["f"].items()})
    want = _state_leaves(jstate["f"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-30, err_msg=k)


# ---------------------------------------------------------------------------
# one train step of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference(arch, opt):
    cfg, jm = get_smoke_config(arch), build_model(jax_smoke_config(arch))
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0),
                                          jax_opt.make_optimizer(opt))
    batch = TokenStream(DataConfig(cfg.vocab_size, 2, 16)).batch_at(0)
    jstep = jax.jit(jax_trainer.make_train_step(
        jm, impl="xla", learning_rate=LR, optimizer=jax_opt.make_optimizer(opt)))
    jnext, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(cfg, jstate["params"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = trainer.init_train_state(model, optimizer.make_optimizer(opt))
    state, metrics = trainer.make_train_step(
        model, impl="xla", learning_rate=LR,
        optimizer=optimizer.make_optimizer(opt))(state, batch)

    for key in ("loss", "ce", "load_balance", "router_z"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    assert state["step"] == int(jnext["step"]) == 1
    want = params_from_jax(jax.tree.map(np.asarray, jnext["params"]), cfg)
    got = {n: p.detach() for n, p in state["params"].items()}
    if opt == "adamw":
        moments = {k: params_from_jax(jax.tree.map(np.asarray, jnext["opt"][k]),
                                      cfg) for k in ("m", "v")}
        for n, w in want.items():
            assert _scaled_err(state["opt"]["m"][n], moments["m"][n]) <= 5e-4, n
            assert _scaled_err(state["opt"]["v"][n], moments["v"][n]) <= 1e-3, n
            m = moments["m"][n].numpy()
            settled = np.abs(m) >= 1e-3 * np.abs(m).max()
            diff = np.abs(got[n].numpy() - w.numpy())
            assert diff[settled].max(initial=0) <= 1e-6 * max(
                float(np.abs(w.numpy()).max()), 1.0), n
            assert diff.max() <= 2 * LR * (1 + 1e-3), n
        return
    for n, w in want.items():
        move = w.numpy() - before[n].numpy()
        assert _scaled_err(got[n].numpy() - before[n].numpy(), move) <= 2e-2, n
    got_f = _state_leaves({_reference_key(k): {s: t.numpy() for s, t in v.items()}
                           for k, v in state["opt"]["f"].items()})
    want_f = _state_leaves(jnext["opt"]["f"])
    assert sorted(got_f) == sorted(want_f)
    for k, w in want_f.items():
        assert got_f[k].shape == w.shape and _scaled_err(got_f[k], w) <= 1e-3, k


def test_moe_grads_through_capacity_drops_match_the_reference():
    """The dropping path under autograd: olmoe-smoke's FFN with a router
    forced onto experts 0 and 1 (40 tokens x 2 slots against a capacity
    of 16: 24 tokens dropped an expert), the gradients of its output and
    aux terms against ``jax.grad`` of the reference's ``moe_ffn``, for the
    input and every weight (float32, 5e-4 of each one's largest entry)."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    cfg, jcfg = get_smoke_config("olmoe-1b-7b"), jax_smoke_config("olmoe-1b-7b")
    m = moe.MoE(cfg, device="cpu", dtype=torch.float32,
                generator=torch.Generator().manual_seed(0))
    e, d = cfg.n_experts, cfg.d_model
    w = np.zeros((d, e), np.float32)
    w[:] = np.linspace(1.0, 0.1, e, dtype=np.float32)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(w))
    rng = np.random.default_rng(6)
    x = np.abs(rng.standard_normal((1, 40, d), dtype=np.float32)) + 0.1
    r = rng.standard_normal((1, 40, d), dtype=np.float32)
    assert moe.expert_capacity(40, cfg) == 16
    names = [n for n, _ in m.named_parameters()]
    jp = {}
    for n, t in m.named_parameters():
        jp.setdefault(n.split(".")[0], {})["w"] = jnp.asarray(t.detach().numpy())

    def objective(out, aux, rr):
        return (out * rr).sum() + aux["load_balance"] + aux["router_z"]

    jg_p, jg_x = jax.grad(lambda p, xx: objective(
        *jax_moe.moe_ffn(p, xx, jcfg), jnp.asarray(r)), argnums=(0, 1))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(m, xt)
    assert np.all(out[0, 16:].detach().numpy() == 0)      # the dropped tokens
    grads = torch.autograd.grad(objective(out, aux, torch.from_numpy(r)),
                                [xt] + list(m.parameters()))
    assert _scaled_err(grads[0].numpy(), jg_x) <= 5e-4
    for n, g in zip(names, grads[1:]):
        assert _scaled_err(g.numpy(), jg_p[n.split(".")[0]]["w"]) <= 5e-4, n


def test_loss_decreases_yi():
    """The reference's ``test_loss_decreases_yi`` on the port: 20 steps of
    yi-smoke (2 microbatches, lr 1e-2) lower the loss by more than 0.5."""
    cfg = get_smoke_config("yi-9b")
    model = Model(cfg, device="cpu")
    stream = TokenStream(DataConfig(cfg.vocab_size, 8, 32))
    state = trainer.init_train_state(model)
    step = trainer.make_train_step(model, microbatches=2, learning_rate=1e-2)
    losses = []
    for _, batch in zip(range(20), stream):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.5, losses


# ---------------------------------------------------------------------------
# checkpoints of a Mamba model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_roundtrip_and_crash_safety_falcon_mamba(tmp_path, opt):
    cfg = get_smoke_config("falcon-mamba-7b")
    model = Model(cfg, device="cpu")
    state = trainer.init_train_state(model, optimizer.make_optimizer(opt))
    batch = TokenStream(DataConfig(cfg.vocab_size, 2, 16)).batch_at(0)
    step = trainer.make_train_step(model, optimizer=optimizer.make_optimizer(opt))
    state, _ = step(state, batch)
    saved = ckpt.host_state(state)
    d = str(tmp_path)
    saver = ckpt.AsyncCheckpointer(d)
    saver.save(1, state)
    saver.wait()
    # a crashed later save: its stray .tmp directory must be ignored
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    assert ckpt.latest_step(d) == 1
    state, _ = step(state, batch)                # training moves on
    restored, at = ckpt.restore(d, state)
    assert at == 1 and restored["step"] == 1 and restored["opt"]["count"] == 1
    assert restored["params"]["embed.table"] is model.embed.table
    for (path, a), (_, b) in zip(ckpt._leaves(restored), ckpt._leaves(saved)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path


# ---------------------------------------------------------------------------
# the clip: the reference's numbers, one float32 copy at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1e-3, 0.5])
def test_clip_is_unchanged_and_holds_no_float32_copies(max_norm):
    """bf16 grads: the clipped values are the reference's ``g * scale``;
    clipping and an Adafactor update never hold float32 copies of the
    grads together (live bytes of the storages they make, by weak
    reference, as the dry run's meter counts them)."""
    rng = np.random.default_rng(3)
    shapes = {f"w{i}": (64, 96) for i in range(16)}
    shapes["b"] = (96,)
    grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    bf = {n: torch.from_numpy(g).to(torch.bfloat16) for n, g in grads.items()}
    jclipped, jnorm = jax_opt.clip_by_global_norm(
        {n: jnp.asarray(g.float().numpy(), jnp.bfloat16) for n, g in bf.items()},
        max_norm)
    clipped, norm = optimizer.clip_by_global_norm(bf, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for n in grads:
        assert clipped[n].dtype == torch.float32
        assert np.dtype(jclipped[n].dtype) == np.float32
        np.testing.assert_allclose(clipped[n].numpy(), np.asarray(jclipped[n]),
                                   rtol=1e-6, atol=0)
    params = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    opt = optimizer.Adafactor()
    state = opt.init(params)
    all_copies = sum(4 * g.numel() for g in bf.values())
    with StepMeter() as meter:
        # the tensors that exist before, which the update writes in place
        for t in list(bf.values()) + list(params.values()) + [
                v for leaf in state["f"].values() for v in leaf.values()]:
            meter._track(t.untyped_storage())
        before = meter.live
        clipped, _ = optimizer.clip_by_global_norm(bf, max_norm)
        opt.update(clipped, state, params, 1e-2)
    made = meter.peak - before
    assert 0 < made <= all_copies / 2, (made, all_copies)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 at smoke size
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_17_on_cpu(tmp_path, capsys):
    """Phase 17 at the smoke configurations on the CPU (the kernel backend
    takes the plain versions, so no launch is counted): both optimizers on
    the hybrid, the bit-exact resume, the dense model, one example."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    out = cs.phase17(cpu, hybrid=get_smoke_config("hymba-1.5b"),
                     dense=get_smoke_config("yi-9b"), hybrid_run=(2, 1, 80, 2),
                     dense_run=(1, 2, 32, 2),
                     examples=[("torch_train_demo.py",
                                ["--steps", "2", "--batch", "4", "--seq", "16"],
                                ["final loss=", "resumed loss="])],
                     limit_s=600, workdir=tmp_path / "ckpt")
    text = capsys.readouterr().out
    assert "[17 hybrid] hymba-smoke" in text
    assert text.count("[17 hybrid]") == 2 and "[17 dense] yi-smoke" in text
    assert "bit for bit" in text and "[17 examples] torch_train_demo.py" in text
    assert out["flash_fwd_launches"] == out["flash_bwd_launches"] == 0
    assert out["hybrid"]["adamw"]["min_cosine"] >= 0.99
    assert out["dense"]["min_cosine"] >= 0.99
    assert out["hybrid"]["checkpoint"]["bytes"] > 0
    assert not (tmp_path / "ckpt").exists()
    for run in (out["hybrid"]["adamw"], out["hybrid"]["adafactor"], out["dense"]):
        assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()


def test_chip_smoke_train_shapes_time_against_a_window_mask():
    """Phase 3's train shapes: where the window cuts keys, the yardstick is
    SDPA with a boolean mask of the pairs the kernel keeps, forward and
    backward (timed on the CPU through the plain versions)."""
    cs = _chip_smoke()
    shapes = cs.train_flash_shapes(get_smoke_config("hymba-1.5b"),
                                   get_smoke_config("yi-9b"),
                                   hybrid_run=(4, 1, 96, 3),
                                   dense_run=(1, 2, 32, 3))
    assert [s[-1] for s in shapes] == [64, 0] and "window 64" in shapes[0][0]
    mask = cs._sdpa_masks(5, 5, True, 2, torch.device("cpu"))["attn_mask"]
    assert mask.sum() == 9 and cs._pairs(5, 5, True, 2) == 9
    rng = np.random.default_rng(0)
    for _, b, s, h, kv, d, win in shapes:
        for case in (cs._flash_case, cs._flash_bwd_case):
            res = case(rng, b, s, s, h, kv, d, True, win, torch.float32,
                       torch.device("cpu"), True)
            assert res["library_ms"] > 0 and res["bound_ms"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_hymba_step_through_the_kernels():
    """One Adafactor step of hymba-smoke (float32) on the card through the
    flash forward and backward and the plain chunked scan: its gradients
    and its step's loss against the plain attention's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    cfg = get_smoke_config("hymba-1.5b")
    batch = TokenStream(DataConfig(cfg.vocab_size, 2, 96)).batch_at(0)
    model = Model(cfg, device="cuda")
    grads = {}
    for impl in ("kernel", "xla"):
        loss, _ = model.loss(batch, impl=impl)
        grads[impl] = torch.autograd.grad(loss, list(model.parameters()))
    for k, x in zip(grads["kernel"], grads["xla"]):
        assert _scaled_err(k.cpu().numpy(), x.cpu().numpy()) <= 5e-4
    losses = {}
    for impl in ("xla", "kernel"):
        fa.flash_attention_fwd.launches = fa.flash_attention_bwd.launches = 0
        ms.mamba_scan.launches = 0
        model = Model(cfg, device="cuda")
        state = trainer.init_train_state(model, optimizer.Adafactor())
        _, m = trainer.make_train_step(model, impl=impl,
                                       optimizer=optimizer.Adafactor())(
            state, batch)
        losses[impl] = float(m["loss"])
    # one forward and its remat recompute, and one backward, a layer
    assert fa.flash_attention_bwd.launches == cfg.n_layers
    assert fa.flash_attention_fwd.launches == 2 * cfg.n_layers
    assert ms.mamba_scan.launches == 0
    np.testing.assert_allclose(losses["kernel"], losses["xla"], rtol=1e-4)
