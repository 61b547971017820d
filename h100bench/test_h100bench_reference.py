"""The plain reference against the port at smoke size on the CPU, and the
check's control: the port (float32 here) passes the smoke limit, the
float8 control fails it."""
import pytest
import torch

from h100bench import _smoke, check, weights
from h100bench.reference import decoder

CONFIGS = sorted(_smoke.SMOKE_CONFIGS)


def _port_model(m, seed):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.zoo import Model
    model = Model(ModelConfig(**m), device="cpu")
    model.load_state_dict(weights.state_dict(m, seed, "cpu"))
    return model.requires_grad_(False)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_forward(name):
    """Logits at every position of a 40-token sequence, the reference's
    MoE capacity that of one 40-token step, as the port's forward runs it."""
    m = _smoke.SMOKE_CONFIGS[name]
    tokens = torch.randint(0, m["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    with torch.no_grad():
        port = _port_model(m, 11).forward([tokens], impl="xla")[0][0]
    ref = decoder.logits(m, 11, [decoder.Sequence_(tokens, list(range(40)),
                                                   [(0, 40, 40)])], "cpu")[0]
    torch.testing.assert_close(ref, port.float(), atol=2e-4, rtol=2e-4)


def test_reference_drops_what_the_port_drops():
    """64 equal tokens all route to the same experts, past their capacity:
    the reference's MoE drops the same (token, choice) pairs as the port's."""
    from repro_torch.models.moe import moe_ffn
    m = _smoke.SMOKE_CONFIGS["olmoe-smoke"]
    model = _port_model(m, 5)
    h = torch.randn(1, m["d_model"], generator=torch.Generator().manual_seed(1))
    h = h.expand(64, -1).contiguous()
    with torch.no_grad():
        port = moe_ffn(model.layers[0].moe, h[None])[0][0]
    w = {k: v.float() for k, v in weights.draw_group(m, 5, 1, "cpu").items()}
    keep = decoder.moe_keep(torch.topk(torch.softmax(h @ w["layers.0.moe.router.w"], -1),
                                       m["top_k"], -1).indices, m, [(0, 64, 64)])
    assert not keep.all()
    ref = decoder._moe(m, w, "layers.0.", h, [(0, 64, 64)])
    torch.testing.assert_close(ref, port, atol=1e-5, rtol=1e-5)


def test_moe_keep_is_first_come_per_expert():
    m = {"n_experts": 8, "top_k": 2}
    top_e = torch.tensor([[0, 1]] * 12 + [[2, 3]] * 3)
    keep = decoder.moe_keep(top_e, m, [(0, 15, 15)])
    cap = decoder.capacity(15, m)
    assert cap == 8
    assert keep[:8].all() and not keep[8:12].any() and keep[12:].all()


@pytest.mark.parametrize("name", CONFIGS)
def test_program_passes_and_control_fails_at_smoke_size(name):
    from h100bench.serve import build_engine, serve
    from h100bench.traffic.generator import traces
    m = _smoke.SMOKE_CONFIGS[name]
    cell = _smoke.smoke_cell(name)
    engine = build_engine(m, cell, 21, torch.device("cpu"))
    win = serve(engine, traces(_smoke.SMOKE_MIX, cell["rate_rps"], 21, m["vocab_size"]), 0.0)
    emitted = engine.emitted()
    picked = check.sample(win.requests, emitted, 3, 21)
    ref, gap, missing = check.served_gaps(m, 21, picked, emitted, engine.chunk_log, "cpu")
    got = check.readings(torch.cat(gap))
    assert missing == 0 and got["logit_gap"] <= _smoke.SMOKE_LIMIT
    control = check.lower_precision(m, 21, picked, engine.chunk_log, "cpu", ref, "fp8")
    assert control["logit_gap"] > 10 * _smoke.SMOKE_LIMIT


def test_gaps_and_readings():
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.2, 0.1]])
    gap = decoder.gaps(ref, torch.tensor([2, 0]))
    assert gap.tolist() == [1.0, 0.0]
    r = check.readings(gap)
    assert r["logit_gap"] == 1.0 and r["mean_logit_gap"] == 0.5
    assert r["token_mismatch_pct"] == 50.0 and r["gap_over_0.2_pct"] == 50.0
    assert decoder.fed_tokens([9, 9], 4) == [9, 9, 2, 3, 4]
    assert decoder.emit_positions(2, 4) == [1, 2, 3, 4]
