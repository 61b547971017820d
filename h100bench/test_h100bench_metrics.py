"""The metric arithmetic on hand-made windows and traces: the percentiles,
rates and per-layer readers, the work counts behind the roofline and the
MFU, and the reading of a profiler trace."""
import json
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from h100bench import run
from h100bench.devtrace import END, START, Summary, kernel_patterns
from h100bench.metrics import work

TINY = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
        "d_ff": 16, "vocab_size": 10, "sliding_window": 5, "swa_interleave": 2}
TINY_MOE = dict(TINY, n_experts=4, top_k=2, moe_d_ff=6, moe_interleave=1,
                sliding_window=0)
PEAKS = json.loads((run.BENCH / "metrics" / "peaks.json").read_text())


def _req(arrival, first, finish, generated, prompt_len=10):
    return NS(arrival=arrival, first_token_t=first, finish_t=finish,
              generated=generated, prompt_len=prompt_len)


def _rec(n_decodes, n_chunks, model_s, n_prefill_tokens=0):
    return NS(n_decodes=n_decodes, n_chunks=n_chunks, model_s=model_s,
              n_prefill_tokens=n_prefill_tokens)


def _ctx(**kw):
    base = dict(model=TINY, trace=None, root=run.BENCH, peaks=PEAKS, setup_s=12.5,
                traced_decodes=[], traced_chunks=[])
    base.update(kw)
    return NS(**base)


def test_end_to_end_readers():
    reqs = [_req(0.0, 0.5, 2.5, 5), _req(1.0, 1.2, 1.6, 3), _req(2.0, 4.0, 4.0, 1)]
    reqs += [_req(3.0 + i, 3.1 + i, 3.5 + i, 9) for i in range(7)]
    ttft = [r.first_token_t - r.arrival for r in reqs]
    tpot = [(r.finish_t - r.first_token_t) / max(r.generated - 1, 1) for r in reqs]
    win = NS(requests=reqs, records=[], wall_s=4.0)
    ctx = _ctx(window=win, lengths=[(r.prompt_len, r.generated) for r in reqs])
    read = {n: run._reader(n)(ctx) for n in
            ("ttft_p90_ms", "tpot_p90_ms", "output_tok_per_s", "setup_s")}
    assert read["ttft_p90_ms"] == pytest.approx(np.percentile(ttft, 90) * 1e3)
    assert read["tpot_p90_ms"] == pytest.approx(np.percentile(tpot, 90) * 1e3)
    assert read["output_tok_per_s"] == pytest.approx((5 + 3 + 1 + 63) / 4.0)
    assert read["setup_s"] == 12.5


def test_engine_readers():
    recs = [_rec(4, 0, 0.010), _rec(2, 1, 0.050, 200), _rec(0, 2, 0.030, 100),
            _rec(6, 0, 0.014)]
    ctx = _ctx(window=NS(requests=[], records=recs, wall_s=1.0), lengths=[])
    assert run._reader("sched.decode_rows")(ctx) == pytest.approx(4.0)
    assert run._reader("engine.decode_iter_ms")(ctx) == pytest.approx(12.0)
    assert run._reader("engine.chunk_ms_per_ktok")(ctx) == pytest.approx(80 / 300 * 1e3)
    # nothing to read off the card without a trace
    for name in ("decode_attention_roofline", "device.idle_pct", "step_mfu"):
        assert run._reader(name)(ctx) is None


def _brute_flops(m, p, g):
    hd, h = m["head_dim"], m["n_heads"]
    n, flops = p + g - 1, 0
    for i in range(m["n_layers"]):
        w = work.layer_window(m, i)
        flops += 2 * work.layer_matmul_params(m, i) * n
        flops += sum(4 * h * hd * (min(q + 1, w) if w else q + 1) for q in range(n))
    return flops + 2 * m["d_model"] * m["vocab_size"] * g


@pytest.mark.parametrize("m", [TINY, TINY_MOE], ids=["dense", "moe"])
def test_work_counts(m):
    assert work.model_flops(m, [(7, 4), (3, 1)]) == _brute_flops(m, 7, 4) + _brute_flops(m, 3, 1)
    # one request served as two chunks and three decode steps
    parts = (work.token_flops(m, 0, 4, 0) + work.token_flops(m, 4, 7, 1)
             + sum(work.token_flops(m, q, q + 1, 1) for q in (7, 8, 9)))
    assert parts == pytest.approx(work.model_flops(m, [(7, 4)]))
    flops, nbytes = work.decode_attention_work(m, [7, 8])
    keys = sum((min(q + 1, w) if w else q + 1) for q in (7, 8)
               for w in (work.layer_window(m, i) for i in range(m["n_layers"])))
    assert flops == 4 * m["n_heads"] * m["head_dim"] * keys
    assert nbytes == 2 * (2 * m["n_kv_heads"] * m["head_dim"] * keys
                          + 2 * m["n_heads"] * m["head_dim"] * 2 * m["n_layers"])
    assert work.layer_matmul_params(TINY_MOE, 0) == (2 * 8 * 8 + 2 * 8 * 4 + 8 * 4
                                                    + 2 * 3 * 8 * 6)


class _Ev:
    def __init__(self, name, start, dur, cuda=True, annotation=False):
        self._n, self._s, self._d, self._c, self._a = name, start, dur, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_summary():
    ms = 1_000_000
    events = [_Ev(START, 0, 0, cuda=False), _Ev(END, 100 * ms, 0, cuda=False),
              _Ev("h100bench.execute", 0, 60 * ms, cuda=False),
              _Ev("h100bench.reset", 70 * ms, 20 * ms, cuda=False),
              _Ev("h100bench.execute", 10 * ms, 30 * ms, annotation=True),
              _Ev("void decode_split_kernel<128>", 10 * ms, 20 * ms),
              _Ev("decode_merge_kernel", 25 * ms, 10 * ms),
              _Ev("gemm", 50 * ms, 5 * ms), _Ev("gemm", 95 * ms, 10 * ms)]
    s = Summary(events)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx((25 + 5 + 5) * 1e-3)
    # gaps 0-10 and 35-50 ms inside an iteration, 55-95 ms inside a reset
    assert s.idle == pytest.approx({"host inside Engine.execute": 0.025,
                                    "Engine.reset between traces": 0.040})
    pats = kernel_patterns(run.BENCH, "decode_attention_roofline")
    assert s.device_seconds(pats) == pytest.approx(0.030)
    assert s.device_seconds(["nothing"]) is None
    b = s.breakdown()
    assert b["device_ops"][0] == ["void decode_split_kernel<128>", pytest.approx(0.02)]
    ctx = _ctx(model=TINY, trace=s, window=NS(requests=[], records=[], wall_s=1.0),
               lengths=[], traced_decodes=[7, 8], traced_chunks=[(0, 7, True)])
    assert run._reader("device.idle_pct")(ctx) == pytest.approx(65.0)
    flops, nbytes = work.decode_attention_work(TINY, [7, 8])
    assert run._reader("decode_attention_roofline")(ctx) == pytest.approx(
        100 * max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"]) / 0.03)
    mfu = (work.token_flops(TINY, 7, 8, 1) + work.token_flops(TINY, 8, 9, 1)
           + work.token_flops(TINY, 0, 7, 1)) / (0.1 * PEAKS["bf16_flops"]) * 100
    assert run._reader("step_mfu")(ctx) == pytest.approx(mfu)
