"""How far bf16 training gradients lie from a float32 reference, through the
flash kernels and through plain attentions.

Part 1, one attention call at each of ``chip_smoke.py`` phase 17's training
shapes: random bf16 q, k, v and dO; dQ, dK and dV through the flash kernels
(``kernel``), the port's plain materialized attention (``plain``: float32
inside, bf16 in and out) and SDPA under a boolean mask (``sdpa``: bf16
products), each against float64 autograd of the same function on the same
bf16 inputs.  Prints each route's relative L2 error.

Part 2, one model's gradients on one microbatch: the bf16 model's through
each attention route, every route with the same plain chunked scan,
against those of a float32 copy of the same weights through the plain
attention.  Prints, per route, the per-tensor relative L2 error (least,
median, largest), the least cosine, and the ratio of the kernel's error to
the plain route's, tensor by tensor.

Part 3 (``--trace``, on the card): ``torch.profiler`` over one AdamW train
step of four such microbatches with remat, the device time by kind of
kernel and of the ten busiest; then one Mamba mixer's forward and backward
with the plain chunked scan timed alone, and scaled to the step.

Needs an NVIDIA GPU unless ``--cpu`` (a smoke config, plain routes)::

    PYTHONPATH=src python examples/torch_grad_precision.py --trace
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def reference_grads(q, k, v, do, causal: bool, window: int):
    """dq, dk, dv of masked attention in float64 autograd."""
    from repro_torch.kernels.flash_attention import _mask
    h, kv = q.shape[2], k.shape[2]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    qd, kd, vd = leaves
    kd = kd.repeat_interleave(h // kv, dim=2)
    vd = vd.repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(q.shape[-1])
    mask = _mask(q.shape[1], k.shape[1], causal, window, 0, q.device)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    return torch.autograd.grad(out, leaves, do.double())


def sdpa_attention(q, k, v, causal, window, q_offset):
    """SDPA on (B,S,H,D) tensors under the boolean mask of causal, window
    and q_offset; GQA by repeating K/V."""
    from repro_torch.kernels.flash_attention import _mask
    h, kv = q.shape[2], k.shape[2]
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    k, v = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    return out.transpose(1, 2)


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float(torch.linalg.vector_norm(a.double() - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-300))


def part_attention(shapes, device, seed: int) -> list:
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import _materialized
    routes = {"kernel": lambda q, k, v, c, w: kops.flash_attention(q, k, v, c, w),
              "plain": lambda q, k, v, c, w: _materialized(q, k, v, c, w, 0),
              "sdpa": lambda q, k, v, c, w: sdpa_attention(q, k, v, c, w, 0)}
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for label, b, s, h, kv, d, window in shapes:
        def rand(*shape):
            return torch.randn(*shape, generator=gen).to(device, torch.bfloat16)
        q, k, v, do = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d), \
            rand(b, s, h, d)
        want = reference_grads(q, k, v, do, True, window)
        row = {"shape": label}
        for name, fn in routes.items():
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            got = torch.autograd.grad(fn(*leaves, True, window), leaves, do)
            row[name] = {g: rel(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
        print(f"[attention] {label}: relative L2 error against float64 "
              + "; ".join(f"{n} " + " ".join(f"{g} {e:.3e}" for g, e in r.items())
                          for n, r in row.items() if n != "shape"), flush=True)
        out.append(row)
        del want
    return out


@contextlib.contextmanager
def chunked_attention_as(fn):
    """Route the model's ``chunked`` attention through ``fn`` (the Mamba
    branch keeps the plain chunked scan)."""
    from repro_torch.models import attention
    old = attention._ATTENTION["chunked"]
    attention._ATTENTION["chunked"] = fn
    try:
        yield
    finally:
        attention._ATTENTION["chunked"] = old


def grads_of(model, batch, impl: str) -> list:
    params = list(model.parameters())
    return [g.detach() for g in torch.autograd.grad(
        model.loss(batch, impl=impl)[0], params)]


def part_model(cfg, device, rows: int, seq: int, seed: int) -> dict:
    from repro_torch.models import Model
    from repro_torch.models.attention import _materialized
    from repro_torch.train.data import DataConfig, TokenStream
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Model(cfg, device=device, dtype=torch.bfloat16, generator=gen)
    names = [n for n, _ in model.named_parameters()]
    batch = TokenStream(DataConfig(cfg.vocab_size, rows, seq)).batch_at(0)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    ref_model = Model(cfg, device=device, dtype=torch.float32,
                      generator=torch.Generator(device=device).manual_seed(seed))
    ref_model.load_state_dict(model.state_dict())
    ref = grads_of(ref_model, batch, "chunked")
    del ref_model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    routes = {"kernel": ("kernel", None), "chunked": ("chunked", None),
              "materialized": ("chunked", _materialized),
              "sdpa": ("chunked", sdpa_attention)}
    errs, coss = {}, {}
    for route, (impl, fn) in routes.items():
        with (chunked_attention_as(fn) if fn else contextlib.nullcontext()):
            t0 = time.perf_counter()
            got = grads_of(model, batch, impl)
            dt = time.perf_counter() - t0
        errs[route] = np.array([rel(g, r) for g, r in zip(got, ref)])
        coss[route] = np.array([float(F.cosine_similarity(
            g.double().flatten(), r.double().flatten(), dim=0))
            for g, r in zip(got, ref)])
        e, c = errs[route], coss[route]
        worst = np.argsort(-e)[:3]
        print(f"[model] {cfg.name} bf16 through {route} ({dt:.2f} s): relative "
              f"L2 error to float32 per tensor least {e.min():.3e} median "
              f"{np.median(e):.3e} largest {e.max():.3e}; least cosine "
              f"{c.min():.6f}; worst "
              + ", ".join(f"{names[i]} {e[i]:.3e}" for i in worst), flush=True)
    out = {"errors": {k: v.tolist() for k, v in errs.items()},
           "cosines": {k: v.tolist() for k, v in coss.items()}, "names": names}
    for route in ("kernel", "sdpa", "materialized"):
        ratio = errs[route] / np.maximum(errs["chunked"], 1e-30)
        worst = int(np.argmax(ratio))
        q = np.quantile(ratio, [0.5, 0.9, 0.99])
        print(f"[model] error ratio {route} / chunked per tensor: median "
              f"{q[0]:.3f}, 90 % {q[1]:.3f}, 99 % {q[2]:.3f}, largest "
              f"{ratio[worst]:.3f} ({names[worst]}: {errs[route][worst]:.3e} "
              f"vs {errs['chunked'][worst]:.3e}); above 2: "
              f"{int((ratio > 2).sum())} of {ratio.size}", flush=True)
    del model
    return out


def part_trace(cfg, device, rows: int, seq: int, microbatches: int) -> dict:
    from torch.profiler import DeviceType, ProfilerActivity, profile
    from repro_torch.models import Model
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.trainer import init_train_state, make_train_step
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    state = init_train_state(model, make_optimizer("adamw"))
    step = make_train_step(model, microbatches=microbatches, impl="kernel",
                           optimizer=make_optimizer("adamw"))
    stream = TokenStream(DataConfig(cfg.vocab_size, microbatches * rows, seq))
    state, m = step(state, stream.batch_at(0))
    float(m["loss"])
    t0 = time.perf_counter()
    state, m = step(state, stream.batch_at(1))
    float(m["loss"])
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, stream.batch_at(2))
        float(m["loss"])
        prof_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_kind = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        kind = next((k for k, words in KINDS if any(w in e.name for w in words)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    total = sum(by_name.values()) * 1e-3
    print(f"[trace] one AdamW step of {cfg.name}, {microbatches} x {rows} x "
          f"{seq} tokens with remat: {plain_s:.3f} s unprofiled, {prof_s:.3f} s "
          f"under torch.profiler; {len(kernels)} kernels, device time "
          f"{total:.1f} ms: " + ", ".join(
              f"{k} {v * 1e-3:.1f} ms" for k, v in
              sorted(by_kind.items(), key=lambda kv: -kv[1])), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    for name, us in top:
        print(f"  {us * 1e-3:10.1f} ms  {name[:100]}")
    # the Mamba mixers' share, timed alone: with remat each layer runs its
    # forward, then forward and backward again, for every microbatch
    mixer = model.layers[0].mamba
    h = torch.randn(rows, seq, cfg.d_model, device=device,
                    dtype=model.dtype, requires_grad=True)
    fwd_ms = _event_ms(lambda: mixer(h, impl="chunked"))
    fb_ms = _event_ms(lambda: torch.autograd.grad(
        mixer(h, impl="chunked").float().sum(), [h] + list(mixer.parameters())))
    n_mamba = sum(d.kind in ("mamba", "hybrid") for d in model.descs)
    mixers_s = n_mamba * microbatches * (fwd_ms + fb_ms) * 1e-3
    print(f"[trace] one Mamba mixer with the plain chunked scan on {rows} x "
          f"{seq} tokens: forward {fwd_ms:.2f} ms, forward and backward "
          f"{fb_ms:.2f} ms (CUDA events); x {n_mamba} layers x {microbatches} "
          f"microbatches = {mixers_s:.3f} s of the {plain_s:.3f} s step",
          flush=True)
    return {"step_s": plain_s, "profiled_s": prof_s, "device_ms": total,
            "by_kind_ms": {k: v * 1e-3 for k, v in by_kind.items()},
            "top": [(n, us * 1e-3) for n, us in top],
            "mixer_fwd_ms": fwd_ms, "mixer_fwd_bwd_ms": fb_ms,
            "mixers_s": mixers_s}


#: kernel name fragments -> the kind a trace sums them under
KINDS = (("flash", ("flash_",)),
         ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("elementwise", ("elementwise", "vectorized")),
         ("reduce", ("reduce",)))


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default="", help="write the numbers as JSON here")
    ap.add_argument("--cpu", action="store_true",
                    help="the arch's smoke config on the CPU, plain routes")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config, get_smoke_config
    if args.cpu:
        device, cfg = torch.device("cpu"), get_smoke_config(args.arch)
        shapes = [("smoke", 1, 64, 4, 2, 32, 32)]
    elif torch.cuda.is_available():
        from repro_torch.kernels import _build
        _build.build(["flash_attention_fwd", "flash_attention_bwd"])
        device, cfg = torch.device("cuda"), get_config(args.arch)
        shapes = [("hymba-1.5b B=1 S=2048 25/5 D=64 window 1024", 1, 2048, 25, 5, 64, 1024),
                  ("yi-9b B=4 S=1024 32/4 D=128 causal", 4, 1024, 32, 4, 128, 0),
                  ("llama3-8b B=2 S=1024 32/8 D=128 causal", 2, 1024, 32, 8, 128, 0)]
    else:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    if device.type == "cuda":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    res = {"attention": part_attention(shapes, device, args.seed),
           "model": part_model(cfg, device, args.rows, args.seq, args.seed)}
    if args.trace and device.type == "cuda":
        res["trace"] = part_trace(cfg, device, args.rows, args.seq, microbatches=4)
    if args.out:
        Path(args.out).write_text(json.dumps(res))
    print("grad precision: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
