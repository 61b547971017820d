"""Serve a smoke model with the port's continuous-batching engine (chunked
prefill, bucketed static shapes, CUDA graphs on the card) over a
ShareGPT-like trace; print TTFT/TPOT percentiles.  The counterpart of
``examples/serve_demo.py``.

    PYTHONPATH=src python examples/torch_serve_demo.py [--arch yi-9b] [-n 20]
    PYTHONPATH=src python examples/torch_serve_demo.py --cpu

On the card (the default) attention runs through the hand-written kernels
(``--backend kernel``); with ``--cpu`` the same backend runs their plain
versions on CPU tensors.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.serving import Engine, SchedulerConfig
from repro_torch.sim import metrics as M
from repro_torch.workload import sharegpt_like


def main(arch: str, n: int, backend: str, cpu: bool):
    cfg = get_smoke_config(arch)
    sched = SchedulerConfig(max_num_seqs=8, max_batch_tokens=128,
                            chunk_size=64)
    eng = Engine(cfg, sched_config=sched, max_seq=256, impl=backend,
                 device="cpu" if cpu else "cuda")
    reqs = sharegpt_like(n, rate=2.0, seed=0, scale=0.08,
                         vocab=cfg.vocab_size)
    res = eng.run(reqs)
    m = M.request_metrics(res["requests"])
    print(f"{cfg.name} ({backend}, {eng.device}): served {n} requests in "
          f"{res['makespan']:.2f}s over {len(res['iterations'])} iterations")
    for k in ("ttft", "tpot"):
        pct = {p: float(np.percentile(m[k], p)) for p in (50, 90, 99)}
        print(f"  {k}: " + "  ".join(f"p{p}={v * 1e3:.1f}ms"
                                     for p, v in pct.items()))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("-n", type=int, default=20)
    ap.add_argument("--backend", default="kernel",
                    choices=["kernel", "xla", "chunked", "chunked_naive"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --cpu to run on the CPU")
    main(args.arch, args.n, args.backend, args.cpu)
