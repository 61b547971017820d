"""Train a smoke-scale model with the port's full training substrate: the
sharded data pipeline, the microbatched train step (float32 accumulators,
remat, clipping), asynchronous checkpoints with a restart from the last
committed one, and optional int8 gradient compression.  The counterpart of
``examples/train_demo.py``.

    PYTHONPATH=src python examples/torch_train_demo.py [--arch yi-9b] \
        [--steps 200] [--compress-grads]
    PYTHONPATH=src python examples/torch_train_demo.py --cpu

On the card (the default) attention runs through the hand-written flash
forward and backward (``impl="kernel"``); with ``--cpu`` the same backend
runs their plain versions on CPU tensors.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.parallel.compression import make_grad_compression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.trainer import init_train_state, make_train_step


def main(args):
    cfg = get_smoke_config(args.arch)
    model = Model(cfg, device="cpu" if args.cpu else "cuda")
    stream = TokenStream(DataConfig(cfg.vocab_size, args.batch, args.seq),
                         process_index=0, process_count=1)
    state = init_train_state(model)
    step_fn = make_train_step(
        model, microbatches=2, learning_rate=1e-3, impl="kernel",
        grad_transform=make_grad_compression() if args.compress_grads
        else None)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    t0 = time.time()
    for i in range(args.steps):
        state, m = step_fn(state, stream.batch_at(i))
        if i % 25 == 0:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1) * 1e3:.0f} ms/step)")
        if i % 100 == 99 or i == args.steps - 1:
            saver.save(i + 1, state)
    saver.wait()
    print(f"final loss={float(m['loss']):.4f} after {args.steps} steps "
          f"on {model.device}")

    # fault-tolerance demo: restart from the last committed checkpoint
    restored, step = ckpt.restore(ckpt_dir, state)
    print(f"\nrestored checkpoint @ step {step}; resuming one step...")
    _, m = step_fn(restored, stream.batch_at(step))
    print(f"resumed loss={float(m['loss']):.4f}  (checkpoints in {ckpt_dir})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --cpu to run on the CPU")
    main(args)
