"""Train step: microbatched gradient accumulation + remat + clipping.

Counterpart of ``repro.train.trainer``.  ``make_train_step(model, ...)``
returns ``train_step(state, batch) -> (state, metrics)``:

* the global batch is split into ``microbatches`` chunks run one after the
  other (bounds activation + logits memory — required for the 128K-vocab
  models);
* each microbatch's loss runs with remat per layer (``cfg.remat``, through
  ``torch.utils.checkpoint``);
* with several microbatches the grads are accumulated in float32 buffers
  and divided by their count, as the reference's fp32 accumulators are
  (autograd's ``.grad`` would add in the parameter dtype); with one they
  stay in the parameter dtype;
* an optional ``grad_transform`` (``parallel.compression``), then global
  clipping, then the config-selected optimizer (AdamW / Adafactor).

The state is ``{"step": int, "params": {name: parameter}, "opt": ...}``;
its parameters are the model's own tensors, so the step updates the model
in place.  ``abstract_train_state`` and ``train_state_axes`` wait for the
parallel slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.models.zoo import Model
from repro_torch.train.optimizer import clip_by_global_norm, make_optimizer

Tree = Dict[str, torch.Tensor]


def init_train_state(model: Model, optimizer=None) -> dict:
    """The train state around the model's current parameters."""
    opt = optimizer or make_optimizer(model.cfg.optimizer)
    params = dict(model.named_parameters())
    return {"step": 0, "params": params, "opt": opt.init(params)}


def make_train_step(model: Model, *, microbatches: int = 1,
                    learning_rate: float = 3e-4, max_grad_norm: float = 1.0,
                    impl: str = "auto", optimizer=None,
                    grad_transform: Optional[Callable[[Tree], Tree]] = None):
    """The batch holds numpy arrays or tensors, ``tokens`` and ``labels``
    (B,S) with B divisible by ``microbatches``; they are moved to
    ``model.device``."""
    opt = optimizer or make_optimizer(model.cfg.optimizer)

    def loss_and_grads(params: Tree, mb: Mapping[str, torch.Tensor]):
        loss, metrics = model.loss(mb, impl=impl)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(state: dict, batch: Mapping[str, Any]):
        params = state["params"]
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            rows = len(batch["tokens"])
            if rows % microbatches:
                raise ValueError(f"a batch of {rows} rows does not split into "
                                 f"{microbatches} microbatches")
            size = rows // microbatches
            mbs = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                   for i in range(microbatches)]
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            stacked: Dict[str, list] = {}
            for mb in mbs:
                mb_loss, mb_metrics, g = loss_and_grads(params, mb)
                for name, gi in g.items():
                    grads[name].add_(gi)
                del g
                loss = loss + mb_loss.float()
                for k, m in mb_metrics.items():
                    stacked.setdefault(k, []).append(m)
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
            metrics = {k: torch.stack(ms).mean() for k, ms in stacked.items()}

        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        opt.update(grads, state["opt"], params, learning_rate)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        state["step"] += 1
        return state, metrics

    return train_step


def default_microbatches(cfg, shape, dp_size: int = 1) -> int:
    """Keep microbatch logits (tokens x vocab fp32) + activations bounded.

    Hard cap: the per-microbatch batch must stay divisible by (>=) the
    data-parallel axis, or every data-parallel rank would run the whole
    microbatch.
    """
    if shape.kind != "train":
        return 1
    tokens = shape.total_tokens
    # target ~= 32k tokens per microbatch for wide models, 64k for narrow
    target = 32_768 if cfg.d_model >= 4096 or cfg.vocab_size >= 100_000 \
        else 65_536
    m = min(max(1, tokens // target), max(1, shape.global_batch // dp_size))
    while shape.global_batch % m != 0 or (shape.global_batch // m) % dp_size:
        m -= 1
    return max(m, 1)
