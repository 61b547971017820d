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
  clipping, then the config-selected optimizer (AdamW / Adafactor), given
  the model's ``param_stacks`` so that it treats the per-layer tensors as
  the reference's stacked leaves (Adafactor's clip and factoring, and its
  state's layout, depend on them).

The state is ``{"step": int, "params": {name: parameter}, "opt": ...}``;
its parameters are the model's own tensors, so the step updates the model
in place.  ``abstract_train_state`` gives its layout as meta tensors (the
step and the optimizer's count as int32 scalars, as the reference's) and
``train_state_axes`` the logical axes to shard it by (``launch.dryrun``).

On DTensors (the dry run) a microbatch takes the same rows of every
device's shard of the batch, so it stays sharded over the data axes and
moves nothing, and the accumulators are ``zeros_like`` the parameters.
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
    return {"step": 0, "params": params,
            "opt": opt.init(params, model.param_stacks())}


def abstract_train_state(model: Model, optimizer=None) -> dict:
    """The train state's layout as meta tensors, allocating nothing."""
    opt = optimizer or make_optimizer(model.cfg.optimizer)
    params = model.abstract_params()
    state = opt.init(params, model.param_stacks())
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    state["count"] = scalar
    return {"step": scalar.clone(), "params": params, "opt": state}


def train_state_axes(model: Model, optimizer=None) -> dict:
    opt = optimizer or make_optimizer(model.cfg.optimizer)
    param_axes = model.param_axes()
    return {"step": (), "params": param_axes,
            "opt": opt.state_axes(param_axes, model.param_stacks())}


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch tensor: rows [i*size,
    (i+1)*size); of a DTensor, those rows of each device's shard."""
    if type(x) is torch.Tensor:
        size = len(x) // n
        return x[i * size:(i + 1) * size]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    size = len(local) // n
    return DTensor.from_local(local[i * size:(i + 1) * size], x.device_mesh,
                              x.placements, run_check=False,
                              shape=(len(x) // n,) + tuple(x.shape[1:]),
                              stride=local.stride())


def _each(body: Callable, items: list) -> list:
    return [body(x) for x in items]


def make_train_step(model: Model, *, microbatches: int = 1,
                    learning_rate: float = 3e-4, max_grad_norm: float = 1.0,
                    impl: str = "auto", optimizer=None,
                    grad_transform: Optional[Callable[[Tree], Tree]] = None,
                    scan: Callable[[Callable, list], list] = _each):
    """The batch holds numpy arrays or tensors, ``tokens`` and ``labels``
    (B,S) with B divisible by ``microbatches``; they are moved to
    ``model.device``.  ``scan(body, microbatches)`` runs the microbatch
    loop, the reference's ``lax.scan``: by default ``body`` on each in
    order; the dry run's runs it once and counts it once per microbatch,
    as the reference's cost analysis counts a scan's body by its trip
    count (``launch.dryrun.StepMeter.scan``)."""
    opt = optimizer or make_optimizer(model.cfg.optimizer)
    stacks = model.param_stacks()

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
            mbs = [{k: _microbatch(v, i, microbatches)
                    for k, v in batch.items()} for i in range(microbatches)]
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            def accumulate(mb):
                mb_loss, mb_metrics, g = loss_and_grads(params, mb)
                for name, gi in g.items():
                    grads[name].add_(gi)
                return mb_loss.float(), mb_metrics

            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            stacked: Dict[str, list] = {}
            for mb_loss, mb_metrics in scan(accumulate, mbs):
                loss = loss + mb_loss
                for k, m in mb_metrics.items():
                    stacked.setdefault(k, []).append(m)
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
            metrics = {k: torch.stack(ms).mean() for k, ms in stacked.items()}

        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        opt.update(grads, state["opt"], params, learning_rate, stacks)
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
