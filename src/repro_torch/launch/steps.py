"""The train step on one card: forward, backward, AdamW.

The JAX package's ``make_train_step`` (``launch/steps.py``) jits the same
step over a mesh with shardings and donation; here there is one card, so
the step is a plain function.  It runs the model's plain path
(``impl="ref"``), as the JAX package's step does: none of the hand-written
kernels has a backward pass, and their wrappers refuse inputs that
require gradients.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.api import ModelApi
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWState, adamw_update, warmup_cosine


def make_train_step(api: ModelApi, *, microbatches: int = 1,
                    lr_peak: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, impl: str = "ref"
                    ) -> tuple[Callable, ShardCtx]:
    """Returns (train_step, ctx).

    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    runs forward, backward and the AdamW update; ``params`` (an ``LM``
    whose parameters require gradients) is updated in place and returned,
    ``opt_state`` is replaced.  ``batch`` holds ``tokens`` and ``labels``
    (B, S) on the parameters' device.  ``microbatches > 1`` accumulates
    the gradients over that many equal splits of the batch.  The model's
    remat policy is ``api.cfg.remat``."""
    ctx = ShardCtx(impl=impl)

    def loss_fn(params: LM, batch: dict):
        return api.loss(params, batch, ctx)

    def step(params: LM, opt_state: AdamWState, batch: dict):
        weights = list(params.parameters())
        if microbatches > 1:
            grads, (loss, aux) = _accumulated_grads(
                loss_fn, params, weights, batch, microbatches)
        else:
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, weights)
        # the step counter is pre-increment: schedule on step + 1 so the
        # very first update trains at a nonzero warmup rate
        lr = warmup_cosine(opt_state.step + 1, peak_lr=lr_peak,
                           warmup=warmup, total=total_steps)
        new, opt_state, om = adamw_update(grads, opt_state, weights, lr=lr)
        with torch.no_grad():
            for w, n in zip(weights, new):
                w.copy_(n)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return params, opt_state, metrics

    return step, ctx


def _accumulated_grads(loss_fn, params: LM, weights: list[torch.Tensor],
                       batch: dict, n_micro: int) -> tuple[list, tuple]:
    """Gradients summed in f32 over ``n_micro`` equal splits of the batch
    and divided by their count; the loss is the microbatches' mean, aux
    the last microbatch's."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    size = b // n_micro
    acc = [torch.zeros_like(w, dtype=torch.float32) for w in weights]
    loss_sum: Any = 0.0
    aux: dict = {}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, aux = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, weights)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    return [a / n_micro for a in acc], (loss_sum / n_micro, aux)
