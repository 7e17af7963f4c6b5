"""AdamW with f32 master weights over bf16 compute parameters.

The JAX package's optimizer, on tensors: the model's parameters are bf16
(what the matmuls consume); the optimizer holds an f32 master copy and f32
first and second moments, updates in f32 and casts back.  The state is
plain lists of tensors in the parameters' order (``list(lm.parameters())``),
each on its parameter's device; :func:`repro_torch.weights.jax_tree` lays
them out as the JAX package's tree for a checkpoint.

``torch.optim.AdamW`` is not used: it decays the weights outside the
learning-rate product of the update (``w *= 1 - lr * wd``, then the Adam
step), while this update puts ``wd * w`` inside it, on the f32 master, and
``torch.optim`` keeps no f32 master to cast back to bf16 parameters.
Scalars (the step, bias corrections, the learning rate) are f32 tensors on
the parameters' device, as the JAX package computes them in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor               # () int32
    master: list[torch.Tensor]       # f32 copy of params
    m: list[torch.Tensor]            # f32 first moment
    v: list[torch.Tensor]            # f32 second moment


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    params = list(params)
    device = params[0].device if params else "cpu"
    with torch.no_grad():
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            master=[p.detach().float().clone() for p in params],
            m=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            v=[torch.zeros_like(p, dtype=torch.float32) for p in params])


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Grads in f32, scaled so their global norm is at most ``max_norm``;
    returns (grads, the norm before scaling)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g.float() * scale for g in grads], norm


@torch.no_grad()
def adamw_update(
    grads: Sequence[torch.Tensor],
    state: AdamWState,
    params: Sequence[torch.Tensor],
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> tuple[list[torch.Tensor], AdamWState, dict]:
    """One AdamW step.  Returns (new params in the params' dtypes, new
    state, metrics); the inputs are left as they were."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    t = step.float()
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, **f32), t)
    lr = torch.as_tensor(lr, **f32)

    new_m, new_v, new_w = [], [], []
    for g, m, v, w in zip(grads, state.m, state.v, state.master):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        w = w - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * w)
        new_m.append(m)
        new_v.append(v)
        new_w.append(w)
    new_state = AdamWState(step=step, master=new_w, m=new_m, v=new_v)
    cast = [w.to(p.dtype) for w, p in zip(new_w, params)]
    return cast, new_state, {"grad_norm": gnorm, "lr": lr}


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to floor*peak, in f32."""
    t = step.float()
    warm = peak_lr * t / max(1.0, float(warmup))
    prog = torch.clamp((t - warmup) / max(1.0, float(total - warmup)),
                       0.0, 1.0)
    cos = peak_lr * (floor + (1.0 - floor) * 0.5
                     * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
