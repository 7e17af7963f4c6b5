"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis.

The JAX package's ``pipeline_forward`` (``parallel/pipeline.py:27``) runs
a layer stack as a ``ppermute`` rotation inside ``shard_map``: each member
of ``stage_axis`` owns a contiguous slab of layers; microbatches enter at
stage 0 and activations hop stage to stage, each stage servicing whatever
sits in its inbound slot.  Here each rank of the axis holds its own slab
already (``stage_params``) and the hop is
:func:`~repro_torch.parallel.collectives.ppermute`.

The schedule is ``n_micro + s - 1`` ticks for ``n_micro`` microbatches and
``s`` stages, so steady-state utilization is ``n_micro / (n_micro + s -
1)``.  A stage computes only at the ticks where a microbatch sits in its
slot (the JAX package computes on the zeros of the other ticks too and
throws them away: the same outputs).  The last stage banks the finished
microbatches, and the result is then given to every stage, as the JAX
package's final ``psum`` gives it (here a sum in which only the last stage
contributes, so it is exact).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import ppermute, psum


def pipeline_forward(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,             # this stage's slab of layers
    x: torch.Tensor,               # (n_micro, micro_batch, ...), every rank
    *,
    mesh,
    stage_axis: str = "pod",
    layers_per_stage: int,
) -> torch.Tensor:
    """Forward ``x`` through all stages; returns (n_micro, micro_batch,
    ...) on every rank.  ``layer_fn(stage_params, h) -> h`` applies this
    stage's ``layers_per_stage`` layers."""
    if len(stage_params) != layers_per_stage:
        raise ValueError(f"a stage holds {len(stage_params)} layers, not "
                         f"{layers_per_stage}")
    n_stages = mesh.axis_size(stage_axis)
    stage = mesh.axis_index(stage_axis)
    n_micro = x.shape[0]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                    # the microbatch in this slot
        h = buf
        if 0 <= mb < n_micro:
            h = layer_fn(stage_params, x[mb] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs[mb] = h
        buf = ppermute(h, mesh, stage_axis)
    keep = outs if stage == n_stages - 1 else torch.zeros_like(outs)
    return psum(keep, mesh, stage_axis)
