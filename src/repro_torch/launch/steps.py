"""Step factories: the train step on one card or over a mesh, and the
serving steps over a mesh.

The JAX package's ``make_train_step`` (``launch/steps.py``) jits one step
over a mesh with shardings and donation; here the step is a plain
function that each rank runs on its blocks of the state
(``sharding.rank_spec``) and its rows of the batch, with the context
:func:`make_ctx` builds (``ShardCtx.specs``: the forward gathers each
layer's FSDP shards and carries gradients through its collectives).
After the backward pass the gradient exchange completes what the
collectives' backward left: a leaf split over the data axis already has
its gradient summed over it (``fsdp_gather``'s reduce-scatter); a leaf
that is not is summed over the data axes here (one f32 ``psum`` for all
of them).  Under a plan's sequence parallelism (``seq_parallel``,
``models/blocks.py``) the norm scales are applied to each model rank's
chunk of the sequence, so their gradients are partial on each model rank
and are summed over the model axis too (:func:`chunked_leaves`); the
global norm then counts each of them once, as any leaf held alike by the
model ranks.  The exchange is exact, in f32: the JAX package's step never
calls ``compressed_psum``, so neither does this one.  The AdamW update
of a block is elementwise; only the global norm crosses ranks.  Without
a mesh the same step runs on one card.  It runs the model's plain path
(``impl="ref"``), as the JAX package's step does: none of the
hand-written kernels has a backward pass, and their wrappers refuse
inputs that require gradients.

The serving steps (``make_serve_step``, ``make_prefill_step``) are plain
functions over a :class:`~repro_torch.launch.mesh.Mesh`, nothing jitted:
each rank runs them on its shards (``weights.shard_params``) and its rows
of the batch, with the context ``make_ctx`` builds.
:func:`cache_shardings` gives the JAX package's spec of each decode-cache
leaf; the rank's own cache (``lm.init_lm_cache`` with the context) is its
block of it where the heads divide the model axis (a head is never split:
see ``models/blocks.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core.codesign import CodesignPlan
from repro_torch.models.api import ModelApi
from repro_torch.models.blocks import ShardCtx
from repro_torch.parallel.sharding import (batch_axes_of, jax_path,
                                           norm_weight, plan_fsdp, rank_spec,
                                           spec_axes)
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWState, adamw_update, warmup_cosine


def default_plan(api: ModelApi, microbatches: int = 1) -> CodesignPlan:
    """The JAX package's trainer's plan: FSDP and TP, the model's remat,
    no sequence parallelism."""
    return CodesignPlan(sharding="fsdp_tp", microbatches=microbatches,
                        remat=api.cfg.remat, seq_parallel=False)


def make_train_step(api: ModelApi, mesh=None,
                    plan: Optional[CodesignPlan] = None, *,
                    microbatches: Optional[int] = None,
                    lr_peak: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, impl: str = "ref"
                    ) -> tuple[Callable, ShardCtx]:
    """Returns (train_step, ctx).

    ``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    runs forward, backward and the AdamW update; ``params`` (an ``LM``
    whose parameters require gradients) is updated in place and returned,
    ``opt_state`` is replaced.  ``batch`` holds ``tokens`` and ``labels``
    (B, S) on the parameters' device (on a mesh, the rank's rows of the
    global batch, ``InputPipeline(mesh=...)``), and may hold a
    ``loss_mask``.  ``microbatches`` (default: the plan's, else 1)
    accumulates the gradients over that many equal splits of the global
    batch, in f32.  On ``mesh`` the parameters and the AdamW state are
    the rank's blocks under ``plan`` (default :func:`default_plan`):
    ``weights.init_sharded(..., plan=plan)``, ``ctx.specs`` by JAX path.
    The model's remat policy is ``api.cfg.remat``."""
    if microbatches is None:
        microbatches = plan.microbatches if plan is not None else 1
    elif plan is not None and plan.microbatches != microbatches:
        raise ValueError(f"microbatches={microbatches} but the plan has "
                         f"{plan.microbatches}")
    if mesh is None:
        ctx = ShardCtx(impl=impl)
    else:
        ctx = make_ctx(api, mesh, plan or default_plan(api, microbatches),
                       impl, train=True)

    def loss_fn(params: LM, batch: dict):
        return api.loss(params, batch, ctx)

    def step(params: LM, opt_state: AdamWState, batch: dict):
        names = [n for n, _ in params.named_parameters()]
        weights = list(params.parameters())
        if microbatches > 1:
            grads, (loss, aux) = _accumulated_grads(
                loss_fn, params, weights, batch, microbatches, ctx)
        else:
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, weights)
        split = norm_weights = None
        if mesh is not None:
            specs = [ctx.specs[jax_path(n)] for n in names]
            grads = _exchange(grads, specs, ctx,
                              chunked_leaves(names, api.cfg, ctx, batch))
            split = [spec_axes(s) for s in specs]
            norm_weights = [norm_weight(s, mesh, g.device)
                            for s, g in zip(specs, grads)]
        # the step counter is pre-increment: schedule on step + 1 so the
        # very first update trains at a nonzero warmup rate
        lr = warmup_cosine(opt_state.step + 1, peak_lr=lr_peak,
                           warmup=warmup, total=total_steps)
        new, opt_state, om = adamw_update(grads, opt_state, weights, lr=lr,
                                          mesh=mesh, split_axes=split,
                                          norm_weights=norm_weights)
        with torch.no_grad():
            for w, n in zip(weights, new):
                w.copy_(n)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return params, opt_state, metrics

    return step, ctx


#: the norm scales' leaf names: each is applied to the layer-boundary
#: activation, the rank's chunk of the sequence under sequence parallelism
NORM_LEAVES = ("ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm")


def chunked_leaves(names: list[str], cfg, ctx: ShardCtx,
                   batch: dict) -> list[bool]:
    """For each parameter (by its ``named_parameters`` name), whether the
    step applied it to the rank's chunk of a sequence (sequence
    parallelism, ``ShardCtx.shards_act``), so that its gradient is
    partial on each model rank: the norm scales of a stack whose sequence
    the context split.  An enc-dec's encoder (``enc_layers``,
    ``enc_norm``) runs over its ``frames``, its decoder over its
    ``tokens``; a decoder's sequence is its tokens after a VLM's
    patches."""
    s_dec = batch["tokens"].shape[1] + (
        cfg.frontend_len if cfg.frontend and cfg.family != "encdec" else 0)
    sp_dec = ctx.shards_act(s_dec)
    sp_enc = "frames" in batch and ctx.shards_act(batch["frames"].shape[1])
    return [n.split(".")[-1] in NORM_LEAVES
            and (sp_enc if n.split(".")[0] in ("enc_layers", "enc_norm")
                 else sp_dec) for n in names]


def _exchange(grads, specs, ctx: ShardCtx,
              chunked: Optional[list[bool]] = None) -> list[torch.Tensor]:
    """Each gradient summed over the data axes its leaf is not split over
    (a split leaf's was summed by its gather's backward), and over the
    model axis too where ``chunked`` (:func:`chunked_leaves`), in f32: the
    leaves that need the same axes travel as one flat f32 ``psum``."""
    from repro_torch.parallel.collectives import psum
    out = [g.float() for g in grads]
    chunked = chunked or [False] * len(out)
    groups: dict[tuple[str, ...], list[int]] = {}
    for i, spec in enumerate(specs):
        rest = {a for a in ctx.batch_axes if a not in spec_axes(spec)}
        if chunked[i]:
            rest.add(ctx.model_axis)
        rest = tuple(a for a in ctx.mesh.axis_names if a in rest)
        if ctx.mesh.axis_size(rest) > 1:
            groups.setdefault(rest, []).append(i)
    for axes in sorted(groups):
        idx = groups[axes]
        flat = psum(torch.cat([out[i].reshape(-1) for i in idx]), ctx.mesh,
                    axes)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def _accumulated_grads(loss_fn, params: LM, weights: list[torch.Tensor],
                       batch: dict, n_micro: int, ctx: ShardCtx
                       ) -> tuple[list, tuple]:
    """Gradients summed in f32 over ``n_micro`` equal splits of the global
    batch and divided by their count; the loss is the microbatches' mean,
    aux the last microbatch's.  Microbatch ``i`` is rows ``[i B / n,
    (i + 1) B / n)`` of the global batch, as the JAX package's reshape
    splits it; on a mesh each rank computes its block of those rows, so
    the (small) token batch is gathered over the data axes first."""
    local = _global_batch(batch, ctx)
    b = next(iter(local.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    size = b // n_micro
    dp, r = 1, 0
    if ctx.mesh is not None:
        dp = ctx.mesh.axis_size(ctx.batch_axes)
        r = ctx.mesh.axis_index(ctx.batch_axes)
        if size % dp:
            raise ValueError(f"a microbatch of {size} rows does not split "
                             f"over {dp} data ranks")
    rows = size // dp
    acc = [torch.zeros_like(w, dtype=torch.float32) for w in weights]
    loss_sum: Any = 0.0
    aux: dict = {}
    for i in range(n_micro):
        lo = i * size + r * rows
        mb = {k: v[lo:lo + rows] for k, v in local.items()}
        loss, aux = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, weights)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    return [a / n_micro for a in acc], (loss_sum / n_micro, aux)


def _global_batch(batch: dict, ctx: ShardCtx) -> dict:
    """The global batch: on a mesh the ranks' rows gathered over the data
    axes, in their order; without one, ``batch``."""
    if ctx.mesh is None:
        return batch
    from repro_torch.parallel.collectives import all_gather
    return {k: all_gather(v, ctx.mesh, ctx.batch_axes)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Serving over a mesh
# ---------------------------------------------------------------------------


def make_ctx(api: ModelApi, mesh, plan: Optional[CodesignPlan] = None,
             impl: str = "cuda", *, train: bool = False) -> ShardCtx:
    """The model context of ``mesh`` (None: one device); with ``train``,
    a training mesh's under ``plan``: ``specs`` maps each parameter's JAX
    path to what the rank holds of it (``sharding.rank_spec``).  A plan's
    ``seq_parallel`` is recorded on the context (Megatron sequence
    parallelism, ``models/blocks.py``), for every family."""
    seq_parallel = plan is not None and plan.seq_parallel
    axes = batch_axes_of(mesh) if mesh is not None else ("data",)
    specs = None
    if train:
        from repro_torch.weights import param_shapes
        fsdp = plan_fsdp(plan or default_plan(api))
        specs = {jax_path(n): rank_spec(n, s, api.cfg, mesh, fsdp=fsdp)
                 for n, s in param_shapes(api.cfg).items()}
    return ShardCtx(impl=impl, mesh=mesh, batch_axes=axes,
                    model_axis="model", specs=specs,
                    seq_parallel=seq_parallel)


def make_serve_step(api: ModelApi, mesh, plan: Optional[CodesignPlan] = None,
                    *, impl: str = "cuda") -> tuple[Callable, ShardCtx]:
    """Returns (serve_step, ctx): ``serve_step(params, cache, tokens) ->
    (logits, cache)``, one decode token against the rank's cache (written
    in place); every model rank gets the whole logits."""
    ctx = make_ctx(api, mesh, plan, impl)

    def step(params, cache: dict, tokens: torch.Tensor):
        return api.decode_step(params, cache, tokens, ctx)
    return step, ctx


def make_prefill_step(api: ModelApi, mesh,
                      plan: Optional[CodesignPlan] = None, *, max_len: int,
                      impl: str = "cuda") -> tuple[Callable, ShardCtx]:
    """Returns (prefill_step, ctx): ``prefill_step(params, batch) -> (last
    logits, populated cache)`` on the rank's rows."""
    ctx = make_ctx(api, mesh, plan, impl)

    def step(params, batch: dict):
        return api.prefill(params, batch, ctx, max_len)
    return step, ctx


def _dp(mesh) -> int:
    out = 1
    for a in batch_axes_of(mesh):
        out *= mesh.shape[a]
    return out


def cache_shardings(cache_shapes: Mapping[str, Any], mesh) -> dict:
    """The JAX package's decode-cache specs, by leaf kind.  ``cache_shapes``
    maps each leaf's name (``k``, ``v``, ``shared_k``, ``conv``, ``ssm``,
    ``pos``) to its whole, layer-stacked shape.

    KV-like leaves (L, B, S, H, hd): batch over the data axes when it
    divides, else the *sequence* over data (long-context batch 1); heads
    over model when divisible, else the sequence takes the model axis.
    Mamba states (L, B, ...): batch over data, feature dims over model when
    divisible.  Scalars replicated."""
    axes = batch_axes_of(mesh)
    dp = _dp(mesh)
    m = mesh.shape["model"]

    def leaf(name: str, shape: tuple[int, ...]) -> tuple:
        nd = len(shape)
        if nd == 0:
            return ()
        if nd == 5:          # (L, B, S, H, hd) attention caches
            L, B, S, H, _ = shape
            b_ax = axes if (B % dp == 0 and B >= dp) else None
            h_ax = "model" if H % m == 0 else None
            if h_ax is None and S % m == 0:
                s_ax = "model"
            elif b_ax is None and S % dp == 0:
                s_ax = axes
            else:
                s_ax = None
            return (None, b_ax, s_ax, h_ax, None)
        if nd == 4 and name in ("conv", ""):   # (L, B, W, C) conv state
            L, B, W, C = shape
            b_ax = axes if (B % dp == 0 and B >= dp) else None
            c_ax = "model" if C % m == 0 else None
            return (None, b_ax, None, c_ax)
        if nd >= 3:          # (L, B, H, P, N) ssm state and friends
            B = shape[1]
            b_ax = axes if (B % dp == 0 and B >= dp) else None
            spec = [None, b_ax] + [None] * (nd - 2)
            if shape[2] % m == 0:
                spec[2] = "model"
            return tuple(spec)
        return (None,) * nd

    return {name: leaf(name, tuple(shape))
            for name, shape in cache_shapes.items()}
