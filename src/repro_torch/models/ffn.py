"""Feed-forward blocks: the SwiGLU MLP and the Mixture-of-Experts.

The MoE has two single-device paths that compute one function:

* :func:`moe_ref` — the JAX package's dense no-drop oracle: every expert on
  every token, masked, with the f32 combine.  ``ShardCtx(impl="ref")``
  runs it, as the JAX package's one-device path does (with no mesh its
  ``ShardCtx.choose_moe`` returns ``"ref"``).
* :func:`moe_dispatch` — the card's path: a no-drop sorted dispatch.  The
  T·k (token, expert) pairs are sorted by expert, stably, as the JAX
  package's ``_local_dispatch`` sorts them; top-k picks k distinct
  experts, so expert e's rows are one contiguous segment of at most T
  rows.  There is no capacity, no (E, C, D) buffer and no dropped token:
  each expert runs its gate, up and down matmuls over its own rows only.
  At top 8 of 128 experts :func:`moe_ref` does E / k = 16 times these
  FLOPs, and reads every expert's weights at every decode step.

No Pallas kernel covers the MoE in the JAX package, so the expert matmuls
are ``torch.matmul``, as the JAX package leaves them to XLA.  The split
into segments needs the expert counts on the host: one device-to-host
copy per layer call.

On a mesh (``ShardCtx.choose_moe`` -> :func:`choose_moe_impl`) the JAX
package's two multi-device paths, with its **capacity** semantics: each
shard of tokens dispatches into (E, C, D) buffers of ``C =
ceil(t * k * capacity_factor / E)`` rows an expert, and the (token,
expert) pairs past an expert's C are dropped, which ``moe_dispatch``
never does.  So a mesh run matches the JAX package's mesh run, not the
one-device path.

* :func:`moe_ep` — expert parallelism: the tokens split over the batch
  and model axes (:func:`_token_axes`), each shard routes and dispatches
  its own, the buffers go to the experts' owners by an all-to-all over the
  model axis, and back.  Used where ``n_experts % model == 0``.
* :func:`moe_tp` — tensor parallelism inside the experts: every model
  rank routes its data row's tokens identically, computes every expert
  over its slice of ``d_ff``, and the partial outputs are summed over the
  model axis.

A rank's activations are its data row's tokens, whole over the model axis
(``models/blocks.py``); each path takes and returns them so.  Under
Megatron sequence parallelism the layer hands them over whole too
(``blocks.ffn_apply`` gathers the rank's chunk of the sequence first), so
each shard routes the tokens, and drops the pairs, it routes without the
split: the JAX package's GSPMD reshards the chunks into the same token
blocks, and the plan changes no value of the MoE.  The expert
matmuls are ``torch.bmm`` here too.  Both carry gradients through their
collectives (``parallel/collectives.py``), whose forwards are the plain
ops, so serving and a training mesh run the same code: the EP exchanges
through ``all_to_all_grad``, the row split and the output gather through
``split_model`` / ``gather_model``, partial sums through
``enter_region`` / ``leave_region``.  Each path says where its partial
gradients are and are not (the router's under ``moe_tp`` is whole on
every model rank).

A :class:`RouteLog` (``ShardCtx.routes``) records every :func:`route`
call's decisions (and, on the capacity paths, which pairs were kept), so
a caller can hold two paths' routing against each other, or impose one
run's decisions on another.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .config import ModelConfig


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (x W_g) SiLU * (x W_u) -> W_d; the SiLU in f32."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# Routing (shared by both MoE paths)
# ---------------------------------------------------------------------------

class RouteLog:
    """The routing decisions of one run, in call order: every
    :func:`route` call given this log appends its ``(experts (T, k),
    probs (T, E) f32)`` to ``calls`` (one entry per MoE layer per forward,
    prefill or decode step); the capacity paths (:func:`moe_ep`,
    :func:`moe_tp`) append ``(kept (T, k) bool, first, total)`` to
    ``kept``: which of the call's pairs their buffers held, and where the
    call's T tokens start among the layer's ``total``.

    Made with ``forced`` (one entry per call of another run of the same
    calls: its experts, or a pair of its experts and kept pairs), the n-th
    call takes the entry's experts instead of its own top-k and gates them
    by its own probabilities, renormalised as usual, and zeroes the gates
    of the pairs not kept: the same function with the other run's
    tie-breaks and drops."""

    def __init__(self, forced: Optional[Sequence] = None):
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.kept: list[tuple[torch.Tensor, int, int]] = []
        self._forced = iter(forced) if forced is not None else None

    def choose(self, probs: torch.Tensor, top_k: int
               ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(gate values, experts, kept pairs or None) of this call,
        recorded."""
        keep = None
        if self._forced is None:
            gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
        else:
            expert_idx = next(self._forced)
            if isinstance(expert_idx, tuple):
                expert_idx, keep = (t.to(probs.device) for t in expert_idx)
            expert_idx = expert_idx.to(probs.device)
            gate_vals = torch.gather(probs, -1, expert_idx)
        self.calls.append((expert_idx.detach(), probs.detach()))
        return gate_vals, expert_idx, keep


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
          log: Optional[RouteLog] = None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x: (T, D) -> (gates (T, k) f32, experts (T, k),
    probs (T, E) f32, logits (T, E) f32): f32 router logits, softmax,
    top-k, gates renormalised over the k.  ``log`` records (or imposes)
    the decisions; an imposed pair that was not kept gates 0."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    keep = None
    if log is None:
        gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    else:
        gate_vals, expert_idx, keep = log.choose(probs, top_k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    if keep is not None:
        gate_vals = gate_vals * keep
    return gate_vals, expert_idx, probs, logits


def aux_losses(probs: torch.Tensor, expert_idx: torch.Tensor,
               n_experts: int, logits: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local (tokens-per-expert, prob-mass, z-loss) sums.  Callers must
    reduce count and mass separately before multiplying: the global
    load-balance term is count_global x mass_global."""
    one_hot = F.one_hot(expert_idx, n_experts).float()       # (T, k, E)
    tokens_per_expert = one_hot.sum(dim=(0, 1))              # (E,)
    prob_mass = probs.sum(dim=0)                             # (E,)
    z_num = torch.sum(torch.square(torch.logsumexp(logits, dim=-1)))
    return tokens_per_expert, prob_mass, z_num


def _aux(probs, eidx, logits, cfg: ModelConfig, total: float):
    """(load-balance loss, router z-loss) of one layer's T tokens."""
    moe = cfg.moe
    counts, mass, z_num = aux_losses(probs, eidx, moe.n_experts, logits)
    lb = moe.n_experts * torch.sum(counts * mass) / (total * total
                                                     * moe.top_k)
    return lb, z_num / total


# ---------------------------------------------------------------------------
# Dense oracle (the plain version)
# ---------------------------------------------------------------------------


def moe_ref(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, cfg: ModelConfig,
            log: Optional[RouteLog] = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """No-drop dense-compute MoE: every expert on every token, masked.
    O(T*E*F), and it holds (T, E, D) outputs: the correctness oracle.
    Returns (y (B, S, D), load-balance loss, router z-loss)."""
    moe = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    gates, eidx, probs, logits = route(xt, w_router, moe.top_k, log)
    g = torch.einsum("td,edf->tef", xt, w_gate)
    u = torch.einsum("td,edf->tef", xt, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    del g, u
    y_all = torch.einsum("tef,efd->ted", h, w_down)          # (T, E, D)
    del h
    mask = F.one_hot(eidx, moe.n_experts).float()            # (T, k, E)
    w = (mask * gates[..., None]).sum(dim=1)                 # (T, E)
    y = torch.einsum("ted,te->td", y_all.float(), w).to(x.dtype)
    lb, z = _aux(probs, eidx, logits, cfg, float(B * S))
    return y.reshape(B, S, D), lb, z


# ---------------------------------------------------------------------------
# No-drop sorted dispatch (the card's path)
# ---------------------------------------------------------------------------


def moe_dispatch(x: torch.Tensor, w_router: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, *, cfg: ModelConfig,
                 log: Optional[RouteLog] = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`moe_ref`'s function over each expert's own tokens.

    The T·k pairs are sorted by expert, stably; expert e takes its
    contiguous segment (at most T rows, since top-k picks distinct
    experts): gate and up matmuls, SiLU in f32 as :func:`swiglu` does,
    the down matmul rounded to the activation dtype as ``moe_ref``'s
    ``y_all`` is.  The rows go back to (token, k) order by a gather, are
    scaled by their gates and summed over k in f32, then cast once, as
    ``moe_ref`` rounds.  No capacity, no drop; deterministic (a gather,
    not an atomic scatter).  Returns (y (B, S, D), load-balance loss,
    router z-loss), ``moe_ref``'s aux terms."""
    moe = cfg.moe
    B, S, D = x.shape
    T, k = B * S, moe.top_k
    xt = x.reshape(T, D)
    gates, eidx, probs, logits = route(xt, w_router, k, log)
    e_flat = eidx.reshape(T * k)
    order = torch.argsort(e_flat, stable=True)
    xs = xt[order // k]                     # pair j of token t is t*k + j
    # expert e's segment is [starts[e], starts[e + 1]) of the sorted pairs
    starts = torch.searchsorted(e_flat[order], torch.arange(
        moe.n_experts + 1, device=x.device, dtype=e_flat.dtype))
    starts = starts.tolist()                # the one host sync
    outs = []
    for e in range(moe.n_experts):
        lo, hi = starts[e], starts[e + 1]
        if lo == hi:
            continue
        xe = xs[lo:hi]
        g = xe @ w_gate[e]
        u = xe @ w_up[e]
        h = F.silu(g.float()).to(x.dtype) * u
        outs.append(h @ w_down[e])
    ys = torch.cat(outs)                    # (T*k, D), sorted by expert
    y_tk = ys[torch.argsort(order)].reshape(T, k, D)
    y = (y_tk.float() * gates[..., None]).sum(dim=1).to(x.dtype)
    lb, z = _aux(probs, eidx, logits, cfg, float(T))
    return y.reshape(B, S, D), lb, z


# ---------------------------------------------------------------------------
# Capacity dispatch, shared by the multi-device paths
# ---------------------------------------------------------------------------


def _local_dispatch(x: torch.Tensor, expert_idx: torch.Tensor,
                    gates: torch.Tensor, n_experts: int, capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch of local tokens into (E, C, D) buffers.

    The T·k pairs sorted by expert, stably; a pair's position is its rank
    among its expert's pairs, and a pair at position >= C is dropped.
    Returns (buffer, sorted experts, sorted token ids, positions (0 where
    dropped), kept) — the latter four drive the inverse combine."""
    t, d = x.shape
    k = expert_idx.shape[-1]
    e_flat = expert_idx.reshape(t * k)
    tok_flat = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    st = tok_flat[order]
    counts = torch.bincount(se, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, 0)
    buf = torch.zeros((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    contrib = torch.where(keep[:, None], x[st], 0)
    buf.index_put_((se, safe_pos), contrib, accumulate=True)
    return buf, se, st, safe_pos, keep


def _local_combine(y: torch.Tensor, se: torch.Tensor, st: torch.Tensor,
                   pos: torch.Tensor, keep: torch.Tensor,
                   order_gates: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of :func:`_local_dispatch` with gate weighting: each kept
    pair's row scaled by its gate, summed per token in f32, rounded once
    (the JAX package scatter-adds in the activation dtype)."""
    gathered = y[se, pos]                       # (t*k, D)
    weighted = gathered.float() * (order_gates * keep)[:, None]
    out = torch.zeros((t, y.shape[-1]), dtype=torch.float32, device=y.device)
    return out.index_add_(0, st, weighted).to(y.dtype)


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(1, math.ceil(tokens * top_k * cf / n_experts))


def _token_axes(total_tokens: int, mesh, batch_axes: tuple[str, ...],
                model_axis: str) -> tuple[str, ...]:
    """Widest axis tuple that evenly divides the token count.  Decode
    shapes (a handful of tokens) degrade gracefully: tokens replicate over
    the axes they cannot split across (redundant-but-correct dispatch)."""
    full = tuple(batch_axes) + (model_axis,)

    def prod(axes):
        out = 1
        for a in axes:
            out *= mesh.shape[a]
        return out
    if total_tokens % prod(full) == 0 and total_tokens >= prod(full):
        return full
    if (total_tokens % prod(batch_axes) == 0
            and total_tokens >= prod(batch_axes)):
        return tuple(batch_axes)
    return ()


def choose_moe_impl(cfg: ModelConfig, mesh, model_axis: str = "model"
                    ) -> str:
    """EP when experts divide the model axis, else TP-inside-experts."""
    m = mesh.shape.get(model_axis, 1)
    if cfg.moe and cfg.moe.n_experts % m == 0:
        return "ep"
    return "tp"


def _row_tokens(x: torch.Tensor, mesh, batch_axes, tok_axes
                ) -> tuple[torch.Tensor, int, int]:
    """The tokens a data row routes, from the rank's (Bl, S, D): its own
    rows' (Bl * S, D) where the tokens split over the batch axes, else
    every row's, gathered.  Returns them, the first one's index among the
    layer's tokens, and the layer's token count."""
    Bl, S, D = x.shape
    dp = mesh.axis_size(batch_axes)
    rows = x.reshape(Bl * S, D)
    if set(batch_axes) <= set(tok_axes):
        return rows, mesh.axis_index(batch_axes) * Bl * S, dp * Bl * S
    from repro_torch.parallel.collectives import all_gather
    return all_gather(rows, mesh, batch_axes), 0, dp * Bl * S


def _own_rows(out: torch.Tensor, x: torch.Tensor, mesh, batch_axes,
              tok_axes) -> torch.Tensor:
    """The inverse of :func:`_row_tokens`: the rank's rows, (Bl, S, D)."""
    Bl, S, D = x.shape
    if not set(batch_axes) <= set(tok_axes):
        i = mesh.axis_index(batch_axes)
        out = out[i * Bl * S:(i + 1) * Bl * S]
    return out.reshape(Bl, S, D)


def _experts(recv: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU per expert: (E', C', D) against (E', D, F') ... -> (E', C',
    D); the SiLU in f32 as :func:`swiglu` does."""
    g = torch.bmm(recv, w_gate)
    u = torch.bmm(recv, w_up)
    h = F.silu(g.float()).to(recv.dtype) * u
    return torch.bmm(h, w_down)


def _aux_over(probs, eidx, logits, cfg: ModelConfig, total: float, mesh,
              axes) -> tuple[torch.Tensor, torch.Tensor]:
    """(load-balance loss, router z-loss) with the count, mass and z sums
    reduced over ``axes`` before they are combined (the global
    estimator: see :func:`aux_losses`).  The mass and z sums leave the
    region of the ranks that route disjoint tokens (``leave_region``:
    every rank's gradient of a sum is the sum's); the counts carry no
    gradient."""
    from repro_torch.parallel import collectives as coll
    moe = cfg.moe
    counts, mass, z_num = aux_losses(probs, eidx, moe.n_experts, logits)
    if axes:
        counts = coll.psum(counts, mesh, axes)
        mass, z_num = (coll.leave_region(t, mesh, axes)
                       for t in (mass, z_num))
    lb = moe.n_experts * torch.sum(counts * mass) / (total * total
                                                     * moe.top_k)
    return lb, z_num / total


def _records_grad(*ts: torch.Tensor) -> bool:
    """Whether this forward records gradients for any of ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _kept_by_token(keep: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """The sorted pairs' kept flags back in (token, k) order."""
    order = torch.argsort(eidx.reshape(-1), stable=True)
    out = torch.empty_like(keep)
    out[order] = keep
    return out.reshape(eidx.shape)


# ---------------------------------------------------------------------------
# Expert-parallel path (all_to_all over the model axis)
# ---------------------------------------------------------------------------


def moe_ep(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor, *, cfg: ModelConfig,
           mesh, batch_axes: tuple[str, ...], model_axis: str = "model",
           log: Optional[RouteLog] = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE layer on the rank's rows x (Bl, S, D), the batch
    split evenly over ``batch_axes``; the rank holds experts
    ``[i * E/ep, (i + 1) * E/ep)`` (``w_gate`` (E/ep, D, F) ...), where i
    is its index on the model axis, whole over every other axis (on a
    training mesh ``ShardCtx.gathered`` gathers FSDP's split first).
    Returns (y (Bl, S, D), load-balance loss, router z-loss).

    The forward carries gradients: the rank's share of the row is cut by
    ``split_model`` and the outputs come back by ``gather_model``, the
    buffers travel by ``all_to_all_grad``; each model rank routes only
    its own tokens, so the router weight enters the model region (its
    gradient summed over the model axis) and the mass and z sums leave
    the token axes.  Tokens too few to split over the model axis (a
    decode step) are routed whole by every model rank, which serves but
    would count the experts' gradients once a member, so a forward that
    records gradients refuses them."""
    from repro_torch.parallel import collectives as coll
    moe = cfg.moe
    ep = mesh.shape[model_axis]
    if moe.n_experts % ep:
        raise ValueError(f"{moe.n_experts} experts do not split over "
                         f"{ep} model ranks")
    Bl, S, D = x.shape
    total = mesh.axis_size(batch_axes) * Bl * S
    tok_axes = _token_axes(total, mesh, batch_axes, model_axis)
    if _records_grad(x, w_router) and model_axis not in tok_axes:
        raise ValueError(f"training moe_ep needs the {total} tokens to split "
                         f"over the batch and model axes {tok_axes}")
    rows, first, total = _row_tokens(x, mesh, batch_axes, tok_axes)
    xl, wr = rows, w_router
    if model_axis in tok_axes:           # this rank's share of the row
        first += mesh.axis_index(model_axis) * (rows.shape[0] // ep)
        xl = coll.split_model(rows, mesh, model_axis)
        wr = coll.enter_region(w_router, mesh, model_axis)
    cap = _capacity(xl.shape[0], moe.top_k, moe.n_experts,
                    moe.capacity_factor)
    gates, eidx, probs, logits = route(xl, wr, moe.top_k, log)
    buf, se, st, pos, keep = _local_dispatch(xl, eidx, gates,
                                             moe.n_experts, cap)
    order_gates = gates.reshape(-1)[torch.argsort(eidx.reshape(-1),
                                                  stable=True)]
    # exchange: (E, C, D) -> (E/ep, C*ep, D) on the experts' owner
    recv = coll.all_to_all_grad(buf, mesh, model_axis, split_dim=0,
                                concat_dim=1)
    yl = _experts(recv, w_gate, w_up, w_down)
    back = coll.all_to_all_grad(yl, mesh, model_axis, split_dim=1,
                                concat_dim=0)
    out = _local_combine(back, se, st, pos, keep, order_gates, xl.shape[0])
    if log is not None:
        log.kept.append((_kept_by_token(keep, eidx), first, total))
    lb, z = _aux_over(probs, eidx, logits, cfg, float(total), mesh,
                      tok_axes)
    if model_axis in tok_axes:
        out = coll.gather_model(out, mesh, model_axis)
    return _own_rows(out, x, mesh, batch_axes, tok_axes), lb, z


# ---------------------------------------------------------------------------
# Tensor-parallel-experts path (every expert over a slice of d_ff)
# ---------------------------------------------------------------------------


def moe_tp(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor, *, cfg: ModelConfig,
           mesh, batch_axes: tuple[str, ...], model_axis: str = "model",
           log: Optional[RouteLog] = None, sum_out: bool = True
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TP-inside-experts MoE (the expert count need not divide the mesh)
    on the rank's rows x (Bl, S, D); the rank holds every expert's slice
    ``[i * F/m, (i + 1) * F/m)`` of ``d_ff`` (``w_gate`` (E, D, F/m),
    ``w_down`` (E, F/m, D)).  Every model rank routes the row's tokens
    (the JAX package all-gathers them; the rank holds them already) with
    the row's capacity, and the partial outputs are summed over the model
    axis.  Returns (y (Bl, S, D), load-balance loss, router z-loss).
    With ``sum_out`` False y is the rank's partial sum, for the caller to
    reduce (under sequence parallelism ``ShardCtx.seq_leave``'s
    reduce-scatter, whose backward gathers the gradient where
    ``leave_region``'s passes it).

    Only the expert path is partial: the rows that fill the buffers and
    the gates that weight the combine enter the model region, the
    partial outputs leave it; routing and the aux terms are whole on
    every model rank, so the router's gradient is too (summing it over
    the model axis would count the aux terms m times).  Rows gathered
    over the batch axes (a decode step) carry no gradient, so a forward
    that records gradients refuses them."""
    from repro_torch.parallel import collectives as coll
    moe = cfg.moe
    m = mesh.shape[model_axis]
    if w_gate.shape[-1] * m != moe.d_ff_expert:
        raise ValueError(f"expert d_ff {moe.d_ff_expert} is not split over "
                         f"{m} model ranks (w_gate {tuple(w_gate.shape)})")
    Bl, S, D = x.shape
    total = mesh.axis_size(batch_axes) * Bl * S
    tok_axes = _token_axes(total, mesh, batch_axes, model_axis)
    if _records_grad(x, w_router) and not set(batch_axes) <= set(tok_axes):
        raise ValueError(f"training moe_tp needs the {total} tokens to split "
                         f"over the batch axes {tuple(batch_axes)}")
    xr, first, total = _row_tokens(x, mesh, batch_axes, tok_axes)
    cap = _capacity(xr.shape[0], moe.top_k, moe.n_experts,
                    moe.capacity_factor)
    gates, eidx, probs, logits = route(xr, w_router, moe.top_k, log)
    xd, gd = (coll.enter_region(t, mesh, model_axis) for t in (xr, gates))
    buf, se, st, pos, keep = _local_dispatch(xd, eidx, gd, moe.n_experts,
                                             cap)
    order_gates = gd.reshape(-1)[torch.argsort(eidx.reshape(-1),
                                               stable=True)]
    y_part = _experts(buf, w_gate, w_up, w_down)   # partial over F
    out = _local_combine(y_part, se, st, pos, keep, order_gates,
                         xr.shape[0])
    if sum_out:
        out = coll.leave_region(out, mesh, model_axis)
    if log is not None:
        log.kept.append((_kept_by_token(keep, eidx), first, total))
    row_axes = tuple(a for a in tok_axes if a != model_axis)
    lb, z = _aux_over(probs, eidx, logits, cfg, float(total), mesh,
                      row_axes)
    return _own_rows(out, x, mesh, batch_axes, tok_axes), lb, z
