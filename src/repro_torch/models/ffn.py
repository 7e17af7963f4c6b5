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
copy per layer call.  The expert-parallel and tensor-parallel paths
(``moe_ep``, ``moe_tp``, ``choose_moe_impl``) wait for multi-device.

A :class:`RouteLog` (``ShardCtx.routes``) records every :func:`route`
call's decisions, so a caller can hold two paths' routing against each
other, or impose one run's decisions on another.
"""

from __future__ import annotations

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
    prefill or decode step).  Made with ``forced`` (the experts of each
    call of another run of the same calls), the n-th call takes
    ``forced[n]`` instead of its own top-k and gates those experts by its
    own probabilities: the same function with the other run's
    tie-breaks."""

    def __init__(self, forced: Optional[Sequence[torch.Tensor]] = None):
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._forced = iter(forced) if forced is not None else None

    def choose(self, probs: torch.Tensor, top_k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(gate values, experts) of this call, recorded."""
        if self._forced is None:
            gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
        else:
            expert_idx = next(self._forced).to(probs.device)
            gate_vals = torch.gather(probs, -1, expert_idx)
        self.calls.append((expert_idx.detach(), probs.detach()))
        return gate_vals, expert_idx


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
          log: Optional[RouteLog] = None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x: (T, D) -> (gates (T, k) f32, experts (T, k),
    probs (T, E) f32, logits (T, E) f32): f32 router logits, softmax,
    top-k, gates renormalised over the k.  ``log`` records (or imposes)
    the decisions."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    if log is None:
        gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    else:
        gate_vals, expert_idx = log.choose(probs, top_k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
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
