"""Collectives over the axes of a mesh, and the compressed and hierarchical
gradient exchanges.

The JAX package names an axis inside ``shard_map`` (``jax.lax.psum``,
``all_gather``, ``all_to_all``, ``psum_scatter``, ``ppermute``); here each
takes the :class:`~repro_torch.launch.mesh.Mesh` and the axes, and runs in
the process group of the ranks that share this rank's other coordinates.
Over an axis of size 1 each returns its input.

The same ops run on a gloo world (CPU tensors, or card tensors of ranks
that share a card) and on an NCCL one.  Where an op of one backend has no
form for some tensor, it is written as ops that every form has, with the
same result:

* sums run in f32 and round once to the input's dtype (a bf16 partial sum
  of a row-split matmul is summed as the one-device matmul accumulates,
  in f32), which also needs no bf16 reduction from the backend;
* ``psum_scatter`` is an ``all_to_all_single`` and a local f32 sum in
  peer order, not ``reduce_scatter``: one order on every backend;
* ``ppermute`` is an ``all_to_all_single`` whose splits are empty but for
  the one peer each way: gloo's ``send`` / ``recv`` take no card tensor.

Autograd does not go through the plain ops above; the serving paths use
them under ``no_grad``.  A training mesh differentiates through
``torch.autograd.Function`` pairs built on them, each backward the
conjugate of its forward (Megatron's ``f`` and ``g``; FSDP's gather; the
MoE's exchanges):

* :func:`fsdp_gather`: ``all_gather`` forward, ``psum_scatter`` of the
  gradient backward (each data rank saw other rows, so their gradients
  of a shard sum);
* :func:`enter_region`: identity forward, ``psum`` of the gradient
  backward, where a replicated activation (or a weight held whole) enters
  a region each rank computes a part of;
* :func:`leave_region`: ``psum`` forward, identity backward, where such a
  region's partial sums leave it (and for a loss's sums over the data
  axes);
* :func:`all_to_all_grad`: ``all_to_all`` forward, the reverse exchange
  (split and concat dims swapped) backward: the MoE's dispatch to the
  experts' owners and its combine back;
* :func:`split_model`: the rank's rows of a replicated activation
  forward, the rows' gradients gathered backward (each member's rows
  got their gradient on that member alone);
* :func:`gather_model`: ``all_gather`` forward, the rank's rows of the
  gradient backward.  Not a reduce-scatter: the gathered activation is
  replicated, so every member holds the same whole gradient of it;
* :func:`gather_seq` and :func:`scatter_seq`: the boundaries of a region
  under Megatron sequence parallelism, where each model rank holds its
  chunk of the sequence outside the region.  Into a region whose work
  the members split, ``all_gather`` forward and ``psum_scatter`` of the
  gradient backward (each member's part of the work gave a part of the
  whole sequence's gradient); out of it, ``psum_scatter`` of the partial
  sums forward and ``all_gather`` of the gradient backward.  Into and
  out of a region every member computes whole, the pair
  :func:`gather_model` / :func:`split_model`.

Every collective of this module adds its wall time to :func:`spent`
(a trainer's share of a step spent in collectives), and the time spent
inside :func:`fsdp_gather`, :func:`all_to_all_grad` and the sequence
boundaries, forward and backward, also to their own kinds (``"fsdp"``,
``"all_to_all"``, ``"seq"``), and the gather of the query-sequence split's
output rows to ``"qseq"`` (``models/blocks.py``).

:func:`compressed_psum` and :func:`hierarchical_psum` are the JAX
package's (``parallel/collectives.py:41``, ``:82``): the paper's finding
that when a path *is* collective-bound, fewer bytes on the wire is the
lever.  On a card tensor the compressed exchange runs the quantize and
dequantize kernels (``kernels/csrc/quantize.cu``), built for 256-value
blocks: another block raises there.  On a CPU tensor it runs their plain
versions at any block.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.optim.compression import (dequantize_int8_blockwise,
                                           quantize_int8_blockwise)


#: wall seconds and calls of this process's collectives (:func:`spent`),
#: and the seconds of each kind
_SPENT = {"seconds": 0.0, "calls": 0, "kinds": {}}
#: the kind the collectives running now count under (:func:`_kind`)
_KIND: list[str] = []


def spent() -> dict:
    """{"seconds", "calls", "kinds"}: the wall time this process has spent
    inside the collectives of this module so far, their number, and the
    seconds of each kind (``"fsdp"``: :func:`fsdp_gather`'s gathers and
    reduce-scatters; ``"all_to_all"``: :func:`all_to_all_grad`'s
    exchanges; ``"seq"``: :func:`gather_seq` and :func:`scatter_seq`;
    ``"qseq"``: the query-sequence split's gather of its output rows),
    each also counted in ``"seconds"``.  A gloo collective of
    card tensors returns once its result is on the card, so its wall time
    covers the copies through the host."""
    return dict(_SPENT, kinds=dict(_SPENT["kinds"]))


def spent_since(before: dict) -> dict:
    """{"seconds", "kinds"}: what :func:`spent` has added since ``before``
    (an earlier :func:`spent`)."""
    now = spent()
    return {"seconds": now["seconds"] - before["seconds"],
            "kinds": {k: v - before["kinds"].get(k, 0.0)
                      for k, v in now["kinds"].items()}}


def _timed(collective, *args, **kw):
    t0 = time.perf_counter()
    try:
        return collective(*args, **kw)
    finally:
        dt = time.perf_counter() - t0
        _SPENT["seconds"] += dt
        _SPENT["calls"] += 1
        if _KIND:
            kinds = _SPENT["kinds"]
            kinds[_KIND[-1]] = kinds.get(_KIND[-1], 0.0) + dt


@contextlib.contextmanager
def _kind(name: Optional[str]):
    """Counts the collectives run inside it under ``name`` too (None:
    under no kind of its own)."""
    if name is None:
        yield
        return
    _KIND.append(name)
    try:
        yield
    finally:
        _KIND.pop()


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes``, in f32, rounded once to ``x``'s dtype; every
    member gets the same result."""
    if mesh.axis_size(axes) == 1:
        return x
    y = x.to(torch.float32, copy=True)
    _timed(dist.all_reduce, y, group=mesh.group(axes))
    return y.to(x.dtype)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (no gradient)."""
    if mesh.axis_size(axes) == 1:
        return x
    y = x.detach().clone()
    _timed(dist.all_reduce, y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return y


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in axis order (the
    JAX package's ``all_gather(..., tiled=True)``)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _timed(dist.all_gather_into_tensor, out, xt, group=mesh.group(axes))
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Chunk ``j`` of ``x`` along ``split_dim`` goes to member ``j``; the
    chunks received, in member order, are concatenated along
    ``concat_dim`` (``jax.lax.all_to_all(..., tiled=True)``)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    chunks = _exchange(torch.stack(x.chunk(n, split_dim)), mesh, axes)
    return torch.cat(chunks.unbind(0), dim=concat_dim)


def _exchange(stacked: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(n, ...) -> (n, ...): row ``j`` to member ``j``; row ``i`` of the
    result came from member ``i``."""
    out = torch.empty_like(stacked)
    _timed(dist.all_to_all_single, out, stacked.contiguous(),
           group=mesh.group(axes))
    return out


def _sum_rows(rows: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """rows[0] + rows[1] + ... in that order, in f32, rounded once."""
    acc = rows[0].float()
    for r in rows[1:]:
        acc = acc + r.float()
    return acc.to(dtype)


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Sum over ``axes`` of chunk ``i`` of ``x`` along ``dim``, on member
    ``i`` (``jax.lax.psum_scatter(..., tiled=True)``): an all-to-all, then
    the peers' chunks summed in member order in f32."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    rows = _exchange(torch.stack(x.chunk(n, dim)), mesh, axes)
    return _sum_rows(rows, x.dtype)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """Member ``i`` sends ``x`` to member ``i + shift`` (mod n) and returns
    what member ``i - shift`` sent (``jax.lax.ppermute`` with the
    permutation ``[(i, (i + shift) % n)]``)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    i = mesh.axis_index(axis)
    size = x.numel()
    send = [size if j == (i + shift) % n else 0 for j in range(n)]
    recv = [size if j == (i - shift) % n else 0 for j in range(n)]
    out = torch.empty_like(x).reshape(-1)
    _timed(dist.all_to_all_single, out, x.contiguous().reshape(-1),
           output_split_sizes=recv, input_split_sizes=send,
           group=mesh.group(axis))
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Collectives that carry gradients
# ---------------------------------------------------------------------------


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        with _kind("fsdp"):
            return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        with _kind("fsdp"):
            g = psum_scatter(g.contiguous(), mesh, axes, dim)
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, *ctx.args), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        with _kind("all_to_all"):
            return all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        with _kind("all_to_all"):
            g = all_to_all(g, mesh, axes, concat_dim, split_dim)
        return g, None, None, None, None


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, kind):
        ctx.args = (mesh, axes, dim, kind)
        return _own_chunk(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, kind = ctx.args
        with _kind(kind):
            g = all_gather(g, mesh, axes, dim)
        return g, None, None, None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, kind):
        ctx.args = (mesh, axes, dim)
        with _kind(kind):
            return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, *ctx.args), None, None, None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        with _kind("seq"):
            return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        with _kind("seq"):
            g = psum_scatter(g.contiguous(), *ctx.args)
        return g, None, None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        with _kind("seq"):
            return psum_scatter(x.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        with _kind("seq"):
            g = all_gather(g, *ctx.args)
        return g, None, None, None


def _own_chunk(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Chunk ``i`` of ``n`` of ``x`` along ``dim``, where ``i`` is this
    member's index along ``axes``."""
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} members")
    return x.chunk(n, dim)[mesh.axis_index(axes)].contiguous()


def all_to_all_grad(x: torch.Tensor, mesh, axes, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` whose gradient takes the reverse exchange: the
    gradient of what member ``j`` received from this one goes back to
    this one (split and concat dims swapped)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


def split_model(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This member's chunk of ``x`` along ``dim`` (``x`` the same on every
    member of ``axes``); the chunks' gradients are gathered, so ``x``'s is
    whole on every member."""
    if mesh.axis_size(axes) == 1:
        return x
    return _SplitModel.apply(x, mesh, axes, dim, None)


def gather_model(x: torch.Tensor, mesh, axes, dim: int = 0, *,
                 kind: Optional[str] = None) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` (:func:`all_gather`);
    the result is the same on every member, so each takes its own chunk of
    the gradient, unsummed.  Counted under ``kind`` too, where given."""
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherModel.apply(x, mesh, axes, dim, kind)


def gather_seq(x: torch.Tensor, mesh, axes, dim: int = 1, *,
               partial: bool) -> torch.Tensor:
    """The whole sequence of which ``x`` is this member's chunk along
    ``dim`` (:func:`all_gather`), as it enters a region under sequence
    parallelism: where the members split the region's work (``partial``)
    the gradient is summed over ``axes`` and this member's chunk of the
    sum kept (:func:`psum_scatter`); where each computes it whole, its own
    chunk of the (same) gradient (:func:`gather_model`).  Counted under
    ``"seq"``."""
    if mesh.axis_size(axes) == 1:
        return x
    if partial:
        return _SeqGather.apply(x, mesh, axes, dim)
    return _GatherModel.apply(x, mesh, axes, dim, "seq")


def scatter_seq(x: torch.Tensor, mesh, axes, dim: int = 1, *,
                partial: bool) -> torch.Tensor:
    """This member's chunk along ``dim`` of ``x``, the whole sequence as it
    leaves a region under sequence parallelism: where ``x`` is a
    ``partial`` sum, the sum over ``axes`` of every member's chunk
    (:func:`psum_scatter`, in member order, in f32), its gradient gathered
    (:func:`all_gather`); where ``x`` is the same on every member, its
    chunk (:func:`split_model`).  Counted under ``"seq"``."""
    if mesh.axis_size(axes) == 1:
        return x
    if partial:
        return _SeqScatter.apply(x, mesh, axes, dim)
    return _SplitModel.apply(x, mesh, axes, dim, "seq")


def fsdp_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The whole of a tensor split over ``axes`` along ``dim``
    (:func:`all_gather`); its gradient is summed over ``axes`` and
    scattered back (:func:`psum_scatter`), so the shard's gradient counts
    every member's rows."""
    if mesh.axis_size(axes) == 1:
        return x
    return _FsdpGather.apply(x, mesh, axes, dim)


def enter_region(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axes``: the members of a
    region each use ``x`` for their part of the work, so each holds a part
    of its gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Enter.apply(x, mesh, axes)


def leave_region(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` (:func:`psum`); its gradient passes to
    each member unchanged: every member uses the same sum."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Leave.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# Compressed and hierarchical exchanges
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor, block: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes (nb, block), f32 scales (nb,)): the kernel on a card
    tensor (its blocks padded to a multiple of 8 with zero blocks), the
    plain quantizer on a CPU tensor."""
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        if block != kops.QUANT_BLOCK:
            raise ValueError(f"the quantize kernels take blocks of "
                             f"{kops.QUANT_BLOCK} values, not {block}")
        return kops.quantize(x)
    return quantize_int8_blockwise(x, block)


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes and scales -> f32 (nb * block,)."""
    shape = (q.numel(),)
    if q.is_cuda:
        from repro_torch.kernels import ops as kops
        return kops.dequantize(q, s, shape)
    return dequantize_int8_blockwise(q, s, shape)


def compressed_psum(x: torch.Tensor, mesh, axis, *, block: int = 256
                    ) -> torch.Tensor:
    """int8-wire sum over ``axis`` (g members):

    1. quantize the local tensor blockwise -> (codes int8, scales f32);
    2. ``all_to_all_single``: member i receives chunk i of every peer's
       codes and scales (the data movement of a reduce-scatter, int8 on
       the wire);
    3. dequantize and sum the g received chunks in f32, in member order;
    4. re-quantize the reduced chunk; ``all_gather_into_tensor`` of codes
       and scales;
    5. dequantize -> the full reduced tensor, in ``x``'s dtype.

    Deterministic, so it composes exactly with error feedback.  The
    kernel pads the blocks to a multiple of 8 and the plain quantizer does
    not; each block is summed and re-quantized alone, so the result does
    not depend on where the chunks split."""
    g = mesh.axis_size(axis)
    if g == 1:
        return x
    q, s = _quantize(x, block)
    pad = (-q.shape[0]) % g
    if pad:
        q = torch.cat([q, q.new_zeros((pad, block))])
        s = torch.cat([s, s.new_zeros(pad)])
    c = q.shape[0] // g
    q_recv = _exchange(q.reshape(g, c, block), mesh, axis)
    s_recv = _exchange(s.reshape(g, c), mesh, axis)
    chunk = _sum_rows(_dequantize(q_recv.reshape(g * c, block),
                                  s_recv.reshape(-1)).reshape(g, c * block),
                      torch.float32)
    qr, sr = _quantize(chunk, block)
    q_all = all_gather(qr[:c].contiguous(), mesh, axis)
    s_all = all_gather(sr[:c].contiguous(), mesh, axis)
    flat = _dequantize(q_all, s_all)
    return flat[:x.numel()].reshape(x.shape).to(x.dtype)


def hierarchical_psum(x: torch.Tensor, mesh, *, intra_axis: str,
                      inter_axis: str, compress_inter: bool = False,
                      block: int = 256) -> torch.Tensor:
    """Two-level sum: reduce-scatter over ``intra_axis`` (the cheap links),
    sum the shard over ``inter_axis`` (the expensive ones; optionally
    int8-compressed), all-gather back over ``intra_axis``.  Cross-axis
    traffic drops by the intra axis's size."""
    g = mesh.axis_size(intra_axis)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % g
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = psum_scatter(flat.reshape(g, -1), mesh, intra_axis)[0]
    if compress_inter:
        shard = compressed_psum(shard, mesh, inter_axis, block=block)
    else:
        shard = psum(shard, mesh, inter_axis)
    full = all_gather(shard, mesh, intra_axis)
    return full[:x.numel()].reshape(x.shape).to(x.dtype)
