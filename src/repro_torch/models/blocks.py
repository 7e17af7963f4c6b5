"""Transformer building blocks and the context threaded through the models.

``ShardCtx`` keeps the JAX package's name so a reader finds the
counterpart.  It holds the kernel implementation: ``"cuda"`` runs the
hand-written kernels (their plain versions when the tensors lie on the
CPU) and the MoE's sorted dispatch (``ffn.moe_dispatch``), ``"ref"`` the
plain paths of ``attention``, ``ssm.ssd_chunked`` and ``ffn.moe_ref``.

On a mesh it also holds the mesh and its axes.  The JAX package marks its
activations with GSPMD layout constraints (``shard_act``, ``shard_heads``,
``shard_kv_cache``), which change no value; here each rank holds and
computes its own part, Megatron-style, by the rule table of
:mod:`repro_torch.parallel.sharding` (``rank_spec``):

* attention over the rank's own query heads (and their KV heads), the
  partial sums of ``wo`` summed over the model axis;
* the MLP over the rank's slice of ``d_ff``, the partial sums of
  ``w_down`` summed over the model axis;
* the embedding vocab-parallel (a masked lookup, summed), the LM head
  column-parallel (the logits gathered over the model axis);
* the MoE through ``ffn.moe_ep`` or ``ffn.moe_tp`` (``choose_moe``);
* a Mamba2 layer over the rank's share of the SSD heads
  (:meth:`ShardCtx.ssm_heads`, ``models/ssm.py``).

A head is never split: where the query heads do not divide the model
axis, the rank computes every head (:class:`HeadPlan`) but only for its
block of the query rows, rows ``[i S/m, (i + 1) S/m)`` for model index i
of m (the JAX package's ``seq_parallel_attn``: m > 1, S > 1 and m divides
S; :meth:`ShardCtx.seq_parallel_attn`), with or without sequence
parallelism: its queries (RoPE at their positions) against the keys and
values of the whole sequence, which fill the prefill cache as before, and
``wo`` on those rows, whole values for them.  Without sequence
parallelism the rows are then gathered over the model axis
(``collectives.gather_model``, counted under ``"qseq"``), so the residual
is whole again; under it they are the rank's chunk already.  A decode
step, a sequence that m does not divide and the enc-dec's cross attention
are computed whole on every model rank.  :func:`query_rows` records the
rows each call fed attention.  Activations hold the
rank's rows of the batch (split over the data axes) and are whole over
the model axis, but under Megatron sequence parallelism
(``ShardCtx.seq_parallel``, a plan's ``seq_parallel``): there a
layer-boundary activation (B, S, D) holds the rank's chunk of the
sequence, rows ``[i S/m, (i + 1) S/m)`` for model index i of m, wherever
the JAX package's ``shard_act`` shards it (:meth:`ShardCtx.shards_act`:
m > 1, S > 1 and m divides S; a decode step's S = 1 never).  The norms
run on the chunk; a region (attention, the MLP, a Mamba2 block, the
head) is entered by gathering the sequence over the model axis and left
by reducing its partial sums and scattering the chunks back
(:meth:`ShardCtx.seq_enter`, :meth:`ShardCtx.seq_leave`; where the rank
computes the region whole, it gathers and keeps its own chunk).  The MoE
is entered the same way, so ``ffn.moe_ep`` / ``moe_tp`` see the rank's
whole rows and split them into the token blocks they split without the
plan (:func:`ffn_apply`): the same tokens routed by each shard, the same
capacity and the same dropped pairs, as the JAX package's GSPMD
reshards its chunks into its blocks.
Attention and RoPE see the gathered sequence at positions ``0..S-1``, so
the kernels run at the shapes they run without it (but under the query
split, where the chunk is the query block and the gathered sequence the
keys).  The residuals a layer keeps for the backward pass then cost 1/m
of the memory.

On a training mesh (``ShardCtx.specs``: what the rank holds of each
parameter, ``sharding.rank_spec``) the same forward carries gradients
through its collectives (``parallel/collectives.py``): a layer's
weights split over the data axis (FSDP) are gathered as the layer is
reached (:meth:`ShardCtx.gathered`, an MoE layer's ``moe/*`` too),
never the whole model at once; the MoE's exchanges carry gradients
(``ffn.moe_ep`` / ``moe_tp``);
every region whose weights are split over the model axis is entered with
``enter_region`` (its input's gradient summed over the model axis) and
left with ``leave_region`` (under sequence parallelism, ``gather_seq``
and ``scatter_seq`` in their place: the gradient of the gathered input
reduce-scattered, that of the chunk gathered; the norm scales, applied
to each rank's chunk, then have a gradient that is partial on each model
rank, which the train step sums over the model axis,
``launch/steps.py``); a weight held whole while the rank computes
only its heads' share of its use (``wk`` / ``wv`` where the query heads
divide the model axis and the KV heads do not) enters too, so its
gradient is summed over the model axis.  Under the query split every
attention weight is held whole and used for one block of rows, so
``wq``, ``wk``, ``wv`` and ``wo`` enter, and so does the normed input
where it is whole (without sequence parallelism); under sequence
parallelism the gathered sequence the keys read is a share of the work
(``gather_seq(partial=True)``).  Where the heads divide nothing and the
sequence does not split, attention is computed whole on every model rank
and its gradients are already whole.

Parameters are ``nn.Module``s whose attribute names follow the JAX
package's parameter tree (``attn.wq``, ``mlp.w_gate``, ``ln1``, ``in_proj``, ...), so
:func:`repro_torch.weights.from_jax_params` maps one onto the other by name.
They are created without gradients, as serving wants them; a trainer asks
for trainable ones (``init_lm(..., trainable=True)``).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, Mapping, Optional

import torch
from torch import nn

from . import ffn as ffn_lib
from .attention import attention
from .common import apply_rope, dense_init, rms_norm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The attention heads one rank computes: ``hq`` query heads (the
    ``wq`` columns and ``wo`` rows it holds) and ``hkv`` KV heads (its
    cache's); every head where the query heads do not divide the model
    axis, the work then shared by query rows instead
    (:meth:`ShardCtx.seq_parallel_attn`).  ``q_split``: the query heads
    are this rank's share of the model axis, so the ``wo`` product is a
    partial sum.  ``kv``: where the
    rank holds ``wk`` / ``wv`` whole (the KV heads do not divide the model
    axis), the KV heads its query heads read, in order (one per query head
    where they share no group); None where ``k`` already holds just the
    rank's KV heads."""

    hq: int
    hkv: int
    q_split: bool = False
    kv: Optional[tuple[int, ...]] = None

    def take_kv(self, k: torch.Tensor) -> torch.Tensor:
        """(B, S, Hkv_held, hd) -> (B, S, hkv, hd)."""
        return k if self.kv is None else k[:, :, list(self.kv)]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Model context: the kernel implementation, a routing log and, on a
    mesh, the mesh, its batch axes and model axis, and the MoE path."""

    impl: str = "cuda"             # attention / SSD kernels: cuda | ref
    #: records (or imposes) the MoE layers' routing decisions
    routes: Optional[ffn_lib.RouteLog] = None
    mesh: Optional[Any] = None     # repro_torch.launch.mesh.Mesh
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    moe_impl: str = "auto"         # auto | ep | tp | ref
    #: a training mesh's spec of each parameter a rank holds, by JAX tree
    #: path (a layer's entry without the stacked layer axis); None serves
    specs: Optional[Mapping[str, tuple]] = dataclasses.field(
        default=None, compare=False, repr=False)
    #: Megatron-SP: layer-boundary activations hold the rank's chunk of
    #: the sequence (:meth:`shards_act`)
    seq_parallel: bool = False

    def __post_init__(self):
        if self.impl not in ("cuda", "ref"):
            raise ValueError(f"impl must be 'cuda' or 'ref', got {self.impl!r}")
        if self.moe_impl not in ("auto", "ep", "tp", "ref"):
            raise ValueError(f"moe_impl {self.moe_impl!r} is not one of "
                             "auto, ep, tp, ref")

    def _model_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.mesh is not None else 1

    def heads_shardable(self, h: int) -> bool:
        m = self._model_size()
        return m > 1 and h % m == 0

    def seq_parallel_attn(self, h: int, s: int) -> bool:
        """Whether attention of ``h`` query heads over ``s`` positions
        splits its query rows over the model axis: the JAX package's test,
        where the heads do not divide a model axis m > 1, s > 1 and m
        divides s (with or without ``seq_parallel``)."""
        m = self._model_size()
        return (not self.heads_shardable(h)) and m > 1 and s > 1 \
            and s % m == 0

    def choose_moe(self, cfg: ModelConfig) -> str:
        """The MoE path.  ``moe_impl`` unless it is ``"auto"``; on a mesh,
        ``ffn.choose_moe_impl`` (``"ep"`` where the experts divide the
        model axis, else ``"tp"``); without one ``"ref"`` (``ffn.moe_ref``,
        every expert on every token: the JAX package's path on one device)
        under ``impl="ref"``, else ``"dispatch"`` (``ffn.moe_dispatch``, the
        same function over each expert's own tokens)."""
        if self.moe_impl != "auto":
            return self.moe_impl
        if self.mesh is not None:
            return ffn_lib.choose_moe_impl(cfg, self.mesh, self.model_axis)
        return "ref" if self.impl == "ref" else "dispatch"

    def heads(self, cfg: ModelConfig) -> HeadPlan:
        """This rank's :class:`HeadPlan` (every head without a mesh)."""
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        if not self.heads_shardable(Hq):
            return HeadPlan(Hq, Hkv)
        m = self._model_size()
        if self.heads_shardable(Hkv):
            return HeadPlan(Hq // m, Hkv // m, q_split=True)
        hq, G = Hq // m, Hq // Hkv
        lo = self.mesh.axis_index(self.model_axis) * hq
        if lo % G == 0 and hq % G == 0:
            kv = tuple(range(lo // G, (lo + hq) // G))
        elif lo // G == (lo + hq - 1) // G:
            kv = (lo // G,)                # all in one group
        else:
            kv = tuple(q // G for q in range(lo, lo + hq))
        return HeadPlan(hq, len(kv), q_split=True, kv=kv)

    @property
    def training(self) -> bool:
        """On a training mesh: the forward carries gradients through its
        collectives."""
        return self.mesh is not None and self.specs is not None

    def model_sum(self, x: torch.Tensor, partial: bool) -> torch.Tensor:
        """``x`` summed over the model axis when it is a ``partial`` sum
        (on a training mesh, leaving the region: the gradient passes to
        every model rank unchanged)."""
        if not partial:
            return x
        from repro_torch.parallel import collectives as coll
        if self.training:
            return coll.leave_region(x, self.mesh, self.model_axis)
        return coll.psum(x, self.mesh, self.model_axis)

    def enter(self, x: torch.Tensor, partial: bool) -> torch.Tensor:
        """``x`` as it enters a region whose work the model ranks share
        when ``partial``: on a training mesh its gradient is summed over
        the model axis; elsewhere ``x`` itself."""
        if not (partial and self.training):
            return x
        from repro_torch.parallel.collectives import enter_region
        return enter_region(x, self.mesh, self.model_axis)

    def shards_act(self, s: int) -> bool:
        """Whether a layer-boundary activation of ``s`` positions holds
        this rank's chunk of the sequence: the JAX package's ``shard_act``
        test, under ``seq_parallel`` on a model axis m > 1 where s > 1 and
        m divides s."""
        m = self._model_size()
        return self.seq_parallel and m > 1 and s > 1 and s % m == 0

    def seq_enter(self, x: torch.Tensor, partial: bool,
                  sp: bool) -> torch.Tensor:
        """``x`` (B, S', D) as it enters a region (:meth:`enter`).  Under
        sequence parallelism (``sp``, :meth:`shards_act` of the whole
        sequence) ``x`` is the rank's chunk and the whole sequence is
        gathered over the model axis (``collectives.gather_seq``: where
        the ranks share the work, ``partial``, its gradient is summed and
        scattered back; else the rank keeps its own chunk of it)."""
        if not sp:
            return self.enter(x, partial)
        from repro_torch.parallel.collectives import gather_seq
        return gather_seq(x, self.mesh, self.model_axis, 1, partial=partial)

    def seq_leave(self, y: torch.Tensor, partial: bool,
                  sp: bool) -> torch.Tensor:
        """A region's output ``y`` (B, S, D) as it leaves (:meth:`model_sum`).
        Under sequence parallelism (``sp``) the rank's chunk of the
        sequence: of the sum over the model axis where ``y`` is a
        ``partial`` sum (``collectives.scatter_seq``: a reduce-scatter,
        its gradient gathered), else of ``y`` itself."""
        if not sp:
            return self.model_sum(y, partial)
        from repro_torch.parallel.collectives import scatter_seq
        return scatter_seq(y, self.mesh, self.model_axis, 1, partial=partial)

    def gathered(self, module: Any, prefix: str) -> Any:
        """``module``'s parameters as the layer uses them: on a training
        mesh each one split over data axes (``specs["<prefix>/<name>"]``)
        gathered over them with ``fsdp_gather`` (its gradient reduced and
        scattered back), as a namespace of the module's attribute names;
        elsewhere ``module`` itself."""
        if not self.training:
            return module
        out: dict = {}
        for name, p in module.named_parameters():
            path = f"{prefix}/{name.replace('.', '/')}"
            node = out
            *owners, leaf = name.split(".")
            for o in owners:
                node = node.setdefault(o, {})
            node[leaf] = self.gather_weight(p, self.specs[path])
        return _namespace(out)

    def gather_weight(self, w: torch.Tensor, spec: tuple) -> torch.Tensor:
        """``w``, a shard under ``spec``, gathered over every axis but the
        model axis (FSDP's data entries), dim by dim."""
        from repro_torch.parallel.collectives import fsdp_gather
        for dim, axis in enumerate(spec):
            # a head-wise (Segments) dim is the model axis's
            if isinstance(axis, (str, tuple)) and axis != self.model_axis:
                w = fsdp_gather(w, self.mesh, axis, dim)
        return w

    def ssm_heads(self, cfg: ModelConfig) -> int:
        """The SSD heads this rank computes: its share where they divide
        the model axis (``sharding.rank_spec``'s head-wise layout), else
        every head."""
        h = cfg.ssm_heads
        return h // self._model_size() if self.heads_shardable(h) else h


def _namespace(tree: dict) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        k: _namespace(v) if isinstance(v, dict) else v
        for k, v in tree.items()})


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Parameter constructors
# ---------------------------------------------------------------------------


class AttnParams(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(w) for w in
                                              (wq, wk, wv, wo))


class MlpParams(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = (_param(w) for w in
                                               (w_gate, w_up, w_down))


class DenseLayer(nn.Module):
    def __init__(self, attn: AttnParams, mlp: MlpParams, ln1, ln2):
        super().__init__()
        self.attn = attn
        self.mlp = mlp
        self.ln1 = _param(ln1)
        self.ln2 = _param(ln2)


class MoeParams(nn.Module):
    """An MoE block: ``router`` f32 (D, E); ``w_gate``, ``w_up`` (E, D, F);
    ``w_down`` (E, F, D)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = (
            _param(w) for w in (router, w_gate, w_up, w_down))


#: parameter names of an MoE block, in constructor order
MOE_PARAMS = ("router", "w_gate", "w_up", "w_down")


class MoeLayer(nn.Module):
    """A transformer layer whose feed-forward is an MoE block ``moe``."""

    def __init__(self, attn: AttnParams, moe: MoeParams, ln1, ln2):
        super().__init__()
        self.attn = attn
        self.moe = moe
        self.ln1 = _param(ln1)
        self.ln2 = _param(ln2)


class MambaLayer(nn.Module):
    """One Mamba2 layer: its pre-norm scale ``ln`` and the block's
    parameters, named as in the JAX package's tree."""

    def __init__(self, ln, in_proj, conv_w, conv_b, A_log, D, dt_bias,
                 norm_w, out_proj):
        super().__init__()
        self.ln = _param(ln)
        self.in_proj = _param(in_proj)
        self.conv_w = _param(conv_w)
        self.conv_b = _param(conv_b)
        self.A_log = _param(A_log)
        self.D = _param(D)
        self.dt_bias = _param(dt_bias)
        self.norm_w = _param(norm_w)
        self.out_proj = _param(out_proj)


#: parameter names of a Mamba layer, in constructor order
MAMBA_PARAMS = ("ln", "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                "norm_w", "out_proj")


def init_attn_params(cfg: ModelConfig, *, generator: torch.Generator,
                     device: torch.device | str) -> AttnParams:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    kw = dict(generator=generator, device=device)
    return AttnParams(dense_init((D, Q), D, **kw), dense_init((D, KV), D, **kw),
                      dense_init((D, KV), D, **kw), dense_init((Q, D), Q, **kw))


def init_mlp_params(cfg: ModelConfig, *, generator: torch.Generator,
                    device: torch.device | str) -> MlpParams:
    D, F = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    return MlpParams(dense_init((D, F), D, **kw), dense_init((D, F), D, **kw),
                     dense_init((F, D), F, **kw))


def init_moe_params(cfg: ModelConfig, *, generator: torch.Generator,
                    device: torch.device | str) -> MoeParams:
    """f32 router, bf16 experts; each tensor drawn in f32 and cast, one at
    a time (one layer's f32 ``w_gate`` at full qwen3 width is 805 MB)."""
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    kw = dict(generator=generator, device=device)
    return MoeParams(dense_init((D, E), D, dtype=torch.float32, **kw),
                     dense_init((E, D, F), D, **kw),
                     dense_init((E, D, F), D, **kw),
                     dense_init((E, F, D), F, **kw))


def init_moe_layer(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device | str) -> MoeLayer:
    D = cfg.d_model
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=device)
    return MoeLayer(init_attn_params(cfg, generator=generator, device=device),
                    init_moe_params(cfg, generator=generator, device=device),
                    zeros(), zeros())


def init_dense_layer(cfg: ModelConfig, *, generator: torch.Generator,
                     device: torch.device | str) -> DenseLayer:
    D = cfg.d_model
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=device)
    return DenseLayer(init_attn_params(cfg, generator=generator, device=device),
                      init_mlp_params(cfg, generator=generator, device=device),
                      zeros(), zeros())


def init_mamba_layer(cfg: ModelConfig, *, generator: torch.Generator,
                     device: torch.device | str) -> MambaLayer:
    """Mamba2 layer init: bf16 projections and conv weights, f32 rest;
    ``A_log`` spans log 1..16 over the heads and ``dt_bias`` is the
    inverse softplus of dt drawn log-uniform in [1e-3, 1e-1]."""
    s = cfg.ssm
    D, H = cfg.d_model, cfg.ssm_heads
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = dense_init((D, cfg.in_proj_dim), D, **kw)
    conv_w = dense_init((s.conv_width, cfg.conv_dim), s.conv_width, **kw)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=generator, **f32)
    dt = torch.exp(u * (hi - lo) + lo)
    out_proj = dense_init((cfg.d_inner, D), cfg.d_inner, **kw)
    return MambaLayer(
        ln=torch.zeros((D,), **f32),
        in_proj=in_proj, conv_w=conv_w,
        conv_b=torch.zeros((cfg.conv_dim,), **f32),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        D=torch.ones((H,), **f32),
        dt_bias=torch.log(torch.expm1(dt)),
        norm_w=torch.ones((cfg.d_inner,), **f32),
        out_proj=out_proj)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


#: the query rows each attention call of this process fed attention since
#: the last :func:`reset_query_rows`: (first, end, of S) -> calls
_QUERY_ROWS: dict = {}


def query_rows() -> dict:
    """{(first, end, S): calls}: the rows ``[first, end)`` of a sequence
    of S positions that each self-attention call (a prefill's, a train
    step's, a decode step's) of this process fed attention as queries,
    since :func:`reset_query_rows`: ``(0, S, S)`` where the rank computed
    every row, its block where the query rows split over the model axis
    (:meth:`ShardCtx.seq_parallel_attn`)."""
    return dict(_QUERY_ROWS)


def reset_query_rows() -> None:
    _QUERY_ROWS.clear()


def record_query_rows(first: int, end: int, s: int) -> None:
    """Counts one attention call fed rows ``[first, end)`` of ``s``."""
    key = (first, end, s)
    _QUERY_ROWS[key] = _QUERY_ROWS.get(key, 0) + 1


def self_attention_block(
    x: torch.Tensor, p: AttnParams, cfg: ModelConfig, ctx: ShardCtx, *,
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projections + RoPE + attention (causal unless told otherwise)
    over this step's keys, over the rank's heads (``ctx.heads``).  Returns
    (out, k_new, v_new), k_new/v_new post-RoPE (the cache's entries).
    Under sequence parallelism (``ctx.shards_act`` of the ``q_pos``
    positions) ``x`` and ``out`` are the rank's chunk of the sequence,
    k_new/v_new the whole sequence's (of the rank's heads).  Where the
    query rows split over the model axis (``ctx.seq_parallel_attn``),
    :func:`_query_split_block`."""
    S = q_pos.shape[0]
    if ctx.seq_parallel_attn(cfg.n_heads, S):
        return _query_split_block(x, p, cfg, ctx, q_pos=q_pos, k_pos=k_pos,
                                  window=window, causal=causal)
    record_query_rows(0, S, S)
    hp = ctx.heads(cfg)
    sp = ctx.shards_act(S)
    x = ctx.seq_enter(x, hp.q_split, sp)
    B, S, D = x.shape
    # wk / wv held whole, used for this rank's heads only
    wk, wv = (ctx.enter(w, hp.kv is not None) for w in (p.wk, p.wv))
    q = (x @ p.wq).reshape(B, S, hp.hq, cfg.hd)
    k = hp.take_kv((x @ wk).reshape(B, S, -1, cfg.hd))
    v = hp.take_kv((x @ wv).reshape(B, S, -1, cfg.hd))
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)   # new keys carry current positions
    out = attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                    window=window, impl=ctx.impl)
    out = out.reshape(B, S, hp.hq * cfg.hd)
    return ctx.seq_leave(out @ p.wo, hp.q_split, sp), k, v


def _query_split_block(
    x: torch.Tensor, p: AttnParams, cfg: ModelConfig, ctx: ShardCtx, *,
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: int, causal: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`self_attention_block` where the query rows split over the
    model axis: model rank i of m computes every head for the queries of
    rows ``[i S/m, (i + 1) S/m)`` (RoPE at their positions) against the
    whole sequence's keys and values, and ``wo`` on those rows.  Without
    sequence parallelism ``x`` is whole and the output rows are gathered
    over the model axis (counted under ``"qseq"``); under it ``x`` is the
    rank's chunk, the query rows themselves, the sequence is gathered for
    the keys (its gradient summed and scattered: each rank's keys are a
    share of the work) and the output is the chunk.  On a training mesh
    the weights, used for one block of rows, enter the region, and so does
    a whole ``x``: their gradients are summed over the model axis."""
    from repro_torch.parallel import collectives as coll
    mesh, ax = ctx.mesh, ctx.model_axis
    S = q_pos.shape[0]
    c = S // mesh.axis_size(ax)
    lo = mesh.axis_index(ax) * c
    sp = ctx.shards_act(S)
    if sp:
        xq, xkv = x, coll.gather_seq(x, mesh, ax, 1, partial=True)
    else:
        xkv = ctx.enter(x, True)
        xq = xkv[:, lo:lo + c]
    wq, wk, wv, wo = (ctx.enter(w, True) for w in (p.wq, p.wk, p.wv, p.wo))
    B = x.shape[0]
    qp = q_pos[lo:lo + c]
    q = apply_rope((xq @ wq).reshape(B, c, cfg.n_heads, cfg.hd), qp,
                   cfg.rope_theta)
    k = apply_rope((xkv @ wk).reshape(B, S, cfg.n_kv_heads, cfg.hd), q_pos,
                   cfg.rope_theta)
    v = (xkv @ wv).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    record_query_rows(lo, lo + c, S)
    out = attention(q, k, v, q_pos=qp, k_pos=k_pos, causal=causal,
                    window=window, impl=ctx.impl)
    y = out.reshape(B, c, cfg.q_dim) @ wo
    if not sp:
        y = coll.gather_model(y, mesh, ax, 1, kind="qseq")
    return y, k, v


def mlp_apply(h: torch.Tensor, p: MlpParams, cfg: ModelConfig,
              ctx: ShardCtx, sp: bool = False) -> torch.Tensor:
    """SwiGLU over the ``d_ff`` columns the rank holds, summed over the
    model axis where they are a share of ``cfg.d_ff``; with ``sp``
    (sequence parallelism) on the rank's chunk of the sequence, gathered
    before ``w_gate`` / ``w_up`` and scattered after ``w_down``."""
    partial = p.w_gate.shape[-1] < cfg.d_ff
    y = ffn_lib.swiglu(ctx.seq_enter(h, partial, sp), p.w_gate, p.w_up,
                       p.w_down)
    return ctx.seq_leave(y, partial, sp)


def dense_layer_apply(
    x: torch.Tensor, p: DenseLayer, cfg: ModelConfig, ctx: ShardCtx, *,
    positions: torch.Tensor, window: int = 0, causal: bool = True,
    prefix: str = "layers",
) -> torch.Tensor:
    """Full pre-norm transformer layer (no cache), causal unless told
    otherwise; on a training mesh its weights are gathered first
    (:meth:`ShardCtx.gathered`; ``prefix``: the layer's path in the JAX
    tree, ``shared_attn`` for the hybrid's shared block).  Under sequence
    parallelism (``ctx.shards_act`` of the ``positions``) ``x`` and the
    result are the rank's chunk of the sequence."""
    p = ctx.gathered(p, prefix)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, _, _ = self_attention_block(
        h, p.attn, cfg, ctx, q_pos=positions, k_pos=positions, window=window,
        causal=causal)
    x = x + attn_out
    return x + mlp_apply(rms_norm(x, p.ln2, cfg.norm_eps), p.mlp, cfg, ctx,
                         ctx.shards_act(positions.shape[0]))


def ffn_apply(h: torch.Tensor, p: DenseLayer | MoeLayer, cfg: ModelConfig,
              ctx: ShardCtx, sp: bool = False
              ) -> tuple[torch.Tensor, Optional[torch.Tensor],
                         Optional[torch.Tensor]]:
    """The layer's feed-forward on its normed input: (y, load-balance loss,
    router z-loss), the losses None for a dense layer's SwiGLU.  ``p`` is
    the layer (or, on a training mesh, its gathered namespace); ``sp``
    (sequence parallelism): ``h`` and y are the rank's chunk of the
    sequence (:func:`mlp_apply`).

    An MoE layer under ``sp`` gathers the whole sequence first, so the
    MoE paths see the rank's whole rows, as without the split, and keep
    the layer's token count, capacity and aux terms.  Each path's input
    gradient is already whole on every model rank, so the entry keeps the
    rank's chunk of it, summing nothing (``partial=False``): ``moe_ep``'s
    ``split_model`` gathers its blocks' gradients; under ``moe_tp`` the
    router's share is whole on every rank and ``enter_region`` has
    summed the experts' share (a summing entry would count that share m
    times).  ``moe_ep``'s output, gathered over the model axis, is whole,
    so the rank keeps its chunk; ``moe_tp``'s partial sums leave by the
    reduce-scatter (``sum_out=False``), not a sum and then a chunk."""
    m = getattr(p, "moe", None)
    if m is None:
        return mlp_apply(h, p.mlp, cfg, ctx, sp), None, None
    impl = ctx.choose_moe(cfg)
    h = ctx.seq_enter(h, False, sp)
    w = (m.router, m.w_gate, m.w_up, m.w_down)
    on_mesh = dict(cfg=cfg, mesh=ctx.mesh, batch_axes=ctx.batch_axes,
                   model_axis=ctx.model_axis, log=ctx.routes)
    if impl == "ep":
        y, lb, z = ffn_lib.moe_ep(h, *w, **on_mesh)
    elif impl == "tp":
        y, lb, z = ffn_lib.moe_tp(h, *w, sum_out=not sp, **on_mesh)
    else:
        fn = ffn_lib.moe_ref if impl == "ref" else ffn_lib.moe_dispatch
        y, lb, z = fn(h, *w, cfg=cfg, log=ctx.routes)
    return ctx.seq_leave(y, impl == "tp" and sp, sp), lb, z


def moe_layer_apply(
    x: torch.Tensor, p: MoeLayer, cfg: ModelConfig, ctx: ShardCtx, *,
    positions: torch.Tensor, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full pre-norm causal MoE layer (no cache); returns (x, load-balance
    loss, router z-loss).  On a training mesh its weights, the MoE's
    ``moe/*`` among them, are gathered first (:meth:`ShardCtx.gathered`).
    Under sequence parallelism (``ctx.shards_act`` of the ``positions``)
    ``x`` and the result are the rank's chunk of the sequence
    (:func:`ffn_apply`)."""
    p = ctx.gathered(p, "layers")
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, _, _ = self_attention_block(
        h, p.attn, cfg, ctx, q_pos=positions, k_pos=positions, window=window)
    x = x + attn_out
    y, lb, z = ffn_apply(rms_norm(x, p.ln2, cfg.norm_eps), p, cfg, ctx,
                         ctx.shards_act(positions.shape[0]))
    return x + y, lb, z
