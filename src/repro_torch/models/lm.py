"""Decoder-only language models, dense, VLM, MoE, SSM and hybrid families:
the training forward and loss, prefill and cached decode.

The JAX package scans one layer body over layer-stacked parameters
(``jax.lax.scan``); here the layers are an ``nn.ModuleList`` walked by a
Python loop, and each layer's attention window is a Python int
(``ModelConfig.layer_windows``), so the kernels see it as a constant.

The VLM (llava-next) is the dense decoder with a stubbed vision frontend:
``cfg.frontend_len`` precomputed patch embeddings (``extra_embeds``) pass
through a two-layer projector (``w1``, tanh-approximated GELU in f32,
``w2``) and are prepended to the text embeddings; the loss scores only the
text tail.

The dense and MoE decode cache holds the K/V of every layer stacked as
(L, B, S_cache, Hkv, hd) bf16, the SSM cache a ``MambaState`` of the conv
windows (L, B, conv_width-1, conv_dim) bf16 and the recurrent states
(L, B, H, P, N) f32, both as the JAX package's do, with a host-side int
``pos``.  The hybrid (zamba2) runs segments of ``attn_every`` Mamba layers,
each followed by one shared attention block (the same weights at every
site); its cache is the SSM cache plus the shared block's K/V per site,
(n_sites, B, S_cache, Hkv, hd) bf16, a ring of ``min(window, max_len)``
slots when the config has a window.  Decode writes each step's entries
into the cache in place.

One deliberate divergence: a ring cache (the hybrid's shared K/V, and the
dense and MoE cache of a config whose every layer is windowed, mixtral's)
rings its decode over the cache's own slot count, ``min(window,
max_len)``, where the JAX package rings over ``cfg.window``.  The two are
equal wherever the JAX package runs, ``max_len >= window``; below that the
JAX package raises and the port attends to the whole, unwrapped cache.

On a mesh (``ShardCtx.mesh``) each rank holds its rows of the batch and
its part of the weights (``models/blocks.py``): the embedding's vocab rows
(a masked lookup, summed over the model axis), the LM head's vocab
columns (the logits gathered over the model axis, so every model rank
ends with the same whole logits), the attention heads of
``ctx.heads(cfg)`` and a cache of just those heads; a VLM's projector
column- then row-parallel (:func:`_project`); a Mamba2 layer's share of
the SSD heads (``models/ssm.py``: ``sharding.rank_spec``'s head-wise
layout) and a state of just those heads; the hybrid's shared block at the
rank's attention heads, its rings holding them.  Every family runs there
(the enc-dec in ``models/encdec.py``, through this module's embedding,
logits and loss).

On a training mesh (``ctx.training``) every family trains: the
forward carries gradients through its collectives (``models/blocks.py``;
the MoE's exchanges, ``models/ffn.py``; the Mamba2 block's, ``models/
ssm.py``),
each layer's weights gathered over the data axis as it is reached (the
layer recomputed in its backward, so the gathered weights are never
kept, whatever ``cfg.remat`` says), and :func:`lm_loss` is the global
token mean.  Its cross entropy is vocab-parallel: the rank's logits are
those of its vocab columns, and the row max, the sum of exponentials and
the target's logit are each combined over the model axis, the same
function as the cross entropy of the gathered logits without gathering
them.  The masked sum and the token count are each summed over the data
axes before the division; the MoE's load-balance and router z terms are
added as ``lm_loss`` adds them, and a VLM scores its text tail alone.
The hybrid's shared block is gathered at each of its sites, and its
gradients from every site add up, as on one device.

Under Megatron sequence parallelism (``ctx.seq_parallel``, where
``ctx.shards_act`` of the whole sequence holds) each rank's activations
between the layers are its chunk of the sequence (``models/blocks.py``):
the embedding's masked lookup is reduce-scattered instead of summed (a
VLM's patches and text are concatenated whole, then split); each layer
gathers the sequence as it enters attention, the MLP, the MoE (whose
token blocks, capacity and dropped pairs are then those without the
split) or a Mamba2 block (the causal conv and the SSD scan run over the
whole sequence, so the cache's conv windows and states are the whole
prompt's) and scatters its output; the head and the loss see the
sequence gathered after the final norm, and a prefill's last logits come
from the gathered final hidden states.  The cache holds the rank's heads over the whole
sequence, as without it.

Training (:func:`forward_lm`, :func:`lm_loss`) runs under autograd on
parameters built with ``trainable=True``; ``cfg.remat`` decides what the
backward pass keeps, as the JAX package's ``_remat`` does: ``"full"``
recomputes each layer from its input (``torch.utils.checkpoint``), ``"none"``
keeps every activation.  :func:`kept_values` counts the floating-point
values the checkpointed layer bodies keep (their inputs, seen by a
``saved_tensors_hooks`` pack hook around each checkpoint): the layer
boundaries, 1/m of them per rank under sequence parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from .attention import (attention, cache_positions_full, cache_positions_ring,
                        cache_update_full, cache_update_ring)
from . import ssm as ssm_lib
from .blocks import (DenseLayer, MambaLayer, MoeLayer, ShardCtx, _param,
                     dense_layer_apply, ffn_apply, init_dense_layer,
                     init_mamba_layer, init_moe_layer, mlp_apply,
                     moe_layer_apply, record_query_rows,
                     self_attention_block)
from .common import (cross_entropy_loss, cross_entropy_sums, dense_init,
                     embed_init, log_partition_and_gold, matmul_f32_reduced,
                     rms_norm, rope_angles, rotate)
from .config import ModelConfig

#: families this module runs (the enc-dec family is ``models/encdec.py``)
PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


class Projector(nn.Module):
    """The VLM frontend's two-layer projector, ``w1`` and ``w2`` (D, D)."""

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.w1 = _param(w1)
        self.w2 = _param(w2)


class LM(nn.Module):
    """Parameters of a decoder: embedding, layers (``DenseLayer``,
    ``MoeLayer`` or ``MambaLayer``), final norm, (unless tied) the LM head,
    for the hybrid the one shared attention block ``shared_attn`` and, for
    a config with a frontend (the VLM), its ``projector``."""

    def __init__(self, embed: torch.Tensor,
                 layers: list[DenseLayer] | list[MoeLayer]
                 | list[MambaLayer],
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None,
                 shared_attn: Optional[DenseLayer] = None,
                 projector: Optional[Projector] = None):
        super().__init__()
        self.embed = _param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _param(final_norm)
        self.lm_head = _param(lm_head) if lm_head is not None else None
        self.shared_attn = shared_attn
        self.projector = projector


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder of this "
            f"module (it runs {PORTED_FAMILIES}; the enc-dec family is "
            f"models/encdec.py)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: torch.device | str, trainable: bool = False,
            keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
            ) -> LM:
    """Random parameters drawn on ``device`` from ``generator``; with
    ``trainable`` they require gradients (serving leaves them frozen).
    ``keep(name, tensor)``, given, maps each parameter as it is drawn
    (named as in ``named_parameters()``) to what the model holds, e.g. a
    rank's shard: the draws are the same, so the same seed gives the same
    values, and no more than one layer is ever held whole."""
    cfg.validate()
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab
    kw = dict(generator=generator, device=device)
    keep = keep or (lambda name, t: t)
    embed = keep("embed", embed_init((V, D), **kw))
    init_layer = {"dense": init_dense_layer, "vlm": init_dense_layer,
                  "moe": init_moe_layer, "ssm": init_mamba_layer,
                  "hybrid": init_mamba_layer}[cfg.family]
    layers = [_kept(init_layer(cfg, **kw), f"layers.{i}", keep)
              for i in range(cfg.n_layers)]
    shared = (_kept(init_dense_layer(cfg, **kw), "shared_attn", keep)
              if cfg.family == "hybrid" else None)
    projector = (_kept(Projector(dense_init((D, D), D, **kw),
                                 dense_init((D, D), D, **kw)),
                       "projector", keep)
                 if cfg.frontend else None)
    final_norm = keep("final_norm",
                      torch.zeros((D,), dtype=torch.float32, device=device))
    lm_head = (None if cfg.tie_embeddings
               else keep("lm_head", dense_init((D, V), D, **kw)))
    return LM(embed, layers, final_norm, lm_head, shared,
              projector).requires_grad_(trainable)


def _kept(module: nn.Module, prefix: str, keep) -> nn.Module:
    """``module`` with each parameter replaced by ``keep(name, value)``."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, _param(keep(f"{prefix}.{name}", p.data)))
    return module


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
           ctx: Optional[ShardCtx], sp: bool = False) -> torch.Tensor:
    """Token embeddings.  Where the rank holds a share of the vocab rows
    (``[i * V/m, (i + 1) * V/m)`` for model index i), a masked lookup
    summed over the model axis: one rank adds each token's row, the others
    zeros, so the sum is exact.  With ``sp`` (sequence parallelism) the
    rank's chunk of the sequence: the sum reduce-scattered, a whole
    lookup split."""
    t = tokens.long()
    embed = _weight(params, "embed", ctx)
    rows = embed.shape[0]
    if rows == cfg.vocab:
        return ctx.seq_leave(embed[t], False, sp) if sp else embed[t]
    t = t - ctx.mesh.axis_index(ctx.model_axis) * rows
    mine = (t >= 0) & (t < rows)
    x = torch.where(mine[..., None], embed[t.clamp(0, rows - 1)], 0)
    return ctx.seq_leave(x, True, sp)


def _weight(params: LM, name: str, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """A top-level parameter as the forward uses it: on a training mesh
    gathered over its data axes."""
    w = getattr(params, name)
    if ctx is None or not ctx.training:
        return w
    return ctx.gather_weight(w, ctx.specs[name])


def _head(params: LM, cfg: ModelConfig,
          ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The LM head (D, V or the rank's vocab columns)."""
    if cfg.tie_embeddings:
        return _weight(params, "embed", ctx).T
    return _weight(params, "lm_head", ctx)


def _seq_len(cfg: ModelConfig, tokens: torch.Tensor) -> int:
    """The length of the sequence the layers see: the tokens, after a
    VLM's ``frontend_len`` patches."""
    return tokens.shape[1] + (cfg.frontend_len if cfg.frontend else 0)


def _embed_inputs(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                  extra_embeds: Optional[torch.Tensor] = None,
                  ctx: Optional[ShardCtx] = None,
                  sp: bool = False) -> torch.Tensor:
    """Token embeddings; for a config with a frontend, the projected
    ``extra_embeds`` (B, frontend_len, D) before them.  ``ctx``: the mesh
    the embedding's vocab rows split over (None: one device); ``sp``: the
    rank's chunk of the sequence (sequence parallelism), split after the
    patches and the text are concatenated, as the JAX package's
    ``shard_act`` splits them."""
    x = _embed(params, cfg, tokens, ctx, sp and not cfg.frontend)
    if cfg.frontend:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} has a {cfg.frontend!r} frontend: "
                             "pass its stub embeddings as extra_embeds")
        x = torch.cat([_project(params, cfg, extra_embeds.to(x.dtype), ctx),
                       x], dim=1)
        if sp:
            x = ctx.seq_leave(x, False, True)
    return x


def _project(params: LM, cfg: ModelConfig, fe: torch.Tensor,
             ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The projector on patch embeddings ``fe``: ``w1``, the tanh GELU in
    f32, ``w2``.  Where the rank holds a share of ``w1``'s columns (and of
    ``w2``'s rows) it is column- then row-parallel: the GELU runs on the
    rank's columns, the ``w2`` partial sums are summed over the model
    axis (on a training mesh ``fe`` enters that region, and the weights
    are gathered over the data axis first)."""
    p = params.projector if ctx is None else ctx.gathered(params.projector,
                                                          "projector")
    partial = p.w1.shape[-1] < cfg.d_model
    if partial:
        fe = ctx.enter(fe, True)
    h = torch.nn.functional.gelu((fe @ p.w1).float(), approximate="tanh")
    y = h.to(fe.dtype) @ p.w2
    return ctx.model_sum(y, True) if partial else y


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor,
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The logits over the whole vocab: where the rank holds a share of the
    head's vocab columns, its logits gathered over the model axis."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = x @ _head(params, cfg, ctx)
    if logits.shape[-1] < cfg.vocab:
        from repro_torch.parallel.collectives import all_gather
        logits = all_gather(logits, ctx.mesh, ctx.model_axis,
                            dim=logits.ndim - 1)
    return logits


def _ring_pack(k_full: torch.Tensor, window: int) -> torch.Tensor:
    """Arrange the last ``window`` steps of (B, S, ...) into ring-slot order."""
    S = k_full.shape[1]
    if S <= window:
        pad = torch.zeros((k_full.shape[0], window - S) + k_full.shape[2:],
                          dtype=k_full.dtype, device=k_full.device)
        return torch.cat([k_full, pad], dim=1)
    j = torch.arange(window, device=k_full.device)
    p = (S - 1) - torch.remainder((S - 1) - j, window)
    return k_full[:, p]


def _segment_bounds(n_layers: int, every: int) -> list[tuple[int, int]]:
    """The hybrid's Mamba segments, [lo, hi) each; the shared attention
    block follows every one of them."""
    return [(lo, min(lo + every, n_layers))
            for lo in range(0, n_layers, every)]


def _sites(cfg: ModelConfig) -> list[tuple[int, int]]:
    return _segment_bounds(cfg.n_layers, cfg.attn_every or cfg.n_layers)


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


#: floating-point values the checkpointed layer bodies of this process
#: have kept for their backward pass since the last :func:`reset_kept`
_KEPT = {"values": 0}


def kept_values() -> int:
    """The floating-point values the checkpointed layer bodies (``remat``
    ``"full"``) of this process have kept for the backward pass, their
    tensor inputs, since :func:`reset_kept`; the checkpoint keeps nothing
    else of a body."""
    return _KEPT["values"]


def reset_kept() -> None:
    _KEPT["values"] = 0


def _count_kept(t: torch.Tensor) -> torch.Tensor:
    if t.is_floating_point():
        _KEPT["values"] += t.numel()
    return t


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode != "full":
        raise NotImplementedError(f"remat {mode!r} is not ported "
                                  "(ported: 'none', 'full')")

    def body(*args):
        # the checkpoint saves its inputs under this hook, then runs the
        # body under its own (the innermost hook packs)
        with torch.autograd.graph.saved_tensors_hooks(_count_kept,
                                                      lambda t: t):
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
    return body


def _dense_layer(x, lp, cfg, ctx, positions, window):
    return dense_layer_apply(x, lp, cfg, ctx, positions=positions,
                             window=window)


def _moe_layer(x, lp, cfg, ctx, positions, window):
    return moe_layer_apply(x, lp, cfg, ctx, positions=positions,
                           window=window)


def _mamba_layer(x, lp, cfg, ctx, positions, window):
    lp = ctx.gathered(lp, "layers")
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    return x + ssm_lib.mamba_block_train(
        h, lp, cfg, impl=ctx.impl, ctx=ctx,
        sp=ctx.shards_act(positions.shape[0]))


def _shared_layer(x, sp, cfg, ctx, positions, window):
    return dense_layer_apply(x, sp, cfg, ctx, positions=positions,
                             window=window, prefix="shared_attn")


def forward_lm(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               ctx: ShardCtx, *, extra_embeds: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), load-balance
    loss, router z-loss): for the MoE family each summed over the layers,
    as the JAX package's scan carries them; 0 for the other families.  A
    VLM's S counts its ``frontend_len`` projected ``extra_embeds`` first."""
    x, lb, z = _hidden(params, cfg, tokens, ctx, extra_embeds)
    x = ctx.seq_enter(x, False, ctx.shards_act(_seq_len(cfg, tokens)))
    return _logits(params, cfg, x, ctx), lb, z


def _layer_remat(cfg: ModelConfig, ctx: ShardCtx,
                 prefix: str = "layers/") -> str:
    """``cfg.remat``, but ``"full"`` where the weights under ``prefix`` are
    gathered over the data axis on a training mesh: the gathered weights
    are then recomputed in the backward pass, never kept."""
    from repro_torch.parallel.sharding import spec_axes
    if ctx.training and any(
            set(spec_axes(spec)) - {ctx.model_axis}
            for path, spec in ctx.specs.items() if path.startswith(prefix)):
        return "full"
    return cfg.remat


def _hidden(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            ctx: ShardCtx, extra_embeds: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward up to the final norm: (x (B, S, D), load-balance loss,
    router z-loss); under sequence parallelism x is the rank's chunk of
    the sequence."""
    _check_family(cfg)
    S = _seq_len(cfg, tokens)
    x = _embed_inputs(params, cfg, tokens, extra_embeds, ctx,
                      ctx.shards_act(S))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, x, ctx, positions)
    elif cfg.family == "moe":
        body = _remat(_moe_layer, _layer_remat(cfg, ctx))
        for lp, w in zip(params.layers, cfg.layer_windows()):
            x, lbi, zi = body(x, lp, cfg, ctx, positions, w)
            lb, z = lb + lbi, z + zi
    else:
        body = _remat(_mamba_layer if cfg.family == "ssm" else _dense_layer,
                      _layer_remat(cfg, ctx))
        for lp, w in zip(params.layers, cfg.layer_windows()):
            x = body(x, lp, cfg, ctx, positions, w)
    return x, lb, z


def _hybrid_forward(params: LM, cfg: ModelConfig, x: torch.Tensor,
                    ctx: ShardCtx, positions: torch.Tensor) -> torch.Tensor:
    """Zamba2: Mamba segments, the shared attention block (same weights,
    window ``cfg.window``) after each."""
    body = _remat(_mamba_layer, _layer_remat(cfg, ctx))
    shared = _remat(_shared_layer, _layer_remat(cfg, ctx, "shared_attn/"))
    for lo, hi in _sites(cfg):
        for lp in params.layers[lo:hi]:
            x = body(x, lp, cfg, ctx, positions, 0)
        x = shared(x, params.shared_attn, cfg, ctx, positions, cfg.window)
    return x


def lm_loss(params: LM, cfg: ModelConfig, batch: dict, ctx: ShardCtx
            ) -> tuple[torch.Tensor, dict]:
    """Token-mean cross entropy (z-loss included) of the batch's
    ``labels`` under the model, plus, for an MoE config,
    ``load_balance_coef * lb + router_z_coef * z``; and the aux dict of the
    JAX package (``ce``, ``load_balance``, ``router_z``).  A VLM's
    frontend positions carry no labels: only the text tail is scored.  On
    a training mesh the global token mean over the rank's rows and its
    vocab columns (module docstring)."""
    if ctx.training:
        return _mesh_loss(params, cfg, batch, ctx)
    logits, lb, z = forward_lm(params, cfg, batch["tokens"], ctx,
                               extra_embeds=batch.get("extra_embeds"))
    labels = batch["labels"]
    if cfg.frontend:
        logits = logits[:, -labels.shape[1]:]
    ce = cross_entropy_loss(logits, labels, batch.get("loss_mask"))
    total = ce
    if cfg.moe:
        total = (total + cfg.moe.load_balance_coef * lb
                 + cfg.moe.router_z_coef * z)
    return total, {"ce": ce, "load_balance": lb, "router_z": z}


def _mesh_loss(params: LM, cfg: ModelConfig, batch: dict, ctx: ShardCtx
               ) -> tuple[torch.Tensor, dict]:
    """:func:`lm_loss` on a training mesh: the rank's logits over its
    vocab columns (a VLM's over its text tail alone), the vocab-parallel
    cross entropy, and the masked sum and token count summed over the
    data axes before the division; an MoE config adds its load-balance
    and router z terms, already global means (``ffn.moe_ep`` /
    ``moe_tp``)."""
    x, lb, z = _hidden(params, cfg, batch["tokens"], ctx,
                       batch.get("extra_embeds"))
    ce = mesh_ce(params, cfg, x, batch, ctx,
                 ctx.shards_act(_seq_len(cfg, batch["tokens"])))
    total = ce
    if cfg.moe:
        total = (total + cfg.moe.load_balance_coef * lb
                 + cfg.moe.router_z_coef * z)
    return total, {"ce": ce, "load_balance": lb, "router_z": z}


def mesh_ce(params, cfg: ModelConfig, x: torch.Tensor, batch: dict,
            ctx: ShardCtx, sp: bool = False) -> torch.Tensor:
    """The global token-mean cross entropy of ``batch["labels"]`` (masked
    by its ``loss_mask``) given the hidden states ``x`` before the final
    norm, on a training mesh: vocab-parallel where the rank holds a share
    of the head's vocab columns (its GEMMs reducing in f32:
    ``common.matmul_f32_reduced``), the masked sum and token count summed
    over the data axes before the division (module docstring).  ``params``
    holds ``final_norm`` and the head (a decoder's, or the enc-dec's).
    With ``sp`` (sequence parallelism) ``x`` is the rank's chunk of the
    sequence: normed there, then gathered before the head.  A VLM's
    labels score the last positions alone, its text tail."""
    from repro_torch.parallel import collectives as coll
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = _head(params, cfg, ctx)
    split = head.shape[-1] < cfg.vocab
    x = ctx.seq_enter(x, split, sp)
    labels = batch["labels"].long()
    x = x[:, x.shape[1] - labels.shape[1]:]
    logits = (matmul_f32_reduced(x, head) if split else x @ head).float()
    if split:
        mesh, ax = ctx.mesh, ctx.model_axis
        top = coll.pmax(logits.detach().amax(-1), mesh, ax)
        lse = torch.log(coll.leave_region(
            torch.exp(logits - top[..., None]).sum(-1), mesh, ax)) + top
        n = logits.shape[-1]
        t = labels - mesh.axis_index(ax) * n
        mine = (t >= 0) & (t < n)
        gold = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
        gold = coll.leave_region(torch.where(mine, gold, 0.0), mesh, ax)
    else:
        lse, gold = log_partition_and_gold(logits, labels)
    total, count = cross_entropy_sums(lse, gold, batch.get("loss_mask"))
    sums = coll.leave_region(torch.stack([total, count]), ctx.mesh,
                             ctx.batch_axes)
    return sums[0] / torch.clamp(sums[1], min=1.0)


# ---------------------------------------------------------------------------
# Prefill (serving: forward + cache population)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_lm(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               ctx: ShardCtx, max_len: int,
               extra_embeds: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the stack, returning (last-token logits
    (B, 1, V), populated decode cache).  The serving 'bulk' phase: the
    cache is staged once, decode then streams against it.  An SSM or
    hybrid prompt must be a whole number of SSD chunks long, as the
    reference asks.  A VLM's prompt is its ``frontend_len`` projected
    ``extra_embeds`` and then the tokens: ``max_len`` must hold both."""
    _check_family(cfg)
    S = _seq_len(cfg, tokens)
    sp = ctx.shards_act(S)
    x = _embed_inputs(params, cfg, tokens, extra_embeds, ctx, sp)
    B = x.shape[0]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    cache = init_lm_cache(cfg, B, max_len, ctx, device=x.device)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        if S % cfg.ssm.chunk:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens is not a multiple of "
                f"the SSD chunk ({cfg.ssm.chunk}); pad or cut the prompt")
        # the JAX package's decode appends each step's conv input in the
        # activations' dtype to the bf16 window, which promotes: an f32
        # model's window keeps its decode entries in f32 (a bf16 one's
        # stays bf16)
        conv = cache["mamba"].conv
        cache["mamba"] = cache["mamba"]._replace(conv=conv.to(
            torch.promote_types(conv.dtype, x.dtype)))
        sites = _sites(cfg) if cfg.family == "hybrid" else [
            (0, cfg.n_layers)]
        for site, (lo, hi) in enumerate(sites):
            for i in range(lo, hi):
                x = _mamba_prefill(x, params.layers[i], cfg, ctx,
                                   cache["mamba"], i, sp)
            if cfg.family == "hybrid":
                x = _shared_prefill(x, params.shared_attn, cfg, ctx,
                                    positions, cache, site)
        cache["pos"] = S
        return _last_logits(params, cfg, x, ctx, sp), cache

    ring = cache_kind(cfg) == "ring"
    s_cache = _attn_cache_len(cfg, max_len)

    for i, (lp, w) in enumerate(zip(params.layers, cfg.layer_windows())):
        hn = rms_norm(x, lp.ln1, cfg.norm_eps)
        attn_out, k_new, v_new = self_attention_block(
            hn, lp.attn, cfg, ctx, q_pos=positions, k_pos=positions,
            window=w)
        x = x + attn_out
        x = x + ffn_apply(rms_norm(x, lp.ln2, cfg.norm_eps), lp, cfg, ctx,
                          sp)[0]
        if ring:
            cache["k"][i] = _ring_pack(k_new, s_cache)
            cache["v"][i] = _ring_pack(v_new, s_cache)
        else:
            cache["k"][i, :, :S] = k_new
            cache["v"][i, :, :S] = v_new

    cache["pos"] = S
    return _last_logits(params, cfg, x, ctx, sp), cache


def _last_logits(params: LM, cfg: ModelConfig, x: torch.Tensor,
                 ctx: ShardCtx, sp: bool) -> torch.Tensor:
    """The last position's logits (B, 1, V) of the final hidden states
    ``x``: with ``sp`` the rank's chunk, gathered first."""
    x = ctx.seq_enter(x, False, sp)
    return _logits(params, cfg, x[:, -1:, :], ctx)


def _mamba_prefill(x, lp: MambaLayer, cfg, ctx, mamba, i: int,
                   sp: bool = False):
    """Mamba layer ``i`` over the prompt; its final conv window and SSM
    state go into the cache (with ``sp``, ``x`` is the rank's chunk, and
    the block gathers the whole prompt, so they are the prompt's)."""
    hn = rms_norm(x, lp.ln, cfg.norm_eps)
    y, st = ssm_lib.mamba_block_train(hn, lp, cfg, impl=ctx.impl,
                                      return_state=True, ctx=ctx, sp=sp)
    mamba.conv[i] = st.conv
    mamba.ssm[i] = st.ssm
    return x + y


def _shared_prefill(x, sp: DenseLayer, cfg, ctx, positions, cache,
                    site: int):
    """The hybrid's shared attention block at ``site`` over the prompt;
    its K/V go into that site's cache, ring-packed when the config has a
    window (the last ``slots`` steps, each at slot position % slots).
    Under sequence parallelism ``x`` is the rank's chunk, the K/V the
    whole prompt's."""
    S = positions.shape[0]
    hn = rms_norm(x, sp.ln1, cfg.norm_eps)
    attn_out, k_new, v_new = self_attention_block(
        hn, sp.attn, cfg, ctx, q_pos=positions, k_pos=positions,
        window=cfg.window)
    x = x + attn_out
    x = x + mlp_apply(rms_norm(x, sp.ln2, cfg.norm_eps), sp.mlp, cfg, ctx,
                      ctx.shards_act(S))
    slots = cache["shared_k"].shape[2]
    if cfg.window > 0:
        cache["shared_k"][site] = _ring_pack(k_new, slots)
        cache["shared_v"][site] = _ring_pack(v_new, slots)
    else:
        cache["shared_k"][site, :, :S] = k_new
        cache["shared_v"][site, :, :S] = v_new
    return x


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_kind(cfg: ModelConfig) -> str:
    """'ring' when every attention layer is windowed (SWA); 'full'
    otherwise (per-layer windows still masked inside a full cache)."""
    if cfg.window > 0 and cfg.global_every == 0:
        return "ring"
    return "full"


def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(cfg.window, max_len) if cache_kind(cfg) == "ring" else max_len


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  ctx: Optional[ShardCtx] = None, *,
                  device: torch.device | str) -> dict:
    """Decode cache: stacked bf16 K/V (L, B, S_cache, Hkv, hd), or for the
    SSM and hybrid families a ``MambaState`` stacked over layers (and the
    hybrid's shared K/V, (n_sites, B, S_cache, Hkv, hd) bf16), and the
    host-side clock ``pos``.  On a mesh ``batch`` is the rank's rows, Hkv
    the KV heads of ``ctx.heads(cfg)`` and the states those of its SSD
    heads (``ctx.ssm_heads(cfg)``): the rank allocates its share."""
    _check_family(cfg)
    cache: dict[str, Any] = {"pos": 0}
    hkv = ctx.heads(cfg).hkv if ctx is not None else cfg.n_kv_heads
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_lib.init_mamba_state(
            cfg, batch, device=device,
            heads=ctx.ssm_heads(cfg) if ctx is not None else None)
        L = cfg.n_layers
        cache["mamba"] = ssm_lib.MambaState(
            conv=torch.zeros((L,) + st.conv.shape, dtype=st.conv.dtype,
                             device=device),
            ssm=torch.zeros((L,) + st.ssm.shape, dtype=st.ssm.dtype,
                            device=device))
        if cfg.family == "hybrid":
            s = min(cfg.window, max_len) if cfg.window > 0 else max_len
            shape = (len(_sites(cfg)), batch, s, hkv, cfg.hd)
            cache["shared_k"] = torch.zeros(shape, dtype=torch.bfloat16,
                                            device=device)
            cache["shared_v"] = torch.zeros(shape, dtype=torch.bfloat16,
                                            device=device)
        return cache
    s = _attn_cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, s, hkv, cfg.hd)
    cache["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    cache["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return cache


def _decode_attn_block(x, lp: DenseLayer | MoeLayer, cfg, ctx, k_cache,
                       v_cache, pos: int, window: int, ring_len: int, q_pos,
                       k_pos, angles):
    """One decode step through one attention layer against its cache
    (updated in place).  ``q_pos`` (1,), the cache's ``k_pos`` and the RoPE
    ``angles`` at ``pos`` are the step's, shared by every layer.  Returns
    (x_out, k_cache, v_cache)."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    B = x.shape[0]
    hp = ctx.heads(cfg)
    record_query_rows(0, 1, 1)   # a decode step's one row, never split
    q = (h @ lp.attn.wq).reshape(B, 1, hp.hq, cfg.hd)
    k = hp.take_kv((h @ lp.attn.wk).reshape(B, 1, -1, cfg.hd))
    v = hp.take_kv((h @ lp.attn.wv).reshape(B, 1, -1, cfg.hd))
    q = rotate(q, angles)
    k = rotate(k, angles)
    if ring_len > 0:
        cache_update_ring(k_cache, v_cache, k, v, pos, ring_len)
    else:
        cache_update_full(k_cache, v_cache, k, v, pos)
    if ctx.impl == "cuda":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, k_cache, v_cache, k_pos, q_pos,
                                    window=window)
    else:
        out = attention(q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos,
                        causal=True, window=window, impl="ref")
    out = out.reshape(B, 1, hp.hq * cfg.hd) @ lp.attn.wo
    return x + ctx.model_sum(out, hp.q_split), k_cache, v_cache


@torch.no_grad()
def lm_decode_step(params: LM, cfg: ModelConfig, cache: dict,
                   tokens: torch.Tensor, ctx: ShardCtx
                   ) -> tuple[torch.Tensor, dict]:
    """One new token per sequence.  tokens: (B, 1).  Returns (logits
    (B, 1, V), cache) — the same cache, written in place, its clock
    advanced."""
    pos = cache["pos"]
    _check_family(cfg)
    x = _embed(params, cfg, tokens, ctx)   # a VLM's frontend is prefill's only
    if cfg.family == "ssm":
        for i, lp in enumerate(params.layers):
            x = _mamba_decode(x, lp, cfg, cache["mamba"], i, ctx)
        cache["pos"] = pos + 1
        return _logits(params, cfg, x, ctx), cache
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, cache, x, ctx, pos)
        cache["pos"] = pos + 1
        return _logits(params, cfg, x, ctx), cache
    # a ring cache rings over its own slot count, min(window, max_len)
    # (module docstring); one shorter than the window cannot wrap without
    # dropping a key the window keeps, so a step past it raises
    s_cache = cache["k"].shape[2]
    ring = s_cache if cache_kind(cfg) == "ring" else 0
    if pos >= s_cache and (not ring or s_cache < cfg.window):
        raise ValueError(f"decode position {pos} is past the cache "
                         f"({s_cache} slots)")
    # the step's positions and rotary angles, built once for all layers
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    k_pos = (cache_positions_ring(ring, pos, x.device) if ring
             else cache_positions_full(s_cache, pos, x.device))
    angles = rope_angles(q_pos, cfg.hd, cfg.rope_theta)
    for i, (lp, w) in enumerate(zip(params.layers, cfg.layer_windows())):
        x, _, _ = _decode_attn_block(x, lp, cfg, ctx, cache["k"][i],
                                     cache["v"][i], pos, w, ring, q_pos,
                                     k_pos, angles)
        x = x + ffn_apply(rms_norm(x, lp.ln2, cfg.norm_eps), lp, cfg, ctx)[0]
    cache["pos"] = pos + 1
    return _logits(params, cfg, x, ctx), cache


def _mamba_decode(x, lp: MambaLayer, cfg, mamba, i: int, ctx: ShardCtx):
    """One step through Mamba layer ``i``, its cache entries updated."""
    hn = rms_norm(x, lp.ln, cfg.norm_eps)
    y, st = ssm_lib.mamba_block_decode(
        hn, lp, cfg, ssm_lib.MambaState(mamba.conv[i], mamba.ssm[i]), ctx)
    mamba.conv[i] = st.conv
    mamba.ssm[i] = st.ssm
    return x + y


def _hybrid_decode(params: LM, cfg: ModelConfig, cache: dict,
                   x: torch.Tensor, ctx: ShardCtx, pos: int) -> torch.Tensor:
    """One step through the hybrid: each Mamba segment, then the shared
    block against its site's cache.  With a window the shared cache is a
    ring over its own slot count, ``min(window, max_len)`` (the JAX
    package rings over ``cfg.window``, the same wherever it runs); a ring
    shorter than the window cannot wrap without dropping a key the window
    keeps, so a step past it raises, as a full cache does."""
    slots = cache["shared_k"].shape[2]
    ring = slots if cfg.window > 0 else 0
    if pos >= slots and (not ring or slots < cfg.window):
        raise ValueError(f"decode position {pos} is past the shared cache "
                         f"({slots} slots)")
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    k_pos = (cache_positions_ring(ring, pos, x.device) if ring
             else cache_positions_full(slots, pos, x.device))
    angles = rope_angles(q_pos, cfg.hd, cfg.rope_theta)
    sp = params.shared_attn
    for site, (lo, hi) in enumerate(_sites(cfg)):
        for i in range(lo, hi):
            x = _mamba_decode(x, params.layers[i], cfg, cache["mamba"], i,
                              ctx)
        x, _, _ = _decode_attn_block(x, sp, cfg, ctx, cache["shared_k"][site],
                                     cache["shared_v"][site], pos,
                                     cfg.window, ring, q_pos, k_pos, angles)
        x = x + mlp_apply(rms_norm(x, sp.ln2, cfg.norm_eps), sp.mlp, cfg, ctx)
    return x
