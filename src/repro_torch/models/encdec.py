"""Encoder-decoder backbone (seamless-m4t style, speech frontend stubbed).

The speech encoder takes precomputed frame embeddings (the modality
frontend is a stub): they are cast to bf16 and pass through ``frame_proj``,
then ``enc_layers`` pre-norm layers of non-causal self attention and a
SwiGLU.  The text decoder attends causally to itself and to the whole
encoder output (cross attention, no RoPE).  At serve time every decoder
layer's cross K/V is computed once per request (:func:`cross_kv`, the
"bulk" staging of the cross operands) and decode steps only write the self
cache.

The JAX package scans one layer body over layer-stacked parameters; here
each stack is an ``nn.ModuleList`` walked by a Python loop, as in
:mod:`repro_torch.models.lm`.  Under ``impl="cuda"`` the encoder's self
attention runs the flash kernel without the causal mask and the decoder's
self attention the causal one; a decode step runs the decode kernel twice
a layer: against the self cache, and as cross attention over every
encoder slot (the kernel keeps slot j when ``k_pos[j] <= q_pos``, so the
cross call passes ``k_pos = 0..S_enc-1`` and ``q_pos = S_enc - 1``: every
slot kept, the non-causal attention of the JAX package).  The training
forward's cross attention (query and key lengths differ) runs the plain
path, as the JAX package's does.

On a mesh (``ShardCtx.mesh``) a rank holds and computes its part as a
decoder's rank does (``models/blocks.py``, ``models/lm.py``): the self and
cross attention of its heads, with caches of just those heads (the cross
K/V over every encoder slot), the ``wo`` and ``w_down`` partial sums
summed over the model axis, the embedding and the LM head vocab-parallel
where the vocab divides the model axis (seamless's 256,206 divides 2 but
not 4: whole on every rank there), and ``frame_proj`` whole.  On a
training mesh each layer's weights are gathered over the data axis as it
is reached, the encoder states enter the decoder's region once (every
layer's cross K/V read the rank's heads of them), and the loss is the
global token mean (``lm.mesh_ce``).

Under Megatron sequence parallelism (``ctx.seq_parallel``) the encoder's
and the decoder's layer-boundary activations each hold the rank's chunk
of their own sequence where ``ctx.shards_act`` of its length holds (the
two lengths may differ): ``frame_proj`` runs on the whole frames and the
rank keeps its chunk; the encoder states, normed on the chunk, are
gathered once as they enter the decoder's cross attention
(:func:`encoder_states`), so every layer's cross K/V and a prefill's
cross cache cover every encoder slot.  The enc-dec prefill decodes one
token and is untouched.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .attention import attention, cache_positions_full
from .blocks import (AttnParams, DenseLayer, MlpParams, ShardCtx, _param,
                     dense_layer_apply, init_attn_params, init_dense_layer,
                     init_mlp_params, mlp_apply, self_attention_block)
from .common import (cross_entropy_loss, dense_init, embed_init, rms_norm,
                     rope_angles)
from .config import ModelConfig
from .lm import (_decode_attn_block, _embed, _kept, _layer_remat, _logits,
                 _remat, _weight, mesh_ce)


class DecLayer(nn.Module):
    """A decoder layer: self attention ``attn``, cross attention ``cross``,
    the SwiGLU ``mlp`` and their pre-norm scales ``ln1``, ``ln2``, ``ln3``."""

    def __init__(self, attn: AttnParams, cross: AttnParams, mlp: MlpParams,
                 ln1, ln2, ln3):
        super().__init__()
        self.attn = attn
        self.cross = cross
        self.mlp = mlp
        self.ln1 = _param(ln1)
        self.ln2 = _param(ln2)
        self.ln3 = _param(ln3)


class EncDec(nn.Module):
    """Parameters of the encoder-decoder, named as the JAX package's tree:
    ``embed``, ``enc_layers`` (``DenseLayer``: attn, mlp, ln1, ln2),
    ``dec_layers`` (``DecLayer``), ``enc_norm``, ``final_norm``,
    ``lm_head`` and the frontend stub's adapter ``frame_proj``."""

    def __init__(self, embed: torch.Tensor, enc_layers: list[DenseLayer],
                 dec_layers: list[DecLayer], enc_norm: torch.Tensor,
                 final_norm: torch.Tensor, lm_head: torch.Tensor,
                 frame_proj: torch.Tensor):
        super().__init__()
        self.embed = _param(embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm = _param(enc_norm)
        self.final_norm = _param(final_norm)
        self.lm_head = _param(lm_head)
        self.frame_proj = _param(frame_proj)


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator,
                device: torch.device | str, trainable: bool = False,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]]
                = None) -> EncDec:
    """Random parameters drawn on ``device`` from ``generator``; with
    ``trainable`` they require gradients.  ``keep(name, tensor)``, given,
    maps each parameter as it is drawn to what the model holds, e.g. a
    rank's shard, as ``lm.init_lm``'s does: the same draws, and no more
    than one layer held whole."""
    cfg.validate()
    D, V = cfg.d_model, cfg.vocab
    kw = dict(generator=generator, device=device)
    keep = keep or (lambda name, t: t)
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=device)
    enc = [_kept(init_dense_layer(cfg, **kw), f"enc_layers.{i}", keep)
           for i in range(cfg.enc_layers)]
    dec = [_kept(DecLayer(init_attn_params(cfg, **kw),
                          init_attn_params(cfg, **kw),
                          init_mlp_params(cfg, **kw), zeros(), zeros(),
                          zeros()), f"dec_layers.{i}", keep)
           for i in range(cfg.n_layers)]
    embed = keep("embed", embed_init((V, D), **kw))
    enc_norm, final_norm = keep("enc_norm", zeros()), keep("final_norm",
                                                           zeros())
    lm_head = keep("lm_head", dense_init((D, V), D, **kw))
    frame_proj = keep("frame_proj", dense_init((D, D), D, **kw))
    return EncDec(embed, enc, dec, enc_norm, final_norm, lm_head,
                  frame_proj).requires_grad_(trainable)


def _enc_layer(h, lp: DenseLayer, cfg, ctx, positions):
    return dense_layer_apply(h, lp, cfg, ctx, positions=positions,
                             causal=False, prefix="enc_layers")


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
           ctx: ShardCtx) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states (B, S_enc,
    D) bf16; under sequence parallelism (``ctx.shards_act(S_enc)``) the
    rank's chunk of them (:func:`encoder_states` gathers them)."""
    w = _weight(params, "frame_proj", ctx)
    # bf16 frames; with f32 weights promoted to f32, as JAX promotes them
    x = frames.to(torch.bfloat16).to(w.dtype) @ w
    S = x.shape[1]
    x = ctx.seq_leave(x, False, ctx.shards_act(S))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    body = _remat(_enc_layer, _layer_remat(cfg, ctx, "enc_layers/"))
    for lp in params.enc_layers:
        x = body(x, lp, cfg, ctx, positions)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def encoder_states(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                   ctx: ShardCtx) -> torch.Tensor:
    """The encoder states (B, S_enc, D) as they enter the decoder's cross
    attention, whole on every rank: every layer's cross K/V read the
    rank's heads of them (on a training mesh their gradient is summed
    over the model axis where the heads split it); under sequence
    parallelism the chunks :func:`encode` leaves, gathered once."""
    enc_out = encode(params, cfg, frames, ctx)
    return ctx.seq_enter(enc_out, ctx.heads(cfg).q_split,
                         ctx.shards_act(frames.shape[1]))


def _cross_block(hc: torch.Tensor, enc_out: torch.Tensor, p: AttnParams,
                 cfg: ModelConfig, ctx: ShardCtx, positions: torch.Tensor,
                 enc_positions: torch.Tensor, sp: bool = False
                 ) -> torch.Tensor:
    """Cross attention (no RoPE: the encoder memory is position-agnostic)
    of the normed decoder states ``hc`` over ``enc_out``, over the rank's
    heads (``ctx.heads``; ``enc_out`` has entered the region already).
    Query and key lengths differ, so it takes the plain path.  With
    ``sp`` (sequence parallelism) ``hc`` and the output are the rank's
    chunk of the decoder's sequence."""
    hp = ctx.heads(cfg)
    hc = ctx.seq_enter(hc, hp.q_split, sp)
    B, S, _ = hc.shape
    wk, wv = (ctx.enter(w, hp.kv is not None) for w in (p.wk, p.wv))
    qc = (hc @ p.wq).reshape(B, S, hp.hq, cfg.hd)
    kc = hp.take_kv((enc_out @ wk).reshape(B, enc_out.shape[1], -1, cfg.hd))
    vc = hp.take_kv((enc_out @ wv).reshape(B, enc_out.shape[1], -1, cfg.hd))
    out = attention(qc, kc, vc, q_pos=positions, k_pos=enc_positions,
                    causal=False, impl="ref")
    return ctx.seq_leave(out.reshape(B, S, hp.hq * cfg.hd) @ p.wo,
                         hp.q_split, sp)


def _dec_layer(h, lp: DecLayer, cfg, ctx, positions, enc_out, enc_positions):
    lp = ctx.gathered(lp, "dec_layers")
    sp = ctx.shards_act(positions.shape[0])
    attn_out, _, _ = self_attention_block(
        rms_norm(h, lp.ln1, cfg.norm_eps), lp.attn, cfg, ctx,
        q_pos=positions, k_pos=positions)
    h = h + attn_out
    h = h + _cross_block(rms_norm(h, lp.ln2, cfg.norm_eps), enc_out,
                         lp.cross, cfg, ctx, positions, enc_positions, sp)
    return h + mlp_apply(rms_norm(h, lp.ln3, cfg.norm_eps), lp.mlp, cfg, ctx,
                         sp)


def _decoder_stack(params: EncDec, cfg: ModelConfig, x: torch.Tensor,
                   enc_out: torch.Tensor, ctx: ShardCtx,
                   S: int) -> torch.Tensor:
    """The decoder layers over ``x`` (a sequence of ``S`` positions: under
    sequence parallelism ``x`` is the rank's chunk); every layer's cross
    K/V read the rank's heads of ``enc_out`` (:func:`encoder_states`)."""
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    enc_positions = torch.arange(enc_out.shape[1], dtype=torch.int32,
                                 device=x.device)
    body = _remat(_dec_layer, _layer_remat(cfg, ctx, "dec_layers/"))
    for lp in params.dec_layers:
        x = body(x, lp, cfg, ctx, positions, enc_out, enc_positions)
    return x


def _dec_hidden(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                dec_tokens: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The teacher-forced forward up to the final norm: (B, S_dec, D), under
    sequence parallelism the rank's chunk of it."""
    enc_out = encoder_states(params, cfg, frames, ctx)
    S = dec_tokens.shape[1]
    x = _embed(params, cfg, dec_tokens, ctx, ctx.shards_act(S))
    return _decoder_stack(params, cfg, x, enc_out, ctx, S)


def forward_encdec(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                   dec_tokens: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Teacher-forced forward: (B, S_dec, V) logits (on a mesh, the whole
    vocab's on every model rank)."""
    x = _dec_hidden(params, cfg, frames, dec_tokens, ctx)
    x = ctx.seq_enter(x, False, ctx.shards_act(dec_tokens.shape[1]))
    return _logits(params, cfg, x, ctx)


def encdec_loss(params: EncDec, cfg: ModelConfig, batch: dict,
                ctx: ShardCtx) -> tuple[torch.Tensor, dict]:
    """Token-mean cross entropy of ``labels`` given ``frames`` and the
    decoder's ``tokens``, and the aux dict ``{"ce": ce}``; on a training
    mesh the global token mean over the rank's rows and vocab columns
    (``lm.mesh_ce``)."""
    if ctx.training:
        ce = mesh_ce(params, cfg, _dec_hidden(params, cfg, batch["frames"],
                                              batch["tokens"], ctx),
                     batch, ctx, ctx.shards_act(batch["tokens"].shape[1]))
        return ce, {"ce": ce}
    logits = forward_encdec(params, cfg, batch["frames"], batch["tokens"],
                            ctx)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@torch.no_grad()
def cross_kv(params: EncDec, cfg: ModelConfig, enc_out: torch.Tensor,
             ctx: Optional[ShardCtx] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V from the encoder states, computed
    once per request: (L, B, S_enc, Hkv, hd) bf16 x 2, on a mesh (``ctx``)
    the rank's KV heads (``ctx.heads``)."""
    B, S_enc, _ = enc_out.shape
    hp = (ctx or ShardCtx()).heads(cfg)
    shape = (cfg.n_layers, B, S_enc, hp.hkv, cfg.hd)
    kc = torch.empty(shape, dtype=torch.bfloat16, device=enc_out.device)
    vc = torch.empty_like(kc)
    for i, lp in enumerate(params.dec_layers):
        kc[i] = hp.take_kv((enc_out @ lp.cross.wk).reshape(
            B, S_enc, -1, cfg.hd))
        vc[i] = hp.take_kv((enc_out @ lp.cross.wv).reshape(
            B, S_enc, -1, cfg.hd))
    return kc, vc


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, ctx: Optional[ShardCtx] = None, *,
                      device: torch.device | str) -> dict:
    """Decode cache: the self K/V (L, B, max_len, Hkv, hd) bf16, the cross
    K/V (L, B, enc_len, Hkv, hd) bf16 and the host-side clock ``pos``; on
    a mesh B is the rank's rows and Hkv its KV heads (``ctx.heads``)."""
    L = cfg.n_layers
    hkv = (ctx or ShardCtx()).heads(cfg).hkv
    kv = (L, batch, max_len, hkv, cfg.hd)
    ckv = (L, batch, enc_len, hkv, cfg.hd)
    zeros = lambda shape: torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)
    return {"pos": 0, "k": zeros(kv), "v": zeros(kv),
            "cross_k": zeros(ckv), "cross_v": zeros(ckv)}


def _cross_decode(h: torch.Tensor, lp: DecLayer, cfg: ModelConfig,
                  ctx: ShardCtx, ck: torch.Tensor, cv: torch.Tensor,
                  q_pos: torch.Tensor, enc_positions: torch.Tensor
                  ) -> torch.Tensor:
    """One decoder token's cross attention over every encoder slot, over
    the rank's heads (its cross K/V's)."""
    B = h.shape[0]
    hp = ctx.heads(cfg)
    hc = rms_norm(h, lp.ln2, cfg.norm_eps)
    qc = (hc @ lp.cross.wq).reshape(B, 1, hp.hq, cfg.hd)
    if ctx.impl == "cuda":
        from repro_torch.kernels import ops as kops
        # the kernel keeps k_pos <= q_pos: a query at the last encoder
        # position keeps every slot, the non-causal mask
        out = kops.decode_attention(qc, ck, cv, enc_positions,
                                    enc_positions[-1:], window=0)
    else:
        out = attention(qc, ck, cv, q_pos=q_pos, k_pos=enc_positions,
                        causal=False, impl="ref")
    return h + ctx.model_sum(out.reshape(B, 1, hp.hq * cfg.hd) @ lp.cross.wo,
                             hp.q_split)


@torch.no_grad()
def encdec_decode_step(params: EncDec, cfg: ModelConfig, cache: dict,
                       tokens: torch.Tensor, ctx: ShardCtx
                       ) -> tuple[torch.Tensor, dict]:
    """One decoder token per sequence against the self cache (written in
    place) and the precomputed cross K/V.  tokens: (B, 1).  Returns
    (logits (B, 1, V), cache) with its clock advanced."""
    pos = cache["pos"]
    s_self = cache["k"].shape[2]
    if pos >= s_self:
        raise ValueError(f"decode position {pos} is past the cache "
                         f"({s_self} slots)")
    x = _embed(params, cfg, tokens, ctx)
    dev = x.device
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    k_pos = cache_positions_full(s_self, pos, dev)
    enc_positions = torch.arange(cache["cross_k"].shape[2],
                                 dtype=torch.int32, device=dev)
    angles = rope_angles(q_pos, cfg.hd, cfg.rope_theta)
    for i, lp in enumerate(params.dec_layers):
        x, _, _ = _decode_attn_block(x, lp, cfg, ctx, cache["k"][i],
                                     cache["v"][i], pos, 0, 0, q_pos, k_pos,
                                     angles)
        x = _cross_decode(x, lp, cfg, ctx, cache["cross_k"][i],
                          cache["cross_v"][i], q_pos, enc_positions)
        x = x + mlp_apply(rms_norm(x, lp.ln3, cfg.norm_eps), lp.mlp, cfg,
                          ctx)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x, ctx), cache


@torch.no_grad()
def prefill_encdec(params: EncDec, cfg: ModelConfig, batch: dict,
                   ctx: ShardCtx, max_len: int) -> tuple[torch.Tensor, dict]:
    """The JAX package's enc-dec prefill: encode ``frames``, precompute the
    cross K/V, and decode the first decoder token ``tokens[:, :1]`` (the
    rest of the decoder prompt is not read, as there).  Returns (logits
    (B, 1, V), cache at position 1)."""
    enc_out = encoder_states(params, cfg, batch["frames"], ctx)
    cache = init_encdec_cache(cfg, enc_out.shape[0], max_len, 0, ctx,
                              device=enc_out.device)
    cache["cross_k"], cache["cross_v"] = cross_kv(params, cfg, enc_out, ctx)
    return encdec_decode_step(params, cfg, cache, batch["tokens"][:, :1],
                              ctx)
