"""Decoder-only language models, dense and SSM families: the training
forward and loss, prefill and cached decode.

The JAX package scans one layer body over layer-stacked parameters
(``jax.lax.scan``); here the layers are an ``nn.ModuleList`` walked by a
Python loop, and each layer's attention window is a Python int
(``ModelConfig.layer_windows``), so the kernels see it as a constant.

The dense decode cache holds the K/V of every layer stacked as
(L, B, S_cache, Hkv, hd) bf16, the SSM cache a ``MambaState`` of the conv
windows (L, B, conv_width-1, conv_dim) bf16 and the recurrent states
(L, B, H, P, N) f32, both as the JAX package's do, with a host-side int
``pos``.  Decode writes each step's entries into the cache in place.

Training (:func:`forward_lm`, :func:`lm_loss`) runs under autograd on
parameters built with ``trainable=True``; ``cfg.remat`` decides what the
backward pass keeps, as the JAX package's ``_remat`` does: ``"full"``
recomputes each layer from its input (``torch.utils.checkpoint``), ``"none"``
keeps every activation.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from . import ffn as ffn_lib
from .attention import (attention, cache_positions_full, cache_positions_ring,
                        cache_update_full, cache_update_ring)
from . import ssm as ssm_lib
from .blocks import (DenseLayer, MambaLayer, ShardCtx, _param,
                     dense_layer_apply, init_dense_layer, init_mamba_layer,
                     self_attention_block)
from .common import (cross_entropy_loss, dense_init, embed_init, rms_norm,
                     rope_angles, rotate)
from .config import ModelConfig

#: families this package runs; the others are queued in ROADMAP.md
PORTED_FAMILIES = ("dense", "ssm")


class LM(nn.Module):
    """Parameters of a decoder: embedding, layers (``DenseLayer`` or
    ``MambaLayer``), final norm and (unless tied) the LM head."""

    def __init__(self, embed: torch.Tensor,
                 layers: list[DenseLayer] | list[MambaLayer],
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _param(final_norm)
        self.lm_head = _param(lm_head) if lm_head is not None else None


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ported: {PORTED_FAMILIES}, without a frontend)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: torch.device | str, trainable: bool = False) -> LM:
    """Random parameters drawn on ``device`` from ``generator``; with
    ``trainable`` they require gradients (serving leaves them frozen)."""
    cfg.validate()
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab
    kw = dict(generator=generator, device=device)
    embed = embed_init((V, D), **kw)
    init_layer = init_mamba_layer if cfg.family == "ssm" else init_dense_layer
    layers = [init_layer(cfg, **kw) for _ in range(cfg.n_layers)]
    final_norm = torch.zeros((D,), dtype=torch.float32, device=device)
    lm_head = None if cfg.tie_embeddings else dense_init((D, V), D, **kw)
    return LM(embed, layers, final_norm, lm_head).requires_grad_(trainable)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _embed_inputs(params: LM, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()]


def _logits(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


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


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def _remat(fn, mode: str):
    if mode == "none":
        return fn
    if mode != "full":
        raise NotImplementedError(f"remat {mode!r} is not ported "
                                  "(ported: 'none', 'full')")
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False)


def _dense_layer(x, lp, cfg, ctx, positions, window):
    return dense_layer_apply(x, lp, cfg, ctx, positions=positions,
                             window=window)


def _mamba_layer(x, lp, cfg, ctx, positions, window):
    h = rms_norm(x, lp.ln, cfg.norm_eps)
    return x + ssm_lib.mamba_block_train(h, lp, cfg, impl=ctx.impl)


def forward_lm(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               ctx: ShardCtx) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), load-balance
    loss, router z-loss); the two auxiliary losses are 0 for the dense and
    SSM families."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    body = _remat(_mamba_layer if cfg.family == "ssm" else _dense_layer,
                  cfg.remat)
    for lp, w in zip(params.layers, cfg.layer_windows()):
        x = body(x, lp, cfg, ctx, positions, w)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), zero, zero


def lm_loss(params: LM, cfg: ModelConfig, batch: dict, ctx: ShardCtx
            ) -> tuple[torch.Tensor, dict]:
    """Token-mean cross entropy (z-loss included) of the batch's
    ``labels`` under the model, and the aux dict of the JAX package
    (``ce``, ``load_balance``, ``router_z``)."""
    logits, lb, z = forward_lm(params, cfg, batch["tokens"], ctx)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "load_balance": lb, "router_z": z}


# ---------------------------------------------------------------------------
# Prefill (serving: forward + cache population)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_lm(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
               ctx: ShardCtx, max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the stack, returning (last-token logits
    (B, 1, V), populated decode cache).  The serving 'bulk' phase: the
    cache is staged once, decode then streams against it.  An SSM prompt
    must be a whole number of SSD chunks long, as the reference asks."""
    x = _embed_inputs(params, cfg, tokens)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    cache = init_lm_cache(cfg, B, max_len, device=x.device)
    if cfg.family == "ssm":
        if S % cfg.ssm.chunk:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens is not a multiple of "
                f"the SSD chunk ({cfg.ssm.chunk}); pad or cut the prompt")
        mamba = cache["mamba"]
        for i, lp in enumerate(params.layers):
            hn = rms_norm(x, lp.ln, cfg.norm_eps)
            y, st = ssm_lib.mamba_block_train(hn, lp, cfg, impl=ctx.impl,
                                              return_state=True)
            x = x + y
            mamba.conv[i] = st.conv
            mamba.ssm[i] = st.ssm
        cache["pos"] = S
        return _logits(params, cfg, x[:, -1:, :]), cache

    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ring = cache_kind(cfg) == "ring"
    s_cache = _attn_cache_len(cfg, max_len)

    for i, (lp, w) in enumerate(zip(params.layers, cfg.layer_windows())):
        hn = rms_norm(x, lp.ln1, cfg.norm_eps)
        attn_out, k_new, v_new = self_attention_block(
            hn, lp.attn, cfg, ctx, q_pos=positions, k_pos=positions,
            window=w)
        x = x + attn_out
        h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + ffn_lib.swiglu(h2, lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down)
        if ring:
            cache["k"][i] = _ring_pack(k_new, s_cache)
            cache["v"][i] = _ring_pack(v_new, s_cache)
        else:
            cache["k"][i, :, :S] = k_new
            cache["v"][i, :, :S] = v_new

    cache["pos"] = S
    return _logits(params, cfg, x[:, -1:, :]), cache


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
    SSM family a ``MambaState`` stacked over layers, and the host-side
    clock ``pos``."""
    _check_family(cfg)
    cache: dict[str, Any] = {"pos": 0}
    if cfg.family == "ssm":
        st = ssm_lib.init_mamba_state(cfg, batch, device=device)
        L = cfg.n_layers
        cache["mamba"] = ssm_lib.MambaState(
            conv=torch.zeros((L,) + st.conv.shape, dtype=st.conv.dtype,
                             device=device),
            ssm=torch.zeros((L,) + st.ssm.shape, dtype=st.ssm.dtype,
                            device=device))
        return cache
    s = _attn_cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
    cache["k"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    cache["v"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return cache


def _decode_attn_block(x, lp: DenseLayer, cfg, ctx, k_cache, v_cache,
                       pos: int, window: int, ring_len: int, q_pos, k_pos,
                       angles):
    """One decode step through one attention layer against its cache
    (updated in place).  ``q_pos`` (1,), the cache's ``k_pos`` and the RoPE
    ``angles`` at ``pos`` are the step's, shared by every layer.  Returns
    (x_out, k_cache, v_cache)."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    B = x.shape[0]
    q = (h @ lp.attn.wq).reshape(B, 1, cfg.n_heads, cfg.hd)
    k = (h @ lp.attn.wk).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    v = (h @ lp.attn.wv).reshape(B, 1, cfg.n_kv_heads, cfg.hd)
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
    out = out.reshape(B, 1, cfg.q_dim)
    return x + out @ lp.attn.wo, k_cache, v_cache


@torch.no_grad()
def lm_decode_step(params: LM, cfg: ModelConfig, cache: dict,
                   tokens: torch.Tensor, ctx: ShardCtx
                   ) -> tuple[torch.Tensor, dict]:
    """One new token per sequence.  tokens: (B, 1).  Returns (logits
    (B, 1, V), cache) — the same cache, written in place, its clock
    advanced."""
    pos = cache["pos"]
    if cfg.family == "ssm":
        x = _embed_inputs(params, cfg, tokens)
        mamba = cache["mamba"]
        for i, lp in enumerate(params.layers):
            hn = rms_norm(x, lp.ln, cfg.norm_eps)
            y, st = ssm_lib.mamba_block_decode(
                hn, lp, cfg, ssm_lib.MambaState(mamba.conv[i], mamba.ssm[i]))
            x = x + y
            mamba.conv[i] = st.conv
            mamba.ssm[i] = st.ssm
        cache["pos"] = pos + 1
        return _logits(params, cfg, x), cache
    s_cache = cache["k"].shape[2]
    ring = cfg.window if cache_kind(cfg) == "ring" else 0
    if not ring and pos >= s_cache:
        raise ValueError(f"decode position {pos} is past the cache "
                         f"({s_cache} slots)")
    x = _embed_inputs(params, cfg, tokens)
    # the step's positions and rotary angles, built once for all layers
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    k_pos = (cache_positions_ring(ring, pos, x.device) if ring
             else cache_positions_full(s_cache, pos, x.device))
    angles = rope_angles(q_pos, cfg.hd, cfg.rope_theta)
    for i, (lp, w) in enumerate(zip(params.layers, cfg.layer_windows())):
        x, _, _ = _decode_attn_block(x, lp, cfg, ctx, cache["k"][i],
                                     cache["v"][i], pos, w, ring, q_pos,
                                     k_pos, angles)
        h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + ffn_lib.swiglu(h2, lp.mlp.w_gate, lp.mlp.w_up, lp.mlp.w_down)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
