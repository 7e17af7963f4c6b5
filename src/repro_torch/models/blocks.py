"""Transformer building blocks and the (single-device) context threaded
through the models.

``ShardCtx`` keeps the JAX package's name so a reader finds the
counterpart; here it holds no mesh, only the attention implementation:
``"cuda"`` runs the hand-written kernels (their plain versions when the
tensors lie on the CPU), ``"ref"`` the plain path of ``attention``.

Parameters are ``nn.Module``s whose attribute names follow the JAX
package's parameter tree (``attn.wq``, ``mlp.w_gate``, ``ln1``, ...), so
:func:`repro_torch.weights.from_jax_params` maps one onto the other by name.
They are created without gradients: this package serves, it does not train.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import ffn as ffn_lib
from .attention import attention
from .common import apply_rope, dense_init, rms_norm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Single-device model context."""

    impl: str = "cuda"             # attention kernels: cuda | ref

    def __post_init__(self):
        if self.impl not in ("cuda", "ref"):
            raise ValueError(f"impl must be 'cuda' or 'ref', got {self.impl!r}")


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


def init_dense_layer(cfg: ModelConfig, *, generator: torch.Generator,
                     device: torch.device | str) -> DenseLayer:
    D = cfg.d_model
    zeros = lambda: torch.zeros((D,), dtype=torch.float32, device=device)
    return DenseLayer(init_attn_params(cfg, generator=generator, device=device),
                      init_mlp_params(cfg, generator=generator, device=device),
                      zeros(), zeros())


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def self_attention_block(
    x: torch.Tensor, p: AttnParams, cfg: ModelConfig, ctx: ShardCtx, *,
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projections + RoPE + causal attention over this step's keys.
    Returns (out, k_new, v_new), k_new/v_new post-RoPE (the cache's
    entries)."""
    B, S, D = x.shape
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (x @ p.wk).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p.wv).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)   # new keys carry current positions
    out = attention(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window,
                    impl=ctx.impl)
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p.wo, k, v


def dense_layer_apply(
    x: torch.Tensor, p: DenseLayer, cfg: ModelConfig, ctx: ShardCtx, *,
    positions: torch.Tensor, window: int = 0,
) -> torch.Tensor:
    """Full pre-norm causal transformer layer (no cache)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, _, _ = self_attention_block(
        h, p.attn, cfg, ctx, q_pos=positions, k_pos=positions, window=window)
    x = x + attn_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + ffn_lib.swiglu(h2, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)
