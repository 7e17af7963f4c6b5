"""Transformer building blocks and the (single-device) context threaded
through the models.

``ShardCtx`` keeps the JAX package's name so a reader finds the
counterpart; here it holds no mesh, only the kernel implementation:
``"cuda"`` runs the hand-written kernels (their plain versions when the
tensors lie on the CPU), ``"ref"`` the plain paths of ``attention`` and
``ssm.ssd_chunked``.

Parameters are ``nn.Module``s whose attribute names follow the JAX
package's parameter tree (``attn.wq``, ``mlp.w_gate``, ``ln1``, ``in_proj``, ...), so
:func:`repro_torch.weights.from_jax_params` maps one onto the other by name.
They are created without gradients, as serving wants them; a trainer asks
for trainable ones (``init_lm(..., trainable=True)``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from . import ffn as ffn_lib
from .attention import attention
from .common import apply_rope, dense_init, rms_norm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Single-device model context."""

    impl: str = "cuda"             # attention / SSD kernels: cuda | ref

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
