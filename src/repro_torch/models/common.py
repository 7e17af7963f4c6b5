"""Shared model primitives: norms, RoPE, initializers, dtype policy."""

from __future__ import annotations

import contextlib

import torch

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics; the learned scale is ``1 + scale``
    (zero-initialised), applied in f32."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def rope_freqs(hd: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings (half-split convention)."""
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope_angles(positions: torch.Tensor, hd: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles at ``positions`` (..., S), each
    (..., S, 1, hd/2) f32: computed once, they serve every layer."""
    inv = rope_freqs(hd, theta, positions.device)             # (hd/2,)
    ang = positions.float()[..., None] * inv                  # (..., S, hd/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor,
           angles: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Apply the rotation of :func:`rope_angles` to x (..., S, H, hd)."""
    cos, sin = angles
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., S, H, hd); positions: broadcastable to (..., S) absolute ids.
    Half-split (LLaMA) convention: rotate [x1, x2] halves, in f32."""
    return rotate(x, rope_angles(positions, x.shape[-1], theta))


def dense_init(shape: tuple[int, ...], in_dim: int, *,
               generator: torch.Generator, device: torch.device | str,
               dtype: torch.dtype = PARAM_DTYPE) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(in_dim)), drawn in f32
    on ``device`` from ``generator``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * in_dim ** -0.5).to(dtype)


def embed_init(shape: tuple[int, ...], *, generator: torch.Generator,
               device: torch.device | str,
               dtype: torch.dtype = PARAM_DTYPE) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.to(dtype)


#: the z-loss coefficient of the language models' cross entropy
Z_LOSS_COEF = 1e-4


def log_partition_and_gold(logits: torch.Tensor, labels: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp over the vocab, the label's logit) of each token, in
    f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse, gold


def cross_entropy_sums(lse: torch.Tensor, gold: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       z_loss_coef: float = Z_LOSS_COEF
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the masked sum of the tokens' cross entropy with its z-loss, the
    count of tokens the mask keeps): the token mean's numerator and
    denominator, from each token's log-sum-exp and label logit."""
    ce = lse - gold
    if z_loss_coef:
        ce = ce + z_loss_coef * torch.square(lse)
    if mask is None:
        return torch.sum(ce), ce.new_tensor(float(ce.numel()))
    mask = mask.float()
    return torch.sum(ce * mask), torch.sum(mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       z_loss_coef: float = Z_LOSS_COEF) -> torch.Tensor:
    """Token-mean cross entropy in f32 with an optional z-loss (keeps the
    log-partition near 0) and an optional per-token mask."""
    total, count = cross_entropy_sums(*log_partition_and_gold(logits, labels),
                                      mask, z_loss_coef)
    return total / torch.clamp(count, min=1.0)


@contextlib.contextmanager
def _f32_reductions():
    """cuBLAS bf16 GEMMs inside reduce their split-K partial sums in f32
    (PyTorch lets them reduce in bf16 by default,
    ``allow_bf16_reduced_precision_reduction``); the flag is restored on
    leaving."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = old


class _F32ReducedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _f32_reductions():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _f32_reductions():
            gx = g @ w.T
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw


def matmul_f32_reduced(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., K), w (K, N)) whose forward and backward GEMMs
    reduce their partial sums in f32.  For a vocab-parallel head: its
    input's gradient sums over the rank's vocab columns (K = 128,103 for
    seamless at a model axis of 2), where cuBLAS's bf16 split-K
    reductions moved the final norm's gradient 7.4% off the one-card
    step's on an H100."""
    return _F32ReducedMatmul.apply(x, w)
