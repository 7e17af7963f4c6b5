"""Gradient compression: block-wise int8 quantization with error feedback.

The paper budgets compute for integrity/encryption *inside* the staged
data path (section 3.4); quantizing a float payload to int8 spends a
little compute to put about 4x fewer bytes on the wire.  The blockwise
functions are the plain PyTorch versions of the JAX package's module of
the same name, the oracle of :mod:`repro_torch.kernels.quantize`'s
hand-written kernels, which are bit-exact with them.

Error feedback (1-bit-Adam style) keeps each step's quantization residual
and adds it to the next step's gradient, over a list of tensors (the
port's parameter order).  Its round trip (:func:`compress_decompress`)
launches the quantize and dequantize kernels on a card tensor and runs
their plain versions on a CPU one.  The compressed exchange itself is
``repro_torch.parallel.collectives.compressed_psum``.

Arithmetic, per block of ``block`` values: ``scale = max|x| / 127`` by
true (IEEE) division, ``q = clip(round_half_even(x / safe), -127, 127)``
with ``safe = scale`` where it is > 0 and 1 where the block is all zero.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def _pad_to_block(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize_int8_blockwise(x: torch.Tensor, block: int = 256
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 values (nblocks, block), f32 scales
    (nblocks,)).  Symmetric per-block scaling: scale = max|x| / 127."""
    flat, _ = _pad_to_block(x.float(), block)
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_blockwise(q: torch.Tensor, scale: torch.Tensor,
                              shape: tuple[int, ...]) -> torch.Tensor:
    """(q, scale) -> f32 of ``shape`` (the padding cut off)."""
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compress_decompress(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Round trip (the local-arithmetic part of a compressed exchange).
    On a card tensor it runs the kernels, built for 256-value blocks only;
    on a CPU tensor the plain functions above."""
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        if block != kops.QUANT_BLOCK:
            raise ValueError(f"the quantize kernels take blocks of "
                             f"{kops.QUANT_BLOCK} values, not {block}")
        q, s = kops.quantize(x)
        return kops.dequantize(q, s, tuple(x.shape)).to(x.dtype)
    q, s = quantize_int8_blockwise(x, block)
    return dequantize_int8_blockwise(q, s, tuple(x.shape)).to(x.dtype)


class CompressionState(NamedTuple):
    """Per-parameter error-feedback residuals (f32), in parameter order."""

    residual: list[torch.Tensor]


def error_feedback_init(params: Sequence[torch.Tensor]) -> CompressionState:
    """Zero residuals shaped as ``params``, on their devices."""
    return CompressionState(residual=[
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in params])


@torch.no_grad()
def error_feedback_step(grads: Sequence[torch.Tensor],
                        state: CompressionState, block: int = 256
                        ) -> tuple[list[torch.Tensor], CompressionState]:
    """Compress (g + residual); carry the quantization error to the next
    step.  Returns (the decompressed gradients as the receiving side sees
    them, f32, and the new state)."""
    sent, resid = [], []
    for g, r in zip(grads, state.residual, strict=True):
        corrected = g.float() + r
        out = compress_decompress(corrected, block).float()
        sent.append(out)
        resid.append(corrected - out)
    return sent, CompressionState(residual=resid)
