"""Block-wise int8 quantization: the oracle of the quantize kernels.

The paper budgets compute for integrity/encryption *inside* the staged
data path (section 3.4); quantizing a float payload to int8 spends a
little compute to put about 4x fewer bytes on the wire.  These are the
plain PyTorch functions of the JAX package's module of the same name;
:mod:`repro_torch.kernels.quantize` holds the hand-written kernels, which
are bit-exact with them.  Error feedback, the training-side use, waits
for the port of training (ROADMAP.md).

Arithmetic, per block of ``block`` values: ``scale = max|x| / 127`` by
true (IEEE) division, ``q = clip(round_half_even(x / safe), -127, 127)``
with ``safe = scale`` where it is > 0 and 1 where the block is all zero.
"""

from __future__ import annotations

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
    """Round trip (the local-arithmetic part of a compressed exchange)."""
    q, s = quantize_int8_blockwise(x, block)
    return dequantize_int8_blockwise(q, s, tuple(x.shape)).to(x.dtype)
