"""Blockwise int8 quantize / dequantize: the wrappers of ``csrc/quantize.cu``.

Replace the Pallas TPU kernels :func:`repro.kernels.quantize.quantize_int8`
and :func:`repro.kernels.quantize.dequantize_int8`: symmetric int8 per
256-value block with an f32 scale, ``scale = max|x| / 127`` and
``q = clip(round_half_even(x / scale), -127, 127)``, bit-exact with the
oracle :func:`repro_torch.optim.compression.quantize_int8_blockwise`.  As
the TPU kernel does, :func:`quantize_int8` flattens its input to f32 and
zero-pads it to a multiple of ``BLOCK * TILE`` values, so the codes on the
wire have the JAX kernel's shape; the padding blocks are q 0, scale 0.
On a CUDA tensor the wrappers launch the kernels or raise; on a CPU
tensor, and only there, they compute the plain versions
(:func:`repro_torch.kernels.ref.quantize_int8_ref` /
:func:`~repro_torch.kernels.ref.dequantize_int8_ref`).
"""

from __future__ import annotations

import math

import torch

from . import build, ref

#: values per block (one f32 scale each)
BLOCK = 256
#: blocks per TPU grid step: the flat input pads to BLOCK * TILE values
TILE = 8


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 (nb, 256), scales f32 (nb,)), nb a
    multiple of 8 covering the flat f32 values."""
    flat = x.reshape(-1).float()
    if not flat.is_cuda:
        return ref.quantize_int8_ref(flat, block=BLOCK, tile=TILE)
    n = flat.numel()
    nb = -(-n // (BLOCK * TILE)) * TILE
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=flat.device)
    s = torch.empty((nb,), dtype=torch.float32, device=flat.device)
    if n == 0:
        return q, s
    flat = _aligned(flat)
    lib = build.library("quantize_int8")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.quantize_int8_f32(flat.data_ptr(), n, q.data_ptr(),
                                    s.data_ptr(), nb, stream)
    build.check("quantize_int8", err)
    build.count_launch("quantize_int8")
    return q, s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    """q int8 (nb, 256) and scales f32 (nb,) -> f32 of ``shape``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize takes int8 codes and f32 scales, got "
                        f"{q.dtype} and {s.dtype}")
    if q.ndim != 2 or q.shape[1] != BLOCK or tuple(s.shape) != (q.shape[0],):
        raise ValueError(f"codes {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} are not (nb, {BLOCK}) and (nb,)")
    if n > q.numel():
        raise ValueError(f"{q.shape[0]} blocks hold {q.numel()} values, "
                         f"fewer than {shape} needs")
    if not q.is_cuda:
        return ref.dequantize_int8_ref(q, s, shape)
    if s.device != q.device:
        raise ValueError("codes and scales must lie on one device")
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    q, s = _aligned(q), s.contiguous()
    lib = build.library("dequantize_int8")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequantize_int8_f32(q.data_ptr(), s.data_ptr(),
                                      out.data_ptr(), n, q.shape[0], stream)
    build.check("dequantize_int8", err)
    build.count_launch("dequantize_int8")
    return out
