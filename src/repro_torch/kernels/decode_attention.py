"""Decode attention (flash-decode): the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.decode_attention.
decode_attention_bhd`: one query token per sequence against a KV cache,
all G query heads of a KV head together.  Slot s is kept iff
``k_pos[b, s] >= 0 and k_pos[b, s] <= q_pos[b]`` (and within ``window``
when it is > 0), so full, partly filled and ring caches share one kernel.
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor,
and only there, it computes :func:`repro_torch.kernels.ref.
decode_attention_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for: those of the ported configs
_HEAD_DIMS = (64,)
#: shared memory one CTA may use on Hopper
_MAX_SMEM = 232448


def decode_attention_bhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                         window: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, Hkv, S, hd); k_pos: (B, S) int32;
    q_pos: (B,) int32 -> (B, Hq, hd).  ``out``, if given, is a (B, Hq, hd)
    tensor or view that receives the result."""
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if tuple(k_pos.shape) != (B, S) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"k_pos {tuple(k_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} do not fit B={B}, S={S}")
    if out is None:
        out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    if not q.is_cuda:
        out.copy_(ref.decode_attention_ref(q, k, v, k_pos, q_pos,
                                           window=window))
        return out
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes {list(_DTYPES)}, got {q.dtype}")
    for t in (k, v, out):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v and out must share one device and dtype")
    for t in (q, k, v, out):
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous")
    for t in (k_pos, q_pos):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError("k_pos and q_pos must be int32 on q's device")
    if k_pos.stride(1) != 1 or not q_pos.is_contiguous():
        raise ValueError("k_pos slots and q_pos must be contiguous")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    lib = build.library("decode_attention")
    smem = lib.decode_attention_smem_bytes(Hq // Hkv, hd)
    if smem > _MAX_SMEM:
        raise ValueError(f"group of {Hq // Hkv} heads x hd {hd} needs "
                         f"{smem} B of shared memory, over {_MAX_SMEM}")
    strides = build.strides_arg((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                                (k_pos, (0,)), (out, (0, 1)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, Hq, Hkv,
            S, hd, ctypes.cast(strides, ctypes.c_void_p),
            float(hd ** -0.5), int(window), stream)
    build.check("decode_attention", err)
    build.count_launch("decode_attention")
    return out
