"""Flash attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.flash_attention.
flash_attention_bhsd`: blocked online-softmax GQA attention with causal and
sliding-window masks (query i and key j at positions i and j).  On a CUDA
tensor the wrapper launches the hand-written kernel or raises; on a CPU
tensor, and only there, it computes the plain version
:func:`repro_torch.kernels.ref.attention_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for: those of the ported configs
_HEAD_DIMS = (64,)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd).

    Inputs may be strided views (the head dim contiguous), e.g. the
    model's (B, S, H, hd) tensors transposed; on the card, bf16 rows must
    start on 16 bytes (the kernel reads them as TMA tiles).  ``out``, if
    given, is a (B, Hq, Sq, hd) tensor or view that receives the result."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    if out is None:
        out = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    if not q.is_cuda:
        out.copy_(ref.attention_ref(q, k, v, causal=causal, window=window))
        return out
    build.refuse_grad("flash_attention", q, k, v)
    _check_cuda(q, k, v, out)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and not all(
            build.aligned16(t, (0, 1, 2)) for t in (q, k, v, out)):
        raise ValueError("bf16 q, k, v and out rows must start on 16 bytes "
                         "(TMA tiles)")
    lib = build.library("flash_attention")
    strides = build.strides_arg((q, (0, 1, 2)), (k, (0, 1, 2)),
                                (v, (0, 1, 2)), (out, (0, 1, 2)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, hd, ctypes.cast(
                strides, ctypes.c_void_p), float(hd ** -0.5), int(causal),
            int(window), stream)
    build.check("flash_attention", err)
    build.count_launch("flash_attention")
    return out


def _check_cuda(*ts: torch.Tensor) -> None:
    dev, dtype = ts[0].device, ts[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes {list(_DTYPES)}, got {dtype}")
    for t in ts:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("q, k, v and out must share one device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous")
