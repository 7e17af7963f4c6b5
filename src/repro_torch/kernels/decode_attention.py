"""Decode attention (flash-decode): the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.decode_attention.
decode_attention_bhd`: one query token per sequence against a KV cache,
all G query heads of a KV head together.  Slot s is kept iff
``k_pos[b, s] >= 0 and k_pos[b, s] <= q_pos[b]`` (and within ``window``
when it is > 0), so full, partly filled and ring caches share one kernel.
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor,
and only there, it computes :func:`repro_torch.kernels.ref.
decode_attention_ref`.

The kernel is split-K (flash-decoding): the cache is cut into ranges of
``chunk`` slots, one CTA per (range, KV head, block of up to 4 query heads,
sequence), and a second kernel merges the ranges' partial softmax states.
:func:`split_plan` picks ``chunk``; :func:`repro_torch.kernels.ref.
decode_attention_split_ref` is the same two steps in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is built for: those of the ported configs (smollm,
#: zamba2, seamless: 64; phi3-mini: 96; qwen3-moe, llava, mixtral,
#: mistral-large: 128; gemma3: 256)
_HEAD_DIMS = (64, 96, 128, 256)
#: head dims in f32: an f32 row of 256 is 64 lanes of 16 bytes, more than
#: the one warp a slot row may span
_F32_HEAD_DIMS = (64,)
#: slots per range are a multiple of this (4 warps x 8 slots a step)
CHUNK_ALIGN = 32
#: query heads one CTA takes at most (csrc GB)
HEADS_PER_CTA = 4
#: CTAs the plan aims for: two waves of the H100's 132 SMs
TARGET_CTAS = 264


def split_plan(S: int, B: int, Hq: int, Hkv: int) -> tuple[int, int]:
    """(chunk, n_split) for a cache of ``S`` slots, where each range runs
    one CTA per sequence, KV head and block of :data:`HEADS_PER_CTA` query
    heads: the smallest multiple of 32 slots that needs no more ranges than
    reach :data:`TARGET_CTAS` CTAs in all.  Every range holds at least one
    slot, and the ranges cover 0..S-1 once."""
    ctas_per_split = B * Hkv * -(-(Hq // Hkv) // HEADS_PER_CTA)
    want = -(-TARGET_CTAS // ctas_per_split)
    chunk = -(-S // want)
    chunk = max(CHUNK_ALIGN, -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN)
    return chunk, -(-S // chunk)


def decode_attention_bhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                         window: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, Hkv, S, hd); k_pos: (B, S) int32;
    q_pos: (B,) int32 -> (B, Hq, hd).  On the card, q, k and v rows must
    start on 16 bytes (16-byte vector loads).  ``out``, if given, is a
    (B, Hq, hd) tensor or view that receives the result."""
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
    build.refuse_grad("decode_attention", q, k, v)
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
    dims = _HEAD_DIMS if q.dtype == torch.bfloat16 else _F32_HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"head dim {hd} not in {dims} for {q.dtype}")
    if not (build.aligned16(q, (0, 1)) and build.aligned16(k, (0, 1, 2))
            and build.aligned16(v, (0, 1, 2))):
        raise ValueError("q, k and v rows must start on 16 bytes "
                         "(16-byte vector loads)")
    lib = build.library("decode_attention")
    chunk, n_split = split_plan(S, B, Hq, Hkv)
    ws = (torch.empty(n_split * B * Hq * (hd + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    strides = build.strides_arg((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                                (k_pos, (0,)), (out, (0, 1)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), _DTYPES[q.dtype], B, Hq,
            Hkv, S, hd, ctypes.cast(strides, ctypes.c_void_p),
            float(hd ** -0.5), int(window), chunk, stream)
    build.check("decode_attention", err)
    build.count_launch("decode_attention")
    return out
