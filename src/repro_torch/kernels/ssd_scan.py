"""Chunked Mamba2 SSD scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.ssd_scan.ssd_scan_bhsd`
(intra-chunk masked quadratic form plus the (P, N) state carried across
chunks, B/C groups broadcast to heads).  Unlike the TPU kernel it also
returns the final state, which the port's prefill stores in the decode
cache.  On a CUDA tensor the wrapper launches the kernel or raises; on a
CPU tensor, and only there, it computes the plain version
:func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

#: (head dim P, state dim N) the kernel is built for: mamba2-1.3b's
SHAPES = ((64, 128),)
#: largest chunk the kernel takes; chunks are whole multiples of 32 rows
MAX_CHUNK = 256
ROW_TILE = 32
#: shared memory one CTA may use on Hopper
_MAX_SMEM = 232448


def ssd_scan_bhsd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                  out: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, S, P); dt: (B, H, S) f32; A: (H,) f32; Bm/Cm: (B, G, S, N)
    -> (y (B, H, S, P) in x's dtype, final state (B, H, P, N) f32).

    Inputs may be strided views with the last dim contiguous (the model's
    (B, S, H, P) tensors transposed).  ``out``, if given, is a
    (B, H, S, P) tensor or view that receives y."""
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if tuple(dt.shape) != (B, H, S) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if tuple(Bm.shape) != (B, G, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"B/C shapes {tuple(Bm.shape)}, {tuple(Cm.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} B/C groups")
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {chunk}")
    if out is None:
        out = torch.empty((B, H, S, P), dtype=x.dtype, device=x.device)
    if not x.is_cuda:
        y, state = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
        out.copy_(y)
        return out, state
    build.refuse_grad("ssd_scan", x, dt, A, Bm, Cm)
    if (P, N) not in SHAPES:
        raise ValueError(f"SSD head dim / state dim ({P}, {N}) not in "
                         f"{SHAPES}")
    if chunk > MAX_CHUNK or chunk % ROW_TILE:
        raise ValueError(f"SSD chunk {chunk} must be a multiple of "
                         f"{ROW_TILE} up to {MAX_CHUNK}")
    for t in (x, Bm, Cm, out):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the SSD kernel takes bf16 x/B/C/y, got "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("the last dim of x, B, C and y must be "
                             "contiguous")
    for t in (x, Bm, Cm):
        if not build.aligned16(t, (0, 1, 2)):
            raise ValueError("the SSD kernel loads x, B and C as TMA tiles: "
                             "their rows must start on 16 bytes")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be f32")
    for t in (dt, A, Bm, Cm, out):
        if t.device != x.device:
            raise ValueError("all SSD operands must lie on one device")
    A = A.contiguous()
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = build.library("ssd_scan")
    smem = lib.ssd_scan_smem_bytes()
    if smem > _MAX_SMEM:
        raise ValueError(f"the SSD kernel needs {smem} B of shared memory, "
                         f"over {_MAX_SMEM}")
    strides = build.strides_arg((x, (0, 1, 2)), (dt, (0, 1, 2)),
                                (Bm, (0, 1, 2)), (Cm, (0, 1, 2)),
                                (out, (0, 1, 2)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), out.data_ptr(), state.data_ptr(), B, H, G, S,
            chunk, P, N, ctypes.cast(strides, ctypes.c_void_p), stream)
    build.check("ssd_scan", err)
    build.count_launch("ssd_scan")
    return out, state
