"""Blockwise lattice digest: the wrapper of ``csrc/digest.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.digest.block_digest`,
the compute half of accelerator-placed integrity
(:mod:`repro_torch.core.integrity`): one 32-bit digest per 256-word row,
``sum_j x_j * (2j+1) * 0x9E3779B1 mod 2^32``, bit-exact with the plain
version :func:`repro_torch.kernels.ref.digest_ref`.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor, and only there, it
computes the plain version.
"""

from __future__ import annotations

import torch

from . import build, ref

#: uint32 words per digest row (the kernel's row width)
BLOCK = 256


def block_digest(panels: torch.Tensor) -> torch.Tensor:
    """uint32 panels (nb, 256) -> one uint32 lattice digest per row.
    Any ``nb`` >= 1 is taken; on the card the panels must be contiguous
    and 16-byte aligned."""
    if panels.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"digest panels are 32-bit words, got {panels.dtype}")
    if panels.ndim != 2 or panels.shape[1] != BLOCK or panels.shape[0] < 1:
        raise ValueError(f"digest panels must be (nb, {BLOCK}), got "
                         f"{tuple(panels.shape)}")
    panels = panels.view(torch.uint32)
    if not panels.is_cuda:
        return ref.digest_ref(panels)
    if not panels.is_contiguous() or panels.data_ptr() % 16:
        raise ValueError("digest panels must be contiguous and 16-byte "
                         "aligned on the card")
    nb = panels.shape[0]
    out = torch.empty((nb,), dtype=torch.uint32, device=panels.device)
    lib = build.library("block_digest")
    with torch.cuda.device(panels.device):
        stream = torch.cuda.current_stream(panels.device).cuda_stream
        err = lib.block_digest_u32(panels.data_ptr(), out.data_ptr(), nb,
                                   stream)
    build.check("block_digest", err)
    build.count_launch("block_digest")
    return out
