"""Plain PyTorch versions of the hand-written kernels.

Each computes what its kernel computes, in the kernel's layout, with
ordinary tensor operations; the CPU tests hold them to the JAX package's
oracles and Pallas kernels, and ``chip_smoke.py`` holds each kernel to its
plain version on the card.  They repeat the arithmetic and are no yardstick
of speed.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

#: 2**32 / golden ratio: the digest's multiplicative-hash constant
GOLDEN = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd).
    Query i and key j sit at positions i and j."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * hd ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, Hkv, S, hd); k_pos (B, S); q_pos (B,)."""
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * hd ** -0.5
    qp = q_pos[:, None]
    keep = (k_pos >= 0) & (k_pos <= qp)
    if window > 0:
        keep &= k_pos > qp - window
    keep = keep[:, None, None, :]
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p, 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def digest_ref(panels: torch.Tensor) -> torch.Tensor:
    """uint32 panels (nb, block) -> one uint32 lattice digest per row,
    ``sum_j x_j * (2j+1) * GOLDEN mod 2^32``.

    PyTorch's uint32 arithmetic is thin, so the words widen to int64 and
    every product is formed exactly: with x = hi * 2^16 + lo,
    x * w = lo * w + ((hi * w) mod 2^16) * 2^16 (mod 2^32), each term
    below 2^49, the row sum below 2^57."""
    nb, block = panels.shape
    x = panels.view(torch.int32).to(torch.int64) & _MASK32
    j = torch.arange(block, dtype=torch.int64, device=panels.device)
    w = ((2 * j + 1) * GOLDEN) & _MASK32
    lo = x & 0xFFFF
    hi = x >> 16
    prod = (lo * w + (((hi * w) & 0xFFFF) << 16)) & _MASK32
    d = prod.sum(dim=1) & _MASK32
    # back to 32 bits through int32, whose conversions every device has
    d = d - ((d >> 31) << 32)
    return d.to(torch.int32).view(torch.uint32)
