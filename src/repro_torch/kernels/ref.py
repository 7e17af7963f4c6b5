"""Plain PyTorch versions of the hand-written kernels.

Each computes what its kernel computes, in the kernel's layout, with
ordinary tensor operations; the CPU tests hold them to the JAX package's
oracles and Pallas kernels, and ``chip_smoke.py`` holds each kernel to its
plain version on the card.  They repeat the arithmetic and are no yardstick
of speed.  The quantize pair and the SSD scan wrap the port's own oracles
(:mod:`repro_torch.optim.compression`, :func:`repro_torch.models.ssm.
ssd_chunked`) in the kernels' layouts, as the JAX package's ``ref`` does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

#: 2**32 / golden ratio: the digest's multiplicative-hash constant
GOLDEN = 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) -> (B, Hq, Sq, hd).
    Query i and key j sit at positions ``q_offset + i`` and j."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * hd ** -0.5
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
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


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_pos: torch.Tensor,
                               q_pos: torch.Tensor, *, chunk: int,
                               window: int = 0) -> torch.Tensor:
    """:func:`decode_attention_ref` computed as the split-K kernel does:
    a partial (m, l, acc) per range of ``chunk`` slots, then the combine.
    Same arguments; returns (B, Hq, hd) in q's dtype."""
    return decode_combine_ref(*decode_partials_ref(
        q, k, v, k_pos, q_pos, chunk=chunk, window=window)).to(q.dtype)


def decode_partials_ref(q, k, v, k_pos, q_pos, *, chunk: int,
                        window: int = 0):
    """Per range r of slots [r chunk, (r+1) chunk): the max kept score m
    (-inf where nothing is kept), l = sum exp(s - m) and acc = sum
    exp(s - m) v over the kept slots, in f32.  Returns m, l (n_split, B, Hq)
    and acc (n_split, B, Hq, hd)."""
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    qp = q_pos[:, None]
    keep = (k_pos >= 0) & (k_pos <= qp)
    if window > 0:
        keep &= k_pos > qp - window
    ms, ls, accs = [], [], []
    for s0 in range(0, S, chunk):
        kr, vr = k[:, :, s0:s0 + chunk].float(), v[:, :, s0:s0 + chunk].float()
        kk = keep[:, None, None, s0:s0 + chunk]
        s = torch.einsum("bhgd,bhkd->bhgk", qg, kr) * hd ** -0.5
        s = torch.where(kk, s, -torch.inf)
        m = s.amax(dim=-1)
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m.reshape(B, Hq))
        ls.append(p.sum(dim=-1).reshape(B, Hq))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, vr).reshape(B, Hq, hd))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def decode_combine_ref(m: torch.Tensor, l: torch.Tensor,
                       acc: torch.Tensor) -> torch.Tensor:
    """Merge the ranges' partials: sum e^(m - M) acc / sum e^(m - M) l with
    M the largest m; a range with nothing kept weighs 0, and a row with
    nothing kept anywhere is 0.  Returns f32 (B, Hq, hd)."""
    M = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isinf(M), 0.0, M))
    L = (w * l).sum(dim=0)
    A = (w[..., None] * acc).sum(dim=0)
    return A / torch.where(L > 0, L, 1.0)[..., None]


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


def digest_items_ref(items, *, device=None) -> torch.Tensor:
    """Items -> one 64-bit lattice fingerprint each, uint64 ``(k,)``.

    An item is a sequence of parts (flat uint8 tensors, or host bytes)
    whose bytes in order are the item.  Its ``n`` bytes, zero-padded to
    ``blocks = max(1, ceil(n / 1024))`` rows of 256 words, give row digests
    d (:func:`digest_ref`) and the fingerprint ``hi << 32 | lo`` with
    ``hi = XOR(d) ^ mix``, ``lo = (sum d + mix) mod 2^32``,
    ``mix = n * GOLDEN mod 2^32``.  Host bytes go to ``device`` (default:
    the tensors' device)."""
    fps = []
    for parts in items:
        dev = device if device is not None else next(
            (p.device for p in parts if isinstance(p, torch.Tensor)), "cpu")
        flat = [p if isinstance(p, torch.Tensor) else torch.frombuffer(
            bytearray(p), dtype=torch.uint8).to(dev) for p in parts if len(p)]
        n = sum(p.numel() for p in flat)
        rows = max(1, -(-n // 1024))
        flat.append(torch.zeros(rows * 1024 - n, dtype=torch.uint8,
                                device=dev))
        panels = torch.cat(flat).view(torch.int32).view(torch.uint32)
        d = digest_ref(panels.reshape(rows, 256)).view(torch.int32)
        d = d.to(torch.int64) & _MASK32
        # XOR of the rows, bit by bit: the parity of each bit's count
        bit = torch.arange(32, dtype=torch.int64, device=dev)
        x = ((((d[:, None] >> bit) & 1).sum(dim=0) & 1) << bit).sum()
        mix = (n * GOLDEN) & _MASK32
        hi = x ^ mix
        lo = (d.sum() + mix) & _MASK32
        # hi << 32 | lo as the int64 of the same 64 bits
        fps.append((hi - ((hi >> 31) << 32)) * (1 << 32) | lo)
    if not fps:
        return torch.empty((0,), dtype=torch.uint64, device=device or "cpu")
    return torch.stack(fps).view(torch.uint64)


def quantize_int8_ref(x: torch.Tensor, *, block: int = 256,
                      tile: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 (nb, block), scales f32 (nb,)) with the
    flat f32 values zero-padded to a multiple of ``block * tile``, as the
    kernel returns them: the oracle's blocks, then all-zero padding
    blocks (q 0, scale 0)."""
    from ..optim.compression import quantize_int8_blockwise
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % (block * tile)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return quantize_int8_blockwise(flat, block)


def dequantize_int8_ref(q: torch.Tensor, s: torch.Tensor,
                        shape: tuple[int, ...]) -> torch.Tensor:
    """q int8 (nb, block) and scales f32 (nb,) -> f32 of ``shape``."""
    from ..optim.compression import dequantize_int8_blockwise
    return dequantize_int8_blockwise(q, s, shape)


def quantize_items_ref(items, *, block: int = 256, tile: int = 8
                       ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """A slab of items -> :func:`quantize_int8_ref` of each."""
    return [quantize_int8_ref(x, block=block, tile=tile) for x in items]


def dequantize_items_ref(items) -> list[torch.Tensor]:
    """A slab of ``(q, scales, shape)`` -> :func:`dequantize_int8_ref` of
    each."""
    return [dequantize_int8_ref(q, s, shape) for q, s, shape in items]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-layout wrapper over :func:`repro_torch.models.ssm.
    ssd_chunked`.  x: (B, H, S, P); dt: (B, H, S) f32; A: (H,) f32;
    Bm/Cm: (B, G, S, N) -> (y (B, H, S, P) in x's dtype, final state
    (B, H, P, N) f32)."""
    from ..models.ssm import ssd_chunked
    y, state = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2).float(),
                           A.float(), Bm.transpose(1, 2), Cm.transpose(1, 2),
                           chunk)
    return y.transpose(1, 2), state


def bf16_parts(v: torch.Tensor, parts: int = 2) -> list[torch.Tensor]:
    """f32 ``v`` as ``parts`` bf16 values (held in f32) whose sum is ``v``
    to about 2^-9 (one part) or 2^-17 (two) relative: hi = bf16(v), then
    lo = bf16(v - hi)."""
    out, rest = [], v.float()
    for _ in range(parts):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def ssd_scan_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                       parts: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_ref` computed as the tensor-core kernel computes it:
    chunk by chunk with the state carried in f32, every product over bf16
    factors with f32 sums, and each f32 factor (W in W.x, the state in
    C.state, wdt x in the state update) cut into ``parts`` bf16 parts at
    the same places as the kernel (two there; one shows what a single
    rounding costs).  Same arguments and results as :func:`ssd_scan_ref`."""
    B, H, S, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    rep = H // G
    xf = x.float()
    Bf = Bm.float().repeat_interleave(rep, dim=1)          # (B, H, S, N)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    a = A.float()[None, :, None]
    keep = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        d = dt[:, :, sl].float()                           # (B, H, Q)
        cum = torch.cumsum(d * a, dim=-1)
        total = cum[..., -1:]
        xc, Bc, Cc = xf[:, :, sl], Bf[:, :, sl], Cf[:, :, sl]
        # exp(cum_i) C_i . state_in, then the intra-chunk W . x
        y = sum(Cc @ s.transpose(-1, -2) for s in bf16_parts(state, parts))
        y = torch.exp(cum)[..., None] * y
        li = cum[..., :, None] - cum[..., None, :]
        L = torch.where(keep, torch.exp(li), 0.0) * d[..., None, :]
        W = L * (Cc @ Bc.transpose(-1, -2))
        y = y + sum(w @ xc for w in bf16_parts(W, parts))
        ys.append(y)
        # state = exp(total) state + (wdt x)^T B
        xw = xc * (torch.exp(total - cum) * d)[..., None]
        state = torch.exp(total)[..., None] * state + sum(
            u.transpose(-1, -2) @ Bc for u in bf16_parts(xw, parts))
    return torch.cat(ys, dim=2).to(x.dtype), state
