"""Model-layout wrappers for the hand-written kernels.

Model code calls these through ``ShardCtx.impl == "cuda"``.  They take the
model's (B, S, H, hd) layout and hand the kernels transposed views, so no
copy is made; each kernel wrapper dispatches on the tensor's device (the
kernel on a CUDA tensor, its plain version on a CPU tensor).  The kernels
have no backward pass: on the card, the attention and SSD wrappers raise
when autograd is on and an input requires gradients, rather than return an
output that carries none (training runs the plain path, ``impl="ref"``).
The wire transforms (:mod:`repro_torch.core.integrity`) call ``quantize``
and ``dequantize``.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_bhd
from .digest import block_digest
from .flash_attention import flash_attention_bhsd
from .quantize import dequantize_int8, quantize_int8
from .ssd_scan import ssd_scan_bhsd

__all__ = ["flash_attention", "decode_attention", "block_digest", "ssd_scan",
           "quantize", "dequantize"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, H, hd) layout in and out; query and key positions are
    0..Sq-1 and 0..Sk-1 (the prefill / train regime)."""
    B, Sq, Hq, hd = q.shape
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=int(window),
                         out=out.transpose(1, 2))
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, 1, Hq, hd); k/v: (B, S, Hkv, hd) caches; k_pos (S,) or
    (B, S); q_pos (1,) or (B,) -> (B, 1, Hq, hd)."""
    B, _, Hq, hd = q.shape
    S = k.shape[1]
    k_pos = k_pos.to(torch.int32).expand(B, S)
    q_pos = q_pos.to(torch.int32).reshape(-1).expand(B).contiguous()
    out = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=q.device)
    decode_attention_bhd(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                         k_pos, q_pos, window=int(window), out=out[:, 0])
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (B, S, H, P); dt (B, S, H) f32; A (H,) f32; Bm/Cm
    (B, S, G, N) -> (y (B, S, H, P), final state (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    _, state = ssd_scan_bhsd(x.transpose(1, 2), dt.transpose(1, 2),
                             A.float(), Bm.transpose(1, 2),
                             Cm.transpose(1, 2), chunk=chunk,
                             out=y.transpose(1, 2))
    return y, state


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Any shape -> (q int8 (nb, 256), scales f32 (nb,)), flat f32 values
    zero-padded to a multiple of 2048."""
    return quantize_int8(x)


def dequantize(q: torch.Tensor, s: torch.Tensor,
               shape: tuple[int, ...]) -> torch.Tensor:
    """(q, scales) -> f32 of ``shape``."""
    return dequantize_int8(q, s, shape)
