"""Model-layout wrappers for the hand-written kernels.

Model code calls these through ``ShardCtx.impl == "cuda"``.  They take the
model's (B, S, H, hd) layout and hand the kernels transposed views, so no
copy is made; each kernel wrapper dispatches on the tensor's device (the
kernel on a CUDA tensor, its plain version on a CPU tensor).
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention_bhd
from .digest import block_digest
from .flash_attention import flash_attention_bhsd

__all__ = ["flash_attention", "decode_attention", "block_digest"]


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
