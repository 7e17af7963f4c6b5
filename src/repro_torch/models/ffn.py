"""Feed-forward blocks: the SwiGLU MLP of the dense decoders."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (x W_g) SiLU * (x W_u) -> W_d; the SiLU in f32."""
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down
