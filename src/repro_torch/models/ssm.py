"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

The SSD layer computes, per head h with scalar decay ``a_t = exp(dt_t A)``:

    state_t = a_t * state_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t     = C_t . state_t + D * x_t

Prefill uses the chunked SSD algorithm: the sequence splits into chunks
of length Q; within a chunk the dual quadratic (attention-like) form is
used, and one inter-chunk recurrence over ``S/Q`` steps carries the state.
:func:`ssd_chunked` is the plain PyTorch version (the JAX package's
oracle, ported); ``impl="cuda"`` runs the hand-written SSD kernel
(:mod:`repro_torch.kernels.ssd_scan`), which also returns the final state,
so the prefill that fills the decode cache runs the kernel.  The JAX
package's ``_try_pallas_ssd`` fallback is not copied: the kernel route
launches the kernel or raises.

Decode is O(1) in sequence length: one multiply-accumulate against the
(H, P, N) state, plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig


class MambaState(NamedTuple):
    conv: torch.Tensor      # (B, conv_width-1, conv_dim) rolling conv input (bf16)
    ssm: torch.Tensor       # (B, H, P, N) recurrent state (f32)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in = cfg.d_inner
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, cfg.ssm_heads], dim=-1)


def _xbc(cfg: ModelConfig, zxbcdt: torch.Tensor) -> torch.Tensor:
    """The conv input (x, B, C): one contiguous run of the projection's
    columns, so no concatenation is needed."""
    d_in = cfg.d_inner
    return zxbcdt[..., d_in:d_in + cfg.conv_dim]


def _dt_activation(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.float() + dt_bias.float())


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(y * silu(z)) * w."""
    y32 = y.float() * F.silu(z.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


# ---------------------------------------------------------------------------
# Chunked SSD (prefill)
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H) — post-softplus, f32
    A: torch.Tensor,       # (H,) negative, f32
    Bm: torch.Tensor,      # (B, S, G, N)
    Cm: torch.Tensor,      # (B, S, G, N)
    chunk: int,
    *,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,P,N) f32)."""
    B_, S, H, Pd = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = S // chunk
    rep = H // G

    xc = x.reshape(B_, nc, chunk, H, Pd).float()
    dtc = dt.reshape(B_, nc, chunk, H)
    Bc = Bm.reshape(B_, nc, chunk, G, N).float()
    Cc = Cm.reshape(B_, nc, chunk, G, N).float()

    dA = dtc * A[None, None, None, :]                     # (B,nc,Q,H) negatives
    cum = torch.cumsum(dA, dim=2)                         # inclusive cumsum
    total = cum[:, :, -1, :]                              # (B,nc,H)

    # intra-chunk (dual quadratic form): L[i,j] = exp(cum_i - cum_j) * dt_j,
    # j<=i; the exponent above the diagonal is -inf before exp, so exp
    # never overflows there and its gradient stays finite (selecting after
    # exp gives the same values, but 0 * inf = NaN in the backward pass)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], li,
                              float("-inf")))
    L = L * dtc[:, :, None, :, :]                         # x dt_j
    CB = torch.einsum("bnigx,bnjgx->bnijg", Cc, Bc)       # (B,nc,Q,Q,G)
    CB = CB.repeat_interleave(rep, dim=-1)                # (B,nc,Q,Q,H)
    W = CB * L
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", W, xc)

    # chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    wdt = decay_to_end * dtc
    Bh = Bc.repeat_interleave(rep, dim=-2)                # (B,nc,Q,H,N)
    Sc = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", wdt, Bh, xc)

    # inter-chunk recurrence over nc, emitting the state entering each chunk
    chunk_decay = torch.exp(total)                        # (B,nc,H)
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B_, H, Pd, N), dtype=torch.float32,
                              device=x.device))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + Sc[:, c]
    entering = torch.stack(entering, dim=1)               # (B,nc,H,P,N)

    # inter-chunk contribution: y_i += C_i exp(cum_i) . state_entering
    Ch = Cc.repeat_interleave(rep, dim=-2)                # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, entering,
                           torch.exp(cum))

    y = (y_intra + y_inter).reshape(B_, S, H, Pd)
    return y.to(x.dtype), state


def ssd_decode_step(
    x: torch.Tensor,       # (B, H, P)
    dt: torch.Tensor,      # (B, H) f32 (post-softplus)
    A: torch.Tensor,       # (H,)
    Bm: torch.Tensor,      # (B, G, N)
    Cm: torch.Tensor,      # (B, G, N)
    state: torch.Tensor,   # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update (O(1) in sequence length)."""
    rep = x.shape[1] // Bm.shape[1]
    dec = torch.exp(dt * A[None, :])                      # (B,H)
    Bh = Bm.repeat_interleave(rep, dim=1).float()         # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    upd = dt[:, :, None, None] * (x.float()[:, :, :, None]
                                  * Bh[:, :, None, :])
    new_state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections + conv + SSD + gate)
# ---------------------------------------------------------------------------


def _conv(windows: torch.Tensor, p) -> torch.Tensor:
    """Depthwise causal conv over the last conv_width steps, in f32.
    ``windows``: (..., W, C) -> silu(sum_w windows * conv_w + conv_b)."""
    acc = (windows.float() * p.conv_w.float()).sum(dim=-2)
    return F.silu(acc + p.conv_b.float())


def mamba_block_train(x: torch.Tensor, p, cfg: ModelConfig, *,
                      impl: str = "ref", return_state: bool = False):
    """(B, S, D) -> (B, S, D)  [or (y, MambaState) with return_state].
    ``impl="cuda"`` runs the SSD scan through the hand-written kernel
    (its plain version when the tensors lie on the CPU)."""
    s = cfg.ssm
    Bsz, S, D = x.shape
    H, Pd, N, G, W = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups, \
        s.conv_width
    zxbcdt = x @ p.in_proj
    z, _, _, _, dt = _split_proj(cfg, zxbcdt)

    # causal depthwise conv over (x, B, C)
    xbc_raw = _xbc(cfg, zxbcdt)                               # (B,S,conv_dim)
    pad = F.pad(xbc_raw, (0, 0, W - 1, 0))
    windows = torch.stack([pad[:, i:i + S] for i in range(W)], dim=2)
    xbc = _conv(windows, p).to(x.dtype)
    xin, Bm, Cm = torch.split(xbc, [cfg.d_inner, G * N, G * N], dim=-1)

    xh = xin.reshape(Bsz, S, H, Pd)
    Bg = Bm.reshape(Bsz, S, G, N)
    Cg = Cm.reshape(Bsz, S, G, N)
    dtf = _dt_activation(dt, p.dt_bias)                        # (B,S,H) f32
    A = -torch.exp(p.A_log.float())

    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        y, final_state = kops.ssd_scan(xh, dtf, A, Bg, Cg, chunk=s.chunk)
    else:
        y, final_state = ssd_chunked(xh, dtf, A, Bg, Cg, s.chunk)
    y = y + xh * p.D.to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = _gated_norm(y, z, p.norm_w, cfg.norm_eps)
    out = y @ p.out_proj
    if return_state:
        conv_state = xbc_raw[:, S - (W - 1):, :].to(torch.bfloat16)
        return out, MambaState(conv=conv_state, ssm=final_state)
    return out


def mamba_block_decode(x: torch.Tensor, p, cfg: ModelConfig,
                       state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """(B, 1, D) one-token step with rolling conv + SSM state."""
    s = cfg.ssm
    Bsz = x.shape[0]
    H, Pd, N, G = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    zxbcdt = (x @ p.in_proj)[:, 0]
    z, _, _, _, dt = _split_proj(cfg, zxbcdt)

    xbc_new = _xbc(cfg, zxbcdt)                               # (B, conv_dim)
    conv_in = torch.cat([state.conv, xbc_new[:, None, :]], dim=1)
    xbc = _conv(conv_in, p).to(x.dtype)
    new_conv = conv_in[:, 1:, :]

    xin, Bm, Cm = torch.split(xbc, [cfg.d_inner, G * N, G * N], dim=-1)
    xh = xin.reshape(Bsz, H, Pd)
    Bg = Bm.reshape(Bsz, G, N)
    Cg = Cm.reshape(Bsz, G, N)
    dtf = _dt_activation(dt, p.dt_bias)                        # (B,H)
    A = -torch.exp(p.A_log.float())
    y, new_ssm = ssd_decode_step(xh, dtf, A, Bg, Cg, state.ssm)
    y = y + xh * p.D.to(x.dtype)[None, :, None]
    y = y.reshape(Bsz, cfg.d_inner)
    y = _gated_norm(y, z, p.norm_w, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None, :]
    return out, MambaState(conv=new_conv, ssm=new_ssm)


def init_mamba_state(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str) -> MambaState:
    s = cfg.ssm
    return MambaState(
        conv=torch.zeros((batch, s.conv_width - 1, cfg.conv_dim),
                         dtype=torch.bfloat16, device=device),
        ssm=torch.zeros((batch, cfg.ssm_heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
    )
