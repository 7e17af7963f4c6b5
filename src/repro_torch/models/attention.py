"""Attention: GQA with causal / sliding-window masking, and the KV caches.

Positions are explicit everywhere: a KV slot with position < 0 is invalid
(empty ring-buffer slot).  Window masking is relative: key valid iff
``q_pos - window < k_pos <= q_pos`` (window == 0 means unbounded), which
makes ring-buffer caches correct without any index shuffling.  A window
is a Python int per layer (``ModelConfig.layer_windows``).

``impl="cuda"`` routes prefill through the flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`) at any sequence length;
``"ref"`` is the plain path, the same arithmetic as the JAX package's
``impl="ref"``.  KV caches are updated in place (the JAX package returns new
arrays): a cache is as large as the model's activations, and a copy per
step would double the memory a decode step touches.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# score tensors above this many elements trigger query-chunked evaluation
# (bounds the live (Sq x Sk) softmax workspace of the plain path; the flash
# kernel tiles in shared memory instead)
ATTN_CHUNK_ELEMS = 1 << 22


def _build_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: int = 0) -> torch.Tensor:
    """Boolean keep-mask broadcastable to (..., Sq, Sk)."""
    qp = q_pos[..., :, None].to(torch.int32)
    kp = k_pos[..., None, :].to(torch.int32)
    keep = kp >= 0
    if causal:
        keep = keep & (kp <= qp)
    if window > 0:
        keep = keep & (kp > qp - window)
    return keep


def _attn_core(q, k, v, *, q_pos, k_pos, causal, window) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scale = hd ** -0.5
    # bf16 operands, f32 accumulation (the products of two bf16 values are
    # exact in f32, as in the reference's preferred_element_type=f32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = _build_mask(q_pos, k_pos, causal=causal, window=window)
    while mask.ndim < scores.ndim:
        mask = mask[..., None, :, :] if mask.ndim >= 2 else mask
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd)
    *,
    q_pos: torch.Tensor,        # (Sq,) or (B, Sq)
    k_pos: torch.Tensor,        # (Sk,) or (B, Sk)
    causal: bool = True,
    window: int = 0,
    impl: str = "ref",
) -> torch.Tensor:
    """Grouped-query attention; returns (B, Sq, Hq, hd).

    ``impl="cuda"`` takes the flash kernel, whose positions are 0..S-1:
    the caller passes q_pos == k_pos == arange(S) (prefill / train).  The
    plain path evaluates queries in chunks when the score workspace would
    exceed ``ATTN_CHUNK_ELEMS``."""
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        if q.shape[1] != k.shape[1]:
            raise ValueError("the flash route takes Sq == Sk (prefill); "
                             "decode goes through decode_attention")
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if impl != "ref":
        raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")
    B, Sq, Hq, hd = q.shape
    Sk = k.shape[1]
    if Sq * Sk <= ATTN_CHUNK_ELEMS or q_pos.ndim != 1:
        return _attn_core(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                          window=window)
    # query-chunked evaluation: bounds the live score workspace
    q_chunk = max(128, ATTN_CHUNK_ELEMS // Sk)
    while Sq % q_chunk:
        q_chunk //= 2
    outs = [_attn_core(q[:, i:i + q_chunk], k, v,
                       q_pos=q_pos[i:i + q_chunk], k_pos=k_pos,
                       causal=causal, window=window)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV caches (updated in place)
# ---------------------------------------------------------------------------


def cache_update_full(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Write step-``pos`` K/V into a full-length cache (B, S_max, Hkv, hd)."""
    n = k_new.shape[1]
    k_cache[:, pos:pos + n] = k_new.to(k_cache.dtype)
    v_cache[:, pos:pos + n] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_positions_full(s_max: int, pos: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """Absolute positions of full-cache slots; > pos slots invalid (-1)."""
    idx = torch.arange(s_max, dtype=torch.int32, device=device)
    return torch.where(idx <= pos, idx, -1)


def cache_update_ring(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one step into a ring cache of length ``window`` at slot
    pos % window."""
    slot = pos % window
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_positions_ring(window: int, pos: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """Absolute position held by each ring slot after writing step ``pos``.

    Slot j holds the largest p <= pos with p === j (mod window); slots that
    would be negative are invalid (-1)."""
    j = torch.arange(window, dtype=torch.int32, device=device)
    p = pos - torch.remainder(pos - j, window)
    return torch.where(p >= 0, p, -1)
