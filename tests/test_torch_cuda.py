"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is False,
and run on the H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: f32 3e-5 (sums in another order), bf16 atol 1e-3 + rtol 8e-3
(both round an f32 result to bf16 once: about one ulp of the output); the
digest, the int8 codes and scales and the dequantized values are
bit-exact.  The SSD scan: y (bf16) within atol 1e-3 of its scale + rtol
8e-3 (one bf16 ulp over f32 sums and an f32 prefix sum taken in another
order), the final state (f32) within atol 1e-4 of its scale + rtol 1e-3
(the prefix sums' rounding moves exp(cum_i - cum_j) by up to about 1e-4
relative where |cum| reaches about 1e3).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.digest import block_digest, digest_items
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.quantize import (dequantize_int8, dequantize_items,
                                          quantize_int8, quantize_items)
from repro_torch.kernels.ssd_scan import ssd_scan_bhsd

torch.set_num_threads(1)

TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
       torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_inputs(card, dtype, S, fill, ring, seed=7):
    g = torch.Generator(device=card).manual_seed(seed)
    B, Hq, Hkv, hd = 4, 15, 5, 64
    q = torch.randn(B, Hq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    if ring:   # slots in a permuted order: only k_pos may be trusted
        perm = torch.randperm(S, generator=g, device=card)
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    return q, k, v, k_pos, q_pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(128, 0), (1000, 0), (1000, 256)])
def test_flash_kernel_matches_plain_on_card(card, dtype, S, window):
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn(4, 15, S, 64, generator=g, device=card).to(dtype)
    k = torch.randn(4, 5, S, 64, generator=g, device=card).to(dtype)
    v = torch.randn(4, 5, S, 64, generator=g, device=card).to(dtype)
    n = build.KERNELS["flash_attention"].launches
    out = flash_attention_bhsd(q, k, v, window=window)
    assert build.KERNELS["flash_attention"].launches == n + 1
    expect = ref.attention_ref(q, k, v, window=window)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,fill,ring,window", [
    (1024, 700, False, 0), (1024, 700, True, 0), (1024, 700, True, 256),
    (161, 144, False, 0), (100, 3, True, 0)])
def test_decode_kernel_matches_plain_on_card(card, dtype, S, fill, ring,
                                             window):
    q, k, v, k_pos, q_pos = _decode_inputs(card, dtype, S, fill, ring)
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,window", [
    (1, True, 0), (17, True, 0), (64, True, 0), (65, True, 0), (200, True, 0),
    (200, True, 16), (300, True, 100), (200, False, 0), (130, False, 40)])
def test_flash_bf16_kernel_tails_and_windows(card, S, causal, window):
    """Tails shorter than a tile and exactly one tile, a window narrower
    than a tile (16) and one that straddles tiles (100), no causal mask."""
    g = torch.Generator(device=card).manual_seed(1000 + S + window)
    q = torch.randn(2, 6, S, 64, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(2, 2, S, 64, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(2, 2, S, 64, generator=g, device=card).to(torch.bfloat16)
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    expect = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(1024, 512), (1024, 0), (1000, 512),
                                      (65, 16), (1, 0)])
def test_flash_hd256_kernel_matches_plain_on_card(card, S, window):
    """The hd-256 instantiation at gemma3's grouping (4 query heads over
    1 KV head): its local (512) and global (0) layers, a ragged tail."""
    g = torch.Generator(device=card).manual_seed(2560 + S + window)
    q = torch.randn(4, 4, S, 256, generator=g, device=card).to(
        torch.bfloat16)
    k = torch.randn(4, 1, S, 256, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(4, 1, S, 256, generator=g, device=card).to(
        torch.bfloat16)
    n = build.KERNELS["flash_attention"].launches
    out = flash_attention_bhsd(q, k, v, window=window)
    assert build.KERNELS["flash_attention"].launches == n + 1
    expect = ref.attention_ref(q, k, v, window=window)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_hd256_kernel_takes_model_views(card):
    """gemma3's (B, S, H, 256) projections: q rows of 1024 values, k/v
    rows of 256, through ops.flash_attention as transposed views."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(2, 300, 4, 256, generator=g, device=card).to(
        torch.bfloat16)
    k = torch.randn(2, 300, 1, 256, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(2, 300, 1, 256, generator=g, device=card).to(
        torch.bfloat16)
    out = ops.flash_attention(q, k, v, window=100)
    expect = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=100).transpose(1, 2)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernel_at_zamba2s_window(card):
    """hd 64 at zamba2's shared block: 32 heads, S 4608 past the 4096
    window."""
    g = torch.Generator(device=card).manual_seed(4096)
    q, k, v = (torch.randn(1, 32, 4608, 64, generator=g, device=card).to(
        torch.bfloat16) for _ in range(3))
    out = flash_attention_bhsd(q, k, v, window=4096)
    expect = ref.attention_ref(q, k, v, window=4096)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("S,fill,ring,window", [
    (1057, 1040, False, 512), (1057, 1040, False, 0), (1057, 1040, True, 0),
    (1057, 20, False, 512), (100, 3, True, 0)])
def test_decode_hd256_kernel_matches_plain_on_card(card, S, fill, ring,
                                                   window):
    """The hd-256 bf16 instantiation (a slot row is one warp-wide load) at
    gemma3's grouping, full and permuted caches, both window kinds."""
    g = torch.Generator(device=card).manual_seed(S + fill)
    B, Hq, Hkv, hd = 4, 4, 1, 256
    q = torch.randn(B, Hq, hd, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    if ring:
        perm = torch.randperm(S, generator=g, device=card)
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    n = build.KERNELS["decode_attention"].launches
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    assert build.KERNELS["decode_attention"].launches == n + 1
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


#: hd-128 groupings: qwen3-moe (32 query heads over 4 KV heads),
#: llava-next (32 over 8), mixtral (48 over 8: 6) and mistral-large (96
#: over 8: 12)
HD128_HEADS = [(32, 4), (32, 8), (48, 8), (96, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", HD128_HEADS)
@pytest.mark.parametrize("S,window", [(512, 0), (1000, 0), (65, 0),
                                      (1000, 256), (1, 0)])
def test_flash_hd128_kernel_matches_plain_on_card(card, Hq, Hkv, S, window):
    """The hd-128 instantiation (two 64-column boxes a row): causal, a
    ragged tail, a window."""
    g = torch.Generator(device=card).manual_seed(1280 + S + window + Hkv)
    q = torch.randn(4, Hq, S, 128, generator=g, device=card).to(
        torch.bfloat16)
    k = torch.randn(4, Hkv, S, 128, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(4, Hkv, S, 128, generator=g, device=card).to(
        torch.bfloat16)
    n = build.KERNELS["flash_attention"].launches
    out = flash_attention_bhsd(q, k, v, window=window)
    assert build.KERNELS["flash_attention"].launches == n + 1
    expect = ref.attention_ref(q, k, v, window=window)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", HD128_HEADS)
@pytest.mark.parametrize("S,fill,ring,window", [
    (545, 544, False, 0), (545, 528, False, 0), (545, 100, False, 0),
    (545, 528, True, 0), (545, 528, False, 256), (100, 3, True, 0)])
def test_decode_hd128_kernel_matches_plain_on_card(card, Hq, Hkv, S, fill,
                                                   ring, window):
    """The hd-128 bf16 instantiation (a slot row is 16 lanes) against full,
    partly filled and permuted caches of qwen3's 545 slots."""
    g = torch.Generator(device=card).manual_seed(S + fill + Hkv)
    B, hd = 4, 128
    q = torch.randn(B, Hq, hd, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    if ring:
        perm = torch.randperm(S, generator=g, device=card)
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    n = build.KERNELS["decode_attention"].launches
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    assert build.KERNELS["decode_attention"].launches == n + 1
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,window", [
    (128, True, 0), (1024, True, 0), (1024, True, 256), (1024, False, 0),
    (65, True, 0), (1, True, 0)])
def test_flash_hd96_kernel_matches_plain_on_card(card, S, causal, window):
    """The hd-96 instantiation (phi3-mini: 32 query heads over 32 KV
    heads): two 64-column boxes a row, the second part filled, whose
    columns past 95 TMA reads as zeros and the store leaves alone."""
    g = torch.Generator(device=card).manual_seed(960 + S + window)
    q, k, v = (torch.randn(2, 32, S, 96, generator=g, device=card).to(
        torch.bfloat16) for _ in range(3))
    n = build.KERNELS["flash_attention"].launches
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    assert build.KERNELS["flash_attention"].launches == n + 1
    expect = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 1024])
@pytest.mark.parametrize("window", [0, 256])
def test_flash_hd96_kernel_takes_model_views(card, S, window):
    """phi3-mini's (B, S, H, 96) projections through ops.flash_attention
    as transposed views (rows of 192 bytes, 6144 bytes apart), and an
    output view whose columns past 95 belong to the next head: the store
    must leave them alone."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=card).manual_seed(96 + S + window)
    q, k, v = (torch.randn(2, S, 32, 96, generator=g, device=card).to(
        torch.bfloat16) for _ in range(3))
    out = ops.flash_attention(q, k, v, window=window)
    expect = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               window=window).transpose(1, 2)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])
    sentinel = torch.full((2, S, 64, 96), 7.0, dtype=torch.bfloat16,
                          device=card)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window=window,
                         out=sentinel[:, :, ::2].transpose(1, 2))
    torch.testing.assert_close(sentinel[:, :, ::2].float(), expect.float(),
                               **TOL[torch.bfloat16])
    assert bool((sentinel[:, :, 1::2] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S,fill,ring,window", [
    (1057, 1056, False, 0), (1057, 1040, False, 0), (1057, 20, False, 0),
    (1057, 1040, True, 0), (1057, 1040, False, 256), (100, 3, True, 0)])
def test_decode_hd96_kernel_matches_plain_on_card(card, S, fill, ring,
                                                  window):
    """The hd-96 bf16 instantiation (a slot row is 12 lanes, padded to 16
    so the score butterfly stays inside a slot) against phi3-mini's full,
    partly filled and permuted 1057-slot caches."""
    g = torch.Generator(device=card).manual_seed(S + fill + 96)
    B, Hq, Hkv, hd = 4, 32, 32, 96
    q = torch.randn(B, Hq, hd, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    if ring:
        perm = torch.randperm(S, generator=g, device=card)
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    n = build.KERNELS["decode_attention"].launches
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    assert build.KERNELS["decode_attention"].launches == n + 1
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_decode_hd96_kernel_over_a_wrapped_ring_of_model_views(card):
    """ops.decode_attention on (B, S, H, 96) cache views, every slot
    filled as a ring is after step 1500 of a 1024-slot ring."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import cache_positions_ring
    g = torch.Generator(device=card).manual_seed(1500)
    q = torch.randn(2, 1, 32, 96, generator=g, device=card).to(
        torch.bfloat16)
    k, v = (torch.randn(2, 1024, 32, 96, generator=g, device=card).to(
        torch.bfloat16) for _ in range(2))
    k_pos = cache_positions_ring(1024, 1500, card)
    q_pos = torch.full((1,), 1500, dtype=torch.int32, device=card)
    out = ops.decode_attention(q, k, v, k_pos, q_pos, window=1024)
    expect = ref.decode_attention_ref(
        q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
        k_pos.expand(2, 1024), q_pos.expand(2), window=1024)
    torch.testing.assert_close(out[:, 0].float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_noncausal_at_seamless_encoder_shape(card):
    """seamless-m4t's encoder self attention: no causal mask, 16 query
    heads over 16 KV heads (a grouping of 1), 1024 frames, hd 64."""
    g = torch.Generator(device=card).manual_seed(1024 + 16)
    q, k, v = (torch.randn(4, 16, 1024, 64, generator=g, device=card).to(
        torch.bfloat16) for _ in range(3))
    n = build.KERNELS["flash_attention"].launches
    out = flash_attention_bhsd(q, k, v, causal=False)
    assert build.KERNELS["flash_attention"].launches == n + 1
    expect = ref.attention_ref(q, k, v, causal=False)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])
    causal = ref.attention_ref(q, k, v, causal=True)
    assert (out.float() - causal.float()).abs().max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,fill", [(1057, 16), (1057, 1), (1121, 1100)])
def test_decode_kernel_at_a_grouping_of_one(card, hd, S, fill):
    """As many KV heads as query heads (seamless's self cache at hd 64,
    a partly filled 1057-slot cache; and at hd 128)."""
    g = torch.Generator(device=card).manual_seed(S + fill + hd)
    B, H = 4, 16
    q = torch.randn(B, H, hd, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, H, S, hd, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(B, H, S, hd, generator=g, device=card).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=card).expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    out = decode_attention_bhd(q, k, v, k_pos, q_pos)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_decode_kernel_as_cross_attention_keeps_every_slot(card):
    """seamless-m4t's cross attention through the decode kernel, as
    ``models/encdec.py`` calls it: ``k_pos = 0..1023`` and ``q_pos =
    1023`` keep all 1024 encoder slots, which equals the plain non-causal
    attention of one query over them (positions play no part); the
    decoder's own position as ``q_pos`` would keep too few."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention
    g = torch.Generator(device=card).manual_seed(4096)
    B, H, S, hd = 4, 16, 1024, 64
    q = torch.randn(B, 1, H, hd, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, S, H, hd, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(B, S, H, hd, generator=g, device=card).to(torch.bfloat16)
    enc_pos = torch.arange(S, dtype=torch.int32, device=card)
    n = build.KERNELS["decode_attention"].launches
    out = ops.decode_attention(q, k, v, enc_pos, enc_pos[-1:])
    assert build.KERNELS["decode_attention"].launches == n + 1
    for dec_pos in (0, 7, 31):
        expect = attention(q, k, v, q_pos=torch.full(
            (1,), dec_pos, dtype=torch.int32, device=card), k_pos=enc_pos,
            causal=False)
        torch.testing.assert_close(out.float(), expect.float(),
                                   **TOL[torch.bfloat16])
    trap = ops.decode_attention(q, k, v, enc_pos, enc_pos[7:8])
    assert (trap.float() - out.float()).abs().max() > 0.05


@pytest.mark.cuda
def test_error_feedback_round_trip_through_the_kernels(card):
    """``error_feedback_step`` on card tensors runs the quantize and
    dequantize kernels once per tensor each, and sends and keeps the same
    bits as the step on CPU copies (the plain functions), step after
    step."""
    from repro_torch.optim import compression
    g = torch.Generator(device=card).manual_seed(5)
    shapes = [(960, 2560), (2560,), (3, 7, 13), (1,)]
    kstate = compression.error_feedback_init(
        [torch.empty(s, device=card) for s in shapes])
    pstate = compression.error_feedback_init(
        [torch.empty(s) for s in shapes])
    for _ in range(3):
        grads = [torch.randn(s, generator=g, device=card) * 1e-2
                 for s in shapes]
        n0 = build.launch_counts()
        sent, kstate = compression.error_feedback_step(grads, kstate)
        n1 = build.launch_counts()
        assert n1["quantize_int8"] - n0["quantize_int8"] == len(shapes)
        assert n1["dequantize_int8"] - n0["dequantize_int8"] == len(shapes)
        psent, pstate = compression.error_feedback_step(
            [t.cpu() for t in grads], pstate)
        for a, b in zip(sent + kstate.residual, psent + pstate.residual):
            assert a.is_cuda
            assert torch.equal(a.cpu().view(torch.int32),
                               b.view(torch.int32))
    with pytest.raises(ValueError, match="256"):
        compression.compress_decompress(grads[0], block=64)


@pytest.mark.cuda
def test_moe_dispatch_matches_moe_ref_on_card(card):
    """qwen3's MoE block (128 experts, top 8, D 2048, F 768): the sorted
    dispatch against the dense oracle on the same input, with the same
    routing; y within two bf16 ulps (rtol 1.6e-2) above a floor of 4e-3 of
    its scale, since the two run each expert's matmuls as GEMMs of other
    shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.models.blocks import init_moe_params
    cfg = get_config("qwen3-moe-30b-a3b")
    g = torch.Generator(device=card).manual_seed(0)
    moe = init_moe_params(cfg, generator=g, device=card)
    x = torch.randn(2, 256, cfg.d_model, generator=g, device=card).to(
        torch.bfloat16)
    args = (x, moe.router, moe.w_gate, moe.w_up, moe.w_down)
    klog, plog = ffn.RouteLog(), ffn.RouteLog()
    y, lb, z = ffn.moe_dispatch(*args, cfg=cfg, log=klog)
    y_ref, lb_ref, z_ref = ffn.moe_ref(*args, cfg=cfg, log=plog)
    assert torch.equal(klog.calls[0][0], plog.calls[0][0])
    _close_to_scale(y, y_ref, 4e-3, 1.6e-2)
    torch.testing.assert_close(lb, lb_ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(z, z_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_model_views(card, dtype):
    """(B, S, H, hd) tensors through ops.flash_attention: the kernel gets
    transposed views (the TMA descriptors stride over S by H x hd)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn(2, 150, 15, 64, generator=g, device=card).to(dtype)
    k = torch.randn(2, 150, 5, 64, generator=g, device=card).to(dtype)
    v = torch.randn(2, 150, 5, 64, generator=g, device=card).to(dtype)
    out = ops.flash_attention(q, k, v, window=40)
    expect = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=40).transpose(1, 2)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,fill,ring", [
    (1000, 900, False),    # chunk 96 does not divide 1000
    (1024, 3, False),      # every split empty but the first
    (1024, 3, True)])      # a few kept slots scattered over the splits
def test_decode_kernel_split_edges(card, dtype, S, fill, ring):
    q, k, v, k_pos, q_pos = _decode_inputs(card, dtype, S, fill, ring)
    out = decode_attention_bhd(q, k, v, k_pos, q_pos)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_shared_positions(card, dtype):
    """One k_pos row for the whole batch (batch stride 0), as the model
    passes it, with per-sequence query positions."""
    q, k, v, _, _ = _decode_inputs(card, dtype, 300, 0, False)
    k_pos = torch.arange(300, dtype=torch.int32, device=card)
    k_pos = torch.where(k_pos < 250, k_pos, -1)[None].expand(4, 300)
    assert k_pos.stride(0) == 0
    q_pos = torch.tensor([0, 31, 200, 260], dtype=torch.int32, device=card)
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=64)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=64)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(12, 1), (5, 5), (16, 2)])
def test_decode_kernel_head_groups(card, Hq, Hkv):
    """Groups of 1, 8 and 12 query heads per KV head: a CTA takes at most
    4, so larger groups run in blocks."""
    g = torch.Generator(device=card).manual_seed(Hq)
    q = torch.randn(2, Hq, 64, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(2, Hkv, 500, 64, generator=g, device=card).to(
        torch.bfloat16)
    v = torch.randn(2, Hkv, 500, 64, generator=g, device=card).to(
        torch.bfloat16)
    k_pos = torch.arange(500, dtype=torch.int32, device=card).expand(2, 500)
    q_pos = torch.tensor([400, 499], dtype=torch.int32, device=card)
    out = decode_attention_bhd(q, k, v, k_pos, q_pos)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_decode_bf16_kernel_on_an_empty_cache_is_zero(card):
    q, k, v, k_pos, q_pos = _decode_inputs(card, torch.bfloat16, 1024, 10,
                                           False)
    out = decode_attention_bhd(q, k, v, torch.full_like(k_pos, -1), q_pos)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
def test_attention_kernels_replay_in_a_cuda_graph(card):
    """Both kernels captured in one CUDA graph and replayed give what an
    eager call gives, bit for bit (no allocation, sync or host read in the
    C code; the decode workspace comes from the graph's pool)."""
    g = torch.Generator(device=card).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn(4, 15, 128, 64, generator=g, device=card).to(bf)
    k = torch.randn(4, 5, 128, 64, generator=g, device=card).to(bf)
    v = torch.randn(4, 5, 128, 64, generator=g, device=card).to(bf)
    dq, dk, dv, k_pos, q_pos = _decode_inputs(card, bf, 161, 144, False)
    eager = (flash_attention_bhsd(q, k, v),
             decode_attention_bhd(dq, dk, dv, k_pos, q_pos))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture
        flash_attention_bhsd(q, k, v)
        decode_attention_bhd(dq, dk, dv, k_pos, q_pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fo = flash_attention_bhsd(q, k, v)
        do = decode_attention_bhd(dq, dk, dv, k_pos, q_pos)
    fo.zero_()
    do.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(fo, eager[0]) and torch.equal(do, eager[1])


@pytest.mark.cuda
def test_attention_kernels_refuse_unaligned_rows(card):
    """16-byte vector loads and TMA tiles need rows that start on 16
    bytes: a view 4 elements in is refused before launch."""
    base = torch.zeros(1, 3, 8, 72, device=card, dtype=torch.bfloat16)
    q = base[..., 4:68]
    kv = torch.zeros(1, 1, 8, 64, device=card, dtype=torch.bfloat16)
    n = build.launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_bhsd(q, kv, kv)
    k_pos = torch.zeros(1, 8, dtype=torch.int32, device=card)
    q_pos = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attention_bhd(q[:, :, 0], kv, kv, k_pos, q_pos)
    assert build.launch_counts() == n


@pytest.mark.cuda
def test_decode_kernel_on_an_empty_cache_is_zero(card):
    q, k, v, k_pos, q_pos = _decode_inputs(card, torch.float32, 256, 10,
                                           False)
    out = decode_attention_bhd(q, k, v, torch.full_like(k_pos, -1), q_pos)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128, 256])
def test_attention_kernels_refuse_an_unbuilt_head_dim(card, hd):
    """f32 is built at hd 64 only (128 and 256 are bf16's)."""
    q = torch.zeros(1, 3, 8, hd, device=card)
    k = torch.zeros(1, 1, 8, hd, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(q, k, k)
    k_pos = torch.zeros(1, 8, dtype=torch.int32, device=card)
    q_pos = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_bhd(q[:, :, 0], k, k, k_pos, q_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 80, 112])
def test_attention_kernels_refuse_an_unbuilt_bf16_head_dim(card, hd):
    """bf16 is built at hd 64, 96, 128 and 256 only."""
    q = torch.zeros(1, 3, 8, hd, dtype=torch.bfloat16, device=card)
    k = torch.zeros(1, 1, 8, hd, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(q, k, k)
    k_pos = torch.zeros(1, 8, dtype=torch.int32, device=card)
    q_pos = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_bhd(q[:, :, 0], k, k, k_pos, q_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 403, 65536])
def test_digest_kernel_bit_exact_on_card(card, nb):
    p = torch.from_numpy(np.random.default_rng(nb).integers(
        0, 2**32, (nb, 256), dtype=np.uint32)).to(card)
    out = block_digest(p).view(torch.int32)
    assert torch.equal(out, ref.digest_ref(p).view(torch.int32))


def _ssd_inputs(card, B, H, G, S, P=64, N=128, seed=0):
    """The SSD scan's inputs as the model makes them: bf16 x/B/C, dt the
    softplus of a raw projection plus a bias (0.001..0.3), A = -(1..16)."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(B, H, S, P, generator=g, device=card).to(torch.bfloat16)
    raw = torch.randn(B, H, S, generator=g, device=card) * 0.5
    bias = torch.linspace(-7.0, -1.5, H, device=card)[None, :, None]
    dt = torch.nn.functional.softplus(raw + bias)
    A = -torch.linspace(1.0, 16.0, H, device=card)
    Bm = torch.randn(B, G, S, N, generator=g, device=card).to(torch.bfloat16)
    Cm = torch.randn(B, G, S, N, generator=g, device=card).to(torch.bfloat16)
    return x, dt, A, Bm, Cm


def _close_to_scale(got, want, atol_share, rtol):
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=atol_share * scale, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,S", [(4, 64, 1, 512), (1, 64, 1, 1024),
                                     (2, 8, 2, 256), (1, 64, 1, 2048)])
def test_ssd_kernel_matches_plain_on_card(card, B, H, G, S):
    x, dt, A, Bm, Cm = _ssd_inputs(card, B, H, G, S, seed=S + G)
    n = build.KERNELS["ssd_scan"].launches
    y, state = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=256)
    assert build.KERNELS["ssd_scan"].launches == n + 1
    ry, rstate = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=256)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    _close_to_scale(y, ry, 1e-3, 8e-3)
    _close_to_scale(state, rstate, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,S,chunk", [
    (2, 64, 1, 4608, 256),    # zamba2's prefill: 18 chunks
    (2, 8, 2, 512, 256), (2, 8, 1, 384, 96), (1, 4, 1, 128, 32)])
def test_ssd_n64_kernel_matches_plain_on_card(card, B, H, G, S, chunk):
    """The N = 64 instantiation (zamba2's state dim: one box per B/C row,
    one state accumulator), whole and partial row tiles."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, B, H, G, S, N=64, seed=S + chunk)
    n = build.KERNELS["ssd_scan"].launches
    y, state = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=chunk)
    assert build.KERNELS["ssd_scan"].launches == n + 1
    assert state.shape == (B, H, 64, 64)
    ry, rstate = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    assert bool(torch.isfinite(y.float()).all())
    _close_to_scale(y, ry, 1e-3, 8e-3)
    _close_to_scale(state, rstate, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,G", [(32, 1), (64, 1), (64, 2), (96, 1),
                                     (128, 1), (128, 2)])
def test_ssd_kernel_takes_every_chunk(card, chunk, G):
    """Chunks that are multiples of 32 up to 256: whole and partial
    64-row tiles (96 = 64 + 32), several chunks carrying the state."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, 2, 8, G, 4 * chunk, seed=chunk + G)
    y, state = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=chunk)
    ry, rstate = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    _close_to_scale(y, ry, 1e-3, 8e-3)
    _close_to_scale(state, rstate, 1e-4, 1e-3)


@pytest.mark.cuda
def test_ssd_kernel_replays_in_a_cuda_graph(card):
    """The SSD kernel captured in a CUDA graph and replayed gives what an
    eager call gives, bit for bit."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, 4, 64, 1, 512, seed=13)
    eager = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture
        ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gs = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=256)
    gy.zero_()
    gs.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, eager[0]) and torch.equal(gs, eager[1])


@pytest.mark.cuda
def test_ssd_kernel_refuses_unaligned_rows(card):
    """Rows of x, B and C are copied 16 bytes at a time: a view 4 elements
    in is refused before launch."""
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 2, 1, 256)
    wide = torch.zeros(1, 1, 256, 136, device=card, dtype=torch.bfloat16)
    n = build.KERNELS["ssd_scan"].launches
    with pytest.raises(ValueError, match="16 bytes"):
        ssd_scan_bhsd(x, dt, A, wide[..., 4:132], Cm, chunk=256)
    assert build.KERNELS["ssd_scan"].launches == n


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_model_views(card):
    """The model hands the kernel transposed views of its conv output."""
    from repro_torch.kernels import ops
    x, dt, A, Bm, Cm = _ssd_inputs(card, 2, 8, 1, 256, seed=5)
    xs, dts = x.transpose(1, 2), dt.transpose(1, 2)
    Bs, Cs = Bm.transpose(1, 2), Cm.transpose(1, 2)
    y, state = ops.ssd_scan(xs, dts, A, Bs, Cs, chunk=256)
    ry, rstate = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=256)
    _close_to_scale(y.transpose(1, 2), ry, 1e-3, 8e-3)
    _close_to_scale(state, rstate, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(32, 128), (64, 32), (128, 128)])
def test_ssd_kernel_refuses_an_unbuilt_shape(card, P, N):
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 2, 1, 256, P=P, N=N)
    n = build.KERNELS["ssd_scan"].launches
    with pytest.raises(ValueError, match="head dim / state dim"):
        ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=256)
    assert build.KERNELS["ssd_scan"].launches == n


@pytest.mark.cuda
def test_ssd_kernel_refuses_f32_and_ragged_lengths(card):
    x, dt, A, Bm, Cm = _ssd_inputs(card, 1, 2, 1, 256)
    with pytest.raises(TypeError):
        ssd_scan_bhsd(x.float(), dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_scan_bhsd(x[:, :, :200], dt[:, :, :200], A, Bm[:, :, :200],
                      Cm[:, :, :200], chunk=256)


def _quant_values(card, n, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    mag = torch.rand(n, generator=g, device=card) * 6 - 3
    return torch.randn(n, generator=g, device=card) * 10.0 ** mag


def _special_blocks(card):
    zero = torch.zeros(256)
    half = (torch.arange(256, dtype=torch.float32) % 64 - 32) + 0.5
    half[0] = 127.0
    neg = torch.linspace(-1.0, 1.0, 256)
    neg[7] = -200.0
    return torch.cat([zero, half, neg]).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2_097_152, 1000, 256 * 9 + 17, "special"])
def test_quantize_kernels_bit_exact_on_card(card, n):
    x = (_special_blocks(card) if n == "special"
         else _quant_values(card, n, 3))
    n0 = build.launch_counts()
    q, s = quantize_int8(x)
    rq, rs = ref.quantize_int8_ref(x)
    assert torch.equal(q, rq)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    back = dequantize_int8(q, s, (x.numel(),))
    want = ref.dequantize_int8_ref(rq, rs, (x.numel(),))
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))
    counts = build.launch_counts()
    assert counts["quantize_int8"] == n0["quantize_int8"] + 1
    assert counts["dequantize_int8"] == n0["dequantize_int8"] + 1


@pytest.mark.cuda
def test_quantize_kernel_on_an_unaligned_view(card):
    x = _quant_values(card, 4097, 8)[1:]          # 4-byte offset
    q, s = quantize_int8(x)
    rq, rs = ref.quantize_int8_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


# -- the slab kernels (quantize_items, dequantize_items) ----------------------


def _slab_bit_exact(card, items):
    """One quantize_items and one dequantize_items launch for the slab;
    every item's codes, scales and values bit for bit its plain version's,
    and its padding blocks zero."""
    n0 = build.launch_counts()
    wire = quantize_items(items)
    backs = dequantize_items([(q, s, tuple(x.shape))
                              for x, (q, s) in zip(items, wire)])
    counts = build.launch_counts()
    assert counts["quantize_int8"] == n0["quantize_int8"] + 1
    assert counts["dequantize_int8"] == n0["dequantize_int8"] + 1
    for x, (q, s), back, (rq, rs), want in zip(
            items, wire, backs, ref.quantize_items_ref(items),
            ref.dequantize_items_ref([(q, s, tuple(x.shape))
                                      for x, (q, s) in zip(items, wire)])):
        assert torch.equal(q, rq)
        assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
        used = -(-x.numel() // 256)
        assert not q[used:].any() and not s[used:].any()
        assert back.shape == x.shape and back.is_cuda
        assert torch.equal(back.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,count", [((2, 64, 64, 64), 38),
                                         ((4, 64, 64, 128), 12)])
def test_quantize_items_kernels_at_the_state_shapes(card, shape, count):
    """zamba2's and mamba2's state items (2 MiB and 8 MiB of f32) as one
    slab, bit-exact."""
    _slab_bit_exact(card, [_quant_values(card, math.prod(shape), 40 + i)
                           .reshape(shape) for i in range(count)])


@pytest.mark.cuda
def test_quantize_items_kernels_on_ragged_items(card):
    """Lengths that are not multiples of 4, 256 or 2048, an empty item,
    all-zero blocks and the special blocks, in one slab."""
    items = [_quant_values(card, n, n) for n in
             (1, 3, 255, 257, 2047, 2049, 1_000_003)]
    items[5][256:512] = 0.0
    items += [torch.zeros(0, device=card), _special_blocks(card),
              torch.zeros(3000, device=card)]
    _slab_bit_exact(card, items)


@pytest.mark.cuda
def test_quantize_items_kernels_walk_ragged_items_across_ctas(card):
    """More tiles than the card holds CTAs, so each CTA walks several, and
    its range crosses items whose ends are ragged."""
    items = [_quant_values(card, 70_001 + 3 * i, 60 + i) for i in range(150)]
    _slab_bit_exact(card, items)


@pytest.mark.cuda
def test_quantize_items_copies_only_an_unaligned_item(card):
    from repro_torch.kernels import quantize
    base = _quant_values(card, 3 * 4096, 9)
    items = [base[1:4097], base[4096:8192], base[8196:]]   # +4, +0, +16 B
    c0 = quantize.copies
    _slab_bit_exact(card, items)
    assert quantize.copies == c0 + 1
    q, s = quantize_int8(base[4096:8192])
    raw = torch.zeros(q.numel() + 16, dtype=torch.int8, device=card)
    odd = raw[1:q.numel() + 1].view(q.shape)
    odd.copy_(q)
    c0 = quantize.copies
    back, = dequantize_items([(odd, s, (4096,))])
    assert quantize.copies == c0 + 1
    assert torch.equal(back, dequantize_int8(q, s, (4096,)))


@pytest.mark.cuda
def test_quantize_items_one_launch_per_table(card):
    """A slab longer than a launch's table splits into launches of
    MAX_ITEMS items; a single-item call is a slab of one, one launch."""
    from repro_torch.kernels import quantize
    k = quantize.MAX_ITEMS + 5
    items = [_quant_values(card, 300 + i, i) for i in range(k)]
    n0 = build.launch_counts()
    wire = quantize_items(items)
    backs = dequantize_items([(q, s, (x.numel(),))
                              for x, (q, s) in zip(items, wire)])
    n1 = build.launch_counts()
    assert n1["quantize_int8"] - n0["quantize_int8"] == 2
    assert n1["dequantize_int8"] - n0["dequantize_int8"] == 2
    for x, (q, s), back in zip(items, wire, backs):
        rq, rs = ref.quantize_int8_ref(x)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert torch.equal(back, ref.dequantize_int8_ref(rq, rs,
                                                         (x.numel(),)))
    x = items[7]
    n0 = build.launch_counts()
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, (x.numel(),))
    n1 = build.launch_counts()
    assert n1["quantize_int8"] == n0["quantize_int8"] + 1
    assert n1["dequantize_int8"] == n0["dequantize_int8"] + 1
    assert torch.equal(q, wire[7][0]) and torch.equal(back, backs[7])


@pytest.mark.cuda
def test_decompress_many_restores_host_items_in_one_launch(card):
    """The restore path: host wire items copied to the card, one launch
    for the slab, equal to the per-item path."""
    from repro_torch.core.integrity import (compress_transform,
                                            decompress_transform)
    items = [_quant_values(card, 524_288, 60 + i).reshape(2, 64, 64, 64)
             for i in range(5)]
    wire = [(q.cpu(), s.cpu(), shape)
            for q, s, shape in compress_transform().many(items)]
    decomp = decompress_transform(device=card)
    n0 = build.launch_counts()["dequantize_int8"]
    backs = decomp.many(wire)
    assert build.launch_counts()["dequantize_int8"] == n0 + 1
    for w, back in zip(wire, backs):
        assert back.is_cuda and torch.equal(back, decomp(w))


# -- whole-item digest (digest_items) and the accel stream digest -----------


def _bytes_on(card, seed, n):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8)).to(card)


def _fps(t):
    return t.view(torch.int64).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 1023, 1024, 1025, 5000, 412_160])
@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
def test_digest_items_kernel_bit_exact_on_card(card, n, offset):
    """One item at any length, its part starting ``offset`` bytes into its
    storage: the kernel reads it where it lies (vector loads where the
    address allows, words or bytes elsewhere)."""
    buf = _bytes_on(card, n + offset, n + offset + 16)
    items = [[buf[offset:offset + n]]]
    n0 = build.launch_counts()["digest_items"]
    got = digest_items(items)
    assert build.launch_counts()["digest_items"] == n0 + 1
    assert torch.equal(_fps(got), _fps(ref.digest_items_ref(items)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 300])
def test_digest_items_kernel_takes_a_slab_in_one_launch(card, k):
    """A slab of items of mixed shapes: KV-sized views of one storage,
    wire items (codes, scales, inline shape bytes), ragged and empty
    items.  300 items take two launches (256 per table)."""
    kv = _bytes_on(card, 1, 8 * 412_160)
    q = _bytes_on(card, 2, 4 * 65_536)
    items = []
    for i in range(k):
        r = i % 5
        if r == 0:
            items.append([kv[(i % 8) * 412_160:(i % 8 + 1) * 412_160]])
        elif r == 1:
            items.append([q[:65_536], q[65_536:65_536 + 1024], b"4161616"])
        elif r == 2:
            items.append([kv[i:i + 1000 + i]])
        elif r == 3:
            items.append([])
        else:
            items.append([b"ab" * (i % 7), kv[:4]])
    n0 = build.launch_counts()["digest_items"]
    got = digest_items(items)
    launches = build.launch_counts()["digest_items"] - n0
    assert launches == -(-k // 256)
    assert torch.equal(_fps(got), _fps(ref.digest_items_ref(items,
                                                            device=card)))


@pytest.mark.cuda
def test_digest_items_copies_only_an_unaligned_item(card):
    from repro_torch.kernels import digest as dmod
    s = _bytes_on(card, 3, 4096)
    items = [[s[:7], s[100:2000]], [s[1:3001]]]
    before = dmod.copies
    got = digest_items(items)
    assert dmod.copies == before + 1
    assert torch.equal(_fps(got), _fps(ref.digest_items_ref(items)))


@pytest.mark.cuda
def test_digest_items_replays_in_a_cuda_graph(card):
    kv = _bytes_on(card, 4, 3 * 412_160)
    items = [[kv[i * 412_160:(i + 1) * 412_160]] for i in range(3)]
    out = torch.empty(3, dtype=torch.uint64, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        digest_items(items, out=out)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            digest_items(items, out=out)
    torch.cuda.current_stream().wait_stream(side)
    out.zero_()
    graph.replay()
    graph.replay()
    assert torch.equal(_fps(out), _fps(ref.digest_items_ref(items)))


def _kv_items(card, k=64, seed=5):
    cache = _bytes_on(card, seed, k * 412_160)
    return [cache[i * 412_160:(i + 1) * 412_160].view(torch.bfloat16)
            for i in range(k)]


@pytest.mark.cuda
def test_stream_digest_add_many_never_syncs(card):
    """A slab folds with one launch and no host synchronisation: a hidden
    ``.cpu()`` or pageable copy per item raises under the debug mode."""
    from repro_torch.core.integrity import StreamDigest
    items = _kv_items(card)
    wire = [(items[0][:1024], items[1][:8], (4, 64, 64, 128))]
    d = StreamDigest(True, "accel")
    d.add_many(items[:1])                  # builds and loads the library
    torch.cuda.synchronize()
    n0 = build.launch_counts()["digest_items"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        d.add_many(items[1:])
        d.add(wire[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert build.launch_counts()["digest_items"] == n0 + 2
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many([t.cpu() for t in items])
    plain.add((wire[0][0].cpu(), wire[0][1].cpu(), wire[0][2]))
    assert d.hexdigest() == plain.hexdigest()
    assert d.hexdigest() == plain.hexdigest()


@pytest.mark.cuda
def test_stream_digest_from_four_threads(card):
    import threading
    from repro_torch.core.integrity import StreamDigest
    items = _kv_items(card, 48, 6)
    d = StreamDigest(True, "accel")
    d.add(items[0])
    ts = [threading.Thread(target=lambda w=items[1 + i::4]: [
        d.add_many(w[j:j + 3]) for j in range(0, len(w), 3)])
        for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many([t.cpu() for t in items])
    assert d.hexdigest() == plain.hexdigest()


@pytest.mark.cuda
def test_mover_accel_transfer_on_card_equals_plain_digest(card):
    from repro_torch.core import basin as tbasin, planner as tplanner
    from repro_torch.core.integrity import StreamDigest
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    items = _kv_items(card, 16, 7)
    plan = tplanner.plan_transfer(
        tbasin.card_host_basin(), item_bytes=items[0].nbytes,
        stages=("kv-stage",), checksum=True, checksum_placement="accel")
    n0 = build.launch_counts()["digest_items"]
    received = []
    report = UnifiedDataMover(MoverConfig(checksum=True),
                              plan=plan).bulk_transfer(
        iter(items), lambda t: received.append(t.to("cpu")), plan=plan)
    assert build.launch_counts()["digest_items"] - n0 == \
        report.checksum_folds == len(items)
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    assert report.checksum == plain.hexdigest()


# ---------------------------------------------------------------------------
# Training on the card: the kernels refuse gradients, the train step runs the
# plain path, and checkpoints and batches cross the card bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_require_grad(card):
    from repro_torch.kernels import ops
    g = torch.Generator(device=card).manual_seed(3)
    bf = dict(device=card, dtype=torch.bfloat16)
    q = torch.randn(1, 64, 15, 64, generator=g, **bf).requires_grad_()
    k = torch.randn(1, 64, 5, 64, generator=g, **bf)
    before = build.launch_counts()
    with pytest.raises(RuntimeError, match="no backward pass"):
        ops.flash_attention(q, k, k)
    kpos = torch.arange(64, dtype=torch.int32, device=card)
    qpos = torch.full((1,), 63, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="no backward pass"):
        ops.decode_attention(q[:, :1], k, k, kpos, qpos)
    x = torch.randn(1, 256, 64, 64, generator=g, **bf).requires_grad_()
    dt = torch.rand(1, 256, 64, generator=g, device=card)
    A = -torch.rand(64, generator=g, device=card)
    Bm = torch.randn(1, 256, 1, 128, generator=g, **bf)
    with pytest.raises(RuntimeError, match="no backward pass"):
        ops.ssd_scan(x, dt, A, Bm, Bm, chunk=256)
    assert build.launch_counts() == before    # the refusals launched none
    with torch.no_grad():                 # serving: launches as before
        ops.flash_attention(q, k, k)
        ops.ssd_scan(x, dt, A, Bm, Bm, chunk=256)
    counts = build.launch_counts()
    assert counts["flash_attention"] == before["flash_attention"] + 1
    assert counts["ssd_scan"] == before["ssd_scan"] + 1


def _smoke_trainer(card, tmp_path, arch="smollm-360m"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import Trainer
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2)
    t = Trainer(cfg, device=card, ckpt_dir=str(tmp_path), ckpt_every=2,
                total_steps=4)
    t.init_state(0)
    return cfg, t


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b"])
def test_train_on_card_runs_no_kernel_and_restores_bit_for_bit(card, arch,
                                                              tmp_path):
    from repro_torch.data.pipeline import PipelineConfig, SyntheticTokenSource
    cfg, t = _smoke_trainer(card, tmp_path, arch)
    build.reset_launches()
    log = t.run(SyntheticTokenSource(cfg, PipelineConfig(2, 32, seed=1),
                                     n_batches=8), 4, inject_failure_at=3)
    assert all(n == 0 for n in build.launch_counts().values())
    assert [r["step"] for r in log] == [1, 2, 3, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    _, t2 = _smoke_trainer(card, tmp_path, arch)
    assert t2.try_restore() and t2.step_idx == 3
    for a, b in zip(t.params.parameters(), t2.params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    for f in ("master", "m", "v"):
        for a, b in zip(getattr(t.opt_state, f), getattr(t2.opt_state, f)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_pipeline_places_batches_on_card_in_order(card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.telemetry import TelemetryRegistry
    from repro_torch.data.pipeline import (InputPipeline, PipelineConfig,
                                           SyntheticTokenSource)
    cfg = get_smoke_config("smollm-360m")
    pc = PipelineConfig(global_batch=8, seq_len=512, seed=4)
    want = list(SyntheticTokenSource(cfg, pc, n_batches=20))
    got = list(InputPipeline(SyntheticTokenSource(cfg, pc, n_batches=20),
                             device=card, telemetry=TelemetryRegistry()))
    torch.cuda.synchronize()
    assert len(got) == 20
    for a, b in zip(got, want):
        for k in b:
            assert a[k].device.type == "cuda"
            assert np.array_equal(a[k].cpu().numpy(), b[k])


# ---------------------------------------------------------------------------
# Resumable and fleet-bound transfers of card tensors
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_resumed_transfer_of_card_tensors(card, tmp_path):
    """Card tensors to host memory, killed at the 5th delivery and
    resumed: the resumed hexdigest equals an unbroken run's, each item
    arrives once, the skipped ones are keyed by their host bytes, and no
    digest kernel runs (the ledger's identities are host SHA-256)."""
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    from repro_torch.core.resume import TransferLedger
    items = _kv_items(card, 12, 11)
    move = [("d2h", lambda t: t.cpu())]
    whole = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(items), lambda _: None, transforms=move)
    path = str(tmp_path / "ledger.jsonl")
    got = []

    def dying(t):
        if len(got) >= 5:
            raise RuntimeError("cut")
        got.append(t)

    n0 = build.launch_counts()["digest_items"]
    with pytest.raises(RuntimeError, match="cut"):
        UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
            iter(items), dying, transforms=move,
            resume=TransferLedger(path))
    led = TransferLedger(path)
    rep = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(items), got.append, transforms=move, resume=led)
    assert build.launch_counts()["digest_items"] == n0
    assert rep.checksum == whole.checksum
    assert led.skipped_items == 5 and rep.items == 7
    assert sorted(TransferLedger.item_key(t) for t in got) == sorted(
        TransferLedger.item_key(t) for t in items)
    assert all(t.device.type == "cpu" for t in got)


@pytest.mark.cuda
def test_fleet_bound_transfer_with_accel_checksum(card):
    """Two fleet members on the card's staging basin: the second admits
    mid-stream, the first counts the re-grant as a replan, each digest
    launches once per item and equals the plain digest of what arrived,
    and completion releases both grants."""
    from repro_torch.core import basin as tbasin
    from repro_torch.core.fleet import FleetArbiter
    from repro_torch.core.integrity import StreamDigest
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    items = _kv_items(card, 16, 13)
    arb = FleetArbiter(tbasin.card_host_basin())
    kw = dict(stages=("kv-stage",), checksum=True,
              checksum_placement="accel")
    a = arb.admit("a", items[0].nbytes, qos="bulk", **kw)
    got_a, got_b, peer = [], [], {}

    def sink_a(t):
        got_a.append(t.cpu())
        if len(got_a) == 4:
            peer["b"] = arb.admit("b", items[0].nbytes, qos="interactive",
                                  **kw)

    n0 = build.launch_counts()["digest_items"]
    rep_a = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(items), sink_a, fleet=a)
    rep_b = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(items), lambda t: got_b.append(t.cpu()), fleet=peer["b"])
    assert build.launch_counts()["digest_items"] - n0 == \
        rep_a.checksum_folds + rep_b.checksum_folds == 2 * len(items)
    assert rep_a.replans >= 1
    for rep, got in ((rep_a, got_a), (rep_b, got_b)):
        plain = StreamDigest(True, "accel", backend="ref", device="cpu")
        plain.add_many(got)
        assert rep.checksum == plain.hexdigest()
    assert arb.grants() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("window", [0, 200])
def test_flash_kernel_at_query_offsets(card, hd, window):
    """A model rank's block of the query rows (the query-sequence split):
    the kernel at each offset of a 4-way split of 512 positions, and at
    an offset off the 64-row tile, against the plain version at that
    offset; at the tile-aligned offsets bit for bit the rows of the
    unsplit launch (the same key tiles in the same order)."""
    g = torch.Generator(device=card).manual_seed(hd + window)
    B, Hq, Hkv, S = 2, 6, 2, 512
    q = torch.randn(B, Hq, S, hd, generator=g, device=card).to(torch.bfloat16)
    k, v = (torch.randn(B, Hkv, S, hd, generator=g, device=card).to(
        torch.bfloat16) for _ in range(2))
    whole = flash_attention_bhsd(q, k, v, window=window)
    for off, rows in ((0, 128), (128, 128), (256, 128), (384, 128),
                      (100, 77)):
        qb = q[:, :, off:off + rows]
        n = build.KERNELS["flash_attention"].launches
        out = flash_attention_bhsd(qb, k, v, window=window, q_offset=off)
        assert build.KERNELS["flash_attention"].launches == n + 1
        expect = ref.attention_ref(qb, k, v, window=window, q_offset=off)
        torch.testing.assert_close(out.float(), expect.float(),
                                   **TOL[torch.bfloat16])
        if off % 64 == 0:
            assert torch.equal(out, whole[:, :, off:off + rows]), off


@pytest.mark.cuda
def test_flash_f32_kernel_at_query_offsets(card):
    """The f32 kernel (hd 64) at offsets: against the plain version, and
    bit for bit the unsplit launch's rows at tile-aligned offsets."""
    g = torch.Generator(device=card).manual_seed(64)
    q = torch.randn(2, 4, 256, 64, generator=g, device=card)
    k, v = (torch.randn(2, 2, 256, 64, generator=g, device=card)
            for _ in range(2))
    whole = flash_attention_bhsd(q, k, v, window=100)
    for off, rows in ((0, 64), (64, 64), (192, 64), (30, 50)):
        out = flash_attention_bhsd(q[:, :, off:off + rows], k, v, window=100,
                                   q_offset=off)
        expect = ref.attention_ref(q[:, :, off:off + rows], k, v, window=100,
                                   q_offset=off)
        torch.testing.assert_close(out, expect, **TOL[torch.float32])
        if off % 64 == 0:
            assert torch.equal(out, whole[:, :, off:off + rows]), off
    with pytest.raises(ValueError, match="offset"):
        flash_attention_bhsd(q[:, :, :64], k, v, q_offset=193)
