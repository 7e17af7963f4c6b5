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

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.digest import block_digest, digest_items
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
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
@pytest.mark.parametrize("hd", [32, 128])
def test_attention_kernels_refuse_an_unbuilt_head_dim(card, hd):
    q = torch.zeros(1, 3, 8, hd, device=card)
    k = torch.zeros(1, 1, 8, hd, device=card)
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
@pytest.mark.parametrize("P,N", [(32, 128), (64, 64), (128, 128)])
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
