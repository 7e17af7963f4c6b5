"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is False,
and run on the H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: f32 3e-5 (sums in another order), bf16 atol 1e-3 + rtol 8e-3
(both round an f32 result to bf16 once: about one ulp of the output); the
digest is bit-exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.digest import block_digest
from repro_torch.kernels.flash_attention import flash_attention_bhsd

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
