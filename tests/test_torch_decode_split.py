"""The split-K decode attention's plan and its plain two-step version.

The CUDA decode kernel cuts the cache into ranges of ``chunk`` slots, writes
a partial softmax state (m, l, acc) per range and merges the ranges in a
second kernel.  Here, on the CPU: the wrapper's plan covers every slot once
with ``chunk`` a multiple of 32 and gives the CTA counts the design aims
for, and ``ref.decode_attention_split_ref`` (the two steps in plain
PyTorch) equals ``ref.decode_attention_ref`` and the JAX package's Pallas
decode kernel in interpret mode on the same seeded numpy inputs, f32 within
1e-6 (the same sums split in another place).  The serving path never calls
the split version: on a CPU tensor the wrapper computes the one-pass plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_bhd as jax_decode

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (CHUNK_ALIGN, TARGET_CTAS,
                                                  split_plan)

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 31, 32, 33, 161, 1000, 1024, 4096, 32768])
@pytest.mark.parametrize("B,Hq,Hkv,ctas", [
    (1, 1, 1, 1), (1, 5, 5, 5), (4, 15, 5, 20), (4, 12, 4, 16),
    (4, 32, 8, 32), (2, 12, 1, 6), (8, 96, 8, 192), (64, 32, 8, 512)])
def test_split_plan_covers_every_slot_once(S, B, Hq, Hkv, ctas):
    """``ctas``: CTAs per range, one per sequence, KV head and block of up
    to 4 query heads."""
    chunk, n_split = split_plan(S, B, Hq, Hkv)
    assert chunk >= CHUNK_ALIGN and chunk % CHUNK_ALIGN == 0
    ranges = [range(i * chunk, min(S, (i + 1) * chunk))
              for i in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [s for r in ranges for s in r] == list(range(S))
    # at most the splits that reach the CTA target, and the smallest chunk
    # that keeps to that: 32 slots fewer would need more splits
    want = -(-TARGET_CTAS // ctas)
    assert n_split <= want
    if chunk > CHUNK_ALIGN:
        assert -(-S // (chunk - CHUNK_ALIGN)) > want


def test_split_plan_at_the_measured_shapes():
    """smollm-360m at batch 4: 5 KV heads, 3 query heads each (one head
    block), so 20 CTAs per split."""
    assert split_plan(161, 4, 15, 5) == (32, 6)    # 120 CTAs, the serving step
    assert split_plan(1024, 4, 15, 5) == (96, 11)  # 220 CTAs


def _inputs(seed, B, Hq, Hkv, S, hd, fill, ring):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    k_pos = np.where(pos <= fill, pos, -1).astype(np.int32)
    if ring:   # slots in a permuted order: only k_pos may be trusted
        perm = rng.permutation(S)
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm]
    q_pos = np.full((B,), fill, np.int32)
    return [np.ascontiguousarray(a) for a in (q, k, v, k_pos, q_pos)]


@pytest.mark.parametrize("fill,ring,window,chunk", [
    (3, False, 0, 32),       # every range empty but the first
    (100, True, 0, 32),      # ring order
    (127, True, 40, 32),     # ring order and a window
    (90, False, 16, 64),     # a window inside one range
    (127, False, 0, 96),     # chunk does not divide S
    (-1, False, 0, 32)])     # nothing kept anywhere: 0
def test_split_plain_matches_one_pass_and_pallas(fill, ring, window, chunk):
    arrs = _inputs(fill + window + chunk, 2, 6, 2, 128, 32, fill, ring)
    q, k, v, k_pos, q_pos = (torch.from_numpy(a) for a in arrs)
    split = ref.decode_attention_split_ref(q, k, v, k_pos, q_pos,
                                           chunk=chunk, window=window)
    one = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    pallas = jax_decode(*(jnp.asarray(a) for a in arrs), window=window,
                        bk=64, interpret=True)
    assert bool(torch.isfinite(split).all())
    torch.testing.assert_close(split, one, **TOL)
    np.testing.assert_allclose(split.numpy(), np.asarray(pallas), **TOL)
    if fill < 0:
        assert torch.equal(split, torch.zeros_like(split))


def test_split_partials_of_empty_ranges_weigh_nothing():
    arrs = _inputs(4, 1, 4, 2, 128, 16, 20, False)
    q, k, v, k_pos, q_pos = (torch.from_numpy(a) for a in arrs)
    m, l, acc = ref.decode_partials_ref(q, k, v, k_pos, q_pos, chunk=32)
    assert m.shape == l.shape == (4, 1, 4) and acc.shape == (4, 1, 4, 16)
    assert bool(torch.isfinite(m[0]).all()) and bool((l[0] >= 1).all())
    assert bool(torch.isinf(m[1:]).all())
    assert not bool(l[1:].any()) and not bool(acc[1:].any())


def test_bf16_split_plain_matches_one_pass():
    """bf16 inputs widen to f32 in both; each rounds its f32 result to bf16
    once, so they differ by at most one ulp (the card tests' tolerance)."""
    arrs = _inputs(9, 2, 6, 2, 128, 32, 77, True)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3])
    k_pos, q_pos = torch.from_numpy(arrs[3]), torch.from_numpy(arrs[4])
    split = ref.decode_attention_split_ref(q, k, v, k_pos, q_pos, chunk=32)
    one = ref.decode_attention_ref(q, k, v, k_pos, q_pos)
    assert split.dtype == torch.bfloat16
    torch.testing.assert_close(split.float(), one.float(), atol=1e-3,
                               rtol=8e-3)


def test_serving_path_never_calls_the_split_version(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the split plain version ran")
    monkeypatch.setattr(ref, "decode_attention_split_ref", boom)
    monkeypatch.setattr(ref, "decode_partials_ref", boom)
    arrs = _inputs(5, 2, 4, 2, 64, 16, 40, False)
    q, k, v, k_pos, q_pos = (torch.from_numpy(a) for a in arrs)
    out = ops.decode_attention(q[:, None], k.transpose(1, 2),
                               v.transpose(1, 2), k_pos[0], q_pos[:1])
    torch.testing.assert_close(
        out[:, 0], ref.decode_attention_ref(q, k, v, k_pos, q_pos),
        atol=0, rtol=0)
