"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` computes its plain
version; these tests hold that to the JAX Pallas kernel in interpret mode
and to the JAX oracle, on the same seeded numpy inputs
(``tests/test_torch_cuda.py`` holds the kernels themselves to these plain
versions on the card).

Tolerances are those of ``tests/test_kernels.py``: f32 3e-5 (sums taken in
another order), bf16 3e-2 (one bf16 rounding of the output); the digest is
bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_bhd as jax_decode
from repro.kernels.digest import block_digest as jax_block_digest
from repro.kernels.digest import digest_ref as jax_digest_ref
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.digest import block_digest
from repro_torch.kernels.flash_attention import flash_attention_bhsd

torch.set_num_threads(1)

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp and a torch array of ``dtype`` (both round
    f32 to bf16 to nearest-even, so the bits agree)."""
    t = torch.from_numpy(a)
    j = jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_plain_matches_pallas_and_oracle(dtype, window):
    B, Hq, Hkv, S, hd = 1, 6, 2, 256, 32
    rng = np.random.default_rng(window + len(dtype))
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    port = flash_attention_bhsd(tq, tk, tv, causal=True, window=window)
    assert port.dtype == tq.dtype and port.shape == (B, Hq, S, hd)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_f32(port), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(port), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("S", [37, 200])
def test_flash_plain_takes_any_length(S):
    """The port has no seq % 128 routing limit: a ragged S matches the
    JAX oracle."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, 4, S, 16), dtype=np.float32)
    k = rng.standard_normal((2, 2, S, 16), dtype=np.float32)
    v = rng.standard_normal((2, 2, S, 16), dtype=np.float32)
    port = flash_attention_bhsd(*(torch.from_numpy(a) for a in (q, k, v)))
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_f32(port), _f32(oracle), **TOL["float32"])


def test_ops_flash_model_layout_is_a_transpose():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 3, 16), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 3, 16), dtype=np.float32))
    out = ops.flash_attention(q, k, v, window=8)
    expect = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), window=8).transpose(1, 2)
    torch.testing.assert_close(out, expect, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_inputs(seed, B, Hq, Hkv, S, hd, fill, ring):
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


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("fill", [17, 127])
def test_decode_plain_matches_pallas(ring, window, fill):
    arrs = _decode_inputs(fill + window, 2, 6, 2, 128, 32, fill, ring)
    port = decode_attention_bhd(*(torch.from_numpy(a) for a in arrs),
                                window=window)
    ja = [jnp.asarray(a) for a in arrs]
    pallas = jax_decode(*ja, window=window, bk=64, interpret=True)
    oracle = jref.decode_attention_ref(*ja, window=window)
    np.testing.assert_allclose(_f32(port), _f32(pallas), **TOL["float32"])
    np.testing.assert_allclose(_f32(port), _f32(oracle), **TOL["float32"])


def test_decode_plain_bf16_matches_pallas():
    arrs = _decode_inputs(3, 2, 6, 2, 128, 32, 90, True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3])
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs[:3])
    port = decode_attention_bhd(tq, tk, tv, torch.from_numpy(arrs[3]),
                                torch.from_numpy(arrs[4]))
    pallas = jax_decode(jq, jk, jv, jnp.asarray(arrs[3]), jnp.asarray(arrs[4]),
                        interpret=True)
    np.testing.assert_allclose(_f32(port), _f32(pallas), **TOL["bfloat16"])


def test_ops_decode_broadcasts_shared_positions():
    """The model passes one (S,) k_pos and a (1,) q_pos for the batch."""
    arrs = _decode_inputs(5, 3, 4, 2, 64, 16, 40, False)
    q, k, v, k_pos, q_pos = (torch.from_numpy(a) for a in arrs)
    out = ops.decode_attention(q[:, None], k.transpose(1, 2),
                               v.transpose(1, 2), k_pos[0], q_pos[:1])
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos)
    torch.testing.assert_close(out[:, 0], expect, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# digest
# ---------------------------------------------------------------------------


def _panels(nb: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2**32, (nb, 256), dtype=np.uint32)


@pytest.mark.parametrize("nb", [8, 16, 64])
def test_digest_plain_bit_exact_with_pallas_and_oracle(nb):
    p = _panels(nb, nb)
    port = block_digest(torch.from_numpy(p)).view(torch.int32).numpy()
    port = port.view(np.uint32)
    np.testing.assert_array_equal(port, np.asarray(jax_digest_ref(p)))
    np.testing.assert_array_equal(
        port, np.asarray(jax_block_digest(p, tile=8, interpret=True)))


@pytest.mark.parametrize("nb", [1, 13])
def test_digest_plain_takes_any_row_count(nb):
    p = _panels(nb, 100 + nb)
    port = block_digest(torch.from_numpy(p)).view(torch.int32).numpy()
    np.testing.assert_array_equal(port.view(np.uint32),
                                  np.asarray(jax_digest_ref(p)))


def test_digest_plain_extremes():
    """All-ones words exercise every wraparound of the products."""
    p = np.full((8, 256), 0xFFFFFFFF, np.uint32)
    p[1] = 0
    p[2, ::2] = 0x80000000
    port = block_digest(torch.from_numpy(p)).view(torch.int32).numpy()
    np.testing.assert_array_equal(port.view(np.uint32),
                                  np.asarray(jax_digest_ref(p)))


def test_cpu_tensors_never_touch_the_kernels():
    """On CPU tensors the wrappers compute the plain version: nothing is
    built and no launch is counted."""
    before = build.launch_counts()
    flash_attention_bhsd(torch.zeros(1, 2, 8, 16), torch.zeros(1, 1, 8, 16),
                         torch.zeros(1, 1, 8, 16))
    block_digest(torch.zeros(2, 256, dtype=torch.uint32))
    assert build.launch_counts() == before
