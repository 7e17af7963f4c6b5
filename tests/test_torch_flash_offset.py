"""Flash attention at a query offset: a model rank's block of the query rows
(the query-sequence split over the model axis, ``ShardCtx.
seq_parallel_attn``) against the keys of the whole sequence.

On the CPU the wrapper computes its plain version, ``ref.attention_ref(...,
q_offset=)``; these tests hold both to the JAX package on the same seeded
numpy inputs: to ``repro.models.attention.attention(impl="ref")`` at the
block's positions (``q_pos = arange(off, off + Sq)``), and to the rows
``[off, off + Sq)`` of the Pallas kernel ``flash_attention_bhsd`` run
unsplit in interpret mode (S 256, bq = bk = 128), causal and windowed, f32
and bf16, at each offset of a 4-way split.  Tolerances are those of
``tests/test_torch_kernels.py``: f32 3e-5, bf16 3e-2.  Also the
refusals: the wrapper's of an offset it cannot take, and the model
route's (``attention(impl="cuda")``) of positions that are not such a
block.  ``tests/test_torch_cuda.py`` holds the kernel itself to the plain
version at offsets, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.models.attention import attention as jax_attention

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.models.attention import attention, query_block_offset

torch.set_num_threads(1)

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
#: the whole sequence, its 4-way split, and the model's (B, S, H, hd) heads
S, SPLIT, B, HQ, HKV, HD = 256, 4, 1, 6, 2, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, HQ, S, HD), (B, HKV, S, HD), (B, HKV, S, HD))]


def _pair(a, dtype):
    t, j = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
def test_offset_rows_match_pallas_and_model_attention(dtype, window):
    """Each rank's block of a 4-way split: the plain version and the
    wrapper (CPU) against the Pallas kernel's rows of the unsplit launch,
    and against the JAX model's attention at the block's positions."""
    q, k, v = _inputs(window + len(dtype))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    whole = _f32(jax_flash(jq, jk, jv, causal=True, window=window, bq=128,
                           bk=128, interpret=True))
    c = S // SPLIT
    k_pos = jnp.arange(S, dtype=jnp.int32)
    for r in range(SPLIT):
        off = r * c
        rows = slice(off, off + c)
        got = ref.attention_ref(tq[:, :, rows], tk, tv, causal=True,
                                window=window, q_offset=off)
        wrapped = flash_attention_bhsd(tq[:, :, rows], tk, tv, causal=True,
                                       window=window, q_offset=off)
        assert got.dtype == tq.dtype and got.shape == (B, HQ, c, HD)
        torch.testing.assert_close(wrapped, got, atol=0, rtol=0)
        np.testing.assert_allclose(_f32(got), whole[:, :, rows],
                                   **TOL[dtype], err_msg=f"offset {off}")
        model = jax_attention(
            jnp.swapaxes(jq[:, :, rows], 1, 2), jnp.swapaxes(jk, 1, 2),
            jnp.swapaxes(jv, 1, 2),
            q_pos=jnp.arange(off, off + c, dtype=jnp.int32), k_pos=k_pos,
            causal=True, window=window, impl="ref")
        np.testing.assert_allclose(_f32(got), np.swapaxes(_f32(model), 1, 2),
                                   **TOL[dtype], err_msg=f"offset {off}")


def test_offset_zero_is_the_whole_launch_and_cuda_route_takes_blocks():
    """Offset 0 over Sq == Sk is the unsplit plain version bit for bit;
    ``attention(impl="cuda")`` on CPU tensors takes a causal block of
    query positions at its offset (the plain version at that offset, the
    model's (B, S, H, hd) layout), and ``query_block_offset`` reads it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3))
    torch.testing.assert_close(
        ref.attention_ref(q, k, v, window=48, q_offset=0),
        ref.attention_ref(q, k, v, window=48), atol=0, rtol=0)
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    k_pos = torch.arange(S, dtype=torch.int32)
    c = S // SPLIT
    before = build.launch_counts()
    for r in range(SPLIT):
        off = r * c
        q_pos = torch.arange(off, off + c, dtype=torch.int32)
        assert query_block_offset(q_pos, k_pos, True) == off
        got = attention(qm[:, off:off + c], km, vm, q_pos=q_pos,
                        k_pos=k_pos, causal=True, window=48, impl="cuda")
        want = ops.flash_attention(qm[:, off:off + c], km, vm, window=48,
                                   q_offset=off)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        plain = attention(qm[:, off:off + c], km, vm, q_pos=q_pos,
                          k_pos=k_pos, causal=True, window=48, impl="ref")
        torch.testing.assert_close(got, plain, **TOL["float32"])
    assert build.launch_counts() == before


def test_offsets_the_kernel_cannot_take_raise():
    """The wrapper refuses a negative offset and, under the causal mask,
    one whose rows would reach past the keys (on every device: here the
    CPU); ``attention(impl="cuda")`` refuses Sq != Sk unless the queries
    are causal at a block ``arange(off, off + Sq)`` of keys at
    ``arange(Sk)``: not a block, keys not ``arange``, positions per batch
    row, non-causal (cross attention), or a block past the keys."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5))
    qb = q[:, :, :64]
    with pytest.raises(ValueError, match="offset"):
        flash_attention_bhsd(qb, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="offset"):
        flash_attention_bhsd(qb, k, v, q_offset=S - 63)
    # the last block fits, and without the causal mask any offset does
    flash_attention_bhsd(qb, k, v, q_offset=S - 64)
    flash_attention_bhsd(qb, k, v, causal=False, q_offset=S)
    qm, km, vm = (t.transpose(1, 2) for t in (qb, k, v))
    k_pos = torch.arange(S, dtype=torch.int32)
    block = torch.arange(64, 128, dtype=torch.int32)
    bad = {
        "not a block": (block.flip(0), k_pos, True),
        "a gap": (torch.cat([block[:32], block[32:] + 1]), k_pos, True),
        "keys not arange": (block, k_pos.flip(0), True),
        "per-row positions": (block.expand(B, 64), k_pos, True),
        "non-causal": (block, k_pos, False),
        "past the keys": (torch.arange(S - 32, S + 32, dtype=torch.int32),
                          k_pos, True),
    }
    for what, (q_pos, kp, causal) in bad.items():
        with pytest.raises(ValueError, match="flash route"):
            attention(qm, km, vm, q_pos=q_pos, k_pos=kp, causal=causal,
                      impl="cuda")
        # the plain path takes any positions
        out = attention(qm, km, vm, q_pos=q_pos, k_pos=kp, causal=causal,
                        impl="ref")
        assert out.shape == qm.shape, what
