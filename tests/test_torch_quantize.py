"""The port's int8 quantizer and compressed wire against the JAX package's.

On the CPU the wrappers of ``repro_torch.kernels.quantize`` compute their
plain versions; these tests hold those to the JAX oracle
(``repro.optim.compression``) and to the Pallas kernels in interpret mode
on the same seeded numpy inputs (``tests/test_torch_cuda.py`` holds the
kernels themselves to the plain versions on the card).

There is no tolerance: codes, scales and dequantized values are compared
bit for bit.  One difference of the reference is pinned down instead of
hidden: the oracle's ``max|x| / 127`` is an IEEE division, while the
Pallas kernel (and anything else jitted by XLA on the CPU) multiplies by
f32(1/127), which lands one ulp away in a few percent of the blocks.  The
port divides, as the oracle does; against the Pallas kernel the scale is
equal or one ulp away, and the kernel's codes are exactly the codes of
its own scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrity as jintegrity
from repro.kernels.quantize import dequantize_int8 as jax_dequantize
from repro.kernels.quantize import quantize_int8 as jax_quantize
from repro.optim import compression as jcompression

from repro_torch.core import basin, integrity, planner
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
from repro_torch.optim import compression

torch.set_num_threads(1)


def _values(n: int, seed: int) -> np.ndarray:
    """Values over six decades of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * rng.uniform(1e-3, 1e3, n)).astype(
        np.float32)


def _codes_of(x: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """clip(round_half_even(x / safe)) per 256-block, by IEEE division."""
    blocks = np.zeros(scales.size * 256, np.float32)
    blocks[:x.size] = x
    safe = np.where(scales > 0, scales, np.float32(1.0)).astype(np.float32)
    q = np.rint(blocks.reshape(-1, 256) / safe[:, None])
    return np.clip(q, -127, 127).astype(np.int8)


def _within_half_step(x: np.ndarray, back: np.ndarray,
                      scales: np.ndarray) -> bool:
    """|back - x| <= scale / 2 + (|x| + |back|) * 2^-24, element-wise."""
    half = np.repeat(scales, 256)[:x.size].reshape(x.shape) * 0.5
    slack = (np.abs(x) + np.abs(back)) * 2.0 ** -24
    return bool(np.all(np.abs(back - x) <= half + slack))


def _special_blocks() -> np.ndarray:
    """An all-zero block; a block with max 127 (scale exactly 1) whose
    values sit on k + 0.5, to test round half to even; a block whose
    largest magnitude is negative."""
    zero = np.zeros(256, np.float32)
    half = (np.arange(256, dtype=np.float32) % 64 - 32) + 0.5
    half[0] = 127.0
    neg = np.linspace(-1.0, 1.0, 256).astype(np.float32)
    neg[7] = -200.0
    return np.concatenate([zero, half, neg])


@pytest.mark.parametrize("n", [2048 * 3, 1000, 256 * 9 + 17])
def test_quantize_bit_exact_with_oracle(n):
    x = _values(n, n)
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape[0] % 8 == 0 and q.shape == (q.shape[0], 256)
    assert q.shape[0] == -(-n // 2048) * 8
    jq, js = jcompression.quantize_int8_blockwise(jnp.asarray(x))
    nb = jq.shape[0]
    np.testing.assert_array_equal(q[:nb].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s[:nb].numpy(), np.asarray(js))
    # the padding the kernel adds past the oracle's blocks is zero
    assert not q[nb:].any() and not s[nb:].any()
    # and the port's own oracle is the same function
    oq, os_ = compression.quantize_int8_blockwise(torch.from_numpy(x))
    assert torch.equal(oq, q[:nb]) and torch.equal(os_, s[:nb])


@pytest.mark.parametrize("n", [2048 * 3, 256 * 9 + 17])
def test_quantize_against_the_pallas_kernel(n):
    x = _values(n, n + 1)
    q, s = quantize_int8(torch.from_numpy(x))
    pq, ps = (np.asarray(a) for a in jax_quantize(jnp.asarray(x),
                                                  interpret=True))
    assert pq.shape == tuple(q.shape) and ps.shape == tuple(s.shape)
    s = s.numpy()
    # the Pallas scale is max|x| * f32(1/127): equal, or one ulp away
    amax = np.abs(np.pad(x, (0, s.size * 256 - n))).reshape(-1, 256).max(1)
    np.testing.assert_array_equal(ps, amax * np.float32(1 / 127))
    ulps = np.abs(ps.view(np.int32).astype(np.int64)
                  - s.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # codes: each kernel's are exactly the codes of its own scale, so they
    # agree wherever the scales do
    np.testing.assert_array_equal(pq, _codes_of(x, ps))
    np.testing.assert_array_equal(q.numpy(), _codes_of(x, s))
    same = ulps == 0
    np.testing.assert_array_equal(q.numpy()[same], pq[same])


def test_quantize_special_blocks_bit_exact():
    x = _special_blocks()
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = (np.asarray(a) for a in
              jcompression.quantize_int8_blockwise(jnp.asarray(x)))
    np.testing.assert_array_equal(q[:3].numpy(), jq)
    np.testing.assert_array_equal(s[:3].numpy(), js)
    assert s[0] == 0 and not q[0].any()                 # all-zero block
    assert s[1] == 1.0                                  # max 127 -> scale 1
    half = x[256:512]
    np.testing.assert_array_equal(q[1, 1:].numpy(), np.rint(half[1:]))
    assert [q[1, i].item() for i in (32, 33, 34)] == [0, 2, 2]  # .5 1.5 2.5
    assert [q[1, i].item() for i in (31, 30, 29)] == [0, -2, -2]
    assert q[2, 7].item() == -127                       # the negative max
    assert s[2] == np.float32(200.0) / np.float32(127.0)


@pytest.mark.parametrize("shape", [(3, 700), (4, 2, 256)])
def test_dequantize_exact(shape):
    x = _values(int(np.prod(shape)), 5).reshape(shape)
    q, s = quantize_int8(torch.from_numpy(x))
    back = dequantize_int8(q, s, shape)
    assert back.dtype == torch.float32 and tuple(back.shape) == shape
    want = jcompression.dequantize_int8_blockwise(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    pallas = jax_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                            shape, interpret=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(pallas))
    # the int8 error is at most half a step of the block's scale, plus the
    # f32 rounding of x / scale and of q * scale
    assert _within_half_step(x, back.numpy(), s.numpy())
    assert torch.equal(ops.dequantize(q, s, shape), back)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, s = quantize_int8(torch.zeros(512))
    with pytest.raises(ValueError, match="fewer than"):
        dequantize_int8(q, s, (q.numel() + 1,))
    with pytest.raises(TypeError):
        dequantize_int8(q.to(torch.int16), s, (4,))
    with pytest.raises(ValueError):
        dequantize_int8(q, s[:-1], (4,))


def test_plain_versions_are_the_oracle_padded():
    x = torch.from_numpy(_values(3000, 9))
    q, s = ref.quantize_int8_ref(x)
    oq, os_ = compression.quantize_int8_blockwise(x)
    assert q.shape[0] == 16 and torch.equal(q[:oq.shape[0]], oq)
    assert torch.equal(s[:os_.shape[0]], os_)
    assert torch.equal(ref.dequantize_int8_ref(q, s, (3000,)),
                       compression.dequantize_int8_blockwise(oq, os_,
                                                             (3000,)))
    rt = compression.compress_decompress(x.reshape(30, 100))
    assert rt.shape == (30, 100) and torch.equal(
        rt.reshape(-1), ref.dequantize_int8_ref(q, s, (3000,)))


# ---------------------------------------------------------------------------
# the wire transforms and the digest of their items
# ---------------------------------------------------------------------------


def _state_items(seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 4, 8, 16)) * 3.0).astype(np.float32)
            for _ in range(3)] + [rng.standard_normal((5, 77)).astype(
                np.float32)]


def test_compress_transform_round_trip_against_reference():
    xs = _state_items()
    comp, decomp = integrity.compress_transform(), \
        integrity.decompress_transform()
    jcomp, jdecomp = jintegrity.compress_transform(), \
        jintegrity.decompress_transform()
    per_item = [comp(torch.from_numpy(x)) for x in xs]
    slab = comp.many([torch.from_numpy(x) for x in xs])
    for (q, s, shape), (q2, s2, shape2), x in zip(per_item, slab, xs):
        assert shape == shape2 == x.shape
        assert torch.equal(q, q2) and torch.equal(s, s2)
        jq, js, jshape = jcomp(x)
        assert jshape == shape and tuple(q.shape) == np.shape(jq)
        # codes agree wherever the reference kernel's scale does (see the
        # module docstring for the one-ulp scale difference)
        ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(js).view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
        same = ulps == 0
        np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq)[same])
        # the port decompresses the reference's wire items exactly as the
        # reference does
        np.testing.assert_array_equal(
            decomp((torch.from_numpy(np.array(jq)),
                    torch.from_numpy(np.array(js)), jshape)).numpy(),
            np.asarray(jdecomp((jq, js, jshape))))
    backs = decomp.many(slab)
    for back, item, x in zip(backs, per_item, xs):
        assert torch.equal(back, decomp(item))
        assert back.shape == x.shape
        assert _within_half_step(x, back.numpy(), item[1].numpy())
    assert getattr(comp, "encodes_wire") and not getattr(decomp,
                                                         "encodes_wire")


def test_decompress_transform_moves_items_to_its_device():
    x = torch.from_numpy(_state_items()[0])
    item = integrity.compress_transform()(x)
    back = integrity.decompress_transform(device="cpu")(item)
    assert back.device.type == "cpu" and back.shape == x.shape


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_tuple_item_digest_equals_its_host_copy(backend):
    """A compressed item (q, scales, shape) is digested from its tensors'
    own memory; the hexdigest equals that of the same item delivered to
    the host as bytes, and the reference's on numpy copies."""
    comp = integrity.compress_transform()
    items = [comp(torch.from_numpy(x)) for x in _state_items(1)]
    got = integrity.StreamDigest(True, "accel", backend=backend,
                                 device="cpu")
    got.add_many(items)
    as_host = integrity.StreamDigest(True, "accel", backend=backend,
                                     device="cpu")
    as_host.add_many([integrity.as_bytes(it) for it in items])
    assert got.hexdigest() == as_host.hexdigest()
    want = jintegrity.StreamDigest(True, "accel")
    want.add_many([(q.numpy(), s.numpy(), shape) for q, s, shape in items])
    assert got.hexdigest() == want.hexdigest()
    host = integrity.StreamDigest(True, "host")
    host.add_many(items)
    jhost = jintegrity.StreamDigest(True, "host")
    jhost.add_many([(q.numpy(), s.numpy(), shape) for q, s, shape in items])
    assert host.hexdigest() == jhost.hexdigest()


def test_checksummed_compressed_transfer_digests_the_wire():
    """A bulk transfer through the compress transform, checksummed on the
    accel placement: the checksum covers the (q, s, shape) items that
    arrive, so the receiver can verify it."""
    xs = [torch.from_numpy(x) for x in _state_items(2)]
    plan = planner.plan_transfer(basin.checkpoint_basin(), xs[0].nbytes,
                                 stages=("state-stage",), checksum=True,
                                 checksum_placement="accel")
    assert plan.checksum_index == 0
    received = []
    report = UnifiedDataMover(MoverConfig(checksum=True, device="cpu"),
                              plan=plan).bulk_transfer(
        iter(xs), received.append, plan=plan,
        transforms=[("compress", integrity.compress_transform())])
    assert len(received) == len(xs)
    plain = integrity.StreamDigest(True, "accel", backend="ref",
                                   device="cpu")
    plain.add_many(received)
    assert report.checksum == plain.hexdigest()
    assert report.bytes == sum(q.nbytes + s.nbytes for q, s, _ in received)
    back = integrity.decompress_transform().many(received)
    want = sorted(compression.compress_decompress(x).sum().item()
                  for x in xs)
    assert sorted(b.sum().item() for b in back) == want
