"""The port's stream digest and mover against the JAX package's.

The same items go through ``repro.core.integrity.StreamDigest`` and
``repro_torch.core.integrity.StreamDigest`` in both placements; the
hexdigests must be equal (the digest is exact arithmetic, so there is no
tolerance).  On the CPU the port's ``backend="cuda"`` computes the
kernel's plain version, since its panels lie on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core import basin as jbasin
from repro.core import integrity as jintegrity
from repro.core import planner as jplanner
from repro.core.mover import MoverConfig as JMoverConfig
from repro.core.mover import UnifiedDataMover as JMover

from repro_torch.core import basin, integrity, planner
from repro_torch.core.mover import MoverConfig, UnifiedDataMover

torch.set_num_threads(1)


def _items(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
           for n in (0, 1, 3, 1023, 1024, 1025, 5000)]
    out.append(rng.standard_normal((17, 33)).astype(np.float32))
    out.append(rng.integers(-9, 9, (4, 256), dtype=np.int32))
    return out


@pytest.mark.parametrize("placement,jbackend,backend", [
    ("host", "ref", "cuda"),
    ("accel", "ref", "ref"),
    ("accel", "ref", "cuda"),
    ("accel", "pallas", "cuda"),
])
def test_stream_digest_equals_reference(placement, jbackend, backend):
    items = _items()
    want = jintegrity.StreamDigest(True, placement=placement,
                                   backend=jbackend)
    want.add_many(items)
    got = integrity.StreamDigest(True, placement=placement, backend=backend,
                                 device="cpu")
    got.add_many(items)
    assert got.hexdigest() == want.hexdigest()
    assert got.hexdigest().startswith("u32:") == (placement == "accel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
def test_tensor_items_digest_as_their_bytes(dtype):
    """A tensor item is digested from its own memory (on the card, without
    a host copy); its hexdigest equals the reference's on the same bytes."""
    g = torch.Generator().manual_seed(3)
    ts = [(torch.randn(5, 7, 64, generator=g) * 50).to(dtype),
          (torch.randn(3, 300, generator=g) * 50).to(dtype)[:, 1::2]]
    for placement in ("host", "accel"):
        want = jintegrity.StreamDigest(True, placement=placement)
        want.add_many([jintegrity.as_bytes(integrity.as_bytes(t))
                       for t in ts])
        got = integrity.StreamDigest(True, placement=placement,
                                     device="cpu")
        got.add_many(ts)
        assert got.hexdigest() == want.hexdigest()


def test_as_bytes_of_a_tensor_is_its_numpy_bytes():
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6).T
    assert integrity.as_bytes(t) == np.ascontiguousarray(t.numpy()).tobytes()
    b = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    assert integrity.as_bytes(b) == b.view(torch.int16).numpy().tobytes()


def test_digest_is_order_independent():
    items = _items(1)
    a = integrity.StreamDigest(True, placement="accel", device="cpu")
    b = integrity.StreamDigest(True, placement="accel", device="cpu")
    a.add_many(items)
    for it in reversed(items):
        b.add(it)
    assert a.hexdigest() == b.hexdigest()


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        integrity.StreamDigest(True, placement="gpu")
    with pytest.raises(ValueError):
        integrity.StreamDigest(True, placement="accel", backend="pallas")


def test_accel_digest_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = integrity.StreamDigest(True, placement="accel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.add(b"abc")


@pytest.mark.parametrize("placement", ["host", "accel"])
@pytest.mark.parametrize("kind", ["bulk", "streaming"])
def test_mover_checksum_equals_reference_mover(placement, kind):
    """A planned, checksummed transfer through the port's mover delivers
    every item and reports the reference mover's checksum."""
    items = _items(2) * 3
    item_bytes = 4096
    jplan = jplanner.plan_transfer(jbasin.checkpoint_basin(), item_bytes,
                                   stages=("pull", "push"), checksum=True,
                                   checksum_placement=placement)
    plan = planner.plan_transfer(basin.checkpoint_basin(), item_bytes,
                                 stages=("pull", "push"), checksum=True,
                                 checksum_placement=placement)
    want = getattr(JMover(JMoverConfig(checksum=True), plan=jplan),
                   f"{kind}_transfer")(iter(items), lambda x: None, plan=jplan)
    got_items = []
    mover = UnifiedDataMover(MoverConfig(checksum=True, device="cpu"),
                             plan=plan)
    got = getattr(mover, f"{kind}_transfer")(iter(items), got_items.append,
                                             plan=plan)
    assert got.checksum == want.checksum
    assert got.items == len(items) == len(got_items)
    assert sorted(integrity.as_bytes(x) for x in got_items) == \
        sorted(integrity.as_bytes(x) for x in items)


def test_mover_accel_transfer_of_tensors():
    """The serving path stages KV-cache tensors: the accel checksum of the
    tensors equals the plain digest of the bytes that arrived."""
    g = torch.Generator().manual_seed(0)
    cache = torch.randn(4, 2, 37, 3, 16, generator=g).to(torch.bfloat16)
    items = [cache[i] for i in range(cache.shape[0])]
    plan = planner.plan_transfer(basin.checkpoint_basin(), items[0].nbytes,
                                 stages=("kv-stage",), checksum=True,
                                 checksum_placement="accel")
    received = []
    report = UnifiedDataMover(MoverConfig(checksum=True, device="cpu"),
                              plan=plan).bulk_transfer(
        iter(items), lambda t: received.append(t.clone()), plan=plan)
    plain = integrity.StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    assert report.checksum == plain.hexdigest()
    want = jintegrity.StreamDigest(True, "accel")
    want.add_many([integrity.as_bytes(t) for t in items])
    assert report.checksum == want.hexdigest()
