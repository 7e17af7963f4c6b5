"""Whole-item lattice fingerprints (``kernels.digest.digest_items``) and the
accel stream digest built on them, against the JAX package's.

The same items go through ``repro.core.integrity.StreamDigest`` (its plain
backend and its Pallas kernel in interpret mode) and through the port's
``digest_items_ref``, ``digest_items`` and ``StreamDigest``; fingerprints
and hexdigests must be equal, bit for bit (the digest is exact arithmetic,
so there is no tolerance).  On the CPU ``digest_items`` computes its plain
version, since its parts lie on the CPU.  The launch tables the card path
builds are checked as plain data.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import integrity as jintegrity

from repro_torch.core import basin, integrity, planner
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.kernels import build, digest, ref

torch.set_num_threads(1)

KV_BYTES = 412_160   # one smollm-360m KV item: 4 x 161 x 5 x 64 x 2 x bf16


def _storage(seed: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8))


def _wire_item(seed: int):
    """A compressed state item at smoke width, as the int8 wire makes it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 8, 16, 16, generator=g) * 3.0
    return integrity.compress_transform()(x)


def _items(seed: int = 0) -> list:
    """Items of every shape a digest is given: byte strings around a row's
    edges, a KV item, wire tuples, uint8 views 1-3 bytes into their
    storage, and a tuple whose second part sits at an item offset that is
    not a multiple of 4."""
    rng = np.random.default_rng(seed)
    out = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
           for n in (0, 1, 3, 1023, 1024, 1025, 5000)]
    out.append(_storage(seed + 1, KV_BYTES))
    out += [_wire_item(seed + 2), _wire_item(seed + 3)]
    base = _storage(seed + 4, 9000)
    out += [base[off:off + 4099] for off in (1, 2, 3)]
    out.append((base[8:15], base[100:1300]))
    return out


def _jax_item(item):
    """The same item for the JAX package: its bytes, or for a wire tuple
    numpy codes and scales beside the shape (whose bytes are equal)."""
    if isinstance(item, tuple) and len(item) == 3 and isinstance(item[2],
                                                                tuple):
        return item[0].numpy(), item[1].numpy(), item[2]
    return integrity.as_bytes(item)


@pytest.mark.parametrize("jbackend", ["ref", "pallas"])
def test_item_fingerprints_equal_reference(jbackend):
    """Item by item, the port's fingerprints (plain ``digest_items_ref``,
    and ``digest_items`` through the stream digest) are the JAX package's."""
    items = _items()
    want = []
    for item in items:
        d = jintegrity.StreamDigest(True, "accel", backend=jbackend)
        d.add(_jax_item(item))
        want.append(int(d.hexdigest()[4:], 16))
    parts = [integrity._parts(it, torch.device("cpu")) for it in items]
    plain = ref.digest_items_ref(parts).view(torch.int64).numpy()
    assert [int(v) for v in plain.view(np.uint64)] == want
    kern = digest.digest_items(parts).view(torch.int64).numpy()
    assert [int(v) for v in kern.view(np.uint64)] == want


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("jbackend", ["ref", "pallas"])
def test_stream_digest_of_every_item_shape_equals_reference(backend,
                                                            jbackend):
    items = _items(5)
    want = jintegrity.StreamDigest(True, "accel", backend=jbackend)
    want.add_many([_jax_item(it) for it in items])
    got = integrity.StreamDigest(True, "accel", backend=backend,
                                 device="cpu")
    got.add_many(items)
    assert got.hexdigest() == want.hexdigest()


def _fold_ways(items):
    one = integrity.StreamDigest(True, "accel", device="cpu")
    for it in items:
        one.add(it)
    slabs = integrity.StreamDigest(True, "accel", device="cpu")
    for i in range(0, len(items), 4):
        slabs.add_many(items[i:i + 4])
    mixed = integrity.StreamDigest(True, "accel", device="cpu")
    mixed.add_many(items[:5])
    for it in items[5:9]:
        mixed(it)
    mixed.many(items[9:])
    threads = integrity.StreamDigest(True, "accel", device="cpu")
    work = [items[i::4] for i in range(4)]
    ts = [threading.Thread(target=threads.add_many, args=(w,)) for w in work]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return {"add": one, "add_many": slabs, "mixed": mixed, "threads": threads}


def test_every_way_of_folding_gives_one_hexdigest():
    items = _items(7)
    want = jintegrity.StreamDigest(True, "accel")
    want.add_many([_jax_item(it) for it in items])
    ways = _fold_ways(items)
    for name, d in ways.items():
        first = d.hexdigest()
        assert first == want.hexdigest(), name
        assert d.hexdigest() == first, name
    assert ways["add"].folds == len(items)
    assert ways["add_many"].folds == -(-len(items) // 4)
    assert ways["threads"].folds == 4


def test_folding_after_a_hexdigest_continues_the_stream():
    items = _items(8)
    d = integrity.StreamDigest(True, "accel", device="cpu")
    d.add_many(items[:6])
    d.hexdigest()
    d.add_many(items[6:])
    whole = integrity.StreamDigest(True, "accel", device="cpu")
    whole.add_many(items)
    assert d.hexdigest() == whole.hexdigest()


def test_cpu_parts_never_touch_the_kernel():
    before = build.launch_counts()
    digest.digest_items([[b"abc"], [_storage(0, 64)]], device="cpu")
    assert build.launch_counts() == before


# -- the launch tables ---------------------------------------------------------


def test_table_rows_segments_and_inline_bytes():
    a, b = _storage(1, 3000), _storage(2, 2048)
    items = [[a], [b[:2048], b"46464128"], [], [b"xyz"]]
    (t,) = digest.build_tables(items)
    assert t.first == 0
    # (first row, bytes, first segment, segments) per item
    assert t.items.tolist() == [[0, 3000, 0, 1], [3, 2056, 1, 2],
                                [6, 0, 3, 0], [7, 3, 3, 1]]
    assert sum(digest.rows_of(int(n)) for n in t.items[:, 1]) == 8
    # (address or pool offset, offset in the item, bytes, inline)
    assert t.segs.tolist() == [[a.data_ptr(), 0, 3000, 0],
                               [b.data_ptr(), 0, 2048, 0],
                               [0, 2048, 8, 1],
                               [8, 0, 3, 1]]
    assert t.pool == b"46464128xyz"


def test_tables_split_at_the_launch_capacity():
    s = _storage(3, 4096)
    items = [[s[:16]] for _ in range(digest.MAX_ITEMS + 44)]
    tables = digest.build_tables(items)
    assert [t.first for t in tables] == [0, digest.MAX_ITEMS]
    assert [len(t.items) for t in tables] == [digest.MAX_ITEMS, 44]
    assert tables[1].items[0, 0] == 0          # each launch's rows from 0
    inline = [[bytes(400)] for _ in range(12)]
    tables = digest.build_tables(inline)
    assert all(len(t.pool) <= digest.MAX_INLINE for t in tables)
    assert sum(len(t.items) for t in tables) == 12 and len(tables) == 2


def test_alignment_decision():
    s = _storage(4, 64)
    assert digest.aligned_parts([s[1:9], s[20:23]])       # starts 0 and 8
    assert digest.aligned_parts([s[:5]])                 # ragged end only
    assert not digest.aligned_parts([s[:5], s[8:12]])    # part at offset 5
    assert not digest.aligned_parts([b"abc", s[:4]])     # part at offset 3
    assert digest.aligned_parts([b"", s[:4]])            # empty parts count 0
    with pytest.raises(ValueError, match="multiple of 4"):
        digest.build_tables([[s[:5], s[8:12]]])


def test_card_parts_copy_only_an_unaligned_item():
    s = _storage(5, 4096)
    cpu = torch.device("cpu")
    before = digest.copies
    kept = digest._card_parts([s[1:1001], b"ab", b"cd"], cpu)
    assert digest.copies == before
    assert kept[0].data_ptr() == s[1:].data_ptr() and kept[1] == b"abcd"
    long = digest._card_parts([s[:8], bytes(range(256)) * 3], cpu)
    assert isinstance(long[1], torch.Tensor) and long[1].numel() == 768
    (copy,) = digest._card_parts([s[:7], s[100:200]], cpu)
    assert digest.copies == before + 1
    assert integrity.as_bytes(copy) == integrity.as_bytes(
        torch.cat([s[:7], s[100:200]]))


def test_digest_items_refuses_what_the_kernel_does_not_take():
    s = _storage(6, 64)
    with pytest.raises(TypeError, match="uint8"):
        digest.digest_items([[s.view(torch.int32)]])
    with pytest.raises(TypeError, match="bytes"):
        digest.digest_items([["abc"]], device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        digest.digest_items([[s[::2]]])
    with pytest.raises(ValueError, match="one device"):
        digest.digest_items([[b"abc"]])
    with pytest.raises(ValueError, match="out must be"):
        digest.digest_items([[s]], out=torch.empty(2, dtype=torch.uint64))


# -- the mover's count of folds ------------------------------------------------


@pytest.mark.parametrize("batch", [None, 4])
def test_transfer_reports_one_fold_per_item_or_slab(batch):
    items = [_storage(i, KV_BYTES // 8) for i in range(10)]
    plan = planner.plan_transfer(basin.checkpoint_basin(), items[0].nbytes,
                                 stages=("kv-stage",), checksum=True,
                                 checksum_placement="accel",
                                 batch_items=batch)
    received = []
    report = UnifiedDataMover(MoverConfig(checksum=True, device="cpu"),
                              plan=plan).bulk_transfer(
        iter(items), received.append, plan=plan)
    plain = integrity.StreamDigest(True, "accel", backend="ref",
                                   device="cpu")
    plain.add_many(received)
    assert report.checksum == plain.hexdigest()
    if batch is None:
        assert report.checksum_folds == len(items)
    else:
        assert 1 <= report.checksum_folds <= len(items)
