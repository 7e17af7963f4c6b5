"""The port's resumable transfers (``repro_torch.core.resume``, the mover's
``resume=`` and ``StreamDigest.absorb_digest``) against the JAX package's,
on the CPU.

The same seeded numpy items go through both packages (as numpy arrays to
the JAX package, as CPU tensors of the same bytes to the port).  Ledger
files, keys and host hexdigests are compared exactly: both hash the same
bytes with SHA-256.
"""

import hashlib

import numpy as np
import pytest
import torch

from repro.core.integrity import StreamDigest as JDigest
from repro.core.integrity import compress_transform as jcompress
from repro.core.mover import MoverConfig as JMoverConfig
from repro.core.mover import UnifiedDataMover as JMover
from repro.core.resume import TransferLedger as JLedger

from repro_torch.core import basin as pbasin
from repro_torch.core.integrity import StreamDigest, compress_transform
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.planner import plan_transfer
from repro_torch.core.resume import TransferLedger

torch.set_num_threads(1)


def _arrays(n: int, size: int = 1024, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(size).astype(np.float32) for _ in range(n)]


def _tensors(arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(a.copy()) for a in arrays]


def _dying(got: list, cut):
    def sink(item):
        if cut is not None and len(got) >= cut:
            raise RuntimeError("power cut")
        got.append(item)
    return sink


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def test_ledger_files_are_byte_equal(tmp_path):
    arrays = _arrays(9)
    arrays.append(arrays[2].copy())                 # a repeated item
    jp, pp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    with JLedger(jp) as jl, TransferLedger(pp) as pl:
        for a, t in zip(arrays, _tensors(arrays)):
            assert pl.record(t) == jl.record(a)
    with open(jp, "rb") as f, open(pp, "rb") as g:
        assert f.read() == g.read()
    j2, p2 = JLedger(jp), TransferLedger(pp)
    assert p2.counts() == j2.counts()
    assert p2.items_recorded == j2.items_recorded == 10
    assert p2.bytes_recorded == j2.bytes_recorded == 10 * 4096


def test_ledger_tolerates_torn_tail_line(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    with TransferLedger(path) as led:
        led.record(b"alpha")
        led.record(b"beta")
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"sha": "dead')                   # mid-write kill
    port, ref = TransferLedger(path), JLedger(path)
    assert port.items_recorded == ref.items_recorded == 2
    assert port.counts() == ref.counts()
    # a fault both packages share: the next record is appended to the
    # torn line (no newline is written first), so the reload drops it
    # too, and a later resume moves that item again
    port.record(b"gamma")
    port.record(b"delta")
    port.close()
    assert TransferLedger(path).counts() == JLedger(path).counts()
    assert TransferLedger(path).items_recorded == 3
    assert TransferLedger.item_key(b"gamma") not in \
        TransferLedger(path).counts()


def test_ledger_is_a_multiset():
    items = [b"dup"] * 3 + [b"solo"]
    outs = []
    for Ledger, Digest in ((TransferLedger, StreamDigest),
                           (JLedger, JDigest)):
        led = Ledger()
        led.record(b"dup")
        led.record(b"dup")
        led.record(b"solo")
        digest = Digest(True)
        out = list(led.skip_verified(iter(items), digest))
        outs.append((out, led.skipped_items, led.skipped_bytes,
                     digest.hexdigest()))
    assert outs[0] == outs[1]
    assert outs[0][:2] == ([b"dup"], 3)


def test_tensor_and_array_keys_agree():
    """A CPU tensor, the numpy array of the same bytes and the JAX
    package's key of that array are one identity; a bf16 tensor keys as
    its raw 2-byte values, a transposed one as its row-major bytes."""
    a = _arrays(1, 96)[0].reshape(8, 12)
    t = torch.from_numpy(a.copy())
    key = JLedger.item_key(a)
    assert TransferLedger.item_key(t) == TransferLedger.item_key(a) == key
    assert TransferLedger.item_key(t.T) == JLedger.item_key(a.T) \
        == hashlib.sha256(np.ascontiguousarray(a.T).tobytes()).hexdigest()
    b = t.to(torch.bfloat16)
    raw = b.view(torch.int16).numpy()
    assert TransferLedger.item_key(b) == JLedger.item_key(raw)


# ---------------------------------------------------------------------------
# absorb_digest
# ---------------------------------------------------------------------------


def test_absorb_digest_matches_rehash():
    arrays = _arrays(7)
    tensors = _tensors(arrays)
    full, jfull = StreamDigest(True), JDigest(True)
    for t, a in zip(tensors, arrays):
        full.add(t)
        jfull.add(a)
    mixed = StreamDigest(True)
    for t in tensors[:3]:
        mixed.absorb_digest(TransferLedger.item_key(t))
    for t in tensors[3:]:
        mixed.add(t)
    assert mixed.hexdigest() == full.hexdigest() == jfull.hexdigest()
    off = StreamDigest(False)
    off.absorb_digest("00" * 32)                    # disabled: a no-op
    assert off.hexdigest() is None


def test_absorb_digest_requires_host_placement():
    d = StreamDigest(True, placement="accel", device="cpu")
    with pytest.raises(ValueError, match="host"):
        d.absorb_digest("00" * 32)


# ---------------------------------------------------------------------------
# resume= through the mover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [1, 11, 29])
def test_resumed_transfer_matches_reference_unbroken(tmp_path, cut):
    """Killed at delivery ``cut`` and resumed through the port's mover:
    the resumed hexdigest equals the JAX package's unbroken host-checksum
    transfer of the same items, each item arrives once over the two runs,
    and a final resume moves nothing."""
    arrays = _arrays(30, 512, seed=cut)
    tensors = _tensors(arrays)
    ref = JMover(JMoverConfig(checksum=True)).bulk_transfer(
        iter(arrays), lambda _: None)

    path = str(tmp_path / "ledger.jsonl")
    got1 = []
    with pytest.raises(RuntimeError, match="power cut"):
        UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
            iter(tensors), _dying(got1, cut), resume=TransferLedger(path))
    assert TransferLedger(path).items_recorded == len(got1) == cut

    led = TransferLedger(path)
    got2 = []
    rep = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(tensors), got2.append, resume=led)
    assert rep.checksum == ref.checksum
    assert led.skipped_items == cut
    assert led.skipped_bytes == cut * 2048
    assert rep.items == 30 - cut
    keys = sorted(TransferLedger.item_key(t) for t in got1 + got2)
    assert keys == sorted(JLedger.item_key(a) for a in arrays)
    led.close()

    final = TransferLedger(path)
    got3 = []
    rep3 = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
        iter(tensors), got3.append, resume=final)
    assert got3 == [] and rep3.items == 0
    assert rep3.checksum == ref.checksum
    assert final.items_recorded == 30


def test_ledger_survives_repeated_kills(tmp_path):
    """Four runs cut at 5, 9 and 6 deliveries and then complete: each
    item is recorded once, in the port as in the reference."""
    arrays = _arrays(24, 256)
    tensors = _tensors(arrays)
    counts = []
    for items, Ledger, Mover, Config in (
            (tensors, TransferLedger, UnifiedDataMover, MoverConfig),
            (arrays, JLedger, JMover, JMoverConfig)):
        path = str(tmp_path / f"{Ledger.__module__}.jsonl")
        delivered = []
        for cut in (5, 9, 6, None):
            got = []
            led = Ledger(path)
            mover = Mover(Config(checksum=False))
            if cut is None:
                mover.bulk_transfer(iter(items), _dying(got, cut),
                                    resume=led)
            else:
                with pytest.raises(RuntimeError):
                    mover.bulk_transfer(iter(items), _dying(got, cut),
                                        resume=led)
            delivered += got
            led.close()
        final = Ledger(path)
        assert final.items_recorded == 24
        assert sorted(Ledger.item_key(x) for x in delivered) == sorted(
            Ledger.item_key(x) for x in items)
        counts.append(final.counts())
    assert counts[0] == counts[1]
    assert set(counts[0].values()) == {1}


def test_resume_rejects_accel_checksum():
    plan = plan_transfer(
        pbasin.DrainageBasin([
            pbasin.Tier("src", pbasin.TierKind.SOURCE, 10 * pbasin.GBPS),
            pbasin.Tier("dst", pbasin.TierKind.SINK, 10 * pbasin.GBPS)],
            [pbasin.Link("src", "dst")]),
        4096, stages=("move",), checksum=True, checksum_placement="accel")
    with pytest.raises(ValueError, match="host"):
        UnifiedDataMover(MoverConfig(checksum=True, device="cpu")
                         ).bulk_transfer(
            iter(_tensors(_arrays(3))), lambda _: None, plan=plan,
            resume=TransferLedger())
    # without a checksum the placement does not matter
    rep = UnifiedDataMover(MoverConfig(checksum=False)).bulk_transfer(
        iter(_tensors(_arrays(3))), lambda _: None, plan=plan,
        resume=TransferLedger())
    assert rep.items == 3


def test_resume_through_a_wire_encoder_skips_nothing(tmp_path):
    """``skip_verified`` keys the source items, but ``recording_sink``
    records what the sink receives: after ``compress_transform`` that is
    the encoded ``(q, scales, shape)`` tuple.  So a resumed compressed
    transfer finds none of its source items in the ledger and moves them
    all again; the reference does the same."""
    arrays = _arrays(6, 512, seed=5)
    outcome = {}
    for which, items, transform, Ledger, Mover, Config in (
            ("port", _tensors(arrays), compress_transform(),
             TransferLedger, UnifiedDataMover, MoverConfig),
            ("ref", arrays, jcompress(interpret=True),
             JLedger, JMover, JMoverConfig)):
        path = str(tmp_path / f"{which}.jsonl")
        got1, got2 = [], []
        with pytest.raises(RuntimeError):
            Mover(Config(checksum=True)).bulk_transfer(
                iter(items), _dying(got1, 3), resume=Ledger(path),
                transforms=[("compress", transform)])
        first = Ledger(path)
        # the records are the encoded items' identities, not the sources'
        assert sorted(first.counts()) == sorted(
            Ledger.item_key(x) for x in got1)
        assert not set(first.counts()) & {Ledger.item_key(x) for x in items}
        led = Ledger(path)
        rep = Mover(Config(checksum=True)).bulk_transfer(
            iter(items), got2.append, resume=led,
            transforms=[("compress", transform)])
        outcome[which] = (len(got1), led.skipped_items, rep.items,
                          Ledger(path).items_recorded)
    assert outcome["port"] == outcome["ref"] == (3, 0, 6, 9)
