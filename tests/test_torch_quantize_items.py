"""The slab quantizer (``quantize_items`` / ``dequantize_items``) and the
wire transforms' slab hook against the JAX package.

On the CPU the slab wrappers compute their plain versions
(``ref.quantize_items_ref`` / ``ref.dequantize_items_ref``, the per-item
oracles item by item); these tests hold them, item by item and bit for bit,
to the JAX oracle (``repro.optim.compression``), to the Pallas kernels in
interpret mode and to the reference's stage transforms, on seeded numpy
inputs; and they hold the launch tables (``quantize_tables``,
``dequantize_tables``) and the alignment copies (``flat_items``,
``wire_items``) as plain data.  ``tests/test_torch_cuda.py`` holds the
kernels to the plain versions on the card.

There is no tolerance.  As ``tests/test_torch_quantize.py`` sets out, the
Pallas kernel (jitted by XLA) multiplies by f32(1/127) where the oracle and
the port divide by 127, so its scale is equal or one ulp away, and its
codes are exactly the codes of its own scale.
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
from repro_torch.kernels import ops, quantize, ref
from repro_torch.kernels.quantize import (dequantize_int8, dequantize_items,
                                          quantize_int8, quantize_items)

torch.set_num_threads(1)


def _values(n: int, seed: int) -> np.ndarray:
    """Values over six decades of magnitude, both signs; every fifth block
    all zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(
        np.float32)
    x[(np.arange(n) // 256) % 5 == 2] = 0.0
    return x


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly (the low 16 bits cleared), so
    both frameworks convert them without rounding."""
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _cases() -> dict:
    """Named slabs of (numpy values, torch item) pairs: ragged lengths, an
    empty item, mixed sizes, a bf16 item, a non-contiguous view, all-zero
    blocks."""
    def t(a):
        return a, torch.from_numpy(a.copy())

    ragged = [t(_values(n, n)) for n in (1, 255, 257, 2047, 2049, 5000)]
    mixed = [t(_values(4096, 1).reshape(16, 256)), t(np.zeros(0, np.float32)),
             t(_values(3, 2)), t(_values(2048 * 3 + 8, 3).reshape(8, -1))]
    b = _bf16_exact(_values(1800, 4))
    bf16 = [(b, torch.from_numpy(b.copy()).to(torch.bfloat16)),
            t(_values(600, 5))]
    base = _values(40 * 96, 6).reshape(40, 96)
    view = torch.from_numpy(base.copy())[:, ::3]            # (40, 32)
    strided = [(base[:, ::3], view), t(_values(700, 7))]
    zeros = [t(np.zeros(2048 + 300, np.float32)),
             t(np.concatenate([np.zeros(512, np.float32), _values(300, 8)]))]
    return {"ragged": ragged, "mixed": mixed, "bf16": bf16,
            "non-contiguous": strided, "all-zero blocks": zeros}


def _padded_oracle(x: np.ndarray):
    """The JAX oracle's codes and scales padded with zero blocks to the
    wire's multiple of 8 blocks."""
    nb = quantize.item_blocks(x.size)
    if x.size == 0:
        return np.zeros((0, 256), np.int8), np.zeros(0, np.float32)
    jq, js = (np.asarray(a) for a in
              jcompression.quantize_int8_blockwise(jnp.asarray(x)))
    q = np.zeros((nb, 256), np.int8)
    s = np.zeros(nb, np.float32)
    q[:jq.shape[0]], s[:js.shape[0]] = jq, js
    return q, s


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_quantize_items_bit_exact_with_the_oracle_per_item():
    for name, case in _cases().items():
        got = quantize_items([t for _, t in case])
        assert len(got) == len(case), name
        for (x, item), (q, s) in zip(case, got):
            want_q, want_s = _padded_oracle(x.reshape(-1))
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(q.numpy(), want_q, err_msg=name)
            np.testing.assert_array_equal(_bits(s.numpy()), _bits(want_s),
                                          err_msg=name)
            q1, s1 = quantize_int8(item)             # the item alone
            assert torch.equal(q, q1) and torch.equal(s, s1), name


def test_quantize_items_against_the_pallas_kernel():
    for name, case in _cases().items():
        items = [(x, t) for x, t in case if x.size]
        for (x, _), (q, s) in zip(items, quantize_items([t for _, t in
                                                         items])):
            pq, ps = (np.asarray(a) for a in jax_quantize(
                jnp.asarray(np.ascontiguousarray(x)), interpret=True))
            assert pq.shape == tuple(q.shape), name
            s = s.numpy()
            ulps = np.abs(ps.view(np.int32).astype(np.int64)
                          - s.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, name
            same = ulps == 0
            np.testing.assert_array_equal(q.numpy()[same], pq[same],
                                          err_msg=name)


def test_dequantize_items_bit_exact_with_the_jax_package_per_item():
    for name, case in _cases().items():
        wire = [(*quantize_int8(t), tuple(t.shape)) for _, t in case]
        backs = dequantize_items(wire)
        for (q, s, shape), back in zip(wire, backs):
            assert back.dtype == torch.float32 and tuple(back.shape) == shape
            want = jcompression.dequantize_int8_blockwise(
                jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), shape)
            np.testing.assert_array_equal(_bits(back.numpy()),
                                          _bits(want), err_msg=name)
            if q.shape[0]:
                pallas = jax_dequantize(jnp.asarray(q.numpy()),
                                        jnp.asarray(s.numpy()), shape,
                                        interpret=True)
                np.testing.assert_array_equal(_bits(back.numpy()),
                                              _bits(pallas), err_msg=name)
            assert torch.equal(back, dequantize_int8(q, s, shape))


def test_plain_slab_versions_are_the_per_item_refs():
    xs = [torch.from_numpy(_values(n, 11 + n)) for n in (100, 4096, 0, 9)]
    got = ref.quantize_items_ref(xs)
    for x, (q, s) in zip(xs, got):
        rq, rs = ref.quantize_int8_ref(x)
        assert torch.equal(q, rq) and torch.equal(s, rs)
    wire = [(q, s, tuple(x.shape)) for x, (q, s) in zip(xs, got)]
    for (q, s, shape), back in zip(wire, ref.dequantize_items_ref(wire)):
        assert torch.equal(back, ref.dequantize_int8_ref(q, s, shape))


# ---------------------------------------------------------------------------
# the stage transforms' slab hook
# ---------------------------------------------------------------------------


def test_transforms_many_equal_their_per_item_calls():
    for name, case in _cases().items():
        items = [t for _, t in case]
        comp = integrity.compress_transform()
        slab = comp.many(items)
        assert len(slab) == len(items)
        for item, (q, s, shape) in zip(items, slab):
            q1, s1, shape1 = comp(item)
            assert shape == shape1 == tuple(item.shape), name
            assert torch.equal(q, q1) and torch.equal(s, s1), name
        for decomp in (integrity.decompress_transform(),
                       integrity.decompress_transform(device="cpu")):
            backs = decomp.many(slab)
            for wire, back in zip(slab, backs):
                assert torch.equal(back, decomp(wire)), name


def test_transforms_against_the_reference_transforms():
    """The port's transforms against the reference's
    ``compress_transform(interpret=True)`` and ``decompress_transform``:
    each wire item of the port's slab equals the oracle's padded codes bit
    for bit, and the reference kernel's where their scales agree; the
    port's ``.many`` restores the reference's wire items exactly as the
    reference does."""
    jcomp, jdecomp = jintegrity.compress_transform(), \
        jintegrity.decompress_transform()
    for name, case in _cases().items():
        case = [(x, t) for x, t in case if x.size]
        slab = integrity.compress_transform().many([t for _, t in case])
        jwire = [jcomp(np.ascontiguousarray(x)) for x, _ in case]
        for (x, _), (q, s, shape), (jq, js, jshape) in zip(case, slab,
                                                           jwire):
            assert tuple(jshape) == shape, name
            want_q, want_s = _padded_oracle(x.reshape(-1))
            assert np.array_equal(q.numpy(), want_q), name
            assert np.array_equal(_bits(s.numpy()), _bits(want_s)), name
            same = np.asarray(js) == s.numpy()
            np.testing.assert_array_equal(q.numpy()[same],
                                          np.asarray(jq)[same], err_msg=name)
        backs = integrity.decompress_transform(device="cpu").many(
            [(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)),
              tuple(jshape)) for jq, js, jshape in jwire])
        for back, w in zip(backs, jwire):
            np.testing.assert_array_equal(_bits(back.numpy()),
                                          _bits(jdecomp(w)), err_msg=name)


def test_compressed_slab_transfer_goes_through_the_slab_hook(monkeypatch):
    """A batched hop hands the compress transform whole slabs: one
    ``quantize_items`` call per slab, and what arrives equals the per-item
    wire items."""
    calls = []
    real = ops.quantize_items

    def counted(items):
        items = list(items)
        calls.append(len(items))
        return real(items)

    monkeypatch.setattr(ops, "quantize_items", counted)
    xs = [torch.from_numpy(_values(3000, 20 + i)) for i in range(6)]
    plan = planner.plan_transfer(basin.checkpoint_basin(), xs[0].nbytes,
                                 stages=("state-stage",), ordered=True,
                                 batch_items=3)
    assert plan.hops[0].batch_items == 1      # an ordered hop: per item
    plan = planner.plan_transfer(basin.checkpoint_basin(), xs[0].nbytes,
                                 stages=("state-stage",), batch_items=3)
    received = []
    UnifiedDataMover(MoverConfig(device="cpu"), plan=plan).bulk_transfer(
        iter(xs), received.append, plan=plan,
        transforms=[("compress", integrity.compress_transform())])
    assert sum(calls) == len(xs) and max(calls) > 1
    want = [quantize_int8(x) for x in xs]
    assert len(received) == len(xs)
    matched = set()
    for q, s, shape in received:
        assert shape == (3000,)
        hit = [i for i, (wq, ws) in enumerate(want)
               if torch.equal(q, wq) and torch.equal(s, ws)]
        assert len(hit) == 1
        matched.add(hit[0])
    assert matched == set(range(len(xs)))


# ---------------------------------------------------------------------------
# the launch tables and the alignment copies, as plain data
# ---------------------------------------------------------------------------


def _rows(table):
    """A launch table's rows as an ``(n_items, 4)`` int64 array."""
    return np.frombuffer(table.rows, dtype=np.int64).reshape(-1, 4)


def test_quantize_tables_first_rows_and_padding():
    sizes = [1, 0, 2048, 2049, 256 * 9 + 17, 5]
    flats, copied = quantize.flat_items([torch.zeros(n) for n in sizes])
    assert copied == []
    tables, firsts, total = quantize.quantize_tables(flats)
    blocks = [8, 0, 8, 16, 16, 8]
    assert [quantize.item_blocks(n) for n in sizes] == blocks
    assert firsts == [0, 8, 8, 16, 32, 48] and total == 56
    assert len(tables) == 1 and tables[0].first == 0
    rows = _rows(tables[0])
    assert rows.dtype == np.int64 and rows.shape == (len(sizes), 4)
    np.testing.assert_array_equal(rows[:, 1], sizes)
    np.testing.assert_array_equal(rows[:, 2], firsts)
    np.testing.assert_array_equal(rows[:, 3], blocks)
    assert rows[1, 0] == 0                        # an empty item: no address
    assert [int(a) for a in rows[[0, 2], 0]] == [flats[0].data_ptr(),
                                                 flats[2].data_ptr()]
    # padding blocks: the rows past ceil(n / 256) are the item's padding
    pad = [b - -(-n // 256) for n, b in zip(sizes, blocks)]
    assert pad == [7, 0, 0, 7, 6, 7]
    q, s = quantize_int8(torch.from_numpy(_values(2049, 30)))
    assert not q[9:].any() and not s[9:].any() and s[8] > 0


def test_tables_split_at_the_launch_capacity():
    k = 2 * quantize.MAX_ITEMS + 5
    flats = [torch.zeros(300) for _ in range(k)]
    tables, firsts, total = quantize.quantize_tables(flats)
    assert [t.first for t in tables] == [0, quantize.MAX_ITEMS,
                                         2 * quantize.MAX_ITEMS]
    assert [t.n_items for t in tables] == [quantize.MAX_ITEMS] * 2 + [5]
    # the first rows run on across launches: one output for the slab
    assert _rows(tables[1])[0, 2] == 8 * quantize.MAX_ITEMS and total == 8 * k
    wire = [(torch.zeros(8, 256, dtype=torch.int8), torch.zeros(8),
             (300,)) for _ in range(k)]
    dtables, offsets, dtotal = quantize.dequantize_tables(wire)
    assert [t.first for t in dtables] == [t.first for t in tables]
    assert [t.n_items for t in dtables] == [t.n_items for t in tables]
    assert offsets[:3] == [0, 320, 640] and dtotal == 320 * k
    np.testing.assert_array_equal(
        np.concatenate([_rows(t)[:, 3] for t in dtables]), offsets)


def test_dequantize_tables_offsets_and_rows():
    xs = [torch.from_numpy(_values(n, 40 + n)) for n in (1, 64, 65, 0, 300)]
    wire = [(q, s, tuple(x.shape)) for x, (q, s) in
            zip(xs, quantize_items(xs))]
    tables, offsets, total = quantize.dequantize_tables(wire)
    assert offsets == [0, 64, 128, 256, 256] and total == 576
    rows = _rows(tables[0])
    np.testing.assert_array_equal(rows[:, 2], [1, 64, 65, 0, 300])
    np.testing.assert_array_equal(rows[:, 3], offsets)
    for (q, s, _), row in zip(wire, rows):
        if q.numel() and row[2]:
            assert row[0] == q.data_ptr() and row[1] == s.data_ptr()
    assert rows[3, 0] == rows[3, 1] == 0


def test_only_unaligned_items_are_copied():
    base = torch.from_numpy(_values(4100, 50))
    items = [base[1:2049],                  # 4 bytes in: copied
             base[4:2052],                  # 16 bytes in: read where it lies
             base[:4096].reshape(64, 64)[:, ::2],   # a strided view
             base[:1000].to(torch.bfloat16),         # another dtype
             base[3:3]]                     # empty: nothing to copy
    flats, copied = quantize.flat_items(items)
    assert copied == [0]
    assert flats[1].data_ptr() == items[1].data_ptr()
    assert all(f.data_ptr() % 16 == 0 for f in flats if f.numel())
    for f, x in zip(flats, items):
        assert torch.equal(f, x.reshape(-1).float())
    with pytest.raises(ValueError, match="16-byte"):
        quantize.quantize_tables([base[1:2049]])
    # codes that do not start on 16 bytes are copied; scales never are
    raw = torch.zeros(8 * 256 + 1, dtype=torch.int8)
    q = raw[1:].view(8, 256)
    s = torch.ones(8)
    ok = torch.zeros(8, 256, dtype=torch.int8)
    wire, copied = quantize.wire_items([(ok, s, (2000,)), (q, s, (2000,))])
    assert copied == [1] and wire[0][0].data_ptr() == ok.data_ptr()
    assert wire[1][0].data_ptr() % 16 == 0 and torch.equal(wire[1][0], q)
    with pytest.raises(ValueError, match="16-byte"):
        quantize.dequantize_tables([(q, s, (2000,))])


def test_slab_wrappers_refuse_what_the_kernels_do_not_take():
    assert quantize_items([]) == [] and dequantize_items([]) == []
    q, s = quantize_int8(torch.zeros(512))
    with pytest.raises(ValueError, match="fewer than"):
        dequantize_items([(q, s, (4,)), (q, s, (q.numel() + 1,))])
    with pytest.raises(TypeError):
        dequantize_items([(q.to(torch.int16), s, (4,))])
    with pytest.raises(ValueError):
        dequantize_items([(q, s[:-1], (4,))])
    # an item's codes and scales lie on one device; a slab's items on
    # several devices go as one slab a device, in the items' order
    with pytest.raises(ValueError, match="one device"):
        dequantize_items([(q, s.to("meta"), (4,))])
    calls = []

    def twice(xs):
        calls.append(xs)
        return [2 * x for x in xs]

    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert quantize._per_device(twice, [1, 2, 3], [cpu, meta, cpu]) == [2, 4,
                                                                        6]
    assert calls == [[1, 3], [2]]
    # an empty item is a (0, 256) wire item, restored to its empty shape
    (q0, s0), = quantize_items([torch.zeros(0, 3)])
    assert q0.shape == (0, 256) and s0.shape == (0,)
    assert dequantize_items([(q0, s0, (0, 3))])[0].shape == (0, 3)
