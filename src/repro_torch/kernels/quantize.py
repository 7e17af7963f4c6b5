"""Blockwise int8 quantize / dequantize: the wrappers of ``csrc/quantize.cu``.

Replace the Pallas TPU kernels :func:`repro.kernels.quantize.quantize_int8`
and :func:`repro.kernels.quantize.dequantize_int8`: symmetric int8 per
256-value block with an f32 scale, ``scale = max|x| / 127`` and
``q = clip(round_half_even(x / scale), -127, 127)``, bit-exact with the
oracle :func:`repro_torch.optim.compression.quantize_int8_blockwise`.  As
the TPU kernel does, each item is flattened to f32 and zero-padded to a
multiple of ``BLOCK * TILE`` values, so the codes on the wire have the JAX
kernel's shape; the padding blocks are q 0, scale 0.

* :func:`quantize_items` / :func:`dequantize_items` take a whole slab of
  items, one launch per ``MAX_ITEMS`` items, each item read where it lies;
  the launch tables come from :func:`quantize_tables` and
  :func:`dequantize_tables`, plain Python.
* :func:`quantize_int8` / :func:`dequantize_int8` are slabs of one.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors,
and only there, they compute the plain versions
(:func:`repro_torch.kernels.ref.quantize_items_ref` /
:func:`~repro_torch.kernels.ref.dequantize_items_ref`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Sequence

import torch

from . import build, ref

#: values per block (one f32 scale each)
BLOCK = 256
#: blocks per TPU grid step: each item pads to BLOCK * TILE values
TILE = 8
#: items a launch takes (``csrc/quantize.cu`` MAX_ITEMS); a longer slab is
#: split into more launches
MAX_ITEMS = 256
#: a dequantized item starts on a multiple of this many values (256 bytes)
#: of the slab's output
OUT_ALIGN = 64

#: one wire item: int8 codes (nb, 256), f32 scales (nb,), the item's shape
Wire = tuple[torch.Tensor, torch.Tensor, tuple[int, ...]]


@dataclasses.dataclass
class Table:
    """One launch: items ``first .. first + n_items - 1`` of the slab, as
    the kernel reads them: ``rows`` holds 4 int64 an item, quantize rows
    (values address, values, first row, rows), dequantize rows (codes
    address, scales address, values, first value of the output)."""

    first: int
    n_items: int
    rows: ctypes.Array
    #: the items' values together (a table of only empty items launches
    #: nothing)
    values: int


def item_blocks(n: int) -> int:
    """Blocks of an ``n``-value item on the wire: ``ceil(n / 2048) * 8``."""
    return -(-n // (BLOCK * TILE)) * TILE


def _split(rows: list[int], values: list[int]) -> list[Table]:
    """Flat rows (4 an item) in launches of ``MAX_ITEMS`` items."""
    return [Table(i, len(part) // 4, (ctypes.c_longlong * len(part))(*part),
                  sum(values[i:i + MAX_ITEMS]))
            for i in range(0, len(values), MAX_ITEMS)
            for part in (rows[4 * i:4 * (i + MAX_ITEMS)],)]


def quantize_tables(flats: Sequence[torch.Tensor]
                    ) -> tuple[list[Table], list[int], int]:
    """The launch tables of a slab of flat f32 items, each contiguous and
    16-byte aligned (:func:`flat_items` sees to that): the tables, each
    item's first row in the slab's output, and the output's rows."""
    rows, values, firsts, row = [], [], [], 0
    for i, f in enumerate(flats):
        n = f.numel()
        addr = f.data_ptr() if n else 0
        if f.dtype != torch.float32 or f.ndim != 1 or addr % 16 or (
                n and not f.is_contiguous()):
            raise ValueError(f"item {i} is not a contiguous, 16-byte "
                             "aligned flat f32 tensor")
        nb = item_blocks(n)
        rows += (addr, n, row, nb)
        values.append(n)
        firsts.append(row)
        row += nb
    return _split(rows, values), firsts, row


def dequantize_tables(items: Sequence[Wire]
                      ) -> tuple[list[Table], list[int], int]:
    """The launch tables of a slab of wire items whose codes are contiguous
    and 16-byte aligned and whose scales are contiguous
    (:func:`wire_items` sees to that): the tables, each item's first value
    in the slab's f32 output (a multiple of ``OUT_ALIGN``), and the
    output's length."""
    rows, values, offsets, off = [], [], [], 0
    for i, (q, s, shape) in enumerate(items):
        n = math.prod(shape)
        if n and (not q.is_contiguous() or q.data_ptr() % 16
                  or not s.is_contiguous()):
            raise ValueError(f"item {i}'s codes are not contiguous and "
                             "16-byte aligned, or its scales not contiguous")
        rows += (q.data_ptr() if n else 0, s.data_ptr() if n else 0, n, off)
        values.append(n)
        offsets.append(off)
        off += -(-n // OUT_ALIGN) * OUT_ALIGN
    return _split(rows, values), offsets, off


_copy_lock = threading.Lock()
#: items the wrappers copied on the card before a launch because their
#: address was not 16-byte aligned
copies = 0


def _count_copies(k: int) -> None:
    global copies
    if k:
        with _copy_lock:
            copies += k


def flat_items(items: Sequence[torch.Tensor]
               ) -> tuple[list[torch.Tensor], list[int]]:
    """Each item as the quantize kernel reads it: flat f32, contiguous
    (a copy of a non-contiguous view or of another dtype, as ``reshape``
    and ``float`` make them), and 16-byte aligned (a copy of one that is
    not).  Returns the flats and the indices of the items copied for
    alignment."""
    flats, copied = [], []
    for i, x in enumerate(items):
        f = x.reshape(-1).float()
        if f.data_ptr() % 16 and f.numel():
            f = f.clone()
            copied.append(i)
        flats.append(f)
    return flats, copied


def wire_items(items: Sequence[Wire]) -> tuple[list[Wire], list[int]]:
    """Each wire item as the dequantize kernel reads it: contiguous codes
    at a 16-byte aligned address (a copy of codes that are not) and
    contiguous scales.  Returns the items and the indices of those whose
    codes were copied for alignment."""
    out, copied = [], []
    for i, (q, s, shape) in enumerate(items):
        q, s = q.contiguous(), s.contiguous()
        if q.data_ptr() % 16 and q.numel():
            q = q.clone()
            copied.append(i)
        out.append((q, s, shape))
    return out, copied


def _per_device(fn, items: list, devices: list[torch.device]) -> list:
    """``fn`` of each device's items as one slab, back in the items' order."""
    out: list = [None] * len(items)
    for dev in dict.fromkeys(devices):
        idx = [i for i, d in enumerate(devices) if d == dev]
        for i, r in zip(idx, fn([items[i] for i in idx])):
            out[i] = r
    return out


def _check_wire(q: torch.Tensor, s: torch.Tensor, n: int, shape) -> None:
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize takes int8 codes and f32 scales, got "
                        f"{q.dtype} and {s.dtype}")
    if q.ndim != 2 or q.shape[1] != BLOCK or tuple(s.shape) != (q.shape[0],):
        raise ValueError(f"codes {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} are not (nb, {BLOCK}) and (nb,)")
    if n > q.numel():
        raise ValueError(f"{q.shape[0]} blocks hold {q.numel()} values, "
                         f"fewer than {shape} needs")


def quantize_items(items: Sequence[torch.Tensor]
                   ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Items (any shapes, float dtypes) -> one ``(q int8 (nb, 256), scales
    f32 (nb,))`` each, ``nb = item_blocks(numel)``, equal bit for bit to
    :func:`quantize_int8` of the item alone.  The items of each device form
    one slab.  On the card a slab is one launch per ``MAX_ITEMS`` items,
    and its items' codes and scales are row views of one int8 and one f32
    output: a caller that keeps one item past the others keeps the whole
    slab's memory (``.clone()`` it to keep it alone)."""
    items = list(items)
    if not items:
        return []
    dev = items[0].device
    if len(items) > 1 and any(x.device != dev for x in items):
        return _per_device(quantize_items, items,
                           [x.device for x in items])
    if dev.type != "cuda":
        return ref.quantize_items_ref(items, block=BLOCK, tile=TILE)
    flats, copied = flat_items(items)
    _count_copies(len(copied))
    tables, firsts, total = quantize_tables(flats)
    q = torch.empty((total, BLOCK), dtype=torch.int8, device=dev)
    s = torch.empty((total,), dtype=torch.float32, device=dev)
    if total:                                     # not only empty items
        lib = build.library("quantize_int8")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for t in tables:
                if not t.values:
                    continue                      # only empty items
                err = lib.quantize_items(t.rows, t.n_items,
                                         q.data_ptr(), s.data_ptr(), stream)
                build.check("quantize_int8", err)
                build.count_launch("quantize_int8")
    if len(items) == 1:
        return [(q, s)]
    return [(q[f:e], s[f:e]) for f, e in zip(firsts, firsts[1:] + [total])]


def dequantize_items(items: Sequence[Wire]) -> list[torch.Tensor]:
    """Wire items ``(q, scales, shape)`` -> one f32 tensor of ``shape``
    each, equal bit for bit to :func:`dequantize_int8` of the item alone.
    An item's codes and scales lie on one device; the items of each device
    form one slab.  On the card a slab is one launch per ``MAX_ITEMS``
    items, and its values are views of one f32 output: a caller that keeps
    one item past the others keeps the whole slab's memory."""
    items = [(q, s, tuple(int(d) for d in shape)) for q, s, shape in items]
    if not items:
        return []
    devices = []
    for q, s, shape in items:
        _check_wire(q, s, math.prod(shape), shape)
        if s.device != q.device:
            raise ValueError(f"codes on {q.device} and scales on "
                             f"{s.device}: an item's codes and scales must "
                             "lie on one device")
        devices.append(q.device)
    if len(devices) > 1 and any(d != devices[0] for d in devices):
        return _per_device(dequantize_items, items, devices)
    dev = devices[0]
    if dev.type != "cuda":
        return ref.dequantize_items_ref(items)
    items, copied = wire_items(items)
    _count_copies(len(copied))
    tables, offsets, total = dequantize_tables(items)
    if len(items) == 1:      # a slab of one: its output is the item
        out = torch.empty(items[0][2], dtype=torch.float32, device=dev)
    else:
        out = torch.empty((total,), dtype=torch.float32, device=dev)
    if total:                                     # not only empty items
        lib = build.library("dequantize_int8")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for t in tables:
                if not t.values:
                    continue                      # only empty items
                err = lib.dequantize_items(t.rows, t.n_items,
                                           out.data_ptr(), stream)
                build.check("dequantize_int8", err)
                build.count_launch("dequantize_int8")
    if len(items) == 1:
        return [out]
    return [out[o:o + math.prod(shape)].view(shape)
            for o, (_, _, shape) in zip(offsets, items)]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 (nb, 256), scales f32 (nb,)), nb a
    multiple of 8 covering the flat f32 values: a slab of one."""
    return quantize_items([x])[0]


def dequantize_int8(q: torch.Tensor, s: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    """q int8 (nb, 256) and scales f32 (nb,) -> f32 of ``shape``: a slab of
    one."""
    return dequantize_items([(q, s, shape)])[0]
