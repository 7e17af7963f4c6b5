"""Lattice digest: the wrappers of ``csrc/digest.cu``.

Replaces the Pallas TPU kernel :func:`repro.kernels.digest.block_digest`,
the compute half of accelerator-placed integrity
(:mod:`repro_torch.core.integrity`), in two entry points:

* :func:`block_digest` — one 32-bit digest per 256-word row,
  ``sum_j x_j * (2j+1) * 0x9E3779B1 mod 2^32``: the TPU kernel's exact
  function, bit-exact with :func:`repro_torch.kernels.ref.digest_ref`.
* :func:`digest_items` — whole items to their 64-bit fingerprints, the
  fold of the JAX package's ``StreamDigest._fingerprint`` included, a slab
  of items in one launch, each item's parts read where they lie (no padded
  or concatenated copy), host bytes carried in the launch's parameters;
  bit-exact with :func:`repro_torch.kernels.ref.digest_items_ref`.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor,
and only there, it computes the plain version.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import build, ref

#: uint32 words per digest row (the kernel's row width)
BLOCK = 256
#: bytes per digest row
ROW_BYTES = 4 * BLOCK

# launch table capacities (csrc/digest.cu MAX_ITEMS, MAX_SEGS, MAX_INLINE):
# a slab beyond them is split into more launches
MAX_ITEMS = 256
MAX_SEGS = 768
MAX_INLINE = 4096
#: a run of host bytes up to this size travels inline in the launch; a
#: longer one is copied to the card first
INLINE_PART = 512
#: segments longer than this are cut (the kernel's length is 32-bit)
MAX_SEG_BYTES = 1 << 31

#: one part of an item: a flat uint8 tensor, or host bytes
Part = Union[torch.Tensor, bytes]


def block_digest(panels: torch.Tensor) -> torch.Tensor:
    """uint32 panels (nb, 256) -> one uint32 lattice digest per row.
    Any ``nb`` >= 1 is taken; on the card the panels must be contiguous
    and 16-byte aligned."""
    if panels.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"digest panels are 32-bit words, got {panels.dtype}")
    if panels.ndim != 2 or panels.shape[1] != BLOCK or panels.shape[0] < 1:
        raise ValueError(f"digest panels must be (nb, {BLOCK}), got "
                         f"{tuple(panels.shape)}")
    panels = panels.view(torch.uint32)
    if not panels.is_cuda:
        return ref.digest_ref(panels)
    if not panels.is_contiguous() or panels.data_ptr() % 16:
        raise ValueError("digest panels must be contiguous and 16-byte "
                         "aligned on the card")
    nb = panels.shape[0]
    out = torch.empty((nb,), dtype=torch.uint32, device=panels.device)
    lib = build.library("block_digest")
    with torch.cuda.device(panels.device):
        stream = torch.cuda.current_stream(panels.device).cuda_stream
        err = lib.block_digest_u32(panels.data_ptr(), out.data_ptr(), nb,
                                   stream)
    build.check("block_digest", err)
    build.count_launch("block_digest")
    return out


# ---------------------------------------------------------------------------
# digest_items
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Table:
    """One launch of :func:`digest_items`: items ``first .. first + k - 1``
    of the slab.  ``items`` rows are (first row, bytes, first segment,
    segments); ``segs`` rows are (device address or offset into ``pool``,
    offset in the item, bytes, inline)."""

    first: int
    items: np.ndarray
    segs: np.ndarray
    pool: bytes


def rows_of(n: int) -> int:
    """Digest rows of an ``n``-byte item: ``max(1, ceil(n / 1024))``."""
    return max(1, -(-n // ROW_BYTES))


def aligned_parts(parts: Sequence[Part]) -> bool:
    """Whether every part of an item starts at a byte offset within the
    item that is a multiple of 4: what the kernel takes in place.  An item
    that fails this is copied whole before its launch."""
    off = 0
    for p in parts:
        n = _nbytes(p)
        if n and off % 4:
            return False
        off += n
    return True


def build_tables(items: Sequence[Sequence[Part]]) -> list[Table]:
    """The launch tables of a slab: every non-empty part becomes a segment
    (a tensor at its ``data_ptr``, host bytes in the inline pool; tensors
    longer than 2 GiB in several), and the items go into launches in order,
    a new one whenever the next item would overflow ``MAX_ITEMS``,
    ``MAX_SEGS`` or ``MAX_INLINE``.  Every item must satisfy
    :func:`aligned_parts`, take at most ``MAX_SEGS`` segments and
    ``MAX_INLINE`` inline bytes (:func:`digest_items` sees to that)."""
    tables: list[Table] = []
    rows_i: list[list[int]] = []
    rows_s: list[list[int]] = []
    pool = bytearray()
    first = row = 0

    def close() -> None:
        tables.append(Table(first, np.array(rows_i, dtype=np.int64).reshape(
            -1, 4), np.array(rows_s, dtype=np.int64).reshape(-1, 4),
            bytes(pool)))

    for i, parts in enumerate(items):
        if not aligned_parts(parts):
            raise ValueError(f"item {i} has a part at an offset that is not "
                             "a multiple of 4")
        segs, inline = [], bytearray()
        off = 0
        for p in parts:
            n = _nbytes(p)
            if not n:
                continue
            if isinstance(p, torch.Tensor):
                addr = p.data_ptr()
                for a in range(0, n, MAX_SEG_BYTES):
                    m = min(MAX_SEG_BYTES, n - a)
                    segs.append([addr + a, off + a, m, 0])
            else:
                segs.append([len(inline), off, n, 1])
                inline += p
            off += n
        if len(segs) > MAX_SEGS or len(inline) > MAX_INLINE:
            raise ValueError(f"item {i} needs {len(segs)} segments and "
                             f"{len(inline)} inline bytes; a launch takes "
                             f"{MAX_SEGS} and {MAX_INLINE}")
        if rows_i and (len(rows_i) == MAX_ITEMS
                       or len(rows_s) + len(segs) > MAX_SEGS
                       or len(pool) + len(inline) > MAX_INLINE):
            close()
            rows_i, rows_s, pool = [], [], bytearray()
            first, row = i, 0
        for s in segs:
            if s[3]:
                s[0] += len(pool)
        rows_i.append([row, off, len(rows_s), len(segs)])
        rows_s.extend(segs)
        pool += inline
        row += rows_of(off)
    if rows_i:
        close()
    return tables


def _nbytes(p: Part) -> int:
    return p.numel() if isinstance(p, torch.Tensor) else len(p)


def _check_part(p: Part) -> None:
    if isinstance(p, torch.Tensor):
        if p.dtype != torch.uint8 or p.ndim != 1:
            raise TypeError("a digest part is a 1-D uint8 tensor or bytes, "
                            f"got {p.dtype} {tuple(p.shape)}")
        if p.numel() and not p.is_contiguous():
            raise ValueError("a digest part must be contiguous")
    elif not isinstance(p, bytes):
        raise TypeError(f"a digest part is a 1-D uint8 tensor or bytes, "
                        f"got {type(p).__name__}")


_copy_lock = threading.Lock()
#: items :func:`digest_items` copied whole on the card before the launch
#: (a part at an item offset that is not a multiple of 4, or more segments
#: or inline bytes than one launch takes)
copies = 0


def _count_copy() -> None:
    global copies
    with _copy_lock:
        copies += 1


def _card_parts(parts: list[Part], dev: torch.device) -> list[Part]:
    """An item's parts as the kernel takes them: runs of host bytes joined,
    and copied to the card when longer than ``INLINE_PART``; the whole
    item copied into one tensor on the card when it is not aligned or
    needs more than one launch can carry."""
    out: list[Part] = []
    for p in parts:
        if isinstance(p, bytes) and out and isinstance(out[-1], bytes):
            out[-1] += p
        elif _nbytes(p):
            out.append(p)
    out = [_to_card(p, dev) if isinstance(p, bytes) and len(p) > INLINE_PART
           else p for p in out]
    inline = sum(len(p) for p in out if isinstance(p, bytes))
    if (aligned_parts(out) and len(out) <= MAX_SEGS // 2
            and inline <= MAX_INLINE // 4):
        return out
    _count_copy()
    return [torch.cat([p if isinstance(p, torch.Tensor) else _to_card(p, dev)
                       for p in out])]


def _to_card(b: bytes, dev: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)


_ws_lock = threading.Lock()
#: (device index, stream handle) -> that stream's workspace
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """The stream's workspace for the kernel: zeroed once, and left zero by
    every launch (its last CTA clears it).  Launches on one stream run one
    after another, so they may share it."""
    key = (dev.index, stream.cuda_stream)
    with _ws_lock:
        ws = _workspaces.get(key)
        if ws is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "digest_items: launch once on this stream before "
                    "capturing it in a CUDA graph (its workspace is zeroed "
                    "at first use)")
            words = build.library("digest_items").digest_items_ws_words()
            ws = torch.zeros(words, dtype=torch.int64, device=dev)
            _workspaces[key] = ws
        return ws


def digest_items(items: Sequence[Sequence[Part]], *,
                 device: Optional[torch.device | str] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Items -> one 64-bit lattice fingerprint each, as uint64 ``(k,)`` on
    ``device``.

    An item is a sequence of parts whose bytes, in order, are the item: a
    contiguous 1-D uint8 tensor (any ``data_ptr``) or host ``bytes``.
    ``device`` defaults to the tensors' device; items of host bytes alone
    need it.  ``out`` (uint64 or int64, ``(k,)``, contiguous, on
    ``device``) receives the fingerprints.  On the card the whole slab goes
    in one launch per ``MAX_ITEMS`` items, with nothing copied except an
    item that :func:`aligned_parts` refuses (one copy of that item,
    counted in :data:`copies`) and a run of host bytes longer than
    ``INLINE_PART``."""
    items = [list(parts) for parts in items]
    devs = set()
    for parts in items:
        for p in parts:
            _check_part(p)
            if isinstance(p, torch.Tensor):
                devs.add(p.device)
    if device is not None:
        devs.add(torch.device(device))
    devs = {torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs}
    if len(devs) != 1:
        raise ValueError(f"digest_items needs its parts on one device and "
                         f"is given {sorted(map(str, devs)) or 'none'}")
    dev = devs.pop()
    k = len(items)
    if out is not None:
        if (out.dtype not in (torch.uint64, torch.int64) or out.shape != (k,)
                or not out.is_contiguous() or out.device != dev):
            raise ValueError(f"out must be a contiguous ({k},) uint64 tensor "
                             f"on {dev}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
    if dev.type != "cuda":
        fps = ref.digest_items_ref(items, device=dev)
        if out is None:
            return fps
        return out.copy_(fps.view(out.dtype))
    if out is None:
        out = torch.empty((k,), dtype=torch.uint64, device=dev)
    if not k:
        return out
    tables = build_tables([_card_parts(parts, dev) for parts in items])
    lib = build.library("digest_items")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ws = _workspace(dev, stream)
        for t in tables:
            err = lib.digest_items(
                t.items.ctypes.data, len(t.items), t.segs.ctypes.data,
                len(t.segs), t.pool, len(t.pool),
                out.data_ptr() + 8 * t.first, ws.data_ptr(),
                stream.cuda_stream)
            build.check("digest_items", err)
            build.count_launch("digest_items")
    return out
