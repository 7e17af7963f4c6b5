"""Stream integrity — the §3.4 compute budget, placeable on host or card.

The paper's §3.4 point is that integrity/encryption are *budgeted compute
inside the data path*; a host-side hash pins an otherwise line-rate hop at
the CPU's hash throughput.  This module is the placement seam:

* :class:`StreamDigest` with ``placement="host"`` is the order-independent
  stream checksum — XOR of per-item SHA-256 digests, bit-identical in
  format and value with the JAX package's.
* ``placement="accel"`` computes per-item fingerprints with the lattice
  digest (:mod:`repro_torch.kernels.digest`): item bytes are viewed as
  uint32 words in rows of 256, each row reduced to a 32-bit digest, and the
  row digests folded into a 64-bit fingerprint whose XOR over the stream is
  the checksum, ``u32:%016x``.  ``backend="cuda"`` runs the hand-written
  kernel on the card (its plain version when the digest is placed on the
  CPU); ``backend="ref"`` runs the plain version, when asked.  Both give
  the same hexdigest, equal to the JAX package's on the same bytes.  An item
  that is already a tensor on the card, or a tuple or list holding tensors
  there (a compressed item ``(q, scales, shape)``), is digested where it
  lies, with no copy: :func:`~repro_torch.kernels.digest.digest_items`
  reads each part in place, and a few host bytes (the shape) ride in the
  launch.  On the card ``add`` is one launch per item and ``add_many`` one
  per slab; the fingerprints stay on the card until :meth:`hexdigest`
  reads them, so folding never waits on the card.

Both placements are order-independent (concurrent staging workers deliver
out of order) and batch-aware: :meth:`StreamDigest.add_many` folds a whole
slab under one lock acquisition, and the object itself is a batch-capable
stage transform (``__call__`` per item, ``.many`` per slab).

The two placements produce *different* checksum formats on purpose (64 hex
chars vs ``u32:`` + 16): a host digest and an accel digest are not
comparable, so equivalence gates always compare like with like.

Wire compression rides the same seam: :func:`compress_transform` /
:func:`decompress_transform` wrap the blockwise-int8 kernels
(:mod:`repro_torch.kernels.quantize`; oracle
:mod:`repro_torch.optim.compression`) as batch-capable stage transforms for
float-tensor item streams: about 4x fewer bytes on the wire for one pass
on the card.  A compressed item is ``(q int8 (nb, 256), scales f32 (nb,),
shape)``, as in the JAX package.  The compress transform is marked as a
wire encoder, so a checksummed transfer digests what it puts on the wire
(see :meth:`repro_torch.core.mover.UnifiedDataMover.bulk_transfer`).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

def as_bytes(item: Any) -> bytes:
    """Stable byte view of an item for integrity hashing."""
    if isinstance(item, (bytes, bytearray)):
        return bytes(item)
    if isinstance(item, memoryview):
        return item.tobytes()
    if isinstance(item, torch.Tensor):
        return _tensor_bytes(item).cpu().numpy().tobytes()
    tobytes = getattr(item, "tobytes", None)
    if tobytes is not None:
        return tobytes()
    if isinstance(item, (tuple, list)):
        return b"".join(as_bytes(e) for e in item)
    if isinstance(item, dict):
        return b"".join(as_bytes(item[k]) for k in sorted(item))
    return repr(item).encode()


def _tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes in memory order (row-major, little-endian), as a
    flat uint8 tensor on the tensor's own device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _holds_tensor(item: Any) -> bool:
    return isinstance(item, (tuple, list)) and any(
        isinstance(e, torch.Tensor) or _holds_tensor(e) for e in item)


def _parts(item: Any, dev: torch.device) -> list:
    """The bytes :func:`as_bytes` gives ``item``, as digest parts (see
    :func:`repro_torch.kernels.digest.digest_items`): each tensor its own
    memory as a flat uint8 view on ``dev`` (moved there if it lies
    elsewhere), tuples and lists their parts in order, anything else (a
    shape tuple of ints) the host bytes ``as_bytes`` makes of it."""
    if isinstance(item, torch.Tensor):
        return [_tensor_bytes(item).to(dev)]
    if _holds_tensor(item):
        return [p for e in item for p in _parts(e, dev)]
    return [as_bytes(item)]


def _xor(fps: torch.Tensor) -> int:
    """XOR of uint64 fingerprints (read on the host)."""
    v = fps.view(torch.int64).cpu().numpy().view(np.uint64)
    return int(np.bitwise_xor.reduce(v)) if v.size else 0


#: fingerprints per device buffer of the card path
_CHUNK = 1024


class StreamDigest:
    """Order-independent integrity over an item stream.

    ``placement="host"``: XOR of per-item SHA-256 digests (commutative +
    associative), shared by the staged, parallel-branch, and direct paths
    so their checksums stay comparable.  ``placement="accel"``: XOR of
    per-item 64-bit lattice fingerprints computed on ``device`` (``None``:
    the card, which must be present) by the digest kernel
    (``backend="cuda"``) or its plain version (``backend="ref"``).

    Thread-safe; a disabled instance is a no-op.  Usable directly as a
    stage transform: calling it (or :meth:`add`) folds one item and
    returns it; :meth:`many` folds a slab under one lock acquisition and
    returns it — the batch hook the slab worker loop discovers."""

    def __init__(self, enabled: bool, placement: str = "host",
                 backend: str = "cuda",
                 device: Optional[torch.device | str] = None):
        if placement not in ("host", "accel"):
            raise ValueError(
                f"placement must be 'host' or 'accel', got {placement!r}")
        if backend not in ("ref", "cuda"):
            raise ValueError(
                f"backend must be 'ref' or 'cuda', got {backend!r}")
        self.placement = placement
        self._backend = backend
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._enabled = bool(enabled)
        self._acc = 0 if enabled else None
        self._lock = threading.Lock()
        #: folds made (one per ``add`` and per ``add_many``): on the card,
        #: one digest launch each
        self.folds = 0
        # the card path's fingerprints not yet read: [buffer, used] pairs,
        # and the streams their launches went on
        self._chunks: list[list] = []
        self._streams: dict[int, torch.cuda.Stream] = {}

    # -- accel fingerprinting -------------------------------------------------

    def _digest_device(self) -> torch.device:
        if self._device is None:
            # resolved on first accel use: the host placement never needs
            # a card
            from ..device import resolve_device
            self._device = resolve_device(self._device_arg)
        return self._device

    def _fold_host(self, items: Sequence[Any]) -> int:
        acc = 0
        for it in items:
            acc ^= int.from_bytes(hashlib.sha256(as_bytes(it)).digest(),
                                  "little")
        return acc

    def _fold(self, items: Sequence[Any]) -> None:
        if self.placement == "host":
            fold = self._fold_host(items)
        else:
            from ..kernels.digest import digest_items
            from ..kernels.ref import digest_items_ref
            dev = self._digest_device()
            parts = [_parts(it, dev) for it in items]
            if self._backend == "cuda" and dev.type == "cuda":
                self._fold_card(parts, dev)
                return
            fn = digest_items if self._backend == "cuda" else digest_items_ref
            fold = _xor(fn(parts, device=dev))
        with self._lock:
            self._acc ^= fold
            self.folds += 1

    def _fold_card(self, parts: list, dev: torch.device) -> None:
        """One launch for the slab (more only past a launch's table), its
        fingerprints left on the card in the next free slots of a device
        buffer: nothing here waits on the card."""
        from ..kernels.digest import digest_items
        k = len(parts)
        with self._lock:
            if not self._chunks or self._chunks[-1][1] + k > len(
                    self._chunks[-1][0]):
                self._chunks.append([torch.empty(
                    (max(_CHUNK, k),), dtype=torch.int64, device=dev), 0])
            chunk = self._chunks[-1]
            used = chunk[1]
            digest_items(parts, device=dev, out=chunk[0][used:used + k])
            chunk[1] = used + k
            stream = torch.cuda.current_stream(dev)
            self._streams[stream.cuda_stream] = stream
            self.folds += 1

    # -- stream API -----------------------------------------------------------

    def add(self, item: Any) -> Any:
        if self._acc is not None:
            self._fold((item,))
        return item

    def add_many(self, items: Sequence[Any]) -> Sequence[Any]:
        """Fold a whole slab: one digest launch for the slab on the card
        (one fold outside the lock on the host), one lock acquisition —
        the batch-admitted counterpart of per-item ``add``, bit-identical
        in result (XOR is order-independent and associative)."""
        if self._acc is not None and items:
            self._fold(items)
        return items

    # stage-transform protocol: per-item call + the `.many` batch hook
    __call__ = add
    many = add_many

    def absorb_digest(self, item_sha256_hex: str) -> None:
        """Fold a previously recorded per-item SHA-256 into the stream
        accumulator *without the item* — the resume path's stand-in for
        re-hashing a ledger-verified item that is being skipped, so a
        resumed transfer's stream checksum stays bit-identical to an
        unbroken run's.  Host placement only: the resumable ledger
        records host SHA-256 identities (the accel lattice fingerprint
        is a different format by design)."""
        if self._acc is None:
            return
        if self.placement != "host":
            raise ValueError(
                "resume digests fold into the host placement only; "
                "plan the resumed transfer with checksum_placement='host'")
        fold = int.from_bytes(bytes.fromhex(item_sha256_hex), "little")
        with self._lock:
            self._acc ^= fold

    def hexdigest(self) -> Optional[str]:
        """The stream's checksum so far.  On the card it waits for every
        digest launch folded in (on whichever stream it went), reading
        their fingerprints with one device-to-host copy per buffer (one
        for up to 1024 items)."""
        if self._acc is None:
            return None
        if self.placement == "host":
            return self._acc.to_bytes(32, "little").hex()
        with self._lock:
            if self._chunks:
                here = torch.cuda.current_stream(self._device)
                for s in self._streams.values():
                    if s != here:
                        here.wait_stream(s)
                for buf, used in self._chunks:
                    self._acc ^= _xor(buf[:used])
                self._chunks, self._streams = [], {}
            return f"u32:{self._acc:016x}"


# -- wire compression (float-tensor item streams) ----------------------------


class _BatchTransform:
    """A per-item callable carrying a ``.many`` slab hook; ``encodes_wire``
    marks a transform whose output, not its input, is what the wire
    carries (the mover digests after it)."""

    def __init__(self, one: Callable[[Any], Any],
                 many: Callable[[Sequence[Any]], Iterable[Any]], *,
                 encodes_wire: bool = False):
        self._one = one
        self.many = many
        self.encodes_wire = encodes_wire

    def __call__(self, item: Any) -> Any:
        return self._one(item)


def compress_transform() -> _BatchTransform:
    """Stage transform: float tensor item -> ``(q int8, scales, shape)``
    through the blockwise-int8 quantize kernel (blocks of 256 values), on
    the device the item lies on (its plain version on the CPU) — the
    budgeted pass that puts about 4x fewer bytes on the wire (oracle:
    :func:`repro_torch.optim.compression.quantize_int8_blockwise`).  A
    slab (``.many``) goes through one ``quantize_items`` call, one launch
    per table of items and device; a single item is a slab of one.  On the
    card a slab's codes and scales are views of one output each, so a
    consumer that keeps one wire item keeps the slab's whole output."""
    from ..kernels import ops

    def many(items):
        items = list(items)
        return [(q, s, tuple(x.shape))
                for x, (q, s) in zip(items, ops.quantize_items(items))]

    return _BatchTransform(lambda x: many([x])[0], many, encodes_wire=True)


def decompress_transform(*, device: Optional[torch.device | str] = None
                         ) -> _BatchTransform:
    """Inverse stage transform: ``(q, scales, shape)`` -> f32 tensor,
    through the dequantize kernel.  With ``device``, each item's codes and
    scales move there first (host items restored onto the card).  A slab
    (``.many``) goes through one ``dequantize_items`` call (one launch per
    table of items and device); a single item is a slab of one.  On the
    card a slab's items are views of one f32 output."""
    from ..kernels import ops
    dev = torch.device(device) if device is not None else None

    def many(items):
        items = list(items)
        if dev is not None:
            items = [(q.to(dev), s.to(dev), shape) for q, s, shape in items]
        return ops.dequantize_items(items)

    return _BatchTransform(lambda t: many([t])[0], many)
