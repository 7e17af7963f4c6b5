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
  that is already a tensor on the card is digested where it lies, with no
  copy to the host.

Both placements are order-independent (concurrent staging workers deliver
out of order) and batch-aware: :meth:`StreamDigest.add_many` folds a whole
slab under one lock acquisition, and the object itself is a batch-capable
stage transform (``__call__`` per item, ``.many`` per slab).

The two placements produce *different* checksum formats on purpose (64 hex
chars vs ``u32:`` + 16): a host digest and an accel digest are not
comparable, so equivalence gates always compare like with like.

The wire-compression transforms of the JAX package's module wait for the
port of the int8 quantize kernel (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

#: uint32 words per digest block (1 KiB of payload per block row)
DIGEST_BLOCK = 256
#: 2**32 / golden ratio, the fold's length mix constant
_GOLDEN = 0x9E3779B1


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


def _item_words(data: bytes):
    """Item bytes -> zero-padded uint32 words (little-endian), plus the
    real block count the digest fold keeps."""
    n = len(data)
    blocks = max(1, -(-n // (4 * DIGEST_BLOCK)))
    padded = data + b"\0" * (blocks * 4 * DIGEST_BLOCK - n)
    return np.frombuffer(padded, dtype="<u4").reshape(-1, DIGEST_BLOCK), \
        blocks


def _tensor_panels(flat: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Flat uint8 bytes -> zero-padded (blocks, 256) uint32 panels on the
    same device, 16-byte aligned, plus the block count."""
    n = flat.numel()
    blocks = max(1, -(-n // (4 * DIGEST_BLOCK)))
    pad = blocks * 4 * DIGEST_BLOCK - n
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=torch.uint8,
                                            device=flat.device)])
    elif flat.data_ptr() % 16:
        flat = flat.clone()
    return flat.view(torch.int32).view(torch.uint32).reshape(
        blocks, DIGEST_BLOCK), blocks


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

    # -- accel fingerprinting -------------------------------------------------

    def _digest_device(self) -> torch.device:
        if self._device is None:
            # resolved on first accel use: the host placement never needs
            # a card
            from ..device import resolve_device
            self._device = resolve_device(self._device_arg)
        return self._device

    def _block_digests(self, panels: torch.Tensor) -> np.ndarray:
        if self._backend == "cuda":
            from ..kernels.digest import block_digest
            d = block_digest(panels)
        else:
            from ..kernels.ref import digest_ref
            d = digest_ref(panels)
        return d.view(torch.int32).cpu().numpy().view(np.uint32)

    def _fingerprint(self, item: Any) -> int:
        dev = self._digest_device()
        if isinstance(item, torch.Tensor):
            flat = _tensor_bytes(item)
            n = flat.numel()
            panels, blocks = _tensor_panels(flat.to(dev))
        else:
            data = as_bytes(item)
            n = len(data)
            words, blocks = _item_words(data)
            panels = torch.from_numpy(words.view(np.int32).copy()).to(dev)
            panels = panels.view(torch.uint32)
        d = self._block_digests(panels)[:blocks].astype(np.uint64)
        mix = (n * _GOLDEN) & 0xFFFFFFFF
        hi = int(np.bitwise_xor.reduce(d)) ^ mix
        lo = (int(np.sum(d)) + mix) & 0xFFFFFFFF
        return (hi << 32) | lo

    def _fold_host(self, items: Sequence[Any]) -> int:
        acc = 0
        for it in items:
            acc ^= int.from_bytes(hashlib.sha256(as_bytes(it)).digest(),
                                  "little")
        return acc

    def _fold(self, items: Sequence[Any]) -> int:
        if self.placement == "host":
            return self._fold_host(items)
        acc = 0
        for it in items:
            acc ^= self._fingerprint(it)
        return acc

    # -- stream API -----------------------------------------------------------

    def add(self, item: Any) -> Any:
        if self._acc is not None:
            fold = self._fold((item,))
            with self._lock:
                self._acc ^= fold
        return item

    def add_many(self, items: Sequence[Any]) -> Sequence[Any]:
        """Fold a whole slab: the hashes compute outside the lock and
        the accumulator takes ONE acquisition — the batch-admitted
        counterpart of per-item ``add``, bit-identical in result
        (XOR is order-independent and associative)."""
        if self._acc is not None and items:
            fold = self._fold(items)
            with self._lock:
                self._acc ^= fold
        return items

    # stage-transform protocol: per-item call + the `.many` batch hook
    __call__ = add
    many = add_many

    def hexdigest(self) -> Optional[str]:
        if self._acc is None:
            return None
        if self.placement == "host":
            return self._acc.to_bytes(32, "little").hex()
        return f"u32:{self._acc:016x}"
