"""Resumable transfer ledger — survive a killed transfer (§2.1's
"routine operation" promise, extended past the process boundary).

The adaptive loop handles *degradation* (slow tiers, lossy links,
shrunken grants) online, but a killed process used to mean restarting
the whole stream from byte zero — exactly the failure mode the
production trials behind the paper identify as what decides whether a
long transfer completes at all.  :class:`TransferLedger` closes that
gap: every delivered item's completion is recorded **durably** (an
append-only JSONL file, flushed and fsynced per batch) together with
its host SHA-256 identity, and ``bulk_transfer(resume=ledger)`` then

* **skips** every item the ledger already verified — the source wrapper
  claims matching identities and never stages them again,
* **folds** each skipped item's recorded digest into the live
  :class:`~repro_torch.core.integrity.StreamDigest`, so the resumed run's
  stream checksum is bit-identical to an unbroken run's (the
  item-exactness proof rides the checksum, not trust),
* **records** every newly delivered item, so a second kill resumes from
  the union — after N interruptions the ledger holds each item exactly
  once and a final resume moves nothing.

Identity is the item's *content* (SHA-256 over
:func:`~repro_torch.core.integrity.as_bytes`), kept as a **multiset**: a
stream that legitimately carries equal items needs one completion per
occurrence, and deliveries arrive out of order (concurrent staging
workers), so positional bookkeeping would be wrong by design.  Claims
during a resume pass are in-memory only — the durable file is never
rewritten, so a crash *during* resume loses no record.

The ledger records host SHA-256 identities; a resumed transfer
therefore requires ``checksum_placement="host"`` (the accel lattice
fingerprint is a different format by design — see
:meth:`StreamDigest.absorb_digest`).  A tensor on the card is identified
by its bytes on the host: keying it copies it there, so a resume pass
reads every item it skips across PCIe once more.

The records and rules are the JAX package's (``{"sha", "bytes"}`` per
line, byte-equal files for the same items); each item's bytes are taken
once per record or claim.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from .integrity import StreamDigest, as_bytes

__all__ = ["TransferLedger"]


class TransferLedger:
    """Durable per-item completion record for resumable transfers.

    ``path=None`` keeps the ledger in memory (property tests, or a
    caller that persists it elsewhere); with a path, existing records
    load on open and new records append — a torn final line from a
    mid-write kill is skipped on load, never fatal.  Thread-safe: the
    mover's concurrent sink workers record through one lock.
    """

    def __init__(self, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._bytes: dict[str, int] = {}
        self._path = path
        self._fh = None
        #: per-resume-pass accounting (reset by :meth:`skip_verified`)
        self.skipped_items = 0
        self.skipped_bytes = 0
        if path is not None:
            if os.path.exists(path):
                with open(path, "r", encoding="utf-8") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                            sha = rec["sha"]
                            nb = int(rec.get("bytes", 0))
                        except (ValueError, KeyError, TypeError):
                            # torn tail line from a mid-write kill: the
                            # item it described was never acknowledged,
                            # so dropping it is the safe direction
                            continue
                        self._counts[sha] = self._counts.get(sha, 0) + 1
                        self._bytes[sha] = nb
            self._fh = open(path, "a", encoding="utf-8")

    # -- identity -------------------------------------------------------------

    @staticmethod
    def item_key(item: Any) -> str:
        """Content identity: hex SHA-256 over the item's stable byte
        view — the same per-item digest the host stream checksum XORs,
        which is what lets a skipped item's record fold into the live
        digest."""
        return hashlib.sha256(as_bytes(item)).hexdigest()

    # -- recording ------------------------------------------------------------

    def record(self, item: Any) -> str:
        """Durably record one delivered item; returns its identity."""
        data = as_bytes(item)
        key = hashlib.sha256(data).hexdigest()
        nb = len(data)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._bytes[key] = nb
            if self._fh is not None:
                self._fh.write(json.dumps({"sha": key, "bytes": nb}) + "\n")
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:  # pragma: no cover - exotic filesystems
                    pass
        return key

    def counts(self) -> dict[str, int]:
        """Snapshot of the verified multiset (identity -> occurrences)."""
        with self._lock:
            return dict(self._counts)

    @property
    def items_recorded(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    @property
    def bytes_recorded(self) -> int:
        with self._lock:
            return sum(self._bytes[k] * n for k, n in self._counts.items())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "TransferLedger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- the resume seam (consumed by UnifiedDataMover._run) ------------------

    def skip_verified(self, source: Iterable[Any],
                      digest: Optional[StreamDigest] = None
                      ) -> Iterator[Any]:
        """Wrap a source: ledger-verified items are claimed (in memory,
        against a snapshot — the durable file never rewrites) and
        skipped, their recorded digests folded into ``digest``; only
        unverified items yield through to be staged."""
        pending = self.counts()
        self.skipped_items = 0
        self.skipped_bytes = 0

        def gen() -> Iterator[Any]:
            for item in source:
                data = as_bytes(item)
                key = hashlib.sha256(data).hexdigest()
                if pending.get(key, 0) > 0:
                    pending[key] -= 1
                    if digest is not None:
                        digest.absorb_digest(key)
                    self.skipped_items += 1
                    self.skipped_bytes += len(data)
                    continue
                yield item

        return gen()

    def recording_sink(self, sink: Callable[[Any], None]
                       ) -> Callable[[Any], None]:
        """Wrap a sink: each successful delivery records durably, so a
        kill between deliveries loses at most the in-flight items."""

        def wrapped(item: Any) -> None:
            sink(item)
            self.record(item)

        return wrapped
