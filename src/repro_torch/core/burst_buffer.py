"""Burst buffer — the paper's low-jitter staging layer (section 2.1).

The paper generalizes the supercomputing burst buffer into the *decoupling
mechanism* of the whole data path: a fast intermediate tier that "buffers
the stochastic throughput and latency of the non-deterministic source ...
to ensure a deterministic, high-bandwidth supply to the high-speed sink".

Here the buffer is a fixed-slot, thread-safe ring of host objects
(typically numpy batches, checkpoint shards, or decode micro-batches).
Cadence coordination is *decentralized through buffer state* exactly as in
the paper's peer-to-peer zx design (section 2.2): producers block on a free
slot, consumers block on a filled slot; no central scheduler sits in the
data path.

Occupancy statistics make jitter absorption measurable: a well-sized buffer
shows near-zero consumer stall time even when the producer's service time
is erratic (validated in tests/test_burst_buffer.py and
benchmarks/fig2_latency_sweep.py).

**Live resizing** is what makes the buffer a *persistent* decoupling
point: :meth:`BurstBuffer.resize` revises ``capacity`` on the running
buffer — growth takes effect immediately (blocked producers wake into the
new slots), shrinkage applies lazily as consumers free slots (no staged
item is ever dropped), and every statistic keeps accumulating across the
change.  That is the mechanism behind the zero-drain replanning path
(:mod:`repro_torch.core.mover`): a plan revision re-sizes the live buffers in
place instead of draining and rebuilding them, so the data path sustains
the paper's deterministic supply *through* the correction instead of
falling off line rate at every planning boundary.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Generic, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


class BufferClosed(Exception):
    """Raised when interacting with a drained, closed buffer."""


@dataclasses.dataclass
class BufferStats:
    """Observed behaviour of one buffer (all times in seconds)."""

    capacity: int
    puts: int = 0
    gets: int = 0
    producer_stall_s: float = 0.0   # time producers spent waiting for a free slot
    consumer_stall_s: float = 0.0   # time consumers spent waiting for an item
    occupancy_sum: float = 0.0      # integral of occupancy over puts+gets (for mean)
    max_occupancy: int = 0
    resizes: int = 0                # live capacity revisions applied

    @property
    def mean_occupancy(self) -> float:
        ops = self.puts + self.gets
        return self.occupancy_sum / ops if ops else 0.0

    @property
    def consumer_stall_per_get_s(self) -> float:
        return self.consumer_stall_s / self.gets if self.gets else 0.0

    @property
    def producer_stall_per_put_s(self) -> float:
        return self.producer_stall_s / self.puts if self.puts else 0.0


class BurstBuffer(Generic[T]):
    """Bounded FIFO staging buffer with backpressure and stall accounting.

    ``capacity`` is the number of slots (items), not bytes: the item
    granularity is chosen by the caller from
    :meth:`repro_torch.core.basin.DrainageBasin.prefetch_depth`.
    """

    def __init__(self, capacity: int, name: str = "burst-buffer",
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self._clock = clock or time.monotonic
        self._items: collections.deque[T] = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.stats = BufferStats(capacity=capacity)

    # -- producer side -----------------------------------------------------

    def put(self, item: T, timeout: Optional[float] = None) -> None:
        """Stage one item; blocks (backpressure) while the buffer is full."""
        t0 = self._clock()
        with self._not_full:
            while len(self._items) >= self.capacity and not self._closed:
                if not self._not_full.wait(timeout):
                    raise TimeoutError(f"{self.name}: put timed out after {timeout}s")
            if self._closed:
                raise BufferClosed(f"{self.name} is closed")
            self._items.append(item)
            self.stats.puts += 1
            self.stats.producer_stall_s += self._clock() - t0
            occ = len(self._items)
            self.stats.occupancy_sum += occ
            self.stats.max_occupancy = max(self.stats.max_occupancy, occ)
            self._not_empty.notify()

    def put_many(self, items: Iterable[T],
                 timeout: Optional[float] = None) -> None:
        """Stage every item of ``items`` in one lock round-trip.

        Semantically identical to ``put`` per item (FIFO order, the same
        backpressure, the same per-item stats accounting) but the lock is
        acquired once per *batch* in the uncontended case — the hot-loop
        variant a dispatcher replicating batches down many branch queues
        uses.  Batches larger than ``capacity`` stage in waves as slots
        free.  On close mid-batch, already-staged items stay consumable
        and :class:`BufferClosed` is raised for the remainder."""
        batch = list(items)
        if not batch:
            return
        with self._not_full:
            i = 0
            while i < len(batch):
                # stall accrues per blocking wave (and survives a raise):
                # a dispatcher blocked mid-batch for a whole revision
                # window must show that backpressure IN that window — a
                # single post-batch accrual would zero the intake signal
                # exactly for the branch that is stalling hardest
                t0 = self._clock()
                try:
                    while (len(self._items) >= self.capacity
                           and not self._closed):
                        if not self._not_full.wait(timeout):
                            raise TimeoutError(
                                f"{self.name}: put_many timed out "
                                f"after {timeout}s")
                finally:
                    self.stats.producer_stall_s += self._clock() - t0
                if self._closed:
                    raise BufferClosed(f"{self.name} is closed")
                while i < len(batch) and len(self._items) < self.capacity:
                    self._items.append(batch[i])
                    i += 1
                    self.stats.puts += 1
                    occ = len(self._items)
                    self.stats.occupancy_sum += occ
                    self.stats.max_occupancy = max(self.stats.max_occupancy,
                                                   occ)
                self._not_empty.notify_all()

    # -- consumer side -----------------------------------------------------

    def get(self, timeout: Optional[float] = None) -> T:
        """Take the oldest staged item; blocks while the buffer is empty.

        Raises :class:`BufferClosed` once the buffer is closed *and* drained,
        which is the normal end-of-stream signal.
        """
        t0 = self._clock()
        with self._not_empty:
            while not self._items:
                if self._closed:
                    raise BufferClosed(f"{self.name} is closed and drained")
                if not self._not_empty.wait(timeout):
                    raise TimeoutError(f"{self.name}: get timed out after {timeout}s")
            item = self._items.popleft()
            self.stats.gets += 1
            self.stats.consumer_stall_s += self._clock() - t0
            self.stats.occupancy_sum += len(self._items)
            self._not_full.notify()
            return item

    def get_many(self, max_items: int,
                 timeout: Optional[float] = None) -> list[T]:
        """Take up to ``max_items`` staged items in one lock round-trip.

        Blocks like ``get`` while the buffer is empty, then returns every
        immediately-available item up to the cap (at least one).  Raises
        :class:`BufferClosed` once closed *and* drained.  Stats count one
        get per item returned, so accounting stays comparable with the
        per-item path."""
        if max_items < 1:
            raise ValueError("max_items must be >= 1")
        t0 = self._clock()
        with self._not_empty:
            while not self._items:
                if self._closed:
                    raise BufferClosed(f"{self.name} is closed and drained")
                if not self._not_empty.wait(timeout):
                    raise TimeoutError(
                        f"{self.name}: get_many timed out after {timeout}s")
            n = min(max_items, len(self._items))
            out = [self._items.popleft() for _ in range(n)]
            self.stats.gets += n
            self.stats.consumer_stall_s += self._clock() - t0
            # per-item occupancy integral: after popping the k-th of n the
            # buffer held (start - k) items
            start = len(self._items) + n
            self.stats.occupancy_sum += n * start - n * (n + 1) // 2
            self._not_full.notify_all()
            return out

    def drain(self) -> Iterator[T]:
        """Yield staged items until the buffer closes (end-of-stream)."""
        while True:
            try:
                yield self.get()
            except BufferClosed:
                return

    # -- lifecycle / introspection ------------------------------------------

    def resize(self, capacity: int) -> None:
        """Revise ``capacity`` on the *running* buffer — the live-swap
        primitive behind zero-drain replanning.

        Growth takes effect immediately: producers blocked on a full
        buffer wake into the new slots without a single staged item
        leaving the path.  Shrinkage is lazy: no staged item is dropped —
        occupancy above the new capacity simply blocks producers until
        consumers free slots down to it.  All statistics keep accumulating
        across the change (``stats.capacity`` tracks the current value,
        ``stats.resizes`` counts revisions)."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        with self._lock:
            if capacity == self.capacity:
                return          # no-op: stats.resizes counts real changes
            grew = capacity > self.capacity
            self.capacity = capacity
            self.stats.capacity = capacity
            self.stats.resizes += 1
            if grew:
                self._not_full.notify_all()

    def close(self) -> None:
        """Signal end-of-stream.  Staged items remain consumable."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def occupancy(self) -> float:
        """Fill fraction in [0, 1] - the buffer-state signal that drives
        decentralized cadence (paper section 2.2).  Clamped: right after a
        lazy shrink the staged count may transiently exceed capacity."""
        with self._lock:
            return min(1.0, len(self._items) / self.capacity)

    def feed(self, items: Iterable[T], close_when_done: bool = True) -> None:
        """Stage every item of ``items`` (convenience for tests/benchmarks).

        Closes in a ``finally``: a source iterable that raises
        mid-iteration must still end the stream, or a consumer blocked in
        ``get``/``drain`` waits forever on a buffer nobody will close."""
        try:
            for item in items:
                self.put(item)
        finally:
            if close_when_done:
                self.close()
