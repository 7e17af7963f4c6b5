"""Data staging — the coordinating process between mismatched tiers.

Paper section 2.1: "Data staging ... is a critical coordinating process.
This operation must be straightforward, predictable, and highly efficient,
as any delay in staging fundamentally negates the performance benefits of
burst buffering."

A :class:`Stage` is a worker (or pool of workers) that moves items from an
upstream source (an iterator or another stage's burst buffer) into its own
:class:`~repro_torch.core.burst_buffer.BurstBuffer`, optionally applying a
transform (decode, shard, checksum, quantize, host-to-device put).
Chaining stages yields a :class:`StagePipeline` — the executable form of a
drainage-basin path.

Design points lifted from the paper:

* **No central scheduler** — each stage runs free and coordinates only
  through buffer state (backpressure), section 2.2.
* **Concurrency as the latency antidote** — multiple workers per stage
  overlap erratic upstream service times, the host-side mirror of the
  paper's concurrent data mover (section 3.1: latency insensitivity).
* **Measurability** — per-stage stall/throughput stats expose where the
  basin actually chokes, so the fidelity gap can be attributed.

Branching paths (DAG basins) run as a :class:`ParallelBranchPipeline`:
one :class:`StagePipeline` per branch, each with its own source, all
draining into a shared merge buffer as ``(branch_id, item)`` pairs, and
every branch's :class:`StageReport` tagged ``"<branch>/<stage>"`` so the
planner's ``replan`` can attribute a stall to the one degraded branch.

Stages are **live-resizable**: :meth:`Stage.resize` grows or shrinks the
worker pool against the running queues (spawn new workers / lazily retire
surplus ones — no thread-pool teardown) and re-sizes the stage's burst
buffer in place.  Together with :meth:`BurstBuffer.resize
<repro_torch.core.burst_buffer.BurstBuffer.resize>` this is what lets the mover
apply a revised plan to a *running* pipeline (zero-drain replanning)
instead of draining and rebuilding it at every segment boundary;
:func:`delta_report` carves the continuously-running stage's cumulative
counters into per-revision-window evidence for ``replan``.

Windowed (RTT-governed) hops run as a :class:`WindowedStage`: a CHANNEL
hop on a long link is clocked by acknowledgements, not by queue space —
throughput is ``window / RTT`` however much bandwidth is provisioned
(paper §3.1/§3.2, the congestion-window fallacy).  The windowed stage
caps *unacknowledged in-flight bytes* at a plan-assigned ``window_bytes``
and accounts the time workers spend waiting for credit as
``StageReport.stall_window_s`` — a third stall side, distinct from
upstream starvation and downstream backpressure, because its remedy
(raise the window) is distinct from both.

Stages are **batch-admitted**: with ``batch_items > 1`` a worker pulls a
whole slab of items per loop (``upstream_many``), admits the slab's total
wire bytes through the transport-credit seam in one call, transforms it
(a transform exposing a ``.many`` attribute handles the slab in one
invocation), and stages it with one ``put_many`` — one lock round-trip
and one admission check per slab instead of per item.  The paper's host
bottleneck is exactly this per-item coordination cost; collapsing it is
how the staging layer gets out of the basin's way.  Per-slab credit keeps
``WindowedStage`` accounting honest: the ACK ledger carries one entry of
the slab's total bytes, and admission waits still accrue to
``stall_window_s``.  ``batch_items=1`` (the default) is byte-for-byte the
historical per-item path.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
import threading
import time
import traceback
from typing import Any, Callable, Generic, Iterable, Iterator, Optional, Sequence, TypeVar

from .burst_buffer import BufferClosed, BurstBuffer

T = TypeVar("T")
U = TypeVar("U")

#: per-side service-time samples kept per stage (bounded: a multi-day
#: transfer must not grow its report without bound)
SERVICE_RESERVOIR = 64


class _Reservoir:
    """Bounded uniform sample of a float stream (Algorithm R).

    The PRNG is seeded per reservoir so a deterministic run produces a
    deterministic report — the property the simulated-basin test harness
    relies on."""

    def __init__(self, k: int = SERVICE_RESERVOIR, seed: int = 0x5EED):
        self._k = k
        self._n = 0
        self._rng = random.Random(seed)
        self.samples: list[float] = []

    def add(self, x: float) -> None:
        self._n += 1
        if len(self.samples) < self._k:
            self.samples.append(x)
        else:
            j = self._rng.randrange(self._n)
            if j < self._k:
                self.samples[j] = x


@dataclasses.dataclass
class StageReport:
    name: str
    items: int
    bytes: int
    elapsed_s: float
    stall_up_s: float      # waiting on upstream (source starvation)
    stall_down_s: float    # waiting on our buffer (downstream backpressure)
    errors: int
    #: waiting for transport credit — in-flight bytes pinned at the hop's
    #: ``window_bytes`` until ACKs return (WindowedStage only; 0.0 on
    #: queue-clocked stages).  Kept apart from the queue stalls because
    #: its remedy is raising the window, not adding workers or buffers.
    stall_window_s: float = 0.0
    #: start -> last completed item: the stage's *active* window.  In a
    #: parallel-branch segment a fast branch finishes early and idles
    #: until the slowest branch drains; rates judged over ``elapsed_s``
    #: would read that idle tail as underdelivery.  0.0 = unknown (treat
    #: as ``elapsed_s``).
    active_s: float = 0.0
    #: bounded reservoir of per-item upstream service times (pull->item);
    #: the regime signature planner.replan diagnoses latency- vs
    #: bandwidth-bound stalls from
    service_up_s: list[float] = dataclasses.field(default_factory=list)
    #: bounded reservoir of per-item downstream delivery times (put->done)
    service_down_s: list[float] = dataclasses.field(default_factory=list)
    #: retransmissions the hop's channel paid in this window (§3.2 loss)
    #: — the evidence behind the planner's **loss-bound** verdict.  0 on
    #: hops without an observable channel.
    retransmits: int = 0
    #: sum and count of observed ACK round-trip times (WindowedStage
    #: only): ``rtt_sum_s / acks`` is the live RTT estimate the planner
    #: revises ``HopPlan.rtt_s`` from — a route change shows up here
    #: *before* it can masquerade as a window-bound stall.
    rtt_sum_s: float = 0.0
    acks: int = 0
    #: transform attempts re-run after a raise, and the backoff the
    #: workers waited before re-running them — first-hand fault evidence
    #: (the planner's **fault-degraded** verdict reads these BEFORE the
    #: stall classifiers, so a flapping hop is priced as faulty rather
    #: than misread as latency-bound).
    retries: int = 0
    retry_wait_s: float = 0.0

    @property
    def throughput_bytes_per_s(self) -> float:
        return self.bytes / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def rtt_estimate_s(self) -> float:
        """Mean observed ACK round trip (0.0 = no windowed observations)."""
        return self.rtt_sum_s / self.acks if self.acks > 0 else 0.0


#: end-of-stream sentinel for the segment peek (None is a valid item)
_EXHAUSTED = object()


def slab_views(buf: Any, item_bytes: int) -> Iterator[memoryview]:
    """Zero-copy item stream over a contiguous buffer: yields
    ``memoryview`` slices of ``item_bytes`` each (last may be short).

    The slices share the underlying storage — no per-item copy is made
    anywhere in the staging path, which treats ``memoryview`` as a
    first-class item type (``_default_sizeof`` measures it by ``len``)."""
    if item_bytes <= 0:
        raise ValueError(f"item_bytes must be > 0, got {item_bytes}")
    view = memoryview(buf)
    for off in range(0, len(view), item_bytes):
        yield view[off:off + item_bytes]


def iter_segments(source_it: Iterator[Any],
                  items_per_segment: int) -> Iterator[Iterator[Any]]:
    """Split an iterator into consecutive segments of up to
    ``items_per_segment`` items (0 = one segment covering everything).

    This is the online-replanning boundary protocol shared by the mover
    and the input pipeline: each yielded segment must be fully drained
    before the next is requested (a buffer boundary), and the one-item
    peek between segments means an exactly-exhausted source ends the
    loop without a phantom empty segment.  The peeked item is prepended
    to the *next* segment directly — no nested re-wrapping of the source,
    so pull cost stays O(1) however many boundaries a long stream
    crosses."""
    if not items_per_segment:
        yield source_it
        return
    pushback = next(source_it, _EXHAUSTED)
    while pushback is not _EXHAUSTED:
        yield itertools.chain(
            [pushback], itertools.islice(source_it, items_per_segment - 1))
        pushback = next(source_it, _EXHAUSTED)


def merge_reports(chunks: Sequence[Sequence[StageReport]]) -> list[StageReport]:
    """Fold per-chunk stage reports into one report per stage name.

    Online replanning runs one pipeline per chunk, but the transfer is a
    single observable: counters and stall times sum, service-time
    reservoirs concatenate keeping the newest ``SERVICE_RESERVOIR``
    samples (the most recent regime is what the next replan should see)."""
    merged: dict[str, StageReport] = {}
    order: list[str] = []
    for reports in chunks:
        for r in reports:
            m = merged.get(r.name)
            if m is None:
                merged[r.name] = dataclasses.replace(
                    r, service_up_s=list(r.service_up_s),
                    service_down_s=list(r.service_down_s))
                order.append(r.name)
                continue
            m.items += r.items
            m.bytes += r.bytes
            m.elapsed_s += r.elapsed_s
            m.active_s += r.active_s
            m.stall_up_s += r.stall_up_s
            m.stall_down_s += r.stall_down_s
            m.stall_window_s += r.stall_window_s
            m.errors += r.errors
            m.retransmits += r.retransmits
            m.rtt_sum_s += r.rtt_sum_s
            m.acks += r.acks
            m.retries += r.retries
            m.retry_wait_s += r.retry_wait_s
            m.service_up_s = (m.service_up_s
                              + list(r.service_up_s))[-SERVICE_RESERVOIR:]
            m.service_down_s = (m.service_down_s
                                + list(r.service_down_s))[-SERVICE_RESERVOIR:]
    return [merged[n] for n in order]


def delta_report(cur: StageReport,
                 prev: Optional[StageReport]) -> StageReport:
    """The window between two cumulative reports of one *continuously
    running* stage — the zero-drain counterpart of a per-segment report.

    A persistent pipeline's counters accumulate from start; feeding the
    same early stall seconds through ``replan`` at every revision
    checkpoint would re-apply consumed evidence and defeat damping.  This
    subtracts the previously-consumed totals, leaving exactly one
    revision window's evidence.  Service reservoirs do not difference —
    the caller resets them per window (``Stage.reset_service_reservoirs``)
    so ``cur`` already carries only fresh samples, which pass through."""
    if prev is None:
        return cur
    return dataclasses.replace(
        cur,
        items=cur.items - prev.items,
        bytes=cur.bytes - prev.bytes,
        elapsed_s=cur.elapsed_s - prev.elapsed_s,
        active_s=max(0.0, cur.active_s - prev.active_s),
        stall_up_s=cur.stall_up_s - prev.stall_up_s,
        stall_down_s=cur.stall_down_s - prev.stall_down_s,
        stall_window_s=cur.stall_window_s - prev.stall_window_s,
        errors=cur.errors - prev.errors,
        retransmits=cur.retransmits - prev.retransmits,
        rtt_sum_s=max(0.0, cur.rtt_sum_s - prev.rtt_sum_s),
        acks=cur.acks - prev.acks,
        retries=cur.retries - prev.retries,
        retry_wait_s=max(0.0, cur.retry_wait_s - prev.retry_wait_s))


def delta_reports(cur: Sequence[StageReport],
                  prev: Sequence[StageReport]) -> list[StageReport]:
    """Per-stage windows between two cumulative report snapshots (matched
    by name; a stage absent from ``prev`` passes through whole)."""
    by_name = {r.name: r for r in prev}
    out = []
    for r in cur:
        d = delta_report(r, by_name.get(r.name))
        if d.elapsed_s > 0 and d.items > 0:
            out.append(d)
    return out


class Stage(Generic[T, U]):
    """One staging hop: pull from upstream, transform, stage into a buffer."""

    def __init__(
        self,
        name: str,
        *,
        capacity: int = 4,
        workers: int = 1,
        transform: Optional[Callable[[T], U]] = None,
        sizeof: Optional[Callable[[Any], int]] = None,
        clock: Optional[Callable[[], float]] = None,
        batch_items: int = 1,
        retry_budget: int = 0,
        backoff_base_s: float = 0.05,
    ):
        self.name = name
        self._clock = clock or time.monotonic
        self.buffer: BurstBuffer[U] = BurstBuffer(capacity, name=f"{name}.buf",
                                                  clock=self._clock)
        self.workers = workers
        self.transform = transform
        self.sizeof = sizeof or _default_sizeof
        #: slab size: items pulled/admitted/staged per worker loop.  1 =
        #: the per-item path; >1 engages the batched loop when the
        #: upstream supports many-pulls.  Read at each loop head so a
        #: live ``resize(batch_items=...)`` takes effect mid-stream.
        self.batch_items = max(1, int(batch_items))
        #: channel-observability hook: a transform may expose the hop's
        #: underlying channel as ``transform.channel`` (tests/simbasin.py
        #: attaches the SimulatedLink; a production wrapper would expose
        #: its socket stats).  The stage reads the channel's live
        #: ``retransmits`` counter and ``rtt_s`` — the §3.2 evidence that
        #: makes loss and route changes *diagnosable* instead of silent.
        self._channel = getattr(transform, "channel", None)
        #: fault tolerance: a transform raise is retried up to
        #: ``retry_budget`` times with exponential backoff
        #: (``backoff_base_s * 2**attempt``) plus seeded jitter before the
        #: error surfaces.  0 (the default) is the historical fail-fast
        #: path; the planner staffs real budgets per hop
        #: (``HopPlan.retry_budget``).  Retries and backoff waits accrue
        #: to the report as ``retries``/``retry_wait_s`` — fault evidence,
        #: deliberately kept OUT of the service reservoirs so the regime
        #: diagnosis still reads clean service cost.
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_base_s = float(backoff_base_s)
        # seeded from the stage name (stable across runs, unlike hash()):
        # backoff jitter must be a pure function of the script
        self._retry_rng = random.Random(0xFA11 ^ sum(name.encode()))
        self._retries = 0
        self._retry_wait_s = 0.0
        self._retrans_base = 0
        self._rtt_obs_sum = 0.0
        self._rtt_obs_n = 0
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._items = 0
        self._bytes = 0
        self._stall_up_s = 0.0
        self._stall_window_s = 0.0      # WindowedStage accrues; base never
        self._errors = 0
        self._error_tb: Optional[str] = None
        self._upstream: Optional[Callable[[], Optional[T]]] = None
        self._upstream_many: Optional[
            Callable[[int], Optional[list[T]]]] = None
        self._active = 0        # spawned minus exited workers
        self._retire = 0        # pending lazy-retirement requests
        #: items a worker held when its transform failed for good (budget
        #: exhausted) — the branch-failover layer re-routes these onto
        #: surviving branches instead of silently dropping them
        self._salvage: list = []
        self._spawned = 0       # lifetime worker counter (thread names)
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None
        self._t_last: Optional[float] = None
        self._service_up = _Reservoir()
        self._service_down = _Reservoir(seed=0xD011)

    # -- execution ----------------------------------------------------------

    def start(self, upstream: Callable[[], Optional[T]],
              upstream_many: Optional[
                  Callable[[int], Optional[list[T]]]] = None) -> None:
        """Begin staging.  ``upstream()`` returns the next item or ``None``
        at end-of-stream; it must be thread-safe for ``workers > 1``.
        ``upstream_many(k)`` (optional) returns up to ``k`` items as a
        list, or ``None``/``[]`` at end-of-stream, in ONE upstream lock
        round-trip — the slab pull the batched worker loop rides.  When
        absent, ``batch_items > 1`` falls back to the per-item loop."""
        self._t_start = self._clock()
        # snapshot the channel's cumulative retransmit counter so this
        # stage reports only ITS OWN window of losses (segmented movers
        # build a fresh stage per segment over one long-lived channel;
        # without the base, merge_reports would multiply-count)
        if self._channel is not None:
            self._retrans_base = int(getattr(self._channel,
                                             "retransmits", 0))
        self._upstream = upstream
        self._upstream_many = upstream_many
        self._spawn(self.workers)

    def _spawn(self, n: int) -> None:
        """Add ``n`` workers against the live upstream/buffer (used at
        start and by live pool growth — no pipeline teardown either way)."""
        if n <= 0:
            return
        # simulation seam: a virtual clock (tests/simbasin.py) anchors the
        # spawned workers' timelines to this instant, so simulated
        # concurrency is deterministic; a real clock has no such hook.
        # Only the FIRST spawn anchors: a live pool growth must not
        # re-anchor at the global frontier — that frontier includes the
        # laggard completions of unrelated slow branches, and charging
        # them to a healthy stage's new workers would be phantom delay.
        spawn_hook = getattr(self._clock, "on_threads_spawn", None)
        if spawn_hook is not None and self._spawned == 0:
            spawn_hook()
        with self._lock:
            threads = [
                threading.Thread(target=self._run_worker,
                                 name=f"{self.name}-{self._spawned + i}",
                                 daemon=True)
                for i in range(n)
            ]
            self._spawned += n
            self._active += n
            # prune exited workers so a long-lived pipeline's grow/retire
            # churn doesn't accumulate dead Thread objects without bound
            self._threads = [t for t in self._threads
                             if t.is_alive()] + threads
        for t in threads:
            t.start()

    # -- transport-credit seam (no-ops here; see WindowedStage) --------------

    def _admit(self, nbytes: int) -> None:
        """Block until the hop may put ``nbytes`` more in flight.  The
        base stage is queue-clocked — admission is free."""

    def _on_sent(self, nbytes: int, t_sent: float) -> None:
        """Record that ``nbytes`` finished transmitting at ``t_sent`` (the
        instant the credit clock starts counting toward their ACK)."""

    # -- fault tolerance ------------------------------------------------------

    def _backoff(self, wait_s: float) -> None:
        """Wait out one retry backoff.  Under the simulated basin's
        virtual clock the waiter's own timeline jumps forward (the same
        per-thread model as windowed admission), so a scripted fault's
        recovery point is deterministic; under a real clock it sleeps."""
        set_thread = getattr(self._clock, "set_thread", None)
        thread_now = getattr(self._clock, "thread_now", None)
        if set_thread is not None and thread_now is not None:
            set_thread(thread_now() + wait_s)
        else:
            time.sleep(wait_s)

    def _run_with_retry(self, attempt_fn: Callable[[], U]) -> U:
        """Run one transform attempt under the hop's retry policy:
        ``retry_budget`` re-runs with exponential backoff and seeded
        jitter.  The final failure re-raises (the worker's error path —
        and, one level up, branch failover — takes over from there)."""
        budget = self.retry_budget
        if budget <= 0:
            return attempt_fn()
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except Exception:
                if attempt >= budget:
                    raise
                # exponential backoff with jitter in [1x, 1.5x): spreads
                # sibling workers' retries so a recovered hop is not
                # re-stormed by a synchronized burst.  Drawn under the
                # stage lock so the jitter sequence is well-defined.
                with self._lock:
                    wait = (self.backoff_base_s * (2 ** attempt)
                            * (1.0 + 0.5 * self._retry_rng.random()))
                    self._retries += 1
                    self._retry_wait_s += wait
                attempt += 1
                self._backoff(wait)

    def _run_worker(self) -> None:
        try:
            while True:
                with self._lock:
                    # lazy retirement: a live pool shrink takes effect at
                    # the worker's next loop head, never mid-item
                    if self._retire > 0:
                        self._retire -= 1
                        return
                # the slab size is re-read each loop so a live
                # resize(batch_items=...) takes effect without a rebuild
                k = self.batch_items
                if k > 1 and self._upstream_many is not None:
                    if not self._step_batch(k):
                        break
                elif not self._step_one():
                    break
        except Exception:
            with self._lock:
                self._errors += 1
                self._error_tb = traceback.format_exc()
        finally:
            with self._lock:
                # last worker out closes the buffer (explicit counter:
                # checking thread liveness races when several workers
                # exit together and nobody closes).  Retired workers only
                # decrement — resize never shrinks the target below one,
                # so the count reaches zero exactly at end-of-stream.
                self._active -= 1
                if self._active == 0 and self._t_end is None:
                    self._t_end = self._clock()
                    self.buffer.close()

    def _step_one(self) -> bool:
        """One per-item loop iteration; False ends the worker (EOS or a
        closed downstream buffer)."""
        t0 = self._clock()
        item = self._upstream()
        dt_up = self._clock() - t0
        with self._lock:
            self._stall_up_s += dt_up
        if item is None:
            return False
        # transport credit is acquired on the PRE-transform size
        # (the bytes handed to the wire) and released on the same
        # figure — admission waits are window stall, kept out of
        # the service samples so the regime diagnosis still reads
        # pure pull+transform cost
        nbytes_wire = self.sizeof(item)
        self._admit(nbytes_wire)
        t_tx0 = self._clock()
        try:
            out = (self._run_with_retry(lambda: self.transform(item))
                   if self.transform else item)
        except BaseException:
            # a failed transmit must still return its credit (via
            # the ACK path, one RTT out) or siblings blocked on
            # the window would wait on an ACK that never comes
            self._on_sent(nbytes_wire, self._clock())
            with self._lock:
                self._salvage.append(item)
            raise
        t1 = self._clock()
        self._on_sent(nbytes_wire, t1)
        with self._lock:
            # upstream service sample = pull + transform: the
            # full cost of acquiring one staged item.  A slow
            # transform (e.g. a storage fetch riding the hop)
            # keeps the worker busy rather than stalled, and
            # only this sample reveals it to the replanner.
            self._service_up.add(dt_up + (t1 - t_tx0))
        try:
            self.buffer.put(out)
        except BufferClosed:
            return False
        dt_down = self._clock() - t1
        with self._lock:
            self._items += 1
            self._bytes += self.sizeof(out)
            self._service_down.add(dt_down)
            self._t_last = self._clock()
        return True

    def _step_batch(self, k: int) -> bool:
        """One slab loop iteration: pull up to ``k`` items in one upstream
        round-trip, admit the slab's total wire bytes in ONE credit check,
        transform, and stage with ONE ``put_many`` — the zero-copy data
        plane's amortized hot path.  Stats parity with ``_step_one``:
        items/bytes count identically, and the service reservoirs record
        the slab's per-item mean so the regime signature stays comparable
        with per-item evidence."""
        t0 = self._clock()
        batch = self._upstream_many(k)
        dt_up = self._clock() - t0
        with self._lock:
            self._stall_up_s += dt_up
        if not batch:
            return False
        sizeof = self.sizeof
        nbytes_wire = sum(sizeof(it) for it in batch)
        # ONE admission for the whole slab: credit is debited per-slab,
        # and the matching _on_sent posts one ACK-ledger entry of the
        # same total, so WindowedStage in-flight accounting balances
        self._admit(nbytes_wire)
        t_tx0 = self._clock()
        transform = self.transform
        try:
            if transform is None:
                out = batch
            else:
                many = getattr(transform, "many", None)
                # the whole slab is one retryable attempt: a mid-slab
                # fault re-runs the slab (simulated tiers charge per
                # serve, so the re-run is paid for honestly)
                out = self._run_with_retry(
                    lambda: list(many(batch)) if many is not None
                    else [transform(it) for it in batch])
        except BaseException:
            self._on_sent(nbytes_wire, self._clock())
            with self._lock:
                self._salvage.extend(batch)
            raise
        t1 = self._clock()
        self._on_sent(nbytes_wire, t1)
        n = len(out)
        with self._lock:
            self._service_up.add((dt_up + (t1 - t_tx0)) / n)
        try:
            self.buffer.put_many(out)
        except BufferClosed:
            return False
        dt_down = self._clock() - t1
        with self._lock:
            self._items += n
            self._bytes += sum(sizeof(o) for o in out)
            self._service_down.add(dt_down / n)
            self._t_last = self._clock()
        return True

    def resize(self, *, capacity: Optional[int] = None,
               workers: Optional[int] = None,
               window_bytes: Optional[float] = None,
               batch_items: Optional[int] = None,
               rtt_s: Optional[float] = None,
               retry_budget: Optional[int] = None,
               backoff_base_s: Optional[float] = None) -> None:
        """Apply revised staging parameters to the *running* stage.

        ``capacity`` re-sizes the stage's burst buffer in place
        (:meth:`BurstBuffer.resize
        <repro_torch.core.burst_buffer.BurstBuffer.resize>`); ``workers`` grows
        the pool by spawning workers against the live queues or shrinks it
        by lazily retiring surplus workers (each exits at its next loop
        head — no thread-pool teardown, no staged item dropped).  Both are
        no-ops when the value is unchanged; the worker target is clamped
        to >= 1 so the stream can always finish.  ``window_bytes`` is
        accepted for call-site uniformity but only a
        :class:`WindowedStage` has a window to revise.  ``batch_items``
        revises the slab size live — each worker reads it at its next
        loop head, so a replan can collapse a misbehaving batched hop to
        per-item (or vice versa) with zero drain.  ``rtt_s`` revises a
        windowed stage's ACK clock (an rtt-revised verdict); ignored on
        queue-clocked stages.  ``retry_budget`` / ``backoff_base_s``
        revise the hop's fault posture live — workers read both at the
        next transform attempt, so a fault-priced budget from telemetry
        priors applies zero-drain."""
        if capacity is not None and capacity != self.buffer.capacity:
            self.buffer.resize(capacity)
        if retry_budget is not None:
            self.retry_budget = max(0, int(retry_budget))
        if backoff_base_s is not None and backoff_base_s > 0:
            self.backoff_base_s = float(backoff_base_s)
        if batch_items is not None:
            self.batch_items = max(1, int(batch_items))
        if workers is None:
            return
        target = max(1, int(workers))
        grow = 0
        with self._lock:
            if self._t_end is not None:
                # stream already ended: record the target for reporting
                # but there is nothing left to staff
                self.workers = target
                return
            current = self._active - self._retire
            self.workers = target
            if target > current:
                grow = target - current
                # growth first cancels pending retirements (cheaper than
                # spawning a thread while another is about to exit)
                cancelled = min(self._retire, grow)
                self._retire -= cancelled
                grow -= cancelled
            elif target < current:
                self._retire += current - target
        if grow > 0 and self._upstream is not None:
            self._spawn(grow)

    @property
    def failed(self) -> bool:
        """True once a worker died on an unretryable (or
        budget-exhausted) error — the dead-branch signal failover acts
        on."""
        with self._lock:
            return self._error_tb is not None

    def take_salvage(self) -> list:
        """Claim (and clear) the items workers held when their transforms
        failed for good, so a failover path can re-route them."""
        with self._lock:
            out, self._salvage = self._salvage, []
            return out

    def error_summary(self) -> str:
        """Last line of the fatal error's traceback ('' while healthy) —
        the one-line obituary failover verdicts carry."""
        with self._lock:
            tb = self._error_tb
        if not tb:
            return ""
        lines = [ln for ln in tb.strip().splitlines() if ln.strip()]
        return lines[-1].strip() if lines else ""

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join worker threads without raising on a recorded error — the
        quiescence barrier failover needs before salvaging (join() is the
        fail-fast form)."""
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        self.wait(timeout)
        if self._error_tb:
            raise RuntimeError(f"stage {self.name} failed:\n{self._error_tb}")

    # -- reporting -----------------------------------------------------------

    def reset_service_reservoirs(self) -> None:
        """Start fresh per-item service windows.  Online replanning over
        a continuously running stage consumes samples one revision window
        at a time; without a reset, a long-gone regime's samples linger
        in the uniform reservoir and keep polluting every later
        diagnosis."""
        with self._lock:
            self._service_up = _Reservoir()
            self._service_down = _Reservoir(seed=0xD011)

    def report(self) -> StageReport:
        # explicit None checks: a virtual clock legitimately starts at 0.0
        end = self._t_end if self._t_end is not None else self._clock()
        start = self._t_start if self._t_start is not None else end
        with self._lock:
            return StageReport(
                name=self.name,
                items=self._items,
                bytes=self._bytes,
                elapsed_s=end - start,
                active_s=(self._t_last - start
                          if self._t_last is not None else 0.0),
                stall_up_s=self._stall_up_s,
                stall_down_s=self.buffer.stats.producer_stall_s,
                stall_window_s=self._stall_window_s,
                errors=self._errors,
                retransmits=(int(getattr(self._channel, "retransmits", 0))
                             - self._retrans_base
                             if self._channel is not None else 0),
                rtt_sum_s=self._rtt_obs_sum,
                acks=self._rtt_obs_n,
                retries=self._retries,
                retry_wait_s=self._retry_wait_s,
                service_up_s=list(self._service_up.samples),
                service_down_s=list(self._service_down.samples),
            )


class WindowedStage(Stage):
    """A credit/ACK-clocked staging hop — the executable form of the
    paper's §3.1/§3.2 window-governed CHANNEL.

    A long link does not admit bytes because queue space exists; it
    admits them while the *congestion/flow-control window* has credit,
    and credit only returns one round trip after the bytes went out.
    The stage keeps an ACK ledger: transmitting an item occupies
    ``sizeof(item)`` bytes of the window from admission until ``rtt_s``
    after its transmission completes.  A worker that would overfill the
    window waits for the oldest outstanding ACK, and that wait is
    accounted as ``stall_window_s`` — separate from the queue stalls,
    because it caps throughput at ``window_bytes / rtt_s`` no matter how
    much bandwidth is provisioned or how many workers are staffed (the
    evidence behind the planner's **window-bound** verdict).

    The ACK clock is the injectable stage clock: under a real clock the
    waiter sleeps out the remaining round trip; under the simulated
    basin's virtual clock (per-thread timelines present) the waiter's own
    timeline jumps to the ACK instant — the same per-thread latency model
    ``SimulatedTier.serve`` uses — so windowed scenarios stay a pure
    function of the script and never wall-block.

    ``resize(window_bytes=...)`` revises the window on the *running*
    stage: growth wakes credit-blocked workers immediately (the
    zero-drain remedy for a window-bound verdict); shrinkage applies as
    outstanding ACKs return.  An item larger than the whole window is
    admitted alone (the stream must always make progress).

    **Fractional credit** — admission is whole-item, so a window worth
    ``k + f`` items (``0 < f < 1``) would truncate to ``k`` in flight
    and deliver only ``k/(k+f)`` of the grant (severe at small windows —
    an arbitered 10 ms hop granted 2.5 items delivers 80 %).  The stage
    therefore *banks* the stranded fractional credit: each admission
    that blocks on a nearly-full window deposits the unusable leftover
    (capped at one item), and once the bank covers an item's shortfall
    the item is admitted overdrawn.  Long-run average in-flight bytes
    stay ≤ the window; the instantaneous overdraft is bounded by one
    item — the grant is honored in expectation instead of floored.
    """

    def __init__(self, name: str, *, window_bytes: float, rtt_s: float,
                 **kwargs: Any):
        super().__init__(name, **kwargs)
        if window_bytes <= 0:
            raise ValueError(f"stage {name!r}: window_bytes must be > 0")
        if rtt_s < 0:
            raise ValueError(f"stage {name!r}: rtt_s must be >= 0")
        self.window_bytes = float(window_bytes)
        self.rtt_s = float(rtt_s)
        self._win_cond = threading.Condition(threading.Lock())
        self._inflight = 0.0                      # admitted, not yet ACKed
        self._acks: list[tuple[float, int]] = []  # heap of (ack_time, bytes)
        self._win_bank = 0.0    # stranded fractional credit, ≤ one item

    @property
    def inflight_bytes(self) -> float:
        with self._win_cond:
            self._reap(self._clock())
            return self._inflight

    def _reap(self, now: float) -> None:
        """Release credit for every ACK that has matured (win lock held)."""
        while self._acks and self._acks[0][0] <= now + 1e-12:
            _, nb = heapq.heappop(self._acks)
            self._inflight -= nb

    def _locked_try_admit(self, nbytes: int,
                          banked: bool) -> tuple[bool, bool]:
        """One admission attempt (win lock held, credit already reaped).

        Returns ``(admitted, banked)``.  A blocked attempt on a window
        with free-but-insufficient credit deposits that leftover into
        the fractional-credit bank — at most once per admission call
        (``banked`` tracks it), and the bank never exceeds one item —
        then admits overdrawn once bank + leftover cover the item."""
        if (self._inflight <= 0
                or self._inflight + nbytes <= self.window_bytes + 1e-9):
            self._inflight += nbytes
            return True, banked
        leftover = self.window_bytes - self._inflight
        if leftover > 0:
            if self._win_bank + leftover >= nbytes - 1e-9:
                # spend the bank: the overdraft is exactly the credit
                # truncation stranded on earlier admissions
                self._win_bank -= nbytes - leftover
                self._inflight += nbytes
                return True, banked
            if not banked:
                self._win_bank = min(self._win_bank + leftover,
                                     float(nbytes))
                banked = True
        return False, banked

    def _admit(self, nbytes: int) -> None:
        thread_now = getattr(self._clock, "thread_now", None)
        if thread_now is not None:
            self._admit_virtual(nbytes, thread_now)
        else:
            self._admit_wall(nbytes)

    def _admit_virtual(self, nbytes: int,
                       thread_now: Callable[[], float]) -> None:
        """Virtual-clock admission: the waiter's own timeline jumps to the
        oldest outstanding ACK (exactly how :meth:`SimulatedTier.serve`
        models latency), so window pacing stays a per-thread, scripted
        quantity — it neither wall-blocks nor drags the global frontier
        forward under other stages' stall measurements."""
        entry = thread_now()
        t = entry
        banked = False
        with self._win_cond:
            while True:
                self._reap(t)
                admitted, banked = self._locked_try_admit(nbytes, banked)
                if admitted:
                    break
                if self._acks:
                    # the oldest ACK's arrival is when credit next frees
                    t = max(t, self._acks[0][0])
                else:
                    # every in-flight byte belongs to a sibling worker
                    # still mid-transmit; its _on_sent will notify
                    self._win_cond.wait(timeout=0.05)
                    t = max(t, thread_now())
        if t > entry:
            self._clock.set_thread(t)
            with self._lock:
                self._stall_window_s += t - entry

    def _admit_wall(self, nbytes: int) -> None:
        """Real-clock admission: sleep out the remaining round trip of
        the oldest outstanding ACK, re-checking as ACKs mature."""
        t0 = self._clock()
        waited = False
        banked = False
        with self._win_cond:
            while True:
                self._reap(self._clock())
                admitted, banked = self._locked_try_admit(nbytes, banked)
                if admitted:
                    break
                waited = True
                if self._acks:
                    wait_s = max(1e-4, self._acks[0][0] - self._clock())
                    self._win_cond.wait(timeout=wait_s)
                else:
                    self._win_cond.wait(timeout=0.05)
        if waited:
            dt = self._clock() - t0
            with self._lock:
                self._stall_window_s += dt

    def _on_sent(self, nbytes: int, t_sent: float) -> None:
        thread_now = getattr(self._clock, "thread_now", None)
        if thread_now is not None:
            # virtual time: the send completed at this worker's timeline
            # position (its serve's completion), not the global frontier
            t_sent = thread_now()
        # the ACK clock rides the CHANNEL's live round trip when one is
        # observable (a route change physically lengthens every ACK the
        # moment it happens — the ledger must not keep ticking at the
        # planned rtt); the observation accrues to the report so replan
        # can revise HopPlan.rtt_s from the same evidence
        ch_rtt = getattr(self._channel, "rtt_s", None)
        rtt = (float(ch_rtt) if ch_rtt is not None and ch_rtt > 0
               else self.rtt_s)
        with self._win_cond:
            heapq.heappush(self._acks, (t_sent + rtt, nbytes))
            self._rtt_obs_sum += rtt
            self._rtt_obs_n += 1
            self._win_cond.notify_all()

    def resize(self, *, capacity: Optional[int] = None,
               workers: Optional[int] = None,
               window_bytes: Optional[float] = None,
               batch_items: Optional[int] = None,
               rtt_s: Optional[float] = None,
               retry_budget: Optional[int] = None,
               backoff_base_s: Optional[float] = None) -> None:
        if window_bytes is not None and window_bytes > 0 \
                and window_bytes != self.window_bytes:
            with self._win_cond:
                self.window_bytes = float(window_bytes)
                # growth admits credit-blocked workers immediately — the
                # live, zero-drain remedy for a window-bound verdict
                self._win_cond.notify_all()
        if rtt_s is not None and rtt_s > 0 and rtt_s != self.rtt_s:
            # an rtt-revised plan retimes the ACK clock for bytes not yet
            # sent; outstanding ledger entries keep their original ACK
            # instants (those bytes are already in flight on the old path)
            with self._win_cond:
                self.rtt_s = float(rtt_s)
                self._win_cond.notify_all()
        super().resize(capacity=capacity, workers=workers,
                       batch_items=batch_items, retry_budget=retry_budget,
                       backoff_base_s=backoff_base_s)


class StagePipeline:
    """A chain of stages: source iterator -> stage_1 -> ... -> stage_n.

    The caller consumes from ``pipeline.output`` (the last stage's buffer)
    or via iteration.  Every hop runs concurrently; throughput settles at
    the basin bottleneck and each hop's report shows whether it starved
    (upstream too slow) or backpressured (downstream too slow).
    """

    def __init__(self, source: Iterable[Any], stages: Sequence[Stage]):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        # a BurstBuffer source (a dispatcher's branch feed) is pulled
        # directly via get/get_many: the intake gets true slab pulls
        # instead of one-item iterator steps under a lock
        if isinstance(source, BurstBuffer):
            self._source_buffer: Optional[BurstBuffer] = source
            self._source_iter = None
        else:
            self._source_buffer = None
            self._source_iter = iter(source)
        self._source_lock = threading.Lock()
        self._started = False
        # failover kill switch: once set, every pull reads end-of-stream,
        # so an aborted branch stops competing with its surviving
        # siblings for shared-intake items (see abort())
        self._aborted = threading.Event()

    def _source_pull(self) -> Optional[Any]:
        if self._aborted.is_set():
            return None
        with self._source_lock:
            return next(self._source_iter, None)

    def _source_pull_many(self, k: int) -> Optional[list[Any]]:
        if self._aborted.is_set():
            return None
        # one lock round-trip covers the whole slab
        with self._source_lock:
            batch = list(itertools.islice(self._source_iter, k))
        return batch or None

    def _buffer_pull(self, buf: BurstBuffer) -> Callable[[], Optional[Any]]:
        def pull() -> Optional[Any]:
            if self._aborted.is_set():
                return None
            try:
                return buf.get()
            except BufferClosed:
                return None
        return pull

    def _buffer_pull_many(self, buf: BurstBuffer
                          ) -> Callable[[int], Optional[list[Any]]]:
        def pull_many(k: int) -> Optional[list[Any]]:
            if self._aborted.is_set():
                return None
            try:
                return buf.get_many(k)
            except BufferClosed:
                return None
        return pull_many

    def abort(self) -> None:
        """Shut the pipeline down without losing staged items: every pull
        starts reading end-of-stream, and every stage buffer is closed so
        workers blocked mid-put unblock (staged items stay consumable by
        the buffer-close contract).  Branch failover calls this on a dead
        branch before salvaging what it stranded; it never touches a
        shared source buffer, which surviving siblings keep draining."""
        self._aborted.set()
        for st in self.stages:
            st.buffer.close()

    def start(self) -> "StagePipeline":
        if self._started:
            raise RuntimeError("pipeline already started")
        self._started = True
        if self._source_buffer is not None:
            upstream = self._buffer_pull(self._source_buffer)
            upstream_many = self._buffer_pull_many(self._source_buffer)
        else:
            upstream = self._source_pull
            upstream_many = self._source_pull_many
        for stage in self.stages:
            stage.start(upstream, upstream_many)
            upstream = self._buffer_pull(stage.buffer)
            upstream_many = self._buffer_pull_many(stage.buffer)
        return self

    @property
    def output(self) -> BurstBuffer:
        return self.stages[-1].buffer

    def __iter__(self) -> Iterator[Any]:
        if not self._started:
            self.start()
        return self.output.drain()

    def join(self, timeout: Optional[float] = None) -> None:
        for stage in self.stages:
            stage.join(timeout)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join without raising on a failed stage (the failover form)."""
        for stage in self.stages:
            stage.wait(timeout)

    def reports(self) -> list[StageReport]:
        return [s.report() for s in self.stages]

    def bottleneck(self) -> StageReport:
        """The slowest stage by observed throughput (ties to basin model)."""
        reps = self.reports()
        return min(reps, key=lambda r: r.throughput_bytes_per_s or float("inf"))


class ParallelBranchPipeline:
    """Parallel-branch execution: one :class:`StagePipeline` per branch.

    Each branch runs its own stage chain over its own source (a fan-in of
    shard iterators, or the per-branch queues a mover's dispatcher fills
    for fan-out).  Branch outputs drain concurrently into one shared
    merge buffer as ``(branch_id, item)`` pairs — the executable form of
    a fan-in (merge) node — and :meth:`reports` returns every branch's
    stage reports with names tagged ``"<branch>/<stage>"``, the key
    :func:`repro_torch.core.planner.replan` uses for per-branch attribution.
    """

    def __init__(self, branches: Sequence[tuple[str, StagePipeline]], *,
                 merge_capacity: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 upstreams: Optional[dict[str, BurstBuffer]] = None,
                 shared_upstream: Optional[BurstBuffer] = None):
        if not branches:
            raise ValueError("need at least one branch")
        ids = [bid for bid, _ in branches]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate branch ids: {ids}")
        self.branches = list(branches)
        self._clock = clock or time.monotonic
        self.merge: BurstBuffer[tuple[str, Any]] = BurstBuffer(
            merge_capacity, name="branch-merge", clock=self._clock)
        # per-branch feed buffers to close when that branch exits: on a
        # branch failure this unblocks a dispatcher mid-put instead of
        # deadlocking it against a pipeline that stopped pulling
        self._upstreams = dict(upstreams or {})
        # work-stealing route: every branch pulls one shared intake, which
        # must only close when the LAST branch exits (a lone dead branch
        # leaves its siblings pulling; all dead unblocks the dispatcher)
        self._shared_upstream = shared_upstream
        self._drainers: list[threading.Thread] = []
        self._open_branches = 0
        self._lock = threading.Lock()
        self._started = False
        #: stranded items recovered from branches that died mid-segment,
        #: keyed by branch id — items the dead branch had pulled from its
        #: feed but never delivered to the merge.  Under a shared (steal)
        #: intake they are re-queued onto the survivors automatically; a
        #: per-branch (deal) dispatcher claims them via
        #: :meth:`take_stranded` and re-deals.
        self._stranded: dict[str, list] = {}
        self._dead: set[str] = set()

    def _salvage_branch(self, pipe: StagePipeline) -> list:
        """Everything the dead branch pulled but never delivered: items
        in workers' hands when their transforms failed for good, plus
        items parked in inter-stage buffers.  The branch is aborted and
        quiesced first — its pulls read end-of-stream so it stops
        competing with survivors for shared-intake items, and its closed
        buffers keep staged items consumable.  Items re-enter at the
        branch feed level: any transforms the dead branch already applied
        are re-applied by the surviving branch, which double-pays a hop's
        service rather than ever double-counting or dropping an item."""
        pipe.abort()
        for st in pipe.stages:
            st.wait()
        stranded: list = []
        for st in pipe.stages:
            stranded.extend(st.take_salvage())
        # the LAST stage's buffer feeds the merge drainer, which has
        # already drained it to exhaustion — only inter-stage parking
        # (and the stages' in-hand salvage) can strand items
        for st in pipe.stages[:-1]:
            try:
                while True:
                    stranded.extend(st.buffer.get_many(1 << 10))
            except BufferClosed:
                pass
        return stranded

    def start(self) -> "ParallelBranchPipeline":
        if self._started:
            raise RuntimeError("pipeline already started")
        self._started = True
        self._open_branches = len(self.branches)

        def drain(bid: str, pipe: StagePipeline) -> None:
            try:
                for item in pipe.output.drain():
                    try:
                        self.merge.put((bid, item))
                    except BufferClosed:
                        return
            finally:
                up = self._upstreams.get(bid)
                if up is not None:
                    up.close()
                died = any(st.failed for st in pipe.stages)
                stranded = self._salvage_branch(pipe) if died else []
                with self._lock:
                    # last branch out closes the merge (mirror of the
                    # last-worker-out rule inside Stage)
                    self._open_branches -= 1
                    last = self._open_branches == 0
                    if died:
                        self._dead.add(bid)
                        self._stranded.setdefault(bid, []).extend(stranded)
                if died and not last and stranded \
                        and self._shared_upstream is not None:
                    # steal route: hand the dead branch's stranded items
                    # straight back to the shared intake — the surviving
                    # branches pull them like any other work, so nothing
                    # committed to the intake is ever lost to one death
                    claim = self.take_stranded(bid)
                    try:
                        self._shared_upstream.put_many(claim)
                    except BufferClosed:
                        # intake already closed (death at stream tail):
                        # keep the claim stranded so the mover's final
                        # salvage sweep re-moves it instead of losing it
                        with self._lock:
                            self._stranded.setdefault(bid, []).extend(claim)
                if last:
                    if self._shared_upstream is not None:
                        self._shared_upstream.close()
                    self.merge.close()

        for bid, pipe in self.branches:
            pipe.start()
        self._drainers = [
            threading.Thread(target=drain, args=(bid, pipe),
                             name=f"drain-{bid}", daemon=True)
            for bid, pipe in self.branches
        ]
        for t in self._drainers:
            t.start()
        return self

    @property
    def output(self) -> BurstBuffer:
        """The merge buffer; yields ``(branch_id, item)`` pairs."""
        return self.merge

    def dead_branches(self) -> set[str]:
        """Branch ids that died (a stage exhausted its retry budget) —
        the dispatcher-side failover signal."""
        with self._lock:
            dead = set(self._dead)
        # a branch whose stage has failed but whose drainer has not yet
        # unwound still counts: the dispatcher must stop feeding it NOW
        for bid, pipe in self.branches:
            if bid not in dead and any(st.failed for st in pipe.stages):
                dead.add(bid)
        return dead

    def take_stranded(self, bid: str) -> list:
        """Claim (and clear) the items branch ``bid`` stranded when it
        died; the deal-route dispatcher re-deals them to survivors."""
        with self._lock:
            return self._stranded.pop(bid, [])

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        if not self._started:
            self.start()
        return self.merge.drain()

    def join(self, timeout: Optional[float] = None) -> None:
        for _, pipe in self.branches:
            pipe.join(timeout)
        for t in self._drainers:
            t.join(timeout)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Join without raising on dead branches — the failover form:
        survivors' completion is the success criterion, and the dead
        branches' errors are already recorded in :meth:`dead_branches`
        (and surfaced as ``branch-dead`` verdicts by the mover)."""
        for _, pipe in self.branches:
            pipe.wait(timeout)
        for t in self._drainers:
            t.join(timeout)

    def branch_error(self, bid: str) -> str:
        """First line of the recorded error for a dead branch ('' when
        none) — the obituary text a ``branch-dead(...)`` verdict carries."""
        for b, pipe in self.branches:
            if b != bid:
                continue
            for st in pipe.stages:
                tb = st.error_summary()
                if tb:
                    return tb
        return ""

    def reports(self) -> list[StageReport]:
        """Every branch's stage reports, names tagged ``<branch>/<stage>``."""
        out: list[StageReport] = []
        for bid, pipe in self.branches:
            for r in pipe.reports():
                out.append(dataclasses.replace(r, name=f"{bid}/{r.name}"))
        return out


def _default_sizeof(x: Any) -> int:
    nbytes = getattr(x, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return len(x)
    if isinstance(x, (tuple, list)):
        return sum(_default_sizeof(e) for e in x)
    if isinstance(x, dict):
        return sum(_default_sizeof(v) for v in x.values())
    return 0
