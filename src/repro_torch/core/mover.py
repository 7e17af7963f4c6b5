"""Unified data mover — one engine for every tier (the paper's zx analogue).

Paper Table 1 / section 2.1: a *single*, concurrent, scale-out data mover
manages the complete placement workflow "from source storage through
transit to destination storage", supporting bulk and streaming transfers,
with integrity built in, at every basin tier.

:class:`UnifiedDataMover` is that engine for this framework.  The same
object moves

* dataset batches        host storage  -> host burst buffer -> device feed,
* checkpoint shards      device        -> host burst buffer -> storage,
* decode token streams   device        -> host burst buffer -> client sink,

in either **bulk** mode (the dataset fully exists before the transfer
starts) or **streaming** mode (the source is still producing — transfer
overlaps production).  Integrity checksums (the paper's encryption/
checksumming budget, section 3.4) are computed *inside the staged path* so
they overlap transit instead of serializing with it.

Branching basins run through :meth:`UnifiedDataMover.parallel_transfer`:
one stage pipeline per branch of a multipath
:class:`~repro_torch.core.planner.TransferPlan`, fed by a dispatcher that either
**splits** the stream across branches (weighted by the plan's per-branch
traffic shares — the fan-out/fan-in case) or **mirrors** every item down
every branch (the replication case: a dual-tier checkpoint, a decode
fan-out to many clients).  Branch reports come back tagged
``"<branch>/<stage>"`` so online replanning attributes a mid-transfer
stall to the one degraded branch and rebalances traffic toward the
healthy ones.

Every transfer returns a :class:`TransferReport` carrying achieved
throughput and the fidelity gap against the planned basin — making the
paper's headline metric a first-class, always-on observable.

Zero-drain replanning (the default hot path)
--------------------------------------------

Online replanning (``replan_every_items``) used to buy adaptivity with a
teardown bubble: every boundary drained the buffer path and rebuilt the
stage pipeline from scratch, so a long stream repeatedly fell off line
rate exactly when the plan was being corrected — the class of host-side
self-inflicted stall arXiv:2308.10312 identifies as a dominant cause of
sub-provisioned throughput.  The hot path is now **zero-drain**: one
persistent pipeline per transfer, kept alive across revision boundaries.
A revision is computed from the boundary *window*'s evidence
(:func:`~repro_torch.core.staging.delta_reports` over the running stages'
cumulative counters) and applied as a
:func:`~repro_torch.core.planner.plan_delta` to the live pipeline — buffers
resize in place, worker pools grow/retire against the live queues, and
the split dispatcher swaps branch weights without stopping — so the data
path sustains the paper's deterministic supply *through* the correction.
Segment boundaries are demoted to accounting-only checkpoints; the
stream-wide checksum and merged :class:`StageReport` observables are
identical to the drain-per-segment path (equivalence-tested), which
remains available as ``drain_per_segment=True`` for comparison
(``benchmarks/live_swap.py`` measures the removed bubble).

Split-mode dispatch additionally offers ``route="steal"``: a pull-based
work-stealing route where every branch pulls from one shared intake, so
a transiently slow branch stops accumulating queued items *within* a
segment instead of waiting for the next weight rebalance (at the cost of
scripted routing determinism).  Replanning under stealing attributes per
branch from **pull rates** at the shared intake (bytes per busy
worker-second — see :meth:`UnifiedDataMover._steal_intake`), since a
shared queue backpressures nobody in particular.  Fan-out deliveries can
run through a per-client drainer pool (``drainer_pool=True``) so one
blocking client write no longer serializes its siblings at the merge
buffer.

Windowed (RTT-governed) hops
----------------------------

A plan hop whose segment crosses a latency-bearing link carries a
``window_bytes``/``rtt_s`` pair, and every execution path — bulk,
streaming, and both parallel modes — builds that hop as a
:class:`~repro_torch.core.staging.WindowedStage` (the single
:meth:`UnifiedDataMover._make_stage` seam): in-flight bytes are capped
at the window and credit returns one RTT after transmission, so an
under-windowed CHANNEL delivers ``window / RTT`` however much bandwidth
is provisioned — the paper's §3.1/§3.2 collapse, executable.  A
window-bound verdict's remedy applies **zero-drain**: the live swap
grows the running stage's window (``Stage.resize(window_bytes=...)``)
and credit-blocked workers wake into the new credit immediately.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Iterator, Mapping, Optional, \
    Sequence

from .basin import DrainageBasin
from .burst_buffer import BufferClosed, BurstBuffer
# the integrity seam moved to core.integrity (host vs accelerator digest
# placement); re-exported under the historical names for importers
from .integrity import StreamDigest as _StreamDigest, as_bytes as _as_bytes
from .planner import BranchPlan, HopPlan, STALL_THRESHOLD, TransferPlan, \
    plan_delta, replan as _replan
from .staging import ParallelBranchPipeline, SERVICE_RESERVOIR, Stage, \
    StagePipeline, StageReport, WindowedStage, _default_sizeof, \
    delta_reports, iter_segments, merge_reports
from .telemetry import TelemetryRegistry

__all__ = ["MIRROR_BATCH", "MoverConfig", "TransferReport",
           "UnifiedDataMover", "_StreamDigest", "_as_bytes"]

#: items replicated per ``put_many`` batch by the mirror-mode dispatcher
#: (one lock round-trip per branch queue per batch instead of per item)
MIRROR_BATCH = 8

#: a live-window intake flag only holds when the flagged branch is also
#: at least this much slower per byte (busy time) than the fastest
#: branch — see UnifiedDataMover._validated_intake
BUSY_CULPRIT_RATIO = 1.5


@dataclasses.dataclass
class TransferReport:
    """Outcome of one end-to-end transfer."""

    mode: str                       # "bulk" | "streaming"
    items: int
    bytes: int
    elapsed_s: float
    stage_reports: list[StageReport]
    checksum: Optional[str] = None  # hex digest over the item stream
    planned_bytes_per_s: Optional[float] = None
    #: online plan revisions applied mid-transfer (``replan_every_items``)
    replans: int = 0
    #: execution shape the transfer finished on (``TransferPlan.path``) —
    #: differs from the initial choice when a ``path-revised`` verdict
    #: switched shapes mid-stream
    path: Optional[str] = None

    @property
    def throughput_bytes_per_s(self) -> float:
        return self.bytes / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def fidelity_gap(self) -> Optional[float]:
        """1 - achieved/planned (paper section 1).  None without a plan."""
        if not self.planned_bytes_per_s:
            return None
        return 1.0 - self.throughput_bytes_per_s / self.planned_bytes_per_s

    def bottleneck_stage(self) -> Optional[StageReport]:
        if not self.stage_reports:
            return None
        return min(self.stage_reports,
                   key=lambda r: r.throughput_bytes_per_s or float("inf"))


def _drain_batched(buf: BurstBuffer,
                   batch: int = MIRROR_BATCH) -> Iterator[Any]:
    """Drain a buffer via ``get_many``: one lock round-trip per batch of
    *already-staged* items.  Unlike put-side batching this adds no
    latency — ``get_many`` returns immediately with at least one item —
    it only stops the hot merge-drain loop paying one lock acquisition
    per item."""
    batch = max(1, batch)
    while True:
        try:
            out = buf.get_many(batch)
        except BufferClosed:
            return
        yield from out


class _DrainerPool:
    """Per-client drainer pool for fan-out deliveries.

    The merge buffer of a parallel-branch transfer drains in one loop; a
    delivery callable that blocks (one slow client write) would therefore
    serialize every sibling behind it.  The pool gives each branch/client
    its own small burst buffer plus one drainer thread, so a blocking
    write stalls only its own client's queue while siblings keep
    receiving — the buffer-decoupling story of §2.1 applied to the last
    hop.  A client whose sink raises is retired: its error is kept for
    :meth:`close` and later deliveries to it are dropped (reported via
    the ``False`` return of :meth:`submit`) instead of failing siblings
    mid-stream."""

    def __init__(self, sinks: Mapping[str, Callable[[Any], None]],
                 capacities: Mapping[str, int],
                 clock: Callable[[], float]):
        self._bufs: dict[str, BurstBuffer] = {}
        self._threads: list[threading.Thread] = []
        self._errors: dict[str, str] = {}
        self._lock = threading.Lock()
        for bid, fn in sinks.items():
            buf: BurstBuffer = BurstBuffer(max(1, capacities.get(bid, 8)),
                                           name=f"{bid}.deliver", clock=clock)
            self._bufs[bid] = buf
            t = threading.Thread(target=self._drain, args=(bid, buf, fn),
                                 name=f"deliver-{bid}", daemon=True)
            self._threads.append(t)
            t.start()

    def _drain(self, bid: str, buf: BurstBuffer,
               fn: Callable[[Any], None]) -> None:
        try:
            for item in buf.drain():
                fn(item)
        except Exception:
            with self._lock:
                self._errors[bid] = traceback.format_exc()
            buf.close()      # unblock a submitter; later deliveries drop

    def submit(self, bid: str, item: Any) -> bool:
        """Queue one delivery; False when the client already failed."""
        try:
            self._bufs[bid].put(item)
            return True
        except BufferClosed:
            return False

    def close(self) -> None:
        """End-of-stream: drain every queue, join drainers, surface the
        first client failure (siblings completed their own streams)."""
        for buf in self._bufs.values():
            buf.close()
        for t in self._threads:
            t.join()
        if self._errors:
            bid, tb = sorted(self._errors.items())[0]
            raise RuntimeError(f"client sink {bid!r} failed:\n{tb}")


@dataclasses.dataclass
class MoverConfig:
    """Global tuning (paper section 2.3): one configuration effective across
    item sizes spanning orders of magnitude.  Per-transfer overrides are
    accepted by the transfer methods (the paper's hierarchical tuning)."""

    staging_capacity: int = 4       # slots per burst buffer
    staging_workers: int = 2        # concurrent movers per hop
    checksum: bool = True           # integrity over the item stream
    name: str = "zx-torch"
    #: where an accelerator-placed digest computes: None = the card
    #: (``"cuda"``; raises without one), ``"cpu"`` = the kernel's plain
    #: version, for tests on a machine without a card
    device: Optional[str] = None


class UnifiedDataMover:
    """Moves item streams through a staged, buffered, instrumented path.

    Staging parameters come from (in precedence order) a
    :class:`~repro_torch.core.planner.TransferPlan` — per-hop capacity/workers
    derived from the basin model — then per-call overrides, then the
    uniform :class:`MoverConfig` defaults.  With ``telemetry`` set, every
    :class:`TransferReport` is recorded there under ``layer``.
    """

    def __init__(self, config: MoverConfig | None = None,
                 basin: DrainageBasin | None = None,
                 plan: TransferPlan | None = None,
                 telemetry: TelemetryRegistry | None = None,
                 layer: str | None = None,
                 clock: Callable[[], float] | None = None):
        self.config = config or MoverConfig()
        self.plan = plan
        self.basin = basin or (plan.basin if plan is not None else None)
        self.telemetry = telemetry
        self.layer = layer or self.config.name
        # injectable for the deterministic simulated-basin test harness
        self._clock = clock or time.monotonic
        #: the plan the most recent transfer ended on (== its starting
        #: plan unless online replanning revised it mid-transfer)
        self.last_plan: TransferPlan | None = plan

    # -- internal ------------------------------------------------------------

    def _stage_params(
        self,
        transforms: Sequence[tuple[str, Any]],
        plan: Optional[TransferPlan],
        capacity: Optional[int],
        workers: Optional[int],
    ) -> list[tuple[int, int, Optional[HopPlan]]]:
        """(capacity, workers, hop) per stage: plan-derived per hop, or
        uniform with no hop (and so no transport window)."""
        n = max(1, len(transforms))
        if plan is not None:
            names = [name for name, _ in transforms] or ["stage"]
            hops = [plan.hop_for(i, name) for i, name in enumerate(names)]
            return [(capacity or h.capacity, workers or h.workers, h)
                    for h in hops]
        cap = capacity or self.config.staging_capacity
        wrk = workers or self.config.staging_workers
        return [(cap, wrk, None)] * n

    def _make_stage(self, name: str, capacity: int, workers: int,
                    transform: Optional[Callable[[Any], Any]],
                    hop: Optional[HopPlan],
                    batch_items: Optional[int] = None) -> Stage:
        """One staging hop — a :class:`~repro_torch.core.staging.WindowedStage`
        when the plan marks the segment RTT-governed (a CHANNEL hop whose
        in-flight bytes are capped at the plan's ``window_bytes``), a
        queue-clocked :class:`~repro_torch.core.staging.Stage` otherwise.  This
        is the single seam every execution path builds hops through, so
        windowed transport — and the zero-copy slab size
        (``batch_items``, a per-call override or the plan hop's) — rides
        bulk, streaming, and both parallel paths alike."""
        batch = self._hop_batch(hop, batch_items)
        # the plan staffs the hop's fault posture too: transient faults
        # retry with exponential backoff inside the stage (charged to
        # StageReport.retries/retry_wait_s — the fault-degraded verdict's
        # evidence); an unplanned stage keeps the historical fail-fast
        retry = dict(retry_budget=hop.retry_budget,
                     backoff_base_s=hop.backoff_base_s) \
            if hop is not None else {}
        if hop is not None and hop.window_bytes > 0 and hop.rtt_s > 0:
            return WindowedStage(name, capacity=capacity, workers=workers,
                                 transform=transform, clock=self._clock,
                                 window_bytes=hop.window_bytes,
                                 rtt_s=hop.rtt_s, batch_items=batch,
                                 **retry)
        return Stage(name, capacity=capacity, workers=workers,
                     transform=transform, clock=self._clock,
                     batch_items=batch, **retry)

    @staticmethod
    def _hop_window(hop: Optional[HopPlan]) -> Optional[float]:
        """The resize argument carrying a hop's revised window (None when
        the hop is queue-clocked — base stages ignore it)."""
        if hop is not None and hop.window_bytes > 0:
            return hop.window_bytes
        return None

    @staticmethod
    def _hop_rtt(hop: Optional[HopPlan]) -> Optional[float]:
        """The resize argument carrying a hop's revised round trip (None
        when the hop is queue-clocked — base stages ignore it).  An
        rtt-revised verdict's remedy rides the same zero-drain swap as a
        window raise: the running WindowedStage re-clocks its ACK ledger
        to the revised RTT without dropping a staged item."""
        if hop is not None and hop.window_bytes > 0 and hop.rtt_s > 0:
            return hop.rtt_s
        return None

    @staticmethod
    def _hop_batch(hop: Optional[HopPlan],
                   batch_items: Optional[int] = None) -> int:
        """Effective slab size for a hop: the per-call override wins
        (the benchmark's per-item baseline forces 1 against a batched
        plan), else the plan hop's ``batch_items``, else per-item."""
        if batch_items is not None:
            return max(1, int(batch_items))
        return hop.batch_items if hop is not None else 1

    @staticmethod
    def _hop_retry(hop: Optional[HopPlan]) -> dict:
        """Resize kwargs carrying a hop's revised fault posture — a
        fault-degraded element's re-priced ``retry_budget`` /
        ``backoff_base_s`` apply to the running stage at the same
        zero-drain boundary as a window raise.  Empty for unplanned hops
        (those keep their construction-time posture)."""
        if hop is None:
            return {}
        return {"retry_budget": hop.retry_budget,
                "backoff_base_s": hop.backoff_base_s}

    def _deal_batch(self, plan: TransferPlan,
                    batch_items: Optional[int] = None) -> int:
        """Split-node slab size: the smallest first-hop batch across
        branches (every branch intake must absorb a dealt slab without
        overrunning its queue).  Ordered plans stay per-item — holding
        tokens to fill a slab would trade delivery latency for lock
        traffic, the same rule mirror batching follows."""
        if plan.ordered or not plan.branches:
            return 1
        return max(1, min(self._hop_batch(b.hops[0], batch_items)
                          for b in plan.branches))

    def _build_pipeline(
        self,
        source: Iterable[Any],
        transforms: Sequence[tuple[str, Callable[[Any], Any]]],
        params: Sequence[tuple[int, int, Optional[HopPlan]]],
        plan: Optional[TransferPlan] = None,
        batch_items: Optional[int] = None,
    ) -> StagePipeline:
        default_name = plan.hops[0].name if plan is not None else "stage"
        stages = [
            self._make_stage(name, cap, wrk, fn, hop, batch_items)
            for (name, fn), (cap, wrk, hop) in zip(transforms, params)
        ] or [self._make_stage(default_name, params[0][0], params[0][1],
                               None, params[0][2], batch_items)]
        return StagePipeline(source, stages)

    @staticmethod
    def _fold_checksum_report(plan: Optional[TransferPlan],
                              reports: Sequence[StageReport]
                              ) -> list[StageReport]:
        """Fold the executed checksum stage's report into its charged
        hop's report before ``replan`` sees the window.

        The digest runs as its own pipeline stage while the *plan*
        charges its budget to the hop at ``checksum_index``
        (``digest_bytes_per_s``) — so the live "checksum" report matched
        no hop name and the host-compute-bound verdict could only ever
        fire on recorded/replayed reports, never on a run.  Merging the
        pair makes the live path speak the plan's accounting language:
        items/bytes are the hop's, the time base is the slower of the
        two (they overlap in the pipeline), the stalls on the buffer
        *between* the pair are dropped (internal coupling of the merged
        stages, not channel evidence) while both outer stall sides
        survive, and the transport ledger (window stalls, retransmits,
        ACK spacing) sums."""
        out = list(reports)
        if plan is None or plan.checksum_index is None or not plan.hops:
            return out
        hop = plan.hops[min(plan.checksum_index, len(plan.hops) - 1)]
        if hop.name == "checksum":
            return out
        i_sum = next((i for i, r in enumerate(out)
                      if r.name == "checksum"), None)
        i_hop = next((i for i, r in enumerate(out)
                      if r.name == hop.name), None)
        if i_sum is None or i_hop is None:
            return out
        sum_rep, hop_rep = out[i_sum], out[i_hop]
        first, second = ((sum_rep, hop_rep) if i_sum < i_hop
                         else (hop_rep, sum_rep))
        out[i_hop] = dataclasses.replace(
            hop_rep,
            elapsed_s=max(hop_rep.elapsed_s, sum_rep.elapsed_s),
            active_s=max(hop_rep.active_s, sum_rep.active_s),
            stall_up_s=first.stall_up_s,
            stall_down_s=second.stall_down_s,
            stall_window_s=hop_rep.stall_window_s + sum_rep.stall_window_s,
            errors=hop_rep.errors + sum_rep.errors,
            retransmits=hop_rep.retransmits + sum_rep.retransmits,
            rtt_sum_s=hop_rep.rtt_sum_s + sum_rep.rtt_sum_s,
            acks=hop_rep.acks + sum_rep.acks,
            service_up_s=(list(first.service_up_s)
                          + list(second.service_up_s))[-SERVICE_RESERVOIR:],
            service_down_s=(list(first.service_down_s)
                            + list(second.service_down_s)
                            )[-SERVICE_RESERVOIR:],
        )
        del out[i_sum]
        return out

    def _record(self, report: TransferReport) -> TransferReport:
        if self.telemetry is not None:
            self.telemetry.record(self.layer, report)
        return report

    def _run_live(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        all_transforms: Sequence[tuple[str, Callable[[Any], Any]]],
        capacity: Optional[int],
        workers: Optional[int],
        plan: Optional[TransferPlan],
        chunk: int,
        damping: float,
        batch_items: Optional[int] = None,
    ) -> tuple[int, int, list[StageReport], int, Optional[TransferPlan]]:
        """The zero-drain hot path: ONE persistent pipeline for the whole
        transfer.  Revision boundaries are accounting-only checkpoints —
        the window's evidence (cumulative-counter deltas) feeds ``replan``
        and the resulting :class:`~repro_torch.core.planner.PlanDelta` is
        applied to the running stages in place (buffer resize, worker
        spawn/retire), so no staged item drains and the supply never
        falls off line rate while the plan is being corrected."""
        active = plan
        params = self._stage_params(all_transforms, active, capacity,
                                    workers)
        pipeline = self._build_pipeline(iter(source), all_transforms,
                                        params, active, batch_items)
        pipeline.start()
        items = 0
        nbytes = 0
        replans = 0
        prev_cum: list[StageReport] = []
        boundary = chunk
        # a batched last hop stages whole slabs: drain them the same way
        # (one get_many lock round-trip per slab) instead of re-serializing
        # the sink loop to one lock acquisition per item
        out_batch = self._hop_batch(params[-1][2], batch_items)
        out_iter = (pipeline.output.drain() if out_batch <= 1
                    else _drain_batched(pipeline.output, out_batch))
        for item in out_iter:
            sink(item)
            items += 1
            nbytes += _default_sizeof(item)
            if chunk and items >= boundary:
                boundary += chunk
                cum = pipeline.reports()
                window = delta_reports(cum, prev_cum)
                prev_cum = cum
                for st in pipeline.stages:
                    # windows must not re-diagnose a consumed regime
                    st.reset_service_reservoirs()
                if not window:
                    continue
                revised = _replan(
                    active, self._fold_checksum_report(active, window),
                    damping=damping)
                delta = plan_delta(active, revised)
                active = revised
                if delta:
                    replans += 1
                    new_params = self._stage_params(all_transforms, active,
                                                    capacity, workers)
                    for st, (cap, wrk, hop) in zip(pipeline.stages,
                                                   new_params):
                        st.resize(capacity=cap, workers=wrk,
                                  window_bytes=self._hop_window(hop),
                                  rtt_s=self._hop_rtt(hop),
                                  batch_items=self._hop_batch(hop,
                                                              batch_items),
                                  **self._hop_retry(hop))
        pipeline.join()
        return items, nbytes, pipeline.reports(), replans, active

    def _run_segmented(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        all_transforms: Sequence[tuple[str, Callable[[Any], Any]]],
        capacity: Optional[int],
        workers: Optional[int],
        plan: Optional[TransferPlan],
        chunk: int,
        damping: float,
        batch_items: Optional[int] = None,
    ) -> tuple[int, int, list[StageReport], int, Optional[TransferPlan]]:
        """The historical drain-per-segment path: tear the pipeline down
        at every boundary and rebuild it on the revised plan.  Kept as an
        explicit fallback (``drain_per_segment=True``) — it is the
        baseline the zero-drain path is equivalence-tested and benchmarked
        against (``benchmarks/live_swap.py``)."""
        active = plan
        merged: list[StageReport] = []      # folded incrementally: bounded
        last_reports: list[StageReport] = []
        replans = 0
        items = 0
        nbytes = 0
        for segment in iter_segments(iter(source), chunk):
            if last_reports:
                # buffer boundary: the previous segment fully drained, so
                # the plan can swap without dropping staged items
                # (hypothesis -> change -> measure, mid-transfer)
                revised = _replan(
                    active, self._fold_checksum_report(active, last_reports),
                    damping=damping)
                # same revision signature as the live path (plan_delta),
                # so the two execution modes count replans identically
                if plan_delta(active, revised):
                    replans += 1
                active = revised
            params = self._stage_params(all_transforms, active, capacity,
                                        workers)
            pipeline = self._build_pipeline(segment, all_transforms, params,
                                            active, batch_items)
            pipeline.start()
            out_batch = self._hop_batch(params[-1][2], batch_items)
            out_iter = (pipeline.output.drain() if out_batch <= 1
                        else _drain_batched(pipeline.output, out_batch))
            for item in out_iter:
                sink(item)
                items += 1
                nbytes += _default_sizeof(item)
            pipeline.join()
            last_reports = pipeline.reports()
            merged = merge_reports([merged, last_reports])
        return items, nbytes, merged, replans, active

    def _run(
        self,
        mode: str,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        transforms: Sequence[tuple[str, Callable[[Any], Any]]],
        capacity: Optional[int],
        workers: Optional[int],
        checksum: Optional[bool],
        plan: Optional[TransferPlan],
        replan_every_items: int = 0,
        replan_damping: float = 0.5,
        drain_per_segment: bool = False,
        batch_items: Optional[int] = None,
    ) -> TransferReport:
        own_plan = plan is None
        plan = plan if plan is not None else self.plan
        do_sum = self.config.checksum if checksum is None else checksum

        # order-independent integrity: concurrent staging workers may
        # deliver items out of order (see _StreamDigest).  The plan
        # decides where the digest computes (host SHA-256 vs the
        # accelerator lattice kernel) — the §3.4 compute-budget placement.
        placement = plan.checksum_placement if plan is not None else "host"
        digest = _StreamDigest(do_sum, placement=placement,
                               device=self.config.device)

        all_transforms = list(transforms)
        if do_sum:
            # checksum rides inside the staged path — overlapped, not
            # serial.  With a plan it rides the hop with the most
            # bandwidth headroom (planner.checksum_index); otherwise it
            # trails the path.  The digest object itself is the transform
            # (callable per item, `.many` per slab) so a batched hop
            # folds a whole slab under one lock acquisition.
            at = len(all_transforms)
            if plan is not None and plan.checksum_index is not None:
                at = min(plan.checksum_index, at)
            all_transforms.insert(at, ("checksum", digest))

        # online replanning needs a plan to revise; without one the
        # transfer runs as a single segment
        chunk = replan_every_items if plan is not None else 0
        t0 = self._clock()
        if drain_per_segment and chunk:
            items, nbytes, merged, replans, active = self._run_segmented(
                source, sink, all_transforms, capacity, workers, plan,
                chunk, replan_damping, batch_items)
        else:
            items, nbytes, merged, replans, active = self._run_live(
                source, sink, all_transforms, capacity, workers, plan,
                chunk, replan_damping, batch_items)
        elapsed = self._clock() - t0
        self.last_plan = active
        if own_plan and self.plan is not None:
            # the mover owns the plan: online revisions persist to the
            # next transfer (the checkpoint engine replans across saves)
            self.plan = active

        if plan is not None:
            planned = plan.planned_bytes_per_s
        else:
            planned = self.basin.achievable_throughput() if self.basin else None
        return self._record(TransferReport(
            mode=mode,
            items=items,
            bytes=nbytes,
            elapsed_s=elapsed,
            stage_reports=merged,
            checksum=digest.hexdigest(),
            planned_bytes_per_s=planned,
            replans=replans,
            path=active.path if active is not None else None,
        ))

    # -- public API -----------------------------------------------------------

    def bulk_transfer(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        *,
        transforms: Sequence[tuple[str, Callable[[Any], Any]]] = (),
        capacity: Optional[int] = None,
        workers: Optional[int] = None,
        checksum: Optional[bool] = None,
        plan: Optional[TransferPlan] = None,
        replan_every_items: int = 0,
        replan_damping: float = 0.5,
        drain_per_segment: bool = False,
        batch_items: Optional[int] = None,
    ) -> TransferReport:
        """Move a dataset at rest (paper section 2.2, *Bulk Transfer*).

        ``replan_every_items > 0`` makes the transfer *self-revising*: the
        observed stall ratios and service-time samples of each revision
        window feed :func:`~repro_torch.core.planner.replan`, and the revised
        plan is applied **zero-drain** to the one persistent pipeline
        (buffers resize in place, worker pools grow/retire live) — a
        mid-transfer regime shift is answered mid-transfer with no
        teardown bubble.  ``drain_per_segment=True`` selects the
        historical segment-drain-and-rebuild path instead (the
        equivalence/benchmark baseline).

        ``batch_items`` overrides the slab size on every hop (1 forces
        the per-item path against a batched plan — the benchmark
        baseline; None defers to the plan's per-hop ``batch_items``)."""
        return self._run("bulk", source, sink, transforms, capacity, workers,
                         checksum, plan, replan_every_items, replan_damping,
                         drain_per_segment, batch_items)

    def streaming_transfer(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        *,
        transforms: Sequence[tuple[str, Callable[[Any], Any]]] = (),
        capacity: Optional[int] = None,
        workers: Optional[int] = None,
        checksum: Optional[bool] = None,
        plan: Optional[TransferPlan] = None,
        replan_every_items: int = 0,
        replan_damping: float = 0.5,
        drain_per_segment: bool = False,
        batch_items: Optional[int] = None,
    ) -> TransferReport:
        """Move a still-growing stream (paper section 2.2, *Streaming
        Transfer*): the source iterator may block while data is produced;
        staging overlaps production with transit, which is exactly what the
        buffer path provides.  Identical machinery, different source
        contract — the unified-mover property.  ``replan_every_items``
        revises the plan online, applied zero-drain to the persistent
        pipeline as in :meth:`bulk_transfer`; ``batch_items`` overrides
        the per-hop slab size."""
        return self._run("streaming", source, sink, transforms, capacity,
                         workers, checksum, plan, replan_every_items,
                         replan_damping, drain_per_segment, batch_items)

    # -- parallel-branch path (DAG plans) --------------------------------------

    def _branch_pipelines(
        self,
        plan: TransferPlan,
        transforms: Sequence[tuple[str, Callable[[Any], Any]]]
        | Mapping[str, Sequence[tuple[str, Callable[[Any], Any]]]],
        capacity: Optional[int],
        workers: Optional[int],
        route: str = "deal",
        batch_items: Optional[int] = None,
    ) -> tuple[dict[str, BurstBuffer], ParallelBranchPipeline]:
        """Per-branch input queue + stage chain from a multipath plan.

        ``route="steal"`` wires every branch to ONE shared intake queue
        (sized to the branches' aggregate first-hop capacity): branches
        pull items as they free up instead of being dealt a share, so a
        transiently slow branch self-throttles within the segment.  Each
        intake queue is handed to its :class:`StagePipeline` as a
        BurstBuffer (not a drain iterator), so a batched first hop pulls
        true slabs — one ``get_many`` lock round-trip per slab."""
        queues: dict[str, BurstBuffer] = {}
        branches: list[tuple[str, StagePipeline]] = []
        shared: Optional[BurstBuffer] = None
        if route == "steal":
            agg = sum(b.hops[0].capacity for b in plan.branches)
            shared = BurstBuffer(capacity or max(1, agg),
                                 name="steal.inq", clock=self._clock)
        for b in plan.branches:
            tf = (transforms.get(b.branch_id, ())
                  if isinstance(transforms, Mapping) else transforms)
            named = list(tf) or [(b.hops[0].name, None)]
            stages = []
            for i, (name, fn) in enumerate(named):
                hop = b.hop_for(i, name)
                stages.append(self._make_stage(
                    name, capacity or hop.capacity,
                    workers or hop.workers, fn, hop, batch_items))
            if shared is not None:
                q = shared
            else:
                q = BurstBuffer(b.hops[0].capacity,
                                name=f"{b.branch_id}.inq", clock=self._clock)
            queues[b.branch_id] = q
            branches.append((b.branch_id, StagePipeline(q, stages)))
        pbp = ParallelBranchPipeline(
            branches, clock=self._clock,
            upstreams=None if shared is not None else queues,
            shared_upstream=shared)
        return queues, pbp

    def _salvage_pass(
        self,
        branch: BranchPlan,
        leftovers: list,
        deliver: Callable[[Any], bool],
        transforms,
        capacity: Optional[int],
        workers: Optional[int],
        batch_items: Optional[int],
    ) -> tuple[int, int, list[StageReport]]:
        """Re-move a dead branch's claimed-but-undelivered items down ONE
        surviving branch.

        Failover's last mile: items a dead branch pulled from its feed
        but never delivered (in-hand when the fault struck, or parked in
        its inter-stage buffers) are re-staged through a fresh copy of a
        survivor's hop chain and delivered under the survivor's id.  The
        stream digest is NOT part of these stages — in parallel mode it
        folds once at the split node, and every salvaged item was hashed
        there before it was ever dealt, so re-moving never re-counts."""
        tf = (transforms.get(branch.branch_id, ())
              if isinstance(transforms, Mapping) else transforms)
        named = list(tf) or [(branch.hops[0].name, None)]
        stages = []
        for i, (name, fn) in enumerate(named):
            hop = branch.hop_for(i, name)
            stages.append(self._make_stage(
                name, capacity or hop.capacity,
                workers or hop.workers, fn, hop, batch_items))
        pipe = StagePipeline(iter(leftovers), stages)
        pipe.start()
        items = 0
        nbytes = 0
        for item in pipe.output.drain():
            if deliver(item):
                items += 1
                nbytes += _default_sizeof(item)
        pipe.join()
        return items, nbytes, [
            dataclasses.replace(r, name=f"salvage/{r.name}")
            for r in pipe.reports()]

    @staticmethod
    def _dispatch(segment: Iterator[Any], queues: dict[str, BurstBuffer],
                  weights: dict[str, float], order: Sequence[str],
                  mode: str, on_item: Callable[[Any], Any],
                  route: str = "deal",
                  mirror_batch: int = MIRROR_BATCH,
                  err_out: Optional[list[str]] = None,
                  deal_batch: int = 1
                  ) -> Callable[[], None]:
        """The split/merge node, executable: pulls the source and routes.

        ``split`` + ``route="deal"``: weighted deficit round-robin over
        ``weights`` — deterministic routing, so a simulated run is a pure
        function of the script.  ``weights`` is read live per item: a
        zero-drain plan revision swaps new branch shares into the dict and
        the running dispatcher re-deals from the next item on.  ``split``
        + ``route="steal"``: every item goes to the shared intake queue;
        branches pull as they free up (self-balancing, not scripted).
        ``mirror``: every item goes down every branch (replication),
        batched ``mirror_batch`` deep — one ``put_many`` lock round-trip
        per branch per batch — pacing at the slowest branch's intake.
        The caller passes ``mirror_batch=1`` for ordered (latency-
        sensitive) streams, where holding tokens to fill a batch would
        trade delivery latency for lock traffic.

        ``deal_batch > 1`` routes split-mode traffic in whole slabs: the
        digest folds the slab in one lock acquisition (``on_item.many``
        when present), a dealt slab goes to ONE branch with its deficit
        debited by the slab size (long-run shares unchanged), and the
        steal intake takes one ``put_many`` per slab — the split node's
        share of the zero-copy batch admission.  ``deal_batch=1`` is the
        historical per-item dispatch, byte for byte.
        """
        deficits = {bid: 0.0 for bid in order}
        on_many = getattr(on_item, "many", None)
        # branches whose intake is still open: a put that raises
        # BufferClosed mid-stream means that branch DIED (its pipeline
        # aborted and closed its feed) — the dispatcher fails the branch
        # over instead of aborting the whole transfer, re-routing every
        # future item through the survivors via the same live-weights
        # seam a zero-drain revision uses
        live = list(order)

        def fold(batch: list[Any]) -> None:
            if on_many is not None:
                on_many(batch)
            else:
                for it in batch:
                    on_item(it)

        def drop(bid: str) -> None:
            live.remove(bid)
            weights[bid] = 0.0      # the zero-drain weight swap, forced

        def deal(batch: list[Any]) -> bool:
            """Route one slab/item to the highest-deficit live branch,
            failing over on a closed intake; False = no branch left."""
            n = float(len(batch))
            for bid in live:
                deficits[bid] += weights[bid] * n
            while live:
                # weights is read live: a zero-drain revision swaps new
                # (pre-normalized) shares in without stopping us
                pick = max(live, key=lambda bid: deficits[bid])
                try:
                    if len(batch) == 1 and deal_batch <= 1:
                        queues[pick].put(batch[0])
                    else:
                        queues[pick].put_many(batch)
                    deficits[pick] -= n
                    return True
                except BufferClosed:
                    drop(pick)
            return False

        def replicate(batch: list[Any]) -> bool:
            """Mirror one batch down every live replica; a dead replica
            is dropped (the mirror promise re-prices to the survivors).
            False = every replica is gone."""
            fold(batch)             # each source item hashed once
            for bid in list(live):
                try:
                    queues[bid].put_many(batch)
                except BufferClosed:
                    drop(bid)
            return bool(live)

        def run() -> None:
            try:
                if mode == "mirror":
                    batch: list[Any] = []
                    for item in segment:
                        batch.append(item)
                        if len(batch) >= mirror_batch:
                            if not replicate(batch):
                                return
                            batch = []
                    if batch:
                        replicate(batch)
                    return
                if route == "steal":
                    # ONE shared intake: it only closes when the LAST
                    # branch died (ParallelBranchPipeline's contract), so
                    # a lone death needs no dispatcher action — survivors
                    # keep pulling and the dead branch's stranded items
                    # re-enter the same queue
                    shared = queues[order[0]]
                    if deal_batch > 1:
                        for wave in iter_segments(segment, deal_batch):
                            batch = list(wave)
                            fold(batch)
                            shared.put_many(batch)
                    else:
                        for item in segment:
                            on_item(item)
                            shared.put(item)
                    return
                if deal_batch > 1:
                    for wave in iter_segments(segment, deal_batch):
                        batch = list(wave)
                        fold(batch)
                        if not deal(batch):
                            return
                    return
                for item in segment:
                    on_item(item)
                    if not deal([item]):
                        return
            except BufferClosed:
                pass
            except Exception:
                # a raising SOURCE must fail the transfer, not silently
                # truncate it: record for the caller to re-raise after
                # the branches drain (parity with the staged path, where
                # a source error surfaces through the stage join)
                if err_out is not None:
                    err_out.append(traceback.format_exc())
            finally:
                for q in queues.values():
                    q.close()

        return run

    @staticmethod
    def _validated_intake(plan: TransferPlan,
                          window: Sequence[StageReport],
                          intake: dict[str, float],
                          workers_by_report: Mapping[str, int]
                          ) -> dict[str, float]:
        """Corroborate a live window's intake backpressure before replan
        sees it.

        The intake ratio measures where the dispatcher's *blocked time*
        landed — exact over a drained segment, but phase-noisy while the
        pipeline keeps running: a window that straddles a regime
        transition can charge a healthy branch with the frontier advance
        a degraded sibling caused (and its routing shadow makes that same
        healthy branch read as underdelivering, so the spurious flag
        turns into a spurious verdict).  A true culprit is also *slower
        per byte* on its own channel, and the window reports measure that
        directly — busy time (``elapsed*workers`` minus both stall sides)
        per byte, a per-item service quantity the scheduling phase cannot
        inflate.  ``workers_by_report`` maps a tagged report name to the
        worker count its stage *actually ran* this window — plan values
        would be wrong under an explicit ``workers`` override or right
        after a revision resized the pool.  Any flag-capable ratio whose
        branch is not clearly the slowest (``BUSY_CULPRIT_RATIO`` over
        the fastest) is zeroed, so the culprit rule only ever fires on
        corroborated backpressure."""
        busy_per_byte: dict[str, float] = {}
        for branch in plan.branches:
            busy = 0.0
            nbytes = 0
            for r in window:
                if "/" not in r.name:
                    continue
                bid = r.name.split("/", 1)[0]
                if bid != branch.branch_id:
                    continue
                wrk = workers_by_report.get(r.name, 1)
                busy += max(0.0, r.elapsed_s * wrk - r.stall_up_s
                            - r.stall_down_s - r.stall_window_s)
                nbytes += r.bytes
            if nbytes > 0 and busy > 0:
                busy_per_byte[branch.branch_id] = busy / nbytes
        if len(busy_per_byte) < 2:
            return intake
        fastest = min(busy_per_byte.values())
        out = dict(intake)
        for bid, ratio in intake.items():
            # a branch with NO byte evidence this window (too slow to
            # complete a single item) cannot be exonerated — infinite
            # busy-per-byte keeps its flag
            if (ratio >= STALL_THRESHOLD
                    and busy_per_byte.get(bid, float("inf"))
                    < BUSY_CULPRIT_RATIO * fastest):
                out[bid] = 0.0
        return out

    @staticmethod
    def _steal_intake(plan: TransferPlan,
                      window: Sequence[StageReport],
                      workers_by_report: Mapping[str, int]
                      ) -> dict[str, float]:
        """Per-branch attribution signal under work-stealing dispatch.

        A shared intake has no per-branch backpressure to measure (every
        branch pulls the same queue), so ``replan`` used to run
        evidence-free on the steal route.  What stealing *does* make
        observable is each branch's **pull rate at the shared intake** —
        bytes moved per busy worker-second this window (busy = elapsed x
        workers minus every stall side, the same quantity
        :meth:`_validated_intake` corroborates with, which the scheduling
        phase cannot inflate).  A branch pulling clearly slower than the
        fastest sibling is draining its own channel slower — exactly why
        it steals less.  The rate deficit maps onto the intake-ratio
        scale ``replan`` already consumes (0 = keeps pace with the
        fastest, -> 1 = pulls almost nothing), so the existing culprit
        rule (``_intake_culprits``: >= STALL_THRESHOLD and well above the
        floor) applies unchanged.  A branch with no completed item this
        window contributes nothing — it can be neither flagged nor
        exonerated without byte evidence."""
        rates: dict[str, float] = {}
        for branch in plan.branches:
            busy = 0.0
            nbytes = 0
            for r in window:
                if "/" not in r.name:
                    continue
                bid = r.name.split("/", 1)[0]
                if bid != branch.branch_id:
                    continue
                wrk = workers_by_report.get(r.name, 1)
                busy += max(0.0, r.elapsed_s * wrk - r.stall_up_s
                            - r.stall_down_s - r.stall_window_s)
                nbytes += r.bytes
            if busy > 0 and nbytes > 0:
                rates[branch.branch_id] = nbytes / busy
        if len(rates) < 2:
            return {}
        fastest = max(rates.values())
        if fastest <= 0:
            return {}
        return {bid: max(0.0, 1.0 - rate / fastest)
                for bid, rate in rates.items()}

    @staticmethod
    def _normalized_weights(branches: Sequence[BranchPlan]
                            ) -> dict[str, float]:
        """Traffic shares the dispatcher deals by (uniform fallback when
        a degenerate plan zeroes every weight)."""
        w = {b.branch_id: max(b.weight, 0.0) for b in branches}
        if sum(w.values()) <= 0:
            w = {bid: 1.0 for bid in w}
        return w

    def _parallel_live(
        self,
        source: Iterable[Any],
        deliver: Callable[[str, Any], bool],
        plan: TransferPlan,
        mode: str,
        route: str,
        transforms,
        capacity: Optional[int],
        workers: Optional[int],
        chunk: int,
        damping: float,
        digest: _StreamDigest,
        batch_items: Optional[int] = None,
    ) -> tuple[int, int, list[StageReport], int, TransferPlan]:
        """Zero-drain parallel path: queues, branch stages, and the
        dispatcher live for the whole transfer.  Revision checkpoints
        compute the window's branch-tagged evidence + split-node intake
        ratios, and apply the resulting plan delta to the running
        machinery — weights swap into the live dispatcher, stages and
        queues resize in place."""
        active = plan
        queues, pbp = self._branch_pipelines(active, transforms, capacity,
                                             workers, route, batch_items)
        weights = self._normalized_weights(active.branches)
        order = [b.branch_id for b in active.branches]
        # ordered plans are the latency-sensitive streams (decode token
        # fan-out): deliver per item instead of holding a batch
        mirror_batch = 1 if plan.ordered else MIRROR_BATCH
        deal_batch = self._deal_batch(active, batch_items)
        source_err: list[str] = []
        dispatch = threading.Thread(
            target=self._dispatch(iter(source), queues, weights, order,
                                  mode, digest, route, mirror_batch,
                                  source_err, deal_batch),
            name="branch-dispatch", daemon=True)
        pbp.start()
        dispatch.start()
        # -- branch failover bookkeeping --------------------------------
        # the dispatcher already *routes around* a dead branch the moment
        # its intake closes (see _dispatch); what remains here is the
        # accounting side: zero the corpse's weight so replanning never
        # hands it traffic back, write its obituary into the plan
        # diagnosis (describe() shows the branch as `dead`)
        dead_handled: set[str] = set()
        obituaries: dict[str, str] = {}

        def _absorb_deaths(force: bool = False) -> None:
            # cheap per-delivery guard; the authoritative set is re-read
            # under the pipeline's lock only when the hint fires
            if not force and len(pbp._dead) == len(dead_handled):
                return
            for bid2 in pbp.dead_branches():
                if bid2 in dead_handled:
                    continue
                dead_handled.add(bid2)
                weights[bid2] = 0.0
                err = pbp.branch_error(bid2)
                obituaries[bid2] = (f"branch-dead({err})" if err
                                    else "branch-dead")
            if obituaries:
                active.diagnosis.update(obituaries)

        items = 0
        nbytes = 0
        seen = 0            # attempted deliveries: the boundary clock —
        #                     a retired drainer-pool client must not
        #                     stretch every later revision window
        replans = 0
        prev_cum: list[StageReport] = []
        prev_stall = {bid: 0.0 for bid in queues}
        t_prev = self._clock()
        # a boundary is chunk *source* items; mirror counts deliveries
        # once per branch
        step = chunk * (len(order) if mode == "mirror" else 1)
        boundary = step
        for bid, item in _drain_batched(pbp.output):
            seen += 1
            _absorb_deaths()
            if deliver(bid, item):
                items += 1
                nbytes += _default_sizeof(item)
            if step and seen >= boundary:
                boundary += step
                t_now = self._clock()
                t_win = t_now - t_prev
                t_prev = t_now
                cum = pbp.reports()
                window = delta_reports(cum, prev_cum)
                prev_cum = cum
                for _bid, pipe in pbp.branches:
                    for st in pipe.stages:
                        st.reset_service_reservoirs()
                intake: dict[str, float] = {}
                if route != "steal":
                    for qbid, q in queues.items():
                        stall = q.stats.producer_stall_s
                        intake[qbid] = ((stall - prev_stall[qbid]) / t_win
                                        if t_win > 0 else 0.0)
                        prev_stall[qbid] = stall
                if not window:
                    continue
                stage_workers = {
                    f"{bid2}/{st.name}": st.workers
                    for bid2, pipe in pbp.branches
                    for st in pipe.stages}
                if route == "steal":
                    # pull-based routing self-balances within the window
                    # and a shared intake has no per-branch backpressure;
                    # the per-branch PULL RATES at that intake are the
                    # attribution signal replan consumes instead
                    intake = self._steal_intake(active, window,
                                                stage_workers)
                elif intake:
                    intake = self._validated_intake(active, window, intake,
                                                    stage_workers)
                revised = _replan(active, window, damping=damping,
                                  intake_ratio=intake)
                delta = plan_delta(active, revised)
                active = revised
                if obituaries:
                    # replan rebuilt the diagnosis; obituaries persist
                    active.diagnosis.update(obituaries)
                if delta:
                    replans += 1
                    for bid2, pipe in pbp.branches:
                        b = active.branch(bid2)
                        for i, st in enumerate(pipe.stages):
                            hop = b.hop_for(i, st.name)
                            st.resize(capacity=capacity or hop.capacity,
                                      workers=workers or hop.workers,
                                      window_bytes=self._hop_window(hop),
                                      rtt_s=self._hop_rtt(hop),
                                      batch_items=self._hop_batch(
                                          hop, batch_items),
                                      **self._hop_retry(hop))
                    if route == "steal":
                        agg = sum(b.hops[0].capacity
                                  for b in active.branches)
                        queues[order[0]].resize(capacity or max(1, agg))
                    else:
                        for b in active.branches:
                            queues[b.branch_id].resize(b.hops[0].capacity)
                    weights.update(self._normalized_weights(active.branches))
        dispatch.join()
        if dead_handled or pbp.dead_branches():
            # failover form: survivors' completion is the success
            # criterion; join() would re-raise the corpses' errors
            pbp.wait()
        else:
            pbp.join()
        _absorb_deaths(force=True)
        merged = pbp.reports()
        if dead_handled:
            survivors = [b for b in order if b not in dead_handled]
            if not survivors:
                raise RuntimeError(
                    "every branch died: "
                    + "; ".join(obituaries[b]
                                for b in sorted(dead_handled)))
            # the corpses' debris: items they claimed but never
            # delivered (stranded mid-pipeline) plus — on the deal
            # route — items still parked in their private intake
            # queues.  Mirror mode skips re-moving: every survivor
            # already carries its own full copy of the stream.
            leftovers: list = []
            for bid2 in sorted(dead_handled):
                leftovers.extend(pbp.take_stranded(bid2))
                if route != "steal" and mode == "split":
                    try:
                        while True:
                            leftovers.extend(
                                queues[bid2].get_many(1 << 10))
                    except BufferClosed:
                        pass
            if leftovers and mode == "split":
                sbid = survivors[0]
                s_items, s_bytes, s_reports = self._salvage_pass(
                    active.branch(sbid), leftovers,
                    lambda it: deliver(sbid, it),
                    transforms, capacity, workers, batch_items)
                items += s_items
                nbytes += s_bytes
                merged = merged + s_reports
        if source_err:
            raise RuntimeError(f"transfer source failed:\n{source_err[0]}")
        return items, nbytes, merged, replans, active

    def _parallel_segmented(
        self,
        source: Iterable[Any],
        deliver: Callable[[str, Any], bool],
        plan: TransferPlan,
        mode: str,
        route: str,
        transforms,
        capacity: Optional[int],
        workers: Optional[int],
        chunk: int,
        damping: float,
        digest: _StreamDigest,
        batch_items: Optional[int] = None,
    ) -> tuple[int, int, list[StageReport], int, TransferPlan]:
        """Historical drain-per-segment parallel path (explicit
        ``drain_per_segment=True``): full teardown + rebuild at every
        boundary — the baseline the zero-drain path is measured against."""
        active = plan
        merged: list[StageReport] = []
        last_reports: list[StageReport] = []
        last_intake: dict[str, float] = {}
        replans = 0
        items = 0
        nbytes = 0
        for segment in iter_segments(iter(source), chunk):
            if last_reports:
                revised = _replan(active, last_reports,
                                  damping=damping,
                                  intake_ratio=last_intake)
                if plan_delta(active, revised):
                    replans += 1
                active = revised
            queues, pbp = self._branch_pipelines(active, transforms,
                                                 capacity, workers, route,
                                                 batch_items)
            weights = self._normalized_weights(active.branches)
            order = [b.branch_id for b in active.branches]
            source_err: list[str] = []
            dispatch = threading.Thread(
                target=self._dispatch(segment, queues, weights, order,
                                      mode, digest, route,
                                      1 if plan.ordered else MIRROR_BATCH,
                                      source_err,
                                      self._deal_batch(active, batch_items)),
                name="branch-dispatch", daemon=True)
            t_seg0 = self._clock()
            pbp.start()
            dispatch.start()
            for bid, item in _drain_batched(pbp.output):
                if deliver(bid, item):
                    items += 1
                    nbytes += _default_sizeof(item)
            dispatch.join()
            pbp.join()
            if source_err:
                raise RuntimeError(
                    f"transfer source failed:\n{source_err[0]}")
            t_seg = self._clock() - t_seg0
            last_reports = pbp.reports()
            # the split node's per-branch backpressure: the attribution
            # signal replan uses to single out a slow branch (§2.2); the
            # steal route derives it from per-branch pull rates instead
            # (a shared intake backpressures nobody in particular)
            if route == "steal":
                stage_workers = {
                    f"{bid}/{st.name}": st.workers
                    for bid, pipe in pbp.branches
                    for st in pipe.stages}
                last_intake = self._steal_intake(active, last_reports,
                                                 stage_workers)
            else:
                last_intake = {
                    bid: (q.stats.producer_stall_s / t_seg
                          if t_seg > 0 else 0.0)
                    for bid, q in queues.items()}
            merged = merge_reports([merged, last_reports])
        return items, nbytes, merged, replans, active

    def parallel_transfer(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None] | Mapping[str, Callable[[Any], None]],
        *,
        plan: Optional[TransferPlan] = None,
        mode: str = "split",
        route: str = "deal",
        transforms: Sequence[tuple[str, Callable[[Any], Any]]]
        | Mapping[str, Sequence[tuple[str, Callable[[Any], Any]]]] = (),
        capacity: Optional[int] = None,
        workers: Optional[int] = None,
        checksum: Optional[bool] = None,
        replan_every_items: int = 0,
        replan_damping: float = 0.5,
        drain_per_segment: bool = False,
        drainer_pool: bool = False,
        batch_items: Optional[int] = None,
    ) -> TransferReport:
        """Move a stream down every branch of a multipath plan at once.

        One stage pipeline per :class:`~repro_torch.core.planner.BranchPlan`; a
        dispatcher thread plays the split node.  ``mode="split"`` routes
        each item down exactly one branch (weighted by the plan's branch
        traffic shares — aggregate throughput is the sum over branches);
        ``mode="mirror"`` replicates every item down every branch (the
        dual-tier checkpoint / decode fan-out case — the dispatcher paces
        at the slowest branch, which is the point: a mirror is only as
        durable as its slowest copy).

        ``route`` picks the split-mode routing discipline:
        ``"deal"`` (default) is the deterministic weighted-deficit
        round-robin over the plan's branch weights; ``"steal"`` is
        pull-based work stealing — every branch pulls one shared intake
        queue, so a transiently slow branch stops accumulating queued
        items *within* a segment instead of waiting for the next weight
        rebalance, at the cost of scripted routing determinism.

        ``transforms`` applies to every branch, or a mapping
        ``branch_id -> transforms`` gives each branch its own chain (a
        mirrored save writes different directories per branch).  ``sink``
        likewise: one callable for all deliveries, or per-branch.
        Integrity (``checksum``) hashes each *source* item once at the
        split node, overlapping branch transit.

        ``replan_every_items > 0`` revises the plan online from
        branch-tagged window reports: a degraded branch gets its verdict
        in ``plan.diagnosis["<branch>/<hop>"]`` and loses traffic share
        to healthy branches (split mode).  The revision applies
        **zero-drain** — weights swap into the live dispatcher, stages
        and queues resize in place (``drain_per_segment=True`` restores
        the historical teardown-per-segment behaviour).

        ``drainer_pool=True`` routes deliveries through a per-branch
        drainer pool (one small buffer + drainer thread per branch), so
        one blocking client write no longer serializes its siblings at
        the merge buffer; a single shared ``sink`` callable must then be
        thread-safe.  Items/bytes in the returned report count
        *deliveries* (mirror mode moves each item once per branch).

        ``batch_items`` overrides the per-hop slab size on every branch
        (1 forces the per-item path; None defers to the plan)."""
        if mode not in ("split", "mirror"):
            raise ValueError(f"unknown parallel mode {mode!r}")
        if route not in ("deal", "steal"):
            raise ValueError(f"unknown split route {route!r}")
        if route == "steal" and mode != "split":
            raise ValueError("route='steal' requires mode='split'")
        own_plan = plan is None
        plan = plan if plan is not None else self.plan
        if plan is None or not plan.branches:
            raise ValueError("parallel_transfer needs a branch-aware plan")
        do_sum = self.config.checksum if checksum is None else checksum
        digest = _StreamDigest(do_sum, placement=plan.checksum_placement,
                               device=self.config.device)

        def sink_for(bid: str) -> Callable[[Any], None]:
            if isinstance(sink, Mapping):
                return sink[bid]
            return sink

        pool: Optional[_DrainerPool] = None
        if drainer_pool:
            pool = _DrainerPool(
                {b.branch_id: sink_for(b.branch_id) for b in plan.branches},
                {b.branch_id: capacity or b.hops[-1].capacity
                 for b in plan.branches},
                self._clock)

        def deliver(bid: str, item: Any) -> bool:
            if pool is not None:
                return pool.submit(bid, item)
            sink_for(bid)(item)
            return True

        chunk = replan_every_items
        t0 = self._clock()
        try:
            # the live (zero-drain) machinery is the default — it is
            # also what branch failover rides (the dispatcher re-routes
            # around a dead branch and the tail sweep salvages its
            # debris; the segmented baseline keeps the historical
            # fail-hard contract).
            if drain_per_segment:
                items, nbytes, merged, replans, active = \
                    self._parallel_segmented(
                        source, deliver, plan, mode, route, transforms,
                        capacity, workers, chunk, replan_damping, digest,
                        batch_items)
            else:
                items, nbytes, merged, replans, active = \
                    self._parallel_live(
                        source, deliver, plan, mode, route, transforms,
                        capacity, workers, chunk, replan_damping, digest,
                        batch_items)
        except BaseException:
            # the primary failure wins: drain the pool for cleanup but do
            # not let a retired client's error replace the real traceback
            if pool is not None:
                try:
                    pool.close()
                except RuntimeError:
                    pass
            raise
        if pool is not None:
            pool.close()
        elapsed = self._clock() - t0
        self.last_plan = active
        if own_plan and self.plan is not None:
            self.plan = active
        if mode == "mirror":
            # replication paces at the slowest branch: every branch moves
            # every item, so the honest promise is n x the weakest rate,
            # not the split-mode aggregate.  A replica that DIED
            # mid-stream leaves the promise to the survivors — the
            # mirror re-prices to n_live x the weakest LIVE rate
            dead = {b for b, v in active.diagnosis.items()
                    if v.startswith("branch-dead")}
            rates = [b.rate_bytes_per_s for b in plan.branches
                     if b.branch_id not in dead]
            planned = len(rates) * min(rates) if rates else 0.0
        else:
            planned = plan.planned_bytes_per_s
        return self._record(TransferReport(
            mode=f"parallel-{mode}",
            items=items,
            bytes=nbytes,
            elapsed_s=elapsed,
            stage_reports=merged,
            checksum=digest.hexdigest(),
            planned_bytes_per_s=planned,
            replans=replans,
            path=active.path if active is not None else None,
        ))

    # -- direct (un-staged) path, for comparison -------------------------------

    def direct_transfer(
        self,
        source: Iterable[Any],
        sink: Callable[[Any], None],
        *,
        checksum: Optional[bool] = None,
    ) -> TransferReport:
        """Synchronous, un-staged copy loop — the 'aws-cli' style baseline of
        Fig. 11: every hop serializes with every other hop.  Used by
        benchmarks to quantify the staged-vs-direct fidelity delta."""
        do_sum = self.config.checksum if checksum is None else checksum
        digest = _StreamDigest(do_sum)
        items = 0
        nbytes = 0
        t0 = self._clock()
        for item in source:
            digest.add(item)                  # serial hash: the baseline
            sink(item)
            items += 1
            nbytes += _default_sizeof(item)
        elapsed = self._clock() - t0
        planned = self.basin.achievable_throughput() if self.basin else None
        return self._record(TransferReport(
            mode="direct",
            items=items,
            bytes=nbytes,
            elapsed_s=elapsed,
            stage_reports=[],
            checksum=digest.hexdigest(),
            planned_bytes_per_s=planned,
            path="direct",
        ))
