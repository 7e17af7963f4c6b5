"""TransferPlan engine — the basin model turned into staging parameters.

The paper's planning discipline (§2.3 "global tuning", §3.4 weakest-link
analysis) is that predictable line-rate movement comes from matching
buffer depth, concurrency, and integrity budget to *every* tier of the
path — not from per-workload hand tuning.  :mod:`repro_torch.core.basin` is the
analytic model; this module is the bridge that turns a
:class:`~repro_torch.core.basin.DrainageBasin` plus an item-size estimate into
the concrete knobs every data-moving layer needs:

* **capacity** — burst-buffer slots per hop (Little's law over the
  jitter window, double-buffered),
* **workers** — concurrent staging workers per hop (concurrency as the
  latency antidote, §3.1: enough in-flight pulls that per-item latency
  and jitter amortize away and the hop sustains the path's line rate),
* **checksum placement** — the integrity budget (§3.4) rides the hop
  with the most bandwidth headroom, so hashing overlaps transit instead
  of stretching the critical path.

Every consumer — the training-input pipeline, the checkpoint engine, the
decode token stream — builds its basin, asks :func:`plan_transfer` for a
:class:`TransferPlan`, and hands that plan to the
:class:`~repro_torch.core.mover.UnifiedDataMover` / stage constructors.  No
layer carries hard-coded staging constants.

DAG basins and per-branch plans
-------------------------------

A branching basin (N dataset shards fanning in to one host, a checkpoint
mirrored to two storage tiers, a decode stream fanning out to many
clients) plans per **branch**: :func:`plan_transfer` enumerates the
basin's root->sink paths, allocates each a rate under shared-tier rate
conservation (:meth:`~repro_torch.core.basin.DrainageBasin.branch_rates` —
branch rates through a shared tier sum to no more than its effective
rate), and derives an independent hop list per branch sized to that
branch's allocated share.  The result is one :class:`TransferPlan` whose
:attr:`~TransferPlan.branches` lists a :class:`BranchPlan` per path; its
``planned_bytes_per_s`` is the *aggregate* over branches, and its
``weight`` per branch is the share of traffic the parallel mover routes
down that branch (``UnifiedDataMover.parallel_transfer``).  On a linear
basin there is exactly one branch mirroring ``plan.hops`` — the
pre-refactor behaviour, bit for bit.

Adaptive re-planning (the paper's hypothesis -> change -> measure cycle,
made mechanical): observed :class:`~repro_torch.core.staging.StageReport` stall
ratios feed back into the tier bandwidth estimates via :func:`replan`,
which returns a revised plan.  A hop that mostly *starved* (stall
upstream) reveals the upstream tier is slower than modeled; a hop that
mostly *backpressured* (stall downstream) reveals the downstream tier is.

Per-branch attribution: parallel-branch reports arrive tagged
``"<branch>/<stage>"``, and :func:`replan` attributes each branch's
evidence to that branch alone.  Two rules keep one slow branch from
uniformly degrading the whole plan:

* **private-tier attribution** — a branch hop that is *busy* (no stalls,
  yet underdelivering) spent its time in its own pull+transform service,
  i.e. in the branch-private channel; the verdict lands on the branch's
  private tier, never on a tier shared with healthy siblings.
* **corroboration** — a branch's stall evidence may implicate a shared
  tier only when every sibling branch crossing that tier shows evidence
  against it too.  A lone branch starving upstream of a split node is a
  routing shadow (traffic was sent elsewhere), not proof the shared tier
  degraded.

The revised plan re-allocates branch rates from the updated estimates,
so traffic rebalances toward healthy branches (their weights grow) while
the degraded branch's verdict is preserved in
:attr:`TransferPlan.diagnosis` under its ``"<branch>/<hop>"`` key.

Regime diagnosis (latency-bound vs bandwidth-bound)
---------------------------------------------------

A stall ratio alone cannot say *why* a hop waited — and the two causes
demand opposite remedies (the paper's "raw bandwidth = capability"
fallacy, and the regime separation of arXiv:2308.10312).  The per-item
service-time reservoirs in :class:`~repro_torch.core.staging.StageReport`
(``service_up_s`` / ``service_down_s``) disambiguate:

* **latency-bound** — service times are widely dispersed (stochastic
  per-item latency + jitter dominates).  Remedy: revise the tier's
  ``latency_s``/``jitter_s`` estimates upward so the next plan raises
  ``workers`` (concurrency amortizes latency, §3.1) and deepens the
  buffer.  Bandwidth estimates are left alone.
* **bandwidth-bound** — service times are tight around a constant (the
  pipe is saturated; every item takes ~``item_bytes/true_bw``).  Remedy:
  pull the tier's ``bandwidth_gbps`` estimate toward the observed rate
  and accept the lower line rate.  More workers would not help.

Without service samples (an empty reservoir) replan falls back to the
bandwidth remedy — the conservative pre-diagnosis behaviour.  A hop that
never stalled but still underdelivered against its planned rate (busy on
its own pull + transform service) is diagnosed from its samples too — the
busy-hop rule, exercised by ``benchmarks/online_replan.py``.

Online replanning: the mover's ``replan_every_items`` runs a transfer in
segments and feeds each segment's reports through :func:`replan` at the
buffer boundary, so a mid-transfer regime shift is answered mid-transfer
(see ``UnifiedDataMover.bulk_transfer`` / ``parallel_transfer``).
"""

from __future__ import annotations

import collections.abc
import dataclasses
import math
from typing import Mapping, Optional, Sequence, Union

from .basin import DrainageBasin, Tier, TierKind
from .staging import StageReport

#: ceiling on per-hop concurrency (a planning guard, not a tuning knob:
#: past this the GIL/thread overhead of the host path dominates)
MAX_WORKERS = 8
#: ceiling on per-hop buffer slots (bounds host memory for tiny items)
MAX_CAPACITY = 64
#: window sizing margin over the path BDP (§3.2): ACK compression and
#: cross-traffic jitter make a window cut exactly at BDP oscillate below
#: line rate, so the plan leaves this much slack
WINDOW_HEADROOM = 1.25
#: slab sizing target for ``batch_items="auto"``: enough items per slab
#: that the per-slab lock/admission round-trip amortizes to noise, small
#: enough that a slab never monopolizes a hop's burst buffer
SLAB_TARGET_BYTES = 1 << 20
#: default modeled host digest throughput (SHA-256 on one core, bytes/s)
#: — the §3.4 integrity budget when the checksum runs on the host CPU.
#: Callers with a measured rate pass ``host_digest_bytes_per_s``.
HOST_DIGEST_BYTES_PER_S = 1.6e9
#: default modeled accelerator digest throughput: a batched Pallas digest
#: kernel streams at HBM-class bandwidth, far above any host path — the
#: placement that takes integrity off the critical path entirely
ACCEL_DIGEST_BYTES_PER_S = 64e9
#: a busy checksum hop is **host-compute-bound** only when its delivered
#: rate sits at the digest ceiling — within this factor of the modeled
#: ``digest_bytes_per_s`` (the §3.4 signature: throughput pinned by the
#: integrity budget, not by any tier or by transport credit)
DIGEST_PIN_SLACK = 1.5
#: minimum observed-ACK samples before the live RTT estimate is trusted
#: to revise ``HopPlan.rtt_s`` (fewer and one stray ACK skews the mean)
MIN_RTT_SAMPLES = 8
#: relative deviation of the observed RTT estimate from the planned
#: ``rtt_s`` beyond which the plan's RTT is revised (an **rtt-revised**
#: verdict).  Below it the estimate is jitter, not a route change.
RTT_REVISION_TOLERANCE = 0.2
#: observed retransmit fraction (retransmits / items) at or above which a
#: window-stalled hop reads as **loss-bound** — §3.2's deterministic-loss
#: regime, whose remedy deepens the window by (1 + loss) and lowers the
#: promise honestly wherever a clamp keeps the window shallow
LOSS_RATE_THRESHOLD = 0.05
#: execution shapes the path decision engine prices (§3.6's stream-vs-
#: stage question made a planned quantity).  ``direct`` is the cut-
#: through stream: one worker, no burst-buffer depth, stop-and-wait on
#: any latency-bearing link — it bypasses the staging copy entirely.
#: ``staged`` is N synchronous streams through the burst buffer (each
#: worker pays the round trip per item).  ``windowed-staged`` is the
#: historical full shape: staged concurrency plus BDP-sized transport
#: credit.  ``compressed`` is windowed-staged with the int8 wire
#: transform: :data:`COMPRESS_WIRE_RATIO` fewer bytes cross every link,
#: paid for at :data:`COMPRESS_BYTES_PER_S` of quantize compute.
PATH_CHOICES = ("direct", "staged", "windowed-staged", "compressed")
#: wire-byte reduction of the compressed path: float32 payloads quantize
#: to int8 (+ per-block scales) via ``integrity.compress_transform`` —
#: 4x fewer bytes on every link the plan prices
COMPRESS_WIRE_RATIO = 4.0
#: modeled quantize/dequantize service rate (bytes of UNCOMPRESSED
#: payload per second) — the compute charge the compressed-wire path
#: pays for its wire relief; it only wins when a link is the priced
#: bottleneck by more than this ceiling allows
COMPRESS_BYTES_PER_S = 8e9
#: online path-revision hysteresis: a replan abandons the executing path
#: only when the re-scored challenger beats the incumbent's re-scored
#: rate by this factor.  A live shape switch re-parameterizes a running
#: pipeline; near-ties must not flap it every revision boundary.
PATH_REVISION_MARGIN = 1.2
#: ceiling on a fault-priced retry budget: past this, a flapping element
#: needs failover (branch death / fleet re-admission), not more patience
MAX_RETRY_BUDGET = 8
#: default transient-failure posture (budget, backoff base) for an
#: element with no observed faults in the telemetry priors
DEFAULT_RETRY_BUDGET = 2
DEFAULT_BACKOFF_BASE_S = 0.05


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """Staging parameters for one hop (one :class:`~repro_torch.core.staging.Stage`)."""

    name: str
    capacity: int               # burst-buffer slots
    workers: int                # concurrent staging workers
    up_tier: str                # tier the hop pulls from
    down_tier: str              # tier the hop delivers toward
    rate_bytes_per_s: float     # what this hop can sustain as planned
    #: in-flight byte cap for an RTT-governed CHANNEL hop (0 = the hop is
    #: queue-clocked).  Sized from the segment link's BDP with
    #: :data:`WINDOW_HEADROOM`, clamped to the segment's burst capacity
    #: and to an explicit ``max_window_bytes`` (the host's socket-buffer
    #: limit, §3.2's silent throughput killer)
    window_bytes: float = 0.0
    #: round-trip time of the hop's windowed link (the ACK clock)
    rtt_s: float = 0.0
    #: ``"src->dst"`` of the link whose BDP governs the window (the name
    #: a window-bound verdict points at); "" on queue-clocked hops
    window_link: str = ""
    #: modeled retransmit fraction of the windowed link (§3.2): the
    #: window is deepened by (1 + loss_rate) so retransmit round trips
    #: do not drain the pipe, and a clamped window's promise drops by
    #: the same factor.  Revised by a **loss-bound** verdict.
    loss_rate: float = 0.0
    #: live RTT estimate from observed ACK spacing (0 = none yet); set by
    #: :func:`replan` when an **rtt-revised** verdict re-times the hop,
    #: and surfaced by ``describe()`` as ``rtt-est=`` next to ``rtt=``
    rtt_estimate_s: float = 0.0
    #: slab size: items the hop's workers pull/admit/stage per loop
    #: (``Stage.batch_items``).  1 = the per-item path.
    batch_items: int = 1
    #: modeled digest service rate charged to this hop (bytes/s); > 0
    #: only on the hop carrying the stream checksum.  Host placement
    #: charges the host SHA rate (and can pin the hop — the
    #: host-compute-bound verdict); accelerator placement charges the
    #: Pallas kernel's rate, far above line rate.
    digest_bytes_per_s: float = 0.0
    #: transient-failure retry budget: how many times one item's
    #: pull+transform may be re-attempted (exponential backoff from
    #: ``backoff_base_s``, seeded jitter) before the failure is final
    #: and the branch is declared dead.  0 = fail fast.
    retry_budget: int = 2
    #: base of the exponential backoff between retries (seconds);
    #: attempt k waits ``backoff_base_s * 2**k * (1 + jitter)``
    backoff_base_s: float = 0.05


def _hop_lookup(hops: Sequence[HopPlan], index: int,
                name: str | None) -> HopPlan:
    if name is not None:
        for h in hops:
            if h.name == name:
                return h
    return hops[min(index, len(hops) - 1)]


@dataclasses.dataclass
class BranchPlan:
    """One root->sink branch of a (possibly branching) plan."""

    branch_id: str                  # stable id ("nvme", "shard-0", ...)
    path: tuple[str, ...]           # tier names, root -> sink
    hops: list[HopPlan]
    rate_bytes_per_s: float         # the branch's planned sustained rate
    weight: float                   # share of traffic routed this way
    #: tiers on this path no other branch crosses — where branch-local
    #: evidence is attributed (see module docstring)
    private_tiers: tuple[str, ...] = ()

    def hop_for(self, index: int, name: str | None = None) -> HopPlan:
        """Hop by stage name when it matches, else by position."""
        return _hop_lookup(self.hops, index, name)


@dataclasses.dataclass
class TransferPlan:
    """A fully derived data path: per-hop parameters plus the promise
    (``planned_bytes_per_s``) the fidelity gap is measured against.

    ``branches`` always holds one :class:`BranchPlan` per root->sink path;
    on a linear basin the single branch mirrors ``hops`` exactly.  On a
    branching basin ``hops`` is the primary (highest-rate) branch's hop
    list — kept for single-pipeline consumers — and
    ``planned_bytes_per_s`` is the aggregate over branches."""

    hops: list[HopPlan]
    item_bytes: float
    planned_bytes_per_s: float
    checksum_index: Optional[int]       # hop index carrying the digest, or None
    basin: DrainageBasin
    ordered: bool
    #: hop name (or ``"<branch>/<hop>"``) -> regime verdict set by
    #: :func:`replan` on the revised plan; empty on a fresh derivation
    diagnosis: dict[str, str] = dataclasses.field(default_factory=dict)
    branches: list[BranchPlan] = dataclasses.field(default_factory=list)
    #: branching plans hash at the split node instead of riding one hop
    checksum_at_split: bool = False
    #: host limit the windowed hops were clamped under (None = BDP-sized;
    #: a mapping clamps per branch id).  A window-bound verdict's remedy
    #: is raising this — for the diagnosed branch only (see :func:`replan`)
    max_window_bytes: WindowClamp = None
    #: where the stream digest runs: ``"host"`` (SHA on the staging CPU,
    #: charged at ``host_digest_bytes_per_s``) or ``"accel"`` (batched
    #: Pallas digest, charged at ``accel_digest_bytes_per_s``).  A
    #: host-compute-bound verdict's remedy is flipping this to "accel".
    checksum_placement: str = "host"
    #: the ``batch_items`` policy the plan was derived under (None, int,
    #: or "auto") — carried so :func:`replan` re-derives with it
    batch_policy: Optional[object] = None
    #: arbiter-granted rate share (bytes/s) the plan was sized under, or
    #: None when the transfer owns the basin.  A capped plan's promise is
    #: the GRANT, its windows are sized from ``grant x RTT`` (so a
    #: windowed hop self-paces to its share), and :func:`replan` treats
    #: share-shaped stalls on a hop that still delivers its grant as the
    #: arbiter at work — never as a degraded tier (the fleet analogue of
    #: the §3.2 misdiagnosis family).  Carried through re-derivations.
    rate_cap_bytes_per_s: Optional[float] = None
    host_digest_bytes_per_s: float = HOST_DIGEST_BYTES_PER_S
    accel_digest_bytes_per_s: float = ACCEL_DIGEST_BYTES_PER_S
    #: the execution shape the hops are parameterized for (one of
    #: :data:`PATH_CHOICES`).  Legacy derivations (no ``path=`` given)
    #: label what they built — ``"windowed-staged"`` when any hop carries
    #: transport credit, ``"staged"`` otherwise — without pricing
    #: candidates.
    path: str = "windowed-staged"
    #: the caller's path request, carried through re-derivations: None
    #: (legacy, no decision engine), ``"auto"`` (replan may re-choose —
    #: the **path-revised** verdict), or a forced member of
    #: :data:`PATH_CHOICES` (pinned; replan re-prices but never switches)
    path_policy: Optional[str] = None
    #: candidate shape -> modeled end-to-end bytes/s over the item-size
    #: distribution; empty on legacy derivations.  ``describe()`` prints
    #: it so an operator can see what the chosen path beat.
    path_scores: dict[str, float] = dataclasses.field(default_factory=dict)
    #: normalized item-size histogram ``((bytes, weight), ...)`` the
    #: candidates were priced over (None = priced at ``item_bytes``).  A
    #: small-file storm prices its per-item latency honestly instead of
    #: hiding behind the mean.
    item_bytes_dist: Optional[tuple] = None
    #: the compressed-wire candidate is only enumerable when the caller
    #: vouches the payload survives the int8 transform
    compressible: bool = False
    #: element name ("src->dst" link or tier) -> observed transient-fault
    #: rate (retries per item), the telemetry prior retry budgets are
    #: priced from; None = every element keeps the cheap default posture
    fault_priors: Optional[Mapping[str, float]] = None

    @property
    def stages(self) -> list[str]:
        return [h.name for h in self.hops]

    @property
    def is_multipath(self) -> bool:
        return len(self.branches) > 1

    def branch(self, branch_id: str) -> BranchPlan:
        for b in self.branches:
            if b.branch_id == branch_id:
                return b
        raise KeyError(f"no branch {branch_id!r}")

    def hop_for(self, index: int, name: str | None = None) -> HopPlan:
        """Hop by stage name when it matches, else by position (extra
        stages beyond the planned hops inherit the last hop's params)."""
        return _hop_lookup(self.hops, index, name)

    @property
    def total_buffer_items(self) -> int:
        hops = [h for b in self.branches for h in b.hops] or self.hops
        return sum(h.capacity for h in hops)

    def _fmt_path(self) -> str:
        """Chosen execution shape + per-candidate scores; "" on legacy
        plans so their describe() stays byte-identical."""
        if not self.path_scores:
            return ""
        scores = ",".join(f"{name}={rate / 1e6:.1f}"
                          for name, rate in sorted(self.path_scores.items()))
        return f" path={self.path} scores[{scores}]MB/s"

    @staticmethod
    def _fmt_hop(h: HopPlan) -> str:
        win = ""
        if h.window_bytes > 0:
            loss = f" loss={h.loss_rate:.0%}" if h.loss_rate > 0 else ""
            est = (f" rtt-est={h.rtt_estimate_s * 1e3:.0f}ms"
                   if h.rtt_estimate_s > 0 else "")
            win = (f" win={h.window_bytes / 1e6:.1f}MB"
                   f" rtt={h.rtt_s * 1e3:.0f}ms{est}{loss}")
        # slab size surfaces only when the hop is actually batched, so a
        # per-item plan's describe() stays byte-identical to the old form
        batch = f" b={h.batch_items}" if h.batch_items > 1 else ""
        retry = f" retry={h.retry_budget}" if h.retry_budget > 0 else ""
        return (f"{h.name}[cap={h.capacity} w={h.workers}{batch}{win}{retry} "
                f"{h.up_tier}->{h.down_tier}]")

    def describe(self) -> str:
        """Operator surface: one line for a linear plan (unchanged from
        the pre-DAG format; windowed hops add their ``win``/``rtt``,
        batched hops their slab size ``b=``, and a carried checksum its
        placement — ``checksum@1:host`` vs ``checksum@1:accel``), a
        per-branch topology summary otherwise."""
        if not self.is_multipath:
            diag = ""
            if self.diagnosis:
                diag = "; diag[" + ", ".join(
                    f"{name}={verdict}"
                    for name, verdict in sorted(self.diagnosis.items())) + "]"
            hops = ", ".join(self._fmt_hop(h) for h in self.hops)
            place = (f":{self.checksum_placement}"
                     if self.checksum_index is not None else "")
            cap = ""
            if self.rate_cap_bytes_per_s is not None:
                cap = (f" arbiter-capped@"
                       f"{self.rate_cap_bytes_per_s / 1e6:.1f} MB/s")
            return (f"TransferPlan({hops}; planned="
                    f"{self.planned_bytes_per_s / 1e6:.1f} MB/s{cap}"
                    f"{self._fmt_path()}, "
                    f"checksum@{self.checksum_index}{place}{diag})")
        split = (f"split:{self.checksum_placement}"
                 if self.checksum_at_split else "None")
        cap = ""
        if self.rate_cap_bytes_per_s is not None:
            cap = (f" arbiter-capped@"
                   f"{self.rate_cap_bytes_per_s / 1e6:.1f} MB/s")
        lines = [f"TransferPlan({len(self.branches)} branches, planned="
                 f"{self.planned_bytes_per_s / 1e6:.1f} MB/s aggregate{cap}"
                 f"{self._fmt_path()}, "
                 f"checksum@{split}"]
        shown = set()
        for b in self.branches:
            hops = ", ".join(self._fmt_hop(h) for h in b.hops)
            keys = [f"{b.branch_id}/{h.name}" for h in b.hops]
            verdicts = [f"{k.split('/', 1)[1]}={self.diagnosis[k]}"
                        for k in keys if k in self.diagnosis]
            shown.update(k for k in keys if k in self.diagnosis)
            tail = f"  !{'; '.join(verdicts)}" if verdicts else ""
            # a failed-over branch carries its obituary under its bare id
            dead = ""
            if self.diagnosis.get(b.branch_id, "").startswith("branch-dead"):
                shown.add(b.branch_id)
                dead = " dead"
            lines.append(f"  {b.branch_id}{dead} w={b.weight:.2f} "
                         f"@{b.rate_bytes_per_s / 1e6:.1f} MB/s: {hops}{tail}")
        # verdicts carried over from branches no longer in the plan
        stray = {k: v for k, v in self.diagnosis.items() if k not in shown}
        diag = ""
        if stray:
            diag = "; diag[" + ", ".join(
                f"{k}={v}" for k, v in sorted(stray.items())) + "]"
        return "\n".join(lines) + f"{diag})"


@dataclasses.dataclass(frozen=True)
class HopRevision:
    """Revised staging parameters for one live hop."""

    name: str
    capacity: int
    workers: int
    window_bytes: float = 0.0
    batch_items: int = 1
    #: revised ACK-clock round trip (0 = the hop is queue-clocked).  An
    #: rtt-revised plan must re-time the RUNNING WindowedStage even when
    #: every other parameter (including a clamped window) is unchanged —
    #: a stale ACK clock mis-paces admission and mis-reads the next
    #: revision window's evidence.
    rtt_s: float = 0.0
    #: revised transient-fault posture (fault-prior pricing): the running
    #: stage adopts the new budget/backoff without a drain, so a hop that
    #: just proved it flaps gets its deeper budget before the next fault
    retry_budget: int = DEFAULT_RETRY_BUDGET
    backoff_base_s: float = DEFAULT_BACKOFF_BASE_S


@dataclasses.dataclass
class PlanDelta:
    """What actually changed between two plans over the same topology —
    the unit of **zero-drain** replanning.

    A revised :class:`TransferPlan` is a full re-derivation; a running
    pipeline does not need to be torn down to adopt it, only to apply the
    difference: per-hop capacity/worker revisions (resized in place via
    ``Stage.resize``) and per-branch traffic-weight shifts (swapped into
    the live dispatcher).  Falsy when the revision changed nothing —
    the mover's ``replans`` counter counts truthy deltas only."""

    #: linear-path hop name -> revised params (changed hops only)
    hops: dict[str, HopRevision] = dataclasses.field(default_factory=dict)
    #: branch id -> hop name -> revised params (changed hops only)
    branch_hops: dict[str, dict[str, HopRevision]] = \
        dataclasses.field(default_factory=dict)
    #: branch id -> new traffic weight (branches whose share shifted)
    weights: dict[str, float] = dataclasses.field(default_factory=dict)
    #: the revised plan's execution shape when it differs from the old
    #: plan's (a **path-revised** switch): the mover rebuilds the pipeline
    #: shape — via the same per-hop resizes, since every shape is a
    #: parameterization of the same stage chain — while buffers, ledger,
    #: fleet grant, and the stream digest carry over.  None = same shape.
    path: Optional[str] = None

    def __bool__(self) -> bool:
        return bool(self.hops or self.branch_hops or self.weights
                    or self.path)


def plan_delta(old: TransferPlan, new: TransferPlan) -> PlanDelta:
    """The applicable difference between two same-topology plans.

    Hops match by name (a replan preserves stage names and order); a
    weight counts as shifted beyond round-off at 3 decimals — the same
    signature the drain-path revision counter used, so the two execution
    modes count replans identically."""
    delta = PlanDelta()

    def changed_hop(h: HopPlan, prev: HopPlan | None) -> bool:
        # rtt_s is part of the live-applicable surface: an rtt-revised
        # plan whose (clamped) window came out numerically identical must
        # still produce a truthy delta, or the running WindowedStage
        # keeps a stale ACK clock through the revision.  The retry
        # posture rides the same surface: a fault-priced budget must
        # reach the running stage before the element's next flap.
        return prev is None or (
            (h.capacity, h.workers, h.window_bytes, h.batch_items, h.rtt_s,
             h.retry_budget, h.backoff_base_s)
            != (prev.capacity, prev.workers, prev.window_bytes,
                prev.batch_items, prev.rtt_s,
                prev.retry_budget, prev.backoff_base_s))

    def revision(h: HopPlan) -> HopRevision:
        return HopRevision(h.name, h.capacity, h.workers, h.window_bytes,
                           h.batch_items, h.rtt_s,
                           retry_budget=h.retry_budget,
                           backoff_base_s=h.backoff_base_s)

    if new.path != old.path:
        delta.path = new.path
    old_hops = {h.name: h for h in old.hops}
    for h in new.hops:
        if changed_hop(h, old_hops.get(h.name)):
            delta.hops[h.name] = revision(h)
    old_branches = {b.branch_id: b for b in old.branches}
    for b in new.branches:
        prev = old_branches.get(b.branch_id)
        if prev is not None and round(b.weight, 3) != round(prev.weight, 3):
            delta.weights[b.branch_id] = b.weight
        prev_hops = {h.name: h for h in prev.hops} if prev is not None else {}
        changed = {}
        for h in b.hops:
            if changed_hop(h, prev_hops.get(h.name)):
                changed[h.name] = revision(h)
        if changed:
            delta.branch_hops[b.branch_id] = changed
    return delta


def _segment(tiers: Sequence[Tier], n_stages: int, j: int
             ) -> tuple[int, int]:
    """Tier-index span [lo, hi] that stage ``j`` of ``n_stages`` covers.

    Stages partition the basin path evenly; each hop pulls from its
    segment's first tier and delivers toward its last."""
    T = len(tiers)
    lo = j * (T - 1) // n_stages
    hi = (j + 1) * (T - 1) // n_stages
    hi = max(hi, lo + 1)
    return lo, min(hi, T - 1)


def _segment_rtt(basin: DrainageBasin, lo: int, hi: int) -> float:
    names = {t.name for t in basin.tiers[lo:hi + 1]}
    rtts = [l.rtt_s for l in basin.links
            if l.src in names and l.dst in names]
    return max(rtts, default=0.0)


def _segment_window(basin: DrainageBasin, lo: int, hi: int
                    ) -> tuple[float, float, str, float]:
    """(rtt_s, bdp_bytes, "src->dst", loss_rate) of the highest-BDP
    windowed link inside the tier span — the link whose ACK clock governs
    this hop.  (0, 0, "", 0) when the segment crosses no latency-bearing
    link (a queue-clocked hop)."""
    names = {t.name for t in basin.tiers[lo:hi + 1]}
    best = (0.0, 0.0, "", 0.0)
    for l in basin.links:
        if l.src in names and l.dst in names and l.rtt_s > 0:
            if l.bdp_bytes() > best[1]:
                best = (l.rtt_s, l.bdp_bytes(), f"{l.src}->{l.dst}",
                        l.loss_rate)
    return best


def _raw_line_rate(basin: DrainageBasin) -> float:
    """Line rate ignoring per-item latency: min raw bandwidth over every
    tier and link.  Concurrency (workers) is how a hop reaches it despite
    latency — the paper's §3.1 latency insensitivity."""
    rates = [t.bandwidth_bytes_per_s for t in basin.tiers]
    rates.extend(l.bandwidth_bytes_per_s for l in basin.links)
    return min(rates)


def _worker_rate(up: Tier, down: Tier, item_bytes: float,
                 batch_items: int = 1,
                 extra_latency_s: float = 0.0) -> float:
    """Sustained rate of ONE staging worker doing pull -> transform ->
    push: upstream service time (with latency + jitter) plus downstream
    delivery, serialized within the worker.

    A batched worker pays the per-operation latency/jitter once per
    *slab* of ``batch_items`` — the analytic form of the zero-copy data
    plane's amortization (one lock round-trip, one admission check per
    slab); the per-byte transmit cost is unchanged.  ``batch_items=1``
    is the historical per-item figure exactly.

    ``extra_latency_s`` is charged per *item*, never amortized by the
    slab: it models the expected retransmit round trips on a lossy
    windowed hop (``loss_rate * rtt_s``), which each item pays
    independently — concurrency across workers, not batching within
    one, is what rides those round trips out."""
    b = max(1, int(batch_items))
    t = (item_bytes / up.bandwidth_bytes_per_s
         + (up.latency_s + up.jitter_s) / b
         + item_bytes / down.bandwidth_bytes_per_s + down.latency_s / b
         + extra_latency_s)
    return item_bytes / t


def _resolve_batch(batch_items: Optional[object],
                   item_bytes: float) -> int:
    """The slab-size policy -> a concrete per-hop starting point.

    ``None``/1 keeps the per-item path; ``"auto"`` targets
    :data:`SLAB_TARGET_BYTES` per slab (further clamped per hop by window
    and capacity); an explicit int is taken as given (same clamps)."""
    if batch_items is None:
        return 1
    if batch_items == "auto":
        return max(1, int(SLAB_TARGET_BYTES // item_bytes))
    b = int(batch_items)
    if b < 1:
        raise ValueError(f"batch_items must be >= 1, got {batch_items!r}")
    return b


def _plan_path(
    basin: DrainageBasin,
    item_bytes: float,
    stages: Sequence[str],
    ordered: bool,
    max_workers: int,
    max_capacity: int,
    target: float | None = None,
    max_window_bytes: float | None = None,
    batch_items: int = 1,
    rate_cap: float | None = None,
    shape: str = "windowed-staged",
    wire_ratio: float = 1.0,
) -> tuple[list[HopPlan], list[float], float]:
    """Per-hop parameters for one *linear* path.  ``target`` overrides the
    rate the hops are sized against (a branch's allocated share); default
    is the path's own raw line rate.  ``max_window_bytes`` caps every
    windowed hop's in-flight window (the host buffer limit).
    ``batch_items`` is the resolved slab-size starting point (see
    :func:`_resolve_batch`); each hop clamps it to its own window and
    burst capacity.  ``rate_cap`` is an arbiter grant: windows size from
    ``grant x RTT`` instead of the link's full BDP, so a capped windowed
    hop self-paces to its share on a link it does not own — uncapped
    plans keep the historical BDP sizing bit for bit.

    ``shape`` parameterizes the same stage chain into one of
    :data:`PATH_CHOICES`: ``"windowed-staged"`` (and ``"compressed"``,
    which additionally scales every link's wire bytes by ``wire_ratio``)
    keep the historical derivation; ``"staged"`` runs N synchronous
    streams — each worker pays the full round trip per item, the window
    holds exactly one item per worker; ``"direct"`` is the cut-through
    stream — one worker, one buffer slot, stop-and-wait credit of a
    single item on any latency-bearing link.  Because shapes differ only
    in hop parameters, a live path switch is applied with the same
    zero-drain resizes as any other revision."""
    tiers = basin.tiers
    n = len(stages)
    if target is None:
        target = _raw_line_rate(basin)
    if rate_cap is not None:
        target = min(target, rate_cap)
    sync_rtt = shape in ("direct", "staged")

    hops: list[HopPlan] = []
    headroom: list[float] = []          # uncapped sustainable rate per hop
    for j, name in enumerate(stages):
        lo, hi = _segment(tiers, n, j)
        up, down = tiers[lo], tiers[hi]
        # the segment's burst capacity is a hard ceiling: never plan more
        # staged items than the smallest tier on the hop can actually hold
        cap_bytes = min(t.capacity_bytes for t in tiers[lo:hi + 1])
        # RTT-governed hop: the in-flight window is sized from the link's
        # BDP with jitter headroom (§3.1/§3.2), clamped to the segment's
        # burst capacity and the host's window limit.  The two clamps
        # mean different things: a *burst-capacity* clamp is a physical
        # model fact (the hop cannot keep more in flight than the
        # staging tier holds), so the hop's promise honestly drops to
        # window/RTT; a *host* (``max_window_bytes``) clamp is a fixable
        # misconfiguration, so the promise stays the line rate and the
        # shortfall surfaces as a fidelity gap + window-bound verdict —
        # whose remedy (lifting the clamp) then actually works.
        rtt, bdp, win_link, loss = _segment_window(basin, lo, hi)
        win = 0.0
        hop_cap = target
        if rtt > 0 and bdp > 0:
            # a lossy link pays one extra RTT per retransmitted item
            # (§3.2): riding those round trips out without draining the
            # pipe needs (1 + loss) windows of bytes in flight — and a
            # window clamped below that only ever delivers
            # ``win / (rtt * (1 + loss))``, so the burst-capacity clamp
            # drops the hop's promise by the same factor (honesty), while
            # a host clamp keeps the promise and surfaces as window-bound
            # an arbiter-capped plan keeps only its granted share of the
            # pipe in flight: window credit IS the enforcement mechanism
            # (K capped peers on one work-conserving link each converge
            # to exactly their grant — the credit clocks, not goodwill).
            # A binding grant carries NO jitter headroom: headroom exists
            # to absorb estimate error on a link the plan owns, but on a
            # shared link it would overshoot the grant — and K overshoots
            # sum to a standing queue whose delay lands unevenly (big
            # windows burst hardest), skewing every class off its share.
            # wire bytes per item: the compressed shape moves the int8
            # form across the link, so window credit (which meters the
            # WIRE) is sized and charged in compressed bytes while hop
            # rates stay in delivered (uncompressed) bytes
            wire_item = item_bytes / wire_ratio
            capped = rate_cap is not None and (target / wire_ratio) * rtt < bdp
            if capped:
                bdp = (target / wire_ratio) * rtt
            slack = 1.0 if capped else WINDOW_HEADROOM
            bdp_eff = bdp * (1.0 + loss)
            if shape == "direct":
                # stop-and-wait: exactly one item's wire bytes in flight;
                # every item pays the round trip (charged in rate_1 below)
                win = wire_item
            else:
                win = bdp_eff * slack
                # coarse admission units (§3.4): the window admits whole
                # items, so once one item is a sizable fraction of the BDP
                # a BDP-sized window degenerates toward stop-and-wait — it
                # cannot hold the item in transmission AND its unACKed
                # predecessors.  Size for both, and throughput stays flat
                # from KiB items to GiB items (the fig4 claim).
                if wire_item * 4 > bdp_eff:
                    win = (bdp_eff + wire_item) * slack
            if math.isfinite(cap_bytes) and cap_bytes < win:
                win = cap_bytes
                hop_cap = min(hop_cap,
                              wire_ratio * win / (rtt * (1.0 + loss)))
            if max_window_bytes is not None:
                win = min(win, float(max_window_bytes))
        # slab size: ordered transfers pin to per-item (a slab reorders
        # nothing, but per-item keeps the stream's pacing exact); a
        # windowed hop never slabs more than one window's worth, or a
        # single admission could park the whole pool on the ACK clock
        b = 1 if ordered else batch_items
        if b > 1 and win > 0:
            b = max(1, min(b, int(win // item_bytes)))
        # a lossy hop's workers each carry the expected retransmit
        # round trip per item; the pool is staffed for it, and when even
        # ``max_workers`` cannot reach the line, the hop's promise drops
        # with the staffed pool — honestly, not as a fidelity gap.  The
        # synchronous shapes (direct, staged) pay the FULL round trip
        # per item — that is what makes them lose on a long fat link and
        # what makes their model honest when they win anyway.
        extra = rtt * (1.0 + loss) if (sync_rtt and rtt > 0) else loss * rtt
        rate_1 = _worker_rate(up, down, item_bytes, batch_items=b,
                              extra_latency_s=extra)
        if ordered or shape == "direct":
            workers = 1
        else:
            workers = max(1, min(max_workers, math.ceil(target / rate_1)))
        # Little's law over the stochastic window, double-buffered
        window_s = up.jitter_s + down.jitter_s + _segment_rtt(basin, lo, hi)
        need_items = math.ceil(target * window_s / item_bytes)
        capacity = max(2, workers + 1, 2 * need_items)
        if b > 1:
            # double-buffered slabs: one slab staged while the next fills
            capacity = max(capacity, 2 * b)
        capacity = min(capacity, max_capacity)
        if math.isfinite(cap_bytes):
            capacity = min(capacity, max(1, int(cap_bytes // item_bytes)))
            # a buffer shallower than the pool serializes the extra
            # workers; shrink the pool so the promised rate stays honest
            workers = min(workers, max(1, capacity - 1))
        if b > 1:
            # whatever clamped capacity also clamps the slab (a slab must
            # fit the buffer twice over, or put_many serializes in waves)
            b = max(1, min(b, capacity // 2))
        if shape == "direct":
            # cut-through: no burst-buffer depth, no pool, no slabs —
            # the item passes straight through, which is exactly where
            # the shape's win (no staging copy) and its loss (no
            # concurrency to amortize latency) both come from
            workers, capacity, b = 1, 1, 1
        elif shape == "staged" and win > 0:
            # N synchronous streams: window credit of one item per
            # worker, so each stream is stop-and-wait on its own round
            # trip while the pool overlaps them — transport credit never
            # exceeds what the synchronous semantics can use
            win = workers * (item_bytes / wire_ratio)
            if math.isfinite(cap_bytes):
                win = min(win, cap_bytes)
            if max_window_bytes is not None:
                win = min(win, float(max_window_bytes))
        headroom.append(workers * rate_1)
        hop_rate = min(workers * rate_1, hop_cap)
        hops.append(HopPlan(name=name, capacity=capacity, workers=workers,
                            up_tier=up.name, down_tier=down.name,
                            rate_bytes_per_s=hop_rate,
                            window_bytes=win, rtt_s=rtt,
                            window_link=win_link if win > 0 else "",
                            loss_rate=loss if win > 0 else 0.0,
                            batch_items=b))

    achievable = basin.achievable_throughput()
    if wire_ratio > 1.0:
        # the compressed wire carries ratio-fewer bytes per delivered
        # byte: links stop binding until their boosted rate does, and the
        # quantize kernel's service rate becomes the new ceiling
        rates = [t.bandwidth_bytes_per_s for t in tiers]
        rates.extend((l.bandwidth_bytes_per_s or math.inf) * wire_ratio
                     for l in basin.links)
        achievable = min(min(rates), COMPRESS_BYTES_PER_S)
    planned = min(min(h.rate_bytes_per_s for h in hops), achievable)
    return hops, headroom, planned


#: a window clamp is either one host limit for the whole plan (float) or
#: a per-branch mapping ``branch_id -> bytes`` (two WAN branches behind
#: different host configs); ``None``/missing branch = BDP-sized
WindowClamp = Optional[Union[float, Mapping[str, float]]]


def _branch_window_clamp(max_window_bytes: WindowClamp,
                         branch_id: str) -> Optional[float]:
    """Resolve the window clamp that applies to one branch."""
    if max_window_bytes is None:
        return None
    if isinstance(max_window_bytes, collections.abc.Mapping):
        v = max_window_bytes.get(branch_id)
        return float(v) if v is not None else None
    return float(max_window_bytes)


def _branch_ids(paths: Sequence[tuple[str, ...]]) -> list[str]:
    """Shortest distinguishing name per path: the sink when sinks differ
    (fan-out), the root when roots differ (fan-in), else the full path."""
    sinks = [p[-1] for p in paths]
    if len(set(sinks)) == len(paths):
        return sinks
    roots = [p[0] for p in paths]
    if len(set(roots)) == len(paths):
        return roots
    return ["->".join(p) for p in paths]


# ---------------------------------------------------------------------------
# Path decision engine: §3.6's stream-vs-stage question, priced per basin
# ---------------------------------------------------------------------------


def _resolve_dist(item_bytes_dist, item_bytes: float
                  ) -> tuple[tuple[float, float], ...]:
    """Normalize an item-size histogram to ``((bytes, weight), ...)``.

    Accepts a mapping ``bytes -> weight`` or a sequence of pairs; None
    degenerates to a single bucket at ``item_bytes``.  Weights are
    relative (they need not sum to 1)."""
    if item_bytes_dist is None:
        return ((float(item_bytes), 1.0),)
    if isinstance(item_bytes_dist, collections.abc.Mapping):
        pairs = list(item_bytes_dist.items())
    else:
        pairs = [tuple(p) for p in item_bytes_dist]
    out = []
    for b, w in pairs:
        b, w = float(b), float(w)
        if b <= 0 or w <= 0:
            raise ValueError(
                f"item_bytes_dist buckets must be positive, got ({b}, {w})")
        out.append((b, w))
    if not out:
        raise ValueError("item_bytes_dist must not be empty")
    return tuple(out)


def _retry_posture(fault_rate: float) -> tuple[int, float]:
    """(retry_budget, backoff_base_s) priced from an element's observed
    transient-fault rate (retries per item — the inverse of its MTBF in
    items).  A fault-free element keeps the cheap default; a flapping one
    gets budget in proportion to how often it flaps (more faults per item
    -> more attempts funded before the failure is final) and a shorter
    backoff base (frequent transient blips clear fast; the budget, not
    long waits, carries the persistence risk)."""
    if fault_rate <= 0:
        return DEFAULT_RETRY_BUDGET, DEFAULT_BACKOFF_BASE_S
    budget = min(MAX_RETRY_BUDGET,
                 DEFAULT_RETRY_BUDGET + math.ceil(fault_rate / 0.05))
    backoff = max(0.01,
                  DEFAULT_BACKOFF_BASE_S * (1.0 - min(0.8, 10.0 * fault_rate)))
    return budget, backoff


def _stamp_retry_budgets(hops: list[HopPlan],
                         priors: Mapping[str, float]) -> None:
    """Re-price each hop's fault posture from the telemetry priors, in
    place (hop lists are shared between ``plan.hops`` and the primary
    branch — mutating preserves that identity)."""
    for i, h in enumerate(hops):
        f = priors.get(h.window_link or h.up_tier,
                       priors.get(h.up_tier, 0.0))
        budget, backoff = _retry_posture(f)
        if (budget, backoff) != (h.retry_budget, h.backoff_base_s):
            hops[i] = dataclasses.replace(h, retry_budget=budget,
                                          backoff_base_s=backoff)


def _shape_rate(basin: DrainageBasin, shape: str, item_bytes: float, *,
                checksum: bool, digest_rate: float, ordered: bool,
                max_workers: int, max_window_bytes: Optional[float],
                rate_cap: Optional[float],
                target: Optional[float] = None) -> float:
    """Modeled end-to-end bytes/s of one execution shape over one linear
    path at one item size — the pricing model behind ``path="auto"``.

    The four shapes price §3.6's trade directly:

    * ``direct`` — serialized cut-through: every non-staging element's
      transmit + latency is paid per item, in sequence, plus the full
      round trip of every link (stop-and-wait) and the serial digest when
      integrity is on.  Interior BURST_BUFFER tiers are *bypassed* — the
      direct stream never pays the staging copy, which is exactly how it
      wins on a path whose staging tier is the priced bottleneck.
    * ``staged`` — concurrent synchronous streams through the burst
      buffer: the pool amortizes per-item latency, but each item still
      carries its links' full round trips.
    * ``windowed-staged`` — staged plus BDP-sized transport credit: round
      trips amortize into the window; each windowed link instead ceilings
      at ``window / RTT``.
    * ``compressed`` — windowed-staged with every link's wire bytes
      scaled by :data:`COMPRESS_WIRE_RATIO`, the whole path ceilinged at
      :data:`COMPRESS_BYTES_PER_S` of quantize compute.
    """
    tiers = basin.tiers
    links = basin.links
    wire_ratio = COMPRESS_WIRE_RATIO if shape == "compressed" else 1.0

    if shape == "direct":
        t = 0.0
        for i, tier in enumerate(tiers):
            if (0 < i < len(tiers) - 1
                    and tier.kind is TierKind.BURST_BUFFER):
                continue
            t += (item_bytes / tier.bandwidth_bytes_per_s
                  + tier.latency_s + tier.jitter_s)
        for link in links:
            if link.bandwidth_bytes_per_s:
                t += item_bytes / link.bandwidth_bytes_per_s
            t += link.rtt_s * (1.0 + link.loss_rate)
        if checksum:
            t += item_bytes / digest_rate
        rate = item_bytes / t
    else:
        rates = [tier.bandwidth_bytes_per_s for tier in tiers]
        rates.extend((link.bandwidth_bytes_per_s or math.inf) * wire_ratio
                     for link in links)
        line = min(rates)
        if shape == "compressed":
            line = min(line, COMPRESS_BYTES_PER_S)
        lat_total = sum(tier.latency_s + tier.jitter_s for tier in tiers)
        if shape == "staged":
            per_item = lat_total + sum(l.rtt_s * (1.0 + l.loss_rate)
                                       for l in links)
        else:
            per_item = lat_total + sum(l.rtt_s * l.loss_rate for l in links)
        workers = 1 if ordered else max_workers
        worker_rate = item_bytes / (item_bytes / line + per_item)
        rate = min(line, workers * worker_rate)
        if shape in ("windowed-staged", "compressed"):
            cap_bytes = min(tier.capacity_bytes for tier in tiers)
            for link in links:
                if link.rtt_s <= 0:
                    continue
                bdp_eff = link.bdp_bytes() * (1.0 + link.loss_rate)
                wire_item = item_bytes / wire_ratio
                win = bdp_eff * WINDOW_HEADROOM
                if wire_item * 4 > bdp_eff:
                    win = (bdp_eff + wire_item) * WINDOW_HEADROOM
                if math.isfinite(cap_bytes):
                    win = min(win, cap_bytes)
                if max_window_bytes is not None:
                    win = min(win, float(max_window_bytes))
                rate = min(rate, wire_ratio * win
                           / (link.rtt_s * (1.0 + link.loss_rate)))
        if checksum:
            # the staged digest overlaps transit but still ceilings the
            # pipeline — §3.4's integrity budget, shape-priced
            rate = min(rate, digest_rate)
    if rate_cap is not None:
        rate = min(rate, rate_cap)
    if target is not None:
        rate = min(rate, target)
    return rate


def _score_paths(basin: DrainageBasin,
                 dist: Sequence[tuple[float, float]], *,
                 checksum: bool, digest_rate: float, ordered: bool,
                 max_workers: int, max_window_bytes: WindowClamp,
                 rate_cap: Optional[float],
                 compressible: bool) -> dict[str, float]:
    """Candidate shape -> modeled end-to-end bytes/s over the item-size
    distribution (byte-weighted harmonic mean: the rate at which the MIX
    moves, so a small-file storm's per-item latency prices honestly
    instead of hiding behind the mean size).  Branching basins score each
    root->sink path at its conservation-allocated share and sum."""
    candidates = [c for c in PATH_CHOICES
                  if compressible or c != "compressed"]
    if basin.is_linear:
        paths = [tuple(t.name for t in basin.tiers)]
        subs = {paths[0]: basin}
        targets: dict = {paths[0]: None}
        ids = [paths[0][-1]]
    else:
        paths = basin.paths()
        subs = {p: basin.path_basin(p) for p in paths}
        targets = basin.branch_rates()
        ids = _branch_ids(paths)
    scores: dict[str, float] = {}
    for cand in candidates:
        total = 0.0
        for bid, p in zip(ids, paths):
            clamp = _branch_window_clamp(max_window_bytes, bid)
            total_bytes = sum(b * w for b, w in dist)
            total_time = sum(
                b * w / _shape_rate(subs[p], cand, b, checksum=checksum,
                                    digest_rate=digest_rate,
                                    ordered=ordered,
                                    max_workers=max_workers,
                                    max_window_bytes=clamp,
                                    rate_cap=rate_cap,
                                    target=targets[p])
                for b, w in dist)
            total += total_bytes / total_time
        scores[cand] = total
    return scores


#: deterministic tie-break for equal scores: the historical full shape
#: first, then the cheaper shapes — a tie must never flip behaviour away
#: from what an un-priced plan would have built
_PATH_PREFERENCE = {"windowed-staged": 0, "staged": 1, "compressed": 2,
                    "direct": 3}


def _choose_path(scores: Mapping[str, float], *,
                 incumbent: Optional[str] = None,
                 margin: float = 1.0) -> str:
    """Highest-scoring candidate; with an ``incumbent`` (online
    revision), the challenger must win by ``margin`` or the running shape
    stands — a live rebuild is not free, and near-ties would flap."""
    best = max(scores, key=lambda k: (scores[k], -_PATH_PREFERENCE[k]))
    if (incumbent is not None and incumbent in scores
            and scores[best] <= scores[incumbent] * margin):
        return incumbent
    return best


def plan_transfer(
    basin: DrainageBasin,
    item_bytes: float,
    *,
    stages: Sequence[str] = ("stage",),
    checksum: bool = False,
    ordered: bool = False,
    max_workers: int = MAX_WORKERS,
    max_capacity: int = MAX_CAPACITY,
    max_window_bytes: WindowClamp = None,
    batch_items: Optional[object] = None,
    checksum_placement: str = "host",
    host_digest_bytes_per_s: float = HOST_DIGEST_BYTES_PER_S,
    accel_digest_bytes_per_s: float = ACCEL_DIGEST_BYTES_PER_S,
    rate_cap_bytes_per_s: Optional[float] = None,
    path: Optional[str] = None,
    item_bytes_dist: Optional[object] = None,
    compressible: bool = False,
    fault_priors: Optional[Mapping[str, float]] = None,
) -> TransferPlan:
    """Derive per-hop staging parameters from the basin model.

    ``stages`` names the hops the consumer will run (one
    :class:`~repro_torch.core.staging.Stage` each); each root->sink path is
    split evenly across them.  ``ordered=True`` pins every hop to one
    worker — required when item order must survive the transfer (training
    batches, decode token streams); buffer depth still comes from the
    model, so jitter absorption is preserved.

    Hops whose segment crosses a latency-bearing link are **windowed**:
    ``HopPlan.window_bytes`` is sized from the link's BDP (with
    :data:`WINDOW_HEADROOM`) and executed by a
    :class:`~repro_torch.core.staging.WindowedStage`.  ``max_window_bytes``
    models the host's socket/stream-buffer limit (§3.2): a clamp below
    BDP pins delivery at ``window / RTT`` — the plan keeps promising the
    line rate so the shortfall surfaces as a window-bound verdict.  A
    mapping ``branch_id -> bytes`` clamps per branch (two WAN branches
    behind differently configured hosts plan — and get diagnosed —
    independently); on a linear basin the branch id is the sink tier's
    name.  A lossy link (``Link.loss_rate > 0``) plans a window deepened
    by ``(1 + loss_rate)`` so retransmit round trips don't drain the
    pipe, and any burst-capacity clamp drops the hop's promise by the
    same factor.

    On a branching basin the returned plan carries one
    :class:`BranchPlan` per root->sink path, each sized against its
    conservation-allocated rate share; ``planned_bytes_per_s`` is the
    aggregate and ``weight`` the traffic share per branch.

    ``batch_items`` selects the zero-copy slab path: ``None`` (default)
    keeps every hop per-item, ``"auto"`` sizes slabs toward
    :data:`SLAB_TARGET_BYTES`, an int pins the slab.  Ordered transfers
    stay per-item regardless.  ``checksum_placement`` charges the stream
    digest (§3.4's integrity budget) to the right compute resource:
    ``"host"`` models the staging CPU's hash rate
    (``host_digest_bytes_per_s``) on the checksum hop — which can pin it,
    the **host-compute-bound** misconfiguration of "Demystifying the
    Performance of Data Transfers" — while ``"accel"`` charges the
    batched Pallas digest kernel's rate (``accel_digest_bytes_per_s``),
    taking integrity off the host's critical path.

    ``rate_cap_bytes_per_s`` is an arbiter grant (see
    :mod:`repro_torch.core.fleet`): every hop is sized against
    ``min(line rate, grant)``, windowed hops get ``grant x RTT`` windows
    (the credit clock enforces the share on a link the transfer does not
    own), the promise becomes the grant, and :func:`replan` will not read
    share-shaped stalls on a hop still delivering its grant as a degraded
    tier.  ``None`` (default) plans as the basin's sole occupant.

    ``path`` engages the decision engine (§3.6): ``"auto"`` prices every
    candidate shape in :data:`PATH_CHOICES` over the basin, integrity
    placement, and item-size distribution, and parameterizes the hops for
    the winner (recorded as :attr:`TransferPlan.path`, candidates in
    :attr:`TransferPlan.path_scores`; :func:`replan` may later flip it —
    the **path-revised** verdict); a concrete shape name forces it;
    ``None`` (default) keeps the historical derivation bit for bit.
    ``item_bytes_dist`` is an optional histogram (mapping or pairs of
    ``bytes -> weight``) the candidates are priced over — a small-file
    storm prices per-item latency honestly instead of at the mean.
    ``compressible=True`` vouches the payload survives the int8 wire
    transform, making the compressed candidate enumerable.
    ``fault_priors`` (element -> observed transient-fault rate) prices
    each hop's ``retry_budget``/``backoff_base_s``; absent elements keep
    the cheap default posture.
    """
    if item_bytes <= 0:
        raise ValueError("item_bytes must be > 0")
    if rate_cap_bytes_per_s is not None and rate_cap_bytes_per_s <= 0:
        raise ValueError("rate_cap_bytes_per_s must be > 0 or None")
    if not stages:
        raise ValueError("need at least one stage name")
    if checksum_placement not in ("host", "accel"):
        raise ValueError(
            f"checksum_placement must be 'host' or 'accel', "
            f"got {checksum_placement!r}")
    batch = _resolve_batch(batch_items, item_bytes)
    digest_rate = (host_digest_bytes_per_s if checksum_placement == "host"
                   else accel_digest_bytes_per_s)

    # -- path decision (§3.6): price the candidate shapes, pick one ----------
    compressible = bool(compressible) or path == "compressed"
    dist = _resolve_dist(item_bytes_dist, item_bytes)
    path_scores: dict[str, float] = {}
    if path is not None:
        if path != "auto" and path not in PATH_CHOICES:
            raise ValueError(f"path must be 'auto' or one of {PATH_CHOICES},"
                             f" got {path!r}")
        path_scores = _score_paths(
            basin, dist, checksum=checksum, digest_rate=digest_rate,
            ordered=ordered, max_workers=max_workers,
            max_window_bytes=max_window_bytes,
            rate_cap=rate_cap_bytes_per_s, compressible=compressible)
        shape = _choose_path(path_scores) if path == "auto" else path
    else:
        shape = "windowed-staged"
    wire_ratio = COMPRESS_WIRE_RATIO if shape == "compressed" else 1.0

    def _label(all_hops: Sequence[HopPlan]) -> str:
        # legacy derivations label what they built without pricing it
        if path is not None:
            return shape
        return ("windowed-staged"
                if any(h.window_bytes > 0 for h in all_hops) else "staged")

    def _compressed_target(sub: DrainageBasin,
                           base: Optional[float]) -> Optional[float]:
        # the compressed shape's line rate: links carry the int8 form
        # (wire bytes / ratio), the whole path ceilings at the quantize
        # kernel's service rate
        if shape != "compressed":
            return base
        rates = [t.bandwidth_bytes_per_s for t in sub.tiers]
        rates.extend((l.bandwidth_bytes_per_s or math.inf) * wire_ratio
                     for l in sub.links)
        boosted = min(min(rates), COMPRESS_BYTES_PER_S)
        return boosted if base is None else min(base, boosted)

    if basin.is_linear:
        hops, headroom, planned = _plan_path(
            basin, item_bytes, stages, ordered, max_workers, max_capacity,
            target=_compressed_target(basin, None),
            max_window_bytes=_branch_window_clamp(
                max_window_bytes, basin.tiers[-1].name),
            batch_items=batch, rate_cap=rate_cap_bytes_per_s,
            shape=shape, wire_ratio=wire_ratio)
        if fault_priors:
            _stamp_retry_budgets(hops, fault_priors)
        if rate_cap_bytes_per_s is not None:
            planned = min(planned, rate_cap_bytes_per_s)
        checksum_index = None
        if checksum:
            # integrity rides the hop with the most headroom over the plan
            checksum_index = max(range(len(hops)), key=lambda i: headroom[i])
            # ... and that hop is charged the digest service rate of the
            # placement, so replan can tell "the hash pinned the hop"
            # (host-compute-bound) apart from a slow tier
            hops[checksum_index] = dataclasses.replace(
                hops[checksum_index], digest_bytes_per_s=digest_rate)
        tier_path = tuple(t.name for t in basin.tiers)
        branch = BranchPlan(branch_id=tier_path[-1], path=tier_path,
                            hops=hops,
                            rate_bytes_per_s=planned, weight=1.0,
                            private_tiers=tier_path)
        return TransferPlan(hops=hops, item_bytes=float(item_bytes),
                            planned_bytes_per_s=planned,
                            checksum_index=checksum_index, basin=basin,
                            ordered=ordered, branches=[branch],
                            max_window_bytes=max_window_bytes,
                            checksum_placement=checksum_placement,
                            batch_policy=batch_items,
                            rate_cap_bytes_per_s=rate_cap_bytes_per_s,
                            host_digest_bytes_per_s=host_digest_bytes_per_s,
                            accel_digest_bytes_per_s=accel_digest_bytes_per_s,
                            path=_label(hops), path_policy=path,
                            path_scores=path_scores,
                            item_bytes_dist=(dist if item_bytes_dist
                                             is not None else None),
                            compressible=compressible,
                            fault_priors=(dict(fault_priors)
                                          if fault_priors else None))

    # -- branching basin: one plan per root->sink path -----------------------
    paths = basin.paths()
    rates = basin.branch_rates()
    # an arbiter grant below the aggregate scales every branch's share
    # proportionally — conservation INSIDE the plan is branch_rates' job,
    # conservation ACROSS plans is the grant's
    cap_scale = 1.0
    if rate_cap_bytes_per_s is not None:
        agg = sum(rates.values())
        if agg > rate_cap_bytes_per_s > 0:
            cap_scale = rate_cap_bytes_per_s / agg
    ids = _branch_ids(paths)
    crossing = {t.name: sum(1 for p in paths if t.name in p)
                for t in basin.tiers}
    branches: list[BranchPlan] = []
    for bid, tier_path in zip(ids, paths):
        sub = basin.path_basin(tier_path)
        hops, _, planned = _plan_path(
            sub, item_bytes, stages, ordered, max_workers, max_capacity,
            target=_compressed_target(sub, rates[tier_path] * cap_scale),
            max_window_bytes=_branch_window_clamp(max_window_bytes, bid),
            batch_items=batch,
            rate_cap=None if rate_cap_bytes_per_s is None
            else rates[tier_path] * cap_scale,
            shape=shape, wire_ratio=wire_ratio)
        if fault_priors:
            _stamp_retry_budgets(hops, fault_priors)
        branches.append(BranchPlan(
            branch_id=bid, path=tier_path, hops=hops,
            rate_bytes_per_s=planned, weight=0.0,
            private_tiers=tuple(n for n in tier_path if crossing[n] == 1)))
    aggregate = sum(b.rate_bytes_per_s for b in branches)
    for b in branches:
        b.weight = (b.rate_bytes_per_s / aggregate) if aggregate > 0 \
            else 1.0 / len(branches)
    primary = max(branches, key=lambda b: b.rate_bytes_per_s)
    return TransferPlan(hops=primary.hops, item_bytes=float(item_bytes),
                        planned_bytes_per_s=aggregate,
                        checksum_index=None, basin=basin,
                        ordered=ordered, branches=branches,
                        checksum_at_split=bool(checksum),
                        max_window_bytes=max_window_bytes,
                        checksum_placement=checksum_placement,
                        batch_policy=batch_items,
                        rate_cap_bytes_per_s=rate_cap_bytes_per_s,
                        host_digest_bytes_per_s=host_digest_bytes_per_s,
                        accel_digest_bytes_per_s=accel_digest_bytes_per_s,
                        path=_label([h for b in branches for h in b.hops]),
                        path_policy=path, path_scores=path_scores,
                        item_bytes_dist=(dist if item_bytes_dist
                                         is not None else None),
                        compressible=compressible,
                        fault_priors=(dict(fault_priors)
                                      if fault_priors else None))


# ---------------------------------------------------------------------------
# Adaptive re-planning: hypothesis -> change -> measure, made mechanical
# ---------------------------------------------------------------------------

#: a hop is considered stalled when this fraction of its worker-time was
#: spent waiting (below it, the measurement is noise)
STALL_THRESHOLD = 0.1

#: minimum service-time samples before a regime diagnosis is attempted
#: (fewer and the dispersion statistic is noise)
MIN_DIAGNOSIS_SAMPLES = 8

#: intake-ratio severity required for the sample-free ``culprit-slow``
#: verdict: the flagged branch must be moving at no more than half the
#: fastest sibling's pace (or backpressuring the split node at least
#: half the window).  Milder flags still shift weight and estimates, but
#: persistent diagnosis text demands more than scheduling-phase noise.
CULPRIT_SEVERITY = 0.5

#: service-sample dispersion — (p90 - p10) / median — above which a
#: stalled side reads as latency/jitter-bound; at or below it the side is
#: a steadily saturated pipe (bandwidth-bound).  A stochastic per-item
#: latency spreads the samples; a saturated pipe serves every item in
#: ~item_bytes/true_bw with near-zero spread.
LATENCY_DISPERSION = 0.75

#: a window-stalled hop is **window-bound** only when its delivered rate
#: actually sits at the window ceiling — within this factor of
#: ``window / RTT`` (§3.2's signature: throughput pinned by credit, not
#: by the pipe).  A hop that window-stalls yet delivers far above the
#: ceiling is mid-transition noise, not a pinned link.
WINDOW_PIN_SLACK = 1.5


def _percentiles(sorted_samples: Sequence[float]
                 ) -> tuple[float, float, float]:
    """(p10, median, p90) of an already-sorted sample list."""
    n = len(sorted_samples)
    return (sorted_samples[int(0.1 * (n - 1))],
            sorted_samples[n // 2],
            sorted_samples[int(0.9 * (n - 1))])


def diagnose_service(samples: Sequence[float], *,
                     workers: int = 1) -> Optional[str]:
    """Classify a stalled side's regime from its per-item service times.

    Returns ``"latency"`` (high-dispersion samples: stochastic per-item
    latency dominates — more concurrency is the remedy), ``"bandwidth"``
    (tight samples: the pipe is steadily saturated — accept the lower
    rate), or ``None`` when there are too few samples to say.

    ``workers`` widens the dispersion threshold for samples taken by a
    pool sharing one pipe: N workers on a saturated pipe see per-item
    completions spread across ``[1x .. Nx]`` the transmit time (queueing
    phase, not stochastic latency), so what counts as "dispersed" must
    scale with the pool size.
    """
    if len(samples) < MIN_DIAGNOSIS_SAMPLES:
        return None
    s = sorted(samples)
    p10, med, p90 = _percentiles(s)
    if med <= 0:
        return None
    threshold = LATENCY_DISPERSION + 0.5 * (max(1, workers) - 1)
    return "latency" if (p90 - p10) / med > threshold else "bandwidth"


@dataclasses.dataclass
class _Evidence:
    """One branch-hop's observed limitation, before attribution."""

    branch: BranchPlan
    hop: HopPlan
    report: StageReport
    up_limited: bool
    busy: bool                  # the busy-hop rule fired (no stalls)
    candidate_tier: str         # tier the raw stall accounting implicates
    #: samples were taken by a worker pool sharing one saturated pipe
    #: (dispatcher-fed culprit branch) — regime diagnosis must widen its
    #: dispersion threshold by the pool size
    pipe_shared: bool = False
    #: the hop was pinned at ~window/RTT with window-stall evidence — a
    #: transport-credit limitation, not a tier-estimate error
    window: bool = False
    #: observed ACK round trip deviating from the planned ``rtt_s`` (0 =
    #: no deviation): a route change, not a window misconfiguration — the
    #: remedy is revising the link's RTT (and re-sizing the window to the
    #: new BDP), never raising a clamp that was correct
    rtt_revised: float = 0.0
    #: observed retransmit fraction when it deviates from the modeled
    #: ``HopPlan.loss_rate`` (None = consistent with the model); drives
    #: the loss-bound verdict and silent loss decay
    loss: Optional[float] = None
    #: the checksum hop was pinned at ~its modeled digest rate with no
    #: stall on any side — the integrity budget (§3.4) is the limiter,
    #: not any tier; the remedy is offloading the digest, not touching
    #: estimates or workers
    compute: bool = False
    #: fraction of the hop's worker-time spent in retry backoff (> 0 =
    #: the hop paid its retry budget against a faulting element).  The
    #: retry counter is the stage's own first-hand telemetry; letting
    #: the backoff-inflated service samples reach the dispersion test
    #: would misread a flapping link as latency-bound, so this verdict
    #: is collected BEFORE the stall classifiers.
    faulted: float = 0.0


def _collect_evidence(plan: TransferPlan,
                      reports: Sequence[StageReport],
                      culprits: frozenset[str],
                      has_intake: bool) -> list[_Evidence]:
    """Per-branch-hop limitation evidence.

    Two regimes.  With split-node intake data (``has_intake`` — the
    parallel mover), per-worker stall accounting is phase noise across
    competing branch pipelines; evidence reduces to the two robust
    signals: a branch the split node singled out (``culprits``) that also
    underdelivers over its *active* window is busy on its own channel —
    everything else is a shadow of the culprit and carries no evidence.
    Without intake data (a linear plan, or fan-in branches that own their
    sources), the stall/busy classification is first-hand, as pre-DAG."""
    by_name = {r.name: r for r in reports}
    multipath = plan.is_multipath
    out: list[_Evidence] = []
    for branch in plan.branches:
        for hop in branch.hops:
            key = f"{branch.branch_id}/{hop.name}" if multipath else hop.name
            rep = by_name.get(key)
            if rep is None and multipath:
                rep = by_name.get(hop.name)
            if rep is None or rep.elapsed_s <= 0:
                continue
            if rep.throughput_bytes_per_s <= 0:
                continue
            # rate over the stage's *active* window: a branch that
            # finished its share early and idled behind a slow sibling
            # must not read that tail as underdelivery
            active = rep.active_s if rep.active_s > 0 else rep.elapsed_s
            active_rate = rep.bytes / active if active > 0 else 0.0
            underdelivered = (active_rate
                              < hop.rate_bytes_per_s
                              * (1.0 - STALL_THRESHOLD))
            # RTT-revision check FIRST — before window-bound can fire.
            # The observed ACK spacing is the hop's own first-hand
            # telemetry: when it deviates from the planned rtt_s, the
            # ROUTE changed, and every downstream symptom (window stall,
            # pinned delivery) is a consequence of sizing the window for
            # the wrong round trip.  Diagnosing window-bound here would
            # prescribe the wrong remedy (lift a clamp that was never
            # wrong) — §3.2's misdiagnosis family, done right.
            if (hop.window_bytes > 0 and hop.rtt_s > 0
                    and rep.acks >= MIN_RTT_SAMPLES):
                rtt_obs = rep.rtt_estimate_s
                if (rtt_obs > 0 and abs(rtt_obs - hop.rtt_s)
                        > RTT_REVISION_TOLERANCE * hop.rtt_s):
                    out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                         up_limited=True, busy=False,
                                         candidate_tier=hop.up_tier,
                                         rtt_revised=rtt_obs))
                    continue
            # loss check, second: a hop paying retransmit round trips
            # beyond what the plan modeled is loss-bound.  The
            # retransmit counter is the channel's own first-hand
            # telemetry, so no stall-ledger corroboration is required:
            # depending on pool depth the unmodeled round trips surface
            # either as window stalls (deep pipes) or as serialized
            # service time inside each worker (shallow pools), and
            # demanding one signature would let the other collapse into
            # a bandwidth-bound misdiagnosis — the §3.2 family again.
            # Either way the remedy is the same: size the window AND the
            # pool for the observed loss regime, not for any host clamp.
            loss_obs = (rep.retransmits / rep.items
                        if rep.items > 0 else 0.0)
            worker_time = rep.elapsed_s * hop.workers
            if (hop.window_bytes > 0 and hop.rtt_s > 0
                    and rep.items >= MIN_DIAGNOSIS_SAMPLES
                    and loss_obs >= LOSS_RATE_THRESHOLD
                    and loss_obs > hop.loss_rate * 1.2
                    and underdelivered):
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=False,
                                     candidate_tier=hop.up_tier,
                                     loss=loss_obs))
                continue
            # silent loss decay: a hop modeled lossy that stopped losing
            # revises the estimate back down (shallower window next
            # derivation) — quietly, no verdict string
            if (hop.window_bytes > 0 and hop.loss_rate > 0
                    and rep.items >= MIN_DIAGNOSIS_SAMPLES
                    and loss_obs < hop.loss_rate * 0.5):
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=False,
                                     candidate_tier=hop.up_tier,
                                     loss=loss_obs))
                continue
            # window-bound check next, in BOTH regimes: the ACK ledger is
            # the stage's own first-hand accounting (never phase noise
            # across competing branches), and a credit-pinned hop must not
            # fall through to the busy-hop rule — per-worker time parked
            # on the window is neither a stall side nor a slow service
            if (hop.window_bytes > 0 and hop.rtt_s > 0 and worker_time > 0
                    and rep.stall_window_s / worker_time >= STALL_THRESHOLD
                    and underdelivered
                    and active_rate <= WINDOW_PIN_SLACK
                    * hop.window_bytes / hop.rtt_s):
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=False,
                                     candidate_tier=hop.up_tier,
                                     window=True))
                continue
            # host-compute-bound check, second (also first-hand, also in
            # both regimes): the checksum hop, stalled on NO side yet
            # delivering at its modeled digest ceiling, is pinned by the
            # integrity budget — but only when the model itself puts that
            # ceiling below the hop's promise (a host-placed digest on a
            # fast path; an accelerator-placed digest's ceiling sits far
            # above line rate and can never bind)
            r_up = rep.stall_up_s / worker_time if worker_time > 0 else 0.0
            r_down = (rep.stall_down_s / worker_time
                      if worker_time > 0 else 0.0)
            r_win = (rep.stall_window_s / worker_time
                     if worker_time > 0 else 0.0)
            if (hop.digest_bytes_per_s > 0 and underdelivered
                    and hop.digest_bytes_per_s
                    < hop.rate_bytes_per_s * (1.0 - STALL_THRESHOLD)
                    and max(r_up, r_down, r_win) < STALL_THRESHOLD
                    and active_rate
                    <= DIGEST_PIN_SLACK * hop.digest_bytes_per_s):
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=True,
                                     candidate_tier=hop.up_tier,
                                     compute=True))
                continue
            # fault-degraded check, BEFORE the stall classifiers: a hop
            # that paid real worker-time in retry backoff (its own retry
            # counter — first-hand, never phase noise) and underdelivered
            # is limited by the faulting element, not by any estimate.
            # The backoff intervals inflate the per-item service samples,
            # so falling through would misdiagnose a flapping link as
            # latency-bound and prescribe MORE workers into the fault —
            # the §3.2 misdiagnosis family, robustness edition.  Remedy:
            # lower the hop's promise honestly and re-level traffic.
            retry_frac = (rep.retry_wait_s / worker_time
                          if worker_time > 0 else 0.0)
            if (rep.retries > 0 and underdelivered
                    and retry_frac >= STALL_THRESHOLD):
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=False,
                                     candidate_tier=hop.up_tier,
                                     faulted=retry_frac))
                continue
            if has_intake and multipath:
                if branch.branch_id not in culprits or not underdelivered:
                    continue
                out.append(_Evidence(branch=branch, hop=hop, report=rep,
                                     up_limited=True, busy=True,
                                     candidate_tier=hop.up_tier,
                                     pipe_shared=True))
                continue
            # arbiter-capped gate: a fleet member that is DELIVERING its
            # granted share necessarily waits whenever peers occupy the
            # rest of the pipe — those stalls are the arbiter at work,
            # not a degraded tier, and letting them fall through to the
            # stall ledger would misdiagnose every well-behaved tenant
            # as bandwidth-bound (the §3.2 misdiagnosis family, fleet
            # edition).  A capped hop below its grant is still evidence.
            if plan.rate_cap_bytes_per_s is not None and not underdelivered:
                continue
            busy = False
            if max(r_up, r_down) >= STALL_THRESHOLD:
                # the side we mostly waited on is the side that limited us
                up_limited = r_up >= r_down
            elif (len(rep.service_up_s) >= MIN_DIAGNOSIS_SAMPLES
                  and underdelivered):
                # the busy-hop case: no waiting on either side, yet the hop
                # underdelivered against its own planned rate — its per-item
                # acquisition service (pull + transform, the modeled upstream
                # tier) is slower than planned; the samples say which regime
                up_limited = True
                busy = True
            else:
                continue
            out.append(_Evidence(
                branch=branch, hop=hop, report=rep, up_limited=up_limited,
                busy=busy,
                candidate_tier=hop.up_tier if up_limited else hop.down_tier))
    return out


def _intake_culprits(plan: TransferPlan,
                     intake_ratio: Optional[Mapping[str, float]]
                     ) -> frozenset[str]:
    """Branches the split node's backpressure singles out as slow.

    The parallel mover measures, per branch, the fraction of the segment
    its dispatcher spent blocked pushing into that branch's intake queue
    (§2.2: coordination through buffer state).  A backpressure ratio both
    above the stall threshold and well above the *least* backpressured
    sibling marks a culprit: the branch is draining its share slower than
    the split node can supply it.  When every branch backpressures alike
    (a healthy, well-fed fan-out) nobody is flagged — the relative test
    is what separates "this branch is slow" from "supply outruns all"."""
    if not intake_ratio or not plan.is_multipath:
        return frozenset()
    vals = [intake_ratio.get(b.branch_id, 0.0) for b in plan.branches]
    floor = min(vals)
    return frozenset(
        b.branch_id for b in plan.branches
        if intake_ratio.get(b.branch_id, 0.0) >= STALL_THRESHOLD
        and intake_ratio.get(b.branch_id, 0.0) > 2.0 * floor)


def _attributed_tier(ev: _Evidence, evidence: Sequence[_Evidence],
                     plan: TransferPlan,
                     culprits: frozenset[str],
                     has_intake: bool) -> Optional[str]:
    """Resolve one piece of evidence to the tier it actually indicts.

    Linear plans: the raw candidate, as always.  Branching plans apply
    the private-tier and corroboration rules (module docstring): evidence
    from a culprit branch (split-node backpressure singled it out) or
    busy evidence lands on the branch's private tier; stall evidence
    against a shared tier needs every sibling branch crossing that tier
    to concur, else it is a routing shadow and is dropped.  When split-
    node backpressure data exists (``has_intake``) it overrides the
    noisier per-worker accounting: with culprits flagged, only their
    evidence counts; with none flagged, busy evidence is discarded
    (underdelivery without intake asymmetry indicts the shared supply,
    never one branch)."""
    if not plan.is_multipath:
        return ev.candidate_tier
    private = (ev.branch.private_tiers[-1] if ev.branch.private_tiers
               else ev.candidate_tier)
    if has_intake:
        # evidence was pre-filtered to culprit branches that underdeliver
        # over their active window (_collect_evidence): the defect is in
        # the branch's own channel, i.e. its deepest private tier
        return private
    # no intake data (each branch owns a real source — the fan-in case):
    # per-worker accounting is first-hand evidence
    if ev.busy:
        # time went into this branch's own pull+transform — its private
        # channel.  Deepest private tier = the branch-specific element.
        return private
    tier = ev.candidate_tier
    if tier in ev.branch.private_tiers:
        return tier
    return tier if _corroborated(ev, evidence, plan, tier, culprits) else None


def _corroborated(ev: _Evidence, evidence: Sequence[_Evidence],
                  plan: TransferPlan, tier: str,
                  culprits: frozenset[str]) -> bool:
    """Shared-tier evidence holds only when every sibling branch crossing
    the tier implicates it too; a lone branch starving upstream of a
    split node is a routing shadow."""
    siblings = [b for b in plan.branches
                if b.branch_id != ev.branch.branch_id and tier in b.path]
    for sib in siblings:
        if not any(e.branch.branch_id == sib.branch_id
                   and _raw_or_private(e, culprits) == tier
                   for e in evidence):
            return False
    return True


def _raw_or_private(ev: _Evidence, culprits: frozenset[str]) -> str:
    """The tier a sibling's evidence points at, for corroboration checks."""
    if ((ev.busy or ev.branch.branch_id in culprits)
            and ev.branch.private_tiers):
        return ev.branch.private_tiers[-1]
    return ev.candidate_tier


def replan(plan: TransferPlan, reports: Sequence[StageReport], *,
           damping: float = 0.5,
           intake_ratio: Optional[Mapping[str, float]] = None
           ) -> TransferPlan:
    """Revise a plan from observed stall ratios and service-time samples.

    For each hop, the stall accounting of its :class:`StageReport` says
    which side actually limited it (``stall_up_s`` dominant: the upstream
    tier; ``stall_down_s`` dominant: the downstream tier).  The limiting
    side's per-item service-time reservoir then says *why* — and the two
    regimes get opposite remedies:

    * **latency-bound** (dispersed samples): revise the tier's
      ``latency_s``/``jitter_s`` estimates from the sample distribution;
      the rebuilt plan raises ``workers`` / deepens the buffer while the
      bandwidth estimate (and so the planned line rate) stands,
    * **bandwidth-bound** (tight samples) — or no samples at all: pull
      the tier's bandwidth estimate toward the hop's observed throughput
      and accept the reduced line rate.

    A third verdict sits above the regime split: **window-bound**.  A
    windowed hop whose delivered rate is pinned at ~``window/RTT`` with
    dominant ``stall_window_s`` is limited by transport credit, not by
    any tier — the estimates stand, and the remedy is raising the window
    (the rebuilt plan drops the ``max_window_bytes`` clamp back to
    BDP-with-headroom, and the buffers feeding the hop re-derive), never
    adding workers: a worker pool sharing an exhausted window all parks
    on the same ACK clock (§3.2).

    A fourth verdict, **host-compute-bound**, covers the §3.4 integrity
    budget: a checksum hop stalled on no side yet pinned at its modeled
    host digest rate is limited by the hash, not by any tier.  Estimates
    and workers stand; the rebuilt plan flips ``checksum_placement`` to
    ``"accel"`` so the digest rides the Pallas kernel instead of the
    staging CPU (applies from the next transfer / rebuilt pipeline — a
    stream's digest backend never switches mid-stream).

    Two channel verdicts sit above window-bound (§3.2's misdiagnosis
    family): **rtt-revised** — the hop's observed ACK spacing deviates
    from the planned ``rtt_s`` (a route change), so the link's RTT is
    revised and the rebuilt plan re-sizes the window to the new BDP; any
    window stall was a symptom of the wrong clock, and no clamp is
    lifted.  **loss-bound** — the hop paid retransmit round trips beyond
    the modeled ``loss_rate``, so the link's loss estimate is revised and
    the rebuilt plan deepens the window by ``(1 + loss)`` (and lowers any
    capacity-clamped promise honestly).  A hop modeled lossy that stopped
    losing decays the estimate back down, quietly.  Window-bound remains
    the verdict only when the ACK clock agrees with the plan and loss is
    at its modeled level — then the clamp really is the lie, and on a
    per-branch clamp only the diagnosed branch's clamp is lifted.

    A robustness verdict, **fault-degraded**, sits before the stall
    classifiers: a hop that spent at least the stall threshold of its
    worker-time in retry backoff (``StageReport.retries`` /
    ``retry_wait_s`` — the stage's own retry ledger, first-hand) and
    underdelivered is limited by a *flapping* element, not a mis-modeled
    one.  The backoff intervals inflate the per-item service samples, so
    without this ordering a flapping link would read as latency-bound
    and the remedy would pour workers into the fault.  Instead the
    faulting side's estimate is pulled toward the observed effective
    rate (backoff included) — the promise drops honestly and a branching
    plan re-levels traffic toward healthy siblings.

    On a branching plan, reports tagged ``"<branch>/<stage>"`` attribute
    per branch (private-tier + corroboration rules, module docstring),
    and the rebuilt plan re-allocates branch rates from the revised
    estimates — traffic rebalances toward healthy branches instead of
    the whole plan degrading uniformly.  ``intake_ratio`` (branch id ->
    fraction of the segment the split node spent backpressured against
    that branch's intake, supplied by the parallel mover) sharpens the
    attribution: a branch the split node singles out is a culprit and
    its evidence lands on its private tier whatever the raw stall side
    says (see :func:`_intake_culprits`).

    ``damping`` blends old estimate and observation (1.0 = trust the
    measurement outright).  Returns a new :class:`TransferPlan` built on
    the re-estimated basin, its per-hop verdicts in
    :attr:`TransferPlan.diagnosis` (surfaced by ``describe()``); the
    original plan is untouched.
    """
    if not 0.0 < damping <= 1.0:
        raise ValueError("damping must be in (0, 1]")
    est = {t.name: t.bandwidth_bytes_per_s for t in plan.basin.tiers}
    lat_est = {t.name: t.latency_s for t in plan.basin.tiers}
    jit_est = {t.name: t.jitter_s for t in plan.basin.tiers}
    # carry the most recent verdict per hop forward: a chain of online
    # replans keeps showing what was learned even after the remedy quiets
    # the stall (describe() is the operator surface)
    diagnosis: dict[str, str] = dict(plan.diagnosis)
    culprits = _intake_culprits(plan, intake_ratio)
    evidence = _collect_evidence(plan, reports, culprits,
                                 intake_ratio is not None)
    multipath = plan.is_multipath
    # -- window-bound pre-pass: transport-credit evidence never touches the
    # tier estimates — the pipe and its model are fine, the in-flight cap
    # is the lie.  The remedy is raising the window (and the buffers that
    # feed it, which the rebuilt plan re-derives), NOT adding workers:
    # N workers sharing an exhausted window all park on the same ACK clock.
    raise_window = False
    raise_branches: set[str] = set()
    # -- host-compute pre-pass, the same shape: a checksum hop pinned at
    # its modeled digest rate indicts the integrity budget's *placement*,
    # not any tier estimate.  The remedy is offloading the digest to the
    # accelerator (the rebuilt plan flips checksum_placement, lifting the
    # hop's digest ceiling to the Pallas kernel's rate); estimates stand
    # and workers do not rise — N workers sharing one host hash pipeline
    # all queue on the same core.
    offload_digest = False
    # -- channel pre-pass: RTT and loss evidence revise the LINK model
    # ("src->dst" -> field overrides applied by replace_tiers), never the
    # tier estimates — the pipe's bandwidth is fine; its round trip or
    # its loss regime changed.  The rebuilt plan re-sizes windows from
    # the revised BDP/(1+loss); for loss it ALSO staffs the pool for the
    # retransmit round trip each item now carries, and when even the
    # full pool cannot reach the line, the hop's promise drops with it —
    # honestly, instead of surviving as a perpetual fidelity gap.
    link_rtt_rev: dict[str, float] = {}
    link_loss_rev: dict[str, float] = {}
    obs_rtt: dict[str, float] = {}
    for ev in list(evidence):
        key = (f"{ev.branch.branch_id}/{ev.hop.name}" if multipath
               else ev.hop.name)
        link = (ev.hop.window_link
                or f"{ev.hop.up_tier}->{ev.hop.down_tier}")
        if ev.rtt_revised > 0:
            evidence.remove(ev)
            link_rtt_rev[link] = ((1.0 - damping) * ev.hop.rtt_s
                                  + damping * ev.rtt_revised)
            obs_rtt[link] = ev.rtt_revised
            diagnosis[key] = f"rtt-revised({link})"
        elif ev.loss is not None:
            evidence.remove(ev)
            link_loss_rev[link] = ((1.0 - damping) * ev.hop.loss_rate
                                   + damping * ev.loss)
            if ev.loss >= LOSS_RATE_THRESHOLD:
                diagnosis[key] = f"loss-bound({link})"
            # else: silent decay — the estimate shrinks, no verdict
        elif ev.window:
            evidence.remove(ev)
            raise_window = True
            raise_branches.add(ev.branch.branch_id)
            diagnosis[key] = f"window-bound({link})"
        elif ev.compute:
            evidence.remove(ev)
            offload_digest = True
            diagnosis[key] = f"host-compute-bound({ev.hop.up_tier}:digest)"
        elif ev.faulted > 0:
            # fault-degraded: the element is flapping, not mis-modeled —
            # but the retries cost real delivered bytes, so the honest
            # remedy is pulling the faulting side's estimate toward the
            # observed effective rate (backoff time included).  On a
            # branching plan the retry counter is the branch's own
            # first-hand telemetry, so the derate lands on its private
            # tier — the rebuilt plan re-levels traffic toward healthy
            # siblings instead of degrading the whole fan-out.
            evidence.remove(ev)
            tier_name = ev.hop.up_tier
            if (multipath and ev.branch.private_tiers
                    and tier_name not in ev.branch.private_tiers):
                tier_name = ev.branch.private_tiers[-1]
            rep_f = ev.report
            active = rep_f.active_s if rep_f.active_s > 0 \
                else rep_f.elapsed_s
            observed = rep_f.bytes / active if active > 0 else 0.0
            if observed > 0:
                est[tier_name] = ((1.0 - damping) * est[tier_name]
                                  + damping * observed)
            element = ev.hop.window_link or tier_name
            diagnosis[key] = f"fault-degraded({element})"
    resolved = []
    for ev in evidence:
        tier_name = _attributed_tier(ev, evidence, plan, culprits,
                                     intake_ratio is not None)
        if tier_name is not None:
            resolved.append((ev, tier_name))
    # one application per tier: corroborated shared-tier evidence arrives
    # once per branch, but each branch only saw its own traffic share —
    # the tier's effective rate is the SUM over corroborating branches,
    # applied once (N damped per-share updates would collapse a healthy
    # shared tier's estimate to ~1/N of reality)
    grouped: dict[str, list[_Evidence]] = {}
    order: list[str] = []
    for ev, tier_name in resolved:
        if multipath and tier_name not in ev.branch.private_tiers:
            key = tier_name
        else:
            key = f"{ev.branch.branch_id}\x00{ev.hop.name}\x00{tier_name}"
        if key not in grouped:
            grouped[key] = []
            order.append(key)
        grouped[key].append(ev)

    def _active_rate(e: _Evidence) -> float:
        rep = e.report
        active = rep.active_s if rep.active_s > 0 else rep.elapsed_s
        return rep.bytes / active

    for key in order:
        evs = grouped[key]
        tier_name = key if "\x00" not in key else key.split("\x00")[2]
        # one contribution per distinct report: with untagged reports (a
        # multipath plan driven through a single pipeline) the lookup
        # fallback hands every branch the SAME report, and summing or
        # pooling it once per branch would inflate the estimate N-fold
        uniq = list({id(e.report): e for e in evs}.values())
        samples = [s for e in uniq
                   for s in (e.report.service_up_s if e.up_limited
                             else e.report.service_down_s)]
        pool = max((e.hop.workers for e in evs if e.pipe_shared),
                   default=1)
        regime = diagnose_service(samples, workers=pool)
        diag_keys = [(f"{e.branch.branch_id}/{e.hop.name}" if multipath
                      else e.hop.name) for e in evs]
        if regime == "latency":
            # the pipe is fine; per-item setup cost is what we waited on.
            # median service over the modeled transmit time is the latency
            # estimate, the p10-p90 spread the jitter window.
            s = sorted(samples)
            p10, med, p90 = _percentiles(s)
            transmit = plan.item_bytes / est[tier_name]
            lat_est[tier_name] = ((1.0 - damping) * lat_est[tier_name]
                                  + damping * max(0.0, med - transmit))
            jit_est[tier_name] = ((1.0 - damping) * jit_est[tier_name]
                                  + damping * max(0.0, p90 - p10))
            for k in diag_keys:
                diagnosis[k] = f"latency-bound({tier_name})"
        else:
            # saturated (or undiagnosable): the limiting side's *effective*
            # delivery rate was the observed throughput — summed over the
            # corroborating branches' distinct reports for a shared tier,
            # and over the active window, so a parallel branch's idle
            # tail (waiting for a slower sibling) does not deflate it
            observed = sum(_active_rate(e) for e in uniq)
            est[tier_name] = ((1.0 - damping) * est[tier_name]
                              + damping * observed)
            if regime == "bandwidth":
                for k in diag_keys:
                    diagnosis[k] = f"bandwidth-bound({tier_name})"
            elif any(
                e.pipe_shared
                and (intake_ratio or {}).get(e.branch.branch_id, 0.0)
                >= CULPRIT_SEVERITY
                for e in evs
            ):
                # sample-free culprit verdict: a steal/deal-route culprit
                # that moved fewer than MIN_DIAGNOSIS_SAMPLES items in the
                # revision window still had its estimate pulled down and
                # its weight shifted — describe() must show WHY the branch
                # lost traffic, even before the reservoir fills.  Gated on
                # a SEVERE intake signal: verdicts persist across replans,
                # so a mild phase-noise flag on a healthy fan-out must not
                # permanently taint the plan's diagnosis surface.
                for k in diag_keys:
                    diagnosis[k] = f"culprit-slow({tier_name})"

    # -- fault priors: each hop's retry ledger updates its element's
    # observed transient-fault rate (retries per item — the telemetry
    # prior the next derivation prices retry budgets from).  A hop that
    # went quiet decays its element's prior back toward the cheap
    # default posture instead of holding the deep budget forever.
    fault_priors: dict[str, float] = dict(plan.fault_priors or {})
    by_name = {r.name: r for r in reports}
    for branch in plan.branches:
        for hop in branch.hops:
            rkey = (f"{branch.branch_id}/{hop.name}" if multipath
                    else hop.name)
            rep = by_name.get(rkey)
            if rep is None and multipath:
                rep = by_name.get(hop.name)
            if rep is None or rep.items < MIN_DIAGNOSIS_SAMPLES:
                continue
            element = hop.window_link or hop.up_tier
            f_obs = rep.retries / rep.items
            if f_obs > 0:
                fault_priors[element] = ((1.0 - damping)
                                         * fault_priors.get(element, 0.0)
                                         + damping * f_obs)
            elif element in fault_priors:
                decayed = fault_priors[element] * (1.0 - damping)
                if decayed < 1e-3:
                    del fault_priors[element]
                else:
                    fault_priors[element] = decayed

    new_tiers = [dataclasses.replace(t, bandwidth_bytes_per_s=est[t.name],
                                     latency_s=lat_est[t.name],
                                     jitter_s=jit_est[t.name])
                 for t in plan.basin.tiers]
    # derived links re-derive from the revised tiers, explicit (physical)
    # links survive — replace_tiers encodes that distinction.  Channel
    # verdicts ride along as link-field overrides: a route change revises
    # the PATH an explicit link takes, so rtt/loss revisions apply even
    # to physically provisioned links.
    overrides: dict[str, dict] = {}
    for link_name, v in link_rtt_rev.items():
        overrides.setdefault(link_name, {})["rtt_s"] = v
    for link_name, v in link_loss_rev.items():
        overrides.setdefault(link_name, {})["loss_rate"] = max(0.0, v)
    new_basin = plan.basin.replace_tiers(new_tiers,
                                         link_overrides=overrides or None)
    # a window-bound verdict lifts the host clamp — for the diagnosed
    # branch only, when the clamp is per-branch: the rebuilt plan's
    # windows go back to BDP-with-headroom (and the live-swap path grows
    # the running windows without a drain).  rtt-revised / loss-bound do
    # NOT lift clamps: their windows re-size from the revised link model.
    clamp = plan.max_window_bytes
    if raise_window and clamp is not None:
        if isinstance(clamp, collections.abc.Mapping):
            clamp = {k: v for k, v in clamp.items()
                     if k not in raise_branches} or None
        else:
            clamp = None
    # -- path carry / revision: a forced path stays forced through every
    # re-derivation; an "auto" plan re-prices its candidates against the
    # REVISED basin (rtt/loss overrides, derated estimates — the very
    # evidence that contradicts the executing shape's model) and switches
    # only when a challenger clears PATH_REVISION_MARGIN over the
    # incumbent's re-scored rate — the **path-revised** verdict.
    checksum_on = plan.checksum_index is not None or plan.checksum_at_split
    revised_placement = ("accel" if offload_digest
                         else plan.checksum_placement)
    path_arg = plan.path_policy
    if plan.path_policy == "auto":
        digest_rate = (plan.host_digest_bytes_per_s
                       if revised_placement == "host"
                       else plan.accel_digest_bytes_per_s)
        scores = _score_paths(
            new_basin, plan.item_bytes_dist or ((plan.item_bytes, 1.0),),
            checksum=checksum_on, digest_rate=digest_rate,
            ordered=plan.ordered, max_workers=MAX_WORKERS,
            max_window_bytes=clamp, rate_cap=plan.rate_cap_bytes_per_s,
            compressible=plan.compressible)
        path_arg = _choose_path(scores, incumbent=plan.path,
                                margin=PATH_REVISION_MARGIN)
    revised = plan_transfer(
        new_basin, plan.item_bytes, stages=plan.stages,
        checksum=checksum_on,
        ordered=plan.ordered,
        max_window_bytes=clamp,
        batch_items=plan.batch_policy,
        # a host-compute-bound verdict's remedy: the rebuilt plan carries
        # the digest on the accelerator, so the checksum hop's ceiling
        # lifts from the host hash rate to the Pallas kernel's
        checksum_placement=revised_placement,
        host_digest_bytes_per_s=plan.host_digest_bytes_per_s,
        accel_digest_bytes_per_s=plan.accel_digest_bytes_per_s,
        # the arbiter grant survives re-derivation: a revision must never
        # silently promote a fleet member back to sole-occupant sizing
        rate_cap_bytes_per_s=plan.rate_cap_bytes_per_s,
        path=path_arg,
        item_bytes_dist=plan.item_bytes_dist,
        compressible=plan.compressible,
        fault_priors=fault_priors or None)
    if plan.path_policy == "auto":
        # the re-derivation ran with the resolved choice pinned; the plan
        # stays an "auto" plan so the NEXT revision may re-choose too
        revised.path_policy = "auto"
        if revised.path != plan.path:
            diagnosis["path"] = (
                f"path-revised({plan.path}->{revised.path})")
    if obs_rtt:
        # stamp the raw observed estimate on the re-timed hops (the
        # operator surface: describe() shows rtt-est= next to the damped
        # rtt= the plan now runs under).  Hop lists may be shared between
        # plan.hops and the primary branch — dedupe by list identity.
        hop_lists = {id(revised.hops): revised.hops}
        for b in revised.branches:
            hop_lists.setdefault(id(b.hops), b.hops)
        for lst in hop_lists.values():
            for i, h in enumerate(lst):
                if h.window_link in obs_rtt:
                    lst[i] = dataclasses.replace(
                        h, rtt_estimate_s=obs_rtt[h.window_link])
    revised.diagnosis = diagnosis
    return revised
