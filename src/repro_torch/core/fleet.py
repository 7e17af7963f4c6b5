"""Fleet-scale basin arbitration — N concurrent transfers, one basin.

The paper's Drainage Basin Pattern says sustainable throughput is a
property of the *shared* end-to-end system, not of any one flow — yet
:func:`~repro_torch.core.planner.plan_transfer` prices every transfer as if it
owned the basin.  K concurrent transfers (checkpoint saves, input
shards, decode streams) each promised the line rate collectively
over-promise the same host/NIC/storage tiers, and all K miss their
fidelity gates — not because anything degraded, but because the model
could not even *express* two transfers sharing a tier.

:class:`FleetArbiter` is the registry that can.  It owns one
:class:`~repro_torch.core.basin.DrainageBasin` and allocates tier rates across
all live transfers under cross-*plan* rate conservation — the same
fixed-point discipline :meth:`~repro_torch.core.basin.DrainageBasin.branch_rates`
applies across the branches of ONE plan, lifted across plans:

* **weighted QoS classes** — each member belongs to a class with a
  weight; on every oversubscribed tier/link the residual (above the
  admitted floors) is water-filled proportionally to weight, capped at
  each member's own path capability.
* **admission control** — a transfer whose ``min_bytes_per_s`` ask
  cannot fit the current fleet is queued (promoted highest-weight-first
  as peers release) or rejected outright; the live fleet's grants are
  never disturbed by a failed admission.
* **load shedding** — when even the admitted floors oversubscribe an
  element (a tier lost bandwidth under the fleet's feet), floors are
  honored in descending class weight: the lowest class's floor is cut
  first and the member is marked *shed*.
* **live rebalancing** — every membership change re-derives each live
  member's :class:`~repro_torch.core.planner.TransferPlan` under its new
  grant (``rate_cap_bytes_per_s``) and pushes the
  :func:`~repro_torch.core.planner.plan_delta` to the running transfer through
  its bound applier.  The zero-drain ``Stage.resize``/window-revision
  path makes each rebalance free of teardown bubbles: windows
  and pools re-size in place, mid-stream.

The enforcement mechanism is the window: a capped plan's windowed hops
carry ``grant x RTT`` of credit instead of the link's full BDP, so K
members on one work-conserving channel each self-pace to exactly their
grant — conservation holds on the wire, not just in the ledger.  A
basin with no windowed link (``card_host_basin``: HBM, PCIe, host memory)
has nothing to carry the grant, so its members are not paced to it.

A copy of the JAX package's arbiter (framework-free), over the port's
basin and planner, publishing to the port's telemetry.  Usage::

    arb = FleetArbiter(basin, telemetry=registry)
    adm = arb.admit("ckpt", item_bytes, qos="interactive",
                    stages=("move",))
    if adm.status == "admitted":
        mover.bulk_transfer(src, sink, fleet=adm)   # auto-releases

"HTCondor data movement at 100 Gbps" (PAPERS.md) is the production
shape: aggregate line rate assembled from many coordinated streams,
none of which owns the link.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping, Optional, Sequence

from .basin import DrainageBasin
from .planner import TransferPlan, plan_delta, plan_transfer

#: default QoS classes (name -> weight).  Residual bandwidth on every
#: oversubscribed element is shared proportionally to weight; floors are
#: honored — and shed — in descending weight order.
DEFAULT_CLASSES: Mapping[str, float] = {
    "interactive": 8.0,
    "priority": 4.0,
    "bulk": 2.0,
    "scavenger": 1.0,
}

#: relative tolerance for rate comparisons (grants, floors, conservation)
_REL_TOL = 1e-9

#: bandwidth a dead basin element is derated to (bytes/s): effectively
#: zero, but nonzero so every rate fixed point stays finite — members
#: crossing the corpse re-price to ~nothing and survivors absorb the
#: share on the next allocation instead of waiting on a hung grant
DEAD_ELEMENT_BYTES_PER_S = 1.0

#: observed throughput across a derated element above which a
#: post-derate probe reads as recovery (bytes/s) — far enough above the
#: 1 B/s obituary that retry trickle can never fake a resurrection
RECOVERY_PROBE_BYTES_PER_S = 1e3


@dataclasses.dataclass
class _Member:
    """One live (or queued) transfer's arbitration state."""

    name: str
    qos: str
    weight: float
    seq: int                            # admission order (FIFO tiebreak)
    item_bytes: float
    min_bytes_per_s: float
    path: Optional[tuple]               # pinned root->sink path, or None
    plan_kwargs: dict
    sub: DrainageBasin                  # the basin the member's plan sees
    crosses_tiers: frozenset[str]
    crosses_links: frozenset[tuple[str, str]]
    demand: float                       # the path's own raw capability
    granted: float = 0.0
    shed: bool = False
    plan: Optional[TransferPlan] = None
    on_revision: Optional[Callable[[TransferPlan, object], None]] = None
    apply_fn: Optional[Callable[[TransferPlan, object], None]] = None
    #: step function of the grant over time: [(t, bytes/s), ...] — the
    #: basis of the time-averaged promise a finished transfer is judged
    #: against (the grant moved mid-stream; the fidelity gate must too)
    grant_log: list = dataclasses.field(default_factory=list)


class Admission:
    """Handle returned by :meth:`FleetArbiter.admit`.

    ``status`` is ``"admitted"`` (a plan is live under a grant),
    ``"queued"`` (the min-rate ask does not fit yet; the handle mutates
    to ``"admitted"`` when a release makes room), or ``"rejected"``
    (``queue=False``, or the ask exceeds the path's own capability).
    The mover accepts the handle via ``fleet=`` — it binds a zero-drain
    applier for mid-stream rebalances and releases the grant on
    completion."""

    def __init__(self, arbiter: "FleetArbiter", member: _Member,
                 status: str, reason: str = "") -> None:
        self._arbiter = arbiter
        self._member = member
        self.status = status
        self.reason = reason

    @property
    def name(self) -> str:
        return self._member.name

    @property
    def qos(self) -> str:
        return self._member.qos

    @property
    def plan(self) -> Optional[TransferPlan]:
        """The member's current plan under its grant (None until admitted)."""
        return self._member.plan

    @property
    def granted_bytes_per_s(self) -> float:
        return self._member.granted

    @property
    def shed(self) -> bool:
        return self._member.shed

    def bind(self, apply_fn: Callable[[TransferPlan, object], None]) -> None:
        """Register the live applier rebalances are pushed through; it is
        invoked once immediately so a revision that landed between plan
        pickup and bind is never lost."""
        self._arbiter._bind(self._member, apply_fn)

    def unbind(self) -> None:
        self._arbiter._bind(self._member, None)

    def release(self) -> None:
        """Free the grant; survivors absorb the share, the queue promotes."""
        self._arbiter.release(self.name)

    def mean_granted(self, t0: float, t1: float) -> float:
        """Time-averaged grant over ``[t0, t1]`` — the honest promise for
        a transfer whose share moved while it ran."""
        return self._arbiter._mean_granted(self._member, t0, t1)

    def element_died(self, tier_name: str) -> None:
        """Failover hook: the mover reports that a branch of this
        member's transfer died for good on ``tier_name`` (retry budget
        exhausted).  Delegates to :meth:`FleetArbiter.element_died` —
        the tier derates and the whole fleet re-levels, so the member's
        grant re-prices to its surviving branches instead of hanging on
        a promise the corpse can no longer keep."""
        self._arbiter.element_died(tier_name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Admission({self._member.name!r}, {self.status}, "
                f"granted={self._member.granted / 1e6:.1f} MB/s)")


class FleetArbiter:
    """Cross-plan rate conservation over one shared basin.

    ``classes`` maps QoS class name -> weight (default
    :data:`DEFAULT_CLASSES`); ``clock`` stamps the grant history (pass
    the same virtual clock as the mover in tests so time-averaged
    promises are deterministic); ``telemetry`` receives a fleet stats row
    (:meth:`stats`) on every rebalance via
    :meth:`~repro_torch.core.telemetry.TelemetryRegistry.record_fleet`."""

    def __init__(self, basin: DrainageBasin, *,
                 classes: Optional[Mapping[str, float]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry=None) -> None:
        self.basin = basin
        self.classes = dict(DEFAULT_CLASSES if classes is None else classes)
        for qos, w in self.classes.items():
            if w <= 0:
                raise ValueError(f"class {qos!r} weight must be > 0, got {w}")
        self._clock = clock if clock is not None else time.monotonic
        self.telemetry = telemetry
        self._lock = threading.RLock()
        self._members: dict[str, _Member] = {}
        self._queue: list[tuple[_Member, Admission]] = []
        self._seq = 0
        #: pre-derate bandwidth estimates of dead elements, keyed by tier
        #: name — what :meth:`element_recovered` restores
        self._derated: dict[str, float] = {}

    # -- membership --------------------------------------------------------

    def admit(self, name: str, item_bytes: float, *,
              qos: str = "bulk", min_bytes_per_s: float = 0.0,
              queue: bool = True, path: Optional[Sequence[str]] = None,
              on_revision: Optional[Callable] = None,
              **plan_kwargs) -> Admission:
        """Ask the fleet for a share of the basin.

        ``path`` restricts the member to one root->sink tier path of a
        branching basin (default: the whole basin — on a linear basin the
        only path, on a DAG a multipath plan charged conservatively
        against every element it might cross).  ``min_bytes_per_s`` is
        the admission floor: a fleet that cannot grant it queues the ask
        (``queue=True``, promoted highest-weight-first on release) or
        rejects it — the live fleet's grants are untouched either way.
        Remaining keyword arguments (``stages``, ``checksum``,
        ``ordered``, ``batch_items``, ...) pass through to
        :func:`~repro_torch.core.planner.plan_transfer` on every grant.

        ``path`` is overloaded the way the planner reads it: a
        *sequence of tier names* restricts the member's route (above),
        while a plain *string* (``"auto"`` or a forced execution shape)
        is the planner's path policy and passes through to
        ``plan_transfer`` — a granted member planning ``path="auto"``
        re-prices its shape candidates against every re-grant, so the
        stream-vs-stage choice tracks the member's share of the basin,
        not the raw line."""
        if isinstance(path, str):
            # execution-shape policy, not a tier route: the planner's
            # path argument (validated there), re-priced on every grant
            plan_kwargs["path"] = path
            path = None
        if item_bytes <= 0:
            raise ValueError("item_bytes must be > 0")
        if min_bytes_per_s < 0:
            raise ValueError("min_bytes_per_s must be >= 0")
        if qos not in self.classes:
            raise ValueError(
                f"unknown QoS class {qos!r}; have {sorted(self.classes)}")
        with self._lock:
            if name in self._members or any(
                    m.name == name for m, _ in self._queue):
                raise ValueError(f"fleet member {name!r} already exists")
            member = self._make_member(name, item_bytes, qos,
                                       min_bytes_per_s, path, on_revision,
                                       plan_kwargs)
            if min_bytes_per_s > member.demand * (1.0 + _REL_TOL):
                return Admission(
                    self, member, "rejected",
                    reason=(f"min {min_bytes_per_s / 1e6:.1f} MB/s exceeds "
                            f"the path's own capability "
                            f"{member.demand / 1e6:.1f} MB/s"))
            trial = self._allocate(list(self._members.values()) + [member],
                                   no_floor=frozenset((name,)))
            if trial[name] < min_bytes_per_s * (1.0 - _REL_TOL):
                reason = (f"granting min {min_bytes_per_s / 1e6:.1f} MB/s "
                          f"would break conservation (fit: "
                          f"{trial[name] / 1e6:.1f} MB/s)")
                if queue:
                    adm = Admission(self, member, "queued", reason=reason)
                    self._queue.append((member, adm))
                    return adm
                return Admission(self, member, "rejected", reason=reason)
            self._members[name] = member
            adm = Admission(self, member, "admitted")
            self._apply_grants(trial)
            self._publish()
            return adm

    def release(self, name: str) -> None:
        """Remove a member; survivors absorb its share (never losing any
        of their own — allocation is release-monotone) and queued asks
        are promoted in descending class weight."""
        with self._lock:
            member = self._members.pop(name, None)
            if member is None:
                # releasing a queued/rejected ask just withdraws it
                self._queue = [(m, a) for m, a in self._queue
                               if m.name != name]
                return
            member.grant_log.append((self._clock(), 0.0))
            member.granted = 0.0
            self._apply_grants(self._allocate(list(self._members.values())))
            self._promote_queue()
            self._publish()

    def rebalance(self, basin: Optional[DrainageBasin] = None) -> None:
        """Re-run allocation across the live fleet — with ``basin``
        given, against a REVISED basin (same tier topology, new
        capacity/latency estimates: a tier lost bandwidth under the
        fleet's feet, typically surfaced by a member's replan verdict).

        This is where **load shedding** becomes reachable: admission
        control guarantees the admitted floors fit the basin they were
        admitted against, so on a static basin no floor is ever cut —
        but a capacity loss can leave the floors oversubscribed, and
        then the lowest class's floor is the one cut first (the member
        stays live at its reduced share, marked ``shed``)."""
        with self._lock:
            if basin is not None:
                if ({t.name for t in basin.tiers}
                        != {t.name for t in self.basin.tiers}):
                    raise ValueError(
                        "revised basin must keep the tier topology")
                self.basin = basin
                for m in self._members.values():
                    self._rederive(m)
                for m, _adm in self._queue:
                    self._rederive(m)
            self._apply_grants(
                self._allocate(list(self._members.values())),
                force=basin is not None)
            self._promote_queue()
            self._publish()

    def element_died(self, tier_name: str) -> None:
        """A basin element died under the fleet's feet (a live member's
        branch exhausted its retry budget against it).  The tier is
        derated to :data:`DEAD_ELEMENT_BYTES_PER_S` — same topology, so
        every member's sub-basin re-derives cleanly — and the fleet
        re-levels: survivors absorb the share, members whose floor no
        longer fits are shed in class order.  Unknown tiers no-op (the
        corpse may be a branch-private tier outside this basin)."""
        with self._lock:
            if all(t.name != tier_name for t in self.basin.tiers):
                return
            already = {t.name: t.bandwidth_bytes_per_s
                       for t in self.basin.tiers}
            if already[tier_name] <= DEAD_ELEMENT_BYTES_PER_S:
                return          # idempotent: the obituary already landed
            # keep the pre-derate estimate so a returned element can be
            # re-admitted at its known capability, not a guess
            self._derated[tier_name] = already[tier_name]
            tiers = [dataclasses.replace(
                         t, bandwidth_bytes_per_s=DEAD_ELEMENT_BYTES_PER_S)
                     if t.name == tier_name else t
                     for t in self.basin.tiers]
            self.rebalance(basin=self.basin.replace_tiers(tiers))

    def element_recovered(self, tier_name: str,
                          bandwidth_bytes_per_s: Optional[float] = None
                          ) -> None:
        """A derated element returned to service: restore its pre-derate
        bandwidth estimate (or an explicit revised one) and re-level the
        fleet — survivors give back the absorbed share, shed floors
        re-fit, and queued asks are promoted against the recovered
        capacity.  The exact inverse of :meth:`element_died`; no-ops for
        tiers that are not currently derated."""
        with self._lock:
            stored = self._derated.pop(tier_name, None)
            bw = bandwidth_bytes_per_s if bandwidth_bytes_per_s else stored
            if bw is None or bw <= DEAD_ELEMENT_BYTES_PER_S:
                return
            by_name = {t.name: t for t in self.basin.tiers}
            tier = by_name.get(tier_name)
            if tier is None or tier.bandwidth_bytes_per_s > \
                    DEAD_ELEMENT_BYTES_PER_S:
                return          # unknown, or never actually derated
            tiers = [dataclasses.replace(t, bandwidth_bytes_per_s=bw)
                     if t.name == tier_name else t
                     for t in self.basin.tiers]
            self.rebalance(basin=self.basin.replace_tiers(tiers))

    def probe_element(self, tier_name: str,
                      observed_bytes_per_s: float) -> bool:
        """Recovery *detection*: a member that kept (or resumed) pushing
        traffic across a derated tier reports what it actually observed
        through it.  A clean post-derate probe — observed throughput far
        above the 1 B/s obituary — is the evidence the element returned;
        the arbiter re-admits it at the stored pre-derate estimate
        (clamped to the observation when the element came back weaker)
        and re-levels.  Returns True when the probe triggered
        re-admission."""
        with self._lock:
            by_name = {t.name: t for t in self.basin.tiers}
            tier = by_name.get(tier_name)
            if tier is None or tier.bandwidth_bytes_per_s > \
                    DEAD_ELEMENT_BYTES_PER_S:
                return False
            if observed_bytes_per_s <= RECOVERY_PROBE_BYTES_PER_S:
                return False    # still (near-)dead: obituary stands
            stored = self._derated.get(tier_name)
            bw = observed_bytes_per_s if stored is None \
                else min(stored, observed_bytes_per_s)
            self.element_recovered(tier_name, bw)
            return True

    def _make_member(self, name, item_bytes, qos, min_bytes_per_s, path,
                     on_revision, plan_kwargs) -> _Member:
        seq = self._seq
        self._seq += 1
        if path is not None:
            path = tuple(path)
            if path not in self.basin.paths():
                raise ValueError(f"{path!r} is not a root->sink path "
                                 f"of the basin")
        member = _Member(name=name, qos=qos, weight=self.classes[qos],
                         seq=seq, item_bytes=float(item_bytes),
                         min_bytes_per_s=float(min_bytes_per_s),
                         path=path, plan_kwargs=dict(plan_kwargs),
                         sub=self.basin, crosses_tiers=frozenset(),
                         crosses_links=frozenset(), demand=0.0,
                         on_revision=on_revision)
        self._rederive(member)
        return member

    def _rederive(self, m: _Member) -> None:
        """(Re)compute a member's sub-basin, crossing sets and raw
        demand against the arbiter's CURRENT basin."""
        if m.path is not None:
            m.sub = self.basin.path_basin(m.path)
            m.crosses_tiers = frozenset(m.path)
            m.crosses_links = frozenset(zip(m.path, m.path[1:]))
            m.demand = min(
                min(t.bandwidth_bytes_per_s for t in m.sub.tiers),
                min(l.bandwidth_bytes_per_s for l in m.sub.links))
        else:
            m.sub = self.basin
            # a whole-basin member is charged conservatively against
            # every element it may cross — exact per-branch accounting
            # belongs to branch_rates inside its own plan
            m.crosses_tiers = frozenset(t.name for t in self.basin.tiers)
            m.crosses_links = frozenset((l.src, l.dst)
                                        for l in self.basin.links)
            m.demand = self.basin.achievable_throughput()

    # -- allocation --------------------------------------------------------

    def _elements(self, members: Sequence[_Member]
                  ) -> list[tuple[float, list[_Member]]]:
        """(capacity, crossing members) per basin element — the
        conservation constraints, mirroring branch_rates' shared-element
        collection across branches."""
        els: list[tuple[float, list[_Member]]] = []
        for t in self.basin.tiers:
            ms = [m for m in members if t.name in m.crosses_tiers]
            if ms:
                els.append((t.bandwidth_bytes_per_s, ms))
        for l in self.basin.links:
            ms = [m for m in members if (l.src, l.dst) in m.crosses_links]
            if ms:
                els.append((l.bandwidth_bytes_per_s, ms))
        return els

    def _allocate(self, members: Sequence[_Member],
                  no_floor: frozenset[str] = frozenset()
                  ) -> dict[str, float]:
        """Fixed point of per-element weighted water-filling.

        Seed every member at its own demand, then repeatedly re-fill each
        oversubscribed element: admitted floors first (descending class
        weight — shedding order), the residual proportional to weight,
        capped at each member's running rate.  Rates only ever decrease,
        so the iteration converges — and removing a member can only
        weaken constraints, which is what makes release monotone.

        ``no_floor`` names members whose floor is NOT honored — the
        admission trial runs the candidate floorless, so its min-rate ask
        must fit its *fair share* rather than being self-fulfilling
        (a floor only binds once admission has validated it)."""
        rates = {m.name: m.demand for m in members}
        if not members:
            return rates
        floors = {m.name: (0.0 if m.name in no_floor
                           else min(m.min_bytes_per_s, m.demand))
                  for m in members}
        els = self._elements(members)
        for _ in range(max(1, 4 * len(members) * max(1, len(els)))):
            changed = False
            for cap, ms in els:
                load = sum(rates[m.name] for m in ms)
                if load <= cap * (1.0 + 1e-12):
                    continue
                alloc = self._fill(cap, ms, rates, floors)
                for m in ms:
                    if alloc[m.name] < rates[m.name] * (1.0 - _REL_TOL):
                        rates[m.name] = alloc[m.name]
                        changed = True
            if not changed:
                break
        return rates

    @staticmethod
    def _fill(cap: float, ms: Sequence[_Member], rates: Mapping[str, float],
              floors: Mapping[str, float]) -> dict[str, float]:
        """One element's weighted water-fill under floors and rate caps:
        every member gets ``clamp(level * weight, floor, rate)`` at the
        common water level that exactly spends the capacity.

        Floors are *reserved* in descending class weight first, so when
        the floors alone oversubscribe the element the lowest class's
        floor is the one cut (load shedding — detected afterwards as
        granted < min).  A floor below the member's fair share never
        inflates it: the clamp only binds from below when the share
        would dip under the floor."""
        order = sorted(ms, key=lambda m: (-m.weight, m.seq))
        left = cap
        floor_grant: dict[str, float] = {}
        for m in order:
            f = min(floors[m.name], rates[m.name], max(0.0, left))
            floor_grant[m.name] = f
            left -= f
        # water level by iterated pinning: members whose weighted share
        # violates a bound are pinned at it and the level recomputes over
        # the rest — terminates, each pass pins at least one member
        pinned: dict[str, float] = {}
        alloc: dict[str, float] = {}
        while True:
            free = [m for m in order if m.name not in pinned]
            if not free:
                break
            budget = cap - sum(pinned.values())
            total_w = sum(m.weight for m in free)
            level = max(0.0, budget) / total_w
            moved = False
            for m in free:
                share = level * m.weight
                if share < floor_grant[m.name] * (1.0 - _REL_TOL):
                    pinned[m.name] = floor_grant[m.name]
                    moved = True
                elif share > rates[m.name] * (1.0 + _REL_TOL):
                    pinned[m.name] = rates[m.name]
                    moved = True
            if not moved:
                for m in free:
                    alloc[m.name] = level * m.weight
                break
        alloc.update(pinned)
        return alloc

    def _apply_grants(self, rates: Mapping[str, float],
                      force: bool = False) -> None:
        """Re-derive and push every member's plan under its new grant
        (``force``: rebuild even at an unchanged grant — the sub-basin
        the plan prices moved under it)."""
        now = self._clock()
        for m in self._members.values():
            granted = rates.get(m.name, 0.0)
            m.shed = (m.min_bytes_per_s > 0
                      and granted < m.min_bytes_per_s * (1.0 - 1e-6))
            if (not force and m.plan is not None
                    and abs(granted - m.granted)
                    <= _REL_TOL * max(1.0, m.granted)):
                continue
            old = m.plan
            new = plan_transfer(m.sub, m.item_bytes,
                                rate_cap_bytes_per_s=max(granted, 1e-9),
                                **m.plan_kwargs)
            m.plan = new
            m.granted = granted
            m.grant_log.append((now, granted))
            delta = plan_delta(old, new) if old is not None else None
            if old is not None:
                if m.apply_fn is not None:
                    m.apply_fn(new, delta)
                if m.on_revision is not None:
                    m.on_revision(new, delta)

    def _promote_queue(self) -> None:
        """Admit queued asks that now fit, highest class weight first."""
        self._queue.sort(key=lambda ma: (-ma[0].weight, ma[0].seq))
        promoted = True
        while promoted:
            promoted = False
            for i, (m, adm) in enumerate(self._queue):
                trial = self._allocate(
                    list(self._members.values()) + [m],
                    no_floor=frozenset((m.name,)))
                if trial[m.name] >= m.min_bytes_per_s * (1.0 - _REL_TOL):
                    del self._queue[i]
                    self._members[m.name] = m
                    adm.status = "admitted"
                    adm.reason = ""
                    self._apply_grants(trial)
                    promoted = True
                    break

    # -- live binding ------------------------------------------------------

    def _bind(self, member: _Member, apply_fn: Optional[Callable]) -> None:
        with self._lock:
            member.apply_fn = apply_fn
            if apply_fn is not None and member.plan is not None:
                # sync call: a rebalance that landed between the mover's
                # plan pickup and this bind must not be lost — the mover's
                # applier diffs against what it actually built, so a
                # no-op sync is harmless
                apply_fn(member.plan, None)

    def _mean_granted(self, member: _Member, t0: float, t1: float) -> float:
        with self._lock:
            if t1 <= t0:
                return member.granted
            log = member.grant_log
            total = 0.0
            for i, (t, rate) in enumerate(log):
                t_next = log[i + 1][0] if i + 1 < len(log) else max(t1, t)
                a, b = max(t, t0), min(t_next, t1)
                if b > a:
                    total += rate * (b - a)
            return total / (t1 - t0)

    # -- observability -----------------------------------------------------

    def grants(self) -> dict[str, float]:
        """name -> granted bytes/s for every live member."""
        with self._lock:
            return {m.name: m.granted for m in self._members.values()}

    def weighted_fairness(self) -> float:
        """Jain's fairness index over weight-normalized grants
        (``granted / weight``): 1.0 = every class holds exactly its
        weighted share, 1/n = one member holds everything."""
        with self._lock:
            xs = [m.granted / m.weight for m in self._members.values()]
        xs = [x for x in xs if x > 0]
        if not xs:
            return 1.0
        return sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))

    def stats(self) -> dict:
        """The fleet row telemetry records on every rebalance."""
        with self._lock:
            classes: dict[str, dict] = {}
            for m in self._members.values():
                row = classes.setdefault(
                    m.qos, {"weight": m.weight, "members": 0,
                            "granted_bytes_per_s": 0.0})
                row["members"] += 1
                row["granted_bytes_per_s"] += m.granted
            return {
                "live": len(self._members),
                "queued": len(self._queue),
                "shed": sorted(m.name for m in self._members.values()
                               if m.shed),
                "aggregate_granted_bytes_per_s":
                    sum(m.granted for m in self._members.values()),
                "fairness_index": self.weighted_fairness(),
                "classes": classes,
            }

    def describe(self) -> str:
        """Operator surface: one line per member plus the fleet totals —
        the fleet-level analogue of ``TransferPlan.describe()``."""
        with self._lock:
            s = self.stats()
            lines = [f"FleetArbiter({s['live']} live, {s['queued']} queued, "
                     f"aggregate={s['aggregate_granted_bytes_per_s'] / 1e6:.1f}"
                     f" MB/s, fairness={s['fairness_index']:.3f}"]
            for m in sorted(self._members.values(),
                            key=lambda m: (-m.weight, m.seq)):
                shed = "  SHED" if m.shed else ""
                floor = (f" min={m.min_bytes_per_s / 1e6:.1f} MB/s"
                         if m.min_bytes_per_s > 0 else "")
                lines.append(f"  {m.name} [{m.qos} w={m.weight:g}] "
                             f"granted={m.granted / 1e6:.1f} MB/s"
                             f"{floor}{shed}")
            for m, _adm in self._queue:
                lines.append(f"  {m.name} [{m.qos} w={m.weight:g}] QUEUED "
                             f"min={m.min_bytes_per_s / 1e6:.1f} MB/s")
            return "\n".join(lines) + ")"

    def _publish(self) -> None:
        if self.telemetry is not None:
            self.telemetry.record_fleet(self.stats())
