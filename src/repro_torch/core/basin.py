"""Drainage Basin Pattern — the paper's conceptual model, made executable.

The paper (Fig. 1) models the full data-movement spectrum as a drainage
basin: *headwaters* (edge sources, 1-10 Gbps, erratic), *tributaries*
(aggregation points), and the *main channel* (core, >= 100 Gbps,
deterministic).  Matching the appliance tier (Mini / Mini+ / Core) to the
basin position - network position x burst-buffer capacity x compute - is
the paper's planning discipline.

This module is the executable form of that model.  A :class:`DrainageBasin`
is a **DAG** of :class:`Tier` nodes joined by :class:`Link` edges.  Real
deployments are rarely one straight channel: datasets fan out N shards ->
M hosts (multiple roots merging at a staging tier), checkpoints mirror to
two storage tiers (one source splitting to two sinks), and decode streams
fan out to many clients.  A tier with several outgoing links is a *split*
(fan-out) node; several incoming links make a *merge* (fan-in) node; both
are detected from the link structure rather than declared.

The historical linear constructor is preserved as the degenerate
single-path case: ``DrainageBasin(tiers)`` with no links still means the
ordered chain ``tiers[0] -> tiers[1] -> ...``, and every analysis method
behaves exactly as it always has on such basins (``is_linear`` is true).
A :class:`Link` whose ``bandwidth_bytes_per_s`` is ``None`` is *derived*:
its capacity is taken from its endpoint tiers and re-derived whenever the
tier estimates are revised (``replace_tiers``), which is how the adaptive
replanner avoids clamping an upward revision at a stale link rate.

From the model we derive, analytically:

* the end-to-end *achievable throughput* (min over a linear path - the
  paper's "a chain is only as strong as its weakest link", section 3.4 -
  or, on a DAG, the sum of per-branch rates under shared-tier rate
  conservation: branch rates through a shared tier must sum to no more
  than its effective rate, see :meth:`DrainageBasin.branch_rates`),
* the *fidelity gap* of any link (section 1: theoretical capacity vs.
  application throughput),
* burst-buffer sizing via Little's law (buffer >= bandwidth x jitter
  window - section 2.1's "low-jitter interface"),
* the appliance tier recommendation (Fig. 3).

Inside a TPU installation the same pattern recurs (DESIGN.md section 2):
dataset store -> host RAM staging -> HBM -> ICI/DCN.  The training data
pipeline, the checkpoint engine and the co-design planner all size their
buffers and schedules from this model.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, Optional, Sequence

# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

GBPS = 1e9 / 8.0        # bytes/s per Gbit/s
MIB = 1024 ** 2
GIB = 1024 ** 3
TIB = 1024 ** 4


class TierKind(enum.Enum):
    """Role of a node in the basin."""

    SOURCE = "source"            # production storage / instrument / dataset store
    BURST_BUFFER = "burst_buffer"  # staging layer (NVMe in the paper; host RAM here)
    CHANNEL = "channel"          # a network hop (WAN in the paper; ICI/DCN/PCIe here)
    SINK = "sink"                # destination storage / device HBM


class ApplianceTier(enum.Enum):
    """Fig. 3 appliance spectrum."""

    MINI = "mini"          # edge, 1-10 Gbps
    MINI_PLUS = "mini+"    # aggregation, 10-100 Gbps
    CORE = "core"          # core, >= 100 Gbps


@dataclasses.dataclass(frozen=True)
class Tier:
    """One node in the drainage basin.

    ``bandwidth_bytes_per_s`` is the *sustained* rate the tier can absorb or
    emit.  ``jitter_s`` is the width of the stochastic service-time window
    (the paper's "erratic production storage"); deterministic tiers have
    ~zero jitter.  ``latency_s`` is per-operation setup latency.
    """

    name: str
    kind: TierKind
    bandwidth_bytes_per_s: float
    latency_s: float = 0.0
    jitter_s: float = 0.0
    capacity_bytes: float = math.inf

    def __post_init__(self) -> None:
        if self.bandwidth_bytes_per_s <= 0:
            raise ValueError(f"tier {self.name!r}: bandwidth must be > 0")
        if self.latency_s < 0 or self.jitter_s < 0:
            raise ValueError(f"tier {self.name!r}: latency/jitter must be >= 0")

    def effective_bandwidth(self, item_bytes: float) -> float:
        """Bandwidth observed when moving items of ``item_bytes``.

        Per-item latency amortizes over the item size - this is the paper's
        small-file penalty (section 3.4: "per-file overheads ... disrupt
        effective pipelining").
        """
        if item_bytes <= 0:
            raise ValueError("item_bytes must be > 0")
        t = item_bytes / self.bandwidth_bytes_per_s + self.latency_s
        return item_bytes / t


@dataclasses.dataclass(frozen=True)
class Link:
    """Directed edge between two tiers (a hop on the data path).

    ``bandwidth_bytes_per_s=None`` marks a *derived* link: its capacity is
    the min of its endpoint tiers, resolved by the basin at construction
    and re-resolved whenever tier estimates are revised
    (:meth:`DrainageBasin.replace_tiers`).  Give a concrete bandwidth only
    for physically provisioned links (a WAN circuit, a PCIe lane count).
    """

    src: str
    dst: str
    bandwidth_bytes_per_s: float | None = None
    rtt_s: float = 0.0
    #: expected retransmit fraction (retransmits / items) on this hop —
    #: §3.2's deterministic loss.  A lossy link needs a window deepened
    #: by (1 + loss_rate) to keep the pipe full while retransmit RTTs
    #: are being paid, and its honest promise drops accordingly when a
    #: clamp keeps the window shallow.
    loss_rate: float = 0.0

    def bdp_bytes(self) -> float:
        """Bandwidth-delay product (section 3.1) - the in-flight window
        required to keep the link full."""
        return (self.bandwidth_bytes_per_s or 0.0) * self.rtt_s


@dataclasses.dataclass
class BottleneckReport:
    """Where the basin chokes and by how much."""

    element: str                 # tier or link name
    kind: str                    # "tier" | "link"
    bandwidth_bytes_per_s: float
    achievable_bytes_per_s: float
    theoretical_bytes_per_s: float  # fastest element on the path

    @property
    def fidelity_gap(self) -> float:
        """Paper section 1: 1 - achieved / theoretical-capacity.  0 = perfect."""
        if self.theoretical_bytes_per_s <= 0:
            return 0.0
        return 1.0 - self.achievable_bytes_per_s / self.theoretical_bytes_per_s


#: combinatorial guard: a basin with more root->sink paths than this is a
#: modeling error, not a plannable topology
MAX_PATHS = 64


class DrainageBasin:
    """A DAG data path: SOURCE(s) -> [BURST_BUFFER|CHANNEL]* -> SINK(s).

    ``DrainageBasin(tiers)`` (no links) is the degenerate linear case: the
    ordered chain the model started life as, with every method behaving
    exactly as before the DAG refactor.  With explicit ``links`` the graph
    may branch: multiple roots merging (N dataset shards -> one host),
    one source splitting to multiple sinks (a mirrored checkpoint, a
    decode fan-out).  Split/merge nodes are detected from link degrees
    (:meth:`split_tiers` / :meth:`merge_tiers`); root->sink paths are
    enumerated by :meth:`paths` and each is addressable as a linear
    sub-basin via :meth:`path_basin`.
    """

    def __init__(self, tiers: Sequence[Tier], links: Sequence[Link] | None = None):
        if len(tiers) < 2:
            raise ValueError("a basin needs at least a source and a sink")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.tiers = list(tiers)
        self._by_name = {t.name: t for t in tiers}
        # implicit links derive from tier bandwidths, so a rebuild with
        # revised tiers must re-derive them (planner.replan relies on this)
        self.explicit_links = links is not None
        if links is None:
            links = [Link(a.name, b.name) for a, b in zip(tiers, tiers[1:])]
        # a None bandwidth is a *derived* link (min of its endpoints);
        # remember which so replace_tiers() can re-derive after revision
        self._derived_links = {(l.src, l.dst) for l in links
                               if l.bandwidth_bytes_per_s is None}
        resolved = []
        for l in links:
            if l.src not in self._by_name or l.dst not in self._by_name:
                raise ValueError(f"link {l.src}->{l.dst} references unknown tier")
            if l.bandwidth_bytes_per_s is None:
                l = dataclasses.replace(
                    l, bandwidth_bytes_per_s=min(
                        self._by_name[l.src].bandwidth_bytes_per_s,
                        self._by_name[l.dst].bandwidth_bytes_per_s))
            resolved.append(l)
        self.links = resolved
        self._out: dict[str, list[str]] = {n: [] for n in names}
        self._in: dict[str, list[str]] = {n: [] for n in names}
        for l in self.links:
            self._out[l.src].append(l.dst)
            self._in[l.dst].append(l.src)
        self._validate_dag()
        self._paths = self._enumerate_paths()

    # -- topology ----------------------------------------------------------

    def _validate_dag(self) -> None:
        indeg = {n: len(self._in[n]) for n in self._by_name}
        ready = [n for n in (t.name for t in self.tiers) if indeg[n] == 0]
        seen = 0
        queue = list(ready)
        while queue:
            n = queue.pop(0)
            seen += 1
            for m in self._out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        if seen != len(self.tiers):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"basin links contain a cycle through {cyclic}")
        for t in self.tiers:
            if not self._in[t.name] and not self._out[t.name]:
                raise ValueError(f"tier {t.name!r} is disconnected")

    def _enumerate_paths(self) -> list[tuple[str, ...]]:
        """Every root->sink tier-name path, in deterministic (tier-order,
        then link-order) traversal order."""
        paths: list[tuple[str, ...]] = []

        def walk(node: str, acc: list[str]) -> None:
            acc.append(node)
            nexts = self._out[node]
            if not nexts:
                paths.append(tuple(acc))
                if len(paths) > MAX_PATHS:
                    raise ValueError(
                        f"basin enumerates more than {MAX_PATHS} root->sink "
                        "paths; simplify the topology")
            for m in nexts:
                walk(m, acc)
            acc.pop()

        for root in self.roots():
            walk(root, [])
        return paths

    def roots(self) -> list[str]:
        """Tier names with no incoming link (the headwaters)."""
        return [t.name for t in self.tiers if not self._in[t.name]]

    def sinks(self) -> list[str]:
        """Tier names with no outgoing link (the basin mouths)."""
        return [t.name for t in self.tiers if not self._out[t.name]]

    def split_tiers(self) -> list[str]:
        """Fan-out nodes: tiers with more than one outgoing link."""
        return [t.name for t in self.tiers if len(self._out[t.name]) > 1]

    def merge_tiers(self) -> list[str]:
        """Fan-in nodes: tiers with more than one incoming link."""
        return [t.name for t in self.tiers if len(self._in[t.name]) > 1]

    @property
    def is_linear(self) -> bool:
        """True when the basin is one root->sink chain covering every tier
        — the degenerate case all pre-DAG call sites construct."""
        return len(self._paths) == 1 and len(self._paths[0]) == len(self.tiers)

    def paths(self) -> list[tuple[str, ...]]:
        """All root->sink tier-name paths (one per branch)."""
        return list(self._paths)

    def tier(self, name: str) -> Tier:
        return self._by_name[name]

    def link(self, src: str, dst: str) -> Link:
        for l in self.links:
            if l.src == src and l.dst == dst:
                return l
        raise KeyError(f"no link {src}->{dst}")

    def path_basin(self, path: Sequence[str]) -> "DrainageBasin":
        """A linear sub-basin over one root->sink path.  Explicit link
        bandwidths/rtts along the path survive; derived links stay derived
        so the sub-basin re-derives them from its (shared) tier objects."""
        tiers = [self._by_name[n] for n in path]
        links = []
        for a, b in zip(path, path[1:]):
            l = self.link(a, b)
            if (a, b) in self._derived_links:
                l = dataclasses.replace(l, bandwidth_bytes_per_s=None)
            links.append(l)
        return DrainageBasin(tiers, links)

    def replace_tiers(self, new_tiers: Sequence[Tier],
                      link_overrides: "dict[str, dict] | None" = None
                      ) -> "DrainageBasin":
        """Rebuild with revised tier estimates, same topology.  Derived
        links re-derive from the new tiers (an upward bandwidth revision
        must not stay clamped at a stale link rate); explicit links are
        physical and survive unchanged.

        ``link_overrides`` maps ``"src->dst"`` to link-field revisions
        (``rtt_s``, ``loss_rate``) learned from observed telemetry — a
        route change revises the *path* the physical link takes, so the
        override applies even to explicit links."""
        if not self.explicit_links and not link_overrides:
            return DrainageBasin(new_tiers)
        links = [dataclasses.replace(l, bandwidth_bytes_per_s=None)
                 if (l.src, l.dst) in self._derived_links else l
                 for l in self.links]
        if link_overrides:
            links = [dataclasses.replace(
                         l, **link_overrides[f"{l.src}->{l.dst}"])
                     if f"{l.src}->{l.dst}" in link_overrides else l
                     for l in links]
        return DrainageBasin(new_tiers, links)

    # -- analysis ----------------------------------------------------------

    def path_elements(self) -> Iterable[tuple[str, str, float]]:
        for t in self.tiers:
            yield (t.name, "tier", t.bandwidth_bytes_per_s)
        for l in self.links:
            yield (f"{l.src}->{l.dst}", "link", l.bandwidth_bytes_per_s)

    def achievable_throughput(self, item_bytes: float | None = None) -> float:
        """Sustained end-to-end rate.

        Linear basin: min over every tier and link (the weakest link).
        Branching basin: the sum of per-branch rates under shared-tier
        rate conservation (:meth:`branch_rates`) — aggregate throughput is
        governed by the slowest *branch allocation*, not the provisioned
        link (arXiv:2308.10312's multi-flow regime).

        With ``item_bytes`` given, tier latencies amortize per item
        (small-item regimes choke on latency, not bandwidth).
        """
        if not self.is_linear:
            return sum(self.branch_rates(item_bytes).values())
        rates = []
        for t in self.tiers:
            rates.append(
                t.effective_bandwidth(item_bytes) if item_bytes else t.bandwidth_bytes_per_s
            )
        rates.extend(l.bandwidth_bytes_per_s for l in self.links)
        return min(rates)

    def branch_rates(self, item_bytes: float | None = None
                     ) -> dict[tuple[str, ...], float]:
        """Per-branch sustainable rate for every root->sink path.

        Each branch starts at its own weakest element, then rates are
        proportionally scaled down wherever branches sharing a tier or
        link would jointly exceed its capacity (rate conservation: branch
        rates through a shared element must sum to <= its effective
        rate).  Deterministic fixed-point iteration; on a linear basin the
        single branch equals :meth:`achievable_throughput`.
        """
        def tier_rate(name: str) -> float:
            t = self._by_name[name]
            return (t.effective_bandwidth(item_bytes) if item_bytes
                    else t.bandwidth_bytes_per_s)

        link_bw = {(l.src, l.dst): l.bandwidth_bytes_per_s for l in self.links}
        rates: dict[tuple[str, ...], float] = {}
        for p in self._paths:
            caps = [tier_rate(n) for n in p]
            caps.extend(link_bw[(a, b)] for a, b in zip(p, p[1:]))
            rates[p] = min(caps)
        # shared elements: (capacity, member paths)
        shared: list[tuple[float, list[tuple[str, ...]]]] = []
        for t in self.tiers:
            members = [p for p in self._paths if t.name in p]
            if len(members) > 1:
                shared.append((tier_rate(t.name), members))
        for (a, b), bw in link_bw.items():
            members = [p for p in self._paths
                       if any(x == a and y == b
                              for x, y in zip(p, p[1:]))]
            if len(members) > 1:
                shared.append((bw, members))
        for _ in range(max(1, 4 * len(self._paths))):
            changed = False
            for cap, members in shared:
                load = sum(rates[p] for p in members)
                if load > cap * (1.0 + 1e-12):
                    scale = cap / load
                    for p in members:
                        rates[p] *= scale
                    changed = True
            if not changed:
                break
        return rates

    def bottleneck(self, item_bytes: float | None = None) -> BottleneckReport:
        best_name, best_kind, best_bw = None, None, math.inf
        theoretical = 0.0
        for t in self.tiers:
            bw = t.effective_bandwidth(item_bytes) if item_bytes else t.bandwidth_bytes_per_s
            theoretical = max(theoretical, t.bandwidth_bytes_per_s)
            if bw < best_bw:
                best_name, best_kind, best_bw = t.name, "tier", bw
        for l in self.links:
            theoretical = max(theoretical, l.bandwidth_bytes_per_s)
            if l.bandwidth_bytes_per_s < best_bw:
                best_name, best_kind, best_bw = f"{l.src}->{l.dst}", "link", l.bandwidth_bytes_per_s
        return BottleneckReport(
            element=best_name,
            kind=best_kind,
            bandwidth_bytes_per_s=best_bw,
            achievable_bytes_per_s=best_bw,
            theoretical_bytes_per_s=theoretical,
        )

    def fidelity_gap(self, achieved_bytes_per_s: float, against: str | None = None) -> float:
        """Measured-vs-provisioned gap for the whole basin or one element."""
        if against is None:
            capacity = max(bw for _, _, bw in self.path_elements())
        else:
            matches = [bw for n, _, bw in self.path_elements() if n == against]
            if not matches:
                raise KeyError(f"no element named {against!r}")
            capacity = matches[0]
        return 1.0 - achieved_bytes_per_s / capacity

    def transfer_time_s(self, total_bytes: float, item_bytes: float | None = None) -> float:
        return total_bytes / self.achievable_throughput(item_bytes)

    # -- planning ----------------------------------------------------------

    def buffer_bytes_required(self, link_name: str | None = None) -> float:
        """Little's-law burst-buffer sizing (section 2.1).

        The staging buffer in front of a channel must hold at least
        ``channel_bandwidth x (source jitter window + channel RTT)`` so the
        deterministic sink never starves while the stochastic source stalls.
        """
        channel_bw = self.achievable_throughput()
        jitter = max((t.jitter_s for t in self.tiers), default=0.0)
        rtt = max((l.rtt_s for l in self.links), default=0.0)
        return channel_bw * (jitter + rtt) * 2.0  # x2: double buffering

    def prefetch_depth(self, item_bytes: float) -> int:
        """Number of in-flight items to keep the channel full (>= 2)."""
        need = self.buffer_bytes_required()
        return max(2, math.ceil(need / max(item_bytes, 1.0)))


def recommend_tier(target_bytes_per_s: float) -> ApplianceTier:
    """Fig. 3: match the appliance tier to the basin position."""
    gbps = target_bytes_per_s / GBPS
    if gbps < 10.0:
        return ApplianceTier.MINI
    if gbps < 100.0:
        return ApplianceTier.MINI_PLUS
    return ApplianceTier.CORE


def daily_volume_bytes(rate_bytes_per_s: float) -> float:
    """Table 5: daily data volume achievable at a sustained rate."""
    return rate_bytes_per_s * 86400.0


# ---------------------------------------------------------------------------
# Pre-built basins
# ---------------------------------------------------------------------------

def paper_basin(link_gbps: float = 100.0, rtt_ms: float = 74.0,
                storage_gbps: float = 40.0, storage_jitter_ms: float = 50.0) -> DrainageBasin:
    """The paper's canonical path: production storage -> burst buffer ->
    WAN -> burst buffer -> production storage (defaults: the Switzerland ->
    California 100 Gbps production link, ~74 ms latency, section 3.3)."""
    bb_bw = 2.0 * link_gbps * GBPS  # NVMe staging provisioned above line rate
    return DrainageBasin(
        tiers=[
            Tier("prod-storage-src", TierKind.SOURCE, storage_gbps * GBPS,
                 latency_s=2e-3, jitter_s=storage_jitter_ms / 1e3),
            Tier("burst-buffer-src", TierKind.BURST_BUFFER, bb_bw, latency_s=50e-6),
            Tier("wan", TierKind.CHANNEL, link_gbps * GBPS, latency_s=rtt_ms / 2e3),
            Tier("burst-buffer-dst", TierKind.BURST_BUFFER, bb_bw, latency_s=50e-6),
            Tier("prod-storage-dst", TierKind.SINK, storage_gbps * GBPS,
                 latency_s=2e-3, jitter_s=storage_jitter_ms / 1e3),
        ],
        links=[
            Link("prod-storage-src", "burst-buffer-src", storage_gbps * GBPS),
            Link("burst-buffer-src", "wan", link_gbps * GBPS, rtt_s=rtt_ms / 1e3),
            Link("wan", "burst-buffer-dst", link_gbps * GBPS, rtt_s=rtt_ms / 1e3),
            Link("burst-buffer-dst", "prod-storage-dst", storage_gbps * GBPS),
        ],
    )


def tpu_input_basin(*, dataset_gbps: float = 8.0, dataset_jitter_ms: float = 20.0,
                    host_staging_gbps: float = 200.0, pcie_gbps: float = 128.0,
                    hbm_gbps: float = 819.0 * 8.0) -> DrainageBasin:
    """The training-input path on one host: dataset store -> host RAM burst
    buffer -> PCIe -> device HBM (DESIGN.md section 2 mapping)."""
    return DrainageBasin(
        tiers=[
            Tier("dataset-store", TierKind.SOURCE, dataset_gbps * GBPS,
                 latency_s=5e-3, jitter_s=dataset_jitter_ms / 1e3),
            Tier("host-burst-buffer", TierKind.BURST_BUFFER, host_staging_gbps * GBPS,
                 latency_s=10e-6),
            Tier("pcie", TierKind.CHANNEL, pcie_gbps * GBPS, latency_s=20e-6),
            Tier("hbm", TierKind.SINK, hbm_gbps * GBPS, latency_s=1e-6),
        ]
    )


def checkpoint_basin(*, host_gbps: float = 200.0, nvme_gbps: float = 16.0,
                     nvme_latency_ms: float = 0.2,
                     nvme_jitter_ms: float = 2.0) -> DrainageBasin:
    """The checkpoint-save path: host RAM snapshot -> serialize/hash
    staging -> NVMe/production storage.  The device->host snapshot happens
    before the staged transfer starts, so the basin begins at host RAM;
    the erratic element is the filesystem (allocation, page-cache
    writeback), modeled as sink jitter."""
    return DrainageBasin(
        tiers=[
            Tier("host-snapshot", TierKind.SOURCE, host_gbps * GBPS,
                 latency_s=10e-6),
            Tier("serialize-staging", TierKind.BURST_BUFFER,
                 host_gbps * GBPS, latency_s=10e-6),
            Tier("nvme", TierKind.SINK, nvme_gbps * GBPS,
                 latency_s=nvme_latency_ms / 1e3,
                 jitter_s=nvme_jitter_ms / 1e3),
        ]
    )


def decode_stream_basin(*, decode_step_ms: float = 2.0,
                        host_gbps: float = 200.0,
                        client_gbps: float = 1.0,
                        client_jitter_ms: float = 5.0) -> DrainageBasin:
    """The serving decode path: accelerator token producer -> host staging
    buffer -> client sink.  The producer's per-step latency is the decode
    step itself; the erratic element is the client (network scheduling,
    slow readers), which the staging buffer must decouple from the
    accelerator so a stalling consumer never idles the chip (§2.1)."""
    return DrainageBasin(
        tiers=[
            Tier("decode-producer", TierKind.SOURCE, host_gbps * GBPS,
                 latency_s=decode_step_ms / 1e3),
            Tier("token-staging", TierKind.BURST_BUFFER, host_gbps * GBPS,
                 latency_s=10e-6),
            Tier("client", TierKind.SINK, client_gbps * GBPS,
                 latency_s=1e-3, jitter_s=client_jitter_ms / 1e3),
        ]
    )


# ---------------------------------------------------------------------------
# Pre-built branching (DAG) basins
# ---------------------------------------------------------------------------

def sharded_input_basin(n_shards: int = 2, *, shard_gbps: float = 4.0,
                        shard_jitter_ms: float = 20.0,
                        host_staging_gbps: float = 200.0,
                        pcie_gbps: float = 128.0,
                        hbm_gbps: float = 819.0 * 8.0) -> DrainageBasin:
    """The fan-in training-input path: N dataset shards -> one host burst
    buffer (merge node) -> PCIe -> device HBM.  Aggregate ingest is the
    sum of shard-branch rates, conserved at the shared host tier."""
    if n_shards < 1:
        raise ValueError("need at least one shard")
    shard_tiers = [
        Tier(f"shard-{i}", TierKind.SOURCE, shard_gbps * GBPS,
             latency_s=5e-3, jitter_s=shard_jitter_ms / 1e3)
        for i in range(n_shards)
    ]
    tail = [
        Tier("host-burst-buffer", TierKind.BURST_BUFFER,
             host_staging_gbps * GBPS, latency_s=10e-6),
        Tier("pcie", TierKind.CHANNEL, pcie_gbps * GBPS, latency_s=20e-6),
        Tier("hbm", TierKind.SINK, hbm_gbps * GBPS, latency_s=1e-6),
    ]
    links = [Link(t.name, "host-burst-buffer") for t in shard_tiers]
    links += [Link("host-burst-buffer", "pcie"), Link("pcie", "hbm")]
    return DrainageBasin(shard_tiers + tail, links)


def mirrored_checkpoint_basin(*, host_gbps: float = 200.0,
                              nvme_gbps: float = 16.0,
                              nvme_latency_ms: float = 0.2,
                              nvme_jitter_ms: float = 2.0,
                              object_gbps: float = 5.0,
                              object_latency_ms: float = 20.0,
                              object_jitter_ms: float = 15.0) -> DrainageBasin:
    """The dual-tier checkpoint-save path: host snapshot -> serialize
    staging (split node) -> {local NVMe, remote object store}.  Every
    shard is replicated down both branches (a mirror, not a split of
    traffic); restore picks whichever branch is modeled/measured faster."""
    staging = Tier("serialize-staging", TierKind.BURST_BUFFER,
                   host_gbps * GBPS, latency_s=10e-6)
    return DrainageBasin(
        tiers=[
            Tier("host-snapshot", TierKind.SOURCE, host_gbps * GBPS,
                 latency_s=10e-6),
            staging,
            Tier("nvme", TierKind.SINK, nvme_gbps * GBPS,
                 latency_s=nvme_latency_ms / 1e3,
                 jitter_s=nvme_jitter_ms / 1e3),
            Tier("object-store", TierKind.SINK, object_gbps * GBPS,
                 latency_s=object_latency_ms / 1e3,
                 jitter_s=object_jitter_ms / 1e3),
        ],
        links=[
            Link("host-snapshot", "serialize-staging"),
            Link("serialize-staging", "nvme"),
            Link("serialize-staging", "object-store"),
        ],
    )


def decode_fanout_basin(n_clients: int = 2, *, decode_step_ms: float = 2.0,
                        host_gbps: float = 200.0,
                        client_gbps: float = 1.0,
                        client_jitter_ms: float = 5.0) -> DrainageBasin:
    """The serving decode fan-out: one accelerator token producer -> host
    staging buffer (split node) -> N concurrent client sinks.  Each client
    receives the full stream (replication); the staging tier decouples the
    slowest client from the accelerator (§2.1), and per-branch plans let
    ``replan`` attribute a stall to the one slow client instead of
    degrading every stream."""
    if n_clients < 1:
        raise ValueError("need at least one client")
    clients = [
        Tier(f"client-{i}", TierKind.SINK, client_gbps * GBPS,
             latency_s=1e-3, jitter_s=client_jitter_ms / 1e3)
        for i in range(n_clients)
    ]
    tiers = [
        Tier("decode-producer", TierKind.SOURCE, host_gbps * GBPS,
             latency_s=decode_step_ms / 1e3),
        Tier("token-staging", TierKind.BURST_BUFFER, host_gbps * GBPS,
             latency_s=10e-6),
    ] + clients
    links = [Link("decode-producer", "token-staging")]
    links += [Link("token-staging", c.name) for c in clients]
    return DrainageBasin(tiers, links)


# ---------------------------------------------------------------------------
# The card's HBM to host memory (the port's own staging path)
# ---------------------------------------------------------------------------

#: one H100 SXM5's HBM3, 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet)
H100_HBM_GBPS = 3.35e12 * 8 / 1e9
#: PCIe Gen5 x16, one direction: 32 GT/s on each of 16 lanes with 128b/130b
#: coding, 63.0 GB/s (PCI Express Base Specification, Revision 5.0)
PCIE5_X16_GBPS = 32.0 * 16 * 128 / 130
#: eight channels of DDR5-4800 on one host socket, 8 bytes per transfer:
#: 307.2 GB/s (JEDEC JESD79-5, DDR5 SDRAM)
HOST_DDR5_GBPS = 4800e6 * 8 * 8 * 8 / 1e9


def card_host_basin(*, pageable_gbps: Optional[float] = None
                    ) -> DrainageBasin:
    """The H100's staging path to the host: device HBM -> PCIe Gen5 x16 ->
    host memory.  Into pinned memory the copy engine writes host DRAM
    directly, so the sink is the DRAM.  Into pageable memory the driver
    copies through a pinned bounce buffer and the CPU copies on (CUDA C++
    Best Practices Guide, "Pinned Memory"), a rate no data sheet gives:
    pass the rate measured on the host as ``pageable_gbps`` and the sink is
    that copy.  The tiers' latencies are those the copied basins give the
    same kinds of tier (``hbm`` and ``pcie`` as in :func:`tpu_input_basin`,
    host memory as in :func:`checkpoint_basin`)."""
    if pageable_gbps is not None and pageable_gbps <= 0:
        raise ValueError("pageable_gbps must be > 0")
    sink = (Tier("host-pinned", TierKind.SINK, HOST_DDR5_GBPS * GBPS,
                 latency_s=10e-6) if pageable_gbps is None
            else Tier("host-pageable", TierKind.SINK, pageable_gbps * GBPS,
                      latency_s=10e-6))
    return DrainageBasin(
        tiers=[
            Tier("hbm", TierKind.SOURCE, H100_HBM_GBPS * GBPS, latency_s=1e-6),
            Tier("pcie", TierKind.CHANNEL, PCIE5_X16_GBPS * GBPS,
                 latency_s=20e-6),
            sink,
        ]
    )
