"""Cross-layer transfer telemetry — the fidelity gap as an always-on signal.

The paper's headline observable (§1) is the *fidelity gap*: provisioned
capacity vs. what the application actually achieves.  Every planned
transfer in this framework already computes it per transfer
(:class:`~repro_torch.core.mover.TransferReport`); this module aggregates those
reports **across layers** — input pipeline, checkpoint engine, decode
stream — so one registry answers "where does the whole system leak
bandwidth", which is exactly the weakest-link question of §3.4.

Layers record under a stable name (``"input"``, ``"checkpoint"``,
``"serve"``); the training driver surfaces :meth:`TelemetryRegistry.summary`
in its step logs and the benchmark harness reads the same registry for
planned-vs-fixed comparisons.  A process-global default registry keeps
wiring trivial; tests construct their own.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:          # circular-import guard (mover imports telemetry)
    from .mover import TransferReport


@dataclasses.dataclass
class LayerSummary:
    """Aggregate view of one layer's recorded transfers."""

    layer: str
    transfers: int = 0
    items: int = 0
    bytes: int = 0
    elapsed_s: float = 0.0
    worst_fidelity_gap: Optional[float] = None
    #: fault posture: transient faults retried away inside this layer's
    #: transfers, and the worker-time those backoffs consumed — a layer
    #: can meet its fidelity gate while quietly burning retry budget,
    #: and this is where that cost stays visible
    retries: int = 0
    retry_wait_s: float = 0.0

    @property
    def throughput_bytes_per_s(self) -> float:
        return self.bytes / self.elapsed_s if self.elapsed_s > 0 else 0.0


class TelemetryRegistry:
    """Thread-safe collector of :class:`TransferReport`\\ s by layer.

    Reports fold into per-layer running aggregates at record time (O(1)
    memory per layer — a long-lived server or multi-day training run
    never grows it); only the most recent ``keep_recent`` raw reports
    are retained for inspection."""

    def __init__(self, keep_recent: int = 256) -> None:
        self._lock = threading.Lock()
        self._aggregates: dict[str, LayerSummary] = {}
        self._recent: collections.deque[tuple[str, "TransferReport"]] = \
            collections.deque(maxlen=keep_recent)
        # latest fleet-arbitration snapshot (FleetArbiter.stats()):
        # aggregate granted rate + per-class weighted-fairness view of a
        # multi-tenant basin; None until an arbiter records one
        self._fleet: Optional[dict] = None

    def record_fleet(self, stats: dict) -> None:
        """Record the latest fleet arbitration snapshot (pushed by
        :class:`~repro_torch.core.fleet.FleetArbiter` on every rebalance); it
        rides :meth:`to_json` / :meth:`append_jsonl` so JSONL trends
        cover multi-tenant runs."""
        with self._lock:
            self._fleet = dict(stats)

    def record(self, layer: str, report: "TransferReport") -> None:
        with self._lock:
            self._recent.append((layer, report))
            s = self._aggregates.setdefault(layer, LayerSummary(layer=layer))
            s.transfers += 1
            s.items += report.items
            s.bytes += report.bytes
            s.elapsed_s += report.elapsed_s
            for r in report.stage_reports:
                s.retries += r.retries
                s.retry_wait_s += r.retry_wait_s
            gap = report.fidelity_gap
            if gap is not None:
                if s.worst_fidelity_gap is None or gap > s.worst_fidelity_gap:
                    s.worst_fidelity_gap = gap

    def reports(self, layer: str | None = None) -> list["TransferReport"]:
        """The retained recent raw reports (newest last)."""
        with self._lock:
            return [r for l, r in self._recent
                    if layer is None or l == layer]

    def layers(self) -> list[str]:
        with self._lock:
            return list(self._aggregates)

    def summary(self) -> dict[str, LayerSummary]:
        """Per-layer aggregation of everything recorded so far."""
        with self._lock:
            return {layer: dataclasses.replace(s)
                    for layer, s in self._aggregates.items()}

    def worst_fidelity_gap(self) -> Optional[float]:
        """The system-wide weakest link: max gap over every layer, or
        ``None`` when no planned transfer has been recorded yet."""
        gaps = [s.worst_fidelity_gap for s in self.summary().values()
                if s.worst_fidelity_gap is not None]
        return max(gaps) if gaps else None

    def format_summary(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            gap = ("n/a" if s.worst_fidelity_gap is None
                   else f"{s.worst_fidelity_gap:.3f}")
            faults = (f", {s.retries} retries "
                      f"({s.retry_wait_s:.2f}s backoff)"
                      if s.retries else "")
            lines.append(
                f"{name:>10}: {s.transfers} transfers, {s.items} items, "
                f"{s.throughput_bytes_per_s / 1e6:.1f} MB/s, "
                f"worst gap {gap}{faults}")
        with self._lock:
            fleet = self._fleet
        if fleet is not None:
            lines.append(
                f"{'fleet':>10}: {fleet.get('live', 0)} live, "
                f"{fleet.get('queued', 0)} queued, "
                f"{fleet.get('aggregate_granted_bytes_per_s', 0.0) / 1e6:.1f}"
                f" MB/s granted, "
                f"fairness {fleet.get('fairness_index', 1.0):.3f}")
        return "\n".join(lines) or "(no transfers recorded)"

    # -- serialization (the dashboard surface) --------------------------------

    def to_json(self, *, indent: Optional[int] = None) -> str:
        """Serialize the per-layer aggregates as JSON.

        The payload carries everything a dashboard needs — counters,
        elapsed, worst fidelity gap, and the derived throughput per layer.
        The recent raw-report ring is process-local detail and is not
        serialized; :meth:`from_json` restores the aggregates exactly."""
        with self._lock:
            layers = {
                name: {**dataclasses.asdict(s),
                       "throughput_bytes_per_s": s.throughput_bytes_per_s}
                for name, s in self._aggregates.items()
            }
            fleet = self._fleet
        gaps = [d["worst_fidelity_gap"] for d in layers.values()
                if d["worst_fidelity_gap"] is not None]
        payload = {"version": 1, "layers": layers,
                   "worst_fidelity_gap": max(gaps) if gaps else None}
        if fleet is not None:
            payload["fleet"] = fleet
        return json.dumps(payload, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TelemetryRegistry":
        """Rebuild a registry (aggregates only) from :meth:`to_json` output."""
        data = json.loads(text)
        reg = cls()
        for name, d in data.get("layers", {}).items():
            reg._aggregates[name] = LayerSummary(
                layer=d.get("layer", name),
                transfers=int(d["transfers"]),
                items=int(d["items"]),
                bytes=int(d["bytes"]),
                elapsed_s=float(d["elapsed_s"]),
                worst_fidelity_gap=d.get("worst_fidelity_gap"),
                retries=int(d.get("retries", 0)),
                retry_wait_s=float(d.get("retry_wait_s", 0.0)))
        reg._fleet = data.get("fleet")
        return reg

    def dump_json(self, path: str, *, indent: Optional[int] = 2) -> None:
        """Atomically write :meth:`to_json` to ``path`` (tmp + rename), so
        a dashboard polling the file never reads a half-written dump."""
        payload = self.to_json(indent=indent)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)

    def append_jsonl(self, path: str, *,
                     timestamp: Optional[float] = None) -> None:
        """Append one snapshot line to a JSONL time series.

        Where :meth:`dump_json` overwrites a point-in-time file, this
        keeps the history: one compact JSON object per flush, stamped
        with wall time, so a dashboard (or
        ``examples/telemetry_timeseries.py``) can plot per-layer rate
        trends over a run.  Aggregates are cumulative-from-start; the
        consumer differences adjacent lines for interval rates."""
        snapshot = json.loads(self.to_json())
        snapshot["ts"] = time.time() if timestamp is None else timestamp
        with open(path, "a") as f:
            f.write(json.dumps(snapshot, sort_keys=True) + "\n")

    def clear(self) -> None:
        with self._lock:
            self._aggregates.clear()
            self._recent.clear()
            self._fleet = None


_global = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    """The process-global registry the production layers record into."""
    return _global
