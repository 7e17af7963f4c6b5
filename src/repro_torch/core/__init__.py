"""Core: the paper's contribution as composable modules (copies of the JAX
package's framework-free modules; the integrity seam runs on the card).

* :mod:`repro_torch.core.basin` — Drainage Basin Pattern (analytic path model)
* :mod:`repro_torch.core.burst_buffer` — low-jitter staging buffer
* :mod:`repro_torch.core.staging` — staging workers / pipelines
* :mod:`repro_torch.core.mover` — unified bulk/streaming data mover
* :mod:`repro_torch.core.planner` — TransferPlan engine: basin -> staging parameters
* :mod:`repro_torch.core.telemetry` — cross-layer TransferReport registry
* :mod:`repro_torch.core.integrity` — host or on-card stream digest
"""

from .basin import (DrainageBasin, Link, Tier, TierKind, checkpoint_basin,
                    decode_fanout_basin, decode_stream_basin, GBPS, MIB, GIB)
from .burst_buffer import BufferClosed, BufferStats, BurstBuffer
from .integrity import StreamDigest
from .mover import MoverConfig, TransferReport, UnifiedDataMover
from .planner import (HopPlan, HopRevision, PlanDelta, TransferPlan,
                      plan_delta, plan_transfer, replan)
from .staging import Stage, StagePipeline, StageReport
from .telemetry import LayerSummary, TelemetryRegistry, get_registry

__all__ = [
    "DrainageBasin", "Link", "Tier", "TierKind", "checkpoint_basin",
    "decode_fanout_basin", "decode_stream_basin", "GBPS", "MIB", "GIB",
    "BufferClosed", "BufferStats", "BurstBuffer", "StreamDigest",
    "MoverConfig", "TransferReport", "UnifiedDataMover",
    "HopPlan", "HopRevision", "PlanDelta", "TransferPlan", "plan_delta",
    "plan_transfer", "replan",
    "Stage", "StagePipeline", "StageReport",
    "LayerSummary", "TelemetryRegistry", "get_registry",
]
