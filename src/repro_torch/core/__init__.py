"""Core: the paper's contribution as composable modules (copies of the JAX
package's framework-free modules; the integrity seam runs on the card).

* :mod:`repro_torch.core.basin` — Drainage Basin Pattern (analytic path model)
* :mod:`repro_torch.core.burst_buffer` — low-jitter staging buffer
* :mod:`repro_torch.core.staging` — staging workers / pipelines
* :mod:`repro_torch.core.mover` — unified bulk/streaming data mover
* :mod:`repro_torch.core.planner` — TransferPlan engine: basin -> staging parameters
* :mod:`repro_torch.core.fleet` — cross-plan rate arbitration over one shared basin
* :mod:`repro_torch.core.resume` — durable ledger for resumable transfers
* :mod:`repro_torch.core.telemetry` — cross-layer TransferReport registry
* :mod:`repro_torch.core.integrity` — host or on-card stream digest
* :mod:`repro_torch.core.fidelity` — fidelity-gap / roofline engine over a counted step
* :mod:`repro_torch.core.codesign` — co-design plan enumeration + analytic ranking
"""

from .basin import (DrainageBasin, Link, Tier, TierKind, checkpoint_basin,
                    decode_fanout_basin, decode_stream_basin, GBPS, MIB, GIB)
from .burst_buffer import BufferClosed, BufferStats, BurstBuffer
from .codesign import (CodesignPlan, PlanPrediction, WorkloadSpec,
                       enumerate_plans, predict, rank_plans,
                       workload_from_config)
from .fidelity import (H100_SXM, HardwareSpec, RooflineReport, StepCost,
                       TPU_V5E, count_step, model_flops_dense, roofline)
from .fleet import DEFAULT_CLASSES, Admission, FleetArbiter
from .integrity import StreamDigest
from .mover import MoverConfig, TransferReport, UnifiedDataMover
from .planner import (HopPlan, HopRevision, PlanDelta, TransferPlan,
                      plan_delta, plan_transfer, replan)
from .resume import TransferLedger
from .staging import Stage, StagePipeline, StageReport
from .telemetry import LayerSummary, TelemetryRegistry, get_registry

__all__ = [
    "DrainageBasin", "Link", "Tier", "TierKind", "checkpoint_basin",
    "decode_fanout_basin", "decode_stream_basin", "GBPS", "MIB", "GIB",
    "BufferClosed", "BufferStats", "BurstBuffer", "StreamDigest",
    "CodesignPlan", "PlanPrediction", "WorkloadSpec", "enumerate_plans",
    "predict", "rank_plans", "workload_from_config",
    "H100_SXM", "HardwareSpec", "RooflineReport", "StepCost", "TPU_V5E",
    "count_step", "model_flops_dense", "roofline",
    "DEFAULT_CLASSES", "Admission", "FleetArbiter", "TransferLedger",
    "MoverConfig", "TransferReport", "UnifiedDataMover",
    "HopPlan", "HopRevision", "PlanDelta", "TransferPlan", "plan_delta",
    "plan_transfer", "replan",
    "Stage", "StagePipeline", "StageReport",
    "LayerSummary", "TelemetryRegistry", "get_registry",
]
