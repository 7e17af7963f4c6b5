"""Co-design planner — automated napkin math over the whole path.

The paper's engineering loop (sections 2.3, 3.4) is: understand every tier
of the path, predict where it chokes, and pick *one global configuration*
that balances the tiers — instead of per-workload manual tuning.  This
module automates that loop for a training/serving step:

1. enumerate candidate plans (sharding layout x microbatching x remat
   policy x gradient compression x collective schedule),
2. predict each plan's three roofline terms analytically from the model
   config, the mesh, and the hardware spec (napkin math, no compile),
3. rank by predicted step time and return the ranking.

:func:`~repro_torch.core.fidelity.count_step` then *counts* one step's
terms on the card, and the step's measured time closes the loop —
the hypothesis -> change -> measure cycle with the hypothesis generated
mechanically.

A copy of the JAX package's model: its defaults stay that package's
``TPU_V5E`` (the parity tests compare the two), and the port's callers
pass ``hw=H100_SXM``.  The one-card train step does not take a plan: it
takes ``microbatches=`` and the remat policy is the config's.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional, Sequence

from .fidelity import HardwareSpec, TPU_V5E


@dataclasses.dataclass(frozen=True)
class CodesignPlan:
    """One global configuration (the paper's 'single setting')."""

    sharding: str = "fsdp_tp"        # dp | tp | fsdp | fsdp_tp
    microbatches: int = 1            # gradient-accumulation splits
    remat: str = "full"              # none | dots | full
    compress_grads: bool = False     # int8 cross-pod gradient sync
    collective_schedule: str = "flat"  # flat | hierarchical
    seq_parallel: bool = True        # Megatron-SP activation sharding

    def describe(self) -> str:
        return (f"sharding={self.sharding} ubatch={self.microbatches} "
                f"remat={self.remat} compress={self.compress_grads} "
                f"sched={self.collective_schedule} sp={self.seq_parallel}")


@dataclasses.dataclass
class PlanPrediction:
    plan: CodesignPlan
    t_compute: float
    t_memory: float
    t_collective: float
    hbm_bytes_needed: float
    fits: bool

    @property
    def step_time_s(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What one step must move and compute (derived from a ModelConfig)."""

    n_params: float                  # total parameters
    n_active_params: float           # != n_params for MoE
    tokens_per_step: float           # global_batch x seq
    d_model: int
    n_layers: int
    seq_len: int
    global_batch: int
    bytes_per_param: float = 2.0     # bf16 weights


def predict(
    work: WorkloadSpec,
    plan: CodesignPlan,
    *,
    n_chips: int,
    dp: int,
    tp: int,
    pods: int = 1,
    hw: HardwareSpec = TPU_V5E,
) -> PlanPrediction:
    """Analytic three-term prediction for one plan.

    Deliberately first-order — the same fidelity as the paper's
    provisioning arithmetic (Table 5): good enough to rank plans and to
    predict the dominant term, cross-checked later against compiled HLO.
    """
    P, Pa = work.n_params, work.n_active_params
    T = work.tokens_per_step
    remat_factor = {"none": 6.0, "dots": 7.0, "full": 8.0}[plan.remat]

    # --- compute: fwd+bwd matmul flops (remat adds a recompute fwd pass)
    flops_global = remat_factor * Pa * T
    t_compute = flops_global / (n_chips * hw.peak_flops)

    # --- memory: weights traffic (each layer read fwd+bwd(+remat fwd)) +
    # activations written fwd / read bwd
    passes = 3.0 if plan.remat != "none" else 2.0
    act_bytes = 2.0 * T * work.d_model * work.n_layers * 2.0 / n_chips  # write+read
    if plan.remat == "full":
        act_bytes *= 0.25  # only layer-boundary activations persist
    resident_act = T * work.d_model * 2.0 * work.n_layers / (dp * pods)
    if plan.seq_parallel:
        resident_act /= tp
    weight_traffic = passes * P * work.bytes_per_param / min(n_chips, dp * tp)
    t_memory = (act_bytes + weight_traffic * plan.microbatches) / hw.hbm_bandwidth

    # --- collective: grad sync over dp (+pods), fsdp all-gathers over dp
    grad_bytes = P * (1.0 if plan.compress_grads else work.bytes_per_param)
    coll = 0.0
    if dp > 1 or pods > 1:
        g = dp * pods
        sync = 2.0 * grad_bytes / tp * (g - 1) / g  # ring all-reduce per chip
        if plan.collective_schedule == "hierarchical" and pods > 1:
            # reduce-scatter intra-pod + small cross-pod exchange + gather
            sync = grad_bytes / tp * ((dp - 1) / dp + 2.0 * (pods - 1) / pods / dp
                                      + (dp - 1) / dp)
        coll += sync
    if plan.sharding in ("fsdp", "fsdp_tp") and dp > 1:
        # params all-gathered across dp each pass (fwd, bwd, remat-fwd)
        coll += passes * (P * work.bytes_per_param / tp) * (dp - 1) / dp \
            * plan.microbatches
    if plan.sharding in ("tp", "fsdp_tp") and tp > 1:
        # activation all-reduces: 2 per layer fwd (+2 bwd) of B x S x D
        per_layer = work.seq_len * work.global_batch * work.d_model * 2.0 / (dp * pods)
        coll += 2.0 * passes * work.n_layers * per_layer * (tp - 1) / tp
    t_collective = coll / hw.ici_bandwidth

    # --- does it fit?  params(+grads+adam m,v master fp32) + activations
    opt_bytes = P * (2.0 + 4.0 + 4.0 + 4.0)  # bf16 w + fp32 master/m/v
    shard = {"dp": 1.0, "tp": tp, "fsdp": dp, "fsdp_tp": dp * tp}[plan.sharding]
    resident = opt_bytes / shard + resident_act / max(plan.microbatches, 1)
    fits = resident <= hw.hbm_bytes * 0.9

    return PlanPrediction(
        plan=plan, t_compute=t_compute, t_memory=t_memory,
        t_collective=t_collective, hbm_bytes_needed=resident, fits=fits,
    )


def enumerate_plans(
    *,
    microbatch_options: Sequence[int] = (1, 2, 4, 8),
    shardings: Sequence[str] = ("dp", "fsdp", "fsdp_tp", "tp"),
    remats: Sequence[str] = ("none", "dots", "full"),
    multi_pod: bool = False,
) -> list[CodesignPlan]:
    plans = []
    for s, m, r in itertools.product(shardings, microbatch_options, remats):
        plans.append(CodesignPlan(sharding=s, microbatches=m, remat=r))
        if multi_pod:
            plans.append(CodesignPlan(sharding=s, microbatches=m, remat=r,
                                      compress_grads=True,
                                      collective_schedule="hierarchical"))
    return plans


def rank_plans(
    work: WorkloadSpec,
    *,
    n_chips: int,
    dp: int,
    tp: int,
    pods: int = 1,
    hw: HardwareSpec = TPU_V5E,
    plans: Optional[Sequence[CodesignPlan]] = None,
) -> list[PlanPrediction]:
    """Rank candidate plans by predicted step time; non-fitting plans last.

    The head of the list is the 'global tuning' default (paper section 2.3);
    callers may override per task — the paper's hierarchical tuning."""
    plans = list(plans) if plans is not None else enumerate_plans(multi_pod=pods > 1)
    preds = [predict(work, p, n_chips=n_chips, dp=dp, tp=tp, pods=pods, hw=hw)
             for p in plans]
    preds.sort(key=lambda pr: (not pr.fits, pr.step_time_s))
    return preds


def workload_from_config(cfg: Any, global_batch: int, seq_len: int) -> WorkloadSpec:
    """Build a WorkloadSpec from a repro ModelConfig (duck-typed)."""
    n_params = float(cfg.param_count())
    n_active = float(getattr(cfg, "active_param_count", cfg.param_count)())
    return WorkloadSpec(
        n_params=n_params,
        n_active_params=n_active,
        tokens_per_step=float(global_batch) * seq_len,
        d_model=cfg.d_model,
        n_layers=cfg.n_layers,
        seq_len=seq_len,
        global_batch=global_batch,
    )
