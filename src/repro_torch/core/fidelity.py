"""Fidelity gap / roofline engine — the paper's headline metric, quantified.

Paper section 1 defines the *fidelity gap*: the discrepancy between
theoretical link capacity and actual application-level throughput.  For
one training step on a card the same three-way decomposition applies:

    t_compute    = FLOPs            / peak FLOP/s          (the tensor cores)
    t_memory     = HBM bytes        / HBM bandwidth        (the HBM "link")
    t_collective = collective bytes / link bandwidth       (NVLink / ICI)

The dominant term is the bottleneck tier of the on-chip drainage basin;
the ratio of useful model FLOPs to counted FLOPs is the fidelity of the
compute path itself (catching remat/redundancy waste).

The JAX package reads these costs from a compiled XLA module's HLO text.
A PyTorch step has no such text, so :func:`count_step` counts the aten
operations one eager run of the step dispatches into a :class:`StepCost`
(the fields of the JAX package's ``HloCost``): FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, as the HLO
walk counts ``dot``), bytes as every operation's input and output bytes
(no fusion: the unfused count the JAX package's ``t_memory_raw`` reads).
:class:`HardwareSpec`, :class:`RooflineReport`, :func:`roofline` and
:func:`model_flops_dense` are copies of the JAX package's; their default
hardware stays its ``TPU_V5E`` (the parity tests compare the two), and
the port's callers pass :data:`H100_SXM`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# ---------------------------------------------------------------------------
# Hardware model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bandwidth: float = 819e9     # bytes/s per chip
    ici_bandwidth: float = 50e9      # bytes/s per ICI link (~spec)
    hbm_bytes: float = 16 * 1024**3  # capacity per chip


#: the JAX package's default chip (a TPU v5e), kept as the copied
#: functions' default so their results equal the JAX package's
TPU_V5E = HardwareSpec()

#: one NVIDIA H100 SXM5 at its 700 W limit, from NVIDIA's "H100 Tensor Core
#: GPU" data sheet: dense bf16 tensor-core peak 989 TFLOP/s, HBM3 3.35 TB/s,
#: 80 GB; NVLink 900 GB/s over 18 links, 50 GB/s per link (one card never
#: reads it)
H100_SXM = HardwareSpec(name="h100-sxm", peak_flops=989e12,
                        hbm_bandwidth=3.35e12, ici_bandwidth=900e9 / 18,
                        hbm_bytes=80e9)


# ---------------------------------------------------------------------------
# Counting one step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepCost:
    """Per-device cost totals of one counted step (the fields of the JAX
    package's ``HloCost``; on one card the collective fields stay 0)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_link_bytes: float = 0.0
    collective_by_type: dict[str, float] = dataclasses.field(default_factory=dict)
    collective_count: dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_op: dict[str, float] = dataclasses.field(default_factory=dict)
    flashable_bytes: float = 0.0
    flashable_flops: float = 0.0
    bytes_by_op: dict[str, float] = dataclasses.field(default_factory=dict)
    num_partitions: int = 1
    unknown_trip_counts: int = 0
    #: aten operations the step dispatched (views and ``empty`` included)
    ops: int = 0


#: operations that move no data: they alias their input or allocate
#: without writing (views are found by their schema)
_NO_TRAFFIC = {"aten._unsafe_view", "aten.alias", "aten.lift_fresh",
               "aten.empty", "aten.empty_like", "aten.empty_strided",
               "aten.new_empty", "aten.new_empty_strided"}


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Adds each dispatched operation's input and output bytes to a
    :class:`StepCost`, by operation; views and allocations count none."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.ops += 1
        name = str(func.overloadpacket)
        if func.is_view or name in _NO_TRAFFIC:
            return out
        nb = _nbytes((args, kwargs)) + _nbytes(out)
        self.cost.bytes_accessed += nb
        self.cost.bytes_by_op[name] = self.cost.bytes_by_op.get(name, 0) + nb
        return out


def count_step(fn: Callable[..., Any], *args: Any,
               **kwargs: Any) -> tuple[Any, StepCost]:
    """Run ``fn(*args, **kwargs)`` once (forward, backward and update, on
    whatever device its tensors lie) while counting its operations;
    returns ``(result, cost)``.  Backward passes that ``fn`` runs are
    counted with it, recomputed forward layers (remat) included."""
    cost = StepCost()
    flops = FlopCounterMode(display=False)
    with flops, _ByteCounter(cost):
        result = fn(*args, **kwargs)
    cost.flops = float(flops.get_total_flops())
    cost.flops_by_op = {str(op): float(n) for op, n in
                        flops.get_flop_counts().get("Global", {}).items()}
    return result, cost


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RooflineReport:
    """Three-term roofline for one (arch x shape x mesh) cell."""

    label: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float       # spec formula (operand-bytes sum)
    collective_link_bytes_per_device: float  # ring model
    t_compute: float
    t_memory: float                          # flash-adjusted (headline)
    t_collective: float
    t_memory_raw: float = 0.0                # unfused memory term
    flashable_bytes_per_device: float = 0.0
    flash_ideal_bytes_per_device: float = 0.0
    model_flops: Optional[float] = None      # 6*N*D global useful FLOPs
    hw: HardwareSpec = TPU_V5E
    collective_by_type: dict[str, float] = dataclasses.field(default_factory=dict)
    memory_per_device_bytes: Optional[float] = None
    unknown_trip_counts: int = 0
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time under perfect overlap = max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to being compute-bound at peak: 1.0 means
        the compute term dominates (no fidelity gap on the chip's fast
        path)."""
        return self.t_compute / self.step_time_s if self.step_time_s > 0 else 0.0

    @property
    def useful_compute_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs (global) — catches remat/redundant
        work."""
        if self.model_flops is None:
            return None
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total > 0 else None

    @property
    def fidelity_gap(self) -> float:
        """Paper section 1 gap for the step: 1 - achieved/peak on the
        dominant resource (i.e. how much of the provisioned roofline the
        non-dominant resources waste is 0 by definition; the gap is in the
        compute term's distance to the envelope)."""
        return 1.0 - self.roofline_fraction

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("hw")
        d["hw_name"] = self.hw.name
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        d["roofline_fraction"] = self.roofline_fraction
        d["useful_compute_fraction"] = self.useful_compute_fraction
        return d

    def summary(self) -> str:
        mf = (f" useful={self.useful_compute_fraction:.2f}"
              if self.useful_compute_fraction is not None else "")
        return (
            f"{self.label}: compute {self.t_compute*1e3:.2f} ms | "
            f"memory {self.t_memory*1e3:.2f} ms | "
            f"collective {self.t_collective*1e3:.2f} ms | "
            f"dominant={self.dominant} roofline={self.roofline_fraction:.2f}{mf}"
        )


def roofline(
    cost: StepCost,
    *,
    label: str = "",
    n_devices: Optional[int] = None,
    model_flops: Optional[float] = None,
    memory_per_device_bytes: Optional[float] = None,
    flash_ideal_bytes_global: Optional[float] = None,
    hw: HardwareSpec = TPU_V5E,
) -> RooflineReport:
    """Build the three-term roofline from per-device step costs.

    ``collective term`` uses the spec's formula: summed collective operand
    bytes (per device, i.e. global/chips) over per-chip link bandwidth.

    ``flash_ideal_bytes_global``: if given, the memory term substitutes
    the kernel-fusable regions' raw traffic with the fused kernel's ideal
    IO (q/k/v/o only).  The raw term is kept alongside (t_memory_raw).
    """
    n = n_devices or cost.num_partitions
    t_compute = cost.flops / hw.peak_flops
    t_memory_raw = cost.bytes_accessed / hw.hbm_bandwidth
    if flash_ideal_bytes_global is not None:
        ideal_dev = flash_ideal_bytes_global / n
        adj_bytes = max(cost.bytes_accessed - cost.flashable_bytes, 0.0) + ideal_dev
        t_memory = adj_bytes / hw.hbm_bandwidth
        flash_dev = ideal_dev
    else:
        t_memory = t_memory_raw
        flash_dev = 0.0
    t_collective = cost.collective_bytes / hw.ici_bandwidth
    return RooflineReport(
        label=label,
        n_devices=n,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes_accessed,
        collective_bytes_per_device=cost.collective_bytes,
        collective_link_bytes_per_device=cost.collective_link_bytes,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_collective,
        t_memory_raw=t_memory_raw,
        flashable_bytes_per_device=cost.flashable_bytes,
        flash_ideal_bytes_per_device=flash_dev,
        model_flops=model_flops,
        hw=hw,
        collective_by_type=dict(cost.collective_by_type),
        memory_per_device_bytes=memory_per_device_bytes,
        unknown_trip_counts=cost.unknown_trip_counts,
    )


def model_flops_dense(n_params: float, n_tokens: float, *, backward: bool = True) -> float:
    """6*N*D (train) or 2*N*D (inference) useful-FLOPs convention."""
    return (6.0 if backward else 2.0) * n_params * n_tokens
