"""Training-input pipeline: the drainage basin's headwaters, executable.

A copy of the JAX package's ``data/pipeline.py`` (the sources yield the
same batches byte for byte for the same seed), placing batches on the card
with PyTorch: ``_decode`` casts float inputs to bf16 with ``torch``, and
``_place`` copies each batch into pinned host memory of its own and from
there to the device with a non-blocking copy.  The default basin is
:func:`~repro_torch.core.basin.card_input_basin`.

The path is   dataset store -> host burst buffer -> device HBM   and it is
built with exactly the machinery the paper prescribes (DESIGN.md §2):

* the *source* (synthetic PRNG stream or a memory-mapped token file) plays
  the erratic production-storage role — it may stall arbitrarily
  (``jitter_s`` injects that for tests/benchmarks),
* a :class:`~repro_torch.core.burst_buffer.BurstBuffer` per hop decouples source
  jitter from the deterministic device feed; depths come from the basin
  model (``DrainageBasin.prefetch_depth``),
* **bulk** mode iterates a finite dataset (epochs); **streaming** mode is
  an endless stream consumed while "produced" — the two paper workload
  classes,
* the consumer never sees the source: it drains the last buffer, so
  transfer cadence emerges from buffer state (decentralized coordination,
  paper §2.2).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.basin import (DrainageBasin, card_input_basin,
                                    sharded_input_basin)
from repro_torch.core.mover import TransferReport
from repro_torch.core.planner import TransferPlan, plan_transfer, replan
from repro_torch.core.staging import (ParallelBranchPipeline, Stage,
                                      StagePipeline, StageReport,
                                      delta_reports, merge_reports)
from repro_torch.core.telemetry import TelemetryRegistry, get_registry
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    mode: str = "streaming"          # bulk | streaming
    staging_capacity: Optional[int] = None   # None -> from the TransferPlan
    staging_workers: Optional[int] = None    # None -> from the TransferPlan;
    # explicit >1 opts into jitter absorption at the cost of batch order
    host_index: int = 0
    host_count: int = 1
    seed: int = 0
    #: > 0: revise the transfer plan online, every N delivered batches, at
    #: a buffer boundary inside the running stream (0 = only when the
    #: caller invokes replan() between iterations)
    replan_every_items: int = 0


def batch_bytes(pc: PipelineConfig) -> int:
    """The bytes of one host's batch as the pipeline plans it: int32
    tokens and labels."""
    return int(pc.global_batch / max(1, pc.host_count) * pc.seq_len * 4 * 2)


class SyntheticTokenSource:
    """Deterministic PRNG token stream (per-host shard of the global batch).

    ``jitter_s`` emulates erratic production storage for latency/jitter
    experiments (paper Fig. 2 analogue)."""

    def __init__(self, cfg: ModelConfig, pc: PipelineConfig, *,
                 n_batches: Optional[int] = None, jitter_s: float = 0.0,
                 jitter_every: int = 3):
        self.cfg = cfg
        self.pc = pc
        self.n_batches = n_batches
        self.jitter_s = jitter_s
        self.jitter_every = jitter_every
        assert pc.global_batch % pc.host_count == 0
        self.batch_per_host = pc.global_batch // pc.host_count

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.pc.seed + 7919 * self.pc.host_index)
        i = 0
        while self.n_batches is None or i < self.n_batches:
            if self.jitter_s and i % self.jitter_every == 0:
                time.sleep(self.jitter_s)        # erratic source stall
            yield self._make(rng, i)
            i += 1

    def _make(self, rng: np.random.Generator, i: int) -> dict[str, np.ndarray]:
        cfg, pc = self.cfg, self.pc
        B, S = self.batch_per_host, pc.seq_len
        if cfg.family == "encdec":
            tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
            return {"frames": rng.standard_normal((B, S, cfg.d_model)
                                                  ).astype(np.float32),
                    "tokens": tokens,
                    "labels": np.roll(tokens, -1, axis=1)}
        s_text = S - cfg.frontend_len if cfg.frontend else S
        tokens = rng.integers(0, cfg.vocab, (B, s_text), dtype=np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        if cfg.frontend:
            batch["extra_embeds"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        return batch


class FileTokenSource:
    """Memory-mapped flat token file (.bin of uint16/uint32) — the 'data at
    rest' bulk source.  Windows of seq_len+1 give (tokens, labels)."""

    def __init__(self, path: str, cfg: ModelConfig, pc: PipelineConfig,
                 dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.cfg, self.pc = cfg, pc
        self.batch_per_host = pc.global_batch // pc.host_count
        span = pc.seq_len + 1
        self.n_windows = (len(self.data) - 1) // pc.seq_len
        self.n_batches = self.n_windows // (self.batch_per_host * pc.host_count)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        B, S = self.batch_per_host, self.pc.seq_len
        stride = B * self.pc.host_count
        for i in range(self.n_batches):
            rows = []
            for b in range(B):
                w = (i * stride + self.pc.host_index * B + b) * S
                rows.append(np.asarray(self.data[w:w + S + 1], np.int32))
            arr = np.stack(rows)
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class InputPipeline:
    """source -> [decode stage] -> [staging buffer] -> device feed.

    Batches arrive as dicts of tensors on ``device`` (the card unless
    ``"cpu"`` is passed), or, with ``to_device=False``, as the decoded host
    batch (numpy arrays; bf16 inputs as CPU tensors).  With a ``mesh``
    each rank gets its rows of the global batch: block ``i`` of ``n``
    along the batch dim, ``i`` its index over ``batch_axes`` and ``n``
    their size (the JAX package's ``make_batch_sharding``); ranks that
    share those coordinates get the same rows.  Only those rows cross to
    the device.

    Staging depth and concurrency per hop come from a
    :class:`~repro_torch.core.planner.TransferPlan` derived from the basin model
    and the estimated batch size — the planning discipline applied, not
    hand-tuned constants.  Batch order must survive the path (training
    determinism), so the plan is ``ordered`` unless the caller explicitly
    sets ``pc.staging_workers > 1``.  Explicit ``pc.staging_capacity`` /
    ``pc.staging_workers`` remain per-workload overrides.

    Replanning is **online and zero-drain**: with
    ``replan_every_items > 0`` (argument or ``pc.replan_every_items``)
    ONE persistent pipeline serves the whole stream, and every that many
    delivered batches the plan is revised from that window's observed
    stalls and applied to the *running* stages in place (buffer resize,
    worker grow/retire) — no staged batch is dropped, batch order is
    preserved, and the device feed never rides a teardown bubble.  A
    mid-epoch regime shift in the dataset store is answered mid-epoch,
    not at the next epoch.  ``replan()`` remains callable between
    iterations for epoch-cadence revision.

    **Shard fan-in**: pass a *list* of sources and the pipeline plans the
    N-shard -> host merge topology
    (:func:`~repro_torch.core.basin.sharded_input_basin`): one planned pull
    branch per shard, all merging into the shared decode/place path via a
    :class:`~repro_torch.core.staging.ParallelBranchPipeline`.  Per-shard stage
    reports come back tagged ``"shard-k/pull"``, so ``replan()`` revises
    each shard branch independently (one slow shard is attributed, not
    averaged over the fleet).  Batch order is preserved *within* a shard;
    interleaving across shards follows delivery order.  Online segmented
    replanning (``replan_every_items``) applies to the merged decode/place
    tail, with the shard plan revising at the same cadence; the basin (or
    a custom one) must plan exactly one branch per shard source.
    """

    def __init__(self, source: Any, *, basin: Optional[DrainageBasin] = None,
                 pc: Optional[PipelineConfig] = None,
                 mesh=None, batch_axes: tuple[str, ...] = ("data",),
                 device: Optional[torch.device | str] = None,
                 to_device: bool = True,
                 plan: Optional[TransferPlan] = None,
                 telemetry: Optional[TelemetryRegistry] = None,
                 replan_every_items: Optional[int] = None):
        self.sources: Optional[list[Any]] = None
        if isinstance(source, (list, tuple)):
            if len(source) > 1:
                self.sources = list(source)
            else:
                source = source[0]
        self.source = source
        if self.sources is not None:
            self.basin = basin or (plan.basin if plan is not None
                                   else sharded_input_basin(len(self.sources)))
        else:
            self.basin = basin or (plan.basin if plan is not None
                                   else card_input_basin())
        self.pc = pc or getattr(self.sources[0] if self.sources else source,
                                "pc", PipelineConfig(1, 128))
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self.telemetry = telemetry if telemetry is not None else get_registry()
        self.replan_every_items = int(
            replan_every_items if replan_every_items is not None
            else getattr(self.pc, "replan_every_items", 0) or 0)
        self.item_bytes = self._estimate_item_bytes()
        ordered = not (self.pc.staging_workers and self.pc.staging_workers > 1)
        #: fan-in only: the multipath plan for the per-shard pull branches
        self.shard_plan: Optional[TransferPlan] = None
        if self.sources is not None:
            self.shard_plan = plan_transfer(
                self.basin, self.item_bytes, stages=("pull",),
                ordered=ordered, path="auto")
            if len(self.shard_plan.branches) != len(self.sources):
                raise ValueError(
                    f"fan-in basin plans {len(self.shard_plan.branches)} "
                    f"branches but {len(self.sources)} shard sources were "
                    "given; pass a basin with one root->sink path per "
                    "shard (e.g. sharded_input_basin(n_shards))")
            # the shared tail (merge tier onward) runs as one linear
            # decode/place pipeline fed by the merged shard branches.
            # The tail starts at the MERGE tier — the first tier common
            # to all root->sink paths — not at branch 0's second tier: a
            # custom fan-in basin may give each shard a private chain
            # deeper than one tier, and slicing ``tiers[1:]`` would plan
            # the shared tail over another branch's private tiers
            tail_basin = self._fanin_tail_basin()
            self.plan = plan or plan_transfer(
                tail_basin, self.item_bytes, stages=("decode", "stage"),
                ordered=ordered, path="auto")
            self._clamp_tail_promise()
        else:
            self.plan = plan or plan_transfer(
                self.basin, self.item_bytes, stages=("decode", "stage"),
                ordered=ordered, path="auto")
        self._shard_pbp: Optional[ParallelBranchPipeline] = None
        #: per-stage totals already consumed by a shard-plan revision
        #: (see _fresh_shard_reports)
        self._shard_seen: dict[str, StageReport] = {}
        #: tail-stage totals already consumed by a live-swap revision
        #: (see _fresh_tail_reports)
        self._tail_seen: dict[str, StageReport] = {}
        self._pipeline: Optional[StagePipeline] = None
        self._t_start: Optional[float] = None
        self._recorded = False
        # the plan whose staging parameters the running pipeline
        # currently carries; replan() revises self.plan, which
        # _apply_plan_live() then applies to the running stages
        self._active_plan = self.plan
        self._delivered = 0

    def _fanin_tail_basin(self) -> DrainageBasin:
        """The linear sub-basin the merged decode/place tail runs over:
        from the merge tier (the first tier every root->sink path
        shares) to the sink.  Built via ``path_basin`` so explicit tail
        links survive — a provisioned bandwidth or an ``rtt_s`` on a
        merge->sink link must reach the tail plan (it is what makes a
        tail hop windowed).  A merge tier that IS the sink leaves no
        chain to plan; the tail then keeps one upstream tier of path 0
        so the basin still models a pull->deliver hop."""
        paths = self.basin.paths()
        common = set(paths[0])
        for p in paths[1:]:
            common &= set(p)
        if not common:
            raise ValueError(
                "fan-in basin has no tier shared by every shard path; "
                "shard branches must merge before the sink")
        first = paths[0]
        merge_idx = next(i for i, name in enumerate(first)
                         if name in common)
        lo = min(merge_idx, len(first) - 2)     # a basin needs >= 2 tiers
        return self.basin.path_basin(first[lo:])

    def _build_stages(self) -> list[Stage]:
        decode_hop = self.plan.hop_for(0, "decode")
        place_hop = self.plan.hop_for(1, "stage")
        cap0 = self.pc.staging_capacity or decode_hop.capacity
        cap1 = self.pc.staging_capacity or place_hop.capacity
        wrk0 = self.pc.staging_workers or decode_hop.workers
        return [
            Stage("decode", capacity=cap0, workers=wrk0,
                  transform=self._decode),
            # device placement stays single-worker: batches reach the
            # device in order, each copy issued on one thread's stream
            Stage("stage", capacity=cap1, workers=1,
                  transform=self._place),
        ]

    def _estimate_item_bytes(self) -> int:
        return batch_bytes(self.pc)

    def _decode(self, item: dict) -> dict:
        out = {}
        for k, v in item.items():
            if v.dtype == np.float32 and k in ("frames", "extra_embeds"):
                out[k] = torch.from_numpy(v).to(torch.bfloat16)
            else:
                out[k] = v
        return out

    def _place(self, item: dict) -> dict:
        """Each array into pinned host memory of its own, then a
        non-blocking copy to the card.  A pinned block comes from PyTorch's
        caching host allocator, which reuses it only after the copy that
        read it has finished (it records an event on the copy's stream),
        so no batch's buffer is overwritten in flight.  On the CPU the
        arrays become tensors sharing their memory.  On a mesh only the
        rank's rows are placed."""
        if self.mesh is not None:
            item = {k: self._rows(v) for k, v in item.items()}
        if not self.to_device:
            return item
        out = {}
        for k, v in item.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _rows(self, v):
        """This rank's block of the global batch ``v`` (its leading dim)."""
        n = self.mesh.axis_size(self.batch_axes)
        if v.shape[0] % n:
            raise ValueError(f"a global batch of {v.shape[0]} rows does not "
                             f"split over {n} data ranks")
        size = v.shape[0] // n
        i = self.mesh.axis_index(self.batch_axes)
        return v[i * size:(i + 1) * size]

    def __iter__(self) -> Iterator[dict]:
        # fresh stages per iteration so the current plan takes effect
        # (and re-iteration after replan() works); _pipeline resets NOW so
        # telemetry queried before the first batch never sees a previous
        # run's stage reports
        self._active_plan = self.plan
        self._pipeline = None
        self._shard_pbp = None
        self._shard_seen = {}
        self._tail_seen = {}
        self._delivered = 0
        self._t_start = time.monotonic()
        self._recorded = False

        if self.sources is not None:
            return self._run_fanin()

        def run() -> Iterator[dict]:
            yield from self._run_segments(iter(self.source))
            self.record_telemetry()

        return run()

    def _run_segments(self, source_it: Iterator[Any]) -> Iterator[dict]:
        """The zero-drain online-replanning protocol, shared by the
        linear and fan-in paths: ONE persistent pipeline serves the whole
        stream; every ``replan_every_items`` delivered batches is an
        accounting-only checkpoint — the window's stall evidence revises
        the plan, and the revision is applied to the *running* stages in
        place (``Stage.resize``), so no staged batch drains and the
        device feed never rides a rebuild bubble."""
        self._pipeline = StagePipeline(source_it, self._build_stages())
        chunk = self.replan_every_items
        boundary = chunk
        for item in self._pipeline:
            self._delivered += 1
            yield item
            if chunk and self._delivered >= boundary:
                boundary += chunk
                self.replan(_fresh_only=True)
                self._apply_plan_live()

    def _apply_plan_live(self) -> None:
        """Apply the revised plan to the running pipeline — the
        zero-drain swap.  Tail stages re-size against the revised tail
        hops (explicit ``pc`` overrides still win, and device placement
        stays single-worker for ordering); fan-in shard pull stages
        re-size against their revised branch hops."""
        if self._pipeline is not None:
            decode_hop = self.plan.hop_for(0, "decode")
            place_hop = self.plan.hop_for(1, "stage")
            for st in self._pipeline.stages:
                if st.name == "decode":
                    st.resize(
                        capacity=self.pc.staging_capacity
                        or decode_hop.capacity,
                        workers=self.pc.staging_workers or decode_hop.workers)
                elif st.name == "stage":
                    st.resize(capacity=self.pc.staging_capacity
                              or place_hop.capacity, workers=1)
        if self._shard_pbp is not None and self.shard_plan is not None:
            for bid, pipe in self._shard_pbp.branches:
                try:
                    b = self.shard_plan.branch(bid)
                except KeyError:
                    continue
                for i, st in enumerate(pipe.stages):
                    hop = b.hop_for(i, st.name)
                    st.resize(capacity=hop.capacity, workers=hop.workers)
        self._active_plan = self.plan

    def _clamp_tail_promise(self) -> None:
        """Fan-in only: the tail plan alone promises the merge-to-device
        rate, but delivery is bounded by the shard branches' conserved
        aggregate — the fidelity gap must measure against the slower of
        the two or it reads ~1.0 even when every tier performs as
        modeled."""
        if self.shard_plan is not None:
            self.plan.planned_bytes_per_s = min(
                self.plan.planned_bytes_per_s,
                self.shard_plan.planned_bytes_per_s)

    def _run_fanin(self) -> Iterator[dict]:
        """One planned pull branch per shard source, merged into the
        shared decode/place tail — the executable N-shard fan-in.

        Online replanning (``replan_every_items``) applies to the merged
        tail zero-drain: the shard branch pipelines AND the decode/place
        stages run continuously, and each revision window re-sizes both
        in place.  The shard plan revises at the same cadence from the
        windowed ``shard-k/pull`` report deltas."""
        branches = []
        for b, src in zip(self.shard_plan.branches, self.sources):
            hop = b.hops[0]
            branches.append((b.branch_id, StagePipeline(
                iter(src),
                [Stage(hop.name, capacity=hop.capacity,
                       workers=hop.workers)])))
        self._shard_pbp = ParallelBranchPipeline(branches)
        merged = (item for _bid, item in self._shard_pbp)
        yield from self._run_segments(merged)
        self._shard_pbp.join()
        self.record_telemetry()

    def reports(self) -> list[StageReport]:
        """Per-stage reports of the current iteration's (persistent)
        pipeline; in fan-in mode the per-shard pull reports (tagged
        ``shard-k/pull``) ride along."""
        live = self._pipeline.reports() if self._pipeline else []
        shard = self._shard_pbp.reports() if self._shard_pbp else []
        return merge_reports([shard, live])

    def record_telemetry(self) -> Optional[TransferReport]:
        """Record the stream's progress so far (for consumers that stop
        before the source exhausts — e.g. a bounded training run).  At
        most one report per iteration of the pipeline."""
        if not self._pipeline or not self._t_start or self._recorded:
            return None
        self._recorded = True
        report = TransferReport(
            mode=self.pc.mode, items=self._delivered,
            bytes=int(self._delivered * self.item_bytes),
            elapsed_s=time.monotonic() - self._t_start,
            stage_reports=self.reports(),
            planned_bytes_per_s=self._active_plan.planned_bytes_per_s)
        self.telemetry.record("input", report)
        return report

    def replan(self, *, damping: float = 0.5,
               _fresh_only: bool = False) -> TransferPlan:
        """Fold observed stall ratios back into the plan (the paper's
        hypothesis -> change -> measure cycle).  Called automatically at
        segment boundaries when ``replan_every_items`` is set; callable
        manually between iterations.  The revised plan takes effect on
        the next segment (online) or iteration (manual).

        With online replanning active, each checkpoint revision consumes
        its window's report deltas, and a manual call between iterations
        sees only the final (not-yet-consumed) window — consumed
        evidence is never re-applied.  A manual call *mid*-window still
        overlaps the upcoming checkpoint fold; keep manual calls between
        iterations.

        In fan-in mode the per-shard branch plan revises too, from the
        ``shard-k/pull``-tagged reports: a single slow shard gets its own
        verdict and loses traffic share, instead of dragging the whole
        shard fleet's estimate down."""
        if _fresh_only or self.replan_every_items:
            reps = self._fresh_tail_reports()
        else:
            reps = self.reports()
        if reps:
            tail = [r for r in reps if "/" not in r.name]
            if tail:
                self.plan = replan(self.plan, tail, damping=damping)
        if self.shard_plan is not None and self._shard_pbp is not None:
            shard_reps = self._fresh_shard_reports()
            if shard_reps:
                self.shard_plan = replan(self.shard_plan, shard_reps,
                                         damping=damping)
        self._clamp_tail_promise()
        return self.plan

    def _fresh_tail_reports(self) -> list[StageReport]:
        """Tail-stage reports covering only the window since the last
        revision (:func:`repro_torch.core.staging.delta_reports` over the
        persistent pipeline's cumulative counters); reservoirs start
        fresh once consumed, so a long-gone regime's samples never keep
        steering later diagnoses."""
        if not self._pipeline:
            return []
        cur = self._pipeline.reports()
        fresh = delta_reports(cur, list(self._tail_seen.values()))
        self._tail_seen = {r.name: r for r in cur}
        for stage in self._pipeline.stages:
            stage.reset_service_reservoirs()
        return fresh

    def _fresh_shard_reports(self) -> list[StageReport]:
        """Shard-branch reports covering only the window since the last
        revision — same protocol as the tail: re-feeding consumed stall
        seconds through ``replan`` at every boundary would re-apply
        evidence and defeat damping, and a consumed window's reservoir
        samples must not keep polluting later diagnoses."""
        cur = self._shard_pbp.reports()
        fresh = delta_reports(cur, list(self._shard_seen.values()))
        self._shard_seen = {r.name: r for r in cur}
        for _, pipe in self._shard_pbp.branches:
            for stage in pipe.stages:
                stage.reset_service_reservoirs()
        return fresh

    def fidelity_gap(self) -> Optional[float]:
        """Live achieved-vs-planned gap of the staging path (<0 means the
        path is beating the plan's promise)."""
        if not self._pipeline or not self._t_start:
            return None
        elapsed = time.monotonic() - self._t_start
        if elapsed <= 0:
            return None
        achieved = self._delivered * self.item_bytes / elapsed
        return 1.0 - achieved / self._active_plan.planned_bytes_per_s

    def consumer_stall_s(self) -> float:
        """Total time the training step waited on input — the pipeline's
        fidelity-gap contribution (0 when the basin is balanced).  The
        zero-drain pipeline persists for the whole iteration, so its
        output buffer's cumulative stall is the whole story."""
        return (self._pipeline.output.stats.consumer_stall_s
                if self._pipeline else 0.0)
