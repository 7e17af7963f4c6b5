"""The trainer: the full co-designed data path, end to end, on one
card or on a mesh.

    dataset -> burst-buffered input pipeline -> train_step
            -> async checksummed checkpoints -> restart recovery

A port of the JAX package's ``launch/train.py``:

* periodic async checkpoints (manifest-atomic, SHA-256 per shard) in the
  JAX package's on-disk format,
* automatic restart discovery (newest complete manifest),
* step-failure recovery: a failing step restores the last checkpoint and
  resumes (``--inject-failure-at`` exercises this),
* elastic restore: on a mesh, a checkpoint restores onto whatever mesh
  the restarted job has, each rank reading its blocks,
* the input basin is :func:`~repro_torch.core.basin.card_input_basin`
  with the host copy rate measured at the start of each run.

The step is the plain PyTorch forward and backward (``impl="ref"``, as the
JAX package trains) and AdamW with an f32 master.  ``Trainer(cfg, mesh)``
trains over a :class:`~repro_torch.launch.mesh.Mesh` under a
``CodesignPlan`` (default FSDP and TP, as the JAX package's trainer):
each rank holds its blocks of the weights and the AdamW state and feeds
its rows of the batch (``launch/steps.py``); rank 0 writes the
checkpoints and every rank restores the step rank 0 chose.

Usage (the card unless ``--device cpu``):
  python -m repro_torch.launch.train --arch smollm-360m --steps 50 \
      --global-batch 8 --seq-len 512 --ckpt-dir /path/to/ckpt
  python -m repro_torch.launch.train --arch repro-100m --smoke \
      --device cpu --steps 12 --global-batch 2 --seq-len 64 \
      --ckpt-dir /path/to/ckpt --ckpt-every 4
On a mesh of 4 ranks (several ranks on one card need gloo; NCCL refuses
them):
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-360m --smoke --mesh 2x2 --backend gloo --steps 4 \
      --global-batch 8 --seq-len 64 --ckpt-dir /path/to/ckpt
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.basin import card_input_basin
from repro_torch.core.codesign import CodesignPlan
from repro_torch.core.telemetry import get_registry
from repro_torch.data.pipeline import (InputPipeline, PipelineConfig,
                                       SyntheticTokenSource, batch_bytes)
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import build
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import NamedSharding, jax_path
from repro_torch.tree import Stacked, map_leaves
from repro_torch.weights import (from_jax_tree, init_sharded, jax_tree,
                                 opt_state_from_tree, opt_state_tree,
                                 param_names)


def host_copy_gbps(nbytes: int, device: torch.device, reps: int = 5
                   ) -> float:
    """The host copy a batch of ``nbytes`` takes into the buffer it
    crosses to ``device`` from (pinned memory for the card, a plain copy
    on the CPU), in Gbit/s: the fastest of ``reps`` timed copies."""
    src = torch.ones(max(1, nbytes), dtype=torch.uint8)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        dst = src.pin_memory() if device.type == "cuda" else src.clone()
        best = min(best, time.perf_counter() - t0)
        del dst
    return src.numel() * 8 / max(best, 1e-9) / 1e9


class Trainer:
    """Owns the step function, state, pipeline, and recovery logic.  With
    a ``mesh`` every rank of it makes one, with the same arguments."""

    def __init__(self, cfg: ModelConfig, mesh=None, *,
                 plan: Optional[CodesignPlan] = None,
                 device: Optional[torch.device | str] = None,
                 microbatches: Optional[int] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 lr: float = 3e-4, total_steps: int = 1000):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.api = build(cfg)
        if mesh is not None and plan is None:
            plan = steps_lib.default_plan(self.api, microbatches or 1)
        self.plan = plan
        # warmup must fit inside the run: the default 100-step warmup never
        # reaches peak lr on short runs (smoke tests, examples)
        warmup = max(1, min(100, total_steps // 5))
        self.train_step, self.ctx = steps_lib.make_train_step(
            self.api, mesh, plan, microbatches=microbatches, lr_peak=lr,
            warmup=warmup, total_steps=total_steps)
        self.ckpt = (CheckpointManager(ckpt_dir, every_steps=ckpt_every,
                                       mesh=mesh)
                     if ckpt_dir else None)
        self.params: Optional[lm_lib.LM] = None
        self.opt_state: Optional[AdamWState] = None
        self.step_idx = 0
        self.metrics_log: list[dict] = []

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        """Weights drawn on the trainer's device from a generator seeded
        with ``seed`` (on a mesh, the rank's blocks of the same draws), and
        a fresh AdamW state."""
        if self.mesh is not None:
            self.params = init_sharded(self.cfg, seed, self.mesh,
                                       device=self.device, plan=self.plan,
                                       trainable=True)
        else:
            self.params = self.api.init(seed, device=self.device,
                                        trainable=True)
        self.opt_state = adamw_init(self.params.parameters())

    def state_tree(self) -> dict:
        """Parameters and AdamW state in the JAX package's checkpoint
        layout: ``{"params": ..., "opt": AdamWState(...)}``, per-layer
        tensors as :class:`~repro_torch.tree.Stacked` leaves (on a mesh,
        the rank's blocks)."""
        names = param_names(self.params)
        return {"params": jax_tree(list(self.params.parameters()), names),
                "opt": opt_state_tree(self.opt_state, names)}

    def state_shardings(self) -> Optional[dict]:
        """On a mesh, :meth:`state_tree`'s shardings: a ``NamedSharding``
        per leaf (a stacked leaf's spec leads with None), the AdamW master
        and moments their parameter's; None on one card."""
        if self.mesh is None:
            return None
        names = param_names(self.params)
        per = jax_tree([NamedSharding(self.mesh, self.ctx.specs[jax_path(n)])
                        for n in names], names)
        tree = map_leaves(lambda v: NamedSharding(
            self.mesh, (None,) + tuple(v[0].spec)) if isinstance(v, Stacked)
            else v, per)
        return {"params": tree,
                "opt": AdamWState(step=NamedSharding(self.mesh, ()),
                                  master=tree, m=tree, v=tree)}

    def try_restore(self) -> bool:
        """Resume from the newest complete checkpoint, onto the trainer's
        device (on a mesh, each rank its blocks: the elastic restore onto
        this mesh, whatever mesh saved it).  A save still in flight
        completes first, so which step the failure path restores does not
        depend on the save thread's timing (the JAX package's trainer
        restores whatever has committed); on a mesh every rank restores
        the step rank 0 chose."""
        if self.ckpt is None:
            return False
        self.ckpt.wait()
        step, state = self.ckpt.restore_latest(
            self.state_tree(), shardings=self.state_shardings())
        if step is None:
            return False
        names = param_names(self.params)
        with torch.no_grad():
            for w, v in zip(self.params.parameters(),
                            from_jax_tree(state["params"], names)):
                w.copy_(v)
        self.opt_state = opt_state_from_tree(state["opt"], names)
        self.step_idx = step
        return True

    # -- loop ----------------------------------------------------------------

    def run(self, source, n_steps: int, *, inject_failure_at: int = -1,
            replan_every: int = 0, telemetry_json: Optional[str] = None,
            telemetry_every: int = 10,
            telemetry_jsonl: Optional[str] = None) -> list[dict]:
        """Train ``n_steps``.  ``replan_every > 0`` folds observed input
        stall ratios and service-time samples back into the transfer plan
        online, every that many batches, at a buffer boundary inside the
        running stream (one batch = one item).  Logged fidelity gaps
        measure against the plan the stream started with.
        ``telemetry_json`` dumps the cross-layer telemetry registry to that
        path every ``telemetry_every`` steps (atomic rename);
        ``telemetry_jsonl`` appends one snapshot line per flush."""
        pc = getattr(source, "pc", None) or PipelineConfig(1, 128)
        basin = card_input_basin(
            host_copy_gbps=host_copy_gbps(batch_bytes(pc), self.device))
        pipeline = InputPipeline(
            source, basin=basin, pc=pc, mesh=self.mesh,
            batch_axes=self.ctx.batch_axes, device=self.device,
            # None defers to pc.replan_every_items; an unset flag must not
            # silently disable a cadence the PipelineConfig asked for
            replan_every_items=replan_every if replan_every else None)
        it = iter(pipeline)
        done = 0
        saved = None                       # the step this run last saved
        while done < n_steps:
            batch = next(it, None)
            if batch is None:
                break
            try:
                if self.step_idx == inject_failure_at:
                    inject_failure_at = -1          # fail exactly once
                    raise RuntimeError("injected node failure")
                t0 = time.monotonic()
                c0 = collectives.spent()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                coll = collectives.spent_since(c0)
            except RuntimeError as e:
                if "injected" not in str(e):
                    raise
                # node-failure path: restore + resume (the data path must
                # survive erratic components)
                restored = self.try_restore()
                if not restored:
                    self.init_state()
                continue
            self.step_idx += 1
            done += 1
            rec = {"step": self.step_idx, "loss": loss, "wall_s": dt,
                   "collective_s": coll["seconds"],
                   "collective_kinds_s": coll["kinds"],
                   "grad_norm": float(metrics["grad_norm"]),
                   "input_stall_s": pipeline.consumer_stall_s(),
                   "input_fidelity_gap": pipeline.fidelity_gap()}
            self.metrics_log.append(rec)
            if done % max(1, telemetry_every) == 0:
                if telemetry_json:
                    get_registry().dump_json(telemetry_json)
                if telemetry_jsonl:
                    get_registry().append_jsonl(telemetry_jsonl)
            if self.ckpt is not None and self.ckpt.maybe_save(
                    self.step_idx, self.state_tree(),
                    shardings=self.state_shardings()):
                saved = self.step_idx
        pipeline.record_telemetry()
        if telemetry_json:
            get_registry().dump_json(telemetry_json)
        if telemetry_jsonl:
            get_registry().append_jsonl(telemetry_jsonl)
        if self.ckpt is not None:
            self.ckpt.wait()
            # the last step, unless its cadence save already holds it (every
            # rank decides alike: it counts its own saves)
            if saved != self.step_idx:
                self.ckpt.maybe_save(self.step_idx, self.state_tree(),
                                     force=True,
                                     shardings=self.state_shardings())
                self.ckpt.wait()
        return self.metrics_log


def main(argv: Optional[list[str]] = None) -> list[dict]:
    """The CLI; returns the run's metrics log (on every rank)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, on NCCL the "
                         "rank's LOCAL_RANK-th; 'cpu' runs on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a (data, model) mesh of D x M ranks, "
                         "FSDP and TP: the world torchrun starts, or the "
                         "one already initialised in the process (default: "
                         "one card)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="the world's backend when --mesh starts it: nccl "
                         "for one rank per card, gloo on the CPU or for "
                         "ranks that share a card")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--replan-every", type=int, default=0,
                    help="revise the transfer plan online from observed "
                         "stalls and service-time samples every N batches, "
                         "at a buffer boundary inside the running stream "
                         "(0 = off)")
    ap.add_argument("--telemetry-json", default=None, metavar="PATH",
                    help="periodically dump the cross-layer telemetry "
                         "registry to PATH as JSON (atomic rename)")
    ap.add_argument("--telemetry-every", type=int, default=10,
                    help="step cadence of --telemetry-json/-jsonl dumps")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="append one telemetry snapshot per flush to PATH "
                         "as a JSONL time series")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh, started = (None, False)
    device = args.device
    if args.mesh:
        from repro_torch.launch.mesh import join_world
        mesh, started = join_world(args.mesh, args.backend)
        if device is None and args.backend == "nccl":
            device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
            torch.cuda.set_device(torch.device(device))
    try:
        log = _train(args, cfg, mesh, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()
    return log


def _train(args, cfg: ModelConfig, mesh, device) -> list[dict]:
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    trainer = Trainer(cfg, mesh, device=device, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, lr=args.lr,
                      total_steps=args.steps)
    trainer.init_state(args.seed)
    if trainer.try_restore():
        say(f"[train] resumed from step {trainer.step_idx}")

    pc = PipelineConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                        seed=args.seed)
    source = SyntheticTokenSource(cfg, pc, n_batches=args.steps + 8)
    log = trainer.run(source, args.steps,
                      inject_failure_at=args.inject_failure_at,
                      replan_every=args.replan_every,
                      telemetry_json=args.telemetry_json,
                      telemetry_every=args.telemetry_every,
                      telemetry_jsonl=args.telemetry_jsonl)
    for rec in log[-5:]:
        gap = rec.get("input_fidelity_gap")
        gap_s = f" gap {gap:+.3f}" if gap is not None else ""
        coll = (f" collectives {rec['collective_s'] * 1e3:.1f} ms"
                if mesh is not None else "")
        say(f"[train] step {rec['step']:5d} loss {rec['loss']:.4f} "
            f"wall {rec['wall_s']*1e3:.1f} ms{coll} "
            f"stall {rec['input_stall_s']:.3f}s{gap_s}")
    losses = [r["loss"] for r in log]
    if len(losses) >= 10:
        say(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    say("[train] transfer telemetry (all layers):")
    for line in get_registry().format_summary().splitlines():
        say(f"[train]   {line}")
    return log


if __name__ == "__main__":
    main()
