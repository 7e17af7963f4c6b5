"""Training driver: the full co-designed data path, end to end, on one card.

    dataset -> burst-buffered input pipeline -> train_step
            -> async checksummed checkpoints -> restart recovery

A port of the JAX package's ``launch/train.py``:

* periodic async checkpoints (manifest-atomic, SHA-256 per shard) in the
  JAX package's on-disk format,
* automatic restart discovery (newest complete manifest),
* step-failure recovery: a failing step restores the last checkpoint and
  resumes (``--inject-failure-at`` exercises this),
* the input basin is :func:`~repro_torch.core.basin.card_input_basin`
  with the host copy rate measured at the start of each run.

One card and no mesh: the step is the plain PyTorch forward and backward
(``impl="ref"``, as the JAX package trains) and AdamW with an f32 master.

Usage (the card unless ``--device cpu``):
  python -m repro_torch.launch.train --arch smollm-360m --steps 50 \
      --global-batch 8 --seq-len 512 --ckpt-dir /path/to/ckpt
  python -m repro_torch.launch.train --arch repro-100m --smoke \
      --device cpu --steps 12 --global-batch 2 --seq-len 64 \
      --ckpt-dir /path/to/ckpt --ckpt-every 4
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.basin import card_input_basin
from repro_torch.core.telemetry import get_registry
from repro_torch.data.pipeline import (InputPipeline, PipelineConfig,
                                       SyntheticTokenSource, batch_bytes)
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import build
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.weights import (from_jax_tree, jax_tree, opt_state_from_tree,
                                 opt_state_tree, param_names)


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
    """Owns the step function, state, pipeline, and recovery logic."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[torch.device | str] = None,
                 microbatches: int = 1,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 lr: float = 3e-4, total_steps: int = 1000):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = build(cfg)
        # warmup must fit inside the run: the default 100-step warmup never
        # reaches peak lr on short runs (smoke tests, examples)
        warmup = max(1, min(100, total_steps // 5))
        self.train_step, self.ctx = steps_lib.make_train_step(
            self.api, microbatches=microbatches, lr_peak=lr, warmup=warmup,
            total_steps=total_steps)
        self.ckpt = (CheckpointManager(ckpt_dir, every_steps=ckpt_every)
                     if ckpt_dir else None)
        self.params: Optional[lm_lib.LM] = None
        self.opt_state: Optional[AdamWState] = None
        self.step_idx = 0
        self.metrics_log: list[dict] = []

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        """Weights drawn on the trainer's device from a generator seeded
        with ``seed``, and a fresh AdamW state."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = lm_lib.init_lm(self.cfg, generator=gen,
                                     device=self.device, trainable=True)
        self.opt_state = adamw_init(self.params.parameters())

    def state_tree(self) -> dict:
        """Parameters and AdamW state in the JAX package's checkpoint
        layout: ``{"params": ..., "opt": AdamWState(...)}``, per-layer
        tensors as :class:`~repro_torch.tree.Stacked` leaves."""
        names = param_names(self.params)
        return {"params": jax_tree(list(self.params.parameters()), names),
                "opt": opt_state_tree(self.opt_state, names)}

    def try_restore(self) -> bool:
        """Resume from the newest complete checkpoint, onto the trainer's
        device.  A save still in flight completes first, so which step the
        failure path restores does not depend on the save thread's timing
        (the JAX package's trainer restores whatever has committed)."""
        if self.ckpt is None:
            return False
        self.ckpt.wait()
        step, state = self.ckpt.restore_latest(self.state_tree())
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
            source, basin=basin, pc=pc, device=self.device,
            # None defers to pc.replan_every_items; an unset flag must not
            # silently disable a cadence the PipelineConfig asked for
            replan_every_items=replan_every if replan_every else None)
        it = iter(pipeline)
        done = 0
        while done < n_steps:
            batch = next(it, None)
            if batch is None:
                break
            try:
                if self.step_idx == inject_failure_at:
                    inject_failure_at = -1          # fail exactly once
                    raise RuntimeError("injected node failure")
                t0 = time.monotonic()
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
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
                   "input_stall_s": pipeline.consumer_stall_s(),
                   "input_fidelity_gap": pipeline.fidelity_gap()}
            self.metrics_log.append(rec)
            if done % max(1, telemetry_every) == 0:
                if telemetry_json:
                    get_registry().dump_json(telemetry_json)
                if telemetry_jsonl:
                    get_registry().append_jsonl(telemetry_jsonl)
            if self.ckpt is not None:
                self.ckpt.maybe_save(self.step_idx, self.state_tree())
        pipeline.record_telemetry()
        if telemetry_json:
            get_registry().dump_json(telemetry_json)
        if telemetry_jsonl:
            get_registry().append_jsonl(telemetry_jsonl)
        if self.ckpt is not None:
            self.ckpt.wait()
            self.ckpt.maybe_save(self.step_idx, self.state_tree(),
                                 force=True)
            self.ckpt.wait()
        return self.metrics_log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
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
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    trainer = Trainer(cfg, device=args.device, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, lr=args.lr,
                      total_steps=args.steps)
    trainer.init_state(args.seed)
    if trainer.try_restore():
        print(f"[train] resumed from step {trainer.step_idx}")

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
        print(f"[train] step {rec['step']:5d} loss {rec['loss']:.4f} "
              f"wall {rec['wall_s']*1e3:.1f} ms "
              f"stall {rec['input_stall_s']:.3f}s{gap_s}")
    losses = [r["loss"] for r in log]
    if len(losses) >= 10:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    print("[train] transfer telemetry (all layers):")
    for line in get_registry().format_summary().splitlines():
        print(f"[train]   {line}")


if __name__ == "__main__":
    main()
