"""Checkpointing: staged, checksummed, atomic — the JAX package's format.

A copy of the JAX package's ``checkpoint/manager.py`` on PyTorch tensors.
Either package reads the other's checkpoints: the same ``leaf_{i:05d}.npy``
shards in JAX's leaf order under the same path strings
(:func:`repro_torch.tree.flatten_with_paths`), byte-equal for equal
arrays (bf16 written as the raw 2-byte values ``np.save`` stores for an
``ml_dtypes`` array, read back without ``ml_dtypes``), a SHA-256 per
shard, and ``manifest.json`` committed by a tmp-dir rename.  The
manifest's ``treedef`` is ``str()`` of a JAX PyTreeDef in the JAX package,
which its loader never reads; the port writes its own description there.

The device-to-host snapshot copies each leaf into one host array of its
own; a :class:`~repro_torch.tree.Stacked` leaf (one tensor per layer) is
copied layer by layer into its slice, never stacked on the card.  Restore
puts each leaf on the device of the caller's ``like`` leaf, cast to its
dtype; there is one card, so nothing is re-sharded.

Checkpoint traffic is a *bulk transfer* in the paper's taxonomy (data at
rest moving device -> storage), so it runs through the same unified-mover
machinery as everything else:

* shards are staged through a burst buffer so the device-side snapshot
  completes immediately and training never blocks on storage (async save),
* every shard carries a SHA-256 (the paper's integrity budget, computed
  inside the staged path where it overlaps transit),
* the manifest commits atomically (tmp dir + rename): a crash mid-save
  can never corrupt the restore point — restart discovers the newest
  *complete* manifest,
* leaves are saved with logical shapes (a JAX job restores them onto
  any mesh),
* saves can **mirror to two storage tiers** (``mirror_root``): shards
  replicate down both branches of a
  :func:`~repro_torch.core.basin.mirrored_checkpoint_basin` plan (local NVMe +
  remote object store) through the mover's parallel-branch mirror mode,
  each branch's stall evidence attributed separately; restore picks
  whichever replica's branch is modeled faster and falls back to the
  other on a missing or corrupt copy.

This process-local implementation writes full arrays.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.basin import (checkpoint_basin,
                                    mirrored_checkpoint_basin)
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.planner import TransferPlan, plan_transfer
from repro_torch.core.telemetry import get_registry
from repro_torch.tree import (BF16_HOST, Stacked, dtype_name,
                              flatten_with_paths, from_host, host_array,
                              map_leaves, unflatten)


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    leaves: list[dict]            # {path, file, shape, dtype, sha256}
    treedef: str
    wall_time: float
    framework: str = "repro"


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that raw bf16 values get the header ``np.save``
    writes for an ``ml_dtypes`` bfloat16 array (``'<V2'``), so the file's
    bytes equal the JAX package's."""
    if arr.dtype != BF16_HOST:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        np.ascontiguousarray(arr).tofile(f)


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def complete_steps(root: str) -> list[int]:
    """Every step with a *complete* (committed) manifest, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.exists(
                os.path.join(root, name, "manifest.json")):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Newest step with a complete manifest."""
    steps = complete_steps(root)
    return steps[-1] if steps else None


def _leaf_plan(total_bytes: int, n_leaves: int,
               plan: Optional[TransferPlan] = None) -> TransferPlan:
    """Per-shard staging parameters from the checkpoint basin model."""
    if plan is not None:
        return plan
    item_bytes = max(1, total_bytes // max(1, n_leaves))
    return plan_transfer(checkpoint_basin(), item_bytes,
                         stages=("serialize",), path="auto")


def _prepare_tmp(root: str, step: int) -> tuple[str, str]:
    os.makedirs(root, exist_ok=True)
    final_dir = _ckpt_dir(root, step)
    tmp_dir = final_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    return final_dir, tmp_dir


def _make_writer(tmp_dir: str, manifest_leaves: Optional[list]):
    """Shard writer bound to one destination directory; the primary
    destination's writer also fills the manifest (replicas carry
    byte-identical shards, so one manifest describes both)."""
    def write_shard(item):
        i, pstr, arr = item
        fname = f"leaf_{i:05d}.npy"
        _save_npy(os.path.join(tmp_dir, fname), arr)
        if manifest_leaves is not None:
            digest = hashlib.sha256(arr.tobytes()).hexdigest()
            manifest_leaves[i] = {
                "path": pstr, "file": fname, "shape": list(arr.shape),
                "dtype": dtype_name(arr), "sha256": digest,
            }
        return arr
    return write_shard


def save_checkpoint(root: str, step: int, tree: Any, *,
                    staged: bool = True,
                    plan: Optional[TransferPlan] = None,
                    mover: Optional[UnifiedDataMover] = None,
                    replan_every_items: int = 0,
                    mirror_root: Optional[str] = None) -> CheckpointMeta:
    """Write one checkpoint atomically; returns its manifest.

    ``replan_every_items > 0`` revises the staging plan online every that
    many shards (a large model's save is a long transfer — a filesystem
    that degrades mid-save is answered mid-save).  Revisions apply
    **zero-drain**: the shard pipeline persists across revision windows
    and re-sizes in place, so a long save never pays a teardown bubble at
    the planning boundary.  Passing a persistent ``mover`` lets revisions
    carry across checkpoints: the mover's plan is the live estimate,
    updated by each save's observed stalls.

    ``mirror_root`` turns the save into a dual-tier mirror: every shard
    replicates down both branches of a mirrored-checkpoint plan (local
    NVMe + remote object store) via the mover's parallel mirror mode —
    one pipeline per branch, stall evidence attributed per branch — and
    both directories commit their (identical) manifest atomically.

    ``tree`` is a tree of dicts, NamedTuples, lists and tuples whose
    leaves are tensors (on any device), :class:`~repro_torch.tree.Stacked`
    per-layer tensors, or numpy arrays."""
    final_dir, tmp_dir = _prepare_tmp(root, step)
    mirror_dirs: Optional[tuple[str, str]] = None
    if mirror_root is not None:
        mirror_dirs = _prepare_tmp(mirror_root, step)

    # device -> host snapshot happens up front (the fast, blocking part);
    # serialization + hashing + disk I/O ride the staged path.
    snapshot = [(i, pstr, host_array(v))
                for i, (pstr, v) in enumerate(flatten_with_paths(tree))]

    manifest_leaves: list[dict] = [None] * len(snapshot)
    write_primary = _make_writer(tmp_dir, manifest_leaves)
    total_bytes = sum(a.nbytes for _, _, a in snapshot)

    if staged:
        if mover is None:
            mover = UnifiedDataMover(MoverConfig(checksum=False),
                                     telemetry=get_registry(),
                                     layer="checkpoint")
        if mirror_dirs is not None:
            if plan is None or not plan.is_multipath:
                item_bytes = max(1, total_bytes // max(1, len(snapshot)))
                plan = plan_transfer(mirrored_checkpoint_basin(), item_bytes,
                                     stages=("serialize",), path="auto")
            primary_id = plan.branches[0].branch_id
            write_mirror = _make_writer(mirror_dirs[1], None)
            transforms = {
                b.branch_id: [("serialize",
                               write_primary if b.branch_id == primary_id
                               else write_mirror)]
                for b in plan.branches
            }
            mover.parallel_transfer(iter(snapshot), sink=lambda _: None,
                                    plan=plan, mode="mirror",
                                    transforms=transforms,
                                    replan_every_items=replan_every_items)
        else:
            if plan is not None:
                mover.plan = plan
            elif mover.plan is None:
                mover.plan = _leaf_plan(total_bytes, len(snapshot), None)
            # plan=None: draw from (and revise) the mover's own plan, so a
            # persistent mover replans across shard batches and across saves
            mover.bulk_transfer(iter(snapshot), sink=lambda _: None,
                                transforms=[("serialize", write_primary)],
                                replan_every_items=replan_every_items)
    else:
        write_mirror = (_make_writer(mirror_dirs[1], None)
                        if mirror_dirs is not None else None)
        for item in snapshot:
            write_primary(item)
            if write_mirror is not None:
                write_mirror(item)

    missing = sum(1 for l in manifest_leaves if l is None)
    if missing:
        # defense in depth: a failed branch surfaces as an exception from
        # the mover's join before this point, but a torn manifest must
        # never commit under any silent-incompleteness path
        raise IOError(f"checkpoint save incomplete: {missing} of "
                      f"{len(manifest_leaves)} shards unwritten")
    meta = CheckpointMeta(
        step=step, leaves=manifest_leaves, wall_time=time.time(),
        treedef=f"repro_torch: {len(snapshot)} leaves in JAX's leaf order")
    commits = [(final_dir, tmp_dir)]
    if mirror_dirs is not None:
        commits.append(mirror_dirs)
    for fin, tmp in commits:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(dataclasses.asdict(meta), f)
        if os.path.exists(fin):
            shutil.rmtree(fin)
        os.replace(tmp, fin)       # atomic commit (per replica)
    return meta


def verify_checkpoint(root: str, step: int) -> bool:
    """Re-hash every shard against the manifest."""
    d = _ckpt_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    for leaf in meta["leaves"]:
        arr = np.load(os.path.join(d, leaf["file"]))
        if hashlib.sha256(arr.tobytes()).hexdigest() != leaf["sha256"]:
            return False
    return True


def load_checkpoint(root: str, step: int, like: Any, *,
                    verify: bool = False, staged: bool = True,
                    replan_every_items: int = 0) -> Any:
    """Restore into the structure of ``like``: each leaf on the device of
    ``like``'s leaf (a tensor, or a :class:`~repro_torch.tree.Stacked`,
    which gets per-layer views of one restored tensor) and cast to its
    dtype.

    With ``staged`` (the default) shard files are read through the
    planned mover path — concurrent reads overlap storage latency, and
    assembly is order-independent (leaves are keyed by tree path)."""
    d = _ckpt_dir(root, step)
    if verify and not verify_checkpoint(root, step):
        raise IOError(f"checkpoint {d} failed integrity verification")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    by_path = {l["path"]: l for l in meta["leaves"]}

    def read_leaf(leaf: dict) -> tuple[str, Any]:
        arr = np.load(os.path.join(d, leaf["file"]))
        return leaf["path"], from_host(arr, leaf["dtype"])

    arrays: dict[str, Any] = {}
    if staged and meta["leaves"]:
        total = sum(os.path.getsize(os.path.join(d, l["file"]))
                    for l in meta["leaves"])
        plan = _leaf_plan(total, len(meta["leaves"]))
        mover = UnifiedDataMover(MoverConfig(checksum=False), plan=plan,
                                 telemetry=get_registry(), layer="checkpoint")
        mover.bulk_transfer(iter(meta["leaves"]),
                            sink=lambda kv: arrays.__setitem__(*kv),
                            transforms=[("serialize", read_leaf)],
                            plan=plan,
                            replan_every_items=replan_every_items)
    else:
        for leaf in meta["leaves"]:
            k, v = read_leaf(leaf)
            arrays[k] = v

    out = []
    for pstr, ref in flatten_with_paths(like):
        if pstr not in by_path:
            raise KeyError(f"checkpoint missing leaf {pstr}")
        arr = arrays[pstr]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{pstr}: shape {tuple(arr.shape)} != "
                             f"{tuple(ref.shape)}")
        t = arr.to(device=ref.device, dtype=ref.dtype)
        out.append(Stacked(t.unbind(0)) if isinstance(ref, Stacked) else t)
    return unflatten(like, out)


class CheckpointManager:
    """Train-loop-facing manager: periodic async saves, retention,
    restart discovery, failure recovery.

    The manager owns one persistent mover for the save path: the staging
    plan it carries is revised online every ``replan_every_shards`` shards
    *and* survives from one checkpoint to the next, so the estimate of the
    storage tier converges across saves instead of resetting each time.

    ``mirror_root`` enables dual-tier mirrored saves (see
    :func:`save_checkpoint`); the mirrored (multipath) plan persists
    across saves the same way, so a degraded replica tier keeps its
    per-branch verdict from one checkpoint to the next.  Restore then
    considers both roots: newest complete step first, the faster-modeled
    replica first within a step, falling back to the sibling replica —
    and then to older complete checkpoints — on any error (a torn,
    missing, or hash-mismatched copy)."""

    def __init__(self, root: str, *, every_steps: int = 100, keep: int = 3,
                 staged: bool = True, replan_every_shards: int = 16,
                 mirror_root: Optional[str] = None):
        self.root = root
        self.mirror_root = mirror_root
        self.every_steps = every_steps
        self.keep = keep
        self.staged = staged
        self.replan_every_shards = replan_every_shards
        self._mover: Optional[UnifiedDataMover] = None
        #: the live multipath estimate for mirrored saves (revised online
        #: and carried across checkpoints, like the mover's linear plan)
        self._mirror_plan: Optional[TransferPlan] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: one record per completed save: step, bytes, seconds of the
        #: device -> host snapshot and of serialize + hash + write
        self.history: list[dict] = []

    def maybe_save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every_steps):
            return False
        self.wait()
        # snapshot to host NOW (cheap), write in background (staged)
        t0 = time.monotonic()
        host_tree = map_leaves(host_array, tree)
        snapshot_s = time.monotonic() - t0
        if self.staged and self._mover is None:
            self._mover = UnifiedDataMover(MoverConfig(checksum=False),
                                           telemetry=get_registry(),
                                           layer="checkpoint")

        def run():
            try:
                t1 = time.monotonic()
                save_checkpoint(self.root, step, host_tree, staged=self.staged,
                                mover=self._mover,
                                plan=self._mirror_plan,
                                replan_every_items=self.replan_every_shards,
                                mirror_root=self.mirror_root)
                self.history.append({
                    "step": step, "snapshot_s": snapshot_s,
                    "write_s": time.monotonic() - t1,
                    "bytes": sum(a.nbytes for _, a in
                                 flatten_with_paths(host_tree))})
                if self.mirror_root and self._mover is not None:
                    self._mirror_plan = self._mover.last_plan
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _restore_roots(self) -> list[str]:
        """Candidate roots, fastest modeled replica first."""
        if not self.mirror_root:
            return [self.root]
        plan = self._mirror_plan
        if plan is None or not plan.is_multipath:
            plan = plan_transfer(mirrored_checkpoint_basin(), 1 << 20,
                                 stages=("serialize",))
        # primary root holds the first branch's replica, mirror the second
        rates = [b.rate_bytes_per_s for b in plan.branches[:2]]
        roots = [self.root, self.mirror_root]
        if len(rates) == 2 and rates[1] > rates[0]:
            roots.reverse()
        return roots

    def restore_latest(self, like: Any) -> tuple[Optional[int], Any]:
        if not self.mirror_root:
            # single root: the historical contract — newest complete step
            # or bust.  Silently resuming from an older step would mask a
            # corrupt/unreadable newest checkpoint.
            step = latest_step(self.root)
            if step is None:
                return None, like
            return step, load_checkpoint(self.root, step, like)
        roots = self._restore_roots()
        # every complete (step, replica) pair, newest step first, the
        # faster-modeled replica first within a step: a corrupt newest
        # copy falls back to its sibling, then to older checkpoints
        candidates = [(s, r) for r in roots for s in complete_steps(r)]
        candidates.sort(key=lambda t: (-t[0], roots.index(t[1])))
        if not candidates:
            return None, like
        last_err: Optional[Exception] = None
        for step, r in candidates:
            try:
                # fallback replicas exist, so re-hash shards against the
                # manifest: a silently bit-rotted copy must fail here so
                # the intact mirror (or an older step) gets its turn
                return step, load_checkpoint(r, step, like, verify=True)
            except Exception as e:       # torn/corrupt replica: try the next
                last_err = e
        raise last_err

    def _gc(self) -> None:
        for root in (self.root, self.mirror_root):
            if not root:
                continue
            for s in complete_steps(root)[:-self.keep]:
                shutil.rmtree(_ckpt_dir(root, s), ignore_errors=True)
