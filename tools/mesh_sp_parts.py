"""Run the mesh phase's sequence-parallel parts of ``chip_smoke.py`` alone
on one card, with the unsplit parts they are held to.

    python tools/mesh_sp_parts.py [--parts P,...] [--out FILE.json]

Builds the kernels, then runs, through ``chip_smoke.py``'s own functions,
the parts named (default all, in this order): ``flash_offset``, the flash
kernel at a rank's block of query rows (``FLASH_OFFSET_ROWS``) against its
plain version and the unsplit launch's rows; then on ``chip_smoke.py``'s
four gloo ranks (``MeshWorld``) ``phi3`` (``MESH_PHI3``'s layers),
``mamba2`` and ``smollm`` (``MESH_SMOLLM``: the query-sequence split)
served at TP 4, each again with and without Megatron sequence
parallelism (``mesh_tp_serve(sp_steps=...)``); ``train``, smollm-360m's
(2, 2) trainer without the plan (``mesh_train``) and its steps under it
(``mesh_sp_train``), both with the query split; ``mixtral``, mixtral at
EP 4 (``MESH_MIXTRAL``) served, its MoE layer checked (entered from the
ranks' sequence chunks too), and served again with and without the plan
(``mesh_mixtral``); ``moe_train``, qwen3-moe's (2, 2) trainer without
the plan (``mesh_moe_train``) and its steps under it (``mesh_sp_train``
with ``MESH_MOE_SP_TRAIN``).  The phi3 KV staging under the digest is
left out.  Prints every record as ``chip_smoke.py``
does, each part's seconds, and fails as it fails.  Needs a CUDA card and
``nvcc``; imports nothing of JAX.
"""

PARTS = ("flash_offset", "phi3", "mamba2", "smollm", "train", "mixtral",
         "moe_train")

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the part records to this JSON file")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {', '.join(PARTS)}")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    import torch
    if not torch.cuda.is_available():
        print("mesh_sp_parts: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    t0 = time.monotonic()
    cs.emit("build", per_source_s=build.build_all(),
            seconds=time.monotonic() - t0)
    paths, records = {}, []
    if "flash_offset" in parts:
        checks = [cs.check_flash(torch, B=B, Hq=hq, Hkv=hkv, S=sq, Sk=sk,
                                 hd=hd, dtype=getattr(torch, dt), window=w,
                                 q_offset=off)
                  for _, B, hq, hkv, sq, sk, hd, w, off, dt
                  in cs.FLASH_OFFSET_ROWS]
        records += checks
        cs.checks_ok(checks)
    rng = torch.Generator().manual_seed(cs.SEED + 5)
    world = cs.MeshWorld(cs.MESH_RANKS)
    tmp = tempfile.mkdtemp(prefix="mesh_sp_parts_")
    try:
        if "phi3" in parts:
            t = time.monotonic()
            phi3 = cs._train_cfg(cs.MESH_PHI3)
            batch = cs._prompts(torch, phi3, cs.MESH_PHI3["batch"],
                                cs.MESH_PHI3["prompt"], rng)
            cs.mesh_tp_serve(torch, world, tmp, paths, records, phi3, batch,
                             cs.MESH_PHI3["steps"], "mesh_phi3",
                             sp_steps=cs.MESH_SP_STEPS)
            cs.emit("part_time", of="phi3", seconds=time.monotonic() - t)
        if "mamba2" in parts:
            t = time.monotonic()
            cfg = get_config("mamba2-1.3b")
            spec = cs.MESH_FAMILY_SERVE["mamba2"]
            batch = cs._prompts(torch, cfg, spec["batch"], spec["prompt"],
                                rng)
            cs.mesh_tp_serve(torch, world, tmp, paths, records, cfg, batch,
                             spec["steps"], "mesh_mamba2",
                             launches=cs._family_launches(
                                 cfg, cs.MESH_RANKS, spec["gen"]),
                             gen=spec["gen"], sp_steps=cs.MESH_SP_STEPS)
            cs.emit("part_time", of="mamba2", seconds=time.monotonic() - t)
        if "smollm" in parts:
            t = time.monotonic()
            spec = cs.MESH_SMOLLM
            cfg = get_config(spec["arch"])
            batch = cs._prompts(torch, cfg, spec["batch"], spec["prompt"],
                                rng)
            cs.mesh_tp_serve(torch, world, tmp, paths, records, cfg, batch,
                             spec["steps"], "mesh_smollm", gen=spec["gen"],
                             sp_steps=cs.MESH_SP_STEPS)
            cs.emit("part_time", of="smollm", seconds=time.monotonic() - t)
        if "train" in parts:
            t = time.monotonic()
            nosp: dict = {}
            rec = cs.mesh_train(torch, world, tmp, paths, nosp)
            records.append(rec)
            cs.checked(rec, "training on the mesh", (
                "loss_ok", "grad_norm_ok", "leaf_norms_ok", "losses_ok",
                "same_ok", "no_kernel_ok", "failure_ok", "elastic_ok",
                "elastic_step_ok", "verify_ok", "hashes_ok",
                "query_rows_ok"))
            cs.emit("part_time", of="train", seconds=time.monotonic() - t)
            t = time.monotonic()
            rec = cs.mesh_sp_train(torch, world, paths, nosp)
            records.append(rec)
            cs.checked(rec, "training under sequence parallelism",
                       cs.SP_TRAIN_CHECKS)
            cs.emit("part_time", of="sp train", seconds=time.monotonic() - t)
        if "mixtral" in parts:
            t = time.monotonic()
            cs.mesh_mixtral(torch, world, tmp, paths, records, rng)
            cs.emit("part_time", of="mixtral", seconds=time.monotonic() - t)
        if "moe_train" in parts:
            t = time.monotonic()
            nosp = {}
            rec = cs.mesh_moe_train(torch, world, tmp, paths, nosp)
            records.append(rec)
            cs.checked(rec, "qwen3-moe's training on the mesh", (
                "loss_ok", "grad_norm_ok", "leaf_norms_ok", "losses_ok",
                "same_ok", "no_kernel_ok", "failure_ok", "elastic_ok",
                "elastic_step_ok", "verify_ok", "routes_ok"))
            cs.emit("part_time", of="moe train", seconds=time.monotonic() - t)
            t = time.monotonic()
            rec = cs.mesh_sp_train(torch, world, paths, nosp,
                                   cs.MESH_MOE_SP_TRAIN, "mesh_moe_sp_train")
            records.append(rec)
            cs.checked(rec, "qwen3-moe's training under sequence "
                       "parallelism", cs.SP_TRAIN_CHECKS + ("routes_ok",))
            cs.emit("part_time", of="moe sp train",
                    seconds=time.monotonic() - t)
    finally:
        codes = world.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(c != 0 for c in codes):
        cs.fail(f"the mesh ranks exited with {codes}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)
    cs.emit("total", seconds=time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
