"""One rank of the port's gloo world, for the mesh tests.

    python tests/torch_mesh_ranks.py {mesh|gpipe|train|moe_train|vlm|family|family_train|seq_parallel|moe_seq_parallel} RANK WORLD PORT REF.npz OUTDIR

The test files call :func:`run_world`: it runs the JAX package's
reference script (``tests/jax_mesh_refs.py``) once, then starts WORLD (4)
of these at once, each single-threaded and niced, the world on one
core, with a free port on localhost.  Each joins the gloo world (60 s collective timeout), builds
the meshes, reads the inputs the JAX package's run wrote, computes the
port's outputs on its shards and rows, and writes them to
``OUTDIR/rank<RANK>.npz``.  It imports no JAX.  Any error leaves the
process with a traceback and a non-zero exit.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import init_world, make_mesh  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.config import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402
from repro_torch.parallel.sharding import shard_tensor, unshard  # noqa: E402
from repro_torch.tree import flatten_with_paths, host_array  # noqa: E402

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))


def run_world(job: str, out_dir, timeout_s: float = 240.0):
    """The JAX package's reference outputs for ``job`` (one subprocess),
    then the port's from one gloo world of :data:`WORLD` ranks.  Returns
    (reference npz, [rank npz ...], {"jax_s", "ranks_s"}); raises with
    the failing process's output if one fails or outlives ``timeout_s``."""
    from repro_torch.launch.mesh import free_port
    out_dir = str(out_dir)
    src = os.path.join(HERE, "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    ref = os.path.join(out_dir, "ref.npz")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, os.path.join(HERE, "jax_mesh_refs.py"),
                        job, ref], env=env, capture_output=True, text=True,
                       timeout=timeout_s)
    if r.returncode:
        raise RuntimeError(f"the JAX reference run failed:\n{r.stderr[-4000:]}")
    t1 = time.monotonic()
    port = free_port()
    logs = [os.path.join(out_dir, f"rank{i}.log") for i in range(WORLD)]
    procs = []
    for i in range(WORLD):
        with open(logs[i], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(i),
                 str(WORLD), str(port), ref, out_dir], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = t1 + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = "\n".join(f"--- rank {i} (exit {procs[i].returncode}):\n"
                         + open(logs[i]).read()[-3000:] for i in bad)
        raise RuntimeError(f"ranks {bad} failed:\n{text}")
    ranks = [np.load(os.path.join(out_dir, f"rank{i}.npz"))
             for i in range(WORLD)]
    return np.load(ref), ranks, {"jax_s": t1 - t0,
                                 "ranks_s": time.monotonic() - t1}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _tree(ref, prefix: str) -> dict:
    """The ``prefix``-named entries of ``ref`` as a nested dict."""
    out: dict = {}
    for key in ref.files:
        if key.startswith(prefix):
            node = out
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[key]
    return out


def _rows(a: np.ndarray, mesh) -> np.ndarray:
    """This rank's rows of a batch split over the data axis."""
    n = a.shape[0] // mesh.shape["data"]
    i = mesh.coords["data"]
    return a[i * n:(i + 1) * n]


def moe_cfg(cf: float) -> ModelConfig:
    return ModelConfig(name="m", family="moe", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                       vocab=64, moe=MoEConfig(n_experts=8, top_k=2,
                                               d_ff_expert=64,
                                               capacity_factor=cf))


def moe(out, ref, meta, meshes):
    """``moe_ep`` (its experts' block of the weights; with the D dim also
    over data, gathered first as ``ShardCtx.gathered`` gathers it, where
    data > 1) and ``moe_tp`` (its slice of d_ff) on the rank's rows, with
    the pairs it kept."""
    w = {k: _t(ref[f"moe/{k}"]) for k in ("wr", "wg", "wu", "wd")}
    for case, (m, cf, _) in meta["moe"].items():
        mesh, cfg = meshes[m], moe_cfg(cf)
        x = _t(_rows(ref[f"moe/{case}/x"], mesh))
        variants = {
            "ep": (ffn.moe_ep, ("model", None, None), ("model", None, None),
                   {}),
            "tp": (ffn.moe_tp, (None, None, "model"), (None, "model", None),
                   {}),
        }
        if mesh.shape["data"] > 1:
            variants["ep_fsdp"] = (ffn.moe_ep, ("model", "data", None),
                                   ("model", None, "data"), {})
        for impl, (fn, up_spec, down_spec, kw) in variants.items():
            log = ffn.RouteLog()
            wg, wu, wd = (unshard(shard_tensor(w[k], spec, mesh), tuple(
                a if a == "data" else None for a in spec), mesh)
                for k, spec in (("wg", up_spec), ("wu", up_spec),
                                ("wd", down_spec)))
            y, lb, z = fn(x, w["wr"], wg, wu, wd, cfg=cfg,
                          mesh=mesh, batch_axes=("data",), log=log, **kw)
            keep, first, total = log.kept[0]
            out[f"moe/{case}/{impl}/y"] = y.numpy()
            out[f"moe/{case}/{impl}/aux"] = np.asarray([lb, z], np.float32)
            out[f"moe/{case}/{impl}/keep"] = keep.numpy()
            out[f"moe/{case}/{impl}/span"] = np.asarray([first, total])


def collectives(out, ref, meta, meshes, rank):
    """Each primitive on rank-dependent values, and the two exchanges on
    the JAX run's inputs (rank r takes row r: device (d, m) of a (2, 2)
    mesh takes row 2d + m, as ``shard_map`` splits ``P(("data",
    "model"))``)."""
    mesh = meshes["2x2"]
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    for axes in ("data", "model", ("data", "model")):
        name = "+".join(mesh.axes(axes))
        out[f"prim/psum/{name}"] = coll.psum(x, mesh, axes).numpy()
        out[f"prim/psum_bf16/{name}"] = coll.psum(
            x.bfloat16(), mesh, axes).float().numpy()
        out[f"prim/all_gather/{name}"] = coll.all_gather(
            x, mesh, axes, dim=1).numpy()
        out[f"prim/all_to_all/{name}"] = coll.all_to_all(
            x, mesh, axes, split_dim=0, concat_dim=1).numpy()
        out[f"prim/psum_scatter/{name}"] = coll.psum_scatter(
            x, mesh, axes, dim=0).numpy()
    for axis in ("data", "model"):
        for shift in (1, -1):
            out[f"prim/ppermute/{axis}/{shift}"] = coll.ppermute(
                x, mesh, axis, shift).numpy()
    for case, (m, axis, _, block) in meta["cpsum"].items():
        xr = _t(ref[f"cpsum/{case}/x"][rank])
        out[f"cpsum/{case}/out"] = coll.compressed_psum(
            xr, meshes[m], axis, block=block).numpy()
    xr = _t(ref["hpsum/x"][rank])
    for name, c in (("plain", False), ("compressed", True)):
        out[f"hpsum/{name}/out"] = coll.hierarchical_psum(
            xr, mesh, intra_axis="model", inter_axis="data",
            compress_inter=c, block=64).numpy()


def serve(out, ref, meta, meshes):
    """The smoke models through ``Server(cfg, mesh)`` on the JAX model's
    weights (f32): prefill and teacher-forced decode logits, the rank's
    cache, and ``generate`` (rank 0 streams through the mover)."""
    from repro_torch.launch.serve import Server
    from repro_torch.weights import shard_params
    for case, (arch, m, B, prompt, steps, max_len) in meta["serve"].items():
        cfg, mesh = get_smoke_config(arch), meshes[m]
        server = Server(cfg, mesh, device="cpu", max_len=max_len)
        server.params = shard_params(_tree(ref, f"serve/{case}/params/"),
                                     cfg, mesh, device="cpu")
        tokens = ref[f"serve/{case}/tokens"]
        forced = server._on_device(ref[f"serve/{case}/forced"])
        logits, cache = server.prefill({"tokens": tokens})
        outs = [logits]
        for t in range(steps):
            logits, cache = server.decode(cache, forced[:, t:t + 1])
            outs.append(logits)
        out[f"serve/{case}/logits"] = torch.stack(outs).numpy()
        out[f"serve/{case}/cache_k"] = np.asarray(cache["k"].shape)
        out[f"serve/{case}/params"] = np.asarray(
            sum(p.numel() for p in server.params.parameters()))
        out[f"serve/{case}/generated"] = server.generate(
            {"tokens": tokens}, steps)
        out[f"serve/{case}/streamed"] = np.asarray(
            -1 if server.last_report is None else server.last_report.items)


def gpipe(out, ref, meta):
    """``pipeline_forward`` of the JAX run's 8-layer stack, each stage
    holding its slab, with the layer function's calls counted."""
    from repro_torch.models.blocks import ShardCtx, dense_layer_apply
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.weights import _dense_layer
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), n_layers=8)
    layers = _tree(ref, "gpipe/layers/")
    ctx = ShardCtx(impl="cuda")
    for case, (shape, axes, stage_axis, _) in meta["gpipe"].items():
        mesh = make_mesh(tuple(shape), tuple(axes))
        n = mesh.axis_size(stage_axis)
        per = cfg.n_layers // n
        stage = mesh.axis_index(stage_axis)
        slab = [_dense_layer(layers, torch.device("cpu"), i)
                for i in range(stage * per, (stage + 1) * per)]
        x = _t(ref[f"gpipe/{case}/x"])
        positions = torch.arange(x.shape[2], dtype=torch.int32)
        calls = []

        def layer_fn(ps, h):
            calls.append(1)
            for lp in ps:
                h = dense_layer_apply(h, lp, cfg, ctx, positions=positions)
            return h

        with torch.no_grad():
            y = pipeline_forward(layer_fn, slab, x, mesh=mesh,
                                 stage_axis=stage_axis, layers_per_stage=per)
        out[f"gpipe/{case}/y"] = y.numpy()
        out[f"gpipe/{case}/calls"] = np.asarray(len(calls))


# ---------------------------------------------------------------------------
# train: the mesh train step, its collectives, the elastic restore
# ---------------------------------------------------------------------------

#: the gradient collectives' inputs: (rows, cols) of each rank's x
GRAD_SHAPE = (2, 3)


def grad_inputs(rank: int):
    """Rank ``rank``'s x and the weight w of its loss ``sum(w * f(x))``."""
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(GRAD_SHAPE).astype(np.float32),
            rng.standard_normal((4, 6)).astype(np.float32))


def grad_collectives(out, mesh, rank):
    """Each collective that carries gradients, on the (2, 2) mesh: the
    gradient of ``sum(w * f(x))`` with respect to the rank's x.  Where
    ``f``'s result is the same on every member (``leave_region``), the
    members' loss is one replicated loss and each uses the model group's
    first member's w."""
    from repro_torch.parallel import collectives as coll
    d, m = mesh.coords["data"], mesh.coords["model"]
    first = d * mesh.shape["model"]          # rank (d, 0)
    cases = {
        "fsdp_gather": (lambda x: coll.fsdp_gather(x, mesh, "data", 0),
                        rank, (4, 3)),
        "enter_region": (lambda x: coll.enter_region(x, mesh, "model"),
                         rank, GRAD_SHAPE),
        "leave_region": (lambda x: coll.leave_region(x, mesh, "model"),
                         first, GRAD_SHAPE),
    }
    for name, (fn, w_rank, shape) in cases.items():
        x = _t(grad_inputs(rank)[0]).requires_grad_(True)
        w = _t(grad_inputs(w_rank)[1][:shape[0], :shape[1]])
        y = fn(x)
        (g,) = torch.autograd.grad(torch.sum(w * y), x)
        out[f"grad/{name}"] = g.numpy()
        out[f"grad/{name}/y"] = y.detach().numpy()


def train_steps(out, ref, meta, meshes, rank):
    """Each case's 2 steps (:func:`mesh_steps`)."""
    B, S = meta["train_batch"]
    for case, (arch, m, sharding, micro) in meta["train"].items():
        cfg = get_smoke_config(arch)
        mesh_steps(out, ref, meta, f"train/{case}", cfg, meshes[m], sharding,
                   micro, _train_batches(cfg.vocab, len(
                       ref[f"train/{case}/metrics"]), B, S),
                   ("loss", "ce", "grad_norm", "lr"), rank)


def mesh_steps(out, ref, meta, prefix, cfg, mesh, sharding, micro, batches,
               keys, rank):
    """``make_train_step`` on ``mesh`` under the plan over ``batches``,
    from the JAX run's weights (``<prefix>/params``) on the rank's shards
    (``shard_params`` under the plan) and rows: the metrics ``keys`` each
    step and the parameters held; rank 0 writes the gathered final
    weights."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.weights import shard_params
    plan = CodesignPlan(sharding=sharding, microbatches=micro,
                        seq_parallel=False)
    lm = shard_params(_tree(ref, f"{prefix}/params/"), cfg, mesh,
                      device="cpu", plan=plan, trainable=True)
    opt = adamw_init(lm.parameters())
    step, _ = make_train_step(build(cfg), mesh, plan,
                              lr_peak=meta["train_lr"], warmup=1,
                              total_steps=10)
    metrics = []
    for b in batches:
        lm, opt, mt = step(lm, opt, {k: _t(_rows(v, mesh))
                                     for k, v in b.items()})
        metrics.append([float(mt[k]) for k in keys])
    out[f"{prefix}/metrics"] = np.asarray(metrics)
    out[f"{prefix}/params_held"] = np.asarray(
        sum(p.numel() for p in lm.parameters()))
    whole = _gather_params(lm, cfg, mesh, plan)
    if rank == 0:
        for path, v in flatten_with_paths(whole):
            out[f"{prefix}/final/{path}"] = v


def _gather_params(lm, cfg, mesh, plan):
    """The whole parameters of which ``lm`` holds this rank's blocks under
    ``plan``, as the JAX package's numpy tree, gathered one parameter at a
    time (every rank joins each gather)."""
    from repro_torch.parallel.sharding import unshard
    from repro_torch.tree import map_leaves
    from repro_torch.weights import (jax_tree, param_names, param_shapes,
                                     param_spec)
    shapes, names = param_shapes(cfg), param_names(lm)
    whole = [unshard(p.detach(), param_spec(n, shapes[n], cfg, mesh, plan),
                     mesh).cpu() for n, p in zip(names, lm.parameters())]
    return map_leaves(host_array, jax_tree(whole, names))


def _train_batches(vocab, n, B, S):
    """The JAX run's batches (the same seeded numpy draws)."""
    rng = np.random.default_rng(17)
    return [{"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, vocab, (B, S), dtype=np.int32)}
            for _ in range(n)]


def _loss_mask(B, S):
    """The JAX run's mask: a different share of each row's tokens kept."""
    rng = np.random.default_rng(23)
    return (rng.random((B, S)) < np.linspace(0.15, 0.95, B)[:, None]
            ).astype(np.float32)


def masked_grads(out, ref, meta, meshes, rank):
    """The loss and the exchanged, gathered gradients of one batch whose
    loss mask differs row by row (so rank by rank) at (2, 2) FSDP + TP."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch import steps
    from repro_torch.models.api import build
    from repro_torch.parallel.sharding import jax_path, unshard
    from repro_torch.weights import jax_tree, param_names, shard_params
    cfg, mesh = get_smoke_config("smollm-360m"), meshes["2x2"]
    plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=False)
    api = build(cfg)
    lm = shard_params(_tree(ref, "masked/params/"), cfg, mesh, device="cpu",
                      plan=plan, trainable=True)
    ctx = steps.make_ctx(api, mesh, plan, "ref", train=True)
    B, S = meta["train_batch"]
    batch = dict(_train_batches(cfg.vocab, 1, B, S)[0],
                 loss_mask=_loss_mask(B, S))
    loss, aux = api.loss(lm, {k: _t(_rows(v, mesh)) for k, v in batch.items()},
                         ctx)
    names = param_names(lm)
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    specs = [ctx.specs[jax_path(n)] for n in names]
    grads = steps._exchange(grads, specs, ctx)
    whole = [unshard(g, s, mesh).numpy() for g, s in zip(grads, specs)]
    out["masked/loss"] = np.asarray([float(loss), float(aux["ce"])])
    if rank == 0:
        for path, v in flatten_with_paths(jax_tree(whole, names)):
            out[f"masked/grads/{path}"] = np.stack(v) if isinstance(
                v, tuple) else v


def elastic(out, ref, meta, meshes, rank, out_dir):
    """The JAX trainer's (2, 2) checkpoint restored by the port's
    ``Trainer`` at (4, 1) FSDP (each rank's blocks written as they came);
    the restored state saved again from the mesh (rank 0 writes
    ``OUTDIR/port_ckpt``); and the rank's rows of the input feed."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.data.pipeline import (InputPipeline, PipelineConfig,
                                           SyntheticTokenSource)
    from repro_torch.launch.train import Trainer
    cfg, mesh = get_smoke_config("smollm-360m"), meshes["4x1"]
    plan = CodesignPlan(sharding="fsdp", seq_parallel=False)
    t = Trainer(cfg, mesh, plan=plan, device="cpu",
                ckpt_dir=str(ref["ckpt/root"]))
    t.init_state(9)
    assert t.try_restore(), "no checkpoint restored"
    out["elastic/step"] = np.asarray(t.step_idx)
    for path, v in flatten_with_paths(t.state_tree()):
        out[f"elastic/state/{path}"] = host_array(v)
    ck = CheckpointManager(os.path.join(out_dir, "port_ckpt"), mesh=mesh)
    ck.maybe_save(t.step_idx, t.state_tree(), force=True,
                  shardings=t.state_shardings())
    ck.wait()
    r = meta["ckpt_run"]
    pc = PipelineConfig(r["batch"], r["seq"], seed=r["seed"])
    pipe = InputPipeline(SyntheticTokenSource(cfg, pc, n_batches=2), pc=pc,
                         mesh=meshes["2x2"], device="cpu")
    rows = list(pipe)
    out["feed/tokens"] = np.stack([b["tokens"].numpy() for b in rows])
    out["feed/labels"] = np.stack([b["labels"].numpy() for b in rows])


def failure(out, meshes, rank, out_dir):
    """The CLI on the (2, 2) mesh (``train.main``, in this world) with an
    injected failure after step 3, then a trainer that restores the run's
    step-2 checkpoint and trains on the batches the run fed after its
    restore: its losses against the run's."""
    from repro_torch.checkpoint.manager import load_checkpoint
    from repro_torch.data.pipeline import PipelineConfig, SyntheticTokenSource
    from repro_torch.launch import train
    from repro_torch.weights import from_jax_tree, opt_state_from_tree
    from repro_torch.weights import param_names
    root = os.path.join(out_dir, "cli_ckpt")
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--mesh",
            "2x2", "--steps", "6", "--global-batch", "8", "--seq-len", "16",
            "--ckpt-dir", root, "--ckpt-every", "2",
            "--inject-failure-at", "3"]
    log = train.main(args)
    out["fail/steps"] = np.asarray([r["step"] for r in log])
    out["fail/losses"] = np.asarray([r["loss"] for r in log])
    cfg = get_smoke_config("smollm-360m")
    t = train.Trainer(cfg, meshes["2x2"], device="cpu", total_steps=6)
    t.init_state(0)
    state = load_checkpoint(root, 2, t.state_tree(),
                            shardings=t.state_shardings())
    names = param_names(t.params)
    with torch.no_grad():
        for w, v in zip(t.params.parameters(),
                        from_jax_tree(state["params"], names)):
            w.copy_(v)
    t.opt_state = opt_state_from_tree(state["opt"], names)
    t.step_idx = 2

    class After:
        """The CLI run's source from its fifth batch on (batches 1-3 fed
        steps 1-3, the fourth was drawn when the failure struck)."""
        pc = PipelineConfig(8, 16, seed=0)

        def __iter__(self):
            it = iter(SyntheticTokenSource(cfg, self.pc, n_batches=14))
            for _ in range(4):
                next(it)
            return it
    again = t.run(After(), 3)
    out["fail/resumed_steps"] = np.asarray([r["step"] for r in again])
    out["fail/resumed_losses"] = np.asarray([r["loss"] for r in again])


# ---------------------------------------------------------------------------
# moe_train: the MoE's gradients and train steps on a training mesh, its
# checkpoints across layouts
# ---------------------------------------------------------------------------

#: the weights of the MoE gradient cases, in argument order
MOE_WEIGHTS = ("wr", "wg", "wu", "wd")


def moe_grad_specs(impl: str, fsdp: bool) -> dict:
    """What a rank holds of each weight of the gradient cases: the train
    rule table's spec for EP (experts over the model axis) or TP inside
    the experts (d_ff over it), with FSDP's data entries when ``fsdp``."""
    d = "data" if fsdp else None
    if impl == "ep":
        return {"wr": (d, None), "wg": ("model", d, None),
                "wu": ("model", d, None), "wd": ("model", None, d)}
    return {"wr": (d, None), "wg": (None, d, "model"),
            "wu": (None, d, "model"), "wd": (None, "model", d)}


def moe_cfg_of(meta, case: str) -> ModelConfig:
    """A MoE train case's smoke config with its expert count."""
    arch, _, _, _, experts = meta["moe_train"][case]
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))


def moe_grads(out, ref, meta, meshes, rank):
    """Each path's gradients of ``sum(y * c)``, lb and z, each alone, on a
    training mesh: the rank's blocks of the weights (FSDP's data split too
    where data > 1), gathered as ``ShardCtx.gathered`` gathers them, the
    weights' gradients exchanged as the train step exchanges them (``steps._exchange``) and gathered whole; x's
    gathered over the data axis on every rank."""
    from repro_torch.launch.steps import _exchange
    from repro_torch.models.blocks import ShardCtx
    for case, (m, cf) in meta["moe_grad"].items():
        mesh, cfg = meshes[m], moe_cfg(cf)
        for impl, fn in (("ep", ffn.moe_ep), ("tp", ffn.moe_tp)):
            specs = moe_grad_specs(impl, mesh.shape["data"] > 1)
            ctx = ShardCtx(impl="ref", mesh=mesh, specs=specs)
            for what in ("y", "lb", "z"):
                x = _t(_rows(ref["moe_grad/x"], mesh)).requires_grad_(True)
                c = _t(_rows(ref["moe_grad/c"], mesh))
                ws = [_t(shard_tensor(ref[f"moe_grad/{n}"], specs[n], mesh)
                         ).requires_grad_(True) for n in MOE_WEIGHTS]
                y, lb, z = fn(x, *(ctx.gather_weight(w, specs[n])
                                   for w, n in zip(ws, MOE_WEIGHTS)),
                              cfg=cfg, mesh=mesh, batch_axes=("data",))
                yc = coll.leave_region(torch.sum(y * c), mesh, "data")
                loss = {"y": yc, "lb": lb, "z": z}[what]
                grads = torch.autograd.grad(loss, [x] + ws,
                                            allow_unused=True,
                                            materialize_grads=True)
                key = f"moe_grad/{case}/{impl}/{what}"
                out[f"{key}/x"] = coll.all_gather(grads[0], mesh,
                                                  "data").numpy()
                gw = _exchange(grads[1:], [specs[n] for n in MOE_WEIGHTS],
                               ctx)
                for n, g in zip(MOE_WEIGHTS, gw):
                    whole = unshard(g, specs[n], mesh).numpy()
                    if rank == 0:
                        out[f"{key}/{n}"] = whole
            out[f"moe_grad/{case}/{impl}/terms"] = np.asarray(
                [float(t) for t in (yc, lb, z)], np.float32)


def moe_train_steps(out, ref, meta, meshes, rank):
    """Each MoE case's 2 steps (:func:`mesh_steps`)."""
    B, S = meta["train_batch"]
    for case, (_, m, sharding, micro, _) in meta["moe_train"].items():
        cfg = moe_cfg_of(meta, case)
        mesh_steps(out, ref, meta, f"moe_train/{case}", cfg, meshes[m],
                   sharding, micro, _train_batches(cfg.vocab, len(
                       ref[f"moe_train/{case}/metrics"]), B, S),
                   meta["train_metrics"], rank)


def moe_recompute(out, ref, meta, meshes):
    """One loss and backward of the (2, 2) EP + FSDP case under a
    ``RouteLog``: the layers are recomputed in the backward pass (their
    weights gathered over the data axis), so the log holds each layer's
    routing twice, forward order then backward order."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch import steps
    from repro_torch.models.api import build
    from repro_torch.weights import shard_params
    case = meta["moe_ckpt"][0]
    _, m, sharding, _, _ = meta["moe_train"][case]
    cfg, mesh = moe_cfg_of(meta, case), meshes[m]
    plan = CodesignPlan(sharding=sharding, seq_parallel=False)
    api = build(cfg)
    lm = shard_params(_tree(ref, f"moe_train/{case}/params/"), cfg, mesh,
                      device="cpu", plan=plan, trainable=True)
    log = ffn.RouteLog()
    ctx = dataclasses.replace(steps.make_ctx(api, mesh, plan, "ref",
                                             train=True), routes=log)
    B, S = meta["train_batch"]
    batch = _train_batches(cfg.vocab, 1, B, S)[0]
    loss, _ = api.loss(lm, {k: _t(_rows(v, mesh)) for k, v in batch.items()},
                       ctx)
    torch.autograd.grad(loss, list(lm.parameters()))
    L = cfg.n_layers
    out["recompute/calls"] = np.asarray(len(log.calls))
    out["recompute/kept"] = np.asarray(len(log.kept))
    for j in range(L):
        again = 2 * L - 1 - j             # the backward recomputes L-1 .. 0
        for what, calls in (("experts", [c[0] for c in log.calls]),
                            ("probs", [c[1] for c in log.calls]),
                            ("kept", [k[0] for k in log.kept])):
            out[f"recompute/{j}/{what}"] = calls[j].numpy()
            out[f"recompute/{j}/{what}_again"] = calls[again].numpy()


def _restored(out, prefix, trainer):
    """The restored step and each state leaf the rank holds."""
    out[f"{prefix}/step"] = np.asarray(trainer.step_idx)
    for path, v in flatten_with_paths(trainer.state_tree()):
        out[f"{prefix}/state/{path}"] = host_array(v)


def moe_checkpoints(out, ref, meta, meshes, out_dir):
    """The JAX run's EP + FSDP (2, 2) checkpoint restored by the port's
    ``Trainer`` at (1, 4) (EP, one expert a rank) and saved again from
    there; its TP-inside-experts (1, 4) checkpoint restored onto its own
    layout and saved again from it, and that save restored at (2, 2)
    under EP + FSDP (6 experts split over 2 model ranks).  Rank 0 writes
    the saves under ``OUTDIR/port_ckpt/<case>``.  Each elastic restore
    (the layouts of ``meta["moe_elastic"]``) then takes its trainer's
    next step (:func:`_next_step`)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch.train import Trainer
    root = str(ref["moe_ckpt/root"])
    tp = CodesignPlan(sharding="tp", seq_parallel=False)
    fsdp_tp = CodesignPlan(sharding="fsdp_tp", seq_parallel=False)

    def restore(case, mesh, plan, src, prefix):
        t = Trainer(moe_cfg_of(meta, case), meshes[mesh], plan=plan,
                    device="cpu", ckpt_dir=src)
        t.init_state(9)
        assert t.try_restore(), f"no checkpoint restored from {src}"
        _restored(out, prefix, t)
        return t

    for case in meta["moe_ckpt"]:
        t = restore(case, "1x4", tp, os.path.join(root, case),
                    f"ckpt/{case}/on_1x4")
        ck = CheckpointManager(os.path.join(out_dir, "port_ckpt", case),
                               mesh=t.mesh)
        ck.maybe_save(t.step_idx, t.state_tree(), force=True,
                      shardings=t.state_shardings())
        ck.wait()
        if meta["moe_elastic"][case][0] == "1x4":
            _next_step(out, f"ckpt/{case}/on_1x4", t, ref, meta, case)
    case = meta["moe_ckpt"][1]
    t = restore(case, "2x2", fsdp_tp, os.path.join(out_dir, "port_ckpt",
                                                   case),
                f"ckpt/{case}/on_2x2")
    _next_step(out, f"ckpt/{case}/on_2x2", t, ref, meta, case)


def _next_step(out, prefix, trainer, ref, meta, case):
    """The restored trainer's next step (its ``train_step``) over the
    batch after the JAX run's, its restored weights widened to f32 as the
    reference's are: the metrics ``meta["train_metrics"]``."""
    B, S = meta["train_batch"]
    batch = _train_batches(trainer.cfg.vocab, len(
        ref[f"moe_train/{case}/metrics"]) + 1, B, S)[-1]
    rows = {k: _t(_rows(v, trainer.mesh)) for k, v in batch.items()}
    _, _, mt = trainer.train_step(trainer.params.float(), trainer.opt_state,
                                  rows)
    out[f"{prefix}/next"] = np.asarray(
        [float(mt[k]) for k in meta["train_metrics"]])


def moe_cli(out, out_dir):
    """The CLI trains the smoke qwen3 on the (2, 2) mesh (``train.main``,
    in this world): 3 steps, a checkpoint at step 2."""
    from repro_torch.launch import train
    log = train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                      "cpu", "--mesh", "2x2", "--steps", "3",
                      "--global-batch", "8", "--seq-len", "16",
                      "--ckpt-dir", os.path.join(out_dir, "moe_cli"),
                      "--ckpt-every", "2"])
    out["cli/steps"] = np.asarray([r["step"] for r in log])
    out["cli/losses"] = np.asarray([r["loss"] for r in log])
    out["cli/all_to_all_s"] = np.asarray(
        [r["collective_kinds_s"].get("all_to_all", 0.0) for r in log])


# ---------------------------------------------------------------------------
# vlm: the smoke llava served and trained on a mesh
# ---------------------------------------------------------------------------


def vlm_serve(out, ref, meta, meshes):
    """The smoke llava through ``Server(cfg, mesh)`` on the JAX model's
    weights (f32): prefill and teacher-forced decode logits, the rank's
    cache, and ``generate``."""
    from repro_torch.launch.serve import Server
    from repro_torch.weights import shard_params
    cfg = get_smoke_config("llava-next-mistral-7b")
    for case, (m, _, prompt, steps) in meta["vlm_serve"].items():
        mesh = meshes[m]
        server = Server(cfg, mesh, device="cpu",
                        max_len=cfg.frontend_len + prompt + steps + 1)
        server.params = shard_params(_tree(ref, f"vlm_serve/{case}/params/"),
                                     cfg, mesh, device="cpu")
        batch = {k: ref[f"vlm_serve/{case}/{k}"]
                 for k in ("tokens", "extra_embeds")}
        forced = server._on_device(ref[f"vlm_serve/{case}/forced"])
        logits, cache = server.prefill(batch)
        outs = [logits]
        for t in range(steps):
            logits, cache = server.decode(cache, forced[:, t:t + 1])
            outs.append(logits)
        out[f"vlm_serve/{case}/logits"] = torch.stack(outs).numpy()
        out[f"vlm_serve/{case}/cache_k"] = np.asarray(cache["k"].shape)
        out[f"vlm_serve/{case}/params"] = np.asarray(
            sum(p.numel() for p in server.params.parameters()))
        out[f"vlm_serve/{case}/generated"] = server.generate(batch, steps)


def vlm_train(out, ref, meta, meshes, rank):
    """The smoke llava's mesh train step (:func:`mesh_steps`) on the JAX
    run's batches."""
    m, sharding, n = meta["vlm_train"]
    batches = [{k: ref[f"vlm_train/batches/{i}/{k}"]
                for k in ("tokens", "labels", "extra_embeds")}
               for i in range(n)]
    mesh_steps(out, ref, meta, "vlm_train",
               get_smoke_config("llava-next-mistral-7b"), meshes[m],
               sharding, 1, batches, meta["train_metrics"], rank)


# ---------------------------------------------------------------------------
# family, family_train: the enc-dec, SSM and hybrid on a mesh
# ---------------------------------------------------------------------------


def family_cfg(arch: str, vocab) -> ModelConfig:
    """A family case's smoke config, at ``vocab`` where given (the JAX
    run's ``family_cfg``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_variant
    if vocab is None:
        return get_smoke_config(arch)
    return smoke_variant(get_config(arch), vocab=vocab)


def _cache_shapes(cache: dict) -> dict:
    """Each cache leaf's shape by name (a ``MambaState``'s fields by
    theirs)."""
    out = {}
    for k, v in cache.items():
        if hasattr(v, "_fields"):
            out.update({f: tuple(getattr(v, f).shape) for f in v._fields})
        elif isinstance(v, torch.Tensor):
            out[k] = tuple(v.shape)
    return out


def family_serve(out, ref, meta, meshes):
    """Each case of ``meta["family_serve"]`` through ``Server(cfg, mesh)``
    on the JAX model's weights (f32): prefill and teacher-forced decode
    logits, the rank's cache shapes and the parameters it holds."""
    from repro_torch.launch.serve import Server
    from repro_torch.weights import shard_params
    for case, (arch, vocab, m, _, _, steps, max_len) in \
            meta["family_serve"].items():
        cfg, mesh = family_cfg(arch, vocab), meshes[m]
        server = Server(cfg, mesh, device="cpu", max_len=max_len)
        server.params = shard_params(_tree(ref, f"family/{case}/params/"),
                                     cfg, mesh, device="cpu")
        batch = {k: ref[f"family/{case}/{k}"] for k in ("tokens", "frames")
                 if f"family/{case}/{k}" in ref.files}
        forced = server._on_device(ref[f"family/{case}/forced"])
        logits, cache = server.prefill(batch)
        outs = [logits]
        for t in range(steps):
            logits, cache = server.decode(cache, forced[:, t:t + 1])
            outs.append(logits)
        out[f"family/{case}/logits"] = torch.stack(outs).numpy()
        out[f"family/{case}/cache"] = np.asarray(json.dumps(
            _cache_shapes(cache)))
        out[f"family/{case}/params"] = np.asarray(
            sum(p.numel() for p in server.params.parameters()))


def roundtrip(out, meshes):
    """``unshard(shard_tensor(p))`` of every parameter of every smoke
    config, on each mesh, under the serving and the FSDP training specs:
    the leaves that do not come back whole, and the head-wise ones."""
    from repro_torch.configs import list_archs
    from repro_torch.models.api import build
    from repro_torch.parallel.sharding import Segments, rank_spec
    bad, segmented = [], 0
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        whole = build(cfg).init(0, device="cpu")
        for m, mesh in meshes.items():
            for fsdp in (False, True):
                for n, p in whole.named_parameters():
                    spec = rank_spec(n, tuple(p.shape), cfg, mesh, fsdp=fsdp)
                    segmented += any(isinstance(a, Segments) for a in spec)
                    back = unshard(shard_tensor(p.data, spec, mesh), spec,
                                   mesh)
                    if not torch.equal(back, p.data):
                        bad.append(f"{arch} {m} {fsdp} {n}")
    out["roundtrip/bad"] = np.asarray(json.dumps(bad))
    out["roundtrip/segmented"] = np.asarray(segmented)


def family_train_steps(out, ref, meta, meshes, rank):
    """Each family case's 2 steps (:func:`mesh_steps`) on the JAX run's
    batches, with that family's metrics."""
    for case, (arch, vocab, m, sharding) in meta["family_train"].items():
        cfg = family_cfg(arch, vocab)
        prefix = f"family_train/{case}"
        n = len(ref[f"{prefix}/metrics"])
        batches = [_tree(ref, f"{prefix}/batches/{i}/") for i in range(n)]
        keys = (("loss", "ce", "grad_norm", "lr") if cfg.family == "encdec"
                else meta["train_metrics"])
        mesh_steps(out, ref, meta, prefix, cfg, meshes[m], sharding, 1,
                   batches, keys, rank)


def mamba_grads(out, ref, meta, meshes, rank):
    """One smoke Mamba2 block on a training mesh, (1, 4) under TP and
    (2, 2) under FSDP + TP: the rank's blocks of the JAX run's weights
    (gathered over the data axis as ``ShardCtx.gathered`` gathers them)
    on its rows of x, the gradients of ``sum(y * c)`` exchanged as the
    train step exchanges them and gathered whole (rank 0 writes them), x's
    gathered over the data axis."""
    import types
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch import steps
    from repro_torch.models import ssm
    from repro_torch.models.api import build
    from repro_torch.models.blocks import MAMBA_PARAMS
    cfg = get_smoke_config("mamba2-1.3b")
    names = [n for n in MAMBA_PARAMS if n != "ln"]    # the block's own
    whole = _tree(ref, "mamba_grad/params/")
    for m, sharding in (("1x4", "tp"), ("2x2", "fsdp_tp")):
        mesh = meshes[m]
        ctx = steps.make_ctx(build(cfg), mesh, CodesignPlan(
            sharding=sharding, seq_parallel=False), "ref", train=True)
        specs = {n: ctx.specs[f"layers/{n}"] for n in names}
        ws = [_t(shard_tensor(whole[n], specs[n], mesh)).requires_grad_(True)
              for n in names]
        layer = types.SimpleNamespace(**{
            n: ctx.gather_weight(w, specs[n]) for n, w in zip(names, ws)})
        x = _t(_rows(ref["mamba_grad/x"], mesh)).requires_grad_(True)
        c = _t(_rows(ref["mamba_grad/c"], mesh))
        y = ssm.mamba_block_train(x, layer, cfg, ctx=ctx)
        loss = coll.leave_region(torch.sum(y * c), mesh, "data")
        grads = torch.autograd.grad(loss, [x] + ws)
        gw = steps._exchange(grads[1:], [specs[n] for n in names], ctx)
        out[f"mamba_grad/{m}/loss"] = np.asarray(float(loss.detach()))
        out[f"mamba_grad/{m}/x"] = coll.all_gather(grads[0], mesh,
                                                   "data").numpy()
        for n, g in zip(names, gw):
            w = unshard(g, specs[n], mesh).numpy()
            if rank == 0:
                out[f"mamba_grad/{m}/{n}"] = w


def family_checkpoints(out, ref, meta, meshes, out_dir):
    """The JAX run's (2, 2) FSDP + TP mamba2 checkpoint restored by the
    port's ``Trainer`` at (1, 4) under TP (the head-wise blocks of each
    leaf), and its next step on the batch after the JAX run's; and a mesh
    save of a (2, 2) trainer's fresh state (rank 0 writes the gathered
    leaves under ``OUTDIR/mamba_save``)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch.train import Trainer
    case = meta["family_ckpt"]
    arch, vocab, _, _ = meta["family_train"][case]
    cfg = family_cfg(arch, vocab)
    m, sharding = meta["family_elastic"]
    t = Trainer(cfg, meshes[m], plan=CodesignPlan(sharding=sharding,
                                                  seq_parallel=False),
                device="cpu", ckpt_dir=str(ref["family_ckpt/root"]))
    t.init_state(9)
    assert t.try_restore(), "no checkpoint restored"
    _restored(out, "family_ckpt/restored", t)
    rows = {k: _t(_rows(v, t.mesh))
            for k, v in _tree(ref, "family_ckpt/batch/").items()}
    _, _, mt = t.train_step(t.params.float(), t.opt_state, rows)
    out["family_ckpt/next"] = np.asarray([float(mt[k])
                                          for k in meta["train_metrics"]])
    s = Trainer(cfg, meshes["2x2"], device="cpu")
    s.init_state(5)
    ck = CheckpointManager(os.path.join(out_dir, "mamba_save"), mesh=s.mesh)
    ck.maybe_save(1, s.state_tree(), force=True,
                  shardings=s.state_shardings())
    ck.wait()


def family_cli(out, out_dir):
    """The CLI trains the smoke seamless on the (2, 2) mesh (``train.main``,
    in this world): 2 steps, its frames split over the data axis."""
    from repro_torch.launch import train
    log = train.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                      "--device", "cpu", "--mesh", "2x2", "--backend",
                      "gloo", "--steps", "2", "--global-batch", "8",
                      "--seq-len", "16"])
    out["cli/steps"] = np.asarray([r["step"] for r in log])
    out["cli/losses"] = np.asarray([r["loss"] for r in log])


# ---------------------------------------------------------------------------
# seq_parallel: Megatron sequence parallelism
# ---------------------------------------------------------------------------


#: the sequence collectives' inputs: each rank's chunk (B, S/m, D) on a
#: model axis of 4
SEQ_CHUNK = (1, 2, 3)


def seq_inputs(rank: int):
    """Rank ``rank``'s chunk x, its partial sums over the whole sequence
    xs, and the weights w (the chunk's shape) and ws (the whole
    sequence's) of its losses."""
    rng = np.random.default_rng(200 + rank)
    b, c, d = SEQ_CHUNK
    whole = (b, 4 * c, d)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in (SEQ_CHUNK, whole, SEQ_CHUNK, whole))


def seq_collectives(out, mesh, rank):
    """``gather_seq`` and ``scatter_seq`` on the (1, 4) mesh, each pair
    member: the output and the gradient of the rank's ``sum(w * f(x))``.
    Where the region is computed whole (``partial=False``) the members'
    loss is one replicated loss, and each uses the model group's first
    member's weights and, for the scatter, its input."""
    from repro_torch.parallel import collectives as coll
    x, xs, w, ws = seq_inputs(rank)
    _, xs0, _, ws0 = seq_inputs(0)
    cases = {
        "gather_partial": (lambda t: coll.gather_seq(t, mesh, "model",
                                                     partial=True), x, ws),
        "gather_whole": (lambda t: coll.gather_seq(t, mesh, "model",
                                                   partial=False), x, ws0),
        "scatter_partial": (lambda t: coll.scatter_seq(t, mesh, "model",
                                                       partial=True), xs, w),
        "scatter_whole": (lambda t: coll.scatter_seq(t, mesh, "model",
                                                     partial=False), xs0,
                          w),
    }
    for name, (fn, xin, win) in cases.items():
        t = _t(xin).requires_grad_(True)
        y = fn(t)
        (g,) = torch.autograd.grad(torch.sum(_t(win) * y), t)
        out[f"seqcoll/{name}/y"] = y.detach().numpy()
        out[f"seqcoll/{name}/grad"] = g.numpy()


def sp_cfg(name: str, meta) -> ModelConfig:
    """The config of the JAX run's ``SP_FAMILIES`` entry ``name``."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_variant
    arch, over, chunk = meta["sp_families"][name]
    cfg = smoke_variant(get_config(arch), **over)
    if chunk is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=chunk))
    return cfg


def _sp_plan(sharding: str, sp: bool):
    from repro_torch.core.codesign import CodesignPlan
    return CodesignPlan(sharding=sharding, seq_parallel=sp)


def sp_serve(out, ref, meta, meshes, name, cfg):
    """``name``'s prompts through ``Server(cfg, mesh, plan=...)`` on each
    mesh (:func:`sp_serve_case`)."""
    for m in meta["sp_meshes"]:
        for S in meta["sp_prompts"]:
            case = f"{name}-{m}-{S}"
            batch = _tree(ref, f"sp/serve/{case}/")
            batch.pop("logits")
            sp_serve_case(out, ref, meta, meshes[m], cfg,
                          f"sp/params/{name}/", batch, f"sp/serve/{case}")


def _kept_records(out, prefix: str, log) -> None:
    """The kept pairs of each capacity call of ``log`` (a ``RouteLog``):
    ``<prefix>/<i>/keep`` (the rank's tokens, k) and ``<prefix>/<i>/span``
    (the first token's index, the layer's token count)."""
    out[f"{prefix}/calls"] = np.asarray(len(log.kept))
    for i, (keep, first, total) in enumerate(log.kept):
        out[f"{prefix}/{i}/keep"] = keep.numpy()
        out[f"{prefix}/{i}/span"] = np.asarray([first, total])


def sp_serve_case(out, ref, meta, mesh, cfg, params: str, batch: dict,
                  prefix: str, routes: bool = False):
    """``batch`` through ``Server(cfg, mesh, plan=...)`` with and without
    sequence parallelism on the JAX model's weights (f32, the entries
    under ``params``): the prefill logits and 2 teacher-forced decode
    steps' (``<prefix>/sp`` / ``nosp``), the collectives' seconds of
    kinds ``"seq"`` and ``"qseq"`` over the prefill, and the query rows
    attention was fed in the prefill and in the decode steps
    (:func:`_query_rows`); with ``routes`` the pairs each MoE layer of
    the prefill kept (:func:`_kept_records`)."""
    from repro_torch.launch.serve import Server
    from repro_torch.models import blocks
    from repro_torch.weights import shard_params
    forced = np.random.default_rng(7).integers(
        0, cfg.vocab, (len(batch["tokens"]), 2), dtype=np.int32)
    for sp in (True, False):
        server = Server(cfg, mesh, device="cpu",
                        max_len=meta["sp_max_len"],
                        plan=_sp_plan("tp", sp))
        server.params = shard_params(_tree(ref, params), cfg, mesh,
                                     device="cpu")
        if routes:
            log = ffn.RouteLog()
            server.ctx = dataclasses.replace(server.ctx, routes=log)
        blocks.reset_query_rows()
        before = coll.spent()
        logits, cache = server.prefill(batch)
        kinds = coll.spent_since(before)["kinds"]
        rows = _query_rows()
        run = f"{prefix}/{'sp' if sp else 'nosp'}"
        if routes:
            _kept_records(out, f"{run}/kept", log)
        blocks.reset_query_rows()
        outs = [logits]
        for t in range(2):
            logits, cache = server.decode(
                cache, server._on_device(forced[:, t:t + 1]))
            outs.append(logits)
        out[f"{run}/logits"] = torch.stack(outs).numpy()
        out[f"{run}/seq_s"] = np.asarray(kinds.get("seq", 0.0))
        out[f"{run}/qseq_s"] = np.asarray(kinds.get("qseq", 0.0))
        out[f"{run}/qrows"] = rows
        out[f"{run}/decode_qrows"] = _query_rows()


def sp_train(out, ref, meta, meshes, rank, name, cfg):
    """``name``'s 2 train steps on each mesh (:func:`sp_train_case`)."""
    keys = (("loss", "ce", "grad_norm", "lr") if cfg.family == "encdec"
            else meta["train_metrics"])
    for m in meta["sp_meshes"]:
        case = f"{name}-{m}"
        batches = [_tree(ref, f"sp/train/{case}/batches/{i}/")
                   for i in range(2)]
        sp_train_case(out, ref, meta, meshes[m], rank, cfg,
                      f"sp/params/{name}/", batches, f"sp/train/{case}",
                      keys)


def sp_train_case(out, ref, meta, mesh, rank, cfg, params: str,
                  batches: list, prefix: str, keys, routes: bool = False):
    """2 train steps under ``CodesignPlan(sharding="fsdp_tp",
    seq_parallel=...)`` on ``mesh`` over ``batches``, from the JAX
    model's weights (the entries under ``params``) on the rank's shards
    and rows, with and without sequence parallelism (``<prefix>/sp`` /
    ``nosp``): the metrics ``keys``, the values the checkpointed layer
    bodies kept, the collectives' seconds of kinds ``"seq"`` and
    ``"qseq"`` and the query rows attention was fed (:func:`_query_rows`)
    each step, and (rank 0) step 1's gradients after the exchange and the
    final weights, gathered whole; with ``routes`` the pairs each MoE
    layer kept in step 1's forward (:func:`_kept_records`, a forward of
    the loss under a ``RouteLog`` before the steps)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import blocks
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.api import build
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.weights import (jax_tree, param_names, param_shapes,
                                     param_spec, shard_params)
    from repro_torch.tree import map_leaves
    update = steps_lib.adamw_update
    for sp in (True, False):
        plan = _sp_plan("fsdp_tp", sp)
        run = f"{prefix}/{'sp' if sp else 'nosp'}"
        lm = shard_params(_tree(ref, params), cfg, mesh, device="cpu",
                          plan=plan, trainable=True)
        if routes:
            log = ffn.RouteLog()
            ctx = dataclasses.replace(steps_lib.make_ctx(
                build(cfg), mesh, plan, "ref", train=True), routes=log)
            with torch.no_grad():
                build(cfg).loss(lm, {k: _t(_rows(v, mesh))
                                     for k, v in batches[0].items()}, ctx)
            _kept_records(out, f"{run}/kept", log)
        opt = adamw_init(lm.parameters())
        step, _ = steps_lib.make_train_step(
            build(cfg), mesh, plan, lr_peak=meta["train_lr"], warmup=1,
            total_steps=10)
        grads: list = []

        def first(g, *a, **k):
            if not grads:
                grads.extend(x.detach().clone() for x in g)
            return update(g, *a, **k)
        steps_lib.adamw_update = first
        metrics, kept, seq_s, qseq_s = [], [], [], []
        try:
            for i, b in enumerate(batches):
                lm_lib.reset_kept()
                blocks.reset_query_rows()
                before = coll.spent()
                lm, opt, mt = step(lm, opt, {k: _t(_rows(v, mesh))
                                             for k, v in b.items()})
                kinds = coll.spent_since(before)["kinds"]
                seq_s.append(kinds.get("seq", 0.0))
                qseq_s.append(kinds.get("qseq", 0.0))
                out[f"{run}/qrows/{i}"] = _query_rows()
                kept.append(lm_lib.kept_values())
                metrics.append([float(mt[k]) for k in keys])
        finally:
            steps_lib.adamw_update = update
        out[f"{run}/metrics"] = np.asarray(metrics)
        out[f"{run}/kept"] = np.asarray(kept)
        out[f"{run}/seq_s"] = np.asarray(seq_s)
        out[f"{run}/qseq_s"] = np.asarray(qseq_s)
        shapes, names = param_shapes(cfg), param_names(lm)
        whole = [unshard(g, param_spec(n, shapes[n], cfg, mesh, plan),
                         mesh) for n, g in zip(names, grads)]
        final = _gather_params(lm, cfg, mesh, plan)
        if rank == 0:
            tree = map_leaves(host_array, jax_tree(whole, names))
            for path, v in flatten_with_paths(tree):
                out[f"{run}/grads/{path}"] = v
            for path, v in flatten_with_paths(final):
                out[f"{run}/final/{path}"] = v


def _query_rows() -> np.ndarray:
    """``blocks.query_rows()`` as rows (first, end, S, calls), sorted;
    (0, 4) where no attention call ran."""
    from repro_torch.models import blocks
    rows = sorted(k + (n,) for k, n in blocks.query_rows().items())
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def seq_parallel(out, ref, meta, meshes, rank):
    """The sequence collectives, then each family of the JAX run's
    ``SP_FAMILIES`` served and trained (:func:`sp_serve`,
    :func:`sp_train`)."""
    seq_collectives(out, meshes["1x4"], rank)
    for name in meta["sp_families"]:
        cfg = sp_cfg(name, meta)
        sp_serve(out, ref, meta, meshes, name, cfg)
        sp_train(out, ref, meta, meshes, rank, name, cfg)


def moe_sp_cfg(meta, case: str) -> ModelConfig:
    """The smoke config of the JAX run's ``MOE_SP_CASES`` entry ``case``."""
    arch, _, experts, cf = meta["moe_sp"][case]
    cfg = get_smoke_config(arch)
    over = {k: v for k, v in (("n_experts", experts),
                              ("capacity_factor", cf)) if v is not None}
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **over))


def moe_seq_parallel(out, ref, meta, meshes, rank):
    """Each case of the JAX run's ``MOE_SP_CASES`` served at each prompt
    length and trained for 2 steps, with and without sequence
    parallelism (:func:`sp_serve_case`, :func:`sp_train_case`), with the
    pairs each MoE layer's shard kept."""
    keys = meta["train_metrics"]
    for case, (_, m, _, _) in meta["moe_sp"].items():
        cfg, mesh = moe_sp_cfg(meta, case), meshes[m]
        params = f"msp/params/{case}/"
        for S in meta["sp_prompts"]:
            key = f"msp/serve/{case}-{S}"
            sp_serve_case(out, ref, meta, mesh, cfg, params,
                          {"tokens": ref[f"{key}/tokens"]}, key,
                          routes=True)
        batches = [_tree(ref, f"msp/train/{case}/batches/{i}/")
                   for i in range(2)]
        sp_train_case(out, ref, meta, mesh, rank, cfg, params, batches,
                      f"msp/train/{case}", keys, routes=True)


def main() -> None:
    job, rank, world, port, ref_path, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    # one thread each, the whole world on one core (the JAX run's: one a
    # job), at a lower priority: the ranks share the host with wall-clock
    # tests in other workers
    os.nice(10)
    os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[
        {"mesh": -1, "gpipe": -2, "moe_train": -4, "vlm": -5, "family": -6,
         "family_train": -7, "seq_parallel": -8,
         "moe_seq_parallel": -10}.get(job, -3)
        % len(os.sched_getaffinity(0))]})
    torch.set_num_threads(1)
    init_world("gloo", rank=rank, world_size=world,
               init_method=f"tcp://127.0.0.1:{port}", timeout_s=60)
    ref = np.load(ref_path)
    meta = json.loads(str(ref["meta"]))
    out: dict = {}
    if job == "mesh":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        moe(out, ref, meta, meshes)
        collectives(out, ref, meta, meshes, rank)
        serve(out, ref, meta, meshes)
    elif job == "gpipe":
        gpipe(out, ref, meta)
    elif job == "train":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        grad_collectives(out, meshes["2x2"], rank)
        train_steps(out, ref, meta, meshes, rank)
        masked_grads(out, ref, meta, meshes, rank)
        elastic(out, ref, meta, meshes, rank, out_dir)
        failure(out, meshes, rank, out_dir)
    elif job == "moe_train":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        moe_grads(out, ref, meta, meshes, rank)
        moe_train_steps(out, ref, meta, meshes, rank)
        moe_recompute(out, ref, meta, meshes)
        moe_checkpoints(out, ref, meta, meshes, out_dir)
        moe_cli(out, out_dir)
    elif job == "vlm":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        vlm_serve(out, ref, meta, meshes)
        vlm_train(out, ref, meta, meshes, rank)
    elif job == "family":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        family_serve(out, ref, meta, meshes)
        roundtrip(out, meshes)
    elif job == "family_train":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        family_train_steps(out, ref, meta, meshes, rank)
        mamba_grads(out, ref, meta, meshes, rank)
        family_checkpoints(out, ref, meta, meshes, out_dir)
        family_cli(out, out_dir)
    elif job == "seq_parallel":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        seq_parallel(out, ref, meta, meshes, rank)
    elif job == "moe_seq_parallel":
        meshes = {n: make_mesh(s, ("data", "model"))
                  for n, s in MESHES.items()}
        moe_seq_parallel(out, ref, meta, meshes, rank)
    else:
        raise SystemExit(f"unknown job {job!r}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
