"""Training on a mesh: the port's ranks against the JAX package's mesh run.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
train``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32 where values are
compared with a tolerance:

* ``make_train_step`` over the mesh for 2 steps from the JAX model's
  weights on the same batches (B 8, S 16, lr 1e-3): smoke smollm (4/1
  heads: the KV head held whole) at (2, 2) under FSDP + TP, smoke phi3 at
  (1, 4) under TP, smoke smollm at (4, 1) under FSDP with 2 microbatches;
  and the port's one-device step on the whole batches;
* the loss and the gradients of a batch whose ``loss_mask`` keeps a
  different share of each row (so of each rank's rows): the global token
  mean, against the JAX loss of the whole batch;
* each collective that carries gradients, against the gradient of the
  same function in one process;
* the JAX ``Trainer``'s (2, 2) checkpoint restored by the port's
  ``Trainer`` at (4, 1) and on one device, bit for bit; the restored state
  saved again from the mesh (rank 0 writes) with the reference's shard
  bytes, read back by the JAX package's ``load_checkpoint``;
* an injected failure through the CLI's ``--mesh`` path: every rank
  restores the same step, and a trainer restored from that checkpoint and
  fed the same batches reproduces the losses after the restore exactly;
* each rank's rows of the input feed against the JAX pipeline's global
  batch.

Tolerances (f32; each against what was seen):
- the step metrics (loss, ce, grad norm, lr): rtol 1e-6 (seen 1.6e-7:
  f32 sums in other orders);
- the masked gradients: 5e-6 of each leaf's largest magnitude (seen
  9.5e-7), the masked loss rtol 1e-6;
- the weights after 2 steps: Adam moves a weight by about
  ``lr * g / (|g| + 1e-8)``, so where ``|g|`` is near 0 an f32 error in
  ``g`` moves the update by a share of lr.  So: at most 1e-4 of the
  elements beyond 1e-6 (seen 13 of 197,184), none beyond lr (seen
  8.4e-5), and the mean error under 1e-5 of the mean distance moved
  (seen 1.5e-6);
- the collectives' gradients: 1e-6 (sums of a few f32 values).
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_mesh_ranks import (GRAD_SHAPE, MESHES, WORLD, _loss_mask,
                              _train_batches, _tree, grad_inputs, run_world)

from repro_torch.checkpoint import manager as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.codesign import CodesignPlan
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding
from repro_torch.tree import flatten_with_paths, host_array
from repro_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

METRICS = ("loss", "ce", "grad_norm", "lr")
METRIC_RTOL = 1e-6
GRAD_SHARE = 5e-6
STRAY, STRAY_SHARE, MEAN_SHARE = 1e-6, 1e-4, 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    try:
        ref, ranks, _ = run_world("train", out, timeout_s=420.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"])), out


def _prefix(npz, prefix: str) -> dict:
    return {k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)}


def _coords(rank: int, mesh: str) -> dict:
    _, m = MESHES[mesh]
    return {"data": rank // m, "model": rank % m}


def _check_weights(got: dict, want: dict, init: dict, lr: float, what: str):
    assert got.keys() == want.keys(), what
    errs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    moved = np.concatenate([np.abs(want[k] - init[k]).ravel()
                            for k in want])
    assert (errs > STRAY).mean() <= STRAY_SHARE, (what, (errs > STRAY).sum())
    assert errs.max() <= lr, (what, errs.max())
    assert errs.mean() <= MEAN_SHARE * moved.mean(), (what, errs.mean())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_mesh_train_step_matches_reference_mesh(world):
    """Each case's metrics on every rank, and every gathered weight after
    2 steps, against the JAX package's mesh run."""
    ref, ranks, meta, _ = world
    for case in meta["train"]:
        want = ref[f"train/{case}/metrics"]
        for r in ranks:
            np.testing.assert_allclose(r[f"train/{case}/metrics"], want,
                                       rtol=METRIC_RTOL, err_msg=case)
        _check_weights(_prefix(ranks[0], f"train/{case}/final/"),
                       _prefix(ref, f"train/{case}/final/"),
                       _prefix(ref, f"train/{case}/params/"),
                       meta["train_lr"], case)


def test_ranks_hold_their_blocks_not_the_model(world):
    """Under FSDP each rank holds a quarter of every matrix (the (2, 2)
    case: a half over data, a half of wq / wo / w_* / the vocab over the
    model axis, wk / wv whole over it); under TP the matrices split four
    ways over the model axis (phi3's 4 heads divide it)."""
    ref, ranks, meta, _ = world
    for case in meta["train"]:
        whole = sum(v.size for v in _prefix(ref, f"train/{case}/params/")
                    .values())
        held = [int(r[f"train/{case}/params_held"]) for r in ranks]
        assert len(set(held)) == 1, case
        assert held[0] < 0.45 * whole, (case, held[0], whole)


def test_one_device_step_matches_reference_mesh(world):
    """The port's one-device step on the whole batches, from the same
    weights, against the JAX package's mesh run (f32)."""
    ref, _, meta, _ = world
    B, S = meta["train_batch"]
    for case, (arch, _, _, micro) in meta["train"].items():
        cfg = get_smoke_config(arch)
        lm = from_jax_params(_tree(ref, f"train/{case}/params/"), cfg,
                             device="cpu", trainable=True)
        opt = adamw_init(lm.parameters())
        step, _ = make_train_step(build(cfg), microbatches=micro,
                                  lr_peak=meta["train_lr"], warmup=1,
                                  total_steps=10)
        got = []
        for b in _train_batches(cfg.vocab, 2, B, S):
            lm, opt, m = step(lm, opt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            got.append([float(m[k]) for k in METRICS])
        np.testing.assert_allclose(got, ref[f"train/{case}/metrics"],
                                   rtol=METRIC_RTOL, err_msg=case)
        _check_weights(dict(flatten_with_paths(to_jax_params(lm))),
                       _prefix(ref, f"train/{case}/final/"),
                       _prefix(ref, f"train/{case}/params/"),
                       meta["train_lr"], case)


def test_masked_loss_is_the_global_token_mean(world):
    """With a mask that keeps 15% to 95% of a row, each data rank's rows
    count differently: the loss is the masked sum over every rank's
    tokens over their count (the JAX loss of the whole batch), and so are
    the exchanged gradients, not a mean of the ranks' means."""
    ref, ranks, meta, _ = world
    B, S = meta["train_batch"]
    mask = _loss_mask(B, S)
    halves = mask.reshape(2, B // 2, S).sum(axis=(1, 2))
    assert halves[0] < 0.7 * halves[1]          # the data ranks differ
    for r in ranks:
        np.testing.assert_allclose(r["masked/loss"], ref["masked/loss"],
                                   rtol=METRIC_RTOL)
    got = _prefix(ranks[0], "masked/grads/")
    want = _prefix(ref, "masked/grads/")
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_SHARE * np.abs(w).max(), k


# ---------------------------------------------------------------------------
# The collectives' gradients
# ---------------------------------------------------------------------------


def test_collectives_carry_gradients(world):
    """The gradient of ``sum(w * f(x))`` on each rank of the (2, 2) mesh,
    against the one-process gradient: ``fsdp_gather`` sums the data
    group's weights and returns this rank's rows; ``enter_region`` sums
    the model group's; ``leave_region`` (a result every member shares, so
    one loss) passes the shared gradient, unscaled by the model axis's
    2."""
    _, ranks, _, _ = world
    r_, c_ = GRAD_SHAPE
    w = {r: grad_inputs(r)[1] for r in range(WORLD)}
    x = {r: grad_inputs(r)[0] for r in range(WORLD)}
    for r, out in enumerate(ranks):
        d, m = _coords(r, "2x2").values()
        group_d = [dd * 2 + m for dd in range(2)]
        group_m = [d * 2 + mm for mm in range(2)]
        first = d * 2
        want = {
            "fsdp_gather": sum(w[q][:4, :c_] for q in group_d)[
                d * r_:(d + 1) * r_],
            "enter_region": sum(w[q][:r_, :c_] for q in group_m),
            "leave_region": w[first][:r_, :c_],
        }
        ys = {
            "fsdp_gather": np.concatenate([x[q] for q in group_d]),
            "enter_region": x[r],
            "leave_region": sum(x[q] for q in group_m),
        }
        for name in want:
            np.testing.assert_allclose(out[f"grad/{name}"], want[name],
                                       atol=1e-6, err_msg=f"{name} {r}")
            np.testing.assert_allclose(out[f"grad/{name}/y"], ys[name],
                                       atol=1e-6, err_msg=f"{name} y {r}")
        # a psum in leave_region's backward would double its gradient
        assert not np.allclose(out["grad/leave_region"],
                               2 * want["leave_region"])


# ---------------------------------------------------------------------------
# Checkpoints: the elastic restore, the mesh save
# ---------------------------------------------------------------------------


def _saved(root: str, step: int) -> dict:
    """A checkpoint's leaves by path, as ``np.load`` reads them."""
    d = ck._ckpt_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    return {leaf["path"]: np.load(os.path.join(d, leaf["file"]))
            for leaf in meta["leaves"]}


def _manifest(root: str, step: int) -> dict:
    with open(os.path.join(ck._ckpt_dir(root, step), "manifest.json")) as f:
        return json.load(f)


def _train_spec_of(path: str, shape, cfg, mesh, fsdp: bool = True) -> tuple:
    """What a rank holds of a checkpoint leaf (under FSDP unless told
    otherwise): a parameter's train spec (a stacked leaf leads with None),
    the AdamW master and moments their parameter's; the step whole."""
    parts = path.split("/")
    if parts[0] == "opt":
        if parts[1] == ".step":
            return ()
        parts = parts[2:]
    else:
        parts = parts[1:]
    name = "/".join(parts)
    stacked = parts[0] in sharding.STACKED
    per = tuple(shape[1:]) if stacked else tuple(shape)
    spec = sharding.rank_spec(name, per, cfg, mesh, fsdp=fsdp)
    return ((None,) + spec) if stacked else spec


def test_reference_checkpoint_restores_onto_4x1_bit_exact(world):
    """The JAX trainer's (2, 2) checkpoint, restored by the port's ranks at
    (4, 1) under FSDP: every rank restores its step, and each leaf it
    holds is its block of the saved leaf, bit for bit."""
    ref, ranks, _, _ = world
    root, step = str(ref["ckpt/root"]), int(ref["ckpt/step"])
    saved = _saved(root, step)
    cfg = get_smoke_config("smollm-360m")
    split = 0
    for r, out in enumerate(ranks):
        assert int(out["elastic/step"]) == step
        mesh = Mesh({"data": 4, "model": 1}, ("data", "model"), rank=r,
                    coords=_coords(r, "4x1"))
        got = _prefix(out, "elastic/state/")
        assert got.keys() == saved.keys()
        for path, whole in saved.items():
            spec = _train_spec_of(path, whole.shape, cfg, mesh)
            split += any(spec)
            block = whole[sharding.shard_slices(whole.shape, spec, mesh)]
            assert got[path].tobytes() == np.ascontiguousarray(
                block).tobytes(), (r, path)
    assert split > 0                     # the ranks held blocks, not copies


def test_reference_checkpoint_restores_onto_one_device(world):
    """The same checkpoint through the port's one-device ``Trainer``."""
    from repro_torch.launch.train import Trainer
    ref, _, _, _ = world
    root, step = str(ref["ckpt/root"]), int(ref["ckpt/step"])
    t = Trainer(get_smoke_config("smollm-360m"), device="cpu", ckpt_dir=root)
    t.init_state(7)
    assert t.try_restore() and t.step_idx == step
    saved = _saved(root, step)
    for path, v in flatten_with_paths(t.state_tree()):
        assert host_array(v).tobytes() == saved[path].tobytes(), path


def test_mesh_save_has_the_reference_bytes(world, tmp_path):
    """The ranks' save of the restored state (rank 0 writes the gathered
    leaves): every shard's SHA-256 equals the JAX checkpoint's and a
    one-device save's, and the manifest equals the JAX one but for
    ``treedef`` and ``wall_time``; the JAX package's loader reads it."""
    import jax
    from repro.checkpoint import manager as jck
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models.api import build as jbuild
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro_torch.launch.train import Trainer
    ref, _, _, out = world
    root, step = str(ref["ckpt/root"]), int(ref["ckpt/step"])
    mine = os.path.join(out, "port_ckpt")
    want, got = _manifest(root, step), _manifest(mine, step)
    for m in (want, got):
        m.pop("treedef")
        m.pop("wall_time")
    assert got == want
    t = Trainer(get_smoke_config("smollm-360m"), device="cpu", ckpt_dir=root)
    t.init_state(0)
    assert t.try_restore()
    ck.save_checkpoint(str(tmp_path), step, t.state_tree())
    one = _manifest(str(tmp_path), step)
    assert [l["sha256"] for l in one["leaves"]] == \
        [l["sha256"] for l in got["leaves"]]
    params = jbuild(jget_smoke("smollm-360m")).init(jax.random.PRNGKey(0))
    like = jax.tree.map(np.asarray, {"params": params,
                                     "opt": jadamw_init(params)})
    back = jck.load_checkpoint(mine, step, like)
    saved = _saved(root, step)
    for p, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        arr = np.asarray(v)
        assert arr.tobytes() == saved[jck._leaf_path_str(p)].tobytes()


# ---------------------------------------------------------------------------
# Failure and resume, the input feed
# ---------------------------------------------------------------------------


def test_injected_failure_restores_one_step_on_every_rank(world):
    """The CLI's ``--mesh 2x2`` run, a failure injected after step 3: every
    rank logs steps 1-3, restores step 2 (rank 0 chose it after its save
    committed) and logs 3-5 again, with the same losses; a trainer
    restored from the step-2 checkpoint and fed the batches the run fed
    after its restore reproduces those losses exactly."""
    _, ranks, _, _ = world
    for r in ranks:
        assert r["fail/steps"].tolist() == [1, 2, 3, 3, 4, 5]
        np.testing.assert_array_equal(r["fail/losses"],
                                      ranks[0]["fail/losses"])
        assert r["fail/resumed_steps"].tolist() == [3, 4, 5]
        np.testing.assert_array_equal(r["fail/resumed_losses"],
                                      r["fail/losses"][3:])
    assert np.isfinite(ranks[0]["fail/losses"]).all()


def test_input_feed_gives_each_rank_its_rows(world):
    """Each rank's rows are its data coordinate's block of the JAX
    pipeline's global batch; ranks that share it get the same rows."""
    ref, ranks, _, _ = world
    for what in ("tokens", "labels"):
        whole = ref[f"feed/{what}"]
        n = whole.shape[1] // 2
        for r, out in enumerate(ranks):
            d = _coords(r, "2x2")["data"]
            np.testing.assert_array_equal(out[f"feed/{what}"],
                                          whole[:, d * n:(d + 1) * n])


# ---------------------------------------------------------------------------
# In process: the training specs, what a training mesh refuses
# ---------------------------------------------------------------------------


def test_train_spec_is_the_fsdp_table_with_no_head_split():
    """The rule table with FSDP's data entries; an attention weight whose
    heads do not divide the model axis keeps only its data entry; a model
    axis of 1 drops the model entries; without FSDP, no data entries."""
    spec = lambda cfg, name, shape, mesh, fsdp=True: sharding.rank_spec(
        name, shape, cfg, Mesh.abstract(mesh, ("data", "model")), fsdp=fsdp)
    smoke = get_smoke_config("smollm-360m")       # 4 / 1 heads
    assert spec(smoke, "layers.0.attn.wq", (64, 64), (2, 2)) == \
        ("data", "model")
    assert spec(smoke, "layers.0.attn.wk", (64, 16), (2, 2)) == \
        ("data", None)
    full = get_config("smollm-360m")              # 15 / 5 heads
    assert spec(full, "layers.0.attn.wq", (960, 960), (2, 2)) == \
        ("data", None)
    assert spec(full, "layers.0.attn.wo", (960, 960), (2, 2)) == \
        (None, "data")
    assert spec(full, "layers.0.mlp.w_down", (2560, 960), (2, 2)) == \
        ("model", "data")
    assert spec(full, "embed", (49152, 960), (4, 1)) == (None, "data")
    assert spec(full, "embed", (49152, 960), (1, 4), fsdp=False) == \
        ("model", None)
    assert spec(full, "layers.0.ln1", (960,), (2, 2)) == (None,)


def test_training_mesh_refusals():
    """No family is refused a mesh any more: every config makes its
    training and serving contexts on (1, 4), (2, 2) and (4, 1) and its
    rank's decode cache under them, and the enc-dec draws through
    ``keep``; the mesh trainer without a card raises unless asked for the
    CPU; a world whose backend fails to start raises (no other backend is
    tried); a plan with sequence parallelism is taken for every config,
    one with MoE layers too."""
    import torch.distributed as dist
    from repro_torch.configs import list_archs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import free_port, init_world
    from repro_torch.launch.train import Trainer
    plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=False)
    mesh = Mesh({"data": 2, "model": 2}, ("data", "model"), rank=0,
                coords={"data": 0, "model": 0}, groups={})
    for arch in list_archs():
        api = build(get_smoke_config(arch))
        for shape in ((1, 4), (2, 2), (4, 1)):
            m = Mesh({"data": shape[0], "model": shape[1]},
                     ("data", "model"), rank=0,
                     coords={"data": 0, "model": 0}, groups={})
            for train in (True, False):
                ctx = steps.make_ctx(api, m, plan, "ref", train=train)
                cache = api.init_cache(1, 32, ctx, device="cpu", enc_len=16)
                assert cache["pos"] == 0, (arch, shape, train)
    seamless = get_smoke_config("seamless-m4t-large-v2")
    kept = []
    build(seamless).init(0, device="cpu",
                         keep=lambda name, t: kept.append(name) or t)
    assert sorted(kept) == sorted(n for n, _ in build(seamless).init(
        0, device="cpu").named_parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(get_smoke_config("smollm-360m"), mesh)
        with pytest.raises(RuntimeError, match="NCCL"):
            init_world("nccl", rank=0, world_size=1, timeout_s=10,
                       init_method=f"tcp://127.0.0.1:{free_port()}")
        assert not dist.is_initialized()
    for arch in ("qwen3-moe-30b-a3b", "smollm-360m"):
        assert make_train_step(build(get_smoke_config(arch)), mesh,
                               CodesignPlan(seq_parallel=True)
                               )[1].seq_parallel, arch
