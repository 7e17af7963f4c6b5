"""The MoE family on a training mesh: the port's ranks against the JAX
package's mesh run.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
moe_train``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32:

* the gradients of ``moe_ep`` and ``moe_tp`` (one layer of 8 experts, top
  2, on 2 x 16 tokens; meshes (1, 4) and (2, 2); capacity factors 8.0,
  at which nothing drops, and 1.25) of ``sum(y * c)``, of the
  load-balance term and of the router z term, each alone, with respect to
  x, the router and the three expert weights, against ``jax.grad`` of
  the reference's path on the same mesh.  A rank that routes only its
  own tokens holds a part of the router's gradient (EP); under TP every
  model rank routes the same tokens and holds all of it: summing it over
  the model axis, or reduce-scattering the gradient of the gathered
  output, would be off by the model axis's size here;
* ``make_train_step`` for 2 steps from the JAX model's weights on the
  same batches (B 8, S 16, lr 1e-3): smoke mixtral (4 experts) at (2, 2)
  under FSDP + TP (EP, the experts' D split over data), smoke qwen3 with
  6 experts at (1, 4) under TP (``moe_tp``), smoke qwen3 (4 experts) at
  (4, 1) under FSDP with 2 microbatches (the aux terms the last
  microbatch's, the loss their mean);
* the recompute of a gathered layer in the backward pass routes as the
  forward did;
* the reference's checkpoints of the first two cases' final state: the
  EP + FSDP (2, 2) one restored by the port at (1, 4) and on one device,
  the TP one restored onto its own layout; each saved again from the
  port's mesh with the reference's bytes, and the TP-layout save restored
  at (2, 2) under EP + FSDP; each elastic restore's next step against the
  reference's step on that layout from the same state (in f32);
* the CLI's ``--mesh 2x2`` on the smoke qwen3.

Tolerances (f32; each against what was seen):
- the layer gradients: 5e-6 of each gradient's largest magnitude (seen
  1.4e-6); a gradient the reference gives as zero is zero; the terms
  themselves rtol 1e-6 (seen 4.7e-7);
- the step metrics (loss, ce, load balance, router z, grad norm, lr):
  rtol 1e-6 (seen 2.0e-7; the step after an elastic restore 1.4e-7), as
  ``tests/test_torch_mesh_train.py``;
- the weights after 2 steps: as ``tests/test_torch_mesh_train.py``
  (``_check_weights``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_torch_mesh_train import (_check_weights, _manifest, _prefix,
                                   _saved, _train_spec_of)
from torch_mesh_ranks import MESHES, MOE_WEIGHTS, run_world

from repro_torch.checkpoint import manager as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import sharding
from repro_torch.tree import flatten_with_paths, host_array

torch.set_num_threads(1)

GRAD_SHARE = 5e-6
METRIC_RTOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_train")
    try:
        ref, ranks, _ = run_world("moe_train", out, timeout_s=420.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"])), out


def _mesh(name: str, rank: int) -> Mesh:
    d, m = MESHES[name]
    return Mesh({"data": d, "model": m}, ("data", "model"), rank=rank,
                coords={"data": rank // m, "model": rank % m})


def _cfg(meta, case: str):
    arch, _, _, _, experts = meta["moe_train"][case]
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))


# ---------------------------------------------------------------------------
# One MoE layer's gradients on the mesh
# ---------------------------------------------------------------------------


def test_moe_layer_gradients_match_reference_mesh(world):
    """Every gradient of every case, path and term on rank 0 (gathered
    whole), and x's on every rank, against ``jax.grad`` of the reference's
    path on the same mesh."""
    ref, ranks, meta, _ = world
    for case in meta["moe_grad"]:
        for impl in ("ep", "tp"):
            for what in ("y", "lb", "z"):
                key = f"moe_grad/{case}/{impl}/{what}"
                for name in ("x",) + MOE_WEIGHTS:
                    want = ref[f"{key}/{name}"]
                    for r in (ranks if name == "x" else ranks[:1]):
                        err = np.abs(r[f"{key}/{name}"] - want).max()
                        assert err <= GRAD_SHARE * np.abs(want).max(), \
                            (key, name, err)


def test_moe_layer_terms_match_reference_mesh(world):
    """``sum(y * c)``, lb and z of each case and path on every rank; at
    capacity 1.25 tokens drop (the output term moves), the aux terms do
    not (they count every pair routed)."""
    ref, ranks, meta, _ = world
    for case in meta["moe_grad"]:
        for impl in ("ep", "tp"):
            want = ref[f"moe_grad/{case}/{impl}/terms"]
            for r in ranks:
                np.testing.assert_allclose(
                    r[f"moe_grad/{case}/{impl}/terms"], want,
                    rtol=METRIC_RTOL, err_msg=f"{case} {impl}")
    for m in ("1x4", "2x2"):
        for impl in ("ep", "tp"):
            full, cut = (ref[f"moe_grad/{m}-cf{cf}/{impl}/terms"]
                         for cf in (8.0, 1.25))
            assert abs(full[0] - cut[0]) > 0.1, (m, impl)
            np.testing.assert_allclose(full[1:], cut[1:], rtol=1e-6)


def test_router_gradient_is_not_counted_per_model_rank(world):
    """The aux terms' router gradient under TP at (1, 4): every model rank
    routes the same tokens, so each holds all of it; a sum over the 4
    model ranks would give 4 times the reference's (the test above holds
    the port to 1x)."""
    ref, ranks, _, _ = world
    for what in ("lb", "z"):
        want = ref[f"moe_grad/1x4-cf8.0/tp/{what}/wr"]
        got = ranks[0][f"moe_grad/1x4-cf8.0/tp/{what}/wr"]
        assert np.abs(want).max() > 0
        assert np.abs(got - 4 * want).max() > 0.5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_moe_mesh_train_step_matches_reference_mesh(world):
    """Each case's metrics on every rank, and every gathered weight after
    2 steps, against the JAX package's mesh run."""
    ref, ranks, meta, _ = world
    for case in meta["moe_train"]:
        want = ref[f"moe_train/{case}/metrics"]
        assert np.all(want[:, 2] > 0) and np.all(want[:, 3] > 0), case
        for r in ranks:
            np.testing.assert_allclose(r[f"moe_train/{case}/metrics"], want,
                                       rtol=METRIC_RTOL, err_msg=case)
        _check_weights(_prefix(ranks[0], f"moe_train/{case}/final/"),
                       _prefix(ref, f"moe_train/{case}/final/"),
                       _prefix(ref, f"moe_train/{case}/params/"),
                       meta["train_lr"], case)


def test_moe_loss_adds_the_aux_terms(world):
    """The loss is ce + load_balance_coef * lb + router_z_coef * z (the
    single-batch cases; with microbatches the loss is their mean and the
    aux terms the last microbatch's, so the sum does not hold)."""
    _, ranks, meta, _ = world
    for case, (_, _, _, micro, _) in meta["moe_train"].items():
        moe = _cfg(meta, case).moe
        for loss, ce, lb, z, _, _ in ranks[0][f"moe_train/{case}/metrics"]:
            total = ce + moe.load_balance_coef * lb + moe.router_z_coef * z
            if micro == 1:
                assert abs(loss - total) <= 1e-6 * abs(loss), case
            else:
                assert abs(loss - total) > 1e-6 * abs(loss), case


def test_moe_ranks_hold_their_blocks_not_the_model(world):
    """Each rank holds well under half of the model in every case."""
    ref, ranks, meta, _ = world
    for case in meta["moe_train"]:
        whole = sum(v.size for v in _prefix(
            ref, f"moe_train/{case}/params/").values())
        held = [int(r[f"moe_train/{case}/params_held"]) for r in ranks]
        assert len(set(held)) == 1, case
        assert held[0] < 0.45 * whole, (case, held[0], whole)


def test_recompute_routes_as_the_forward(world):
    """Under FSDP the layers are recomputed in the backward pass: the
    route log holds each layer twice, and the recompute's choices, router
    probabilities and kept pairs equal the forward's bit for bit."""
    _, ranks, meta, _ = world
    L = _cfg(meta, meta["moe_ckpt"][0]).n_layers
    for r in ranks:
        assert int(r["recompute/calls"]) == int(r["recompute/kept"]) == 2 * L
        for j in range(L):
            for what in ("experts", "probs", "kept"):
                a, b = r[f"recompute/{j}/{what}"], \
                    r[f"recompute/{j}/{what}_again"]
                assert a.tobytes() == b.tobytes(), (j, what)


# ---------------------------------------------------------------------------
# Checkpoints across layouts
# ---------------------------------------------------------------------------


def _check_blocks(ranks, prefix, saved, cfg, mesh_name, fsdp, step):
    split = 0
    for r, out in enumerate(ranks):
        assert int(out[f"{prefix}/step"]) == step
        mesh = _mesh(mesh_name, r)
        got = _prefix(out, f"{prefix}/state/")
        assert got.keys() == saved.keys()
        for path, whole in saved.items():
            spec = _train_spec_of(path, whole.shape, cfg, mesh, fsdp)
            split += any(spec)
            block = whole[sharding.shard_slices(whole.shape, spec, mesh)]
            assert got[path].tobytes() == np.ascontiguousarray(
                block).tobytes(), (prefix, r, path)
    assert split > 0                     # the ranks held blocks, not copies


def test_ep_fsdp_checkpoint_restores_onto_1x4_bit_exact(world):
    """The reference's (2, 2) EP + FSDP checkpoint restored at (1, 4) (one
    expert a rank, no FSDP): each leaf a rank holds is its block of the
    saved leaf, bit for bit; so is the TP checkpoint's on its own
    layout."""
    ref, ranks, meta, _ = world
    root = str(ref["moe_ckpt/root"])
    for case in meta["moe_ckpt"]:
        saved = _saved(os.path.join(root, case), 2)
        _check_blocks(ranks, f"ckpt/{case}/on_1x4", saved, _cfg(meta, case),
                      "1x4", False, 2)


def test_ep_fsdp_checkpoint_restores_onto_one_device(world):
    """The same checkpoint through the port's one-device ``Trainer``."""
    from repro_torch.launch.train import Trainer
    ref, _, meta, _ = world
    case = meta["moe_ckpt"][0]
    root = os.path.join(str(ref["moe_ckpt/root"]), case)
    t = Trainer(_cfg(meta, case), device="cpu", ckpt_dir=root)
    t.init_state(7)
    assert t.try_restore() and t.step_idx == 2
    saved = _saved(root, 2)
    for path, v in flatten_with_paths(t.state_tree()):
        assert host_array(v).tobytes() == saved[path].tobytes(), path


def test_tp_layout_save_restores_onto_ep_layout(world):
    """The port's save from the TP-inside-experts layout at (1, 4),
    restored at (2, 2), where the 6 experts split over the 2 model ranks
    (EP) and D over data (FSDP)."""
    ref, ranks, meta, out = world
    case = meta["moe_ckpt"][1]
    cfg = _cfg(meta, case)
    assert cfg.moe.n_experts % 4 and not cfg.moe.n_experts % 2
    saved = _saved(os.path.join(out, "port_ckpt", case), 2)
    _check_blocks(ranks, f"ckpt/{case}/on_2x2", saved, cfg, "2x2", True, 2)


def test_step_after_elastic_restore_matches_reference(world):
    """Each elastic restore (the (2, 2) EP + FSDP state at (1, 4), the TP
    state at (2, 2) under EP + FSDP) takes its next step over a new batch
    as the reference's step on that layout from the same state does (the
    restored bf16 weights widened to f32 on both sides):
    loss, ce, load balance, router z and gradient norm, every rank the
    same (not lr: the trainer's schedule is its own)."""
    ref, ranks, meta, _ = world
    keys = [meta["train_metrics"].index(k) for k in
            ("loss", "ce", "load_balance", "router_z", "grad_norm")]
    for case in meta["moe_ckpt"]:
        prefix = f"ckpt/{case}/on_{meta['moe_elastic'][case][0]}/next"
        for r in ranks:
            np.testing.assert_array_equal(r[prefix], ranks[0][prefix])
        got = ranks[0][prefix][keys]
        want = ref[f"moe_ckpt/{case}/next"][keys]
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL,
                                   err_msg=case)


def test_moe_mesh_saves_have_the_reference_bytes(world):
    """The ranks' saves of each restored state (rank 0 writes the gathered
    leaves) have the reference checkpoint's manifest but for ``treedef``
    and ``wall_time``: every shard's SHA-256 the same."""
    ref, _, meta, out = world
    root = str(ref["moe_ckpt/root"])
    for case in meta["moe_ckpt"]:
        want = _manifest(os.path.join(root, case), 2)
        got = _manifest(os.path.join(out, "port_ckpt", case), 2)
        for m in (want, got):
            m.pop("treedef")
            m.pop("wall_time")
        assert got == want, case
        assert ck.verify_checkpoint(os.path.join(out, "port_ckpt", case), 2)


def test_cli_trains_the_moe_on_the_mesh(world):
    """``--mesh 2x2`` on the smoke qwen3: every rank logs steps 1-3 with
    the same finite losses, and each step spent time in the MoE's
    all-to-alls (counted apart in ``collectives.spent()``)."""
    _, ranks, _, out = world
    for r in ranks:
        assert r["cli/steps"].tolist() == [1, 2, 3]
        np.testing.assert_array_equal(r["cli/losses"],
                                      ranks[0]["cli/losses"])
        assert np.all(r["cli/all_to_all_s"] > 0)
    assert np.isfinite(ranks[0]["cli/losses"]).all()
    assert ck.complete_steps(os.path.join(out, "moe_cli")) == [2, 3]


# ---------------------------------------------------------------------------
# In process: the MoE's training specs
# ---------------------------------------------------------------------------


def test_moe_train_specs_are_the_reference_rules():
    """Under FSDP: EP ``(model, data, None)`` for ``w_gate`` / ``w_up`` and
    ``(model, None, data)`` for ``w_down``; TP inside the experts ``(None,
    data, model)`` and ``(None, model, data)``; the router ``(data,
    None)``.  Without FSDP the data entries go; ``init_sharded`` draws
    blocks of those shapes."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.weights import init_sharded
    full = get_config("qwen3-moe-30b-a3b")        # 128 experts: EP
    six = dataclasses.replace(full, moe=dataclasses.replace(full.moe,
                                                            n_experts=6))
    E, D, F = 128, full.d_model, full.moe.d_ff_expert

    def spec(cfg, name, shape, mesh, fsdp=True):
        return sharding.rank_spec(f"layers.0.moe.{name}", shape, cfg,
                                  Mesh.abstract(mesh, ("data", "model")),
                                  fsdp=fsdp)
    assert spec(full, "w_gate", (E, D, F), (2, 2)) == ("model", "data", None)
    assert spec(full, "w_up", (E, D, F), (2, 2)) == ("model", "data", None)
    assert spec(full, "w_down", (E, F, D), (2, 2)) == ("model", None, "data")
    assert spec(full, "router", (D, E), (2, 2)) == ("data", None)
    assert spec(six, "w_gate", (6, D, F), (2, 4)) == (None, "data", "model")
    assert spec(six, "w_down", (6, F, D), (2, 4)) == (None, "model", "data")
    assert spec(full, "w_gate", (E, D, F), (1, 4), fsdp=False) == \
        ("model", None, None)
    assert spec(full, "router", (D, E), (1, 4), fsdp=False) == (None, None)
    cfg = get_smoke_config("qwen3-moe-30b-a3b")   # 4 experts, D 64, F 64
    lm = init_sharded(cfg, 0, _mesh("2x2", 3), device="cpu",
                      plan=CodesignPlan(sharding="fsdp_tp",
                                        seq_parallel=False))
    moe = lm.layers[0].moe
    assert tuple(moe.w_gate.shape) == (2, 32, 64)
    assert tuple(moe.w_down.shape) == (2, 64, 32)
    assert tuple(moe.router.shape) == (32, 4)
