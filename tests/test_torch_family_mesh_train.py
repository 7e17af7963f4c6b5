"""The enc-dec, SSM and hybrid families trained on a mesh: the port's ranks
against the JAX package's mesh run.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
family_train``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32:

* ``make_train_step`` for 2 steps from the JAX model's weights on the
  same batches (B 8, S 16, lr 1e-3) at (2, 2) under FSDP + TP and at
  (1, 4) under TP, for seamless at a vocab of 258 (its head split over a
  model axis of 2, whole over 4; 16 stub frames a row), mamba2 and zamba2
  (the shared block's gradients from its 2 sites added up);
* one Mamba2 block's gradients of ``sum(y * c)`` on the head-wise layout,
  at (1, 4) and (2, 2), against ``jax.grad`` of the reference's block on
  one device: x's and each parameter's.  Two are partial on each model
  rank and summed over it once: that of the B and C columns of
  ``in_proj`` and channels of the conv (every rank's heads read them),
  and that of the gated norm's sum of squares (``norm_w``'s gradient goes
  through it);
* the reference's checkpoint of the (2, 2) FSDP + TP mamba2 state
  restored by the port at (1, 4) under TP: each leaf's head-wise block
  bit for bit, and its next step against the reference's on that layout;
* a (2, 2) save of mamba2's state with a one-device save's bytes;
* the CLI's ``--mesh 2x2`` on the smoke seamless.

Tolerances (f32, as ``tests/test_torch_moe_mesh_train.py``'s): the step
metrics rtol 1e-6 (seen 6.1e-7, zamba2's gradient norm at (1, 4); the
reference compiled with and without LLVM's backend passes differs by
3e-7 there), the block gradients 5e-6 of each gradient's largest
magnitude (seen 1.2e-6), the weights after 2 steps as
``tests/test_torch_mesh_train.py`` holds them.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_mesh_train import (_check_weights, _manifest, _prefix,
                                   _saved)
from test_torch_moe_mesh_train import _check_blocks
from torch_mesh_ranks import MESHES, family_cfg, run_world

from repro_torch.checkpoint import manager as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.blocks import MAMBA_PARAMS
from repro_torch.parallel import sharding

torch.set_num_threads(1)

METRIC_RTOL = 1e-6
GRAD_SHARE = 5e-6
#: the Mamba2 block's own parameters (its pre-norm ``ln`` is the layer's)
BLOCK_LEAVES = [n for n in MAMBA_PARAMS if n != "ln"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("family_train")
    try:
        ref, ranks, _ = run_world("family_train", out, timeout_s=420.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"])), out


def _case_cfg(meta, case: str):
    arch, vocab, _, _ = meta["family_train"][case]
    return family_cfg(arch, vocab)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_family_mesh_train_steps_match_reference_mesh(world):
    """Each case's metrics on every rank (the enc-dec's loss, ce, gradient
    norm and lr; the decoders' load-balance and router z terms too, zero
    here), and every gathered weight after 2 steps, against the JAX
    package's mesh run."""
    ref, ranks, meta, _ = world
    for case in meta["family_train"]:
        want = ref[f"family_train/{case}/metrics"]
        width = 4 if _case_cfg(meta, case).family == "encdec" else 6
        assert want.shape == (2, width), case
        for r in ranks:
            np.testing.assert_allclose(r[f"family_train/{case}/metrics"],
                                       want, rtol=METRIC_RTOL, err_msg=case)
        _check_weights(_prefix(ranks[0], f"family_train/{case}/final/"),
                       _prefix(ref, f"family_train/{case}/final/"),
                       _prefix(ref, f"family_train/{case}/params/"),
                       meta["train_lr"], case)


def test_family_ranks_hold_their_blocks_not_the_model(world):
    """Every rank holds the same share: under FSDP + TP well under half of
    the model; under TP more than a quarter (the norms, the B and C
    columns and, for the enc-dec at a vocab that does not divide 4, the
    embedding and head are whole on every rank) and under two thirds."""
    ref, ranks, meta, _ = world
    for case, (_, _, m, sharding_) in meta["family_train"].items():
        whole = sum(v.size for v in _prefix(
            ref, f"family_train/{case}/params/").values())
        held = {int(r[f"family_train/{case}/params_held"]) for r in ranks}
        assert len(held) == 1, case
        share = held.pop() / whole
        bound = 0.45 if sharding_ == "fsdp_tp" else 2 / 3
        assert 0.25 <= share < bound, (case, share)


# ---------------------------------------------------------------------------
# The Mamba2 block's gradients on the head-wise layout
# ---------------------------------------------------------------------------


def _close(got, want, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(got - want).max() <= GRAD_SHARE * scale, what


def test_mamba_block_gradients_match_reference(world):
    """x's gradient on every rank and each parameter's (exchanged as the
    train step exchanges them, gathered whole) against the reference's
    ``jax.grad``; the loss too."""
    ref, ranks, _, _ = world
    for m in ("1x4", "2x2"):
        for r in ranks:
            np.testing.assert_allclose(float(r[f"mamba_grad/{m}/loss"]),
                                       float(ref["mamba_grad/loss"]),
                                       rtol=METRIC_RTOL)
            _close(r[f"mamba_grad/{m}/x"], ref["mamba_grad/grads/x"],
                   (m, "x"))
        for n in BLOCK_LEAVES:
            _close(ranks[0][f"mamba_grad/{m}/{n}"],
                   ref[f"mamba_grad/grads/p/{n}"], (m, n))


def test_shared_b_and_c_gradients_count_each_rank_once(world):
    """The B and C columns of ``in_proj`` and channels of ``conv_w`` /
    ``conv_b`` (whole on every rank) hold the sum of the ranks' partial
    gradients once: each matches the reference alone, and the rank's
    share of it (the whole over the model axis's size) would not."""
    ref, ranks, _, _ = world
    cfg = get_smoke_config("mamba2-1.3b")
    di, gn2 = cfg.d_inner, 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    cuts = {"in_proj": slice(2 * di, 2 * di + gn2),
            "conv_w": slice(di, di + gn2), "conv_b": slice(di, di + gn2)}
    for m_name in ("1x4", "2x2"):
        _, m = MESHES[m_name]
        for n, cut in cuts.items():
            got = ranks[0][f"mamba_grad/{m_name}/{n}"][..., cut]
            want = ref[f"mamba_grad/grads/p/{n}"][..., cut]
            _close(got, want, (m_name, n))
            assert np.abs(got / m - want).max() > 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Checkpoints across layouts
# ---------------------------------------------------------------------------


def test_fsdp_tp_checkpoint_restores_onto_1x4_head_wise(world):
    """The reference's (2, 2) FSDP + TP mamba2 checkpoint restored at
    (1, 4) under TP: each leaf a rank holds is its head-wise block of the
    saved leaf, bit for bit (the master and moments too)."""
    ref, ranks, meta, _ = world
    root = str(ref["family_ckpt/root"])
    saved = _saved(root, 2)
    cfg = _case_cfg(meta, meta["family_ckpt"])
    _check_blocks(ranks, "family_ckpt/restored", saved, cfg,
                  meta["family_elastic"][0], False, 2)
    segmented = [p for p in saved if p.endswith(("in_proj", "conv_w",
                                                  "conv_b"))]
    assert len(segmented) == 3 * 4          # params, master, m, v


def test_step_after_elastic_restore_matches_reference(world):
    """The restored trainer's next step over a new batch (the restored bf16
    weights widened to f32 on both sides) against the reference's step
    on that layout from the same state: loss, ce and gradient norm, every
    rank the same (not lr: the trainer's schedule is its own)."""
    ref, ranks, meta, _ = world
    keys = [meta["train_metrics"].index(k) for k in ("loss", "ce",
                                                     "grad_norm")]
    for r in ranks:
        np.testing.assert_array_equal(r["family_ckpt/next"],
                                      ranks[0]["family_ckpt/next"])
    np.testing.assert_allclose(ranks[0]["family_ckpt/next"][keys],
                               ref["family_ckpt/next"][keys],
                               rtol=METRIC_RTOL)


def test_mamba_mesh_save_has_one_device_bytes(world, tmp_path):
    """A (2, 2) trainer's save of its fresh state (rank 0 writes the
    gathered leaves, the head-wise ones joined back) has a one-device
    trainer's manifest from the same seed but for ``treedef`` and
    ``wall_time``: every shard's SHA-256 the same."""
    from repro_torch.launch.train import Trainer
    _, _, _, out = world
    t = Trainer(get_smoke_config("mamba2-1.3b"), device="cpu")
    t.init_state(5)
    ck.save_checkpoint(str(tmp_path), 1, t.state_tree())
    got = _manifest(os.path.join(out, "mamba_save"), 1)
    want = _manifest(str(tmp_path), 1)
    for m in (got, want):
        m.pop("treedef")
        m.pop("wall_time")
    assert got == want
    assert ck.verify_checkpoint(os.path.join(out, "mamba_save"), 1)


def test_cli_trains_the_encdec_on_the_mesh(world):
    """``--mesh 2x2`` on the smoke seamless: every rank logs steps 1-2 with
    the same finite losses near ln V."""
    _, ranks, _, _ = world
    for r in ranks:
        assert r["cli/steps"].tolist() == [1, 2]
        np.testing.assert_array_equal(r["cli/losses"],
                                      ranks[0]["cli/losses"])
    losses = ranks[0]["cli/losses"]
    assert np.all(np.isfinite(losses))
    vocab = get_smoke_config("seamless-m4t-large-v2").vocab
    assert np.all(np.abs(losses - np.log(vocab)) < 1.0), losses


def test_family_train_specs():
    """On a (2, 2) training mesh under FSDP: mamba2-1.3b's ``in_proj`` over
    data by rows and head-wise by columns, ``out_proj`` by heads' rows and
    over data by columns, the per-head vectors by head; seamless's
    ``frame_proj`` over data only, its cross attention as self attention
    is."""
    full = get_config("mamba2-1.3b")
    mesh = Mesh.abstract((2, 2), ("data", "model"))

    def spec(cfg, name, shape):
        return sharding.rank_spec(name, shape, cfg, mesh, fsdp=True)
    D, E, di = full.d_model, full.in_proj_dim, full.d_inner
    s = spec(full, "layers.0.in_proj", (D, E))
    assert s[0] == "data" and isinstance(s[1], sharding.Segments)
    assert s[1].sizes == (di, di, 2 * full.ssm.d_state, full.ssm_heads)
    assert s[1].split == (True, True, False, True)
    assert spec(full, "layers.0.out_proj", (di, D)) == ("model", "data")
    assert spec(full, "layers.0.dt_bias", (full.ssm_heads,)) == ("model",)
    assert spec(full, "layers.0.conv_w", (4, full.conv_dim))[0] is None
    seamless = get_config("seamless-m4t-large-v2")
    assert spec(seamless, "frame_proj", (1024, 1024)) == ("data", None)
    assert spec(seamless, "dec_layers.0.cross.wq", (1024, 1024)) == (
        "data", "model")


def test_f32_reduced_matmul_is_the_matmul():
    """``common.matmul_f32_reduced`` (the vocab-parallel head's GEMMs, their
    split-K sums in f32 on a card) computes ``x @ w`` and its gradients,
    and leaves PyTorch's reduction flag as it found it."""
    from repro_torch.models.common import matmul_f32_reduced
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 8, generator=g, requires_grad=True)
    w = torch.randn(8, 7, generator=g, requires_grad=True)
    c = torch.randn(2, 5, 7, generator=g)
    got = matmul_f32_reduced(x, w)
    want = x @ w
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(torch.autograd.grad((got * c).sum(), [x, w]),
                    torch.autograd.grad((want * c).sum(), [x, w])):
        torch.testing.assert_close(a, b)
    assert flags.allow_bf16_reduced_precision_reduction == before
