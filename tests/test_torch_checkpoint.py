"""The port's checkpoints against the JAX package's, on the CPU.

Either package reads the other's checkpoints: the same shard files (leaf
order, path strings, ``.npy`` bytes, bf16 as raw 2-byte values), the same
manifest apart from ``treedef`` (a JAX PyTreeDef's text, never read by
either loader) and ``wall_time``, and the same SHA-256 per shard.  All
comparisons are bit for bit: a checkpoint stores values, it computes
nothing.  The trees are smoke-width models (2 layers) with their AdamW
state, as a trainer saves them.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jck
from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import build as jbuild
from repro.optim.adamw import adamw_init as jadamw_init

from repro_torch.checkpoint import manager as ck
from repro_torch.configs import get_smoke_config
from repro_torch.tree import Stacked, flatten_with_paths, host_array
from repro_torch.weights import (from_jax_opt_state, from_jax_params,
                                 jax_tree, opt_state_tree, param_names)

torch.set_num_threads(1)

ARCHS = ("smollm-360m", "mamba2-1.3b")


@functools.lru_cache(maxsize=None)
def _jax_state(arch: str):
    """The reference's {"params", "opt"} tree (numpy leaves), after one
    made-up update so m, v and the step are not all zero."""
    cfg = dataclasses.replace(jget_smoke(arch), n_layers=2)
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    opt = jadamw_init(params)
    rng = np.random.default_rng(0)
    bump = lambda a: a + rng.standard_normal(a.shape).astype(np.float32)
    opt = opt._replace(step=opt.step + 3, m=jax.tree.map(bump, opt.m),
                       v=jax.tree.map(lambda a: bump(a) ** 2, opt.v))
    return cfg, jax.tree.map(np.asarray, {"params": params, "opt": opt})


def _port_state(arch: str):
    """The same state as the port's trainer holds it, and its checkpoint
    tree (per-layer tensors as Stacked leaves)."""
    jcfg, jtree = _jax_state(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2)
    lm = from_jax_params(jtree["params"], cfg, device="cpu", trainable=True)
    opt = from_jax_opt_state(jtree["opt"], lm, device="cpu")
    names = param_names(lm)
    tree = {"params": jax_tree(list(lm.parameters()), names),
            "opt": opt_state_tree(opt, names)}
    return lm, tree


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _manifest(root, step):
    with open(os.path.join(jck._ckpt_dir(root, step), "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_paths_and_order_match_the_reference(arch):
    _, jtree = _jax_state(arch)
    _, tree = _port_state(arch)
    want = [jck._leaf_path_str(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [p for p, _ in flatten_with_paths(tree)]
    assert got == want
    assert got[0] == "opt/.step" and got[-1] == "params/lm_head"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("staged", [True, False])
def test_shards_and_manifest_equal_the_reference(arch, staged, tmp_path):
    _, jtree = _jax_state(arch)
    _, tree = _port_state(arch)
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jroot, 7, jtree, staged=staged)
    ck.save_checkpoint(root, 7, tree, staged=staged)
    jm, m = _manifest(jroot, 7), _manifest(root, 7)
    for k in ("treedef", "wall_time"):
        jm.pop(k), m.pop(k)
    assert m == jm
    for leaf in m["leaves"]:
        names = [os.path.join(jck._ckpt_dir(r, 7), leaf["file"])
                 for r in (jroot, root)]
        a, b = (open(n, "rb").read() for n in names)
        assert a == b, leaf["path"]
    assert {l["dtype"] for l in m["leaves"]} >= {"bfloat16", "float32",
                                                  "int32"}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    _, jtree = _jax_state(arch)
    lm, like = _port_state(arch)
    for p in lm.parameters():           # the port's values must come back
        p.data.zero_()
    jck.save_checkpoint(str(tmp_path), 5, jtree)
    assert ck.verify_checkpoint(str(tmp_path), 5)
    got = ck.load_checkpoint(str(tmp_path), 5, like, verify=True)
    want = {jck._leaf_path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    likes = dict(flatten_with_paths(like))
    for path, leaf in flatten_with_paths(got):
        assert leaf.dtype == likes[path].dtype
        assert leaf.shape == likes[path].shape
        assert _bits(host_array(leaf)) == _bits(want[path]), path
        if isinstance(leaf, Stacked):
            assert len(leaf) == 2 and leaf[0].device.type == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_a_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    _, jtree = _jax_state(arch)
    _, tree = _port_state(arch)
    ck.save_checkpoint(str(tmp_path), 9, tree)
    assert jck.verify_checkpoint(str(tmp_path), 9)
    got = jck.load_checkpoint(str(tmp_path), 9, jtree, verify=True)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert np.asarray(a).dtype == b.dtype, jck._leaf_path_str(p)
        assert _bits(a) == _bits(b), jck._leaf_path_str(p)


def test_restore_casts_to_the_like_leaf(tmp_path):
    """A leaf restores in the dtype of the caller's leaf (the reference's
    ``astype``), on its device."""
    ck.save_checkpoint(str(tmp_path), 1,
                       {"w": torch.arange(6, dtype=torch.float32)
                        .reshape(2, 3)}, staged=False)
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    got = ck.load_checkpoint(str(tmp_path), 1, like)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(6.).reshape(2, 3))
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(str(tmp_path), 1, {"w": torch.zeros(6)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.load_checkpoint(str(tmp_path), 1, {"x": torch.zeros(6)})


def test_verify_catches_a_flipped_bit(tmp_path):
    _, tree = _port_state("smollm-360m")
    ck.save_checkpoint(str(tmp_path), 2, tree)
    d = jck._ckpt_dir(str(tmp_path), 2)
    path = os.path.join(d, "leaf_00010.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 1
    open(path, "wb").write(bytes(raw))
    assert not ck.verify_checkpoint(str(tmp_path), 2)
    assert not jck.verify_checkpoint(str(tmp_path), 2)
    with pytest.raises(IOError, match="integrity"):
        ck.load_checkpoint(str(tmp_path), 2, tree, verify=True)


def test_manager_saves_async_keeps_three_and_records_history(tmp_path):
    _, tree = _port_state("smollm-360m")
    mgr = ck.CheckpointManager(str(tmp_path), every_steps=2)
    assert not mgr.maybe_save(3, tree)
    for step in (2, 4, 6, 8):
        assert mgr.maybe_save(step, tree)
    mgr.wait()
    assert ck.complete_steps(str(tmp_path)) == [4, 6, 8]
    assert [h["step"] for h in mgr.history] == [2, 4, 6, 8]
    nbytes = sum(host_array(v).nbytes for _, v in flatten_with_paths(tree))
    for h in mgr.history:
        assert h["bytes"] == nbytes and h["snapshot_s"] >= 0 \
            and h["write_s"] > 0
    step, got = mgr.restore_latest(tree)
    assert step == 8


def test_mirrored_save_falls_back_to_the_intact_replica(tmp_path):
    """Both replicas hold identical shards; a corrupt primary restores from
    the mirror, and with both replicas of the newest step corrupt the
    restore falls back to the older step."""
    lm, tree = _port_state("smollm-360m")
    root, mirror = str(tmp_path / "nvme"), str(tmp_path / "remote")
    mgr = ck.CheckpointManager(root, every_steps=1, mirror_root=mirror)
    older = {"params": {"embed": torch.ones(3)}}
    mgr.maybe_save(1, older)
    mgr.maybe_save(2, tree)
    mgr.wait()
    assert ck.complete_steps(root) == ck.complete_steps(mirror) == [1, 2]
    for leaf in _manifest(root, 2)["leaves"]:
        a, b = (open(os.path.join(jck._ckpt_dir(r, 2), leaf["file"]),
                     "rb").read() for r in (root, mirror))
        assert a == b
    want = {p: _bits(host_array(v)) for p, v in flatten_with_paths(tree)}

    def corrupt(r):
        path = os.path.join(jck._ckpt_dir(r, 2), "leaf_00001.npy")
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))

    first = mgr._restore_roots()[0]
    corrupt(first)
    step, got = mgr.restore_latest(tree)
    assert step == 2
    assert {p: _bits(host_array(v))
            for p, v in flatten_with_paths(got)} == want
    corrupt(mirror if first == root else root)
    with pytest.raises(KeyError):        # step 1 lacks the tree's leaves
        mgr.restore_latest(tree)
    step, got = mgr.restore_latest(older)
    assert step == 1 and torch.equal(got["params"]["embed"], torch.ones(3))


def test_a_reference_mirrored_checkpoint_restores_in_the_port(tmp_path):
    _, jtree = _jax_state("mamba2-1.3b")
    _, like = _port_state("mamba2-1.3b")
    root, mirror = str(tmp_path / "a"), str(tmp_path / "b")
    jck.save_checkpoint(root, 3, jtree, mirror_root=mirror)
    mgr = ck.CheckpointManager(root, mirror_root=mirror)
    step, got = mgr.restore_latest(like)
    assert step == 3
    want = {jck._leaf_path_str(p): _bits(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert {p: _bits(host_array(v))
            for p, v in flatten_with_paths(got)} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_opt_state_round_trip_to_the_jax_layout(arch):
    """``to_jax_params`` / ``to_jax_opt_state`` invert ``from_jax_params``
    / ``from_jax_opt_state`` bit for bit, layers stacked as the reference
    stacks them."""
    from repro_torch.weights import to_jax_opt_state, to_jax_params
    _, jtree = _jax_state(arch)
    lm, _ = _port_state(arch)
    opt = from_jax_opt_state(jtree["opt"], lm, device="cpu")
    for want, got in ((jtree["params"], to_jax_params(lm)),
                      (jtree["opt"], to_jax_opt_state(opt, lm))):
        w = {jck._leaf_path_str(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
        g = dict(flatten_with_paths(got))
        assert sorted(g) == sorted(w)
        for path, v in g.items():
            assert v.shape == w[path].shape and _bits(v) == _bits(w[path])
    assert not any(p.requires_grad for p in from_jax_params(
        jtree["params"], dataclasses.replace(get_smoke_config(arch),
                                             n_layers=2),
        device="cpu").parameters())
    assert all(p.requires_grad for p in lm.parameters())
