"""The port's GPipe ``pipeline_forward`` against the JAX package's.

One module fixture runs the JAX package's ``pipeline_forward`` once
(``tests/jax_mesh_refs.py gpipe``: 4 emulated CPU devices) and then one
gloo world of 4 single-threaded ranks (``tests/torch_mesh_ranks.py``) on
the same 8-layer dense stack (the smoke phi3's layers, f32) and the same
microbatches: 4 microbatches over 4 stages of 2 layers on a ("pod",) mesh,
and 3 microbatches over 2 stages of 4 layers on the data axis of a (2, 2)
mesh.  The outputs agree within 1e-4 on every rank, each stage runs its
slab once per microbatch, and the result equals the stack run straight
through on one device.  In-process cases check a one-stage pipeline and
the schedule's argument checks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_mesh_ranks import WORLD, _tree, run_world

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.blocks import ShardCtx, dense_layer_apply
from repro_torch.parallel import pipeline_forward
from repro_torch.weights import _dense_layer

CASES = ["pod4", "data2"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    try:
        ref, ranks, _ = run_world("gpipe", tmp_path_factory.mktemp("gpipe"))
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _stack(ref):
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), n_layers=8)
    layers = _tree(ref, "gpipe/layers/")
    return cfg, [_dense_layer(layers, torch.device("cpu"), i)
                 for i in range(cfg.n_layers)]


def _straight(cfg, layers, x):
    """Every microbatch through every layer on one device."""
    pos = torch.arange(x.shape[2], dtype=torch.int32)
    ctx = ShardCtx(impl="cuda")
    out = []
    with torch.no_grad():
        for mb in x:
            h = mb
            for lp in layers:
                h = dense_layer_apply(h, lp, cfg, ctx, positions=pos)
            out.append(h)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_pipeline_matches_reference(world, case, rank):
    ref, ranks, _ = world
    np.testing.assert_allclose(ranks[rank][f"gpipe/{case}/y"],
                               ref[f"gpipe/{case}/y"], **TOL)


@pytest.mark.parametrize("case", CASES)
def test_each_stage_runs_once_per_microbatch(world, case):
    _, ranks, meta = world
    n_micro = meta["gpipe"][case][3]
    assert [int(r[f"gpipe/{case}/calls"]) for r in ranks] == [n_micro] * WORLD


@pytest.mark.parametrize("case", CASES)
def test_pipeline_equals_the_stack_straight_through(world, case):
    ref, ranks, _ = world
    cfg, layers = _stack(ref)
    want = _straight(cfg, layers, torch.from_numpy(ref[f"gpipe/{case}/x"]))
    np.testing.assert_allclose(ranks[0][f"gpipe/{case}/y"], want, **TOL)


def _one_stage_mesh():
    """A one-member mesh: its collectives return their input."""
    return Mesh({"pod": 1}, ("pod",), rank=0, coords={"pod": 0}, groups={})


def test_one_stage_pipeline_is_the_stack(world):
    ref, _, _ = world
    cfg, layers = _stack(ref)
    x = torch.from_numpy(ref["gpipe/pod4/x"])
    pos = torch.arange(x.shape[2], dtype=torch.int32)
    ctx = ShardCtx(impl="ref")

    def layer_fn(ps, h):
        for lp in ps:
            h = dense_layer_apply(h, lp, cfg, ctx, positions=pos)
        return h
    with torch.no_grad():
        y = pipeline_forward(layer_fn, layers, x, mesh=_one_stage_mesh(),
                             layers_per_stage=8)
    np.testing.assert_allclose(y.numpy(), _straight(cfg, layers, x), **TOL)


def test_stage_slab_must_match_layers_per_stage():
    with pytest.raises(ValueError, match="holds 2 layers, not 4"):
        pipeline_forward(lambda p, h: h, [0, 1], torch.zeros(2, 1, 3),
                         mesh=_one_stage_mesh(), layers_per_stage=4)
