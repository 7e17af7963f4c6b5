"""The VLM (llava-next) on a mesh, serving and training: the port's ranks
against the JAX package.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
vlm``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The smoke llava (4 query heads over 1 KV head, 8
stub patches through the projector), in f32:

* served by ``Server(cfg, mesh)`` at (1, 4) and (2, 2) on the JAX model's
  weights, 4 prompts of 8 patches + 16 tokens, a cache of ``frontend_len
  + prompt + steps + 1`` slots: prefill logits against the JAX mesh run,
  teacher-forced decode logits against the JAX one-device run, each
  within 1e-4 of the largest reference logit (``tests/test_torch_mesh.py``'s
  bound).  The KV head divides neither model axis, so the JAX mesh
  decode is at fault there (ROADMAP queue 3) and is not the reference;
* ``make_train_step`` at (2, 2) under FSDP + TP for 2 steps on the same
  batches (8 rows of 8 patches + 16 scored text tokens): metrics rtol 1e-6
  (seen 1.2e-7) and the weights after 2 steps as
  ``tests/test_torch_mesh_train.py`` holds them.

Seen: prefill 1.4e-6 of 3.6, decode 1.5e-4 (4.1e-5 of the largest logit:
the bf16 cache rounds apart where the sums run in another order).
"""

import json

import numpy as np
import pytest
import torch

from test_torch_mesh_train import _check_weights, _prefix
from torch_mesh_ranks import MESHES, WORLD, run_world

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import sharding

torch.set_num_threads(1)

LOGIT_SHARE = 1e-4
METRIC_RTOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm")
    try:
        ref, ranks, _ = run_world("vlm", out, timeout_s=300.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _logits(world, case: str) -> np.ndarray:
    """The whole batch's logits (steps, B, 1, V): each data row's ranks
    hold its rows (every model rank the same)."""
    _, ranks, meta = world
    d, m = MESHES[meta["vlm_serve"][case][0]]
    rows = [ranks[i * m][f"vlm_serve/{case}/logits"] for i in range(d)]
    for r in range(WORLD):
        np.testing.assert_array_equal(
            ranks[r][f"vlm_serve/{case}/logits"], rows[r // m])
    return np.concatenate(rows, axis=1)


def test_vlm_prefill_logits_match_reference_mesh(world):
    ref, _, meta = world
    for case in meta["vlm_serve"]:
        want = ref[f"vlm_serve/{case}/mesh/logits"][0]
        err = np.abs(_logits(world, case)[0] - want).max()
        assert err <= LOGIT_SHARE * np.abs(want).max(), (case, err)


def test_vlm_decode_logits_match_reference_one_device(world):
    ref, _, meta = world
    for case, (_, _, _, steps) in meta["vlm_serve"].items():
        got = _logits(world, case)
        for step in range(1, steps + 1):
            want = ref[f"vlm_serve/{case}/one/logits"][step]
            err = np.abs(got[step] - want).max()
            assert err <= LOGIT_SHARE * np.abs(want).max(), (case, step, err)


def test_vlm_rank_caches_and_weights(world):
    """The cache holds the patches, the prompt and the decode steps, the
    rank's rows and the one KV head (whole: it divides no model axis); the
    projector's ``w1`` columns and ``w2`` rows split over the model axis,
    as every matrix does, so a rank holds about 1 / m of the weights."""
    ref, ranks, meta = world
    cfg = get_smoke_config("llava-next-mistral-7b")
    for case, (m_name, B, prompt, steps) in meta["vlm_serve"].items():
        d, m = MESHES[m_name]
        full = sum(ref[k].size for k in ref.files
                   if k.startswith(f"vlm_serve/{case}/params/"))
        for r in ranks:
            assert tuple(r[f"vlm_serve/{case}/cache_k"]) == (
                cfg.n_layers, B // d, cfg.frontend_len + prompt + steps + 1,
                1, cfg.hd)
            share = int(r[f"vlm_serve/{case}/params"]) / full
            assert 1 / m <= share < 1.2 / m, (case, share)


def test_vlm_generate_on_the_mesh(world):
    """Every rank returns the whole batch's greedy tokens, the same."""
    _, ranks, meta = world
    for case, (_, B, _, steps) in meta["vlm_serve"].items():
        toks = [r[f"vlm_serve/{case}/generated"] for r in ranks]
        assert toks[0].shape == (B, steps)
        for t in toks[1:]:
            np.testing.assert_array_equal(t, toks[0])


def test_vlm_mesh_train_step_matches_reference_mesh(world):
    """The metrics on every rank and every gathered weight (the projector's
    among them) after 2 steps, against the JAX package's mesh step, which
    scores the text tail alone."""
    ref, ranks, meta = world
    want = ref["vlm_train/metrics"]
    for r in ranks:
        np.testing.assert_allclose(r["vlm_train/metrics"], want,
                                   rtol=METRIC_RTOL)
    final = _prefix(ranks[0], "vlm_train/final/")
    assert {"projector/w1", "projector/w2"} <= final.keys()
    _check_weights(final, _prefix(ref, "vlm_train/final/"),
                   _prefix(ref, "vlm_train/params/"), meta["train_lr"],
                   "vlm")


def test_projector_specs():
    """``w1`` is column-parallel and ``w2`` row-parallel, with FSDP's data
    entry on the other dim on a training mesh: the reference's rules."""
    full = get_config("llava-next-mistral-7b")
    D = full.d_model

    def spec(name, mesh, fsdp):
        return sharding.rank_spec(f"projector.{name}", (D, D), full,
                                  Mesh.abstract(mesh, ("data", "model")),
                                  fsdp=fsdp)
    assert spec("w1", (2, 2), True) == ("data", "model")
    assert spec("w2", (2, 2), True) == ("model", "data")
    assert spec("w1", (1, 4), False) == (None, "model")
    assert spec("w2", (1, 4), False) == ("model", None)
    assert spec("w1", (4, 1), True) == ("data", None)
