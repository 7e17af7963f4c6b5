"""The enc-dec, SSM and hybrid families served on a mesh: the port's ranks
against the JAX package's ``Server(cfg, mesh)``.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
family``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32, on the JAX model's
weights, at (1, 4) and (2, 2):

* seamless (2 + 2 layers, 4 heads) at a vocab of 258, which divides a
  model axis of 2 but not 4: its embedding and LM head whole on every
  rank at (1, 4), vocab-parallel at (2, 2); 4 requests of 16 stub frames;
* mamba2 (4 layers, 8 SSD heads: 2 or 4 a rank under the head-wise
  layout), 4 prompts of 32 tokens (two SSD chunks);
* zamba2 (4 Mamba2 layers, the shared block at 2 sites, window 32), 4
  prompts of 48 tokens, past the window, into a 56-slot cache (the JAX
  package raises below the window: ROADMAP queue 3), so the 32-slot ring
  wraps.

Prefill logits within 1e-4 of the largest reference logit (seen: 3.0e-6
seamless, 6.0e-7 mamba2, 8.0e-7 zamba2).  Three teacher-forced decode
steps within :data:`DECODE_SHARE` of it (seen: 1.4e-4 seamless, 2.6e-5
mamba2, 5.2e-5 zamba2): the caches hold bf16 (K/V, a conv window's
prefill entries), and where an f32 entry of the port and of XLA, which
sum in other orders, falls either side of a bf16 rounding point, one
ulp of bf16 (2^-8) moves the later logits.  The port's one-device run
sits about as far from the JAX one-device run.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_sharding import _check_init_sharded
from torch_mesh_ranks import MESHES, WORLD, family_cfg, run_world

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import sharding

torch.set_num_threads(1)

LOGIT_SHARE = 1e-4
DECODE_SHARE = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("family")
    try:
        ref, ranks, _ = run_world("family", out, timeout_s=300.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _logits(world, case: str) -> np.ndarray:
    """The whole batch's logits (steps, B, 1, V): each data row's ranks
    hold its rows (every model rank the same)."""
    _, ranks, meta = world
    d, m = MESHES[meta["family_serve"][case][2]]
    rows = [ranks[i * m][f"family/{case}/logits"] for i in range(d)]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"family/{case}/logits"],
                                      rows[r // m])
    return np.concatenate(rows, axis=1)


def test_family_prefill_logits_match_reference_mesh(world):
    ref, _, meta = world
    for case in meta["family_serve"]:
        want = ref[f"family/{case}/logits"]
        err = np.abs(_logits(world, case)[0] - want[0]).max()
        assert err <= LOGIT_SHARE * np.abs(want).max(), (case, err)


def test_family_decode_logits_match_reference_mesh(world):
    ref, _, meta = world
    for case, (_, _, _, _, _, steps, _) in meta["family_serve"].items():
        got, want = _logits(world, case), ref[f"family/{case}/logits"]
        assert got.shape == want.shape == (steps + 1,) + want.shape[1:]
        for step in range(1, steps + 1):
            err = np.abs(got[step] - want[step]).max()
            assert err <= DECODE_SHARE * np.abs(want).max(), (case, step,
                                                               err)


def test_family_rank_caches(world):
    """Each rank's cache holds its rows and its heads: seamless's self and
    cross K/V its attention heads over the cache's and the encoder's
    slots; mamba2's and zamba2's conv window its x channels and all of B
    and C, its SSM state its SSD heads; zamba2's shared K/V a 32-slot ring
    (its window: the cache is longer) of its attention heads per site."""
    ref, ranks, meta = world
    for case, (arch, vocab, m_name, B, prompt, _, max_len) in \
            meta["family_serve"].items():
        cfg = family_cfg(arch, vocab)
        d, m = MESHES[m_name]
        b, hkv = B // d, cfg.n_kv_heads // m
        want = {}
        if cfg.family == "encdec":
            want = {"k": [cfg.n_layers, b, max_len, hkv, cfg.hd],
                    "cross_k": [cfg.n_layers, b, prompt, hkv, cfg.hd]}
        else:
            s, h = cfg.ssm, cfg.ssm_heads // m
            want = {"conv": [cfg.n_layers, b, s.conv_width - 1,
                             h * s.head_dim + 2 * s.n_groups * s.d_state],
                    "ssm": [cfg.n_layers, b, h, s.head_dim, s.d_state]}
            if cfg.family == "hybrid":
                assert max_len >= cfg.window
                want["shared_k"] = [2, b, cfg.window, hkv, cfg.hd]
        for r in ranks:
            got = json.loads(str(r[f"family/{case}/cache"]))
            for k, v in want.items():
                assert got[k] == v, (case, k, got[k], v)


def test_family_ranks_hold_their_share(world):
    """Every rank holds the same number of parameters: about 1 / m of each
    matrix, and more where a leaf is whole (norms, B and C columns, the
    enc-dec's head at (1, 4) and ``frame_proj``)."""
    ref, ranks, meta = world
    for case, (_, _, m_name, *_rest) in meta["family_serve"].items():
        _, m = MESHES[m_name]
        full = sum(ref[k].size for k in ref.files
                   if k.startswith(f"family/{case}/params/"))
        held = {int(r[f"family/{case}/params"]) for r in ranks}
        assert len(held) == 1, case
        share = held.pop() / full
        assert 1 / m <= share < 0.6, (case, share)


def test_the_encdec_head_is_whole_at_1x4_and_split_at_2x2():
    """A vocab of 258 = 2 x 129 splits the embedding's rows and the head's
    columns over a model axis of 2 but not of 4 (the rule drops an axis
    that does not divide); seamless's 256,206 the same; ``frame_proj`` is
    whole over the model axis either way."""
    for cfg in (family_cfg("seamless-m4t-large-v2", 258),
                get_config("seamless-m4t-large-v2")):
        V, D = cfg.vocab, cfg.d_model

        def spec(name, shape, mesh):
            return sharding.rank_spec(name, shape, cfg, Mesh.abstract(
                mesh, ("data", "model")))
        assert spec("embed", (V, D), (2, 2)) == ("model", None)
        assert spec("lm_head", (D, V), (2, 2)) == (None, "model")
        assert spec("embed", (V, D), (1, 4)) == (None, None)
        assert spec("lm_head", (D, V), (1, 4)) == (None, None)
        assert spec("frame_proj", (D, D), (1, 4)) == (None, None)


def test_unshard_of_shard_round_trips_every_leaf(world):
    """``unshard(shard_tensor(p, spec))`` is ``p`` for every parameter of
    every smoke config on (1, 4), (2, 2) and (4, 1), serving and FSDP
    specs, on every rank; the Mamba2 projections and convs took the
    head-wise layout there (mamba2 and zamba2, 4 layers x 3 leaves, on
    the two meshes whose model axis divides the heads, both spec kinds)."""
    _, ranks, _ = world
    for r in ranks:
        assert json.loads(str(r["roundtrip/bad"])) == []
        assert int(r["roundtrip/segmented"]) == 2 * 4 * 3 * 2 * 2


def test_head_wise_layout_of_a_mamba2_projection():
    """mamba2-1.3b's ``in_proj`` (2048, 8512) = [z 4096 | x 4096 | B 128 |
    C 128 | dt 64] at TP 4: rank i holds z's and x's columns of its 16
    heads, all of B and C, and dt's of its heads (2128 columns); its conv
    ``[x | B | C]`` channels; the reference table's contiguous cut (2128
    columns from 2128 i) is what the layout replaces."""
    cfg = get_config("mamba2-1.3b")
    di, gn, H = cfg.d_inner, 2 * cfg.ssm.d_state, cfg.ssm_heads
    for rank in range(4):
        mesh = Mesh({"data": 1, "model": 4}, ("data", "model"), rank=rank,
                    coords={"data": 0, "model": rank})
        spec = sharding.rank_spec("layers.0.in_proj",
                                  (cfg.d_model, cfg.in_proj_dim), cfg, mesh)
        assert spec[0] is None and isinstance(spec[1], sharding.Segments)
        cols = np.asarray(sharding.shard_slices(
            (cfg.d_model, cfg.in_proj_dim), spec, mesh)[1])
        w, h = di // 4, H // 4
        want = np.concatenate([
            np.arange(rank * w, (rank + 1) * w),
            di + np.arange(rank * w, (rank + 1) * w),
            2 * di + np.arange(gn),
            2 * di + gn + np.arange(rank * h, (rank + 1) * h)])
        np.testing.assert_array_equal(cols, want)
        conv = sharding.rank_spec("layers.0.conv_w", (4, cfg.conv_dim), cfg,
                                  mesh)
        chans = np.asarray(sharding.shard_slices((4, cfg.conv_dim), conv,
                                                 mesh)[1])
        np.testing.assert_array_equal(chans, np.concatenate([
            np.arange(rank * w, (rank + 1) * w), di + np.arange(gn)]))
        for leaf, shape, want_spec in (
                ("A_log", (H,), ("model",)), ("norm_w", (di,), ("model",)),
                ("out_proj", (di, cfg.d_model), ("model", None))):
            assert sharding.rank_spec(f"layers.0.{leaf}", shape, cfg,
                                      mesh) == want_spec
    # heads that do not divide the model axis stay whole: 64 heads do not
    # split over 3 ranks, and a head is never split
    three = Mesh.abstract((1, 3), ("data", "model"))
    assert sharding.rank_spec("layers.0.in_proj",
                              (cfg.d_model, cfg.in_proj_dim), cfg,
                              three) == (None, None)


def test_init_sharded_draws_what_init_draws_for_the_families():
    """Each rank's shards drawn from the seed equal its shards of the whole
    model drawn from the seed (the enc-dec through ``init_encdec(keep=)``,
    the Mamba2 leaves cut head-wise)."""
    for arch in ("seamless-m4t-large-v2", "mamba2-1.3b", "zamba2-1.2b"):
        for shape in ((1, 4), (2, 2)):
            _check_init_sharded(arch, shape)
