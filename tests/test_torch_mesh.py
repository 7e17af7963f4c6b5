"""The port on a mesh of four gloo ranks against the JAX package on four
emulated CPU devices.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py``,
a subprocess with ``xla_force_host_platform_device_count=4``) and then one
gloo world of 4 single-threaded ranks (``tests/torch_mesh_ranks.py``) on
the same inputs; each test compares one kind of output over its cases
(the file keeps under 27 tests: xdist's ``loadfile`` runs the files with
the most tests first, and a larger file would move the reference's
wall-clock tests beside heavier neighbours):

* ``moe_ep`` / ``moe_tp`` (meshes (1, 4) and (2, 2); prefill-shaped
  tokens at capacity factors 8.0 and 1.25, at which tokens drop, and
  decode-shaped ones at 1.25; on
  (2, 2) ``moe_ep`` also with its expert weights split over data and
  gathered, as the JAX package's FSDP gather does): outputs within f32
  noise (atol = rtol = 2e-4), the aux losses, and the same kept pairs;
* the collective primitives against numpy; ``compressed_psum`` (blocks 64
  and 256): every block bit-equal to the JAX package's but those where
  XLA's quantizer (``max|x| * f32(1/127)``) and the port's (the IEEE
  quotient) take scales one ulp apart, at either quantization (ROADMAP
  queue 3), and within 5% of the exact sum; ``hierarchical_psum`` plain
  (1e-4) and compressed (as ``compressed_psum``);
* ``cache_shardings`` for every config, batch 1 and 8, on (1, 4), (2, 2)
  and (4, 1);
* the smoke phi3 at (1, 4) and smoke mixtral at (2, 2) through
  ``Server(cfg, mesh)`` on the JAX model's weights in f32: prefill logits
  against the JAX mesh run, decode logits against the JAX one-device run,
  each within 1e-4 of the largest reference logit.  The JAX mesh decode
  is not the reference there: under a mesh whose model axis divides the
  query heads but not the KV heads (mixtral), its prefill caches the KV
  heads repeated once per query head (the GQA repair of
  ``self_attention_block``) and its decode writes each step's K/V into the
  first of them only, so the other query heads read stale entries
  (``test_reference_mesh_decode_fault``); and its bf16 cache rounds apart
  from the one-device run's where GSPMD sums in another order (phi3: 1.2e-3
  of 3.8 by the fourth step).  The port's mesh decode matches the
  one-device function.
"""

import json

import numpy as np
import pytest

from torch_mesh_ranks import MESHES, WORLD, run_world

MOE_TOL = dict(atol=2e-4, rtol=2e-4)
LOGIT_SHARE = 1e-4
MOE_CASES = [f"{m}-{kind}" for m in ("1x4", "2x2")
             for kind in ("cf8.0-prefill", "cf1.25-prefill", "cf1.25-decode")]
IMPLS = {"1x4": ("ep", "tp"), "2x2": ("ep", "tp", "ep_fsdp")}
AXES = ["data", "model", "data+model"]
OPS = ["psum", "psum_bf16", "all_gather", "all_to_all", "psum_scatter"]
CPSUM = ["model-b64", "model-b256", "data-b64"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    try:
        ref, ranks, secs = run_world("mesh", tmp_path_factory.mktemp("mesh"))
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _coords(rank: int, mesh: str) -> tuple[int, int]:
    _, m = MESHES[mesh]
    return rank // m, rank % m


def _rows(ranks, key: str, mesh: str) -> np.ndarray:
    """The batch assembled from each data row's ranks, which must agree."""
    d, _ = MESHES[mesh]
    out = []
    for i in range(d):
        got = [r[key] for k, r in enumerate(ranks) if _coords(k, mesh)[0] == i]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        out.append(got[0])
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_matches_reference_mesh(world, case):
    """Each path (``moe_ep``, ``moe_tp`` and, on (2, 2), ``moe_ep`` over
    FSDP-split experts): the output, the kept pairs and the aux losses."""
    ref, ranks, _ = world
    mesh = case.split("-")[0]
    for impl in IMPLS[mesh]:
        y = _rows(ranks, f"moe/{case}/{impl}/y", mesh)
        np.testing.assert_allclose(y, ref[f"moe/{case}/{impl[:2]}/y"],
                                   err_msg=impl, **MOE_TOL)
        want = ref[f"moe/{case}/{impl[:2]}/keep"]
        got = np.zeros_like(want)
        for r in ranks:
            keep = r[f"moe/{case}/{impl}/keep"]
            first, total = r[f"moe/{case}/{impl}/span"]
            assert total == want.shape[0]
            got[first:first + len(keep)] = keep
        np.testing.assert_array_equal(got, want, err_msg=impl)
        for r in ranks:
            np.testing.assert_allclose(r[f"moe/{case}/{impl}/aux"],
                                       ref[f"moe/{case}/{impl[:2]}/aux"],
                                       err_msg=impl, **MOE_TOL)


def test_moe_drops_at_capacity_1_25_and_none_at_8(world):
    """At a capacity factor of 1.25 the prefill-shaped shards drop pairs;
    at 8.0 none drops, and both paths equal the no-drop oracle."""
    ref, ranks, _ = world
    for mesh, impl in ((m, i) for m in ("1x4", "2x2") for i in ("ep", "tp")):
        assert not ref[f"moe/{mesh}-cf1.25-prefill/{impl}/keep"].all()
        case = f"{mesh}-cf8.0-prefill"
        assert ref[f"moe/{case}/{impl}/keep"].all()
        np.testing.assert_allclose(
            _rows(ranks, f"moe/{case}/{impl}/y", mesh),
            ref[f"moe/{case}/ref/y"], **MOE_TOL)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _members(axes: str, rank: int) -> list[int]:
    """The ranks of a (2, 2) mesh's group over ``axes`` holding ``rank``,
    in axis order."""
    d, m = _coords(rank, "2x2")
    if axes == "data":
        return [2 * i + m for i in range(2)]
    if axes == "model":
        return [2 * d + i for i in range(2)]
    return list(range(WORLD))


def _bf16(x: np.ndarray) -> np.ndarray:
    import torch
    return torch.from_numpy(x).bfloat16().float().numpy()


def _x(rank: int) -> np.ndarray:
    return np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * rank


def test_collective_primitives(world):
    """Each primitive over each set of axes of the (2, 2) mesh, on every
    rank, against numpy."""
    _, ranks, _ = world
    for op, axes, (rank, r) in ((o, a, rr) for o in OPS for a in AXES
                                for rr in enumerate(ranks)):
        mem = _members(axes, rank)
        xs = [_x(k) for k in mem]
        n, i = len(mem), mem.index(rank)
        if op == "psum":
            want = sum(xs)
        elif op == "psum_bf16":       # bf16 in, an f32 sum, rounded once
            want = _bf16(sum(_bf16(x) for x in xs))
        elif op == "all_gather":
            want = np.concatenate(xs, axis=1)
        elif op == "all_to_all":
            want = np.concatenate([np.split(x, n, 0)[i] for x in xs], axis=1)
        else:
            want = sum(np.split(x, n, 0)[i] for x in xs)
        np.testing.assert_array_equal(r[f"prim/{op}/{axes}"], want,
                                      err_msg=f"{op} {axes} rank {rank}")


def test_ppermute(world):
    _, ranks, _ = world
    for axis, shift, (rank, r) in ((a, sh, rr) for a in ("data", "model")
                                   for sh in (1, -1)
                                   for rr in enumerate(ranks)):
        mem = _members(axis, rank)
        src = mem[(mem.index(rank) - shift) % len(mem)]
        np.testing.assert_array_equal(r[f"prim/ppermute/{axis}/{shift}"],
                                      _x(src))


def _blocks(x: np.ndarray, block: int) -> np.ndarray:
    nb = -(-x.size // block)
    flat = np.zeros(nb * block, np.float32)
    flat[:x.size] = x.reshape(-1)
    return flat.reshape(nb, block)


def _check_compressed(got: np.ndarray, want: np.ndarray, block: int) -> int:
    """A compressed sum against the JAX package's, block by block: the same
    int8 codes everywhere (each value over its block's largest, which is
    its code 127 times the scale), and every value within 2.5e-7 of the
    JAX package's relative to it: the scales at most 2 ulps apart.  XLA
    computes a scale as ``max|x| * f32(1/127)`` (and sums the received
    chunks in its own order), the port as the IEEE quotient (ROADMAP
    queue 3).  Returns the count of blocks that differ, at most half."""
    gb, wb = _blocks(got, block), _blocks(want, block)
    gmax, wmax = np.abs(gb).max(axis=1), np.abs(wb).max(axis=1)
    ulps = np.abs(gmax.view(np.int32).astype(np.int64)
                  - wmax.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    codes = lambda b, m: np.rint(b * 127 / np.where(m > 0, m, 1)[:, None])
    np.testing.assert_array_equal(codes(gb, gmax), codes(wb, wmax))
    assert (np.abs(gb - wb) <= 2.5e-7 * np.abs(wb)).all()
    differ = (gb != wb).any(axis=1)
    assert differ.sum() <= len(differ) // 2
    return int(differ.sum())


def _cpsum_members(meta, case, rank, x):
    mesh, axis = meta["cpsum"][case][0], meta["cpsum"][case][1]
    d, m = _coords(rank, mesh)
    if axis == "model":
        mem = [2 * d + i for i in range(2)] if mesh == "2x2" else range(4)
    else:
        mem = [2 * i + m for i in range(2)]
    return x[list(mem)]


def test_compressed_psum_codes_match_reference(world):
    ref, ranks, meta = world
    for case, (k, r) in ((c, kr) for c in CPSUM for kr in enumerate(ranks)):
        block = meta["cpsum"][case][3]
        _check_compressed(r[f"cpsum/{case}/out"],
                          ref[f"cpsum/{case}/out"][k], block)


def test_compressed_psum_within_5pct_of_exact(world):
    ref, ranks, meta = world
    for case, (k, r) in ((c, kr) for c in CPSUM for kr in enumerate(ranks)):
        x = ref[f"cpsum/{case}/x"]
        exact = _cpsum_members(meta, case, k, x).sum(axis=0)
        err = np.abs(r[f"cpsum/{case}/out"] - exact).max()
        assert err < 0.05 * np.abs(exact).max()


def test_compressed_psum_first_quantization_is_the_reference_s_but_ulps(
        world):
    """The JAX run's own first-stage codes: where its scale is the IEEE
    quotient, the port's plain quantizer gives the same codes."""
    from repro_torch.optim.compression import quantize_int8_blockwise
    import torch
    ref, _, _ = world
    for case in ("model-b64", "model-b256"):
        block = int(case.split("b")[-1])
        for row in range(WORLD):
            q, s = quantize_int8_blockwise(
                torch.from_numpy(ref[f"cpsum/{case}/x"][row]), block)
            same = s.numpy() == ref[f"cpsum/{case}/s1"][row]
            np.testing.assert_array_equal(q.numpy()[same],
                                          ref[f"cpsum/{case}/q1"][row][same])
            assert same.mean() > 0.8


def test_hierarchical_psum_plain(world):
    ref, ranks, _ = world
    x = ref["hpsum/x"]
    for k, r in enumerate(ranks):
        np.testing.assert_allclose(r["hpsum/plain/out"],
                                   ref["hpsum/plain/out"][k], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["hpsum/plain/out"], x.sum(axis=0),
                                   atol=1e-4, rtol=1e-4)


def test_hierarchical_psum_compressed(world):
    """The inter (data) stage compresses each model index's chunk of the
    intra (model) sums: held as ``compressed_psum`` is, chunk by chunk."""
    ref, ranks, _ = world
    n = ref["hpsum/x"].shape[1] // 2
    for k, r in enumerate(ranks):
        for m in range(2):
            chunk = slice(m * n, (m + 1) * n)
            _check_compressed(r["hpsum/compressed/out"][chunk],
                              ref["hpsum/compressed/out"][k][chunk], 64)


# ---------------------------------------------------------------------------
# cache_shardings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_shardings_match_reference(world, mesh_name):
    """Every config's cache, batch 1 and 8, on one mesh."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import cache_shardings
    ref, _, _ = world
    mesh = Mesh.abstract(MESHES[mesh_name], ("data", "model"))
    # a PartitionSpec writes the one-axis tuple ("data",) as "data"
    one = lambda a: a[0] if isinstance(a, (tuple, list)) and len(a) == 1 \
        else (tuple(a) if isinstance(a, list) else a)
    tables = json.loads(str(ref["cache/table"]))
    keys = [k for k in tables if k.endswith(f"|{mesh_name}")]
    assert len(keys) == 22
    for key in keys:
        table = tables[key]
        got = cache_shardings({n: tuple(s) for n, (s, _) in table.items()},
                              mesh)
        assert {n: tuple(map(one, s)) for n, s in got.items()} == \
            {n: tuple(map(one, spec)) for n, (_, spec) in table.items()}, key


def test_rank_caches_hold_their_share(world):
    """phi3 at (1, 4): the cache's heads split over model (4 KV heads, one
    a rank), the reference's spec.  mixtral at (2, 2): batch over data,
    its one KV head whole (the reference's spec puts the sequence on the
    model axis instead: ROADMAP queue 3)."""
    _, ranks, meta = world
    for r in ranks:
        assert tuple(r["serve/phi3/cache_k"]) == (4, 4, 24, 1, 16)
        assert tuple(r["serve/mixtral/cache_k"]) == (4, 1, 32, 1, 16)


# ---------------------------------------------------------------------------
# Serving the smoke models on a mesh
# ---------------------------------------------------------------------------


def _logits(world, case):
    _, ranks, meta = world
    return _rows([{k: r[k].swapaxes(0, 1) for k in (f"serve/{case}/logits",)}
                  for r in ranks], f"serve/{case}/logits",
                 meta["serve"][case][1]).swapaxes(0, 1)


def test_prefill_logits_match_reference_mesh(world):
    ref, _, _ = world
    for case in ("phi3", "mixtral"):
        want = ref[f"serve/{case}/mesh/logits"][0]
        err = np.abs(_logits(world, case)[0] - want).max()
        assert err <= LOGIT_SHARE * np.abs(want).max(), case


def test_decode_logits_match_reference_one_device(world):
    ref, _, _ = world
    for case, step in ((c, t) for c in ("phi3", "mixtral")
                       for t in (1, 2, 3, 4)):
        want = ref[f"serve/{case}/one/logits"][step]
        err = np.abs(_logits(world, case)[step] - want).max()
        assert err <= LOGIT_SHARE * np.abs(want).max(), (case, step)


def test_reference_mesh_decode_fault(world):
    """mixtral (4 query heads over 1 KV head) at (2, 2): the JAX mesh
    prefill caches 4 KV heads, its decode then parts from its own
    one-device decode by far more than f32 noise; the port's mesh decode
    stays with the one-device one."""
    ref, _, _ = world
    assert int(ref["serve/mixtral/mesh/cache_heads"]) == 4
    assert int(ref["serve/mixtral/one/cache_heads"]) == 1
    mesh, one = (ref[f"serve/mixtral/{r}/logits"] for r in ("mesh", "one"))
    assert np.abs(mesh[1:] - one[1:]).max() > 0.1
    assert np.abs(_logits(world, "mixtral")[1:] - one[1:]).max() < 1e-4


def test_generate_on_the_mesh(world):
    """Every rank returns the whole batch's tokens, the same; rank 0 alone
    streamed them through the mover (one item a decode step)."""
    _, ranks, meta = world
    for case in ("phi3", "mixtral"):
        _check_generate(ranks, meta, case)


def _check_generate(ranks, meta, case):
    _, _, B, _, steps, _ = meta["serve"][case]
    toks = [r[f"serve/{case}/generated"] for r in ranks]
    assert toks[0].shape == (B, steps)
    for t in toks[1:]:
        np.testing.assert_array_equal(t, toks[0])
    assert [int(r[f"serve/{case}/streamed"]) for r in ranks] == \
        [steps - 1] + [-1] * (WORLD - 1)


def test_phi3_rank_holds_a_quarter_of_the_weights(world):
    """At (1, 4) every weight of phi3's smoke variant splits over model but
    the norms: a rank holds a little over a quarter of them."""
    ref, ranks, _ = world
    full = sum(ref[k].size for k in ref.files
               if k.startswith("serve/phi3/params/"))
    for r in ranks:
        share = int(r["serve/phi3/params"]) / full
        assert 0.25 <= share < 0.27
