"""The MoE family under Megatron sequence parallelism
(``CodesignPlan(seq_parallel=True)``): the port's ranks against the JAX
package's run under the same plan, and against the port without it.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
moe_seq_parallel``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32, on the JAX model's
weights, for each case of the JAX run's ``MOE_SP_CASES`` (one mesh
each): smoke qwen3 through ``moe_ep`` at (1, 4) and, at a capacity factor
of 1.25, at (2, 2); qwen3 with 6 experts through ``moe_tp`` at (1, 4), at
1.25 too; smoke mixtral (windowed, ring cache) through ``moe_ep`` at
(2, 2).  At 1.25 the shards drop pairs.  The served prompts are 4 x 24
(24 divides a model axis of 4) and 4 x 18 (18 divides only 2, so (1, 4)
runs it without the split); step 1 of training takes 8 x 24, step 2
8 x 18.

Under the plan a layer holds the rank's chunk of the sequence, and the
MoE is entered by gathering it: each shard then routes the token block
it routes without the plan, as the JAX package's GSPMD reshards its
chunks into its blocks.  Checked:

* the prefill logits against the reference's under the same plan;
  the prefill and 2 teacher-forced decode steps against the port's own
  run without the plan, bit for bit where the sequence does not split;
* the pairs each MoE layer's shards kept, in the prefills and in step
  1's forward, equal to ``shard_keep``'s on the reference's own layer
  inputs, and each rank's record (its tokens, the first one's index, the
  layer's token count) equal to the one without the plan: the counts,
  the capacity and the drops are the layer's, not the chunk's;
* 2 train steps: the metrics (``loss``, ``ce``, ``load_balance``,
  ``router_z``, ``grad_norm``, ``lr``), step 1's gradient of every leaf
  (after the exchange, gathered whole) and the weights after 2 steps
  against the reference and against the port without the plan;
* the values the checkpointed layer bodies keep at (2, 2), where FSDP
  recomputes each layer: half those without the plan;
* the boundary collectives (kind ``"seq"``) run exactly where the
  sequence splits.

Tolerances, those of ``tests/test_torch_seq_parallel.py``: prefill logits
within 1e-4 of the largest reference logit, decode logits 1e-3 (bf16
caches); the metrics rtol 1e-6; each gradient leaf within 5e-6 of its
largest magnitude; the weights after 2 steps by ``_check_weights``
(``tests/test_torch_mesh_train.py``); the kept pairs exactly.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_mesh_train import _check_weights, _prefix
from test_torch_seq_parallel import (DECODE_SHARE, GRAD_SHARE, LOGIT_SHARE,
                                     METRIC_RTOL, _logits, _mesh, _share)
from torch_mesh_ranks import MESHES, moe_sp_cfg, run_world

from repro_torch.core.codesign import CodesignPlan
from repro_torch.launch import steps
from repro_torch.models.api import build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_seq_parallel")
    try:
        ref, ranks, _ = run_world("moe_seq_parallel", out, timeout_s=600.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _mesh_of(meta, case: str) -> str:
    return meta["moe_sp"][case][1]


def _splits(meta, case: str, S: int) -> bool:
    """Whether a sequence of ``S`` splits over the case's model axis."""
    return S % MESHES[_mesh_of(meta, case)][1] == 0


def _serve_cases(meta):
    for case in meta["moe_sp"]:
        for S in meta["sp_prompts"]:
            yield case, S, f"msp/serve/{case}-{S}"


def _impl(meta, case: str) -> str:
    """The MoE path the case's mesh takes (``ShardCtx.choose_moe``)."""
    cfg = moe_sp_cfg(meta, case)
    api = build(cfg)
    ctx = steps.make_ctx(api, _mesh(MESHES[_mesh_of(meta, case)]),
                         CodesignPlan(sharding="tp", seq_parallel=True),
                         "ref")
    return ctx.choose_moe(cfg)


def _kept(rank_out, prefix: str, call: int):
    keep = rank_out[f"{prefix}/{call}/keep"]
    first, total = (int(v) for v in rank_out[f"{prefix}/{call}/span"])
    return keep, first, total


def _assembled(ranks, prefix: str, call: int) -> np.ndarray:
    """The kept flags of MoE call ``call`` over the layer's tokens, each
    rank's written at its span (ranks that route the same tokens must
    agree)."""
    total = _kept(ranks[0], prefix, call)[2]
    k = ranks[0][f"{prefix}/{call}/keep"].shape[1]
    got = np.zeros((total, k), dtype=np.int8) - 1
    for r in ranks:
        keep, first, t = _kept(r, prefix, call)
        assert t == total, (prefix, call)
        seen = got[first:first + len(keep)]
        assert ((seen == -1) | (seen == keep)).all(), (prefix, call)
        got[first:first + len(keep)] = keep
    assert (got >= 0).all(), (prefix, call)
    return got.astype(bool)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_moe_sp_prefill_logits_match_reference(world):
    """Every case and prompt: the prefill logits under the plan against
    the reference's under the same plan."""
    ref, ranks, meta = world
    for case, S, key in _serve_cases(meta):
        got = _logits(ranks, meta, f"{key}/sp/logits", _mesh_of(meta, case))
        _share(got[0], ref[f"{key}/logits"], LOGIT_SHARE, key)


def test_moe_sp_serving_matches_port_without_sp(world):
    """The prefill and 2 teacher-forced decode steps under the plan
    against the port's run without it: within the reference tolerances
    where the sequence splits, bit for bit where it does not."""
    _, ranks, meta = world
    for case, S, key in _serve_cases(meta):
        m = _mesh_of(meta, case)
        got = _logits(ranks, meta, f"{key}/sp/logits", m)
        want = _logits(ranks, meta, f"{key}/nosp/logits", m)
        assert got.shape == want.shape and got.shape[0] == 3, key
        if not _splits(meta, case, S):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        _share(got[0], want[0], LOGIT_SHARE, key)
        for step in (1, 2):
            _share(got[step], want[step], DECODE_SHARE, (key, step))


def test_moe_sp_prefill_gathers_only_where_the_sequence_splits(world):
    """The collectives of kind ``"seq"`` run in a prefill exactly where
    the plan splits its sequence, on every rank, and never without the
    plan."""
    _, ranks, meta = world
    for case, S, key in _serve_cases(meta):
        for r in ranks:
            seq_s = float(r[f"{key}/sp/seq_s"])
            assert (seq_s > 0) == _splits(meta, case, S), (key, seq_s)
            assert float(r[f"{key}/nosp/seq_s"]) == 0.0, key


# ---------------------------------------------------------------------------
# The token blocks: kept pairs and counts
# ---------------------------------------------------------------------------


def _kept_runs(meta):
    """(what, kept-record prefix of a run, the reference's keep entry,
    the case) of every prefill and step 1 of every case."""
    for case, S, key in _serve_cases(meta):
        for run in ("sp", "nosp"):
            yield (key, run), f"{key}/{run}/kept", f"{key}/keep", case
    for case in meta["moe_sp"]:
        for run in ("sp", "nosp"):
            key = f"msp/train/{case}"
            yield (key, run), f"{key}/{run}/kept", f"{key}/keep", case


def test_moe_sp_kept_pairs_match_shard_keep(world):
    """Each MoE layer's kept pairs over the layer's tokens (the ranks'
    records assembled at their spans), in every prefill and in step 1's
    forward, with and without the plan: ``shard_keep`` of the reference's
    own layer input, exactly."""
    ref, ranks, meta = world
    for what, prefix, want_key, _ in _kept_runs(meta):
        want = ref[want_key]
        calls = int(ranks[0][f"{prefix}/calls"])
        assert calls == len(want), (what, calls)
        for layer in range(calls):
            got = _assembled(ranks, prefix, layer)
            np.testing.assert_array_equal(got, want[layer],
                                          err_msg=f"{what} {layer}")


def test_moe_sp_records_equal_the_runs_without_the_plan(world):
    """Every rank's record of every MoE call under the plan, its kept
    flags, the first token's index and the layer's token count, equals
    the run's without the plan: the plan moves no token between shards
    and shrinks no count (the capacity follows the shard's tokens)."""
    _, ranks, meta = world
    for what, prefix, _, _ in _kept_runs(meta):
        if what[1] != "sp":
            continue
        nosp = prefix[:-len("sp/kept")] + "nosp/kept"
        for r in ranks:
            calls = int(r[f"{prefix}/calls"])
            assert calls == int(r[f"{nosp}/calls"]), what
            for i in range(calls):
                a, b = _kept(r, prefix, i), _kept(r, nosp, i)
                np.testing.assert_array_equal(a[0], b[0], err_msg=str(what))
                assert a[1:] == b[1:], (what, i, a[1:], b[1:])


def test_moe_sp_counts_are_the_layers(world):
    """The token count each record holds is the layer's (B x S over the
    whole batch), and each rank routes the reference's block of it:
    under ``moe_ep`` the quarter at index d m + i of the (data, model)
    split, under ``moe_tp`` its data row's tokens, the same on every
    model rank."""
    ref, ranks, meta = world
    for what, prefix, want_key, case in _kept_runs(meta):
        d, m = MESHES[_mesh_of(meta, case)]
        total = ref[want_key].shape[1]
        impl = _impl(meta, case)
        for rank, r in enumerate(ranks):
            di, mi = divmod(rank, m)
            for i in range(int(r[f"{prefix}/calls"])):
                keep, first, t = _kept(r, prefix, i)
                assert t == total, (what, rank, t, total)
                if impl == "ep":
                    n = total // (d * m)
                    want_first = (di * m + mi) * n
                else:
                    n = total // d
                    want_first = di * n
                assert (first, len(keep)) == (want_first, n), (
                    what, rank, first, len(keep))


def test_moe_sp_cases_cover_both_paths_and_drops(world):
    """The cases take ``moe_ep`` and ``moe_tp``; at a capacity factor of
    1.25 the shards drop pairs in every prefill and in step 1, and at the
    smoke config's 2.0 with 4 experts none."""
    ref, _, meta = world
    assert {_impl(meta, c) for c in meta["moe_sp"]} == {"ep", "tp"}
    for what, _, want_key, case in _kept_runs(meta):
        dropped = int((~ref[want_key]).sum())
        cf = meta["moe_sp"][case][3]
        assert (dropped > 0) == (cf is not None), (what, dropped)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_moe_sp_train_steps_match_reference(world):
    """Each case's metrics on every rank and every gathered weight after
    2 steps, against the reference's ``make_train_step`` under the same
    plan."""
    ref, ranks, meta = world
    for case in meta["moe_sp"]:
        key = f"msp/train/{case}"
        want = ref[f"{key}/metrics"]
        assert want.shape == (2, len(meta["train_metrics"])), case
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/sp/metrics"], want,
                                       rtol=METRIC_RTOL, err_msg=case)
        _check_weights(_prefix(ranks[0], f"{key}/sp/final/"),
                       _prefix(ref, f"{key}/final/"),
                       _prefix(ref, f"msp/params/{case}/"),
                       meta["train_lr"], case)


def test_moe_sp_step1_gradients_match_reference(world):
    """Step 1's gradient of every leaf (after the exchange, gathered
    whole) against ``jax.value_and_grad`` of the reference's loss under
    the plan, and step 1's loss against the reference's."""
    ref, ranks, meta = world
    for case in meta["moe_sp"]:
        want = _prefix(ref, f"msp/grads/{case}/grads/")
        got = _prefix(ranks[0], f"msp/train/{case}/sp/grads/")
        assert got.keys() == want.keys(), case
        for k in want:
            _share(got[k], want[k], GRAD_SHARE, (case, k))
        np.testing.assert_allclose(
            ranks[0][f"msp/train/{case}/sp/metrics"][0, 0],
            float(ref[f"msp/grads/{case}/loss"]), rtol=METRIC_RTOL,
            err_msg=case)


def test_moe_sp_train_matches_port_without_sp(world):
    """The same steps without the plan: the metrics, step 1's gradients
    and the final weights under the same tolerances."""
    ref, ranks, meta = world
    for case in meta["moe_sp"]:
        key = f"msp/train/{case}"
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/sp/metrics"],
                                       r[f"{key}/nosp/metrics"],
                                       rtol=METRIC_RTOL, err_msg=case)
        want = _prefix(ranks[0], f"{key}/nosp/grads/")
        got = _prefix(ranks[0], f"{key}/sp/grads/")
        assert got.keys() == want.keys(), case
        for k in want:
            _share(got[k], want[k], GRAD_SHARE, (case, k))
        _check_weights(_prefix(ranks[0], f"{key}/sp/final/"),
                       _prefix(ranks[0], f"{key}/nosp/final/"),
                       _prefix(ref, f"msp/params/{case}/"),
                       meta["train_lr"], case)


def test_moe_sp_layer_boundaries_hold_the_rank_chunk(world):
    """At (2, 2) under FSDP + EP each layer is recomputed in the backward
    pass, and its checkpoint keeps its input: under the plan the rank's
    4 rows by S / 2 positions by d_model, half of what the same step
    keeps without it (S 24, then 18).  Every rank keeps the same."""
    ref, ranks, meta = world
    held = 0
    for case in meta["moe_sp"]:
        if _mesh_of(meta, case) != "2x2":
            continue
        cfg, key = moe_sp_cfg(meta, case), f"msp/train/{case}"
        b = len(ref[f"{key}/batches/0/tokens"]) // 2
        for step in range(2):
            S = ref[f"{key}/batches/{step}/tokens"].shape[1]
            want = cfg.n_layers * b * S * cfg.d_model
            for r in ranks:
                assert int(r[f"{key}/nosp/kept"][step]) == want, (case, step)
                assert 2 * int(r[f"{key}/sp/kept"][step]) == want, (
                    case, step)
        held += 1
    assert held == 2, held


def test_moe_sp_train_steps_gather_where_the_sequence_splits(world):
    """The train steps spend time in collectives of kind ``"seq"`` under
    the plan exactly at the steps whose sequence splits (at (1, 4) step
    2's 18 positions do not), never without it."""
    ref, ranks, meta = world
    for case in meta["moe_sp"]:
        key = f"msp/train/{case}"
        split = [_splits(meta, case,
                         ref[f"{key}/batches/{i}/tokens"].shape[1])
                 for i in range(2)]
        for r in ranks:
            assert ((r[f"{key}/sp/seq_s"] > 0) == split).all(), (
                case, r[f"{key}/sp/seq_s"])
            assert (r[f"{key}/nosp/seq_s"] == 0).all(), case

