"""Megatron sequence parallelism on a mesh (``CodesignPlan(seq_parallel=True)``):
the port's ranks against the JAX package's run under the same plan, and
against the port without it.

One module fixture runs the JAX package once (``tests/jax_mesh_refs.py
seq_parallel``: 4 emulated CPU devices) and then one gloo world of 4
single-threaded ranks (``tests/torch_mesh_ranks.py``), both niced and
pinned to one core.  The file keeps under 27 tests (see
``tests/test_torch_mesh.py``).  Smoke widths, in f32, on the JAX model's
weights, at (1, 4) and (2, 2), for each family of the JAX run's
``SP_FAMILIES``: the dense family with heads that divide no model axis (3
query heads, one KV head: each rank computes every head for its block of
the query rows where the sequence divides the model axis, as smollm-360m's
15 heads are, the MLP split), the VLM (8 patches before the text; 4 query
heads over one KV head), the SSM and the hybrid (SSD chunk 6), the
enc-dec (vocab 258: its head split over 2, whole over 4).  Each runs a
sequence that divides a model axis of 4 (24) and one that divides only 2
(18), so (1, 4) runs the second without the split:

* ``Server(cfg, mesh, plan=CodesignPlan(sharding="tp",
  seq_parallel=True))``: prefill logits against the reference's under
  the same plan; prefill and 2 teacher-forced decode steps against the
  port's own run without sequence parallelism (the reference's mesh
  decode is at fault where the KV heads do not divide the model axis,
  ROADMAP queue 3), bit for bit where the sequence does not split;
* ``make_train_step(api, mesh, CodesignPlan(sharding="fsdp_tp",
  seq_parallel=True))`` for 2 steps (step 1 at 24 on both meshes, step 2
  at 18 at (2, 2); the enc-dec's frames and decoder tokens at 24 / 18 and
  18 / 24): the metrics, step 1's gradient of every leaf (after the
  exchange, gathered whole) and the final weights against the reference,
  and against the port without sequence parallelism;
* the values the checkpointed layer bodies keep (the (2, 2) FSDP steps
  recompute each layer): the layer inputs, S/m rows a rank;
* ``gather_seq`` / ``scatter_seq``, each with both gradients, against
  the one-process function;
* the query-sequence split of attention (``ShardCtx.seq_parallel_attn``,
  the reference's test: the dense family's 3 heads divide no model axis):
  the query rows each rank fed attention, its block exactly where the
  split holds, with and without the plan (S 24 on both meshes, S 18 at
  (2, 2)); the runs without the plan, now split, against the reference's
  arrays under the plan (the same function: the reference's layout
  constraints change no value); the output rows' gather (kind
  ``"qseq"``) exactly where the split runs without the plan.

Tolerances, those of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_family_mesh.py``: prefill logits within 1e-4 of the
largest reference logit, decode logits 1e-3 (bf16 caches), and so the
enc-dec's prefill logits too, which are its first decode step's against
its bf16 self and cross caches (seen: 8.5e-4 at (1, 4) over 24 frames,
4.1e-5 without the split; multiplying the encoder's weights by 1 + 1e-7
noise moves the same logits by up to 8.6e-4 of the largest); the metrics
rtol 1e-6; each gradient leaf within 5e-6 of its largest magnitude; the
weights after 2 steps by ``_check_weights``; the collectives 1e-6.
``psum_scatter`` sums the model ranks' partial sums in member order in
f32, where the sum without the split is an ``all_reduce``: the values
move by f32 rounding.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.models.blocks import ShardCtx as RefCtx
from test_torch_mesh_train import _check_weights, _prefix
from torch_mesh_ranks import (MESHES, SEQ_CHUNK, WORLD, run_world,
                              seq_inputs, sp_cfg)

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core.codesign import CodesignPlan
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.weights import param_shapes

torch.set_num_threads(1)

LOGIT_SHARE, DECODE_SHARE = 1e-4, 1e-3
METRIC_RTOL, GRAD_SHARE = 1e-6, 5e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_parallel")
    try:
        ref, ranks, _ = run_world("seq_parallel", out, timeout_s=600.0)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ref, ranks, json.loads(str(ref["meta"]))


def _serve_cases(meta):
    for name in meta["sp_families"]:
        for m in meta["sp_meshes"]:
            for S in meta["sp_prompts"]:
                yield name, m, S, f"{name}-{m}-{S}"


def _splits(meta, name: str, m: str, S: int) -> bool:
    """Whether the served sequence of ``S`` splits over the model axis."""
    return S % MESHES[m][1] == 0


def _logits(ranks, meta, key: str, m: str) -> np.ndarray:
    """The whole batch's logits (steps, B, 1, V): each data row's ranks
    hold its rows (every model rank the same)."""
    d, mm = MESHES[m]
    rows = [ranks[i * mm][key] for i in range(d)]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][key], rows[r // mm])
    return np.concatenate(rows, axis=1)


def _prefill_share(meta, name: str) -> float:
    """The prefill logits' bound: an enc-dec's are a decode step's."""
    return (DECODE_SHARE if sp_cfg(name, meta).family == "encdec"
            else LOGIT_SHARE)


def _share(got, want, share, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= share * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# The sequence collectives
# ---------------------------------------------------------------------------


def test_seq_collectives_carry_gradients(world):
    """On the (1, 4) mesh: ``gather_seq`` concatenates the chunks; its
    gradient is the sum of the members' gradients of the whole sequence,
    chunked (``partial``), or the member's chunk of the one shared
    gradient; ``scatter_seq`` sums the members' partial sums chunk by
    chunk (``partial``) or takes the member's chunk, and its gradient is
    the members' chunk gradients gathered."""
    _, ranks, _ = world
    ins = [seq_inputs(r) for r in range(WORLD)]
    c = SEQ_CHUNK[1]
    whole_x = np.concatenate([i[0] for i in ins], axis=1)
    ws = sum(i[3] for i in ins)
    w_all = np.concatenate([i[2] for i in ins], axis=1)
    for r, out in enumerate(ranks):
        chunk = slice(r * c, (r + 1) * c)
        want = {
            "gather_partial": (whole_x, ws[:, chunk]),
            "gather_whole": (whole_x, ins[0][3][:, chunk]),
            "scatter_partial": (sum(i[1] for i in ins)[:, chunk], w_all),
            "scatter_whole": (ins[0][1][:, chunk], w_all),
        }
        for name, (y, g) in want.items():
            np.testing.assert_allclose(out[f"seqcoll/{name}/y"], y,
                                       atol=1e-6, err_msg=f"{name} {r}")
            np.testing.assert_allclose(out[f"seqcoll/{name}/grad"], g,
                                       atol=1e-6, err_msg=f"{name} {r}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_sp_prefill_logits_match_reference(world):
    """Every family, mesh and prompt: the prefill logits under sequence
    parallelism against the reference's under the same plan."""
    ref, ranks, meta = world
    for name, m, S, case in _serve_cases(meta):
        got = _logits(ranks, meta, f"sp/serve/{case}/sp/logits", m)[0]
        _share(got, ref[f"sp/serve/{case}/logits"],
               _prefill_share(meta, name), case)


def test_sp_serving_matches_port_without_sp(world):
    """The prefill and 2 teacher-forced decode steps under sequence
    parallelism against the port's run without it: within the reference
    tolerances where the sequence splits, bit for bit where it does not
    (the layout is then the one without the split)."""
    _, ranks, meta = world
    for name, m, S, case in _serve_cases(meta):
        got = _logits(ranks, meta, f"sp/serve/{case}/sp/logits", m)
        want = _logits(ranks, meta, f"sp/serve/{case}/nosp/logits", m)
        assert got.shape == want.shape and got.shape[0] == 3, case
        if not _splits(meta, name, m, S):
            np.testing.assert_array_equal(got, want, err_msg=case)
            continue
        _share(got[0], want[0], _prefill_share(meta, name), case)
        for step in (1, 2):
            _share(got[step], want[step], DECODE_SHARE, (case, step))


def test_sp_prefill_gathers_only_where_the_sequence_splits(world):
    """The collectives of kind ``"seq"`` run in a prefill exactly where
    the plan splits its sequence (the enc-dec's: its frames), on every
    rank, and never without the plan."""
    _, ranks, meta = world
    for name, m, S, case in _serve_cases(meta):
        for r in ranks:
            seq_s = float(r[f"sp/serve/{case}/sp/seq_s"])
            assert (seq_s > 0) == _splits(meta, name, m, S), (case, seq_s)
            assert float(r[f"sp/serve/{case}/nosp/seq_s"]) == 0.0, case


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _train_cases(meta):
    for name in meta["sp_families"]:
        for m in meta["sp_meshes"]:
            yield name, m, f"{name}-{m}"


def test_sp_train_steps_match_reference(world):
    """Each case's metrics on every rank (step 1's loss and gradient norm
    among them) and every gathered weight after 2 steps, against the
    reference's ``make_train_step`` under the same plan."""
    ref, ranks, meta = world
    for name, m, case in _train_cases(meta):
        want = ref[f"sp/train/{case}/metrics"]
        assert want.shape[0] == 2, case
        for r in ranks:
            np.testing.assert_allclose(r[f"sp/train/{case}/sp/metrics"],
                                       want, rtol=METRIC_RTOL, err_msg=case)
        _check_weights(_prefix(ranks[0], f"sp/train/{case}/sp/final/"),
                       _prefix(ref, f"sp/train/{case}/final/"),
                       _prefix(ref, f"sp/params/{name}/"),
                       meta["train_lr"], case)


def test_sp_step1_gradients_match_reference(world):
    """Step 1's gradient of every leaf (after the exchange: the norm
    scales' summed over the model axis; gathered whole) against
    ``jax.value_and_grad`` of the reference's loss under the plan, and
    step 1's loss against the reference's."""
    ref, ranks, meta = world
    for name, m, case in _train_cases(meta):
        want = _prefix(ref, f"sp/grads/{name}/grads/")
        got = _prefix(ranks[0], f"sp/train/{case}/sp/grads/")
        assert got.keys() == want.keys(), case
        for k in want:
            _share(got[k], want[k], GRAD_SHARE, (case, k))
        np.testing.assert_allclose(
            ranks[0][f"sp/train/{case}/sp/metrics"][0, 0],
            float(ref[f"sp/grads/{name}/loss"]), rtol=METRIC_RTOL,
            err_msg=case)


def test_sp_train_matches_port_without_sp(world):
    """The same steps without sequence parallelism: the metrics, step 1's
    gradients and the final weights under the same tolerances."""
    ref, ranks, meta = world
    for name, m, case in _train_cases(meta):
        run = f"sp/train/{case}"
        for r in ranks:
            np.testing.assert_allclose(r[f"{run}/sp/metrics"],
                                       r[f"{run}/nosp/metrics"],
                                       rtol=METRIC_RTOL, err_msg=case)
        want = _prefix(ranks[0], f"{run}/nosp/grads/")
        got = _prefix(ranks[0], f"{run}/sp/grads/")
        assert got.keys() == want.keys(), case
        for k in want:
            _share(got[k], want[k], GRAD_SHARE, (case, k))
        _check_weights(_prefix(ranks[0], f"{run}/sp/final/"),
                       _prefix(ranks[0], f"{run}/nosp/final/"),
                       _prefix(ref, f"sp/params/{name}/"),
                       meta["train_lr"], case)


def _bodies(cfg) -> int:
    """The checkpointed layer bodies of a decoder's forward: its layers,
    and the hybrid's shared block at each site."""
    sites = (len(range(0, cfg.n_layers, cfg.attn_every))
             if cfg.family == "hybrid" else 0)
    return cfg.n_layers + sites


def test_sp_layer_boundaries_hold_the_rank_chunk(world):
    """At (2, 2) under FSDP + TP each layer is recomputed in the backward
    pass, and what its checkpoint keeps is its input: with the split, the
    rank's rows (8 / 2) by S / 2 positions by d_model, half of what the
    same step keeps without it (S 24, then 18: 9 positions a rank).  The
    enc-dec's decoder layers also keep the gathered encoder states they
    read.  Every rank keeps the same."""
    ref, ranks, meta = world
    for name in meta["sp_families"]:
        cfg, case = sp_cfg(name, meta), f"sp/train/{name}-2x2"
        b = len(ref[f"{case}/batches/0/tokens"]) // 2
        for step in range(2):
            if cfg.family == "encdec":
                s_enc = ref[f"{case}/batches/{step}/frames"].shape[1]
                s_dec = ref[f"{case}/batches/{step}/tokens"].shape[1]
                kept = {sp: b * cfg.d_model * (
                    cfg.enc_layers * s_enc // (2 if sp else 1)
                    + cfg.n_layers * (s_dec // (2 if sp else 1) + s_enc))
                    for sp in (True, False)}
            else:
                S = ref[f"{case}/batches/{step}/tokens"].shape[1] + (
                    cfg.frontend_len if cfg.family == "vlm" else 0)
                kept = {sp: _bodies(cfg) * b * (S // (2 if sp else 1))
                        * cfg.d_model for sp in (True, False)}
                assert 2 * kept[True] == kept[False]
            for r in ranks:
                assert int(r[f"{case}/sp/kept"][step]) == kept[True], (
                    name, step)
                assert int(r[f"{case}/nosp/kept"][step]) == kept[False], (
                    name, step)


def test_sp_train_steps_gather_where_the_sequence_splits(world):
    """The train steps spend time in collectives of kind ``"seq"`` under
    the plan (every step splits a sequence: at (1, 4) step 2 repeats step
    1's lengths, and the enc-dec's frames split there), never without
    it."""
    _, ranks, meta = world
    for name, m, case in _train_cases(meta):
        for r in ranks:
            seq_s = r[f"sp/train/{case}/sp/seq_s"]
            assert (seq_s > 0).all(), (case, seq_s)
            assert (r[f"sp/train/{case}/nosp/seq_s"] == 0).all(), case


# ---------------------------------------------------------------------------
# The query-sequence split of attention
# ---------------------------------------------------------------------------


def _split(meta, name: str, m: str, s: int) -> bool:
    """Whether attention over ``s`` positions splits its query rows on
    mesh ``m``: the reference's ``seq_parallel_attn`` of the family's
    query heads, the mesh given by its shape alone (never for the SSM
    family, which has no attention)."""
    d, mm = MESHES[m]
    mesh = SimpleNamespace(shape={"data": d, "model": mm})
    cfg = sp_cfg(name, meta)
    return cfg.family != "ssm" and RefCtx(mesh=mesh).seq_parallel_attn(
        cfg.n_heads, s)


def _rows_ok(rows, meta, name, m, r, what):
    """Each entry (first, end, S, calls) of rank ``r``'s record: its block
    of S/m rows where the split holds for S, every row where it does not.
    Returns the sequence lengths that split."""
    mm = MESHES[m][1]
    split = set()
    for first, end, S, calls in rows.tolist():
        assert calls > 0, what
        if _split(meta, name, m, S):
            c = S // mm
            assert (first, end) == ((r % mm) * c, (r % mm + 1) * c), (
                what, r, first, end, S)
            split.add(S)
        else:
            assert (first, end) == (0, S), (what, r, first, end, S)
    return split


def test_query_split_runs_where_seq_parallel_attn_holds(world):
    """The port's test is the reference's (every head count 1..16 at
    every sequence of 1..30 on each mesh); then the query rows each rank
    fed attention in every prefill and train step, with and without the
    plan: rank i's block ``[i S/m, (i + 1) S/m)`` exactly where the split
    holds, every row elsewhere, a decode step's one row whole.  It holds
    for the dense family (3 query heads) at S 24 on both meshes and at S
    18 at (2, 2), once per layer, and for no other family."""
    ref, ranks, meta = world
    for m in meta["sp_meshes"]:
        ctx = ShardCtx(mesh=_mesh(MESHES[m]))
        rctx = RefCtx(mesh=SimpleNamespace(shape=dict(
            zip(("data", "model"), MESHES[m]))))
        for h in range(1, 17):
            for S in range(1, 31):
                assert ctx.seq_parallel_attn(h, S) == \
                    rctx.seq_parallel_attn(h, S), (m, h, S)
    for name, m, S, case in _serve_cases(meta):
        cfg = sp_cfg(name, meta)
        for r, out in enumerate(ranks):
            for run in ("sp", "nosp"):
                what = (case, run)
                split = _rows_ok(out[f"sp/serve/{case}/{run}/qrows"], meta,
                                 name, m, r, what)
                want = {S} if name == "smollm3" and (
                    m == "2x2" or S % 4 == 0) else set()
                assert split == want, (what, split)
                if want:
                    assert out[f"sp/serve/{case}/{run}/qrows"][:, 3].tolist() \
                        == [cfg.n_layers], what
                decode = out[f"sp/serve/{case}/{run}/decode_qrows"]
                assert all(row[:3] == [0, 1, 1] for row in decode.tolist()), (
                    what, decode)
    for name, m, case in _train_cases(meta):
        for r, out in enumerate(ranks):
            for run in ("sp", "nosp"):
                for i in range(2):
                    what = (case, run, i)
                    split = _rows_ok(
                        out[f"sp/train/{case}/{run}/qrows/{i}"], meta, name,
                        m, r, what)
                    assert bool(split) == (name == "smollm3"), (what, split)


def test_query_split_without_plan_matches_reference(world):
    """Where the split runs without the plan (the dense family's), the
    port's prefill logits, its train steps' metrics, step 1's gradient of
    every leaf and the weights after 2 steps against the reference's run
    under the plan: the file's tolerances."""
    ref, ranks, meta = world
    held = 0
    for name, m, S, case in _serve_cases(meta):
        if not _split(meta, name, m, S):
            continue
        got = _logits(ranks, meta, f"sp/serve/{case}/nosp/logits", m)[0]
        _share(got, ref[f"sp/serve/{case}/logits"],
               _prefill_share(meta, name), case)
        held += 1
    for name, m, case in _train_cases(meta):
        steps_s = [ref[f"sp/train/{case}/batches/{i}/tokens"].shape[1]
                   for i in range(2)]
        if sp_cfg(name, meta).family != "dense" or not all(
                _split(meta, name, m, s) for s in steps_s):
            continue
        run = f"sp/train/{case}/nosp"
        for r in ranks:
            np.testing.assert_allclose(r[f"{run}/metrics"],
                                       ref[f"sp/train/{case}/metrics"],
                                       rtol=METRIC_RTOL, err_msg=case)
        want = _prefix(ref, f"sp/grads/{name}/grads/")
        got = _prefix(ranks[0], f"{run}/grads/")
        assert got.keys() == want.keys(), case
        for k in want:
            _share(got[k], want[k], GRAD_SHARE, (case, k))
        _check_weights(_prefix(ranks[0], f"{run}/final/"),
                       _prefix(ref, f"sp/train/{case}/final/"),
                       _prefix(ref, f"sp/params/{name}/"),
                       meta["train_lr"], case)
        held += 1
    # 3 prompts (24 at both meshes, 18 at (2, 2)) and 2 train cases
    assert held == 5, held


def test_query_split_gathers_rows_only_without_plan(world):
    """The gather of the split's output rows (kind ``"qseq"``) spends time
    in a prefill or train step exactly where the split runs without the
    plan, on every rank; under the plan the rows are the rank's chunk
    already and nothing is spent in it."""
    ref, ranks, meta = world
    for name, m, S, case in _serve_cases(meta):
        for r in ranks:
            qseq = float(r[f"sp/serve/{case}/nosp/qseq_s"])
            assert (qseq > 0) == _split(meta, name, m, S), (case, qseq)
            assert float(r[f"sp/serve/{case}/sp/qseq_s"]) == 0.0, case
    for name, m, case in _train_cases(meta):
        for r in ranks:
            qseq = r[f"sp/train/{case}/nosp/qseq_s"]
            assert ((qseq > 0) == (name == "smollm3")).all(), (case, qseq)
            assert (r[f"sp/train/{case}/sp/qseq_s"] == 0).all(), case


# ---------------------------------------------------------------------------
# The plan's entry points (in process)
# ---------------------------------------------------------------------------


def _mesh(shape):
    return Mesh({"data": shape[0], "model": shape[1]}, ("data", "model"),
                rank=0, coords={"data": 0, "model": 0}, groups={})


def test_sp_plan_is_accepted_for_every_config():
    """``make_ctx``, ``make_train_step``, ``make_serve_step``,
    ``make_prefill_step``, ``Trainer(cfg, mesh, plan=...)`` and
    ``Server(cfg, mesh, plan=...)`` take ``seq_parallel=True`` for every
    config, the MoE pair (qwen3-moe and mixtral) included: the context
    records it, and no maker raises.  ``Server``'s default plan is the
    reference's, and the trainer's default takes no split."""
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import Trainer
    plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=True)
    mesh = _mesh((2, 2))
    moe = []
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        api = build(cfg)
        makers = (
            lambda: steps.make_ctx(api, mesh, plan, "ref", train=True),
            lambda: steps.make_train_step(api, mesh, plan)[1],
            lambda: steps.make_serve_step(api, mesh, plan)[1],
            lambda: steps.make_prefill_step(api, mesh, plan,
                                            max_len=32)[1],
            lambda: Trainer(cfg, mesh, plan=plan, device="cpu").ctx,
            lambda: Server(cfg, mesh, device="cpu", plan=plan).ctx)
        for make in makers:
            ctx = make()
            assert ctx.seq_parallel and ctx.shards_act(24), arch
            assert not ctx.shards_act(9) and not ctx.shards_act(1)
        moe += [arch] if cfg.moe else []
    assert sorted(moe) == ["mixtral-8x22b", "qwen3-moe-30b-a3b"]
    server = Server(get_smoke_config("smollm-360m"), mesh, device="cpu")
    assert server.plan == CodesignPlan(sharding="tp", seq_parallel=False)
    assert not server.ctx.seq_parallel
    assert not steps.default_plan(build(get_smoke_config(
        "smollm-360m"))).seq_parallel


def test_shards_act_is_the_reference_test():
    """The split holds where the reference's ``shard_act`` shards the
    sequence: under the plan, on a model axis m > 1, for S > 1 that m
    divides (a decode step's S = 1 never; the GPipe stage mesh's model
    axis of 1 never)."""
    api = build(get_smoke_config("smollm-360m"))
    plan = CodesignPlan(sharding="tp", seq_parallel=True)
    for shape in ((1, 4), (2, 2), (4, 1)):
        ctx = steps.make_ctx(api, _mesh(shape), plan, "ref")
        m = shape[1]
        for S in (1, 2, 3, 4, 6, 8, 18, 24, 1025):
            assert ctx.shards_act(S) == (m > 1 and S > 1 and S % m == 0), (
                shape, S)
        off = steps.make_ctx(api, _mesh(shape), None, "ref")
        assert not any(off.shards_act(S) for S in (2, 4, 24))
    assert not steps.make_ctx(api, None, plan, "ref").shards_act(24)


def test_chunked_leaves_follow_each_stack():
    """The train step sums over the model axis the gradient of each norm
    scale applied to a chunk: a decoder's every norm where its sequence
    (a VLM's patches and text) splits; the enc-dec's encoder norms by its
    frames and its decoder norms and ``final_norm`` by its tokens; no
    other leaf."""
    mesh = _mesh((1, 4))
    plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=True)
    norms = {"ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm"}
    for arch, batches in (
            ("smollm-360m", (({"tokens": (2, 24)}, True),
                             ({"tokens": (2, 18)}, False))),
            ("llava-next-mistral-7b", (({"tokens": (2, 16)}, True),
                                       ({"tokens": (2, 10)}, False))),
            ("zamba2-1.2b", (({"tokens": (2, 32)}, True),))):
        cfg = get_smoke_config(arch)
        api = build(cfg)
        ctx = steps.make_ctx(api, mesh, plan, "ref", train=True)
        names = list(param_shapes(cfg))
        for shapes, split in batches:
            batch = {k: torch.zeros(v) for k, v in shapes.items()}
            got = steps.chunked_leaves(names, cfg, ctx, batch)
            want = [split and n.split(".")[-1] in norms for n in names]
            assert got == want, (arch, shapes)
            assert any(got) == split
    cfg = get_smoke_config("seamless-m4t-large-v2")
    api = build(cfg)
    ctx = steps.make_ctx(api, mesh, plan, "ref", train=True)
    names = list(param_shapes(cfg))
    for s_enc, s_dec in ((24, 18), (18, 24), (24, 24), (18, 18)):
        batch = {"frames": torch.zeros(2, s_enc, 4),
                 "tokens": torch.zeros(2, s_dec)}
        got = steps.chunked_leaves(names, cfg, ctx, batch)
        for n, g in zip(names, got):
            enc = n.startswith(("enc_layers.", "enc_norm"))
            split = (s_enc if enc else s_dec) % 4 == 0
            assert g == (split and n.split(".")[-1] in norms), (n, s_enc,
                                                                 s_dec)
