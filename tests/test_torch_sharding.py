"""The port's sharding rules against the JAX package's, in one process.

``param_specs`` for all 11 configs at full width (the JAX tree from
``jax.eval_shape``, the port's from an init on the ``meta`` device: no
memory), with and without FSDP, on meshes (1, 4), (2, 2) and (4, 1); and
``_token_axes``, ``_capacity`` and ``choose_moe_impl``.  The JAX
functions are called with a stand-in mesh that has ``shape`` (a dict) and
``axis_names``, all they read; the JAX package is not patched.  Then the
port's own pieces that need no world: ``rank_spec`` on a serving mesh
(the table without FSDP or a head split), ``shard_tensor``, ``ShardCtx.heads``, the meshes' shapes,
the draws of ``weights.init_sharded`` and the families a mesh refuses.
Each test loops over its cases, so the file keeps under 27 tests (see
``tests/test_torch_mesh.py``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import ffn as jffn
from repro.models.api import build as jbuild
from repro.parallel import sharding as jsharding

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ffn
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.parallel import sharding

torch.set_num_threads(1)

MESHES = [(1, 4), (2, 2), (4, 1)]


class StandIn:
    """What the JAX package's rules read of a mesh."""

    def __init__(self, shape, axes=("data", "model")):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch: str):
    """(path, shape) of every leaf of the JAX model's tree, abstractly."""
    api = jbuild(jget_config(arch))
    tree = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
    return tree, [(jsharding._leaf_path(p), tuple(v.shape))
                  for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str) -> dict:
    """The port's parameter names and shapes, from an init on ``meta``."""
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.lm import init_lm
    cfg = get_config(arch)
    init = init_encdec if cfg.family == "encdec" else init_lm
    params = init(cfg, generator=torch.Generator(), device="meta")
    return {n: tuple(p.shape) for n, p in params.named_parameters()}


def _norm(spec) -> tuple:
    """A spec as plain tuples (a PartitionSpec writes ("data",) as
    "data")."""
    one = lambda a: a[0] if isinstance(a, tuple) and len(a) == 1 else a
    return tuple(one(a) for a in spec)


def test_every_config_is_covered():
    assert list_archs() == jlist_archs()


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch):
    """Each port parameter takes the spec of its JAX leaf (a layer of a
    stacked leaf: without the leading layer entry), with and without FSDP,
    on each mesh."""
    for shape in MESHES:
        for fsdp in (True, False):
            _check_param_specs(arch, shape, fsdp)


def _check_param_specs(arch, shape, fsdp):
    tree, leaves = _jax_leaves(arch)
    mesh = StandIn(shape)
    want_tree = jsharding.param_specs(tree, jget_config(arch), mesh, fsdp=fsdp)
    want = {p: _norm(s) for (p, _), s in zip(
        leaves, jax.tree_util.tree_leaves(
            want_tree, is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec)))}
    shapes = _port_shapes(arch)
    got = sharding.param_specs(shapes, get_config(arch),
                               Mesh.abstract(shape, ("data", "model")),
                               fsdp=fsdp)
    jshape = dict(leaves)
    for name, spec in got.items():
        path = sharding.jax_path(name)
        stacked = path != name.replace(".", "/")
        ref = want[path][1:] if stacked else want[path]
        assert _norm(spec) == ref, (name, spec, ref)
        assert (jshape[path][1:] if stacked else jshape[path]) == shapes[name]
    assert {sharding.jax_path(n) for n in got} == set(want)


def test_token_axes_match_reference():
    for total in (1, 2, 3, 4, 6, 8, 16, 9216):
        for shape in MESHES + [(2, 4), (8, 1)]:
            mesh = StandIn(shape)
            assert ffn._token_axes(total, mesh, ("data",), "model") == \
                jffn._token_axes(total, mesh, ("data",), "model")
    mesh = StandIn((2, 2, 2), ("pod", "data", "model"))
    for total in (1, 2, 4, 8, 12, 16):
        assert ffn._token_axes(total, mesh, ("pod", "data"), "model") == \
            jffn._token_axes(total, mesh, ("pod", "data"), "model")


def test_capacity_matches_reference():
    for tokens in (1, 2, 7, 20, 2304, 9216):
        for cf in (1.0, 1.25, 2.0, 8.0):
            for k, e in ((2, 8), (8, 128), (2, 4)):
                assert ffn._capacity(tokens, k, e, cf) == \
                    jffn._capacity(tokens, k, e, cf)


def test_choose_moe_impl_matches_reference():
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x22b"):
        for shape in MESHES + [(1, 16), (2, 16), (1, 3)]:
            mesh = StandIn(shape)
            assert ffn.choose_moe_impl(get_config(arch), mesh) == \
                jffn.choose_moe_impl(jget_config(arch), mesh), (arch, shape)


def test_batch_and_state_specs():
    assert sharding.batch_axes_of(StandIn((2, 2))) == ("data",)
    pod = StandIn((2, 2, 2), ("pod", "data", "model"))
    assert sharding.batch_axes_of(pod) == \
        jsharding.batch_axes_of(pod) == ("pod", "data")
    specs = sharding.batch_specs({"tokens": np.zeros((8, 16)),
                                  "frames": np.zeros((8, 16, 4))}, pod)
    assert specs == {"tokens": (("pod", "data"), None),
                     "frames": (("pod", "data"), None, None)}
    # AdamW's master, m and v mirror the parameters
    from repro_torch.optim.adamw import adamw_init
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    params = build(cfg).init(0, device="cpu")
    names = [n for n, _ in params.named_parameters()]
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    st = sharding.state_shardings(adamw_init(list(params.parameters())),
                                  names, cfg, mesh)
    specs = sharding.param_specs(
        {n: tuple(p.shape) for n, p in params.named_parameters()}, cfg, mesh)
    assert st.step == ()
    for field in ("master", "m", "v"):
        assert getattr(st, field) == [specs[n] for n in names]


# ---------------------------------------------------------------------------
# The port's own pieces
# ---------------------------------------------------------------------------


def test_serve_spec_is_the_table_without_fsdp_or_a_split_head():
    for arch in ("phi3-mini-3.8b", "mixtral-8x22b", "mistral-large-123b",
                 "smollm-360m", "qwen3-moe-30b-a3b", "gemma3-1b"):
        for shape in MESHES:
            _check_serve_spec(arch, shape)


def _check_serve_spec(arch, shape):
    cfg = get_config(arch)
    mesh = Mesh.abstract(shape, ("data", "model"))
    m = shape[1]
    shapes = _port_shapes(arch)
    table = sharding.param_specs(shapes, cfg, mesh, fsdp=False)
    q_split = m > 1 and cfg.n_heads % m == 0
    kv_split = q_split and cfg.n_kv_heads % m == 0
    for name, s in shapes.items():
        leaf = name.split(".")[-1]
        got = sharding.rank_spec(name, s, cfg, mesh)
        if leaf in ("wq", "wo") and not q_split or \
                leaf in ("wk", "wv") and not kv_split:
            assert got == (None,) * len(s)
        else:
            assert got == table[name]
        assert "data" not in got


def test_shard_tensor_takes_the_rank_s_block():
    t = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    for rank in range(4):
        mesh = Mesh({"data": 2, "model": 2}, ("data", "model"), rank=rank,
                    coords={"data": rank // 2, "model": rank % 2})
        d, m = rank // 2, rank % 2
        np.testing.assert_array_equal(
            sharding.shard_tensor(t, ("data", "model", None), mesh),
            t[2 * d:2 * d + 2, 3 * m:3 * m + 3])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tensor(t, (None, None, ("data", "model")), mesh)
    # over a tuple of axes, row-major
    t = torch.arange(8)
    for rank in range(4):
        mesh = Mesh({"data": 2, "model": 2}, ("data", "model"), rank=rank,
                    coords={"data": rank // 2, "model": rank % 2})
        got = sharding.shard_tensor(t, (("data", "model"),), mesh)
        np.testing.assert_array_equal(got, t[2 * rank:2 * rank + 2])


def _ctx(shape, rank):
    mesh = Mesh({"data": shape[0], "model": shape[1]}, ("data", "model"),
                rank=rank, coords={"data": rank // shape[1],
                                   "model": rank % shape[1]})
    return ShardCtx(mesh=mesh)


HEAD_PLANS = [
    # (Hq, Hkv), model axis, per model rank: (hq, hkv, q_split, kv)
    ((32, 32), 4, [(8, 8, True, None)] * 4),
    ((48, 8), 4, [(12, 2, True, None)] * 4),
    ((4, 1), 2, [(2, 1, True, (0,)), (2, 1, True, (0,))]),
    ((96, 8), 16, [(6, 1, True, (i // 2,)) for i in range(16)]),
    ((8, 2), 2, [(4, 1, True, None)] * 2),
    ((15, 5), 4, [(15, 5, False, None)] * 4),
    # no shared group: one KV head a query head, repeated as needed
    ((6, 3), 2, [(3, 3, True, (0, 0, 1)), (3, 3, True, (1, 2, 2))]),
]


def test_head_plan():
    import dataclasses
    cfg = get_smoke_config("phi3-mini-3.8b")
    for heads, m, want in HEAD_PLANS:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
        for r in range(m):
            hp = _ctx((1, m), r).heads(cfg)
            assert (hp.hq, hp.hkv, hp.q_split, hp.kv) == want[r], (heads, r)


def test_head_plan_takes_the_kv_heads_it_reads():
    from repro_torch.models.blocks import HeadPlan
    k = torch.arange(3).reshape(1, 1, 3, 1).float()
    assert HeadPlan(3, 3, True, (0, 0, 1)).take_kv(k).flatten().tolist() == \
        [0, 0, 1]
    assert HeadPlan(2, 2, True, (1, 2)).take_kv(k).flatten().tolist() == \
        [1, 2]
    assert HeadPlan(2, 3).take_kv(k) is k


def test_mesh_shapes_and_axes():
    assert mesh_lib.PRODUCTION[False] == ((16, 16), ("data", "model"))
    assert mesh_lib.PRODUCTION[True] == ((2, 16, 16),
                                         ("pod", "data", "model"))
    m = Mesh.abstract((2, 16, 16), ("pod", "data", "model"))
    assert m.size == 512 and m.axis_size(("pod", "data")) == 32
    with pytest.raises(ValueError, match="mesh's order"):
        m.axes(("model", "data"))
    with pytest.raises(RuntimeError, match="no process groups"):
        m.group("model")
    with pytest.raises(ValueError, match="does not name"):
        Mesh.abstract((2, 2), ("data",))


def test_init_world_refuses_other_backends_and_long_timeouts():
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_world("mpi", rank=0, world_size=1,
                            init_method="tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="timeout"):
        mesh_lib.init_world("gloo", rank=0, world_size=1,
                            init_method="tcp://127.0.0.1:1", timeout_s=600)


def test_init_sharded_draws_what_init_draws():
    """Each rank's shards drawn from the seed equal its shards of the whole
    model drawn from the seed, for every rank."""
    for arch, shape in (("phi3-mini-3.8b", (1, 4)), ("mixtral-8x22b", (2, 2))):
        _check_init_sharded(arch, shape)


def _check_init_sharded(arch, shape):
    from repro_torch.weights import init_sharded, shard_params
    cfg = get_smoke_config(arch)
    whole = build(cfg).init(3, device="cpu")
    for rank in range(4):
        mesh = Mesh({"data": shape[0], "model": shape[1]}, ("data", "model"),
                    rank=rank, coords={"data": rank // shape[1],
                                       "model": rank % shape[1]})
        a = dict(init_sharded(cfg, 3, mesh, device="cpu").named_parameters())
        b = dict(shard_params(whole, cfg, mesh).named_parameters())
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n], b[n]), n


def test_a_mesh_refuses_the_families_that_wait():
    """No family waits any more: the SSM and the hybrid run on a model
    axis of 2, their states holding the rank's half of the SSD heads (the
    conv window its x channels and all of B and C) and the hybrid's shared
    cache its half of the attention heads; a data-only mesh holds every
    head; the VLM's cache holds the rank's heads (the one KV head
    whole)."""
    from repro_torch.models import lm
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        cfg = get_smoke_config(arch)
        s, H = cfg.ssm, cfg.ssm_heads
        for shape, h in (((1, 2), H // 2), ((2, 1), H)):
            cache = lm.init_lm_cache(cfg, 1, 64, _ctx(shape, 0),
                                     device="cpu")
            assert tuple(cache["mamba"].conv.shape) == (
                cfg.n_layers, 1, s.conv_width - 1,
                h * s.head_dim + 2 * s.n_groups * s.d_state)
            assert tuple(cache["mamba"].ssm.shape) == (
                cfg.n_layers, 1, h, s.head_dim, s.d_state)
            if cfg.family == "hybrid":
                assert cache["shared_k"].shape[3] == cfg.n_kv_heads // (
                    shape[1])
    cfg = get_smoke_config("llava-next-mistral-7b")
    cache = lm.init_lm_cache(cfg, 1, 64, _ctx((1, 2), 0), device="cpu")
    assert tuple(cache["k"].shape) == (cfg.n_layers, 1, 64, 1, cfg.hd)


def test_mesh_steps_on_a_one_member_mesh_are_the_one_device_steps():
    """``make_prefill_step`` / ``make_serve_step`` over a (1, 1) mesh (its
    collectives return their input; the MoE through ``moe_ep``, where the
    smoke capacity drops nothing) give the one-device logits (f32); a plan
    with sequence parallelism is taken for this config, whose layers are
    MoE layers, and splits nothing over a model axis of 1: its prefill
    gives the same logits, bit for bit."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.launch import steps
    cfg = get_smoke_config("mixtral-8x22b")
    api = build(cfg)
    params = api.init(0, device="cpu").float()
    mesh = Mesh({"data": 1, "model": 1}, ("data", "model"), rank=0,
                coords={"data": 0, "model": 0}, groups={})
    prefill, ctx = steps.make_prefill_step(api, mesh, max_len=48)
    serve, _ = steps.make_serve_step(api, mesh)
    assert ctx.mesh is mesh and ctx.choose_moe(cfg) == "ep"
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(0))
    got, cache = prefill(params, {"tokens": tokens})
    want, wcache = api.prefill(params, {"tokens": tokens}, ShardCtx(), 48)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    step = tokens[:, :1]
    torch.testing.assert_close(serve(params, cache, step)[0],
                               api.decode_step(params, wcache, step,
                                               ShardCtx())[0],
                               rtol=1e-4, atol=1e-4)
    sp_prefill, sp_ctx = steps.make_prefill_step(
        api, mesh, CodesignPlan(seq_parallel=True), max_len=48)
    assert sp_ctx.seq_parallel and not sp_ctx.shards_act(40)
    torch.testing.assert_close(sp_prefill(params, {"tokens": tokens})[0],
                               got, rtol=0, atol=0)
