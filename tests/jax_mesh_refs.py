"""Reference outputs of the JAX package on an emulated 4-device CPU mesh.

    python tests/jax_mesh_refs.py {mesh|gpipe|train|moe_train|vlm|family|family_train|seq_parallel|moe_seq_parallel} OUT.npz

jax pins the device count at its first import, so the test files that
compare the port's ranks with the JAX package's mesh run this script in
one subprocess, which sets ``xla_force_host_platform_device_count=4``
before importing jax (as ``tests/test_distribution.py`` does).  Every
input is drawn here from seeded numpy (or the JAX package's own seeded
init) and written beside the outputs, so the port's ranks
(``tests/torch_mesh_ranks.py``) read the same values.  Entries are named
``<case>/<what>``; the JSON entry ``meta`` lists the cases.

``mesh``: ``moe_ep`` / ``moe_tp`` (meshes (1, 4) and (2, 2), capacity
factors 8.0 and 1.25, prefill- and decode-shaped tokens) with the pairs
each shard kept; ``compressed_psum`` (blocks 64 and 256) and
``hierarchical_psum`` (plain and compressed); ``cache_shardings`` for
every config; the smoke phi3 at (1, 4) and smoke mixtral at (2, 2) served
by ``Server(cfg, mesh)``: prefill logits and teacher-forced decode logits,
in f32.  ``gpipe``: ``pipeline_forward`` of a dense stack over a stage
axis of 4 and of 2.  ``train``: ``make_train_step`` on each mesh of
``TRAIN_CASES`` for 2 steps from the JAX model's weights in f32 (the
metrics and the final weights); the loss and gradients of one batch with
a ``loss_mask`` that differs row by row (one device: the reference's
jitted mesh step takes no mask); the JAX ``Trainer`` at (2, 2) saving a
checkpoint beside OUT.npz (``jax_ckpt/``); and the JAX input pipeline's
global batches on the (2, 2) mesh.  ``moe_train``: the gradients of
``moe_ep`` and ``moe_tp`` (meshes (1, 4) and (2, 2), capacity factors 8.0
and 1.25) with respect to x, the router and the expert weights, of
``sum(y * c)``, of the load-balance term and of the router z term, each
alone; ``make_train_step`` for the MoE cases of ``MOE_TRAIN_CASES`` as in
``train`` (the metrics with the aux terms), the final state of two of
them (the parameters in the model's own dtypes) saved as checkpoints
beside OUT.npz (``moe_ckpt/<case>/``), and the step each saved state takes
next on the layout of :data:`MOE_ELASTIC` (the step after an elastic
restore), in f32 from the saved values.
``vlm``: the smoke llava served by ``Server(cfg, mesh)`` at (1, 4) and
(2, 2) (prefill logits) and on one device (prefill and teacher-forced
decode logits), and ``make_train_step`` at (2, 2) under FSDP + TP.
``family``: the smoke seamless (at a vocab of 258, which divides a model
axis of 2 but not 4), mamba2 and zamba2 served by ``Server(cfg, mesh)``
at (1, 4) and (2, 2): prefill logits and teacher-forced decode
logits, in f32.  ``family_train``: ``make_train_step`` for the cases of
:data:`FAMILY_TRAIN_CASES` as in ``moe_train`` (each family's metrics),
the final state of :data:`FAMILY_CKPT_CASE` saved as a checkpoint beside
OUT.npz (``family_ckpt/``) and its next step on :data:`FAMILY_ELASTIC`;
and ``jax.grad`` of one smoke Mamba2 block (``sum(y * c)`` with respect
to x and each of its parameters).  ``seq_parallel``: Megatron sequence
parallelism (``CodesignPlan(seq_parallel=True)``) for each family of
:data:`SP_FAMILIES` at (1, 4) and (2, 2): the prefill logits of
``Server(cfg, mesh, plan=CodesignPlan(sharding="tp", seq_parallel=True))``
at each layer-sequence length of :data:`SP_PROMPTS`, and
``make_train_step`` under ``CodesignPlan(sharding="fsdp_tp",
seq_parallel=True)`` for 2 steps (:data:`SP_TRAIN_SEQ`), and step 1's
loss and gradients from ``jax.value_and_grad`` of the loss under the
(2, 2) step's context (step 1 takes the same batch on both meshes).
``moe_seq_parallel``: the MoE family under the same plan, for each case
of :data:`MOE_SP_CASES` (one mesh each): the prefill logits of
``Server(cfg, mesh, plan=...)`` at each length of :data:`SP_PROMPTS`,
2 steps of ``make_train_step`` (sequences :data:`MOE_SP_TRAIN_SEQ`),
step 1's loss and gradients, and the pairs the shards keep in each MoE
layer (:func:`shard_keep` of the layer's input, from a layer-by-layer
run of the JAX package's blocks) of each prefill and of step 1's
forward.
"""

import dataclasses
import json
import os
import sys

# four emulated devices, single-threaded, on one core at a lower priority:
# the test run shares the host with wall-clock tests in other workers
os.nice(10)
os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[
    {"mesh": -1, "gpipe": -2, "moe_train": -4, "vlm": -5}.get(
        sys.argv[1], -3) % len(os.sched_getaffinity(0))]}
    if sys.argv[1] not in ("family", "family_train", "seq_parallel",
                           "moe_seq_parallel") else
    {sorted(os.sched_getaffinity(0))[
        {"family": -6, "family_train": -7, "seq_parallel": -8,
         "moe_seq_parallel": -10}[sys.argv[1]]
        % len(os.sched_getaffinity(0))]})
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
if sys.argv[1] in ("family", "family_train", "seq_parallel",
                   "moe_seq_parallel"):
    # these jobs compile many small programs: LLVM's backend passes take
    # half their time and change no result beyond f32 rounding
    os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                                " --xla_llvm_disable_expensive_passes=true")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch.mesh import _make_mesh  # noqa: E402
from repro.parallel.compat import shard_map  # noqa: E402

F32 = np.float32
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
#: MoE cases: name -> (mesh, capacity factor, tokens shape (B, S)); a
#: decode shape's 2 tokens drop at neither factor, so it runs at 1.25 only
MOE_CASES = {f"{m}-cf{cf}-{kind}": (m, cf, shape)
             for m in ("1x4", "2x2")
             for cf, kinds in ((8.0, ("prefill",)),
                               (1.25, ("prefill", "decode")))
             for kind, shape in (("prefill", (2, 16)), ("decode", (2, 1)))
             if kind in kinds}
#: served smoke models: name -> (arch, mesh, batch, prompt, steps, max_len)
SERVE_CASES = {"phi3": ("phi3-mini-3.8b", "1x4", 4, 16, 4, 24),
               "mixtral": ("mixtral-8x22b", "2x2", 2, 40, 4, 48)}
#: compressed_psum cases: name -> (mesh, axis, values per rank, block)
CPSUM_CASES = {"model-b64": ("1x4", "model", 1300, 64),
               "model-b256": ("1x4", "model", 3000, 256),
               "data-b64": ("2x2", "data", 1300, 64)}
#: pipeline cases: name -> (mesh shape, axes, stage axis, n_micro)
GPIPE_CASES = {"pod4": ((4,), ("pod",), "pod", 4),
               "data2": ((2, 2), ("data", "model"), "data", 3)}
#: mesh train steps: name -> (arch, mesh, plan sharding, microbatches)
TRAIN_CASES = {"smollm-2x2-fsdp_tp": ("smollm-360m", "2x2", "fsdp_tp", 1),
               "phi3-1x4-tp": ("phi3-mini-3.8b", "1x4", "tp", 1),
               "smollm-4x1-fsdp-mb2": ("smollm-360m", "4x1", "fsdp", 2)}
#: the train job's batches (B, S), learning rate and steps; the trainer's
#: checkpoint run: its batches (B, S), pipeline seed and steps
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = (8, 16), 1e-3, 2
CKPT_RUN = dict(batch=8, seq=16, seed=5, steps=2, every=2)
#: MoE gradient cases: name -> (mesh, capacity factor), on prefill-shaped
#: tokens (2, 16) of ``moe_cfg``'s layer (8 experts, top 2)
MOE_GRAD_CASES = {f"{m}-cf{cf}": (m, cf) for m in ("1x4", "2x2")
                  for cf in (8.0, 1.25)}
#: MoE mesh train steps: name -> (arch, mesh, plan sharding,
#: microbatches, experts): EP + FSDP, TP inside the experts (6 experts do
#: not split over 4 model ranks), EP over a model axis of 1 with FSDP
MOE_TRAIN_CASES = {
    "mixtral-2x2-fsdp_tp": ("mixtral-8x22b", "2x2", "fsdp_tp", 1, 4),
    "qwen3-1x4-tp-e6": ("qwen3-moe-30b-a3b", "1x4", "tp", 1, 6),
    "qwen3-4x1-fsdp-mb2": ("qwen3-moe-30b-a3b", "4x1", "fsdp", 2, 4)}
#: the MoE cases whose final state is saved as a checkpoint (an EP + FSDP
#: layout and a TP-inside-experts layout)
MOE_CKPT_CASES = ("mixtral-2x2-fsdp_tp", "qwen3-1x4-tp-e6")
#: the layout (mesh, plan sharding) on which each saved state takes its
#: next step: the port restores it there elastically
MOE_ELASTIC = {"mixtral-2x2-fsdp_tp": ("1x4", "tp"),
               "qwen3-1x4-tp-e6": ("2x2", "fsdp_tp")}
#: the train metrics recorded for the MoE and VLM cases
TRAIN_METRICS = ("loss", "ce", "load_balance", "router_z", "grad_norm", "lr")
#: the smoke llava served: name -> (mesh, batch, prompt, decode steps)
VLM_SERVE_CASES = {"1x4": ("1x4", 4, 16, 4), "2x2": ("2x2", 4, 16, 4)}
#: the smoke llava's mesh train step: (mesh, plan sharding, steps)
VLM_TRAIN = ("2x2", "fsdp_tp", 2)
#: the smoke enc-dec, SSM and hybrid served: name -> (arch, vocab (None:
#: the smoke config's), mesh, batch, prompt, decode steps, max_len).  The
#: enc-dec at a vocab of 258, which divides a model axis of 2 but not 4
#: (its head whole at (1, 4), split at (2, 2)); its prompt is its stub
#: frames (its decoder reads one token).  The SSM and hybrid prompts are
#: whole SSD chunks (16), zamba2's past its 32-slot window into a cache
#: at least as long
FAMILY_SERVE_CASES = {
    f"{name}-{m}": (arch, vocab, m, 4, prompt, 3, max_len)
    for name, arch, vocab, prompt, max_len in (
        ("seamless_v258", "seamless-m4t-large-v2", 258, 16, 16),
        ("mamba2", "mamba2-1.3b", None, 32, 40),
        ("zamba2", "zamba2-1.2b", None, 48, 56))
    for m in ("1x4", "2x2")}
#: the families' mesh train steps: name -> (arch, vocab, mesh, plan
#: sharding); the enc-dec at a vocab that splits at (2, 2) only
FAMILY_TRAIN_CASES = {
    f"{name}-{m}-{sh}": (arch, vocab, m, sh)
    for name, arch, vocab in (("seamless_v258", "seamless-m4t-large-v2", 258),
                              ("mamba2", "mamba2-1.3b", None),
                              ("zamba2", "zamba2-1.2b", None))
    for m, sh in (("2x2", "fsdp_tp"), ("1x4", "tp"))}
#: the case whose final state is saved, and the layout of its next step
FAMILY_CKPT_CASE = "mamba2-2x2-fsdp_tp"
FAMILY_ELASTIC = ("1x4", "tp")
#: the enc-dec's stub frames in a train batch, and the Mamba2 block
#: gradient case's input (B, S)
FAMILY_FRAMES, MAMBA_GRAD_X = 16, (4, 32)
#: the families held under sequence parallelism: name -> (arch, smoke
#: overrides, SSD chunk (None: the smoke config's)).  The dense family as
#: smollm-360m's 15 heads are, heads that divide no model axis (3, one KV
#: head: the query rows split over the model axis, the MLP split); the
#: VLM at its smoke widths (4 query heads, one KV head); the SSM and
#: hybrid at an SSD chunk of 6, so that a sequence of 18 (which divides 2
#: but not 4) is whole chunks; the enc-dec at a vocab that splits over 2
#: but not 4
SP_FAMILIES = {"smollm3": ("smollm-360m", {"n_heads": 3, "n_kv_heads": 1},
                           None),
               "llava": ("llava-next-mistral-7b", {}, None),
               "mamba2": ("mamba2-1.3b", {}, 6),
               "zamba2": ("zamba2-1.2b", {}, 6),
               "seamless": ("seamless-m4t-large-v2", {"vocab": 258}, None)}
SP_MESHES = ("1x4", "2x2")
#: the served sequence lengths the layers see (a VLM's 8 patches and its
#: text; an enc-dec's frames): one divides a model axis of 4, one only 2;
#: the serve batch and cache length
SP_PROMPTS, SP_SERVE_BATCH, SP_MAX_LEN = (24, 18), 4, 40
#: the train steps' sequence lengths (a decoder's layers' S; the
#: enc-dec's (frames, decoder tokens)), step 1's on both meshes and step
#: 2's at (2, 2), which divides 2 but not 4 (at (1, 4) step 2 repeats
#: step 1's lengths on other rows: one compiled step fewer); the enc-dec
#: splits one stack and not the other at (1, 4)
SP_TRAIN_SEQ = {"decoder": (24, 18), "encdec": ((24, 18), (18, 24))}
#: the MoE family under sequence parallelism: name -> (arch, mesh,
#: experts, capacity factor; None: the smoke config's 4 experts, 2.0).
#: The path follows from the mesh (``choose_moe``): EP where the experts
#: divide the model axis, else TP inside the experts (6 experts over 4).
#: At 1.25 the shards drop pairs; at the smoke 2.0 with 4 experts an
#: expert's capacity is the shard's tokens and nothing drops
MOE_SP_CASES = {
    "qwen3-1x4-ep": ("qwen3-moe-30b-a3b", "1x4", None, None),
    "qwen3-2x2-ep-cf1.25": ("qwen3-moe-30b-a3b", "2x2", None, 1.25),
    "qwen3-1x4-tp-e6-cf1.25": ("qwen3-moe-30b-a3b", "1x4", 6, 1.25),
    "mixtral-2x2-ep": ("mixtral-8x22b", "2x2", None, None)}
#: the MoE train steps' sequence lengths: step 1 divides a model axis of
#: 4, step 2 only 2 (so at (1, 4) step 2 runs without the split)
MOE_SP_TRAIN_SEQ = (24, 18)


def mesh_of(name):
    return _make_mesh(MESHES[name], ("data", "model"))


def moe_cfg(cf):
    from repro.models.config import ModelConfig, MoEConfig
    return ModelConfig(name="m", family="moe", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                       vocab=64, moe=MoEConfig(n_experts=8, top_k=2,
                                               d_ff_expert=64,
                                               capacity_factor=cf))


def moe_weights():
    rng = np.random.default_rng(11)
    return {"wr": (rng.standard_normal((32, 8)) * 0.5).astype(F32),
            "wg": (rng.standard_normal((8, 32, 64)) * 0.1).astype(F32),
            "wu": (rng.standard_normal((8, 32, 64)) * 0.1).astype(F32),
            "wd": (rng.standard_normal((8, 64, 32)) * 0.1).astype(F32)}


def shard_keep(ffn, x, wr, cfg, mesh, impl):
    """Which (token, k) pairs the JAX package's shards keep: each shard of
    tokens (the split of ``moe_ep`` / ``moe_tp``) routed and dispatched
    alone (one jitted call over the stacked shards), in (token, k) order
    over all tokens."""
    B, S, D = x.shape
    T, moe = B * S, cfg.moe
    tok_axes = ffn._token_axes(T, mesh, ("data",), "model")
    axes = tok_axes if impl == "ep" else tuple(a for a in tok_axes
                                               if a != "model")
    n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    t = T // n
    cap = ffn._capacity(t, moe.top_k, moe.n_experts, moe.capacity_factor)

    def one(xs):
        gates, eidx, _, _ = ffn.route(xs, jnp.asarray(wr), moe.top_k)
        keep = ffn._local_dispatch(xs, eidx, gates, moe.n_experts, cap)[4]
        order = jnp.argsort(eidx.reshape(-1), stable=True)
        return jnp.zeros_like(keep).at[order].set(keep).reshape(
            t, moe.top_k)
    shards = jnp.asarray(x.reshape(n, t, D))
    return np.asarray(jax.jit(jax.vmap(one))(shards)).reshape(T, moe.top_k)


def moe_refs(out):
    from repro.models import ffn
    w = moe_weights()
    for k, v in w.items():
        out[f"moe/{k}"] = v
    for case, (m, cf, shape) in MOE_CASES.items():
        mesh, cfg = mesh_of(m), moe_cfg(cf)
        x = np.random.default_rng(7 + shape[1]).standard_normal(
            shape + (32,)).astype(F32)
        out[f"moe/{case}/x"] = x
        args = [jnp.asarray(a) for a in (x, w["wr"], w["wg"], w["wu"],
                                          w["wd"])]
        for impl, fn in (("ep", ffn.moe_ep), ("tp", ffn.moe_tp)):
            y, lb, z = jax.jit(lambda *a: fn(*a, cfg=cfg, mesh=mesh,
                                             batch_axes=("data",)))(*args)
            out[f"moe/{case}/{impl}/y"] = np.asarray(y)
            out[f"moe/{case}/{impl}/aux"] = np.asarray([lb, z], F32)
            out[f"moe/{case}/{impl}/keep"] = shard_keep(ffn, x, w["wr"], cfg,
                                                       mesh, impl)
        y, lb, z = ffn.moe_ref(*args, cfg=cfg)
        out[f"moe/{case}/ref/y"] = np.asarray(y)


def per_rank(fn, mesh):
    """``fn(row)`` on each device's row of a (4, ...) input (device (d, m)
    takes row d * 2 + m), results stacked the same way."""
    spec = P(("data", "model"))
    return shard_map(lambda xl: fn(xl[0])[None], mesh=mesh, in_specs=spec,
                     out_specs=spec, check_vma=False)


def collective_refs(out):
    from repro.optim.compression import quantize_int8_blockwise
    from repro.parallel.collectives import compressed_psum, hierarchical_psum
    for case, (m, axis, n, block) in CPSUM_CASES.items():
        mesh = mesh_of(m)
        x = np.random.default_rng(n + block).standard_normal(
            (4, n)).astype(F32)
        out[f"cpsum/{case}/x"] = x
        f = per_rank(lambda xl: compressed_psum(xl, axis, block=block), mesh)
        out[f"cpsum/{case}/out"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
        q, s = jax.vmap(jax.jit(
            lambda r: quantize_int8_blockwise(r, block)))(jnp.asarray(x))
        out[f"cpsum/{case}/q1"] = np.asarray(q)
        out[f"cpsum/{case}/s1"] = np.asarray(s)
    mesh = mesh_of("2x2")
    x = np.random.default_rng(5).standard_normal((4, 1000)).astype(F32)
    out["hpsum/x"] = x
    for name, c in (("plain", False), ("compressed", True)):
        f = per_rank(lambda xl: hierarchical_psum(
            xl, intra_axis="model", inter_axis="data", compress_inter=c,
            block=64), mesh)
        out[f"hpsum/{name}/out"] = np.asarray(jax.jit(f)(jnp.asarray(x)))


def cache_refs(out):
    from repro.configs import get_config, list_archs
    from repro.launch.steps import cache_shardings
    from repro.models.api import build
    from repro.models.blocks import ShardCtx
    table = {}
    for arch in list_archs():
        api = build(get_config(arch))
        for B in (1, 8):
            abs_ = jax.eval_shape(
                lambda: api.init_cache(B, 4096, ShardCtx(), enc_len=1024))
            for m in MESHES:
                sh = cache_shardings(abs_, mesh_of(m))
                leaves = jax.tree_util.tree_flatten_with_path(abs_)[0]
                specs = jax.tree_util.tree_leaves(
                    sh, is_leaf=lambda v: hasattr(v, "spec"))
                table[f"{arch}|{B}|{m}"] = {
                    _leaf_name(p): [list(v.shape), _spec_json(s.spec)]
                    for (p, v), s in zip(leaves, specs)}
    out["cache/table"] = np.asarray(json.dumps(table))


def _leaf_name(path):
    last = path[-1]
    return str(getattr(last, "key", getattr(last, "name", "")))


def _spec_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]


def serve_refs(out):
    """Each smoke model served on its mesh and on one device (``mesh=None``),
    the same weights and tokens: prefill logits, then teacher-forced
    decode logits, and the KV heads each run's cache ends with."""
    from repro.configs import get_smoke_config
    from repro.launch.serve import Server
    for case, (arch, m, B, prompt, steps, max_len) in SERVE_CASES.items():
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab, (B, prompt), dtype=np.int32)
        forced = rng.integers(0, cfg.vocab, (B, steps), dtype=np.int32)
        out[f"serve/{case}/tokens"] = tokens
        out[f"serve/{case}/forced"] = forced
        # the mesh run's decode is compared only where it is at fault
        # (mixtral: see tests/test_torch_mesh.py); phi3's mesh run prefills
        runs = (("mesh", mesh_of(m), steps if case == "mixtral" else 0),
                ("one", None, steps))
        for run, mesh, n in runs:
            server = Server(cfg, mesh, max_len=max_len)
            params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  server.api.init(jax.random.PRNGKey(0)))
            logits, cache = server._prefill(params, {"tokens": tokens})
            outs = [np.asarray(logits)]
            for t in range(n):
                logits, cache = server._decode(
                    params, cache, jnp.asarray(forced[:, t:t + 1]))
                outs.append(np.asarray(logits))
            out[f"serve/{case}/{run}/logits"] = np.stack(outs)
            out[f"serve/{case}/{run}/cache_heads"] = np.asarray(
                cache["k"].shape[3])
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            out[f"serve/{case}/params/{key}"] = np.asarray(v)


def gpipe_refs(out):
    from repro.configs import get_smoke_config
    from repro.models import blocks
    from repro.models.api import build
    from repro.parallel.pipeline import pipeline_forward
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), n_layers=8)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          build(cfg).init(jax.random.PRNGKey(1)))
    layers = params["layers"]
    for path, v in jax.tree_util.tree_flatten_with_path(layers)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"gpipe/layers/{key}"] = np.asarray(v)
    S = 8
    positions = jnp.arange(S, dtype=jnp.int32)
    ctx = blocks.ShardCtx()
    for case, (shape, axes, stage_axis, n_micro) in GPIPE_CASES.items():
        mesh = _make_mesh(shape, axes)
        n_stages = mesh.shape[stage_axis]
        x = np.random.default_rng(n_micro).standard_normal(
            (n_micro, 2, S, cfg.d_model)).astype(F32)

        def layer_fn(stage, h):
            def body(h, lp):
                return blocks.dense_layer_apply(
                    h, lp, cfg, ctx, positions=positions), None
            return jax.lax.scan(body, h, stage)[0]

        y = jax.jit(lambda p, xx: pipeline_forward(
            layer_fn, p, xx, mesh=mesh, stage_axis=stage_axis,
            layers_per_stage=cfg.n_layers // n_stages))(layers,
                                                        jnp.asarray(x))
        out[f"gpipe/{case}/x"] = x
        out[f"gpipe/{case}/y"] = np.asarray(y)


def _flat(out, prefix, tree):
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in p)
        out[f"{prefix}/{key}"] = np.asarray(v)


def train_batches(vocab, n):
    """``n`` seeded (tokens, labels) batches of :data:`TRAIN_BATCH`."""
    rng = np.random.default_rng(17)
    B, S = TRAIN_BATCH
    return [{"tokens": rng.integers(0, vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, vocab, (B, S), dtype=np.int32)}
            for _ in range(n)]


def loss_mask():
    """A mask that keeps a different share of each row's tokens."""
    B, S = TRAIN_BATCH
    rng = np.random.default_rng(23)
    return (rng.random((B, S)) < np.linspace(0.15, 0.95, B)[:, None]
            ).astype(np.float32)


def train_refs(out, path):
    """The mesh train steps, the masked loss and gradients, the trainer's
    checkpoint and the input feed (module docstring)."""
    from repro.configs import get_smoke_config
    from repro.core.codesign import CodesignPlan
    from repro.data.pipeline import (InputPipeline, PipelineConfig,
                                     SyntheticTokenSource)
    from repro.launch import steps as steps_lib
    from repro.launch.train import Trainer
    from repro.models.api import build
    from repro.models.blocks import ShardCtx
    from repro.optim.adamw import adamw_init
    from repro.parallel.sharding import param_shardings
    for case, (arch, m, sharding, micro) in TRAIN_CASES.items():
        cfg = get_smoke_config(arch)
        api, mesh = build(cfg), mesh_of(m)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              api.init(jax.random.PRNGKey(0)))
        _flat(out, f"train/{case}/params", params)
        plan = CodesignPlan(sharding=sharding, microbatches=micro,
                            seq_parallel=False)
        step, p_shard, s_shard, _ = steps_lib.make_train_step(
            api, mesh, plan, lr_peak=TRAIN_LR, warmup=1,
            total_steps=10)
        params = jax.device_put(params, p_shard)
        opt = jax.jit(adamw_init, out_shardings=s_shard)(params)
        metrics = []
        for b in train_batches(cfg.vocab, TRAIN_STEPS):
            params, opt, mt = step(params, opt, b)
            metrics.append([float(mt[k]) for k in
                            ("loss", "ce", "grad_norm", "lr")])
        out[f"train/{case}/metrics"] = np.asarray(metrics)
        _flat(out, f"train/{case}/final", params)

    cfg = get_smoke_config("smollm-360m")
    api = build(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          api.init(jax.random.PRNGKey(1)))
    _flat(out, "masked/params", params)
    batch = dict(train_batches(cfg.vocab, 1)[0], loss_mask=loss_mask())
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss(p, batch, ShardCtx()), has_aux=True))(params)
    out["masked/loss"] = np.asarray([float(loss), float(aux["ce"])])
    _flat(out, "masked/grads", grads)

    root = os.path.join(os.path.dirname(os.path.abspath(path)), "jax_ckpt")
    r = CKPT_RUN
    trainer = Trainer(cfg, mesh_of("2x2"), ckpt_dir=root,
                      ckpt_every=r["every"], total_steps=10)
    trainer.init_state(0)
    pc = PipelineConfig(r["batch"], r["seq"], seed=r["seed"])
    trainer.run(SyntheticTokenSource(cfg, pc, n_batches=r["steps"] + 2),
                r["steps"])
    out["ckpt/root"] = np.asarray(root)
    out["ckpt/step"] = np.asarray(trainer.step_idx)

    pipe = InputPipeline(SyntheticTokenSource(cfg, pc, n_batches=2), pc=pc,
                         mesh=mesh_of("2x2"), batch_axes=("data",))
    got = [jax.tree.map(np.asarray, b) for b in pipe]
    out["feed/tokens"] = np.stack([b["tokens"] for b in got])
    out["feed/labels"] = np.stack([b["labels"] for b in got])


def with_experts(cfg, n):
    """``cfg`` with ``n`` experts."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=n))


def moe_grad_inputs(x_shape):
    """The gradient cases' tokens and the cotangent c of ``sum(y * c)``."""
    rng = np.random.default_rng(31)
    return (rng.standard_normal(x_shape).astype(F32),
            rng.standard_normal(x_shape).astype(F32))


def moe_grad_refs(out):
    """Each path's gradients of ``sum(y * c)``, lb and z, each alone, with
    respect to (x, router, w_gate, w_up, w_down), in one jitted call a
    case."""
    from repro.models import ffn
    w = moe_weights()
    for k, v in w.items():
        out[f"moe_grad/{k}"] = v
    x, c = moe_grad_inputs((2, 16, 32))
    out["moe_grad/x"], out["moe_grad/c"] = x, c
    args = [jnp.asarray(a) for a in (x, w["wr"], w["wg"], w["wu"], w["wd"])]
    for case, (m, cf) in MOE_GRAD_CASES.items():
        mesh, cfg = mesh_of(m), moe_cfg(cf)
        for impl, fn in (("ep", ffn.moe_ep), ("tp", ffn.moe_tp)):
            def terms(*a):
                y, lb, z = fn(*a, cfg=cfg, mesh=mesh, batch_axes=("data",))
                return jnp.sum(y * jnp.asarray(c)), lb, z

            def all_grads(*a):
                return [jax.grad(lambda *b, i=i: terms(*b)[i],
                                 argnums=(0, 1, 2, 3, 4))(*a)
                        for i in range(3)]
            got = jax.jit(all_grads)(*args)
            for what, grads in zip(("y", "lb", "z"), got):
                for name, g in zip(("x", "wr", "wg", "wu", "wd"), grads):
                    out[f"moe_grad/{case}/{impl}/{what}/{name}"] = \
                        np.asarray(g)
            out[f"moe_grad/{case}/{impl}/terms"] = np.asarray(
                jax.jit(terms)(*args), F32)


def moe_train_refs(out, path):
    """The MoE mesh train steps (as :func:`train_refs`), the final state
    of :data:`MOE_CKPT_CASES` saved by the JAX package's
    ``save_checkpoint``, and the metrics of that state's next step on the
    :data:`MOE_ELASTIC` layout, over the next seeded batch, in f32 (the
    saved bf16 values widened, as f32 as the other cases)."""
    from repro.checkpoint.manager import save_checkpoint
    from repro.configs import get_smoke_config
    from repro.models.api import build
    root = os.path.join(os.path.dirname(os.path.abspath(path)), "moe_ckpt")
    for case, (arch, m, sharding, micro, experts) in MOE_TRAIN_CASES.items():
        cfg = with_experts(get_smoke_config(arch), experts)
        params, opt = mesh_train(out, f"moe_train/{case}", cfg, m, sharding,
                                 micro, train_batches(cfg.vocab,
                                                      TRAIN_STEPS))
        if case in MOE_CKPT_CASES:
            # the parameters in the model's own dtypes (bf16 matrices), as
            # a trainer holds them; the AdamW state is f32 either way
            native = jax.eval_shape(build(cfg).init, jax.random.PRNGKey(0))
            params = jax.tree.map(lambda a, n: a.astype(n.dtype), params,
                                  native)
            save_checkpoint(os.path.join(root, case), TRAIN_STEPS,
                            {"params": params, "opt": opt})
            out[f"moe_ckpt/{case}/next"] = next_step(
                cfg, jax.tree.map(lambda a: a.astype(jnp.float32), params),
                opt, *MOE_ELASTIC[case],
                train_batches(cfg.vocab, TRAIN_STEPS + 1)[-1])
    out["moe_ckpt/root"] = np.asarray(root)


def mesh_train(out, prefix, cfg, m, sharding, micro, batches,
               metrics=TRAIN_METRICS):
    """``make_train_step`` on mesh ``m`` from the JAX model's weights in
    f32 over ``batches``: the initial weights, the ``metrics`` each step
    and the final weights under ``prefix``.  Returns the final (params,
    opt state)."""
    from repro.core.codesign import CodesignPlan
    from repro.launch import steps as steps_lib
    from repro.models.api import build
    from repro.optim.adamw import adamw_init
    api, mesh = build(cfg), mesh_of(m)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          api.init(jax.random.PRNGKey(0)))
    _flat(out, f"{prefix}/params", params)
    plan = CodesignPlan(sharding=sharding, microbatches=micro,
                        seq_parallel=False)
    step, p_shard, s_shard, _ = steps_lib.make_train_step(
        api, mesh, plan, lr_peak=TRAIN_LR, warmup=1, total_steps=10)
    params = jax.device_put(params, p_shard)
    opt = jax.jit(adamw_init, out_shardings=s_shard)(params)
    got = []
    for b in batches:
        params, opt, mt = step(params, opt, b)
        got.append([float(mt[k]) for k in metrics])
    out[f"{prefix}/metrics"] = np.asarray(got)
    _flat(out, f"{prefix}/final", params)
    return params, opt


def next_step(cfg, params, opt, m, sharding, batch, metrics=TRAIN_METRICS):
    """The ``metrics`` of one ``make_train_step`` on mesh ``m`` under
    ``sharding`` from the state (params, opt) over ``batch``."""
    from repro.core.codesign import CodesignPlan
    from repro.launch import steps as steps_lib
    from repro.models.api import build
    plan = CodesignPlan(sharding=sharding, seq_parallel=False)
    step, p_shard, s_shard, _ = steps_lib.make_train_step(
        build(cfg), mesh_of(m), plan, lr_peak=TRAIN_LR, warmup=1,
        total_steps=10)
    _, _, mt = step(jax.device_put(params, p_shard),
                    jax.device_put(opt, s_shard), batch)
    return np.asarray([float(mt[k]) for k in metrics])


def vlm_batches(cfg, n, B, S):
    """``n`` seeded VLM batches: text tokens and labels (B, S) and the stub
    patch embeddings (B, frontend_len, D)."""
    rng = np.random.default_rng(29)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "extra_embeds": rng.standard_normal(
                 (B, cfg.frontend_len, cfg.d_model)).astype(F32)}
            for _ in range(n)]


def vlm_refs(out):
    """The smoke llava served on each mesh of :data:`VLM_SERVE_CASES`
    (prefill logits: the mesh decode is at fault where the KV heads do not
    divide the model axis, ROADMAP queue 3) and on one device (prefill and
    teacher-forced decode logits), and its mesh train step."""
    from repro.configs import get_smoke_config
    from repro.launch.serve import Server
    cfg = get_smoke_config("llava-next-mistral-7b")
    for case, (m, B, prompt, steps) in VLM_SERVE_CASES.items():
        batch = vlm_batches(cfg, 1, B, prompt)[0]
        forced = np.random.default_rng(3).integers(
            0, cfg.vocab, (B, steps), dtype=np.int32)
        out[f"vlm_serve/{case}/tokens"] = batch["tokens"]
        out[f"vlm_serve/{case}/extra_embeds"] = batch["extra_embeds"]
        out[f"vlm_serve/{case}/forced"] = forced
        max_len = cfg.frontend_len + prompt + steps + 1
        for run, mesh, n in (("mesh", mesh_of(m), 0), ("one", None, steps)):
            server = Server(cfg, mesh, max_len=max_len)
            params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  server.api.init(jax.random.PRNGKey(0)))
            logits, cache = server._prefill(params, {
                "tokens": batch["tokens"],
                "extra_embeds": batch["extra_embeds"]})
            outs = [np.asarray(logits)]
            for t in range(n):
                logits, cache = server._decode(
                    params, cache, jnp.asarray(forced[:, t:t + 1]))
                outs.append(np.asarray(logits))
            out[f"vlm_serve/{case}/{run}/logits"] = np.stack(outs)
        _flat(out, f"vlm_serve/{case}/params", params)
    m, sharding, n = VLM_TRAIN
    batches = vlm_batches(cfg, n, *TRAIN_BATCH)
    for i, b in enumerate(batches):
        for k, v in b.items():
            out[f"vlm_train/batches/{i}/{k}"] = v
    mesh_train(out, "vlm_train", cfg, m, sharding, 1, batches)


def family_cfg(arch, vocab):
    """The smoke config of ``arch``, at ``vocab`` where given."""
    from repro.configs import get_smoke_config
    from repro.models.config import smoke_variant
    from repro.configs import get_config
    if vocab is None:
        return get_smoke_config(arch)
    return smoke_variant(get_config(arch), vocab=vocab)


def family_inputs(cfg, B: int, prompt: int, steps: int):
    """A served case's seeded prompt batch and forced decode tokens: an
    enc-dec's ``prompt`` stub frames and decoder tokens of that length."""
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, prompt),
                                    dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, prompt, cfg.d_model)).astype(F32)
    forced = rng.integers(0, cfg.vocab, (B, steps), dtype=np.int32)
    return batch, forced


def family_refs(out):
    """Each case of :data:`FAMILY_SERVE_CASES` served on its mesh: prefill
    logits, then teacher-forced decode logits, and its weights (f32)."""
    from repro.launch.serve import Server
    for case, (arch, vocab, m, B, prompt, steps, max_len) in \
            FAMILY_SERVE_CASES.items():
        cfg = family_cfg(arch, vocab)
        batch, forced = family_inputs(cfg, B, prompt, steps)
        for k, v in dict(batch, forced=forced).items():
            out[f"family/{case}/{k}"] = v
        server = Server(cfg, mesh_of(m), max_len=max_len)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              server.api.init(jax.random.PRNGKey(0)))
        logits, cache = server._prefill(params, batch)
        outs = [np.asarray(logits)]
        for t in range(steps):
            logits, cache = server._decode(params, cache,
                                           jnp.asarray(forced[:, t:t + 1]))
            outs.append(np.asarray(logits))
        out[f"family/{case}/logits"] = np.stack(outs)
        _flat(out, f"family/{case}/params", params)


def family_batches(cfg, n):
    """``n`` seeded train batches of :data:`TRAIN_BATCH`; an enc-dec's
    carry :data:`FAMILY_FRAMES` stub frames a row."""
    batches = train_batches(cfg.vocab, n)
    if cfg.family == "encdec":
        rng = np.random.default_rng(37)
        for b in batches:
            b["frames"] = rng.standard_normal(
                (TRAIN_BATCH[0], FAMILY_FRAMES, cfg.d_model)).astype(F32)
    return batches


def family_metrics(cfg):
    """The train metrics a family's step reports (the enc-dec has no
    load-balance or router z term)."""
    return (("loss", "ce", "grad_norm", "lr") if cfg.family == "encdec"
            else TRAIN_METRICS)


def family_train_refs(out, path):
    """The families' mesh train steps (:func:`mesh_train`), the saved
    state of :data:`FAMILY_CKPT_CASE` and its next step on
    :data:`FAMILY_ELASTIC`, and one Mamba2 block's gradients."""
    from repro.checkpoint.manager import save_checkpoint
    from repro.models import ssm
    from repro.models.api import build
    root = os.path.join(os.path.dirname(os.path.abspath(path)),
                        "family_ckpt")
    for case, (arch, vocab, m, sharding) in FAMILY_TRAIN_CASES.items():
        cfg = family_cfg(arch, vocab)
        batches = family_batches(cfg, TRAIN_STEPS)
        for i, b in enumerate(batches):
            for k, v in b.items():
                out[f"family_train/{case}/batches/{i}/{k}"] = v
        params, opt = mesh_train(out, f"family_train/{case}", cfg, m,
                                 sharding, 1, batches, family_metrics(cfg))
        if case == FAMILY_CKPT_CASE:
            native = jax.eval_shape(build(cfg).init, jax.random.PRNGKey(0))
            params = jax.tree.map(lambda a, n: a.astype(n.dtype), params,
                                  native)
            save_checkpoint(root, TRAIN_STEPS, {"params": params,
                                                "opt": opt})
            batch = family_batches(cfg, TRAIN_STEPS + 1)[-1]
            for k, v in batch.items():
                out[f"family_ckpt/batch/{k}"] = v
            out["family_ckpt/next"] = next_step(
                cfg, jax.tree.map(lambda a: a.astype(jnp.float32), params),
                opt, *FAMILY_ELASTIC, batch, family_metrics(cfg))
    out["family_ckpt/root"] = np.asarray(root)

    cfg = family_cfg("mamba2-1.3b", None)
    params = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                          build(cfg).init(jax.random.PRNGKey(2))["layers"])
    rng = np.random.default_rng(41)
    x = rng.standard_normal(MAMBA_GRAD_X + (cfg.d_model,)).astype(F32)
    c = rng.standard_normal(MAMBA_GRAD_X + (cfg.d_model,)).astype(F32)
    _flat(out, "mamba_grad/params", params)
    out["mamba_grad/x"], out["mamba_grad/c"] = x, c

    def loss(xx, p):
        return jnp.sum(ssm.mamba_block_train(xx, p, cfg) * jnp.asarray(c))
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), params)
    out["mamba_grad/grads/x"] = np.asarray(gx)
    _flat(out, "mamba_grad/grads/p", gp)
    out["mamba_grad/loss"] = np.asarray(float(jax.jit(loss)(x, params)))


def sp_cfg(name):
    """The config of :data:`SP_FAMILIES` ``name``."""
    from repro.configs import get_config
    from repro.models.config import smoke_variant
    arch, over, chunk = SP_FAMILIES[name]
    cfg = smoke_variant(get_config(arch), **over)
    if chunk is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=chunk))
    return cfg


def sp_batch(cfg, rng, B, S, dec=None, labels=False):
    """A seeded batch whose layers see ``S`` positions: a VLM's text after
    its patches, an enc-dec's ``S`` frames and ``dec`` decoder tokens (a
    prefill reads the first)."""
    if cfg.family == "encdec":
        text = dec or 4
    elif cfg.family == "vlm":
        text = S - cfg.frontend_len
    else:
        text = S
    b = {"tokens": rng.integers(0, cfg.vocab, (B, text), dtype=np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, text), dtype=np.int32)
    if cfg.family == "vlm":
        b["extra_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(F32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(F32)
    return b


def sp_refs(out):
    """Each family of :data:`SP_FAMILIES` under sequence parallelism on
    each mesh of :data:`SP_MESHES` (module docstring): its weights (f32,
    ``sp/params/<name>/``), the served prompts and prefill logits
    (``sp/serve/<name>-<mesh>-<S>/``), the train batches, the metrics and
    the final weights (``sp/train/<name>-<mesh>/``), and step 1's loss and
    gradients (``sp/grads/<name>/``)."""
    from repro.core.codesign import CodesignPlan
    from repro.launch import steps as steps_lib
    from repro.launch.serve import Server
    from repro.models.api import build
    from repro.optim.adamw import adamw_init
    for name in SP_FAMILIES:
        cfg = sp_cfg(name)
        api = build(cfg)
        params0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                               api.init(jax.random.PRNGKey(0)))
        _flat(out, f"sp/params/{name}", params0)
        seqs = SP_TRAIN_SEQ["encdec" if cfg.family == "encdec"
                            else "decoder"]
        rng = np.random.default_rng(43)
        first, second = (sp_batch(cfg, rng, TRAIN_BATCH[0], *(
            s if isinstance(s, tuple) else (s,)), labels=True)
            for s in seqs)
        again = sp_batch(cfg, rng, TRAIN_BATCH[0], *(
            seqs[0] if isinstance(seqs[0], tuple) else (seqs[0],)),
            labels=True)
        for m in SP_MESHES:
            mesh = mesh_of(m)
            server = Server(cfg, mesh, max_len=SP_MAX_LEN,
                            plan=CodesignPlan(sharding="tp",
                                              seq_parallel=True))
            for S in SP_PROMPTS:
                case = f"{name}-{m}-{S}"
                batch = sp_batch(cfg, np.random.default_rng(S),
                                 SP_SERVE_BATCH, S)
                for k, v in batch.items():
                    out[f"sp/serve/{case}/{k}"] = v
                logits, _ = server._prefill(params0, batch)
                out[f"sp/serve/{case}/logits"] = np.asarray(logits)

            case = f"{name}-{m}"
            plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=True)
            step, p_shard, s_shard, ctx = steps_lib.make_train_step(
                api, mesh, plan, lr_peak=TRAIN_LR, warmup=1,
                total_steps=10)
            batches = [first, second if m == "2x2" else again]
            for i, b in enumerate(batches):
                for k, v in b.items():
                    out[f"sp/train/{case}/batches/{i}/{k}"] = v
            params = jax.device_put(params0, p_shard)
            if m == "2x2":
                (loss, _), grads = jax.jit(jax.value_and_grad(
                    lambda p, b: api.loss(p, b, ctx), has_aux=True))(
                        params, first)
                out[f"sp/grads/{name}/loss"] = np.asarray(float(loss))
                _flat(out, f"sp/grads/{name}/grads", grads)
            opt = jax.jit(adamw_init, out_shardings=s_shard)(params)
            got = []
            for b in batches:
                params, opt, mt = step(params, opt, b)
                got.append([float(mt[k]) for k in family_metrics(cfg)])
            out[f"sp/train/{case}/metrics"] = np.asarray(got)
            _flat(out, f"sp/train/{case}/final", params)


def moe_sp_cfg(case):
    """The smoke config of :data:`MOE_SP_CASES` ``case``."""
    from repro.configs import get_smoke_config
    arch, _, experts, cf = MOE_SP_CASES[case]
    cfg = get_smoke_config(arch)
    over = {k: v for k, v in (("n_experts", experts),
                              ("capacity_factor", cf)) if v is not None}
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **over))


def moe_layer_keep(cfg, params, tokens, ctx, mesh):
    """The pairs the shards of each MoE layer keep (:func:`shard_keep`),
    (L, B*S, k), for ``tokens`` under ``ctx``: each layer's input to the
    MoE from a layer-by-layer run of the JAX package's own blocks
    (embedding, ``self_attention_block``, the norm), then the layer
    itself (``moe_layer_apply``)."""
    from repro.models import blocks, ffn
    from repro.models import lm as jlm
    S = tokens.shape[1]
    positions = jnp.arange(S, dtype=jnp.int32)
    impl = ctx.choose_moe(cfg)

    @jax.jit
    def inputs(p, t):
        x = jlm._embed_inputs(p, cfg, t, ctx, None)
        ins = []
        for i, w in enumerate(cfg.layer_windows()):
            lp = jax.tree.map(lambda a: a[i], p["layers"])
            hn = blocks.rms_norm(x, lp["ln1"], cfg.norm_eps)
            attn_out, _, _ = blocks.self_attention_block(
                hn, lp["attn"], cfg, ctx, q_pos=positions, k_pos=positions,
                causal=True, window=w)
            h = ctx.shard_act(x + attn_out)
            ins.append(blocks.rms_norm(h, lp["ln2"], cfg.norm_eps))
            x, _, _ = blocks.moe_layer_apply(x, lp, cfg, ctx,
                                             positions=positions, window=w)
        return ins
    got = inputs(params, jnp.asarray(tokens))
    return np.stack([
        shard_keep(ffn, np.asarray(h), np.asarray(
            params["layers"]["moe"]["router"][i]), cfg, mesh, impl)
        for i, h in enumerate(got)])


def moe_sp_refs(out):
    """Each case of :data:`MOE_SP_CASES` under sequence parallelism
    (module docstring): its weights (f32, ``msp/params/<case>/``), the
    served prompts, prefill logits and kept pairs
    (``msp/serve/<case>-<S>/``), the train batches, the metrics, the
    final weights and step 1's kept pairs (``msp/train/<case>/``), and
    step 1's loss and gradients (``msp/grads/<case>/``)."""
    from repro.core.codesign import CodesignPlan
    from repro.launch import steps as steps_lib
    from repro.launch.serve import Server
    from repro.models.api import build
    from repro.optim.adamw import adamw_init
    for case, (_, m, _, _) in MOE_SP_CASES.items():
        cfg, mesh = moe_sp_cfg(case), mesh_of(m)
        api = build(cfg)
        params0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                               api.init(jax.random.PRNGKey(0)))
        _flat(out, f"msp/params/{case}", params0)
        server = Server(cfg, mesh, max_len=SP_MAX_LEN,
                        plan=CodesignPlan(sharding="tp", seq_parallel=True))
        for S in SP_PROMPTS:
            key = f"msp/serve/{case}-{S}"
            batch = sp_batch(cfg, np.random.default_rng(S), SP_SERVE_BATCH,
                             S)
            out[f"{key}/tokens"] = batch["tokens"]
            logits, _ = server._prefill(params0, batch)
            out[f"{key}/logits"] = np.asarray(logits)
            out[f"{key}/keep"] = moe_layer_keep(cfg, params0,
                                                batch["tokens"], server.ctx,
                                                mesh)

        plan = CodesignPlan(sharding="fsdp_tp", seq_parallel=True)
        step, p_shard, s_shard, ctx = steps_lib.make_train_step(
            api, mesh, plan, lr_peak=TRAIN_LR, warmup=1, total_steps=10)
        rng = np.random.default_rng(43)
        batches = [sp_batch(cfg, rng, TRAIN_BATCH[0], S, labels=True)
                   for S in MOE_SP_TRAIN_SEQ]
        for i, b in enumerate(batches):
            for k, v in b.items():
                out[f"msp/train/{case}/batches/{i}/{k}"] = v
        out[f"msp/train/{case}/keep"] = moe_layer_keep(
            cfg, params0, batches[0]["tokens"], ctx, mesh)
        params = jax.device_put(params0, p_shard)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b, ctx), has_aux=True))(params,
                                                             batches[0])
        out[f"msp/grads/{case}/loss"] = np.asarray(float(loss))
        _flat(out, f"msp/grads/{case}/grads", grads)
        opt = jax.jit(adamw_init, out_shardings=s_shard)(params)
        got = []
        for b in batches:
            params, opt, mt = step(params, opt, b)
            got.append([float(mt[k]) for k in TRAIN_METRICS])
        out[f"msp/train/{case}/metrics"] = np.asarray(got)
        _flat(out, f"msp/train/{case}/final", params)


def main():
    job, path = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    if job == "mesh":
        moe_refs(out)
        collective_refs(out)
        cache_refs(out)
        serve_refs(out)
    elif job == "gpipe":
        gpipe_refs(out)
    elif job == "train":
        train_refs(out, path)
    elif job == "moe_train":
        moe_grad_refs(out)
        moe_train_refs(out, path)
    elif job == "vlm":
        vlm_refs(out)
    elif job == "family":
        family_refs(out)
    elif job == "family_train":
        family_train_refs(out, path)
    elif job == "seq_parallel":
        sp_refs(out)
    elif job == "moe_seq_parallel":
        moe_sp_refs(out)
    else:
        raise SystemExit(f"unknown job {job!r}")
    out["meta"] = np.asarray(json.dumps({
        "moe": MOE_CASES, "serve": SERVE_CASES, "cpsum": CPSUM_CASES,
        "gpipe": {k: [list(v[0]), list(v[1]), v[2], v[3]]
                  for k, v in GPIPE_CASES.items()},
        "train": TRAIN_CASES, "train_batch": TRAIN_BATCH,
        "train_lr": TRAIN_LR, "ckpt_run": CKPT_RUN,
        "moe_grad": MOE_GRAD_CASES, "moe_train": MOE_TRAIN_CASES,
        "moe_ckpt": MOE_CKPT_CASES, "moe_elastic": MOE_ELASTIC,
        "train_metrics": TRAIN_METRICS,
        "vlm_serve": VLM_SERVE_CASES, "vlm_train": VLM_TRAIN,
        "family_serve": FAMILY_SERVE_CASES,
        "family_train": FAMILY_TRAIN_CASES,
        "family_ckpt": FAMILY_CKPT_CASE, "family_elastic": FAMILY_ELASTIC,
        "family_frames": FAMILY_FRAMES,
        "sp_families": SP_FAMILIES, "sp_meshes": SP_MESHES,
        "sp_prompts": SP_PROMPTS, "sp_max_len": SP_MAX_LEN,
        "sp_serve_batch": SP_SERVE_BATCH, "moe_sp": MOE_SP_CASES,
        "moe_sp_train_seq": MOE_SP_TRAIN_SEQ}))
    np.savez(path, **out)
    print("MARKER jax-mesh-refs-ok", job, len(out))


if __name__ == "__main__":
    main()
