"""The port's MoE family (qwen3-moe-30b-a3b) against the JAX package's.

At ``smoke_variant`` width (4 layers, d_model 64, 4 experts, top 2,
d_ff_expert 64) the same numpy-seeded inputs go through the JAX functions
and the port's: ``route``, ``aux_losses``, the dense oracle ``moe_ref``
and the card's no-drop sorted dispatch ``moe_dispatch`` (against the JAX
``moe_ref``: the JAX package's one-device MoE path), ``moe_layer_apply``,
``forward_lm``'s aux losses and ``lm_loss``, the prefill and 4
teacher-forced decode steps, the weight converter, the server, and both
attention kernels at head dim 128.

Routing.  Two paths that round differently may route a token whose k-th
and (k+1)-th router probabilities nearly tie to different experts, and its
output then moves by far more than rounding noise (so does every later
token of its sequence, through attention).  On identical inputs the
routing is held equal, layer by layer.  The whole model is held to the
JAX model in f32 on both sides (routing equal everywhere, logits within
f32 noise), then in bf16 with the margins checked: each routing decision
of the port is compared with the JAX model's (run layer by layer through
the JAX package's own blocks, so its routing can be read), every decision
that differs must be a near-tie (the JAX side's k-th and (k+1)-th router
logits closer than ``NEAR_TIE``), and the logits are held to the bf16
tolerance for the sequences whose routing agreed at every token in every
layer so far (at least one must).

Tolerances.  f32: route's floats 1e-6 (f32 matmuls sum in another order),
the model 1e-4 relative and absolute (4 layers of f32 sums).  bf16: the
MoE block on identical input atol 0.02 with rtol 0.02 (about 2 bf16 ulps
of outputs near 1: the two frameworks round g, u and each expert's output
to bf16 in GEMMs of another order); logits and the KV cache atol 0.1 with
rtol 0.03, as ``tests/test_torch_model.py`` states; the kernels as
``tests/test_torch_kernels.py`` states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.decode_attention import decode_attention_bhd as jax_decode
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.models import blocks as jblocks
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx
from repro.models.common import rms_norm as jrms_norm
from repro.models.config import smoke_variant as jsmoke_variant

from repro_torch.configs import get_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import ffn
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx, moe_layer_apply
from repro_torch.models.config import smoke_variant
from repro_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
B, S, MAX_LEN, STEPS = 2, 32, 40, 4
F32_TOL = dict(atol=1e-4, rtol=1e-4)
MOE_TOL = dict(atol=0.02, rtol=0.02)
TOL = dict(atol=0.1, rtol=0.03)
KTOL = {"float32": dict(atol=3e-5, rtol=3e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
#: a routing decision that differs between two paths must be a near-tie:
#: the reference side's k-th and (k+1)-th router logits closer than this
#: (the router logits have unit scale: unit-rms inputs against weights of
#: std D^-1/2)
NEAR_TIE = 0.05


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _cfgs():
    return smoke_variant(get_config(ARCH)), jsmoke_variant(jget_config(ARCH))


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32)
    return j.astype(jnp.bfloat16) if dtype == "bfloat16" else j


def _moe_weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    return tuple((rng.standard_normal(shape, np.float32) / np.sqrt(n))
                 .astype(np.float32)
                 for shape, n in (((D, E), D), ((E, D, F), D),
                                  ((E, D, F), D), ((E, F, D), F)))


# ---------------------------------------------------------------------------
# routing and the MoE block on identical inputs
# ---------------------------------------------------------------------------


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes this slice is about."""
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.vocab) == (48, 2048, 32, 4, 128, 151936)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.d_ff_expert) == \
        (128, 8, 768)
    assert full.param_count() == 30_532_108_288
    cfg, _ = _cfgs()
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.n_layers) == (4, 2, 4)


def test_route_matches_reference():
    cfg, _ = _cfgs()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, cfg.d_model), np.float32)
    w = _moe_weights(cfg)[0]
    got = ffn.route(torch.from_numpy(x), torch.from_numpy(w), 2)
    want = jffn.route(jnp.asarray(x), jnp.asarray(w), 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, j in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(j), atol=1e-6, rtol=1e-6)


def test_aux_losses_match_reference():
    cfg, _ = _cfgs()
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((48, 4), np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    got = ffn.aux_losses(torch.from_numpy(probs), torch.from_numpy(idx).long(),
                         4, torch.from_numpy(logits))
    want = jffn.aux_losses(jnp.asarray(probs), jnp.asarray(idx), 4,
                           jnp.asarray(logits))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("path", ["moe_ref", "moe_dispatch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(path, dtype):
    """Both port paths against the JAX ``moe_ref`` (the JAX package's
    one-device path) on the same input; routing equal, the aux losses in
    f32 noise.  The dispatch drops no token: every one of 2 x 37 tokens,
    top 2 of 4 experts, is held to the oracle."""
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, cfg.d_model), np.float32)
    ws = _moe_weights(cfg, seed=6)
    t_args = [_to_torch(x, dtype)] + [torch.from_numpy(ws[0])] + [
        _to_torch(w, dtype) for w in ws[1:]]
    j_args = [_to_jax(x, dtype)] + [jnp.asarray(ws[0])] + [
        _to_jax(w, dtype) for w in ws[1:]]
    log = ffn.RouteLog()
    y, lb, z = getattr(ffn, path)(*t_args, cfg=cfg, log=log)
    jy, jlb, jz = jffn.moe_ref(*j_args, cfg=jcfg)
    jroute = jffn.route(j_args[0].reshape(-1, cfg.d_model), j_args[1], 2)
    np.testing.assert_array_equal(log.calls[0][0].numpy(),
                                  np.asarray(jroute[1]))
    assert y.dtype == t_args[0].dtype and y.shape == x.shape
    tol = F32_TOL if dtype == "float32" else MOE_TOL
    np.testing.assert_allclose(y.float().numpy(), _np(jy), **tol)
    np.testing.assert_allclose(lb.item(), float(jlb), rtol=1e-5)
    np.testing.assert_allclose(z.item(), float(jz), rtol=1e-5)


def test_dispatch_equals_the_oracle_on_skewed_routing():
    """A router that sends every token with a positive sum to experts 0
    and 1 and every other to 2 and 3 (ragged segments), and the same at
    top 1 (an expert left empty): the dispatch is the oracle's function,
    to f32 rounding on the CPU."""
    import dataclasses
    cfg, _ = _cfgs()
    cfg1 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            top_k=1))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 37, cfg.d_model),
                                             np.float32))
    router = torch.zeros((cfg.d_model, 4))
    router[:, 0], router[:, 1] = 1.0, 0.5
    ws = [torch.from_numpy(w) for w in _moe_weights(cfg, seed=9)[1:]]
    for c in (cfg, cfg1):
        want = ffn.moe_ref(x, router, *ws, cfg=c)
        got = ffn.moe_dispatch(x, router, *ws, cfg=c)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def _jax_layer_input(np_params, x, dtype):
    """Layer 0's params of the JAX tree, cast, and x as a JAX array."""
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"])
    if dtype == "float32":
        lp = jax.tree.map(lambda a: a.astype(jnp.float32), lp)
    return lp, _to_jax(x, dtype)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_apply_matches_reference(impl, dtype):
    """One full MoE layer (attention, then the MoE block) on the same
    input.  In bf16 the two sides' attention rounds differently, so a
    token may route elsewhere at a near-tie: those tokens (checked to be
    near-ties) are left out of the comparison."""
    cfg, jcfg = _cfgs()
    np_params = _params("float32" if dtype == "float32" else "bfloat16")
    lp, jx = _jax_layer_input(np_params, np.random.default_rng(7)
                              .standard_normal((B, S, cfg.d_model),
                                               np.float32), dtype)
    pos = jnp.arange(S, dtype=jnp.int32)
    jy, jlb, jz = jblocks.moe_layer_apply(jx, lp, jcfg, JShardCtx(),
                                          positions=pos)
    # the JAX side's routing, from its own blocks
    h = jrms_norm(jx, lp["ln1"], jcfg.norm_eps)
    a, _, _ = jblocks.self_attention_block(h, lp["attn"], jcfg, JShardCtx(),
                                           q_pos=pos, k_pos=pos)
    h2 = jrms_norm(jx + a, lp["ln2"], jcfg.norm_eps)
    _, je, jp, _ = jffn.route(h2.reshape(B * S, -1), lp["moe"]["router"], 2)
    port = from_jax_params(np_params, cfg, device="cpu").layers[0]
    log = ffn.RouteLog()
    y, lb, z = moe_layer_apply(torch.from_numpy(np.array(_np(jx))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32),
        port, cfg, ShardCtx(impl=impl, routes=log),
        positions=torch.arange(S, dtype=torch.int32))
    same = _same_routing(log.calls[0][0], je)
    if dtype == "float32":
        assert same.all()
        np.testing.assert_allclose(y.numpy(), _np(jy), **F32_TOL)
        np.testing.assert_allclose(lb.item(), float(jlb), rtol=1e-5)
        np.testing.assert_allclose(z.item(), float(jz), rtol=1e-4)
        return
    _assert_near_ties(~same, np.asarray(jp))
    keep = same.reshape(B, S)
    assert keep.sum() >= B * S - 2
    np.testing.assert_allclose(y.float().numpy()[keep], _np(jy)[keep], **TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(dtype: str):
    """The JAX model's parameters as numpy (f32 casts every bf16 leaf)."""
    _, jcfg = _cfgs()
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jax.tree.map(np.asarray, params)


def _same_routing(t_experts: torch.Tensor, j_experts) -> np.ndarray:
    """Per token: the same set of experts on both sides."""
    a = np.sort(t_experts.numpy(), -1)
    b = np.sort(np.asarray(j_experts), -1)
    return (a == b).all(-1)


def _assert_near_ties(differ: np.ndarray, probs: np.ndarray, k: int = 2):
    """Every token in ``differ`` is a near-tie by the reference side's
    router probabilities ``probs`` (T, E)."""
    lg = -np.sort(-np.log(probs[differ]), -1)
    gaps = lg[:, k - 1] - lg[:, k]
    assert (gaps < NEAR_TIE).all(), gaps


def _jax_layers(params, jcfg, x, attend):
    """The JAX model's layers one by one through the JAX package's own
    blocks (``attend`` runs layer i's attention and returns the residual
    stream after it): the stream after the last layer, and per layer its
    input and routing (experts, probs) as numpy."""
    layers = []
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        x_in = x
        x = attend(x, lp, i)
        h2 = jrms_norm(x, lp["ln2"], jcfg.norm_eps)
        m = lp["moe"]
        _, e, p, _ = jffn.route(h2.reshape(-1, jcfg.d_model), m["router"],
                                jcfg.moe.top_k)
        layers.append((np.array(x_in, np.float32), np.array(e),
                       np.array(p)))
        y, _, _ = jffn.moe_ref(h2, m["router"], m["w_gate"], m["w_up"],
                               m["w_down"], cfg=jcfg)
        x = x + y
    return x, layers


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    """The JAX model's prefill and 4 decode steps (each fed the previous
    step's greedy token), run layer by layer through the JAX package's
    own blocks: (tokens, (prefill logits, K, V, layers), [(tok, logits,
    layers)] per step, final K), ``layers`` as :func:`_jax_layers`."""
    _, jcfg = _cfgs()
    params = jax.tree.map(jnp.asarray, _params(dtype))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S),
                                               dtype=np.int32)
    ctx, pos = JShardCtx(), jnp.arange(S, dtype=jnp.int32)
    caches = []

    def attend_prefill(x, lp, i):
        h = jrms_norm(x, lp["ln1"], jcfg.norm_eps)
        a, k, v = jblocks.self_attention_block(h, lp["attn"], jcfg, ctx,
                                               q_pos=pos, k_pos=pos)
        pad = ((0, 0), (0, MAX_LEN - S), (0, 0), (0, 0))
        caches.append((jnp.pad(k, pad).astype(jnp.bfloat16),
                       jnp.pad(v, pad).astype(jnp.bfloat16)))
        return x + a

    x, layers = _jax_layers(params, jcfg, params["embed"][tokens],
                            attend_prefill)
    logits = jlm._logits(params, jcfg, x[:, -1:])
    k_cache = jnp.stack([c[0] for c in caches])
    v_cache = jnp.stack([c[1] for c in caches])
    prefill = (_np(logits), _np(k_cache), _np(v_cache), layers)
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for t in range(STEPS):
        caches = []

        def attend_decode(x, lp, i):
            x, kc, vc = jlm._decode_attn_block(x, lp, jcfg, ctx, k_cache[i],
                                               v_cache[i], jnp.int32(S + t),
                                               0, 0)
            caches.append((kc, vc))
            return x

        x, layers = _jax_layers(params, jcfg, params["embed"][tok],
                                attend_decode)
        k_cache = jnp.stack([c[0] for c in caches])
        v_cache = jnp.stack([c[1] for c in caches])
        logits = jlm._logits(params, jcfg, x)
        steps.append((np.array(tok), _np(logits), layers))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return tokens, prefill, steps, _np(k_cache)


def test_layerwise_reference_is_the_reference():
    """The layer-by-layer JAX run these tests read routing from is the
    JAX model's own prefill and decode (in f32, where it is exact to f32
    noise)."""
    _, jcfg = _cfgs()
    api, params = jbuild(jcfg), jax.tree.map(jnp.asarray, _params("float32"))
    tokens, (logits, k, v, _), steps, final_k = _reference("float32")
    want, cache = api.prefill(params, {"tokens": jnp.asarray(tokens)},
                              JShardCtx(), MAX_LEN)
    np.testing.assert_allclose(logits, _np(want), **F32_TOL)
    np.testing.assert_allclose(k, _np(cache["k"]), **TOL)
    np.testing.assert_allclose(v, _np(cache["v"]), **TOL)
    for tok, step_logits, _ in steps:
        want, cache = api.decode_step(params, cache, jnp.asarray(tok),
                                      JShardCtx())
        np.testing.assert_allclose(step_logits, _np(want), **F32_TOL)
    np.testing.assert_allclose(final_k, _np(cache["k"]), **TOL)


def _port(dtype: str):
    cfg, _ = _cfgs()
    return cfg, from_jax_params(_params(dtype), cfg, device="cpu")


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_matches_reference_layer_by_layer(impl, dtype):
    """Each layer of the port on the JAX model's own input to that layer
    (its prefill, every token): the same experts in f32; in bf16, where the
    two sides round one layer's attention differently, a decision may
    differ only at a near-tie."""
    cfg, params = _port(dtype)
    _, (_, _, _, layers), _, _ = _reference(dtype)
    x_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    pos = torch.arange(S, dtype=torch.int32)
    differ = 0
    for lp, (x_in, experts, probs) in zip(params.layers, layers):
        log = ffn.RouteLog()
        moe_layer_apply(torch.from_numpy(x_in).to(x_dtype), lp, cfg,
                        ShardCtx(impl=impl, routes=log), positions=pos)
        same = _same_routing(log.calls[0][0], experts)
        if dtype == "float32":
            assert same.all()
        _assert_near_ties(~same, probs)
        differ += int((~same).sum())
    assert differ <= 2


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(impl, dtype):
    """Prefill logits and the KV cache, then 4 teacher-forced decode
    steps.  f32 routes freely and must route as the JAX model does
    everywhere; bf16 takes the JAX model's expert choices
    (``ffn.RouteLog(forced=...)``), so the two compute one function and the
    logits are held at every position (module docstring)."""
    cfg, params = _port(dtype)
    tokens, (logits, k, v, layers), steps, final_k = _reference(dtype)
    api = build(cfg)
    tol = F32_TOL if dtype == "float32" else TOL

    def routed(j_layers, fn):
        """``fn(ctx)`` free (f32: then the routing must match) or forced
        to the JAX model's experts (bf16)."""
        experts = [torch.from_numpy(e).long() for _, e, _ in j_layers]
        log = ffn.RouteLog(forced=experts if dtype == "bfloat16" else None)
        out = fn(ShardCtx(impl=impl, routes=log))
        assert len(log.calls) == len(j_layers)
        for (te, _), je in zip(log.calls, experts):
            assert _same_routing(te, je).all()
        return out

    got, cache = routed(layers, lambda ctx: api.prefill(
        params, {"tokens": torch.from_numpy(tokens)}, ctx, MAX_LEN))
    assert got.shape == (B, 1, cfg.vocab) and cache["pos"] == S
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, MAX_LEN,
                                       cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(got.float().numpy(), logits, **tol)
    np.testing.assert_allclose(cache["k"].float().numpy(), k, **TOL)
    np.testing.assert_allclose(cache["v"].float().numpy(), v, **TOL)
    for i, (tok, want, j_layers) in enumerate(steps):
        got, cache = routed(j_layers, lambda ctx: api.decode_step(
            params, cache, torch.from_numpy(tok), ctx))
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(cache["k"].float().numpy(), final_k, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_forward_aux_losses_and_loss_match_reference(impl):
    """``forward_lm``'s load-balance and z losses summed over the layers,
    and ``lm_loss``'s total with their coefficients, in f32."""
    cfg, jcfg = _cfgs()
    params = jax.tree.map(jnp.asarray, _params("float32"))
    _, port = _port("float32")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    jlogits, jlb, jz = jlm.forward_lm(params, jcfg, jnp.asarray(tokens),
                                      JShardCtx())
    ctx = ShardCtx(impl=impl)
    logits, lb, z = build(cfg).forward(port, torch.from_numpy(tokens), ctx)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **F32_TOL)
    np.testing.assert_allclose(lb.item(), float(jlb), rtol=1e-5)
    np.testing.assert_allclose(z.item(), float(jz), rtol=1e-5)
    assert lb.item() > 0 and z.item() > 0
    jtotal, jaux = jlm.lm_loss(params, jcfg, {n: jnp.asarray(a)
                                              for n, a in batch.items()},
                               JShardCtx())
    total, aux = build(cfg).loss(port, {n: torch.from_numpy(a)
                                        for n, a in batch.items()}, ctx)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for name in ("ce", "load_balance", "router_z"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-5)
    moe = cfg.moe
    assert total.item() == pytest.approx(
        aux["ce"].item() + moe.load_balance_coef * lb.item()
        + moe.router_z_coef * z.item(), rel=1e-6)


def test_weights_round_trip_the_moe_leaves_bit_exactly():
    np_params = _params("bfloat16")
    cfg, port = _port("bfloat16")
    layer = port.layers[1]
    assert layer.moe.router.dtype == torch.float32
    assert layer.moe.w_gate.dtype == torch.bfloat16
    assert tuple(layer.moe.w_down.shape) == (4, 64, cfg.d_model)
    back = to_jax_params(port)
    for name in ("router", "w_gate", "w_up", "w_down"):
        want = np_params["layers"]["moe"][name]
        got = back["layers"]["moe"][name]
        assert got.shape == want.shape
        np.testing.assert_array_equal(
            got.view(np.int16) if got.dtype.itemsize == 2 else got,
            want.view(np.int16) if want.dtype.itemsize == 2 else want)
    assert set(back["layers"]) == set(np_params["layers"])


# ---------------------------------------------------------------------------
# the attention kernels at head dim 128
# ---------------------------------------------------------------------------


def _pair(a: np.ndarray, dtype: str):
    return _to_jax(a, dtype), _to_torch(a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd128_plain_matches_pallas(dtype):
    """8 query heads over 1 KV head (G 8, as qwen3's 32 over 4), S 128."""
    B_, Hq, Hkv, S_, hd = 1, 8, 1, 128, 128
    rng = np.random.default_rng(128)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B_, Hq, S_, hd), (B_, Hkv, S_, hd),
                         (B_, Hkv, S_, hd)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    port = flash_attention_bhsd(tq, tk, tv, causal=True)
    assert port.dtype == tq.dtype and port.shape == (B_, Hq, S_, hd)
    pallas = jax_flash(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(port.float().numpy(), _np(pallas),
                               **KTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_hd128_plain_matches_pallas(dtype):
    """One query per sequence, G 8, against a partly filled cache."""
    B_, Hq, Hkv, S_, hd, fill = 2, 8, 1, 128, 128, 100
    rng = np.random.default_rng(129)
    q = rng.standard_normal((B_, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    v = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B_, S_))
    k_pos = np.ascontiguousarray(np.where(pos <= fill, pos, -1), np.int32)
    q_pos = np.full((B_,), fill, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    port = decode_attention_bhd(tq, tk, tv, torch.from_numpy(k_pos),
                                torch.from_numpy(q_pos))
    pallas = jax_decode(jq, jk, jv, jnp.asarray(k_pos), jnp.asarray(q_pos),
                        bk=64, interpret=True)
    np.testing.assert_allclose(port.float().numpy(), _np(pallas),
                               **KTOL[dtype])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_server_generates_on_the_cpu():
    cfg, _ = _cfgs()
    server = Server(cfg, device="cpu", max_len=S + 8,
                    telemetry=TelemetryRegistry())
    server.load(0)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)}
    tokens = server.generate(batch, 5)
    assert tokens.shape == (B, 5) and tokens.dtype == np.int32
    logits, cache = server.prefill(batch)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    want = [tok]
    for _ in range(4):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        want.append(tok)
    np.testing.assert_array_equal(tokens, torch.cat(want, 1).numpy())


def test_server_prices_its_first_stream_at_qwen3s_own_step():
    cfg, _ = _cfgs()
    server = Server(cfg, device="cpu", max_len=20,
                    telemetry=TelemetryRegistry())
    assert server.decode_step_ms() == H100_DECODE_STEP_MS[ARCH]
    assert serve.FAMILY_STAND_IN["moe"] == ARCH


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    assert "generated (2, 4)" in capsys.readouterr().out


def test_server_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(_cfgs()[0])
