"""The port's mixtral-8x22b path against the JAX package's.

mixtral is the MoE family with every layer windowed, so its decode cache
is a ring of ``min(window, max_len)`` slots.  At ``smoke_variant`` width
(4 layers, d_model 64, 4 query heads over 1 KV head, hd 16, 4 experts, top
2, window 32) and ``max_len`` 56 (a 32-slot ring) the same weights go
through the JAX model and the port: a 48-token prompt (prefill past the
window, the ring packed from its last 32 steps) with 4 teacher-forced
decode steps, and a 28-token prompt with 8 steps, which cross the ring's
wrap at position 32; the training forward's aux losses and the loss over
48 tokens; the weight converter; the server.  Then the ring-length
divergence: below the window (``max_len`` 24) the JAX package's decode
raises and the port's equals a full-cache run under the same window mask.

Routing and tolerances are those of ``tests/test_torch_moe.py``: in f32
both sides route freely and the logits agree to f32 noise (atol and rtol
1e-4), the bf16 KV cache to atol 0.1 with rtol 0.03; in bf16 the port
takes the JAX model's expert choices, read from a layer-by-layer run of
the JAX package's own blocks (a near-tie may route elsewhere on two paths
that round differently), and the logits are held to atol 0.1 with rtol
0.03.  The port's kernel route (``impl="cuda"``, the kernels' plain
versions on CPU tensors) and its plain route (``impl="ref"``) are both
held to them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import blocks as jblocks
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx
from repro.models.common import rms_norm as jrms_norm

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import ffn
from repro_torch.models import lm as tlm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

ARCH = "mixtral-8x22b"
B, MAX_LEN = 2, 56
#: (prompt, decode steps): past the window at prefill; across the wrap
CASES = [(48, 4), (28, 8)]
F32_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=0.1, rtol=0.03)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _params(dtype: str):
    """The JAX model's parameters as numpy (f32 casts every bf16 leaf)."""
    params = jbuild(jget_smoke(ARCH)).init(jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jax.tree.map(np.asarray, params)


def _tokens(n: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, 256, (B, n), dtype=np.int32)


def _jax_layers(params, jcfg, x, attend):
    """The JAX model's layers one by one through the JAX package's own
    blocks (``attend`` runs layer i's attention and returns the residual
    stream after it): the stream after the last layer and each layer's
    experts (T, k) as numpy."""
    experts = []
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        x = attend(x, lp, i)
        h2 = jrms_norm(x, lp["ln2"], jcfg.norm_eps)
        m = lp["moe"]
        _, e, _, _ = jffn.route(h2.reshape(-1, jcfg.d_model), m["router"],
                                jcfg.moe.top_k)
        experts.append(np.array(e))
        y, _, _ = jffn.moe_ref(h2, m["router"], m["w_gate"], m["w_up"],
                               m["w_down"], cfg=jcfg)
        x = x + y
    return x, experts


@functools.lru_cache(maxsize=None)
def _reference(dtype: str, prompt: int, n_steps: int):
    """The JAX model's prefill into the 32-slot ring and ``n_steps``
    decode steps (each fed the previous step's greedy token), layer by
    layer through its own blocks: (tokens, (logits, K, V, experts),
    [(tok, logits, experts)] per step, final K)."""
    jcfg = jget_smoke(ARCH)
    slots = min(jcfg.window, MAX_LEN)
    params = jax.tree.map(jnp.asarray, _params(dtype))
    tokens = _tokens(prompt)
    ctx, pos = JShardCtx(), jnp.arange(prompt, dtype=jnp.int32)
    caches = []

    def attend_prefill(x, lp, i):
        h = jrms_norm(x, lp["ln1"], jcfg.norm_eps)
        a, k, v = jblocks.self_attention_block(h, lp["attn"], jcfg, ctx,
                                               q_pos=pos, k_pos=pos,
                                               window=jcfg.window)
        caches.append((jlm._ring_pack(k, slots).astype(jnp.bfloat16),
                       jlm._ring_pack(v, slots).astype(jnp.bfloat16)))
        return x + a

    x, experts = _jax_layers(params, jcfg, params["embed"][tokens],
                             attend_prefill)
    logits = jlm._logits(params, jcfg, x[:, -1:])
    k_cache = jnp.stack([c[0] for c in caches])
    v_cache = jnp.stack([c[1] for c in caches])
    prefill = (_np(logits), _np(k_cache), _np(v_cache), experts)
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for t in range(n_steps):
        caches = []

        def attend_decode(x, lp, i):
            x, kc, vc = jlm._decode_attn_block(
                x, lp, jcfg, ctx, k_cache[i], v_cache[i],
                jnp.int32(prompt + t), jcfg.window, jcfg.window)
            caches.append((kc, vc))
            return x

        x, experts = _jax_layers(params, jcfg, params["embed"][tok],
                                 attend_decode)
        k_cache = jnp.stack([c[0] for c in caches])
        v_cache = jnp.stack([c[1] for c in caches])
        logits = jlm._logits(params, jcfg, x)
        steps.append((np.array(tok), _np(logits), experts))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return tokens, prefill, steps, _np(k_cache)


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes this slice is about, at full and smoke width."""
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.vocab, full.window, full.global_every) == \
        (56, 6144, 48, 8, 128, 32768, 4096, 0)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.d_ff_expert) == \
        (8, 2, 16384)
    assert full.param_count() == jget_config(ARCH).param_count()
    assert tlm.cache_kind(full) == "ring"
    assert tlm._attn_cache_len(full, 4096 + 33) == 4096
    cfg = get_smoke_config(ARCH)
    assert (cfg.window, cfg.moe.n_experts, cfg.moe.top_k, cfg.hd) == \
        (32, 4, 2, 16)
    assert tlm._attn_cache_len(cfg, MAX_LEN) == 32


@pytest.mark.parametrize("prompt,n_steps", CASES[:1])
def test_layerwise_reference_is_the_reference(prompt, n_steps):
    """The layer-by-layer JAX run the tests read routing from is the JAX
    model's own prefill and decode over the ring (in f32, where it is
    exact to f32 noise)."""
    jcfg = jget_smoke(ARCH)
    api, params = jbuild(jcfg), jax.tree.map(jnp.asarray, _params("float32"))
    tokens, (logits, k, v, _), steps, final_k = _reference("float32",
                                                           prompt, n_steps)
    want, cache = api.prefill(params, {"tokens": jnp.asarray(tokens)},
                              JShardCtx(), MAX_LEN)
    assert cache["k"].shape[2] == 32
    np.testing.assert_allclose(logits, _np(want), **F32_TOL)
    np.testing.assert_allclose(k, _np(cache["k"]), **TOL)
    np.testing.assert_allclose(v, _np(cache["v"]), **TOL)
    for tok, step_logits, _ in steps:
        want, cache = api.decode_step(params, cache, jnp.asarray(tok),
                                      JShardCtx())
        np.testing.assert_allclose(step_logits, _np(want), **F32_TOL)
    np.testing.assert_allclose(final_k, _np(cache["k"]), **TOL)


def _same_routing(t_experts: torch.Tensor, j_experts) -> np.ndarray:
    a = np.sort(t_experts.numpy(), -1)
    b = np.sort(np.asarray(j_experts), -1)
    return (a == b).all(-1)


@pytest.mark.parametrize("prompt,n_steps", CASES)
@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_across_the_ring_match_reference(
        prompt, n_steps, impl, dtype):
    """Prefill logits and the ring-packed KV cache, then teacher-forced
    decode steps through the ring (the 28-token prompt's cross its wrap
    at position 32).  f32 routes freely and must route as the JAX model
    does everywhere; bf16 takes the JAX model's expert choices."""
    cfg = get_smoke_config(ARCH)
    params = from_jax_params(_params(dtype), cfg, device="cpu")
    tokens, (logits, k, v, experts), steps, final_k = _reference(
        dtype, prompt, n_steps)
    api = build(cfg)
    tol = F32_TOL if dtype == "float32" else TOL

    def routed(j_experts, fn):
        want = [torch.from_numpy(e).long() for e in j_experts]
        log = ffn.RouteLog(forced=want if dtype == "bfloat16" else None)
        out = fn(ShardCtx(impl=impl, routes=log))
        assert len(log.calls) == len(want)
        for (te, _), je in zip(log.calls, want):
            assert _same_routing(te, je).all()
        return out

    got, cache = routed(experts, lambda ctx: api.prefill(
        params, {"tokens": torch.from_numpy(tokens)}, ctx, MAX_LEN))
    assert got.shape == (B, 1, cfg.vocab) and cache["pos"] == prompt
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, 32, cfg.n_kv_heads,
                                       cfg.hd)
    np.testing.assert_allclose(got.float().numpy(), logits, **tol)
    np.testing.assert_allclose(cache["k"].float().numpy(), k, **TOL)
    np.testing.assert_allclose(cache["v"].float().numpy(), v, **TOL)
    for i, (tok, want, j_experts) in enumerate(steps):
        got, cache = routed(j_experts, lambda ctx: api.decode_step(
            params, cache, torch.from_numpy(tok), ctx))
        assert cache["pos"] == prompt + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(cache["k"].float().numpy(), final_k, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_forward_aux_losses_and_loss_match_reference(impl):
    """``forward_lm``'s load-balance and z losses summed over the layers,
    and ``lm_loss``'s total, in f32 over 48 tokens (past the window)."""
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    params = jax.tree.map(jnp.asarray, _params("float32"))
    port = from_jax_params(_params("float32"), cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, 48),
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


def test_window_bites_past_the_prompt_window():
    """The window matters at the 48-token prompt: without it the logits
    move (the tests above would not see a window ignored)."""
    cfg = get_smoke_config(ARCH)
    params = from_jax_params(_params("float32"), cfg, device="cpu")
    tokens, (logits, _, _, _), _, _ = _reference("float32", 48, 4)
    wide = dataclasses.replace(cfg, window=0)
    got, _ = build(wide).prefill(params, {"tokens": torch.from_numpy(tokens)},
                                 ShardCtx(impl="ref"), MAX_LEN)
    assert np.abs(got.numpy() - logits).max() > 1e-2


# ---------------------------------------------------------------------------
# the dense ring below the window: a deliberate divergence
# ---------------------------------------------------------------------------


def _full_under_the_window(c):
    """``c`` with a full cache and the same window on every layer: a
    ``global_every`` past the depth leaves every layer windowed but makes
    ``cache_kind`` "full"."""
    return dataclasses.replace(c, global_every=c.n_layers + 1)


def _short_decode(jcfg, cfg, max_len, steps=3):
    """JAX and port decode at ``max_len`` with a 16-token prompt, in f32,
    teacher-forced: the port's logits, and the JAX package's (or the
    exception it raised)."""
    tokens = _tokens(16 + steps)
    tok = tokens[:, :16]
    api, ctx = build(cfg), ShardCtx(impl="ref")
    params = from_jax_params(_params("float32"), cfg, device="cpu")
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(tok)},
                                ctx, max_len)
    port = []
    for t in range(steps):
        logits, cache = api.decode_step(
            params, cache, torch.from_numpy(tokens[:, 16 + t:17 + t]), ctx)
        port.append(logits.numpy())
    japi = jbuild(jcfg)
    jp = jax.tree.map(jnp.asarray, _params("float32"))
    _, jcache = japi.prefill(jp, {"tokens": jnp.asarray(tok)}, JShardCtx(),
                             max_len)
    ref = []
    try:
        for t in range(steps):
            jl, jcache = japi.decode_step(
                jp, jcache, jnp.asarray(tokens[:, 16 + t:17 + t]),
                JShardCtx())
            ref.append(_np(jl))
    except ValueError as e:
        return port, e
    return port, ref


def test_dense_ring_below_the_window_equals_full_cache_where_reference_raises():
    """At ``max_len`` 24 < window 32 the ring cache has 24 slots.  The JAX
    package rings its decode over the window (32 positions for 24 slots:
    its window mask of 32 does not broadcast against the 24 scores) and
    raises; the port rings over the 24 slots, which at these positions is
    the full cache, and equals a full-cache run under the same window
    mask: the port's bit for bit, the JAX package's to f32 noise."""
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    assert tlm._attn_cache_len(cfg, 24) == 24 and cfg.window == 32
    port, err = _short_decode(jcfg, cfg, 24)
    assert isinstance(err, ValueError)
    assert "broadcast" in str(err)
    port_full, ref_full = _short_decode(_full_under_the_window(jcfg),
                                        _full_under_the_window(cfg), 24)
    assert tlm.cache_kind(_full_under_the_window(cfg)) == "full"
    assert isinstance(ref_full, list) and len(ref_full) == len(port)
    for a, b, c in zip(port, port_full, ref_full):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, **F32_TOL)


def test_dense_ring_at_the_window_matches_reference():
    """At ``max_len`` >= window the two ring over the same 32 slots."""
    port, ref = _short_decode(jget_smoke(ARCH), get_smoke_config(ARCH), 40)
    assert isinstance(ref, list)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_decode_past_a_short_dense_ring_raises():
    """A ring shorter than the window cannot wrap without dropping a key
    the window keeps: the step past it raises, as a full cache's does."""
    cfg = get_smoke_config(ARCH)
    params = from_jax_params(_params("float32"), cfg, device="cpu")
    api, ctx = build(cfg), ShardCtx(impl="ref")
    tokens = _tokens(17)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :16])}, ctx, 17)
    tok = torch.from_numpy(tokens[:, 16:17])
    _, cache = api.decode_step(params, cache, tok, ctx)    # position 16
    with pytest.raises(ValueError, match="past the cache"):
        api.decode_step(params, cache, tok, ctx)


# ---------------------------------------------------------------------------
# weights and the server
# ---------------------------------------------------------------------------


def test_weights_round_trip_bit_for_bit():
    """The JAX tree (bf16, as numpy) carries into the port and back with
    every leaf's bits."""
    np_params = _params("bfloat16")
    port = from_jax_params(np_params, get_smoke_config(ARCH), device="cpu")
    back = to_jax_params(port)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): a
                      for path, a in jax.tree_util.tree_flatten_with_path(
                          t)[0]}
    want, got = flat(np_params), flat(back)
    assert set(got) == set(want)
    for name, a in want.items():
        b = got[name]
        assert b.shape == a.shape, name
        view = lambda x: x.view(np.int16) if x.dtype.itemsize == 2 else x
        np.testing.assert_array_equal(view(b), view(a), err_msg=name)


def test_server_generates_across_the_wrap_on_the_cpu():
    cfg = get_smoke_config(ARCH)
    server = Server(cfg, device="cpu", max_len=28 + 9,
                    telemetry=TelemetryRegistry())
    server.load(0)
    batch = {"tokens": _tokens(28)}
    tokens = server.generate(batch, 9)
    assert tokens.shape == (B, 9) and tokens.dtype == np.int32
    logits, cache = server.prefill(batch)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    want = [tok]
    for _ in range(8):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        want.append(tok)
    assert cache["k"].shape[2] == 32 and cache["pos"] == 36
    np.testing.assert_array_equal(tokens, torch.cat(want, 1).numpy())


def test_server_prices_its_first_stream_at_mixtrals_own_step():
    server = Server(get_smoke_config(ARCH), device="cpu", max_len=20,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[ARCH]
    assert step != H100_DECODE_STEP_MS["qwen3-moe-30b-a3b"]
    assert server.decode_step_ms() == step
    assert serve.FAMILY_STAND_IN["moe"] == "qwen3-moe-30b-a3b"


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "40", "--gen", "4"])
    assert "generated (2, 4)" in capsys.readouterr().out
