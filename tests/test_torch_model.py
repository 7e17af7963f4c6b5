"""The port's dense LM against the JAX package's, from the same weights.

The JAX model initialises its parameters; ``from_jax_params`` converts the
numpy tree into the port's module.  Prefill logits and the populated KV
cache, then four decode steps teacher-forced with the JAX model's greedy
tokens, must agree.

Tolerance: both sides compute in bf16 (bf16 weights and activations, f32
softmax and norm statistics), but the two frameworks round to bf16 at
different places (matmul accumulation, the attention probabilities), so
values agree to a few bf16 ulps: logits are of magnitude 2-4 here, where a
bf16 ulp is 0.016; atol 0.1 with rtol 0.03 allows about 6 ulps.  Both the
plain path (``impl="ref"``) and the kernel route (``impl="cuda"``, whose
wrappers compute their plain versions on CPU tensors) are held to it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx

from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models.api import build
from repro_torch.models.attention import (attention, cache_positions_full,
                                          cache_positions_ring)
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.03)
B, S, MAX_LEN, STEPS = 2, 24, 32, 4

CASES = [("smollm-360m", 0), ("smollm-360m", 8), ("repro-100m", 0)]


@functools.lru_cache(maxsize=None)
def _reference(arch: str, window: int):
    """JAX params, prompt, prefill outputs and teacher-forced decode."""
    cfg = dataclasses.replace(jget_smoke(arch), window=window)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jprefill = jax.jit(lambda p, t: api.prefill(p, {"tokens": t},
                                                JShardCtx(), MAX_LEN))
    jdecode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, JShardCtx()))
    logits, cache = jprefill(params, jnp.asarray(tokens))
    prefill = (np.asarray(logits, np.float32),
               np.asarray(cache["k"], np.float32),
               np.asarray(cache["v"], np.float32))
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), np.asarray(logits, np.float32)))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return jax.tree.map(np.asarray, params), tokens, prefill, steps


def _port(arch: str, window: int):
    cfg = dataclasses.replace(get_smoke_config(arch), window=window)
    np_params, tokens, prefill, steps = _reference(arch, window)
    return cfg, from_jax_params(np_params, cfg, device="cpu"), tokens, \
        prefill, steps


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch,window", CASES)
def test_prefill_matches_reference(arch, window, impl):
    cfg, params, tokens, (logits, k, v), _ = _port(arch, window)
    got, cache = build(cfg).prefill(params, {"tokens": torch.from_numpy(tokens)},
                                    ShardCtx(impl=impl), MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.bfloat16
    assert cache["pos"] == S
    assert cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), logits, **TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(), k, **TOL)
    np.testing.assert_allclose(cache["v"].float().numpy(), v, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch,window", CASES)
def test_teacher_forced_decode_matches_reference(arch, window, impl):
    cfg, params, tokens, _, steps = _port(arch, window)
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    for i, (tok, want) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok), ctx)
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **TOL)


def test_kernel_route_equals_plain_route_closely():
    """impl='cuda' (the kernels' plain versions here) and impl='ref' differ
    only where the attention probabilities are rounded."""
    cfg, params, tokens, _, _ = _port("smollm-360m", 0)
    api = build(cfg)
    a, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                       ShardCtx(impl="cuda"), MAX_LEN)
    b, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                       ShardCtx(impl="ref"), MAX_LEN)
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_dense_layer_matches_reference(impl):
    """One pre-norm layer, bf16 activations, against the JAX layer."""
    from repro.models.blocks import dense_layer_apply as jlayer
    from repro_torch.models.blocks import dense_layer_apply
    arch, window = "smollm-360m", 8
    cfg, params, _, _, _ = _port(arch, window)
    np_params = _reference(arch, window)[0]
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"])
    x = np.random.default_rng(2).standard_normal((2, 20, cfg.d_model),
                                                 dtype=np.float32)
    pos = np.arange(20, dtype=np.int32)
    want = jlayer(jnp.asarray(x).astype(jnp.bfloat16), layer0,
                  dataclasses.replace(jget_smoke(arch), window=window),
                  JShardCtx(), positions=jnp.asarray(pos), window=window)
    got = dense_layer_apply(torch.from_numpy(x).to(torch.bfloat16),
                            params.layers[0], cfg,
                            ShardCtx(impl=impl), positions=torch.from_numpy(pos),
                            window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def test_random_init_is_seeded():
    cfg = get_smoke_config("smollm-360m")
    a = build(cfg).init(3, device="cpu")
    b = build(cfg).init(3, device="cpu")
    c = build(cfg).init(4, device="cpu")
    assert torch.equal(a.layers[1].attn.wq, b.layers[1].attn.wq)
    assert not torch.equal(a.layers[1].attn.wq, c.layers[1].attn.wq)
    assert a.embed.dtype == torch.bfloat16 and a.layers[0].ln1.dtype == \
        torch.float32
    assert len(a.layers) == cfg.n_layers
    assert not any(p.requires_grad for p in a.parameters())


def test_unported_family_raises():
    """Every family is ported now, the enc-dec one in ``models/encdec.py``:
    the decoder module refuses it rather than build a decoder of it, and
    what is still not ported raises (remat ``"dots"``)."""
    from repro_torch.models import lm as tlm
    cfg = get_smoke_config("repro-100m")
    encdec = dataclasses.replace(cfg, family="encdec", enc_layers=2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        tlm.init_lm(encdec, generator=gen, device="cpu")
    dots = dataclasses.replace(cfg, remat="dots")
    params = build(dots).init(0, device="cpu", trainable=True)
    with pytest.raises(NotImplementedError):
        build(dots).forward(params, torch.zeros((1, 4), dtype=torch.int32),
                            ShardCtx(impl="ref"))


def test_primitives_match_reference():
    from repro.models import common as jcommon
    from repro.models import attention as jattn
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) + 7
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0)), atol=1e-5, rtol=1e-5)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    s = rng.standard_normal((16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(h), torch.from_numpy(s)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(h), jnp.asarray(s))),
        atol=1e-5, rtol=1e-5)
    for pos in (0, 5, 13):
        np.testing.assert_array_equal(
            cache_positions_ring(8, pos).numpy(),
            np.asarray(jattn.cache_positions_ring(8, jnp.int32(pos))))
        np.testing.assert_array_equal(
            cache_positions_full(16, pos).numpy(),
            np.asarray(jattn.cache_positions_full(16, jnp.int32(pos))))


def test_chunked_plain_attention_matches_unchunked(monkeypatch):
    """The query-chunked plain path (large score workspaces) is the same
    function as the one-shot path."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 256, 4, 16, generator=g)
    k = torch.randn(1, 256, 2, 16, generator=g)
    v = torch.randn(1, 256, 2, 16, generator=g)
    pos = torch.arange(256, dtype=torch.int32)
    whole = attention(q, k, v, q_pos=pos, k_pos=pos, window=9)
    monkeypatch.setattr(tattn, "ATTN_CHUNK_ELEMS", 1024)  # two 128-query chunks
    chunked = attention(q, k, v, q_pos=pos, k_pos=pos, window=9)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)
