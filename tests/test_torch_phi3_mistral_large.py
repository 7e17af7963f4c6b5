"""The port's phi3-mini-3.8b and mistral-large-123b paths against the JAX
package's.

Both are dense decoders of full attention; what they bring to the port
are shapes.  phi3-mini's head dim is 3072 / 32 = 96, which no config
before it had: at ``smoke_variant(..., d_model=192, n_heads=2,
n_kv_heads=2, head_dim=96)`` (a grouping of 1, as phi3's 32 over 32) the
whole model runs at hd 96, RoPE over 48 frequency pairs included.
mistral-large groups 96 query heads over 8 KV heads (12 a group): at
``smoke_variant(..., d_model=192, n_heads=12, n_kv_heads=1,
head_dim=16)`` the grouping is 12.  For each, from the same weights
(``from_jax_params``): the training forward, the prefill's logits and KV
cache for a 40-token prompt, 4 decode steps teacher-forced with the JAX
model's greedy tokens, and the bit-exact weight round trip.  Then RoPE
at hd 96, and both attention kernels at hd 96 through the port's CPU path
(their plain versions) against the JAX package's Pallas kernels in
interpret mode; the server on the CPU.

Tolerances.  Model logits and the bf16 KV cache: atol 0.1 with rtol 0.03,
as ``tests/test_torch_model.py`` states for bf16 activations (the two
frameworks round to bf16 at different places: a few bf16 ulps).  RoPE in
f32: atol 1e-4 with rtol 1e-5 (the same f32 operations, but at position
4095 the angle is about 4e3 rad, where an f32 ulp is 2.4e-4 rad, and the
two libraries reduce so large an argument of cos and sin differently: 2e-5
apart here).
The kernels: f32 3e-5 (sums in another order), bf16 3e-2 (one bf16
rounding of the output), as ``tests/test_torch_kernels.py`` states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_bhd as jax_decode
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx
from repro.models.common import apply_rope as japply_rope
from repro.models.config import smoke_variant as jsmoke_variant
from repro.models.lm import forward_lm as jforward_lm

from repro_torch.configs import get_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import lm as tlm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.common import apply_rope
from repro_torch.models.config import smoke_variant
from repro_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.03)
KTOL = {"float32": dict(atol=3e-5, rtol=3e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
#: the smoke shapes of each config: phi3 at hd 96, mistral-large at a
#: grouping of 12
SMOKE = {"phi3-mini-3.8b": dict(d_model=192, n_heads=2, n_kv_heads=2,
                                head_dim=96),
         "mistral-large-123b": dict(d_model=192, n_heads=12, n_kv_heads=1,
                                    head_dim=16)}
ARCHS = list(SMOKE)
B, S, MAX_LEN, STEPS = 2, 40, 48, 4


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _cfg(arch):
    return smoke_variant(get_config(arch), **SMOKE[arch])


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """JAX params, prompt, forward logits, prefill outputs and
    teacher-forced decode (greedy tokens of the JAX model)."""
    cfg = jsmoke_variant(jget_config(arch), **SMOKE[arch])
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    fwd, _, _ = jax.jit(lambda p, t: jforward_lm(p, cfg, t, JShardCtx()))(
        params, jnp.asarray(tokens))
    jprefill = jax.jit(lambda p, t: api.prefill(p, {"tokens": t},
                                                JShardCtx(), MAX_LEN))
    jdecode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, JShardCtx()))
    logits, cache = jprefill(params, jnp.asarray(tokens))
    prefill = (_np(logits), _np(cache["k"]), _np(cache["v"]))
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), _np(logits)))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return (jax.tree.map(np.asarray, params), tokens, _np(fwd), prefill,
            steps, _np(cache["k"]))


def _port(arch):
    np_params, tokens, fwd, prefill, steps, final_k = _reference(arch)
    cfg = _cfg(arch)
    return cfg, from_jax_params(np_params, cfg, device="cpu"), tokens, fwd, \
        prefill, steps, final_k


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes this slice is about, at full and smoke width."""
    phi3 = get_config("phi3-mini-3.8b")
    assert (phi3.n_layers, phi3.d_model, phi3.n_heads, phi3.n_kv_heads,
            phi3.hd, phi3.d_ff, phi3.vocab) == (32, 3072, 32, 32, 96, 8192,
                                                32064)
    assert phi3.param_count() == 3_821_076_480
    large = get_config("mistral-large-123b")
    assert (large.n_layers, large.d_model, large.n_heads, large.n_kv_heads,
            large.hd, large.d_ff, large.vocab) == (88, 12288, 96, 8, 128,
                                                   28672, 32768)
    assert large.n_heads // large.n_kv_heads == 12
    for arch in ARCHS:
        assert tlm.cache_kind(get_config(arch)) == "full"
        assert get_config(arch).param_count() == \
            jget_config(arch).param_count()
    assert _cfg("phi3-mini-3.8b").hd == 96
    cfg = _cfg("mistral-large-123b")
    assert cfg.n_heads // cfg.n_kv_heads == 12 and cfg.q_dim == 192


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    cfg, params, tokens, fwd, _, _, _ = _port(arch)
    got, _, _ = build(cfg).forward(params, torch.from_numpy(tokens),
                                   ShardCtx(impl=impl))
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.float().numpy(), fwd, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, impl):
    cfg, params, tokens, _, (logits, k, v), _, _ = _port(arch)
    got, cache = build(cfg).prefill(
        params, {"tokens": torch.from_numpy(tokens)}, ShardCtx(impl=impl),
        MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab) and cache["pos"] == S
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, MAX_LEN,
                                       cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(got.float().numpy(), logits, **TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(), k, **TOL)
    np.testing.assert_allclose(cache["v"].float().numpy(), v, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch, impl):
    cfg, params, tokens, _, _, steps, final_k = _port(arch)
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    for i, (tok, want) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(), final_k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_bit_for_bit(arch):
    """The JAX tree (bf16, as numpy) carries into the port and back with
    every leaf's bits and shape."""
    cfg, params, _, _, _, _, _ = _port(arch)
    np_params = _reference(arch)[0]
    back = to_jax_params(params)
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
    assert tuple(params.layers[0].attn.wq.shape) == (cfg.d_model, cfg.q_dim)


# ---------------------------------------------------------------------------
# head dim 96: RoPE and the attention kernels
# ---------------------------------------------------------------------------


def test_rope_at_hd96_matches_reference():
    """48 frequency pairs at phi3's theta, positions into the thousands."""
    rng = np.random.default_rng(96)
    x = rng.standard_normal((2, 5, 3, 96), dtype=np.float32)
    pos = np.array([0, 1, 95, 1023, 4095], np.int32)
    theta = get_config("phi3-mini-3.8b").rope_theta
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-5)


def _pair(a: np.ndarray, dtype: str):
    t, j = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_hd96_plain_matches_pallas_and_oracle(dtype, window):
    """B1 H2 S128 at hd 96, a grouping of 1 as phi3's."""
    B_, Hq, Hkv, S_, hd = 1, 2, 2, 128, 96
    rng = np.random.default_rng(window + 96)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B_, Hq, S_, hd), (B_, Hkv, S_, hd),
                         (B_, Hkv, S_, hd)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    port = flash_attention_bhsd(tq, tk, tv, causal=True, window=window)
    assert port.dtype == tq.dtype and port.shape == (B_, Hq, S_, hd)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(port.float().numpy(), _np(pallas),
                               **KTOL[dtype])
    np.testing.assert_allclose(port.float().numpy(), _np(oracle),
                               **KTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fill,ring", [(100, False), (127, False),
                                       (300, True)])
def test_decode_hd96_plain_matches_pallas(dtype, fill, ring):
    """One query per sequence at hd 96 against a partly filled, a full and
    a wrapped ring cache (every slot kept by position, not index)."""
    B_, Hq, Hkv, S_, hd = 2, 2, 2, 128, 96
    rng = np.random.default_rng(fill + 96)
    q = rng.standard_normal((B_, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    v = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B_, S_))
    if ring:
        k_pos = fill - np.mod(fill - pos, S_)
    else:
        k_pos = np.where(pos <= fill, pos, -1)
    k_pos = np.ascontiguousarray(k_pos, np.int32)
    q_pos = np.full((B_,), fill, np.int32)
    window = S_ if ring else 0
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    port = decode_attention_bhd(tq, tk, tv, torch.from_numpy(k_pos),
                                torch.from_numpy(q_pos), window=window)
    pallas = jax_decode(jq, jk, jv, jnp.asarray(k_pos), jnp.asarray(q_pos),
                        window=window, bk=64, interpret=True)
    np.testing.assert_allclose(port.float().numpy(), _np(pallas),
                               **KTOL[dtype])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generates_on_the_cpu(arch):
    cfg = _cfg(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_server_prices_its_first_stream_at_its_own_step(arch):
    """Keyed by config, not family: neither is priced at smollm's."""
    server = Server(_cfg(arch), device="cpu", max_len=20,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[arch]
    assert step != H100_DECODE_STEP_MS["smollm-360m"]
    assert server.decode_step_ms() == step


@pytest.mark.parametrize("arch", ARCHS)
def test_main_runs_the_cpu_smoke(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    assert "generated (2, 4)" in capsys.readouterr().out
