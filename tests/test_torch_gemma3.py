"""The port's gemma3-1b path against the JAX package's.

gemma3 runs on the dense path with new shapes: a 5:1 local:global window
pattern (``ModelConfig.layer_windows``), ``q_dim`` unequal to ``d_model``,
and head dim 256 at full width.  The smoke variant here is built by
``smoke_variant(..., n_layers=6, head_dim=32)`` on both sides: six layers,
so layer 5 is global and layers 0-4 have the window of 32, and q_dim 128
against d_model 64, so a mix-up of the two cannot pass.  With a 48-token
prompt (past the window): prefill logits and the populated KV cache, and
four decode steps teacher-forced with the JAX model's greedy tokens.  Then
both attention kernels at hd 256 through the port's CPU path (their plain
versions) against the JAX package's Pallas kernels in interpret mode, and
the server on the CPU.

Tolerances.  Model logits and the bf16 KV cache: atol 0.1 with rtol 0.03,
as ``tests/test_torch_model.py`` states for bf16 activations (the two
frameworks round to bf16 at different places: a few bf16 ulps).  The
kernels: f32 3e-5 (sums in another order), bf16 3e-2 (one bf16 rounding
of the output), as ``tests/test_torch_kernels.py`` states.
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
from repro.models.config import smoke_variant as jsmoke_variant

from repro_torch.configs import get_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import lm as tlm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.config import smoke_variant
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.03)
KTOL = {"float32": dict(atol=3e-5, rtol=3e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
ARCH = "gemma3-1b"
SMOKE = dict(n_layers=6, head_dim=32)
B, S, MAX_LEN, STEPS = 2, 48, 56, 4


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _cfg():
    return smoke_variant(get_config(ARCH), **SMOKE)


@functools.lru_cache(maxsize=None)
def _reference():
    """JAX params, prompt, prefill outputs and teacher-forced decode."""
    cfg = jsmoke_variant(jget_config(ARCH), **SMOKE)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
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
    return jax.tree.map(np.asarray, params), tokens, prefill, steps, \
        _np(cache["k"])


def _port():
    cfg = _cfg()
    np_params, tokens, prefill, steps, final_k = _reference()
    return cfg, from_jax_params(np_params, cfg, device="cpu"), tokens, \
        prefill, steps, final_k


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes this slice is about, at full and smoke width."""
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.q_dim, full.d_ff, full.vocab, full.window) == \
        (26, 1152, 4, 1, 256, 1024, 6912, 262144, 512)
    assert full.layer_windows() == [0 if (i + 1) % 6 == 0 else 512
                                    for i in range(26)]
    assert tlm.cache_kind(full) == "full"
    cfg = _cfg()
    assert cfg.q_dim == 128 and cfg.d_model == 64 and cfg.window == 32
    assert cfg.layer_windows() == [32, 32, 32, 32, 32, 0]
    assert cfg.layer_windows() == jsmoke_variant(
        jget_config(ARCH), **SMOKE).layer_windows()


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_prefill_matches_reference(impl):
    cfg, params, tokens, (logits, k, v), _, _ = _port()
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
def test_teacher_forced_decode_matches_reference(impl):
    cfg, params, tokens, _, steps, final_k = _port()
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    for i, (tok, want) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    np.testing.assert_allclose(cache["k"].float().numpy(), final_k, **TOL)


def test_window_bites_past_the_prompt_window():
    """The local layers' window matters at this prompt: with every layer
    global the logits move (the test above would not see a window
    ignored)."""
    import dataclasses
    cfg, params, tokens, (logits, _, _), _, _ = _port()
    wide = dataclasses.replace(cfg, window=0, global_every=0)
    got, _ = build(wide).prefill(params, {"tokens": torch.from_numpy(tokens)},
                                 ShardCtx(impl="ref"), MAX_LEN)
    assert np.abs(got.float().numpy() - logits).max() > 0.1


# ---------------------------------------------------------------------------
# the attention kernels at head dim 256
# ---------------------------------------------------------------------------


def _pair(a: np.ndarray, dtype: str):
    t, j = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_hd256_plain_matches_pallas_and_oracle(dtype, window):
    """gemma3's grouping (4 query heads over 1 KV head) at hd 256."""
    B_, Hq, Hkv, S_, hd = 1, 4, 1, 256, 256
    rng = np.random.default_rng(window + 256)
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
@pytest.mark.parametrize("window", [0, 48])
def test_decode_hd256_plain_matches_pallas(dtype, window):
    """One query per sequence against a partly filled cache at hd 256."""
    B_, Hq, Hkv, S_, hd, fill = 2, 4, 1, 128, 256, 100
    rng = np.random.default_rng(window + 7)
    q = rng.standard_normal((B_, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    v = rng.standard_normal((B_, Hkv, S_, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B_, S_))
    k_pos = np.ascontiguousarray(np.where(pos <= fill, pos, -1), np.int32)
    q_pos = np.full((B_,), fill, np.int32)
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


def test_server_generates_on_the_cpu():
    cfg = _cfg()
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


def test_server_prices_its_first_stream_at_gemma3s_own_step():
    """Keyed by config, not family: gemma3 is not priced at smollm's."""
    server = Server(_cfg(), device="cpu", max_len=20,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[ARCH]
    assert step > 2.0 and step != H100_DECODE_STEP_MS["smollm-360m"]
    assert server.decode_step_ms() == step


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "48", "--gen", "4"])
    assert "generated (2, 4)" in capsys.readouterr().out
