"""The port's Mamba2 SSM family against the JAX package's.

The SSD scan's plain version against the JAX oracle ``ssd_chunked`` and
the Pallas kernel in interpret mode; the decode step and both Mamba block
functions against JAX; then the smoke-width mamba2-1.3b from the same
weights (``from_jax_params``): prefill logits and both caches, four
teacher-forced decode steps, and the server on the CPU.

Tolerances.  The SSD scan in f32: atol 1e-4 with rtol 1e-5 — the two
frameworks sum the prefix sums and the contractions in other orders,
which moves outputs of magnitude about 40 by about 1e-5.  With bf16
inputs and output (the model's types): atol 3e-2, rtol 3e-2, one bf16
rounding of the output, as ``tests/test_kernels.py`` states for the
Pallas kernel.  Model logits and the bf16 conv cache: atol 0.1 with
rtol 0.03, as ``tests/test_torch_model.py`` states for bf16 activations;
the f32 SSM cache: atol 1e-4 with rtol 1e-3 (f32 state built from bf16
activations rounded at the same places; about 2e-5 apart here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels.ssd_scan import ssd_scan_bhsd as jax_ssd_scan
from repro.models import ssm as jssm
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_bhsd
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models import ssm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

SSD_TOL = dict(atol=1e-4, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
TOL = dict(atol=0.1, rtol=0.03)
STATE_TOL = dict(atol=1e-4, rtol=1e-3)
ARCH = "mamba2-1.3b"
B, S, MAX_LEN, STEPS = 2, 32, 40, 4


def _ssd_inputs(G: int, seed: int = 0, *, Bsz=2, H=4, S=64, P=16, N=16):
    """Model-layout SSD inputs: x (B,S,H,P), dt (B,S,H) post-softplus,
    A (H,) negative, B/C (B,S,G,N), all f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _bhsd(x, dt, A, Bm, Cm):
    """Model layout -> the kernels' (B, H, S, .) layout."""
    return (x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), A,
            Bm.transpose(0, 2, 1, 3), Cm.transpose(0, 2, 1, 3))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_plain_matches_oracle_and_pallas(G):
    """y and the final state of the port's plain scan against JAX's
    ``ssd_chunked``; the kernel wrapper's (its plain version here) against
    the Pallas kernel in interpret mode, in the kernels' layout."""
    ins = _ssd_inputs(G, seed=G)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in ins), 16)
    y, state = ssm.ssd_chunked(*(_t(a) for a in ins), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(js), **SSD_TOL)

    kins = _bhsd(*ins)
    ky, ks = ssd_scan_bhsd(*(_t(a) for a in kins), chunk=16)
    assert ky.shape == (2, 4, 64, 16) and ks.shape == (2, 4, 16, 16)
    pallas = jax_ssd_scan(*(jnp.asarray(a) for a in kins), chunk=16,
                          interpret=True)
    np.testing.assert_allclose(ky.numpy(), np.asarray(pallas), **SSD_TOL)
    np.testing.assert_allclose(ks.numpy(), np.asarray(js), **SSD_TOL)
    # the model-layout wrapper is the same function, without a copy of x
    oy, os_ = ops.ssd_scan(*(_t(a) for a in ins), chunk=16)
    assert torch.equal(oy, ky.transpose(1, 2)) and torch.equal(os_, ks)


def test_ssd_plain_bf16_matches_pallas():
    """bf16 x/B/C in and y out, as the model runs it."""
    x, dt, A, Bm, Cm = _bhsd(*_ssd_inputs(1, seed=7))
    bf = lambda a: _t(a).to(torch.bfloat16)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    y, _ = ssd_scan_bhsd(bf(x), _t(dt), _t(A), bf(Bm), bf(Cm), chunk=16)
    assert y.dtype == torch.bfloat16
    pallas = jax_ssd_scan(jbf(x), jnp.asarray(dt), jnp.asarray(A), jbf(Bm),
                          jbf(Cm), chunk=16, interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(pallas, np.float32), **BF16_TOL)


def test_ssd_state_carries_across_chunks():
    """Four chunks in one scan equal two scans of two chunks with the
    state handed over, and perturbing the first chunk moves the last
    chunk's output (the state flowed), in the port as in JAX."""
    x, dt, A, Bm, Cm = (_t(a) for a in _ssd_inputs(1, seed=3))
    dt = torch.full_like(dt, 0.5)
    A = torch.full_like(A, -0.01)            # slow decay: long memory
    y, state = ssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
    y1, s1 = ssm.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32],
                             Cm[:, :32], 16)
    y2, s2 = ssm.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:],
                             Cm[:, 32:], 16, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SSD_TOL)
    torch.testing.assert_close(s2, state, **SSD_TOL)
    x2 = x.clone()
    x2[:, 0] += 1.0
    y3, _ = ops.ssd_scan(x2, dt, A, Bm, Cm, chunk=16)
    assert not torch.allclose(y3[:, -16:], y[:, -16:], atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.ssd_chunked(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40], 16)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 4)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(4) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((2, 2, 16)).astype(np.float32)
    Cm = rng.standard_normal((2, 2, 16)).astype(np.float32)
    st = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, st)
    jy, js = jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))
    y, new = ssm.ssd_decode_step(*(_t(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(js), **SSD_TOL)


# ---------------------------------------------------------------------------
# the smoke-width model, from the JAX model's weights
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference():
    """JAX params, prompt, prefill outputs and teacher-forced decode."""
    cfg = jget_smoke(ARCH)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                               dtype=np.int32)
    jprefill = jax.jit(lambda p, t: api.prefill(p, {"tokens": t},
                                                JShardCtx(), MAX_LEN))
    jdecode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, JShardCtx()))
    logits, cache = jprefill(params, jnp.asarray(tokens))
    prefill = (np.asarray(logits, np.float32),
               np.asarray(cache["mamba"].conv, np.float32),
               np.asarray(cache["mamba"].ssm))
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), np.asarray(logits, np.float32),
                      np.asarray(cache["mamba"].ssm)))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return jax.tree.map(np.asarray, params), tokens, prefill, steps


def _port():
    cfg = get_smoke_config(ARCH)
    np_params, tokens, prefill, steps = _reference()
    return cfg, from_jax_params(np_params, cfg, device="cpu"), tokens, \
        prefill, steps


def test_config_full_width():
    """Field equality with the reference is in test_torch_configs.py."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.ssm.d_state,
            cfg.ssm.head_dim, cfg.ssm.chunk) == (48, 2048, 50280, 128, 64, 256)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.conv_dim, cfg.in_proj_dim) == \
        (4096, 64, 4352, 8512)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_mamba_blocks_match_reference(impl):
    """One layer's block in prefill form (with its state) and one decode
    step from that state, bf16 activations, against the JAX functions."""
    cfg, params, _, _, _ = _port()
    jcfg = jget_smoke(ARCH)
    lp0 = jax.tree.map(lambda a: jnp.asarray(a[0]), _reference()[0]["layers"])
    x = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model),
                                                 dtype=np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jout, jst = jax.jit(lambda h, p: jssm.mamba_block_train(
        h, p, jcfg, return_state=True))(jx, lp0)
    out, st = ssm.mamba_block_train(tx, params.layers[0], cfg, impl=impl,
                                    return_state=True)
    assert st.conv.dtype == torch.bfloat16 and st.ssm.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **TOL)
    np.testing.assert_allclose(st.conv.float().numpy(),
                               np.asarray(jst.conv, np.float32), **TOL)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm),
                               **STATE_TOL)
    x1 = x[:, :1]
    jout, jst = jax.jit(lambda h, p, st: jssm.mamba_block_decode(
        h, p, jcfg, st))(jnp.asarray(x1).astype(jnp.bfloat16), lp0, jst)
    out, st = ssm.mamba_block_decode(torch.from_numpy(x1).to(torch.bfloat16),
                                     params.layers[0], cfg, st)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **TOL)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(jst.ssm),
                               **STATE_TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_prefill_and_decode_match_reference(impl):
    cfg, params, tokens, (logits, conv, ssm_state), steps = _port()
    api, ctx = build(cfg), ShardCtx(impl=impl)
    got, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             ctx, MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.bfloat16
    mamba = cache["mamba"]
    assert cache["pos"] == S
    assert mamba.conv.shape == (cfg.n_layers, B, 3, cfg.conv_dim)
    assert mamba.conv.dtype == torch.bfloat16
    assert mamba.ssm.shape == (cfg.n_layers, B, cfg.ssm_heads,
                               cfg.ssm.head_dim, cfg.ssm.d_state)
    assert mamba.ssm.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), logits, **TOL)
    np.testing.assert_allclose(mamba.conv.float().numpy(), conv, **TOL)
    np.testing.assert_allclose(mamba.ssm.numpy(), ssm_state, **STATE_TOL)
    for i, (tok, want, want_ssm) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **TOL)
        np.testing.assert_allclose(cache["mamba"].ssm.numpy(), want_ssm,
                                   **STATE_TOL)


def test_prefill_refuses_a_ragged_prompt():
    cfg, params, tokens, _, _ = _port()
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        build(cfg).prefill(params, {"tokens": torch.from_numpy(
            tokens[:, :20])}, ShardCtx(), MAX_LEN)


def test_random_init_is_seeded_and_typed():
    cfg = get_smoke_config(ARCH)
    a, b = build(cfg).init(3, device="cpu"), build(cfg).init(3, device="cpu")
    assert torch.equal(a.layers[1].in_proj, b.layers[1].in_proj)
    lp = a.layers[0]
    assert lp.in_proj.shape == (cfg.d_model, cfg.in_proj_dim)
    assert lp.in_proj.dtype == lp.conv_w.dtype == lp.out_proj.dtype == \
        torch.bfloat16
    for name in ("ln", "conv_b", "A_log", "D", "dt_bias", "norm_w"):
        assert getattr(lp, name).dtype == torch.float32, name
    dt = torch.nn.functional.softplus(lp.dt_bias)
    assert bool(((dt > 0.9e-3) & (dt < 1.1e-1)).all())
    assert a.lm_head is not None and not torch.equal(a.lm_head, a.embed.T)


def test_server_generates_on_the_cpu():
    """The server's kernel route (the SSD scan's plain version on CPU
    tensors) streams the same greedy tokens as a step-by-step decode."""
    cfg = get_smoke_config(ARCH)
    server = Server(cfg, device="cpu", max_len=S + 8,
                    telemetry=TelemetryRegistry())
    server.load(0)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)}
    kbuild.reset_launches()
    tokens = server.generate(batch, 5)
    assert tokens.shape == (B, 5) and tokens.dtype == np.int32
    assert kbuild.launch_counts()["ssd_scan"] == 0    # nothing on a card
    logits, cache = server.prefill(batch)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    want = [tok]
    for _ in range(4):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        want.append(tok)
    np.testing.assert_array_equal(tokens, torch.cat(want, 1).numpy())


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "32", "--gen", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])
