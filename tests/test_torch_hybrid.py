"""The port's hybrid family (zamba2-1.2b) against the JAX package's.

The smoke-width zamba2 (4 Mamba2 layers, the shared attention block after
every 2: two sites, window 32) from the same weights (``from_jax_params``):
the training forward; prefill logits, both Mamba caches and the shared
block's ring cache for a 48-token prompt (past the window, so the ring
wraps); four teacher-forced decode steps; the bit-exact weight round trip
with ``shared_attn``.  Then the ring-length divergence: below the window
(``max_len`` 20) the JAX package's decode raises and the port's equals
full-cache attention.  The SSD scan at the state dim zamba2 has (N = 64)
through the port's CPU path against the Pallas kernel in interpret mode;
the server on the CPU.

Tolerances are those of ``tests/test_torch_ssm.py``: logits, the bf16
conv cache and the bf16 shared K/V atol 0.1 with rtol 0.03 (bf16
activations rounded at different places by the two frameworks, a few bf16
ulps); the f32 SSM cache of the first segment (before any shared block)
atol 1e-4 with rtol 1e-3, and of the later segments atol 0.1 with rtol
0.03: their inputs come through the shared block's attention, which the
two frameworks round to bf16 at different places, so those states inherit
the few bf16 ulps of their inputs (about 1e-2 of their scale here, where
the first segment's agree to 1e-7); the SSD scan in f32 atol 1e-4 with
rtol 1e-5 (sums in another order).  The port's kernel
route (``impl="cuda"``, the kernels' plain versions on CPU tensors) and
its plain route (``impl="ref"``) are both held to them.
"""

import dataclasses
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
from repro.models.lm import forward_lm as jforward_lm

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.ssd_scan import ssd_scan_bhsd
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import lm as tlm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.tree import flatten_with_paths
from repro_torch.weights import from_jax_params, param_names, to_jax_params

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.03)
STATE_TOL = dict(atol=1e-4, rtol=1e-3)
SSD_TOL = dict(atol=1e-4, rtol=1e-5)
ARCH = "zamba2-1.2b"
B, S, MAX_LEN, STEPS = 2, 48, 56, 4


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _check_states(cfg, got: torch.Tensor, want: np.ndarray) -> None:
    """The stacked SSM states: the first segment's to ``STATE_TOL``, the
    later ones (downstream of a shared block) to ``TOL``."""
    first = cfg.attn_every
    np.testing.assert_allclose(got[:first].numpy(), want[:first],
                               **STATE_TOL)
    np.testing.assert_allclose(got[first:].numpy(), want[first:], **TOL)


@functools.lru_cache(maxsize=None)
def _reference():
    """JAX params, prompt, forward, prefill outputs and teacher-forced
    decode (greedy tokens of the JAX model)."""
    cfg = jget_smoke(ARCH)
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
    prefill = {"logits": _np(logits),
               "conv": _np(cache["mamba"].conv),
               "ssm": np.asarray(cache["mamba"].ssm),
               "shared_k": _np(cache["shared_k"]),
               "shared_v": _np(cache["shared_v"])}
    steps = []
    tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), _np(logits)))
        tok = jnp.argmax(logits[:, -1], -1, keepdims=True).astype(jnp.int32)
    final = {"ssm": np.asarray(cache["mamba"].ssm),
             "shared_k": _np(cache["shared_k"])}
    return (jax.tree.map(np.asarray, params), tokens, _np(fwd), prefill,
            steps, final)


def _port():
    cfg = get_smoke_config(ARCH)
    np_params, tokens, fwd, prefill, steps, final = _reference()
    return cfg, from_jax_params(np_params, cfg, device="cpu"), tokens, fwd, \
        prefill, steps, final


def test_config_full_width_and_sites():
    """Field equality with the reference is in test_torch_configs.py."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.window, cfg.attn_every) == \
        (38, 2048, 32, 32, 64, 8192, 32000, 4096, 6)
    assert (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm_heads) == (64, 64, 64)
    sites = tlm._sites(cfg)
    assert len(sites) == 7 and sites[0] == (0, 6) and sites[-1] == (36, 38)
    cache = tlm.init_lm_cache(cfg, 2, 4608 + 33, device="meta")
    assert tuple(cache["shared_k"].shape) == (7, 2, 4096, 32, 64)
    assert cache["shared_v"].dtype == torch.bfloat16
    assert tuple(cache["mamba"].ssm.shape) == (38, 2, 64, 64, 64)
    # below the window the ring is max_len slots, as the JAX package's cache
    short = tlm.init_lm_cache(cfg, 1, 100, device="meta")
    assert short["shared_k"].shape[2] == 100


@pytest.mark.parametrize("n_every", [(4, 2), (38, 6), (7, 7), (5, 0)])
def test_segment_bounds_match_reference(n_every):
    from repro.models.lm import _segment_bounds as jbounds
    n, every = n_every
    assert tlm._segment_bounds(n, every or n) == jbounds(n, every or n)


def test_forward_matches_reference():
    cfg, params, tokens, fwd, _, _, _ = _port()
    with torch.no_grad():
        got, lb, z = build(cfg).forward(params, torch.from_numpy(tokens),
                                        ShardCtx(impl="ref"))
    assert got.shape == (B, S, cfg.vocab) and float(lb) == float(z) == 0.0
    np.testing.assert_allclose(got.float().numpy(), fwd, **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_prefill_matches_reference(impl):
    cfg, params, tokens, _, want, _, _ = _port()
    got, cache = build(cfg).prefill(
        params, {"tokens": torch.from_numpy(tokens)}, ShardCtx(impl=impl),
        MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab) and cache["pos"] == S
    n_sites = len(tlm._sites(cfg))
    assert n_sites == 2
    assert tuple(cache["shared_k"].shape) == (n_sites, B, cfg.window,
                                              cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(got.float().numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(cache["mamba"].conv.float().numpy(),
                               want["conv"], **TOL)
    _check_states(cfg, cache["mamba"].ssm, want["ssm"])
    # ring-packed: slot j holds the last prompt step p with p % 32 == j
    for name in ("shared_k", "shared_v"):
        np.testing.assert_allclose(cache[name].float().numpy(), want[name],
                                   **TOL)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_teacher_forced_decode_matches_reference(impl):
    cfg, params, tokens, _, _, steps, final = _port()
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    for i, (tok, want) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == S + i + 1
        np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    _check_states(cfg, cache["mamba"].ssm, final["ssm"])
    np.testing.assert_allclose(cache["shared_k"].float().numpy(),
                               final["shared_k"], **TOL)


def test_shared_block_runs_at_every_site_with_one_set_of_weights():
    """Every site reads the one ``shared_attn``: zeroing its output
    projection changes the logits (the block ran), and the cache holds one
    K/V slab per site, each from that site's own input."""
    cfg, params, tokens, _, _, _, _ = _port()
    api, ctx = build(cfg), ShardCtx(impl="ref")
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    assert not torch.equal(cache["shared_k"][0], cache["shared_k"][1])
    shared = [n for n in param_names(params) if n.startswith("shared_attn.")]
    assert len(shared) == 9     # wq wk wv wo, w_gate w_up w_down, ln1 ln2
    before, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                            MAX_LEN)
    wo = params.shared_attn.attn.wo
    saved = wo.detach().clone()
    with torch.no_grad():
        wo.zero_()
    after, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, ctx,
                           MAX_LEN)
    with torch.no_grad():
        wo.copy_(saved)
    assert not torch.equal(before, after)


def test_weights_round_trip_bit_for_bit():
    """JAX tree -> port -> JAX tree: every leaf, ``shared_attn`` included,
    comes back with the same path, shape, dtype and bits."""
    cfg, params, _, _, _, _, _ = _port()
    np_params = _reference()[0]
    back = to_jax_params(params)
    want = dict(flatten_with_paths(np_params))
    got = dict(flatten_with_paths(back))
    assert sorted(got) == sorted(want)
    assert any(p.startswith("shared_attn/") for p in got)
    for path, a in want.items():
        b = got[path]
        assert a.shape == b.shape, path
        assert a.dtype.itemsize == b.dtype.itemsize, path
        assert np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes(), path
    again = from_jax_params(back, cfg, device="cpu")
    for (n, p), (m, q) in zip(params.named_parameters(),
                              again.named_parameters()):
        assert n == m and p.dtype == q.dtype
        assert torch.equal(p.view(torch.int16) if p.dtype == torch.bfloat16
                           else p, q.view(torch.int16)
                           if q.dtype == torch.bfloat16 else q), n


def _short_decode(jcfg, cfg, np_params, tokens, max_len, steps=3):
    """JAX and port decode at ``max_len`` with a 16-token prompt: the
    port's logits, and the JAX package's (or the exception it raised)."""
    tok = tokens[:, :16]
    api, ctx = build(cfg), ShardCtx(impl="ref")
    params = from_jax_params(np_params, cfg, device="cpu")
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(tok)},
                                ctx, max_len)
    port = []
    forced = tokens[:, 16:16 + steps]
    for t in range(steps):
        logits, cache = api.decode_step(
            params, cache, torch.from_numpy(forced[:, t:t + 1]), ctx)
        port.append(logits.float().numpy())
    japi = jbuild(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    _, jcache = japi.prefill(jp, {"tokens": jnp.asarray(tok)}, JShardCtx(),
                             max_len)
    ref = []
    try:
        for t in range(steps):
            jl, jcache = japi.decode_step(jp, jcache,
                                          jnp.asarray(forced[:, t:t + 1]),
                                          JShardCtx())
            ref.append(_np(jl))
    except ValueError as e:
        return port, e
    return port, ref


def test_ring_below_the_window_equals_full_cache_where_reference_raises():
    """At ``max_len`` 20 < window 32 the shared cache has 20 slots.  The
    JAX package rings its decode over the window (32 positions for 20
    slots) and raises; the port rings over the 20 slots, which is the full
    cache, and equals the JAX package with no window (every position is
    inside the window) step for step."""
    cfg = get_smoke_config(ARCH)
    np_params, tokens = _reference()[0], _reference()[1]
    port, err = _short_decode(jget_smoke(ARCH), cfg, np_params, tokens, 20)
    assert isinstance(err, ValueError)
    assert "broadcast" in str(err)
    full = dataclasses.replace(cfg, window=0)
    port_full, ref_full = _short_decode(
        dataclasses.replace(jget_smoke(ARCH), window=0), full, np_params,
        tokens, 20)
    for a, b, c in zip(port, port_full, ref_full):
        np.testing.assert_allclose(a, c, **TOL)
        np.testing.assert_array_equal(a, b)


def test_ring_at_the_window_matches_reference():
    """At ``max_len`` >= window the two ring over the same 32 slots."""
    cfg = get_smoke_config(ARCH)
    np_params, tokens = _reference()[0], _reference()[1]
    port, ref = _short_decode(jget_smoke(ARCH), cfg, np_params, tokens, 40)
    assert isinstance(ref, list)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, **TOL)


def test_decode_past_a_short_ring_raises():
    """A ring shorter than the window cannot wrap without dropping a key
    the window keeps: the step past it raises, as a full cache's does."""
    cfg, params, tokens, _, _, _, _ = _port()
    api, ctx = build(cfg), ShardCtx(impl="ref")
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :16])}, ctx, 17)
    tok = torch.from_numpy(tokens[:, 16:17])
    _, cache = api.decode_step(params, cache, tok, ctx)    # position 16
    with pytest.raises(ValueError, match="past the shared cache"):
        api.decode_step(params, cache, tok, ctx)


def test_prefill_refuses_a_ragged_prompt():
    cfg, params, tokens, _, _, _, _ = _port()
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        build(cfg).prefill(params, {"tokens": torch.from_numpy(
            tokens[:, :20])}, ShardCtx(), MAX_LEN)


# ---------------------------------------------------------------------------
# the SSD scan at zamba2's state dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_at_state_dim_64_matches_pallas(dtype):
    """The kernel wrapper's CPU path (its plain version) at P 64, N 64 —
    zamba2's head and state dims — over three chunks, against the Pallas
    kernel in interpret mode and JAX's ``ssd_chunked`` (state).  bf16
    x/B/C/y: atol 3e-2 with rtol 3e-2, one bf16 rounding of the output."""
    rng = np.random.default_rng(64)
    Bsz, H, G, Sl, P, N, Q = 1, 2, 1, 96, 64, 64, 32
    x = rng.standard_normal((Bsz, H, Sl, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, H, Sl)) - 2)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bsz, G, Sl, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, G, Sl, N)).astype(np.float32)
    if dtype == "bfloat16":
        tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (x, Bm, Cm))
        jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (x, Bm, Cm))
        tol = dict(atol=3e-2, rtol=3e-2)
    else:
        tx, tB, tC = (torch.from_numpy(a) for a in (x, Bm, Cm))
        jx, jB, jC = (jnp.asarray(a) for a in (x, Bm, Cm))
        tol = SSD_TOL
    y, state = ssd_scan_bhsd(tx, torch.from_numpy(dt), torch.from_numpy(A),
                             tB, tC, chunk=Q)
    assert y.shape == (Bsz, H, Sl, P) and state.shape == (Bsz, H, P, N)
    pallas = jax_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                          chunk=Q, interpret=True)
    np.testing.assert_allclose(y.float().numpy(), _np(pallas), **tol)
    if dtype == "float32":
        _, jstate = jssm.ssd_chunked(
            *(jnp.asarray(a) for a in (x.transpose(0, 2, 1, 3),
                                       dt.transpose(0, 2, 1), A,
                                       Bm.transpose(0, 2, 1, 3),
                                       Cm.transpose(0, 2, 1, 3))), Q)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   **SSD_TOL)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_server_generates_on_the_cpu():
    """The server's kernel route (plain versions on CPU tensors) streams
    the same greedy tokens as a step-by-step decode, with the ring
    wrapped."""
    cfg = get_smoke_config(ARCH)
    server = Server(cfg, device="cpu", max_len=S + 8,
                    telemetry=TelemetryRegistry())
    server.load(0)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)}
    kbuild.reset_launches()
    tokens = server.generate(batch, 5)
    assert tokens.shape == (B, 5) and tokens.dtype == np.int32
    assert not any(kbuild.launch_counts().values())   # nothing on a card
    logits, cache = server.prefill(batch)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    want = [tok]
    for _ in range(4):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        want.append(tok)
    np.testing.assert_array_equal(tokens, torch.cat(want, 1).numpy())


def test_hybrid_server_prices_its_first_stream_from_the_table():
    """Before its first timed step a hybrid server prices its stream at
    zamba2's measured H100 step (no KeyError), and a config without an
    entry at its family's served config."""
    server = Server(get_smoke_config(ARCH), device="cpu", max_len=20,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[ARCH]
    assert step > 2.0
    assert server.decode_step_ms() == step
    assert server.stream_basin().tiers[0].latency_s == pytest.approx(
        step / 1e3)
    other = dataclasses.replace(get_smoke_config(ARCH), name="zamba2-x")
    assert serve.h100_step_ms(other) == step


def test_main_rounds_a_hybrid_prompt_to_the_chunk(monkeypatch, capsys):
    """Without --prompt-len the default 128 tokens round up to whole SSD
    chunks for the hybrid, as for the SSM family (48-step chunks here)."""
    chunky = dataclasses.replace(
        get_smoke_config(ARCH),
        ssm=dataclasses.replace(get_smoke_config(ARCH).ssm, chunk=48))
    monkeypatch.setattr(serve, "get_smoke_config", lambda arch: chunky)
    seen = []
    generate = Server.generate

    def spy(self, batch, n, sink=None):
        seen.append(np.asarray(batch["tokens"]).shape)
        return generate(self, batch, n, sink)

    monkeypatch.setattr(Server, "generate", spy)
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "1",
                "--gen", "2"])
    assert seen == [(1, 144)]
    assert "generated (1, 2)" in capsys.readouterr().out


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "48", "--gen", "4"])
    assert "generated (2, 4)" in capsys.readouterr().out


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_chunked_plain_attention_takes_a_ragged_tail(monkeypatch):
    """The plain path's query chunks need not divide the prompt (zamba2's
    4608 = 2^9 x 9 tokens against 910-query chunks): the last chunk is
    shorter, and the result is the one-shot one."""
    from repro_torch.models import attention as tattn
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 300, 4, 16, generator=g)
    k = torch.randn(1, 300, 4, 16, generator=g)
    v = torch.randn(1, 300, 4, 16, generator=g)
    pos = torch.arange(300, dtype=torch.int32)
    whole = tattn.attention(q, k, v, q_pos=pos, k_pos=pos, window=40)
    monkeypatch.setattr(tattn, "ATTN_CHUNK_ELEMS", 128 * 300)
    chunked = tattn.attention(q, k, v, q_pos=pos, k_pos=pos, window=40)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


def test_plain_decode_promotes_a_bf16_cache_under_f32_weights():
    """An f32 model (the noise floor's reference) against the bf16 cache:
    the plain path promotes the cache, as JAX does, and stays finite."""
    import copy
    cfg, params, tokens, _, _, _, _ = _port()
    p32 = copy.deepcopy(params).float()
    api, ctx = build(cfg), ShardCtx(impl="ref")
    logits, cache = api.prefill(p32, {"tokens": torch.from_numpy(tokens)},
                                ctx, MAX_LEN)
    assert cache["shared_k"].dtype == torch.bfloat16
    logits, _ = api.decode_step(p32, cache, torch.from_numpy(tokens[:, :1]),
                                ctx)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
