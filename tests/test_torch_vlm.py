"""The port's VLM (llava-next-mistral-7b) against the JAX package's.

The VLM is the dense decoder with a stubbed vision frontend:
``frontend_len`` precomputed patch embeddings pass through a two-layer
projector (``w1``, tanh-approximated GELU in f32, ``w2``) and are
prepended to the text embeddings; the loss scores the text tail only.  At
smoke width (4 layers, d_model 64, 4 query heads over 1 KV head, 8 patch
positions) the same seeded numpy prompt and patch embeddings go through
both packages with the same weights (``weights.from_jax_params``): the
projected embeddings, the training forward and loss, prefill with its KV
cache, and four decode steps teacher-forced with the JAX model's greedy
tokens.

Tolerances.  bf16 logits, embeddings and KV cache are held within
``LOGIT_SHARE`` (5%) of the JAX values' scale (their largest magnitude):
the two frameworks round to bf16 at different places, a few bf16 ulps.
The loss (an f32 mean over tokens of bf16 logits) within ``LOSS_RTOL``,
1e-3 relative: a quarter of one bf16 ulp (2^-8), where the projector's
roundings add to the decoder's (``tests/test_torch_train.py`` holds two
dense layers to 2e-4).  The weights carried both ways are bit-exact.

One recorded divergence: the JAX package's serving CLI sizes the cache
without the patch positions and raises in prefill (``--arch
llava-next-mistral-7b --smoke``); the port's sizes it ``frontend_len +
prompt + gen + 1`` and serves.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import lm as tlm
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

ARCH = "llava-next-mistral-7b"
#: logits, embeddings and caches within this share of the JAX values' scale
LOGIT_SHARE = 0.05
#: the bf16 model's loss, relative
LOSS_RTOL = 1e-3
B, S, STEPS = 2, 16, 4
MAX_LEN = 8 + S + STEPS + 1


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_SHARE * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _reference():
    """JAX params, inputs, embeddings, forward, loss, prefill and
    teacher-forced decode."""
    cfg = jget_smoke(ARCH)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    patches = rng.standard_normal((B, cfg.frontend_len, cfg.d_model),
                                  dtype=np.float32)
    ctx = JShardCtx()
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "extra_embeds": jnp.asarray(patches)}
    embed = jlm._embed_inputs(params, cfg, batch["tokens"], ctx,
                              batch["extra_embeds"])
    logits, _, _ = jax.jit(lambda p, b: jlm.forward_lm(
        p, cfg, b["tokens"], ctx, extra_embeds=b["extra_embeds"]))(
        params, batch)
    loss, aux = jax.jit(lambda p, b: api.loss(p, b, ctx))(params, batch)
    jprefill = jax.jit(lambda p, b: api.prefill(p, b, ctx, MAX_LEN))
    jdecode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, ctx))
    plogits, cache = jprefill(params, {"tokens": batch["tokens"],
                                       "extra_embeds": batch["extra_embeds"]})
    prefill = (_np(plogits), _np(cache["k"]), _np(cache["v"]))
    steps = []
    tok = jnp.argmax(plogits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        dlogits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), _np(dlogits)))
        tok = jnp.argmax(dlogits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return (jax.tree.map(np.asarray, params), tokens, labels, patches,
            _np(embed), _np(logits), float(loss), float(aux["ce"]), prefill,
            steps, _np(cache["k"]))


def _port():
    cfg = get_smoke_config(ARCH)
    ref = _reference()
    return cfg, from_jax_params(ref[0], cfg, device="cpu"), ref


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes the slice runs, at full and smoke width."""
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.hd, full.d_ff, full.vocab,
            full.frontend_len) == ("vlm", 32, 4096, 32, 8, 128, 14336,
                                   32000, 576)
    assert full.param_count() == 7_275_282_432
    cfg = get_smoke_config(ARCH)
    assert (cfg.frontend, cfg.frontend_len, cfg.n_heads,
            cfg.n_kv_heads) == ("patch", 8, 4, 1)


def test_weights_round_trip_bit_exact():
    cfg, params, ref = _port()
    assert params.projector is not None
    back = to_jax_params(params)
    want = ref[0]
    assert set(back) == set(want)
    assert set(back["projector"]) == {"w1", "w2"}
    for name in ("w1", "w2"):
        np.testing.assert_array_equal(
            back["projector"][name].view(np.int16),
            want["projector"][name].view(np.int16))
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"].view(np.int16),
                                  want["layers"]["attn"]["wq"].view(np.int16))
    np.testing.assert_array_equal(back["final_norm"], want["final_norm"])


def test_projector_embedding_matches_reference():
    cfg, params, ref = _port()
    tokens, patches, embed = ref[1], ref[3], ref[4]
    got = tlm._embed_inputs(params, cfg, torch.from_numpy(tokens),
                            torch.from_numpy(patches))
    assert got.dtype == torch.bfloat16
    assert got.shape == (B, cfg.frontend_len + S, cfg.d_model)
    _close(got, embed)
    # the text tail is the token embeddings themselves
    assert torch.equal(got[:, cfg.frontend_len:],
                       params.embed[torch.from_numpy(tokens).long()])
    with pytest.raises(ValueError, match="extra_embeds"):
        tlm._embed_inputs(params, cfg, torch.from_numpy(tokens))


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_forward_matches_reference(impl):
    cfg, params, ref = _port()
    tokens, patches, logits = ref[1], ref[3], ref[5]
    got, lb, z = build(cfg).forward(params, torch.from_numpy(tokens),
                                    ShardCtx(impl=impl),
                                    extra_embeds=torch.from_numpy(patches))
    assert got.shape == (B, cfg.frontend_len + S, cfg.vocab)
    assert float(lb) == 0.0 and float(z) == 0.0
    _close(got, logits)


def test_loss_scores_only_the_text_tail():
    cfg, params, ref = _port()
    tokens, labels, patches, logits, loss, ce = ref[1:4] + ref[5:8]
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "extra_embeds": torch.from_numpy(patches)}
    got, aux = build(cfg).loss(params, batch, ShardCtx(impl="ref"))
    assert float(got) == pytest.approx(loss, rel=LOSS_RTOL)
    assert float(aux["ce"]) == pytest.approx(ce, rel=LOSS_RTOL)
    # the JAX model's own logits, scored on the tail, give the same loss:
    # the patch positions carry no labels
    from repro.models.common import cross_entropy_loss as jce
    tail = float(jce(jnp.asarray(logits[:, cfg.frontend_len:]),
                     jnp.asarray(labels)))
    assert tail == pytest.approx(loss, rel=1e-6)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_prefill_matches_reference(impl):
    cfg, params, ref = _port()
    tokens, patches, (logits, k, v) = ref[1], ref[3], ref[8]
    got, cache = build(cfg).prefill(
        params, {"tokens": torch.from_numpy(tokens),
                 "extra_embeds": torch.from_numpy(patches)},
        ShardCtx(impl=impl), MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab)
    assert cache["pos"] == cfg.frontend_len + S
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, MAX_LEN,
                                       cfg.n_kv_heads, cfg.hd)
    _close(got, logits)
    _close(cache["k"], k)
    _close(cache["v"], v)


def test_prefill_refuses_a_cache_without_the_patch_positions():
    """``max_len`` must hold the patches and the prompt: the JAX package's
    pad goes negative there (see the CLI test); the port says why."""
    cfg, params, ref = _port()
    with pytest.raises(ValueError, match="exceeds max_len"):
        build(cfg).prefill(params, {"tokens": torch.from_numpy(ref[1]),
                                    "extra_embeds": torch.from_numpy(ref[3])},
                           ShardCtx(impl="ref"), S + STEPS + 1)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_teacher_forced_decode_matches_reference(impl):
    cfg, params, ref = _port()
    tokens, patches, steps, final_k = ref[1], ref[3], ref[9], ref[10]
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens),
                                    "extra_embeds": torch.from_numpy(patches)},
                           ctx, MAX_LEN)
    for i, (tok, want) in enumerate(steps):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == cfg.frontend_len + S + i + 1
        _close(got, want)
    _close(cache["k"], final_k)


# ---------------------------------------------------------------------------
# the server and the CLI
# ---------------------------------------------------------------------------


def test_server_generates_on_the_cpu():
    cfg = get_smoke_config(ARCH)
    server = Server(cfg, device="cpu", max_len=MAX_LEN + 1,
                    telemetry=TelemetryRegistry())
    server.load(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "extra_embeds": rng.standard_normal(
                 (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)}
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


def test_server_prices_its_first_stream_at_llavas_own_step():
    server = Server(get_smoke_config(ARCH), device="cpu", max_len=40,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[ARCH]
    assert step > 2.0 and server.decode_step_ms() == step
    assert serve.FAMILY_STAND_IN["vlm"] == ARCH


def test_reference_cli_raises_where_the_port_serves(monkeypatch, capsys):
    """The same recipe: the JAX package's ``main`` sizes the cache as
    ``prompt_len + gen + 1``, without the 8 patch positions, and its
    prefill's pad goes negative; the port's adds them and serves."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "16",
            "--gen", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError, match="negative"):
        jserve.main()
    serve.main(argv + ["--device", "cpu"])
    assert "generated (2, 4)" in capsys.readouterr().out
