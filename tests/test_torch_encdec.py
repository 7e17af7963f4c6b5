"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package's.

At smoke width (2 encoder and 2 decoder layers, d_model 64, 4 query heads
over 4 KV heads, head dim 16) the same seeded numpy frames and decoder
tokens go through both packages with the same weights
(``weights.from_jax_params``): ``encode`` (non-causal self attention, the
flash kernel's plain version under ``impl="cuda"``), ``cross_kv``, the
teacher-forced ``forward_encdec`` and ``encdec_loss``, ``ModelApi.prefill``
(encode, cross K/V, one decode step on the first decoder token, as the
JAX package's does) and a run of ``encdec_decode_step`` teacher-forced
with the JAX model's greedy tokens.

The decode kernel serves the cross attention: it keeps slot j when
``k_pos[j] <= q_pos``, so the model passes ``k_pos = 0..S_enc-1`` and
``q_pos = S_enc - 1`` and every encoder slot is kept.  The kernel's plain
version at those positions is held to the JAX package's ``causal=False``
attention; the decoder's own position in their place keeps too few slots.

Tolerances.  bf16 logits, encoder states and K/V are held within
``LOGIT_SHARE`` (5%) of the JAX values' scale (their largest magnitude):
the two frameworks round to bf16 at different places.  The loss (an f32
mean over bf16 logits) within ``LOSS_RTOL``, 1e-3 relative.  The
cross-attention kernel's plain version: f32 3e-5, bf16 3e-2 (one bf16
rounding of the output), as ``tests/test_torch_kernels.py`` states.  The
weights carried both ways are bit-exact.
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
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.launch import serve
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server
from repro_torch.models import encdec as tencdec
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.weights import from_jax_params, param_names, to_jax_params

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
#: logits, states and K/V within this share of the JAX values' scale
LOGIT_SHARE = 0.05
#: the bf16 model's loss, relative
LOSS_RTOL = 1e-3
KTOL = {"float32": dict(atol=3e-5, rtol=3e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
B, S_ENC, S_DEC, STEPS = 2, 24, 12, 5
MAX_LEN = S_DEC + STEPS + 1


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
    """JAX params, inputs, encoder states, cross K/V, forward, loss,
    prefill and teacher-forced decode, as a dict."""
    cfg = jget_smoke(ARCH)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S_DEC), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S_DEC), dtype=np.int32)
    ctx = JShardCtx()
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    enc = jax.jit(lambda p, f: jencdec.encode(p, cfg, f, ctx))(params, jf)
    ck, cv = jencdec.cross_kv(params, cfg, enc, ctx)
    logits = jax.jit(lambda p, f, t: jencdec.forward_encdec(
        p, cfg, f, t, ctx))(params, jf, jt)
    loss, _ = jax.jit(lambda p, b: api.loss(p, b, ctx))(
        params, {"frames": jf, "tokens": jt, "labels": jnp.asarray(labels)})
    plogits, cache = jax.jit(lambda p, b: api.prefill(p, b, ctx, MAX_LEN))(
        params, {"frames": jf, "tokens": jt})
    prefill = {"logits": _np(plogits), "k": _np(cache["k"]),
               "v": _np(cache["v"]), "cross_k": _np(cache["cross_k"]),
               "pos": int(cache["pos"])}
    jdecode = jax.jit(lambda p, c, t: api.decode_step(p, c, t, ctx))
    steps = []
    tok = jnp.argmax(plogits[:, -1], -1, keepdims=True).astype(jnp.int32)
    for _ in range(STEPS):
        dlogits, cache = jdecode(params, cache, tok)
        steps.append((np.array(tok), _np(dlogits)))
        tok = jnp.argmax(dlogits[:, -1], -1, keepdims=True).astype(jnp.int32)
    return dict(params=jax.tree.map(np.asarray, params), frames=frames,
                tokens=tokens, labels=labels, enc=_np(enc), ck=_np(ck),
                cv=_np(cv), logits=_np(logits), loss=float(loss),
                prefill=prefill, steps=steps, final_k=_np(cache["k"]))


def _port():
    cfg = get_smoke_config(ARCH)
    ref = _reference()
    return cfg, from_jax_params(ref["params"], cfg, device="cpu"), ref


def test_config_shapes():
    """Field equality with the reference is in test_torch_configs.py; here
    the shapes the slice runs, at full and smoke width."""
    full = get_config(ARCH)
    assert (full.family, full.enc_layers, full.n_layers, full.d_model,
            full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab) == ("encdec", 24, 24, 1024, 16, 16, 64, 8192,
                            256206)
    assert full.param_count() == 2_036_879_360
    cfg = get_smoke_config(ARCH)
    assert (cfg.enc_layers, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd) == (2, 2, 4, 4, 16)


def test_weights_round_trip_bit_exact():
    cfg, params, ref = _port()
    back, want = to_jax_params(params), ref["params"]
    assert set(back) == set(want)
    assert set(back["dec_layers"]) == set(want["dec_layers"])
    for path in (("enc_layers", "attn", "wq"), ("dec_layers", "cross", "wk"),
                 ("dec_layers", "mlp", "w_down"), ("frame_proj",),
                 ("lm_head",), ("embed",)):
        got, exp = back, want
        for key in path:
            got, exp = got[key], exp[key]
        assert got.shape == exp.shape, path
        np.testing.assert_array_equal(got.view(np.int16), exp.view(np.int16))
    for path in (("enc_norm",), ("dec_layers", "ln3")):
        got, exp = back, want
        for key in path:
            got, exp = got[key], exp[key]
        np.testing.assert_array_equal(got, exp)
    names = param_names(params)
    assert "dec_layers.1.cross.wq" in names and "enc_layers.0.ln2" in names


def test_api_init_builds_the_tree():
    """As many parameters as the JAX package's tree (``param_count`` is
    the reference's estimate, which counts a projector and no final
    norms for any frontend)."""
    cfg = get_smoke_config(ARCH)
    params = build(cfg).init(0, device="cpu")
    assert isinstance(params, tencdec.EncDec)
    assert len(params.enc_layers) == 2 and len(params.dec_layers) == 2
    assert params.frame_proj.shape == (cfg.d_model, cfg.d_model)
    want = jax.tree.leaves(_reference()["params"])
    assert sum(p.numel() for p in params.parameters()) == \
        sum(a.size for a in want)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_encode_matches_reference(impl):
    cfg, params, ref = _port()
    got = tencdec.encode(params, cfg, torch.from_numpy(ref["frames"]),
                         ShardCtx(impl=impl))
    assert got.dtype == torch.bfloat16
    _close(got, ref["enc"])


def test_encoder_attention_is_not_causal():
    """A causal encoder would give other states (the test above would not
    see the mask): the encoder's layer is the transformer layer without
    the causal mask, which moves its output."""
    from repro_torch.models.blocks import dense_layer_apply
    cfg, params, ref = _port()
    x = torch.from_numpy(ref["frames"]).to(torch.bfloat16) @ params.frame_proj
    pos = torch.arange(S_ENC, dtype=torch.int32)
    lp, ctx = params.enc_layers[0], ShardCtx(impl="ref")
    full = tencdec._enc_layer(x, lp, cfg, ctx, pos)
    torch.testing.assert_close(full, dense_layer_apply(
        x, lp, cfg, ctx, positions=pos, causal=False), rtol=0, atol=0)
    causal = dense_layer_apply(x, lp, cfg, ctx, positions=pos)
    assert (full.float() - causal.float()).abs().max() > 0.1


def test_cross_kv_matches_reference():
    cfg, params, ref = _port()
    enc = tencdec.encode(params, cfg, torch.from_numpy(ref["frames"]),
                         ShardCtx(impl="ref"))
    ck, cv = tencdec.cross_kv(params, cfg, enc)
    assert ck.dtype == cv.dtype == torch.bfloat16
    assert tuple(ck.shape) == (cfg.n_layers, B, S_ENC, cfg.n_kv_heads,
                               cfg.hd)
    _close(ck, ref["ck"])
    _close(cv, ref["cv"])


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_forward_matches_reference(impl):
    cfg, params, ref = _port()
    got, lb, z = build(cfg).forward(params, torch.from_numpy(ref["tokens"]),
                                    ShardCtx(impl=impl),
                                    frames=torch.from_numpy(ref["frames"]))
    assert got.shape == (B, S_DEC, cfg.vocab)
    assert float(lb) == 0.0 and float(z) == 0.0
    _close(got, ref["logits"])


def test_loss_matches_reference():
    cfg, params, ref = _port()
    batch = {n: torch.from_numpy(ref[n])
             for n in ("frames", "tokens", "labels")}
    loss, aux = build(cfg).loss(params, batch, ShardCtx(impl="ref"))
    assert float(loss) == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert float(aux["ce"]) == float(loss)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_prefill_decodes_only_the_first_token_as_reference(impl):
    cfg, params, ref = _port()
    want = ref["prefill"]
    batch = {"frames": torch.from_numpy(ref["frames"]),
             "tokens": torch.from_numpy(ref["tokens"])}
    got, cache = build(cfg).prefill(params, batch, ShardCtx(impl=impl),
                                    MAX_LEN)
    assert got.shape == (B, 1, cfg.vocab)
    assert cache["pos"] == want["pos"] == 1
    assert tuple(cache["k"].shape) == (cfg.n_layers, B, MAX_LEN,
                                       cfg.n_kv_heads, cfg.hd)
    _close(got, want["logits"])
    _close(cache["k"], want["k"])
    _close(cache["v"], want["v"])
    _close(cache["cross_k"], want["cross_k"])
    # the rest of the decoder prompt is not read
    other = dict(batch, tokens=batch["tokens"].flip(1))
    other["tokens"][:, 0] = batch["tokens"][:, 0]
    again, _ = build(cfg).prefill(params, other, ShardCtx(impl=impl),
                                  MAX_LEN)
    assert torch.equal(again, got)


@pytest.mark.parametrize("impl", ["ref", "cuda"])
def test_teacher_forced_decode_matches_reference(impl):
    cfg, params, ref = _port()
    api, ctx = build(cfg), ShardCtx(impl=impl)
    _, cache = api.prefill(params, {"frames": torch.from_numpy(ref["frames"]),
                                    "tokens": torch.from_numpy(ref["tokens"])},
                           ctx, MAX_LEN)
    for i, (tok, want) in enumerate(ref["steps"]):
        got, cache = api.decode_step(params, cache, torch.from_numpy(tok),
                                     ctx)
        assert cache["pos"] == i + 2
        _close(got, want)
    _close(cache["k"], ref["final_k"])
    with pytest.raises(ValueError, match="past the cache"):
        cache["pos"] = MAX_LEN
        api.decode_step(params, cache, torch.from_numpy(tok), ctx)


# ---------------------------------------------------------------------------
# cross attention through the decode kernel
# ---------------------------------------------------------------------------


def _pair(a: np.ndarray, dtype: str):
    t, j = torch.from_numpy(a), jnp.asarray(a)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dec_pos", [0, 3, 40])
def test_cross_positions_through_decode_kernel_match_noncausal(dtype,
                                                               dec_pos):
    """One decoder query (at decoder position ``dec_pos``) against 100
    encoder slots: the decode kernel's plain version with ``k_pos =
    0..99`` and ``q_pos = 99`` equals the JAX package's ``causal=False``
    attention at the decoder's position; with the decoder's position as
    ``q_pos`` only ``dec_pos + 1`` slots would be kept."""
    B_, Hq, Hkv, S_, hd = 2, 4, 4, 100, 64
    rng = np.random.default_rng(dec_pos + 11)
    q = rng.standard_normal((B_, 1, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B_, S_, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B_, S_, Hkv, hd), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    enc_pos = np.arange(S_, dtype=np.int32)
    want = jattn.attention(jq, jk, jv, q_pos=jnp.full((1,), dec_pos,
                                                      jnp.int32),
                           k_pos=jnp.asarray(enc_pos), causal=False)
    k_pos = torch.from_numpy(enc_pos).expand(B_, S_).contiguous()
    got = decode_attention_bhd(tq[:, 0], tk.transpose(1, 2),
                               tv.transpose(1, 2), k_pos,
                               torch.full((B_,), S_ - 1, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), _np(want)[:, 0],
                               **KTOL[dtype])
    trap = decode_attention_bhd(tq[:, 0], tk.transpose(1, 2),
                                tv.transpose(1, 2), k_pos,
                                torch.full((B_,), dec_pos,
                                           dtype=torch.int32))
    assert np.abs(trap.float().numpy() - _np(want)[:, 0]).max() > 0.05


# ---------------------------------------------------------------------------
# the server and the CLI
# ---------------------------------------------------------------------------


def test_server_generates_on_the_cpu():
    cfg = get_smoke_config(ARCH)
    server = Server(cfg, device="cpu", max_len=MAX_LEN,
                    telemetry=TelemetryRegistry())
    server.load(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_DEC),
                                    dtype=np.int32),
             "frames": rng.standard_normal(
                 (B, S_ENC, cfg.d_model)).astype(np.float32)}
    tokens = server.generate(batch, 5)
    assert tokens.shape == (B, 5) and tokens.dtype == np.int32
    logits, cache = server.prefill(batch)
    assert cache["cross_k"].shape[2] == S_ENC
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    want = [tok]
    for _ in range(4):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        want.append(tok)
    np.testing.assert_array_equal(tokens, torch.cat(want, 1).numpy())


def test_server_prices_its_first_stream_at_seamlesss_own_step():
    server = Server(get_smoke_config(ARCH), device="cpu", max_len=40,
                    telemetry=TelemetryRegistry())
    step = H100_DECODE_STEP_MS[ARCH]
    assert step > 2.0 and server.decode_step_ms() == step
    assert serve.FAMILY_STAND_IN["encdec"] == ARCH


def test_cli_serves_as_the_reference_does(monkeypatch, capsys):
    """The same recipe serves in both packages (the JAX package's
    enc-dec CLI works; its VLM's does not, see test_torch_vlm.py)."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "16",
            "--gen", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("generated (2, 4)") == 2
