"""The port's server on the CPU: greedy tokens stream through the mover in
decode order, to one client or fanned out to several."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models.blocks import ShardCtx

torch.set_num_threads(1)

B, PROMPT, GEN = 2, 12, 6


def _server(arch: str = "smollm-360m") -> Server:
    s = Server(get_smoke_config(arch), device="cpu", max_len=PROMPT + GEN + 1,
               telemetry=TelemetryRegistry())
    s.load(0)
    return s


def _batch(cfg) -> dict:
    return {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (B, PROMPT), dtype=np.int32)}


def _greedy(server: Server, batch: dict, n: int) -> np.ndarray:
    """The same decode, step by step, outside the mover."""
    logits, cache = server.prefill(batch)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
    out = [tok]
    for _ in range(n - 1):
        logits, cache = server.decode(cache, tok)
        tok = torch.argmax(logits[:, -1], -1, keepdim=True).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1).numpy()


@pytest.mark.parametrize("arch", ["smollm-360m", "repro-100m"])
def test_generate_returns_tokens_in_decode_order(arch):
    server = _server(arch)
    batch = _batch(server.cfg)
    tokens = server.generate(batch, GEN)
    assert tokens.shape == (B, GEN) and tokens.dtype == np.int32
    assert tokens.min() >= 0 and tokens.max() < server.cfg.vocab
    np.testing.assert_array_equal(tokens, _greedy(server, batch, GEN))
    rep = server.last_report
    assert rep.items == GEN - 1
    assert rep.bytes == (GEN - 1) * B * 4


def test_generate_streams_to_a_sink_in_order():
    server = _server()
    batch = _batch(server.cfg)
    got = []
    tokens = server.generate(batch, GEN, sink=got.append)
    assert len(got) == GEN - 1
    np.testing.assert_array_equal(np.concatenate(got, axis=1), tokens[:, 1:])


def test_generate_fans_out_to_every_client():
    server = _server()
    batch = _batch(server.cfg)
    clients = [[], [], []]
    tokens = server.generate(batch, GEN, sink=[c.append for c in clients])
    for c in clients:
        np.testing.assert_array_equal(np.concatenate(c, axis=1), tokens[:, 1:])
    np.testing.assert_array_equal(tokens, _greedy(server, batch, GEN))


def test_server_prefill_takes_the_kernel_route():
    """The server's context routes attention through the kernels (their
    plain versions on CPU tensors); its logits agree with the plain path."""
    server = _server()
    assert server.ctx == ShardCtx(impl="cuda")
    batch = _batch(server.cfg)
    a, _ = server.prefill(batch)
    b, _ = server.api.prefill(server.params,
                              {"tokens": torch.from_numpy(batch["tokens"])},
                              ShardCtx(impl="ref"), server.max_len)
    torch.testing.assert_close(a.float(), b.float(), atol=0.1, rtol=0.03)


def test_main_runs_the_cpu_smoke(capsys):
    serve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out


def test_prefill_before_load_raises():
    s = Server(get_smoke_config("smollm-360m"), device="cpu")
    with pytest.raises(RuntimeError, match="load"):
        s.prefill({"tokens": np.zeros((1, 4), np.int32)})
