"""Serving: batched prefill + streaming decode through the mover.

The serving path is the paper's two workload classes composed:

* **bulk** — prefill: the prompt batch moves through the stack once and
  the KV cache is staged (the "data at rest" transfer),
* **streaming** — decode: tokens are produced step by step and move to
  the client sink *while being generated*, staged through a burst buffer
  so a slow client never stalls the card (the low-jitter decoupling of
  §2.1),
* **fan-out** — pass ``generate`` a list of client sinks and the token
  stream replicates down one planned branch per client
  (:func:`~repro_torch.core.basin.decode_fanout_basin` + the mover's
  parallel mirror mode), each client drained by its own drainer.

Prefill runs through the flash-attention kernel and every decode step
through the decode-attention kernel (``ShardCtx(impl="cuda")``).  All CUDA
work is issued on the device's current stream; the decode steps run on the
mover's producer thread, and each step's ``.cpu()`` copy of the new tokens
is the one device sync per token — the host copy that is the stream's item.

Usage:
  python -m repro_torch.launch.serve --arch smollm-360m          # on the card
  python -m repro_torch.launch.serve --arch smollm-360m --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.basin import decode_fanout_basin, decode_stream_basin
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.planner import plan_transfer
from repro_torch.core.telemetry import TelemetryRegistry, get_registry
from repro_torch.device import resolve_device
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx

#: floor for the fed-back client drain-rate estimate — one stalled client
#: must not collapse the next request's plan to a zero-rate basin
MIN_CLIENT_GBPS = 1e-3

#: how many recent serve transfers the drain-rate estimate averages over
DRAIN_RATE_WINDOW = 4

#: a stream counts as client-limited evidence only when its staging hop
#: spent at least this fraction of the transfer backpressured by the sink
CLIENT_LIMITED_STALL = 0.1


def observed_client_gbps(registry: TelemetryRegistry) -> Optional[float]:
    """Client drain rate (Gbps) observed by recent decode streams.

    Only streams the client actually *limited* count as evidence: a
    stream's end-to-end rate is ``min(decode rate, client drain rate)``,
    so a transfer paced by decode compute says nothing about the client.
    Fan-out (mirror) transfers count bytes once per client delivery, so
    their aggregate rate is divided by the branch count.  Returns ``None``
    when no client-limited stream has been recorded (the modeled default
    applies)."""
    rates = []
    for r in registry.reports("serve"):
        if r.elapsed_s <= 0 or r.bytes <= 0:
            continue
        if not any(s.stall_down_s >= CLIENT_LIMITED_STALL * r.elapsed_s
                   for s in r.stage_reports):
            continue                     # producer-paced: no client evidence
        n_clients = len({s.name.split("/")[0] for s in r.stage_reports
                         if "/" in s.name}) or 1
        rates.append(r.throughput_bytes_per_s / n_clients)
    if not rates:
        return None
    window = rates[-DRAIN_RATE_WINDOW:]
    return max(MIN_CLIENT_GBPS, (sum(window) / len(window)) * 8.0 / 1e9)


class Server:
    """Holds params on one device; streams tokens out through a burst
    buffer."""

    def __init__(self, cfg, *, device: Optional[torch.device | str] = None,
                 max_len: int = 512,
                 telemetry: Optional[TelemetryRegistry] = None,
                 replan_every_tokens: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = build(cfg)
        self.max_len = max_len
        self.ctx = ShardCtx(impl="cuda")
        self.telemetry = telemetry if telemetry is not None else get_registry()
        self.replan_every_tokens = replan_every_tokens
        self.params = None
        self.last_report = None

    def load(self, seed: int = 0) -> None:
        """Random weights drawn on the device from ``seed``."""
        self.params = self.api.init(seed, device=self.device)

    def stream_basin(self):
        """The decode-stream basin, its client tier re-estimated from the
        drain rate previous requests actually observed."""
        drain = observed_client_gbps(self.telemetry)
        if drain is None:
            return decode_stream_basin()
        return decode_stream_basin(client_gbps=drain)

    def fanout_basin(self, n_clients: int):
        """The decode fan-out basin for ``n_clients`` concurrent streams,
        its per-client tier re-estimated from observed drain rates."""
        drain = observed_client_gbps(self.telemetry)
        if drain is None:
            return decode_fanout_basin(n_clients)
        return decode_fanout_basin(n_clients, client_gbps=drain)

    def _tokens(self, batch: dict) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch["tokens"]),
                               dtype=torch.int32).to(self.device)

    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(last-token logits (B, 1, V), decode cache) for a prompt batch
        of numpy or torch tokens (B, S)."""
        if self.params is None:
            raise RuntimeError("Server.load() first")
        return self.api.prefill(self.params, {"tokens": self._tokens(batch)},
                                self.ctx, max_len=self.max_len)

    def decode(self, cache: dict, tok: torch.Tensor
               ) -> tuple[torch.Tensor, dict]:
        """One decode step: (logits (B, 1, V), cache advanced in place)."""
        return self.api.decode_step(self.params, cache, tok, self.ctx)

    def generate(self, batch: dict, n_tokens: int, sink=None) -> np.ndarray:
        """Greedy-decode ``n_tokens``; each step's tokens stream to ``sink``
        through the unified mover (streaming transfer).  Staging depth
        comes from the decode-stream basin plan; the plan is ``ordered``
        because the token stream must arrive in decode order.

        ``sink`` may be a *list* of callables — concurrent client streams:
        the token stream then replicates down one planned branch per
        client (decode fan-out, mover parallel mirror mode).  Returns the
        (B, n_tokens) int32 tokens in decode order."""
        logits, cache = self.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        out = [tok.cpu().numpy()]
        n_batch = int(tok.shape[0])

        def produce() -> Iterator[np.ndarray]:
            nonlocal tok, cache
            on_card = (torch.cuda.device(self.device)
                       if self.device.type == "cuda"
                       else contextlib.nullcontext())
            with on_card:
                for _ in range(n_tokens - 1):
                    logits_i, cache = self.decode(cache, tok)
                    tok = torch.argmax(logits_i[:, -1], dim=-1,
                                       keepdim=True).to(torch.int32)
                    yield tok.cpu().numpy()

        sinks = list(sink) if isinstance(sink, (list, tuple)) else None
        collected: list[np.ndarray] = []
        if sinks and len(sinks) > 1:
            plan = plan_transfer(self.fanout_basin(len(sinks)),
                                 item_bytes=max(1, n_batch * 4),
                                 stages=("token-stream",), ordered=True,
                                 path="auto")
            mover = UnifiedDataMover(MoverConfig(checksum=False), plan=plan,
                                     telemetry=self.telemetry, layer="serve")
            # branch order follows basin link order == client order
            sink_map = {b.branch_id: s for b, s in zip(plan.branches, sinks)}
            first = plan.branches[0].branch_id
            first_sink = sink_map[first]

            def tee(item):
                collected.append(item)
                first_sink(item)

            sink_map[first] = tee
            report = mover.parallel_transfer(
                produce(), sink_map, plan=plan, mode="mirror",
                replan_every_items=self.replan_every_tokens,
                drainer_pool=True)
        else:
            one_sink = sinks[0] if sinks else sink
            plan = plan_transfer(self.stream_basin(),
                                 item_bytes=max(1, n_batch * 4),
                                 stages=("token-stream",), ordered=True,
                                 path="auto")
            mover = UnifiedDataMover(MoverConfig(checksum=False), plan=plan,
                                     telemetry=self.telemetry, layer="serve")

            def deliver(item):
                collected.append(item)
                if one_sink is not None:
                    one_sink(item)

            report = mover.streaming_transfer(
                produce(), deliver, plan=plan,
                replan_every_items=self.replan_every_tokens)
        out.extend(collected)
        self.last_report = report
        return np.concatenate(out, axis=1)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    server = Server(cfg, device=args.device,
                    max_len=args.prompt_len + args.gen + 1)
    server.load(args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt_len),
                                    dtype=np.int32)}

    t0 = time.monotonic()
    tokens = server.generate(batch, args.gen)
    dt = time.monotonic() - t0
    tps = args.batch * args.gen / dt
    print(f"[serve] {server.device}: generated {tokens.shape} in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    rep = server.last_report
    print(f"[serve] stream fidelity: throughput="
          f"{rep.throughput_bytes_per_s:.0f} B/s bottleneck="
          f"{rep.bottleneck_stage().name if rep.stage_reports else 'n/a'}")


if __name__ == "__main__":
    main()
