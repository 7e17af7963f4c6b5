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

A dense model (smollm-360m, gemma3-1b, phi3-mini-3.8b at head dim 96,
mistral-large-123b) prefills through the flash-attention kernel and
decodes through the decode-attention kernel; the MoE (qwen3-moe-30b-a3b,
and mixtral-8x22b, whose every layer is windowed, against a ring cache of
``min(window, max_len)`` slots) does the same, its expert layers through
the no-drop sorted dispatch (``ffn.moe_dispatch``: one host sync per layer
for the expert counts); an SSM model (mamba2-1.3b) prefills through the
SSD-scan kernel and decodes with the plain recurrent step; the hybrid
(zamba2-1.2b) does both, its shared attention block decoding against a
ring cache (``ShardCtx(impl="cuda")``).  The VLM (llava-next) is the dense
path with its stub patch embeddings (``extra_embeds``) projected and
prepended to the prompt; the encoder-decoder (seamless-m4t) encodes its
stub ``frames`` through the flash kernel without the causal mask, computes
every decoder layer's cross K/V once, and decodes through the decode kernel
against its self cache and, as cross attention, over every encoder slot.
Its prefill decodes only the first decoder token, as the reference's does.
An SSM or hybrid prompt must be a whole number of SSD chunks long, as the
reference asks: another length raises, it is not padded.  All CUDA work is
issued on the device's current stream; the decode steps run on the mover's
producer thread, and each step's ``.cpu()`` copy of the new tokens is its
device sync (the MoE's adds one per layer) — the host copy that is the
stream's item.

Usage:
  python -m repro_torch.launch.serve --arch smollm-360m          # on the card
  python -m repro_torch.launch.serve --arch mamba2-1.3b          # on the card
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --prompt-len 512                                            # on the card
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b \\
      --prompt-len 512                                            # on the card
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --prompt-len 1024                                           # on the card
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --prompt-len 1024                                           # on the card
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch smollm-360m --mesh 1x4 --backend gloo \\
      --prompt-len 512 --gen 8          # TP 4, ranks sharing one card
  python -m repro_torch.launch.serve --arch smollm-360m --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke \\
      --device cpu --prompt-len 32 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch gemma3-1b --smoke \\
      --device cpu --prompt-len 48 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke \\
      --device cpu --prompt-len 48 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch mistral-large-123b --smoke \\
      --device cpu --prompt-len 16 --gen 4                        # CPU smoke
  python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke \\
      --device cpu --prompt-len 40 --gen 4                        # CPU smoke

mistral-large-123b (246 GB in bf16) and mixtral-8x22b (282 GB) do not fit
one 80 GB card at full depth, as they fit no one TPU chip in the
reference: their full depth needs a mesh of several cards (below;
``chip_smoke.py`` serves each at published widths with the depth cut).

On a mesh (``Server(cfg, mesh)``, a :class:`~repro_torch.launch.mesh.Mesh`
over a ``torch.distributed`` world, one process per rank), each rank holds
its shards of the weights (``weights.init_sharded`` / ``shard_params``) and
serves its rows of the batch, split over the data axes (the batch must
divide over them); the dense and MoE families run there (tensor-parallel
attention and MLP, expert- or tensor-parallel experts).  Every model rank
ends a step with the same logits and tokens; the step's tokens of the
whole batch are gathered over the data axes, and global rank 0 alone
streams them through the mover.  ``plan=`` takes a ``CodesignPlan``, the
reference's ``CodesignPlan(sharding="tp", seq_parallel=False)`` by
default; with ``seq_parallel=True`` a prefill holds each model rank's
chunk of the prompt between the layers (Megatron sequence parallelism,
``models/blocks.py``), and decode is the same.  On N cards, one rank per
card over NCCL:

  torchrun --nproc-per-node N prog.py     # prog.py: init_world("nccl",
      # rank=RANK, world_size=WORLD_SIZE, init_method="env://"...),
      # torch.cuda.set_device(LOCAL_RANK), mesh = make_host_mesh(),
      # Server(cfg, mesh, device="cuda").load(), .generate(batch, n)

The CLI takes no mesh, as the reference's takes none.

The CLI draws the stub inputs as the reference's does: ``frames`` of
``--prompt-len`` frames for the encoder-decoder, ``frontend_len`` patch
embeddings for the VLM.  A VLM's cache holds ``frontend_len + prompt + gen
+ 1`` slots (the reference sizes it without the patch positions and
raises in prefill).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.codesign import CodesignPlan
from repro_torch.core.basin import decode_fanout_basin, decode_stream_basin
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.planner import plan_transfer
from repro_torch.core.telemetry import TelemetryRegistry, get_registry
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.api import build

#: floor for the fed-back client drain-rate estimate — one stalled client
#: must not collapse the next request's plan to a zero-rate basin
MIN_CLIENT_GBPS = 1e-3

#: how many recent serve transfers the drain-rate estimate averages over
DRAIN_RATE_WINDOW = 4

#: a stream counts as client-limited evidence only when its staging hop
#: spent at least this fraction of the transfer backpressured by the sink
CLIENT_LIMITED_STALL = 0.1

#: an eager decode step on the card, by config, used until a server has
#: timed steps of its own; each measured by chip_smoke.py on an NVIDIA H100
#: 80GB HBM3 at its 700.00 W power limit (PERF.md section 5): smollm-360m
#: and mamba2-1.3b at batch 4, gemma3-1b at batch 4 (1057-slot cache),
#: zamba2-1.2b at batch 2 (4096-slot rings) and qwen3-moe-30b-a3b at batch
#: 4 (545-slot cache), llava-next-mistral-7b at batch 4 (1121-slot cache)
#: and seamless-m4t-large-v2 at batch 4 (1024 encoder slots), phi3-mini-3.8b
#: at batch 4 (all 32 layers, 1057-slot cache), mistral-large-123b at batch
#: 4 with 20 of its 88 layers (1057-slot cache) and mixtral-8x22b at batch 2
#: with 10 of its 56 layers (a 4096-slot ring), the serving cells' batches
#: and depths (a deeper model's step is longer)
H100_DECODE_STEP_MS = {"smollm-360m": 36.27, "mamba2-1.3b": 81.19,
                       "gemma3-1b": 27.27, "zamba2-1.2b": 61.09,
                       "qwen3-moe-30b-a3b": 253.49,
                       "llava-next-mistral-7b": 37.72,
                       "seamless-m4t-large-v2": 42.39,
                       "phi3-mini-3.8b": 43.89,
                       "mistral-large-123b": 23.02,
                       "mixtral-8x22b": 26.88}

#: the served config whose step prices a config without an entry, by family
FAMILY_STAND_IN = {"dense": "smollm-360m", "moe": "qwen3-moe-30b-a3b",
                   "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
                   "vlm": "llava-next-mistral-7b",
                   "encdec": "seamless-m4t-large-v2"}

#: how many recent decode steps the step-time estimate averages over
STEP_MS_WINDOW = 32


def h100_step_ms(cfg) -> float:
    """:data:`H100_DECODE_STEP_MS` for ``cfg``: its own entry (a smoke
    variant takes its full-width config's), else that of its family's
    served config."""
    name = cfg.name.removesuffix("-smoke")
    if name not in H100_DECODE_STEP_MS:
        name = FAMILY_STAND_IN[cfg.family]
    return H100_DECODE_STEP_MS[name]


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
    """Holds params on one device, or this rank's shards of them on a mesh;
    streams tokens out through a burst buffer."""

    def __init__(self, cfg, mesh=None, *,
                 device: Optional[torch.device | str] = None,
                 max_len: int = 512,
                 plan: Optional[CodesignPlan] = None,
                 telemetry: Optional[TelemetryRegistry] = None,
                 replan_every_tokens: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = build(cfg)
        self.mesh = mesh
        self.max_len = max_len
        self.plan = plan or CodesignPlan(sharding="tp", seq_parallel=False)
        self.ctx = steps_lib.make_ctx(self.api, mesh, self.plan, impl="cuda")
        self.telemetry = telemetry if telemetry is not None else get_registry()
        self.replan_every_tokens = replan_every_tokens
        self.params = None
        self.last_report = None
        #: host wall ms of recent decode steps, each to its tokens on the host
        self.step_ms: collections.deque[float] = collections.deque(
            maxlen=STEP_MS_WINDOW)

    def load(self, seed: int = 0) -> None:
        """Random weights drawn on the device from ``seed``; on a mesh this
        rank's shards of them (``weights.init_sharded``)."""
        if self.mesh is None:
            self.params = self.api.init(seed, device=self.device)
        else:
            from repro_torch.weights import init_sharded
            self.params = init_sharded(self.cfg, seed, self.mesh,
                                       device=self.device)

    def decode_step_ms(self) -> float:
        """The decode step's time as this server has seen it: the mean of
        its recent steps, or :func:`h100_step_ms` before the first."""
        if self.step_ms:
            return sum(self.step_ms) / len(self.step_ms)
        return h100_step_ms(self.cfg)

    def stream_basin(self):
        """The decode-stream basin: its producer tier from the decode steps
        this server has timed, its client tier re-estimated from the drain
        rate previous requests actually observed."""
        kw = {"decode_step_ms": self.decode_step_ms()}
        drain = observed_client_gbps(self.telemetry)
        if drain is not None:
            kw["client_gbps"] = drain
        return decode_stream_basin(**kw)

    def fanout_basin(self, n_clients: int):
        """The decode fan-out basin for ``n_clients`` concurrent streams,
        timed and re-estimated as :meth:`stream_basin`."""
        kw = {"decode_step_ms": self.decode_step_ms()}
        drain = observed_client_gbps(self.telemetry)
        if drain is not None:
            kw["client_gbps"] = drain
        return decode_fanout_basin(n_clients, **kw)

    def _on_device(self, a, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
        """A batch entry on the device; on a mesh this rank's rows of it."""
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        if self.mesh is not None:
            axes = self.ctx.batch_axes
            dp = self.mesh.axis_size(axes)
            if t.shape[0] % dp:
                raise ValueError(f"a batch of {t.shape[0]} does not split "
                                 f"over the data axes ({dp})")
            n = t.shape[0] // dp
            i = self.mesh.axis_index(axes)
            t = t[i * n:(i + 1) * n]
        return t.to(self.device, dtype)

    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(last-token logits (B, 1, V), decode cache) for a prompt batch
        of numpy or torch tokens (B, S) and, for a VLM, its stub patch
        embeddings ``extra_embeds`` (B, frontend_len, D), for the
        encoder-decoder its stub ``frames`` (B, S_enc, D).  On a mesh B is
        this rank's rows."""
        if self.params is None:
            raise RuntimeError("Server.load() first")
        inputs = {"tokens": self._on_device(batch["tokens"], torch.int32)}
        for key in ("extra_embeds", "frames"):
            if batch.get(key) is not None:
                inputs[key] = self._on_device(batch[key])
        return self.api.prefill(self.params, inputs, self.ctx,
                                max_len=self.max_len)

    def decode(self, cache: dict, tok: torch.Tensor
               ) -> tuple[torch.Tensor, dict]:
        """One decode step: (logits (B, 1, V), cache advanced in place)."""
        return self.api.decode_step(self.params, cache, tok, self.ctx)

    def _whole_batch(self, tok: torch.Tensor) -> np.ndarray:
        """A step's tokens of the whole batch on the host: on a mesh the
        ranks' rows gathered over the data axes."""
        if self.mesh is not None:
            from repro_torch.parallel.collectives import all_gather
            tok = all_gather(tok, self.mesh, self.ctx.batch_axes)
        return tok.cpu().numpy()

    def generate(self, batch: dict, n_tokens: int, sink=None) -> np.ndarray:
        """Greedy-decode ``n_tokens``; each step's tokens stream to ``sink``
        through the unified mover (streaming transfer).  Staging depth
        comes from the decode-stream basin plan; the plan is ``ordered``
        because the token stream must arrive in decode order.

        ``sink`` may be a *list* of callables — concurrent client streams:
        the token stream then replicates down one planned branch per
        client (decode fan-out, mover parallel mirror mode).  Returns the
        (B, n_tokens) int32 tokens in decode order.  On a mesh every rank
        returns them; global rank 0 alone streams them through the mover
        to ``sink``."""
        logits, cache = self.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        out = [self._whole_batch(tok)]
        n_batch = int(out[0].shape[0])

        def produce() -> Iterator[np.ndarray]:
            nonlocal tok, cache
            on_card = (torch.cuda.device(self.device)
                       if self.device.type == "cuda"
                       else contextlib.nullcontext())
            with on_card:
                for _ in range(n_tokens - 1):
                    t0 = time.perf_counter()
                    logits_i, cache = self.decode(cache, tok)
                    tok = torch.argmax(logits_i[:, -1], dim=-1,
                                       keepdim=True).to(torch.int32)
                    step = self._whole_batch(tok)   # waits for the device
                    self.step_ms.append((time.perf_counter() - t0) * 1e3)
                    yield step

        if self.mesh is not None and self.mesh.rank != 0:
            out.extend(produce())
            return np.concatenate(out, axis=1)
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
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 128, rounded up to a whole number of "
                         "SSD chunks for an SSM or hybrid model")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D x M ranks "
                         "(TP; the world torchrun starts, or the one "
                         "already initialised in the process; default: "
                         "one card); rank 0 prints")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="the world's backend when --mesh starts it: nccl "
                         "for one rank per card, gloo on the CPU or for "
                         "ranks that share a card")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh, started, device = None, False, args.device
    if args.mesh:
        from repro_torch.launch.mesh import join_world
        mesh, started = join_world(args.mesh, args.backend)
        if device is None and args.backend == "nccl":
            device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
            torch.cuda.set_device(torch.device(device))
    try:
        _serve(args, cfg, mesh, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, cfg, mesh, device) -> None:
    """The CLI's request: ``args.batch`` random prompts through
    ``Server.generate`` on one card or, on ``mesh``, on each rank."""
    prompt_len = args.prompt_len
    if prompt_len is None:
        chunk = cfg.ssm.chunk if cfg.family in ("ssm", "hybrid") else 1
        prompt_len = -(-128 // chunk) * chunk
    # a VLM's prefill holds its patch positions before the prompt
    patches = cfg.frontend_len if cfg.family == "vlm" else 0
    server = Server(cfg, mesh, device=device,
                    max_len=patches + prompt_len + args.gen + 1)
    server.load(args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, prompt_len),
                                    dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (args.batch, prompt_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend:
        batch["extra_embeds"] = rng.standard_normal(
            (args.batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)

    t0 = time.monotonic()
    tokens = server.generate(batch, args.gen)
    dt = time.monotonic() - t0
    tps = args.batch * args.gen / dt
    if mesh is not None and mesh.rank != 0:
        return
    where = (f"{server.device}, mesh {args.mesh}" if mesh is not None
             else server.device)
    print(f"[serve] {where}: generated {tokens.shape} in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    rep = server.last_report
    print(f"[serve] stream fidelity: throughput="
          f"{rep.throughput_bytes_per_s:.0f} B/s bottleneck="
          f"{rep.bottleneck_stage().name if rep.stage_reports else 'n/a'}")


if __name__ == "__main__":
    main()
