#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo world runs, on CPU and on
card tensors, and what a few large ones cost when four ranks share a card.

    python3 gloo_probe.py

Spawns one world of 4 gloo ranks on the CPU, then (with a card) one world
of 4 ranks whose tensors all lie on card 0, and tries ``all_reduce``,
``all_gather_into_tensor``, ``all_gather``, ``all_to_all_single`` (even
and uneven splits), ``reduce_scatter_tensor`` and ``broadcast`` in f32,
bf16 and int8; on the card it also times an f32 ``all_reduce`` of 50 MB,
a bf16 ``all_to_all_single`` of 70 MB and an int8
``all_gather_into_tensor`` of 16 MB (mean of 3 calls, host clock around a
synchronised call).  Then NCCL at a world of one, and a module's card
tensors passed to a spawned process (CUDA IPC).  Prints one JSON object.

gloo's ``send`` / ``recv`` are left out: on a card tensor they hand the
device pointer to the socket (``writev ... Bad address``) and the world
dies, which is why ``repro_torch.parallel.collectives.ppermute`` is an
``all_to_all_single``.
"""

import datetime
import json
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
#: the timed collectives: name -> elements
TIMED = {"all_reduce_f32_50MB": 12_500_000, "all_to_all_bf16_70MB": 35_000_000,
         "all_gather_into_tensor_int8_16MB": 16_000_000}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ops(rank: int, dev: str, dtype) -> dict:
    def t(n=8):
        return (torch.arange(n, device=dev) + rank).to(dtype)
    split = [2 if r == (rank - 1) % WORLD else 0 for r in range(WORLD)]
    send = [2 if r == (rank + 1) % WORLD else 0 for r in range(WORLD)]
    return {
        "all_reduce": lambda: dist.all_reduce(t()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * WORLD, dtype=dtype, device=dev), t()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(8, dtype=dtype, device=dev) for _ in range(WORLD)],
            t()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, dtype=dtype, device=dev), t()),
        "all_to_all_single_splits": lambda: dist.all_to_all_single(
            torch.empty(2, dtype=dtype, device=dev), t(2),
            output_split_sizes=split, input_split_sizes=send),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // WORLD, dtype=dtype, device=dev), t()),
        "broadcast": lambda: dist.broadcast(t(), 0),
    }


def _timed(dev: str) -> dict:
    out = {}
    for name, n in TIMED.items():
        if name.startswith("all_reduce"):
            x = torch.ones(n, device=dev)
            fn = lambda: dist.all_reduce(x)              # noqa: E731
        elif name.startswith("all_to_all"):
            x = torch.ones(n, device=dev, dtype=torch.bfloat16)
            y = torch.empty_like(x)
            fn = lambda: dist.all_to_all_single(y, x)    # noqa: E731
        else:
            x = torch.ones(n // WORLD, device=dev, dtype=torch.int8)
            y = torch.empty(n // WORLD * WORLD, device=dev, dtype=torch.int8)
            fn = lambda: dist.all_gather_into_tensor(y, x)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        dist.barrier()
    return out


def _rank(rank: int, port: int, dev: str, q) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=30))
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for name, fn in _ops(rank, dev, dtype).items():
            key = f"{name}/{str(dtype).split('.')[1]}"
            try:
                fn()
                if dev == "cuda":
                    torch.cuda.synchronize()
                out[key] = "ok"
            except RuntimeError as e:     # the probe records what raised
                out[key] = f"RuntimeError: {str(e)[:120]}"
            dist.barrier()
    if dev == "cuda":
        out.update(_timed(dev))
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


def _child_sum(module, q) -> None:
    q.put(float(module.weight.sum().item()))


def main() -> None:
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}
    ctx = mp.get_context("spawn")
    for dev in ["cpu"] + (["cuda"] if torch.cuda.is_available() else []):
        q = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, port, dev, q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        res[dev] = q.get(timeout=120)
        for p in procs:
            p.join(60)
    if torch.cuda.is_available():
        try:
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1)
            x = torch.ones(8, device="cuda")
            dist.all_reduce(x)
            dist.all_to_all_single(torch.empty_like(x), x)
            torch.cuda.synchronize()
            dist.destroy_process_group()
            res["nccl1"] = "ok"
        except RuntimeError:
            res["nccl1"] = traceback.format_exc()[-400:]
        lin = torch.nn.Linear(64, 64).cuda()
        q = ctx.Queue()
        p = ctx.Process(target=_child_sum, args=(lin, q))
        p.start()
        res["ipc_module"] = [q.get(timeout=60),
                             float(lin.weight.sum().item())]
        p.join(30)
    print(json.dumps(res, indent=0))


if __name__ == "__main__":
    main()
