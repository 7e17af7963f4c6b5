"""Time the int8 wire kernels' designs against each other on one card.

Two modes, each printing one JSON line a measurement (and appending them
to ``--out`` where given):

``python tools/quantize_designs.py``
    Builds ``src/repro_torch/kernels/csrc/quantize.cu`` (what the port
    ships: quantize a register-pipelined persistent stream, dequantize a
    persistent ring of shared-memory stages filled by TMA bulk copies) and
    ``tools/quantize_designs.cu`` (``QDESIGN=1``: the other design of each
    direction; ``QDESIGN=2``: one warp a block, a CTA a tile), each at a
    few settings (``VARIANTS``: ``stream dN`` keeps N blocks' loads in
    flight a warp; ``ring S stages x C CTAs`` a SM), one ``nvcc`` a build,
    all at once.
    Then, for each shape in turn (single items of the paths and the
    staging's slabs), every build runs ``quantize_items`` /
    ``dequantize_items`` through the port's wrappers, is held bit for bit
    to the plain versions, and is timed: device ms a call from a CUDA graph
    of repeated calls, beside the bound (each input read once and each
    output written once at 3.35 TB/s).  Every build sees the same inputs
    within one process, so the designs compare on the same card and clock.

``python tools/quantize_designs.py --tree DIR --label NAME``
    Imports ``repro_torch`` from ``DIR/src`` (for example an unpacked
    parent commit) and times its single-item ``quantize_int8`` /
    ``dequantize_int8`` at the same shapes: eager ms a call as a caller
    sees it (host work included) and device ms.  Run it on two trees on
    the same card, interleaved (A, B, B, A), to compare them.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PEAK_BYTES = 3.35e12

#: (label, items, values an item): the paths' single items, then the
#: stagings' state items as one slab each
SINGLES = [("1,000,003 values", 1, 1_000_003),
           ("zamba2 state item", 1, 524_288),
           ("mamba2 state item", 1, 2_097_152),
           ("compressed_psum rank", 1, 16 * 2 ** 20)]
SLABS = [("zamba2 state slab", 38, 524_288),
         ("mamba2 state slab", 48, 2_097_152)]

#: build -> (source, extra nvcc flags, the design each direction runs)
VARIANTS = {
    "shipped": ("csrc", [], {"quantize": "stream d1",
                             "dequantize": "ring 8 stages x 4 CTAs"}),
    "shipped d2/16x2": ("csrc", ["-DQUANT_DEPTH=2", "-DDEQUANT_STAGES=16",
                                 "-DDEQUANT_CTAS=2"],
                        {"quantize": "stream d2",
                         "dequantize": "ring 16 stages x 2 CTAs"}),
    "others": ("designs", ["-DQDESIGN=1"],
               {"quantize": "ring 5 stages x 4 CTAs",
                "dequantize": "stream d2"}),
    "others d4": ("designs", ["-DQDESIGN=1", "-DDEQUANT_DEPTH=4",
                              "-DQUANT_STAGES=3", "-DQUANT_CTAS=6"],
                  {"quantize": "ring 3 stages x 6 CTAs",
                   "dequantize": "stream d4"}),
    "per-warp": ("designs", ["-DQDESIGN=2"],
                 {"quantize": "per-warp", "dequantize": "per-warp"}),
}


def emit(out, **rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def device_ms(torch, fn, iters: int) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph on a
    side stream (after two warm-up calls there), replayed between two
    events, the median of five replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    del graph
    return statistics.median(times)


def call_ms(torch, fn, iters: int = 50) -> float:
    """Eager ms a call: ``iters`` back-to-back calls between two events
    (the host's work included where it exceeds the device's), the median
    of five rounds."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def values(torch, n: int, seed: int):
    """Values over six decades of magnitude, both signs, some zero blocks."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mag = torch.rand(n, generator=g, device="cuda") * 6 - 3
    x = torch.randn(n, generator=g, device="cuda") * 10.0 ** mag
    x[256:512] = 0.0
    return x


def wire_bytes(count: int, n: int) -> int:
    nb = -(-n // 2048) * 8
    return count * (4 * n + 256 * nb + 4 * nb)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def build_variants(build, names) -> dict[str, str]:
    """One nvcc a variant, all at once; returns label -> library path and
    prints each build's register and spill report."""
    out_dir = build.BUILD_DIR / "designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for label in names:
        where, defs, _ = VARIANTS[label]
        src = (build.CSRC / "quantize.cu" if where == "csrc"
               else os.path.join(HERE, "quantize_designs.cu"))
        lib = str(out_dir / f"{label.replace(' ', '_').replace('/', '-')}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               *defs, "-o", lib, str(src)]
        procs.append((label, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for label, lib, proc in procs:
        log, _ = proc.communicate()
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "error" in ln]
        print(json.dumps({"build": label, "rc": proc.returncode,
                          "ptxas": report}), flush=True)
        if proc.returncode == 0:
            libs[label] = lib
    return libs


def use(build, path: str) -> None:
    """Point the port's quantize wrappers at the library at ``path``."""
    lib = ctypes.CDLL(path)
    build._declare("quantize_int8", lib)
    build._declare("dequantize_int8", lib)
    build._libs["quantize_int8"] = lib
    build._libs["dequantize_int8"] = lib


def designs(torch, out: str, names) -> int:
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.quantize import dequantize_items, quantize_items
    libs = build_variants(build, names)
    bad = len(libs) != len(names)
    for label, count, n in SINGLES + SLABS:
        xs = [values(torch, n, 7 + i) for i in range(count)]
        want = ref.quantize_items_ref(xs)
        bound = wire_bytes(count, n) / PEAK_BYTES * 1e3
        for name, path in libs.items():
            use(build, path)
            wire = quantize_items(xs)
            slab = [(q, s, (n,)) for q, s in wire]
            backs = dequantize_items(slab)
            ok = all(torch.equal(q, rq) and torch.equal(s, rs)
                     for (q, s), (rq, rs) in zip(wire, want))
            ok = ok and all(
                torch.equal(b, ref.dequantize_int8_ref(q, s, (n,)))
                for b, (q, s, _) in zip(backs, slab))
            del backs
            bad += not ok
            iters = 10 if count > 1 else 20
            for kernel, fn in (("quantize", lambda: quantize_items(xs)),
                               ("dequantize",
                                lambda: dequantize_items(slab))):
                ms = device_ms(torch, fn, iters)
                emit(out, shape=label, items=count, values=n, kernel=kernel,
                     design=VARIANTS[name][2][kernel], build=name, ok=ok,
                     ms=ms, bound_ms=bound, share_of_bound=bound / ms)
            del wire, slab
        del xs, want
        torch.cuda.empty_cache()
    return 1 if bad else 0


def singles(torch, out: str, label: str) -> int:
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
    bad = 0
    for shape, _, n in SINGLES:
        x = values(torch, n, 11)
        q, s = quantize_int8(x)
        rq, rs = ref.quantize_int8_ref(x)
        ok = torch.equal(q, rq) and torch.equal(s, rs) and torch.equal(
            dequantize_int8(q, s, (n,)), ref.dequantize_int8_ref(q, s, (n,)))
        bad += not ok
        bound = wire_bytes(1, n) / PEAK_BYTES * 1e3
        for kernel, fn in (("quantize", lambda: quantize_int8(x)),
                           ("dequantize",
                            lambda: dequantize_int8(q, s, (n,)))):
            emit(out, tree=label, shape=shape, values=n, kernel=kernel,
                 ok=ok, call_ms=call_ms(torch, fn),
                 ms=device_ms(torch, fn, 20), bound_ms=bound)
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="time the single-item wrappers of the "
                    "repro_torch under TREE/src instead of the designs")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--designs", nargs="*", default=list(VARIANTS),
                    help="variants to build and time (default: all)")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree) if args.tree else ROOT
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    if not torch.cuda.is_available():
        print("quantize_designs: no CUDA card", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    emit(args.out, card=card(), torch=torch.__version__,
         cuda=torch.version.cuda, tree=args.label if args.tree else "designs",
         at=time.strftime("%Y-%m-%dT%H:%M:%S"))
    if args.tree:
        return singles(torch, args.out, args.label)
    return designs(torch, args.out, args.designs)


if __name__ == "__main__":
    sys.exit(main())
