#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, one JSON line each:

1. ``card``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: the hand-written kernels built from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a, all at once, with seconds and the
   compiler's register / shared-memory report.
3. ``check``: each kernel's wrapper on tensors on the card against its plain
   PyTorch version on the same inputs (stated tolerance; the digest
   bit-exact), at smollm-360m's attention shapes and at the shapes the
   serving path gives it.  Times are device times per call (a CUDA graph of
   repeated calls, replayed between CUDA events) of the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (``scaled_dot_product_attention``, a yardstick the port never
   calls); ``call_ms`` is the kernel's time per eager call, host included.
4. ``serve``: the main path — ``Server(get_config("smollm-360m"),
   device="cuda")`` (full width, 32 layers, random weights from a seed)
   serves 4 x 128-token prompts for 32 tokens through the mover, and the
   prefill's KV cache is staged to host memory by a ``bulk_transfer``
   planned with ``checksum_placement="accel"``.  The launch counts are set
   to 0 just before and read just after; every kernel must have run.
   Prefill ms, decode ms/token (eager, and as device time from a CUDA
   graph), tok/s, peak memory, and a profiler trace of one prefill and
   one decode step (device busy time, idle share, top kernels).
5. ``correct``: the kernel path's full-width prefill logits and 4
   teacher-forced decode steps against the plain path (``impl="ref"``) on
   the same weights; the served tokens against the kernel path's own
   greedy choices at those 5 steps, exactly; the transfer's hexdigest against the plain digest of
   the bytes that arrived on the host, and those bytes against the cache.

Then the kernels line, the card line as ``nvidia-smi`` prints it, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result lines; without a card, or without the repository's ``src/`` beside
this file, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, and
# device memory bandwidth; a card below its 700 W limit runs slower.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
BATCH, PROMPT, GEN = 4, 128, 32

# kernel against plain version on the card, both rounding an f32 result to
# the output dtype once: f32 sums in another order, bf16 about one ulp of
# the output (2^-8..2^-7 relative) plus a floor for values near zero
TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=1e-3, rtol=8e-3)}


def emit(phase: str, **kw) -> dict:
    rec = {"phase": phase, **kw}
    print(json.dumps(rec), flush=True)
    return rec


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph and replayed between two CUDA events, so the host's
    launch cost is left out (inputs stay warm in L2 across the calls)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` as an eager caller sees it, in ms:
    ``iters`` back-to-back calls between two CUDA events (the host's
    launch cost included when it exceeds the device time)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_busy(fn) -> dict:
    """Profile one call of ``fn`` (ending in a device sync): host wall ms,
    the union of the card's kernel and copy intervals, the idle share
    between them, and the kernels that took the most device time.  The
    profiler slows the host, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_kernels": len(spans),
            "idle_share": (1.0 - busy / wall_us) if spans else None,
            "top_device_ms": {n[:60]: t / 1e3 for n, t in top}}


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_flash(torch, B, Hq, Hkv, S, hd, dtype, window, *, library=True):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(S + hd)
    q = torch.randn(B, Hq, S, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    out = flash_attention_bhsd(q, k, v, causal=True, window=window)
    expect = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = (out.float() - expect.float()).abs().max().item()
    tol = TOL[str(dtype).replace("torch.", "")]
    ok = bool(torch.allclose(out.float(), expect.float(), **tol))
    kernel = lambda: flash_attention_bhsd(q, k, v, causal=True, window=window)
    ms, per_call = device_ms(kernel), call_ms(kernel)
    plain_ms = device_ms(lambda: ref.attention_ref(q, k, v, causal=True,
                                                   window=window), iters=5)
    lib_ms = None
    if library:
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        lib_ms = device_ms(lib)
    esize = q.element_size()
    nbytes = (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd) * esize
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    ops = 4.0 * hd * B * Hq * pairs
    bms, by = bound_ms(nbytes, ops, PEAK_BF16 if dtype == torch.bfloat16
                       else PEAK_F32)
    return emit("check", kernel="flash_attention",
                shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, hd=hd), window=window,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ok=ok, ms=ms, call_ms=per_call, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by)


def check_decode(torch, B, Hq, Hkv, S, hd, dtype, fill, window, ring):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_bhd
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(S + fill)
    q = torch.randn(B, Hq, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda").to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
    k_pos = torch.where(pos <= fill, pos, -1).contiguous()
    if ring:   # slots in a permuted order: only k_pos may be trusted
        perm = torch.randperm(S, generator=g, device="cuda")
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device="cuda")
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    expect = ref.decode_attention_ref(q, k, v, k_pos, q_pos, window=window)
    torch.cuda.synchronize()
    err = (out.float() - expect.float()).abs().max().item()
    tol = TOL[str(dtype).replace("torch.", "")]
    ok = bool(torch.allclose(out.float(), expect.float(), **tol))
    kernel = lambda: decode_attention_bhd(q, k, v, k_pos, q_pos,
                                          window=window)
    ms, per_call = device_ms(kernel), call_ms(kernel)
    plain_ms = device_ms(lambda: ref.decode_attention_ref(
        q, k, v, k_pos, q_pos, window=window), iters=10)
    keep = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        keep &= k_pos > q_pos[:, None] - window
    mask = keep[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, enable_gqa=True))
    esize = q.element_size()
    kept = int(keep.sum().item())            # (b, slot) pairs this data needs
    nbytes = (2 * B * Hq * hd * esize + 2 * kept * Hkv * hd * esize
              + k_pos.numel() * 4 + B * 4)
    ops = 4.0 * hd * Hq * kept
    bms, by = bound_ms(nbytes, ops, PEAK_BF16 if dtype == torch.bfloat16
                       else PEAK_F32)
    return emit("check", kernel="decode_attention",
                shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, hd=hd), fill=fill,
                window=window, ring=ring,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ok=ok, ms=ms, call_ms=per_call, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by)


def check_digest(torch, nb):
    from repro_torch.kernels import ref
    from repro_torch.kernels.digest import block_digest
    g = torch.Generator(device="cuda").manual_seed(nb)
    panels = torch.randint(-2**31, 2**31, (nb, 256), generator=g,
                           dtype=torch.int64, device="cuda").to(torch.int32)
    panels = panels.view(torch.uint32)
    out = block_digest(panels)
    expect = ref.digest_ref(panels)
    torch.cuda.synchronize()
    a, b = out.view(torch.int32), expect.view(torch.int32)
    mismatches = int((a != b).sum().item())
    ms = device_ms(lambda: block_digest(panels))
    per_call = call_ms(lambda: block_digest(panels))
    plain_ms = device_ms(lambda: ref.digest_ref(panels), iters=5)
    nbytes = nb * 256 * 4 + nb * 4
    # 2 integer operations (multiply, add) per word, counted at the f32
    # non-tensor rate for want of a published int32 peak
    bms, by = bound_ms(nbytes, 2.0 * 256 * nb, PEAK_F32)
    return emit("check", kernel="block_digest", rows=nb,
                mib=nb * 1024 / 2**20, mismatches=mismatches,
                max_abs_err=float(mismatches), tol="bit-exact",
                ok=mismatches == 0, ms=ms, call_ms=per_call,
                plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                bound_by=by)


# ---------------------------------------------------------------------------
# phases 4-5: the serving path at full width, and its correctness
# ---------------------------------------------------------------------------


def serve_and_stage(torch, server, batch):
    """The main path: generate through the mover, then stage the prefill's
    KV cache to host memory under an accel-placed checksum."""
    from repro_torch.core.basin import checkpoint_basin
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    from repro_torch.core.planner import plan_transfer

    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0

    _, cache = server.prefill(batch)
    items = [cache[name][i] for i in range(cache["k"].shape[0])
             for name in ("k", "v")]
    item_bytes = items[0].nbytes
    plan = plan_transfer(checkpoint_basin(), item_bytes=item_bytes,
                         stages=("kv-stage",), checksum=True,
                         checksum_placement="accel")
    mover = UnifiedDataMover(MoverConfig(checksum=True), plan=plan)
    received = []
    t0 = time.monotonic()
    report = mover.bulk_transfer(iter(items),
                                 lambda t: received.append(t.to("cpu")),
                                 plan=plan)
    stage_s = time.monotonic() - t0
    return tokens, gen_s, items, received, report, stage_s


def check_correct(torch, server, batch, tokens, items, received, report):
    from repro_torch.core.integrity import StreamDigest
    from repro_torch.models.blocks import ShardCtx
    api, params = server.api, server.params
    tok = torch.as_tensor(batch["tokens"], device="cuda")
    ref_ctx = ShardCtx(impl="ref")
    lk, ck = api.prefill(params, {"tokens": tok}, server.ctx, server.max_len)
    lr, cr = api.prefill(params, {"tokens": tok}, ref_ctx, server.max_len)
    scale = lr.float().abs().max().item()
    errs = [(lk.float() - lr.float()).abs().max().item()]
    # generate's tokens must be the kernel path's own greedy choices: the
    # same deterministic path, so argmax agrees exactly at every step
    greedy = [torch.argmax(lk[:, -1], dim=-1)]
    forced = torch.as_tensor(tokens, device="cuda")
    for t in range(4):       # teacher-forced with the kernel path's tokens
        step = forced[:, t:t + 1]
        lk, ck = api.decode_step(params, ck, step, server.ctx)
        lr, cr = api.decode_step(params, cr, step, ref_ctx)
        errs.append((lk.float() - lr.float()).abs().max().item())
        scale = max(scale, lr.float().abs().max().item())
        greedy.append(torch.argmax(lk[:, -1], dim=-1))
    greedy = torch.stack(greedy, dim=1).cpu().numpy()
    greedy_ok = bool((greedy == tokens[:, :greedy.shape[1]]).all())
    # bf16 activations through 32 layers: the two paths round attention
    # probabilities at different places, so logits agree to a few bf16 ulps
    # of their scale, not bit for bit
    tol = 0.05 * scale
    logits_ok = max(errs) <= tol and bool(torch.isfinite(lk).all())
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    bytes_ok = (len(received) == len(items)
                and sorted(_sha(t) for t in received)
                == sorted(_sha(t.cpu()) for t in items))
    shape_ok = (tokens.shape == (BATCH, GEN) and tokens.dtype.kind == "i"
                and int(tokens.min()) >= 0
                and int(tokens.max()) < server.cfg.vocab)
    return emit("correct", logits_max_abs_err=errs, logits_scale=scale,
                logits_tol=tol, logits_ok=logits_ok,
                tokens_shape=list(tokens.shape), tokens_ok=shape_ok,
                greedy_steps=int(greedy.shape[1]), greedy_ok=greedy_ok,
                accel_hexdigest=report.checksum,
                plain_hexdigest=plain.hexdigest(),
                digest_ok=report.checksum == plain.hexdigest(),
                bytes_ok=bytes_ok)


def _sha(t) -> str:
    import hashlib
    from repro_torch.core.integrity import as_bytes
    return hashlib.sha256(as_bytes(t)).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase record to this JSON file")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    records.append(emit(
        "card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0]))

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server

    t0 = time.monotonic()
    took = build.build_all()
    records.append(emit(
        "build", seconds=time.monotonic() - t0, per_kernel_s=took,
        ptxas={n: [ln.strip() for ln in build.build_log(n).splitlines()
                   if "registers" in ln or "spill" in ln]
               for n in build.KERNELS}))

    cfg = get_config("smollm-360m")
    G = dict(B=BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    max_len = PROMPT + GEN + 1
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (PROMPT, 1000):
            checks.append(check_flash(torch, S=S, dtype=dtype, window=0, **G))
        checks.append(check_flash(torch, S=1000, dtype=dtype, window=256,
                                  **G))
        for window, ring in ((0, False), (0, True), (256, True)):
            checks.append(check_decode(torch, S=1024, dtype=dtype, fill=700,
                                       window=window, ring=ring, **G))
    checks.append(check_digest(torch, nb=65536))          # 64 MiB
    # the shapes the serving path gives each kernel
    main_shapes = {
        "flash_attention": check_flash(torch, S=PROMPT, dtype=torch.bfloat16,
                                       window=0, **G),
        "decode_attention": check_decode(torch, S=max_len,
                                         dtype=torch.bfloat16,
                                         fill=PROMPT + GEN // 2, window=0,
                                         ring=False, **G),
        "block_digest": check_digest(
            torch, nb=-(-BATCH * max_len * cfg.kv_dim * 2 // 1024)),
    }
    checks += list(main_shapes.values())
    records += checks
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             f"{json.dumps(bad)}")

    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    rng = torch.Generator().manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                     generator=rng,
                                     dtype=torch.int32).numpy()}
    server.generate(batch, 4)                              # warm-up request
    prefill_ms = call_ms(lambda: server.prefill(batch), iters=5, warmup=1)
    _, cache = server.prefill(batch)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")

    def one_step():
        cache["pos"] = PROMPT
        server.decode(cache, tok)
    decode_ms = call_ms(one_step, iters=10, warmup=2)
    # the same step with the host's launch cost removed (CUDA graph replay):
    # what the card itself spends per token
    decode_device_ms = device_ms(one_step, iters=5)
    trace = {"prefill": device_busy(lambda: server.prefill(batch)),
             "decode_step": device_busy(one_step)}
    del cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    tokens, gen_s, items, received, report, stage_s = serve_and_stage(
        torch, server, batch)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    records.append(emit(
        "serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        batch=BATCH, prompt=PROMPT, gen=GEN, prefill_ms=prefill_ms,
        decode_ms_per_token=decode_ms,
        decode_device_ms_per_token=decode_device_ms, generate_s=gen_s,
        tok_per_s=BATCH * GEN / gen_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        kv_items=len(items), kv_bytes=sum(t.nbytes for t in items),
        kv_stage_s=stage_s, kv_stage_gbps=report.throughput_bytes_per_s
        * 8 / 1e9, launches=launches, trace=trace))
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        fail(f"the serving path never launched {idle}")

    correct = check_correct(torch, server, batch, tokens, items, received,
                            report)
    records.append(correct)
    if not all(correct[k] for k in ("logits_ok", "tokens_ok", "greedy_ok",
                                     "digest_ok", "bytes_ok")):
        fail(f"the serving path's output is wrong: {json.dumps(correct)}")

    kernels = []
    for name, rec in main_shapes.items():
        k = build.KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"records": records, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
