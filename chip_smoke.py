#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, one JSON line each:

1. ``card``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: the hand-written kernels built from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a, one process per source, all at
   once, with seconds, the compiler's register / shared-memory report and,
   per library, its tensor-core instructions in ``cuobjdump -sass``
   (``HGMMA`` is wgmma, ``HMMA`` mma.sync); the run fails if the SSD
   scan's library holds neither.
3. ``check``: each kernel's wrapper on tensors on the card against its plain
   PyTorch version on the same inputs (stated tolerance; the digest and the
   int8 codes, scales and dequantized values bit-exact), at the shapes the
   serving paths give it and at a few others.  Times are device times per
   call (a CUDA graph of repeated calls, replayed between CUDA events) of
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (``scaled_dot_product_attention``, a yardstick
   the port never calls); ``call_ms`` is the kernel's time per eager call,
   host included.  The whole-item digest ``digest_items`` is checked at
   the main paths' shapes (one KV item, a prefill's 64 KV items as one
   slab, one wire item, 48 wire items as one slab, one 64 MiB item), each
   record with its bytes, TB/s and launches per call; one more record
   gives the host time of one ``StreamDigest.add`` of a KV item and
   whether a slab folded under ``set_sync_debug_mode("error")`` raised.
4. ``serve`` (smollm-360m): ``Server(get_config("smollm-360m"),
   device="cuda")`` (full width, 32 layers, random weights from a seed)
   serves 4 x 128-token prompts for 32 tokens through the mover, and the
   prefill's KV cache is staged to host memory by a ``bulk_transfer``
   planned with ``checksum_placement="accel"`` on the card's staging basin
   (``card_host_basin``: HBM, PCIe Gen5 x16, pageable host memory at the
   copy rate this run measures), its digest priced at the rate phase 3
   measured for one KV item (the mover hands the digest one item at a
   time: one launch each).  The run fails unless the staging launched the
   digest once per item or slab the mover handed over
   (``kv_digest_folds``), and unless a profiler trace of one more staging
   shows no kernel but the digest (no padding, no concatenation).
   Prefill ms, decode ms/token (eager, and as device time from a CUDA
   graph), tok/s, peak memory, and a profiler trace of one prefill and
   one decode step (device busy time, idle share, top kernels).
5. ``correct`` (smollm-360m): the kernel path's prefill logits and 4
   teacher-forced decode steps against the plain path (``impl="ref"``) on
   the same weights; the served tokens against the kernel path's own greedy
   choices at those 5 steps, exactly; the transfer's hexdigest against the
   plain digest of the bytes that arrived on the host, and those bytes
   against the cache.
6. ``serve`` (mamba2-1.3b): the same at full width (48 layers, d_model
   2048, nothing cut) for 4 x 512-token prompts (two SSD chunks, so the
   state carries across chunks): the prefill runs the SSD-scan kernel once
   per layer, decode the plain recurrent step.
7. ``stage_state``: the prefill's SSM state (48 items of 8 MiB f32) moves
   to host memory by a ``bulk_transfer`` with
   ``transforms=[("compress", compress_transform())]`` on the card and an
   accel checksum, as int8 codes and scales; ``restore``: the host items
   go back onto the card through ``decompress_transform``.  Planned as
   in 4, the digest priced at the rate phase 3 measured for one wire item;
   one digest launch per item handed over, as in 4.
8. ``correct`` (mamba2-1.3b): kernel path against plain path as in 5; the
   codes and scales on the host against the plain quantizer's of the same
   state, bit for bit; the transfer's hexdigest against the plain digest
   of the delivered items; 4 teacher-forced decode steps from the restored
   state against the same from the original state.

9. ``train`` (smollm-360m): ``Trainer(get_config("smollm-360m"),
   device="cuda")`` (full width, 32 layers, ``remat="full"``, random weights
   from a seed) trains 8 steps of 8 x 512 tokens from ``InputPipeline`` on
   ``SyntheticTokenSource``, checkpoints every 4 steps into a temporary
   directory (removed at the end) and fails once, injected before step 7,
   restoring the step-4 checkpoint.  It fails unless every loss is finite,
   the state right after the restore hashes (SHA-256 per leaf) to the
   manifest's digests, ``verify_checkpoint`` accepts every saved step, the
   last checkpoint loaded back onto the card equals the trainer's state bit
   for bit, and no kernel of ``kernels/build.py`` launched while training
   (the plain ``impl="ref"`` path, as the JAX package trains).  Step ms
   (the first apart, median of the rest), tokens/s, the input pipeline's
   consumer stall and fidelity gap, each save's device-to-host snapshot and
   serialize + hash + write seconds and bytes, restore seconds, peak memory.

The launch counts are set to 0 just before each path (the two ``serve``
phases, ``stage_state``, ``restore``, ``train``) and read just after; every
kernel a serving path runs must have run there, and none may run in
``train``.  Then the kernels line (launches summed over the paths;
``block_digest``, the TPU kernel's per-row function, is checked in phase 3
and runs on no path, so its count is 0), the card line
as ``nvidia-smi`` prints it, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before the result lines; without a card, or
without the repository's ``src/`` beside this file, it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
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
#: the train phase: global batch, sequence, steps, checkpoint cadence, and
#: the step index before which the injected failure strikes
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 6
#: mamba2-1.3b prompt: two 256-step SSD chunks
MAMBA_PROMPT = 512

# kernel against plain version on the card, both rounding an f32 result to
# the output dtype once: f32 sums in another order, bf16 about one ulp of
# the output (2^-8..2^-7 relative) plus a floor for values near zero
TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=1e-3, rtol=8e-3)}
# SSD scan against its plain version, atol as a share of the output's
# largest magnitude: y (bf16) one bf16 ulp (rtol 8e-3) over f32 sums and an
# f32 prefix sum taken in another order; the final state (f32) rtol 1e-3,
# since the prefix sums' rounding moves exp(cum_i - cum_j) by up to about
# 1e-4 relative where |cum| reaches about 1e3
SSD_TOL = {"y": dict(atol_share=1e-3, rtol=8e-3),
           "state": dict(atol_share=1e-4, rtol=1e-3)}
# smollm-360m's served logits, kernel path against plain path, as a share
# of the plain path's logit scale
LOGIT_SHARE = 0.05
# mamba2-1.3b's served logits (48 layers) are held to the noise of bf16
# itself: the kernel path may differ from the plain path, and decoding from
# the restored int8 state from decoding from the original state, by at most
# this many times what the plain path's own bf16 rounding moves them (the
# plain path against the same path with f32 weights and activations)
NOISE_FACTOR = 2.0


def emit(phase: str, **kw) -> dict:
    rec = {"phase": phase, **kw}
    print(json.dumps(rec), flush=True)
    return rec


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph (on the stream that ran the warm-up calls) and replayed
    between two CUDA events, so the host's launch cost is left out (inputs
    stay warm in L2 across the calls)."""
    import torch
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


def device_busy(fn, top: int = 6) -> dict:
    """Profile one call of ``fn`` (ending in a device sync): host wall ms,
    the union of the card's kernel and copy intervals, the idle share
    between them, and the kernels that took the most device time (names
    cut to 60 characters, kernels that share those summed together).  The
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
        name = ev.name[:60]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_kernels": len(spans),
            "idle_share": (1.0 - busy / wall_us) if spans else None,
            "top_device_ms": {n: t / 1e3 for n, t in ranked}}


def tensor_core_sass(build) -> dict:
    """Per kernel source, how many HGMMA (wgmma) and HMMA (mma.sync)
    instructions its built library's SASS holds."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    counts = {}
    for name, k in build.KERNELS.items():
        src = os.path.basename(k.source)
        if src in counts:
            continue
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[src] = {op: len(re.findall(rf"\b{op}\b", sass))
                       for op in ("HGMMA", "HMMA")}
    return counts


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
    from repro_torch.kernels.decode_attention import (decode_attention_bhd,
                                                       split_plan)
    import torch.nn.functional as F
    chunk, n_split = split_plan(S, B, Hq, Hkv)
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
                window=window, ring=ring, chunk=chunk, n_split=n_split,
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


def check_digest_items(torch, label, items, plain_items):
    """``digest_items`` on a slab of items against ``digest_items_ref`` on
    the same bytes (``plain_items``: the host bytes of ``items`` as tensors
    on the card, so the plain version can be captured in a graph), bit for
    bit.  Bound: the slab's bytes read once and 8 bytes per item written,
    at the memory rate (2 integer operations per 4-byte word, at the f32
    rate, bound it far less)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.digest import digest_items
    n0 = build.launch_counts()["digest_items"]
    out = digest_items(items)
    launches = build.launch_counts()["digest_items"] - n0
    expect = ref.digest_items_ref(plain_items)
    torch.cuda.synchronize()
    mismatches = int((out.view(torch.int64)
                      != expect.view(torch.int64)).sum().item())
    item_bytes = [sum(p.numel() if hasattr(p, "numel") else len(p)
                      for p in parts) for parts in items]
    nbytes = sum(item_bytes) + 8 * len(items)
    bms, by = bound_ms(nbytes, 0.5 * sum(item_bytes), PEAK_F32)
    kernel = lambda: digest_items(items)
    big = nbytes > 2**26
    ms = device_ms(kernel, iters=10 if big else 20)
    return emit("check", kernel="digest_items", of=label, items=len(items),
                bytes=sum(item_bytes), launches_per_call=launches,
                mismatches=mismatches, max_abs_err=float(mismatches),
                tol="bit-exact", ok=mismatches == 0 and launches == 1,
                ms=ms, call_ms=call_ms(kernel, iters=10 if big else 20),
                plain_ms=device_ms(lambda: ref.digest_items_ref(plain_items),
                                   iters=2 if big else 5),
                library_ms=None, bound_ms=bms, bound_by=by,
                tb_per_s=sum(item_bytes) / (ms / 1e3) / 1e12)


def digest_checks(torch, cfg, mcfg):
    """``digest_items`` at the main paths' shapes: one KV item, the KV
    items of one prefill as one slab, one wire item (int8 codes, f32
    scales, the shape's bytes inline), a staging's wire items as one slab,
    and one 64 MiB item.  Then the host time of one ``StreamDigest.add`` of
    a KV item (it queues a launch and returns), and one slab folded under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core.integrity import StreamDigest, as_bytes
    g = torch.Generator(device="cuda").manual_seed(17)
    kv_bytes = BATCH * (PROMPT + GEN + 1) * cfg.kv_dim * 2
    n_kv = 2 * cfg.n_layers
    kv = torch.randint(0, 256, (n_kv, kv_bytes), generator=g,
                       dtype=torch.uint8, device="cuda")
    kv_items = [[kv[i]] for i in range(n_kv)]
    values = BATCH * mcfg.ssm_heads * mcfg.ssm.head_dim * mcfg.ssm.d_state
    shape = (BATCH, mcfg.ssm_heads, mcfg.ssm.head_dim, mcfg.ssm.d_state)
    n_state = mcfg.n_layers
    codes = torch.randint(0, 256, (n_state, values), generator=g,
                          dtype=torch.uint8, device="cuda")
    scales = torch.randint(0, 256, (n_state, values // 256 * 4),
                           generator=g, dtype=torch.uint8, device="cuda")
    shape_bytes = as_bytes(shape)
    shape_dev = torch.frombuffer(bytearray(shape_bytes),
                                 dtype=torch.uint8).cuda()
    wire = [[codes[i], scales[i], shape_bytes] for i in range(n_state)]
    wire_plain = [[codes[i], scales[i], shape_dev] for i in range(n_state)]
    big = torch.randint(0, 256, (2**26,), generator=g, dtype=torch.uint8,
                        device="cuda")
    recs = {
        "kv_item": check_digest_items(torch, "one KV item", kv_items[:1],
                                      kv_items[:1]),
        "kv_slab": check_digest_items(torch, f"{n_kv} KV items, one slab",
                                      kv_items, kv_items),
        "wire_item": check_digest_items(torch, "one wire item", wire[:1],
                                        wire_plain[:1]),
        "wire_slab": check_digest_items(
            torch, f"{n_state} wire items, one slab", wire, wire_plain),
        "big": check_digest_items(torch, "one 64 MiB item", [[big]],
                                  [[big]]),
    }
    # host wall time of one add of a KV item: it must not wait on the card
    item = kv[0].view(torch.bfloat16)
    d = StreamDigest(True, "accel")
    d.add(item)
    torch.cuda.synchronize()
    walls = []
    for _ in range(50):
        t0 = time.perf_counter()
        d.add(item)
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        d.add_many([t[0].view(torch.bfloat16) for t in kv_items])
        synced = False
    except RuntimeError:
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain = StreamDigest(True, "accel", backend="ref")
    plain.add_many([item] * 51 + [t[0] for t in kv_items])
    got, want = d.hexdigest(), plain.hexdigest()
    recs["add"] = emit(
        "check", kernel="digest_items", of="StreamDigest.add of a KV item",
        host_ms_median=statistics.median(walls), host_ms_min=min(walls),
        add_many_slab_synced=synced, hexdigest=got, plain_hexdigest=want,
        ok=got == want and not synced)
    return recs


def _ssd_inputs(torch, B, H, G, S, P=64, N=128, seed=0):
    """The SSD scan's inputs as the model makes them: bf16 x/B/C, dt the
    softplus of a raw projection plus a bias (0.001..0.3), A = -(1..16)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, H, S, P, generator=g, device="cuda").to(torch.bfloat16)
    raw = torch.randn(B, H, S, generator=g, device="cuda") * 0.5
    bias = torch.linspace(-7.0, -1.5, H, device="cuda")[None, :, None]
    dt = torch.nn.functional.softplus(raw + bias)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = torch.randn(B, G, S, N, generator=g, device="cuda").to(
        torch.bfloat16)
    Cm = torch.randn(B, G, S, N, generator=g, device="cuda").to(
        torch.bfloat16)
    return x, dt, A, Bm, Cm


def _within(torch, got, want, atol_share, rtol) -> tuple[float, bool]:
    """Max abs error, and whether ``got`` is within ``atol_share`` of
    ``want``'s largest magnitude plus ``rtol`` relative."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    atol = atol_share * want.abs().max().item()
    ok = bool(torch.allclose(got, want, atol=atol, rtol=rtol)
              and torch.isfinite(got).all())
    return err, ok


def check_ssd(torch, B, H, G, S, chunk=256):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsd
    x, dt, A, Bm, Cm = _ssd_inputs(torch, B, H, G, S, seed=S + G)
    P, N = x.shape[3], Bm.shape[3]
    y, state = ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=chunk)
    ry, rstate = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    y_err, y_ok = _within(torch, y, ry, **SSD_TOL["y"])
    s_err, s_ok = _within(torch, state, rstate, **SSD_TOL["state"])
    kernel = lambda: ssd_scan_bhsd(x, dt, A, Bm, Cm, chunk=chunk)
    ms, per_call = device_ms(kernel, iters=10), call_ms(kernel, iters=10)
    plain_ms = device_ms(lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                                  chunk=chunk), iters=3)
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4
              + 2 * Bm.numel() * 2 + state.numel() * 4)
    # per (b, h, chunk) what the causal form needs: C.B^T and W.x over the
    # Q(Q+1)/2 pairs j <= i, C.state and the state update over Q x P x N
    pairs = chunk * (chunk + 1) // 2
    per = 2 * pairs * N + 2 * pairs * P + 4 * chunk * P * N
    ops = float(per) * B * H * (S // chunk)
    bms, by = bound_ms(nbytes, ops, PEAK_BF16)
    return emit("check", kernel="ssd_scan",
                shape=dict(B=B, H=H, G=G, S=S, P=P, N=N, chunk=chunk),
                dtype="bfloat16", max_abs_err=y_err, state_max_abs_err=s_err,
                tol=SSD_TOL, ok=y_ok and s_ok, ms=ms, call_ms=per_call,
                plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                bound_by=by, gflop=ops / 1e9, mbytes=nbytes / 1e6)


def _quant_values(torch, n, seed):
    """Values over six decades of magnitude, both signs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mag = torch.rand(n, generator=g, device="cuda") * 6 - 3
    return torch.randn(n, generator=g, device="cuda") * 10.0 ** mag


def _bits_differ(torch, a, b) -> int:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum().item())


def check_quantize(torch, n):
    """Both quantize kernels against the plain versions, bit for bit;
    returns the quantize and the dequantize record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import dequantize_int8, quantize_int8
    x = _quant_values(torch, n, n)
    q, s = quantize_int8(x)
    rq, rs = ref.quantize_int8_ref(x)
    back = dequantize_int8(q, s, (n,))
    rback = ref.dequantize_int8_ref(rq, rs, (n,))
    torch.cuda.synchronize()
    qbad = _bits_differ(torch, q, rq) + _bits_differ(torch, s, rs)
    dbad = _bits_differ(torch, back, rback)
    nb = q.shape[0]
    recs = []
    for name, bad, kernel, plain, ops in (
            ("quantize_int8", qbad, lambda: quantize_int8(x),
             lambda: ref.quantize_int8_ref(x), 5.0 * n),
            ("dequantize_int8", dbad, lambda: dequantize_int8(q, s, (n,)),
             lambda: ref.dequantize_int8_ref(q, s, (n,)), 1.0 * n)):
        nbytes = n * 4 + nb * 256 + nb * 4
        # a few f32 operations per value (abs, max, divide, round, clamp;
        # one multiply back), at the f32 rate outside the tensor cores
        bms, by = bound_ms(nbytes, ops, PEAK_F32)
        recs.append(emit(
            "check", kernel=name, values=n, blocks=nb, mismatches=bad,
            max_abs_err=float(bad), tol="bit-exact", ok=bad == 0,
            ms=device_ms(kernel), call_ms=call_ms(kernel),
            plain_ms=device_ms(plain, iters=5), library_ms=None,
            bound_ms=bms, bound_by=by))
    return recs


# ---------------------------------------------------------------------------
# phases 4-5: the serving path at full width, and its correctness
# ---------------------------------------------------------------------------


def pageable_gbps(torch, t, reps: int = 5) -> float:
    """The copy rate of ``t`` from the card into pageable host memory, in
    Gbps: host clock around ``reps`` copies (each ``.cpu()`` waits)."""
    t.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        t.cpu()
    return reps * t.nbytes * 8 / (time.perf_counter() - t0) / 1e9


def digest_rate(rec: dict) -> float:
    """Bytes per second of a ``check_digest_items`` record's kernel."""
    return rec["bytes"] / (rec["ms"] / 1e3)


def staging_kernels(torch, items, digest_bytes_per_s, copy_gbps) -> dict:
    """The kernels (by name, with counts) one more KV staging runs on the
    card, from a profiler trace; copies are not kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _stage_kv(torch, items, digest_bytes_per_s, copy_gbps)
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.name.startswith(
                ("Memcpy", "Memset")):
            names[ev.name] = names.get(ev.name, 0) + 1
    return names


def serve_and_stage(torch, server, batch, digest_bytes_per_s):
    """The main path: generate through the mover, then stage the prefill's
    KV cache to host memory under an accel-placed checksum, planned on
    the card's staging basin with this run's copy and digest rates."""
    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0

    _, cache = server.prefill(batch)
    items = [cache[name][i] for i in range(cache["k"].shape[0])
             for name in ("k", "v")]
    copy_gbps = pageable_gbps(torch, items[0])
    t0 = time.monotonic()
    received, report = _stage_kv(torch, items, digest_bytes_per_s,
                                 copy_gbps)
    stage_s = time.monotonic() - t0
    return tokens, gen_s, items, received, report, stage_s, copy_gbps


def _stage_kv(torch, items, digest_bytes_per_s, copy_gbps=None):
    """Stage KV items to host memory through the mover, planned on the
    card's staging basin, under an accel-placed checksum."""
    from repro_torch.core.basin import card_host_basin
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    from repro_torch.core.planner import plan_transfer
    plan = plan_transfer(card_host_basin(pageable_gbps=copy_gbps),
                         item_bytes=items[0].nbytes, stages=("kv-stage",),
                         checksum=True, checksum_placement="accel",
                         accel_digest_bytes_per_s=digest_bytes_per_s)
    mover = UnifiedDataMover(MoverConfig(checksum=True), plan=plan)
    received = []
    report = mover.bulk_transfer(iter(items),
                                 lambda t: received.append(t.to("cpu")),
                                 plan=plan)
    return received, report


def _teacher_forced(torch, api, params, ctx, tok, forced, max_len):
    """Prefill logits and 4 decode steps teacher-forced with ``forced``."""
    logits, cache = api.prefill(params, {"tokens": tok}, ctx, max_len)
    out = [logits.float()]
    for t in range(4):
        logits, cache = api.decode_step(params, cache, forced[:, t:t + 1],
                                        ctx)
        out.append(logits.float())
    return out


def _max_err(a, b) -> list[float]:
    return [(x - y).abs().max().item() for x, y in zip(a, b)]


def check_logits(torch, server, batch, tokens, *, noise_floor=False) -> dict:
    """The kernel path's prefill logits and 4 decode steps, teacher-forced
    with the served tokens, against the plain path (``impl="ref"``) on the
    same weights; and the served tokens against the kernel path's own
    greedy choices at those 5 steps.  With ``noise_floor``, also the plain
    path with f32 weights and activations, whose distance from the plain
    path is what bf16 rounding alone moves the logits."""
    import copy
    from repro_torch.models.blocks import ShardCtx
    api, params = server.api, server.params
    tok = torch.as_tensor(batch["tokens"], device="cuda")
    forced = torch.as_tensor(tokens, device="cuda")
    ref_ctx = ShardCtx(impl="ref")
    run = lambda p, ctx: _teacher_forced(torch, api, p, ctx, tok, forced,
                                         server.max_len)
    kern, plain = run(params, server.ctx), run(params, ref_ctx)
    errs = _max_err(kern, plain)
    scale = max(x.abs().max().item() for x in plain)
    # generate's tokens must be the kernel path's own greedy choices: the
    # same deterministic path, so argmax agrees exactly at every step
    greedy = torch.stack([torch.argmax(x[:, -1], dim=-1) for x in kern],
                         dim=1).cpu().numpy()
    greedy_ok = bool((greedy == tokens[:, :greedy.shape[1]]).all())
    finite = all(bool(torch.isfinite(x).all()) for x in kern)
    shape_ok = (tokens.shape == (BATCH, GEN) and tokens.dtype.kind == "i"
                and int(tokens.min()) >= 0
                and int(tokens.max()) < server.cfg.vocab)
    out = dict(logits_max_abs_err=errs, logits_scale=scale,
               tokens_shape=list(tokens.shape), tokens_ok=shape_ok,
               greedy_steps=int(greedy.shape[1]), greedy_ok=greedy_ok)
    if not noise_floor:
        # bf16 activations through the whole stack: the two paths round
        # attention probabilities at different places, so logits agree to
        # a few bf16 ulps of their scale, not bit for bit
        tol = LOGIT_SHARE * scale
    else:
        p32 = copy.deepcopy(params).float()
        noise = _max_err(plain, run(p32, ref_ctx))
        del p32
        tol = NOISE_FACTOR * max(noise)
        out.update(bf16_noise_max_abs_err=noise)
    out.update(logits_tol=tol, logits_ok=max(errs) <= tol and finite)
    return out


def check_correct(torch, server, batch, tokens, items, received, report):
    from repro_torch.core.integrity import StreamDigest
    fields = check_logits(torch, server, batch, tokens)
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    bytes_ok = (len(received) == len(items)
                and sorted(_sha(t) for t in received)
                == sorted(_sha(t.cpu()) for t in items))
    return emit("correct", arch=server.cfg.name, **fields,
                accel_hexdigest=report.checksum,
                plain_hexdigest=plain.hexdigest(),
                digest_ok=report.checksum == plain.hexdigest(),
                bytes_ok=bytes_ok)


def stage_state(torch, server, batch, digest_bytes_per_s):
    """The SSM path's staging: a prefill, then its recurrent state (one
    item per layer) to host memory over the int8 wire, quantized on the
    card and digested there.  The plan is ordered, so layer i arrives i-th
    (a restored state must not permute its layers); it is planned as the
    KV staging is."""
    from repro_torch.core.basin import card_host_basin
    from repro_torch.core.integrity import compress_transform
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    from repro_torch.core.planner import plan_transfer

    _, cache = server.prefill(batch)
    ssm = cache["mamba"].ssm
    items = [ssm[i] for i in range(ssm.shape[0])]
    copy_gbps = pageable_gbps(torch, items[0])
    plan = plan_transfer(card_host_basin(pageable_gbps=copy_gbps),
                         item_bytes=items[0].nbytes,
                         stages=("state-stage",), checksum=True,
                         checksum_placement="accel", ordered=True,
                         accel_digest_bytes_per_s=digest_bytes_per_s)
    mover = UnifiedDataMover(MoverConfig(checksum=True), plan=plan)
    received = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    report = mover.bulk_transfer(
        iter(items), lambda t: received.append((t[0].cpu(), t[1].cpu(),
                                                t[2])),
        plan=plan, transforms=[("compress", compress_transform())])
    stage_s = time.monotonic() - t0
    return cache, items, received, report, stage_s, copy_gbps


def check_mamba_correct(torch, server, batch, tokens, cache, items, received,
                        report, restored):
    """The SSM path's output: logits as in :func:`check_logits`; the codes
    that reached the host against the plain quantizer's, bit for bit; the
    transfer's digest against the plain digest of the delivered items; the
    restored state within half a quantization step of the original, and 4
    teacher-forced decode steps from it within a share of the logit scale
    of the same steps from the original state."""
    from repro_torch.core.integrity import StreamDigest
    from repro_torch.kernels import ref
    from repro_torch.models.ssm import MambaState
    fields = check_logits(torch, server, batch, tokens, noise_floor=True)
    code_bad = step_bad = 0
    for x, back, (q, s, shape) in zip(items, restored, received):
        rq, rs = ref.quantize_int8_ref(x)
        code_bad += _bits_differ(torch, q, rq.cpu())
        code_bad += _bits_differ(torch, s, rs.cpu())
        code_bad += int(tuple(shape) != tuple(x.shape))
        # |restored - original| <= scale / 2, block by block, plus the f32
        # rounding of x / scale and of q * scale: (|x| + |q s|) * 2^-24
        x, back = x.reshape(-1), back.reshape(-1)
        bound = (rs.repeat_interleave(256)[:x.numel()] * 0.5
                 + (x.abs() + back.abs()) * 2.0 ** -24)
        step_bad += int(((back - x).abs() > bound).sum().item())
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    code_bytes = sum(q.nbytes for q, _, _ in received)
    scale_bytes = sum(s.nbytes for _, s, _ in received)
    mamba = cache["mamba"]
    orig = {"pos": cache["pos"], "mamba": MambaState(mamba.conv.clone(),
                                                     mamba.ssm.clone())}
    back = {"pos": cache["pos"], "mamba": MambaState(mamba.conv.clone(),
                                                     restored)}
    forced = torch.as_tensor(tokens, device="cuda")
    errs, scale = [], 0.0
    for t in range(4):
        step = forced[:, t:t + 1]
        la, orig = server.decode(orig, step)
        lb, back = server.decode(back, step)
        errs.append((la.float() - lb.float()).abs().max().item())
        scale = max(scale, la.float().abs().max().item())
    # the int8 error of each state element is at most half its block's
    # step (max|block| / 254, checked above), about the relative size of a
    # bf16 rounding: held to the same noise floor as the kernel path
    tol = fields["logits_tol"]
    return emit(
        "correct", arch=server.cfg.name, **fields,
        state_items=len(received), code_bytes=code_bytes,
        scale_bytes=scale_bytes, codes_mismatched=code_bad,
        codes_ok=code_bad == 0 and len(received) == len(items),
        restore_over_half_step=step_bad, restore_ok=step_bad == 0,
        accel_hexdigest=report.checksum, plain_hexdigest=plain.hexdigest(),
        digest_ok=report.checksum == plain.hexdigest(),
        restored_logits_max_abs_err=errs, restored_logits_scale=scale,
        restored_logits_tol=tol,
        restored_ok=max(errs) <= tol and bool(torch.isfinite(lb).all()))


def _sha(t) -> str:
    import hashlib
    from repro_torch.core.integrity import as_bytes
    return hashlib.sha256(as_bytes(t)).hexdigest()


# ---------------------------------------------------------------------------
# phase 9: training at full width, with checkpoints, a failure and a restore
# ---------------------------------------------------------------------------


def _bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two tensors (``torch.equal`` compares
    values: it takes -0 for 0 and fails on NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(ints[a.element_size()]),
                       b.view(ints[b.element_size()]))


def _leaf_hashes(tree) -> dict:
    import hashlib
    from repro_torch.tree import flatten_with_paths, host_array
    return {p: hashlib.sha256(host_array(v).tobytes()).hexdigest()
            for p, v in flatten_with_paths(tree)}


def _manifest_hashes(root, step) -> dict:
    from repro_torch.checkpoint.manager import _ckpt_dir
    with open(os.path.join(_ckpt_dir(root, step), "manifest.json")) as f:
        return {leaf["path"]: leaf["sha256"] for leaf in
                json.load(f)["leaves"]}


def train_phase(torch, cfg, root) -> dict:
    """Train ``cfg`` on the card through ``Trainer.run`` with checkpoints
    into ``root`` and one injected failure; returns the phase's record,
    checks included (``*_ok``).  The launch counts are set to 0 just before
    the run."""
    from repro_torch.checkpoint.manager import (complete_steps,
                                                load_checkpoint,
                                                verify_checkpoint)
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SyntheticTokenSource)
    from repro_torch.kernels import build
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import Stacked, flatten_with_paths

    restores = []

    class Checked(Trainer):
        """The trainer, timing each restore and hashing the state it
        restored against the checkpoint's manifest."""

        def try_restore(self):
            t0 = time.monotonic()
            ok = super().try_restore()
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
            if ok:
                want = _manifest_hashes(root, self.step_idx)
                got = _leaf_hashes(self.state_tree())
                restores.append({
                    "step": self.step_idx, "seconds": sec,
                    "leaves": len(got),
                    "hashes_ok": got == want})
            return ok

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Checked(cfg, device="cuda", ckpt_dir=root,
                      ckpt_every=TRAIN_CKPT_EVERY, total_steps=TRAIN_STEPS)
    trainer.init_state(SEED)
    n_params = sum(p.numel() for p in trainer.params.parameters())
    source = SyntheticTokenSource(
        cfg, PipelineConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            seed=SEED),
        n_batches=TRAIN_STEPS + 8)
    build.reset_launches()
    t0 = time.monotonic()
    log = trainer.run(source, TRAIN_STEPS, inject_failure_at=TRAIN_FAIL_AT)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    saved = complete_steps(root)
    verified = {s: verify_checkpoint(root, s) for s in saved}
    t1 = time.monotonic()
    back = load_checkpoint(root, saved[-1], trainer.state_tree())
    torch.cuda.synchronize()
    load_s = time.monotonic() - t1
    mine = dict(flatten_with_paths(trainer.state_tree()))
    mismatched = []
    for p, v in flatten_with_paths(back):
        pairs = zip(v, mine[p]) if isinstance(v, Stacked) else [(v, mine[p])]
        if not all(_bits_equal(torch, a, b) for a, b in pairs):
            mismatched.append(p)
    del back
    breakdown = step_breakdown(torch, trainer, source)

    wall = [r["wall_s"] * 1e3 for r in log]
    rest = statistics.median(wall[1:])
    losses = [r["loss"] for r in log]
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "remat": cfg.remat, "params": n_params,
        "global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
        "steps": len(log),
        "steps_logged": [r["step"] for r in log], "losses": losses,
        "step_ms_first": wall[0], "step_ms_median": rest,
        "step_ms": wall,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (rest / 1e3),
        "run_s": run_s,
        "run_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * len(log) / run_s,
        "input_consumer_stall_s": log[-1]["input_stall_s"],
        "input_fidelity_gap": log[-1]["input_fidelity_gap"],
        "saves": [dict(h, write_bytes_per_s=h["bytes"] / h["write_s"],
                       snapshot_bytes_per_s=h["bytes"] / h["snapshot_s"])
                  for h in trainer.ckpt.history],
        "restores": restores, "saved_steps": saved,
        "verified": {str(s): ok for s, ok in verified.items()},
        "load_back_s": load_s, "load_back_mismatched": mismatched,
        "step_breakdown": breakdown,
        "peak_mem_gib": peak, "launches": launches,
        "losses_ok": all(map(math.isfinite, losses)),
        "restore_ok": (len(restores) == 1 and restores[0]["hashes_ok"]
                       and restores[0]["step"] == TRAIN_CKPT_EVERY),
        "verify_ok": bool(saved) and all(verified.values()),
        "load_back_ok": not mismatched,
        "no_kernel_ok": not any(launches.values()),
    }


def step_breakdown(torch, trainer, source) -> dict:
    """Where one train step's time goes, on the trainer's state after its
    run: forward + backward and the AdamW update as eager calls between
    CUDA events, and a profiler trace of one whole step (device busy, idle
    share, the kernels that took the most device time)."""
    from repro_torch.optim.adamw import adamw_update, warmup_cosine
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter(source))
             .items()}
    weights = list(trainer.params.parameters())

    def fwd_bwd():
        loss, _ = trainer.api.loss(trainer.params, batch, trainer.ctx)
        return torch.autograd.grad(loss, weights)

    grads = fwd_bwd()
    lr = warmup_cosine(trainer.opt_state.step + 1, peak_lr=3e-4, warmup=1,
                       total=TRAIN_STEPS)
    out = {"fwd_bwd_ms": call_ms(fwd_bwd, iters=3, warmup=1),
           "adamw_ms": call_ms(lambda: adamw_update(
               grads, trainer.opt_state, weights, lr=lr), iters=3,
               warmup=1)}
    del grads

    def step():
        trainer.params, trainer.opt_state, _ = trainer.train_step(
            trainer.params, trainer.opt_state, batch)
    step()
    out["trace"] = device_busy(step, top=12)
    return out


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
    sass = tensor_core_sass(build)
    records.append(emit(
        "build", seconds=time.monotonic() - t0, per_source_s=took,
        ptxas={n: [ln.strip() for ln in build.build_log(n).splitlines()
                   if "registers" in ln or "spill" in ln]
               for n in build.KERNELS},
        tensor_core_sass=sass))
    ssd_sass = sass[os.path.basename(build.KERNELS["ssd_scan"].source)]
    if not (ssd_sass["HMMA"] or ssd_sass["HGMMA"]):
        fail(f"the SSD scan's library runs no tensor-core instruction: "
             f"{ssd_sass}")

    t_phase = time.monotonic()
    cfg = get_config("smollm-360m")
    mcfg = get_config("mamba2-1.3b")
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
    # the serving decode shape in f32 (bf16 is the main path's, below)
    checks.append(check_decode(torch, S=max_len, dtype=torch.float32,
                               fill=PROMPT + GEN // 2, window=0, ring=False,
                               **G))
    big_digest = check_digest(torch, nb=65536)            # 64 MiB
    checks.append(big_digest)
    # SSD over 4 chunks, and over 8 chunks at batch 1 (64 CTAs, fewer than
    # the SMs); quantize at a length that needs padding
    checks.append(check_ssd(torch, BATCH, mcfg.ssm_heads, 1, 1024))
    checks.append(check_ssd(torch, 1, mcfg.ssm_heads, 1, 2048))
    checks += check_quantize(torch, 1_000_003)
    # the shapes the serving paths give each kernel: one layer's SSD scan
    # and one layer's state (4 x 64 x 64 x 128 f32) on the int8 wire
    state_values = BATCH * mcfg.ssm_heads * mcfg.ssm.head_dim * \
        mcfg.ssm.d_state
    quant, dequant = check_quantize(torch, state_values)
    main_shapes = {
        "flash_attention": check_flash(torch, S=PROMPT, dtype=torch.bfloat16,
                                       window=0, **G),
        "decode_attention": check_decode(torch, S=max_len,
                                         dtype=torch.bfloat16,
                                         fill=PROMPT + GEN // 2, window=0,
                                         ring=False, **G),
        "block_digest": check_digest(
            torch, nb=-(-BATCH * max_len * cfg.kv_dim * 2 // 1024)),
        "ssd_scan": check_ssd(torch, BATCH, mcfg.ssm_heads,
                              mcfg.ssm.n_groups, MAMBA_PROMPT,
                              chunk=mcfg.ssm.chunk),
        "quantize_int8": quant,
        "dequantize_int8": dequant,
    }
    digests = digest_checks(torch, cfg, mcfg)
    main_shapes["digest_items"] = digests["kv_item"]
    checks += list(main_shapes.values())
    checks += [r for k, r in digests.items() if k != "kv_item"]
    records += checks
    records.append(emit("phase_time", of="check",
                        seconds=time.monotonic() - t_phase))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             f"{json.dumps(bad)}")

    # ---- smollm-360m: serve, stage the KV cache -------------------------
    t_phase = time.monotonic()
    mib_before = torch.cuda.memory_allocated() / 2**20
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    rng = torch.Generator().manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                     generator=rng,
                                     dtype=torch.int32).numpy()}
    timing = serve_timing(torch, server, batch, PROMPT)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    # the mover digests one item per launch: plan with that record's rate
    kv_digest = digest_rate(digests["kv_item"])
    tokens, gen_s, items, received, report, stage_s, kv_copy_gbps = \
        serve_and_stage(torch, server, batch, kv_digest)
    torch.cuda.synchronize()
    paths = {"smollm_serve": build.launch_counts()}
    kv_trace = staging_kernels(torch, items, kv_digest, kv_copy_gbps)
    records.append(emit(
        "serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        batch=BATCH, prompt=PROMPT, gen=GEN, **timing, generate_s=gen_s,
        tok_per_s=BATCH * GEN / gen_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        allocated_before_server_mib=mib_before, kv_items=len(items),
        kv_bytes=sum(t.nbytes for t in items),
        kv_stage_s=stage_s, kv_stage_gbps=report.throughput_bytes_per_s
        * 8 / 1e9, kv_pageable_copy_gbps=kv_copy_gbps,
        kv_planned_digest_bytes_per_s=kv_digest,
        kv_digest_folds=report.checksum_folds,
        kv_staging_device_kernels=kv_trace,
        launches=paths["smollm_serve"]))
    need(paths, "smollm_serve",
         ("flash_attention", "decode_attention", "digest_items"))
    once_per_fold(paths, "smollm_serve", report)
    others = [n for n in kv_trace if "digest_items_kernel" not in n]
    if others:
        fail(f"one KV staging ran other kernels than the digest: {others}")

    correct = check_correct(torch, server, batch, tokens, items, received,
                            report)
    records.append(correct)
    if not all(correct[k] for k in ("logits_ok", "tokens_ok", "greedy_ok",
                                     "digest_ok", "bytes_ok")):
        fail(f"the serving path's output is wrong: {json.dumps(correct)}")
    records.append(emit("phase_time", of="smollm",
                        seconds=time.monotonic() - t_phase))
    del server, items, received

    # ---- mamba2-1.3b: serve, stage the state over the int8 wire ---------
    t_phase = time.monotonic()
    mserver = Server(mcfg, device="cuda", max_len=MAMBA_PROMPT + GEN + 1)
    mserver.load(SEED)
    mbatch = {"tokens": torch.randint(0, mcfg.vocab, (BATCH, MAMBA_PROMPT),
                                      generator=rng,
                                      dtype=torch.int32).numpy()}
    mtiming = serve_timing(torch, mserver, mbatch, MAMBA_PROMPT)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.monotonic()
    mtokens = mserver.generate(mbatch, GEN)
    torch.cuda.synchronize()
    mgen_s = time.monotonic() - t0
    paths["mamba_serve"] = build.launch_counts()
    records.append(emit(
        "serve", arch=mcfg.name, layers=mcfg.n_layers, d_model=mcfg.d_model,
        params=sum(p.numel() for p in mserver.params.parameters()),
        batch=BATCH, prompt=MAMBA_PROMPT, gen=GEN, **mtiming,
        generate_s=mgen_s, tok_per_s=BATCH * GEN / mgen_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=paths["mamba_serve"]))
    need(paths, "mamba_serve", ("ssd_scan",))
    if paths["mamba_serve"]["ssd_scan"] != mcfg.n_layers:
        fail(f"one prefill launched the SSD kernel "
             f"{paths['mamba_serve']['ssd_scan']} times, not once per layer")

    build.reset_launches()
    state_digest = digest_rate(digests["wire_item"])
    cache, sitems, sreceived, sreport, sstage_s, state_copy_gbps = \
        stage_state(torch, mserver, mbatch, state_digest)
    torch.cuda.synchronize()
    paths["stage_state"] = build.launch_counts()
    state_bytes = sum(t.nbytes for t in sitems)
    records.append(emit(
        "stage_state", arch=mcfg.name, items=len(sitems),
        item_bytes=sitems[0].nbytes, state_bytes=state_bytes,
        wire_bytes=sreport.bytes, ratio=state_bytes / sreport.bytes,
        stage_s=sstage_s, state_gbps=state_bytes * 8 / sstage_s / 1e9,
        pageable_copy_gbps=state_copy_gbps,
        planned_digest_bytes_per_s=state_digest,
        digest_folds=sreport.checksum_folds,
        launches=paths["stage_state"]))
    need(paths, "stage_state", ("ssd_scan", "quantize_int8", "digest_items"))
    once_per_fold(paths, "stage_state", sreport)

    from repro_torch.core.integrity import decompress_transform
    build.reset_launches()
    t0 = time.monotonic()
    restored = torch.stack(
        decompress_transform(device="cuda").many(sreceived))
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    paths["restore"] = build.launch_counts()
    records.append(emit("restore", arch=mcfg.name, items=len(sreceived),
                        seconds=restore_s,
                        state_gbps=state_bytes * 8 / restore_s / 1e9,
                        launches=paths["restore"]))
    need(paths, "restore", ("dequantize_int8",))

    mcorrect = check_mamba_correct(torch, mserver, mbatch, mtokens, cache,
                                   sitems, sreceived, sreport, restored)
    records.append(mcorrect)
    if not all(mcorrect[k] for k in (
            "logits_ok", "tokens_ok", "greedy_ok", "codes_ok", "restore_ok",
            "digest_ok", "restored_ok")):
        fail(f"the SSM path's output is wrong: {json.dumps(mcorrect)}")
    records.append(emit("phase_time", of="mamba",
                        seconds=time.monotonic() - t_phase))
    del mserver, cache, sitems, sreceived, restored
    torch.cuda.empty_cache()

    # ---- smollm-360m: train, checkpoint, fail, restore ------------------
    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train = train_phase(torch, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    paths["train"] = train["launches"]
    records.append(emit("train", nvidia_smi=smi, **train))
    if not all(train[k] for k in ("losses_ok", "restore_ok", "verify_ok",
                                   "load_back_ok", "no_kernel_ok")):
        fail("the training path's checks failed: "
             + json.dumps({k: v for k, v in train.items()
                           if k.endswith("_ok")}))
    records.append(emit("phase_time", of="train",
                        seconds=time.monotonic() - t_phase))

    kernels = []
    for name, rec in main_shapes.items():
        k = build.KERNELS[name]
        # block_digest, the TPU kernel's per-row function, is checked above
        # but no path runs it: the digest path runs digest_items
        launches = sum(c[name] for c in paths.values())
        if launches == 0 and name != "block_digest":
            fail(f"no path launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "call_ms": rec["call_ms"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"records": records, "kernels": kernels,
                       "paths": paths}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_timing(torch, server, batch, prompt) -> dict:
    """A warm-up request, then prefill ms (eager), decode ms/token (eager,
    and as device time from a CUDA graph replay of the same step: what the
    card itself spends per token) and a profiler trace of one prefill and
    one decode step."""
    server.generate(batch, 4)                              # warm-up request
    prefill_ms = call_ms(lambda: server.prefill(batch), iters=5, warmup=1)
    _, cache = server.prefill(batch)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")

    def one_step():
        cache["pos"] = prompt
        server.decode(cache, tok)
    decode_ms = call_ms(one_step, iters=10, warmup=2)
    decode_device_ms = device_ms(one_step, iters=5)
    trace = {"prefill": device_busy(lambda: server.prefill(batch)),
             "decode_step": device_busy(one_step)}
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
                decode_device_ms_per_token=decode_device_ms, trace=trace)


def once_per_fold(paths: dict, path: str, report) -> None:
    """Fail unless the path's digest launches equal the folds its transfer
    made: one launch per item or slab the mover handed over."""
    got = paths[path]["digest_items"]
    if got != report.checksum_folds:
        fail(f"the {path} path launched the digest {got} times for "
             f"{report.checksum_folds} items or slabs handed over")


def need(paths: dict, path: str, names) -> None:
    """Fail unless every kernel in ``names`` launched on ``path``."""
    idle = [n for n in names if paths[path][n] == 0]
    if idle:
        fail(f"the {path} path never launched {idle}")


if __name__ == "__main__":
    sys.exit(main())
