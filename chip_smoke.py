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
   The int8 pair is checked one item a call (1,000,003 values, a mamba2
   and a zamba2 state item, ``compressed_psum``'s 16 Mi values) and as
   slabs (mamba2's 48 state items, 384 MiB, and zamba2's 38, 76 MiB, one
   ``quantize_items`` / ``dequantize_items`` call each), every slab record
   with its launches, its bound and ``singles_ms``, the same items by
   single-item calls.
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
9. ``gemma3`` (gemma3-1b): the kernels at the phase's shapes first (flash
   B4 Hq4 Hkv1 S1024 hd 256 at windows 512 and 0; decode against the
   1057-slot cache at both), then ``Server`` at full width (26 layers, hd
   256, q_dim 1024 against d_model 1152, 5:1 local:global) serves 4 x
   1024-token prompts (past the 512 window) for 32 tokens; flash launches
   once per layer per prefill, decode once per layer per step; logits
   against the plain path as in 5.
10. ``zamba2`` (zamba2-1.2b): the kernels at the phase's shapes (flash B2
   Hq32 S4608 hd 64 at window 4096; decode over the 4096-slot ring, every
   slot filled as a ring is; SSD B2 H64 S4608 P64 N64; quantize at one
   state item; the digest of one shared K item and one wire item, the
   plans' rates), then the hybrid at full width (38 Mamba2 layers, the
   shared block at 7 sites) serves 2 x 4608-token prompts (18 SSD chunks,
   past the ring) for 32 tokens: SSD once per layer, flash once per site
   per prefill, decode once per site per step.  Its decode cache is then
   staged as in 7 (38 f32 states over the int8 wire, restored onto the
   card) and its 14 shared K/V items as in 4 (the accel digest), and
   checked as in 8 (logits at the noise floor, codes bit-exact, both
   hexdigests, decoding from the restored state, shared K/V bytes).

10a. ``llava`` (llava-next-mistral-7b): the kernels at the phase's
   shapes (flash B4 Hq32 Hkv8 S1088 hd 128, causal, over the 576 stub
   patch positions and the 512-token prompt; decode against the 1121-slot
   cache; the digest of one KV item), then ``Server`` at full width (32
   layers, d_model 4096, 7.27 B parameters, nothing cut) serves 4 requests
   of 576 stub patch embeddings and 512 tokens for 32 tokens: flash once
   per layer per prefill, decode once per layer per step; logits against
   the plain path as in 5, and the prefill's 64 KV items staged under
   the accel digest as in 4.
10b. ``seamless`` (seamless-m4t-large-v2): the kernels at the phase's
   shapes (flash B4 Hq16 Hkv16 S1024 hd 64 without the causal mask;
   decode against the 1057-slot self cache filled to 17, and as cross
   attention over 1024 encoder slots, every slot kept, held to the plain
   non-causal attention; the digest of one cross K item), then ``Server``
   at full width (24 + 24 layers, d_model 1024, 2.04 B parameters)
   serves 4 requests of 1024 stub frames for 32 tokens: flash once per
   encoder layer per prefill, decode twice per decoder layer per step
   (self and cross; the prefill decodes the first decoder token, as the
   reference does); the encoder states and the logits against the plain
   path, and the 48 cross K/V items staged under the accel digest.  Then
   one ``check`` of ``error_feedback_step`` on a gradient list shaped as
   smollm-360m's parameters, through the quantize and dequantize kernels,
   against its plain version on the card, bit for bit over two steps.

11. ``train`` (smollm-360m): ``Trainer(get_config("smollm-360m"),
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

12. ``resume``: the trainer's state left on the card (bf16 params, f32
   master, m and v: one item per leaf and per layer of a ``Stacked`` leaf,
   in ``tree.py``'s order) to host memory by a ``bulk_transfer`` planned on
   ``card_host_basin`` at the measured pageable copy rate with the host
   checksum (the ledger's identities are host SHA-256, so no digest
   kernel): (a) unbroken, hexdigest H; (b) with a ``TransferLedger`` on a
   JSONL file and a sink that fails at delivery k = half the items, so the
   mover raises; (c) a fresh mover and ledger reopened from the file,
   resuming; (d) a last resume.  It fails unless (c)'s hexdigest is H, the
   SHA-256 multiset delivered over (b) and (c) is the source's with each
   item once, (c) skipped exactly the records (b) left, (d) moved nothing,
   and the host bytes equal the card's.  Seconds and GB/s per run, bytes
   skipped, and the time (c) spent hashing the items it skipped (each read
   across PCIe again: the identity is the content).
13. ``fleet``: a ``FleetArbiter`` over ``card_host_basin``.  ``state``
   (bulk: mamba's 48 state items over the int8 wire, accel checksum) is
   admitted first; at a quarter of its items ``kv`` (interactive: smollm's
   64 KV items, accel checksum) is admitted and runs on its own thread,
   and ``late`` (priority: the KV items again) asks for half the line, more
   than the fleet has left, queues, and runs on its own thread once a
   release promotes it.  It fails unless the statuses are admitted,
   admitted, queued, admitted; every grant snapshot conserves every
   element's rate; ``state`` counts a replan (the re-grant resizes its
   worker pool in place); each hexdigest equals the plain digest of what
   arrived; the digest launched once per item or slab handed over and
   quantize once per state item; and no grant is left.  Per member its
   time-averaged grant, measured rate, fidelity gap and replans (nothing on
   this basin paces a member to its grant: it has no windowed link).
14. ``codesign``: ``predict`` for phase 11's step (8 x 512 tokens, remat
   full, one card) on ``H100_SXM``, and ``roofline`` of one train step
   counted with ``count_step`` on the card, beside the measured median
   step and their ratios.  It fails unless the plan fits (the measured
   peak too) and the counted FLOPs reach 6 N T.
14a. ``phi3``, ``mistral_large`` and ``mixtral`` (``LARGE_CELLS``), at
   published widths, once the trainer is freed: each checks that the
   card holds under ``RESIDENT_LIMIT_MIB`` at its start, then its kernels at the phase's shapes (flash
   over the prompt with the config's window; decode against the phase's
   cache filled to prompt + 16; the digest of one KV item), serves
   ``batch`` x ``prompt`` tokens for 32 tokens (flash once per layer per
   prefill, decode once per layer per step), holds the logits to the
   plain path and stages the prefill's KV items under the accel digest,
   as in 10a.  phi3-mini-3.8b whole (32 layers, hd 96: the kernels'
   first head dim that is not a multiple of 64), 4 x 1024 tokens, 1057
   slots; mistral-large-123b at 20 of its 88 layers (96 query heads over
   8 KV heads, a grouping of 12; 57.0 GB of weights), 4 x 1024 tokens;
   mixtral-8x22b at 10 of its 56 layers (8 experts of d_ff 16384, top 2,
   window 4096; 50.9 GB), 2 x 4608 tokens past the window into a
   4096-slot ring that wraps, with one MoE layer's ``moe_dispatch``
   against ``moe_ref`` on its 9216 prompt tokens and the logits held
   under the kernel path's expert choices (``check_moe_logits``).  The
   serve record names the cut (``reduced``).
15. ``qwen3_moe`` (qwen3-moe-30b-a3b), last, once every earlier phase's
   tensors are freed: the kernels at the phase's shapes (flash B4 Hq32
   Hkv4 S512 hd 128, causal; decode against the 545-slot cache filled to
   528; the digest of one 2,232,320-byte KV item), then ``Server`` at full
   width (48 MoE layers of 128 experts, top 8; 61 GB of weights from a
   seed) and one layer's ``moe_dispatch`` against ``moe_ref`` on the same
   2048 tokens (routing identical, y within ``MOE_TOL``); the server
   serves 4 x 512-token prompts for 32 tokens (flash once per layer per
   prefill, decode once per layer per step), with host syncs per decode
   step and peak memory (under 80 GB); the logits and routing against the
   plain path (``check_moe_logits``: routing disagreements counted, the
   logits held under the kernel path's routing, near-ties checked layer
   by layer); and the prefill's 96 KV items staged under the accel
   digest, as in 4.
16. ``mesh``, last: NCCL at a world of one (an ``all_reduce`` and an
   ``all_to_all_single`` on the card); the kernels at the per-rank shapes
   (flash phi3 B4 Hq8 Hkv8 S1024 hd 96, mixtral B2 Hq12 Hkv2 S4608 at
   window 4096, llava B4 Hq8 Hkv2 S1088 hd 128, a mistral-large stage B1
   Hq96 Hkv8 S1024, seamless's encoder B4 Hq4 Hkv4 S1024 hd 64 without
   the causal mask, zamba2's shared block B2 Hq8 Hkv8 S4608 at window
   4096; decode phi3 8/8 over 1057 slots, mixtral 12/2 over the wrapped
   4096-slot ring, llava 8/2 over 1121 slots, seamless 4/4 over its 1057
   self slots and as cross attention over 1024 encoder slots, zamba2 8/8
   over its wrapped 4096-slot ring; the SSD scan at mamba2's B4 H16 S512
   N128 and zamba2's B2 H16 S4608 N64; the digest of one rank's KV item;
   quantize and dequantize at 64 MiB; flash at a rank's block of query
   rows, ``FLASH_OFFSET_ROWS``: smollm's B4 Hq15 Hkv5 Sq128 of Sk512 at
   offsets 0, 128, 256, 384, gemma3's local hd-256 block Sq256 of Sk1024
   at 768, window 512, and the f32 kernel at smollm's shape, each also
   held to the unsplit launch's rows, bit for bit at a tile-aligned
   offset, its library time SDPA under an explicit mask); then
   four ranks spawned once (``MeshWorld``), sharing the card over gloo,
   each single-threaded with a 60 s collective timeout (a rank that
   raises, hangs or exits non-zero fails the run with its traceback).
   This process loads each model once from ``SEED``; the ranks view its
   tensors by CUDA IPC (``weights.shard_params``).  Parts:
   ``compressed_psum`` over the 4 ranks on 64 MiB of f32 each (the
   quantize and dequantize kernels twice a rank; within 5% of the exact
   sum; bit-equal to the same exchange on the CPU) and
   ``hierarchical_psum`` on (2, 2), plain and compressed; phi3-mini at TP
   4 (mesh (1, 4)): ``Server(cfg, mesh).generate`` (rank 0 streams
   through the mover), then the logits over 4 x 1024 tokens and 8
   teacher-forced steps held to this process's kernel path within
   ``LOGIT_SHARE``, and that path to the plain path; rank 0 stages its
   prefill's KV items under the accel digest; mixtral at EP 4 (10 of 56
   layers, 2 x 4608 tokens, ``moe_ep`` at capacity 1.25): the logits held
   to this process's run under the ranks' expert choices and kept pairs,
   the share of dropped pairs, and one MoE layer through ``moe_ep`` and
   ``moe_tp`` against ``moe_dispatch`` on the same 9216 tokens, each path
   also entered from every rank's chunk of the 2 x 4608 sequence
   (``blocks.ffn_apply(..., sp=True)``) and held to the unsplit call's
   rows and kept pairs; then mixtral again with and without Megatron
   sequence parallelism, a prefill and ``MESH_SP_STEPS`` teacher-forced
   steps, the split run under the unsplit run's expert choices, its
   logits within ``LOGIT_SHARE`` of the unsplit ranks' and its dropped
   pairs equal to theirs;
   mistral-large through ``pipeline_forward`` (4 stages of 2 layers, 8 of
   88, 4 microbatches of 1 x 1024) held to the same 8 layers run straight
   through; llava-next-mistral-7b at TP 4 (``MESH_LLAVA``: 4 x (576 stub
   patches + 512 tokens), a 1121-slot cache) served and held as phi3 is,
   without the staging; seamless-m4t-large-v2, mamba2-1.3b and
   zamba2-1.2b at TP 4, full width and depth (``MESH_FAMILY_SERVE``: 4 x
   1024 stub frames, 4 x 512 tokens, 2 x 4608 tokens; each rank its
   heads, a Mamba2 layer's head-wise share of the SSD heads, its caches
   and states of those heads) served and held as llava is; phi3 and
   mamba2 again under Megatron sequence parallelism
   (``Server(cfg, mesh, plan=CodesignPlan(sharding="tp",
   seq_parallel=True))``: each rank's chunk of the prompt between the
   layers), a prefill and ``MESH_SP_STEPS`` teacher-forced steps held to
   the same ranks' server without it (phi3 within ``LOGIT_SHARE``, mamba2
   within twice its bf16 noise floor), the prefill timed with its
   collectives by kind; smollm-360m at TP 4 (``MESH_SMOLLM``: 4 x 512
   tokens, 8 generated, full width and depth), whose 15 query heads
   divide no model axis: each rank computes every head for its block of
   the query rows (``ShardCtx.seq_parallel_attn``; flash at Sq 128 of Sk
   512 at offset 128 r on rank r, 128 launches a prefill), served and
   held as llava is and again with and without sequence parallelism, each
   rank's query rows (``blocks.query_rows``) checked in both; then
   smollm-360m trained at full width (``MESH_TRAIN``):
   ``Trainer(cfg, mesh)`` at (2, 2) under FSDP + TP on the train phase's
   8 x 512 batches, a checkpoint every 2 steps (rank 0 writes the
   gathered leaves; no save at the end of a run: one checkpoint a part,
   for the machine's 45 GiB disk budget), 3 steps with a failure
   injected before step 3 (every rank restores step 2), then the elastic
   restore of that checkpoint onto (4, 1) under FSDP and 1 more step on
   the batch the (2, 2) trainer's step 3 took, its loss and gradient norm
   held to that step's (``MESH_LOSS_RTOL``, ``MESH_NORM_RTOL``); its
   step-1 loss,
   gradient norm and each gradient leaf's norm held to a one-card step
   on the same weights and batch (``MESH_LOSS_RTOL``, ``MESH_NORM_RTOL``,
   ``MESH_LEAF_RTOL``), a one-card ``Trainer`` restoring the checkpoint
   with the manifest's hashes; per rank and step the wall ms and
   the share spent in collectives (all, FSDP's gathers and
   reduce-scatters, the MoE's all-to-alls), each save and restore, the
   peak memory; no kernel launches.  Then llava trained at published
   widths, 4 of 32 layers (``MESH_VLM_TRAIN``): ``make_train_step`` at
   (2, 2) under FSDP + TP for 2 steps on 8 rows of 576 stub patches + 512
   scored text tokens, step 1 held to a one-card step as above;
   seamless (4 + 4 of 24 + 24 layers, (2, 2) FSDP + TP, its vocab split
   over 2), mamba2 (8 of 48 layers, (2, 2) FSDP + TP) and zamba2 (12 of
   38 layers, 2 sites, (1, 4) TP) trained the same way on 8 x 512
   (``MESH_FAMILY_TRAIN``: no checkpoint); smollm-360m again at (2, 2)
   under ``CodesignPlan(sharding="fsdp_tp", seq_parallel=True)``
   (``MESH_SP_TRAIN``: 2 steps, no checkpoint), its step 1 held to the
   (2, 2) trainer's step 1 without the split (``MESH_LOSS_RTOL``,
   ``MESH_NORM_RTOL``, ``MESH_LEAF_RTOL``), and the values the
   checkpointed layer bodies keep for the backward pass at step 1
   (``lm.kept_values``, a ``saved_tensors_hooks`` count) in both: the
   layer inputs, 4 x 512 x 960 x 32 without the split, exactly half with
   it; both smollm trainers split the query rows of attention (256 of
   512 a rank, checked from ``blocks.query_rows`` at step 1); and last
   qwen3-moe-30b-a3b trained at published widths, 2 of 48 layers
   (``MESH_MOE_TRAIN``; it fails first unless the disk holds twice its
   26 GB state): ``Trainer(cfg, mesh)`` at (2, 2) under FSDP + EP (64
   experts a rank) for 3 steps, a checkpoint at step 2, a failure before
   step 3 (every rank restores step 2), then the elastic restore onto
   (1, 4) (EP, 32 experts a rank) and 1 step, held to the (2, 2) step 3
   as smollm's is; step 1 held to a one-card step under the ranks' expert
   choices and kept pairs (``RouteLog(forced=...)``: the mesh drops pairs
   past an expert's capacity, the one-card oracle none), the share of
   dropped pairs recorded, and the share of the ranks' decisions the one
   card's own router makes on that batch bounded by
   ``MESH_ROUTE_AGREE`` in each layer; then qwen3-moe again at (2, 2)
   under ``CodesignPlan(sharding="fsdp_tp", seq_parallel=True)``
   (``MESH_MOE_SP_TRAIN``: 2 steps of the same batches, no checkpoint),
   its step 1 held to the unsplit trainer's step 1 as smollm's is, the
   share of the unsplit step's (token, expert) decisions it makes in
   each layer bounded by ``MESH_ROUTE_AGREE``, the kept values half the
   unsplit step's.  Every mesh time is labelled "4 ranks on one card
   over gloo: not a multi-card time".

The launch counts are set to 0 just before each path (the ten ``serve``
phases, each ``stage_state``, ``stage_kv`` and ``restore``, ``train``,
``resume``, ``fleet``, ``codesign``, and in each rank each mesh part, the
ranks' counts summed) and read just after; every kernel a serving path or
the fleet runs must have run there, and none may run in ``train`` or the
mesh's training.  Then
the kernels line (launches summed over the paths, each kernel's record at
the smollm / mamba shape and, under ``shapes``, at the gemma3, zamba2,
llava, seamless, phi3, mistral_large, mixtral, qwen3_moe and mesh
phases' shapes; ``block_digest``, the TPU kernel's per-row function, is
checked in phase 3 and runs on no path, so its count is 0), the card line
as ``nvidia-smi`` prints it, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before the result lines; without a card, or
without the repository's ``src/`` beside this file, it exits 2 and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
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
#: gemma3-1b: batch and prompt, past the local layers' 512-token window
GEMMA_BATCH, GEMMA_PROMPT = 4, 1024
#: zamba2-1.2b: batch and prompt, 18 SSD chunks, past the 4096-slot ring
ZAMBA_BATCH, ZAMBA_PROMPT = 2, 4608
#: qwen3-moe-30b-a3b: batch and prompt (a whole number of flash's 128-row
#: tiles), a 545-slot cache
QWEN_BATCH, QWEN_PROMPT = 4, 512
#: llava-next-mistral-7b: batch and text prompt; the prefill runs the 576
#: stub patch positions and the prompt, 1088 in all, into a 1121-slot cache
LLAVA_BATCH, LLAVA_PROMPT = 4, 512
#: seamless-m4t-large-v2: batch and stub frames per request (the encoder's
#: length); the decoder prompt has as many tokens, of which the prefill
#: reads the first, and the self cache frames + gen + 1 slots, as the CLI
#: draws and sizes them
SEAMLESS_BATCH, SEAMLESS_FRAMES = 4, 1024
#: the slice-11 cells, each at published widths: arch, batch, prompt, and
#: the depth run where the whole model does not fit one 80 GB card (None:
#: every layer).  phi3-mini (7.64 GB) whole, 4 x 1024 tokens into a
#: 1057-slot cache; mistral-large at 20 of 88 layers (57.0 GB with the
#: embeddings and head), 4 x 1024; mixtral at 10 of 56 layers (50.9 GB),
#: 2 x 4608 tokens, past its 4096 window, so the prefill ring-packs its
#: last 4096 steps and decode runs on a wrapped ring.  The depths leave
#: room for the plain path's check beside the weights.
LARGE_CELLS = {
    "phi3": dict(arch="phi3-mini-3.8b", batch=4, prompt=1024, layers=None),
    "mistral_large": dict(arch="mistral-large-123b", batch=4, prompt=1024,
                          layers=20),
    "mixtral": dict(arch="mixtral-8x22b", batch=2, prompt=4608, layers=10),
}
#: a phase's allocation at its start above this means an earlier phase
#: left tensors on the card
RESIDENT_LIMIT_MIB = 1024

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
# one MoE layer, moe_dispatch against moe_ref on the same input and the
# same routing: the two run g, u and each expert's down matmul as GEMMs of
# other shapes (bf16 out, f32 sums in another order), so g, u, h and an
# expert's output may each round an ulp apart; y is held to two bf16 ulps
# (rtol) above a floor of 4e-3 of its largest magnitude
MOE_TOL = dict(atol_share=4e-3, rtol=1.6e-2)
# qwen3's routing, kernel path against plain path: a decision that differs
# is a near-tie when the plain path's k-th and (k+1)-th router logits lie
# closer than this.  The router logits have unit scale (unit-rms inputs
# against f32 weights of std D^-1/2), so this is LOGIT_SHARE of their
# scale: the divergence between the two paths the logit check allows.
ROUTE_NEAR_TIE = LOGIT_SHARE
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


_SIDE_STREAM = []


def _side_stream():
    """The one side stream every :func:`device_ms` captures on.  cuBLAS
    keeps a workspace (32 MiB on the H100) for each stream it has run on,
    for the life of the process, and the allocator counts it: a new
    stream per timing left about 1 GiB allocated by the later phases."""
    import torch
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    return _SIDE_STREAM[0]


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph (on the side stream that ran the warm-up calls) and
    replayed between two CUDA events, so the host's launch cost is left
    out (inputs stay warm in L2 across the calls)."""
    import torch
    side = _side_stream()
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


def check_flash(torch, B, Hq, Hkv, S, hd, dtype, window, *, library=True,
                causal=True, q_offset=None, Sk=None):
    """Flash attention over ``S`` query rows against its plain version.
    With ``q_offset`` (a model rank's block of the query rows under the
    query-sequence split) the rows ``[q_offset, q_offset + S)`` of a
    sequence of ``Sk`` keys: held also to those rows of the unsplit
    launch on the same Q, K and V, bit for bit where the offset is a
    multiple of the kernels' 64-row tile (the same key tiles in the same
    order), and the library call given an explicit boolean mask
    (``is_causal`` aligns the diagonal top-left when Sq != Sk)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    import torch.nn.functional as F
    off = q_offset or 0
    Sk = Sk or S
    g = torch.Generator(device="cuda").manual_seed(S + hd + (
        Sk + off if q_offset is not None else 0))
    q_all = torch.randn(B, Hq, Sk if q_offset is not None else S, hd,
                        generator=g, device="cuda").to(dtype)
    q = q_all[:, :, off:off + S]
    k = torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, hd, generator=g, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=off)
    out = flash_attention_bhsd(q, k, v, **kw)
    expect = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - expect.float()).abs().max().item()
    tol = TOL[str(dtype).replace("torch.", "")]
    ok = bool(torch.allclose(out.float(), expect.float(), **tol))
    extra = {}
    if q_offset is not None:
        whole = flash_attention_bhsd(q_all, k, v, causal=causal,
                                     window=window)[:, :, off:off + S]
        same = bool(torch.equal(out, whole))
        extra = dict(q_offset=off, unsplit_rows_equal=same,
                     unsplit_rows_max_abs_err=(out.float() - whole.float()
                                               ).abs().max().item())
        ok = ok and (same or off % 64 != 0)
        del whole
    kernel = lambda: flash_attention_bhsd(q, k, v, **kw)
    ms, per_call = device_ms(kernel), call_ms(kernel)
    plain_ms = device_ms(lambda: ref.attention_ref(q, k, v, **kw), iters=5)
    lib_ms = None
    if library:
        if window or S != Sk:
            i = torch.arange(S, device="cuda") + off
            j = torch.arange(Sk, device="cuda")
            mask = torch.ones(S, Sk, dtype=torch.bool, device="cuda")
            if window:
                mask &= j[None, :] > i[:, None] - window
            if causal:
                mask &= j[None, :] <= i[:, None]
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        lib_ms = device_ms(lib)
    esize = q.element_size()
    nbytes = (2 * B * Hq * S * hd + 2 * B * Hkv * Sk * hd) * esize
    pairs = sum((off + i + 1 if causal else Sk) - (
        max(0, off + i - window + 1) if window else 0) for i in range(S))
    ops = 4.0 * hd * B * Hq * pairs
    bms, by = bound_ms(nbytes, ops, PEAK_BF16 if dtype == torch.bfloat16
                       else PEAK_F32)
    shape = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, hd=hd)
    if q_offset is not None:
        shape.update(Sk=Sk, q_offset=off)
    return emit("check", kernel="flash_attention", shape=shape,
                window=window, causal=causal,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                tol=tol, ok=ok, ms=ms, call_ms=per_call, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by, **extra)


def check_decode(torch, B, Hq, Hkv, S, hd, dtype, fill, window, ring,
                 wrapped=False, cross=False):
    """``ring`` permutes the slots; ``wrapped`` fills every slot as a ring
    cache does after step ``fill`` (slot j holds the last position p <=
    fill with p % S == j); ``cross`` is the enc-dec's cross attention: the
    kernel at ``k_pos = 0..S-1`` and ``q_pos = fill = S - 1`` (every slot
    kept), held to the plain non-causal attention of one query over the S
    slots, which knows no positions."""
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
    if wrapped:
        k_pos = (fill - torch.remainder(fill - pos, S)).contiguous()
    if ring:   # slots in a permuted order: only k_pos may be trusted
        perm = torch.randperm(S, generator=g, device="cuda")
        k, v, k_pos = k[:, :, perm], v[:, :, perm], k_pos[:, perm].contiguous()
    q_pos = torch.full((B,), fill, dtype=torch.int32, device="cuda")
    out = decode_attention_bhd(q, k, v, k_pos, q_pos, window=window)
    if cross:
        if fill != S - 1 or window or ring or wrapped:
            fail("a cross-attention check keeps every slot: fill = S - 1")
        plain = lambda: ref.attention_ref(q[:, :, None], k, v,
                                          causal=False)[:, :, 0]
    else:
        plain = lambda: ref.decode_attention_ref(q, k, v, k_pos, q_pos,
                                                 window=window)
    expect = plain()
    torch.cuda.synchronize()
    err = (out.float() - expect.float()).abs().max().item()
    tol = TOL[str(dtype).replace("torch.", "")]
    ok = bool(torch.allclose(out.float(), expect.float(), **tol))
    kernel = lambda: decode_attention_bhd(q, k, v, k_pos, q_pos,
                                          window=window)
    ms, per_call = device_ms(kernel), call_ms(kernel)
    plain_ms = device_ms(plain, iters=10)
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
                window=window, ring=ring, wrapped=wrapped, cross=cross,
                chunk=chunk,
                n_split=n_split,
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


def check_ssd(torch, B, H, G, S, chunk=256, N=128):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsd
    x, dt, A, Bm, Cm = _ssd_inputs(torch, B, H, G, S, N=N, seed=S + G)
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


def check_quantize_slab(torch, label, count, shape):
    """One ``quantize_items`` and one ``dequantize_items`` call over
    ``count`` state items of ``shape`` (a staging's items as one slab)
    against the plain versions, bit for bit; returns the two records.  Each
    has its launches a call (one), device ms beside its bound (the items'
    bytes in and out at the memory rate, summed) and ``singles_ms``: the
    same items by ``count`` single-item calls, timed the same way.  The
    slabs outgrow the 50 MB L2, so the repeated calls find them cold."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.quantize import (dequantize_int8,
                                              dequantize_items,
                                              quantize_int8, quantize_items)
    n = math.prod(shape)
    xs = [_quant_values(torch, n, 1000 + i).reshape(shape)
          for i in range(count)]
    n0 = build.launch_counts()
    wire = quantize_items(xs)
    n1 = build.launch_counts()
    slab = [(q, s, shape) for q, s in wire]
    backs = dequantize_items(slab)
    n2 = build.launch_counts()
    launches = {"quantize_int8": n1["quantize_int8"] - n0["quantize_int8"],
                "dequantize_int8": n2["dequantize_int8"]
                - n1["dequantize_int8"]}
    qbad = dbad = 0
    for x, (q, s), back in zip(xs, wire, backs):
        rq, rs = ref.quantize_int8_ref(x)
        qbad += _bits_differ(torch, q, rq) + _bits_differ(torch, s, rs)
        dbad += _bits_differ(torch, back,
                             ref.dequantize_int8_ref(q, s, shape))
    del backs
    nb = wire[0][0].shape[0]
    nbytes = count * (n * 4 + nb * 256 + nb * 4)
    recs = []
    for name, bad, kernel, singles, plain, ops in (
            ("quantize_int8", qbad, lambda: quantize_items(xs),
             lambda: [quantize_int8(x) for x in xs],
             lambda: ref.quantize_items_ref(xs), 5.0 * n * count),
            ("dequantize_int8", dbad, lambda: dequantize_items(slab),
             lambda: [dequantize_int8(q, s, shape) for q, s, _ in slab],
             lambda: ref.dequantize_items_ref(slab), 1.0 * n * count)):
        bms, by = bound_ms(nbytes, ops, PEAK_F32)
        ms = device_ms(kernel, iters=10)
        recs.append(emit(
            "check", kernel=name, of=label, items=count, shape=list(shape),
            values=n * count, bytes=nbytes,
            launches_per_call=launches[name], mismatches=bad,
            max_abs_err=float(bad), tol="bit-exact",
            ok=bad == 0 and launches[name] == 1, ms=ms,
            call_ms=call_ms(kernel, iters=10),
            singles_ms=device_ms(singles, iters=3),
            plain_ms=device_ms(plain, iters=2), library_ms=None,
            bound_ms=bms, bound_by=by, share_of_bound=bms / ms))
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


def _on_card(torch, batch) -> dict:
    """A request's inputs on the card: its tokens and, where the model
    takes them, its stub ``extra_embeds`` (a VLM) or ``frames`` (the
    enc-dec)."""
    return {n: torch.as_tensor(batch[n], device="cuda")
            for n in ("tokens", "extra_embeds", "frames") if n in batch}


def _teacher_forced(torch, api, params, ctx, inputs, forced, max_len):
    """Prefill logits and 4 decode steps teacher-forced with ``forced``."""
    logits, cache = api.prefill(params, inputs, ctx, max_len)
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
    inputs = _on_card(torch, batch)
    forced = torch.as_tensor(tokens, device="cuda")
    ref_ctx = ShardCtx(impl="ref")
    run = lambda p, ctx: _teacher_forced(torch, api, p, ctx, inputs, forced,
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
    shape_ok = (tokens.shape == (len(batch["tokens"]), GEN)
                and tokens.dtype.kind == "i"
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
    fields = check_logits(torch, server, batch, tokens)
    return emit("correct", arch=server.cfg.name, **fields,
                **kv_staged_ok(items, received, report))


def kv_staged_ok(items, received, report) -> dict:
    """A KV staging's hexdigest against the plain digest of the bytes that
    arrived on the host, and those bytes against the card's items."""
    from repro_torch.core.integrity import StreamDigest
    plain = StreamDigest(True, "accel", backend="ref", device="cpu")
    plain.add_many(received)
    bytes_ok = (len(received) == len(items)
                and sorted(_sha(t) for t in received)
                == sorted(_sha(t.cpu()) for t in items))
    return dict(accel_hexdigest=report.checksum,
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
    # decode writes its cache in place: each run gets its own copy (the
    # hybrid's shared K/V included)
    kv = {n: cache[n] for n in ("shared_k", "shared_v") if n in cache}
    orig = {"pos": cache["pos"], "mamba": MambaState(mamba.conv.clone(),
                                                     mamba.ssm.clone()),
            **{n: t.clone() for n, t in kv.items()}}
    back = {"pos": cache["pos"], "mamba": MambaState(mamba.conv.clone(),
                                                     restored),
            **{n: t.clone() for n, t in kv.items()}}
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
# phase 11: training at full width, with checkpoints, a failure and a restore
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


def train_phase(torch, cfg, root) -> tuple:
    """Train ``cfg`` on the card through ``Trainer.run`` with checkpoints
    into ``root`` and one injected failure; returns the phase's record,
    checks included (``*_ok``), the trainer (its state stays on the card
    for the later phases) and its token source.  The launch counts are set
    to 0 just before the run."""
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
    return ({
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
    }, trainer, source)


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


# ---------------------------------------------------------------------------
# phase 12: a resumed transfer of the training state
# ---------------------------------------------------------------------------


class InjectedFailure(RuntimeError):
    """The failure the ``resume`` phase injects into its sink."""


def _state_items(trainer) -> list:
    """The trainer's state on the card, one item per leaf and per layer of
    a ``Stacked`` leaf, in the order ``tree.py`` walks them."""
    from repro_torch.tree import Stacked, flatten_with_paths
    return [t for _, leaf in flatten_with_paths(trainer.state_tree())
            for t in (leaf if isinstance(leaf, Stacked) else (leaf,))]


def resume_phase(torch, trainer, root) -> dict:
    """The training state to host memory by ``bulk_transfer`` under the host
    checksum, planned on ``card_host_basin`` at the measured pageable copy
    rate: (a) unbroken; (b) with a ``TransferLedger`` on a JSONL file and a
    sink that fails at delivery k = half the items (the mover raises); (c) a
    fresh mover and ledger reopened from the file, resuming; (d) one more
    resume, which moves nothing.  Returns the record, checks included."""
    import collections
    from repro_torch.core.basin import card_host_basin
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover
    from repro_torch.core.planner import plan_transfer
    from repro_torch.core.resume import TransferLedger

    items = _state_items(trainer)
    nbytes = sum(t.nbytes for t in items)
    k = len(items) // 2
    copy_gbps = pageable_gbps(torch, max(items, key=lambda t: t.nbytes))
    plan = plan_transfer(card_host_basin(pageable_gbps=copy_gbps),
                         item_bytes=nbytes / len(items), stages=("d2h",),
                         checksum=True, checksum_placement="host",
                         ordered=True)
    path = os.path.join(root, "resume_ledger.jsonl")
    pulls: list = []

    def source():
        # the time of every pull: a resume hashes each item it skips
        # between two pulls
        for t in items:
            pulls.append(time.monotonic())
            yield t

    def run(sink, ledger=None):
        pulls.clear()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rep = UnifiedDataMover(MoverConfig(checksum=True),
                               plan=plan).bulk_transfer(
            source(), sink, plan=plan,
            transforms=[("d2h", lambda t: t.cpu())], resume=ledger)
        return rep, time.monotonic() - t0

    def rate(moved, sec):
        return {"seconds": sec, "bytes": moved, "gb_per_s": moved / sec / 1e9}

    runs = {}
    count = [0]
    rep_a, sec = run(lambda t: count.__setitem__(0, count[0] + 1))
    runs["a"] = dict(rate(nbytes, sec), items=rep_a.items)

    got_b, got_c = [], []

    def dying(t):
        if len(got_b) >= k:
            raise InjectedFailure(f"injected failure at delivery {k}")
        got_b.append(t)

    ledger_b = TransferLedger(path)
    t0 = time.monotonic()
    try:
        run(dying, ledger_b)
        b_raised = False
    except InjectedFailure:
        b_raised = True
    ledger_b.close()
    left = TransferLedger(path)
    records_left = left.items_recorded
    left.close()
    runs["b"] = dict(rate(sum(t.nbytes for t in got_b),
                          time.monotonic() - t0), items=len(got_b),
                     raised=b_raised, records_left=records_left)

    ledger_c = TransferLedger(path)
    rep_c, sec = run(got_c.append, ledger_c)
    skip_hash_s = pulls[k] - pulls[0] if len(pulls) > k else None
    ledger_c.close()
    runs["c"] = dict(rate(nbytes - ledger_c.skipped_bytes, sec),
                     items=rep_c.items, skipped_items=ledger_c.skipped_items,
                     skipped_bytes=ledger_c.skipped_bytes,
                     skip_hash_s=skip_hash_s,
                     skip_hash_gb_per_s=ledger_c.skipped_bytes / skip_hash_s
                     / 1e9 if skip_hash_s else None)

    ledger_d = TransferLedger(path)
    rep_d, sec = run(lambda t: None, ledger_d)
    ledger_d.close()
    runs["d"] = dict(seconds=sec, items=rep_d.items,
                     skipped_items=ledger_d.skipped_items)

    want = collections.Counter(TransferLedger.item_key(t) for t in items)
    delivered = got_b + got_c
    got = collections.Counter(TransferLedger.item_key(t) for t in delivered)
    bytes_ok = len(delivered) == len(items) and all(
        h.device.type == "cpu" and _bits_equal(torch, h.to("cuda"), c)
        for h, c in zip(delivered, items))
    return {
        "items": len(items), "bytes": nbytes, "k": k,
        "distinct_items": len(want), "pageable_copy_gbps": copy_gbps,
        "plan": plan.describe(), "runs": runs,
        "hexdigest": rep_a.checksum, "resumed_hexdigest": rep_c.checksum,
        "digest_ok": rep_a.checksum is not None
        and rep_c.checksum == rep_a.checksum,
        "exact_ok": got == want and sum(got.values()) == len(items),
        "skip_ok": b_raised and ledger_c.skipped_items == records_left == k,
        "noop_ok": rep_d.items == 0 and ledger_d.skipped_items == len(items)
        and rep_d.checksum == rep_a.checksum,
        "bytes_ok": bytes_ok,
    }


# ---------------------------------------------------------------------------
# phase 13: three transfers under one fleet arbiter
# ---------------------------------------------------------------------------


class _GrantLog:
    """The arbiter's telemetry: every grant snapshot it publishes (on each
    admission, release and promotion), with its fairness index."""

    def __init__(self):
        self.arbiter = None
        self.snaps: list = []

    def record_fleet(self, stats: dict) -> None:
        self.snaps.append({"grants": self.arbiter.grants(),
                           "live": stats["live"], "queued": stats["queued"],
                           "fairness": stats["fairness_index"]})


def fleet_phase(torch, kv_items, state_items, kv_digest, state_digest
                ) -> dict:
    """A ``FleetArbiter`` over ``card_host_basin`` at the measured pageable
    copy rate.  ``state`` (bulk): mamba's SSM state over the int8 wire with
    an accel checksum, admitted first.  When a quarter of its items have
    arrived, ``kv`` (interactive: smollm's KV items, accel checksum) is
    admitted and runs on its own thread, and ``late`` (priority: the KV
    items again) asks for half the line, more than the fleet has left, so
    it queues; promoted when a peer releases, it runs on a thread of its
    own.  Returns the record, checks included."""
    import threading
    from repro_torch.core.basin import card_host_basin
    from repro_torch.core.fleet import FleetArbiter
    from repro_torch.core.integrity import StreamDigest, compress_transform
    from repro_torch.core.mover import MoverConfig, UnifiedDataMover

    copy_gbps = pageable_gbps(torch, state_items[0])
    basin = card_host_basin(pageable_gbps=copy_gbps)
    log = _GrantLog()
    arb = FleetArbiter(basin, telemetry=log)
    log.arbiter = arb
    line = basin.achievable_throughput()
    accel = dict(checksum=True, checksum_placement="accel")
    kv_ask = dict(stages=("kv-stage",), accel_digest_bytes_per_s=kv_digest,
                  **accel)
    adm = {"state": arb.admit("state", state_items[0].nbytes, qos="bulk",
                              stages=("state-stage",),
                              accel_digest_bytes_per_s=state_digest,
                              **accel)}
    statuses = [adm["state"].status]
    got = {"state": [], "kv": [], "late": []}
    reports, errors, started = {}, {}, threading.Event()

    def sink_state(t):
        got["state"].append((t[0].cpu(), t[1].cpu(), t[2]))
        if len(got["state"]) == len(state_items) // 4:
            adm["kv"] = arb.admit("kv", kv_items[0].nbytes,
                                  qos="interactive", **kv_ask)
            adm["late"] = arb.admit("late", kv_items[0].nbytes,
                                    qos="priority",
                                    min_bytes_per_s=0.5 * line, **kv_ask)
            statuses.extend([adm["kv"].status, adm["late"].status])
            started.set()

    def transfer(name, items, sink, **kw):
        t0 = time.monotonic()
        rep = UnifiedDataMover(MoverConfig(checksum=True)).bulk_transfer(
            iter(items), sink, fleet=adm[name], **kw)
        reports[name] = (rep, time.monotonic() - t0)

    def thread(name, wait_promotion):
        try:
            if not started.wait(timeout=300):
                raise RuntimeError(f"{name}: state never reached a quarter")
            if wait_promotion:
                deadline = time.monotonic() + 300
                while adm[name].status != "admitted":
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{name} was never promoted")
                    time.sleep(0.001)
                statuses.append(adm[name].status)
            transfer(name, kv_items, lambda t: got[name].append(t.cpu()))
        except BaseException as e:          # re-raised on the main thread
            errors[name] = e

    from repro_torch.kernels import build
    build.reset_launches()
    threads = [threading.Thread(target=thread, args=("kv", False)),
               threading.Thread(target=thread, args=("late", True))]
    for th in threads:
        th.start()
    t0 = time.monotonic()
    try:
        transfer("state", state_items, sink_state,
                 transforms=[("compress", compress_transform())])
    finally:
        started.set()
        for th in threads:
            th.join(timeout=600)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = build.launch_counts()
    for e in errors.values():
        raise e
    if any(th.is_alive() for th in threads):
        fail("a fleet member's thread did not finish")

    members, digests_ok = {}, True
    for name, (rep, sec) in reports.items():
        plain = StreamDigest(True, "accel", backend="ref")
        plain.add_many(got[name])
        ok = rep.checksum is not None and rep.checksum == plain.hexdigest()
        digests_ok &= ok
        source_bytes = sum(t.nbytes for t in (
            state_items if name == "state" else kv_items))
        members[name] = {
            "qos": adm[name].qos, "items": rep.items, "seconds": sec,
            "mean_granted_bytes_per_s": rep.planned_bytes_per_s,
            "measured_bytes_per_s": rep.throughput_bytes_per_s,
            "measured_over_granted": rep.throughput_bytes_per_s
            / rep.planned_bytes_per_s,
            "source_bytes_per_s": source_bytes / rep.elapsed_s,
            "fidelity_gap": rep.fidelity_gap, "replans": rep.replans,
            "checksum_folds": rep.checksum_folds, "digest_ok": ok}
    rates = ([t.bandwidth_bytes_per_s for t in basin.tiers]
             + [l.bandwidth_bytes_per_s for l in basin.links
                if l.bandwidth_bytes_per_s])
    # every member plans over the whole (linear) basin, so each element
    # carries the sum of all grants
    conserved = all(sum(s["grants"].values()) <= r * (1 + 1e-9)
                    for s in log.snaps for r in rates)
    folds = sum(m["checksum_folds"] for m in members.values())
    return {
        "pageable_copy_gbps": copy_gbps, "line_bytes_per_s": line,
        "late_min_bytes_per_s": 0.5 * line, "statuses": statuses,
        "members": members, "wall_s": wall_s,
        "grant_snapshots": log.snaps,
        "weighted_fairness": [s["fairness"] for s in log.snaps],
        "launches": launches,
        "admission_ok": statuses == ["admitted", "admitted", "queued",
                                     "admitted"],
        "conserved_ok": bool(log.snaps) and conserved,
        "rebalance_ok": members["state"]["replans"] >= 1,
        "digest_ok": digests_ok and len(members) == 3,
        "folds_ok": launches["digest_items"] == folds
        and launches["quantize_int8"] == len(state_items),
        "released_ok": arb.grants() == {},
    }


# ---------------------------------------------------------------------------
# phase 14: the co-design model's prediction beside the measured step
# ---------------------------------------------------------------------------


def codesign_phase(torch, cfg, trainer, source, train) -> dict:
    """The analytic prediction for smollm-360m's train step as phase 11 runs
    it (8 x 512 tokens, remat full, one card) on the H100's data sheet,
    the roofline of one step counted by ``count_step`` (run on the card:
    the trainer's state advances one step), and the measured step."""
    from repro_torch.core.codesign import (CodesignPlan, predict,
                                           workload_from_config)
    from repro_torch.core.fidelity import (H100_SXM, count_step,
                                           model_flops_dense, roofline)
    from repro_torch.kernels import build
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pred = predict(workload_from_config(cfg, TRAIN_BATCH, TRAIN_SEQ),
                   CodesignPlan(sharding="dp", microbatches=1,
                                remat=cfg.remat),
                   n_chips=1, dp=1, tp=1, hw=H100_SXM)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(iter(source)).items()}
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    (trainer.params, trainer.opt_state, _), cost = count_step(
        trainer.train_step, trainer.params, trainer.opt_state, batch)
    torch.cuda.synchronize()
    count_s = time.monotonic() - t0
    launches = build.launch_counts()
    # 6 N T over the parameters the trainer holds (the config's formula,
    # which ``predict`` reads, leaves out the final norm)
    model_flops = model_flops_dense(train["params"], tokens)
    roof = roofline(cost, hw=H100_SXM, model_flops=model_flops,
                    label=f"{cfg.name} train {TRAIN_BATCH}x{TRAIN_SEQ}")
    measured = train["step_ms_median"]
    top_bytes = sorted(cost.bytes_by_op.items(), key=lambda kv: -kv[1])[:8]
    return {
        "arch": cfg.name, "params": train["params"],
        "params_config": cfg.param_count(), "tokens": tokens,
        "hw": dataclasses.asdict(H100_SXM),
        "hbm_bytes_spec": H100_SXM.hbm_bytes,
        "hbm_bytes_card": torch.cuda.get_device_properties(0).total_memory,
        "predicted": {
            "plan": pred.plan.describe(), "t_compute_ms": pred.t_compute * 1e3,
            "t_memory_ms": pred.t_memory * 1e3,
            "t_collective_ms": pred.t_collective * 1e3,
            "step_ms": pred.step_time_s * 1e3, "dominant": pred.dominant,
            "hbm_bytes_needed": pred.hbm_bytes_needed, "fits": pred.fits},
        "counted": {
            "flops": cost.flops, "bytes": cost.bytes_accessed,
            "ops": cost.ops, "flops_by_op": cost.flops_by_op,
            "top_bytes_by_op": dict(top_bytes), "count_s": count_s},
        "roofline": {
            "t_compute_ms": roof.t_compute * 1e3,
            "t_memory_ms": roof.t_memory * 1e3,
            "step_ms": roof.step_time_s * 1e3, "dominant": roof.dominant,
            "roofline_fraction": roof.roofline_fraction,
            "useful_compute_fraction": roof.useful_compute_fraction,
            "fidelity_gap": roof.fidelity_gap},
        "model_flops": model_flops,
        "measured_step_ms_median": measured,
        "measured_over_predicted": measured / (pred.step_time_s * 1e3),
        "measured_over_roofline": measured / (roof.step_time_s * 1e3),
        "train_peak_gib": train["peak_mem_gib"], "launches": launches,
        "fits_ok": pred.fits
        and train["peak_mem_gib"] * 2**30 <= H100_SXM.hbm_bytes,
        "flops_ok": cost.flops >= model_flops,
    }


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
    # the int8 pair over whole stagings' state items, one slab a call
    zcfg = get_config("zamba2-1.2b")
    slabs = {}
    for label, count, shape in (
            ("mamba2 state slab", mcfg.n_layers,
             (BATCH, mcfg.ssm_heads, mcfg.ssm.head_dim, mcfg.ssm.d_state)),
            ("zamba2 state slab", zcfg.n_layers,
             (ZAMBA_BATCH, zcfg.ssm_heads, zcfg.ssm.head_dim,
              zcfg.ssm.d_state))):
        for rec in check_quantize_slab(torch, label, count, shape):
            slabs[f"{rec['kernel']} {label}"] = rec
    checks += list(slabs.values())
    gc.collect()
    torch.cuda.empty_cache()
    records += checks
    records.append(emit("phase_time", of="check",
                        seconds=time.monotonic() - t_phase))
    checks_ok(checks)

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
    # the KV items stay on the card for the fleet phase
    kv_items = items
    del server, received

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
    # the state items (views of the prefill's state) stay for the fleet
    state_items = sitems
    del mserver, sreceived, restored
    torch.cuda.empty_cache()

    # ---- gemma3-1b and zamba2-1.2b: serve at full width ------------------
    shapes = {"slabs": slabs}
    for name, phase in (("gemma3", gemma3_phase), ("zamba2", zamba2_phase),
                        ("llava", llava_phase),
                        ("seamless", seamless_phase)):
        t_phase = time.monotonic()
        shapes[name] = phase(torch, paths, rng, records)
        records.append(emit("phase_time", of=name,
                            seconds=time.monotonic() - t_phase))
        gc.collect()
        torch.cuda.empty_cache()
    ef = check_error_feedback(torch, cfg)
    records.append(ef)
    checks_ok([ef])
    torch.cuda.empty_cache()

    # ---- smollm-360m: train, checkpoint, fail, restore ------------------
    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train, trainer, source = train_phase(torch, cfg, root)
        paths["train"] = train["launches"]
        records.append(emit("train", nvidia_smi=smi, **train))
        checked(train, "training path", ("losses_ok", "restore_ok",
                                         "verify_ok", "load_back_ok",
                                         "no_kernel_ok"))
        records.append(emit("phase_time", of="train",
                            seconds=time.monotonic() - t_phase))

        # ---- the training state: a transfer killed and resumed ----------
        t_phase = time.monotonic()
        build.reset_launches()
        resume = resume_phase(torch, trainer, root)
        paths["resume"] = build.launch_counts()
        records.append(emit("resume", nvidia_smi=smi,
                            launches=paths["resume"], **resume))
        checked(resume, "resume", ("digest_ok", "exact_ok", "skip_ok",
                                   "noop_ok", "bytes_ok"))
        records.append(emit("phase_time", of="resume",
                            seconds=time.monotonic() - t_phase))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # ---- three transfers under one fleet arbiter ------------------------
    t_phase = time.monotonic()
    fleet = fleet_phase(torch, kv_items, state_items, kv_digest,
                        state_digest)
    paths["fleet"] = fleet["launches"]
    records.append(emit("fleet", nvidia_smi=smi, **fleet))
    checked(fleet, "fleet", ("admission_ok", "conserved_ok", "rebalance_ok",
                             "digest_ok", "folds_ok", "released_ok"))
    need(paths, "fleet", ("digest_items", "quantize_int8"))
    records.append(emit("phase_time", of="fleet",
                        seconds=time.monotonic() - t_phase))
    del kv_items, state_items, cache, items, sitems

    # ---- the co-design model beside the measured step --------------------
    t_phase = time.monotonic()
    codesign = codesign_phase(torch, cfg, trainer, source, train)
    paths["codesign"] = codesign["launches"]
    records.append(emit("codesign", nvidia_smi=smi, **codesign))
    checked(codesign, "codesign", ("fits_ok", "flops_ok"))
    records.append(emit("phase_time", of="codesign",
                        seconds=time.monotonic() - t_phase))
    del trainer, source
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phi3-mini, mistral-large and mixtral at published widths --------
    for name in LARGE_CELLS:
        t_phase = time.monotonic()
        shapes[name] = large_phase(torch, paths, rng, records, name)
        records.append(emit("phase_time", of=name,
                            seconds=time.monotonic() - t_phase))
        gc.collect()
        torch.cuda.empty_cache()

    # ---- qwen3-moe-30b-a3b: serve at full width, alone ------------------
    t_phase = time.monotonic()
    shapes["qwen3_moe"] = qwen3_phase(torch, paths, rng, records)
    records.append(emit("phase_time", of="qwen3_moe",
                        seconds=time.monotonic() - t_phase))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the mesh: four gloo ranks sharing the card, last ---------------
    t_phase = time.monotonic()
    shapes["mesh"] = mesh_phase(torch, paths, rng, records)
    records.append(emit("phase_time", of="mesh",
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
            "call_ms": rec["call_ms"],
            # the same kernel at the later phases' shapes
            "shapes": [
                {"of": f"{phase} {label}", **{key: r.get(key) for key in (
                    "shape", "window", "values", "bytes", "items",
                    "launches_per_call", "max_abs_err", "ms", "singles_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "call_ms")}}
                for phase, recs in shapes.items()
                for label, r in recs.items() if r["kernel"] == name]})
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


# ---------------------------------------------------------------------------
# the gemma3-1b and zamba2-1.2b serving phases
# ---------------------------------------------------------------------------


def _prompts(torch, cfg, batch, prompt, rng) -> dict:
    return {"tokens": torch.randint(0, cfg.vocab, (batch, prompt),
                                    generator=rng,
                                    dtype=torch.int32).numpy()}


def checks_ok(checks) -> None:
    """Fail unless every kernel check record in ``checks`` holds."""
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) disagree with the plain version: "
             f"{json.dumps(bad)}")


def _launches_per_layer(paths, path, name, want) -> None:
    got = paths[path][name]
    if got != want:
        fail(f"the {path} path launched {name} {got} times, not {want}")


def _serve_record(torch, server, batch, prompt, timing, gen_s, launches,
                  **extra):
    cfg = server.cfg
    n = len(batch["tokens"])
    return emit(
        "serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params=sum(p.numel() for p in server.params.parameters()),
        batch=n, prompt=prompt, gen=GEN, max_len=server.max_len, **timing,
        generate_s=gen_s, tok_per_s=n * GEN / gen_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches, **extra)


def gemma3_phase(torch, paths, rng, records) -> dict:
    """gemma3-1b at full width (26 layers, hd 256, 5:1 local:global)
    serving 4 x 1024-token prompts for 32 tokens against a full cache of
    1057 slots: the kernels at the phase's shapes (flash at windows 512
    and 0, decode against the cache at both), the path's launches, and
    its logits against the plain path.  Appends every record to
    ``records``; returns the check records by name."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    cfg = get_config("gemma3-1b")
    max_len = GEMMA_PROMPT + GEN + 1
    G = dict(B=GEMMA_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    checks = {
        "flash_local": check_flash(torch, S=GEMMA_PROMPT, dtype=bf16,
                                   window=cfg.window, **G),
        "flash_global": check_flash(torch, S=GEMMA_PROMPT, dtype=bf16,
                                    window=0, **G),
        "decode_local": check_decode(torch, S=max_len, dtype=bf16,
                                     fill=GEMMA_PROMPT + GEN // 2,
                                     window=cfg.window, ring=False, **G),
        "decode_global": check_decode(torch, S=max_len, dtype=bf16,
                                      fill=GEMMA_PROMPT + GEN // 2,
                                      window=0, ring=False, **G),
    }
    records += checks.values()
    checks_ok(checks.values())
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    batch = _prompts(torch, cfg, GEMMA_BATCH, GEMMA_PROMPT, rng)
    timing = serve_timing(torch, server, batch, GEMMA_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    paths["gemma3_serve"] = build.launch_counts()
    records.append(_serve_record(torch, server, batch, GEMMA_PROMPT, timing,
                                 gen_s, paths["gemma3_serve"]))
    # one prefill: flash once per layer; 31 decode steps: decode per layer
    _launches_per_layer(paths, "gemma3_serve", "flash_attention",
                        cfg.n_layers)
    _launches_per_layer(paths, "gemma3_serve", "decode_attention",
                        cfg.n_layers * (GEN - 1))
    correct = emit("correct", arch=cfg.name,
                   **check_logits(torch, server, batch, tokens))
    records.append(correct)
    checked(correct, "gemma3 serving path",
            ("logits_ok", "tokens_ok", "greedy_ok"))
    return checks


def zamba2_phase(torch, paths, rng, records) -> dict:
    """zamba2-1.2b at full width (38 Mamba2 layers, the shared block at 7
    sites) serving 2 x 4608-token prompts for 32 tokens, the shared K/V a
    4096-slot ring at each site: the kernels at the phase's shapes, the
    path's launches, then its decode cache staged as the mamba phase stages
    its own (the 38 f32 states over the int8 wire, restored onto the card;
    the 14 shared K/V items under the accel digest), both planned on
    ``card_host_basin`` at the rates measured here, and its logits, codes,
    digests and decoding from the restored state checked.  Appends every
    record to ``records``; returns the check records by name."""
    from repro_torch.configs import get_config
    from repro_torch.core.integrity import as_bytes, decompress_transform
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    cfg = get_config("zamba2-1.2b")
    max_len = ZAMBA_PROMPT + GEN + 1
    slots = min(cfg.window, max_len)
    G = dict(B=ZAMBA_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    s = cfg.ssm
    state_shape = (ZAMBA_BATCH, cfg.ssm_heads, s.head_dim, s.d_state)
    state_values = math.prod(state_shape)
    quant, dequant = check_quantize(torch, state_values)
    # one shared K item and one state item on the wire, as the mover hands
    # them to the digest (one launch each): the plans' digest rates
    g = torch.Generator(device="cuda").manual_seed(29)
    kv_bytes = ZAMBA_BATCH * slots * cfg.kv_dim * 2
    kv = torch.randint(0, 256, (kv_bytes,), generator=g, dtype=torch.uint8,
                       device="cuda")
    codes = torch.randint(0, 256, (state_values,), generator=g,
                          dtype=torch.uint8, device="cuda")
    scales = torch.randint(0, 256, (state_values // 256 * 4,), generator=g,
                           dtype=torch.uint8, device="cuda")
    shape_bytes = as_bytes(state_shape)
    shape_dev = torch.frombuffer(bytearray(shape_bytes),
                                 dtype=torch.uint8).cuda()
    checks = {
        "flash": check_flash(torch, S=ZAMBA_PROMPT, dtype=bf16,
                             window=cfg.window, **G),
        "decode": check_decode(torch, S=slots, dtype=bf16,
                               fill=ZAMBA_PROMPT + GEN // 2,
                               window=cfg.window, ring=False, wrapped=True,
                               **G),
        "ssd_scan": check_ssd(torch, ZAMBA_BATCH, cfg.ssm_heads, s.n_groups,
                              ZAMBA_PROMPT, chunk=s.chunk, N=s.d_state),
        "quantize_int8": quant, "dequantize_int8": dequant,
        "kv_item": check_digest_items(torch, "one zamba2 shared K item",
                                      [[kv]], [[kv]]),
        "wire_item": check_digest_items(
            torch, "one zamba2 state item on the wire",
            [[codes, scales, shape_bytes]], [[codes, scales, shape_dev]]),
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv, codes, scales

    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    batch = _prompts(torch, cfg, ZAMBA_BATCH, ZAMBA_PROMPT, rng)
    timing = serve_timing(torch, server, batch, ZAMBA_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    paths["zamba2_serve"] = build.launch_counts()
    records.append(_serve_record(torch, server, batch, ZAMBA_PROMPT, timing,
                                 gen_s, paths["zamba2_serve"]))
    n_sites = len(range(0, cfg.n_layers, cfg.attn_every))
    _launches_per_layer(paths, "zamba2_serve", "ssd_scan", cfg.n_layers)
    _launches_per_layer(paths, "zamba2_serve", "flash_attention", n_sites)
    _launches_per_layer(paths, "zamba2_serve", "decode_attention",
                        n_sites * (GEN - 1))

    build.reset_launches()
    state_digest = digest_rate(checks["wire_item"])
    cache, sitems, sreceived, sreport, sstage_s, state_copy_gbps = \
        stage_state(torch, server, batch, state_digest)
    torch.cuda.synchronize()
    paths["zamba2_stage_state"] = build.launch_counts()
    state_bytes = sum(t.nbytes for t in sitems)
    records.append(emit(
        "stage_state", arch=cfg.name, items=len(sitems),
        item_bytes=sitems[0].nbytes, state_bytes=state_bytes,
        wire_bytes=sreport.bytes, ratio=state_bytes / sreport.bytes,
        stage_s=sstage_s, state_gbps=state_bytes * 8 / sstage_s / 1e9,
        pageable_copy_gbps=state_copy_gbps,
        planned_digest_bytes_per_s=state_digest,
        digest_folds=sreport.checksum_folds,
        launches=paths["zamba2_stage_state"]))
    need(paths, "zamba2_stage_state",
         ("ssd_scan", "quantize_int8", "digest_items"))
    once_per_fold(paths, "zamba2_stage_state", sreport)

    # the shared block's K and V, one item per site and tensor
    kv_items = [cache[name][i] for i in range(cache["shared_k"].shape[0])
                for name in ("shared_k", "shared_v")]
    kv_digest = digest_rate(checks["kv_item"])
    kv_copy_gbps = pageable_gbps(torch, kv_items[0])
    build.reset_launches()
    t0 = time.monotonic()
    kreceived, kreport = _stage_kv(torch, kv_items, kv_digest, kv_copy_gbps)
    kstage_s = time.monotonic() - t0
    paths["zamba2_stage_kv"] = build.launch_counts()
    kv_total = sum(t.nbytes for t in kv_items)
    records.append(emit(
        "stage_kv", arch=cfg.name, items=len(kv_items),
        item_bytes=kv_items[0].nbytes, kv_bytes=kv_total,
        stage_s=kstage_s, kv_gbps=kv_total * 8 / kstage_s / 1e9,
        pageable_copy_gbps=kv_copy_gbps,
        planned_digest_bytes_per_s=kv_digest,
        digest_folds=kreport.checksum_folds,
        launches=paths["zamba2_stage_kv"]))
    need(paths, "zamba2_stage_kv", ("digest_items",))
    once_per_fold(paths, "zamba2_stage_kv", kreport)

    build.reset_launches()
    t0 = time.monotonic()
    restored = torch.stack(
        decompress_transform(device="cuda").many(sreceived))
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    paths["zamba2_restore"] = build.launch_counts()
    records.append(emit("restore", arch=cfg.name, items=len(sreceived),
                        seconds=restore_s,
                        state_gbps=state_bytes * 8 / restore_s / 1e9,
                        launches=paths["zamba2_restore"]))
    need(paths, "zamba2_restore", ("dequantize_int8",))

    correct = check_mamba_correct(torch, server, batch, tokens, cache,
                                  sitems, sreceived, sreport, restored)
    records.append(correct)
    checked(correct, "zamba2 serving and state staging path",
            ("logits_ok", "tokens_ok", "greedy_ok", "codes_ok",
             "restore_ok", "digest_ok", "restored_ok"))
    kv_ok = emit("correct", of="zamba2 shared K/V staging", arch=cfg.name,
                 **kv_staged_ok(kv_items, kreceived, kreport))
    records.append(kv_ok)
    checked(kv_ok, "zamba2 shared K/V staging", ("digest_ok", "bytes_ok"))
    return checks


# ---------------------------------------------------------------------------
# the llava-next-mistral-7b and seamless-m4t-large-v2 serving phases
# ---------------------------------------------------------------------------


def _stage_kv_path(torch, paths, path, arch, items, kv_digest, records):
    """Stage ``items`` (card tensors) to host memory under the accel
    digest as :func:`_stage_kv` does, the path's launches counted from 0;
    the record, then the hexdigest and bytes checked."""
    from repro_torch.kernels import build
    copy_gbps = pageable_gbps(torch, items[0])
    build.reset_launches()
    t0 = time.monotonic()
    received, report = _stage_kv(torch, items, kv_digest, copy_gbps)
    stage_s = time.monotonic() - t0
    paths[path] = build.launch_counts()
    total = sum(t.nbytes for t in items)
    records.append(emit(
        "stage_kv", arch=arch, items=len(items), item_bytes=items[0].nbytes,
        kv_bytes=total, stage_s=stage_s, kv_gbps=total * 8 / stage_s / 1e9,
        pageable_copy_gbps=copy_gbps, planned_digest_bytes_per_s=kv_digest,
        digest_folds=report.checksum_folds, launches=paths[path]))
    need(paths, path, ("digest_items",))
    once_per_fold(paths, path, report)
    ok = emit("correct", of=f"{path} staging", arch=arch,
              **kv_staged_ok(items, received, report))
    records.append(ok)
    checked(ok, f"{path} staging", ("digest_ok", "bytes_ok"))


def _serve_launches(torch, paths, path, server, batch):
    """``generate`` for GEN tokens with the launch counts set to 0 just
    before and read just after: (tokens, seconds)."""
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    paths[path] = build.launch_counts()
    return tokens, gen_s


def llava_phase(torch, paths, rng, records) -> dict:
    """llava-next-mistral-7b at full width (32 layers, d_model 4096, 32
    query heads over 8 KV heads, hd 128; 7.27 B parameters) serving 4
    requests of 576 stub patch embeddings and 512 tokens for 32 tokens
    against a full 1121-slot cache: the kernels at the phase's shapes
    (flash over the 1088 prefill positions, decode against the cache, the
    digest of one KV item), the path's launches, its logits against the
    plain path (prefill and 4 teacher-forced steps), and the prefill's 64
    KV items staged under the accel digest.  Appends every record to
    ``records``; returns the check records by name."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    cfg = get_config("llava-next-mistral-7b")
    S = cfg.frontend_len + LLAVA_PROMPT
    max_len = S + GEN + 1
    G = dict(B=LLAVA_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(37)
    kv = torch.randint(0, 256, (LLAVA_BATCH * max_len * cfg.kv_dim * 2,),
                       generator=g, dtype=torch.uint8, device="cuda")
    checks = {
        "flash": check_flash(torch, S=S, dtype=bf16, window=0, **G),
        "decode": check_decode(torch, S=max_len, dtype=bf16,
                               fill=S + GEN // 2, window=0, ring=False, **G),
        "kv_item": check_digest_items(torch, "one llava KV item", [[kv]],
                                      [[kv]]),
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv

    t0 = time.monotonic()
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    batch = _prompts(torch, cfg, LLAVA_BATCH, LLAVA_PROMPT, rng)
    batch["extra_embeds"] = torch.randn(
        (LLAVA_BATCH, cfg.frontend_len, cfg.d_model), generator=rng).numpy()
    timing = serve_timing(torch, server, batch, S)
    tokens, gen_s = _serve_launches(torch, paths, "llava_serve", server,
                                    batch)
    records.append(_serve_record(
        torch, server, batch, LLAVA_PROMPT, timing, gen_s,
        paths["llava_serve"], load_s=load_s, patches=cfg.frontend_len,
        prefill_positions=S))
    _launches_per_layer(paths, "llava_serve", "flash_attention",
                        cfg.n_layers)
    _launches_per_layer(paths, "llava_serve", "decode_attention",
                        cfg.n_layers * (GEN - 1))
    correct = emit("correct", arch=cfg.name,
                   **check_logits(torch, server, batch, tokens))
    records.append(correct)
    checked(correct, "llava serving path",
            ("logits_ok", "tokens_ok", "greedy_ok"))

    _, cache = server.prefill(batch)
    items = [cache[name][i] for i in range(cache["k"].shape[0])
             for name in ("k", "v")]
    _stage_kv_path(torch, paths, "llava_stage_kv", cfg.name, items,
                   digest_rate(checks["kv_item"]), records)
    return checks


def seamless_phase(torch, paths, rng, records) -> dict:
    """seamless-m4t-large-v2 at full width (24 encoder and 24 decoder
    layers, d_model 1024, 16 query heads over 16 KV heads, hd 64; 2.04 B
    parameters) serving 4 requests of 1024 stub frames for 32 tokens: the
    kernels at the phase's shapes (flash without the causal mask over the
    1024 frames; decode against the self cache and, as cross attention,
    over every encoder slot, held to the plain non-causal attention; the
    digest of one cross K item), the path's launches (flash once per
    encoder layer per prefill; decode twice per decoder layer per step,
    the prefill's first-token step included), the encoder states and the
    logits against the plain path, and the 48 cross K/V items staged under
    the accel digest.  Appends every record to ``records``; returns the
    check records by name."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import encdec
    from repro_torch.models.blocks import ShardCtx
    cfg = get_config("seamless-m4t-large-v2")
    S = SEAMLESS_FRAMES
    max_len = S + GEN + 1
    G = dict(B=SEAMLESS_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(41)
    kv = torch.randint(0, 256, (SEAMLESS_BATCH * S * cfg.kv_dim * 2,),
                       generator=g, dtype=torch.uint8, device="cuda")
    checks = {
        "flash_encoder": check_flash(torch, S=S, dtype=bf16, window=0,
                                     causal=False, **G),
        "decode_self": check_decode(torch, S=max_len, dtype=bf16,
                                    fill=GEN // 2, window=0, ring=False, **G),
        "decode_cross": check_decode(torch, S=S, dtype=bf16, fill=S - 1,
                                     window=0, ring=False, cross=True, **G),
        "kv_item": check_digest_items(torch, "one seamless cross K item",
                                      [[kv]], [[kv]]),
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv

    t0 = time.monotonic()
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    batch = _prompts(torch, cfg, SEAMLESS_BATCH, S, rng)
    batch["frames"] = torch.randn((SEAMLESS_BATCH, S, cfg.d_model),
                                  generator=rng).numpy()
    # the prefill leaves the self cache at position 1
    timing = serve_timing(torch, server, batch, 1)
    tokens, gen_s = _serve_launches(torch, paths, "seamless_serve", server,
                                    batch)
    records.append(_serve_record(
        torch, server, batch, S, timing, gen_s, paths["seamless_serve"],
        load_s=load_s, enc_layers=cfg.enc_layers, frames=S))
    _launches_per_layer(paths, "seamless_serve", "flash_attention",
                        cfg.enc_layers)
    _launches_per_layer(paths, "seamless_serve", "decode_attention",
                        2 * cfg.n_layers * GEN)

    frames = torch.as_tensor(batch["frames"], device="cuda")
    with torch.no_grad():
        enc = encdec.encode(server.params, cfg, frames, server.ctx)
        enc_ref = encdec.encode(server.params, cfg, frames,
                                ShardCtx(impl="ref"))
    enc_err = (enc.float() - enc_ref.float()).abs().max().item()
    enc_scale = enc_ref.float().abs().max().item()
    del enc, enc_ref
    fields = check_logits(torch, server, batch, tokens)
    correct = emit("correct", arch=cfg.name, encoder_max_abs_err=enc_err,
                   encoder_scale=enc_scale,
                   encoder_tol=LOGIT_SHARE * enc_scale,
                   encoder_ok=enc_err <= LOGIT_SHARE * enc_scale, **fields)
    records.append(correct)
    checked(correct, "seamless serving path",
            ("encoder_ok", "logits_ok", "tokens_ok", "greedy_ok"))

    # the cross K/V, one item per decoder layer and tensor, computed once
    # per request: staged as a KV cache is
    _, cache = server.prefill(batch)
    items = [cache[name][i] for i in range(cache["cross_k"].shape[0])
             for name in ("cross_k", "cross_v")]
    _stage_kv_path(torch, paths, "seamless_stage_kv", cfg.name, items,
                   digest_rate(checks["kv_item"]), records)
    return checks


def large_phase(torch, paths, rng, records, name) -> dict:
    """One of :data:`LARGE_CELLS` at published widths (its depth cut where
    the cell says so), random weights from ``SEED``, serving ``batch`` x
    ``prompt`` tokens for 32 tokens: the allocation at the phase's start
    (under ``RESIDENT_LIMIT_MIB``); the kernels at the phase's shapes
    (flash over the prompt with the config's window, decode against the
    phase's cache filled to prompt + 16, for mixtral its 4096-slot ring
    wrapped; the digest of one KV item) and, for mixtral, one MoE layer's
    ``moe_dispatch`` against ``moe_ref`` on the prefill's 9216 tokens;
    the serving path's launches (flash once per layer per prefill, decode
    once per layer per step); its logits against the plain path
    (``check_logits``, or ``check_moe_logits`` under the kernel path's
    expert choices); and the prefill's KV items staged under the accel
    digest.  Appends every record to ``records``; returns the check
    records by name."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import lm as lm_lib
    cell = LARGE_CELLS[name]
    resident_mib = torch.cuda.memory_allocated() / 2**20
    resident = emit("memory", of=f"{name} phase start",
                    allocated_before_phase_mib=resident_mib,
                    resident_ok=resident_mib < RESIDENT_LIMIT_MIB)
    records.append(resident)
    checked(resident, f"{name} phase start", ("resident_ok",))
    published = get_config(cell["arch"])
    cfg = (dataclasses.replace(published, n_layers=cell["layers"])
           if cell["layers"] else published)
    B, prompt = cell["batch"], cell["prompt"]
    max_len = prompt + GEN + 1
    slots = lm_lib._attn_cache_len(cfg, max_len)
    ring = lm_lib.cache_kind(cfg) == "ring"
    G = dict(B=B, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(43)
    kv = torch.randint(0, 256, (B * slots * cfg.kv_dim * 2,), generator=g,
                       dtype=torch.uint8, device="cuda")
    checks = {
        "flash": check_flash(torch, S=prompt, dtype=bf16, window=cfg.window,
                             **G),
        "decode": check_decode(torch, S=slots, dtype=bf16,
                               fill=prompt + GEN // 2, window=cfg.window,
                               ring=False, wrapped=ring, **G),
        "kv_item": check_digest_items(torch, f"one {name} KV item", [[kv]],
                                      [[kv]]),
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv

    t0 = time.monotonic()
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    if cfg.moe:
        moe = check_moe_layer(torch, cfg, server.params.layers[0].moe,
                              B * prompt)
        records.append(moe)
        checked(moe, f"{name} MoE layer", ("ok", "routing_ok", "aux_ok"))
    batch = _prompts(torch, cfg, B, prompt, rng)
    # the MoE's decode step syncs with the host once a layer: no CUDA graph
    timing = serve_timing(torch, server, batch, prompt, graph=not cfg.moe)
    tokens, gen_s = _serve_launches(torch, paths, f"{name}_serve", server,
                                    batch)
    reduced = ({"n_layers": [cfg.n_layers, published.n_layers]}
               if cell["layers"] else {})
    records.append(_serve_record(
        torch, server, batch, prompt, timing, gen_s, paths[f"{name}_serve"],
        load_s=load_s, cache_slots=slots, cache_kind=lm_lib.cache_kind(cfg),
        weight_gb=sum(p.nbytes for p in server.params.parameters()) / 1e9,
        published_layers=published.n_layers, reduced=reduced))
    _launches_per_layer(paths, f"{name}_serve", "flash_attention",
                        cfg.n_layers)
    _launches_per_layer(paths, f"{name}_serve", "decode_attention",
                        cfg.n_layers * (GEN - 1))
    if cfg.moe:
        correct = emit("correct", arch=cfg.name, n_layers=cfg.n_layers,
                       **check_moe_logits(torch, server, batch, tokens))
        keys = ("logits_ok", "near_tie_ok", "tokens_ok", "greedy_ok")
    else:
        correct = emit("correct", arch=cfg.name, n_layers=cfg.n_layers,
                       **check_logits(torch, server, batch, tokens))
        keys = ("logits_ok", "tokens_ok", "greedy_ok")
    records.append(correct)
    checked(correct, f"{name} serving path", keys)

    # the prefill's KV cache, one item per layer and tensor, to host memory
    _, cache = server.prefill(batch)
    items = [cache[n][i] for i in range(cache["k"].shape[0])
             for n in ("k", "v")]
    _stage_kv_path(torch, paths, f"{name}_stage_kv", cfg.name, items,
                   digest_rate(checks["kv_item"]), records)
    return checks


def check_error_feedback(torch, cfg, steps: int = 2) -> dict:
    """``error_feedback_step`` on a gradient list shaped as ``cfg``'s
    parameters (f32, on the card: its round trip through the quantize
    and dequantize kernels, once per tensor each) against its plain
    version on the card (the blockwise functions of
    ``optim.compression``), ``steps`` steps with the residuals carried:
    what is sent and every residual bit for bit.  Times per eager step;
    bound: each gradient and residual read once, what is sent and the new
    residual written once (bytes)."""
    from repro_torch.kernels import build
    from repro_torch.models.api import build as build_model
    from repro_torch.optim import compression as comp
    params = build_model(cfg).init(SEED, device="cuda")
    shapes = [tuple(p.shape) for p in params.parameters()]
    del params
    g = torch.Generator(device="cuda").manual_seed(43)
    grads = [torch.randn(s, generator=g, device="cuda") * 1e-3
             for s in shapes]

    def plain_step(gs, state):
        sent, resid = [], []
        for x, r in zip(gs, state.residual):
            c = x.float() + r
            q, sc = comp.quantize_int8_blockwise(c)
            out = comp.dequantize_int8_blockwise(q, sc, tuple(c.shape))
            sent.append(out)
            resid.append(c - out)
        return sent, comp.CompressionState(residual=resid)

    kstate = comp.error_feedback_init(grads)
    pstate = comp.error_feedback_init(grads)
    mismatched, err = 0, 0.0
    n0 = build.launch_counts()
    for _ in range(steps):
        ksent, kstate = comp.error_feedback_step(grads, kstate)
        psent, pstate = plain_step(grads, pstate)
        for a, b in zip(ksent + kstate.residual, psent + pstate.residual):
            mismatched += _bits_differ(torch, a, b)
            err = max(err, (a - b).abs().max().item())
    n1 = build.launch_counts()
    launches = {n: n1[n] - n0[n] for n in ("quantize_int8",
                                           "dequantize_int8")}
    ms = call_ms(lambda: comp.error_feedback_step(grads, kstate), iters=3,
                 warmup=1)
    plain_ms = call_ms(lambda: plain_step(grads, pstate), iters=3, warmup=1)
    values = sum(math.prod(s) for s in shapes)
    bms, by = bound_ms(4 * 4 * values, 0.0, PEAK_F32)
    del grads, kstate, pstate, ksent, psent
    return emit("check", of="error feedback", path="error_feedback_step",
                plain="quantize_int8_blockwise / dequantize_int8_blockwise",
                arch=cfg.name, tensors=len(shapes), values=values,
                steps=steps, mismatched=mismatched, max_abs_err=err,
                launches=launches,
                ok=mismatched == 0 and all(
                    c == steps * len(shapes) for c in launches.values()),
                call_ms=ms, plain_call_ms=plain_ms, bound_ms=bms,
                bound_by=by)


# ---------------------------------------------------------------------------
# the qwen3-moe-30b-a3b serving phase
# ---------------------------------------------------------------------------


def host_syncs(torch, fn) -> int:
    """Synchronizing CUDA operations (device-to-host copies and waits) in
    one call of ``fn``, as torch's sync debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def check_moe_layer(torch, cfg, moe, T):
    """One layer's ``moe_dispatch`` against ``moe_ref`` (the plain
    version) on the same T tokens of unit-rms values, as the layer's normed
    input is, each path's routing recorded: the routing identical, y
    within ``MOE_TOL``, the load-balance and z losses within f32 rounding.
    Times are per eager call (the dispatch syncs once with the host, so no
    CUDA graph).  Bound: the experts this routing uses, read once, and the
    tokens in and out (bytes), or 2 T k 3 D F operations at the bf16 rate;
    no single PyTorch call computes a top-k MoE, so no library time."""
    from repro_torch.models import ffn
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(1, T, cfg.d_model, generator=g, device="cuda").to(
        torch.bfloat16)
    args = (x, moe.router, moe.w_gate, moe.w_up, moe.w_down)
    klog, plog = ffn.RouteLog(), ffn.RouteLog()
    y, lb, z = ffn.moe_dispatch(*args, cfg=cfg, log=klog)
    y_ref, lb_ref, z_ref = ffn.moe_ref(*args, cfg=cfg, log=plog)
    torch.cuda.synchronize()
    routing_ok = bool(torch.equal(klog.calls[0][0], plog.calls[0][0]))
    err, ok = _within(torch, y, y_ref, **MOE_TOL)
    aux_ok = bool(torch.allclose(lb, lb_ref, rtol=1e-5)
                  and torch.allclose(z, z_ref, rtol=1e-5))
    ms = call_ms(lambda: ffn.moe_dispatch(*args, cfg=cfg), iters=10)
    plain_ms = call_ms(lambda: ffn.moe_ref(*args, cfg=cfg), iters=3,
                       warmup=1)
    D, F, k = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.top_k
    used = int(torch.unique(klog.calls[0][0]).numel())
    nbytes = used * 3 * D * F * 2 + 2 * T * D * 2 + moe.router.nbytes
    bms, by = bound_ms(nbytes, 2.0 * T * k * 3 * D * F, PEAK_BF16)
    return emit("check", of="moe layer", path="moe_dispatch",
                plain="moe_ref", tokens=T, experts_used=used,
                max_abs_err=err, tol=MOE_TOL, ok=ok, routing_ok=routing_ok,
                aux_ok=aux_ok, lb=[lb.item(), lb_ref.item()],
                z=[z.item(), z_ref.item()], call_ms=ms, plain_call_ms=plain_ms,
                bound_ms=bms, bound_by=by)


def _routing_gaps(torch, probs, k):
    """Per row of router ``probs``, the k-th minus the (k+1)-th largest
    router logit (log-probability): how far the row is from a tie at the
    top-k boundary."""
    lg = torch.log(probs).sort(-1, descending=True).values
    return lg[:, k - 1] - lg[:, k]


def routing_layer_by_layer(torch, server, batch) -> dict:
    """Each MoE layer's routing by the kernel path and by the plain path on
    the same layer input (the plain path's own stream through a prefill of
    ``batch``): every decision of every prompt token in every layer.  The
    two differ only by one layer of attention rounding, so a decision may
    differ only at a near-tie: fails unless the plain path's k-th and
    (k+1)-th router logits lie closer than ``ROUTE_NEAR_TIE`` wherever the
    expert sets differ."""
    from repro_torch.models import ffn
    from repro_torch.models.blocks import ShardCtx, moe_layer_apply
    params, cfg = server.params, server.cfg
    k = cfg.moe.top_k
    tok = torch.as_tensor(batch["tokens"], device="cuda")
    pos = torch.arange(tok.shape[1], dtype=torch.int32, device="cuda")
    x = params.embed[tok.long()]
    gaps, differ = [], []
    with torch.no_grad():
        for lp in params.layers:
            klog, plog = ffn.RouteLog(), ffn.RouteLog()
            moe_layer_apply(x, lp, cfg,
                            dataclasses.replace(server.ctx, routes=klog),
                            positions=pos)
            x, _, _ = moe_layer_apply(x, lp, cfg,
                                      ShardCtx(impl="ref", routes=plog),
                                      positions=pos)
            (ke, _), (pe, pp) = klog.calls[0], plog.calls[0]
            same = (ke.sort(-1).values == pe.sort(-1).values).all(-1)
            gap = _routing_gaps(torch, pp, k)
            gaps.append(gap)
            differ.append(gap[~same])
    gaps, differ = torch.cat(gaps).cpu(), torch.cat(differ).cpu()
    return dict(
        layer_local_decisions=gaps.numel() * k,
        layer_local_differing=int(differ.numel()),
        layer_local_max_gap=differ.max().item() if differ.numel() else None,
        layer_local_gap_quantiles={str(q): torch.quantile(gaps, q).item()
                                   for q in (0.01, 0.1, 0.5)},
        near_tie_bound=ROUTE_NEAR_TIE,
        near_tie_ok=bool((differ < ROUTE_NEAR_TIE).all()))


def check_moe_logits(torch, server, batch, tokens) -> dict:
    """``check_logits`` for the MoE, each path's routing recorded.

    The kernel path and the plain path round attention at different
    places, so a token whose k-th and (k+1)-th router probabilities nearly
    tie may take another expert in one path; its output then moves by far
    more than bf16 noise, and through attention so does every later token
    of its sequence, and so on through 48 layers.  So:

    * free runs (prefill and 4 teacher-forced decode steps per path): the
      routing decisions that differ at the compared positions (each
      prompt's last token at the prefill, every sequence at each decode
      step), with their expert ids and the plain path's gaps; the
      positions whose routing agreed in every layer, and the logits there;
    * the logits, held to ``LOGIT_SHARE`` at every compared position, come
      from the plain path run again with the kernel path's expert choices
      imposed (``ffn.RouteLog(forced=...)``): the same function with the
      same tie-breaks;
    * the near-tie check runs layer by layer on the same inputs
      (:func:`routing_layer_by_layer`), where one layer's rounding is the
      only difference.

    The f32 noise floor of the dense phases cannot run: qwen3's weights in
    f32 would take 122 GB, more than the card holds."""
    from repro_torch.models import ffn
    from repro_torch.models.blocks import ShardCtx
    api, params, cfg = server.api, server.params, server.cfg
    tok = torch.as_tensor(batch["tokens"], device="cuda")
    forced = torch.as_tensor(tokens, device="cuda")
    run = lambda ctx: _teacher_forced(torch, api, params, ctx, {"tokens": tok},
                                      forced, server.max_len)
    klog, plog = ffn.RouteLog(), ffn.RouteLog()
    kern = run(dataclasses.replace(server.ctx, routes=klog))
    plain = run(ShardCtx(impl="ref", routes=plog))
    plain_forced = run(ShardCtx(impl="ref", routes=ffn.RouteLog(
        forced=[e for e, _ in klog.calls])))
    klog, plog = klog.calls, plog.calls
    L, k = cfg.n_layers, cfg.moe.top_k
    B, S = tok.shape
    steps = len(kern)
    if len(klog) != steps * L or len(plog) != steps * L:
        fail(f"{len(klog)} / {len(plog)} route calls for {steps} steps of "
             f"{L} layers")
    last = torch.arange(B, device="cuda") * S + S - 1
    rows = [last] + [torch.arange(B, device="cuda")] * (steps - 1)
    agreed = torch.ones((steps, B), dtype=torch.bool)
    differing, gaps = [], []
    for step in range(steps):
        for layer in range(L):
            ke = klog[step * L + layer][0][rows[step]]
            pe, pp = (t[rows[step]] for t in plog[step * L + layer])
            same = (ke.sort(-1).values == pe.sort(-1).values).all(-1).cpu()
            gap = _routing_gaps(torch, pp, k).cpu()
            gaps.append(gap)
            agreed[step] &= same
            for b in (~same).nonzero().flatten().tolist():
                kset, pset = set(ke[b].tolist()), set(pe[b].tolist())
                differing.append(dict(
                    step=step, seq=b, layer=layer, gap=gap[b].item(),
                    kernel_only=sorted(kset - pset),
                    plain_only=sorted(pset - kset)))
    errs = torch.stack([(x.float() - y.float()).abs().amax(dim=(1, 2))
                        for x, y in zip(kern, plain)]).cpu()   # (steps, B)
    forced_errs = _max_err(kern, plain_forced)
    scale = max(x.abs().max().item() for x in plain)
    tol = LOGIT_SHARE * scale
    gaps = torch.cat(gaps)
    diff_gaps = torch.tensor([d["gap"] for d in differing] or [0.0])
    quant = lambda t: {str(q): torch.quantile(t, q).item()
                       for q in (0.1, 0.5, 0.9)}
    greedy = torch.stack([torch.argmax(x[:, -1], dim=-1) for x in kern],
                         dim=1).cpu().numpy()
    finite = all(bool(torch.isfinite(x).all()) for x in kern)
    return dict(
        compared_positions=steps * B, decisions=steps * B * L * k,
        differing_decisions=len(differing),
        differing_experts=sum(len(d["kernel_only"]) for d in differing),
        differing_by_step=[sum(d["step"] == i for d in differing)
                           for i in range(steps)],
        differing=differing[:32], differing_gap_quantiles=quant(diff_gaps),
        gap_quantiles=quant(gaps),
        agreed_positions=int(agreed.sum()),
        agreed_logits_max_abs_err=errs[agreed].tolist(),
        free_logits_max_abs_err=errs.tolist(),
        logits_max_abs_err=forced_errs, logits_scale=scale,
        logits_tol=tol, logits_ok=finite and max(forced_errs) <= tol,
        **routing_layer_by_layer(torch, server, batch),
        tokens_shape=list(tokens.shape),
        tokens_ok=(tokens.shape == (B, GEN) and tokens.dtype.kind == "i"
                   and int(tokens.min()) >= 0
                   and int(tokens.max()) < cfg.vocab),
        greedy_steps=int(greedy.shape[1]),
        greedy_ok=bool((greedy == tokens[:, :greedy.shape[1]]).all()))


def qwen3_phase(torch, paths, rng, records) -> dict:
    """qwen3-moe-30b-a3b at full width (48 MoE layers of 128 experts, top
    8, hd 128, 32 query heads over 4 KV heads; 61 GB of bf16 weights, the
    router f32) serving 4 x 512-token prompts for 32 tokens against a full
    545-slot cache.  Runs after every other phase, with their tensors
    freed.  The kernels at the phase's shapes (flash hd 128, decode hd 128
    filled to 528 slots, the digest of one KV item), one MoE layer's
    dispatch against ``moe_ref``, the serving path's launches, peak memory
    and host syncs per decode step, its logits and routing against the
    plain path, and the prefill's KV cache (96 items) staged under the
    accel digest.  Appends every record to ``records``; returns the check
    records by name."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    torch.cuda.reset_peak_memory_stats()
    resident_mib = torch.cuda.memory_allocated() / 2**20
    cfg = get_config("qwen3-moe-30b-a3b")
    max_len = QWEN_PROMPT + GEN + 1
    G = dict(B=QWEN_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(31)
    kv = torch.randint(0, 256, (QWEN_BATCH * max_len * cfg.kv_dim * 2,),
                       generator=g, dtype=torch.uint8, device="cuda")
    checks = {
        "flash": check_flash(torch, S=QWEN_PROMPT, dtype=bf16, window=0, **G),
        "decode": check_decode(torch, S=max_len, dtype=bf16,
                               fill=QWEN_PROMPT + GEN // 2, window=0,
                               ring=False, **G),
        "kv_item": check_digest_items(torch, "one qwen3 KV item", [[kv]],
                                      [[kv]]),
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv

    t0 = time.monotonic()
    server = Server(cfg, device="cuda", max_len=max_len)
    server.load(SEED)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    moe = check_moe_layer(torch, cfg, server.params.layers[0].moe,
                          QWEN_BATCH * QWEN_PROMPT)
    records.append(moe)
    checked(moe, "MoE layer", ("ok", "routing_ok", "aux_ok"))
    batch = _prompts(torch, cfg, QWEN_BATCH, QWEN_PROMPT, rng)
    timing = serve_timing(torch, server, batch, QWEN_PROMPT, graph=False)
    _, cache = server.prefill(batch)
    step_tok = torch.zeros((QWEN_BATCH, 1), dtype=torch.int32, device="cuda")

    def one_step():
        cache["pos"] = QWEN_PROMPT
        server.decode(cache, step_tok)
    syncs = host_syncs(torch, one_step)
    del cache
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.monotonic()
    tokens = server.generate(batch, GEN)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    paths["qwen3_serve"] = build.launch_counts()
    records.append(_serve_record(torch, server, batch, QWEN_PROMPT, timing,
                                 gen_s, paths["qwen3_serve"], load_s=load_s,
                                 allocated_before_phase_mib=resident_mib,
                                 host_syncs_per_decode_step=syncs))
    _launches_per_layer(paths, "qwen3_serve", "flash_attention",
                        cfg.n_layers)
    _launches_per_layer(paths, "qwen3_serve", "decode_attention",
                        cfg.n_layers * (GEN - 1))
    correct = emit("correct", arch=cfg.name,
                   **check_moe_logits(torch, server, batch, tokens))
    records.append(correct)
    checked(correct, "qwen3 serving path",
            ("logits_ok", "near_tie_ok", "tokens_ok", "greedy_ok"))

    # the prefill's KV cache, one item per layer and tensor, to host memory
    _, cache = server.prefill(batch)
    items = [cache[name][i] for i in range(cache["k"].shape[0])
             for name in ("k", "v")]
    kv_digest = digest_rate(checks["kv_item"])
    copy_gbps = pageable_gbps(torch, items[0])
    build.reset_launches()
    t0 = time.monotonic()
    received, report = _stage_kv(torch, items, kv_digest, copy_gbps)
    stage_s = time.monotonic() - t0
    paths["qwen3_stage_kv"] = build.launch_counts()
    kv_total = sum(t.nbytes for t in items)
    records.append(emit(
        "stage_kv", arch=cfg.name, items=len(items),
        item_bytes=items[0].nbytes, kv_bytes=kv_total, stage_s=stage_s,
        kv_gbps=kv_total * 8 / stage_s / 1e9, pageable_copy_gbps=copy_gbps,
        planned_digest_bytes_per_s=kv_digest,
        digest_folds=report.checksum_folds,
        launches=paths["qwen3_stage_kv"]))
    need(paths, "qwen3_stage_kv", ("digest_items",))
    once_per_fold(paths, "qwen3_stage_kv", report)
    kv_ok = emit("correct", of="qwen3 KV staging", arch=cfg.name,
                 **kv_staged_ok(items, received, report))
    records.append(kv_ok)
    checked(kv_ok, "qwen3 KV staging", ("digest_ok", "bytes_ok"))
    peak = max(peak, torch.cuda.max_memory_allocated())
    records.append(emit("memory", of="qwen3 phase", peak_gib=peak / 2**30,
                        peak_ok=peak < 80e9))
    checked(records[-1], "qwen3 phase memory", ("peak_ok",))
    return checks


# ---------------------------------------------------------------------------
# phase 16: the mesh (four gloo ranks sharing the card)
# ---------------------------------------------------------------------------

#: every timing of the mesh phase is of this setup
MESH_LABEL = "4 ranks on one card over gloo: not a multi-card time"
MESH_RANKS = 4
#: each rank's collective timeout (s), and the parent's wait for one part
MESH_COLLECTIVE_S, MESH_PART_S = 60, 300
#: phi3-mini at TP 4 (mesh (1, 4)): the phi3 phase's batch and prompt, 8
#: teacher-forced decode steps (cut from 32 for the run's time limit) and
#: 16 of its 32 layers (cut for the same limit, to make room for the
#: enc-dec, SSM and hybrid parts);
#: mixtral at EP 4 (mesh (1, 4)) at the
#: mixtral phase's batch, prompt and depth; mistral-large through the
#: pipeline: 4 stages of 2 layers, 4 microbatches of 1 x 1024 tokens
MESH_PHI3 = dict(arch="phi3-mini-3.8b", batch=4, prompt=1024, steps=8,
                 layers=16)
MESH_MIXTRAL = dict(arch="mixtral-8x22b", batch=2, prompt=4608, layers=10)
MESH_PIPE = dict(arch="mistral-large-123b", stages=4, per_stage=2, micro=4,
                 seq=1024)
#: smollm-360m trained at full width on the ranks: (2, 2) under FSDP + TP,
#: ``steps`` steps of the train phase's batch and sequence, a checkpoint
#: every ``every`` steps and a failure injected once ``fail_at`` steps are
#: done; then the elastic restore onto (4, 1) under FSDP and ``more``
#: steps on the batches the (2, 2) trainer fed after its restore (cut from
#: 4 steps and 2, for the run's time limit)
MESH_TRAIN = dict(arch="smollm-360m", steps=3, every=2, fail_at=2, more=1,
                  mesh="hier", plan="fsdp_tp", elastic="fsdp",
                  elastic_plan="fsdp")
# The disk budget: a call's machine takes at most 45 GiB of writes to its
# disk, deleted files included.  The train phase writes two 5.33 GiB
# checkpoints, so each mesh training part writes one, at step ``every``
# (the part's steps stop before a second): its trainers make no save at
# the end of a run (``_timed_trainer``), and the elastic restore reads the
# checkpoint the failure restored (smollm-360m 5.33 GiB, qwen3-moe 24.36
# GiB: 40.4 GiB with the train phase's).
#: qwen3-moe-30b-a3b trained at published widths (128 experts, top 8, d
#: 2048, vocab 151,936), its depth cut to ``layers`` of 48: 2 layers and
#: the embeddings are 1.87 B parameters, about 26 GB of bf16 weights and
#: f32 master and moments over the 4 ranks; a third layer would add about
#: 8.5 GB of state and the one-card check step's dense oracle more.
#: (2, 2) under FSDP + EP (64 experts a rank), ``steps`` steps of the
#: train phase's 8 x 512 batches, a checkpoint every ``every`` steps, a
#: failure injected once ``fail_at`` steps are done (every rank restores
#: step ``every``), then the elastic restore of that checkpoint onto (1, 4)
#: (EP, 32 experts a rank) and ``more`` steps on the batches the (2, 2)
#: trainer fed after its restore; the first step's routing recorded
MESH_MOE_TRAIN = dict(arch="qwen3-moe-30b-a3b", layers=2, steps=3, every=2,
                      fail_at=2, more=1, mesh="hier",
                      plan="fsdp_tp", elastic="tp", elastic_plan="tp",
                      routes=True)
#: llava-next-mistral-7b at TP 4 (mesh (1, 4)) at full width: the llava
#: phase's 4 x (576 stub patches + 512 tokens), 8 teacher-forced steps
#: and 16 of its 32 layers (both cut, from 32 steps and every layer, for
#: the run's time limit, to make room for the enc-dec, SSM and hybrid
#: parts)
MESH_LLAVA = dict(arch="llava-next-mistral-7b", steps=8, layers=16)
#: llava trained at (2, 2) under FSDP + TP at published widths, its depth
#: cut to ``layers`` of 32 (1.17 B parameters): ``steps`` steps of 8 rows
#: of 576 stub patches + 512 text tokens, no checkpoint
MESH_VLM_TRAIN = dict(arch="llava-next-mistral-7b", layers=4, steps=2,
                      mesh="hier", plan="fsdp_tp")
#: the enc-dec, SSM and hybrid at TP 4 (mesh (1, 4)), full width and full
#: depth, each at its one-card phase's batch and prompt (seamless 4 x 1024
#: stub frames, mamba2 4 x 512 tokens, zamba2 2 x 4608 tokens past its
#: 4096-slot rings), ``steps`` teacher-forced decode steps; ``generate``
#: for ``gen`` tokens (cut from 32 for the run's time limit: a rank's
#: decode step takes 0.6-1.4 s over gloo), so seamless's self cache holds
#: 1033 slots
MESH_FAMILY_SERVE = {
    "seamless": dict(arch="seamless-m4t-large-v2", batch=SEAMLESS_BATCH,
                     prompt=SEAMLESS_FRAMES, steps=4, gen=8),
    "mamba2": dict(arch="mamba2-1.3b", batch=BATCH, prompt=MAMBA_PROMPT,
                   steps=4, gen=8),
    "zamba2": dict(arch="zamba2-1.2b", batch=ZAMBA_BATCH,
                   prompt=ZAMBA_PROMPT, steps=4, gen=8)}
#: the enc-dec, SSM and hybrid trained at published widths, their depth
#: cut, ``steps`` steps of the train phase's 8 x 512 batches (the
#: enc-dec's rows with 512 stub frames each), no checkpoint (the disk
#: budget, above :data:`MESH_MOE_TRAIN`): seamless at (2, 2) under FSDP +
#: TP (its 256,206-entry vocab splits over 2), 4 + 4 of 24 + 24 layers
#: (0.73 B parameters, the embedding and head 0.52 B of them); mamba2 at
#: (2, 2) under FSDP + TP, 8 of 48 layers; zamba2 at (1, 4) under TP, 12
#: of 38 layers, which keeps 2 of the shared block's 7 sites.  Each
#: gradient leaf's norm is held to the larger of ``MESH_LEAF_RTOL`` and
#: twice its kind's bf16 noise floor (``noise``: the one card's bf16 step
#: against its f32 step), as the SSM families' serving is held on one
#: card: a Mamba2 layer's per-head ``A_log`` / ``dt_bias`` gradients sum
#: many terms that cancel: on an H100 the one card's own bf16 moves
#: zamba2's ``A_log`` norm 1.2%, and the ranks put its ``dt_bias`` norm
#: 1.995% off the one card's
MESH_FAMILY_TRAIN = {
    "seamless": dict(arch="seamless-m4t-large-v2", layers=4, enc_layers=4,
                     steps=2, mesh="hier", plan="fsdp_tp", noise=True),
    "mamba2": dict(arch="mamba2-1.3b", layers=8, steps=2, mesh="hier",
                   plan="fsdp_tp", noise=True),
    "zamba2": dict(arch="zamba2-1.2b", layers=12, steps=2, mesh="tp",
                   plan="tp", noise=True)}
#: Megatron sequence parallelism on the ranks (``CodesignPlan(seq_parallel=
#: True)``): smollm-360m trained at full width at (2, 2) under FSDP + TP,
#: ``steps`` steps of the train phase's first batches, no checkpoint (the
#: disk budget, above :data:`MESH_MOE_TRAIN`), its step 1 held to the
#: :data:`MESH_TRAIN` trainer's step 1 without the split (the same weights
#: and batch on the same layout); phi3 (:data:`MESH_PHI3`'s layers) and
#: mamba2-1.3b served at TP 4 with and without the split, a prefill and
#: :data:`MESH_SP_STEPS` teacher-forced decode steps
MESH_SP_TRAIN = dict(arch="smollm-360m", steps=2, mesh="hier",
                     plan="fsdp_tp", sp=True)
#: the MoE under the same plan: qwen3-moe-30b-a3b at :data:`MESH_MOE_TRAIN`'s
#: 2 of 48 layers and published widths, (2, 2) under FSDP + EP, ``steps``
#: steps of the train phase's first 8 x 512 batches, no checkpoint (the
#: disk budget), the first step's routing recorded; its step 1 held to
#: the :data:`MESH_MOE_TRAIN` trainer's step 1 without the split
MESH_MOE_SP_TRAIN = dict(arch="qwen3-moe-30b-a3b", layers=2, steps=2,
                         mesh="hier", plan="fsdp_tp", sp=True, routes=True)
MESH_SP_STEPS = 4
#: smollm-360m at TP 4 (mesh (1, 4)), full width and depth: its 15 query
#: heads divide no model axis, so each rank computes every head for its
#: block of the query rows (the query-sequence split): flash at Sq 128 of
#: Sk 512 at offset 128 r on rank r.  :data:`MESH_FAMILY_SERVE`'s parts:
#: 4 x 512 prompts, ``steps`` teacher-forced steps, ``gen`` tokens; then
#: with and without Megatron sequence parallelism (:data:`MESH_SP_STEPS`)
MESH_SMOLLM = dict(arch="smollm-360m", batch=BATCH, prompt=512, steps=4,
                   gen=8)
#: the kernel at a rank's query block: (name, B, Hq, Hkv, Sq, Sk, hd,
#: window, offset, dtype): smollm-360m's rank at each offset of its 4-way
#: split; gemma3's local layer (hd 256, window 512) split four ways over
#: 1024 keys, the last block; the f32 kernel at smollm's rank shape
FLASH_OFFSET_ROWS = (
    [(f"smollm flash q_offset {o}", 4, 15, 5, 128, 512, 64, 0, o, "bfloat16")
     for o in (0, 128, 256, 384)]
    + [("gemma3 local flash q_offset 768", 4, 4, 1, 256, 1024, 256, 512,
        768, "bfloat16"),
       ("smollm flash f32 q_offset 256", 4, 15, 5, 128, 512, 64, 0, 256,
        "float32")])
#: the mesh's step-1 loss, gradient norm and worst leaf's gradient norm
#: against the one-card step's on the same weights and batch, relative:
#: the same bf16 model, its partial sums added in f32 in another order and
#: rounded once.  Readings on the card: loss 5.1e-6, norm 5.7e-5, worst
#: leaf 3.3e-3 (a norm weight's, 0.004 of 2.56); dropping the gradients'
#: sum over the data axis moved the worst leaf by 42% (smoke width, CPU)
MESH_LOSS_RTOL, MESH_NORM_RTOL, MESH_LEAF_RTOL = 1e-4, 1e-3, 2e-2
#: qwen3-moe's step 1: the least share, in any layer, of the ranks'
#: (token, expert) decisions that the one card's own router makes on the
#: same batch.  The ranks' layer inputs differ by rounding, and from the
#: second layer on by the pairs past an expert's capacity the mesh drops
#: (the one card drops none); a rank routing another rank's tokens, or
#: another top-k, agrees on about k / E = 8 / 128 of them
MESH_ROUTE_AGREE = 0.95
#: compressed_psum: 64 MiB of f32 a rank; hierarchical_psum: 16 MiB
CPSUM_VALUES, HPSUM_VALUES = 16 * 2**20, 4 * 2**20
#: the reference test's bound on a compressed sum (its largest error as a
#: share of the exact sum's largest magnitude)
CPSUM_SHARE = 0.05
#: the pipeline's output against the same 8 layers run straight through in
#: one process, as a share of its largest magnitude: the same kernels at
#: the same shapes, but another process may take other GEMM algorithms
#: (a few bf16 ulps through 8 layers)
PIPE_SHARE = 0.01


def _mesh_ms(torch, fn) -> dict:
    """Host wall ms and device ms (CUDA events on the rank's stream) of one
    call of ``fn``, labelled as :data:`MESH_LABEL`."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, {"wall_ms": (time.perf_counter() - t0) * 1e3,
                 "device_ms": s.elapsed_time(e), "label": MESH_LABEL}


def _digest(torch, t) -> str:
    return _sha(t.float().cpu().contiguous()) if t.is_cuda else _sha(t)


def _rank_collectives(torch, rank, meshes):
    """``compressed_psum`` over the 4 ranks on 64 MiB of f32 a rank (the
    quantize and dequantize kernels), against the exact sum and against the
    same exchange of the same values on the CPU (the plain quantizer:
    the same codes, so the same bits); ``hierarchical_psum`` on (2, 2),
    plain and with ``compress_inter``."""
    from repro_torch.kernels import build
    from repro_torch.parallel.collectives import (compressed_psum,
                                                  hierarchical_psum, psum)
    mesh, hmesh = meshes["tp"], meshes["hier"]
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    x = torch.randn(CPSUM_VALUES, generator=g, device="cuda")
    exact = psum(x, mesh, "model")
    torch.cuda.synchronize()
    build.reset_launches()
    got, t = _mesh_ms(torch, lambda: compressed_psum(x, mesh, "model"))
    launches = build.launch_counts()
    plain = compressed_psum(x.cpu(), mesh, "model")
    err = (got - exact).abs().max().item()
    out = {"values": CPSUM_VALUES, "launches": launches, **t,
           "max_abs_err": err, "exact_scale": exact.abs().max().item(),
           "plain_equal": bool(torch.equal(got.cpu(), plain)),
           "digest": _digest(torch, got)}
    hx = torch.randn(HPSUM_VALUES, generator=g, device="cuda")
    hexact = psum(hx, hmesh, ("data", "model"))
    for name, c in (("hier", False), ("hier_compressed", True)):
        build.reset_launches()
        h, t = _mesh_ms(torch, lambda: hierarchical_psum(
            hx, hmesh, intra_axis="model", inter_axis="data",
            compress_inter=c))
        out[name] = {"values": HPSUM_VALUES, "launches": build.launch_counts(),
                     **t, "max_abs_err": (h - hexact).abs().max().item(),
                     "exact_scale": hexact.abs().max().item()}
    return out


def _forced_run(torch, server, batch, forced, steps, ctx=None,
                timed=None):
    """Prefill ``batch`` (its tokens and a VLM's ``extra_embeds`` or an
    enc-dec's ``frames``) and
    ``steps`` decode steps teacher-forced with ``forced``, under ``ctx``
    (the server's unless given): the logits of each, (steps + 1, B, V) f32
    on the card, and the cache.  With ``timed`` (a dict, on a rank), the
    prefill is timed (``_mesh_ms``) into ``timed["prefill"]`` and the
    collectives it ran into ``timed["collectives"]``
    (``collectives.spent_since``)."""
    from repro_torch.parallel import collectives
    ctx = ctx or server.ctx
    inputs = {"tokens": server._on_device(batch["tokens"], torch.int32)}
    for key in ("extra_embeds", "frames"):
        if key in batch:
            inputs[key] = server._on_device(batch[key])

    def prefill():
        return server.api.prefill(server.params, inputs, ctx, server.max_len)
    if timed is None:
        logits, cache = prefill()
    else:
        c0 = collectives.spent()
        (logits, cache), timed["prefill"] = _mesh_ms(torch, prefill)
        timed["collectives"] = collectives.spent_since(c0)
    out = [logits[:, -1].float()]
    f = server._on_device(forced, torch.int32)
    for t in range(steps):
        logits, cache = server.api.decode_step(server.params, cache,
                                               f[:, t:t + 1], ctx)
        out.append(logits[:, -1].float())
    return torch.stack(out), cache


def _rank_serve(torch, rank, meshes, lm, arch, layers, batch, steps,
                ref_path=None, kv_digest=None, gen=GEN):
    """One rank of ``Server(cfg, mesh)`` on its views of the parent's
    weights (``shard_params``: no copy): ``generate`` for ``gen`` tokens (the
    launch counts set to 0 just before and read just after; rank 0 streams
    through the mover), one prefill and one decode step timed, the
    teacher-forced logits over ``steps`` steps (phi3: with the parent's
    tokens, held to its one-process logits in ``ref_path``; mixtral: with
    the ranks' own tokens, the routing recorded for the parent), and, on
    rank 0 with ``kv_digest``, its prefill's KV items staged under the
    accel digest."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    from repro_torch.models import blocks, ffn
    from repro_torch.weights import shard_params
    published = get_config(arch)
    cfg = (dataclasses.replace(published, n_layers=layers) if layers
           else published)
    mesh = meshes["tp"]
    # a VLM's cache also holds its patch positions
    prompt = batch["tokens"].shape[1] + (cfg.frontend_len if cfg.frontend
                                         else 0)
    server = Server(cfg, mesh, device="cuda", max_len=prompt + gen + 1)
    server.params = shard_params(lm, cfg, mesh)
    out = {"params": sum(p.numel() for p in server.params.parameters())}
    torch.cuda.synchronize()
    build.reset_launches()
    blocks.reset_query_rows()
    t0 = time.monotonic()
    tokens = server.generate(batch, gen)
    torch.cuda.synchronize()
    out["generate_s"] = time.monotonic() - t0
    out["launches"] = build.launch_counts()
    out["query_rows"] = blocks.query_rows()
    out["tokens"] = tokens
    (_, cache), out["prefill"] = _mesh_ms(torch,
                                          lambda: server.prefill(batch))
    tok = server._on_device(tokens[:, :1], torch.int32)

    def step():
        cache["pos"] = prompt
        server.decode(cache, tok)
    step()
    _, out["decode_step"] = _mesh_ms(torch, step)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log = ffn.RouteLog() if cfg.moe else None
    forced = tokens if ref_path is None else torch.load(ref_path)["tokens"]
    logits, cache = _forced_run(
        torch, server, batch, forced, steps,
        ctx=dataclasses.replace(server.ctx, routes=log))
    out["logits_digest"] = _digest(torch, logits)
    if ref_path is not None:
        ref = torch.load(ref_path)["logits"].to("cuda")
        out["logits_max_abs_err"] = (logits - ref).abs().amax(
            dim=(1, 2)).tolist()
        out["logits_scale"] = ref.abs().max().item()
    else:
        out["logits"] = logits.cpu()
    if log is not None:
        out["routes"] = [(e.cpu(), k.cpu(), first, total) for (e, _), (
            k, first, total) in zip(log.calls, log.kept)]
    if rank == 0 and kv_digest:
        items = [cache[n][i] for i in range(cache["k"].shape[0])
                 for n in ("k", "v")]
        build.reset_launches()
        t0 = time.monotonic()
        received, report = _stage_kv(torch, items, kv_digest,
                                     pageable_gbps(torch, items[0]))
        out["stage"] = dict(
            items=len(items), item_bytes=items[0].nbytes,
            stage_s=time.monotonic() - t0, folds=report.checksum_folds,
            launches=build.launch_counts(),
            **kv_staged_ok(items, received, report))
    del server, cache, logits
    return out


def _rank_sp_serve(torch, rank, meshes, lm, arch, layers, batch, steps,
                   ref_path):
    """One rank of ``Server(cfg, mesh, plan=CodesignPlan(sharding="tp",
    seq_parallel=...))`` on its views of the parent's weights, without and
    with sequence parallelism: each one's logits over a prefill and
    ``steps`` decode steps teacher-forced with the parent's tokens (the
    launch counts set to 0 just before, read just after), its prefill
    timed with its collectives by kind, and the peak memory; the
    largest difference of the two runs' logits, and of each from the
    parent's one-process logits, step by step.  An MoE's split run takes
    the unsplit run's expert choices and kept pairs on this rank
    (``RouteLog(forced=...)``: the same tokens route on the same rank
    under the plan), and each run's kept pairs are recorded."""
    from repro_torch.configs import get_config
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Server
    from repro_torch.models import blocks, ffn
    from repro_torch.weights import shard_params
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    mesh = meshes["tp"]
    saved = torch.load(ref_path)
    ref = saved["logits"][:steps + 1].to("cuda")
    out, logits, logs = {}, {}, {}
    for sp in (False, True):
        server = Server(cfg, mesh, device="cuda",
                        max_len=batch["tokens"].shape[1] + GEN + 1,
                        plan=CodesignPlan(sharding="tp", seq_parallel=sp))
        server.params = shard_params(lm, cfg, mesh)
        ctx = server.ctx
        if cfg.moe:
            logs[sp] = ffn.RouteLog(forced=[
                (e, k) for (e, _), (k, _, _) in zip(logs[False].calls,
                                                    logs[False].kept)]
                if sp else None)
            ctx = dataclasses.replace(ctx, routes=logs[sp])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        blocks.reset_query_rows()
        timed: dict = {}
        logits[sp], _ = _forced_run(torch, server, batch, saved["tokens"],
                                    steps, ctx=ctx, timed=timed)
        torch.cuda.synchronize()
        run = {"launches": build.launch_counts(),
               "query_rows": blocks.query_rows(),
               "prefill": timed["prefill"]}
        coll = timed["collectives"]
        run["prefill_collective_s"] = {"all": coll["seconds"],
                                       **coll["kinds"]}
        run["prefill_collective_share"] = {
            "all": coll["seconds"] * 1e3 / run["prefill"]["wall_ms"],
            **{k: v * 1e3 / run["prefill"]["wall_ms"]
               for k, v in coll["kinds"].items()}}
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if cfg.moe:
            kept = logs[sp].kept
            run.update(route_calls=len(kept),
                       pairs=sum(k.numel() for k, _, _ in kept),
                       dropped_pairs=sum(int((~k).sum()) for k, _, _ in kept))
        run["vs_one_process_max_abs_err"] = (logits[sp] - ref).abs().amax(
            dim=(1, 2)).tolist()
        run["logits_digest"] = _digest(torch, logits[sp])
        out["sp" if sp else "nosp"] = run
        del server
    out["sp_vs_nosp_max_abs_err"] = (logits[True] - logits[False]).abs(
        ).amax(dim=(1, 2)).tolist()
    out["logits_scale"] = logits[False].abs().max().item()
    if cfg.moe:
        # each call's kept pairs, first token and token count, both runs
        a, b = logs[True].kept, logs[False].kept
        out["kept_same"] = len(a) == len(b) and all(
            x[1:] == y[1:] and bool(torch.equal(x[0], y[0]))
            for x, y in zip(a, b))
    return out


def _rank_moe_layer(torch, rank, meshes, lm, arch, layers, tokens, rows):
    """Layer 0's MoE on the same ``tokens`` x d_model unit-rms values on
    every rank, through ``moe_ep`` (the rank's experts) and ``moe_tp``
    (every expert's quarter of d_ff), each at the config's capacity
    factor, with their routing and kept pairs; rank 0 writes both
    outputs for the parent.  Then the same layer entered from the rank's
    chunk of each of ``rows`` rows' sequence under Megatron sequence
    parallelism (``blocks.ffn_apply(..., sp=True)``, each path forced),
    held on the rank to the unsplit output's rows of that chunk
    (``MOE_TOL``; bit for bit recorded) and to the unsplit call's kept
    pairs, first token and token count, exactly."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, ffn
    from repro_torch.parallel.sharding import shard_tensor
    cfg = get_config(arch)
    mesh = meshes["tp"]
    moe = lm.layers[0].moe
    g = torch.Generator(device="cuda").manual_seed(tokens)
    x = torch.randn(1, tokens, cfg.d_model, generator=g, device="cuda").to(
        torch.bfloat16)
    S = tokens // rows
    c = S // mesh.axis_size("model")
    lo = mesh.axis_index("model") * c
    out = {}
    for impl, fn, up, down in (
            ("ep", ffn.moe_ep, ("model", None, None), ("model", None, None)),
            ("tp", ffn.moe_tp, (None, None, "model"),
             (None, "model", None))):
        log = ffn.RouteLog()
        w = types.SimpleNamespace(
            router=moe.router, w_gate=shard_tensor(moe.w_gate, up, mesh),
            w_up=shard_tensor(moe.w_up, up, mesh),
            w_down=shard_tensor(moe.w_down, down, mesh))
        (y, _, _), t = _mesh_ms(torch, lambda: fn(
            x, w.router, w.w_gate, w.w_up, w.w_down, cfg=cfg, mesh=mesh,
            batch_axes=("data",), log=log))
        keep, first, total = log.kept[0]
        out[impl] = {"timing": t, "digest": _digest(torch, y),
                     "experts": log.calls[0][0].cpu(), "keep": keep.cpu(),
                     "first": first, "total": total}
        if rank == 0:
            out[impl]["y"] = y.cpu()
        slog = ffn.RouteLog()
        ctx = blocks.ShardCtx(impl="cuda", mesh=mesh, moe_impl=impl,
                              seq_parallel=True, routes=slog)
        chunk = x.view(rows, S, cfg.d_model)[:, lo:lo + c].contiguous()
        (ys, _, _), ts = _mesh_ms(torch, lambda: blocks.ffn_apply(
            chunk, types.SimpleNamespace(moe=w), cfg, ctx, sp=True))
        want = y.view(rows, S, cfg.d_model)[:, lo:lo + c]
        err, ok = _within(torch, ys, want, **MOE_TOL)
        skeep, sfirst, stotal = slog.kept[0]
        out[impl]["sp"] = {
            "timing": ts, "chunk": list(chunk.shape), "max_abs_err": err,
            "within_ok": ok, "bits_equal": bool(torch.equal(ys, want)),
            "kept_same": bool(torch.equal(skeep, keep))
            and (sfirst, stotal) == (first, total),
            "dropped_pairs": int((~skeep).sum())}
    return out


def _check_mesh_moe_layer(torch, cfg, moe, outs, T) -> dict:
    """The ranks' ``moe_ep`` and ``moe_tp`` outputs (rank 0's; every rank's
    digest) against the one-process ``moe_dispatch`` on the same T tokens
    under each path's expert choices and kept pairs (a dropped pair gates
    0): within ``MOE_TOL`` over every token, and over the tokens that lost
    no pair; the share of dropped pairs; and each path entered from the
    ranks' sequence chunks (``<path>_sp_ok``: every rank's chunk within
    ``MOE_TOL`` of the unsplit output, its kept pairs the same)."""
    from repro_torch.models import ffn
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(1, T, cfg.d_model, generator=g, device="cuda").to(
        torch.bfloat16)
    out = {"tokens": T, "label": MESH_LABEL}
    for impl in ("ep", "tp"):
        parts = [o[impl] for o in outs]
        k = cfg.moe.top_k
        e = torch.zeros((T, k), dtype=torch.int64)
        keep = torch.zeros((T, k), dtype=torch.bool)
        for p in parts:
            n = len(p["experts"])
            e[p["first"]:p["first"] + n] = p["experts"]
            keep[p["first"]:p["first"] + n] = p["keep"]
        log = ffn.RouteLog(forced=[(e.cuda(), keep.cuda())])
        want, _, _ = ffn.moe_dispatch(x, moe.router, moe.w_gate, moe.w_up,
                                      moe.w_down, cfg=cfg, log=log)
        got = parts[0]["y"].to("cuda")
        err, ok = _within(torch, got, want, **MOE_TOL)
        whole = keep.all(dim=1).cuda()
        err_kept, ok_kept = _within(torch, got[0][whole], want[0][whole],
                                    **MOE_TOL)
        out[impl] = dict(max_abs_err=err, kept_tokens_max_abs_err=err_kept,
                         dropped_pairs=int((~keep).sum()),
                         dropped_share=float((~keep).float().mean()),
                         tokens_with_a_drop=int((~whole).sum()),
                         timing=[p["timing"] for p in parts])
        out[f"{impl}_ok"] = ok and ok_kept
        out[f"{impl}_experts"] = e
        sp = [p["sp"] for p in parts]
        out[impl]["sp"] = dict(
            chunk=sp[0]["chunk"],
            max_abs_err=max(r["max_abs_err"] for r in sp),
            bits_equal=[r["bits_equal"] for r in sp],
            dropped_pairs=[r["dropped_pairs"] for r in sp],
            timing=[r["timing"] for r in sp])
        out[f"{impl}_sp_ok"] = all(r["within_ok"] and r["kept_same"]
                                   for r in sp)
    out["ep_tp_same_routing"] = float(
        (out.pop("ep_experts").sort(-1).values
         == out.pop("tp_experts").sort(-1).values).all(-1).float().mean())
    out["same_ok"] = all(len({o[i]["digest"] for o in outs}) == 1
                         for i in ("ep", "tp"))
    return out


def _rank_pipeline(torch, rank, meshes, lm, arch, ref_path):
    """The rank's stage of ``pipeline_forward``: its 2 layers (views of the
    parent's), the microbatches (the embeddings of the parent's tokens),
    the output held to the parent's one-process forward in ``ref_path``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.blocks import ShardCtx, dense_layer_apply
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = meshes["pipe"]
    cfg = get_config(arch)
    per = MESH_PIPE["per_stage"]
    stage = mesh.axis_index("pod")
    slab = list(lm.layers[stage * per:(stage + 1) * per])
    ref = torch.load(ref_path)
    x = lm.embed[ref["tokens"].to("cuda").long()]
    pos = torch.arange(x.shape[2], dtype=torch.int32, device="cuda")
    ctx = ShardCtx(impl="cuda")

    def layer_fn(ps, h):
        for lp in ps:
            h = dense_layer_apply(h, lp, cfg, ctx, positions=pos)
        return h
    torch.cuda.synchronize()
    build.reset_launches()
    with torch.no_grad():
        y, t = _mesh_ms(torch, lambda: pipeline_forward(
            layer_fn, slab, x, mesh=mesh, stage_axis="pod",
            layers_per_stage=per))
    launches = build.launch_counts()
    want = ref["y"].to("cuda")
    return {"launches": launches, "timing": t,
            "max_abs_err": (y.float() - want.float()).abs().max().item(),
            "scale": want.float().abs().max().item(),
            "exact": bool(torch.equal(y, want)), "digest": _digest(torch, y)}


def _train_cfg(spec: dict):
    """A mesh training part's config: the published one, its depth cut to
    ``spec["layers"]`` (and an enc-dec's encoder to ``spec["enc_layers"]``)
    where given."""
    from repro_torch.configs import get_config
    cut = {k: spec[v] for k, v in (("n_layers", "layers"),
                                   ("enc_layers", "enc_layers")) if v in spec}
    return dataclasses.replace(get_config(spec["arch"]), **cut)


def _timed_trainer(torch, saves: list, restores: list):
    """``Trainer``, timing each save and restore on this rank into
    ``saves`` and ``restores``, and making no save at the end of a run
    (the mesh phase's disk budget, above :data:`MESH_MOE_TRAIN`)."""
    from repro_torch.launch.train import Trainer

    def mesh_of(t):
        return list(t.mesh.shape.values())

    class Timed(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            save = self.ckpt.maybe_save

            def maybe_save(step, tree, **k):
                if k.get("force"):
                    return False
                # the save gathers each leaf whole on every rank: give back
                # the step's cached blocks first, which the other ranks
                # sharing the card cannot use
                torch.cuda.empty_cache()
                t0 = time.monotonic()
                done = save(step, tree, **k)
                if done:
                    saves.append({"step": step, "mesh": mesh_of(self),
                                  "seconds": time.monotonic() - t0})
                return done
            self.ckpt.maybe_save = maybe_save

        def try_restore(self):
            t0 = time.monotonic()
            ok = super().try_restore()
            torch.cuda.synchronize()
            restores.append({"step": self.step_idx if ok else None,
                             "mesh": mesh_of(self),
                             "seconds": time.monotonic() - t0})
            return ok
    return Timed


def _step_log(log) -> list:
    return [{k: r[k] for k in ("step", "loss", "grad_norm", "wall_s",
                               "collective_s", "collective_kinds_s")}
            for r in log]


def _rank_train(torch, rank, meshes, root, spec):
    """The rank's part of training ``spec``'s model on the ranks
    (:data:`MESH_TRAIN`, :data:`MESH_MOE_TRAIN`): ``Trainer(cfg, mesh)``
    on ``spec["mesh"]`` under ``spec["plan"]`` with checkpoints into
    ``root`` and an injected failure, then a trainer on
    ``spec["elastic"]`` under its plan that restores the last checkpoint
    (the elastic restore) and trains on, saving nothing, from the batch
    the first trainer's step after its restore took (its batches
    ``fail_at`` steps, the one the failure drew, then the rest), so the
    two layouts take that step on the same weights and batch.  Each save and
    restore timed on this rank; rank 0's writes; the launch counts (set
    to 0 just before); with ``spec["routes"]``, the routing of the first
    step's forward."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SyntheticTokenSource)
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import blocks, ffn
    from repro_torch.models import lm as lm_lib
    cfg = _train_cfg(spec)
    total = spec["steps"] + spec["more"] + 1
    saves, restores = [], []
    Timed = _timed_trainer(torch, saves, restores)

    def plan(name):
        return CodesignPlan(sharding=name, seq_parallel=False)

    def source(skip=0):
        """The train phase's batches from the ``skip``-th on."""
        src = SyntheticTokenSource(cfg, PipelineConfig(
            TRAIN_BATCH, TRAIN_SEQ, seed=SEED), n_batches=16)

        class From:
            pc = src.pc

            def __iter__(self):
                return itertools.islice(iter(src), skip, None)
        return From()
    out = {"leaf_norms": [], "kept": [], "query_rows": [],
           "card_free_gib_at_start": torch.cuda.mem_get_info()[0] / 2**30}
    _record_leaf_norms(torch, out["leaf_norms"], out["kept"],
                       out["query_rows"])
    routes = ffn.RouteLog() if spec.get("routes") else None
    make_ctx = steps_lib.make_ctx
    with torch.enable_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.monotonic()
        if routes is not None:         # the first trainer's steps log
            steps_lib.make_ctx = lambda *a, **k: dataclasses.replace(
                make_ctx(*a, **k), routes=routes)
        try:
            a = Timed(cfg, meshes[spec["mesh"]], plan=plan(spec["plan"]),
                      device="cuda", ckpt_dir=root,
                      ckpt_every=spec["every"], total_steps=total)
        finally:
            steps_lib.make_ctx = make_ctx
        a.init_state(SEED)
        out["params_held"] = sum(p.numel() for p in a.params.parameters())
        lm_lib.reset_kept()
        blocks.reset_query_rows()
        out["log"] = _step_log(a.run(source(), spec["steps"],
                                     inject_failure_at=spec["fail_at"]))
        torch.cuda.synchronize()
        out["writes"] = list(a.ckpt.history)
        out["peak_gib_train"] = torch.cuda.max_memory_allocated() / 2**30
        del a
        gc.collect()
        b = Timed(cfg, meshes[spec["elastic"]],
                  plan=plan(spec["elastic_plan"]), device="cuda",
                  ckpt_dir=root, ckpt_every=10**6, total_steps=total)
        b.init_state(SEED)
        out["elastic_ok"] = b.try_restore()
        out["elastic_params_held"] = sum(p.numel()
                                         for p in b.params.parameters())
        b.ckpt = None
        out["elastic_log"] = _step_log(b.run(source(spec["fail_at"] + 1),
                                             spec["more"]))
        torch.cuda.synchronize()
        out["run_s"] = time.monotonic() - t0
        out["launches"] = build.launch_counts()
        out["final_step"] = b.step_idx
        del b
    if routes is not None:
        L = cfg.n_layers
        out["routes"] = [(e.cpu(), k.cpu(), first, n) for (e, _), (
            k, first, n) in zip(routes.calls[:L], routes.kept[:L])]
    out.update(saves=saves, restores=restores,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def _rank_steps(torch, rank, meshes, spec, batches):
    """The rank's part of training ``spec``'s model on the ranks
    (:data:`MESH_VLM_TRAIN`, :data:`MESH_FAMILY_TRAIN`,
    :data:`MESH_SP_TRAIN`): ``make_train_step`` on ``spec["mesh"]`` under
    ``spec["plan"]`` (with ``spec["sp"]``, sequence parallelism) on its
    rows of ``batches`` (a VLM's carry patch embeddings, which the
    trainer's input feed does not make; an enc-dec's stub frames), each
    step timed; the values the checkpointed layer bodies keep at step 1;
    the launch counts (set to 0 just before); with ``spec["routes"]``,
    the routing of the first step's forward."""
    from repro_torch.core.codesign import CodesignPlan
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import blocks, ffn
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.api import build as build_api
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import collectives
    from repro_torch.weights import init_sharded
    cfg = _train_cfg(spec)
    mesh = meshes[spec["mesh"]]
    plan = CodesignPlan(sharding=spec["plan"],
                        seq_parallel=spec.get("sp", False))
    out = {"leaf_norms": [], "kept": [], "query_rows": [], "log": []}
    _record_leaf_norms(torch, out["leaf_norms"], out["kept"],
                       out["query_rows"])
    n = len(batches[0]["tokens"]) // mesh.axis_size(("data",))
    lo = mesh.axis_index(("data",)) * n
    with torch.enable_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        lm_lib.reset_kept()
        blocks.reset_query_rows()
        lm = init_sharded(cfg, SEED, mesh, device="cuda", plan=plan,
                          trainable=True)
        out["params_held"] = sum(p.numel() for p in lm.parameters())
        opt = adamw_init(lm.parameters())
        routes = ffn.RouteLog() if spec.get("routes") else None
        make_ctx = steps_lib.make_ctx
        if routes is not None:          # the steps log their routing
            steps_lib.make_ctx = lambda *a, **k: dataclasses.replace(
                make_ctx(*a, **k), routes=routes)
        try:
            step, _ = steps_lib.make_train_step(build_api(cfg), mesh, plan,
                                                warmup=1, total_steps=10)
        finally:
            steps_lib.make_ctx = make_ctx
        for i, b in enumerate(batches):
            rows = {k: v[lo:lo + n].cuda() for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.monotonic()
            c0 = collectives.spent()
            lm, opt, m = step(lm, opt, rows)
            loss = float(m["loss"])
            coll = collectives.spent_since(c0)
            out["log"].append({
                "step": i + 1, "loss": loss,
                "grad_norm": float(m["grad_norm"]),
                "wall_s": time.monotonic() - t0,
                "collective_s": coll["seconds"],
                "collective_kinds_s": coll["kinds"]})
        out["launches"] = build.launch_counts()
        del lm, opt
    if routes is not None:
        L = cfg.n_layers
        out["routes"] = [(e.cpu(), k.cpu(), first, n) for (e, _), (
            k, first, n) in zip(routes.calls[:L], routes.kept[:L])]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _record_leaf_norms(torch, into: list, kept: list,
                       rows: list | None = None) -> None:
    """Wraps the train step's AdamW update in this rank so that its first
    call appends to ``into`` the whole norm of each gradient leaf (its
    squares summed over the axes the leaf is split over, each leaf held
    whole on several ranks counted once, a head-wise leaf's B and C columns
    too: ``norm_weights``), in parameter order, to ``kept`` the values
    the checkpointed layer bodies have kept since ``lm.reset_kept`` and
    to ``rows`` the query rows attention was fed since
    ``blocks.reset_query_rows``: the first step's, where they were reset
    just before."""
    from repro_torch.launch import steps
    from repro_torch.models import blocks
    from repro_torch.models import lm as lm_lib
    from repro_torch.parallel.collectives import psum
    update = steps.adamw_update

    def first_call(grads, state, params, *, mesh=None, split_axes=None,
                   norm_weights=None, **kw):
        if not into:
            kept.append(lm_lib.kept_values())
            if rows is not None:
                rows.append(blocks.query_rows())
            groups: dict = {}
            for i, axes in enumerate(split_axes):
                key = tuple(a for a in mesh.axis_names if a in axes)
                groups.setdefault(key, []).append(i)
            weights = norm_weights or [None] * len(grads)
            sq = [0.0] * len(grads)
            for key in sorted(groups):
                idx = groups[key]
                part = psum(torch.stack([torch.sum(torch.square(
                    grads[i].float()) * (1.0 if weights[i] is None
                                         else weights[i]))
                    for i in idx]), mesh, key)
                for i, v in zip(idx, part.tolist()):
                    sq[i] = v
            into.extend(math.sqrt(v) for v in sq)
        return update(grads, state, params, mesh=mesh,
                      split_axes=split_axes, norm_weights=norm_weights, **kw)
    steps.adamw_update = first_call


MESH_PARTS = {"collectives": _rank_collectives, "serve": _rank_serve,
              "moe_layer": _rank_moe_layer, "pipeline": _rank_pipeline,
              "train": _rank_train, "steps": _rank_steps,
              "sp_serve": _rank_sp_serve}


def mesh_rank(rank, world, port, cmds, results):
    """A rank of the mesh phase (a spawned process): joins the gloo world,
    builds the meshes, then runs each part the parent sends until told to
    stop.  A part's error goes back to the parent with its traceback, and
    the rank exits non-zero."""
    import traceback
    try:
        sys.path.insert(0, SRC)
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch.mesh import init_world, make_mesh
        init_world("gloo", rank=rank, world_size=world,
                   init_method=f"tcp://127.0.0.1:{port}",
                   timeout_s=MESH_COLLECTIVE_S)
        meshes = {"tp": make_mesh((1, world), ("data", "model")),
                  "hier": make_mesh((2, world // 2), ("data", "model")),
                  "fsdp": make_mesh((world, 1), ("data", "model")),
                  "pipe": make_mesh((world,), ("pod",))}
        while True:
            part, kw = cmds.get()
            if part is None:
                break
            with torch.no_grad():
                out = MESH_PARTS[part](torch, rank, meshes, **kw)
            del kw
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.ipc_collect()
            results.put((rank, part, out, None))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, None, None, traceback.format_exc()))
        raise SystemExit(1)


class MeshWorld:
    """The mesh phase's four spawned ranks: :meth:`run` sends every rank a
    part and waits for all four results; a rank's error, exit or silence
    past :data:`MESH_PART_S` fails the run with every traceback that came
    back.  :meth:`close` stops and joins every rank, killing what is left."""

    def __init__(self, world: int):
        import torch.multiprocessing as tmp
        from repro_torch.launch.mesh import free_port
        # torch's pickler: card tensors reach the ranks by CUDA IPC
        ctx = tmp.get_context("spawn")
        self.cmds = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = free_port()
        # one thread a rank: four ranks share the host's cores
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self.procs = [ctx.Process(target=mesh_rank, daemon=True,
                                      args=(r, world, port, self.cmds[r],
                                            self.results))
                          for r in range(world)]
            for p in self.procs:
                p.start()
        finally:
            if old is None:
                os.environ.pop("OMP_NUM_THREADS")
            else:
                os.environ["OMP_NUM_THREADS"] = old

    def run(self, part: str, per_rank=None, **kw) -> list:
        """Each rank's result of ``part`` (``per_rank(r)`` adds rank r's own
        arguments), in rank order."""
        for r, q in enumerate(self.cmds):
            q.put((part, dict(kw, **(per_rank(r) if per_rank else {}))))
        got, errors = {}, []
        deadline = time.monotonic() + MESH_PART_S
        import queue
        while len(got) < len(self.procs) and not errors:
            try:
                rank, _, out, err = self.results.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks {dead} exited" if dead else
                                  f"no result of {part} in {MESH_PART_S} s")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                got[rank] = out
        if errors:
            # give the other ranks a moment to report theirs
            t_end = time.monotonic() + 5
            while time.monotonic() < t_end:
                try:
                    rank, _, _, err = self.results.get(timeout=1)
                except queue.Empty:
                    break
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
            self.close()
            fail(f"the mesh phase's {part} part failed:\n"
                 + "\n".join(errors))
        return [got[r] for r in range(len(self.procs))]

    def close(self) -> list:
        for p, q in zip(self.procs, self.cmds):
            if p.is_alive():
                q.put((None, None))
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        return [p.exitcode for p in self.procs]


def _summed(outs, key="launches") -> dict:
    total = {}
    for o in outs:
        for k, v in o[key].items():
            total[k] = total.get(k, 0) + v
    return total


def _assemble_routes(torch, outs) -> list:
    """The ranks' routing of each MoE call as one run's: (experts (T, k),
    kept (T, k)) over the call's whole token range, each rank's share
    placed at its span (ranks that route the same tokens agree)."""
    calls = []
    for parts in zip(*(o["routes"] for o in outs)):
        total = parts[0][3]
        e = torch.zeros((total, parts[0][0].shape[1]), dtype=torch.int64)
        k = torch.zeros((total, parts[0][0].shape[1]), dtype=torch.bool)
        for experts, keep, first, _ in parts:
            e[first:first + len(experts)] = experts
            k[first:first + len(keep)] = keep
        calls.append((e, k))
    return calls


def _route_agreement(torch, mesh_calls, one_calls, n_experts) -> list:
    """Per MoE layer, the share of the ranks' (token, expert) decisions
    (``_assemble_routes``) that the one card's router made too on the same
    batch."""
    shares = []
    for (e, _), (f, _) in zip(mesh_calls, one_calls):
        e, f = e.cpu(), f.cpu().reshape(e.shape)
        a = torch.zeros((e.shape[0], n_experts), dtype=torch.bool)
        b = torch.zeros_like(a)
        a.scatter_(1, e, True)
        b.scatter_(1, f, True)
        shares.append(int((a & b).sum()) / e.numel())
    return shares


def _rank_heads(cfg, m: int):
    """The heads model rank 0 of a (1, m) mesh computes
    (``ShardCtx.heads``): the kernels' per-rank shapes."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.blocks import ShardCtx
    mesh = Mesh({"data": 1, "model": m}, ("data", "model"), rank=0,
                coords={"data": 0, "model": 0})
    return ShardCtx(mesh=mesh).heads(cfg)


def query_split(cfg, shape, S: int) -> bool:
    """Whether ``cfg``'s attention over ``S`` positions splits its query
    rows over the model axis of a mesh of ``shape`` (data, model)
    (``ShardCtx.seq_parallel_attn``: its query heads divide no model axis
    m > 1, and m divides S); never for the SSM family, which has no
    attention."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.blocks import ShardCtx
    mesh = Mesh({"data": shape[0], "model": shape[1]}, ("data", "model"),
                rank=0, coords={"data": 0, "model": 0})
    return cfg.family != "ssm" and ShardCtx(mesh=mesh).seq_parallel_attn(
        cfg.n_heads, S)


def split_rows_ok(records, shape, S: int, calls=None) -> bool:
    """Each rank's record of the query rows it fed attention
    (``blocks.query_rows``, in rank order) under the query-sequence split
    of ``S`` positions on a mesh of ``shape``: rank r (model index i = r %
    m) fed exactly the block ``[i S/m, (i + 1) S/m)`` of every such
    sequence (``calls`` times, where given), and a decode step's one row
    whole."""
    m = shape[1]
    c = S // m
    for r, rows in enumerate(records):
        want = ((r % m) * c, (r % m + 1) * c, S)
        if want not in rows or (calls is not None and rows[want] != calls):
            return False
        if any(key != want and key != (0, 1, 1) for key in rows):
            return False
    return True


def _rows_json(rows: dict) -> list:
    """A query-rows record as JSON: [first, end, S, calls] rows."""
    return [list(key) + [n] for key, n in sorted(rows.items())]


def nccl_check(torch) -> dict:
    """The production backend on the card at a world of one: one
    ``all_reduce`` and one ``all_to_all_single`` of card tensors."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import free_port, init_world
    init_world("nccl", rank=0, world_size=1,
               init_method=f"tcp://127.0.0.1:{free_port()}", timeout_s=60)
    try:
        x = torch.arange(1024, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y)
        z = torch.empty_like(x)
        dist.all_to_all_single(z, x)
        torch.cuda.synchronize()
        ok = bool(torch.equal(y, x) and torch.equal(z, x))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return emit("nccl", world=1, backend=backend, ok=ok)


def _first_batch(torch, cfg) -> dict:
    """The train phase's first batch (the trainers' first step's), on the
    card."""
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SyntheticTokenSource)
    first = next(iter(SyntheticTokenSource(cfg, PipelineConfig(
        TRAIN_BATCH, TRAIN_SEQ, seed=SEED), n_batches=1)))
    return {k: torch.from_numpy(v).cuda() for k, v in first.items()}


def _one_card_step(torch, api, params, batch, ctx, noise=False) -> dict:
    """The loss, the gradient norm and each gradient leaf's norm of one
    step on this card (no update).  With ``noise``, also each leaf norm's
    bf16 noise floor (``leaf_noise``): its relative distance from the
    same step with f32 weights and activations, the largest over the
    leaves of its kind (its name without the layer index: one leaf's
    distance is a sample of one)."""
    from repro_torch.optim.adamw import clip_by_global_norm
    with torch.enable_grad():
        loss, _ = api.loss(params, batch, ctx)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    out = {"loss": loss.item(),
           "grad_norm": clip_by_global_norm(grads, 1.0)[1].item(),
           "leaves": [math.sqrt(torch.sum(torch.square(g.float())).item())
                      for g in grads],
           "names": [n for n, _ in params.named_parameters()]}
    del loss, grads
    if noise:
        import copy
        f32 = _one_card_step(torch, api, copy.deepcopy(params).float(),
                             batch, ctx)
        kind = [re.sub(r"\.\d+\.", ".*.", n) for n in out["names"]]
        worst: dict = {}
        for k, a, b in zip(kind, out["leaves"], f32["leaves"]):
            worst[k] = max(worst.get(k, 0.0), abs(a - b) / b)
        out["leaf_noise"] = [worst[k] for k in kind]
    return out


def _step1_checks(outs, logs, one) -> dict:
    """The mesh's step-1 loss, gradient norm and gradient leaf norms (every
    rank's the same) against the one-card step ``one``, and the per-rank,
    per-step wall ms and collective shares (all, FSDP's gathers and
    reduce-scatters, the MoE's all-to-alls)."""
    mesh_loss, mesh_norm = logs[0][0]["loss"], logs[0][0]["grad_norm"]
    leaf_err = [abs(a - b) / b for a, b in zip(outs[0]["leaf_norms"],
                                                one["leaves"])]
    # a leaf's bound: MESH_LEAF_RTOL, or twice its kind's bf16 noise floor
    # where the one-card step measured it (``_one_card_step(noise=True)``)
    noise = one.get("leaf_noise", [0.0] * len(leaf_err))
    leaf_tol = [max(MESH_LEAF_RTOL, NOISE_FACTOR * n) for n in noise]
    worst = max(range(len(leaf_err)),
                key=lambda i: leaf_err[i] / leaf_tol[i])
    wall = [[r["wall_s"] for r in lg] for lg in logs]

    def share(key):
        return [[(r["collective_s"] if key is None else
                  r["collective_kinds_s"].get(key, 0.0)) / r["wall_s"]
                 for r in lg] for lg in logs]
    return dict(
        one_card_step1_loss=one["loss"], mesh_step1_loss=mesh_loss,
        one_card_step1_grad_norm=one["grad_norm"],
        mesh_step1_grad_norm=mesh_norm,
        step1_loss_rel=abs(mesh_loss - one["loss"]) / abs(one["loss"]),
        step1_grad_norm_rel=abs(mesh_norm - one["grad_norm"])
        / abs(one["grad_norm"]),
        step1_leaves=len(one["leaves"]),
        step1_worst_leaf=one["names"][worst],
        step1_worst_leaf_rel=leaf_err[worst],
        step1_worst_leaf_tol=leaf_tol[worst],
        step1_worst_leaf_noise=noise[worst],
        step1_worst_leaf_norms=[outs[0]["leaf_norms"][worst],
                                one["leaves"][worst]],
        step_wall_ms=[[w * 1e3 for w in r] for r in wall],
        step_collective_ms=[[r["collective_s"] * 1e3 for r in lg]
                            for lg in logs],
        step_collective_share=share(None),
        step_fsdp_share=share("fsdp"),
        step_all_to_all_share=share("all_to_all"),
        loss_ok=abs(mesh_loss - one["loss"])
        <= MESH_LOSS_RTOL * abs(one["loss"]),
        grad_norm_ok=abs(mesh_norm - one["grad_norm"])
        <= MESH_NORM_RTOL * abs(one["grad_norm"]),
        leaf_norms_ok=len(outs[0]["leaf_norms"]) == len(one["leaves"])
        and all(o["leaf_norms"] == outs[0]["leaf_norms"] for o in outs)
        and leaf_err[worst] <= leaf_tol[worst],
        losses_ok=all(math.isfinite(r["loss"]) for lg in logs for r in lg),
        # every rank logs the same steps and losses (the loss is summed
        # over the ranks); the gradient norm sums the squares of the
        # replicated norms' gradients on each rank, so it is held to a
        # last-bit rtol
        same_ok=all([(r["step"], r["loss"]) for r in lg]
                    == [(r["step"], r["loss"]) for r in logs[0]]
                    and all(math.isclose(a["grad_norm"], b["grad_norm"],
                                         rel_tol=1e-6)
                            for a, b in zip(lg, logs[0])) for lg in logs))


def _restart_checks(outs, spec, root) -> dict:
    """The failure and elastic restore of a training part: every rank
    logged steps 1..fail_at, then every+1.. after restoring step
    ``every``; the elastic trainer restored that checkpoint, the only one
    (the disk budget, above :data:`MESH_MOE_TRAIN`), and ran ``more``
    steps, its first held to the first trainer's step after its restore
    (the same weights and batch on another layout: ``MESH_LOSS_RTOL``,
    ``MESH_NORM_RTOL``); it verifies."""
    from repro_torch.checkpoint.manager import (complete_steps,
                                                verify_checkpoint)
    every, fail_at = spec["every"], spec["fail_at"]
    want_steps = list(range(1, fail_at + 1)) + list(range(
        every + 1, every + 1 + spec["steps"] - fail_at))
    saved = complete_steps(root)
    after = [r for r in outs[0]["log"] if r["step"] == every + 1]
    again = outs[0]["elastic_log"][0]
    loss_rel = (abs(again["loss"] - after[0]["loss"]) / abs(after[0]["loss"])
                if after else math.inf)
    norm_rel = (abs(again["grad_norm"] - after[0]["grad_norm"])
                / abs(after[0]["grad_norm"]) if after else math.inf)
    return dict(
        steps_logged=[r["step"] for r in outs[0]["log"]],
        elastic_steps_logged=[r["step"] for r in outs[0]["elastic_log"]],
        losses=[r["loss"] for r in outs[0]["log"] + outs[0]["elastic_log"]],
        grad_norms=[r["grad_norm"]
                    for r in outs[0]["log"] + outs[0]["elastic_log"]],
        saves=[o["saves"] for o in outs], writes=outs[0]["writes"],
        restores=[o["restores"] for o in outs], saved_steps=saved,
        run_s=[o["run_s"] for o in outs],
        peak_gib=[o["peak_gib"] for o in outs],
        failure_ok=all([r["step"] for r in o["log"]] == want_steps
                       and [r["step"] for r in o["restores"]]
                       == [every, every] for o in outs),
        elastic_ok=all(o["elastic_ok"] and o["final_step"]
                       == every + spec["more"] for o in outs),
        elastic_step_loss_rel=loss_rel, elastic_step_grad_norm_rel=norm_rel,
        elastic_step_ok=loss_rel <= MESH_LOSS_RTOL
        and norm_rel <= MESH_NORM_RTOL,
        verify_ok=saved == [every] and verify_checkpoint(root, every))


def mesh_train(torch, world, tmp, paths, nosp: dict) -> dict:
    """smollm-360m trained at full width on the ranks (``_rank_train``),
    checked against this process: the step-1 loss and gradient norm of a
    one-card step on the same weights and batch; every rank restored step
    ``every`` after the failure, then the same checkpoint at (4, 1); the
    one-card trainer restores it with the manifest's hashes (of each
    leaf's bytes, what a one-card save of that state would write).  The
    record of the part, checks included (``*_ok``); ``nosp`` gets its
    (2, 2) trainer's step 1 (without sequence parallelism: loss, gradient
    norm, leaf norms, kept values) and step walls, for
    :func:`mesh_sp_train`."""
    from repro_torch.launch.train import Trainer
    spec = MESH_TRAIN
    cfg = _train_cfg(spec)
    root = os.path.join(tmp, "mesh_ckpt")
    one = Trainer(cfg, device="cuda", ckpt_dir=root)
    one.init_state(SEED)
    step1 = _one_card_step(torch, one.api, one.params,
                           _first_batch(torch, cfg), one.ctx)
    torch.cuda.empty_cache()

    outs = world.run("train", root=root, spec=spec)
    paths["mesh_train"] = _summed(outs)
    logs = [o["log"] + o["elastic_log"] for o in outs]
    nosp.update(loss=outs[0]["log"][0]["loss"],
                grad_norm=outs[0]["log"][0]["grad_norm"],
                leaves=outs[0]["leaf_norms"], names=step1["names"],
                kept=[o["kept"][0] for o in outs],
                wall_ms=[[r["wall_s"] * 1e3 for r in o["log"]]
                         for o in outs])

    t0 = time.monotonic()
    restored = one.try_restore()
    torch.cuda.synchronize()
    one_restore_s = time.monotonic() - t0
    step = one.step_idx
    hashes_ok = restored and (_leaf_hashes(one.state_tree())
                              == _manifest_hashes(root, step))
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return emit(
        "mesh", part="smollm-360m training", arch=cfg.name,
        layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, label=MESH_LABEL,
        meshes={"train": [2, MESH_RANKS // 2], "elastic": [MESH_RANKS, 1]},
        plans={"train": "fsdp_tp", "elastic": "fsdp"},
        params_per_rank=[o["params_held"] for o in outs],
        **_restart_checks(outs, spec, root), **_step1_checks(outs, logs,
                                                             step1),
        one_card_restore_s=one_restore_s, restored_step=step,
        peak_gib_2x2=[o["peak_gib_train"] for o in outs],
        kept_values_step1=nosp["kept"],
        query_rows_step1=[_rows_json(o["query_rows"][0]) for o in outs],
        query_rows_ok=split_rows_ok([o["query_rows"][0] for o in outs],
                                    (2, MESH_RANKS // 2), TRAIN_SEQ),
        launches=paths["mesh_train"], hashes_ok=hashes_ok,
        no_kernel_ok=not any(paths["mesh_train"].values()))


def _sizes(torch, cfg) -> tuple[int, int]:
    """(parameters, bytes of a training state: each parameter in its dtype,
    bf16 or f32, and its f32 master, m and v) of ``cfg``."""
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.lm import init_lm
    init = init_encdec if cfg.family == "encdec" else init_lm
    lm = init(cfg, generator=torch.Generator(), device="meta")
    return (sum(p.numel() for p in lm.parameters()),
            sum(p.numel() * (p.element_size() + 12)
                for p in lm.parameters()))


def mesh_moe_train(torch, world, tmp, paths, nosp: dict) -> dict:
    """qwen3-moe-30b-a3b trained at published widths on the ranks
    (:data:`MESH_MOE_TRAIN`), checked against this process: the step-1
    loss, gradient norm and gradient leaf norms of a one-card step on the
    same weights and batch under the ranks' expert choices and kept pairs
    (the mesh drops pairs past an expert's capacity, the one-card oracle
    drops none; ``RouteLog(forced=...)``, the forward's routing and then
    the backward's recompute, layers in reverse); the dropped share; the
    failure and elastic restore.  Fails before it starts unless the disk
    holds twice the state.  The record of the part, checks included;
    ``nosp`` gets its (2, 2) trainer's step 1 (without sequence
    parallelism, as :func:`mesh_train`'s, and its routing) for
    :func:`mesh_sp_train`."""
    from repro_torch.models import ffn
    from repro_torch.models.api import build as build_api
    from repro_torch.models.blocks import ShardCtx
    from repro_torch.configs import get_config
    spec = MESH_MOE_TRAIN
    cfg = _train_cfg(spec)
    root = os.path.join(tmp, "moe_ckpt")
    n_params, state = _sizes(torch, cfg)
    free = shutil.disk_usage(tmp).free
    if free < 2 * state:
        fail(f"the MoE training part needs twice its {state / 1e9:.1f} GB "
             f"state on disk; {free / 1e9:.1f} GB are free under {tmp}")
    torch.cuda.empty_cache()
    parent_reserved = torch.cuda.memory_reserved() / 2**30
    t0 = time.monotonic()
    outs = world.run("train", root=root, spec=spec)
    ranks_s = time.monotonic() - t0
    paths["mesh_moe_train"] = _summed(outs)
    logs = [o["log"] + o["elastic_log"] for o in outs]
    routes = _assemble_routes(torch, outs)
    pairs = sum(k.numel() for _, k in routes)
    dropped = sum(int((~k).sum()) for _, k in routes)
    forced = [(e.cuda(), k.cuda()) for e, k in routes]
    t0 = time.monotonic()
    api = build_api(cfg)
    params = api.init(SEED, device="cuda", trainable=True)
    torch.cuda.reset_peak_memory_stats()
    first = _first_batch(torch, cfg)
    step1 = _one_card_step(
        torch, api, params, first,
        ShardCtx(impl="ref", routes=ffn.RouteLog(
            forced=forced + forced[::-1])))
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    one_card_s = time.monotonic() - t0
    nosp.update(loss=outs[0]["log"][0]["loss"],
                grad_norm=outs[0]["log"][0]["grad_norm"],
                leaves=outs[0]["leaf_norms"], names=step1["names"],
                kept=[o["kept"][0] for o in outs],
                wall_ms=[[r["wall_s"] * 1e3 for r in o["log"]]
                         for o in outs], routes=routes)
    own = ffn.RouteLog()                # the one card's own routing
    with torch.no_grad():
        api.loss(params, first, ShardCtx(impl="ref", routes=own))
    agree = _route_agreement(torch, routes, own.calls, cfg.moe.n_experts)
    del params, forced, first, own
    gc.collect()
    torch.cuda.empty_cache()
    return emit(
        "mesh", part="qwen3-moe training", arch=cfg.name,
        layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
        experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        capacity_factor=cfg.moe.capacity_factor,
        reduced={"n_layers": [cfg.n_layers,
                              get_config(spec["arch"]).n_layers]},
        params=n_params,
        state_bytes=state, disk_free_bytes=free,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, label=MESH_LABEL,
        meshes={"train": [2, MESH_RANKS // 2], "elastic": [1, MESH_RANKS]},
        plans={"train": "fsdp_tp (EP + FSDP)", "elastic": "tp (EP)"},
        experts_per_rank={"train": cfg.moe.n_experts // 2,
                          "elastic": cfg.moe.n_experts // MESH_RANKS},
        params_per_rank=[o["params_held"] for o in outs],
        elastic_params_per_rank=[o["elastic_params_held"] for o in outs],
        card_free_gib_at_start=[o["card_free_gib_at_start"] for o in outs],
        parent_reserved_gib=parent_reserved,
        route_calls=len(routes), pairs=pairs, dropped_pairs=dropped,
        dropped_share=dropped / pairs, route_agreement=agree,
        route_agreement_bound=MESH_ROUTE_AGREE,
        routes_ok=len(agree) == cfg.n_layers
        and min(agree) >= MESH_ROUTE_AGREE,
        **_restart_checks(outs, spec, root), **_step1_checks(outs, logs,
                                                             step1),
        peak_gib_2x2=[o["peak_gib_train"] for o in outs],
        one_card_step_peak_gib=one_peak, ranks_s=ranks_s,
        one_card_s=one_card_s,
        launches=paths["mesh_moe_train"],
        no_kernel_ok=not any(paths["mesh_moe_train"].values()))


def _step_batches(torch, cfg, n: int, seed: int) -> list:
    """``n`` seeded global batches of the train phase's 8 x 512 tokens and
    labels (on the host), a VLM's with its stub patch embeddings, an
    enc-dec's with 512 stub frames a row (bf16)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
        extra = {"vlm": ("extra_embeds", cfg.frontend_len),
                 "encdec": ("frames", TRAIN_SEQ)}.get(cfg.family)
        if extra:
            b[extra[0]] = torch.randn((TRAIN_BATCH, extra[1], cfg.d_model),
                                      generator=g).bfloat16()
        out.append(b)
    return out


def mesh_steps_train(torch, world, paths, spec, path, part, seed) -> dict:
    """``spec``'s model trained at published widths on the ranks
    (``_rank_steps``: :data:`MESH_VLM_TRAIN`, :data:`MESH_FAMILY_TRAIN`)
    on seeded batches, checked against this process: the step-1 loss,
    gradient norm and gradient leaf norms of a one-card step on the same
    weights and batch (with ``spec["noise"]``, each leaf at least within
    twice its kind's bf16 noise floor).  The record of the part (``path``
    names its launch counts), checks included."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build as build_api
    from repro_torch.models.blocks import ShardCtx
    cfg = _train_cfg(spec)
    batches = _step_batches(torch, cfg, spec["steps"], seed)
    t0 = time.monotonic()
    outs = world.run("steps", spec=spec, batches=batches)
    ranks_s = time.monotonic() - t0
    paths[path] = _summed(outs)
    logs = [o["log"] for o in outs]
    api = build_api(cfg)
    params = api.init(SEED, device="cuda", trainable=True)
    step1 = _one_card_step(torch, api, params,
                           {k: v.cuda() for k, v in batches[0].items()},
                           ShardCtx(impl="ref"), noise=spec.get("noise", False))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(spec["arch"])
    reduced = {k: [getattr(cfg, k), getattr(full, k)]
               for k in ("n_layers", "enc_layers")
               if getattr(cfg, k) != getattr(full, k)}
    mesh = {"hier": [2, MESH_RANKS // 2], "tp": [1, MESH_RANKS]}
    extra = {"vlm": {"patches": cfg.frontend_len},
             "encdec": {"frames": TRAIN_SEQ}}.get(cfg.family, {})
    return emit(
        "mesh", part=part, arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab, reduced=reduced,
        params=_sizes(torch, cfg)[0], global_batch=TRAIN_BATCH,
        text_len=TRAIN_SEQ, **extra, label=MESH_LABEL,
        mesh=mesh[spec["mesh"]], plan=spec["plan"],
        params_per_rank=[o["params_held"] for o in outs],
        steps_logged=[r["step"] for r in logs[0]],
        losses=[r["loss"] for r in logs[0]],
        grad_norms=[r["grad_norm"] for r in logs[0]],
        peak_gib=[o["peak_gib"] for o in outs], ranks_s=ranks_s,
        **_step1_checks(outs, logs, step1),
        launches=paths[path], no_kernel_ok=not any(paths[path].values()))


def mesh_sp_train(torch, world, paths, nosp: dict, spec=MESH_SP_TRAIN,
                  path="mesh_sp_train") -> dict:
    """``spec``'s model trained at (2, 2) under FSDP + TP (an MoE's experts
    EP) with Megatron sequence parallelism on the ranks
    (:data:`MESH_SP_TRAIN`, :data:`MESH_MOE_SP_TRAIN`; ``_rank_steps``) on
    the train phase's first batches, held to the (2, 2) trainer's step 1
    without it (``nosp``: :func:`mesh_train`'s, :func:`mesh_moe_train`'s;
    the same weights and batch on the same layout): the step-1 loss,
    gradient norm and each gradient leaf's norm (``MESH_LOSS_RTOL``,
    ``MESH_NORM_RTOL``, ``MESH_LEAF_RTOL``), and the values the
    checkpointed layer bodies kept at step 1, exactly 1 / m of those
    without the split (m = 2); for an MoE the share of the unsplit
    trainer's (token, expert) decisions the split step makes in each
    layer (``MESH_ROUTE_AGREE``) and both runs' dropped pairs.  Per rank
    and step the wall ms and the collective share by kind, the peak
    memory; no kernel launches (``path`` names the counts).  The record,
    checks included."""
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SyntheticTokenSource)
    cfg = _train_cfg(spec)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in SyntheticTokenSource(cfg, PipelineConfig(
                   TRAIN_BATCH, TRAIN_SEQ, seed=SEED),
                   n_batches=spec["steps"])]
    t0 = time.monotonic()
    outs = world.run("steps", spec=spec, batches=batches)
    ranks_s = time.monotonic() - t0
    paths[path] = _summed(outs)
    logs = [o["log"] for o in outs]
    loss, norm = logs[0][0]["loss"], logs[0][0]["grad_norm"]
    leaf_err = [abs(a - b) / b for a, b in zip(outs[0]["leaf_norms"],
                                                nosp["leaves"])]
    worst = max(range(len(leaf_err)), key=leaf_err.__getitem__)
    m = MESH_RANKS // 2
    kept = [o["kept"][0] for o in outs]
    want_kept = (TRAIN_BATCH // 2) * TRAIN_SEQ * cfg.d_model * cfg.n_layers
    wall = [[r["wall_s"] * 1e3 for r in lg] for lg in logs]
    mean = lambda rows: sum(map(sum, rows)) / sum(map(len, rows))
    split = query_split(cfg, (2, m), TRAIN_SEQ)
    rows = [o["query_rows"][0] for o in outs]
    moe = {}
    if cfg.moe:
        routes = _assemble_routes(torch, outs)
        agree = _route_agreement(torch, routes, nosp["routes"],
                                 cfg.moe.n_experts)
        moe = dict(
            experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            reduced={"n_layers": [cfg.n_layers, _train_cfg(
                {"arch": spec["arch"]}).n_layers]},
            pairs=sum(k.numel() for _, k in routes),
            dropped_pairs=sum(int((~k).sum()) for _, k in routes),
            nosp_dropped_pairs=sum(int((~k).sum())
                                   for _, k in nosp["routes"]),
            route_agreement=agree, route_agreement_bound=MESH_ROUTE_AGREE,
            routes_ok=len(agree) == cfg.n_layers
            and min(agree) >= MESH_ROUTE_AGREE)

    def share(key):
        return [[(r["collective_s"] if key is None else
                  r["collective_kinds_s"].get(key, 0.0)) / r["wall_s"]
                 for r in lg] for lg in logs]
    return emit(
        "mesh", part=f"{cfg.name} training, sequence parallel",
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, label=MESH_LABEL,
        mesh=[2, m], plan=spec["plan"], seq_parallel=True, **moe,
        params_per_rank=[o["params_held"] for o in outs],
        steps_logged=[r["step"] for r in logs[0]],
        losses=[r["loss"] for r in logs[0]],
        grad_norms=[r["grad_norm"] for r in logs[0]],
        nosp_step1_loss=nosp["loss"], sp_step1_loss=loss,
        nosp_step1_grad_norm=nosp["grad_norm"], sp_step1_grad_norm=norm,
        step1_loss_rel=abs(loss - nosp["loss"]) / abs(nosp["loss"]),
        step1_grad_norm_rel=abs(norm - nosp["grad_norm"])
        / abs(nosp["grad_norm"]),
        step1_leaves=len(leaf_err), step1_worst_leaf=nosp["names"][worst],
        step1_worst_leaf_rel=leaf_err[worst],
        step1_worst_leaf_norms=[outs[0]["leaf_norms"][worst],
                                nosp["leaves"][worst]],
        kept_values_step1=kept, nosp_kept_values_step1=nosp["kept"],
        kept_values_expected_nosp=want_kept,
        kept_ratio=[a / b for a, b in zip(kept, nosp["kept"])],
        step_wall_ms=wall, nosp_step_wall_ms=nosp["wall_ms"],
        step_ms_ratio_to_nosp=mean(wall) / mean(nosp["wall_ms"]),
        step_collective_share=share(None), step_fsdp_share=share("fsdp"),
        step_all_to_all_share=share("all_to_all"),
        step_seq_share=share("seq"),
        peak_gib=[o["peak_gib"] for o in outs], ranks_s=ranks_s,
        launches=paths[path],
        loss_ok=abs(loss - nosp["loss"])
        <= MESH_LOSS_RTOL * abs(nosp["loss"]),
        grad_norm_ok=abs(norm - nosp["grad_norm"])
        <= MESH_NORM_RTOL * abs(nosp["grad_norm"]),
        leaf_norms_ok=len(leaf_err) == len(nosp["leaves"])
        and all(o["leaf_norms"] == outs[0]["leaf_norms"] for o in outs)
        and leaf_err[worst] <= MESH_LEAF_RTOL,
        kept_ok=all(k * m == n == want_kept
                    for k, n in zip(kept, nosp["kept"])),
        query_split=split,
        query_rows_step1=[_rows_json(r) for r in rows],
        query_rows_ok=split_rows_ok(rows, (2, m), TRAIN_SEQ) if split
        else all(set(r) == {(0, TRAIN_SEQ, TRAIN_SEQ)} for r in rows),
        seq_ok=all(r["collective_kinds_s"].get("seq", 0.0) > 0
                   for lg in logs for r in lg),
        losses_ok=all(math.isfinite(r["loss"]) for lg in logs for r in lg),
        same_ok=all([(r["step"], r["loss"]) for r in lg]
                    == [(r["step"], r["loss"]) for r in logs[0]]
                    for lg in logs),
        no_kernel_ok=not any(paths[path].values()))


#: the checks of a training part under sequence parallelism
#: (:func:`mesh_sp_train`); an MoE's adds ``routes_ok``
SP_TRAIN_CHECKS = ("loss_ok", "grad_norm_ok", "leaf_norms_ok", "kept_ok",
                   "query_rows_ok", "seq_ok", "losses_ok", "same_ok",
                   "no_kernel_ok")


def mesh_tp_serve(torch, world, tmp, paths, records, cfg, batch, steps,
                  path, kv_digest=None, launches=None, gen=GEN,
                  sp_steps=0) -> dict:
    """``cfg`` served at TP 4 (mesh (1, 4)) by the ranks on views of this
    process's weights (a Mamba2 layer's head-wise leaves copied):
    ``Server(cfg, mesh).generate`` (rank 0 streams through the mover),
    then the logits over ``batch`` and ``steps`` teacher-forced steps held
    to this process's kernel path within ``LOGIT_SHARE``, and that path to
    the plain path; with ``kv_digest`` rank 0 stages its prefill's KV
    items under the accel digest.  ``launches``: each kernel's launches
    over the 4 ranks' ``generate`` of ``gen`` tokens (default a decoder's:
    flash once per layer per rank per prefill, decode once per layer per
    rank per step).  With ``sp_steps``, the ranks then serve a prefill and
    ``sp_steps`` teacher-forced steps with and without Megatron sequence
    parallelism (``_rank_sp_serve``), held to each other as the ranks are
    held to this process (the second record).  An SSM or hybrid is held, as its one-card phase is,
    to twice the bf16 noise floor (``NOISE_FACTOR``: the plain path against
    the same path in f32) instead: its 38-48 layers of bf16 put the
    one-card kernel path 3.6-3.8% of the scale off the plain path on an
    H100, and a rank's partial sums, rounded before they are summed, as
    far again.  Appends the record (checks included) to ``records``."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.blocks import ShardCtx
    t_part = time.monotonic()
    m = MESH_RANKS
    frontend = cfg.frontend_len if cfg.frontend else 0
    prompt = batch["tokens"].shape[1]
    server = Server(cfg, device="cuda",
                    max_len=frontend + prompt + gen + 1)
    server.load(SEED)
    tokens = server.generate(batch, gen)
    one, _ = _forced_run(torch, server, batch, tokens, steps)
    plain, _ = _forced_run(torch, server, batch, tokens, steps,
                           ctx=ShardCtx(impl="ref"))
    scale = plain.abs().max().item()
    one_err = (one - plain).abs().amax(dim=(1, 2)).tolist()
    tol, noise = LOGIT_SHARE * scale, None
    if cfg.family in ("ssm", "hybrid"):
        import copy
        params = server.params
        server.params = copy.deepcopy(params).float()
        p32, _ = _forced_run(torch, server, batch, tokens, steps,
                             ctx=ShardCtx(impl="ref"))
        server.params = params
        noise = (plain - p32).abs().amax(dim=(1, 2)).tolist()
        tol = NOISE_FACTOR * max(noise)
        del p32
    ref_path = os.path.join(tmp, f"{path}.pt")
    torch.save({"tokens": torch.as_tensor(tokens), "logits": one.cpu()},
               ref_path)
    del plain
    outs = world.run("serve", lm=server.params, arch=cfg.name,
                     layers=cfg.n_layers, batch=batch, steps=steps,
                     ref_path=ref_path, kv_digest=kv_digest, gen=gen)
    paths[path] = _summed(outs)
    rank_err = max(max(o["logits_max_abs_err"]) for o in outs)
    stage = {}
    if kv_digest:
        stage = outs[0]["stage"]
        paths[f"{path}_stage_kv"] = stage["launches"]
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    split = query_split(cfg, (1, m), frontend + prompt)
    rec = emit(
        "mesh", part=f"{cfg.name} TP {m}", arch=cfg.name, mesh=[1, m],
        layers=cfg.n_layers,
        reduced={"n_layers": [cfg.n_layers, full]}
        if cfg.n_layers != full else {},
        batch=len(batch["tokens"]), prompt=prompt, patches=frontend,
        gen=gen, teacher_forced_steps=steps, label=MESH_LABEL,
        params_per_rank=[o["params"] for o in outs],
        generate_s=[o["generate_s"] for o in outs],
        prefill=[o["prefill"] for o in outs],
        decode_step=[o["decode_step"] for o in outs],
        peak_gib=[o["peak_gib"] for o in outs], launches=paths[path],
        one_process_vs_plain_max_abs_err=one_err, logits_scale=scale,
        ranks_vs_one_process_max_abs_err=rank_err,
        bf16_noise_max_abs_err=noise, logits_tol=tol,
        one_process_ok=max(one_err) <= tol, logits_ok=rank_err <= tol,
        same_ok=len({o["logits_digest"] for o in outs}) == 1
        and all((o["tokens"] == outs[0]["tokens"]).all() for o in outs),
        tokens_ok=outs[0]["tokens"].shape == (len(batch["tokens"]), gen),
        stage={k: v for k, v in stage.items() if k != "launches"},
        stage_launches=stage.get("launches"),
        kv_staged_ok=not kv_digest or (stage["digest_ok"]
                                       and stage["bytes_ok"]),
        query_split=split,
        query_rows=[_rows_json(o["query_rows"]) for o in outs],
        query_rows_ok=not split or split_rows_ok(
            [o["query_rows"] for o in outs], (1, m), frontend + prompt,
            calls=cfg.n_layers))
    records.append(rec)
    checked(rec, f"{cfg.name} on the mesh", (
        "one_process_ok", "logits_ok", "same_ok", "tokens_ok",
        "kv_staged_ok", "query_rows_ok"))
    launches = launches or {
        "flash_attention": m * cfg.n_layers,
        "decode_attention": m * cfg.n_layers * (gen - 1)}
    need(paths, path, tuple(launches))
    for name, want in launches.items():
        _launches_per_layer(paths, path, name, want)
    if kv_digest:
        need(paths, f"{path}_stage_kv", ("digest_items",))
        _launches_per_layer(paths, f"{path}_stage_kv", "digest_items",
                            stage["folds"])
    if sp_steps:
        records.append(_mesh_sp_serve(torch, world, paths, cfg,
                                      server.params, batch, sp_steps, path,
                                      ref_path, tol, m))
    del server, one
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    records.append(emit("phase_time", of=f"mesh {cfg.name}",
                        seconds=time.monotonic() - t_part))
    return rec


def _mesh_sp_serve(torch, world, paths, cfg, lm, batch, steps, path,
                   ref_path, tol, m) -> dict:
    """``cfg`` served at TP ``m`` with and without Megatron sequence
    parallelism (``_rank_sp_serve`` on the weights the ranks viewed for
    ``path``): the split run's logits held to the unsplit run's within
    ``tol`` (the tolerance the ranks were held to against this process),
    every rank the same, both runs through the kernels (flash, or the SSD
    scan, once per layer per rank per prefill); for an MoE, each run's
    dropped pairs, equal (``drops_ok``: the split run under the unsplit
    run's expert choices keeps, on every rank, the same pairs of the same
    tokens); the record."""
    outs = world.run("sp_serve", lm=lm, arch=cfg.name,
                     layers=cfg.n_layers, batch=batch, steps=steps,
                     ref_path=ref_path)
    for run in ("nosp", "sp"):
        paths[f"{path}_{run}"] = _summed([o[run] for o in outs])
    err = max(max(o["sp_vs_nosp_max_abs_err"]) for o in outs)
    prefill = ("ssd_scan" if cfg.family in ("ssm", "hybrid")
               else "flash_attention")
    S = batch["tokens"].shape[1]
    split = query_split(cfg, (1, m), S)
    moe = {}
    if cfg.moe:
        moe = dict(
            route_calls={r: outs[0][r]["route_calls"] for r in ("nosp", "sp")},
            pairs={r: [o[r]["pairs"] for o in outs] for r in ("nosp", "sp")},
            dropped_pairs={r: [o[r]["dropped_pairs"] for o in outs]
                           for r in ("nosp", "sp")},
            drops_ok=all(o["kept_same"] and o["sp"]["dropped_pairs"]
                         == o["nosp"]["dropped_pairs"] for o in outs))
    rec = emit(
        "mesh", part=f"{cfg.name} TP {m}, sequence parallel",
        arch=cfg.name, mesh=[1, m], layers=cfg.n_layers,
        batch=len(batch["tokens"]), prompt=batch["tokens"].shape[1],
        teacher_forced_steps=steps, label=MESH_LABEL, seq_parallel=True,
        prefill={r: [o[r]["prefill"] for o in outs] for r in ("nosp", "sp")},
        prefill_collective_share={
            r: [o[r]["prefill_collective_share"] for o in outs]
            for r in ("nosp", "sp")},
        prefill_collective_s={
            r: [o[r]["prefill_collective_s"] for o in outs]
            for r in ("nosp", "sp")},
        peak_gib={r: [o[r]["peak_gib"] for o in outs]
                  for r in ("nosp", "sp")}, **moe,
        launches={r: paths[f"{path}_{r}"] for r in ("nosp", "sp")},
        sp_vs_nosp_max_abs_err=[o["sp_vs_nosp_max_abs_err"] for o in outs],
        vs_one_process_max_abs_err={
            r: [o[r]["vs_one_process_max_abs_err"] for o in outs]
            for r in ("nosp", "sp")},
        logits_scale=outs[0]["logits_scale"], logits_tol=tol,
        logits_ok=err <= tol,
        same_ok=len({o["sp"]["logits_digest"] for o in outs}) == 1,
        seq_ok=all(o["sp"]["prefill_collective_share"].get("seq", 0) > 0
                   and o["nosp"]["prefill_collective_share"].get("seq", 0)
                   == 0 for o in outs),
        kernels_ok=all(paths[f"{path}_{r}"][prefill] == m * cfg.n_layers
                       for r in ("nosp", "sp")),
        query_split=split,
        query_rows={r: [_rows_json(o[r]["query_rows"]) for o in outs]
                    for r in ("nosp", "sp")},
        query_rows_ok=not split or all(split_rows_ok(
            [o[r]["query_rows"] for o in outs], (1, m), S,
            calls=cfg.n_layers) for r in ("nosp", "sp")))
    checked(rec, f"{cfg.name} under sequence parallelism",
            ("logits_ok", "same_ok", "seq_ok", "kernels_ok",
             "query_rows_ok") + (("drops_ok",) if cfg.moe else ()))
    return rec


def mesh_mixtral(torch, world, tmp, paths, records, rng) -> dict:
    """mixtral at EP 4 (:data:`MESH_MIXTRAL`) served by the ranks on views
    of this process's weights: ``generate``, then the logits over the
    prompt and 4 teacher-forced steps held to this process's run under
    the ranks' expert choices and kept pairs; one MoE layer through
    ``moe_ep`` and ``moe_tp`` against ``moe_dispatch``, and entered from
    the ranks' sequence chunks (``_rank_moe_layer``); then a prefill and
    :data:`MESH_SP_STEPS` teacher-forced steps with and without Megatron
    sequence parallelism (:func:`_mesh_sp_serve`: the split run under the
    unsplit run's expert choices, its logits within ``LOGIT_SHARE`` of the
    unsplit ranks', the dropped pairs equal).  Appends the records
    (checks included) to ``records``; returns the first."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import ffn
    t_part = time.monotonic()
    m = MESH_RANKS
    mix = dataclasses.replace(get_config(MESH_MIXTRAL["arch"]),
                              n_layers=MESH_MIXTRAL["layers"])
    xB, xS = MESH_MIXTRAL["batch"], MESH_MIXTRAL["prompt"]
    server = Server(mix, device="cuda", max_len=xS + GEN + 1)
    server.load(SEED)
    batch = _prompts(torch, mix, xB, xS, rng)
    outs = world.run("serve", lm=server.params, arch=mix.name,
                     layers=mix.n_layers, batch=batch, steps=MESH_SP_STEPS)
    paths["mesh_mixtral"] = _summed(outs)
    tokens = outs[0]["tokens"]
    routes = _assemble_routes(torch, outs)
    forced = ffn.RouteLog(forced=[(e.cuda(), k.cuda())
                                  for e, k in routes])
    one, _ = _forced_run(torch, server, batch, tokens, MESH_SP_STEPS,
                         ctx=dataclasses.replace(server.ctx,
                                                 routes=forced))
    ranks_logits = outs[0]["logits"].to("cuda")
    scale = one.abs().max().item()
    err = (ranks_logits - one).abs().amax(dim=(1, 2)).tolist()
    pairs = sum(k.numel() for _, k in routes)
    dropped = sum(int((~k).sum()) for _, k in routes)
    layer_outs = world.run("moe_layer", lm=server.params, arch=mix.name,
                           layers=mix.n_layers, tokens=xB * xS, rows=xB)
    layer = _check_mesh_moe_layer(torch, mix, server.params.layers[0].moe,
                                  layer_outs, xB * xS)
    rec = emit(
        "mesh", part="mixtral EP 4", arch=mix.name, mesh=[1, m],
        batch=xB, prompt=xS, gen=GEN, label=MESH_LABEL,
        reduced={"n_layers": [mix.n_layers,
                              get_config(MESH_MIXTRAL["arch"]).n_layers]},
        capacity_factor=mix.moe.capacity_factor,
        params_per_rank=[o["params"] for o in outs],
        generate_s=[o["generate_s"] for o in outs],
        prefill=[o["prefill"] for o in outs],
        decode_step=[o["decode_step"] for o in outs],
        peak_gib=[o["peak_gib"] for o in outs],
        launches=paths["mesh_mixtral"], route_calls=len(routes),
        pairs=pairs, dropped_pairs=dropped,
        dropped_share=dropped / pairs,
        logits_max_abs_err=err, logits_scale=scale,
        logits_tol=LOGIT_SHARE * scale,
        logits_ok=max(err) <= LOGIT_SHARE * scale
        and bool(torch.isfinite(ranks_logits).all()),
        same_ok=len({o["logits_digest"] for o in outs}) == 1
        and all((o["tokens"] == tokens).all() for o in outs),
        greedy_ok=bool((ranks_logits.argmax(-1).T.cpu().numpy()
                        == tokens[:, :MESH_SP_STEPS + 1]).all()),
        moe_layer=layer)
    records.append(rec)
    checked(rec, "mixtral on the mesh", ("logits_ok", "same_ok",
                                         "greedy_ok"))
    checked(layer, "mixtral's MoE layer on the mesh",
            ("ep_ok", "tp_ok", "same_ok", "ep_sp_ok", "tp_sp_ok"))
    need(paths, "mesh_mixtral", ("flash_attention", "decode_attention"))
    _launches_per_layer(paths, "mesh_mixtral", "flash_attention",
                        m * mix.n_layers)
    ref_path = os.path.join(tmp, "mesh_mixtral.pt")
    torch.save({"tokens": torch.as_tensor(tokens), "logits": one.cpu()},
               ref_path)
    del forced, routes, layer_outs, ranks_logits
    records.append(_mesh_sp_serve(torch, world, paths, mix, server.params,
                                  batch, MESH_SP_STEPS, "mesh_mixtral",
                                  ref_path, LOGIT_SHARE * scale, m))
    del server, one
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    records.append(emit("phase_time", of="mesh mixtral",
                        seconds=time.monotonic() - t_part))
    return rec


def family_kernel_checks(torch, fam: dict, m: int) -> dict:
    """The kernels at the per-rank shapes of the enc-dec, SSM and hybrid
    at TP ``m`` (:data:`MESH_FAMILY_SERVE`): seamless's encoder flash
    (no causal mask) and its decode as self and as cross attention over
    every encoder slot; zamba2's shared block's flash at its window and
    decode over the wrapped ring; the SSD scan at mamba2's and zamba2's
    heads a rank (N 128 and 64)."""
    bf16 = torch.bfloat16
    out = {}
    sm, se = fam["seamless"], MESH_FAMILY_SERVE["seamless"]
    h = _rank_heads(sm, m)
    S, B = se["prompt"], se["batch"]
    G = dict(B=B, Hq=h.hq, Hkv=h.hkv, hd=sm.hd)
    out["seamless flash_encoder"] = check_flash(torch, S=S, dtype=bf16,
                                                window=0, causal=False, **G)
    out["seamless decode_self"] = check_decode(
        torch, S=S + se["gen"] + 1, dtype=bf16, fill=se["gen"] // 2,
        window=0, ring=False, **G)
    out["seamless decode_cross"] = check_decode(
        torch, S=S, dtype=bf16, fill=S - 1, window=0, ring=False,
        cross=True, **G)
    z, ze = fam["zamba2"], MESH_FAMILY_SERVE["zamba2"]
    h = _rank_heads(z, m)
    G = dict(B=ze["batch"], Hq=h.hq, Hkv=h.hkv, hd=z.hd)
    out["zamba2 flash"] = check_flash(torch, S=ze["prompt"], dtype=bf16,
                                      window=z.window, **G)
    out["zamba2 decode"] = check_decode(
        torch, S=min(z.window, ze["prompt"] + ze["gen"] + 1), dtype=bf16,
        fill=ze["prompt"] + ze["gen"] // 2, window=z.window, ring=False,
        wrapped=True, **G)
    for name in ("mamba2", "zamba2"):
        cfg, spec = fam[name], MESH_FAMILY_SERVE[name]
        out[f"{name} ssd_scan"] = check_ssd(
            torch, spec["batch"], cfg.ssm_heads // m, cfg.ssm.n_groups,
            spec["prompt"], chunk=cfg.ssm.chunk, N=cfg.ssm.d_state)
    return out


def _family_launches(cfg, m: int, gen: int) -> dict:
    """Each kernel's launches over ``m`` ranks' ``generate`` of ``gen``
    tokens:
    the enc-dec's flash once per encoder layer per prefill and decode
    twice per decoder layer per step (self and cross; the prefill decodes
    the first token); a Mamba2 layer's SSD scan once per prefill; the
    hybrid's shared block's flash once per site per prefill and decode
    once per site per later step."""
    if cfg.family == "encdec":
        return {"flash_attention": m * cfg.enc_layers,
                "decode_attention": m * 2 * cfg.n_layers * gen}
    out = {"ssd_scan": m * cfg.n_layers}
    if cfg.family == "hybrid":
        sites = len(range(0, cfg.n_layers, cfg.attn_every))
        out.update(flash_attention=m * sites,
                   decode_attention=m * sites * (gen - 1))
    return out


def mesh_phase(torch, paths, rng, records) -> dict:
    """The mesh phase (module docstring, 16): NCCL at a world of one; the
    kernels at the per-rank shapes; then four gloo ranks sharing the card,
    spawned once: the collectives, phi3-mini at TP 4, mixtral at EP 4 (and
    one MoE layer through ``moe_tp``), mistral-large through the
    pipeline, llava, seamless, mamba2 and zamba2 at TP 4, and the training
    parts.  The weights are loaded once by this process and shared with
    the ranks by CUDA IPC (``shard_params`` views them, no copy).  Returns
    the kernel check records by name."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import ShardCtx, dense_layer_apply
    resident_mib = torch.cuda.memory_allocated() / 2**20
    resident = emit("memory", of="mesh phase start",
                    allocated_before_phase_mib=resident_mib,
                    resident_ok=resident_mib < RESIDENT_LIMIT_MIB)
    records.append(resident)
    checked(resident, "mesh phase start", ("resident_ok",))
    nccl = nccl_check(torch)
    records.append(nccl)
    checked(nccl, "NCCL at a world of one", ("ok",))

    phi3 = _train_cfg(MESH_PHI3)
    mix = dataclasses.replace(get_config(MESH_MIXTRAL["arch"]),
                              n_layers=MESH_MIXTRAL["layers"])
    big = get_config(MESH_PIPE["arch"])
    llava = _train_cfg(MESH_LLAVA)
    fam = {k: get_config(v["arch"]) for k, v in MESH_FAMILY_SERVE.items()}
    m = MESH_RANKS
    bf16 = torch.bfloat16
    pB, pS = MESH_PHI3["batch"], MESH_PHI3["prompt"]
    xB, xS = MESH_MIXTRAL["batch"], MESH_MIXTRAL["prompt"]
    ph, xh, lh = (_rank_heads(c, m) for c in (phi3, mix, llava))
    lS = llava.frontend_len + LLAVA_PROMPT
    g = torch.Generator(device="cuda").manual_seed(44)
    kv_len = pS + GEN + 1
    kv = torch.randint(0, 256, (pB * kv_len * ph.hkv * phi3.hd * 2,),
                       generator=g, dtype=torch.uint8, device="cuda")
    quant, dequant = check_quantize(torch, CPSUM_VALUES)
    checks = {
        "phi3 flash": check_flash(torch, B=pB, Hq=ph.hq, Hkv=ph.hkv, S=pS,
                                  hd=phi3.hd, dtype=bf16, window=0),
        "phi3 decode": check_decode(torch, B=pB, Hq=ph.hq, Hkv=ph.hkv,
                                    S=kv_len, hd=phi3.hd, dtype=bf16,
                                    fill=pS + GEN // 2, window=0,
                                    ring=False),
        "phi3 kv_item": check_digest_items(
            torch, "one phi3 KV item of a rank", [[kv]], [[kv]]),
        "mixtral flash": check_flash(torch, B=xB, Hq=xh.hq, Hkv=xh.hkv,
                                     S=xS, hd=mix.hd, dtype=bf16,
                                     window=mix.window),
        "mixtral decode": check_decode(torch, B=xB, Hq=xh.hq, Hkv=xh.hkv,
                                       S=min(mix.window, xS + GEN + 1),
                                       hd=mix.hd, dtype=bf16,
                                       fill=xS + GEN // 2,
                                       window=mix.window, ring=False,
                                       wrapped=True),
        "llava flash": check_flash(torch, B=LLAVA_BATCH, Hq=lh.hq,
                                   Hkv=lh.hkv, S=lS, hd=llava.hd,
                                   dtype=bf16, window=0),
        "llava decode": check_decode(torch, B=LLAVA_BATCH, Hq=lh.hq,
                                     Hkv=lh.hkv, S=lS + GEN + 1,
                                     hd=llava.hd, dtype=bf16,
                                     fill=lS + GEN // 2, window=0,
                                     ring=False),
        "mistral_large flash": check_flash(
            torch, B=1, Hq=big.n_heads, Hkv=big.n_kv_heads,
            S=MESH_PIPE["seq"], hd=big.hd, dtype=bf16, window=0),
        "compressed_psum quantize": quant,
        "compressed_psum dequantize": dequant,
        **family_kernel_checks(torch, fam, m),
        **{name: check_flash(torch, B=B_, Hq=hq, Hkv=hkv, S=sq, Sk=sk, hd=hd,
                             dtype=getattr(torch, dt), window=w,
                             q_offset=off)
           for name, B_, hq, hkv, sq, sk, hd, w, off, dt
           in FLASH_OFFSET_ROWS},
    }
    records += checks.values()
    checks_ok(checks.values())
    del kv
    kv_digest = digest_rate(checks["phi3 kv_item"])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.monotonic()
    world = MeshWorld(m)
    try:
        # ---- the collectives on card tensors -------------------------------
        outs = world.run("collectives")
        records.append(emit("phase_time", of="mesh spawn + collectives",
                            seconds=time.monotonic() - t0))
        paths["mesh_collectives"] = _summed(outs)
        o = outs[0]
        rec = emit(
            "mesh", part="compressed_psum", ranks=m, values=o["values"],
            block=256, timing=[x_["device_ms"] for x_ in outs],
            wall_ms=[x_["wall_ms"] for x_ in outs], label=MESH_LABEL,
            launches=paths["mesh_collectives"],
            max_abs_err=max(x_["max_abs_err"] for x_ in outs),
            exact_scale=o["exact_scale"],
            within_ok=all(x_["max_abs_err"] <= CPSUM_SHARE * x_["exact_scale"]
                          for x_ in outs),
            plain_ok=all(x_["plain_equal"] for x_ in outs),
            same_ok=len({x_["digest"] for x_ in outs}) == 1,
            hier={n: {"max_abs_err": max(x_[n]["max_abs_err"] for x_ in outs),
                      "exact_scale": o[n]["exact_scale"],
                      "wall_ms": [x_[n]["wall_ms"] for x_ in outs],
                      "device_ms": [x_[n]["device_ms"] for x_ in outs]}
                  for n in ("hier", "hier_compressed")},
            hier_ok=all(x_["hier"]["max_abs_err"]
                        <= 1e-4 * x_["hier"]["exact_scale"] for x_ in outs),
            hier_compressed_ok=all(
                x_["hier_compressed"]["max_abs_err"]
                <= CPSUM_SHARE * x_["hier_compressed"]["exact_scale"]
                for x_ in outs))
        records.append(rec)
        checked(rec, "mesh collectives", ("within_ok", "plain_ok", "same_ok",
                                           "hier_ok", "hier_compressed_ok"))
        # each rank quantizes twice (its values, its reduced chunk) and
        # dequantizes twice (the received chunks, the gathered result)
        for name in ("quantize_int8", "dequantize_int8"):
            _launches_per_layer(paths, "mesh_collectives", name, 2 * m)

        # ---- phi3-mini at TP 4 -------------------------------------------
        batch = _prompts(torch, phi3, pB, pS, rng)
        mesh_tp_serve(torch, world, tmp, paths, records, phi3, batch,
                      MESH_PHI3["steps"], "mesh_phi3", kv_digest=kv_digest,
                      sp_steps=MESH_SP_STEPS)

        # ---- mixtral at EP 4, with and without sequence parallelism ------
        mesh_mixtral(torch, world, tmp, paths, records, rng)

        # ---- mistral-large through the pipeline ----------------------------
        t_part = time.monotonic()
        n_layers = MESH_PIPE["stages"] * MESH_PIPE["per_stage"]
        cut = dataclasses.replace(big, n_layers=n_layers)
        from repro_torch.models.api import build as build_api
        lm = build_api(cut).init(SEED, device="cuda")
        toks = torch.randint(0, big.vocab, (MESH_PIPE["micro"], 1,
                                            MESH_PIPE["seq"]),
                             generator=rng, dtype=torch.int32)
        x = lm.embed[toks.to("cuda").long()]
        pos = torch.arange(MESH_PIPE["seq"], dtype=torch.int32,
                           device="cuda")
        ctx = ShardCtx(impl="cuda")
        with torch.no_grad():
            ys = []
            for mb in x:
                h = mb
                for lp in lm.layers:
                    h = dense_layer_apply(h, lp, cut, ctx, positions=pos)
                ys.append(h)
            y = torch.stack(ys)
        ref_path = os.path.join(tmp, "pipe.pt")
        torch.save({"tokens": toks, "y": y.cpu()}, ref_path)
        outs = world.run("pipeline", lm=lm, arch=big.name,
                         ref_path=ref_path)
        paths["mesh_pipeline"] = _summed(outs)
        rec = emit(
            "mesh", part="mistral-large pipeline", arch=big.name,
            stages=MESH_PIPE["stages"], layers_per_stage=MESH_PIPE["per_stage"],
            microbatches=MESH_PIPE["micro"], microbatch=[1, MESH_PIPE["seq"]],
            ticks=MESH_PIPE["micro"] + MESH_PIPE["stages"] - 1,
            reduced={"n_layers": [n_layers, big.n_layers]},
            label=MESH_LABEL, timing=[o["timing"] for o in outs],
            launches=paths["mesh_pipeline"],
            max_abs_err=max(o["max_abs_err"] for o in outs),
            scale=outs[0]["scale"],
            exact=[o["exact"] for o in outs],
            pipeline_ok=all(o["max_abs_err"] <= PIPE_SHARE * o["scale"]
                            for o in outs),
            same_ok=len({o["digest"] for o in outs}) == 1)
        records.append(rec)
        checked(rec, "mistral-large's pipeline", ("pipeline_ok", "same_ok"))
        _launches_per_layer(paths, "mesh_pipeline", "flash_attention",
                            n_layers * MESH_PIPE["micro"])
        del lm, x, y, ys
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        records.append(emit("phase_time", of="mesh pipeline",
                            seconds=time.monotonic() - t_part))

        # ---- llava at TP 4 -----------------------------------------------
        batch = _prompts(torch, llava, LLAVA_BATCH, LLAVA_PROMPT, rng)
        batch["extra_embeds"] = torch.randn(
            (LLAVA_BATCH, llava.frontend_len, llava.d_model),
            generator=rng).numpy()
        mesh_tp_serve(torch, world, tmp, paths, records, llava, batch,
                      MESH_LLAVA["steps"], "mesh_llava")

        # ---- the enc-dec, SSM and hybrid at TP 4 ---------------------------
        for name, spec in MESH_FAMILY_SERVE.items():
            cfg = fam[name]
            batch = _prompts(torch, cfg, spec["batch"], spec["prompt"], rng)
            if cfg.family == "encdec":
                batch["frames"] = torch.randn(
                    (spec["batch"], spec["prompt"], cfg.d_model),
                    generator=rng).numpy()
            mesh_tp_serve(torch, world, tmp, paths, records, cfg, batch,
                          spec["steps"], f"mesh_{name}",
                          launches=_family_launches(cfg, m, spec["gen"]),
                          gen=spec["gen"],
                          sp_steps=MESH_SP_STEPS if name == "mamba2" else 0)

        # ---- smollm-360m at TP 4: the query-sequence split ---------------
        smol = get_config(MESH_SMOLLM["arch"])
        batch = _prompts(torch, smol, MESH_SMOLLM["batch"],
                         MESH_SMOLLM["prompt"], rng)
        mesh_tp_serve(torch, world, tmp, paths, records, smol, batch,
                      MESH_SMOLLM["steps"], "mesh_smollm",
                      gen=MESH_SMOLLM["gen"], sp_steps=MESH_SP_STEPS)

        # ---- smollm-360m trained on the mesh, the elastic restore ----------
        train_checks = ("loss_ok", "grad_norm_ok", "leaf_norms_ok",
                        "losses_ok", "same_ok", "no_kernel_ok")
        restart_checks = ("failure_ok", "elastic_ok", "elastic_step_ok",
                          "verify_ok")
        t_part = time.monotonic()
        nosp: dict = {}
        rec = mesh_train(torch, world, tmp, paths, nosp)
        records.append(rec)
        checked(rec, "training on the mesh", train_checks + restart_checks
                + ("hashes_ok", "query_rows_ok"))
        records.append(emit("phase_time", of="mesh train",
                            seconds=time.monotonic() - t_part))

        # ---- llava, the enc-dec, SSM and hybrid trained on the mesh -------
        for name, spec, seed in (
                [("llava", MESH_VLM_TRAIN, SEED + 61)]
                + [(k, v, SEED + 71 + i) for i, (k, v) in enumerate(
                    MESH_FAMILY_TRAIN.items())]):
            t_part = time.monotonic()
            rec = mesh_steps_train(torch, world, paths, spec,
                                   f"mesh_{name}_train",
                                   f"{name} training", seed)
            records.append(rec)
            checked(rec, f"{name}'s training on the mesh", train_checks)
            records.append(emit("phase_time", of=f"mesh {name} train",
                                seconds=time.monotonic() - t_part))

        # ---- smollm-360m trained under sequence parallelism ---------------
        t_part = time.monotonic()
        rec = mesh_sp_train(torch, world, paths, nosp)
        records.append(rec)
        checked(rec, "training under sequence parallelism on the mesh",
                SP_TRAIN_CHECKS)
        records.append(emit("phase_time", of="mesh sp train",
                            seconds=time.monotonic() - t_part))

        # ---- qwen3-moe trained on the mesh, the elastic restore ------------
        t_part = time.monotonic()
        moe_nosp: dict = {}
        rec = mesh_moe_train(torch, world, tmp, paths, moe_nosp)
        records.append(rec)
        checked(rec, "qwen3-moe's training on the mesh",
                train_checks + restart_checks + ("routes_ok",))
        records.append(emit("phase_time", of="mesh qwen3-moe train",
                            seconds=time.monotonic() - t_part))

        # ---- qwen3-moe trained under sequence parallelism ------------------
        t_part = time.monotonic()
        rec = mesh_sp_train(torch, world, paths, moe_nosp,
                            MESH_MOE_SP_TRAIN, "mesh_moe_sp_train")
        records.append(rec)
        checked(rec, "qwen3-moe's training under sequence parallelism",
                SP_TRAIN_CHECKS + ("routes_ok",))
        records.append(emit("phase_time", of="mesh qwen3-moe sp train",
                            seconds=time.monotonic() - t_part))
    finally:
        codes = world.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(c != 0 for c in codes):
        fail(f"the mesh ranks exited with {codes}")
    return checks


def serve_timing(torch, server, batch, prompt, *, graph=True) -> dict:
    """A warm-up request, then prefill ms (eager), decode ms/token (eager,
    and as device time from a CUDA graph replay of the same step: what the
    card itself spends per token) and a profiler trace of one prefill and
    one decode step.  A step that syncs with the host (the MoE's expert
    counts) cannot be captured: without ``graph`` its device time is the
    trace's busy time."""
    server.generate(batch, 4)                              # warm-up request
    prefill_ms = call_ms(lambda: server.prefill(batch), iters=5, warmup=1)
    _, cache = server.prefill(batch)
    tok = torch.zeros((len(batch["tokens"]), 1), dtype=torch.int32,
                      device="cuda")

    def one_step():
        cache["pos"] = prompt
        server.decode(cache, tok)
    decode_ms = call_ms(one_step, iters=10, warmup=2)
    trace = {"prefill": device_busy(lambda: server.prefill(batch)),
             "decode_step": device_busy(one_step)}
    decode_device_ms = (device_ms(one_step, iters=5) if graph
                        else trace["decode_step"]["device_busy_ms"])
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
                decode_device_ms_per_token=decode_device_ms, trace=trace)


def once_per_fold(paths: dict, path: str, report) -> None:
    """Fail unless the path's digest launches equal the folds its transfer
    made: one launch per item or slab the mover handed over."""
    got = paths[path]["digest_items"]
    if got != report.checksum_folds:
        fail(f"the {path} path launched the digest {got} times for "
             f"{report.checksum_folds} items or slabs handed over")


def checked(rec: dict, what: str, keys) -> None:
    """Fail unless every check ``keys`` names in ``rec`` holds."""
    if not all(rec[k] for k in keys):
        fail(f"the {what} checks failed: "
             + json.dumps({k: rec[k] for k in keys}))


def need(paths: dict, path: str, names) -> None:
    """Fail unless every kernel in ``names`` launched on ``path``."""
    idle = [n for n in names if paths[path][n] == 0]
    if idle:
        fail(f"the {path} path never launched {idle}")


if __name__ == "__main__":
    sys.exit(main())
