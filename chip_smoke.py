"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. print the card, build every CUDA kernel from ``src/repro_torch``,
     print each instantiation's registers, spills and static shared
     memory from ptxas, and fail if a bf16 instantiation of K1 or K2
     that the main paths pick, or any of K3/K4's wgmma and split
     instantiations (all bf16, all on the plan's paths), spills;
  2. hold K1 (flash attention) against its plain PyTorch version in every
     setting the kernel supports and at the decoder prefill's own shapes
     and tiles, fp32 (the CUDA-core kernel) and bf16 (the tensor-core
     kernel, at every q tile it is built for), each at the kernel's kv
     tile, and its visit counts against ``live_block_counts``;
  3. GECToR-base at full width in bf16 (random weights from seed 0): the
     K1 forward against the plain-attention forward on a bucket-128 batch,
     and both against the same model in fp32, where K1's may be no worse
     than plain attention's within a stated factor;
  4. serve 64 sentences through ``ServingEngine(mode="encoder")`` with the
     tag head, one captured program per (bucket, batch) (``warmup``
     captures them), check the tags against direct ``predict_tags``
     calls and, exactly, against direct uncaptured forwards of the same
     batches, and that every served batch launched K1 once per layer
     (a replay counts the launches its capture recorded);
  5. time K1, its plain version and ``scaled_dot_product_attention`` (the
     yardstick; the port never calls it) by the profiler's device time,
     at the encoder's shapes and Qwen2-0.5B's prefill, time one serving
     batch's forward
     and break its device time down by kernel, report the serve latencies;
  6. hold K2 (decode attention) against its plain version at the same
     split count in every setting, fp32, bf16 and a bf16 query over an
     fp32 cache, and at explicit split counts (splits with no live
     tile, a wrapped ring, a window, a softcap, a ragged L, one split),
     and its visit counts against ``live_tile_counts``;
  7. Qwen2-0.5B at full width in bf16 (random weights from seed 0): a
     B=32 bucket-128 batch prefilled (K1) and decoded 15 teacher-forced
     steps (K2), against the plain-attention path and both against the
     same model in fp32, where the kernels' logits may be no worse than
     plain attention's within a stated factor; where free-running greedy
     streams of the two bf16 paths part is reported, not gated;
  8. serve 48 requests through ``ServingEngine(mode="decoder")`` batch at
     a time (greedy, sampled and eos-stopped), each batch's prefill and
     decode one captured program: a first burst captures the sampled
     programs, the measured burst replays every batch; check every
     request's tokens in both bursts against a direct uncaptured prefill
     + ``decode_segment`` call on the same padded batch, the finish
     reasons, and that each batch launched K1 once per layer and K2 once
     per layer and decode step;
  9. time K2 (both launches: the split pass and the merge), its plain
     version and SDPA by device time, one decode step and its kernels,
     and the decoder burst;
 10. hold K3 (the dequant-fused int8 matmul) and K4 (the tiled matmul)
     against their plain versions at every (K, N) of both models'
     projections for M = 1, 2, 8, 16, 32, 64 and 4096, at ragged shapes
     and at a K that is not a multiple of the split slab, fp32 and bf16,
     with an all-zero weight column that must give exact zeros; then at
     Qwen2's decode shapes rows of M = 1, 2, 4, 8 and 16 must be the same
     bits as those rows in M = 32, and two launches the same bits;
 11. GECToR-base with int8 weights (``quantize_params``) in bf16: the K3
     forward against the plain-int8 forward, both against the int8 model
     in fp32, gated by phase 3's factors;
 12. Qwen2-0.5B with int8 weights and an int8 KV cache in bf16: prefill
     and 15 teacher-forced steps, the kernel path (K1, K2, K3) against the
     plain path, both against the int8 model in fp32, gated as phase 7;
 13. serve with ``weight_quant="int8"``: 32 sentences through the encoder
     engine (tags against direct ``predict_tags`` calls on the engine's
     tree, 72 K3 launches a batch) and 16 requests through the decoder
     engine with ``kv_quant="int8"`` too (tokens and finish reasons
     against direct calls, 144 x 16 K3 launches a batch), and
     ``metrics()["weight_bytes"]`` beside the float engines';
 14. time K3 and K4 at the main shapes by device time beside their
     bounds, plain versions and ``torch.matmul`` on the weight dequantized
     beforehand (the yardstick; the port never calls it), each as a factor
     of that call beside its target (2.0 at M = 4096, 1.5 for K3 at a
     decode step's M = 32), the K3 time of a Qwen2 int8 decode step
     beside its 1.0 ms target, then one int8 GECToR forward and one int8
     Qwen2 decode step beside the float ones;
 15. hold K5 (the RG-LRU linear scan) against its plain version at the
     hybrid's shapes, a long S and a ragged W, fp32, within 1e-5 of the
     output's largest magnitude, with an identity channel (a = 1, b = 0)
     that must stay exactly 0;
 16. hold K1 and K2 at head dim 256 against their plain versions in
     phases 2 and 6's settings and at the hybrid's shapes, with their
     tolerances and exact visit counts;
 17. RecurrentGemma-9B at full width in bf16 (random weights from seed
     0), cut to one period (19 layers) so that an fp32 copy fits beside
     it: a B=32 bucket-128 batch prefilled (K1, K5) and decoded 15
     teacher-forced steps (K2), the kernel path against the plain path
     (plain attention and plain scan), both against the fp32 model,
     gated by phase 7's factors;
 18. serve 32 requests (greedy, sampled, eos-stopped) through the
     decoder engine at full depth (38 layers) as one batch: tokens and
     finish reasons equal direct calls (the decode loop in sync debug
     mode "error"), and exactly 26 K5, 12 K1, 12 x 15 K2 and no K3/K4
     launches;
 19. time K5, and K1 and K2 at the hybrid's shapes, beside their bounds,
     plain versions and SDPA (K5 has no library call), one full-depth
     prefill and one decode step broken down by kernel with the device's
     idle share, and the hybrid's ``weight_bytes``;
 20. the paper's concurrency ladder through the port's deploy lab:
     ``repro_torch.launch.experiment.main`` over the 21 paper profiles
     with full-width GECToR-base (bf16, no head, bucket 32, max_batch
     32) at NS = 1, 2, ..., 512, 3 bursts a rung: one record per profile
     with the JAX package's fields and schema, every cell's latency and
     rate finite and positive, every paper finding in the drift report,
     and 12 K1 launches per batch served (warmup included; every batch
     a captured program); then
     ``run_ladder`` on the int8 encoder engine over the same ladder and
     sentences (12 K1 and 72 K3 launches a batch, one served row against
     a direct forward), each engine's resident and peak device memory
     beside ``weight_bytes``, and ``serve --ladder 1 16`` on the card;
 21. (after phase 14) captured programs against their uncaptured calls,
     bit for bit, the replay in sync debug mode "error", and both timed
     (host-clock wall, kernels and device idle share by the profiler):
     the GECToR-base encoder program at B=32 in buckets 32 and 128 and a
     Qwen2-0.5B decode step at B=32, greedy and sampled;
 22. one Qwen2-0.5B row's bits against the batch it runs in, float and
     int8 weights and KV: its prefill hidden state and first-token
     logits for every join size the continuous loads can form (n =
     1..16 in buckets 32/64/128, 1..32 in 256/512), padded as the engine
     pads them to M >= 128 rows, must equal the widest join's; one
     decode step's logits at widths 1-16 in caches of 48, 144, 272 and
     528 slots must equal the cap's (16 or 32) at the cap's K2 split
     count (the engine's ``decode_width``), and are printed beside at
     K2's own split count for the width; then GECToR-base's encoder
     program (float and int8): rows of batches 1..16 at bucket 32 and
     1..4 at bucket 128, which the engine pads like the prefills, equal
     the widest batch's; and the eager decoder's (``use_scan_decode=
     False``) first-token logits at bucket 32, batches 1..4;
 23. Qwen2-0.5B at full width through the default continuous decoder
     (lanes over buckets 32/64/128, the KV pool, adaptive width tiers,
     ``warmup(sampled=True)`` capturing every program): 48 greedy and
     sampled requests of mixed lengths arriving 2 ms apart; every
     request's tokens, exactly, against the same load through fixed
     width and batch at a time (the engine pads each prefill to the M
     where phase 22 finds a row's bits independent of the batch), a
     measured window that captures nothing, K1/K2/K3
     launches against its prefill batches and segments, the
     untouched-slot property bitwise on the pool, the smallest and the
     largest width tier's segment captured against uncaptured, and
     device memory; float,
     then int8 weights and KV; then 32 staggered requests of 257-500
     tokens in bucket 512 at max_batch 32, adaptive against fixed width
     and batch at a time (the continuous engines' second pass, whose
     occupancy moves across the width tiers), float and int8;
 24. chunked prefill (``prefill_chunk``): (a) prompts of 100, 257 and
     500 tokens prefilled chunk by chunk (C = 128, and 64 at bucket 128)
     against whole, fp32 within 1e-4 relative and bf16 within phase 7's
     factor of the plain path's error, the bf16 difference kept as the
     near-tie threshold; a chunk's attention over the cache
     (``naive_attention``) timed against SDPA on its mask; (b) the chunk
     program's row 0 alone and beside 1..15 other fills, padded as the
     engine pads, bit for bit, and captured against uncaptured; (c) 48
     requests of up to 500 tokens in buckets 128/256/512 through the
     continuous engine with and without ``prefill_chunk=128``, float and
     int8: equal tokens, except requests that part at a near-tie of the
     unchunked run (the least logit change that changes the sampler's
     choice, top-k boundary included, below (a)'s difference; printed
     with their margins and counted); the
     in-flight row's segment gaps while a 500-token prompt prefills,
     chunked against whole; and (after phase 19) RecurrentGemma-9B at
     full depth, 4 requests chunk by chunk through the engine against
     direct calls, with 26 K5 launches per chunk program;
 25. the prefix cache at buckets 128 (C = 32) and 512 (C = 128), float
     and int8 KV: a system prompt of 3/4 of the bucket plus unique
     suffixes, served one by one; warm hits equal a cold engine's tokens
     exactly, the counters equal the expected 7 hits, 1 miss, 1 insert,
     a measured window after ``warmup()`` captures nothing; a donor that
     joined whole (K1) held to phase 24's token rule; a store of one
     entry evicts and stays equal to cold; a request's prefill device
     time cold (its chunk programs) against warm (one hit program);
 26. (after phase 20) the deploy lab's decoder scenarios
     (``--staggered --prefix-cache --quant --spec-decode``, full-width
     Qwen2-0.5B, the CLI's defaults) over four of the 21 paper profiles
     (``LAB_PROFILES``):
     records, cells and compile-clean windows checked, the
     ``prefix_cache`` and ``quant`` cells printed per profile and the
     ``spec_decode`` cells for AWS/C, AWS/G and Azure/A, the grid
     written to ``chiprun_out/lab``;
 27. (after phase 25) speculative decoding on Qwen2-0.5B at full width,
     bf16, float and int8 W+KV: (a) K2 with S > 1 queries a row at widths
     1-16 x S 2-5 in rings of 148 and 532 slots (fp32, and int8
     dequantized to bf16) at the plain engine's split partition, against
     its plain version within 2e-2 with exact visits, and bit for bit
     against S single-query launches and the ring cut to the plain
     engine's length (trailing dead splits), and the decode route
     (``ops.gqa_decode``) picking the same partition at S = 1; timed
     at the verify shape (16 x 5 queries over 532 slots) beside its
     plain version, SDPA and its bound; (b) ``verify_chunk`` logits
     against spec_k + 1 ``decode_step`` logits bit for bit at widths
     1-16 x spec_k 1-4, verify in the spec engine's ring and decode in
     the plain one, and the first M at which unblocked products would
     part from a decode step's rows; (c) phase 23's load through the
     spec engine (spec_k 4, self-drafted): every stream equal to phase
     23's, a compile-clean window after ``warmup(sampled=True)``, launch
     counts against joins and rounds, a captured round against the same
     round uncaptured, the accept rate and tokens/s; (e) a captured
     round at width 1 and 16 beside phase 23's 4-step segments.
 28. (after phase 26) training: (a) K1's backward against its plain
     version in phases 2 and 16's settings and at the training shapes of
     Qwen2-0.5B (B=8 S=512, 14/2 heads, causal) and the hybrid (B=2
     S=512, 16/1 heads of 256, causal, window 2048), fp32 and bf16 at
     every built tile, visits from both sides against
     ``live_block_counts`` / ``live_q_counts``, the forward's
     log-sum-exps against the plain forward's (whose out and lse the
     plain backward takes), the forward's output with its log-sum-exps
     bit-equal to the output without, two calls bit-equal, and the bf16
     dK/dV kernel's cluster within one bf16 rounding of a launch with
     cluster 1; (b) K5's
     backward against its plain version at phase 15's shapes; (c) both
     timed by ``graph_ms`` beside their bounds, plain versions and (K1)
     SDPA's backward, K1's at the encoder's shape and at the two
     training shapes, there also at every cluster size; (d)
     Qwen2-0.5B at full width in bf16: one batch's gradients through the
     kernels and through plain attention against fp32 plain-attention
     gradients (the kernels' errors within 1.5x plain's), then 20
     ``train_step``s with remat on SyntheticLM, each launching K1 24
     times forward, 24 in remat and 24 backward, the loss falling, step
     wall, the profiled step's idle share, breakdown and peak memory
     printed; (e) GECToR-base,
     50 steps of ``gector_loss`` and AdamW at B=32 x 128 on GECCorpus
     (12 K1 launches forward and 12 backward a step), the loss falling;
     (f) RecurrentGemma-9B at full width with its pattern cut to one
     (rglru, rglru, attn_local) triple (all 38 layers' params, grads and
     fp32 moments do not fit one card): the gradient gate and one step
     (K5 forward and backward, K1 at head dim 256); (g) (d)'s and (e)'s
     trees saved and restored bit for bit, and the Qwen2 checkpoint
     serving the tokens of the tree in memory; (h) printed only: the
     spec bench's target and a one-layer draft trained 60 steps, their
     accept rate through the spec engine beside the untrained pair's.
 29. (after phase 28, with GECToR's and Qwen2's trees freed) K1 and K2
     at the new models' shapes against their plain versions, by phase 2
     and 6's rules (fp32 1e-4, bf16 2e-2 against fp32, visits exact):
     head dims 128 and 160, causal and not, a window, a softcap, a
     kv_len, GQA (stablelm's 32/8 and gemma2's 32/16, softcap 50),
     explicit split counts; then timed by ``graph_ms`` beside their
     bounds, plain versions and SDPA: K1 at stablelm's prefill (B=16
     S=512 32/8 of 160) and gemma2's (B=8 S=512 32/16 of 128, softcap
     50, SDPA without), K2 at B=16 over 576 fp32 slots at both models'
     heads; K3/K4 timed at stablelm's projections (M = 16 and 4096;
     phase 10 holds them against their plain versions there);
 30. stablelm-12b at full width and depth (40 layers, head dim 160,
     ``init_params(seed=0)``): 32 requests (16 in bucket 128, 16 of
     129-500 tokens in bucket 512, half sampled) through the default
     continuous decoder at max_batch 16, 32 new tokens, served twice
     (the first pass captures each program at its first, uncaptured
     call; the second replays): the passes' streams equal, the second
     pass's K1/K2 (and K3) launches those of its joins and steps; float,
     then int8 W+KV; phase 21's rule (a decode step program at B=16,
     greedy and sampled, captured against uncaptured) and phase 22's
     (row 0 at join sizes 1 and 16 and decode widths 1 and 16) on the
     float and the int8 tree; then ``prefill_chunk=128`` with the prefix
     cache over a 256-token system prompt, warm hits equal to cold;
 31. gemma2-27b, with less than 2 GB left allocated: (a) one period
     (local + global, full width) against its fp32 copy by phase 7's
     rule on a 4608-token prompt past the window, then all 46 layers
     (the fused ``wqkv``) through K1 against plain attention on the
     last 64 positions; (c) ``long_ctx`` at one period: a global ring
     capped at 32,768 slots filled past the cap, K2 on it against its
     plain version, and 8 decode steps by phase 7's rule; (b) 16
     requests (one of 500 tokens, chunk by chunk) through the
     continuous decoder at max_batch 8, ``prefill_chunk=128``, served
     twice as in phase 30, and phase 21's and 22's rules at width 8.
 32. qwen2-moe-a2.7b at 24 layers, served and spec-decoded, and the two
     larger MoE configs cut in depth (``phase_moe``);
 33. MoE training (``phase_train_moe``);
 34. xlstm-125m at full size, on an emptied card (``phase_xlstm``): (a)
     an mLSTM and the sLSTM block in bf16 against fp32, and the mLSTM's
     parallel form against its recurrence at JAX's tolerances; (b) 32
     requests served twice through the continuous decoder with
     ``prefill_chunk=128`` and 32 short ones through the batch decoder
     (tokens/s, peak memory, every program's build seconds), and the
     decode step captured against uncaptured; (c) phase 22's rule at
     joins of 1-16 in buckets 32 and 128 and decode widths 1-16; (d) 10
     train steps at B=8 x 512, two backwards bit-equal. No kernel of
     K1-K5 runs there.

Prints a ``{"kernels": [...]}`` line (each kernel with its design and
its instantiations' registers), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is missing or the repository's ``src/`` is not beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc as gc_mod
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12            # fp32 outside the tensor cores
FP32_TOL = 1e-4                    # fp32 kernel vs fp32 plain version
BF16_TOL = 2e-2                    # bf16 kernel vs fp32 plain version
TAG_AGREEMENT = 0.99               # bf16 GEMMs round by batch width
# Against the fp32 forward, the K1 bf16 forward may be at most this much
# worse than the plain-attention bf16 forward: its hidden-state error by
# HIDDEN_ERR_FACTOR, its share of flipped tags by TAG_FLIP_FACTOR.
HIDDEN_ERR_FACTOR = 1.5
TAG_FLIP_FACTOR = 2.0
MAIN = dict(B=32, S=128, H=12, D=64)   # encoder serving shape (bucket 128)
# decoder: Qwen2-0.5B, B=32, bucket 128 + 16 new tokens, bf16 q, fp32 cache
DECODE_MAIN = dict(B=32, L=144, Hq=14, Hkv=2, D=64)
NEW_TOKENS = 16
# RecurrentGemma-9B's local attention at B=32, bucket 128 + 16 new tokens:
# 16 query heads over one kv head of 256, a ring of 144 slots (the window
# of 2048 clamped to the batch's cache length)
HYBRID_MAIN = dict(B=32, S=128, L=144, Hq=16, Hkv=1, D=256)
HYBRID_WINDOW = 2048
# K5's main shape: the hybrid's prefill scan at B=32, bucket 128, W=4096
SCAN_MAIN = (32, 128, 4096)
SCAN_TOL = 1e-5                    # relative to the output's largest value
# Against the fp32 model, the kernels' bf16 logits may be at most this much
# worse than the plain-attention bf16 path's (max and mean abs error), and
# their top-1 flips at most TOP1_FLIP_FACTOR x plain's (or 1% of rows).
LOGIT_ERR_FACTOR = 1.5
TOP1_FLIP_FACTOR = 2.0
# K3/K4's main shape in the kernels line: GECToR-base's wq at B=32, bucket
# 128 (M = 4096 rows, K = N = 768)
MM_MAIN = (4096, 768, 768)
# K3/K4 targets against torch.matmul on the dequantized bf16 weight
# (printed, not gated): large M, and K3 at a decode step's M; and the K3
# time of one Qwen2-0.5B int8 decode step
MM_TARGET_LARGE = 2.0
MM_TARGET_DECODE = 1.5
STEP_K3_TARGET_MS = 1.0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_rows(prof, n):
    """(device ms per call, launches per call, name) of every kernel the
    profiler saw run on the card, over ``n`` calls."""
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            rows.append((dev / n / 1e3, e.count // n, e.key))
    return rows


def device_ms(fn, iters: int = 20, warmup: int = 3, launches: int = 1):
    """The card's own time for one call of ``fn``: the summed device time
    of every kernel it runs, from the profiler (None if it saw fewer than
    ``launches`` kernel launches a call in two tries: a trace that lost
    one of K2's two launches once read below its bound).
    Unlike ``cuda_ms`` this leaves out the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):            # the profiler now and then sees no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof, iters)
        if sum(r[1] for r in rows) >= launches:
            return sum(r[0] for r in rows)
    return None


def graph_ms(fn, iters: int = 20, replays: int = 5, warmup: int = 3,
             stream=None):
    """The card's time for one call of ``fn`` with no host time between
    its kernels: ``iters`` calls captured in one CUDA graph, timed by
    CUDA events around ``replays`` replays. It never comes back empty.
    K2's time in every row (its trace, ``device_ms``, has lost one of
    K2's two launches in long runs; where both read, they agreed within
    5%), and the backward kernels', their plain versions' and SDPA's
    backward's. ``stream`` is the stream to warm up and capture on: where
    ``fn`` runs autograd's backward, the one its forward ran on (autograd
    runs a backward op on its forward's stream)."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def ptxas_table(log):
    """Per compiled kernel instantiation, from ``nvcc -Xptxas -v``:
    {demangled name: (registers, spill store bytes, spill load bytes,
    stack frame bytes, static shared memory bytes)}."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows[name] = [0, 0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows[name][1:4] = (int(m.group(2)), int(m.group(3)),
                               int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[name][4] = int(sm.group(1)) if sm else 0
    names = list(rows)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        names = out.splitlines() if len(out.splitlines()) == len(rows) \
            else names
    return {n: tuple(v) for n, v in zip(names, rows.values())}


def attn_bound_ms(B, Sq, Skv, Hq, Hkv, D, itemsize, causal=False):
    """Least time for one attention call: each input read once and the
    output written once over HBM, or the scored products at the bf16
    tensor-core peak, whichever is larger."""
    nbytes = itemsize * D * (2 * B * Sq * Hq + 2 * B * Skv * Hkv)
    pairs = Sq * Skv if not causal else Sq * (Sq + 1) // 2
    flops = 4 * B * Hq * pairs * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def randn(gen, *shape, dtype):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def k1_settings(attn_block_sizes):
    """Phase 2's K1 settings, D = 64 and 128. The decoder's prefill
    settings take bq from ``attn_block_sizes`` as the model does: B=32
    bucket 128 (phases 7 and 9) and B=16 in buckets 32, 64 and 128 (the
    engine's batches in phase 8)."""
    def prefill_bq(B, S):
        return attn_block_sizes("prefill", S, bh=B * DECODE_MAIN["Hq"],
                                dtype=torch.bfloat16)[0]
    decoder = [(f"decoder prefill B={B} S={S}", B, S, S, DECODE_MAIN["Hq"],
                DECODE_MAIN["Hkv"], DECODE_MAIN["D"], prefill_bq(B, S),
                dict(causal=True, kv_len=S))
               for B, S in ((32, 128), (16, 32), (16, 64), (16, 128))]
    settings = [  # (name, B, Sq, Skv, Hq, Hkv, D, bq, kwargs)
        ("non-causal kv_len<Skv", 4, 160, 160, 12, 12, 64, 64,
         dict(causal=False, kv_len=131)),
        ("causal", 2, 256, 256, 8, 8, 64, 64, dict(causal=True)),
        ("causal window 64", 2, 256, 256, 8, 8, 128, 32,
         dict(causal=True, window=64)),
        ("softcap 50", 2, 128, 128, 8, 8, 64, 32,
         dict(causal=False, softcap=50.0)),
        ("GQA G=2", 2, 192, 192, 8, 4, 128, 64, dict(causal=True)),
        ("GQA G=7", 2, 96, 96, 14, 2, 64, 32, dict(causal=False)),
        ("GQA G=7 causal D=64", 2, 128, 128, 14, 2, 64, 64,
         dict(causal=True)),
        ("Sq != Skv", 3, 100, 228, 8, 8, 128, 64, dict(causal=False)),
        ("D=128 causal window kv_len", 2, 200, 200, 4, 2, 128, 64,
         dict(causal=True, window=40, kv_len=170)),
        ("fully masked rows", 2, 160, 160, 4, 4, 64, 32,
         dict(causal=True, window=8, kv_len=100)),
        ("main shape", MAIN["B"], MAIN["S"], MAIN["S"], MAIN["H"],
         MAIN["H"], MAIN["D"], 64, dict(causal=False)),
        *decoder,
    ]
    return settings


def k1_settings_256(attn_block_sizes):
    """Phase 16's K1 settings at D = 256, phase 2's kinds, and the
    hybrid's prefill (B=32 bucket 128, 16 query heads over one kv head,
    causal with the local window of 2048) at the bq the model takes."""
    h = HYBRID_MAIN
    bq = attn_block_sizes("prefill", h["S"], bh=h["B"] * h["Hq"],
                          head_dim=h["D"], dtype=torch.bfloat16)[0]
    return [  # (name, B, Sq, Skv, Hq, Hkv, D, bq, kwargs)
        ("D=256 non-causal kv_len<Skv", 2, 160, 160, 4, 4, 256, 32,
         dict(causal=False, kv_len=131)),
        ("D=256 causal", 2, 256, 256, 4, 4, 256, 32, dict(causal=True)),
        ("D=256 causal window 64", 2, 256, 256, 4, 4, 256, 32,
         dict(causal=True, window=64)),
        ("D=256 softcap 50", 2, 128, 128, 4, 4, 256, 32,
         dict(causal=False, softcap=50.0)),
        ("D=256 GQA G=16 causal", 2, 128, 128, 16, 1, 256, 32,
         dict(causal=True)),
        ("D=256 Sq != Skv", 3, 100, 228, 4, 2, 256, 32,
         dict(causal=False)),
        ("D=256 fully masked rows", 2, 160, 160, 4, 4, 256, 32,
         dict(causal=True, window=8, kv_len=100)),
        ("hybrid prefill", h["B"], h["S"], h["S"], h["Hq"], h["Hkv"],
         h["D"], bq, dict(causal=True, window=HYBRID_WINDOW,
                          kv_len=h["S"])),
    ]


def phase_kernel_parity(fa, settings, main="main shape"):
    """K1 against its plain version in each of ``settings`` at the kv tile
    the kernel has for the dtype and head dim: fp32 at the setting's bq
    (32 where fp32 is not built for it), bf16 at every bq the kernel is
    built for (every tile ``attn_block_sizes`` can pick). Returns the
    bf16 error of the setting named ``main`` at its own bq and the
    settings checked."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    main_err, checked = None, 0
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, B, Sq, Skv, Hq, Hkv, D, bq0, kw in settings:
            q = randn(gen, B, Sq, Hq, D, dtype=dtype)
            k = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            v = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            bqs, bk = fa.TILES[(dtype, D)]
            fp32_bq = bq0 if bq0 in bqs else bqs[0]
            for bq in (bqs if dtype == torch.bfloat16 else (fp32_bq,)):
                out, visits = fa.flash_attention(q, k, v, bq=bq,
                                                 return_visits=True, **kw)
                torch.cuda.synchronize()
                ref, ref_visits = fa.flash_attention_plain(
                    q.float(), k.float(), v.float(), bq=bq, bk=bk, **kw)
                err = (out.float() - ref).abs().max().item()
                close = torch.allclose(out.float(), ref, atol=tol,
                                       rtol=0.0 if dtype == torch.float32
                                       else tol)
                want = torch.tensor(fa.live_block_counts(
                    Sq, Skv, causal=kw.get("causal", True),
                    window=kw.get("window"), bq=bq, bk=bk,
                    kv_len=kw.get("kv_len")), dtype=torch.int32)
                vis_ok = bool((visits.cpu() == want).all()) and \
                    bool((visits == ref_visits).all())
                print(f"K1 {name:28s} bq={bq:<3d} bk={bk:<3d} "
                      f"{str(dtype):15s} max_abs_err {err:.3e} "
                      f"(tol {tol}) visits {'ok' if vis_ok else 'WRONG'}",
                      flush=True)
                if not (close and vis_ok):
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version: {name} {dtype} bq={bq}")
                checked += 1
                if name == main and dtype == torch.bfloat16 and bq == bq0:
                    main_err = err
    return main_err, checked


def phase_breakdown(fwd, fwd_plain, name):
    """Where the device time of one serving batch goes: host-clocked
    forward times (K1 and plain attention) and, from the profiler, the
    kernels of the K1 forward by name."""
    from torch.profiler import ProfilerActivity, profile
    n = 5
    with torch.inference_mode():
        t_fwd = cuda_ms(fwd, iters=10)
        t_plain = cuda_ms(fwd_plain, iters=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fwd()
            torch.cuda.synchronize()
    print(f"forward B=32 bucket 128 bf16: K1 {t_fwd:.4f} ms, plain "
          f"attention {t_plain:.4f} ms [{name}]", flush=True)
    rows = kernel_rows(prof, n)
    if not rows:
        print("profiler: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"profiler: kernels {busy:.4f} ms of the {t_fwd:.4f} ms forward "
          f"(device idle {max(0.0, 1 - busy / t_fwd):.1%})")
    for ms, calls, key in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{calls:<3d} {key[:90]}")


def to_fp32(tree):
    """Float leaves to fp32; int8 weights (and their fp32 scales) kept."""
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def sentences(rng, n, lo, hi, vocab):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def padded(sents, bucket):
    toks = np.zeros((len(sents), bucket), np.int64)
    mask = np.zeros((len(sents), bucket), bool)
    for i, s in enumerate(sents):
        toks[i, :len(s)] = s
        mask[i, :len(s)] = True
    return toks, mask


# ------------------------------------------------------------ decoder
def kv_positions(rng, pattern, B, L):
    """(q_pos (B,), kv_pos (B, L)) int32 for a cache pattern: "full"
    0..L-1, "prefix" a short live prefix then empty slots, "ring" a
    wrapped ring (positions above L), "holes" empty slots among live
    ones. The query sits at the newest position."""
    pos = np.full((B, L), -1, np.int32)
    q_pos = np.empty(B, np.int32)
    for b in range(B):
        if pattern == "full":
            n = L
        elif pattern == "prefix":
            n = int(rng.integers(1, max(2, L // 8)))
        elif pattern == "ring":
            n = L + int(rng.integers(1, 3 * L))
        else:
            n = L
        p = np.arange(n)[-L:]
        pos[b, p % L] = p
        if pattern == "holes":
            pos[b, rng.choice(L - 1, L // 4, replace=False)] = -1
        q_pos[b] = n - 1
    return q_pos, pos


def decode_bound_ms(q_pos, kv_pos, Hq, Hkv, D, q_item, kv_item,
                    window=None):
    """Least time for one decode-attention call on these inputs: the live
    K/V slots read once in the stored type, q read and the output written
    once, the positions read once, over HBM; or 4 flops per live slot,
    head dim and query head at the bf16 tensor-core peak."""
    live = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        live &= kv_pos > q_pos[:, None] - window
    n_live = int(live.sum())
    B = kv_pos.shape[0]
    nbytes = (2 * n_live * Hkv * D * kv_item + 2 * B * Hq * D * q_item
              + kv_pos.size * 4 + B * 4)
    flops = 4 * n_live * Hq * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k2_settings():
    """Phase 6's K2 settings, D = 64 and 128."""
    m = DECODE_MAIN
    return [  # (name, B, L, Hq, Hkv, D, kv_pos pattern, kwargs)
        ("full cache", 4, 128, 8, 2, 64, "full", {}),
        ("short prefix, long ring", 4, 1024, 8, 2, 64, "prefix", {}),
        ("wrapped ring", 4, 160, 8, 2, 128, "ring", {}),
        ("empty slots", 4, 256, 8, 2, 64, "holes", {}),
        ("window 64", 4, 512, 8, 2, 64, "ring", dict(window=64)),
        ("softcap 50", 4, 192, 8, 2, 128, "full", dict(softcap=50.0)),
        ("G=1", 3, 96, 4, 4, 128, "full", {}),
        ("G=2", 3, 96, 8, 4, 64, "ring", {}),
        ("G=7", 3, 96, 14, 2, 64, "full", {}),
        ("G=7 D=128 window softcap", 2, 300, 14, 2, 128, "ring",
         dict(window=100, softcap=30.0)),
        ("ragged L=157", 5, 157, 14, 2, 64, "ring", {}),
        ("main decode shape", m["B"], m["L"], m["Hq"], m["Hkv"], m["D"],
         "full", {}),
        *k2_split_settings(64, 14, 2),
    ]


def k2_split_settings(D, Hq, Hkv):
    """K2 at explicit split counts: splits with no live tile (a short
    prefix in a long ring, and 5 splits of 2 tiles), a wrapped ring, a
    window, a softcap, a ragged L, and one split (the single-pass
    order)."""
    return [  # (name, B, L, Hq, Hkv, D, kv_pos pattern, kwargs)
        (f"D={D} split 2 dead split", 4, 1024, Hq, Hkv, D, "prefix",
         dict(n_split=2)),
        (f"D={D} split 5 dead splits", 3, 300, Hq, Hkv, D, "prefix",
         dict(n_split=5)),
        (f"D={D} split 3 wrapped ring", 4, 160, Hq, Hkv, D, "ring",
         dict(n_split=3)),
        (f"D={D} split 5 window 64", 4, 512, Hq, Hkv, D, "ring",
         dict(window=64, n_split=5)),
        (f"D={D} split 2 softcap 50", 4, 192, Hq, Hkv, D, "full",
         dict(softcap=50.0, n_split=2)),
        (f"D={D} split 3 ragged L=157", 5, 157, Hq, Hkv, D, "ring",
         dict(n_split=3)),
        (f"D={D} split 1", 4, 144, Hq, Hkv, D, "holes", dict(n_split=1)),
    ]


def k2_settings_256():
    """Phase 16's K2 settings at D = 256, phase 6's kinds, and the
    hybrid's decode read (B=32, 144 slots, 16 query heads over one kv
    head, the local window of 2048)."""
    h = HYBRID_MAIN
    return [  # (name, B, L, Hq, Hkv, D, kv_pos pattern, kwargs)
        ("D=256 full cache", 4, 128, 16, 1, 256, "full", {}),
        ("D=256 short prefix, long ring", 4, 1024, 16, 1, 256, "prefix",
         {}),
        ("D=256 wrapped ring", 4, 160, 8, 2, 256, "ring", {}),
        ("D=256 empty slots", 4, 256, 16, 1, 256, "holes", {}),
        ("D=256 window 64", 4, 512, 16, 1, 256, "ring", dict(window=64)),
        ("D=256 softcap 50", 4, 192, 16, 1, 256, "full",
         dict(softcap=50.0)),
        ("D=256 G=1", 3, 96, 4, 4, 256, "full", {}),
        ("D=256 window softcap", 2, 300, 16, 1, 256, "ring",
         dict(window=100, softcap=30.0)),
        ("D=256 ragged L=157", 5, 157, 16, 1, 256, "ring", {}),
        ("hybrid decode shape", h["B"], h["L"], h["Hq"], h["Hkv"], h["D"],
         "full", dict(window=HYBRID_WINDOW)),
        *k2_split_settings(256, 16, 1),
    ]


def phase_decode_parity(da, settings, main="main decode shape"):
    """K2 against its plain version in each of ``settings``; returns the
    error of the setting named ``main`` (bf16 q, fp32 cache) and the
    number of settings checked."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    combos = ((torch.float32, torch.float32, FP32_TOL),
              (torch.bfloat16, torch.bfloat16, BF16_TOL),
              (torch.bfloat16, torch.float32, BF16_TOL))
    main_err, checked = None, 0
    for q_dt, kv_dt, tol in combos:
        for name, B, L, Hq, Hkv, D, pattern, kw in settings:
            q = randn(gen, B, 1, Hq, D, dtype=q_dt)
            k = randn(gen, B, L, Hkv, D, dtype=kv_dt)
            v = randn(gen, B, L, Hkv, D, dtype=kv_dt)
            q_pos, kv_pos = kv_positions(rng, pattern, B, L)
            qp = torch.from_numpy(q_pos).cuda()
            kvp = torch.from_numpy(kv_pos).cuda()
            out, visits = da.decode_attention(q, k, v, qp, kvp,
                                              return_visits=True, **kw)
            torch.cuda.synchronize()
            # the plain version at the kernel's split count
            n_split = kw.get("n_split") or da.decode_splits(B, Hkv, L)[0]
            ref, ref_visits = da.decode_attention_plain(
                q.float(), k.to(q_dt).float(), v.to(q_dt).float(), qp, kvp,
                **{**kw, "n_split": n_split})
            err = (out.float() - ref).abs().max().item()
            close = torch.allclose(out.float(), ref, atol=tol,
                                   rtol=0.0 if q_dt == torch.float32
                                   else tol)
            want = da.live_tile_counts(q_pos, kv_pos,
                                       window=kw.get("window"),
                                       n_kv_heads=Hkv)
            vis_ok = bool((visits.cpu().numpy() == want).all()) and \
                bool((visits == ref_visits).all())
            label = f"q {str(q_dt)[6:]} cache {str(kv_dt)[6:]}"
            print(f"K2 {name:28s} {label:26s} splits {n_split:<3d} "
                  f"max_abs_err {err:.3e} "
                  f"(tol {tol}) visits {'ok' if vis_ok else 'WRONG'} "
                  f"({int(want.sum())} of {B * Hkv * -(-L // da.BLOCK_K)} "
                  f"tiles)", flush=True)
            if not (close and vis_ok):
                raise AssertionError(f"K2 disagrees with its plain version: "
                                     f"{name} {label}")
            checked += 1
            if name == main and q_dt == torch.bfloat16 \
                    and kv_dt == torch.float32:
                main_err = err
    return main_err, checked


def qwen2_params(cfg, seed):
    """Random Qwen2 weights from ``seed``, with the QKV biases drawn too
    (the JAX init leaves them at zero) so the bias path is exercised."""
    from repro_torch.models import init_params
    params = init_params(cfg, seed, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    attn = params["blocks"]["blk0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * torch.randn(attn[name].shape, device="cuda",
                                        generator=gen)).to(attn[name].dtype)
    return params


def prompt_batch(rng, n, lo, hi, bucket, vocab):
    prompts = [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
               for _ in range(n)]
    toks = np.zeros((n, bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return prompts, toks, np.array([len(p) for p in prompts], np.int32)


def first_logits(cfg, params, toks, lens, caches, plain, plain_matmul=False):
    """Prefill (filling ``caches``) and the fp32 logits (B, V) at each
    row's last real position, as the engine takes them. ``plain`` takes
    plain attention and the plain scan."""
    from repro_torch.models import forward
    from repro_torch.models.layers import head_weight, lm_head_apply
    hid = forward(cfg, params, tokens=toks, caches=caches, mode="full",
                  return_hidden=True, plain_attention=plain,
                  plain_matmul=plain_matmul)
    last = hid[torch.arange(toks.shape[0], device="cuda"), lens - 1]
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    return lm_head_apply(cfg, None, last[:, None], w=w)[:, 0], w


def phase_decoder_gates(cfg, params, model, *, kv_quant=None, label=""):
    """Kernel path (K1 prefill, K2 decode, K3 for int8 weights, K5 for the
    recurrent blocks' prefill) and plain path (plain attention, matmuls
    and scan) in bf16 against the fp32 model (plain, TF32 off), teacher
    forced on the fp32 model's greedy tokens; then, for the float model,
    free-running greedy streams of the two bf16 paths. ``kv_quant`` gives
    every path int8 caches. Returns the readings."""
    from repro_torch.models import decode_segment, forward, make_caches
    rng = np.random.default_rng(7)
    B, bucket = DECODE_MAIN["B"], 128
    _, toks_np, lens_np = prompt_batch(rng, B, 8, 120, bucket,
                                       cfg.vocab_size)
    toks = torch.from_numpy(toks_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_fp32(params)
    paths = {"kernels bf16": (cfg, params, False),
             "plain bf16": (cfg, params, True),
             "fp32": (cfg32, params32, True)}
    state = {}
    with torch.inference_mode():
        for path, (c, p, plain) in paths.items():
            caches = make_caches(c, B, bucket + NEW_TOKENS,
                                 dtype=torch.float32, kv_quant=kv_quant,
                                 device="cuda")
            logits, w = first_logits(c, p, toks, lens, caches, plain, plain)
            state[path] = [caches, w, [logits]]
        for t in range(NEW_TOKENS - 1):
            tok = state["fp32"][2][-1].argmax(-1)[:, None]
            pos = (lens + t)[:, None]
            for path, (c, p, plain) in paths.items():
                caches, w, out = state[path]
                out.append(forward(c, p, tokens=tok, positions=pos,
                                   caches=caches, mode="decode",
                                   plain_attention=plain, plain_matmul=plain,
                                   head_w=w)[:, 0])
        torch.cuda.synchronize()
        ref = torch.stack(state["fp32"][2])               # (T, B, V)
        V = cfg.vocab_size
        readings = {}
        for path in ("kernels bf16", "plain bf16"):
            got = torch.stack(state[path][2])
            if not (torch.isfinite(got[..., :V]).all()
                    and tuple(got.shape) == (NEW_TOKENS, B,
                                             cfg.padded_vocab)):
                raise AssertionError(f"{path} logits: non-finite or "
                                     f"misshapen")
            diff = (got[..., :V] - ref[..., :V]).abs()
            flips = int((got.argmax(-1) != ref.argmax(-1)).sum())
            readings[path] = (diff.max().item(), diff.mean().item(), flips)
            print(f"{model}{label} {path:12s} vs fp32 over prefill + "
                  f"{NEW_TOKENS - 1} teacher-forced steps x {B} rows: "
                  f"logits max_abs_err {readings[path][0]:.4e}, mean "
                  f"{readings[path][1]:.4e}, top-1 flips {flips} of "
                  f"{NEW_TOKENS * B}", flush=True)
        del state, ref
        (k_max, k_mean, k_flips) = readings["kernels bf16"]
        (p_max, p_mean, p_flips) = readings["plain bf16"]
        if (k_max > LOGIT_ERR_FACTOR * p_max
                or k_mean > LOGIT_ERR_FACTOR * p_mean
                or k_flips > max(TOP1_FLIP_FACTOR * p_flips,
                                 0.01 * NEW_TOKENS * B)):
            raise AssertionError(
                f"the kernel path strays further from fp32 than plain "
                f"attention: max {k_max:.3e} vs {p_max:.3e}, mean "
                f"{k_mean:.3e} vs {p_mean:.3e} (factor {LOGIT_ERR_FACTOR}),"
                f" flips {k_flips} vs {p_flips}")
        if kv_quant is not None:
            return readings, None
        # free-running greedy streams of the two bf16 paths
        streams = {}
        for label, plain in (("kernels bf16", False), ("plain bf16", True)):
            caches = make_caches(cfg, B, bucket + NEW_TOKENS,
                                 dtype=torch.float32, device="cuda")
            logits, w = first_logits(cfg, params, toks, lens, caches, plain)
            first = logits.argmax(-1).to(torch.int32)[:, None]
            rest, _, _, _ = no_host_sync(lambda: decode_segment(
                cfg, params, first, lens[:, None], caches,
                n_steps=NEW_TOKENS - 1, plain_attention=plain, head_w=w))
            streams[label] = torch.cat([first, rest], 1).cpu().numpy()
    same = streams["kernels bf16"] == streams["plain bf16"]
    part = np.where(same.all(1), NEW_TOKENS, np.argmin(same, axis=1))
    print(f"free-running greedy, kernels vs plain (bf16): {int(same.all(1).sum())} "
          f"of {B} rows identical over {NEW_TOKENS} tokens; first "
          f"differing step: min {int(part.min())}, median "
          f"{float(np.median(part)):.1f} (not gated)", flush=True)
    return readings, part


def no_host_sync(fn):
    """Run ``fn`` with PyTorch's CUDA sync debug mode at "error": any
    operation that makes the host wait for the device raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def direct_generate(cfg, params, toks, lens, temp, topk, seed, kv_quant=None):
    """The engine's decoder computation written out: fp32 (or, with
    ``kv_quant``, int8) caches of bucket + NEW_TOKENS slots, prefill, the
    first token at each row's last real position, decode_segment for the
    rest, which must not wait for the device. Returns (B, T) numpy."""
    from repro_torch.models import decode_segment, make_caches, sample_logits
    B, bucket = toks.shape
    with torch.inference_mode():
        caches = make_caches(cfg, B, bucket + NEW_TOKENS,
                             dtype=torch.float32, kv_quant=kv_quant,
                             device="cuda")
        logits, w = first_logits(cfg, params, toks, lens, caches, False)
        first = sample_logits(logits, temperature=temp, top_k=topk,
                              seed=seed, positions=lens)[:, None]
        rest, _, _, _ = no_host_sync(lambda: decode_segment(
            cfg, params, first, lens[:, None], caches,
            n_steps=NEW_TOKENS - 1, temperature=temp, top_k=topk, seed=seed,
            head_w=w))
        return torch.cat([first, rest], 1).cpu().numpy()


def replay_diff(gc, key, fn, args, direct):
    """Capture ``fn`` under ``key`` in ``gc`` (its warm-up run must equal
    ``direct``, the same function called uncaptured), replay it in sync
    debug mode "error" and return the replay's largest difference from
    ``direct``."""
    first = gc.run(key, fn, *args)        # warm-up run + capture
    if max_diff(first, direct) != 0:
        raise AssertionError(f"{key}: the warm-up run differs from the "
                             f"direct call")
    return max_diff(no_host_sync(lambda: gc.run(key, fn, *args)), direct)


def served_logits_diff(cfg, params, toks, lens, kv_quant):
    """The decoder engine's batch-at-a-time program up to its logits, on
    one served batch: prefill into fresh caches of bucket + NEW_TOKENS
    slots, the first-token logits, and the logits of one greedy decode
    step, as a captured program against the same calls uncaptured.
    Returns the largest logit difference."""
    from repro_torch.models import forward, make_caches
    from repro_torch.serving.graphs import GraphCache
    B, bucket = toks.shape
    tt = torch.from_numpy(toks).cuda()
    lt = torch.from_numpy(lens).cuda()

    def fn(t, ln):
        caches = make_caches(cfg, B, bucket + NEW_TOKENS,
                             dtype=torch.float32, kv_quant=kv_quant,
                             device="cuda")
        lg0, w = first_logits(cfg, params, t, ln, caches, False)
        tok = lg0.argmax(-1).to(torch.int32)[:, None]
        lg1 = forward(cfg, params, tokens=tok, positions=ln[:, None],
                      caches=caches, mode="decode", head_w=w)[:, 0]
        return {"first": lg0, "step": lg1}
    with torch.inference_mode():
        return replay_diff(GraphCache("cuda"), ("logits", bucket), fn,
                           (tt, lt), fn(tt, lt))


def reset_launches(kernels):
    """Zero every launch counter of ``kernels``, K2's count of its S > 1
    launches (``verify_launches``) too."""
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "verify_launches"):
            fn.verify_launches = 0


def phase_decoder_engine(cfg, params, kernels, *, quant=None,
                         spans=((8, 32, 32), (33, 64, 64), (65, 120, 128)),
                         wave=16, label=""):
    """One wave of ``wave`` requests per (shortest, longest prompt,
    bucket) in ``spans`` (default: 48 requests in buckets 32/64/128): per
    wave half greedy, a quarter sampled (temperature 0.8, top_k 50,
    distinct seeds), a quarter greedy with an eos id their stream
    reaches. ``quant="int8"`` serves with int8 weights and an int8 KV
    cache; the direct calls then run on the engine's quantized tree.
    ``kernels`` are K1, K2, K3, K4 and K5's wrappers; per batch K1 must
    launch once per attention layer, K2 once per attention layer and
    decode step, K3 six times per layer and step under int8 weights, K4
    never, and K5 once per recurrent layer. Returns (launches of
    K1..K5, the engine's window, tokens, wall seconds of the burst,
    batch sizes, weight bytes)."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    ec = EngineConfig(mode="decoder", continuous=False, use_cache_pool=False,
                      max_batch=wave, batch_window_ms=200.0,
                      pad_buckets=tuple(b for _, _, b in spans),
                      max_new_tokens=NEW_TOKENS, weight_quant=quant,
                      kv_quant=quant)
    eng = ServingEngine(cfg, params, ec, device="cuda")
    try:
        rng = np.random.default_rng(11)
        waves = []
        logit_diff = 0.0
        for w, (lo, hi, bucket) in enumerate(spans):
            prompts, toks, lens = prompt_batch(rng, wave, lo, hi, bucket,
                                               cfg.vocab_size)
            temp = np.zeros(wave, np.float32)
            topk = np.zeros(wave, np.int32)
            seed = np.zeros(wave, np.int32)
            kinds = ["greedy", "greedy", "sampled", "eos"] * (wave // 4)
            for i, kind in enumerate(kinds):
                if kind == "sampled":
                    temp[i], topk[i], seed[i] = 0.8, 50, 100 * w + i
            gen = direct_generate(
                cfg, eng.params, torch.from_numpy(toks).cuda(),
                torch.from_numpy(lens).cuda(), torch.from_numpy(temp).cuda(),
                torch.from_numpy(topk).cuda(), torch.from_numpy(seed).cuda(),
                kv_quant=quant)
            sampling, want = [], []
            for i, kind in enumerate(kinds):
                row = gen[i]
                if kind == "eos":
                    eos = int(row[8])
                    n = int(np.where(row == eos)[0][0]) + 1
                    sampling.append(SamplingParams(eos_id=eos))
                    want.append((row[:n], "eos"))
                else:
                    sampling.append(SamplingParams(
                        temperature=float(temp[i]),
                        top_k=int(topk[i]) or None, seed=int(seed[i])))
                    want.append((row, "length"))
            waves.append((prompts, sampling, want))
            logit_diff = max(logit_diff, served_logits_diff(
                cfg, eng.params, toks, lens, quant))
        eng.warmup(batch_sizes=[wave], buckets=ec.pad_buckets)

        def burst():
            out = []
            for prompts, sampling, _ in waves:   # one burst per bucket
                handles = [eng.generate(p, s)
                           for p, s in zip(prompts, sampling)]
                out.append([h.result(timeout=600) for h in handles])
            return out
        # warmup captures greedy batches only: a first burst captures the
        # sampled ones (its results come from each capture's warm-up run),
        # the measured burst replays every batch
        primed = burst()
        eng.discard_samples()
        reset_launches(kernels)
        replays0 = eng._graphs.replays
        t0 = time.perf_counter()
        results = burst()
        wall = time.perf_counter() - t0
        launches = tuple(fn.launches for fn in kernels)
        served = eng.window()
        batch_sizes = list(eng.batch_sizes)   # the worker is idle now
        weight_bytes = eng.metrics()["weight_bytes"]
        captures = eng._graphs.captures
        replays = eng._graphs.replays - replays0
    finally:
        eng.close()
    n_batches = len(batch_sizes)
    tag = label + (f" ({quant} weights and KV)" if quant else "")
    print(f"decoder engine{tag}: {sum(map(len, results))} requests in "
          f"{n_batches} batches {batch_sizes}; K1 launches {launches[0]}, "
          f"K2 launches {launches[1]}, K3/K4 launches {launches[2:4]}, K5 "
          f"launches {launches[4]}; {captures} programs captured, "
          f"{replays} replays", flush=True)
    if replays != n_batches:
        raise AssertionError(f"{replays} replays for {n_batches} batches")
    if batch_sizes != [wave] * len(spans):
        raise AssertionError(f"waves were not served as one batch each: "
                             f"{batch_sizes}")
    n_attn = sum(k != "rglru" for k in cfg.layer_pattern)
    n_rec = cfg.n_layers - n_attn
    want = (n_attn * n_batches, n_attn * (NEW_TOKENS - 1) * n_batches,
            6 * cfg.n_layers * NEW_TOKENS * n_batches if quant else 0, 0,
            n_rec * n_batches)
    if launches != want:
        raise AssertionError(f"launches K1/K2/K3/K4/K5 {launches} != "
                             f"{want}")
    n_tok = 0
    for (_, _, want), got, first in zip(waves, results, primed):
        for (w_tokens, w_reason), r, r0 in zip(want, got, first):
            if not np.array_equal(r0.tokens, w_tokens):
                raise AssertionError(f"capturing burst {r0.tokens} != "
                                     f"direct {w_tokens}")
            if not (np.array_equal(r.tokens, w_tokens)
                    and r.finish_reason == w_reason):
                raise AssertionError(
                    f"engine result {r.tokens} ({r.finish_reason}) != "
                    f"direct {w_tokens} ({w_reason})")
            n_tok += len(r.tokens)
    n_req = wave * len(spans)
    print(f"decoder engine{tag} tokens and finish reasons (captured "
          f"programs) equal direct uncaptured prefill + decode_segment "
          f"calls on the same batches: {n_req} of {n_req} ({n_tok} tokens); "
          f"decode_segment ran in sync debug mode 'error' (no host sync); "
          f"first-token and decode-step logits of each wave's batch, "
          f"captured vs uncaptured: max difference {logit_diff}",
          flush=True)
    if logit_diff != 0:
        raise AssertionError(f"captured logits differ from uncaptured ones "
                             f"by {logit_diff}")
    return launches, served, n_tok, wall, batch_sizes, weight_bytes


def phase_decode_timings(da, name, m=DECODE_MAIN,
                         shapes=tuple((B, L) for B in (1, 8, 32)
                                      for L in (144, 528))):
    """K2 at each (B, L) of ``shapes`` (default: B in {1, 8, 32} x L in
    {144, 528}) with ``m``'s heads (default Qwen2's, 14 / 2 of 64), bf16
    q over an fp32 cache, every slot live; beside it its bound, plain
    version and SDPA. K2's own time is ``graph_ms``'s, at every shape
    and in every run (the profiler's, printed beside it, has lost one of
    its two launches in long runs). Returns the row of ``m``'s (B, L)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Hq, Hkv, D = m["Hq"], m["Hkv"], m["D"]
    main = None
    for B, L in shapes:
        q = randn(gen, B, 1, Hq, D, dtype=torch.bfloat16)
        k = randn(gen, B, L, Hkv, D, dtype=torch.float32)
        v = randn(gen, B, L, Hkv, D, dtype=torch.float32)
        q_pos = np.full(B, L - 1, np.int32)
        kv_pos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
        qp = torch.from_numpy(q_pos).cuda()
        kvp = torch.from_numpy(kv_pos).cuda()

        def k2():
            return da.decode_attention(q, k, v, qp, kvp)
        t_k = device_ms(k2, launches=2)
        t_ev = cuda_ms(k2)
        t_g = graph_ms(k2)
        t_p = device_ms(lambda: da.decode_attention_plain(
            q, k, v, qp, kvp), iters=5)
        qt = q.transpose(1, 2)                           # (B, Hq, 1, D)
        kt = k.to(torch.bfloat16).transpose(1, 2)        # cast beforehand
        vt = v.to(torch.bfloat16).transpose(1, 2)
        mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
        t_s = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                     enable_gqa=True))
        bound, by = decode_bound_ms(q_pos, kv_pos, Hq, Hkv, D, 2, 4)
        n_split = da.decode_splits(B, Hkv, L)[0]
        print(f"timing K2 B={B} L={L} Hq={Hq} Hkv={Hkv} D={D} bf16 q "
              f"fp32 cache, grid {B * Hkv} x {n_split} splits and a merge, "
              f"kernel over a captured graph of 20 calls {t_g:.4f} ms, "
              f"by the profiler (both launches) {fmt_ms(t_k)}, by events "
              f"over back-to-back calls {t_ev:.4f} ms; device time: plain "
              f"{fmt_ms(t_p)}, sdpa {fmt_ms(t_s)}; bound {bound:.5f} ms "
              f"({by}) [{name}]", flush=True)
        if (B, L) == (m["B"], m["L"]):
            main = (t_g, t_p, t_s, bound, by)
    return main


def phase_decode_step(cfg, params, name, *, kv_quant=None,
                      modes=(False, True), label="", model="Qwen2-0.5B",
                      top=10):
    """One decode step of ``model`` at B=32 bucket 128 (after a prefill):
    the forward in decode mode plus token selection, greedy and sampled
    (temperature 0.8, top_k 50; ``modes`` says which). Wall time by the
    host clock around synchronized steps, device time and kernels by the
    profiler. ``params`` may be quantized; ``kv_quant`` gives int8
    caches. Returns {mode: (wall ms, device ms)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward, make_caches, sample_logits
    rng = np.random.default_rng(13)
    B, bucket = DECODE_MAIN["B"], 128
    _, toks, lens = prompt_batch(rng, B, 8, 120, bucket, cfg.vocab_size)
    lens_t = torch.from_numpy(lens).cuda()
    temp = torch.full((B,), 0.8, device="cuda")
    topk = torch.full((B,), 50, dtype=torch.int32, device="cuda")
    seed = torch.arange(B, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        caches = make_caches(cfg, B, bucket + NEW_TOKENS,
                             dtype=torch.float32, kv_quant=kv_quant,
                             device="cuda")
        logits, w = first_logits(cfg, params, torch.from_numpy(toks).cuda(),
                                 lens_t, caches, False)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = lens_t[:, None]

        def step(sampled):
            lg = forward(cfg, params, tokens=tok, positions=pos,
                         caches=caches, mode="decode", head_w=w)[:, 0]
            if sampled:
                return sample_logits(lg, temperature=temp, top_k=topk,
                                     seed=seed, positions=pos[:, 0] + 1)
            return sample_logits(lg)

        out = {}
        for sampled in modes:
            mode = "sampled" if sampled else "greedy"
            for _ in range(3):
                step(sampled)
            torch.cuda.synchronize()
            n = 10
            t0 = time.perf_counter()
            for _ in range(n):
                step(sampled)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step(sampled)
                torch.cuda.synchronize()
            rows = kernel_rows(prof, 5)
            busy = sum(r[0] for r in rows) if rows else None
            out[mode] = (wall, busy)
            print(f"decode step {model}{label} B={B} "
                  f"L={bucket + NEW_TOKENS} bf16, {mode}: wall {wall:.3f} "
                  f"ms (host clock, "
                  f"synchronized), device {fmt_ms(busy)}"
                  + ("" if busy is None else
                     f", device idle {max(0.0, 1 - busy / wall):.1%}")
                  + f" [{name}]", flush=True)
            for ms, calls, key in sorted(rows, reverse=True)[:top]:
                print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{calls:<4d} "
                      f"{key[:90]}")
    return out



# ------------------------------------------------------------ hybrid
def scan_inputs(gen, B, S, W):
    """a in (0.79, 0.99) and b of scale 0.1 (as tests/test_kernels.py
    draws them), fp32 on the card; channel W // 3 of every row made the
    identity step (a = 1, b = 0), whose h must stay exactly 0."""
    a = torch.sigmoid(torch.randn(B, S, W, device="cuda", generator=gen))
    a = a * 0.2 + 0.79
    b = torch.randn(B, S, W, device="cuda", generator=gen) * 0.1
    a[:, :, W // 3] = 1.0
    b[:, :, W // 3] = 0.0
    return a, b


def scan_bound_ms(B, S, W):
    """Least time for one scan: a and b read once and h written once
    (fp32) over HBM; its 2 flops an element are far below that."""
    t_bytes = 3 * B * S * W * 4 / HBM_BYTES_PER_S
    t_ops = 2 * B * S * W / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_scan_parity(rs):
    """K5 against its plain version at the hybrid's shapes (one short and
    one longer prompt, the B=32 bucket-128 batch) and at a long S and a
    ragged W, in fp32: within SCAN_TOL of the output's largest magnitude
    (the kernel's fused multiply-add rounds once where the plain
    version's product and sum round twice); the identity channel exactly
    0. Returns (the error at SCAN_MAIN, settings checked)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    main_err, checked = None, 0
    for B, S, W in ((1, 1, 4096), (1, 37, 4096), SCAN_MAIN, (4, 300, 256),
                    (3, 100, 130)):
        a, b = scan_inputs(gen, B, S, W)
        out = rs.rglru_scan(a, b)
        torch.cuda.synchronize()
        ref = rs.rglru_scan_plain(a, b)
        err = (out - ref).abs().max().item()
        mag = ref.abs().max().item()
        zero = bool((out[:, :, W // 3] == 0).all())
        print(f"K5 B={B:<3d} S={S:<4d} W={W:<5d} max_abs_err {err:.3e} of "
              f"max {mag:.3e} (tol {SCAN_TOL} relative), identity channel "
              f"{'exact' if zero else 'WRONG'}", flush=True)
        if not (err <= SCAN_TOL * mag and zero and out.dtype == torch.float32
                and out.shape == a.shape):
            raise AssertionError(f"K5 disagrees with its plain version: "
                                 f"B={B} S={S} W={W}")
        if (B, S, W) == SCAN_MAIN:
            main_err = err
        checked += 1
    return main_err, checked


def one_period(cfg, params):
    """The first period of a stacked model: its config cut to one period
    and a tree of views of period 0 (no copy)."""
    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:1]
    tree = {k: v for k, v in params.items() if k != "blocks"}
    tree["blocks"] = first(params["blocks"])
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern)), tree


def phase_scan_timings(rs, name):
    """K5 by device time at SCAN_MAIN and at one short prompt, beside its
    bound and plain version; no single PyTorch call computes a linear
    recurrence, so it has no library time. Returns the main row (ms,
    plain ms, bound ms, bound by)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    main = None
    for B, S, W in ((1, 128, 4096), SCAN_MAIN):
        a, b = scan_inputs(gen, B, S, W)

        def k5():
            return rs.rglru_scan(a, b)
        t_k = device_ms(k5)
        t_ev = cuda_ms(k5)
        t_p = device_ms(lambda: rs.rglru_scan_plain(a, b), iters=5)
        bound, by = scan_bound_ms(B, S, W)
        print(f"timing K5 B={B} S={S} W={W} fp32, {B * W} threads, device "
              f"time: kernel {fmt_ms(t_k)}, plain {fmt_ms(t_p)}, library "
              f"none, bound {bound:.5f} ms ({by}); kernel by events over "
              f"back-to-back calls {t_ev:.4f} ms [{name}]", flush=True)
        if (B, S, W) == SCAN_MAIN:
            main = (t_k if t_k is not None else t_ev, t_p, bound, by)
    return main


def phase_qwen2_k1_timing(fa, attn_block_sizes, name):
    """K1 at Qwen2-0.5B's prefill (B=32, S=128, 14 query heads over 2 kv
    heads of 64, bf16, causal) by device time, beside its bound, plain
    version and SDPA (causal, GQA). Returns (ms, plain ms, sdpa ms, bound
    ms, bound by)."""
    m = DECODE_MAIN
    B, S = m["B"], 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(34)
    q = randn(gen, B, S, m["Hq"], m["D"], dtype=torch.bfloat16)
    k, v = (randn(gen, B, S, m["Hkv"], m["D"], dtype=torch.bfloat16)
            for _ in range(2))
    bq = attn_block_sizes("prefill", S, bh=B * m["Hq"], head_dim=m["D"],
                          dtype=torch.bfloat16)[0]

    def k1():
        return fa.flash_attention(q, k, v, bq=bq, causal=True)
    t_k = device_ms(k1)
    t_ev = cuda_ms(k1)
    t_p = device_ms(lambda: fa.flash_attention_plain(q, k, v, bq=bq,
                                                     causal=True), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    t_s = device_ms(sdpa)
    bound, by = attn_bound_ms(B, S, S, m["Hq"], m["Hkv"], m["D"], 2,
                              causal=True)
    print(f"timing K1 Qwen2 prefill B={B} S={S} Hq={m['Hq']} "
          f"Hkv={m['Hkv']} D={m['D']} bf16 causal bq={bq}, device time: "
          f"kernel {fmt_ms(t_k)}, plain {fmt_ms(t_p)}, sdpa {fmt_ms(t_s)}, "
          f"bound {bound:.4f} ms ({by}); by events over back-to-back calls "
          f"kernel {t_ev:.4f} ms, sdpa {cuda_ms(sdpa):.4f} ms [{name}]",
          flush=True)
    return (t_k if t_k is not None else t_ev, t_p, t_s, bound, by)


def phase_hybrid_k1_timing(fa, attn_block_sizes, name):
    """K1 at the hybrid's prefill (B=32, S=128, 16 query heads over one kv
    head of 256, bf16, causal, window 2048) by device time, beside its
    bound, plain version and SDPA (causal, GQA). Returns (ms, plain ms,
    sdpa ms, bound ms, bound by)."""
    h = HYBRID_MAIN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    q = randn(gen, h["B"], h["S"], h["Hq"], h["D"], dtype=torch.bfloat16)
    k, v = (randn(gen, h["B"], h["S"], h["Hkv"], h["D"],
                  dtype=torch.bfloat16) for _ in range(2))
    bq = attn_block_sizes("prefill", h["S"], bh=h["B"] * h["Hq"],
                          head_dim=h["D"], dtype=torch.bfloat16)[0]
    kw = dict(causal=True, window=HYBRID_WINDOW)

    def k1():
        return fa.flash_attention(q, k, v, bq=bq, **kw)
    t_k = device_ms(k1)
    t_ev = cuda_ms(k1)
    t_p = device_ms(lambda: fa.flash_attention_plain(q, k, v, bq=bq, **kw),
                    iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_s = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bound, by = attn_bound_ms(h["B"], h["S"], h["S"], h["Hq"], h["Hkv"],
                              h["D"], 2, causal=True)
    print(f"timing K1 hybrid prefill B={h['B']} S={h['S']} Hq={h['Hq']} "
          f"Hkv={h['Hkv']} D={h['D']} bf16 causal bq={bq}, device time: "
          f"kernel {fmt_ms(t_k)}, plain {fmt_ms(t_p)}, sdpa {fmt_ms(t_s)}, "
          f"bound {bound:.4f} ms ({by}); kernel by events over back-to-back "
          f"calls {t_ev:.4f} ms [{name}]", flush=True)
    return (t_k if t_k is not None else t_ev, t_p, t_s, bound, by)


# --------------------------------------------------------- int8 serving
def proj_shapes(cfg):
    """(K, N) -> projection names of one layer's int8 matmuls, in
    ``qeinsum``'s (M, K) x (K, N) view (a fused ``wqkv`` is one)."""
    d, hd = cfg.d_model, cfg.head_dim_
    q, kv, f = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff
    mlp = [("w_in", d, 2 * f)] if cfg.gated_mlp else [("w_up", d, f)]
    qkv = ([("wqkv", d, q + 2 * kv)] if cfg.fused_qkv else
           [("wq", d, q), ("wk", d, kv), ("wv", d, kv)])
    # an MoE block's experts stay float: only the attention's are int8
    ffn = [] if cfg.moe is not None else [*mlp, ("w_down", f, d)]
    shapes = {}
    for name, K, N in [*qkv, ("wo", q, d), *ffn]:
        shapes.setdefault((K, N), []).append(name)
    return {kn: "/".join(names) for kn, names in shapes.items()}


def mm_bound_ms(M, K, N, x_item, w_item, scaled):
    """Least time for one (M, K) x (K, N) product: x, the weight (and
    the fp32 scales) read once and the output written once in x's type,
    over HBM; or 2MKN operations at the bf16 tensor-core peak (the
    products are bf16 x bf16 for an int8 weight too)."""
    nbytes = M * K * x_item + K * N * w_item + (4 * N if scaled else 0) + \
        M * N * x_item
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int8_inputs(gen, M, K, N, dtype):
    """x (M, K) in ``dtype``; qw (K, N) int8 and fp32 scales that give
    outputs of order one; column N // 3 of qw all zero."""
    x = randn(gen, M, K, dtype=dtype)
    qw = torch.randint(-127, 128, (K, N), device="cuda", generator=gen,
                       dtype=torch.int8)
    qw[:, N // 3] = 0
    scale = (torch.rand(N, device="cuda", generator=gen) + 0.5) / \
        (127.0 * K ** 0.5)
    return x, qw, scale


def phase_matmul_parity(i8, cfgs):
    """K3 and K4 against their plain versions at every (K, N) of the
    main paths (the int8 projections of ``cfgs``: GECToR-base's,
    Qwen2-0.5B's, stablelm-12b's, and qwen2-moe-a2.7b's fused ``wqkv``
    and ``wo``) for M = 1,
    2, 8, 16, 32, 64 and 4096, and at GECToR-base's for M = 96 (a partial
    64-row tile), 512 and 1024 (the ladder's batches of 3, 16 and 32 at
    bucket 32: the 64 x 64 and 128 x 192 tiles), at ragged shapes and at a K that is not a
    multiple of the split slab, in fp32 (TF32 off, within 1e-4 of the
    output's largest magnitude: another order of the fp32 sum) and bf16
    (within 2e-2 of it: one bf16 rounding of the output); the all-zero
    weight column must give exact zeros. Then, at Qwen2's decode shapes
    in bf16, rows of M = 1, 2, 4, 8 and 16 must be the same bits as the
    same rows in M = 32 (the split plan does not depend on M), and two
    launches at a decode and a large shape the same bits. Returns (K3's
    and K4's bf16 error at MM_MAIN, settings checked, {shape: K3's bf16
    error} at qwen2-moe-a2.7b's shapes)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    kn = {}
    for c in cfgs:
        for (K, N), names in proj_shapes(c).items():
            kn[(K, N)] = f"{c.name} {names}"
    shapes = [(M, K, N, label) for (K, N), label in kn.items()
              for M in (1, 2, 8, 16, 32, 64, 4096) + (
                  LADDER_WIDTHS if label.startswith("gector") else ())]
    shapes += [(33, 72, 40, "ragged"), (5, 300, 17, "ragged"),
               (130, 896, 129, "ragged"),
               (32, 1000, 256, "K % split slab != 0")]
    errs, checked = {}, 0
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for M, K, N, label in shapes:
            x, qw, scale = int8_inputs(gen, M, K, N, dtype)
            plan = i8.matmul_plan(M, N, K)
            taken = i8.launch_plan(x, qw, plan)
            w = (qw.float() * scale).to(dtype)
            out3 = i8.int8_matmul(x, qw, scale, plan=plan)
            out4 = i8.cache_matmul(x, w, plan=plan)
            torch.cuda.synchronize()
            for kname, out, ref in (
                    ("K3", out3, i8.int8_matmul_plain(x.float(), qw, scale)),
                    ("K4", out4, i8.cache_matmul_plain(x.float(), w))):
                err = (out.float() - ref).abs().max().item()
                mag = ref.abs().max().item()
                zeros = kname == "K4" or bool((out[:, N // 3] == 0).all())
                ok = err <= tol * mag and zeros and out.dtype == dtype
                print(f"{kname} M={M:<4d} K={K:<4d} N={N:<5d} {label:28s} "
                      f"{taken.path} {taken.tile} x{taken.splits} "
                      f"{str(dtype)[6:]:8s} max_abs_err "
                      f"{err:.3e} of max {mag:.3e} (tol {tol} relative)"
                      + ("" if kname == "K4" else
                         f", zero column {'exact' if zeros else 'WRONG'}"),
                      flush=True)
                if not ok:
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version: M={M} K={K} N={N} "
                                         f"{dtype}")
                errs[(kname, M, K, N, dtype)] = err
                checked += 1
    # a row's bits do not depend on the batch width; launches repeat
    qwen = [kn_ for kn_, label in kn.items() if label.startswith("qwen2")]
    for K, N in qwen:
        x, qw, scale = int8_inputs(gen, 32, K, N, torch.bfloat16)
        w = (qw.float() * scale).bfloat16()
        full3, full4 = i8.int8_matmul(x, qw, scale), i8.cache_matmul(x, w)
        for m in (1, 2, 4, 8, 16):
            if not (torch.equal(i8.int8_matmul(x[:m], qw, scale), full3[:m])
                    and torch.equal(i8.cache_matmul(x[:m], w), full4[:m])):
                raise AssertionError(f"K3/K4 rows of M={m} differ from the "
                                     f"same rows in M=32 at K={K} N={N}")
        print(f"K3/K4 K={K} N={N}: rows of M = 1, 2, 4, 8, 16 bit-equal to "
              f"M = 32", flush=True)
    for M, K, N in ((32, 4864, 896), MM_MAIN):
        x, qw, scale = int8_inputs(gen, M, K, N, torch.bfloat16)
        w = (qw.float() * scale).bfloat16()
        if not (torch.equal(i8.int8_matmul(x, qw, scale),
                            i8.int8_matmul(x, qw, scale))
                and torch.equal(i8.cache_matmul(x, w),
                                i8.cache_matmul(x, w))):
            raise AssertionError(f"K3/K4 not deterministic at M={M} K={K} "
                                 f"N={N}")
        print(f"K3/K4 M={M} K={K} N={N}: two launches bit-equal", flush=True)
    return (errs[("K3", *MM_MAIN, torch.bfloat16)],
            errs[("K4", *MM_MAIN, torch.bfloat16)], checked,
            {f"M={M} K={K} N={N} {label}": errs[("K3", M, K, N,
                                                 torch.bfloat16)]
             for M, K, N, label in shapes if label.startswith("qwen2-moe")})


def int8_hidden_gate(cfg, qtree, tokens, label):
    """An int8 encoder tree's hidden states through K3 in bf16 against the
    plain-int8 forward (both with K1), both against the same tree in fp32
    with plain matmuls; K3's error may be at most HIDDEN_ERR_FACTOR times
    the plain path's. Returns (K3, plain, fp32) hidden states."""
    from repro_torch.models import forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        hid = forward(cfg, qtree, tokens=tokens, causal=False,
                      return_hidden=True)
        hid_plain = forward(cfg, qtree, tokens=tokens, causal=False,
                            return_hidden=True, plain_matmul=True)
        hid32 = forward(cfg32, to_fp32(qtree), tokens=tokens, causal=False,
                        return_hidden=True, plain_matmul=True)
    torch.cuda.synchronize()
    if not (torch.isfinite(hid.float()).all()
            and hid.shape == hid_plain.shape == (*tokens.shape, cfg.d_model)):
        raise AssertionError(f"{label}: int8 forward non-finite or "
                             f"misshapen")
    k_err = (hid.float() - hid32).abs().max().item()
    p_err = (hid_plain.float() - hid32).abs().max().item()
    print(f"{label}: hidden max_abs_err vs the int8 tree in fp32 (plain "
          f"matmuls): K3 bf16 {k_err:.3e}, plain bf16 {p_err:.3e} (K3 at "
          f"most {HIDDEN_ERR_FACTOR} x plain)", flush=True)
    if k_err > HIDDEN_ERR_FACTOR * p_err:
        raise AssertionError(f"{label}: K3 bf16 strays further from fp32 "
                             f"than the plain int8 path: {k_err:.3e} > "
                             f"{HIDDEN_ERR_FACTOR} x {p_err:.3e}")
    return hid, hid_plain, hid32


def phase_gector_int8(cfg, params, tt, mt, tags_float):
    """GECToR-base with int8 weights in bf16: the K3 forward against the
    plain-int8 forward (both with K1), both against the same quantized
    model in fp32 with plain matmuls; the K3 path may be no worse than
    the plain path by phase 3's factors. How often the int8 tags agree
    with the float model's is reported, not gated (random weights)."""
    from repro_torch.core.gector import tag_head
    from repro_torch.quant import quantize_params
    qp = quantize_params(params)
    qp32 = to_fp32(qp)
    hid, hid_plain, hid32 = int8_hidden_gate(cfg, qp["encoder"], tt,
                                             "GECToR-base int8 weights")
    with torch.inference_mode():
        tags = {"K3 bf16": tag_head(qp, hid, mt),
                "plain bf16": tag_head(qp, hid_plain, mt)}
        tags32 = tag_head(qp32, hid32, mt)
    agree32 = {label: (t == tags32)[mt].float().mean().item()
               for label, t in tags.items()}
    print(f"GECToR-base int8 weights: tag agreement with the int8 model in "
          f"fp32: K3 bf16 {agree32['K3 bf16']:.4f}, plain bf16 "
          f"{agree32['plain bf16']:.4f}", flush=True)
    k_flip, p_flip = 1 - agree32["K3 bf16"], 1 - agree32["plain bf16"]
    if k_flip > TAG_FLIP_FACTOR * p_flip:
        raise AssertionError(
            f"K3 bf16 strays further from fp32 than the plain int8 path: "
            f"tag flips {k_flip:.4f} > {TAG_FLIP_FACTOR} x {p_flip:.4f}")
    agree = (tags["K3 bf16"] == tags_float)[mt].float().mean().item()
    print(f"int8 (K3) tags agree with the float bf16 model's on "
          f"{agree:.4f} of {int(mt.sum())} real tokens (random weights; "
          f"not gated)", flush=True)
    return qp


def phase_encoder_int8_engine(cfg, params, kernels, rng):
    """32 sentences of 65-120 tokens through ``ServingEngine(mode=
    "encoder", weight_quant="int8")`` with the tag head: K1 once and K3
    six times per layer and batch, and the tags equal direct
    ``predict_tags`` calls on the engine's quantized tree. Returns
    (launches of K1/K2/K3/K4, batch sizes, weight bytes)."""
    from repro_torch.core.gector import predict_tags, tag_head
    from repro_torch.models import forward
    from repro_torch.quant import params_bytes
    from repro_torch.serving import EngineConfig, ServingEngine
    sents = sentences(rng, 32, 65, 120, cfg.vocab_size)
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="encoder", weight_quant="int8", batch_window_ms=200.0,
        pad_buckets=(128,)), head_fn=tag_head, device="cuda")
    try:
        eng.warmup(batch_sizes=[32])
        eng.discard_samples()
        reset_launches(kernels)
        results = [f.result(timeout=300) for f in
                   [eng.submit(s) for s in sents]]
        launches = tuple(fn.launches for fn in kernels)
        batch_sizes = list(eng.batch_sizes)   # the worker is idle now
        weight_bytes = eng.metrics()["weight_bytes"]
        qparams = eng.params
        toks, mask = padded(sents, 128)
        want = predict_tags(cfg, qparams, toks, mask)
        with torch.inference_mode():        # the same batch, uncaptured
            tt = torch.from_numpy(toks).cuda()
            hid = forward(cfg, qparams["encoder"], tokens=tt, causal=False,
                          return_hidden=True)
            direct = tag_head(qparams, hid,
                              torch.from_numpy(mask).cuda()).cpu()
        replays = eng._graphs.replays
    finally:
        eng.close()
    if batch_sizes != [32] or replays != 1:
        raise AssertionError(f"not one captured batch: {batch_sizes}, "
                             f"{replays} replays")
    diff = int((torch.stack(results) != direct).sum())
    print(f"int8 engine tags (a captured program) vs a direct uncaptured "
          f"forward + tag_head of the batch: {diff} tags differ",
          flush=True)
    if diff:
        raise AssertionError(f"{diff} served int8 tags differ from the "
                             f"direct call")
    n = len(batch_sizes)
    print(f"encoder engine (int8 weights): {len(results)} requests in {n} "
          f"batches {batch_sizes}; K1 launches {launches[0]}, K3 launches "
          f"{launches[2]}", flush=True)
    if launches[:3] != (cfg.n_layers * n, 0, 6 * cfg.n_layers * n):
        raise AssertionError(f"launches K1/K2/K3 {launches[:3]} for {n} "
                             f"batches of {cfg.n_layers} layers")
    match = sum(int((r.numpy()[:len(s)] == want[i, :len(s)]).sum())
                for i, (s, r) in enumerate(zip(sents, results)))
    total = sum(map(len, sents))
    print(f"int8 engine tags vs direct predict_tags on the engine's tree: "
          f"{match}/{total} = {match / total:.4f}", flush=True)
    if match / total < TAG_AGREEMENT:
        raise AssertionError("int8 engine results disagree with predict_tags")
    if weight_bytes != params_bytes(qparams):
        raise AssertionError(f"weight_bytes {weight_bytes} != "
                             f"{params_bytes(qparams)}")
    return launches, batch_sizes, weight_bytes


def phase_matmul_timings(i8, shapes, name, int8pack=True):
    """K3 and K4 by device time at the main paths' shapes, bf16 x, beside
    the bound, the plain version and one PyTorch call as the yardstick:
    ``torch.matmul`` of x with the weight dequantized beforehand to bf16
    (the float path's GEMM; the port never calls it) and, where this
    PyTorch has it on CUDA and ``int8pack`` asks for it,
    ``torch._weight_int8pack_mm`` (its scales are bf16; over a second a
    call at stablelm-12b's M=4096 ``w_in``). Each kernel's time is printed
    as a factor of ``torch.matmul`` beside its target (not gated).
    Returns {(M, K, N): (K3 row, K4 row)}, a row (ms, plain ms, bound ms,
    bound by, library ms); a kernel's and a plain version's ms is its
    event time where the profiler saw no kernel, the library call's its
    ``graph_ms``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    rows = {}
    for M, K, N, label in shapes:
        x, qw, scale = int8_inputs(gen, M, K, N, torch.bfloat16)
        plan = i8.matmul_plan(M, N, K)
        w = (qw.float() * scale).to(torch.bfloat16)

        def k3():
            return i8.int8_matmul(x, qw, scale, plan=plan)

        def k4():
            return i8.cache_matmul(x, w, plan=plan)
        t3, t4 = device_ms(k3), device_ms(k4)
        t3p = device_ms(lambda: i8.int8_matmul_plain(x, qw, scale), iters=5)
        t4p = device_ms(lambda: i8.cache_matmul_plain(x, w), iters=5)
        t_lib = device_ms(lambda: torch.matmul(x, w))
        pack = "not in this PyTorch" if int8pack else "not timed"
        if int8pack and hasattr(torch, "_weight_int8pack_mm"):
            qt, sb = qw.t().contiguous(), scale.to(torch.bfloat16)
            try:   # a yardstick only: the port never calls it
                torch._weight_int8pack_mm(x, qt, sb)
                pack = fmt_ms(device_ms(
                    lambda: torch._weight_int8pack_mm(x, qt, sb)))
            except (RuntimeError, NotImplementedError) as e:
                pack = f"not on CUDA ({str(e)[:60]!r})"
        b3, by3 = mm_bound_ms(M, K, N, 2, 1, True)
        b4, by4 = mm_bound_ms(M, K, N, 2, 2, False)
        # where the profiler saw no kernel, the event time stands in
        # (``graph_ms`` for the library call: no host time to add)
        t3 = t3 if t3 is not None else cuda_ms(k3)
        t4 = t4 if t4 is not None else cuda_ms(k4)
        t3p = t3p if t3p is not None else cuda_ms(
            lambda: i8.int8_matmul_plain(x, qw, scale), iters=5)
        t4p = t4p if t4p is not None else cuda_ms(
            lambda: i8.cache_matmul_plain(x, w), iters=5)
        t_lib = t_lib if t_lib is not None else graph_ms(
            lambda: torch.matmul(x, w))
        target3 = MM_TARGET_DECODE if M <= 64 else MM_TARGET_LARGE
        target4 = "none" if M <= 64 else MM_TARGET_LARGE

        def factor(t):
            return "not measured" if not t_lib else f"{t / t_lib:.2f}x"
        print(f"timing M={M:<4d} K={K:<4d} N={N:<5d} {label:26s} "
              f"{plan.path} {plan.tile} x{plan.splits}, device time: K3 "
              f"{fmt_ms(t3)} = {factor(t3)} torch.matmul (target "
              f"{target3}x; bound {b3:.5f} ms {by3}, plain {fmt_ms(t3p)}), "
              f"K4 {fmt_ms(t4)} = {factor(t4)} (target {target4}; bound "
              f"{b4:.5f} ms {by4}, plain {fmt_ms(t4p)}), torch.matmul bf16 "
              f"{fmt_ms(t_lib)}, _weight_int8pack_mm {pack} [{name}]",
              flush=True)
        rows[(M, K, N)] = ((t3, t3p, b3, by3, t_lib),
                           (t4, t4p, b4, by4, t_lib))
    return rows


LADDER_REPEATS = 3                 # bursts per rung of the paper's ladder
LADDER_BATCH = 32                  # the encoder engine's max_batch there
LADDER_BUCKET = 32                 # sentences of 8-24 tokens
LADDER_WIDTHS = (96, 512, 1024)    # K3's M at 3, 16 and 32 of them


def proc_stat_advances() -> bool:
    """Whether this host's /proc/stat jiffies move: where they do not (a
    sandboxed host), the load test's vCPU% has no sample and reads 0.0."""
    from repro_torch.deploy.telemetry import read_proc_stat
    before = read_proc_stat()
    time.sleep(0.2)
    after = read_proc_stat()
    return before is not None and after is not None and after[0] > before[0]


def rung_lines(cells, label, name, cpu_seen):
    """One line per rung of a ladder: mean and p95 latency of the NS-burst,
    sentences/s, host vCPU% (``cpu_seen``: the host's jiffies move) and
    RAM%. ``cells`` maps NS to a list of cell dicts (one per profile of the
    grid, or one); with several, each figure is their median and the
    latency carries its range."""
    for ns, group in cells.items():
        def med(key):
            return float(np.median([c[key] for c in group]))
        lat = [c["latency_s"] for c in group]
        spread = (f" (profiles {min(lat) * 1e3:.3f}-{max(lat) * 1e3:.3f})"
                  if len(group) > 1 else "")
        cpu = f"{med('vcpu_pct'):.1f}%" if cpu_seen else "not measured"
        print(f"ladder {label} NS={ns}: latency mean "
              f"{med('latency_s') * 1e3:.3f} ms{spread}, p95 "
              f"{med('latency_p95_s') * 1e3:.3f} ms, "
              f"{med('sentences_per_s'):.1f} sentences/s, host vCPU {cpu}, "
              f"RAM {med('ram_pct'):.1f}% [{name}]", flush=True)


def phase_paper_ladder(kernels, name):
    """20. The paper's concurrency ladder on the card, through the port's
    deploy lab: ``repro_torch.launch.experiment.main`` over the 21 paper
    profiles with full-width GECToR-base (bf16, no head) at NS = 1..512,
    checked record by record, K1's launches against the batches served;
    then ``run_ladder`` on the int8 encoder engine over the same ladder and
    sentences (K1 and K3 against its batches), and the serve CLI's
    ``--ladder``. Launch counts are reset before each engine's warmup, so
    its batches count. After the int8 ladder, K3 is held against its plain
    version at every width M = batch x bucket that the ladder served, at
    GECToR-base's three (K, N), and the int8 tree's forward at the full
    batch (B=32, bucket 32) against the plain-int8 and fp32 forwards by
    phase 11's gate. Device memory is read as deltas over what earlier
    phases still hold: resident after the engine's build, and the peak
    while it serves the ladder (stats reset after its warmup). Last, one
    forward of each engine's tree at the ladder's full batch (B=32,
    bucket 32) by wall time and kernels, the part of a served batch that
    is the model's. Returns each path's launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.loadtest import run_ladder
    from repro_torch.deploy.profiles import NS_LADDER, paper_profiles
    from repro_torch.deploy.report import PAPER_FINDINGS
    from repro_torch.deploy.runner import (RECORD_FIELDS, SCHEMA_VERSION,
                                           read_jsonl)
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.launch import experiment, serve
    from repro_torch.models import forward, init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = get_config("gector-base")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "ladder"
    cpu_seen = proc_stat_advances()
    t0 = time.perf_counter()

    # ---- the float grid through the experiment CLI; the factory is
    # wrapped to keep the engine it builds and to read device memory
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    built = []
    make_factory = experiment.make_engine_factory

    def keep_engine(args):
        factory = make_factory(args)

        def wrapped(scenario):
            eng, sents, sampling = factory(scenario)   # built and warm
            torch.cuda.synchronize()
            built.append((eng, sents, torch.cuda.memory_allocated() - base))
            torch.cuda.reset_peak_memory_stats()
            return eng, sents, sampling
        return wrapped

    reset_launches(kernels)
    experiment.make_engine_factory = keep_engine
    try:
        experiment.main([
            "--ladder", *map(str, NS_LADDER),
            "--repeats", str(LADDER_REPEATS),
            "--max-batch", str(LADDER_BATCH), "--bucket", str(LADDER_BUCKET),
            "--out-dir", str(out_dir)])
    finally:
        experiment.make_engine_factory = make_factory
    launches = tuple(fn.launches for fn in kernels)
    peak = torch.cuda.max_memory_allocated() - base
    t_grid = time.perf_counter() - t0
    (eng, sents, resident), = built
    batches = list(eng.batch_sizes)      # warmup's and the grid's
    rows = read_jsonl(str(out_dir / experiment.GRID_FILE))
    with open(out_dir / experiment.DRIFT_FILE) as f:
        drift = json.load(f)
    keys = [f"{r['profile']['provider']}/{r['profile']['machine']}"
            for r in rows]
    if keys != [p.key for p in paper_profiles()]:
        raise AssertionError(f"grid records {keys}: not one per paper "
                             f"profile")
    for r in rows:
        if set(r) != set(RECORD_FIELDS) or len(r) != len(RECORD_FIELDS) \
                or r["schema_version"] != SCHEMA_VERSION \
                or SCHEMA_VERSION != 2:
            raise AssertionError(f"record fields {sorted(r)}, schema "
                                 f"{r['schema_version']}")
        if [c["ns"] for c in r["cells"]] != list(NS_LADDER) or not all(
                np.isfinite(c[k]) and c[k] > 0 for c in r["cells"]
                for k in ("latency_s", "sentences_per_s")):
            raise AssertionError(f"cells of {r['profile']['provider']}/"
                                 f"{r['profile']['machine']}: {r['cells']}")
    if set(drift["findings"]) != set(PAPER_FINDINGS):
        raise AssertionError(f"drift report findings {sorted(drift)}")
    if eng.device.type != "cuda":
        raise AssertionError(f"the grid's engine ran on {eng.device}")
    warm = LADDER_BATCH * (LADDER_BATCH + 1) // 2
    if sum(batches) != warm + len(rows) * LADDER_REPEATS * sum(NS_LADDER):
        raise AssertionError(f"{sum(batches)} requests served")
    print(f"float grid: {len(rows)} profiles x NS {list(NS_LADDER)} x "
          f"{LADDER_REPEATS} repeats, {sum(batches)} requests (warmup "
          f"{warm}) in {len(batches)} batches, K1 launches {launches[0]}; "
          f"{t_grid:.1f} s [{name}]", flush=True)
    if launches != (cfg.n_layers * len(batches), 0, 0, 0, 0):
        raise AssertionError(f"launches K1-K5 {launches} for "
                             f"{len(batches)} batches of {cfg.n_layers} "
                             f"layers")
    by_ns = {ns: [r["cells"][i] for r in rows]
             for i, ns in enumerate(NS_LADDER)}
    rung_lines(by_ns, "float", name, cpu_seen)
    top = [c["sentences_per_s"] for c in by_ns[NS_LADDER[-1]]]
    weight_bytes = rows[0]["engine"]["weight_bytes"]
    print(f"float saturation (NS={NS_LADDER[-1]}): median "
          f"{np.median(top):.1f} sentences/s over the profiles "
          f"({min(top):.1f}-{max(top):.1f}); device memory: resident "
          f"{resident:,} B after the build, peak {peak:,} B while serving, "
          f"weight_bytes {weight_bytes:,} [{name}]", flush=True)

    # ---- the int8 ladder on the same sentences
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device="cuda")
    eng8 = ServingEngine(cfg, params, EngineConfig(
        mode="encoder", max_batch=LADDER_BATCH, pad_buckets=(LADDER_BUCKET,),
        weight_quant="int8"), device="cuda")
    del params                           # the engine holds the int8 tree
    try:
        torch.cuda.synchronize()
        resident8 = torch.cuda.memory_allocated() - base
        reset_launches(kernels)
        eng8.warmup()
        torch.cuda.reset_peak_memory_stats()
        cells8 = run_ladder(eng8, sents, ladder=NS_LADDER,
                            repeats=LADDER_REPEATS, warmup=False)
        launches8 = tuple(fn.launches for fn in kernels)
        peak8 = torch.cuda.max_memory_allocated() - base
        batches8 = list(eng8.batch_sizes)
        weight_bytes8 = eng8.metrics()["weight_bytes"]
        # the engine against the model: one sentence alone against a
        # direct forward of the same padded row on the engine's tree (both
        # through K3; the kernel itself is held below)
        one = sents[0]
        got = eng8.submit(one).result(timeout=300)
        toks = torch.zeros((1, LADDER_BUCKET), dtype=torch.long,
                           device="cuda")
        toks[0, :len(one)] = torch.from_numpy(one)
        with torch.inference_mode():
            want = forward(cfg, eng8.params, tokens=toks, causal=False,
                           return_hidden=True)[0].float().cpu()
    finally:
        eng8.close()
    t_int8 = time.perf_counter() - t1
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"int8 ladder: {sum(batches8)} requests in {len(batches8)} "
          f"batches, K1 launches {launches8[0]}, K3 launches "
          f"{launches8[2]}; one served row vs a direct forward: max_abs_err "
          f"{err:.3e} of {scale:.3e}; {t_int8:.1f} s [{name}]", flush=True)
    n8 = len(batches8)
    if launches8 != (cfg.n_layers * n8, 0, 6 * cfg.n_layers * n8, 0, 0):
        raise AssertionError(f"launches K1-K5 {launches8} for {n8} int8 "
                             f"batches of {cfg.n_layers} layers")
    if tuple(got.shape) != (LADDER_BUCKET, cfg.d_model) or \
            not torch.isfinite(got.float()).all() or err > BF16_TOL * scale:
        raise AssertionError(f"int8 engine row: shape {tuple(got.shape)}, "
                             f"error {err:.3e} of {scale:.3e}")
    if [c.ns for c in cells8] != list(NS_LADDER) or not all(
            np.isfinite(c.latency_s) and c.latency_s > 0 for c in cells8):
        raise AssertionError(f"int8 ladder cells {cells8}")
    rung_lines({c.ns: [dict(dataclasses.asdict(c), sentences_per_s=c.ns
                            / c.latency_s)] for c in cells8}, "int8", name,
               cpu_seen)
    print(f"int8 saturation (NS={NS_LADDER[-1]}): "
          f"{NS_LADDER[-1] / cells8[-1].latency_s:.1f} sentences/s; device "
          f"memory: resident {resident8:,} B after the build, peak "
          f"{peak8:,} B while serving, weight_bytes {weight_bytes8:,} "
          f"[{name}]", flush=True)

    # ---- K3 at every width the int8 ladder served, and the full batch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    widths = sorted({ServingEngine._prefill_rows(b, LADDER_BUCKET)
                     * LADDER_BUCKET for b in batches8})
    worst = 0.0
    for M in widths:
        for K, N in proj_shapes(cfg):
            x, qw, qscale = int8_inputs(gen, M, K, N, torch.bfloat16)
            out = i8.int8_matmul(x, qw, qscale)
            ref = i8.int8_matmul_plain(x.float(), qw, qscale)
            e = (out.float() - ref).abs().max().item()
            mag = ref.abs().max().item()
            if out.dtype != torch.bfloat16 or not e <= BF16_TOL * mag:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at the ladder's M={M} K={K} N={N}: "
                                     f"{e:.3e} of {mag:.3e}")
            worst = max(worst, e / mag)
    print(f"K3 vs plain at the {len(widths)} widths the int8 ladder served "
          f"(M = {widths[0]}..{widths[-1]}) x GECToR-base's "
          f"{len(proj_shapes(cfg))} (K, N), bf16: worst max_abs_err "
          f"{worst:.3e} of the output's max (tol {BF16_TOL} relative)",
          flush=True)
    full = torch.zeros((LADDER_BATCH, LADDER_BUCKET), dtype=torch.long,
                       device="cuda")
    for i, s in enumerate(sents[:LADDER_BATCH]):
        full[i, :len(s)] = torch.from_numpy(s)
    int8_hidden_gate(cfg, eng8.params, full,
                     f"GECToR-base int8 B={LADDER_BATCH} bucket "
                     f"{LADDER_BUCKET} (the ladder's full batch)")

    # ---- one forward at the ladder's full batch, float and int8
    for label, tree in (("float", eng.params), ("int8 K3", eng8.params)):
        forward_profile(lambda: forward(cfg, tree, tokens=full, causal=False,
                                        return_hidden=True),
                        f"GECToR-base forward B={LADDER_BATCH} bucket "
                        f"{LADDER_BUCKET} bf16, {label} (the ladder's full "
                        f"batch)", name, top=4)

    # ---- the serve CLI's ladder, once on the card
    t2 = time.perf_counter()
    serve.main(["--ladder", "1", "16"])
    print(f"phase 20: grid {t_grid:.1f} s, int8 ladder {t_int8:.1f} s, "
          f"serve --ladder {time.perf_counter() - t2:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, launches8


def forward_profile(fn, label, name, n=5, top=8):
    """Wall time of ``fn`` (CUDA events around back-to-back calls), its
    kernel time and device idle share by the profiler, and its ``top``
    costliest kernels. Returns (wall ms, kernel ms)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        wall = cuda_ms(fn, iters=10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    rows = kernel_rows(prof, n)
    busy = sum(r[0] for r in rows) if rows else None
    print(f"{label}: wall {wall:.4f} ms (events), kernels {fmt_ms(busy)}"
          + ("" if busy is None else
             f", device idle {max(0.0, 1 - busy / wall):.1%}")
          + f" [{name}]", flush=True)
    for ms, calls, key in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{calls:<4d} {key[:90]}")
    return wall, busy


# ------------------------------------------------ captured programs
CONT_BATCH = 16                    # max_batch of the continuous phase
CONT_SPANS = ((8, 32, 32), (33, 64, 64), (65, 120, 128))
CONT_GAP_S = 0.002                 # arrival gap of the staggered load
LONG_BATCH = 32                    # max_batch of the long-bucket check
LONG_SPAN = (257, 500, 512)        # its prompt lengths and bucket
LONG_GAP_S = 0.005                 # and its arrival gap


def sync_wall_ms(fn, n=10, warmup=2):
    """Host-clock ms of ``fn`` run and synchronized, mean over ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def program_reading(fn, n=3, n_wall=10):
    """(wall ms by the host clock, mean of ``n_wall`` calls; kernel ms by
    the profiler over ``n`` calls, or None; device idle share or None) of
    one synchronized call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    wall = sync_wall_ms(fn, n=n_wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    rows = kernel_rows(prof, n)
    busy = sum(r[0] for r in rows) if rows else None
    idle = None if busy is None else max(0.0, 1 - busy / wall)
    return wall, busy, idle


def fmt_reading(r):
    wall, busy, idle = r
    return (f"wall {wall:.4f} ms, kernels {fmt_ms(busy)}, device idle "
            + ("not measured" if idle is None else f"{idle:.1%}"))


def max_diff(a, b):
    """Largest |a - b| over float tensors (or trees of them), as a float;
    integer tensors count their unequal elements instead."""
    if isinstance(a, dict):
        return max(max_diff(a[k], b[k]) for k in a)
    if a.is_floating_point():
        return (a.float() - b.float()).abs().max().item()
    return float((a != b).sum().item())


def captured_against_direct(gc, key, fn, args, direct, label, name):
    """Capture ``fn`` under ``key`` in ``gc``, replay it in sync debug
    mode "error", and hold the replay against ``direct`` (the same
    function called uncaptured) bit for bit; print and return both
    readings (captured, uncaptured)."""
    diff = replay_diff(gc, key, fn, args, direct)
    print(f"{label}: captured replay vs direct uncaptured call: max "
          f"difference {diff} (replayed in sync debug mode 'error')",
          flush=True)
    if diff != 0:
        raise AssertionError(f"{label}: captured program differs from the "
                             f"uncaptured call by {diff}")
    cap = program_reading(lambda: gc.run(key, fn, *args))
    unc = program_reading(lambda: fn(*args))
    print(f"  captured:   {fmt_reading(cap)} [{name}]", flush=True)
    print(f"  uncaptured: {fmt_reading(unc)} [{name}]", flush=True)
    return cap, unc


def phase_captured_programs(cfg, params, qcfg, qparams, name):
    """21. One captured program against its uncaptured call, bit for bit,
    and both timed: a GECToR-base forward with the tag head at B=32 in
    buckets 32 and 128 (the engine's encoder program) and a Qwen2-0.5B
    decode step at B=32, L=144 (forward in decode mode and token
    selection), greedy and sampled. Returns {label: (captured,
    uncaptured)} readings."""
    from repro_torch.core.gector import tag_head
    from repro_torch.models import forward, make_caches, sample_logits
    from repro_torch.serving.graphs import GraphCache
    gc = GraphCache("cuda")
    out = {}
    rng = np.random.default_rng(21)
    with torch.inference_mode():
        for bucket in (32, 128):
            toks, mask = padded(sentences(rng, 32, 8, bucket,
                                          cfg.vocab_size), bucket)
            tt = torch.from_numpy(toks).cuda()
            mt = torch.from_numpy(mask).cuda()

            def enc(t, m):
                hid = forward(cfg, params["encoder"], tokens=t,
                              causal=False, return_hidden=True)
                return {"hidden": hid, "tags": tag_head(params, hid, m)}
            label = f"GECToR-base encoder program B=32 bucket {bucket} bf16"
            out[label] = captured_against_direct(
                gc, ("enc", bucket), enc, (tt, mt), enc(tt, mt), label, name)
        B, bucket = DECODE_MAIN["B"], 128
        _, toks, lens = prompt_batch(rng, B, 8, 120, bucket, qcfg.vocab_size)
        lens_t = torch.from_numpy(lens).cuda()
        caches = make_caches(qcfg, B, bucket + NEW_TOKENS,
                             dtype=torch.float32, device="cuda")
        logits, w = first_logits(qcfg, qparams,
                                 torch.from_numpy(toks).cuda(), lens_t,
                                 caches, False)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = lens_t[:, None]
        temp = torch.full((B,), 0.8, device="cuda")
        topk = torch.full((B,), 50, dtype=torch.int32, device="cuda")
        seed = torch.arange(B, dtype=torch.int32, device="cuda")

        def step(t, p, tm, tk, sd):
            # the step rewrites its own KV slot with the same values, so
            # repeated calls see the same cache
            lg = forward(qcfg, qparams, tokens=t, positions=p,
                         caches=caches, mode="decode", head_w=w)[:, 0]
            return {"logits": lg,
                    "tok": sample_logits(lg, temperature=tm, top_k=tk,
                                         seed=sd, positions=p[:, 0] + 1)}
        for mode, sargs in (("greedy", (None, None, None)),
                            ("sampled", (temp, topk, seed))):
            label = (f"Qwen2-0.5B decode step program B={B} "
                     f"L={bucket + NEW_TOKENS} bf16, {mode}")
            args = (tok, pos, *sargs)
            out[label] = captured_against_direct(
                gc, ("step", mode), step, args, step(*args), label, name)
        del caches
    print(f"phase 21: {gc.captures} programs captured, {gc.replays} "
          f"replays", flush=True)
    return out


# (bucket, widest batch) of phase 22's prefill check: the continuous
# phase's buckets at its max_batch, and the long buckets at the long
# continuous check's
WIDTH_BUCKETS = ((32, CONT_BATCH), (64, CONT_BATCH), (128, CONT_BATCH),
                 (256, LONG_BATCH), (512, LONG_BATCH))
STEP_BUCKETS = (32, 128, 256, 512)   # decode-step check: L = bucket + 16


def slice_caches(caches, w):
    """A copy of the first ``w`` rows of a ``make_caches`` tree."""
    return {b: {k: t[:, :w].clone() for k, t in blk.items()}
            for b, blk in caches.items()}


def phase_width_determinism(cfg, params, label, kv_quant=None):
    """22. One Qwen2-0.5B row's bits against the batch it runs in (bf16
    weights, or int8 weights and KV).

    Prefill: for each (bucket, cap) of ``WIDTH_BUCKETS`` and every join
    size n = 1..cap, the join's n prompts padded as the engine pads them
    (copies of row 0 up to ``PREFILL_MIN_M`` rows of M): row 0's prefill
    hidden state and first-token logits against the same row at n = cap.
    Every such n must give the same bits. The unpadded joins below
    ``PREFILL_MIN_M`` rows are printed beside (the fault the padding
    avoids).

    Decode: in each bucket of ``STEP_BUCKETS``, the caches of one
    width-32 prefill cut to widths 1..cap (cap 16 and 32) and one
    teacher-forced decode step: row 0's logits against the same row at
    the cap, once at K2's own split count for the width
    (``decode_splits(width, ...)``) and once at the cap's
    (``decode_width=cap``, as the engine runs). The second must give the
    same bits at every width. Returns (prefill diffs {(bucket, n):
    (hidden, logits)}, decode diffs {(bucket, cap, width): (own, cap's)})."""
    from repro_torch.kernels.decode_attention import decode_splits
    from repro_torch.models import forward, make_caches
    from repro_torch.models.layers import head_weight, lm_head_apply
    from repro_torch.serving.engine import PREFILL_MIN_M, ServingEngine
    rng = np.random.default_rng(22)
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    hkv = cfg.n_kv_heads
    pre, dec = {}, {}

    def prefill_row0(tt, lt, idx, L):
        t = tt[idx]
        caches = make_caches(cfg, len(idx), L, dtype=torch.float32,
                             kv_quant=kv_quant, device="cuda")
        hid = forward(cfg, params, tokens=t, caches=caches, mode="full",
                      return_hidden=True)
        last = hid[0, lt[0] - 1]
        return last.float(), lm_head_apply(cfg, None, last[None, None],
                                           w=w)[0, 0]

    t0 = time.perf_counter()
    with torch.inference_mode():
        for bucket, cap in WIDTH_BUCKETS:
            _, toks, lens = prompt_batch(rng, cap, 8, bucket - 8, bucket,
                                         cfg.vocab_size)
            tt = torch.from_numpy(toks).cuda()
            lt = torch.from_numpy(lens).cuda()
            L = bucket + NEW_TOKENS
            ref = prefill_row0(tt, lt, list(range(cap)), L)
            small = []
            for n in range(1, cap + 1):
                rows = ServingEngine._prefill_rows(n, bucket)
                got = prefill_row0(tt, lt, list(range(n)) + [0] * (rows - n),
                                   L)
                pre[(bucket, n)] = tuple((a - b).abs().max().item()
                                         for a, b in zip(got, ref))
                if n * bucket < PREFILL_MIN_M:
                    got = prefill_row0(tt, lt, list(range(n)), L)
                    small.append(
                        f"n={n} (M={n * bucket}) hidden "
                        + ", logits ".join(f"{(a - b).abs().max().item():.3e}"
                                           for a, b in zip(got, ref)))
            worst = [max(pre[(bucket, n)][k] for n in range(1, cap + 1))
                     for k in (0, 1)]
            ms = sorted({ServingEngine._prefill_rows(n, bucket) * bucket
                         for n in range(1, cap + 1)})
            print(f"width determinism {label}: bucket {bucket}, row 0 of "
                  f"joins n = 1..{cap} padded as the engine pads them (M = "
                  f"{ms[0]}..{ms[-1]}, {len(ms)} values) vs n = {cap}: max "
                  f"prefill hidden diff {worst[0]:.3e}, first-token logits "
                  f"{worst[1]:.3e}"
                  + (f"; unpadded {'; '.join(small)}" if small else ""),
                  flush=True)
        for bucket in STEP_BUCKETS:
            _, toks, lens = prompt_batch(rng, 32, 8, bucket - 8, bucket,
                                         cfg.vocab_size)
            tt = torch.from_numpy(toks).cuda()
            lt = torch.from_numpy(lens).cuda()
            L = bucket + NEW_TOKENS
            caches = make_caches(cfg, 32, L, dtype=torch.float32,
                                 kv_quant=kv_quant, device="cuda")
            hid = forward(cfg, params, tokens=tt, caches=caches, mode="full",
                          return_hidden=True)
            last = hid[torch.arange(32, device="cuda"), lt - 1][:, None]
            tok = lm_head_apply(cfg, None, last, w=w)[:, 0].argmax(-1)

            def step(width, dw):
                return forward(cfg, params,
                               tokens=tok[:width, None].to(torch.int32),
                               positions=lt[:width, None],
                               caches=slice_caches(caches, width),
                               mode="decode", head_w=w,
                               decode_width=dw)[0, 0]
            for cap in (16, 32):
                ref = step(cap, cap)
                for width in (1, 2, 4, 8, 16):
                    if width >= cap:
                        continue
                    d = ((step(width, None) - ref).abs().max().item(),
                         (step(width, cap) - ref).abs().max().item())
                    dec[(bucket, cap, width)] = d
                    print(f"width determinism {label}: L={L}, decode-step "
                          f"logits of row 0 at width {width} vs {cap}: at "
                          f"K2's own {decode_splits(width, hkv, L)[0]} "
                          f"splits {d[0]:.3e}; at the cap's "
                          f"{decode_splits(cap, hkv, L)[0]} (decode_width="
                          f"{cap}) {d[1]:.3e}", flush=True)
            del caches
    bad_pre = [k for k, d in pre.items() if d != (0.0, 0.0)]
    bad_dec = [k for k, d in dec.items() if d[1] != 0.0]
    own = [k for k, d in dec.items() if d[0] != 0.0]
    print(f"width determinism {label}: {len(pre)} padded joins, "
          f"{len(pre) - len(bad_pre)} bit-equal to the widest; {len(dec)} "
          f"decode widths at the cap's split count, "
          f"{len(dec) - len(bad_dec)} bit-equal; at K2's own split count "
          f"{len(dec) - len(own)} bit-equal"
          + (f" (differ: (bucket, cap, width) {own})" if own else "")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    if bad_pre:
        raise AssertionError(f"{label}: a padded join's row 0 changes with "
                             f"the join size at (bucket, n) {bad_pre}")
    if bad_dec:
        raise AssertionError(f"{label}: a decode row changes with the width "
                             f"at the cap's split count at {bad_dec}")
    return pre, dec


def cont_load(cfg, seed, spans=CONT_SPANS):
    """The continuous phase's 48 requests: 16 per (shortest, longest
    prompt, bucket) of ``spans``, every other one sampled (temperature
    0.8, top_k 50, its own seed), shuffled."""
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(seed)
    load = []
    for lo, hi, _ in spans:
        for i in range(16):
            p = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
            sp = (SamplingParams(temperature=0.8, top_k=50,
                                 seed=len(load)) if i % 2 else
                  SamplingParams())
            load.append((p, sp))
    order = rng.permutation(len(load))
    return [load[i] for i in order]


def serve_load(eng, load, gap_s):
    """Submit ``load`` with ``gap_s`` between arrivals; wait for every
    result. Returns (results, wall seconds)."""
    t0 = time.perf_counter()
    handles = []
    for p, sp in load:
        handles.append(eng.generate(p, sp))
        if gap_s:
            time.sleep(gap_s)
    results = [h.result(timeout=600) for h in handles]
    return results, time.perf_counter() - t0


def untouched_slots(eng, bucket):
    """The pool's untouched-slot property on the card, bitwise: for
    several sets of live slots, one compacted segment (the engine's
    captured program, as a lane runs it) must leave every other slot's
    bytes as they were and change the live ones. Returns the number of
    sets checked."""
    from repro_torch.serving.scheduler import pick_tier
    pool = eng._pools[bucket]
    n = eng.ec.max_batch
    sets = [[0], [1, 3], [2, 5, 7, 9], list(range(0, n, 2)),
            list(range(3, n))]
    for live in sets:
        width = pick_tier(len(live), eng._tiers)
        if width >= n:
            continue
        before = {(b, k): x.clone() for b, blk in pool.caches.items()
                  for k, x in blk.items()}
        rows = (np.full((width, 1), 7, np.int32),
                np.full((width, 1), 5, np.int32),
                np.arange(width) < len(live), np.full(width, 3, np.int32),
                np.full(width, -1, np.int32))
        key = ("cont_compact", bucket, width, False)
        if key not in eng._graphs:
            raise AssertionError(f"{key} was not captured by warmup()")
        eng._segment_call(bucket, width, rows, slots=live)
        torch.cuda.synchronize()
        others = [s for s in range(n) if s not in live]
        changed = False
        for (b, k), x in before.items():
            now = pool.caches[b][k]
            if not torch.equal(now[:, others], x[:, others]):
                raise AssertionError(f"slots {others} changed in {b}/{k} "
                                     f"by a segment over slots {live}")
            changed |= not torch.equal(now[:, live], x[:, live])
        if not changed:
            raise AssertionError(f"a segment over slots {live} wrote "
                                 f"nothing")
    return len(sets)


def phase_continuous(cfg, params, kernels, name, *, quant=None):
    """23. Qwen2-0.5B at full width through the default continuous
    decoder config (lanes over buckets 32/64/128, the KV pool, adaptive
    width tiers; max_batch ``CONT_BATCH``), every program captured by
    ``warmup(sampled=True)``: 48 greedy and sampled requests of mixed
    lengths arriving ``CONT_GAP_S`` apart. The same load through
    ``segment_width="fixed"`` and through the batch-at-a-time engine
    (one wave per bucket); every request's tokens against both; the
    measured window compile-clean; K1/K2/K3 launches against the
    window's prefill batches and segments; the untouched-slot property
    on the pool's bytes; the end tiers' segments captured against
    uncaptured. ``quant="int8"`` serves int8 weights and KV. Every
    request's tokens must be the same in all three engines. Returns the
    window's K1..K5 launches, the served streams (phase 27 holds the
    speculative engine to them) and ``tier_timings``' readings."""
    from repro_torch.serving import EngineConfig, ServingEngine
    tag = " int8 W+KV" if quant else ""
    load = cont_load(cfg, 23)
    base = dict(mode="decoder", max_batch=CONT_BATCH,
                pad_buckets=tuple(b for _, _, b in CONT_SPANS),
                max_new_tokens=NEW_TOKENS, weight_quant=quant,
                kv_quant=quant)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    eng = ServingEngine(cfg, params, EngineConfig(**base), device="cuda")
    try:
        t0 = time.perf_counter()
        eng.warmup(sampled=True)
        t_warm = time.perf_counter() - t0
        compiles = eng.metrics()["jit_compiles"]
        resident = torch.cuda.memory_allocated() - mem0
        eng.window()
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        results, wall = serve_load(eng, load, CONT_GAP_S)
        launches = tuple(fn.launches for fn in kernels)
        win = eng.window()
        peak = torch.cuda.max_memory_allocated() - mem0
        print(f"continuous{tag}: warmup captured {compiles} programs in "
              f"{t_warm:.1f} s; 48 requests in {wall:.3f} s, "
              f"{sum(len(r.tokens) for r in results)} tokens; window: "
              f"jit_compiles {win['jit_compiles']}, prefill batches "
              f"{win['prefill_batches']}, decode segments "
              f"{win['decode_segments']}, joins mid-flight "
              f"{win['joins_mid_flight']}, occupancy mean "
              f"{win['batch_occupancy_mean']:.2f}; K1..K5 launches "
              f"{launches} [{name}]", flush=True)
        for b, lane in win["lanes"].items():
            print(f"  lane {b}: segments {lane['decode_segments']} "
                  f"(compacted {lane['compact_segments']}), joins "
                  f"{lane['joins']}, tier_hist {lane['tier_hist']}, "
                  f"kv_bytes {lane['kv_bytes']:,}", flush=True)
        print(f"continuous{tag}: device memory resident after warmup "
              f"{resident:,} B, peak while serving {peak:,} B, "
              f"weight_bytes {win['weight_bytes']:,} [{name}]", flush=True)
        if win["jit_compiles"] != 0:
            raise AssertionError(f"the measured window built "
                                 f"{win['jit_compiles']} programs")
        n_layers = cfg.n_layers
        steps = eng.ec.decode_segment * win["decode_segments"]
        want = (n_layers * win["prefill_batches"], n_layers * steps,
                6 * n_layers * (win["prefill_batches"] + steps)
                if quant else 0, 0, 0)
        if launches != want:
            raise AssertionError(f"continuous launches K1..K5 {launches} "
                                 f"!= {want}")
        n_sets = untouched_slots(eng, 128)
        print(f"continuous{tag}: untouched-slot property held bitwise on "
              f"the bucket-128 pool for {n_sets} sets of live slots",
              flush=True)
        t0 = time.perf_counter()
        segments = tier_timings(eng, 128, name, tag)
        print(f"continuous{tag}: tier timings took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        eng.close()
    t0 = time.perf_counter()
    streams = {"adaptive": [r.tokens for r in results]}
    for label, kw, gap in (("fixed", dict(segment_width="fixed"),
                            CONT_GAP_S),
                           ("batch at a time", dict(
                               continuous=False, batch_window_ms=200.0), 0)):
        ref = ServingEngine(cfg, params, EngineConfig(**dict(base, **kw)),
                            device="cuda")
        try:
            if label == "fixed":       # programs captured as they come
                got, _ = serve_load(ref, load, gap)
            else:
                got = []
                by_bucket = {}
                for i, (p, sp) in enumerate(load):
                    by_bucket.setdefault(ref._bucket(len(p)), []).append(i)
                res = {}
                for idx in by_bucket.values():   # one wave per bucket
                    hs = [(i, ref.generate(*load[i])) for i in idx]
                    res.update((i, h.result(timeout=600)) for i, h in hs)
                got = [res[i] for i in range(len(load))]
        finally:
            ref.close()
        streams[label] = [r.tokens for r in got]
    compare_streams(streams, f"continuous{tag}")
    print(f"continuous{tag}: reference engines took "
          f"{time.perf_counter() - t0:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, streams["adaptive"], segments


def compare_streams(streams, what):
    """Every request's tokens of the "adaptive" engine against the
    "fixed" and "batch at a time" ones', exactly."""
    for label in ("fixed", "batch at a time"):
        same = [np.array_equal(a, b) for a, b in
                zip(streams["adaptive"], streams[label])]
        first = [int(np.argmin(np.asarray(a) == np.asarray(b)))
                 for a, b, s in zip(streams["adaptive"], streams[label],
                                    same) if not s]
        print(f"{what} adaptive vs {label}: {sum(same)} of {len(same)} "
              f"requests token-identical"
              + (f"; first differing token at {sorted(first)}"
                 if first else ""), flush=True)
        if first:
            raise AssertionError(f"{what}: {len(first)} requests differ "
                                 f"from the {label} engine")


def phase_continuous_long(cfg, params, name, *, quant=None):
    """23, long bucket. ``LONG_BATCH`` greedy and sampled requests of
    ``LONG_SPAN`` tokens, each with its own budget of 1-16 new tokens,
    arriving ``LONG_GAP_S`` apart in one bucket of 512 (caches of 528
    slots, where K2's own split count would be 17, 9 or 5 by width),
    through the default continuous decoder at max_batch ``LONG_BATCH``.
    The adaptive and fixed engines serve the load twice (the first pass
    captures the programs as they come, the second replays them, so
    occupancy, and with it the width tier, moves); every request's
    tokens of the second pass against fixed width and batch at a time,
    exactly."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    tag = " int8 W+KV" if quant else ""
    lo, hi, bucket = LONG_SPAN
    rng = np.random.default_rng(24)
    load = []
    for i in range(LONG_BATCH):
        p = rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
        budget = int(rng.integers(1, NEW_TOKENS + 1))
        load.append((p, SamplingParams(temperature=0.8, top_k=50, seed=i,
                                       max_new_tokens=budget) if i % 2
                     else SamplingParams(max_new_tokens=budget)))
    base = dict(mode="decoder", max_batch=LONG_BATCH, pad_buckets=(bucket,),
                max_new_tokens=NEW_TOKENS, weight_quant=quant,
                kv_quant=quant)
    t0 = time.perf_counter()
    streams = {}
    for label, kw, passes in (("adaptive", {}, 2),
                              ("fixed", dict(segment_width="fixed"), 2),
                              ("batch at a time", dict(
                                  continuous=False, batch_window_ms=200.0),
                               1)):
        eng = ServingEngine(cfg, params, EngineConfig(**dict(base, **kw)),
                            device="cuda")
        try:
            for _ in range(passes):
                eng.window()
                results, _ = serve_load(
                    eng, load, LONG_GAP_S if passes == 2 else 0)
            win = eng.window()
        finally:
            eng.close()
        streams[label] = [r.tokens for r in results]
        if label == "adaptive":
            lane = win["lanes"][bucket]
            print(f"continuous long{tag}: bucket {bucket}, {LONG_BATCH} "
                  f"requests of {lo}..{hi} tokens, budgets 1..{NEW_TOKENS}, "
                  f"{LONG_GAP_S * 1e3:.0f} ms apart; the adaptive engine's "
                  f"second pass: segments {lane['decode_segments']} "
                  f"(compacted {lane['compact_segments']}), joins "
                  f"{lane['joins']}, tier_hist {lane['tier_hist']}, "
                  f"{win['jit_compiles']} programs captured", flush=True)
    compare_streams(streams, f"continuous long{tag}")
    print(f"continuous long{tag}: three engines took "
          f"{time.perf_counter() - t0:.1f} s [{name}]", flush=True)


def tier_timings(eng, bucket, name, tag):
    """The smallest and the largest width tier's decode segment
    (``decode_segment`` steps) of the engine's bucket, captured (a replay
    of its program: wall, kernels and device idle share) and the same
    program called uncaptured: at the largest width wall, kernels and
    idle share, at the smallest the wall alone (the profiler's summary of
    an eager segment takes tens of seconds). Returns {width: captured
    reading}."""
    out = {}
    for width in (eng._tiers[0], eng._tiers[-1]):
        slots = list(range(width))
        rows = (np.full((width, 1), 7, np.int32),
                np.full((width, 1), 5, np.int32), np.ones(width, bool),
                np.full(width, 99, np.int32), np.full(width, -1, np.int32))
        compact = width < eng.ec.max_batch
        kw = dict(slots=slots) if compact else {}
        cap = program_reading(lambda: eng._segment_call(bucket, width, rows,
                                                        **kw), n_wall=5)
        fn = eng._segment_fn(bucket)
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in rows]
        idx = (torch.tensor(slots, dtype=torch.int64, device="cuda")
               if compact else None)
        src = (torch.arange(width, dtype=torch.int64, device="cuda")
               if compact else None)

        def direct():
            with torch.inference_mode():
                return fn(*dev, None, None, None, idx, src)
        if width == eng._tiers[-1]:
            unc = fmt_reading(program_reading(direct, n=1, n_wall=3))
        else:
            unc = f"wall {sync_wall_ms(direct, n=3, warmup=1):.4f} ms"
        print(f"continuous{tag} segment bucket {bucket} width {width} "
              f"({eng.ec.decode_segment} steps): captured "
              f"{fmt_reading(cap)}; uncaptured {unc} [{name}]", flush=True)
        out[width] = cap
    return out


# ------------------------------------- a row's bits: encoder, eager decoder
def _requests(prompts):
    from concurrent.futures import Future
    from repro_torch.serving.engine import _Request
    return [_Request(np.asarray(p, np.int32), Future(), time.perf_counter())
            for p in prompts]


def phase_encoder_widths(cfg, params, label, quant=None):
    """22, the encoder program. Rows of batches n = 1..16 at bucket 32 and
    n = 1..4 at bucket 128 served by the encoder engine's program (which
    pads a batch to ``PREFILL_MIN_M`` rows of M with copies of its first
    row) must equal the same rows of the widest batch bit for bit:
    GECToR-base's hidden states, float or int8 weights."""
    from repro_torch.serving import EngineConfig, ServingEngine
    rng = np.random.default_rng(220)
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="encoder", max_batch=16, pad_buckets=(32, 128),
        weight_quant=quant), device="cuda")
    worst, checked = 0.0, 0
    try:
        with torch.inference_mode():
            for bucket, cap, lo in ((32, 16, 8), (128, 4, 33)):
                sents = sentences(rng, cap, lo, bucket - 8, cfg.vocab_size)
                if bucket == 32:
                    short = sents[0]

                def serve(n):
                    reqs = _requests(sents[:n])
                    eng._serve_batch(reqs)
                    return [r.future.result() for r in reqs]
                wide = serve(cap)
                for n in range(1, cap):
                    for g, w in zip(serve(n), wide):
                        worst = max(worst, (g.float() - w.float()).abs()
                                    .max().item())
                    checked += 1
            # what the padding costs: one sentence's forward at bucket 32
            # alone (M = 32) and as the engine runs it (4 rows, M = 128),
            # each a captured program, by events over its replays
            from repro_torch.models import forward
            from repro_torch.serving.graphs import GraphCache
            tree = eng.params.get("encoder", eng.params)
            one = torch.zeros((4, 32), dtype=torch.long, device="cuda")
            one[:, :len(short)] = torch.from_numpy(short).cuda()
            programs = GraphCache("cuda")

            def fwd(t):
                return forward(cfg, tree, tokens=t, causal=False,
                               return_hidden=True)
            cost = [cuda_ms(lambda: programs.run(b, fwd, one[:b]))
                    for b in (1, 4)]
    finally:
        eng.close()
    print(f"width determinism {label}: GECToR-base encoder program, rows "
          f"of batches 1..15 at bucket 32 and 1..3 at bucket 128 (padded "
          f"by the engine to M >= {128}) vs the widest batch: max hidden "
          f"diff {worst:.3e} over {checked} batches; one sentence's "
          f"forward at bucket 32, a captured program's replay by events: "
          f"alone {cost[0]:.4f} ms, padded to 4 rows {cost[1]:.4f} ms",
          flush=True)
    if worst != 0.0:
        raise AssertionError(f"{label}: an encoder row changes with its "
                             f"batch ({worst:.3e})")


def phase_eager_decoder_widths(cfg, params, label, quant=None):
    """22, the eager decoder (``use_scan_decode=False``). Prompts of
    batches n = 1..4 at bucket 32 prefilled as the engine prefills them
    (``_acquire_caches`` pads the batch to ``PREFILL_MIN_M`` rows of M
    with copies of the first row's cache): the first-token logits of
    each row must equal the widest batch's bit for bit."""
    from repro_torch.models import forward
    from repro_torch.models.layers import lm_head_apply
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.engine import _pad_rows
    rng = np.random.default_rng(221)
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="decoder", continuous=False, use_scan_decode=False,
        pad_buckets=(32,), max_batch=4, max_new_tokens=NEW_TOKENS,
        weight_quant=quant, kv_quant=quant), device="cuda")
    _, toks, lens = prompt_batch(rng, 4, 8, 32, 32, cfg.vocab_size)

    def first(n):
        rows = eng._prefill_rows(n, 32)
        caches, handle = eng._acquire_caches(n, 32, rows=rows)
        try:
            t, ln = (torch.from_numpy(a).cuda()
                     for a in _pad_rows(rows, toks[:n], lens[:n]))
            hid = forward(cfg, eng.params, tokens=t, caches=caches,
                          mode="full", return_hidden=True)
            last = hid[torch.arange(rows, device="cuda"), ln - 1][:, None]
            return lm_head_apply(cfg, None, last, w=eng._head_w)[:n, 0]
        finally:
            eng._release_caches(handle)
    try:
        with torch.inference_mode():
            wide = first(4)
            worst = max((first(n) - wide[:n]).abs().max().item()
                        for n in (1, 2, 3))
    finally:
        eng.close()
    print(f"width determinism {label}: eager decoder first-token logits of "
          f"batches 1..3 at bucket 32 vs 4: max diff {worst:.3e}",
          flush=True)
    if worst != 0.0:
        raise AssertionError(f"{label}: an eager decoder row changes with "
                             f"its batch ({worst:.3e})")


# ------------------------------------------------------- chunked prefill
CHUNK = 128                     # prefill_chunk of phases 24 and 25
# (a)'s prompts: (length, bucket, chunks)
CHUNK_PROMPTS = ((100, 128, (128, 64)), (257, 512, (128,)),
                 (500, 512, (128,)))
# (c)'s load: 16 requests per (shortest, longest prompt, bucket); buckets
# of whole chunks, since the ring check holds every bucket to them
CHUNK_SPANS = ((8, 128, 128), (129, 256, 256), (257, 500, 512))


def chunk_logits(cfg, params, prompt, bucket, C, w, kv_quant=None):
    """The first-token logits (V,) of ``prompt`` prefilled chunk by chunk
    into fresh caches of bucket + NEW_TOKENS slots, as a fill runs."""
    from repro_torch.models import make_caches
    caches = make_caches(cfg, 1, bucket + NEW_TOKENS, dtype=torch.float32,
                         kv_quant=kv_quant, device="cuda")
    return chunk_logits_into(cfg, params, prompt, C, w, caches)[0]


def whole_logits(cfg, params, prompt, bucket, w, plain=False,
                 kv_quant=None):
    """The first-token logits of ``prompt`` padded to ``bucket`` and
    prefilled whole (K1, or ``plain`` attention), as a join runs."""
    from repro_torch.models import make_caches
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(prompt)] = prompt
    caches = make_caches(cfg, 1, bucket + NEW_TOKENS, dtype=torch.float32,
                         kv_quant=kv_quant, device="cuda")
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    logits, _ = first_logits(cfg, params, torch.from_numpy(toks).cuda(),
                             lens, caches, plain)
    return logits[0]


def phase_chunk_model(cfg, params, qparams, name):
    """24 (a). One prompt of each length in ``CHUNK_PROMPTS`` prefilled
    chunk by chunk against whole: with fp32 weights (and the fp32 K1) the
    first-token logits agree to 1e-4 of their largest magnitude; with bf16
    weights the chunked logits' error against the fp32 whole prefill may
    be at most ``LOGIT_ERR_FACTOR`` x the plain-attention whole prefill's
    (phase 7's rule). Returns the largest |chunked - whole| bf16 logit
    difference, with float weights and with ``qparams`` (int8 weights and
    KV): phase 24 (c)'s near-tie thresholds."""
    from repro_torch.models.layers import head_weight
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_fp32(params)
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    w32 = head_weight(cfg32, params32.get("lm_head"), params32["embed"])
    rng = np.random.default_rng(240)
    tie = tie8 = 0.0
    with torch.inference_mode():
        for length, bucket, chunks in CHUNK_PROMPTS:
            prompt = rng.integers(0, cfg.vocab_size, length)
            ref = whole_logits(cfg32, params32, prompt, bucket, w32)
            plain = whole_logits(cfg, params, prompt, bucket, w, plain=True)
            k1 = whole_logits(cfg, params, prompt, bucket, w)
            e_plain = (plain.float() - ref).abs().max().item()
            # the padded vocabulary's masked logits equal in every path
            mag = ref[:cfg.vocab_size].abs().max().item()
            for C in chunks:
                c32 = chunk_logits(cfg32, params32, prompt, bucket, C, w32)
                d32 = (c32 - ref).abs().max().item()
                rel = d32 / mag
                cbf = chunk_logits(cfg, params, prompt, bucket, C, w)
                e_chunk = (cbf.float() - ref).abs().max().item()
                d = (cbf.float() - k1.float()).abs().max().item()
                tie = max(tie, d)
                print(f"chunked prefill, model level: {length} tokens, "
                      f"bucket {bucket}, C={C}: fp32 chunked vs whole "
                      f"{d32:.3e} of {mag:.3e} = {rel:.3e} relative (tol "
                      f"1e-4); bf16 vs the fp32 "
                      f"whole: chunked {e_chunk:.3e}, plain whole "
                      f"{e_plain:.3e} (factor {LOGIT_ERR_FACTOR}); bf16 "
                      f"chunked vs K1 whole {d:.3e}; top-1 "
                      f"{'same' if cbf.argmax() == k1.argmax() else 'differs'}",
                      flush=True)
                if rel > 1e-4:
                    raise AssertionError(f"fp32 chunked prefill of {length} "
                                         f"tokens at C={C}: {rel:.3e}")
                if e_chunk > LOGIT_ERR_FACTOR * e_plain:
                    raise AssertionError(
                        f"bf16 chunked prefill of {length} tokens at C={C} "
                        f"strays from fp32 by {e_chunk:.3e} > "
                        f"{LOGIT_ERR_FACTOR} x {e_plain:.3e}")
                d8 = (chunk_logits(cfg, qparams, prompt, bucket, C, w,
                                   kv_quant="int8").float()
                      - whole_logits(cfg, qparams, prompt, bucket, w,
                                     kv_quant="int8").float()).abs().max()
                tie8 = max(tie8, d8.item())
    print(f"chunked prefill, model level: near-tie thresholds (bf16 "
          f"chunked vs whole) float {tie:.4e}, int8 W+KV {tie8:.4e}",
          flush=True)
    del params32
    torch.cuda.empty_cache()
    return tie, tie8


def chunk_attention_timings(cfg, name):
    """A chunk's attention over the cache (``naive_attention``, one layer)
    against SDPA on the same chunk-over-cache mask, by device time, at
    C = 128 over a cache of 528 slots, 1 and 16 rows."""
    from repro_torch.models.attention import _mask, naive_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(241)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    L, C = 528, CHUNK
    out = {}
    for rows in (1, 16):
        q = randn(gen, rows, C, Hq, D, dtype=torch.bfloat16)
        k, v = (randn(gen, rows, L + C, Hkv, D, dtype=torch.bfloat16)
                for _ in range(2))
        start = 384                           # the chunk's 4th position
        qpos = (start + torch.arange(C, device="cuda"))[None].expand(rows, C)
        kpos = torch.full((rows, L), -1, dtype=torch.int32, device="cuda")
        kpos[:, :start] = torch.arange(start, dtype=torch.int32,
                                       device="cuda")
        kvpos = torch.cat([kpos, qpos.int()], 1)
        t_n = device_ms(lambda: naive_attention(q, k, v, qpos, kvpos))
        mask = _mask(qpos, kvpos, causal=True, window=None)[:, None]
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                  for x in (k, v))
        t_s = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        kv_bytes = 2 * rows * (L + C) * Hkv * D * 2
        bound = max((kv_bytes + 2 * rows * C * Hq * D * 2) / HBM_BYTES_PER_S,
                    4 * rows * Hq * C * (start + C) * D / BF16_FLOP_PER_S) \
            * 1e3
        out[rows] = (t_n, t_s, bound)
        print(f"chunk attention over the cache, one layer, {rows} rows x "
              f"C={C} at position {start}, ring {L}, {Hq}/{Hkv} heads of "
              f"{D}, bf16: naive_attention {fmt_ms(t_n)}, SDPA (mask) "
              f"{fmt_ms(t_s)}, bound {bound:.4f} ms; per chunk "
              f"({cfg.n_layers} layers) naive "
              f"{fmt_ms(None if t_n is None else t_n * cfg.n_layers)} "
              f"[{name}]", flush=True)
    return out


def phase_chunk_rows(cfg, params, name, kv_quant=None, label=""):
    """24 (b). The engine's chunk program up to its logits (gather the
    fills' staging slots, ``prefill_chunk`` at their starts, the logits at
    ``nvalid - 1``), at C = 128 in bucket 512: 16 fills of 500 tokens whose
    first chunk is staged; row 0's second-chunk logits run alone and with
    1..15 other fills (rows ``_prefill_rows(n, C)``, padded as the engine
    pads) must equal the 16-fill run's bit for bit, and the 16-fill
    program captured must equal it uncaptured. Returns the captured
    reading."""
    from repro_torch.models import prefill_chunk
    from repro_torch.models.layers import head_weight, lm_head_apply
    from repro_torch.serving import kvcache
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.graphs import GraphCache
    from repro_torch.serving.kvcache import CachePool
    bucket, C, n_max = 512, CHUNK, CONT_BATCH
    pool = CachePool(cfg, n_max, bucket + NEW_TOKENS, dtype=torch.float32,
                     kv_quant=kv_quant, device="cuda")
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    rng = np.random.default_rng(242)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (n_max, 2 * C))).cuda()
    ar = torch.arange(C, dtype=torch.int32, device="cuda")

    def fn(t, start, nvalid, idx):
        view = kvcache._take_slots(pool.caches, idx)
        hid = prefill_chunk(cfg, params, t, start[:, None] + ar, view,
                            return_hidden=True)
        last = hid[torch.arange(t.shape[0], device="cuda"), nvalid - 1]
        return lm_head_apply(cfg, None, last[:, None], w=w)[:, 0]

    def args(n):
        rows = ServingEngine._prefill_rows(n, C)
        idx = list(range(n)) + [0] * (rows - n)
        ix = torch.tensor(idx, device="cuda")
        return (toks[ix, C:], torch.full((rows,), C, dtype=torch.int32,
                                         device="cuda"),
                torch.full((rows,), C, dtype=torch.int32, device="cuda"), ix)
    with torch.inference_mode():
        prefill_chunk(cfg, params, toks[:, :C], ar[None].expand(n_max, C),
                      pool.caches)                # stage every fill's chunk 0
        ref = fn(*args(n_max))[0]
        worst = max((fn(*args(n))[0] - ref).abs().max().item()
                    for n in range(1, n_max))
        print(f"chunk program{label}: row 0's logits alone and with 1..15 "
              f"other fills (C={C}, bucket {bucket}, rows padded to "
              f"M >= 128) vs 16 fills: max diff {worst:.3e}", flush=True)
        if worst != 0.0:
            raise AssertionError(f"chunk program{label}: row 0 changes with "
                                 f"the fills beside it ({worst:.3e})")
        gc = GraphCache("cuda")
        a16 = args(n_max)
        cap, unc = captured_against_direct(
            gc, ("chunk", n_max), fn, a16, fn(*a16),
            f"chunk program{label} (16 fills x C={C}, bucket {bucket}, up "
            f"to the logits)", name)
        a1 = args(1)
        cap1, unc1 = captured_against_direct(
            gc, ("chunk", 1), fn, a1, fn(*a1),
            f"chunk program{label} (1 fill x C={C}, bucket {bucket}, up to "
            f"the logits)", name)
    return {"16 fills": (cap, unc), "1 fill": (cap1, unc1)}


def choice_margin(logits, sp, position, want):
    """The smallest change of logits, in logit units, that changes the
    choice of the sampler at one step (``sample_logits`` on ``logits``
    (V,) with ``sp``'s temperature, top_k and seed, counter
    ``position``): greedy, the gap of the top two logits; sampled, the
    least of (i) the gap of the top two noisy scores among the top-k
    tokens times the temperature, (ii) the distance below the top-k
    threshold of the nearest token outside the top k whose noisy score
    would win if it entered, and (iii) the winner's distance above the
    largest logit outside the top k. Checks that the reconstruction picks
    ``want``, the run's token."""
    from repro_torch.models import threefry
    lg = logits.float()
    if not sp.temperature:           # argmax: the first of tied maxima
        winner = int(torch.argmax(lg))
        top = torch.topk(lg, 2).values
        margin = (top[0] - top[1]).item()
    else:
        V = lg.shape[0]
        k = sp.top_k if sp.top_k else V
        desc = torch.sort(lg, descending=True).values
        thresh = desc[k - 1]
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(0x5EED, device=lg.device),
            torch.tensor(sp.seed, dtype=torch.int32, device=lg.device)),
            torch.tensor(position, dtype=torch.int32, device=lg.device))
        raw = lg / sp.temperature + threefry.gumbel(key, V)
        inside = lg >= thresh
        scores = torch.where(inside, raw, float("-inf"))
        winner = int(torch.argmax(scores))
        top = torch.topk(scores, 2).values
        margin = (top[0] - top[1]).item() * sp.temperature
        enter = ~inside & (raw > top[0])
        if enter.any():
            margin = min(margin, (thresh - lg[enter].max()).item())
        if k < V:
            margin = min(margin, (lg[winner] - desc[k]).item())
    if winner != int(want):
        raise AssertionError(f"the margin's reconstruction picks {winner}, "
                             f"the run {want}")
    return margin


def stream_logits(cfg, params, prompt, bucket, stream, d, *, kv_quant=None,
                  chunk=None, decode_width=None):
    """The logits (V,) at step ``d`` of ``stream`` (a run's tokens for
    ``prompt``): the prompt prefilled whole at ``bucket`` (or chunk by
    chunk of ``chunk``), then teacher-forced decode steps up to step d at
    the engine's decode width (default ``CONT_BATCH``), into one-row
    caches of bucket + NEW_TOKENS slots."""
    from repro_torch.models import forward, make_caches
    from repro_torch.models.layers import head_weight
    caches = make_caches(cfg, 1, bucket + NEW_TOKENS, dtype=torch.float32,
                         kv_quant=kv_quant, device="cuda")
    n = len(prompt)
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    if chunk:
        logits = chunk_logits_into(cfg, params, prompt, chunk, w, caches)
    else:
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = prompt
        logits, _ = first_logits(cfg, params, torch.from_numpy(toks).cuda(),
                                 torch.tensor([n], dtype=torch.int32,
                                              device="cuda"), caches, False)
    for step in range(1, d + 1):
        tok = torch.tensor([[int(stream[step - 1])]], dtype=torch.int32,
                           device="cuda")
        pos = torch.tensor([[n + step - 1]], dtype=torch.int32,
                           device="cuda")
        logits = forward(cfg, params, tokens=tok, positions=pos,
                         caches=caches, mode="decode", head_w=w,
                         decode_width=decode_width or CONT_BATCH)[:, 0]
    return logits[0]


def phase_chunked_continuous(cfg, params, kernels, name, tie, quant=None):
    """24 (c). The 48 requests of ``cont_load`` over ``CHUNK_SPANS``
    (prompts up to 500 tokens in buckets 128/256/512) through the
    continuous engine with ``prefill_chunk=128`` and without, float or
    int8 W+KV, each engine capturing its programs as they come. Every
    request's tokens must be equal, except where the first differing step
    is a near-tie of the unchunked run: a ``choice_margin`` below ``tie``
    (phase 24 (a)'s chunked-vs-whole logit difference); each such request
    is printed with its margin and the count of them. Returns the chunked
    engine's K1..K5 launches."""
    import gc
    from repro_torch.serving import EngineConfig, ServingEngine
    tag = " int8 W+KV" if quant else ""
    load = cont_load(cfg, 24, spans=CHUNK_SPANS)
    base = dict(mode="decoder", max_batch=CONT_BATCH,
                pad_buckets=tuple(b for _, _, b in CHUNK_SPANS),
                max_new_tokens=NEW_TOKENS, weight_quant=quant,
                kv_quant=quant)
    t0 = time.perf_counter()
    streams, wins, mem = {}, {}, {}
    for label, kw in (("chunked", dict(prefill_chunk=CHUNK)), ("whole", {})):
        gc.collect()                      # the engines before, freed now
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        eng = ServingEngine(cfg, params, EngineConfig(**base, **kw),
                            device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_launches(kernels)
            results, wall = serve_load(eng, load, CONT_GAP_S)
            launches = tuple(fn.launches for fn in kernels)
            wins[label] = (eng.window(), launches, wall)
            tree = eng.params
            torch.cuda.synchronize()
            mem[label] = (
                sum(p.nbytes for p in eng._pools.values()),
                sum(ln.staging.nbytes
                    for ln in eng._scheduler.lanes.values()
                    if ln.staging is not None),
                torch.cuda.memory_allocated() - base_mem,
                torch.cuda.max_memory_allocated() - base_mem)
        finally:
            eng.close()
        streams[label] = [r.tokens for r in results]
        print(f"chunked continuous{tag}, {label}: lane pools {mem[label][0]:,} "
              f"B, staging pools {mem[label][1]:,} B; device memory above "
              f"what the phase held before the engine (its int8 tree "
              f"included): resident {mem[label][2]:,} B after serving, "
              f"peak {mem[label][3]:,} B while serving [{name}]", flush=True)
    win, launches, wall = wins["chunked"]
    print(f"chunked continuous{tag}: 48 requests in {wall:.3f} s, "
          f"prefill_chunks {win['prefill_chunks']} (lanes "
          f"{ {b: l['prefill_chunks'] for b, l in win['lanes'].items()} }), "
          f"prefill batches {win['prefill_batches']}, segments "
          f"{win['decode_segments']}, {win['jit_compiles']} programs "
          f"captured; K1..K5 launches {launches}; the unchunked engine "
          f"{wins['whole'][2]:.3f} s, K1..K5 {wins['whole'][1]} [{name}]",
          flush=True)
    n_fill = sum(-(-len(p) // CHUNK) for p, _ in load if len(p) > CHUNK)
    if win["prefill_chunks"] != n_fill:
        raise AssertionError(f"prefill_chunks {win['prefill_chunks']} != "
                             f"{n_fill}")
    parted = []
    for i, ((p, sp), a, b) in enumerate(zip(load, streams["chunked"],
                                            streams["whole"])):
        if np.array_equal(a, b):
            continue
        n = min(len(a), len(b))
        d = int(np.argmin(a[:n] == b[:n])) if (a[:n] != b[:n]).any() else n
        bucket = next(bk for _, hi, bk in CHUNK_SPANS if len(p) <= hi)
        with torch.inference_mode():
            margin = choice_margin(
                stream_logits(cfg, tree, p, bucket, b, d, kv_quant=quant),
                sp, len(p) + d, b[d])
        parted.append((i, len(p), d, margin))
        print(f"chunked continuous{tag}: request {i} ({len(p)} tokens, "
              f"{'sampled' if sp.temperature else 'greedy'}) parts from "
              f"the unchunked run at step {d}, whose choice margin there "
              f"is {margin:.4e} (near-tie threshold {tie:.4e})",
              flush=True)
    print(f"chunked continuous{tag}: {48 - len(parted)} of 48 requests "
          f"token-identical to the unchunked engine; {len(parted)} part at "
          f"a near-tie; {time.perf_counter() - t0:.1f} s", flush=True)
    if any(m >= tie for *_, m in parted):
        raise AssertionError(f"chunked continuous{tag}: partings {parted} "
                             f"not all below the near-tie threshold "
                             f"{tie:.4e}")
    return launches


def stall_reading(cfg, params, name):
    """24, the stall chunking cuts: one request decoding in bucket 128
    (64 new tokens) while a 500-token prompt joins bucket 512; the gaps
    between the in-flight request's segments (its streamed tokens' arrival
    times) with ``prefill_chunk=128`` against whole-prompt admission.
    Programs of one-row joins and segments are captured first."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(243)
    short = rng.integers(0, cfg.vocab_size, 40)
    long = rng.integers(0, cfg.vocab_size, 500)
    out = {}
    for label, kw in (("chunked", dict(prefill_chunk=CHUNK)), ("whole", {})):
        eng = ServingEngine(cfg, params, EngineConfig(
            mode="decoder", max_batch=CONT_BATCH, pad_buckets=(128, 512),
            max_new_tokens=64, **kw), device="cuda")
        try:
            eng.warmup(batch_sizes=[1])
            h = eng.generate(short, SamplingParams(max_new_tokens=64))
            it = iter(h)
            next(it)
            times = []
            t_join = None
            for i, _ in enumerate(it):
                times.append(time.perf_counter())
                if i == 4 * eng.ec.decode_segment:
                    t_join = time.perf_counter()
                    hl = eng.generate(long, SamplingParams(max_new_tokens=1))
            hl.result(timeout=300)
            t_done = hl.result().timing.prefill_s
        finally:
            eng.close()
        gaps = np.diff([t for j, t in enumerate(times)
                        if j % eng.ec.decode_segment == 0]) * 1e3
        during = [g for g, t in zip(gaps, times[eng.ec.decode_segment::
                                                eng.ec.decode_segment])
                  if t >= t_join]
        out[label] = (float(np.median(gaps)), float(max(during[:8])),
                      t_done * 1e3)
        print(f"stall, {label}: the in-flight row's segment gap median "
              f"{out[label][0]:.3f} ms, the largest while the 500-token "
              f"prompt prefills {out[label][1]:.3f} ms; that prompt's "
              f"prefill wall {out[label][2]:.3f} ms [{name}]", flush=True)
    return out


def phase_chunked_hybrid(cfg, params, kernels, name):
    """24, the hybrid. RecurrentGemma-9B at full depth, 4 greedy requests
    of 385-500 tokens (4 chunks each) at bucket 512, ``prefill_chunk=128``,
    served one after another: each request's 16 tokens must equal direct
    calls (``prefill_chunk`` chunk by chunk, the first token at the last
    real position, ``decode_segment`` at the engine's decode width), and
    K5 must launch 26 times per chunk program run (the recurrent layers,
    once each, with the carried state)."""
    from repro_torch.models import decode_segment, make_caches
    from repro_torch.models.layers import head_weight
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(244)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(385, 501, 4)]
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="decoder", max_batch=4, pad_buckets=(512,),
        max_new_tokens=NEW_TOKENS, prefill_chunk=CHUNK), device="cuda")
    calls = []
    chunk_call = eng._chunk_call

    def counted(*a, **k):
        calls.append(a[0])
        return chunk_call(*a, **k)
    eng._chunk_call = counted
    t0 = time.perf_counter()
    try:
        reset_launches(kernels)
        got = [eng.generate(p, SamplingParams()).result(timeout=600).tokens
               for p in prompts]
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.close()
    t_serve = time.perf_counter() - t0
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    n_rec = sum(k == "rglru" for k in cfg.pattern) * cfg.n_periods
    same = 0
    with torch.inference_mode():
        for p, g in zip(prompts, got):
            caches = make_caches(cfg, 1, 512 + NEW_TOKENS,
                                 dtype=torch.float32, device="cuda")
            lg = chunk_logits_into(cfg, params, p, CHUNK, w, caches)
            first = lg.argmax(-1).to(torch.int32)[:, None]
            rest, _, _, _ = decode_segment(
                cfg, params, first,
                torch.tensor([[len(p)]], dtype=torch.int32, device="cuda"),
                caches, n_steps=NEW_TOKENS - 1, head_w=w, decode_width=4)
            want = torch.cat([first, rest], 1)[0].cpu().numpy()
            same += int(np.array_equal(g, want))
    n_chunks = calls.count("cont_chunk")
    print(f"chunked hybrid: RecurrentGemma-9B, 4 requests of "
          f"{[len(p) for p in prompts]} tokens at C={CHUNK}: {same} of 4 "
          f"token-identical to direct chunk-by-chunk calls; {n_chunks} "
          f"chunk programs, K1..K5 launches {launches} (K5 {n_rec} x "
          f"{n_chunks} expected); served in {t_serve:.1f} s [{name}]",
          flush=True)
    if same != 4 or launches[4] != n_rec * n_chunks or n_chunks != 16:
        raise AssertionError(f"chunked hybrid: {same} of 4 equal, K5 "
                             f"{launches[4]} for {n_chunks} chunks")
    return launches


def chunk_logits_into(cfg, params, prompt, C, w, caches):
    """``prompt`` prefilled chunk by chunk (``prefill_chunk``, chunks of C
    from position 0, the last padded) into the one-row ``caches``: the
    first-token logits (1, V)."""
    from repro_torch.models import prefill_chunk
    from repro_torch.models.layers import lm_head_apply
    for s0 in range(0, len(prompt), C):
        t = torch.zeros((1, C), dtype=torch.long, device="cuda")
        part = torch.from_numpy(prompt[s0:s0 + C]).cuda()
        t[0, :len(part)] = part
        pos = s0 + torch.arange(C, dtype=torch.int32, device="cuda")[None]
        hid = prefill_chunk(cfg, params, t, pos, caches, return_hidden=True)
    return lm_head_apply(cfg, None, hid[:, len(part) - 1][:, None],
                         w=w)[:, 0]


# ---------------------------------------------------------- prefix cache
# (bucket, prefill_chunk): the system prompt is 3/4 of the bucket, whole
# chunks, so a hit's suffix of 1..bucket/8 tokens runs as one chunk
PREFIX_BUCKETS = ((128, 32), (512, 128))
PREFIX_REQUESTS = 8


def one_by_one(eng, prompts):
    """Serve greedy ``prompts`` one after another (each its own join, so
    hits and inserts do not hang on timing); (results, the window)."""
    from repro_torch.serving.api import SamplingParams
    eng.window()
    out = [eng.generate(p, SamplingParams()).result(timeout=600)
           for p in prompts]
    return out, eng.window()


def phase_prefix(cfg, params, kernels, name, tie, kv_quant=None):
    """25. The prefix cache at buckets 128 (C=32) and 512 (C=128), float
    or int8 KV, max_batch 4, greedy requests served one after another.
    Traffic: a system prompt of 3/4 of the bucket plus a unique suffix of
    1..bucket/8 tokens. The first request misses and stores the system
    prompt from its chunked fill; the other 7 hit it and must equal a cold
    engine's tokens (``prefix_cache=False``) exactly; the counters must be
    7 hits, 1 miss, 1 insert, 7 x the prompt's tokens hit; the measured
    window after ``warmup()`` builds nothing. At bucket 512 a donor of
    exactly one chunk (a whole-prompt join, its KV through K1) serves 6
    hits, held to phase 24's token rule. A store of one entry's bytes
    evicts as three families rotate and stays equal to cold. Prints the
    prefill device ms of a cold request (its chunk programs) against a
    warm one (one hit program), and the engines' prefill walls."""
    from repro_torch.serving import EngineConfig, ServingEngine
    tag = " int8 KV" if kv_quant else ""
    rng = np.random.default_rng(250)
    launches = None
    for bucket, C in PREFIX_BUCKETS:
        V = cfg.vocab_size

        def family(n_sys):
            sysp = rng.integers(0, V, n_sys)
            return [np.concatenate([sysp, rng.integers(
                0, V, int(rng.integers(1, bucket // 8 + 1)))])
                for _ in range(PREFIX_REQUESTS)]
        prompts = family(bucket * 3 // 4)
        fams = [family(bucket * 3 // 4)[:2] for _ in range(3)]
        rotate = [p for f in fams for p in f]
        base = dict(mode="decoder", max_batch=4, pad_buckets=(bucket,),
                    max_new_tokens=NEW_TOKENS, prefill_chunk=C,
                    kv_quant=kv_quant)
        cold = ServingEngine(cfg, params, EngineConfig(**base),
                             device="cuda")
        try:
            want, wcold = one_by_one(cold, prompts + rotate)
        finally:
            cold.close()
        eng = ServingEngine(cfg, params, EngineConfig(
            **base, prefix_cache=True), device="cuda")
        try:
            eng.warmup()
            reset_launches(kernels)
            got, win = one_by_one(eng, prompts)
            launches = tuple(fn.launches for fn in kernels)
            lane = win["lanes"][bucket]
            entry_bytes = eng._prefix_store(bucket).entry_bytes
            store_bytes = eng._prefix_store(bucket).pool.nbytes
            device = prefix_device_ms(eng, bucket, C, prompts)
        finally:
            eng.close()
        same = sum(np.array_equal(g.tokens, w.tokens)
                   for g, w in zip(got, want))
        counts = {k: lane[k] for k in ("prefix_hits", "prefix_misses",
                                        "prefix_inserts",
                                        "prefix_hit_tokens")}
        expect = {"prefix_hits": 7, "prefix_misses": 1, "prefix_inserts": 1,
                  "prefix_hit_tokens": 7 * (bucket * 3 // 4)}
        walls = [r.timing.prefill_s * 1e3 for r in got]
        cwalls = [r.timing.prefill_s * 1e3 for r in want[:len(prompts)]]
        print(f"prefix{tag}, bucket {bucket}, C={C}: {same} of "
              f"{len(prompts)} token-identical to the cold engine; "
              f"counters {counts}; window jit_compiles "
              f"{win['jit_compiles']}, prefix_bytes {lane['prefix_bytes']:,} "
              f"(the store's pool {store_bytes:,} B); "
              f"prefill device ms: cold {device[0]:.4f} "
              f"({-(-len(prompts[0]) // C)} chunk programs), warm "
              f"{device[1]:.4f} (one hit program); prefill wall mean: cold "
              f"{np.mean(cwalls[1:]):.3f} ms, warm {np.mean(walls[1:]):.3f} "
              f"ms [{name}]", flush=True)
        if same != len(prompts) or counts != expect or win["jit_compiles"]:
            raise AssertionError(f"prefix{tag} bucket {bucket}: {same} "
                                 f"equal, counters {counts} != {expect}, "
                                 f"{win['jit_compiles']} captures")
        tiny = ServingEngine(cfg, params, EngineConfig(
            **base, prefix_cache=True, prefix_cache_bytes=entry_bytes),
            device="cuda")
        try:
            got, win = one_by_one(tiny, rotate)
        finally:
            tiny.close()
        lane = win["lanes"][bucket]
        same = sum(np.array_equal(g.tokens, w.tokens)
                   for g, w in zip(got, want[len(prompts):]))
        print(f"prefix{tag}, bucket {bucket}, a store of one entry: {same} "
              f"of {len(rotate)} token-identical to cold; hits "
              f"{lane['prefix_hits']}, inserts {lane['prefix_inserts']}, "
              f"evictions {lane['prefix_evictions']}, prefix_bytes "
              f"{lane['prefix_bytes']:,} (one entry {entry_bytes:,})",
              flush=True)
        if (same != len(rotate) or lane["prefix_evictions"] != 2
                or lane["prefix_hits"] != 3
                or lane["prefix_bytes"] > entry_bytes):
            raise AssertionError(f"prefix{tag} one-entry store: {same} "
                                 f"equal, {lane}")
        if bucket == 512:
            whole_donor(cfg, params, base, C, name, tie, kv_quant, rng)
    return launches


def prefix_device_ms(eng, bucket, C, prompts):
    """Device ms of a request's prefill by its programs, replayed on the
    engine's captured programs: a cold one's chunk programs (one fill,
    the first prompt's starts) and a warm one's hit program."""
    lane = eng._scheduler.lanes[bucket]
    staging, pool = lane.staging, lane.pool
    store = eng._prefix_store(bucket)
    entry = store.trie.entries[0]
    p = prompts[1]
    chunks = []
    for s0 in range(0, len(p), C):
        part = p[s0:s0 + C]
        toks = np.zeros((1, C), np.int64)
        toks[0, :len(part)] = part
        chunks.append((toks, np.array([s0], np.int32),
                       np.array([len(part)], np.int32)))

    def cold_prefill():
        for toks, start, nvalid in chunks:
            eng._chunk_call("cont_chunk", bucket, staging, staging, toks,
                            start, nvalid, [0], [0])
    cold = program_reading(cold_prefill, n_wall=2)[1] or float("nan")
    suffix = p[entry.n_tokens:]
    toks = np.zeros((1, C), np.int64)
    toks[0, :len(suffix)] = suffix
    warm = program_reading(lambda: eng._chunk_call(
        "cont_hit", bucket, store.pool, pool, toks,
        np.array([entry.n_tokens], np.int32),
        np.array([len(suffix)], np.int32), [entry.slot], [0]),
        n_wall=2)[1] or float("nan")
    return cold, warm


def whole_donor(cfg, params, base, C, name, tie, kv_quant, rng):
    """25, a whole-join donor: a prompt of exactly one chunk (128 tokens)
    joins whole (K1) and is stored; 6 prompts extending it by 1..64
    tokens hit it. Their tokens against a cold engine, by phase 24's
    rule: a parting only at a near-tie of the cold run."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    tag = " int8 KV" if kv_quant else ""
    donor = rng.integers(0, cfg.vocab_size, C)
    prompts = [donor] + [np.concatenate([donor, rng.integers(
        0, cfg.vocab_size, int(rng.integers(1, 65)))]) for _ in range(6)]
    outs = {}
    for on in (False, True):
        eng = ServingEngine(cfg, params, EngineConfig(**base,
                                                      prefix_cache=on),
                            device="cuda")
        try:
            res, win = one_by_one(eng, prompts)
        finally:
            eng.close()
        outs[on] = [r.tokens for r in res]
    hits = win["lanes"][base["pad_buckets"][0]]["prefix_hits"]
    parted = []
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        if np.array_equal(a, b):
            continue
        d = int(np.argmin(a == b))
        with torch.inference_mode():
            margin = choice_margin(
                stream_logits(cfg, params, prompts[i], 512, b, d,
                              kv_quant=kv_quant, chunk=C, decode_width=4),
                SamplingParams(), len(prompts[i]) + d, b[d])
        parted.append((i, d, margin))
    print(f"prefix{tag}, a whole-join donor of {C} tokens: {hits} hits; "
          f"{len(prompts) - len(parted)} of {len(prompts)} token-identical "
          f"to cold; partings (request, step, margin) {parted} (near-tie "
          f"threshold {tie:.4e}) [{name}]", flush=True)
    if hits != 6 or any(m >= tie for *_, m in parted):
        raise AssertionError(f"prefix{tag} whole-join donor: {hits} hits, "
                             f"partings {parted}")


# ------------------------------------------------- the lab's decoder cells
LAB_PROFILES = ("AWS/C", "AWS/G", "GCP/C", "Azure/A")


def phase_lab_decoder(kernels, name):
    """26. The deploy lab's decoder scenarios on the card:
    ``repro_torch.launch.experiment.main`` with ``--staggered
    --prefix-cache --quant --spec-decode --arch qwen2-0.5b`` at the CLI's
    defaults (spec_k 4, self-drafted)
    (buckets 16/32, max_batch 4, chunks of 8, 8 requests 50 ms apart, 8
    new tokens) over LAB_PROFILES, four of the 21 paper profiles (every
    profile runs the same engines and differs only in its prices; all 21
    took about 90 s until phase 34 needed the time), full-width
    Qwen2-0.5B. Every
    record must carry JAX's fields, its cells finite, its decoder window
    compile-clean with 64 tokens; the drift report's ``prefix_cache``,
    ``quant`` and ``spec_decode`` cells (one per profile) are printed,
    the last for AWS/C, AWS/G and Azure/A (all four in the drift report).
    K2's S > 1 launches are counted over the measured windows (from each
    ``engine.window()`` to the next, ``window_launches``) and must be
    one a layer for each round the ``_sd`` windows report. Returns
    (K1..K5 launches, K2's S > 1 launches in the windows)."""
    from repro_torch.deploy.runner import RECORD_FIELDS, read_jsonl
    from repro_torch.launch import experiment
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "lab"
    t0 = time.perf_counter()
    reset_launches(kernels)
    with window_launches(lambda: kernels[1].verify_launches) as in_windows:
        experiment.main(["--staggered", "--prefix-cache", "--quant",
                         "--spec-decode", "--arch", "qwen2-0.5b",
                         "--profiles", *LAB_PROFILES,
                         "--out-dir", str(out_dir)])
    launches = tuple(fn.launches for fn in kernels)
    verify = in_windows[0]
    rows = read_jsonl(str(out_dir / experiment.GRID_FILE))
    with open(out_dir / experiment.DRIFT_FILE) as f:
        drift = json.load(f)
    names = ["ladder", "staggered", "staggered_shared",
             "staggered_shared_pc", "staggered_quant", "staggered_quant_q8",
             "staggered_spec", "staggered_spec_sd"]
    n_prof = len(LAB_PROFILES)
    if [r["scenario"]["name"] for r in rows] != [
            n for n in names for _ in range(n_prof)]:
        raise AssertionError("lab records: not one per (scenario, profile)")
    for r in rows:
        if set(r) != set(RECORD_FIELDS):
            raise AssertionError(f"record fields {sorted(r)}")
        if r["scenario"]["mode"] != "decoder":
            continue
        c, win = r["cells"][0], r["engine_window"]
        if (c["n_requests"] != 8 or c["total_tokens"] != 64
                or win["jit_compiles"] != 0 or not all(
                    np.isfinite(c[k]) and c[k] > 0 for k in
                    ("latency_p50_s", "tokens_per_s", "requests_per_s"))):
            raise AssertionError(f"lab cell {r['scenario']['name']} "
                                 f"{r['profile']['machine']}: {c}, "
                                 f"{win['jit_compiles']} captures")
    pc, q8, sd = drift["prefix_cache"], drift["quant"], drift["spec_decode"]
    if not len(pc) == len(q8) == len(sd) == n_prof:
        raise AssertionError(f"{len(pc)} prefix-cache, {len(q8)} quant and "
                             f"{len(sd)} spec cells for {n_prof} profiles")
    from repro_torch.configs import get_config
    n_layers = get_config("qwen2-0.5b").n_layers
    sd_rounds = sum(l_["spec_rounds"] for r in rows
                    if r["scenario"]["name"] == "staggered_spec_sd"
                    for l_ in r["engine_window"]["lanes"].values())
    if not sd_rounds:
        raise AssertionError("the _sd runs ran no speculative round")
    if verify != n_layers * sd_rounds:
        raise AssertionError(f"lab: K2 counted {verify} S > 1 launches in "
                             f"the windows, not {n_layers} layers x "
                             f"{sd_rounds} rounds")
    hits = sum(l["prefix_hits"] for r in rows
               if r["scenario"]["name"] == "staggered_shared_pc"
               for l in r["engine_window"]["lanes"].values())
    print(f"lab decoder scenarios: {len(rows)} records, prefix hits "
          f"{hits} over the _pc runs, K1..K5 launches {launches} (warm-up "
          f"included), K2's S > 1 launches {verify} in the windows "
          f"({kernels[1].verify_launches} in all) for {sd_rounds} rounds; "
          f"{time.perf_counter() - t0:.1f} s [{name}]", flush=True)
    for a, b in zip(pc, q8):
        print(f"  {a['profile']}: $/1M requests shared-prompt "
              f"{a['usd_per_1m_requests_off']:.4f} -> "
              f"{a['usd_per_1m_requests_pc']:.4f} with the prefix cache "
              f"(prefill {a['prefill_mean_off_s'] * 1e3:.3f} -> "
              f"{a['prefill_mean_pc_s'] * 1e3:.3f} ms); float "
              f"{b['usd_per_1m_requests_off']:.4f} -> int8 "
              f"{b['usd_per_1m_requests_q8']:.4f}, footprint "
              f"{b['footprint_bytes_off']:,} -> {b['footprint_bytes_q8']:,} "
              f"B", flush=True)
    for c in sd:
        if c["profile"] in ("AWS/C", "AWS/G", "Azure/A"):
            print(f"  {c['profile']}: spec decoding $/1M requests "
                  f"{c['usd_per_1m_requests_off']:.4f} -> "
                  f"{c['usd_per_1m_requests_sd']:.4f} "
                  f"({c['usd_drop_pct']:+.1f}%), tokens/s "
                  f"{c['tokens_per_s_off']:.1f} -> "
                  f"{c['tokens_per_s_sd']:.1f}, accept rate "
                  f"{c['accept_rate']:.4f} [{name}]", flush=True)
    return launches, verify


@contextlib.contextmanager
def window_launches(counter):
    """Yield a one-item list that, by the end of the block, holds the sum
    of ``counter()``'s growth over the serving windows: from each
    ``ServingEngine.window()`` call to the next on the same engine. The
    lab's runner calls it once before each run (a reset) and once after
    (the record), so warm-up before an engine's first window is left
    out."""
    import weakref

    from repro_torch.serving import ServingEngine
    window, total = ServingEngine.window, [0]
    last = weakref.WeakKeyDictionary()     # engine -> counter at its call

    def counted(self):
        now = counter()
        if self in last:
            total[0] += now - last[self]
        last[self] = now
        return window(self)
    ServingEngine.window = counted
    try:
        yield total
    finally:
        ServingEngine.window = window


# ------------------------------------------- 27. speculative decoding
SPEC_K = 4                      # draft tokens a round (the engine default)
SPEC_WIDTHS = (1, 2, 4, 8, 16)  # the width tiers of max_batch 16
SPEC_RINGS = (148, 532)         # a spec engine's ring at buckets 128, 512
SPEC_BUCKET = 112               # 27 (b): 112 + 16 = 128 slots, whole tiles


def spec_ring(rng, B, S, L, plain_len):
    """(q_pos (B, S), kv_pos (B, L)) int32 of a verify chunk right after
    its write in a spec engine's ring of L slots: row b holds positions
    0..n_b + S - 1 (no wrap), the slots from ``plain_len`` on (the spec
    headroom) positions past every query, the rest -1; query s sits at
    n_b + s <= plain_len - 2, a position a plain engine's ring of
    ``plain_len`` slots also holds."""
    kv_pos = np.full((B, L), -1, np.int32)
    q_pos = np.empty((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(1, plain_len - S))
        kv_pos[b, :n + S] = np.arange(n + S)
        q_pos[b] = n + np.arange(S)
    kv_pos[:, plain_len:] = np.arange(plain_len, L)
    return q_pos, kv_pos


def verify_bound_ms(q_pos, kv_pos, Hq, Hkv, D, q_item, kv_item):
    """Least time for one verify-attention call on these inputs: the
    slots live for any query of a row read once in the stored type, q
    read and the output written once, the positions read once, over HBM;
    or 4 flops per live (query, slot) pair, head dim and query head at
    the bf16 tensor-core peak."""
    live = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                        <= q_pos[:, :, None])
    n_any = int(live.any(1).sum())
    n_pairs = int(live.sum())
    B, S = q_pos.shape
    nbytes = (2 * n_any * Hkv * D * kv_item + 2 * B * S * Hq * D * q_item
              + kv_pos.size * 4 + q_pos.size * 4)
    flops = 4 * n_pairs * Hq * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_spec_kernel(da, name):
    """27 (a). K2 with S > 1 queries a row (bf16 q, Qwen2's 14 / 2 heads
    of 64) at widths ``SPEC_WIDTHS`` x S = 2..5 in rings of ``SPEC_RINGS``
    slots, over an fp32 ring and over an int8 ring dequantized to bf16,
    at the plain engine's partition (``ops.decode_partition``): against its
    plain version within ``BF16_TOL``, its visits against
    ``live_tile_counts``; against S single-query launches over the same
    ring, bit for bit; at S = 1, the decode route (``ops.gqa_decode`` at
    ``width``) against the same launch at its partition, bit for bit (the
    two routes pick one partition; that S = 1 is the single-query
    kernel's code path rests on the source); and against the same queries over
    the ring cut to the plain engine's length at that length's own
    partition, bit for bit (the trailing splits of the headroom add exact
    zeros). Then timed at the verify shape (width 16, S 5, 532 slots,
    fp32 ring), K2-S by ``graph_ms`` as every K2 row, beside its plain
    version, SDPA on the same mask and its bound. Returns (max error,
    settings checked, (ms, plain ms, sdpa ms, bound ms, bound by))."""
    from repro_torch.kernels import ops
    from repro_torch.quant.kv import dequantize_kv, quantize_kv
    rng = np.random.default_rng(27)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    Hq, Hkv, D = DECODE_MAIN["Hq"], DECODE_MAIN["Hkv"], DECODE_MAIN["D"]
    bf16 = torch.bfloat16
    worst, checked = 0.0, 0
    t0 = time.perf_counter()
    for L in SPEC_RINGS:
        plain_len = L - SPEC_K
        n_split, per = ops.decode_partition(CONT_BATCH, Hkv, plain_len)
        for cache in ("fp32", "int8 -> bf16"):
            for B in SPEC_WIDTHS:
                for S in (2, 3, 4, 5):
                    q = randn(gen, B, S, Hq, D, dtype=bf16)
                    k, v = (randn(gen, B, L, Hkv, D, dtype=torch.float32)
                            for _ in range(2))
                    if cache != "fp32":
                        k, v = (dequantize_kv(*quantize_kv(t), bf16)
                                for t in (k, v))
                    q_pos, kv_pos = spec_ring(rng, B, S, L, plain_len)
                    qp = torch.from_numpy(q_pos).cuda()
                    kvp = torch.from_numpy(kv_pos).cuda()
                    part = dict(n_split=n_split, per_split=per)
                    out, visits = da.decode_attention(
                        q, k, v, qp, kvp, return_visits=True, **part)
                    ref, ref_vis = da.decode_attention_plain(
                        q.float(), k.to(bf16).float(), v.to(bf16).float(),
                        qp, kvp, **part)
                    err = (out.float() - ref).abs().max().item()
                    want = da.live_tile_counts(q_pos, kv_pos, n_kv_heads=Hkv)
                    ones = torch.cat([da.decode_attention(
                        q[:, s:s + 1], k, v, qp[:, s], kvp, **part)
                        for s in range(S)], 1)
                    short = da.decode_attention(
                        q, k[:, :plain_len].contiguous(),
                        v[:, :plain_len].contiguous(), qp,
                        kvp[:, :plain_len].contiguous(), **part)
                    s1 = torch.equal(
                        da.decode_attention(q[:, :1], k, v, qp[:, :1], kvp,
                                            n_split=da.decode_splits(
                                                CONT_BATCH, Hkv, L)[0]),
                        ops.gqa_decode(q[:, :1], k, v, qp[:, 0], kvp,
                                       width=CONT_BATCH))
                    torch.cuda.synchronize()
                    ok = {"plain": torch.allclose(out.float(), ref,
                                                  atol=BF16_TOL,
                                                  rtol=BF16_TOL),
                          "visits": bool((visits.cpu().numpy() == want)
                                         .all()
                                         and (visits == ref_vis).all()),
                          "single-query launches": torch.equal(out, ones),
                          "gqa_decode partition": s1,
                          "plain-length ring": torch.equal(out, short)}
                    worst = max(worst, err)
                    checked += 1
                    if not all(ok.values()):
                        raise AssertionError(
                            f"K2-S width {B} S {S} L {L} {cache}: "
                            f"{[k_ for k_, v_ in ok.items() if not v_]} "
                            f"failed (max_abs_err {err:.3e})")
        print(f"K2-S L={L} (plain ring {plain_len}, partition {n_split} x "
              f"{per} tiles + trailing): widths {SPEC_WIDTHS} x S 2..5, "
              f"fp32 and int8 -> bf16 rings: within {BF16_TOL} of the plain "
              f"version (worst so far {worst:.3e}), visits exact, equal to "
              f"S single-query launches and to the plain-length ring bit "
              f"for bit; at S = 1 gqa_decode picks the same partition",
              flush=True)
    # timed at the verify shape
    B, S, L = CONT_BATCH, SPEC_K + 1, SPEC_RINGS[-1]
    n_split, per = ops.decode_partition(CONT_BATCH, Hkv, L - SPEC_K)
    q = randn(gen, B, S, Hq, D, dtype=bf16)
    k, v = (randn(gen, B, L, Hkv, D, dtype=torch.float32) for _ in range(2))
    q_pos, kv_pos = spec_ring(rng, B, S, L, L - SPEC_K)
    q_pos[:] = (L - SPEC_K - S - 1) + np.arange(S)     # every row full
    kv_pos[:, :L - SPEC_K] = np.arange(L - SPEC_K)
    qp = torch.from_numpy(q_pos).cuda()
    kvp = torch.from_numpy(kv_pos).cuda()

    def k2s():
        return da.decode_attention(q, k, v, qp, kvp, n_split=n_split,
                                   per_split=per)
    t_k = device_ms(k2s, launches=2)
    t_ev = cuda_ms(k2s)
    t_g = graph_ms(k2s)
    t_p = device_ms(lambda: da.decode_attention_plain(
        q, k, v, qp, kvp, n_split=n_split, per_split=per), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)                              # (B, Hq, S, D)
    kt = k.to(bf16).transpose(1, 2)                     # cast beforehand
    vt = v.to(bf16).transpose(1, 2)
    mask = ((kvp[:, None, :] >= 0)
            & (kvp[:, None, :] <= qp[:, :, None]))[:, None]
    t_s = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                 enable_gqa=True))
    bound, by = verify_bound_ms(q_pos, kv_pos, Hq, Hkv, D, 2, 4)
    print(f"timing K2-S verify shape B={B} S={S} L={L} Hq={Hq} Hkv={Hkv} "
          f"D={D} bf16 q fp32 ring, grid {B * S * Hkv} x {n_split} splits "
          f"and a merge: kernel over a captured graph of 20 calls "
          f"{t_g:.4f} ms, by the profiler (both launches) {fmt_ms(t_k)}, "
          f"by events over back-to-back calls {t_ev:.4f} ms; device time: "
          f"plain {fmt_ms(t_p)}, sdpa {fmt_ms(t_s)}; bound {bound:.5f} ms "
          f"({by}); {checked} settings in {time.perf_counter() - t0:.1f} s "
          f"[{name}]", flush=True)
    return worst, checked, (t_g, t_p, t_s, bound, by)


def unblocked_parting(cfg, params, label):
    """27 (b): the first M (rows) at which the rows of an unblocked
    product part from the same rows at a decode step's M (width 16): a
    verify chunk of width x (spec_k + 1) rows would run there, which is
    why verify runs its products per position. Returns {product: M or
    None (none up to 16 x 5)}."""
    from repro_torch.models.layers import head_weight, lm_head_apply
    from repro_torch.quant.weights import qeinsum
    gen = torch.Generator(device="cuda")
    gen.manual_seed(271)
    blk = params["blocks"]["blk0"]
    a, m = blk["attn"], blk["mlp"]
    first = lambda t: t[0] if not isinstance(t, dict) else {    # noqa: E731
        k_: v_[0] for k_, v_ in t.items()}
    d, hd, hq = cfg.d_model, cfg.head_dim_, cfg.n_heads
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    prods = {
        "wq": (d, lambda x: qeinsum("bsd,dhk->bshk", x, first(a["wq"]))),
        "wk": (d, lambda x: qeinsum("bsd,dhk->bshk", x, first(a["wk"]))),
        "wo": (hq * hd, lambda x: qeinsum(
            "bshk,hkd->bsd", x.reshape(x.shape[0], 1, hq, hd),
            first(a["wo"]))),
        "w_in": (d, lambda x: qeinsum("bsd,dcf->bscf", x, first(m["w_in"]))),
        "w_down": (cfg.d_ff, lambda x: qeinsum(
            "bsf,fd->bsd", x, first(m["w_down"]))
            if isinstance(m["w_down"], dict) else x @ m["w_down"][0]),
        "head": (d, lambda x: lm_head_apply(cfg, None, x, w=w))}
    top = CONT_BATCH * (SPEC_K + 1)
    out = {}
    with torch.inference_mode():
        for pname, (K, fn) in prods.items():
            x = randn(gen, top, 1, K, dtype=cfg.torch_dtype)
            ref = fn(x[:CONT_BATCH].contiguous())
            out[pname] = next((M for M in range(CONT_BATCH + 1, top + 1)
                               if not torch.equal(
                                   fn(x[:M].contiguous())[:CONT_BATCH],
                                   ref)), None)
    print(f"27 (b) {label}: first M at which an unblocked product's rows "
          f"part from the same rows at M = {CONT_BATCH} (checked up to "
          f"{top}): " + ", ".join(f"{k_} {'none' if v_ is None else v_}"
                                  for k_, v_ in out.items()), flush=True)
    return out


def phase_spec_model(cfg, params, qparams, name):
    """27 (b). Qwen2-0.5B at full width: ``verify_chunk`` logits against
    k + 1 ``decode_step`` logits, bit for bit, at every width tier 1-16
    and spec_k 1-4, float and int8 weights and KV. One width-16 prefill
    of prompts in bucket ``SPEC_BUCKET`` fills both rings: the plain
    engine's of ``SPEC_BUCKET + NEW_TOKENS`` slots (a whole number of
    K2 tiles, so the spec headroom adds a tile) keeps the padded tail, as
    a plain engine's slot does; the spec engine's, ``spec_k`` slots
    longer, is cut at each prompt, as its install cuts it. Then two
    rounds per setting: the chunk [t0, d1..dk] (random tokens) as k + 1
    decode steps in the plain ring against one verify chunk in the spec
    ring (K2 at the plain ring's partition at width 16,
    ``ops.decode_partition``), the spec ring rolled back to a random
    commit boundary, the next chunk from there. Also
    ``unblocked_parting``."""
    from repro_torch.kernels import ops
    from repro_torch.models import (decode_step, forward, make_caches,
                                    verify_chunk)
    from repro_torch.models.layers import head_weight
    rng = np.random.default_rng(272)
    Lp = SPEC_BUCKET + NEW_TOKENS
    part = ops.decode_partition(CONT_BATCH, cfg.n_kv_heads, Lp)
    t0 = time.perf_counter()
    n_checked = 0
    for label, prm, kvq in (("float", params, None),
                            ("int8 W+KV", qparams, "int8")):
        unblocked_parting(cfg, prm, label)
        w = head_weight(cfg, prm.get("lm_head"), prm["embed"])
        _, toks, lens = prompt_batch(rng, CONT_BATCH, 8, SPEC_BUCKET - 8,
                                     SPEC_BUCKET, cfg.vocab_size)
        tt = torch.from_numpy(toks).cuda()
        with torch.inference_mode():
            full = make_caches(cfg, CONT_BATCH, Lp + SPEC_K,
                               dtype=torch.float32, kv_quant=kvq,
                               device="cuda")
            forward(cfg, prm, tokens=tt, caches=full, return_hidden=True)
            for width in SPEC_WIDTHS:
                for k in range(1, SPEC_K + 1):
                    Ls = Lp + k
                    plain = {b: {k_: (t[:, :width, :Lp] if t.dim() > 2
                                      else t[:, :width]).clone()
                                 for k_, t in blk.items()}
                             for b, blk in full.items()}
                    spec = {b: {k_: (t[:, :width, :Ls] if t.dim() > 2
                                     else t[:, :width]).clone()
                                for k_, t in blk.items()}
                            for b, blk in full.items()}
                    cpos = lens[:width].astype(np.int32).copy()
                    for blk in spec.values():       # the install's cut
                        bnd = torch.from_numpy(cpos).cuda()
                        blk["pos"][blk["pos"] >= bnd[None, :, None]] = -1
                        blk["len"].copy_(torch.minimum(blk["len"],
                                                       bnd[None, :]))
                    for _ in range(2):
                        chunk = torch.from_numpy(rng.integers(
                            0, cfg.vocab_size, (width, k + 1))).cuda()
                        pos = torch.from_numpy(cpos[:, None] + np.arange(
                            k + 1, dtype=np.int32)).cuda()
                        want = torch.cat([decode_step(
                            cfg, prm, chunk[:, s:s + 1], pos[:, s:s + 1],
                            plain, head_w=w, decode_width=CONT_BATCH)
                            for s in range(k + 1)], 1)
                        got = verify_chunk(cfg, prm, chunk, pos, spec,
                                           head_w=w, partition=part,
                                           decode_width=CONT_BATCH)
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"27 (b) {label}: verify logits differ from "
                                f"decode-step logits at width {width}, "
                                f"spec_k {k}: max "
                                f"{(got - want).abs().max().item():.3e}")
                        n_checked += 1
                        c = rng.integers(1, k + 2, width).astype(np.int32)
                        cpos = cpos + c                 # commit, roll back
                        bnd = torch.from_numpy(cpos).cuda()
                        for blk in spec.values():
                            blk["pos"][blk["pos"] >= bnd[None, :, None]] = -1
                            blk["len"].copy_(torch.minimum(
                                blk["len"], bnd[None, :]))
            del full, plain, spec
        print(f"27 (b) {label}: verify_chunk logits equal to spec_k + 1 "
              f"decode_step logits bit for bit at widths {SPEC_WIDTHS} x "
              f"spec_k 1..{SPEC_K}, two rounds each (verify in a ring of "
              f"{Lp} + spec_k slots at the {Lp}-slot ring's partition, "
              f"decode in the {Lp}-slot ring) [{name}]", flush=True)
    print(f"27 (b): {n_checked} rounds checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return n_checked


def phase_spec_engine(cfg, params, kernels, name, plain, *, quant=None):
    """27 (c) and (e). Phase 23's load (48 requests over buckets
    32/64/128, every other one sampled, max_batch 16, 2 ms apart) through
    the continuous decoder with ``spec_decode`` (``SPEC_K`` proposals a
    round, self-drafted as the lab drafts: ``experiment.self_draft``),
    every program captured by
    ``warmup(sampled=True)``: every request's tokens equal to ``plain``
    (phase 23's streams of the same load, spec off), exactly; the
    measured window compile-clean; K1/K2/K3 launches against the
    window's joins and rounds; a captured round (bucket 128, width 16)
    against the same round uncaptured, its tokens and views bit for bit;
    the accept rate, rounds and tokens/s; then a captured round at width
    1 and 16, wall, kernels and device idle share (beside phase 23's
    4-step segments). ``quant="int8"`` serves int8 weights and KV.
    Returns (K1..K5 launches, K2's S > 1 launches, as counted in the
    window, {width: reading})."""
    from repro_torch.launch.experiment import self_draft
    from repro_torch.serving import EngineConfig, ServingEngine
    tag = " int8 W+KV" if quant else ""
    load = cont_load(cfg, 23)
    dcfg, dparams = self_draft(cfg, params)
    t_phase = time.perf_counter()
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="decoder", max_batch=CONT_BATCH,
        pad_buckets=tuple(b for _, _, b in CONT_SPANS),
        max_new_tokens=NEW_TOKENS, weight_quant=quant, kv_quant=quant,
        spec_decode=True, spec_k=SPEC_K), device="cuda",
        draft=(dcfg, dparams))
    try:
        t0 = time.perf_counter()
        eng.warmup(sampled=True)
        t_warm = time.perf_counter() - t0
        compiles = eng.metrics()["jit_compiles"]
        eng.window()
        reset_launches(kernels)
        results, wall = serve_load(eng, load, CONT_GAP_S)
        launches = tuple(fn.launches for fn in kernels)
        verify = kernels[1].verify_launches
        win = eng.window()
        rounds = win["decode_segments"]
        lanes = win["lanes"].values()
        prop = sum(l_["spec_proposed"] for l_ in lanes)
        acc = sum(l_["spec_accepted"] for l_ in lanes)
        n_tok = sum(len(r.tokens) for r in results)
        print(f"spec{tag}: warmup captured {compiles} programs in "
              f"{t_warm:.1f} s; 48 requests in {wall:.3f} s, {n_tok} tokens "
              f"= {n_tok / wall:.1f} tokens/s; window: jit_compiles "
              f"{win['jit_compiles']}, prefill batches "
              f"{win['prefill_batches']}, rounds {rounds} "
              f"({sum(l_['spec_rounds'] for l_ in lanes)} by the lanes), "
              f"proposed {prop}, accepted {acc} (accept rate "
              f"{acc / max(prop, 1):.4f}), {n_tok / max(rounds, 1):.2f} "
              f"tokens a round; K1..K5 launches {launches}, K2's S > 1 "
              f"launches {verify} [{name}]", flush=True)
        if win["jit_compiles"] != 0:
            raise AssertionError(f"spec{tag}: the measured window built "
                                 f"{win['jit_compiles']} programs")
        L, Ld = cfg.n_layers, dcfg.n_layers
        joins = win["prefill_batches"]
        if verify != L * rounds:
            raise AssertionError(f"spec{tag}: K2 counted {verify} S > 1 "
                                 f"launches, not {L} layers x {rounds} "
                                 f"rounds")
        want = ((L + Ld) * joins, verify + Ld * (SPEC_K + 1) * rounds,
                6 * L * (joins + (SPEC_K + 1) * rounds) if quant else 0,
                0, 0)
        if launches != want:
            raise AssertionError(f"spec{tag} launches K1..K5 {launches} != "
                                 f"{want}")
        streams = [r.tokens for r in results]
        same = [np.array_equal(a, b) for a, b in zip(streams, plain)]
        print(f"spec{tag} vs spec off (phase 23's streams of the same "
              f"load): {sum(same)} of {len(same)} requests token-identical",
              flush=True)
        if not all(same):
            raise AssertionError(f"spec{tag}: {same.count(False)} requests "
                                 f"differ from plain decoding")
        # a captured round against the same round uncaptured
        bucket, width = 128, CONT_BATCH
        tok = np.full((width, 1), 7, np.int32)
        pos = (40 + np.arange(width, dtype=np.int32))[:, None]
        idx = list(range(width))
        cap = eng._spec_round_call(bucket, width, tok, pos, idx)
        views = eng._spec_view(bucket, width)
        cap_views = [{b: {k_: t.clone() for k_, t in blk.items()}
                      for b, blk in v.items()} for v in views]
        fn = eng._spec_round_fn(bucket, width)
        with torch.inference_mode():
            direct = fn(torch.from_numpy(tok).cuda(),
                        torch.from_numpy(pos).cuda(),
                        torch.arange(width, device="cuda"), None, None,
                        None).cpu().numpy()
        same_views = all(torch.equal(a[b][k_], t)
                         for a, v in zip(cap_views, views)
                         for b, blk in v.items() for k_, t in blk.items())
        same_toks = np.array_equal(np.concatenate(cap, 1), direct)
        print(f"spec{tag}: captured round (bucket {bucket}, width {width}) "
              f"vs the same round uncaptured: tokens "
              f"{'equal' if same_toks else 'DIFFER'}, views "
              f"{'equal' if same_views else 'DIFFER'}", flush=True)
        if not (same_toks and same_views):
            raise AssertionError(f"spec{tag}: captured round differs")
        readings = {}
        for w in (1, width):
            readings[w] = program_reading(lambda: eng._spec_round_call(
                bucket, w, tok[:w], pos[:w], idx[:w]), n_wall=5)
            print(f"spec{tag} round bucket {bucket} width {w} (spec_k "
                  f"{SPEC_K}, captured): {fmt_reading(readings[w])} "
                  f"[{name}]", flush=True)
    finally:
        eng.close()
    print(f"spec{tag}: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, verify, readings


# ------------------------------------------------------ 28. training
TRAIN_SHAPE = dict(B=8, S=512)     # Qwen2-0.5B's training batch
TRAIN_STEPS = 20
GECTOR_TRAIN = dict(B=32, S=128, steps=50)
HYBRID_TRAIN = dict(B=2, S=512)    # RecurrentGemma-9B, one pattern triple
SPEC_TRAIN_STEPS = 60              # benchmarks/run.py bench_spec_decode
# Against fp32 plain-attention gradients, the bf16 gradients through the
# kernels may be at most this much further off than the bf16 gradients
# through plain attention (the global relative error and the mean of the
# leaves' relative errors), as phases 3 and 7 gate hidden states and
# logits.
GRAD_ERR_FACTOR = 1.5
# K1's backward before its tensor-core design (the CUDA-core kernel), by
# graph_ms on an "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md section 6):
# printed in phase 28 (c)'s log beside this run's times, not measured
# here, and kept out of the kernels line
K1_BWD_WAS_MS = {"qwen2 train": 2.0075, "encoder": 0.5441}
# a bf16 dK/dV launch at cluster c against cluster 1: one bf16 rounding of
# the value, and the fp32 sums' order in a small part of the largest
CLUSTER_RTOL, CLUSTER_ATOL = 2 ** -7, 2 ** -16
# launches of one bf16 K1 backward: dQ (with delta), then dK/dV
K1_BWD_BF16_LAUNCHES = 2


def bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, itemsize, causal=False):
    """Least time for one attention backward: q, k, v, out, dout and the
    fp32 lse read once and dq, dk, dv written once over HBM, or its five
    products of the forward's size (S, dP, dV, dK, dQ) at the peak for the
    inputs' type (the bf16 tensor cores, or fp32 outside them), whichever
    is larger."""
    nbytes = itemsize * D * (4 * B * Sq * Hq + 4 * B * Skv * Hkv) + \
        4 * B * Hq * Sq
    pairs = Sq * Skv if not causal else Sq * (Sq + 1) // 2
    flops = 10 * B * Hq * pairs * D
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scan_bwd_bound_ms(B, S, W):
    """Least time for one K5 backward: a, h and dh read once, da and db
    written once (fp32), against its 3 flops an element."""
    t_bytes = 5 * B * S * W * 4 / HBM_BYTES_PER_S
    t_ops = 3 * B * S * W / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_train_settings(attn_block_sizes):
    """K1's backward at the training shapes phase 28 runs, at the bq the
    model takes: Qwen2-0.5B (B=8 S=512, 14/2 heads of 64, causal,
    kv_len = S) and RecurrentGemma-9B's local layers (B=2 S=512, 16/1
    heads of 256, causal, window 2048)."""
    def bq(B, S, Hq, D):
        return attn_block_sizes("prefill", S, bh=B * Hq, head_dim=D,
                                dtype=torch.bfloat16)[0]
    B, S, h = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"], DECODE_MAIN
    Bh, Sh, y = HYBRID_TRAIN["B"], HYBRID_TRAIN["S"], HYBRID_MAIN
    return [  # (name, B, Sq, Skv, Hq, Hkv, D, bq, kwargs)
        ("qwen2 train", B, S, S, h["Hq"], h["Hkv"], h["D"],
         bq(B, S, h["Hq"], h["D"]), dict(causal=True, kv_len=S)),
        ("hybrid train", Bh, Sh, Sh, y["Hq"], y["Hkv"], y["D"],
         bq(Bh, Sh, y["Hq"], y["D"]),
         dict(causal=True, window=HYBRID_WINDOW, kv_len=Sh)),
    ]


def phase_k1_bwd_parity(fa, settings, main):
    """K1's backward against its plain version in each of ``settings``
    (phases 2 and 16's and the training shapes) at the kernel's tiles:
    fp32 at the setting's bq (32 where fp32 is not built for it), bf16 at
    every bq K1 is built for, fp32 within FP32_TOL absolute and bf16
    within BF16_TOL (absolute and relative), as phase 2 holds the
    forward; the q-side visits equal ``live_block_counts`` and the kv
    side's ``live_q_counts``, both the plain version's; the forward's
    log-sum-exps within FP32_TOL of the plain forward's; the forward's
    output with the log-sum-exps asked for bit-equal to the output
    without; a second call bit-equal to the first; and, where the bf16
    dK/dV kernel runs as a cluster (``bwd_cluster`` > 1), its dK and dV
    within CLUSTER_RTOL relative and CLUSTER_ATOL of the largest value of
    a launch with cluster 1 (only the split of the fp32 sum over the
    query heads differs). The plain backward gets the plain forward's out and lse,
    so that the two kernels together are held against the two plain
    versions. Returns (the bf16 error of ``main`` at its bq, settings
    checked)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    main_err, checked = None, 0
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, B, Sq, Skv, Hq, Hkv, D, bq0, kw in settings:
            q = randn(gen, B, Sq, Hq, D, dtype=dtype)
            k = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            v = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            do = randn(gen, B, Sq, Hq, D, dtype=dtype)
            bqs, bk = fa.TILES[(dtype, D)]
            fp32_bq = bq0 if bq0 in bqs else bqs[0]
            for bq in (bqs if dtype == torch.bfloat16 else (fp32_bq,)):
                no_lse_out = fa.flash_attention(q, k, v, bq=bq, **kw)
                out, lse = fa.flash_attention(q, k, v, bq=bq,
                                              return_lse=True, **kw)
                got = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq,
                                             bk=bk, return_visits=True, **kw)
                again = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq,
                                               bk=bk, **kw)
                c = fa.bwd_cluster(Hq, Hkv, dtype)
                one = fa.flash_attention_bwd(q, k, v, out, do, lse, bq=bq,
                                             bk=bk, cluster=1, **kw) \
                    if c > 1 else None
                torch.cuda.synchronize()
                p_out, _, p_lse = fa.flash_attention_plain(
                    q, k, v, bq=bq, bk=bk, return_lse=True, **kw)
                lse_err = (lse - p_lse).abs().max().item()
                want = fa.flash_attention_bwd_plain(
                    q.float(), k.float(), v.float(), p_out.float(),
                    do.float(), p_lse, bq=bq, bk=bk, **kw)
                errs = [(a.float() - b).abs().max().item()
                        for a, b in zip(got[:3], want[:3])]
                rtol = 0.0 if dtype == torch.float32 else tol
                close = all(torch.allclose(a.float(), b, atol=tol, rtol=rtol)
                            for a, b in zip(got[:3], want[:3]))
                same = all(torch.equal(a, b) for a, b in zip(got[:3], again))
                c1 = ""
                if one is not None:
                    close = close and all(torch.allclose(
                        a.float(), b.float(), rtol=CLUSTER_RTOL,
                        atol=CLUSTER_ATOL * b.float().abs().max().item())
                        for a, b in zip(got[1:3], one[1:3]))
                    c1 = (f", cluster {c} against 1: dk/dv max diff "
                          f"{max_diff(got[1], one[1]):.3e}/"
                          f"{max_diff(got[2], one[2]):.3e} (tol "
                          f"{CLUSTER_RTOL} relative)")
                geo = dict(causal=kw.get("causal", True),
                           window=kw.get("window"), bq=bq, bk=bk,
                           kv_len=kw.get("kv_len"))
                want_q = torch.tensor(fa.live_block_counts(Sq, Skv, **geo),
                                      dtype=torch.int32)
                want_kv = torch.tensor(fa.live_q_counts(Sq, Skv, **geo),
                                       dtype=torch.int32)
                vis_ok = (bool((got[3].cpu() == want_q).all())
                          and bool((got[4].cpu() == want_kv).all())
                          and torch.equal(got[3], want[3])
                          and torch.equal(got[4], want[4]))
                bits = torch.equal(out, no_lse_out)
                print(f"K1 bwd {name:28s} bq={bq:<3d} bk={bk:<3d} "
                      f"{str(dtype):15s} dq/dk/dv max_abs_err "
                      f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
                      f"{tol}), lse {lse_err:.3e} (tol {FP32_TOL}), visits "
                      f"{'ok' if vis_ok else 'WRONG'}, out with lse "
                      f"{'bit-equal' if bits else 'DIFFERS'}, two calls "
                      f"{'bit-equal' if same else 'DIFFER'}{c1}", flush=True)
                if not (close and vis_ok and bits and same and
                        lse_err <= FP32_TOL):
                    raise AssertionError(f"K1's backward or its lse "
                                         f"disagrees with the plain versions "
                                         f"(or lse changed out, or two "
                                         f"calls or clusters differ): {name} "
                                         f"{dtype} bq={bq}")
                checked += 1
                if name == main and dtype == torch.bfloat16 and bq == bq0:
                    main_err = max(errs)
    return main_err, checked


def phase_k5_bwd_parity(rs):
    """K5's backward against its plain version at phase 15's shapes:
    da and db within SCAN_TOL of their largest magnitude (the kernel's
    fused multiply-add rounds once where the plain version rounds twice);
    the identity channel's da (its h is 0) exactly 0. Returns (the error
    at SCAN_MAIN, settings checked)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(42)
    main_err, checked = None, 0
    for B, S, W in ((1, 1, 4096), (1, 37, 4096), SCAN_MAIN, (4, 300, 256),
                    (3, 100, 130)):
        a, b = scan_inputs(gen, B, S, W)
        h = rs.rglru_scan(a, b)
        dh = torch.randn(B, S, W, device="cuda", generator=gen)
        da, db = rs.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        pa, pb = rs.rglru_scan_bwd_plain(a, h, dh)
        err = max((da - pa).abs().max().item(), (db - pb).abs().max().item())
        mag = max(pa.abs().max().item(), pb.abs().max().item())
        zero = bool((da[:, :, W // 3] == 0).all())
        print(f"K5 bwd B={B:<3d} S={S:<4d} W={W:<5d} da/db max_abs_err "
              f"{err:.3e} of max {mag:.3e} (tol {SCAN_TOL} relative), "
              f"identity channel's da {'exact' if zero else 'WRONG'}",
              flush=True)
        if not (err <= SCAN_TOL * mag and zero):
            raise AssertionError(f"K5's backward disagrees with its plain "
                                 f"version: B={B} S={S} W={W}")
        if (B, S, W) == SCAN_MAIN:
            main_err = err
        checked += 1
    return main_err, checked


def k1_bwd_timing(fa, attn_block_sizes, gen, label, B, S, Hq, Hkv, D,
                  causal, window, name):
    """K1's backward at one shape by ``graph_ms`` beside its plain version,
    SDPA's backward and its bound (see ``phase_bwd_timings``). Returns
    ((ms, plain ms, library ms, bound ms, bound by), {cluster: ms})."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, B, S, Hq, D, dtype=torch.bfloat16)
    k, v = (randn(gen, B, S, Hkv, D, dtype=torch.bfloat16)
            for _ in range(2))
    do = randn(gen, B, S, Hq, D, dtype=torch.bfloat16)
    bq, bk = attn_block_sizes("prefill", S, bh=B * Hq, head_dim=D,
                              dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    cluster = fa.bwd_cluster(Hq, Hkv, torch.bfloat16)

    def bwd():
        return fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    t_k = graph_ms(bwd)
    t_prof = device_ms(bwd, launches=K1_BWD_BF16_LAUNCHES)
    t_ev = cuda_ms(bwd)
    t_p = graph_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, do, lse, **kw), iters=3, replays=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ot = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
    dot = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                   retain_graph=True)
    t_s = graph_ms(lib, stream=side)
    G = Hq // Hkv
    by_c = {str(c): graph_ms(lambda c=c: fa.flash_attention_bwd(
        q, k, v, out, do, lse, cluster=c, **kw))
        for c in range(1, min(G, fa.BWD_MAX_CLUSTER) + 1)
        if G % c == 0} if G > 1 else {}
    bound, by = bwd_bound_ms(B, S, S, Hq, Hkv, D, 2, causal=causal)
    was = (f"; the CUDA-core design's {K1_BWD_WAS_MS[label]} ms"
           if label in K1_BWD_WAS_MS else "")
    print(f"timing K1 bwd {label} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
          f"bf16 {'causal' if causal else 'non-causal'}"
          f"{f' window {window}' if window else ''} bq={bq} bk={bk} "
          f"cluster {cluster}, over a captured graph "
          f"({K1_BWD_BF16_LAUNCHES} launches a call): kernel "
          f"{t_k:.4f} ms ({t_k / t_s:.2f}x sdpa's backward{was}), "
          f"plain {t_p:.4f} ms, sdpa backward {t_s:.4f} "
          f"ms, bound {bound:.4f} ms ({by}); kernel by the profiler "
          f"{fmt_ms(t_prof)}, by events over back-to-back calls "
          f"{t_ev:.4f} ms; by cluster size "
          f"{ {c: round(t, 4) for c, t in by_c.items()} } [{name}]",
          flush=True)
    return (t_k, t_p, t_s, bound, by), by_c


def phase_bwd_timings(fa, rs, attn_block_sizes, name):
    """The backward kernels by ``graph_ms`` (one method for the kernel,
    its plain version and the library call, which cannot come back
    empty) beside their bounds: K1's at the encoder's shape (B=32 S=128
    12 heads of 64, non-causal), at Qwen2-0.5B's training shape (B=8
    S=512, 14 query heads over 2 kv heads of 64, causal) and at the
    hybrid's (B=2 S=512, 16 query heads over one kv head of 256, causal,
    window 2048), bf16, each at the tiles ``mha_prefill`` picks and the
    cluster ``bwd_cluster`` picks, beside SDPA's backward (the yardstick,
    called nowhere in the port: ``autograd.grad`` of its output, GQA as
    phase 5 calls it, its forward run on the stream the graph captures;
    the window spans the whole sequence, so causal is the same mask);
    K5's at SCAN_MAIN (no library call). The profiler's reading and
    events over back-to-back calls are printed beside, and, where the
    group has more than one query head, K1's backward at every cluster
    size that divides it (the evidence for ``bwd_cluster``'s choice).
    Returns {shape: (ms, plain ms, library ms, bound ms, bound by)} and
    {shape + " by cluster": {cluster: ms}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(43)
    rows = {}
    for label, B, S, Hq, Hkv, D, causal, window in (
            ("encoder", MAIN["B"], MAIN["S"], MAIN["H"], MAIN["H"],
             MAIN["D"], False, None),
            ("qwen2 train", TRAIN_SHAPE["B"], TRAIN_SHAPE["S"],
             DECODE_MAIN["Hq"], DECODE_MAIN["Hkv"], DECODE_MAIN["D"], True,
             None),
            ("hybrid train", HYBRID_TRAIN["B"], HYBRID_TRAIN["S"],
             HYBRID_MAIN["Hq"], HYBRID_MAIN["Hkv"], HYBRID_MAIN["D"], True,
             HYBRID_WINDOW)):
        rows[label], rows[f"{label} by cluster"] = k1_bwd_timing(
            fa, attn_block_sizes, gen, label, B, S, Hq, Hkv, D, causal,
            window, name)
    B, S, W = SCAN_MAIN
    a, b = scan_inputs(gen, B, S, W)
    h = rs.rglru_scan(a, b)
    dh = torch.randn(B, S, W, device="cuda", generator=gen)
    t_k = graph_ms(lambda: rs.rglru_scan_bwd(a, h, dh))
    t_prof = device_ms(lambda: rs.rglru_scan_bwd(a, h, dh))
    t_ev = cuda_ms(lambda: rs.rglru_scan_bwd(a, h, dh))
    t_p = graph_ms(lambda: rs.rglru_scan_bwd_plain(a, h, dh), iters=3,
                   replays=3, warmup=1)
    bound, by = scan_bwd_bound_ms(B, S, W)
    print(f"timing K5 bwd B={B} S={S} W={W} fp32, over a captured graph: "
          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library none, bound "
          f"{bound:.5f} ms ({by}); kernel by the profiler {fmt_ms(t_prof)}"
          f", by events {t_ev:.4f} ms [{name}]", flush=True)
    rows["scan"] = (t_k, t_p, None, bound, by)
    return rows


def grad_errors(grads, ref):
    """(||g - ref|| / ||ref|| over the whole tree, the mean over leaves of
    max|g - ref| / max|ref|)."""
    from repro_torch.training.tree import flatten
    g, r = flatten(grads), flatten(ref)
    num = den = 0.0
    per_leaf = []
    for key, want in r.items():
        d = g[key].float() - want
        num += float(torch.sum(d * d))
        den += float(torch.sum(want * want))
        per_leaf.append(float(d.abs().max()) /
                        max(float(want.abs().max()), 1e-30))
    return (num / max(den, 1e-30)) ** 0.5, sum(per_leaf) / len(per_leaf)


def gradient_gate(cfg, params, loss_of, label):
    """One batch's gradients through the kernels and through plain
    attention (and the plain scan), in bf16, both against the fp32
    plain-attention gradients of the same weights: finite, and the
    kernels' errors within GRAD_ERR_FACTOR of the plain path's.
    ``loss_of(cfg, plain)`` gives a loss function of the params."""
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves
    (loss32, _), g32 = value_and_grad(
        loss_of(dataclasses.replace(cfg, dtype="float32"), True),
        to_fp32(params))
    torch.cuda.empty_cache()
    errs = {}
    for plain in (False, True):
        (loss, _), g = value_and_grad(loss_of(cfg, plain), params)
        if not all(bool(torch.isfinite(x).all()) for x in leaves(g)):
            raise AssertionError(f"{label}: non-finite gradients "
                                 f"(plain={plain})")
        errs[plain] = grad_errors(g, g32)
        print(f"{label} {'plain' if plain else 'kernels'} bf16: loss "
              f"{float(loss):.5f} (fp32 {float(loss32):.5f}); gradients vs "
              f"fp32 plain attention: global relative error "
              f"{errs[plain][0]:.3e}, mean leaf max-relative error "
              f"{errs[plain][1]:.3e}", flush=True)
        del g
    del g32
    torch.cuda.empty_cache()
    (k_glob, k_leaf), (p_glob, p_leaf) = errs[False], errs[True]
    if k_glob > GRAD_ERR_FACTOR * p_glob or \
            k_leaf > GRAD_ERR_FACTOR * p_leaf:
        raise AssertionError(
            f"{label}: the kernels' gradients stray further from fp32 than "
            f"plain attention's: {k_glob:.3e} > {GRAD_ERR_FACTOR} x "
            f"{p_glob:.3e} or {k_leaf:.3e} > {GRAD_ERR_FACTOR} x "
            f"{p_leaf:.3e}")
    return errs


TRAIN_COUNTERS = ("K1", "K2", "K3", "K4", "K5", "K1 bwd", "K5 bwd")


def train_counts(kernels, bwd):
    return tuple(f.launches for f in kernels + bwd)


def check_step_counts(label, got, want):
    """``got`` a train_counts tuple; ``want`` {counter name: launches}
    (every other counter 0)."""
    named = dict(zip(TRAIN_COUNTERS, got))
    exp = {n: want.get(n, 0) for n in TRAIN_COUNTERS}
    if named != exp:
        raise AssertionError(f"{label}: launches {named}, want {exp}")


def train_step_reading(cfg, oc, params, opt, batch, walls, peak, label,
                       t_phase, name):
    """A train step's reading: its wall (the median of ``walls`` past the
    first two), one profiled step's kernels and the device's idle share
    of that step's own wall, K1's forward and backward kernels, and the
    step's parts by CUDA events (forward + CE without grad, forward +
    remat + backward, CE forward + backward, AdamW); ``peak`` printed
    beside. Returns (median step ms, profiled step ms, its kernels' ms,
    {part: ms})."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import forward
    from repro_torch.training import train_step
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import (chunked_ce, loss_fn,
                                                 value_and_grad)
    step_ms = float(np.median(walls[2:]))
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: loss_fn(cfg, params, batch), iters=3,
                        warmup=1)
        hid = forward(cfg, params, tokens=batch["tokens"][:, :-1],
                      return_hidden=True)
    labels = batch["tokens"][:, 1:]
    hid.requires_grad_()

    def ce():
        loss = chunked_ce(cfg, params, hid, labels, labels >= 0)
        return torch.autograd.grad(loss, hid)
    t_ce = cuda_ms(ce, iters=3, warmup=1)
    del hid
    t_vg = cuda_ms(lambda: value_and_grad(
        lambda p: loss_fn(cfg, p, batch), params), iters=3, warmup=1)
    (_, _), grads = value_and_grad(lambda p: loss_fn(cfg, p, batch), params)
    t_opt = cuda_ms(lambda: adamw_update(oc, params, grads, opt), iters=3,
                    warmup=1)
    del grads
    for _ in range(2):            # the profiler now and then sees no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(cfg, oc, params, opt, batch)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        rows = kernel_rows(prof, 1)
        if rows:
            break
    busy = sum(r[0] for r in rows) if rows else None
    k1f = [r for r in rows if "flash_fwd" in r[2]]
    k1b = [r for r in rows if "flash_bwd" in r[2]]
    print(f"{label}: wall {step_ms:.1f} ms (median of steps 2-"
          f"{len(walls) - 1}, no profiler); the profiled step: wall "
          f"{prof_ms:.1f} ms (profiler on), kernels {fmt_ms(busy)}, device "
          f"idle " + (
              "not measured" if busy is None else
              f"{max(0.0, 1 - busy / prof_ms):.1%}") +
          f" of its own wall; K1 forward ({sum(r[1] for r in k1f)} "
          f"launches) {sum(r[0] for r in k1f):.3f} ms, K1 backward "
          f"({sum(r[1] for r in k1b)}) {sum(r[0] for r in k1b):.3f} ms; by "
          f"events: forward + CE (no grad) {t_fwd:.1f} ms, forward + remat "
          f"+ backward {t_vg:.1f} ms, CE forward + backward {t_ce:.1f} ms, "
          f"AdamW {t_opt:.1f} ms; peak memory {peak:,} B; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)
    for ms, calls, key in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:8.4f} ms {ms / busy:6.1%} x{calls:<4d} {key[:90]}")
    return step_ms, prof_ms, busy, {"forward + CE": t_fwd,
                                    "forward + remat + backward": t_vg,
                                    "CE": t_ce, "AdamW": t_opt}


def phase_train_qwen2(kernels, bwd, name):
    """Phase 28 (d): Qwen2-0.5B at full width in bf16 (random weights from
    seed 0) on SyntheticLM batches of B=8 x 512 tokens: the gradient gate
    on the first batch, then TRAIN_STEPS ``train_step``s with remat, each
    launching K1 24 times forward, 24 in remat and 24 backward (and no
    other kernel); the loss falls, everything stays finite; step wall,
    a profiled step's kernels and the device's idle share of that step's
    own wall, a step's breakdown (profiler and events), peak memory.
    Returns (cfg, params, launches over the steps, (median step ms,
    profiled step ms, its kernels' ms))."""
    from repro_torch.configs import get_config
    from repro_torch.training import OptConfig, adamw_init, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import loss_fn
    from repro_torch.training.tree import leaves
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    params = qwen2_params(cfg, 0)
    B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, seed=0))
    batches = [{"tokens": torch.as_tensor(b["tokens"], device="cuda")}
               for b in data.batches(TRAIN_STEPS)]
    gradient_gate(cfg, params, lambda c, plain: (
        lambda p: loss_fn(c, p, batches[0], plain_attention=plain)),
        f"Qwen2-0.5B B={B} S={S}")
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    opt = adamw_init(params)
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    total = [0] * len(TRAIN_COUNTERS)
    for i, batch in enumerate(batches):
        reset_launches(kernels + bwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = train_step(cfg, oc, params, opt, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = train_counts(kernels, bwd)
        check_step_counts(f"Qwen2-0.5B train step {i}", counts,
                          {"K1": 2 * cfg.n_layers, "K1 bwd": cfg.n_layers})
        total = [a + b for a, b in zip(total, counts)]
        losses.append(loss)
        if i % 5 == 0 or i == TRAIN_STEPS - 1:
            print(f"Qwen2-0.5B train step {i:3d} loss {loss:.4f} gnorm "
                  f"{gn:.3f} wall {walls[-1]:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and all(bool(torch.isfinite(x).all()) for x in leaves(params))):
        raise AssertionError(f"Qwen2-0.5B training: loss did not fall or "
                             f"went non-finite: {losses}")
    reading = train_step_reading(
        cfg, oc, params, opt, batches[-1], walls, peak,
        f"Qwen2-0.5B train step B={B} S={S} bf16 remat", t_phase, name)
    return cfg, params, tuple(total), reading


def phase_train_gector(kernels, bwd, name):
    """Phase 28 (e): GECToR-base at full width in bf16 (random weights
    from seed 0), GECTOR_TRAIN["steps"] steps of ``gector_loss`` and
    ``adamw_update`` on the port's GECCorpus (train error rate 0.4, as
    examples/train_gector.py), B=32 x 128, non-causal K1: 12 launches
    forward and 12 backward a step, the loss falls; tag_acc printed.
    Returns (cfg, params, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.corpus import CorpusConfig, GECCorpus
    from repro_torch.core.gector import gector_loss, init_gector
    from repro_torch.training import OptConfig, adamw_init
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import value_and_grad
    t_phase = time.perf_counter()
    cfg = get_config("gector-base")
    corpus = GECCorpus(CorpusConfig(vocab_size=cfg.vocab_size,
                                    edit_words=256, error_rate=0.4, seed=0))
    params = init_gector(cfg, corpus.vocab, 0, device="cuda")
    n = GECTOR_TRAIN["steps"]
    oc = OptConfig(lr=5e-4, warmup_steps=5, total_steps=n,
                   weight_decay=0.01)
    opt = adamw_init(params)
    losses, accs, walls = [], [], []
    total = [0] * len(TRAIN_COUNTERS)
    for i, b in enumerate(corpus.batches(GECTOR_TRAIN["B"],
                                         GECTOR_TRAIN["S"], n)):
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
        reset_launches(kernels + bwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, m), g = value_and_grad(
            lambda p: gector_loss(cfg, p, batch), params)
        params, opt, _ = adamw_update(oc, params, g, opt)
        del g
        losses.append(float(loss))
        accs.append((float(m["tag_acc"]), float(m["edit_acc"])))
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = train_counts(kernels, bwd)
        check_step_counts(f"GECToR-base step {i}", counts,
                          {"K1": cfg.n_layers, "K1 bwd": cfg.n_layers})
        total = [a + c for a, c in zip(total, counts)]
        if i % 10 == 0 or i == n - 1:
            print(f"GECToR-base train step {i:3d} loss {losses[-1]:.4f} "
                  f"tag_acc {accs[-1][0]:.3f} edit_acc {accs[-1][1]:.3f}",
                  flush=True)
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"GECToR-base B={GECTOR_TRAIN['B']} S={GECTOR_TRAIN['S']} bf16: "
          f"loss {head:.4f} -> {tail:.4f} (means of the first and last 5 "
          f"steps), tag_acc {accs[0][0]:.3f} -> {accs[-1][0]:.3f}, step "
          f"wall {np.median(walls[2:]):.1f} ms (median); phase "
          f"{time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)
    if not (all(np.isfinite(losses)) and tail < head):
        raise AssertionError(f"GECToR-base training: loss did not fall: "
                             f"{losses}")
    return cfg, params, tuple(total)


def phase_train_hybrid(kernels, bwd, name):
    """Phase 28 (f): RecurrentGemma-9B at full width in bf16 (random
    weights from seed 0) with its pattern cut to one (rglru, rglru,
    attn_local) triple: 3 layers, 1.7 B parameters with the 256k fp32
    embedding. All 38 layers' params, grads and fp32 moments (~108 GB) do
    not fit one card, and one period (19 layers) is ~60 GB before
    activations. The gradient gate at B=2 x 512, then one ``train_step``
    with remat: K5 2 launches forward, 2 in remat and 2 backward, K1 at
    head dim 256 1, 1 and 1. Returns launches over the step."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig, adamw_init, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import loss_fn
    from repro_torch.training.tree import leaves
    t_phase = time.perf_counter()
    triple = ("rglru", "rglru", "attn_local")
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              pattern=triple, n_layers=len(triple))
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(x.numel() for x in leaves(params))
    B, S = HYBRID_TRAIN["B"], HYBRID_TRAIN["S"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, seed=0))
    batch = {"tokens": torch.as_tensor(next(data.batches(1))["tokens"],
                                       device="cuda")}
    gradient_gate(cfg, params, lambda c, plain: (
        lambda p: loss_fn(c, p, batch, plain_attention=plain)),
        f"RecurrentGemma-9B ({cfg.n_layers} layers) B={B} S={S}")
    oc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    opt = adamw_init(params)
    reset_launches(kernels + bwd)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = train_step(cfg, oc, params, opt, batch)
    loss = float(m["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    counts = train_counts(kernels, bwd)
    check_step_counts("RecurrentGemma-9B train step", counts,
                      {"K1": 2, "K1 bwd": 1, "K5": 4, "K5 bwd": 2})
    if not (np.isfinite(loss) and all(bool(torch.isfinite(x).all())
                                      for x in leaves(params))):
        raise AssertionError("RecurrentGemma-9B train step: non-finite")
    print(f"RecurrentGemma-9B train step, pattern cut to one triple "
          f"({cfg.n_layers} layers, {n_params:,} params), B={B} S={S} bf16 "
          f"remat: loss {loss:.4f} gnorm {float(m['grad_norm']):.3f}, wall "
          f"{wall:.1f} ms (first step), peak memory "
          f"{torch.cuda.max_memory_allocated():,} B; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)
    return counts


def phase_train_checkpoints(qcfg, qparams, gcfg, gparams, name):
    """Phase 28 (g): (d)'s and (e)'s trained trees saved and restored
    (``training.checkpoint``, under ``build/``) bit for bit, then four
    requests served from the Qwen2-0.5B checkpoint (the decoder engine,
    batch at a time, greedy) with the tokens the same engine gives on
    the tree held in memory."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.tree import flatten
    out_dir = Path(__file__).resolve().parent / "build" / "ckpt"
    out_dir.mkdir(parents=True, exist_ok=True)
    restored = {}
    for label, tree in (("qwen2", qparams), ("gector", gparams)):
        path = out_dir / f"{label}.ckpt"
        t0 = time.perf_counter()
        ck.save(str(path), {"params": tree})
        t_save = time.perf_counter() - t0
        back = ck.restore(str(path), device="cuda")["params"]
        t_load = time.perf_counter() - t0 - t_save
        a, b = flatten(tree), flatten(back)
        same = sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
        size = path.stat().st_size
        path.unlink()
        print(f"checkpoint {label}: {len(a)} leaves, {size:,} B, save "
              f"{t_save:.1f} s, restore {t_load:.1f} s, "
              f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
        if not same:
            raise AssertionError(f"checkpoint {label} did not restore "
                                 f"bit for bit")
        restored[label] = back
    rng = np.random.default_rng(28)
    prompts = [rng.integers(0, qcfg.vocab_size, int(n))
               for n in rng.integers(8, 30, 4)]
    streams = []
    for tree in (qparams, restored["qwen2"]):
        eng = ServingEngine(qcfg, tree, EngineConfig(
            mode="decoder", continuous=False, use_cache_pool=False,
            max_batch=4, pad_buckets=(32,), max_new_tokens=8),
            device="cuda")
        try:
            hs = [eng.generate(p, SamplingParams(max_new_tokens=8))
                  for p in prompts]
            streams.append([h.result(timeout=300).tokens.tolist()
                            for h in hs])
        finally:
            eng.close()
    same = streams[0] == streams[1]
    print(f"served 4 requests from the Qwen2-0.5B checkpoint: "
          f"{'the tokens of the tree in memory' if same else 'OTHER TOKENS'}"
          f" (first request {streams[1][0]})", flush=True)
    if streams[0] != streams[1]:
        raise AssertionError("the checkpoint served other tokens than the "
                             "tree it was saved from")


def phase_spec_trained(name):
    """Phase 28 (h), printed only: ``bench_spec_decode``'s target (the
    Qwen2 smoke config widened to d_model 640, 10/2 heads of 64, d_ff
    1536; benchmarks/run.py:766-784) and a one-layer draft, each trained
    SPEC_TRAIN_STEPS steps by the port on SyntheticLM (B=16 x 32, lr 3e-3,
    as ``_train_lm``), then 4 requests of 16 tokens through the spec
    engine (spec_k 7), beside the same pair untrained. The bench's draft
    (d_model 112, 7 heads) has heads of 16, which K1 and K2 are not built
    for: this draft is 128 wide, 2 heads of 64 over one kv head."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.api import SamplingParams
    from repro_torch.training import OptConfig, adamw_init, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    t_phase = time.perf_counter()
    base = get_config("qwen2-0.5b", smoke=True)
    cfg = dataclasses.replace(base, name="qwen2-smoke-spec-target",
                              d_model=640, n_heads=10, n_kv_heads=2,
                              d_ff=1536)
    dcfg = dataclasses.replace(cfg, name="qwen2-smoke-spec-draft",
                               n_layers=1, d_model=128, n_heads=2,
                               n_kv_heads=1, d_ff=256)
    dcf = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=16,
                     seed=0)

    def train(c, seed):
        p = init_params(c, seed, device="cuda")
        oc = OptConfig(lr=3e-3, warmup_steps=5,
                       total_steps=SPEC_TRAIN_STEPS)
        o = adamw_init(p)
        first = last = None
        for b in SyntheticLM(dcf).batches(SPEC_TRAIN_STEPS):
            p, o, m = train_step(c, oc, p, o, {"tokens": torch.as_tensor(
                b["tokens"], device="cuda")})
            last = float(m["loss"])
            first = last if first is None else first
        return p, first, last

    pairs = {"random": (init_params(cfg, 0, device="cuda"),
                        init_params(dcfg, 1, device="cuda"))}
    tp, t0, t1 = train(cfg, 0)
    dp, d0, d1 = train(dcfg, 1)
    pairs["trained"] = (tp, dp)
    data = SyntheticLM(dcf)
    rng = np.random.default_rng(5)
    data.rng = rng
    prompts = [data._doc(int(rng.integers(4, 20))) for _ in range(4)]
    rates = {}
    for label, (p, d) in pairs.items():
        eng = ServingEngine(cfg, p, EngineConfig(
            mode="decoder", max_batch=4, max_new_tokens=16,
            pad_buckets=(32,), decode_segment=8, spec_decode=True,
            spec_k=7), draft=(dcfg, d), device="cuda")
        try:
            eng.window()
            hs = [eng.generate(x, SamplingParams(max_new_tokens=16))
                  for x in prompts]
            for h in hs:
                h.result(timeout=300)
            lanes = eng.window().get("lanes", {})
        finally:
            eng.close()
        prop = sum(s.get("spec_proposed", 0) for s in lanes.values())
        acc = sum(s.get("spec_accepted", 0) for s in lanes.values())
        rates[label] = (acc, prop)
    print(f"spec pair trained {SPEC_TRAIN_STEPS} steps by the port: target "
          f"loss {t0:.3f} -> {t1:.3f}, draft {d0:.3f} -> {d1:.3f}; accept "
          f"rate (spec_k 7, 4 requests x 16 tokens) trained "
          f"{rates['trained'][0]}/{rates['trained'][1]} = "
          f"{rates['trained'][0] / max(rates['trained'][1], 1):.3f}, "
          f"random weights {rates['random'][0]}/{rates['random'][1]} = "
          f"{rates['random'][0] / max(rates['random'][1], 1):.3f}; phase "
          f"{time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)


# ------------------------------------- 29-31. stablelm-12b and gemma2-27b
# The new models' attention shapes: stablelm-12b's head dim of 160 (32
# query heads over 8 kv heads) and gemma2-27b's 128 with two query heads
# a kv head, a softcap of 50 and a local window of 4096
STABLELM = dict(Hq=32, Hkv=8, D=160)
GEMMA2 = dict(Hq=32, Hkv=16, D=128, softcap=50.0, window=4096)
STABLELM_PREFILL = dict(B=16, S=512)     # K1 timed at these
GEMMA2_PREFILL = dict(B=8, S=512)
NEW_DECODE = dict(B=16, L=576)           # K2 timed over these rings
BIG_NEW = 32                             # new tokens a request, 30-31
BIG_BUCKETS = (128, 512)
LONG_PROMPT = 4608                       # 31 (a): past gemma2's window
LONG_CTX_STEPS = 8                       # 31 (c): decode steps past the cap
LAST_ROWS = 512                          # 31 (a): logit rows compared


def k1_settings_new(attn_block_sizes):
    """Phase 29's K1 settings at head dims 128 and 160, phase 2's kinds,
    gemma2's two query heads a kv head under a window and a softcap, and
    the two prefill shapes timed after them at the bq the model takes."""
    def bq(p, m):
        return attn_block_sizes("prefill", p["S"], bh=p["B"] * m["Hq"],
                                head_dim=m["D"], dtype=torch.bfloat16)[0]
    s, g = STABLELM, GEMMA2
    settings = []
    for D in (128, 160):
        settings += [  # (name, B, Sq, Skv, Hq, Hkv, D, bq, kwargs)
            (f"D={D} non-causal kv_len<Skv", 2, 160, 160, 8, 8, D, 64,
             dict(causal=False, kv_len=131)),
            (f"D={D} causal GQA G=4", 2, 256, 256, 32, 8, D, 64,
             dict(causal=True)),
            (f"D={D} window 64 softcap 50", 2, 256, 256, 8, 4, D, 32,
             dict(causal=True, window=64, softcap=50.0)),
            (f"D={D} Sq != Skv", 3, 100, 228, 8, 8, D, 64,
             dict(causal=False)),
            (f"D={D} fully masked rows", 2, 160, 160, 4, 4, D, 32,
             dict(causal=True, window=8, kv_len=100))]
    return settings + [
        ("D=128 G=2 window 100 softcap 50", 2, 300, 300, 32, 16, 128, 64,
         dict(causal=True, window=100, softcap=50.0)),
        ("stablelm prefill", STABLELM_PREFILL["B"], 512, 512, s["Hq"],
         s["Hkv"], s["D"], bq(STABLELM_PREFILL, s),
         dict(causal=True, kv_len=512)),
        ("gemma2 prefill", GEMMA2_PREFILL["B"], 512, 512, g["Hq"], g["Hkv"],
         g["D"], bq(GEMMA2_PREFILL, g),
         dict(causal=True, window=g["window"], softcap=g["softcap"],
              kv_len=512))]


def k2_settings_new():
    """Phase 29's K2 settings: phase 6's kinds at stablelm's heads (32 / 8
    of 160) and gemma2's (32 / 16 of 128, softcap 50), explicit split
    counts at D = 160, and both decode shapes timed after them."""
    settings = []
    for D, Hq, Hkv, kw in ((160, 32, 8, {}), (128, 32, 16,
                                              dict(softcap=50.0))):
        tag = f"D={D} G={Hq // Hkv}"
        settings += [  # (name, B, L, Hq, Hkv, D, kv_pos pattern, kwargs)
            (f"{tag} full cache", 4, 128, Hq, Hkv, D, "full", kw),
            (f"{tag} short prefix", 4, 1024, Hq, Hkv, D, "prefix", kw),
            (f"{tag} wrapped ring", 4, 160, Hq, Hkv, D, "ring", kw),
            (f"{tag} empty slots", 4, 256, Hq, Hkv, D, "holes", kw),
            (f"{tag} window 64", 4, 512, Hq, Hkv, D, "ring",
             dict(kw, window=64)),
            (f"{tag} ragged L=157", 5, 157, Hq, Hkv, D, "ring", kw)]
    n = NEW_DECODE
    return settings + k2_split_settings(160, 32, 8) + [
        ("stablelm decode", n["B"], n["L"], STABLELM["Hq"],
         STABLELM["Hkv"], STABLELM["D"], "full", {}),
        ("gemma2 decode", n["B"], n["L"], GEMMA2["Hq"], GEMMA2["Hkv"],
         GEMMA2["D"], "full", dict(softcap=GEMMA2["softcap"]))]


def phase_new_shape_timings(fa, da, attn_block_sizes, name):
    """29 (b). K1 at stablelm's prefill (B=16, S=512, 32 / 8 heads of 160,
    causal) and gemma2's (B=8, S=512, 32 / 16 of 128, causal, softcap 50,
    window 4096), and K2 at B=16 over 576 slots at both models' heads
    (bf16 q, fp32 ring; gemma2's with its softcap), each by ``graph_ms``
    beside its bound, its plain version (profiler device time) and SDPA
    (``graph_ms``; SDPA has no softcap, so gemma2's reads SDPA without
    one). Returns {label: (ms, plain ms, sdpa ms, bound ms, bound by)}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    rows = {}
    for label, m, p in (("stablelm prefill", STABLELM, STABLELM_PREFILL),
                        ("gemma2 prefill", GEMMA2, GEMMA2_PREFILL)):
        B, S, Hq, Hkv, D = p["B"], p["S"], m["Hq"], m["Hkv"], m["D"]
        q = randn(gen, B, S, Hq, D, dtype=bf16)
        k, v = (randn(gen, B, S, Hkv, D, dtype=bf16) for _ in range(2))
        kw = dict(causal=True, window=m.get("window"),
                  softcap=m.get("softcap"))
        bq = attn_block_sizes("prefill", S, bh=B * Hq, head_dim=D,
                              dtype=bf16)[0]
        t_k = graph_ms(lambda: fa.flash_attention(q, k, v, bq=bq, **kw))
        t_p = device_ms(lambda: fa.flash_attention_plain(q, k, v, bq=bq,
                                                         **kw), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t_s = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                    enable_gqa=True))
        bound, by = attn_bound_ms(B, S, S, Hq, Hkv, D, 2, causal=True)
        print(f"timing K1 {label} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 "
              f"{kw} bq={bq}: kernel over a captured graph of 20 calls "
              f"{t_k:.4f} ms, plain (device time) {fmt_ms(t_p)}, sdpa "
              f"(graph{', no softcap' if 'softcap' in m else ''}) "
              f"{t_s:.4f} ms, bound {bound:.4f} ms ({by}) [{name}]",
              flush=True)
        rows[label] = (t_k, t_p, t_s, bound, by)
    for label, m in (("stablelm decode", STABLELM), ("gemma2 decode",
                                                     GEMMA2)):
        B, L, Hq, Hkv, D = (NEW_DECODE["B"], NEW_DECODE["L"], m["Hq"],
                            m["Hkv"], m["D"])
        q = randn(gen, B, 1, Hq, D, dtype=bf16)
        k, v = (randn(gen, B, L, Hkv, D, dtype=torch.float32)
                for _ in range(2))
        q_pos = np.full(B, L - 1, np.int32)
        kv_pos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
        qp, kvp = (torch.from_numpy(x).cuda() for x in (q_pos, kv_pos))
        sc = m.get("softcap")
        t_k = graph_ms(lambda: da.decode_attention(q, k, v, qp, kvp,
                                                   softcap=sc))
        t_p = device_ms(lambda: da.decode_attention_plain(
            q, k, v, qp, kvp, softcap=sc), iters=3)
        qt = q.transpose(1, 2)
        kt, vt = (x.to(bf16).transpose(1, 2) for x in (k, v))
        mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
        t_s = graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                    enable_gqa=True))
        bound, by = decode_bound_ms(q_pos, kv_pos, Hq, Hkv, D, 2, 4)
        print(f"timing K2 {label} B={B} L={L} Hq={Hq} Hkv={Hkv} D={D} bf16 "
              f"q fp32 ring softcap {sc}, {da.decode_splits(B, Hkv, L)[0]} "
              f"splits: kernel over a captured graph of 20 calls "
              f"{t_k:.4f} ms, plain (device time) {fmt_ms(t_p)}, sdpa "
              f"(graph{', no softcap' if sc else ''}) {t_s:.4f} ms, bound "
              f"{bound:.5f} ms ({by}) [{name}]", flush=True)
        rows[label] = (t_k, t_p, t_s, bound, by)
    return rows


def big_load(cfg, seed, n_short, long_lens, lo=8, hi=120):
    """``n_short`` prompts of ``lo``..``hi`` tokens and one of each length
    in ``long_lens``, every other one sampled (temperature 0.8, top_k 50,
    its own seed), shuffled."""
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(lo, hi + 1)) for _ in range(n_short)]
    load = [(rng.integers(0, cfg.vocab_size, n),
             SamplingParams(temperature=0.8, top_k=50, seed=i) if i % 2
             else SamplingParams())
            for i, n in enumerate(lens + list(long_lens))]
    return [load[i] for i in rng.permutation(len(load))]


def serve_twice(cfg, params, kernels, ec, load, label, name, streams=None):
    """A continuous engine (``ec``) serves ``load`` twice, all requests at
    once: the first pass captures each program at its first call (which
    runs uncaptured), the second replays them. Every request's tokens of
    the two passes must be equal, and the second pass's K1/K2 (and, with
    int8 weights, K3) launches must match its whole-prompt joins and
    decode steps. Returns the second pass's K1..K5 launches; the second
    pass's token streams are appended to ``streams`` where given."""
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, params, EngineConfig(**ec), device="cuda")
    try:
        t0 = time.perf_counter()
        first, _ = serve_load(eng, load, 0.0)
        t_first = time.perf_counter() - t0
        captures = eng.metrics()["jit_compiles"]
        eng.window()
        reset_launches(kernels)
        second, wall = serve_load(eng, load, 0.0)
        launches = tuple(fn.launches for fn in kernels)
        win = eng.window()
        ecfg = eng.ec
    finally:
        eng.close()
    # the engine and its scheduler form a cycle: free its pools and
    # graphs now, before the next engine
    del eng
    gc_mod.collect()
    torch.cuda.empty_cache()
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(first, second))
    if streams is not None:
        streams.extend(np.asarray(r.tokens) for r in second)
    n_tok = sum(len(r.tokens) for r in second)
    steps = ecfg.decode_segment * win["decode_segments"]
    L = cfg.n_layers
    want = (L * win["prefill_batches"], L * steps,
            k3_per_layer(cfg) * L * (win["prefill_batches"] + steps)
            if ecfg.weight_quant else 0, 0, 0)
    print(f"{label}: first pass (captures {captures} programs as they "
          f"come) {t_first:.1f} s; second pass (replays) {len(load)} "
          f"requests, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
          f"tokens/s; {same} of {len(load)} token-identical across the "
          f"passes; window: prefill batches {win['prefill_batches']}, "
          f"prefill_chunks {win['prefill_chunks']}, decode segments "
          f"{win['decode_segments']}, weight_bytes {win['weight_bytes']:,};"
          f" K1..K5 launches {launches} (joins and steps give {want}) "
          f"[{name}]", flush=True)
    if same != len(load) or launches[:3] != want[:3] or 0 in launches[:2]:
        raise AssertionError(f"{label}: {same} of {len(load)} streams "
                             f"equal across passes, launches {launches} "
                             f"!= {want}")
    return launches


def big_program_gates(cfg, params, label, name, *, width, bucket=128,
                      kv_quant=None):
    """Phase 21's and 22's rules at a big model's serving shapes: one
    decode step program at B = ``width`` in caches of bucket + BIG_NEW
    slots (forward in decode mode and token selection, greedy and
    sampled) captured against the same call uncaptured, bit for bit; row
    0's prefill hidden state and first-token logits alone (join size 1)
    and in a join of ``width``, each padded as the engine pads it; row
    0's decode-step logits at widths 1 and ``width``, both at
    ``width``'s K2 split count (``decode_width``, as the engine runs).
    The captured step is read by the profiler (wall, kernels, device
    idle), the uncaptured one by the host clock only (the profiler's
    summary of an eager 40-layer step took seconds)."""
    from repro_torch.models import forward, make_caches, sample_logits
    from repro_torch.models.layers import head_weight, lm_head_apply
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.graphs import GraphCache
    rng = np.random.default_rng(300 + width)
    L = bucket + BIG_NEW
    _, toks, lens = prompt_batch(rng, width, 8, bucket - 8, bucket,
                                 cfg.vocab_size)
    tt = torch.from_numpy(toks).cuda()
    lt = torch.from_numpy(lens).cuda()
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    out = {}
    with torch.inference_mode():
        def prefill_row0(idx):
            caches = make_caches(cfg, len(idx), L, dtype=torch.float32,
                                 kv_quant=kv_quant, device="cuda")
            hid = forward(cfg, params, tokens=tt[idx], caches=caches,
                          return_hidden=True)
            last = hid[torch.arange(len(idx), device="cuda"),
                       lt[idx] - 1][:, None]
            return hid, lm_head_apply(cfg, None, last, w=w)[:, 0], caches
        rows = {n: ServingEngine._prefill_rows(n, bucket)
                for n in (1, width)}
        ref = prefill_row0(list(range(width)) + [0] * (rows[width] - width))
        one = prefill_row0([0] * rows[1])
        out["prefill"] = (max_diff(one[0][0, :lens[0]],
                                   ref[0][0, :lens[0]]),
                          max_diff(one[1][0], ref[1][0]))
        caches = ref[2]
        tok = ref[1].argmax(-1).to(torch.int32)[:, None]
        del one, ref

        def step(width_, dw):
            sub = slice_caches(caches, width_)
            return forward(cfg, params, tokens=tok[:width_],
                           positions=lt[:width_, None], caches=sub,
                           mode="decode", head_w=w, decode_width=dw)[0, 0]
        out["decode"] = max_diff(step(1, width), step(width, width))
        gc = GraphCache("cuda")
        temp = torch.full((width,), 0.8, device="cuda")
        topk = torch.full((width,), 50, dtype=torch.int32, device="cuda")
        seed = torch.arange(width, dtype=torch.int32, device="cuda")

        def prog(t, p, tm, tk, sd):
            lg = forward(cfg, params, tokens=t, positions=p, caches=caches,
                         mode="decode", head_w=w)[:, 0]
            return {"logits": lg,
                    "tok": sample_logits(lg, temperature=tm, top_k=tk,
                                         seed=sd, positions=p[:, 0] + 1)}
        pos = lt[:, None]
        for mode, sargs in (("greedy", (None, None, None)),
                            ("sampled", (temp, topk, seed))):
            args = (tok[:width], pos, *sargs)
            diff = replay_diff(gc, ("step", mode), prog, args, prog(*args))
            cap = program_reading(lambda: gc.run(("step", mode), prog,
                                                 *args))
            unc = sync_wall_ms(lambda: prog(*args), n=3, warmup=1)
            print(f"{label} decode step program B={width} L={L}, {mode}: "
                  f"captured replay vs direct uncaptured call: max "
                  f"difference {diff} (replayed in sync debug mode "
                  f"'error'); captured {fmt_reading(cap)}; uncaptured "
                  f"wall {unc:.4f} ms [{name}]", flush=True)
            if diff != 0:
                raise AssertionError(f"{label} {mode}: the captured step "
                                     f"differs from the uncaptured call")
        del caches
    print(f"{label}: row 0's prefill (hidden, first-token logits) at join "
          f"size 1 vs {width}, padded as the engine pads (M = "
          f"{rows[1] * bucket} vs {rows[width] * bucket}): "
          f"{out['prefill']}; its decode-step logits at width 1 vs {width} "
          f"(decode_width={width}): {out['decode']}", flush=True)
    if out["prefill"] != (0.0, 0.0) or out["decode"] != 0.0:
        raise AssertionError(f"{label}: a row's bits follow its batch: "
                             f"{out}")


def phase_stablelm(kernels, name):
    """30. stablelm-12b at full width and depth (40 layers, head dim 160,
    random weights from ``init_params(seed=0)``), bf16, through the
    default continuous decoder (max_batch 16, buckets 128 and 512, 32 new
    tokens): 32 requests, 16 of 8-120 tokens and 16 of 129-500, half
    greedy, half sampled (top_k 50), served twice (``serve_twice``),
    float and then int8 weights and KV (K3 at K = 5120 and 13824); phase
    21's and 22's rules on the float and the int8 tree at width 16; then
    one engine with ``prefill_chunk=128`` and the prefix cache, 6
    prompts sharing a 256-token system prompt served one by one, whose
    warm hits must equal a cold engine's tokens. Returns {path: K1..K5
    launches}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantize_params
    cfg = get_config("stablelm-12b")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"stablelm-12b: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim_}, drawn in "
          f"{time.perf_counter() - t0:.1f} s; {mem0:,} B allocated before",
          flush=True)
    rng = np.random.default_rng(30)
    load = big_load(cfg, 30, 16, [int(x) for x in rng.integers(129, 501,
                                                              16)])
    base = dict(mode="decoder", max_batch=16, pad_buckets=BIG_BUCKETS,
                max_new_tokens=BIG_NEW)
    out = {}
    for quant in (None, "int8"):
        label = "stablelm-12b" + (" int8 W+KV" if quant else "")
        out[label] = serve_twice(cfg, params, kernels,
                                 dict(base, weight_quant=quant,
                                      kv_quant=quant), load, label, name)
    print(f"stablelm-12b: engines {time.perf_counter() - t0:.1f} s",
          flush=True)
    big_program_gates(cfg, params, "stablelm-12b", name, width=16)
    qparams = quantize_params(params)
    big_program_gates(cfg, qparams, "stablelm-12b int8 W+KV", name,
                      width=16, kv_quant="int8")
    del qparams
    print(f"stablelm-12b: program gates {time.perf_counter() - t0:.1f} s",
          flush=True)
    out["stablelm-12b prefix"] = big_prefix(cfg, params, kernels, base,
                                            name)
    peak = torch.cuda.max_memory_allocated() - mem0
    print(f"stablelm-12b: peak device memory {peak:,} B over the phase's "
          f"start; phase {time.perf_counter() - t0:.1f} s [{name}]",
          flush=True)
    del params
    return out


def big_prefix(cfg, params, kernels, base, name):
    """30 (c). ``prefill_chunk=128`` and the prefix cache in bucket 512:
    6 greedy prompts of a 256-token system prompt (two whole chunks)
    plus 1..64 tokens, served one by one; the cold engine
    (``prefix_cache=False``) fills every prompt chunk by chunk, the warm
    one stores the first and serves the 5 others from a hit. Every warm
    stream must equal the cold one; 5 hits, 1 miss, 1 insert."""
    from repro_torch.serving import EngineConfig, ServingEngine
    rng = np.random.default_rng(31)
    sysp = rng.integers(0, cfg.vocab_size, 256)
    prompts = [np.concatenate([sysp, rng.integers(
        0, cfg.vocab_size, int(rng.integers(1, 65)))]) for _ in range(6)]
    ec = dict(base, pad_buckets=(512,), prefill_chunk=128)
    res = {}
    for on in (False, True):
        eng = ServingEngine(cfg, params, EngineConfig(**ec,
                                                      prefix_cache=on),
                            device="cuda")
        try:
            reset_launches(kernels)
            res[on] = one_by_one(eng, prompts) + (
                tuple(fn.launches for fn in kernels),)
        finally:
            eng.close()
    (cold, _, _), (warm, win, launches) = res[False], res[True]
    same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(cold,
                                                                  warm))
    lane = win["lanes"][512]
    counts = {k: lane[k] for k in ("prefix_hits", "prefix_misses",
                                    "prefix_inserts")}
    print(f"stablelm-12b prefix: {same} of {len(prompts)} warm streams "
          f"token-identical to cold; counters {counts}, prefill_chunks "
          f"{lane['prefill_chunks']}; K1..K5 launches {launches} [{name}]",
          flush=True)
    if same != len(prompts) or counts != {"prefix_hits": 5,
                                          "prefix_misses": 1,
                                          "prefix_inserts": 1}:
        raise AssertionError(f"stablelm-12b prefix: {same} equal, "
                             f"{counts}")
    return launches


def bf16_rule(readings, rows, label):
    """Phase 7's gate on {path: (max abs err, mean abs err, top-1 flips)}
    against fp32 over ``rows`` rows: the kernel path's errors at most
    LOGIT_ERR_FACTOR x the plain path's, its flips at most
    TOP1_FLIP_FACTOR x plain's (or 1% of the rows)."""
    (k_max, k_mean, k_flips) = readings["kernels bf16"]
    (p_max, p_mean, p_flips) = readings["plain bf16"]
    if (k_max > LOGIT_ERR_FACTOR * p_max
            or k_mean > LOGIT_ERR_FACTOR * p_mean
            or k_flips > max(TOP1_FLIP_FACTOR * p_flips, 0.01 * rows)):
        raise AssertionError(
            f"{label}: the kernel path strays further from fp32 than plain "
            f"attention: max {k_max:.3e} vs {p_max:.3e}, mean {k_mean:.3e} "
            f"vs {p_mean:.3e}, flips {k_flips} vs {p_flips}")


def against_fp32(logits, label, what):
    """{path: (max, mean, flips)} of the bf16 paths' logits against the
    fp32 path's (each (rows, V) over the real vocabulary), printed."""
    ref = logits["fp32"]
    out = {}
    for path in ("kernels bf16", "plain bf16"):
        got = logits[path]
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            raise AssertionError(f"{label} {path}: non-finite or misshapen")
        d = (got - ref).abs()
        out[path] = (d.max().item(), d.mean().item(),
                     int((got.argmax(-1) != ref.argmax(-1)).sum()))
        print(f"{label} {path:12s} vs fp32, {what}: logits max_abs_err "
              f"{out[path][0]:.4e}, mean {out[path][1]:.4e}, top-1 flips "
              f"{out[path][2]} of {ref.shape[0]}", flush=True)
    return out


def hidden_fp32_by_layer(cfg, params, tokens):
    """``forward(cfg32, to_fp32(params), tokens=tokens, return_hidden=True,
    plain_attention=True)`` for a bf16 tree too large to copy whole to
    fp32 (gemma2-27b's 46 layers: 104 GB): ``forward``'s full mode step by
    step, each block's weights cast to fp32 only while it runs."""
    from repro_torch.models import transformer as tm
    from repro_torch.models.layers import (apply_norm, embed_apply,
                                           rope_angles)
    c32 = dataclasses.replace(cfg, dtype="float32")
    if c32.abs_pos:
        raise ValueError("hidden_fp32_by_layer: no absolute positions")
    x = embed_apply(c32, params["embed"], tokens)
    if c32.embed_scale:
        x = x * torch.tensor(c32.d_model ** 0.5, dtype=torch.float32).item()
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope = (None if c32.attn.rope_base is None else
            rope_angles(positions, c32.head_dim_, c32.attn.rope_base))
    for j, kind in enumerate(c32.pattern):
        blk = params["blocks"][f"blk{j}"]
        for i in range(c32.n_periods):
            x, _ = tm._apply_block(
                c32, kind, to_fp32(tm._index_tree(blk, i)), x, positions,
                None, mode="full", causal=True, plain_attention=True,
                plain_matmul=False, rope=rope)
    return apply_norm(c32, to_fp32(params["final_norm"]), x)


def phase_gemma2_period(da, name):
    """31 (a) and (c) at one period of gemma2-27b (an attn_local and an
    attn_global layer, full width, random weights from ``init_params(
    seed=0)`` of the cut config), in bf16 through the kernels and plain
    attention against its fp32 copy, by phase 7's rule: (a) a 4608-token
    prompt at B=1, past the window of 4096, on the last 512 positions'
    logits; (c) ``long_ctx``: caches of max_len 65536 hold a local ring
    of 4096 and a global ring capped at 32,768 slots, filled with random
    K/V at positions past the cap, then 8 teacher-forced decode steps;
    and K2 on that global ring against its plain version, timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, make_caches
    from repro_torch.models.layers import head_weight, lm_head_apply
    cfg = dataclasses.replace(get_config("gemma2-27b"), n_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = init_params(cfg, 0, device="cuda")
    p32 = to_fp32(p)
    paths = {"kernels bf16": (cfg, p, False), "plain bf16": (cfg, p, True),
             "fp32": (cfg32, p32, True)}
    V = cfg.vocab_size
    rng = np.random.default_rng(311)
    toks = torch.from_numpy(rng.integers(0, V, (1, LONG_PROMPT))).cuda()
    logits = {}
    with torch.inference_mode():
        for path, (c, pp, plain) in paths.items():
            hid = forward(c, pp, tokens=toks, return_hidden=True,
                          plain_attention=plain)[:, -LAST_ROWS:]
            w = head_weight(c, None, pp["embed"])
            logits[path] = lm_head_apply(c, None, hid, w=w)[0, :, :V]
            del hid, w
    bf16_rule(against_fp32(logits, "gemma2-27b one period",
                           f"a {LONG_PROMPT}-token prompt, last {LAST_ROWS} "
                           f"positions"), LAST_ROWS, "31 (a)")
    del logits
    # (c): long_ctx past the cap
    B, max_len = 2, 65536
    cap = cfg.attn.long_ctx_window_cap
    last = np.array([40_000 + 777 * b for b in range(B)])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(312)
    fill = make_caches(cfg, B, max_len, long_ctx=True, dtype=torch.float32,
                       device="cuda")
    for blk in fill.values():
        n = blk["k"].shape[2]
        for key in ("k", "v"):
            blk[key].normal_(generator=gen)
        for b in range(B):
            ps = torch.arange(last[b] - n + 1, last[b] + 1, device="cuda",
                              dtype=torch.int32)
            blk["pos"][:, b, ps.long() % n] = ps
        blk["len"].copy_(torch.from_numpy(last + 1).cuda().expand(1, B))
    shapes = {b: tuple(blk["k"].shape) for b, blk in fill.items()}
    # K2 over the filled global ring at the step's position, and timed
    ring = fill["blk1"]
    q = randn(gen, B, 1, cfg.n_heads, cfg.head_dim_, dtype=torch.bfloat16)
    qp = torch.from_numpy(last + 1).to(torch.int32).cuda()
    kw = dict(window=cap, softcap=cfg.attn.logit_softcap)
    k, v, kvp = ring["k"][0], ring["v"][0], ring["pos"][0]
    out, visits = da.decode_attention(q, k, v, qp, kvp, return_visits=True,
                                      **kw)
    torch.cuda.synchronize()
    n_split = da.decode_splits(B, cfg.n_kv_heads, cap)[0]
    ref, ref_visits = da.decode_attention_plain(
        q.float(), k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float(),
        qp, kvp, n_split=n_split, **kw)
    err = (out.float() - ref).abs().max().item()
    t_k = graph_ms(lambda: da.decode_attention(q, k, v, qp, kvp, **kw))
    bound, by = decode_bound_ms(qp.cpu().numpy(), kvp.cpu().numpy(),
                                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                                2, 4, window=cap)
    print(f"K2 long_ctx global ring B={B} L={cap} 32/16 of 128, bf16 q fp32 "
          f"ring, window {cap}, softcap 50, {n_split} splits: max_abs_err "
          f"{err:.3e} (tol {BF16_TOL}), visits "
          f"{'ok' if torch.equal(visits, ref_visits) else 'WRONG'}; kernel "
          f"over a captured graph {t_k:.4f} ms, bound {bound:.5f} ms ({by}) "
          f"[{name}]", flush=True)
    if not (torch.allclose(out.float(), ref, atol=BF16_TOL, rtol=BF16_TOL)
            and torch.equal(visits, ref_visits)):
        raise AssertionError("K2 disagrees with its plain version on the "
                             "long_ctx ring")
    caches = {path: {b: {k_: t.clone() for k_, t in blk.items()}
                     for b, blk in fill.items()} for path in paths}
    del fill, ring, k, v, kvp
    tok = torch.from_numpy(rng.integers(0, V, (B, 1))).cuda()
    steps = {path: [] for path in paths}
    k2_0 = da.decode_attention.launches
    with torch.inference_mode():
        for t in range(LONG_CTX_STEPS):
            pos = torch.from_numpy(last + 1 + t).cuda()[:, None]
            for path, (c, pp, plain) in paths.items():
                lg = forward(c, pp, tokens=tok, positions=pos,
                             caches=caches[path], mode="decode",
                             plain_attention=plain, long_ctx=True)[:, 0]
                steps[path].append(lg[:, :V])
            tok = steps["fp32"][-1].argmax(-1)[:, None]
    k2 = da.decode_attention.launches - k2_0
    logits = {path: torch.cat(s) for path, s in steps.items()}
    print(f"gemma2-27b one period long_ctx: caches {shapes} (local ring "
          f"4096, global capped at {cap}); positions {list(last + 1)}.. "
          f"decoded {LONG_CTX_STEPS} steps; K2 launches {k2}", flush=True)
    bf16_rule(against_fp32(logits, "gemma2-27b one period long_ctx",
                           f"{LONG_CTX_STEPS} steps x {B} rows"),
              LONG_CTX_STEPS * B, "31 (c)")
    if k2 != LONG_CTX_STEPS * cfg.n_layers or \
            shapes["blk1"][2] != cap or shapes["blk0"][2] != cfg.attn.window:
        raise AssertionError(f"31 (c): K2 launches {k2}, caches {shapes}")
    return err


def phase_gemma2(fa, da, kernels, name):
    """31. gemma2-27b at full width and depth (46 layers: 23 local, then
    23 global; 32 / 16 heads of 128 through the fused ``wqkv``), bf16,
    random weights from ``init_params(seed=0)``, with nothing else on the
    card: (a) at one period by the bf16 rule (``phase_gemma2_period``),
    then at 46 layers one 4608-token prompt at B=1 through K1 and through
    plain attention, each held against the fp32 path
    (``hidden_fp32_by_layer``) on the last 512 positions' logits by the
    same rule, K1 against plain attention printed; (b) the
    continuous engine (max_batch 8, buckets 128 and 512,
    ``prefill_chunk=128``, 32 new tokens): 15 prompts of 8-120 tokens
    and one of 500 (chunk by chunk), half sampled, served twice
    (``serve_twice``), and phase 21's and 22's rules at width 8; (c) at
    one period (``phase_gemma2_period``). Prints the peak memory.
    Returns ((b)'s K1..K5 launches, K2's error on (c)'s ring)."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.layers import head_weight, lm_head_apply
    empty_card("gemma2-27b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k2_err = phase_gemma2_period(da, name)
    gc_mod.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma2-27b")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    attn = params["blocks"]["blk0"]["attn"]
    print(f"gemma2-27b: {cfg.n_layers} layers drawn, attention leaves "
          f"{ {k: tuple(t.shape) for k, t in attn.items()} }, "
          f"{torch.cuda.memory_allocated():,} B allocated", flush=True)
    if set(attn) != {"wqkv", "wo"}:
        raise AssertionError("gemma2-27b does not take the fused layout")
    V = cfg.vocab_size
    rng = np.random.default_rng(313)
    toks = torch.from_numpy(rng.integers(0, V, (1, LONG_PROMPT))).cuda()
    w = head_weight(cfg, None, params["embed"])
    lg = {}
    with torch.inference_mode():
        for path, plain in (("kernels bf16", False), ("plain bf16", True)):
            k1_0 = fa.flash_attention.launches
            hid = forward(cfg, params, tokens=toks, return_hidden=True,
                          plain_attention=plain)[:, -LAST_ROWS:]
            lg[path] = lm_head_apply(cfg, None, hid, w=w)[0, :, :V]
            if not plain:
                k1 = fa.flash_attention.launches - k1_0
        del w, hid
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        hid = hidden_fp32_by_layer(cfg, params, toks)[:, -LAST_ROWS:]
        lg["fp32"] = lm_head_apply(cfg32, None, hid, w=head_weight(
            cfg32, None, params["embed"]))[0, :, :V]
    del hid
    a, b = lg["kernels bf16"], lg["plain bf16"]
    d = (a - b).abs()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean()
    print(f"gemma2-27b {cfg.n_layers} layers, a {LONG_PROMPT}-token prompt: "
          f"K1 ({k1} launches) vs plain attention on the last {LAST_ROWS} "
          f"positions' logits: max_abs_err {d.max().item():.4e}, mean "
          f"{d.mean().item():.4e}, top-1 agreement {agree.item():.4f} "
          f"[{name}]", flush=True)
    if k1 != cfg.n_layers:
        raise AssertionError(f"31 (a): K1 launches {k1}")
    bf16_rule(against_fp32(lg, f"gemma2-27b {cfg.n_layers} layers",
                           f"a {LONG_PROMPT}-token prompt, last {LAST_ROWS} "
                           f"positions"), LAST_ROWS, "31 (a) at 46 layers")
    del lg, d, a, b
    print(f"gemma2-27b: (a) and (c) {time.perf_counter() - t0:.1f} s",
          flush=True)
    load = big_load(cfg, 314, 15, [500])
    ec = dict(mode="decoder", max_batch=8, pad_buckets=BIG_BUCKETS,
              max_new_tokens=BIG_NEW, prefill_chunk=128)
    served = serve_twice(cfg, params, kernels, ec, load, "gemma2-27b", name)
    big_program_gates(cfg, params, "gemma2-27b", name, width=8)
    peak = torch.cuda.max_memory_allocated()
    print(f"gemma2-27b: peak device memory {peak:,} B; phase "
          f"{time.perf_counter() - t0:.1f} s [{name}]", flush=True)
    del params
    return served, k2_err


# ------------------------------------------- 32. the MoE block: qwen2-moe
# qwen2-moe-a2.7b's attention: 16 query heads over 16 kv heads of 128 (G
# = 1 in K2), through the fused wqkv with its bias
QWEN2_MOE = dict(Hq=16, Hkv=16, D=128)
MOE_PREFILL = dict(B=16, S=512)         # K1 timed at the widest join
MOE_DECODE = dict(B=16, L=512 + BIG_NEW)  # K2 over bucket 512's ring
MOE_JOINS = (1, 4, 8, 16)               # 32 (c): join sizes held
MOE_WIDTHS = (1, 16)                    # 32 (c): decode widths held
MOE_SHORT = dict(B=2, S=512)            # 32 (a): the prompts compared
# 32 (a) at 24 layers: K1 against plain attention may stray at most these
# multiples of its one-layer reading: the max logit error, the mean, and
# the share of top-1 disagreements. A routing flip turns a bf16 attention
# difference into another expert mix, and the difference grows with
# depth: on random weights the first card reading grew 2.7x (max), 10.2x
# (mean) and 10.3x (disagreement, 2.7% to 28.1%; plain bf16 attention
# against fp32 itself flips 28% at 24 layers; "NVIDIA H100 80GB HBM3,
# 700.00 W"), so the limits are about twice the growth read (PERF.md).
MOE_DEPTH_FACTORS = dict(max=5.0, mean=20.0, disagree=20.0)
# 32 (d): the other MoE configs at full width, cut to two layers
MOE_CUT_LAYERS = 2
MOE_CUT = dict(B=4, S=128)
MOE_CLASSES = ("attention", "router", "dispatch", "expert products",
               "combine", "shared experts", "head")


def k3_per_layer(cfg):
    """K3 launches of one int8 layer: the q/k/v projections (one fused
    ``wqkv`` or three), ``wo``, and a dense MLP's two (an MoE block's
    experts stay float)."""
    return (1 if cfg.fused_qkv else 3) + 1 + (0 if cfg.moe else 2)


def empty_card(label):
    """Free what earlier phases left (each stream a cuBLAS handle ran on
    keeps its workspace in the caching allocator), then require less
    than 2 GB still allocated; returns the bytes allocated."""
    gc_mod.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    print(f"{label}: {mem0:,} B allocated at the phase's start (limit "
          f"2 GB; {held:,} B before the cuBLAS workspaces were freed)",
          flush=True)
    if mem0 >= 2e9:
        live = sorted(((t.numel() * t.element_size(), tuple(t.shape),
                        t.dtype) for t in gc_mod.get_objects()
                       if isinstance(t, torch.Tensor) and t.is_cuda),
                      key=lambda r: r[0], reverse=True)[:10]
        raise AssertionError(f"{mem0:,} B still allocated before {label}; "
                             f"the largest live tensors: {live}")
    return mem0


def row_bits(cfg, params, label, *, buckets, joins, widths, step_bucket,
             new_tokens, kv_quant=None, seed=322, min_m=None, gate=True):
    """Phase 22's rule at a model's serving shapes: in each bucket, row
    0's prefill hidden state and first-token logits in a join of every
    size of ``joins``, padded as the engine pads it, against the widest
    join; the widest join's prefill run twice (the same bits every
    call); and at ``step_bucket`` row 0's decode-step logits at every
    width of ``widths`` against the widest, at its K2 split count and M
    (``decode_width``, as the engine runs). Every difference must be 0
    (``gate``; without it they are printed only). ``min_m``: the rows of
    M a join is padded to, default the engine's ``prefill_min_m(cfg)``.
    Returns {key: max difference}."""
    from repro_torch.models import forward, make_caches
    from repro_torch.models.layers import head_weight, lm_head_apply
    from repro_torch.serving.engine import ServingEngine, prefill_min_m
    rng = np.random.default_rng(seed)
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    wide = max(widths)
    min_m = prefill_min_m(cfg) if min_m is None else min_m
    out = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for bucket in buckets:
            n_max = max(joins + (wide,) if bucket == step_bucket else joins)
            _, toks, lens = prompt_batch(rng, n_max, 8, bucket - 8, bucket,
                                         cfg.vocab_size)
            tt = torch.from_numpy(toks).cuda()
            lt = torch.from_numpy(lens).cuda()
            L = bucket + new_tokens

            def prefill(n):
                idx = list(range(n)) + [0] * (
                    ServingEngine._prefill_rows(n, bucket, min_m) - n)
                caches = make_caches(cfg, len(idx), L, dtype=torch.float32,
                                     kv_quant=kv_quant, device="cuda")
                hid = forward(cfg, params, tokens=tt[idx], caches=caches,
                              return_hidden=True)
                last = hid[torch.arange(len(idx), device="cuda"),
                           lt[idx] - 1][:, None]
                return (hid[0, :lens[0]],
                        lm_head_apply(cfg, None, last, w=w)[:, 0], caches)
            ref = prefill(max(joins))
            again = prefill(max(joins))
            out[(bucket, "twice")] = max(max_diff(ref[0], again[0]),
                                         max_diff(ref[1], again[1]))
            del again
            for n in joins[:-1]:
                got = prefill(n)
                out[(bucket, n)] = max(max_diff(got[0], ref[0]),
                                       max_diff(got[1][0], ref[1][0]))
                del got
            if bucket != step_bucket:
                del ref
                continue
            if max(joins) != wide:
                ref = prefill(wide)
            caches, tok = ref[2], ref[1].argmax(-1).to(torch.int32)[:, None]
            del ref

            def step(width):
                return forward(cfg, params, tokens=tok[:width],
                               positions=lt[:width, None],
                               caches=slice_caches(caches, width),
                               mode="decode", head_w=w,
                               decode_width=wide)[0, 0]
            top = step(wide)
            for width in widths[:-1]:
                out[("decode", width)] = max_diff(step(width), top)
            del caches
    bad = {k: d for k, d in out.items() if d != 0.0}
    ms = {b: sorted({ServingEngine._prefill_rows(n, b, min_m) * b
                     for n in joins}) for b in buckets}
    print(f"row bits {label}: joins {joins} padded as the engine pads "
          f"(M by bucket {ms}) against the widest, the widest run twice, "
          f"decode widths {widths} at decode_width={wide} (L = "
          f"{step_bucket + new_tokens}): {len(out) - len(bad)} of "
          f"{len(out)} bit-equal; max differences {out} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if bad and gate:
        raise AssertionError(f"{label}: a row's bits follow its batch or "
                             f"its call: {bad}")
    return out


def moe_kernel_rows(fa, da, attn_block_sizes, name):
    """32 (a) and (e): K1 and K2 at qwen2-moe's shapes against their plain
    versions (phase 2's and 6's checks), then timed by ``graph_ms``
    beside the bound, the plain version (profiler) and SDPA: K1 at the
    widest bucket-512 join (B=16 S=512, 16/16 heads of 128, causal) and
    K2 at G = 1 over bucket 512's ring (B=16 L=544, bf16 q, fp32 ring).
    Returns ((K1 err, settings), (K2 err, settings), {label: (ms, plain
    ms, sdpa ms, bound ms, bound by)})."""
    m, p, dm = QWEN2_MOE, MOE_PREFILL, MOE_DECODE
    bf16 = torch.bfloat16
    bq = attn_block_sizes("prefill", p["S"], bh=p["B"] * m["Hq"],
                          head_dim=m["D"], dtype=bf16)[0]
    k1 = phase_kernel_parity(fa, [
        ("G=1 D=128 causal", 2, 256, 256, 16, 16, 128, 64,
         dict(causal=True)),
        ("G=1 D=128 kv_len<S", 2, 256, 256, 16, 16, 128, 32,
         dict(causal=True, kv_len=200)),
        ("qwen2-moe prefill", p["B"], p["S"], p["S"], m["Hq"], m["Hkv"],
         m["D"], bq, dict(causal=True, kv_len=p["S"]))],
        main="qwen2-moe prefill")
    k2 = phase_decode_parity(da, [
        ("G=1 D=128 wrapped ring", 4, 160, 16, 16, 128, "ring", {}),
        ("G=1 D=128 empty slots", 4, 256, 16, 16, 128, "holes", {}),
        ("qwen2-moe decode", dm["B"], dm["L"], m["Hq"], m["Hkv"], m["D"],
         "full", {})], main="qwen2-moe decode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, D = p["B"], p["S"], m["Hq"], m["D"]
    q, k, v = (randn(gen, B, S, H, D, dtype=bf16) for _ in range(3))
    t_k = graph_ms(lambda: fa.flash_attention(q, k, v, bq=bq, causal=True))
    t_p = device_ms(lambda: fa.flash_attention_plain(q, k, v, bq=bq,
                                                     causal=True), iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_s = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound, by = attn_bound_ms(B, S, S, H, H, D, 2, causal=True)
    rows = {"prefill": (t_k, t_p, t_s, bound, by)}
    print(f"timing K1 qwen2-moe prefill B={B} S={S} Hq=Hkv={H} D={D} bf16 "
          f"causal bq={bq}: kernel (graph) {t_k:.4f} ms, plain (device "
          f"time) {fmt_ms(t_p)}, sdpa (graph) {t_s:.4f} ms, bound "
          f"{bound:.4f} ms ({by}) [{name}]", flush=True)
    del q, k, v, qt, kt, vt
    B, L = dm["B"], dm["L"]
    q = randn(gen, B, 1, H, D, dtype=bf16)
    k, v = (randn(gen, B, L, H, D, dtype=torch.float32) for _ in range(2))
    q_pos = np.full(B, L - 1, np.int32)
    kv_pos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    qp, kvp = (torch.from_numpy(x).cuda() for x in (q_pos, kv_pos))
    t_k = graph_ms(lambda: da.decode_attention(q, k, v, qp, kvp))
    t_p = device_ms(lambda: da.decode_attention_plain(q, k, v, qp, kvp),
                    iters=3)
    qt = q.transpose(1, 2)
    kt, vt = (x.to(bf16).transpose(1, 2) for x in (k, v))
    mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
    t_s = graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    bound, by = decode_bound_ms(q_pos, kv_pos, H, H, D, 2, 4)
    rows["decode"] = (t_k, t_p, t_s, bound, by)
    print(f"timing K2 qwen2-moe decode B={B} L={L} Hq=Hkv={H} (G=1) D={D} "
          f"bf16 q fp32 ring, {da.decode_splits(B, H, L)[0]} splits: "
          f"kernel (graph) {t_k:.4f} ms, plain (device time) {fmt_ms(t_p)}, "
          f"sdpa (graph) {t_s:.4f} ms, bound {bound:.5f} ms ({by}) "
          f"[{name}]", flush=True)
    return k1, k2, rows


def moe_logits(cfg, params, toks, plain, w=None):
    """fp32 logits (B*S, V) of every position of ``toks`` over the real
    vocabulary (plain attention with ``plain``)."""
    from repro_torch.models import forward
    from repro_torch.models.layers import head_weight, lm_head_apply
    hid = forward(cfg, params, tokens=toks, return_hidden=True,
                  plain_attention=plain)
    if w is None:
        w = head_weight(cfg, params.get("lm_head"), params["embed"])
    lg = lm_head_apply(cfg, None, hid, w=w)[..., :cfg.vocab_size]
    return lg.reshape(-1, cfg.vocab_size)


def k1_against_plain(a, b):
    """(max, mean abs logit difference, top-1 agreement) of two paths."""
    d = (a - b).abs()
    return (d.max().item(), d.mean().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def moe_depth_gate(fa, cfg, params, name):
    """32 (a). qwen2-moe in bf16 through K1 and through plain attention
    against fp32, by phase 7's rule, on every position of 2 prompts of
    512 tokens: at one layer (the fp32 copy of that layer), then at 24
    layers (``hidden_fp32_by_layer``: each block cast to fp32 while it
    runs); K1 against plain attention at 24 layers held to
    MOE_DEPTH_FACTORS x the one-layer reading (max, mean, top-1
    disagreement). Returns the readings."""
    from repro_torch.models.layers import head_weight, lm_head_apply
    rng = np.random.default_rng(321)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_SHORT["B"], MOE_SHORT["S"]))).cuda()
    rows = MOE_SHORT["B"] * MOE_SHORT["S"]
    c1, p1 = one_period(cfg, params)
    c32 = dataclasses.replace(c1, dtype="float32")
    readings = {}
    with torch.inference_mode():
        lg = {"kernels bf16": moe_logits(c1, p1, toks, False),
              "plain bf16": moe_logits(c1, p1, toks, True),
              "fp32": moe_logits(c32, to_fp32(p1), toks, True)}
        bf16_rule(against_fp32(lg, "qwen2-moe one layer",
                               f"{rows} positions"), rows, "32 (a)")
        readings[1] = k1_against_plain(lg["kernels bf16"], lg["plain bf16"])
        del lg
        w = head_weight(cfg, params.get("lm_head"), params["embed"])
        k1_0 = fa.flash_attention.launches
        lg = {"kernels bf16": moe_logits(cfg, params, toks, False, w)}
        k1 = fa.flash_attention.launches - k1_0
        lg["plain bf16"] = moe_logits(cfg, params, toks, True, w)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        hid = hidden_fp32_by_layer(cfg, params, toks)
        lg["fp32"] = lm_head_apply(cfg32, None, hid, w=w.float())[
            ..., :cfg.vocab_size].reshape(rows, -1)
        del hid, w
        bf16_rule(against_fp32(lg, f"qwen2-moe {cfg.n_layers} layers",
                               f"{rows} positions"), rows,
                  "32 (a) at 24 layers")
        readings[cfg.n_layers] = k1_against_plain(lg["kernels bf16"],
                                                  lg["plain bf16"])
        del lg
    one, full = readings[1], readings[cfg.n_layers]
    f = MOE_DEPTH_FACTORS
    lim = (f["max"] * one[0], f["mean"] * one[1],
           1 - f["disagree"] * (1 - one[2]))
    print(f"qwen2-moe K1 against plain attention, {rows} positions: one "
          f"layer max {one[0]:.4e} mean {one[1]:.4e} top-1 agreement "
          f"{one[2]:.4f}; {cfg.n_layers} layers ({k1} K1 launches) max "
          f"{full[0]:.4e} mean {full[1]:.4e} agreement {full[2]:.4f} "
          f"(limits {lim[0]:.4e}, {lim[1]:.4e}, at least {lim[2]:.4f}) "
          f"[{name}]", flush=True)
    if k1 != cfg.n_layers or full[0] > lim[0] or full[1] > lim[1] \
            or full[2] < lim[2]:
        raise AssertionError(f"32 (a): K1 launches {k1}; K1 against plain "
                             f"at depth {full} beyond {lim}")
    return readings


def moe_step_breakdown(cfg, params, name, width=16, bucket=128):
    """32 (e). qwen2-moe's decode step at width 16 over bucket 128's ring
    (greedy): the captured program's wall, kernels and device idle
    (``program_reading``), and an uncaptured step's device time by op
    class (the profiler's kernels under a ``record_function`` range
    around each class's function: attention, router, dispatch, expert
    products, combine, shared experts, head; the rest is norms,
    residuals and the embedding). Returns (captured reading, {class:
    ms})."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as am
    from repro_torch.models import forward, make_caches
    from repro_torch.models import moe as mm
    from repro_torch.models import transformer as tm
    from repro_torch.models.layers import head_weight
    from repro_torch.serving.graphs import GraphCache
    rng = np.random.default_rng(325)
    _, toks, lens = prompt_batch(rng, width, 8, bucket - 8, bucket,
                                 cfg.vocab_size)
    tt, lt = (torch.from_numpy(x).cuda() for x in (toks, lens))
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    caches = make_caches(cfg, width, bucket + BIG_NEW, dtype=torch.float32,
                         device="cuda")
    with torch.inference_mode():
        forward(cfg, params, tokens=tt, caches=caches, return_hidden=True)
        tok = tt[:, :1].to(torch.int32)

        def prog(t, p):
            return forward(cfg, params, tokens=t, positions=p, caches=caches,
                           mode="decode", head_w=w)[:, 0]
        gc = GraphCache("cuda")
        args = (tok, lt[:, None])
        cap = program_reading(lambda: gc.run(("moe step",), prog, *args))
        hooks = [(am, "attn_decode", "attention"), (mm, "route", "router"),
                 (mm, "dispatch", "dispatch"), (mm, "gather", "dispatch"),
                 (mm, "experts", "expert products"),
                 (mm, "combine", "combine"),
                 (mm, "shared", "shared experts"), (tm, "_final", "head")]
        orig = [(mod, fn, getattr(mod, fn)) for mod, fn, _ in hooks]

        def labelled(f, label):
            def g(*a, **k):
                with record_function(label):
                    return f(*a, **k)
            return g
        n = 3
        try:
            for mod, fn, label in hooks:
                setattr(mod, fn, labelled(getattr(mod, fn), label))
            prog(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    prog(*args)
                torch.cuda.synchronize()
        finally:
            for mod, fn, f in orig:
                setattr(mod, fn, f)
    del caches
    by = {c: 0.0 for c in MOE_CLASSES}
    for e in prof.events():
        if e.name in by and "cpu" in str(e.device_type).lower():
            by[e.name] += e.device_time_total / n / 1e3
    # the ranges' own device-side spans are not kernels
    total = sum(r[0] for r in kernel_rows(prof, n) if r[2] not in by)
    by["other"] = total - sum(by[c] for c in MOE_CLASSES)
    print(f"qwen2-moe decode step B={width} L={bucket + BIG_NEW} greedy, "
          f"captured: {fmt_reading(cap)}; uncaptured kernels {total:.4f} ms "
          f"by op class: "
          + ", ".join(f"{c} {ms:.4f} ms ({ms / total:.1%})"
                      for c, ms in by.items())
          + f" [{name}]", flush=True)
    return cap, by


def phase_moe_cut(fa, da, name):
    """32 (d). moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b at full width
    cut to MOE_CUT_LAYERS layers (phi3.5's 32 layers take about 84 GB in
    bf16, past one card; moonshot's 48 about 58 GB beside the fp32
    reference): one prefill of 4 prompts of 128 tokens and one decode
    step, through K1/K2 and through plain attention, each against the
    fp32 copy by phase 7's rule over every prefill position and the
    step's rows. Returns {config: (K1, K2 launches)}."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, make_caches
    from repro_torch.models.layers import head_weight, lm_head_apply
    out = {}
    for arch in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=MOE_CUT_LAYERS)
        print(f"{arch}: cut from {full.n_layers} to {cfg.n_layers} layers "
              f"at full width (d {cfg.d_model}, {cfg.moe.num_experts} "
              f"experts top-{cfg.moe.top_k}, d_ff {cfg.moe.expert_d_ff}): "
              f"its {full.n_layers} layers take "
              f"{2 * full.param_count() / 1e9:.1f} GB in bf16, and the "
              f"check needs an fp32 copy beside the bf16 one", flush=True)
        params = init_params(cfg, 0, device="cuda")
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = to_fp32(params)
        B, S = MOE_CUT["B"], MOE_CUT["S"]
        rng = np.random.default_rng(326)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, S))).cuda()
        lg, k1, k2 = {}, 0, 0
        with torch.inference_mode():
            for path, c, p, plain in (("kernels bf16", cfg, params, False),
                                      ("plain bf16", cfg, params, True),
                                      ("fp32", c32, p32, True)):
                caches = make_caches(c, B, S + 8, dtype=torch.float32,
                                     device="cuda")
                w = head_weight(c, p.get("lm_head"), p["embed"])
                l0 = (fa.flash_attention.launches,
                      da.decode_attention.launches)
                hid = forward(c, p, tokens=toks, caches=caches,
                              return_hidden=True, plain_attention=plain)
                pre = lm_head_apply(c, None, hid, w=w)[..., :c.vocab_size]
                step = forward(c, p, tokens=toks[:, :1],
                               positions=torch.full((B, 1), S,
                                                    dtype=torch.int32,
                                                    device="cuda"),
                               caches=caches, mode="decode",
                               plain_attention=plain, head_w=w)
                lg[path] = torch.cat([pre.reshape(-1, c.vocab_size),
                                      step[:, 0, :c.vocab_size]])
                if not plain:
                    k1 = fa.flash_attention.launches - l0[0]
                    k2 = da.decode_attention.launches - l0[1]
                del caches, hid, pre, step
        rows = B * S + B              # every path steps on the same token
        bf16_rule(against_fp32(lg, f"{arch} {cfg.n_layers} layers",
                               f"{B * S} prefill positions + {B} decode "
                               f"rows"), rows, f"32 (d) {arch}")
        print(f"{arch} {cfg.n_layers} layers: K1 launches {k1}, K2 "
              f"launches {k2} [{name}]", flush=True)
        if (k1, k2) != (cfg.n_layers, cfg.n_layers):
            raise AssertionError(f"32 (d) {arch}: K1/K2 launches {k1}, {k2}")
        out[arch] = (k1, k2)
        del params, p32, lg
        gc_mod.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------- 32 (f). qwen2-moe's speculative decoding
MOE_SPEC_K = (3, 4)     # S = 4 <= C = 4 drops no copy; S = 5 may
MOE_SPEC_BUCKET = 128   # 32 (f)'s model-level rings: 128 + BIG_NEW slots


def moe_k2s_row(da, name):
    """32 (f). K2 with S = spec_k + 1 queries a row at qwen2-moe's verify
    shape (G = 1: 16/16 heads of 128, bf16 q, an fp32 ring of bucket
    512's spec engine, 512 + BIG_NEW + spec_k slots, at the plain ring's
    partition), for spec_k 3 and 4 at widths 1 and 16: against its plain
    version within BF16_TOL and bit-equal to S single-query launches;
    then timed at width 16 x 5 queries by ``graph_ms`` beside the plain
    version (profiler), SDPA on the same mask (``graph_ms``) and the
    bound. Returns (max error, settings checked, (ms, plain ms, sdpa ms,
    bound ms, bound by))."""
    from repro_torch.kernels import ops
    m = QWEN2_MOE
    H, D, bf16 = m["Hq"], m["D"], torch.bfloat16
    rng = np.random.default_rng(3271)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3271)
    plain_len = 512 + BIG_NEW
    worst, checked = 0.0, 0
    for k in MOE_SPEC_K:
        L, S = plain_len + k, k + 1
        n_split, per = ops.decode_partition(16, H, plain_len)
        part = dict(n_split=n_split, per_split=per)
        for B in (1, 16):
            q = randn(gen, B, S, H, D, dtype=bf16)
            kc, vc = (randn(gen, B, L, H, D, dtype=torch.float32)
                      for _ in range(2))
            q_pos, kv_pos = spec_ring(rng, B, S, L, plain_len)
            qp, kvp = (torch.from_numpy(x).cuda() for x in (q_pos, kv_pos))
            out = da.decode_attention(q, kc, vc, qp, kvp, **part)
            ref, _ = da.decode_attention_plain(
                q.float(), kc.to(bf16).float(), vc.to(bf16).float(), qp, kvp,
                **part)
            ones = torch.cat([da.decode_attention(
                q[:, s:s + 1], kc, vc, qp[:, s], kvp, **part)
                for s in range(S)], 1)
            err = (out.float() - ref).abs().max().item()
            worst = max(worst, err)
            checked += 1
            if not (torch.allclose(out.float(), ref, atol=BF16_TOL,
                                   rtol=BF16_TOL) and torch.equal(out, ones)):
                raise AssertionError(
                    f"32 (f) K2-S qwen2-moe width {B} S {S}: max_abs_err "
                    f"{err:.3e}, equal to single-query launches "
                    f"{torch.equal(out, ones)}")
    B, S = 16, MOE_SPEC_K[-1] + 1
    L = plain_len + S - 1
    n_split, per = ops.decode_partition(16, H, plain_len)
    q = randn(gen, B, S, H, D, dtype=bf16)
    kc, vc = (randn(gen, B, L, H, D, dtype=torch.float32) for _ in range(2))
    q_pos, kv_pos = spec_ring(rng, B, S, L, plain_len)
    q_pos[:] = (plain_len - S - 1) + np.arange(S)         # every row full
    kv_pos[:, :plain_len] = np.arange(plain_len)
    qp, kvp = (torch.from_numpy(x).cuda() for x in (q_pos, kv_pos))

    def k2s():
        return da.decode_attention(q, kc, vc, qp, kvp, n_split=n_split,
                                   per_split=per)
    t_k = graph_ms(k2s)
    t_p = device_ms(lambda: da.decode_attention_plain(
        q, kc, vc, qp, kvp, n_split=n_split, per_split=per), iters=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    kt, vt = (x.to(bf16).transpose(1, 2) for x in (kc, vc))
    mask = ((kvp[:, None, :] >= 0)
            & (kvp[:, None, :] <= qp[:, :, None]))[:, None]
    t_s = graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
    bound, by = verify_bound_ms(q_pos, kv_pos, H, H, D, 2, 4)
    print(f"32 (f) K2-S at qwen2-moe's verify shape (G=1, D={D}, bf16 q, "
          f"fp32 ring of {plain_len} + spec_k slots, the plain ring's "
          f"partition): spec_k {MOE_SPEC_K} x widths 1 and 16 within "
          f"{BF16_TOL} of plain (worst {worst:.3e}), bit-equal to S "
          f"single-query launches; timed B={B} S={S} L={L}, {n_split} "
          f"splits of {per} tiles: kernel (graph) {t_k:.4f} ms, plain "
          f"(device time) {fmt_ms(t_p)}, sdpa (graph) {t_s:.4f} ms, bound "
          f"{bound:.5f} ms ({by}) [{name}]", flush=True)
    return worst, checked, (t_k, t_p, t_s, bound, by)


def moe_spec_model(cfg, params, name):
    """32 (f) at the model level: 16 prompts in bucket MOE_SPEC_BUCKET
    fill a plain ring of bucket + BIG_NEW slots and a spec ring spec_k
    slots longer (cut at each prompt, as the spec engine's install cuts
    it); then at widths 1 and 16 and spec_k 3 and 4 one random chunk of
    spec_k + 1 tokens a row runs as spec_k + 1 ``decode_step``s in the
    plain ring and as one ``verify_chunk`` in the spec ring (K2 at the
    plain ring's partition, both at ``decode_width`` 16). ``moe.dispatch``
    is wrapped during verify to learn which rows dropped a copy in some
    layer. At spec_k 3 (S = 4 <= C) no copy can drop and every row must
    be bit-equal; at spec_k 4 every row that dropped none must be.
    Returns {(width, spec_k): (rows, rows dropping, rows parted)}."""
    from repro_torch.kernels import ops
    from repro_torch.models import (decode_step, forward, make_caches,
                                    verify_chunk)
    from repro_torch.models import moe as mm
    from repro_torch.models.layers import head_weight
    rng = np.random.default_rng(327)
    W, bucket = 16, MOE_SPEC_BUCKET
    Lp = bucket + BIG_NEW
    part = ops.decode_partition(W, cfg.n_kv_heads, Lp)
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    _, toks, lens = prompt_batch(rng, W, 8, bucket - 8, bucket,
                                 cfg.vocab_size)
    out = {}
    dispatch = mm.dispatch
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = make_caches(cfg, W, Lp + max(MOE_SPEC_K), dtype=torch.float32,
                           device="cuda")
        forward(cfg, params, tokens=torch.from_numpy(toks).cuda(),
                caches=full, return_hidden=True)
        for width in (1, W):
            for k in MOE_SPEC_K:
                plain = {b: {k_: (t[:, :width, :Lp] if t.dim() > 2
                                  else t[:, :width]).clone()
                             for k_, t in blk.items()}
                         for b, blk in full.items()}
                spec = {b: {k_: (t[:, :width, :Lp + k] if t.dim() > 2
                                 else t[:, :width]).clone()
                            for k_, t in blk.items()}
                        for b, blk in full.items()}
                bnd = torch.from_numpy(lens[:width]).cuda()
                for blk in spec.values():             # the install's cut
                    blk["pos"][blk["pos"] >= bnd[None, :, None]] = -1
                    blk["len"].copy_(torch.minimum(blk["len"], bnd[None, :]))
                chunk = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (width, k + 1))).cuda()
                pos = torch.from_numpy(lens[:width, None] + np.arange(
                    k + 1, dtype=np.int32)).cuda()
                want = torch.cat([decode_step(
                    cfg, params, chunk[:, s:s + 1], pos[:, s:s + 1], plain,
                    head_w=w, decode_width=W) for s in range(k + 1)], 1)
                dropped = torch.zeros(width, dtype=torch.bool, device="cuda")

                def counted(cfg_, ids, C):
                    d = dispatch(cfg_, ids, C)
                    dropped.logical_or_(~d[3][:width].all(1))
                    return d
                mm.dispatch = counted
                try:
                    got = verify_chunk(cfg, params, chunk, pos, spec,
                                       head_w=w, partition=part,
                                       decode_width=W)
                finally:
                    mm.dispatch = dispatch
                same = (got == want).flatten(1).all(1)
                drop = dropped.cpu().numpy()
                parted = ~same.cpu().numpy()
                out[(width, k)] = (width, int(drop.sum()), int(parted.sum()))
                print(f"32 (f) verify vs {k + 1} decode steps, width {width}"
                      f" spec_k {k} (C = {mm.capacity(cfg, k + 1)}): rows "
                      f"dropping a copy in some layer {int(drop.sum())}, "
                      f"rows parted {int(parted.sum())} (of them dropping "
                      f"{int((parted & drop).sum())}), max difference "
                      f"{(got - want).abs().max().item():.3e}", flush=True)
                if (parted & ~drop).any() or (k + 1 <= mm.capacity(
                        cfg, k + 1) and drop.any()):
                    raise AssertionError(
                        f"32 (f): at width {width} spec_k {k} "
                        f"{int((parted & ~drop).sum())} rows that dropped "
                        f"no copy part from decode steps")
                del plain, spec
        del full
    print(f"32 (f) model level: verify bit-equal to decode steps on every "
          f"row without a drop, {time.perf_counter() - t0:.1f} s [{name}]",
          flush=True)
    return out


def moe_step_programs(cfg, params, widths):
    """Captured decode-step programs (greedy, bucket MOE_SPEC_BUCKET) at
    each of ``widths`` over prefilled caches: {width: reading}."""
    from repro_torch.models import forward, make_caches
    from repro_torch.models.layers import head_weight
    from repro_torch.serving.graphs import GraphCache
    rng = np.random.default_rng(328)
    bucket, top = MOE_SPEC_BUCKET, max(widths)
    _, toks, lens = prompt_batch(rng, top, 8, bucket - 8, bucket,
                                 cfg.vocab_size)
    tt, lt = (torch.from_numpy(x).cuda() for x in (toks, lens))
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    caches = make_caches(cfg, top, bucket + BIG_NEW, dtype=torch.float32,
                         device="cuda")
    gc = GraphCache("cuda")
    out = {}
    with torch.inference_mode():
        forward(cfg, params, tokens=tt, caches=caches, return_hidden=True)
        for width in widths:
            view = slice_caches(caches, width)
            args = (tt[:width, :1].to(torch.int32), lt[:width, None])

            def prog(t, p, view=view):
                return forward(cfg, params, tokens=t, positions=p,
                               caches=view, mode="decode", head_w=w,
                               decode_width=top)[:, 0]
            out[width] = program_reading(
                lambda: gc.run(("moe step", width), prog, *args), n_wall=5)
    del caches, gc
    return out


def moe_spec_engine(cfg, params, kernels, load, plain, name, *, quant=None,
                    spec_k, timed=False):
    """32 (f). 32 (b)'s load at once through the continuous decoder with
    ``spec_decode`` (``spec_k`` proposals a round, self-drafted: the
    target's first layer), float or int8 weights and KV: one pass, each
    program captured at its first call. K1/K2/K3 launches against the
    window's joins and rounds (K2's S > 1 launches 24 a round); the
    streams against ``plain`` (32 (b)'s of the same load): at spec_k 3
    every stream equal, at spec_k 4 the partings printed. ``timed``: a
    second pass (replays) for tokens/s, and a captured round (bucket
    MOE_SPEC_BUCKET) at widths 1 and 16, wall, kernels and idle. Returns
    (K1..K5 launches, K2's S > 1 launches, {width: reading},
    (streams equal, accept rate, tokens/s))."""
    from repro_torch.launch.experiment import self_draft
    from repro_torch.serving import EngineConfig, ServingEngine
    tag = f"qwen2-moe spec_k {spec_k}" + (" int8 W+KV" if quant else "")
    dcfg, dparams = self_draft(cfg, params)
    t_phase = time.perf_counter()
    eng = ServingEngine(cfg, params, EngineConfig(
        mode="decoder", max_batch=16, pad_buckets=BIG_BUCKETS,
        max_new_tokens=BIG_NEW, weight_quant=quant, kv_quant=quant,
        spec_decode=True, spec_k=spec_k), device="cuda",
        draft=(dcfg, dparams))
    readings, tps = {}, None
    try:
        eng.window()
        reset_launches(kernels)
        results, wall = serve_load(eng, load, 0.0)
        launches = tuple(fn.launches for fn in kernels)
        verify = kernels[1].verify_launches
        win = eng.window()
        captures = eng.metrics()["jit_compiles"]
        if timed:
            results2, wall2 = serve_load(eng, load, 0.0)
            tps = sum(len(r.tokens) for r in results2) / wall2
            if any(not np.array_equal(a.tokens, b.tokens)
                   for a, b in zip(results, results2)):
                raise AssertionError(f"{tag}: the replayed pass differs")
            tok = np.full((16, 1), 7, np.int32)
            pos = (40 + np.arange(16, dtype=np.int32))[:, None]
            for wd in (1, 16):
                readings[wd] = program_reading(
                    lambda: eng._spec_round_call(
                        MOE_SPEC_BUCKET, wd, tok[:wd], pos[:wd],
                        list(range(wd))), n_wall=5)
    finally:
        eng.close()
    del eng
    gc_mod.collect()
    torch.cuda.empty_cache()
    rounds = win["decode_segments"]
    lanes = win["lanes"].values()
    prop = sum(l_["spec_proposed"] for l_ in lanes)
    acc = sum(l_["spec_accepted"] for l_ in lanes)
    n_tok = sum(len(r.tokens) for r in results)
    streams = [np.asarray(r.tokens) for r in results]
    same = [np.array_equal(a, b) for a, b in zip(streams, plain)]
    L, Ld, joins = cfg.n_layers, dcfg.n_layers, win["prefill_batches"]
    want = ((L + Ld) * joins, verify + Ld * (spec_k + 1) * rounds,
            k3_per_layer(cfg) * L * (joins + (spec_k + 1) * rounds)
            if quant else 0, 0, 0)
    print(f"{tag}: {len(load)} requests at once, first pass (captures "
          f"{captures} programs as they come) {wall:.1f} s, {n_tok} tokens; "
          f"rounds {rounds}, proposed {prop}, accepted {acc} (accept rate "
          f"{acc / max(prop, 1):.4f}), {n_tok / max(rounds, 1):.2f} tokens a "
          f"round over its rows; K1..K5 launches {launches} (joins and "
          f"rounds give {want}), K2's S > 1 launches {verify}; against 32 (b)'s plain "
          f"streams {sum(same)} of {len(same)} equal"
          + (f"; second pass (replays) {tps:.1f} tokens/s" if timed else "")
          + f"; {time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)
    for wd, r in readings.items():
        print(f"{tag} round bucket {MOE_SPEC_BUCKET} width {wd} (captured):"
              f" {fmt_reading(r)} [{name}]", flush=True)
    if verify != L * rounds or launches != want:
        raise AssertionError(f"{tag}: K2's S > 1 launches {verify} (want "
                             f"{L} x {rounds}), K1..K5 {launches} != {want}")
    if spec_k + 1 <= 4 and not all(same):
        raise AssertionError(f"{tag}: {same.count(False)} streams differ "
                             f"from plain decoding where no copy can drop")
    return launches, verify, readings, (sum(same), acc / max(prop, 1), tps)


def phase_moe_spec(da, cfg, params, kernels, load, plain, name):
    """32 (f): K2-S at qwen2-moe's verify shape, the model-level gate
    (``moe_spec_model``), then the spec engine on 32 (b)'s load: float
    and int8 W+KV at spec_k 3 (streams equal to plain), float at spec_k 4
    (timed, beside captured 4-step segments: 4 x a captured decode step
    at widths 1 and 16). Returns (K2-S (err, checked, times), model
    readings, {path: K1..K5 launches}, K2's S > 1 launches)."""
    t0 = time.perf_counter()
    k2s = moe_k2s_row(da, name)
    model = moe_spec_model(cfg, params, name)
    out, verify = {}, 0
    for quant, k, timed in ((None, 3, False), ("int8", 3, False),
                            (None, 4, True)):
        label = f"qwen2-moe spec_k {k}" + (" int8 W+KV" if quant else "")
        out[label], n, readings, _ = moe_spec_engine(
            cfg, params, kernels, load, plain[quant], name, quant=quant,
            spec_k=k, timed=timed)
        verify += n
    steps = moe_step_programs(cfg, params, (1, 16))
    for wd, r in steps.items():
        print(f"qwen2-moe captured decode step bucket {MOE_SPEC_BUCKET} "
              f"width {wd}: {fmt_reading(r)}; 4 steps {4 * r[0]:.4f} ms wall "
              f"against the spec_k 4 round's {readings[wd][0]:.4f} ms "
              f"[{name}]", flush=True)
    print(f"32 (f): {time.perf_counter() - t0:.1f} s", flush=True)
    return k2s, model, out, verify


# ------------------------------------------------- 33. MoE training
MOE_TRAIN = dict(B=8, S=512, layers=2, steps=20)
# the two MoE configs too large for AdamW on one card, trained a few steps
# cut in depth: (arch, layers)
MOE_TRAIN_CUT = (("moonshot-v1-16b-a3b", 2), ("phi3.5-moe-42b-a6.6b", 1))
MOE_TRAIN_CUT_STEPS = 3


def moe_train_steps(cfg, params, kernels, bwd, batches, label, oc, *,
                    must_fall=True):
    """``train_step`` over ``batches`` (remat on): each step's launches K1
    2 x layers and K1's backward once a layer, nothing else; the loss
    stays finite and (``must_fall``) falls. Returns (params, opt, losses,
    walls, launches over the steps)."""
    from repro_torch.training import adamw_init, train_step
    from repro_torch.training.tree import leaves
    opt = adamw_init(params)
    losses, walls = [], []
    total = [0] * len(TRAIN_COUNTERS)
    for i, batch in enumerate(batches):
        reset_launches(kernels + bwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = train_step(cfg, oc, params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = train_counts(kernels, bwd)
        check_step_counts(f"{label} step {i}", counts,
                          {"K1": 2 * cfg.n_layers, "K1 bwd": cfg.n_layers})
        total = [a + b for a, b in zip(total, counts)]
        if i % 5 == 0 or i == len(batches) - 1:
            print(f"{label} step {i:3d} loss {losses[-1]:.4f} (nll "
                  f"{float(m['nll']):.4f}, load balance "
                  f"{float(m['load_balance']):.4f}, router z "
                  f"{float(m['router_z']):.4f}) gnorm "
                  f"{float(m['grad_norm']):.3f} wall {walls[-1]:.1f} ms",
                  flush=True)
    if not (all(np.isfinite(losses)) and (losses[-1] < losses[0]
                                          or not must_fall)
            and all(bool(torch.isfinite(x).all()) for x in leaves(params))):
        raise AssertionError(f"{label}: the loss did not fall or went "
                             f"non-finite: {losses}")
    return params, opt, losses, walls, tuple(total)


def phase_train_moe(fa, kernels, bwd, attn_block_sizes, name):
    """33. MoE training on an emptied card. K1's backward at qwen2-moe's
    training shape (B=8 S=512, 16/16 heads of 128, causal, bf16, cluster
    1) against its plain version and timed beside SDPA's backward and its
    bound. qwen2-moe-a2.7b at full width cut to MOE_TRAIN["layers"]
    layers (random weights from seed 0, bf16) on SyntheticLM batches of
    B=8 x 512: the gradient gate of phase 28 on the first batch (kernels
    and plain attention against fp32); two backward calls bit-equal in
    every leaf; MOE_TRAIN["steps"] ``train_step``s, the loss falls; the
    step's wall, kernels, idle share, breakdown and peak memory. Then
    moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b a few steps each, cut
    to MOE_TRAIN_CUT's depths. Returns (K1 bwd (err, checked, times),
    {path: TRAIN_COUNTERS launches}, the qwen2-moe step reading)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import loss_fn, value_and_grad
    from repro_torch.training.tree import flatten
    t_phase = time.perf_counter()
    mem0 = empty_card("33 (MoE training)")
    m, B, S = QWEN2_MOE, MOE_TRAIN["B"], MOE_TRAIN["S"]
    bq = attn_block_sizes("prefill", S, bh=B * m["Hq"], head_dim=m["D"],
                          dtype=torch.bfloat16)[0]
    k1b = phase_k1_bwd_parity(fa, [
        ("qwen2-moe train", B, S, S, m["Hq"], m["Hkv"], m["D"], bq,
         dict(causal=True, kv_len=S))], main="qwen2-moe train")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    k1b_times, _ = k1_bwd_timing(fa, attn_block_sizes, gen,
                                 "qwen2-moe train", B, S, m["Hq"], m["Hkv"],
                                 m["D"], True, None, name)
    full = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN["layers"])
    params = init_params(cfg, 0, device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, seed=0))
    batches = [{"tokens": torch.as_tensor(b["tokens"], device="cuda")}
               for b in data.batches(MOE_TRAIN["steps"])]
    print(f"qwen2-moe-a2.7b training: cut from {full.n_layers} to "
          f"{cfg.n_layers} layers at full width ({cfg.param_count():,} "
          f"parameters; the whole model's AdamW state needs about 12 B a "
          f"parameter, {12 * full.param_count() / 1e9:.0f} GB), B={B} "
          f"S={S} [{name}]", flush=True)
    gradient_gate(cfg, params, lambda c, plain: (
        lambda p: loss_fn(c, p, batches[0], plain_attention=plain)),
        f"qwen2-moe-a2.7b ({cfg.n_layers} layers) B={B} S={S}")
    grads = [value_and_grad(lambda p: loss_fn(cfg, p, batches[0]),
                            params)[1] for _ in range(2)]
    a, b = flatten(grads[0]), flatten(grads[1])
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"33: two backward calls on one batch: {len(a) - len(differ)} of "
          f"{len(a)} leaves bit-equal (the routers' "
          f"{sorted(k for k in a if k.endswith('/router'))})", flush=True)
    if differ:
        raise AssertionError(f"33: leaves whose gradients follow the call: "
                             f"{differ}")
    del grads, a, b
    torch.cuda.empty_cache()
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=MOE_TRAIN["steps"])
    torch.cuda.reset_peak_memory_stats()
    label = f"qwen2-moe-a2.7b ({cfg.n_layers} layers) train"
    params, opt, _, walls, total = moe_train_steps(
        cfg, params, kernels, bwd, batches, label, oc)
    peak = torch.cuda.max_memory_allocated() - mem0
    reading = train_step_reading(
        cfg, oc, params, opt, batches[-1], walls, peak,
        f"{label} step B={B} S={S} bf16 remat (peak over the phase's start)",
        t_phase, name)
    paths = {f"train qwen2-moe-a2.7b ({cfg.n_layers} layers, "
             f"{MOE_TRAIN['steps']} steps)": total}
    del params, opt, batches
    gc_mod.collect()
    torch.cuda.empty_cache()
    for arch, layers in MOE_TRAIN_CUT:
        c = dataclasses.replace(get_config(arch), n_layers=layers)
        p = init_params(c, 0, device="cuda")
        data = SyntheticLM(DataConfig(vocab_size=c.vocab_size, seq_len=S,
                                      batch_size=B // 2, seed=1))
        bt = [{"tokens": torch.as_tensor(x["tokens"], device="cuda")}
              for x in data.batches(MOE_TRAIN_CUT_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        _, _, losses, _, n = moe_train_steps(
            c, p, kernels, bwd, bt, f"{arch} ({layers} layers) train",
            OptConfig(lr=3e-4, warmup_steps=1,
                      total_steps=MOE_TRAIN_CUT_STEPS), must_fall=False)
        print(f"{arch} ({layers} layers, {c.param_count():,} parameters) "
              f"B={B // 2} S={S}: losses {[round(x, 4) for x in losses]}, "
              f"peak {torch.cuda.max_memory_allocated():,} B [{name}]",
              flush=True)
        paths[f"train {arch} ({layers} layers, {MOE_TRAIN_CUT_STEPS} "
              f"steps)"] = n
        del p, bt
        gc_mod.collect()
        torch.cuda.empty_cache()
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return (*k1b, k1b_times), paths, reading


def phase_moe(fa, da, kernels, attn_block_sizes, name):
    """32. qwen2-moe-a2.7b at full width and depth (24 layers, 16/16
    heads of 128 through the fused ``wqkv`` with its bias, 60 experts
    top-4 and 4 shared experts, random weights from ``init_params(
    seed=0)``), bf16, with nothing else on the card: (a) K1 and K2 at its
    shapes against their plain versions and timed; the bf16 rule at one
    layer and at 24 layers, K1 against plain attention gated at depth;
    (b) the default continuous decoder (max_batch 16, buckets 128 and
    512, 32 new tokens): 32 requests, 16 of 8-120 tokens and 16 of
    129-500, half sampled, served twice (``serve_twice``), float and then
    int8 weights and KV; (c) phase 21's rule (``big_program_gates``) and
    phase 22's at joins of 1, 4, 8 and 16 in buckets 128 and 512 and
    decode widths 1 and 16, a prefill run twice; (e) the weights' bytes,
    the peak memory and the captured decode step's breakdown; then (d)
    the two MoE configs too large to serve whole, cut to two layers;
    (f) speculative decoding on (b)'s load (``phase_moe_spec``) before
    (d). Returns (K1/K2 readings, timing rows, {path: K1..K5 launches},
    ``phase_moe_spec``'s readings)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import params_bytes
    mem0 = empty_card("qwen2-moe-a2.7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k1, k2, rows = moe_kernel_rows(fa, da, attn_block_sizes, name)
    cfg = get_config("qwen2-moe-a2.7b")
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    nbytes = params_bytes(params)
    attn = params["blocks"]["blk0"]["attn"]
    print(f"qwen2-moe-a2.7b: {cfg.n_layers} layers drawn in "
          f"{time.perf_counter() - t0:.1f} s, attention leaves "
          f"{ {k: tuple(t.shape) for k, t in attn.items()} }, weight bytes "
          f"{nbytes:,} B ({cfg.param_count():,} parameters) [{name}]",
          flush=True)
    if set(attn) != {"wqkv", "bqkv", "wo"}:
        raise AssertionError("qwen2-moe does not take the fused layout")
    depth = moe_depth_gate(fa, cfg, params, name)
    print(f"qwen2-moe-a2.7b: (a) {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(32)
    load = big_load(cfg, 32, 16, [int(x) for x in rng.integers(129, 501,
                                                              16)])
    base = dict(mode="decoder", max_batch=16, pad_buckets=BIG_BUCKETS,
                max_new_tokens=BIG_NEW)
    out, plain = {}, {None: [], "int8": []}
    for quant in (None, "int8"):
        label = "qwen2-moe-a2.7b" + (" int8 W+KV" if quant else "")
        out[label] = serve_twice(cfg, params, kernels,
                                 dict(base, weight_quant=quant,
                                      kv_quant=quant), load, label, name,
                                 streams=plain[quant])
    print(f"qwen2-moe-a2.7b: (b) {time.perf_counter() - t0:.1f} s",
          flush=True)
    big_program_gates(cfg, params, "qwen2-moe-a2.7b", name, width=16)
    row_bits(cfg, params, "qwen2-moe-a2.7b", buckets=BIG_BUCKETS,
             joins=MOE_JOINS, widths=MOE_WIDTHS, step_bucket=128,
             new_tokens=BIG_NEW)
    print(f"qwen2-moe-a2.7b: (c) {time.perf_counter() - t0:.1f} s",
          flush=True)
    moe_step_breakdown(cfg, params, name)
    peak = torch.cuda.max_memory_allocated() - mem0
    print(f"qwen2-moe-a2.7b: weight bytes {nbytes:,} B; peak device memory "
          f"{peak:,} B over the phase's start; (a)-(c), (e) "
          f"{time.perf_counter() - t0:.1f} s [{name}]", flush=True)
    spec = phase_moe_spec(da, cfg, params, kernels, load, plain, name)
    out.update(spec[2])
    del params
    gc_mod.collect()
    torch.cuda.empty_cache()
    cut = phase_moe_cut(fa, da, name)
    for arch, (n1, n2) in cut.items():
        out[f"{arch} ({MOE_CUT_LAYERS} layers)"] = (n1, n2, 0, 0, 0)
    print(f"phase 32: {time.perf_counter() - t0:.1f} s", flush=True)
    return (k1, k2, depth), rows, out, spec


# ------------------------------------------------------ 34. xlstm-125m
XLSTM_SERVE = dict(max_batch=16, buckets=(128, 512), new=32, chunk=128)
XLSTM_BATCH_BUCKETS = (32, 128)    # (b): the batch decoder steps whole
# prompts; a bucket-512 batch's program took 20-27 s to build on the H100
XLSTM_BLOCK = dict(B=4, S=300)     # (a): past the 256-position chunk seam
XLSTM_BF16_TOL = 5e-2              # (a): bf16 block vs fp32, of its largest
XLSTM_PAR_TOL = dict(out=(2e-3, 2e-2), state=(1e-3, 1e-2))  # JAX's own
XLSTM_TIMED = dict(B=16, S=128)    # (a): one layer's prefill timed
XLSTM_ROW_BUCKETS = (32, 128)      # (c)
XLSTM_JOINS = (1, 2, 4, 8, 15, 16)
XLSTM_WIDTHS = (1, 2, 4, 8, 16)
XLSTM_TRAIN = dict(B=8, S=512, steps=10)


def within(a, b, atol, rtol):
    """max |a - b| - (atol + rtol |b|) <= 0, and that margin's worst."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def xlstm_blocks(cfg, params, name):
    """34 (a). One mLSTM block (blk0, period 0) and the sLSTM block (blk5,
    period 0) of xlstm-125m at full width, on x of (B, S) = XLSTM_BLOCK
    drawn on the card: each bf16 block (the mLSTM from no state, its
    chunkwise-parallel form, and from its initial state, the recurrence;
    the sLSTM's recurrence) against the same block in fp32 on the same
    inputs, within XLSTM_BF16_TOL of the fp32 output's largest magnitude;
    the fp32 mLSTM's parallel form against its recurrence (output and
    final state) at the tolerances JAX holds its own two forms to
    (``tests/test_attention.py:83``). Then one bf16 mLSTM layer's prefill
    of XLSTM_TIMED timed both ways (CUDA events), and the sLSTM's
    recurrence: the cost of a served prefill, which steps. Returns
    {what: ms}."""
    from repro_torch.models import transformer as tm
    from repro_torch.models import xlstm as xm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(34)
    B, S = XLSTM_BLOCK["B"], XLSTM_BLOCK["S"]
    c32 = dataclasses.replace(cfg, dtype="float32")
    times = {}
    with torch.inference_mode():
        for kind in ("mlstm", "slstm"):
            j = cfg.pattern.index(kind)
            p = tm._index_tree(params["blocks"][f"blk{j}"], 0)[kind]
            p32 = to_fp32(p)
            apply = getattr(xm, f"{kind}_apply")
            initial = getattr(xm, f"{kind}_state")
            x16 = randn(gen, B, S, cfg.d_model, dtype=torch.bfloat16)
            x32 = x16.float()
            forms = {"from no state": None}
            if kind == "mlstm":
                forms["recurrence"] = "state"
            ref = {}
            for form, st in forms.items():
                def run(c, pp, x):
                    return apply(c, pp, x, None if st is None
                                 else initial(c, B, device="cuda"))
                got, _ = run(cfg, p, x16)
                ref[form] = run(c32, p32, x32)
                want = ref[form][0]
                if not torch.isfinite(got).all():
                    raise AssertionError(f"34 (a) {kind} {form}: "
                                         f"non-finite bf16 output")
                err = (got.float() - want).abs().max().item()
                scale = want.abs().max().item()
                print(f"34 (a) xlstm-125m {kind} block bf16 vs fp32 "
                      f"({form}), (B, S) = ({B}, {S}): max_abs_err "
                      f"{err:.4e} against the fp32 output's largest "
                      f"{scale:.4e} ({err / scale:.3e}; bound "
                      f"{XLSTM_BF16_TOL})", flush=True)
                if err > XLSTM_BF16_TOL * scale:
                    raise AssertionError(f"34 (a) {kind} {form}: bf16 "
                                         f"strays {err / scale:.3e} of the "
                                         f"fp32 output's largest")
            if kind == "mlstm":
                (par, spar), (rec, srec) = ref["from no state"], \
                    ref["recurrence"]
                margin = {"out": within(par, rec, *XLSTM_PAR_TOL["out"])}
                for k in ("C", "n", "m"):
                    margin[k] = within(spar[k], srec[k],
                                       *XLSTM_PAR_TOL["state"])
                print(f"34 (a) xlstm-125m mlstm fp32 parallel form vs "
                      f"recurrence over {S} positions: worst margin to "
                      f"the bound (atol + rtol |b|, out "
                      f"{XLSTM_PAR_TOL['out']}, states "
                      f"{XLSTM_PAR_TOL['state']}) {margin}; out max "
                      f"difference {(par - rec).abs().max().item():.4e}",
                      flush=True)
                if max(margin.values()) > 0:
                    raise AssertionError(f"34 (a): the mLSTM's two forms "
                                         f"part: {margin}")
            del ref
            Bt, St = XLSTM_TIMED["B"], XLSTM_TIMED["S"]
            xt = randn(gen, Bt, St, cfg.d_model, dtype=torch.bfloat16)
            if kind == "mlstm":
                times["mlstm parallel"] = cuda_ms(
                    lambda: apply(cfg, p, xt), iters=3, warmup=1)
            times[f"{kind} recurrence"] = cuda_ms(
                lambda: apply(cfg, p, xt, initial(cfg, Bt, device="cuda")),
                iters=3, warmup=1)
    print(f"34 (a) one xlstm-125m layer's prefill, B={XLSTM_TIMED['B']} "
          f"S={XLSTM_TIMED['S']} bf16 (CUDA events, uncaptured): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" [{name}]", flush=True)
    return times


@contextlib.contextmanager
def build_clock():
    """Yield a dict that, by the end of the block, maps each program key
    a ``GraphCache`` built in it to the seconds its build took (the
    warm-up run and the capture, the card synchronized around both)."""
    from repro_torch.serving import graphs
    orig = graphs.GraphCache._warm_and_capture
    times = {}

    def timed(self, key, fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, key, fn, args)
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t0
        return out
    graphs.GraphCache._warm_and_capture = timed
    try:
        yield times
    finally:
        graphs.GraphCache._warm_and_capture = orig


def xlstm_serve(cfg, params, kernels, ec, load, label, name, mem0):
    """34 (b). ``ec``'s engine serves ``load`` twice, all requests at
    once: the first pass builds each program at its first call (timed by
    ``build_clock``), the second replays them (and builds a join size it
    had not formed, printed). The passes' streams must be
    equal and the second pass must launch no kernel of K1-K5 (xLSTM runs
    none). Prints tokens/s, the peak device memory over the phase's start
    and every program's build seconds. Returns (K1..K5 launches, the
    second pass's streams, {key: build seconds})."""
    from repro_torch.serving import EngineConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, EngineConfig(**ec), device="cuda")
    try:
        with build_clock() as builds:
            t0 = time.perf_counter()
            first, _ = serve_load(eng, load, 0.0)
            t_first = time.perf_counter() - t0
        reset_launches(kernels)
        with build_clock() as rebuilt:
            second, wall = serve_load(eng, load, 0.0)
        launches = tuple(fn.launches for fn in kernels)
    finally:
        eng.close()
    del eng
    gc_mod.collect()
    peak = torch.cuda.max_memory_allocated() - mem0
    torch.cuda.empty_cache()
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(first, second))
    n_tok = sum(len(r.tokens) for r in second)
    print(f"{label}: first pass (builds {len(builds)} programs as they "
          f"come; the second builds {len(rebuilt)}) "
          f"{t_first:.1f} s; second pass {len(load)} requests, "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
          f"{same} of {len(load)} token-identical across the passes; peak "
          f"device memory {peak:,} B over the phase's start; K1..K5 "
          f"launches {launches} [{name}]", flush=True)
    by_kind = {}
    for key, s in builds.items():
        by_kind.setdefault(key[0], []).append(s)
    print(f"{label}: build seconds (warm-up run + capture) by program: "
          + "; ".join(f"{k!r} {s:.2f}" for k, s in sorted(
              builds.items(), key=lambda kv: -kv[1]))
          + " | by kind: " + ", ".join(
              f"{k} {len(v)} programs {sum(v):.1f} s (max {max(v):.2f})"
              for k, v in by_kind.items()), flush=True)
    if same != len(load) or any(launches):
        raise AssertionError(f"{label}: {same} of {len(load)} streams equal "
                             f"across passes, launches {launches}")
    return launches, [np.asarray(r.tokens) for r in second], builds


def xlstm_step_reading(cfg, params, name, width=16, bucket=128):
    """34 (b). The decode step program at B = ``width`` over states filled
    by a bucket-``bucket`` prefill (greedy). A step advances the states
    it reads, so phase 21's rule runs on the step with the states first
    restored from a copy (a function of its inputs alone): captured,
    replayed in sync debug mode "error", bit for bit against the same
    call uncaptured. Then the step alone, captured and uncaptured, read
    by the profiler (wall, kernels, device idle). Returns the two
    readings."""
    from repro_torch.models import forward, make_caches
    from repro_torch.models.layers import head_weight
    from repro_torch.serving.graphs import GraphCache
    rng = np.random.default_rng(341)
    _, toks, lens = prompt_batch(rng, width, 8, bucket - 8, bucket,
                                 cfg.vocab_size)
    tt, lt = (torch.from_numpy(x).cuda() for x in (toks, lens))
    w = head_weight(cfg, params.get("lm_head"), params["embed"])
    caches = make_caches(cfg, width, bucket + XLSTM_SERVE["new"],
                         dtype=torch.float32, device="cuda")
    label = (f"34 (b) xlstm-125m decode step program B={width} after a "
             f"bucket-{bucket} prefill, greedy")
    with torch.inference_mode():
        forward(cfg, params, tokens=tt, caches=caches, return_hidden=True)
        saved = slice_caches(caches, width)
        args = (tt[:, :1].to(torch.int32), lt[:, None])

        def step(t, p):
            return forward(cfg, params, tokens=t, positions=p, caches=caches,
                           mode="decode", head_w=w,
                           decode_width=width)[:, 0]

        def restored(t, p):
            for b, blk in caches.items():
                for k, t_ in blk.items():
                    t_.copy_(saved[b][k])
            return step(t, p)
        gc = GraphCache("cuda")
        diff = replay_diff(gc, ("restored step",), restored, args,
                           restored(*args))
        print(f"{label}: the step with its states restored, captured "
              f"replay vs direct uncaptured call: max difference {diff} "
              f"(replayed in sync debug mode 'error')", flush=True)
        if diff != 0:
            raise AssertionError(f"{label}: captured differs from "
                                 f"uncaptured by {diff}")
        cap = program_reading(lambda: gc.run(("step",), step, *args))
        unc = program_reading(lambda: step(*args))
    print(f"  captured:   {fmt_reading(cap)} [{name}]", flush=True)
    print(f"  uncaptured: {fmt_reading(unc)} [{name}]", flush=True)
    del caches, saved
    return cap, unc


def xlstm_prefill_reading(cfg, params, name, width=16, bucket=128):
    """34 (b). What a served prefill's steps cost: a join of ``width``
    prompts of ``bucket`` tokens through ``forward`` into caches (the
    recurrence, step by step, as the engine's prefill runs it) captured
    and replayed, against the same tokens without caches (the mLSTM's
    chunkwise-parallel form; the sLSTM steps in both), uncaptured; both
    read by the profiler (wall, kernels, device idle). Returns the two
    readings."""
    from repro_torch.models import forward, make_caches
    from repro_torch.serving.graphs import GraphCache
    rng = np.random.default_rng(342)
    _, toks, _ = prompt_batch(rng, width, bucket, bucket, bucket,
                              cfg.vocab_size)
    tt = torch.from_numpy(toks).cuda()
    caches = make_caches(cfg, width, bucket + XLSTM_SERVE["new"],
                         dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        def stepped(t):
            return forward(cfg, params, tokens=t, caches=caches,
                           return_hidden=True)
        gc = GraphCache("cuda")
        steps = program_reading(lambda: gc.run(("prefill",), stepped, tt),
                                n_wall=5)
        parallel = program_reading(lambda: forward(
            cfg, params, tokens=tt, return_hidden=True), n_wall=5)
    print(f"34 (b) xlstm-125m prefill of a join of {width} at bucket "
          f"{bucket}: into caches, step by step, captured: "
          f"{fmt_reading(steps)}; without caches (the mLSTM's parallel "
          f"form), uncaptured: {fmt_reading(parallel)} [{name}]",
          flush=True)
    del caches
    return steps, parallel


def xlstm_train(cfg, params, kernels, bwd, name, mem0):
    """34 (d). xlstm-125m trained at full size in bf16 on SyntheticLM
    batches of XLSTM_TRAIN (remat on: the mLSTM blocks in their parallel
    form, each query chunk under its own checkpoint; the sLSTM blocks'
    recurrence through ``_SLSTMRecurrence``, its backward through time
    step by step): two backward calls on one batch bit-equal in every
    leaf; XLSTM_TRAIN["steps"] ``train_step``s, each launching no kernel
    of K1-K5 or their backwards, the loss finite and falling; the step's
    wall (the median of steps 2 on), its parts by CUDA events (forward +
    CE without grad, forward + remat + backward, AdamW, and one sLSTM
    block's forward and backward alone) and the peak memory. The
    profiler is left out: a step runs tens of thousands of kernels, and
    the profiler's summary of one took about 50 s on the H100, longer
    than the ten steps.
    Returns (TRAIN_COUNTERS launches over the steps, the losses)."""
    from repro_torch.models import transformer as tm
    from repro_torch.models import xlstm as xm
    from repro_torch.training import OptConfig, adamw_init, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import loss_fn, value_and_grad
    from repro_torch.training.tree import flatten, leaves
    t_phase = time.perf_counter()
    B, S, n = XLSTM_TRAIN["B"], XLSTM_TRAIN["S"], XLSTM_TRAIN["steps"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, seed=0))
    batches = [{"tokens": torch.as_tensor(b["tokens"], device="cuda")}
               for b in data.batches(n)]
    grads = [value_and_grad(lambda p: loss_fn(cfg, p, batches[0]),
                            params)[1] for _ in range(2)]
    a, b = flatten(grads[0]), flatten(grads[1])
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"34 (d) xlstm-125m: two backward calls on one batch (B={B} "
          f"S={S}): {len(a) - len(differ)} of {len(a)} leaves bit-equal "
          f"[{name}]", flush=True)
    if differ:
        raise AssertionError(f"34 (d): leaves whose gradients follow the "
                             f"call: {differ}")
    del grads, a, b
    torch.cuda.empty_cache()
    oc = OptConfig(lr=1e-3, warmup_steps=2, total_steps=n)
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    label = "34 (d) xlstm-125m train"
    losses, walls = [], []
    total = [0] * len(TRAIN_COUNTERS)
    for i, batch in enumerate(batches):
        reset_launches(kernels + bwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = train_step(cfg, oc, params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = train_counts(kernels, bwd)
        check_step_counts(f"{label} step {i}", counts, {})
        total = [x + y for x, y in zip(total, counts)]
        print(f"{label} step {i:3d} loss {losses[-1]:.4f} gnorm "
              f"{float(m['grad_norm']):.3f} wall {walls[-1]:.1f} ms",
              flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and all(bool(torch.isfinite(x).all()) for x in leaves(params))):
        raise AssertionError(f"{label}: the loss did not fall or went "
                             f"non-finite: {losses}")
    peak = torch.cuda.max_memory_allocated() - mem0
    batch = batches[-1]

    def loss_of(p):
        return loss_fn(cfg, p, batch)
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: loss_of(params), iters=1, warmup=0)
    t_vg = cuda_ms(lambda: value_and_grad(loss_of, params), iters=1,
                   warmup=0)
    (_, _), grads = value_and_grad(loss_of, params)
    t_opt = cuda_ms(lambda: adamw_update(oc, params, grads, opt), iters=1,
                    warmup=0)
    del grads
    j = cfg.pattern.index("slstm")
    p = tm._index_tree(params["blocks"][f"blk{j}"], 0)["slstm"]
    x = torch.randn(B, S, cfg.d_model, device="cuda").bfloat16()
    x.requires_grad_()
    t_slstm = cuda_ms(lambda: xm.slstm_apply(cfg, p, x)[0].float().sum()
                      .backward(), iters=1, warmup=0)
    print(f"{label} step B={B} S={S} bf16 remat: wall "
          f"{float(np.median(walls[2:])):.1f} ms (median of steps 2-"
          f"{n - 1}); by events: forward + CE (no grad) {t_fwd:.1f} ms, "
          f"forward + remat + backward {t_vg:.1f} ms, AdamW {t_opt:.1f} "
          f"ms, one sLSTM block's forward and backward alone (of "
          f"{cfg.layer_pattern.count('slstm')}) {t_slstm:.1f} ms; peak "
          f"memory {peak:,} B over the phase's start; (d) "
          f"{time.perf_counter() - t_phase:.1f} s [{name}]", flush=True)
    return tuple(total), losses


def phase_xlstm(kernels, bwd, name):
    """34. xlstm-125m at full size (12 layers: two periods of five mLSTM
    blocks and one sLSTM, d_model 768, 4 heads, vocab 50,304; random
    weights from ``init_params(seed=0)``), bf16, on an emptied card:
    (a) its blocks against fp32 and the mLSTM's two forms against each
    other (``xlstm_blocks``); (b) 32 requests (16 of 8-120 tokens in
    bucket 128, 16 of 129-500 in bucket 512, half sampled, 32 new tokens,
    max_batch 16) served twice through the continuous decoder with
    ``prefill_chunk=128``, and 32 of 8-120 tokens (those 16 and 16 more)
    through the batch-at-a-time decoder in buckets 32 and 128, which
    prefills a batch whole in its longest prompt's bucket
    (``xlstm_serve``: tokens/s, peak memory, build seconds per program),
    the decode step program captured against uncaptured
    (``xlstm_step_reading``) and a join's prefill stepped against the
    parallel form (``xlstm_prefill_reading``); (c) phase 22's rule: row 0
    at joins of XLSTM_JOINS in buckets 32 and 128, padded as the engine
    pads, and at decode widths 1-16 (``row_bits``), bit for bit; (d)
    training
    (``xlstm_train``). No kernel of K1-K5 runs on any of these paths.
    Returns ({serving path: K1..K5 launches}, {training path:
    TRAIN_COUNTERS launches})."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import params_bytes
    t0 = time.perf_counter()
    mem0 = empty_card("34 (xlstm-125m)")
    cfg = get_config("xlstm-125m")
    params = init_params(cfg, 0, device="cuda")
    print(f"xlstm-125m: {cfg.n_layers} layers, pattern {cfg.pattern} x "
          f"{cfg.n_periods}, weight bytes {params_bytes(params):,} B "
          f"({cfg.param_count():,} parameters by the config's count) "
          f"[{name}]", flush=True)
    xlstm_blocks(cfg, params, name)
    print(f"34 (a) {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(34)
    load = big_load(cfg, 34, 16, [int(x) for x in rng.integers(129, 501,
                                                              16)])
    short = [r for r in load if len(r[0]) <= 120]
    short += big_load(cfg, 35, 32 - len(short), [])
    base = dict(mode="decoder", max_batch=XLSTM_SERVE["max_batch"],
                max_new_tokens=XLSTM_SERVE["new"])
    paths = {}
    for path, ec, reqs in (
            ("xlstm-125m batch at a time",
             dict(base, continuous=False, pad_buckets=XLSTM_BATCH_BUCKETS),
             short),
            ("xlstm-125m continuous, prefill_chunk=128",
             dict(base, pad_buckets=XLSTM_SERVE["buckets"],
                  prefill_chunk=XLSTM_SERVE["chunk"]), load)):
        paths[path], _, _ = xlstm_serve(cfg, params, kernels, ec, reqs,
                                        f"34 (b) {path}", name, mem0)
    xlstm_step_reading(cfg, params, name)
    xlstm_prefill_reading(cfg, params, name)
    print(f"34 (b) {time.perf_counter() - t0:.1f} s", flush=True)
    row_bits(cfg, params, "xlstm-125m", buckets=XLSTM_ROW_BUCKETS,
             joins=XLSTM_JOINS, widths=XLSTM_WIDTHS, step_bucket=32,
             new_tokens=XLSTM_SERVE["new"])
    print(f"34 (c) {time.perf_counter() - t0:.1f} s", flush=True)
    gc_mod.collect()
    torch.cuda.empty_cache()
    n_train, _ = xlstm_train(cfg, params, kernels, bwd, name, mem0)
    train = {f"train xlstm-125m ({XLSTM_TRAIN['steps']} steps)": n_train}
    del params
    gc_mod.collect()
    torch.cuda.empty_cache()
    print(f"phase 34: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, train


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core.gector import (gector_forward, init_gector,
                                         predict_tags, tag_head)
    from repro_torch.core.tags import TagVocab
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels.ops import attn_block_sizes
    from repro_torch.models import forward, init_params, make_caches
    from repro_torch.quant import params_bytes, quantize_params
    from repro_torch.serving import EngineConfig, ServingEngine

    t_start = time.perf_counter()

    def clock(label):
        print(f"clock: {label} done at {time.perf_counter() - t_start:.1f} "
              f"s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(f"card: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 1. build every kernel from the checkout's sources
    built = build.build_all()
    for k, b in built.items():
        print(f"built {k} in {b.seconds:.1f} s -> {b.path.name}", flush=True)
    ptxas = {k: ptxas_table(b.log) for k, b in built.items()}
    for k, rows in ptxas.items():
        for inst, (regs, st, ld, stack, smem) in rows.items():
            print(f"ptxas {k}: {inst[:100]}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads, {stack} bytes "
                  f"stack, {smem} bytes static smem", flush=True)
    # the bf16 instantiations the main paths pick must not spill: K1's
    # (with and without the log-sum-exps), K2's, every K3/K4 wgmma and
    # split instantiation (all bf16), and the bf16 ones of K1's backward
    main_insts = {n: r for k in ("flash_attention", "decode_attention",
                                 "int8_matmul", "flash_attention_bwd")
                  for n, r in ptxas[k].items()
                  if any(t in n for t in (
                      "flash_fwd_bf16", "decode_merge",
                      "decode_split<__nv_bfloat16",       # demangled
                      "decode_splitI13__nv_bfloat16",     # mangled
                      "mm_wgmma", "mm_split", "flash_bwd_dkdv_bf16",
                      "flash_bwd_dq_bf16"))}
    spilled = {n: r for n, r in main_insts.items() if r[1] or r[2]}
    mm_insts = [n for n in main_insts if "mm_wgmma" in n or "mm_split" in n]
    bwd_insts = [n for n in main_insts if "flash_bwd" in n]
    if not main_insts or len(mm_insts) != 12 or len(bwd_insts) != 12 \
            or spilled:   # 6 + 6; dkdv and dq at 3 head dims x 2 bq
        raise AssertionError(f"main-path bf16 instantiations spill (or were "
                             f"not all found in the build log: {mm_insts}, "
                             f"{bwd_insts}): {spilled}")

    # ---- 2. K1 against its plain version
    main_err, checked = phase_kernel_parity(fa,
                                            k1_settings(attn_block_sizes))

    # ---- 3. GECToR-base, full width, bf16: K1 forward vs plain attention
    cfg = get_config("gector-base")
    vocab = TagVocab(64)
    params = init_gector(cfg, vocab, 0, device="cuda")
    rng = np.random.default_rng(0)
    toks, mask = padded(sentences(rng, 32, 8, 128, cfg.vocab_size), 128)
    tt = torch.from_numpy(toks).cuda()
    mt = torch.from_numpy(mask).cuda()
    with torch.inference_mode():
        hid = forward(cfg, params["encoder"], tokens=tt, causal=False,
                      return_hidden=True)
        hid_plain = forward(cfg, params["encoder"], tokens=tt, causal=False,
                            return_hidden=True, plain_attention=True)
        tags = tag_head(params, hid, mt)
        tags_plain = tag_head(params, hid_plain, mt)
        logits = gector_forward(cfg, params, tt)[0]
    torch.cuda.synchronize()
    if not (torch.isfinite(hid.float()).all() and tuple(logits.shape) ==
            (32, 128, vocab.n_tags)):
        raise AssertionError("GECToR forward: non-finite or misshapen")
    hid_err = (hid.float() - hid_plain.float()).abs().max().item()
    agree = (tags == tags_plain)[mt].float().mean().item()
    print(f"GECToR-base bf16 bucket 128 x 32: hidden max_abs_err "
          f"{hid_err:.3e} (K1 vs plain attention), tag agreement "
          f"{agree:.4f} on {int(mt.sum())} real tokens", flush=True)
    if agree < TAG_AGREEMENT:
        raise AssertionError(f"tag agreement {agree} < {TAG_AGREEMENT}")
    # where the two bf16 forwards part: both against the same model in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_fp32(params)
    with torch.inference_mode():
        hid32 = forward(cfg32, params32["encoder"], tokens=tt, causal=False,
                        return_hidden=True)
        tags32 = tag_head(params32, hid32, mt)
    vs32 = {}
    for label, h, tg in (("K1 bf16", hid, tags),
                         ("plain bf16", hid_plain, tags_plain)):
        vs32[label] = ((h.float() - hid32).abs().max().item(),
                       (tg == tags32)[mt].float().mean().item())
        print(f"  {label:10s} vs fp32 K1 forward: hidden max_abs_err "
              f"{vs32[label][0]:.3e}, tag agreement {vs32[label][1]:.4f}",
              flush=True)
    del params32, hid32
    (k_err, k_agree), (p_err, p_agree) = vs32["K1 bf16"], vs32["plain bf16"]
    if k_err > HIDDEN_ERR_FACTOR * p_err or \
            1 - k_agree > TAG_FLIP_FACTOR * (1 - p_agree):
        raise AssertionError(
            f"K1 bf16 strays further from fp32 than plain attention does: "
            f"hidden {k_err:.3e} > {HIDDEN_ERR_FACTOR} x {p_err:.3e} or "
            f"tag flips {1 - k_agree:.4f} > {TAG_FLIP_FACTOR} x "
            f"{1 - p_agree:.4f}")

    # ---- 4. the encoder engine: the port's main path
    eng = ServingEngine(cfg, params, EngineConfig(mode="encoder",
                                                  batch_window_ms=200.0),
                        head_fn=tag_head, device="cuda")
    try:
        buckets = (32, 64, 128)
        eng.warmup(buckets=buckets)
        enc_captures = eng._graphs.captures
        eng.discard_samples()
        waves = [sentences(rng, 22, 8, 32, cfg.vocab_size),
                 sentences(rng, 21, 33, 64, cfg.vocab_size),
                 sentences(rng, 21, 65, 120, cfg.vocab_size)]
        kernels = (fa.flash_attention, da.decode_attention,
                   i8.int8_matmul, i8.cache_matmul, rs.rglru_scan)
        reset_launches(kernels)
        results, sent = [], []
        for wave in waves:                 # one burst per bucket
            futs = [eng.submit(s) for s in wave]
            results += [f.result(timeout=300) for f in futs]
            sent += wave
        launches = fa.flash_attention.launches
        enc_k2_launches = da.decode_attention.launches
        enc_mm_launches = (i8.int8_matmul.launches, i8.cache_matmul.launches)
        enc_k5_launches = rs.rglru_scan.launches
        served = eng.window()
        batch_sizes = list(eng.batch_sizes)   # the worker is idle now
        enc_replays = eng._graphs.replays
    finally:
        eng.close()
    n_batches = len(batch_sizes)
    print(f"served {len(results)} requests in {n_batches} batches "
          f"{batch_sizes}; K1 launches {launches}, K3/K4 launches "
          f"{enc_mm_launches}; {enc_captures} programs captured by "
          f"warmup, {enc_replays} replays", flush=True)
    if batch_sizes != [len(w) for w in waves] or enc_replays < n_batches:
        raise AssertionError(f"waves were not served as one captured "
                             f"batch each: {batch_sizes}, {enc_replays} "
                             f"replays")
    # the served tags against direct uncaptured calls on the same batches
    diff = 0
    with torch.inference_mode():
        for w, wave in enumerate(waves):
            bucket = buckets[w]
            t1, m1 = padded(wave, bucket)
            t1, m1 = torch.from_numpy(t1).cuda(), torch.from_numpy(m1).cuda()
            hid1 = forward(cfg, params["encoder"], tokens=t1, causal=False,
                           return_hidden=True)
            want = tag_head(params, hid1, m1).cpu()
            got = torch.stack(results[sum(map(len, waves[:w])):][:len(wave)])
            diff += int((got != want).sum())
    print(f"served tags vs direct uncaptured forward + tag_head on the same "
          f"batches: {diff} tags differ", flush=True)
    if diff:
        raise AssertionError(f"{diff} served tags differ from direct calls")
    if launches != cfg.n_layers * n_batches or launches == 0:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{n_batches} batches of {cfg.n_layers} layers")
    if enc_mm_launches != (0, 0) or enc_k5_launches != 0:
        raise AssertionError("the float encoder launched K3, K4 or K5")
    match = total = 0
    for s, row in zip(sent, results):
        bucket = row.shape[0]
        t1, m1 = padded([s], bucket)
        want = predict_tags(cfg, params, t1, m1)[0]
        match += int((row.numpy()[:len(s)] == want[:len(s)]).sum())
        total += len(s)
    print(f"engine tags vs direct predict_tags: {match}/{total} = "
          f"{match / total:.4f}", flush=True)
    if match / total < TAG_AGREEMENT:
        raise AssertionError("engine results disagree with predict_tags")

    # ---- 5. timings
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    main_times = None
    for B in (8, 32):
        for S in (128, 512):
            H, D = MAIN["H"], MAIN["D"]
            q, k, v = (randn(gen, B, S, H, D, dtype=torch.bfloat16)
                       for _ in range(3))
            bq, _ = attn_block_sizes("prefill", S, bh=B * H,
                                     dtype=torch.bfloat16)

            def k1():
                return fa.flash_attention(q, k, v, causal=False, bq=bq)
            t_k = device_ms(k1)
            t_host = cuda_ms(k1)
            t_p = device_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=False, bq=bq), iters=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            t_s = device_ms(lambda: sdpa(qt, kt, vt))
            bound, by = attn_bound_ms(B, S, S, H, H, D, 2)
            print(f"timing K1 B={B} S={S} H={H} D={D} bf16 bq={bq}, device "
                  f"time: kernel {fmt_ms(t_k)}, plain {fmt_ms(t_p)}, sdpa "
                  f"{fmt_ms(t_s)}, bound {bound:.4f} ms ({by}); kernel by "
                  f"events over back-to-back calls {t_host:.4f} ms "
                  f"[{name}]", flush=True)
            if (B, S) == (MAIN["B"], MAIN["S"]):
                main_times = (t_k if t_k is not None else t_host, t_p, t_s,
                              bound, by)
    k1q_times = phase_qwen2_k1_timing(fa, attn_block_sizes, name)
    phase_breakdown(
        lambda: forward(cfg, params["encoder"], tokens=tt, causal=False,
                        return_hidden=True),
        lambda: forward(cfg, params["encoder"], tokens=tt, causal=False,
                        return_hidden=True, plain_attention=True), name)
    print(f"serve burst (phase 4, batch window 200 ms): "
          f"{served['requests']} requests, p50 "
          f"{served['latency_p50_s'] * 1e3:.3f} ms, p95 "
          f"{served['latency_p95_s'] * 1e3:.3f} ms, mean batch "
          f"{served['batch_size_mean']:.2f} [{name}]", flush=True)
    float_bytes = params_bytes(params)
    del params

    # ---- 6. K2 against its plain version
    k2_err, k2_checked = phase_decode_parity(da, k2_settings())

    # ---- 7. Qwen2-0.5B, full width, bf16: kernel path vs plain vs fp32
    qcfg = get_config("qwen2-0.5b")
    qparams = qwen2_params(qcfg, 0)
    phase_decoder_gates(qcfg, qparams, "Qwen2-0.5B")

    # ---- 8. the decoder engine, batch at a time: the port's second path
    dec_launches, dec_served, n_tok, wall, dec_batches, qfloat_bytes = \
        phase_decoder_engine(qcfg, qparams, kernels)

    # ---- 9. timings
    k2_times = phase_decode_timings(da, name)
    phase_decode_step(qcfg, qparams, name)
    print(f"decoder burst: 48 requests in 3 batches of 16 "
          f"({dec_batches}), {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s, request p50 "
          f"{dec_served['latency_p50_s'] * 1e3:.3f} ms, p95 "
          f"{dec_served['latency_p95_s'] * 1e3:.3f} ms, mean decode serve "
          f"{dec_served['decode_mean_s'] * 1e3:.3f} ms [{name}]", flush=True)

    # ---- 10. K3 and K4 against their plain versions (stablelm-12b's and
    # qwen2-moe-a2.7b's shapes too: phases 30 and 32 serve them with int8
    # weights)
    scfg = get_config("stablelm-12b")
    k3_err, k4_err, mm_checked, k3_moe_errs = phase_matmul_parity(
        i8, (cfg, qcfg, scfg, get_config("qwen2-moe-a2.7b")))

    # ---- 11. GECToR-base, full width, bf16, int8 weights: K3 vs plain
    params = init_gector(cfg, vocab, 0, device="cuda")
    gq = phase_gector_int8(cfg, params, tt, mt, tags)

    # ---- 12. Qwen2-0.5B, full width, bf16, int8 weights and KV
    qq = quantize_params(qparams)
    phase_decoder_gates(qcfg, qq, "Qwen2-0.5B", kv_quant="int8",
                        label=" int8 W+KV")

    # ---- 13. serve with int8 weights (and the int8 KV cache)
    enc8_launches, _, enc8_bytes = phase_encoder_int8_engine(
        cfg, params, kernels, rng)
    dec8_launches, dec8_served, n_tok8, wall8, _, dec8_bytes = \
        phase_decoder_engine(qcfg, qparams, kernels, quant="int8",
                             spans=((65, 120, 128),))
    print(f"weight_bytes: GECToR-base float {float_bytes:,} -> int8 "
          f"{enc8_bytes:,} ({float_bytes / enc8_bytes:.2f}x); Qwen2-0.5B "
          f"float {qfloat_bytes:,} -> int8 {dec8_bytes:,} "
          f"({qfloat_bytes / dec8_bytes:.2f}x); int8 decoder burst: 16 "
          f"requests, {n_tok8} tokens in {wall8:.3f} s, request p50 "
          f"{dec8_served['latency_p50_s'] * 1e3:.3f} ms [{name}]",
          flush=True)

    # ---- 14. timings: K3/K4 at the main shapes, int8 forward and step
    mm_shapes = [(4096, K, N, f"GECToR {names}")
                 for (K, N), names in proj_shapes(cfg).items()]
    for M, what in ((DECODE_MAIN["B"], "decode"), (4096, "prefill")):
        mm_shapes += [(M, K, N, f"Qwen2 {what} {names}")
                      for (K, N), names in proj_shapes(qcfg).items()]
    mm_rows = phase_matmul_timings(i8, mm_shapes, name)
    step_k3 = sum(mm_rows[(DECODE_MAIN["B"], K, N)][0][0] * len(n.split("/"))
                  for (K, N), n in proj_shapes(qcfg).items()) * qcfg.n_layers
    step_bound = sum(mm_rows[(DECODE_MAIN["B"], K, N)][0][2]
                     * len(n.split("/"))
                     for (K, N), n in proj_shapes(qcfg).items()) * \
        qcfg.n_layers
    print(f"K3 per Qwen2-0.5B decode step (B=32, {6 * qcfg.n_layers} "
          f"launches, alone, L2 warm): {step_k3:.4f} ms (target "
          f"{STEP_K3_TARGET_MS} ms) against a bound of {step_bound:.4f} ms "
          f"[{name}]", flush=True)
    forward_profile(lambda: forward(cfg, params["encoder"], tokens=tt,
                                    causal=False, return_hidden=True),
                    "GECToR-base forward B=32 bucket 128 bf16, float", name)
    forward_profile(lambda: forward(cfg, gq["encoder"], tokens=tt,
                                    causal=False, return_hidden=True),
                    "GECToR-base forward B=32 bucket 128 bf16, int8 K3",
                    name)
    phase_decode_step(qcfg, qparams, name, modes=(False,), label=" float")
    phase_decode_step(qcfg, qq, name, kv_quant="int8", modes=(False,),
                      label=" int8 W+KV")

    clock("phases 1-14")

    # ---- 21. captured programs against uncaptured calls, and timed
    phase_captured_programs(cfg, params, qcfg, qparams, name)

    clock("phase 21")

    # ---- 22. one row's bits across batch widths, float and int8: the
    # captured prefill and decode step, the encoder program and the eager
    # decoder
    phase_width_determinism(qcfg, qparams, "float")
    phase_width_determinism(qcfg, qq, "int8 W+KV", kv_quant="int8")
    phase_encoder_widths(cfg, params, "float")
    phase_encoder_widths(cfg, params, "int8", quant="int8")
    phase_eager_decoder_widths(qcfg, qparams, "float")
    phase_eager_decoder_widths(qcfg, qparams, "int8 W+KV", quant="int8")

    clock("phase 22")

    # ---- 23. the default continuous decoder, float and int8
    cont, cont_streams, cont_segs = phase_continuous(qcfg, qparams, kernels,
                                                     name)
    cont8, cont8_streams, cont8_segs = phase_continuous(
        qcfg, qparams, kernels, name, quant="int8")
    phase_continuous_long(qcfg, qparams, name)
    phase_continuous_long(qcfg, qparams, name, quant="int8")

    clock("phase 23")

    # ---- 24. chunked prefill: model level, the chunk program's rows, the
    # continuous engine float and int8, the stall it cuts
    tie, tie8 = phase_chunk_model(qcfg, qparams, qq, name)
    chunk_attention_timings(qcfg, name)
    phase_chunk_rows(qcfg, qparams, name)
    phase_chunk_rows(qcfg, qq, name, kv_quant="int8", label=" int8 W+KV")
    chunked = phase_chunked_continuous(qcfg, qparams, kernels, name, tie)
    chunked8 = phase_chunked_continuous(qcfg, qparams, kernels, name, tie8,
                                        quant="int8")
    stall_reading(qcfg, qparams, name)

    clock("phase 24")

    # ---- 25. the prefix cache, float and int8 KV
    prefix = phase_prefix(qcfg, qparams, kernels, name, tie)
    prefix8 = phase_prefix(qcfg, qparams, kernels, name, tie8,
                           kv_quant="int8")

    clock("phase 25")

    # ---- 27. speculative decoding: K2 with S queries, verify against
    # decode steps, the spec engine against phase 23's streams, float and
    # int8
    k2s_err, k2s_checked, k2s_times = phase_spec_kernel(da, name)
    phase_spec_model(qcfg, qparams, qq, name)
    spec, spec_verify, spec_rounds = phase_spec_engine(
        qcfg, qparams, kernels, name, cont_streams)
    spec8, spec8_verify, spec8_rounds = phase_spec_engine(
        qcfg, qparams, kernels, name, cont8_streams, quant="int8")
    for tag, rd, seg in (("", spec_rounds, cont_segs),
                         (" int8 W+KV", spec8_rounds, cont8_segs)):
        for w, r in rd.items():
            print(f"spec{tag} bucket 128 width {w}: a round (spec_k "
                  f"{SPEC_K}, captured) {fmt_reading(r)}; a 4-step segment "
                  f"(phase 23, captured) {fmt_reading(seg[w])} [{name}]",
                  flush=True)
    del qq, gq
    torch.cuda.empty_cache()

    clock("phase 27")

    # ---- 15. K5 against its plain version
    k5_err, k5_checked = phase_scan_parity(rs)

    # ---- 16. K1 and K2 at head dim 256 against their plain versions
    k1h_err, k1h_checked = phase_kernel_parity(
        fa, k1_settings_256(attn_block_sizes), main="hybrid prefill")
    k2h_err, k2h_checked = phase_decode_parity(
        da, k2_settings_256(), main="hybrid decode shape")

    # ---- 17. RecurrentGemma-9B, full width, bf16: kernel path vs plain vs
    # fp32, at one period (19 layers) so that the fp32 copy of its blocks
    # (about 15 GB, beside the 4.2 GB fp32 embedding) fits beside the bf16
    # model; the tree is a view of the full model's first period
    hcfg = get_config("recurrentgemma-9b")
    hparams = init_params(hcfg, 0, device="cuda")
    h1cfg, h1params = one_period(hcfg, hparams)
    phase_decoder_gates(h1cfg, h1params,
                        f"RecurrentGemma-9B ({h1cfg.n_layers} layers)")
    del h1params
    torch.cuda.empty_cache()

    # ---- 18. serve the hybrid at full depth (38 layers), batch at a time
    hyb_launches, hyb_served, n_tokh, wallh, hyb_batches, hyb_bytes = \
        phase_decoder_engine(hcfg, hparams, kernels,
                             spans=((8, 120, 128),), wave=32,
                             label=" RecurrentGemma-9B")

    # ---- 19. timings: K5, K1/K2 at the hybrid's shapes, prefill and step
    k5_times = phase_scan_timings(rs, name)
    k1h_times = phase_hybrid_k1_timing(fa, attn_block_sizes, name)
    k2h_times = phase_decode_timings(da, name, m=HYBRID_MAIN,
                                     shapes=((1, 144), (32, 144)))
    rng = np.random.default_rng(17)
    _, htoks, _ = prompt_batch(rng, HYBRID_MAIN["B"], 8, 120,
                               HYBRID_MAIN["S"], hcfg.vocab_size)
    htt = torch.from_numpy(htoks).cuda()
    hcaches = make_caches(hcfg, HYBRID_MAIN["B"], HYBRID_MAIN["L"],
                          dtype=torch.float32, device="cuda")
    forward_profile(lambda: forward(hcfg, hparams, tokens=htt,
                                    caches=hcaches, return_hidden=True),
                    f"RecurrentGemma-9B prefill B={HYBRID_MAIN['B']} "
                    f"bucket {HYBRID_MAIN['S']} bf16, {hcfg.n_layers} "
                    f"layers", name, top=14)
    del hcaches
    phase_decode_step(hcfg, hparams, name, modes=(False,),
                      model="RecurrentGemma-9B", top=14)
    print(f"RecurrentGemma-9B decoder burst: {hyb_served['requests']} "
          f"requests in batches {hyb_batches}, {n_tokh} tokens in "
          f"{wallh:.3f} s = {n_tokh / wallh:.1f} tokens/s, request p50 "
          f"{hyb_served['latency_p50_s'] * 1e3:.3f} ms; weight_bytes "
          f"{hyb_bytes:,} [{name}]", flush=True)
    clock("phases 15-19")

    # ---- 22, the hybrid: a row's bits across joins of 1-32 at buckets
    # 32 and 128 (padded to its 448 rows of M; a join of 15 at bucket 32
    # runs 480) and across decode widths
    row_bits(hcfg, hparams, "RecurrentGemma-9B", buckets=(32, 128),
             joins=(1, 2, 4, 8, 15, 16, 32), widths=(1, 2, 4, 8, 16),
             step_bucket=32, new_tokens=NEW_TOKENS)
    # printed beside: the joins padded to 128 (the dense models' floor),
    # 256 and 384 rows of M (a join of 13 then runs 416), the faults the
    # hybrid's floor avoids
    for floor in (128, 256, 384):
        row_bits(hcfg, hparams, f"RecurrentGemma-9B at {floor} rows of M",
                 buckets=(32,), joins=(1, 2, 4, 8, 13, 16, 32),
                 widths=(1, 16),
                 step_bucket=32, new_tokens=NEW_TOKENS, min_m=floor,
                 gate=False)
    clock("phase 22, the hybrid")

    # ---- 24, the hybrid: chunked prefill at full depth
    hyb_chunked = phase_chunked_hybrid(hcfg, hparams, kernels, name)
    del hparams
    torch.cuda.empty_cache()

    clock("phase 24, the hybrid")

    # ---- 20. the paper's ladder through the deploy lab, float and int8
    ladder_launches, ladder8_launches = phase_paper_ladder(kernels, name)

    clock("phase 20")

    # ---- 26. the lab's decoder scenarios
    lab, lab_verify = phase_lab_decoder(kernels, name)

    clock("phase 26")

    # ---- 28. training: the backward kernels against their plain versions
    # and timed; Qwen2-0.5B, GECToR-base and the hybrid (one pattern
    # triple) trained at full width; checkpoints; the spec pair trained
    bwd = (fa.flash_attention_bwd, rs.rglru_scan_bwd)
    k1b_err, k1b_checked = phase_k1_bwd_parity(
        fa, k1_settings(attn_block_sizes) + k1_settings_256(
            attn_block_sizes) + k1_train_settings(attn_block_sizes),
        main="main shape")
    k5b_err, k5b_checked = phase_k5_bwd_parity(rs)
    bwd_rows = phase_bwd_timings(fa, rs, attn_block_sizes, name)
    tq_cfg, tq_params, train_q, _ = phase_train_qwen2(kernels, bwd, name)
    tg_cfg, tg_params, train_g = phase_train_gector(kernels, bwd, name)
    phase_train_checkpoints(tq_cfg, tq_params, tg_cfg, tg_params, name)
    del tq_params, tg_params
    torch.cuda.empty_cache()
    train_h = phase_train_hybrid(kernels, bwd, name)
    torch.cuda.empty_cache()
    phase_spec_trained(name)
    clock("phase 28")

    # ---- 29. K1 and K2 at the new models' shapes (head dims 128 and 160,
    # gemma2's G = 2 and softcap), timed; K3 at stablelm's shapes, timed.
    # Nothing after phase 28 reads GECToR's or Qwen2's trees: the card is
    # emptied for the big models
    del params, qparams, tt, mt
    gc_mod.collect()
    torch.cuda.empty_cache()
    k1n_err, k1n_checked = phase_kernel_parity(
        fa, k1_settings_new(attn_block_sizes), main="stablelm prefill")
    k2n_err, k2n_checked = phase_decode_parity(da, k2_settings_new(),
                                               main="stablelm decode")
    new_rows = phase_new_shape_timings(fa, da, attn_block_sizes, name)
    k3s_rows = phase_matmul_timings(i8, [
        (M, K, N, f"stablelm {what} {names}")
        for M, what in ((16, "decode"), (4096, "prefill"))
        for (K, N), names in proj_shapes(scfg).items()], name,
        int8pack=False)
    mcfg = get_config("qwen2-moe-a2.7b")
    k3m_rows = phase_matmul_timings(i8, [
        (M, K, N, f"qwen2-moe {what} {names}")
        for M, what in ((16, "decode"), (4096, "prefill"))
        for (K, N), names in proj_shapes(mcfg).items()], name,
        int8pack=False)
    clock("phase 29")

    # ---- 30. stablelm-12b at 40 layers: float, int8 W+KV, prefix cache
    big = phase_stablelm(kernels, name)
    gc_mod.collect()
    torch.cuda.empty_cache()
    clock("phase 30")

    # ---- 31. gemma2-27b at 46 layers, fused wqkv, long_ctx at one period
    gem, k2l_err = phase_gemma2(fa, da, kernels, name)
    clock("phase 31")

    # ---- 32. qwen2-moe-a2.7b at 24 layers: float, int8 W+KV, a row's
    # bits; moonshot and phi3.5-moe cut to two layers
    (k1m, k2m, _), moe_rows, moe, moe_spec = phase_moe(
        fa, da, kernels, attn_block_sizes, name)
    k2ms_err, k2ms_checked, k2ms_times = moe_spec[0]
    clock("phase 32")

    # ---- 33. MoE training: qwen2-moe at two layers, K1's backward at its
    # shape, moonshot and phi3.5-moe cut in depth
    k1bm, train_moe, _ = phase_train_moe(fa, kernels, bwd, attn_block_sizes,
                                         name)
    clock("phase 33")

    # ---- 34. xlstm-125m at full size: its blocks against fp32, served
    # through both decoders, a row's bits, trained
    xlstm_serving, xlstm_training = phase_xlstm(kernels, bwd, name)
    clock("phase 34")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    t_k, t_p, t_s, bound, by = main_times
    k2_k, k2_p, k2_s, k2_bound, k2_by = k2_times
    k3_row, k4_row = mm_rows[MM_MAIN]
    k5_k, k5_p, k5_bound, k5_by = k5_times

    def by_path(i, encoder):
        return {"encoder": encoder, "decoder": dec_launches[i],
                "encoder int8": enc8_launches[i],
                "decoder int8": dec8_launches[i],
                "decoder hybrid": hyb_launches[i],
                "ladder float": ladder_launches[i],
                "ladder int8": ladder8_launches[i],
                "continuous": cont[i],
                "continuous int8": cont8[i],
                "chunked": chunked[i], "chunked int8": chunked8[i],
                "chunked hybrid": hyb_chunked[i],
                "prefix (bucket 512)": prefix[i],
                "prefix int8 KV (bucket 512)": prefix8[i],
                "spec": spec[i], "spec int8": spec8[i],
                "lab decoder scenarios": lab[i],
                **train_paths(i), **big_paths(i)}

    def big_paths(i):
        """Launches of counter i on phases 30-32's and 34's paths (the
        second passes, the prefix engine's warm one, and 32 (d)'s cut
        models)."""
        int8 = "stablelm-12b int8 W+KV"
        return {"stablelm-12b": big["stablelm-12b"][i],
                int8: big[int8][i],
                "stablelm-12b prefix": big["stablelm-12b prefix"][i],
                "gemma2-27b": gem[i],
                **{path: n[i] for path, n in moe.items()},
                **{path: n[i] for path, n in xlstm_serving.items()}}

    def train_paths(i):
        """Launches of counter i (TRAIN_COUNTERS) on phases 28, 33 and
        34's paths."""
        return {f"train Qwen2-0.5B ({TRAIN_STEPS} steps)": train_q[i],
                f"train GECToR-base ({GECTOR_TRAIN['steps']} steps)":
                    train_g[i],
                "train RecurrentGemma-9B (one triple, 1 step)": train_h[i],
                **{path: n[i] for path, n in train_moe.items()},
                **{path: n[i] for path, n in xlstm_training.items()}}

    def hybrid_row(times, err=None, checked_256=None):
        ms, plain_ms, lib_ms, bound_ms, bound_by = times
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if err is not None:
            row.update(max_abs_err=err, settings_checked=checked_256)
        return row

    def registers(source, bwd=False):
        return {n: r[0] for n, r in ptxas[source].items()
                if ("bwd" in n) == bwd}
    k1b, k5b = bwd_rows["qwen2 train"], bwd_rows["scan"]
    print(name)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:132",
        "launches": launches, "max_abs_err": main_err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
        "library_ms": t_s, "check": "ok", "settings_checked": checked,
        "visits_checked": True, "launches_by_path": by_path(0, launches),
        "design": "bf16: mma.sync m16n8k16 tensor cores, 16 query rows a "
                  "warp, ldmatrix, bf16 K/V tiles double-buffered by "
                  "cp.async (bk 64, 32 at D=256); fp32: CUDA-core FMAs, "
                  "bk 32",
        "registers": registers("flash_attention"),
        "qwen2_prefill": hybrid_row(k1q_times),
        "head_dim_256": hybrid_row(k1h_times, k1h_err, k1h_checked),
        "stablelm_prefill": dict(
            hybrid_row(new_rows["stablelm prefill"], k1n_err, k1n_checked),
            ms_by="graph_ms (kernel, sdpa); plain by the profiler",
            shape="B=16 S=512 32/8 heads of 160, causal, bf16"),
        "qwen2_moe_prefill": dict(
            hybrid_row(moe_rows["prefill"], *k1m),
            ms_by="graph_ms (kernel, sdpa); plain by the profiler",
            shape="B=16 S=512 16/16 heads of 128, causal, bf16"),
        "gemma2_prefill": dict(
            hybrid_row(new_rows["gemma2 prefill"]),
            ms_by="graph_ms (kernel, sdpa without softcap); plain by the "
                  "profiler",
            shape="B=8 S=512 32/16 heads of 128, causal, softcap 50, "
                  "window 4096, bf16")}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:81",
        "launches": dec_launches[1], "max_abs_err": k2_err, "ms": k2_k,
        "plain_ms": k2_p, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": k2_s, "check": "ok", "settings_checked": k2_checked,
        "visits_checked": True,
        "ms_by": "graph_ms (every K2 row): 20 calls captured in one CUDA "
                 "graph, CUDA events around 5 replays",
        "launches_by_path": by_path(1, enc_k2_launches),
        "design": "split-KV: (B*Hkv, n_split) blocks over 32-slot tiles, "
                  "cp.async of the raw cache type one tile ahead, warp "
                  "partial dots and a transposing shuffle reduction, then "
                  "a merge launch",
        "registers": registers("decode_attention"),
        "head_dim_256": hybrid_row(k2h_times, k2h_err, k2h_checked),
        "head_dim_160": dict(
            hybrid_row(new_rows["stablelm decode"], k2n_err, k2n_checked),
            shape="B=16 L=576 32/8 heads of 160, bf16 q, fp32 ring"),
        "gemma2_decode": dict(
            hybrid_row(new_rows["gemma2 decode"]),
            shape="B=16 L=576 32/16 heads of 128, softcap 50 (sdpa "
                  "without), bf16 q, fp32 ring"),
        "qwen2_moe_decode": dict(
            hybrid_row(moe_rows["decode"], *k2m),
            shape="B=16 L=544 16/16 heads of 128 (G=1), bf16 q, fp32 "
                  "ring"),
        "long_ctx_max_abs_err": k2l_err,
        "verify": dict(hybrid_row(k2s_times, k2s_err, k2s_checked),
                       shape="B=16 S=5 L=532 14/2 heads of 64, bf16 q, "
                             "fp32 ring",
                       launches_by_path={"spec": spec_verify,
                                         "spec int8": spec8_verify,
                                         "lab spec pair (windows)":
                                             lab_verify,
                                         "qwen2-moe spec (32 (f))":
                                             moe_spec[3]}),
        "qwen2_moe_verify": dict(
            hybrid_row(k2ms_times, k2ms_err, k2ms_checked),
            shape="B=16 S=5 L=548 16/16 heads of 128 (G=1), bf16 q, fp32 "
                  "ring")}, {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:50",
        "launches": enc8_launches[2] + dec8_launches[2],
        "max_abs_err": k3_err, "ms": k3_row[0], "plain_ms": k3_row[1],
        "bound_ms": k3_row[2], "bound_by": k3_row[3],
        "library_ms": k3_row[4], "check": "ok",
        "settings_checked": mm_checked // 2,
        "launches_by_path": by_path(2, enc_mm_launches[0]),
        "design": "large M: wgmma m64nNk16 on 128x128 (two warpgroups, "
                  "2 blocks an SM), 128x192 (where it evens out the grid) "
                  "or 64x64 tiles, a 3-4 stage cp.async ring for x, the "
                  "int8 tile loaded to registers two stages ahead and "
                  "converted to bf16 (prmt + fma.bf16x2, exact) into the "
                  "128-byte swizzle while the previous stage multiplies; "
                  "decode M: split-K weight stream, (N/32) x splits from "
                  "(N, K) only, 4 warps a block each with a 3-stage "
                  "cp.async ring, mma.sync with B fragments built in "
                  "registers, the splits of a column tile one cluster "
                  "adding their fp32 partials in split order through "
                  "distributed shared memory; scale once on the fp32 "
                  "total; fp32 x or unaligned rows: masked tiles",
        "registers": registers("int8_matmul"),
        "stablelm": {f"M={M} K={K} N={N}": dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
            rows[0])) for (M, K, N), rows in k3s_rows.items()},
        "qwen2_moe": {f"M={M} K={K} N={N}": dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
            rows[0])) for (M, K, N), rows in k3m_rows.items()},
        "qwen2_moe_max_abs_err": k3_moe_errs}, {
        "name": "cache_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/cache_matmul.py:43",
        "launches": enc8_launches[3] + dec8_launches[3],
        "max_abs_err": k4_err,
        "ms": k4_row[0], "plain_ms": k4_row[1], "bound_ms": k4_row[2],
        "bound_by": k4_row[3], "library_ms": k4_row[4], "check": "ok",
        "settings_checked": mm_checked // 2,
        "launches_by_path": by_path(3, enc_mm_launches[1]),
        "design": "K3's template with a bf16 weight copied by cp.async "
                  "straight into wgmma's MN-major swizzle (read by "
                  "ldmatrix.trans on the split path), no conversion and no "
                  "scale",
        "registers": registers("int8_matmul")}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "launches": hyb_launches[4], "max_abs_err": k5_err, "ms": k5_k,
        "plain_ms": k5_p, "bound_ms": k5_bound, "bound_by": k5_by,
        "library_ms": None, "check": "ok", "settings_checked": k5_checked,
        "launches_by_path": by_path(4, enc_k5_launches),
        "design": "one thread per (b, w) channel, h in a register, 8 steps "
                  "of loads issued ahead",
        "registers": registers("rglru_scan")}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:132",
        "replaces_note": "the TPU kernel has no backward: JAX "
                         "differentiates its jnp attention "
                         "(src/repro/models/attention.py:255)",
        "launches": train_q[5] + train_g[5] + train_h[5]
        + sum(n[5] for n in train_moe.values()),
        "max_abs_err": k1b_err, "ms": k1b[0], "plain_ms": k1b[1],
        "bound_ms": k1b[3], "bound_by": k1b[4], "library_ms": k1b[2],
        "check": "ok", "settings_checked": k1b_checked,
        "visits_checked": True, "lse_checked": True,
        "ms_by": "graph_ms (kernel, plain and library, all three "
                 "shapes): 20 calls (3 for the plain version) captured in "
                 "one CUDA graph, CUDA events around the replays",
        "shape": "B=8 S=512, 14 query heads over 2 kv heads of 64, causal, "
                 "bf16 (Qwen2-0.5B training); library: SDPA's backward",
        "launches_by_path": train_paths(5),
        "ms_by_cluster": bwd_rows["qwen2 train by cluster"],
        "design": "the forward's tiles; bf16: two launches on the "
                  "mma.sync m16n8k16 tensor cores, FlashAttention-2's "
                  "backward: dQ (a warp per 16 query rows, delta = "
                  "rowsum(dO O) first, K/V tiles of the live range through "
                  "a two-stage cp.async ring), then dK/dV (a warp per 16 "
                  "kv rows, two warps splitting the columns at D=256; "
                  "Q/dO/lse/delta streamed by a two-stage cp.async ring; "
                  "S^T and dP^T as C fragments repacked to bf16 A "
                  "fragments for dV += P^T dO and dK += dS^T Q; a thread "
                  "block cluster of c blocks over the query heads of a kv "
                  "head adding their fp32 partials in rank order through "
                  "distributed shared memory, no atomics); fp32: three "
                  "launches of CUDA-core FMAs",
        "registers": registers("flash_attention_bwd", bwd=True),
        "encoder": hybrid_row(bwd_rows["encoder"]),
        "qwen2_moe_train": dict(
            hybrid_row(k1bm[2], k1bm[0], k1bm[1]),
            shape="B=8 S=512, 16/16 heads of 128 (G=1, cluster 1), causal, "
                  "bf16 (qwen2-moe-a2.7b's training shape)"),
        "head_dim_256": dict(
            hybrid_row(bwd_rows["hybrid train"]),
            ms_by_cluster=bwd_rows["hybrid train by cluster"],
            shape="B=2 S=512, 16 query heads over 1 kv head of 256, "
                  "causal, window 2048, bf16 (RecurrentGemma-9B's local "
                  "layers in training)")}, {
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        "replaces_note": "the TPU kernel has no backward: JAX "
                         "differentiates jax.lax.associative_scan "
                         "(src/repro/models/rglru.py:106)",
        "launches": train_h[6], "max_abs_err": k5b_err, "ms": k5b[0],
        "plain_ms": k5b[1], "bound_ms": k5b[3], "bound_by": k5b[4],
        "library_ms": None, "check": "ok", "settings_checked": k5b_checked,
        "ms_by": "graph_ms (kernel and plain): 20 calls (3 for the plain "
                 "version) captured in one CUDA graph, CUDA events around "
                 "the replays",
        "launches_by_path": train_paths(6),
        "design": "the reverse scan, one thread per (b, w) channel, g in a "
                  "register, 8 steps of loads issued ahead",
        "registers": registers("rglru_scan", bwd=True)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
