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
     K2's own split count for the width;
 23. Qwen2-0.5B at full width through the default continuous decoder
     (lanes over buckets 32/64/128, the KV pool, adaptive width tiers,
     ``warmup(sampled=True)`` capturing every program): 48 greedy and
     sampled requests of mixed lengths arriving 2 ms apart; every
     request's tokens, exactly, against the same load through fixed
     width and batch at a time (the engine pads each prefill to the M
     where phase 22 finds a row's bits independent of the batch), a
     measured window that captures nothing, K1/K2/K3
     launches against its prefill batches and segments, the
     untouched-slot property bitwise on the pool, each width tier's
     segment captured against uncaptured, and device memory; float,
     then int8 weights and KV; then 32 staggered requests of 257-500
     tokens in bucket 512 at max_batch 32, adaptive against fixed width
     and batch at a time (the continuous engines' second pass, whose
     occupancy moves across the width tiers), float and int8.

Prints a ``{"kernels": [...]}`` line (each kernel with its design and
its instantiations' registers), then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is missing or the repository's ``src/`` is not beside this file.
"""
from __future__ import annotations

import dataclasses
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


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """The card's own time for one call of ``fn``: the summed device time
    of every kernel it runs, from the profiler (None if it saw none in
    two tries).
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
        if rows:
            return sum(r[0] for r in rows)
    return None


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
    for fn in kernels:
        fn.launches = 0


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
    """K2 by device time at each (B, L) of ``shapes`` (default: B in {1,
    8, 32} x L in {144, 528}) with ``m``'s heads (default Qwen2's, 14 / 2
    of 64), bf16 q over an fp32 cache, every slot live; beside it its
    bound, plain version and SDPA. Returns the row of ``m``'s (B, L)."""
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
        t_k = device_ms(k2)
        t_ev = cuda_ms(k2)
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
              f"device time (both launches): kernel "
              f"{fmt_ms(t_k)}, plain {fmt_ms(t_p)}, sdpa {fmt_ms(t_s)}, "
              f"bound {bound:.5f} ms ({by}); kernel by events over "
              f"back-to-back calls {t_ev:.4f} ms [{name}]", flush=True)
        if (B, L) == (m["B"], m["L"]):
            main = (t_k if t_k is not None else t_ev, t_p, t_s, bound, by)
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
    ``qeinsum``'s (M, K) x (K, N) view."""
    d, hd = cfg.d_model, cfg.head_dim_
    q, kv, f = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff
    mlp = [("w_in", d, 2 * f)] if cfg.gated_mlp else [("w_up", d, f)]
    shapes = {}
    for name, K, N in [("wq", d, q), ("wk", d, kv), ("wv", d, kv),
                       ("wo", q, d), *mlp, ("w_down", f, d)]:
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
    main paths (GECToR-base's and Qwen2-0.5B's projections) for M = 1,
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
    and K4's bf16 error at MM_MAIN, settings checked)."""
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
            errs[("K4", *MM_MAIN, torch.bfloat16)], checked)


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


def phase_matmul_timings(i8, shapes, name):
    """K3 and K4 by device time at the main paths' shapes, bf16 x, beside
    the bound, the plain version and one PyTorch call as the yardstick:
    ``torch.matmul`` of x with the weight dequantized beforehand to bf16
    (the float path's GEMM; the port never calls it) and, where this
    PyTorch has it on CUDA, ``torch._weight_int8pack_mm`` (its scales are
    bf16). Each kernel's time is printed as a factor of ``torch.matmul``
    beside its target (not gated). Returns {(M, K, N): (K3 row, K4 row)},
    a row (ms, plain ms, bound ms, bound by, library ms); a kernel's ms is
    its event time where the profiler saw no kernel."""
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
        pack = "not in this PyTorch"
        if hasattr(torch, "_weight_int8pack_mm"):
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
        t3 = t3 if t3 is not None else cuda_ms(k3)
        t4 = t4 if t4 is not None else cuda_ms(k4)
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
    widths = sorted({b * LADDER_BUCKET for b in batches8})
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


def cont_load(cfg, seed):
    """The continuous phase's 48 requests: 16 per (shortest, longest
    prompt, bucket) of ``CONT_SPANS``, every other one sampled
    (temperature 0.8, top_k 50, its own seed), shuffled."""
    from repro_torch.serving.api import SamplingParams
    rng = np.random.default_rng(seed)
    load = []
    for lo, hi, _ in CONT_SPANS:
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
    on the pool's bytes; each tier's segment captured against
    uncaptured. ``quant="int8"`` serves int8 weights and KV. Every
    request's tokens must be the same in all three engines. Returns the
    window's K1..K5 launches."""
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
        tier_timings(eng, 128, name, tag)
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
    return launches


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
    """Each width tier's decode segment (``decode_segment`` steps) of the
    engine's bucket, captured (a replay of its program): wall, kernels
    and device idle share; at the smallest and the largest tier also the
    same program called uncaptured."""
    for width in eng._tiers:
        slots = list(range(width))
        rows = (np.full((width, 1), 7, np.int32),
                np.full((width, 1), 5, np.int32), np.ones(width, bool),
                np.full(width, 99, np.int32), np.full(width, -1, np.int32))
        compact = width < eng.ec.max_batch
        kw = dict(slots=slots) if compact else {}
        cap = program_reading(lambda: eng._segment_call(bucket, width, rows,
                                                        **kw), n_wall=5)
        if width not in (eng._tiers[0], eng._tiers[-1]):
            print(f"continuous{tag} segment bucket {bucket} width {width} "
                  f"({eng.ec.decode_segment} steps): captured "
                  f"{fmt_reading(cap)} [{name}]", flush=True)
            continue
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
        unc = program_reading(direct, n=1, n_wall=3)
        print(f"continuous{tag} segment bucket {bucket} width {width} "
              f"({eng.ec.decode_segment} steps): captured "
              f"{fmt_reading(cap)}; uncaptured {fmt_reading(unc)} "
              f"[{name}]", flush=True)


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
    # the bf16 instantiations the main paths pick must not spill: K1's,
    # K2's, and every K3/K4 wgmma and split instantiation (all bf16)
    main_insts = {n: r for k in ("flash_attention", "decode_attention",
                                 "int8_matmul")
                  for n, r in ptxas[k].items()
                  if any(t in n for t in (
                      "flash_fwd_bf16", "decode_merge",
                      "decode_split<__nv_bfloat16",       # demangled
                      "decode_splitI13__nv_bfloat16",     # mangled
                      "mm_wgmma", "mm_split"))}
    spilled = {n: r for n, r in main_insts.items() if r[1] or r[2]}
    mm_insts = [n for n in main_insts if "mm_wgmma" in n or "mm_split" in n]
    if not main_insts or len(mm_insts) != 12 or spilled:   # 6 + 6
        raise AssertionError(f"main-path bf16 instantiations spill (or were "
                             f"not all found in the build log: {mm_insts}): "
                             f"{spilled}")

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

    # ---- 10. K3 and K4 against their plain versions
    k3_err, k4_err, mm_checked = phase_matmul_parity(i8, (cfg, qcfg))

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

    # ---- 21. captured programs against uncaptured calls, and timed
    phase_captured_programs(cfg, params, qcfg, qparams, name)

    # ---- 22. one row's bits across batch widths, float and int8
    phase_width_determinism(qcfg, qparams, "float")
    phase_width_determinism(qcfg, qq, "int8 W+KV", kv_quant="int8")

    # ---- 23. the default continuous decoder, float and int8
    cont = phase_continuous(qcfg, qparams, kernels, name)
    cont8 = phase_continuous(qcfg, qparams, kernels, name, quant="int8")
    phase_continuous_long(qcfg, qparams, name)
    phase_continuous_long(qcfg, qparams, name, quant="int8")
    del qq, gq
    torch.cuda.empty_cache()

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
    del hparams
    torch.cuda.empty_cache()

    # ---- 20. the paper's ladder through the deploy lab, float and int8
    ladder_launches, ladder8_launches = phase_paper_ladder(kernels, name)
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
                "continuous int8": cont8[i]}

    def hybrid_row(times, err=None, checked_256=None):
        ms, plain_ms, lib_ms, bound_ms, bound_by = times
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if err is not None:
            row.update(max_abs_err=err, settings_checked=checked_256)
        return row

    def registers(source):
        return {n: r[0] for n, r in ptxas[source].items()}
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
        "head_dim_256": hybrid_row(k1h_times, k1h_err, k1h_checked)}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:81",
        "launches": dec_launches[1], "max_abs_err": k2_err, "ms": k2_k,
        "plain_ms": k2_p, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": k2_s, "check": "ok", "settings_checked": k2_checked,
        "visits_checked": True,
        "launches_by_path": by_path(1, enc_k2_launches),
        "design": "split-KV: (B*Hkv, n_split) blocks over 32-slot tiles, "
                  "cp.async of the raw cache type one tile ahead, warp "
                  "partial dots and a transposing shuffle reduction, then "
                  "a merge launch",
        "registers": registers("decode_attention"),
        "head_dim_256": hybrid_row(k2h_times, k2h_err, k2h_checked)}, {
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
        "registers": registers("int8_matmul")}, {
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
        "registers": registers("rglru_scan")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
