"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. print the card, build every CUDA kernel from ``src/repro_torch``;
  2. hold K1 (flash attention) against its plain PyTorch version in every
     setting the kernel supports, fp32 and bf16, and its visit counts
     against ``live_block_counts``;
  3. GECToR-base at full width in bf16 (random weights from seed 0): the
     K1 forward against the plain-attention forward on a bucket-128 batch,
     and both against the same model in fp32, where K1's may be no worse
     than plain attention's within a stated factor;
  4. serve 64 sentences through ``ServingEngine(mode="encoder")`` with the
     tag head, check the tags against direct ``predict_tags`` calls and
     that every served batch launched K1 once per layer;
  5. time K1, its plain version and ``scaled_dot_product_attention`` (the
     yardstick; the port never calls it) by the profiler's device time,
     time one serving batch's forward
     and break its device time down by kernel, report the serve latencies.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is missing or the repository's ``src/`` is not beside this file.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
FP32_TOL = 1e-4                    # fp32 kernel vs fp32 plain version
BF16_TOL = 2e-2                    # bf16 kernel vs fp32 plain version
TAG_AGREEMENT = 0.99               # bf16 GEMMs round by batch width
# Against the fp32 forward, the K1 bf16 forward may be at most this much
# worse than the plain-attention bf16 forward: its hidden-state error by
# HIDDEN_ERR_FACTOR, its share of flipped tags by TAG_FLIP_FACTOR.
HIDDEN_ERR_FACTOR = 1.5
TAG_FLIP_FACTOR = 2.0
MAIN = dict(B=32, S=128, H=12, D=64)   # encoder serving shape (bucket 128)


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
    of every kernel it runs, from the profiler (None if it saw none).
    Unlike ``cuda_ms`` this leaves out the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof, iters)
    return sum(r[0] for r in rows) if rows else None


def fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


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


def phase_kernel_parity(fa):
    """K1 against its plain version; returns the main-shape bf16 error."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
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
        ("Sq != Skv", 3, 100, 228, 8, 8, 128, 64, dict(causal=False)),
        ("D=128 causal window kv_len", 2, 200, 200, 4, 2, 128, 64,
         dict(causal=True, window=40, kv_len=170)),
        ("fully masked rows", 2, 160, 160, 4, 4, 64, 32,
         dict(causal=True, window=8, kv_len=100)),
        ("main shape", MAIN["B"], MAIN["S"], MAIN["S"], MAIN["H"],
         MAIN["H"], MAIN["D"], 64, dict(causal=False)),
    ]
    main_err, checked = None, 0
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, B, Sq, Skv, Hq, Hkv, D, bq, kw in settings:
            q = randn(gen, B, Sq, Hq, D, dtype=dtype)
            k = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            v = randn(gen, B, Skv, Hkv, D, dtype=dtype)
            out, visits = fa.flash_attention(q, k, v, bq=bq,
                                             return_visits=True, **kw)
            torch.cuda.synchronize()
            ref, ref_visits = fa.flash_attention_plain(
                q.float(), k.float(), v.float(), bq=bq, **kw)
            err = (out.float() - ref).abs().max().item()
            close = torch.allclose(out.float(), ref, atol=tol,
                                   rtol=0.0 if dtype == torch.float32
                                   else tol)
            want = torch.tensor(fa.live_block_counts(
                Sq, Skv, causal=kw.get("causal", True),
                window=kw.get("window"), bq=bq, bk=fa.BLOCK_K,
                kv_len=kw.get("kv_len")), dtype=torch.int32)
            vis_ok = bool((visits.cpu() == want).all()) and \
                bool((visits == ref_visits).all())
            print(f"K1 {name:28s} {str(dtype):15s} max_abs_err {err:.3e} "
                  f"(tol {tol}) visits {'ok' if vis_ok else 'WRONG'}",
                  flush=True)
            if not (close and vis_ok):
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"{name} {dtype}")
            checked += 1
            if name == "main shape" and dtype == torch.bfloat16:
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
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    return tree.float()


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import attn_block_sizes
    from repro_torch.models import forward
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
    nvcc_log = "\n".join(b.log for b in built.values())
    print("\n".join(line for line in nvcc_log.splitlines()
                    if "registers" in line or "spill" in line))

    # ---- 2. K1 against its plain version
    main_err, checked = phase_kernel_parity(fa)

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
    eng = ServingEngine(cfg, params, EngineConfig(mode="encoder"),
                        head_fn=tag_head, device="cuda")
    try:
        buckets = (32, 64, 128)
        eng.warmup(buckets=buckets)
        eng.discard_samples()
        waves = [sentences(rng, 22, 8, 32, cfg.vocab_size),
                 sentences(rng, 21, 33, 64, cfg.vocab_size),
                 sentences(rng, 21, 65, 120, cfg.vocab_size)]
        fa.flash_attention.launches = 0
        results, sent = [], []
        for wave in waves:                 # one burst per bucket
            futs = [eng.submit(s) for s in wave]
            results += [f.result(timeout=300) for f in futs]
            sent += wave
        launches = fa.flash_attention.launches
        served = eng.window()
        batch_sizes = list(eng.batch_sizes)   # the worker is idle now
    finally:
        eng.close()
    n_batches = len(batch_sizes)
    print(f"served {len(results)} requests in {n_batches} batches "
          f"{batch_sizes}; K1 launches {launches}", flush=True)
    if launches != cfg.n_layers * n_batches or launches == 0:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{n_batches} batches of {cfg.n_layers} layers")
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
            bq, _ = attn_block_sizes("prefill", S, bh=B * H)

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
    phase_breakdown(
        lambda: forward(cfg, params["encoder"], tokens=tt, causal=False,
                        return_hidden=True),
        lambda: forward(cfg, params["encoder"], tokens=tt, causal=False,
                        return_hidden=True, plain_attention=True), name)
    print(f"serve burst: {served['requests']} requests, p50 "
          f"{served['latency_p50_s'] * 1e3:.3f} ms, p95 "
          f"{served['latency_p95_s'] * 1e3:.3f} ms, mean batch "
          f"{served['batch_size_mean']:.2f} [{name}]", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    t_k, t_p, t_s, bound, by = main_times
    print(name)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:132",
        "launches": launches, "max_abs_err": main_err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
        "library_ms": t_s, "check": "ok", "settings_checked": checked,
        "visits_checked": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
