"""Time the continuous decoder's captured programs on one NVIDIA H100:
the decode segment at its narrowest and its widest width tier, and a
join of one prompt's prefill at each bucket, so that two checkouts can
be compared on one card. The model (bf16, random weights from seed 0)
runs through the continuous engine as ``chip_smoke.py``'s phase 23
builds it (max_batch 16, buckets 32/64/128, 16 new tokens, 4-step
segments); Qwen2-0.5B float and int8 W+KV, RecurrentGemma-9B float (its
int8 weights are not ported). The segment runs over bucket 128.

    python3 chip_decode_ab.py [--src DIR] [--label NAME] [--blas LIB]
                              [--model NAME]

``--src`` is the directory ``repro_torch`` is imported from (default:
``src`` beside this file), so that a second checkout unpacked under a
git-ignored directory (``git archive``) is timed by the same script; each
checkout builds its kernels under its own ``build/``. ``--blas cublas``
or ``cublaslt`` sets PyTorch's preferred BLAS library after the import
(default: whatever the checkout sets). ``--model`` is ``qwen2-0.5b``
(default) or ``recurrentgemma-9b``. Walls on the host's clock move
between machines and calls, so compare two checkouts only within one
call, run as A, B, B, A. For each (weights, program) it prints one JSON
line: the program's walls (host clock, one replay with its input and
output copies a call; 40 calls after the capture and 3 more), their
median, the summed device time of its kernels over one more call under
the profiler, and the tokens of the first row, so that two checkouts
can be seen to serve the same tokens. The card's name and power limit
come first. Exits non-zero without a result when CUDA is missing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ENGINE = dict(mode="decoder", max_batch=16, pad_buckets=(32, 64, 128),
              max_new_tokens=16)
BUCKET = 128
CALLS = 40


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernels_ms(fn):
    """Summed device time (ms) of the kernels of one call of ``fn`` under
    the profiler, or None where it saw none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            busy += dev / 1e3
    return busy or None


def timed(call):
    """(first result, walls ms, median ms, kernels ms) of ``call``: the
    first call captures its program, 3 more warm it."""
    out = call()
    for _ in range(3):
        call()
    walls = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls, float(np.median(walls)), kernels_ms(call)


def programs(label, model, quant):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = get_config(model)
    params = init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, EngineConfig(
        **ENGINE, weight_quant=quant, kv_quant=quant), device="cuda")
    head = {"label": label, "model": model, "weights": quant or "bf16",
            "blas": str(torch.backends.cuda.preferred_blas_library())}
    rng = np.random.default_rng(5)
    for bucket in ENGINE["pad_buckets"]:
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :bucket - 3] = rng.integers(0, cfg.vocab_size, bucket - 3)
        lens = np.array([bucket - 3], np.int32)
        first, walls, med, kms = timed(
            lambda: eng._prefill_call(bucket, toks, lens, [0]))
        print(json.dumps({**head, "program": "prefill", "join": 1,
                          "bucket": bucket, "median_ms": med,
                          "walls_ms": [round(w, 4) for w in walls],
                          "kernels_ms": kms,
                          "first_token": first.tolist()}), flush=True)
    for width in (eng._tiers[0], eng._tiers[-1]):
        rows = (np.full((width, 1), 7, np.int32),
                np.full((width, 1), 5, np.int32), np.ones(width, bool),
                np.full(width, 99, np.int32), np.full(width, -1, np.int32))
        kw = (dict(slots=list(range(width)))
              if width < eng.ec.max_batch else {})
        out, walls, med, kms = timed(
            lambda: eng._segment_call(BUCKET, width, rows, **kw))
        print(json.dumps({**head, "program": "segment", "bucket": BUCKET,
                          "width": width, "steps": eng.ec.decode_segment,
                          "median_ms": med,
                          "walls_ms": [round(w, 4) for w in walls],
                          "kernels_ms": kms,
                          "row0_tokens": out[0][0].tolist()}), flush=True)
    del eng, params
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--blas", choices=("cublas", "cublaslt"))
    ap.add_argument("--model", default="qwen2-0.5b",
                    choices=("qwen2-0.5b", "recurrentgemma-9b"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available: the segments run on the card",
              file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  (its import may set the BLAS library)
    if args.blas:
        torch.backends.cuda.preferred_blas_library(args.blas)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    for quant in ((None, "int8") if args.model == "qwen2-0.5b"
                  else (None,)):
        programs(args.label, args.model, quant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
