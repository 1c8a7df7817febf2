"""Time K3 (int8_matmul) and K4 (cache_matmul) under every plan the CUDA
source is built for, on one NVIDIA H100, to check `matmul_plan`'s choices.

    python3 chip_sweep.py

Device time by the profiler (as `chip_smoke.py`'s phase 14: L2 warm,
summed kernel time over 20 calls after 3 warm-up calls), bf16 x, at the
main paths' projection shapes, beside one `torch.matmul` on the weight
dequantized to bf16 (the yardstick; the port never calls it):
  1. large M (4096): each shape at every wgmma tile (128 x 128, 128 x
     192, 64 x 64) and at the masked 128 x 128 x 32 tile, the first
     port's design;
  2. decode M (32): each shape at every split count of whole 128-row
     stages up to the cluster limit of 16, and at the masked 32 x 32 x
     128 tile; Qwen2-0.5B's w_in also at M = 1, 8 and 16;
each result held against the plain version (2e-2 of the output's
largest value). The plan's own choice is marked with "*". Exits non-zero
without a result when CUDA is missing or `src/` is not beside this file.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import BF16_TOL, device_ms, int8_inputs


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(i8, fn, x, w, extra, plan, ref):
    """(device ms, relative error) of K3 (extra = (scale,)) or K4."""
    out = fn(x, w, *extra, plan=plan)
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    if err > BF16_TOL:
        raise AssertionError(f"{fn.__name__} at {plan}: error {err:.3e}")
    return device_ms(lambda: fn(x, w, *extra, plan=plan)), err


def sweep(i8, M, K, N, plans, label, name):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + K + N)
    x, qw, scale = int8_inputs(gen, M, K, N, torch.bfloat16)
    w = (qw.float() * scale).bfloat16()
    ref3 = i8.int8_matmul_plain(x.float(), qw, scale).float()
    ref4 = i8.cache_matmul_plain(x.float(), w).float()
    lib = device_ms(lambda: torch.matmul(x, w))
    chosen = i8.matmul_plan(M, N, K)
    print(f"M={M} K={K} N={N} {label}: torch.matmul {lib:.4f} ms [{name}]",
          flush=True)
    for plan in plans:
        t3, _ = timed(i8, i8.int8_matmul, x, qw, (scale,), plan, ref3)
        t4, _ = timed(i8, i8.cache_matmul, x, w, (), plan, ref4)
        mark = "*" if plan == chosen else " "
        print(f"  {mark} {plan.path:6s} {str(plan.tile):15s} x{plan.splits:<2d}"
              f" K3 {t3:.4f} ms = {t3 / lib:.2f}x, K4 {t4:.4f} ms = "
              f"{t4 / lib:.2f}x", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_sweep: CUDA is not available", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_sweep: {src}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels.int8_matmul import TILES, Plan
    name = card()
    print(f"card: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    large = [(768, 768, "GECToR wq/wk/wv/wo"), (768, 3072, "GECToR w_up"),
             (3072, 768, "GECToR w_down"), (896, 896, "Qwen2 wq/wo"),
             (896, 128, "Qwen2 wk/wv"), (896, 9728, "Qwen2 w_in"),
             (4864, 896, "Qwen2 w_down")]
    for K, N, label in large:
        plans = [Plan("wgmma", t, 1, K) for t in TILES["wgmma"]]
        plans.append(Plan("masked", TILES["masked"][0], 1, K))
        sweep(i8, 4096, K, N, plans, label, name)
    tile, bk = TILES["split"][0], TILES["split"][0][2]
    for K, N, label in large:
        steps = -(-K // bk)
        slabs = sorted({-(-steps // s) * bk for s in range(1, steps + 1)})
        plans = [Plan("split", tile, -(-K // k), k) for k in slabs
                 if -(-K // k) <= i8.MAX_SPLITS]
        plans.append(Plan("masked", TILES["masked"][1], 1, K))
        sweep(i8, 32, K, N, plans, label, name)
    for M in (1, 8, 16):
        sweep(i8, M, 896, 9728, [i8.matmul_plan(M, 9728, 896)],
              "Qwen2 w_in", name)
    print(name)
    print("chip_sweep: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
