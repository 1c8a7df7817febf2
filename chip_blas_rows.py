"""Does a row's bits of a bf16 matrix product follow M on the card?

    python3 chip_blas_rows.py

For the projections of every model the port serves (GECToR-base,
Qwen2-0.5B, RecurrentGemma-9B, stablelm-12b, gemma2-27b: (K, N) of x (M,
K) @ w (K, N)), the first rows of ``x[:M] @ w`` against the same rows at
a reference M, under PyTorch's cuBLAS and under cublasLt
(``torch.backends.cuda.preferred_blas_library``): prefill sizes (M =
128..16384 against 128, the serving engine's ``PREFILL_MIN_M``) and
decode widths (M = 1..32 against 16). Prints, per library and range,
the shapes whose rows part and by how much, and each library's summed
time of the projections at M = 8192 and 16 (CUDA events, 20 calls after
3), beside the card's name and power limit. Exits non-zero without CUDA.

    python3 chip_blas_rows.py --scan K N [--fp32] [LO HI STEP]

prints instead, under cublasLt, the groups of M (LO to HI in steps of
STEP, default 128 to 4096 by 32) whose first LO rows of ``x[:M] @ w``
are the same bits, for one (K, N), in bf16 or (``--fp32``) fp32: where
a prefill's M may fall for a model with that product.
The port prefers cublasLt on the card (set when ``repro_torch`` is
imported) and pads a decode step's rows to the engine's ``max_batch``
(``forward``'s ``decode_width``); this script is the measurement behind
both.
"""
from __future__ import annotations

import subprocess
import sys

import torch

# (K, N) of the served models' projections, as qeinsum flattens them
SHAPES = {
    "gector-base": [(768, 768), (768, 3072), (3072, 768)],
    "qwen2-0.5b": [(896, 896), (896, 128), (896, 9728), (4864, 896)],
    "recurrentgemma-9b": [(4096, 4096), (4096, 256), (4096, 24576),
                          (12288, 4096)],
    "stablelm-12b": [(5120, 5120), (5120, 1280), (5120, 27648),
                     (13824, 5120)],
    "gemma2-27b": [(4608, 8192), (4096, 4608), (4608, 73728),
                   (36864, 4608)],
}
RANGES = {"prefill": ((128, 256, 384, 512, 1024, 2048, 4096, 8192, 16384),
                      128),
          "decode": ((1, 2, 4, 8, 16, 32), 16)}


def parts(gen):
    """{range: [(model, K, N, {M: max |diff|})]} of the shapes whose rows
    part, and {range: summed ms at the timing M}."""
    bad, ms = {}, {}
    for rng, (Ms, ref_m) in RANGES.items():
        bad[rng], total = [], 0.0
        for model, shapes in SHAPES.items():
            for K, N in shapes:
                w = (torch.randn(K, N, device="cuda", generator=gen)
                     / K ** 0.5).bfloat16()
                x = torch.randn(max(Ms), K, device="cuda",
                                generator=gen).bfloat16()
                ref = (x[:ref_m] @ w).float()
                d = {}
                for M in Ms:
                    n = min(M, ref_m)
                    d[M] = ((x[:M] @ w)[:n].float() - ref[:n]).abs().max()
                d = {M: v.item() for M, v in d.items()}
                if any(d.values()):
                    bad[rng].append((model, K, N, d))
                xt = x[:8192 if rng == "prefill" else 16]
                for _ in range(3):
                    xt @ w
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(20):
                    xt @ w
                t1.record()
                torch.cuda.synchronize()
                total += t0.elapsed_time(t1) / 20
        ms[rng] = total
    return bad, ms


def scan(K, N, Ms=range(128, 4097, 32), dtype=torch.bfloat16):
    """Groups of M (in order of first appearance) whose first min(Ms)
    rows of a (M, K) x (K, N) product in ``dtype`` are the same bits."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    w = (torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5).to(dtype)
    x = torch.randn(max(Ms), K, device="cuda", generator=gen).to(dtype)
    groups = []
    for M in Ms:
        rows = (x[:M] @ w)[:min(Ms)]
        for g in groups:
            if torch.equal(g[0], rows):
                g[1].append(M)
                break
        else:
            groups.append((rows, [M]))
    return [ms for _, ms in groups]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_blas_rows: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if sys.argv[1:2] == ["--scan"]:
        K, N = int(sys.argv[2]), int(sys.argv[3])
        rest = sys.argv[4:]
        dtype = torch.float32 if "--fp32" in rest else torch.bfloat16
        lo, hi, step = ([int(a) for a in rest if a != "--fp32"]
                        or [128, 4096, 32])
        torch.backends.cuda.preferred_blas_library("cublaslt")
        for i, ms in enumerate(scan(K, N, range(lo, hi + 1, step), dtype)):
            print(f"cublaslt K={K} N={N} {str(dtype)[6:]}: bits {i}: M = "
                  f"{ms} [{card}]", flush=True)
        return 0
    for lib in ("cublas", "cublaslt"):
        torch.backends.cuda.preferred_blas_library(lib)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        bad, ms = parts(gen)
        for rng, (Ms, ref_m) in RANGES.items():
            print(f"{lib} {rng} (M = {Ms[0]}..{Ms[-1]} against {ref_m}): "
                  f"{len(bad[rng])} shapes part"
                  + "".join(f"\n  {m} K={K} N={N}: {d}"
                            for m, K, N, d in bad[rng])
                  + f"\n  summed time of the {sum(map(len, SHAPES.values()))}"
                  f" projections at M = {8192 if rng == 'prefill' else 16}: "
                  f"{ms[rng]:.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
