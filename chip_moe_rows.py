"""Time qwen2-moe-a2.7b's prefill on one NVIDIA H100 under several rules
for the MoE block's groups, and check which keep a row's bits.

    python3 chip_moe_rows.py

The model runs at 24 layers, full width, bf16, random weights from seed
0. A prefill (or chunk) runs its MoE block on groups of R batch rows,
the last padded with zero rows, so that the expert products' M (R x C
slots an expert) does not follow the join's size (``models/moe.py``).
The rules: the join at once (R = its rows, no padding: M follows the
join), and R = 1 (a row at a time), 4 and 16 (``moe.GROUP_ROWS``, the
port's: the engine's default max_batch). For each rule, bucket (128,
512) and join (1, 4, 16 prompts, padded to the rows the engine runs),
the prefill runs as the continuous engine runs it (``forward`` into
fresh caches, captured in one CUDA graph by the port's ``GraphCache``)
and prints one JSON line: the replays' times by CUDA events (median of
10 after 3), and whether row 0's hidden states are the same bits as in
the widest join. The card's name and power limit come first. Exits
non-zero without CUDA, or if the rows part under a rule of a fixed R.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BUCKETS = (128, 512)
JOINS = (1, 4, 16)
REPLAYS = 10


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def replay_ms(fn, n=REPLAYS, warmup=3):
    """Median time (ms) of ``fn`` by CUDA events, each call on its own."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: the prefills run on the card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, make_caches
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine, prefill_min_m
    from repro_torch.serving.graphs import GraphCache
    print(card(), flush=True)
    cfg = get_config("qwen2-moe-a2.7b")
    params = init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(7)
    default_r, parted = moe.GROUP_ROWS, []
    for bucket in BUCKETS:
        C = moe.capacity(cfg, bucket)
        lens = rng.integers(8, bucket + 1, max(JOINS))
        toks = np.zeros((max(JOINS), bucket), np.int64)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
        rules = {"the join at once": None, "a row at a time": 1,
                 "4 rows": 4, "16 rows": 16}
        for rule, rows in rules.items():
            gc, rows0 = GraphCache("cuda"), {}
            for n in sorted(JOINS, reverse=True):
                m = ServingEngine._prefill_rows(n, bucket,
                                                prefill_min_m(cfg))
                moe.GROUP_ROWS = m if rows is None else rows
                idx = list(range(n)) + [0] * (m - n)
                tt = torch.from_numpy(toks[idx]).cuda()
                caches = make_caches(cfg, m, bucket + 32,
                                     dtype=torch.float32, device="cuda")

                def prefill(t):
                    return forward(cfg, params, tokens=t, caches=caches,
                                   return_hidden=True)
                with torch.inference_mode():
                    rows0[n] = gc.run((rule, bucket, n), prefill,
                                      tt)[0].clone()
                    ms = replay_ms(lambda: gc.run((rule, bucket, n),
                                                  prefill, tt))
                same = torch.equal(rows0[n], rows0[max(JOINS)])
                if not same and rows is not None:
                    parted.append((rule, bucket, n))
                print(json.dumps({
                    "rule": rule, "bucket": bucket, "join": n, "rows": m,
                    "C": C, "group_rows": moe.GROUP_ROWS,
                    "expert_m": moe.GROUP_ROWS * C,
                    "ms": ms, "row0_equal_to_widest": same}), flush=True)
                del caches
            del gc
            torch.cuda.empty_cache()
    moe.GROUP_ROWS = default_r
    if parted:
        print(f"rows parted: {parted}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
