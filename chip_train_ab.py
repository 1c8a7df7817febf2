"""Time the port's train steps on one NVIDIA H100, so that two checkouts
can be compared on one card: Qwen2-0.5B at B=8 x 512 (bf16, remat,
random weights from seed 0, SyntheticLM batches) and GECToR-base at
B=32 x 128 (``gector_loss`` and AdamW on GECCorpus), as ``chip_smoke.py``'s
phase 28 (d) and (e) train them.

    python3 chip_train_ab.py [--src DIR] [--label NAME]

``--src`` is the directory ``repro_torch`` is imported from (default:
``src`` beside this file), so that a second checkout unpacked under a
git-ignored directory (``git archive``) is timed by the same script; each
checkout builds its kernels under its own ``build/``. Walls on the host's
clock move between machines and calls, so compare two checkouts only
within one call, run as A, B, B, A. For each model it prints one JSON
line: the step walls (host clock, a synchronize around each step), their
median over steps 2 onwards, the first and last loss, K1's backward
launches, and one more step under the profiler: its wall, its kernels'
summed device time and the device's idle share of that step's own wall
(the profiler's host cost makes the share an upper bound). The card's
name and power limit come first. Exits non-zero without a result when
CUDA is missing.
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

QWEN2 = dict(B=8, S=512, steps=20)
GECTOR = dict(B=32, S=128, steps=30)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_steps(step, n):
    """Walls (ms) of ``n`` calls of ``step``, then one profiled call:
    (walls, profiled wall ms, its kernels' device ms or None)."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(n - 1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            busy += dev / 1e3
    return walls, prof_ms, busy or None


def report(model, label, walls, prof_ms, busy, losses, launches):
    out = {"model": model, "label": label,
           "median_ms": float(np.median(walls[2:])),
           "walls_ms": [round(w, 3) for w in walls],
           "profiled_wall_ms": prof_ms, "profiled_kernels_ms": busy,
           "idle": None if busy is None else max(0.0, 1 - busy / prof_ms),
           "loss_first": losses[0], "loss_last": losses[-1],
           "finite": bool(np.isfinite(losses).all()),
           "k1_bwd_launches": launches}
    print(json.dumps(out), flush=True)


def qwen2(label):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig, adamw_init, train_step
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config("qwen2-0.5b")
    B, S, n = QWEN2["B"], QWEN2["S"], QWEN2["steps"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  batch_size=B, seed=0))
    batches = [{"tokens": torch.as_tensor(b["tokens"], device="cuda")}
               for b in data.batches(n)]
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=n)
    state = {"params": init_params(cfg, 0, device="cuda")}
    state["opt"] = adamw_init(state["params"])
    losses = []

    def step(i):
        state["params"], state["opt"], m = train_step(
            cfg, oc, state["params"], state["opt"], batches[i])
        losses.append(float(m["loss"]))
    fa.flash_attention_bwd.launches = 0
    walls, prof_ms, busy = timed_steps(step, n)
    report("qwen2-0.5b B=8 S=512 bf16 remat", label, walls, prof_ms, busy,
           losses[:n], fa.flash_attention_bwd.launches)


def gector(label):
    from repro_torch.configs import get_config
    from repro_torch.core.corpus import CorpusConfig, GECCorpus
    from repro_torch.core.gector import gector_loss, init_gector
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import OptConfig, adamw_init
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import value_and_grad
    cfg = get_config("gector-base")
    corpus = GECCorpus(CorpusConfig(vocab_size=cfg.vocab_size,
                                    edit_words=256, error_rate=0.4, seed=0))
    B, S, n = GECTOR["B"], GECTOR["S"], GECTOR["steps"]
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for b in corpus.batches(B, S, n)]
    oc = OptConfig(lr=5e-4, warmup_steps=5, total_steps=n,
                   weight_decay=0.01)
    state = {"params": init_gector(cfg, corpus.vocab, 0, device="cuda")}
    state["opt"] = adamw_init(state["params"])
    losses = []

    def step(i):
        (loss, _), g = value_and_grad(
            lambda p: gector_loss(cfg, p, batches[i]), state["params"])
        state["params"], state["opt"], _ = adamw_update(
            oc, state["params"], g, state["opt"])
        losses.append(float(loss))
    fa.flash_attention_bwd.launches = 0
    walls, prof_ms, busy = timed_steps(step, n)
    report("gector-base B=32 S=128 bf16", label, walls, prof_ms, busy,
           losses[:n], fa.flash_attention_bwd.launches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available: the train steps run on the card",
              file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    print(card(), flush=True)
    qwen2(args.label)
    torch.cuda.empty_cache()
    gector(args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
