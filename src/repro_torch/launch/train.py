"""Training launcher of the port: trains a model on ``SyntheticLM`` with
``train_step`` (remat on) and prints the JAX launcher's step lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 20 --batch 4 --seq 64 --ckpt /tmp/lm.ckpt

Runs on the card (K1 and K5 forward and backward; xlstm-125m's mLSTM
blocks in their chunkwise-parallel form, its sLSTM blocks step by step,
in torch ops); ``--device cpu
--smoke`` trains the small config on the CPU. Weights start random from
seed 0. ``--ckpt`` writes ``{"params", "opt"}`` in the JAX package's
checkpoint format, which ``repro_torch.launch.serve --ckpt`` serves. There
is no mesh: the JAX launcher's production mesh and ``--multi-pod`` are
ROADMAP Queue 1 item 14. The MoE archs train with their load-balance and
router-z terms; at full size their weights and AdamW state (about 12 B
a parameter: 172 GB for qwen2-moe-a2.7b's 14.3 B) need more than one
card, which is that mesh work: on one card they train ``--smoke``, or
cut in depth from code (``dataclasses.replace(cfg, n_layers=2)``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.training.checkpoint import save
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import OptConfig, adamw_init
from repro_torch.training.train_loop import train_step

ARCHS = ("gector-base", "qwen2-0.5b", "recurrentgemma-9b",
         "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
         "xlstm-125m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    oc = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch))
    params = init_params(cfg, 0, device=dev)
    opt = adamw_init(params)
    t0 = time.time()
    for i, b in enumerate(data.batches(args.steps)):
        batch = {"tokens": torch.as_tensor(b["tokens"], device=dev)}
        params, opt, m = train_step(cfg, oc, params, opt, batch, remat=True)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} "
                  f"[{time.time()-t0:.0f}s]", flush=True)
    if args.ckpt:
        save(args.ckpt, {"params": params, "opt": opt})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
