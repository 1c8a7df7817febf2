"""Serving launcher of the port: stands up the encoder-mode engine for
GECToR with its edit-tag head, sends a burst of random sentences and
prints the engine's metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64

Runs on the card; ``--device cpu --smoke`` runs the small config on the
CPU. Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.gector import init_gector, tag_head
from repro_torch.core.tags import TagVocab
from repro_torch.serving import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gector-base", choices=["gector-base"])
    ap.add_argument("--smoke", action="store_true",
                    help="the small same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-inflight", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_gector(cfg, TagVocab(64), args.seed, device=args.device)
    eng = ServingEngine(cfg, params,
                        EngineConfig(mode="encoder", max_batch=args.max_batch,
                                     max_inflight=args.max_inflight),
                        head_fn=tag_head, device=args.device)
    try:
        rng = np.random.default_rng(args.seed)
        sentences = [rng.integers(0, cfg.vocab_size, rng.integers(8, 33))
                     for _ in range(args.requests)]
        futs = [eng.submit(s) for s in sentences]
        for f in futs:
            f.result(timeout=600)
        print("metrics:", eng.metrics())
    finally:
        eng.close()


if __name__ == "__main__":
    main()
