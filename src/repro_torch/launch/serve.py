"""Serving launcher of the port: stands up the engine, sends a burst of
random requests and prints the engine's metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --max-new-tokens 16 --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --ladder 1 4 16

``gector-base`` serves sentences in encoder mode with its edit-tag head;
``qwen2-0.5b`` and ``recurrentgemma-9b`` serve prompts in decoder mode
through ``generate()``, on the continuous scheduler over the KV pool
(``--no-continuous``: batch at a time), greedy or sampled at
``--temperature`` (and ``--top-k``) with per-request seeds, stopping at
``--eos-id``; ``--stream`` prints the first request's tokens as they
arrive. ``--ladder NS ...`` instead fires the paper's load ladder at the
engine (``core.loadtest.run_ladder``, one repeat) and prints its table.
Runs on the card; ``--device cpu --smoke`` runs the small config on the
CPU. Weights are random, drawn from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.loadtest import format_table, run_ladder
from repro_torch.core.gector import init_gector, tag_head
from repro_torch.core.tags import TagVocab
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams


def _ladder(args, cfg, eng, rng) -> None:
    """The paper's ladder: NS simultaneous requests per cell, one repeat."""
    sentences = [rng.integers(0, cfg.vocab_size, rng.integers(8, 33))
                 for _ in range(max(args.requests, 32))]
    cells = run_ladder(eng, sentences, ladder=tuple(args.ladder), repeats=1)
    print(format_table(cells))


def _serve_encoder(args, cfg, rng):
    params = init_gector(cfg, TagVocab(64), args.seed, device=args.device)
    eng = ServingEngine(cfg, params,
                        EngineConfig(mode="encoder", max_batch=args.max_batch,
                                     max_inflight=args.max_inflight),
                        head_fn=tag_head, device=args.device)
    try:
        if args.ladder:
            _ladder(args, cfg, eng, rng)
            return
        sentences = [rng.integers(0, cfg.vocab_size, rng.integers(8, 33))
                     for _ in range(args.requests)]
        futs = [eng.submit(s) for s in sentences]
        for f in futs:
            f.result(timeout=600)
        print("metrics:", eng.metrics())
    finally:
        eng.close()


def _serve_decoder(args, cfg, rng):
    params = init_params(cfg, args.seed, device=args.device)
    eng = ServingEngine(cfg, params,
                        EngineConfig(mode="decoder",
                                     continuous=not args.no_continuous,
                                     max_batch=args.max_batch,
                                     max_inflight=args.max_inflight,
                                     max_new_tokens=args.max_new_tokens),
                        device=args.device)
    try:
        if args.ladder:
            _ladder(args, cfg, eng, rng)
            return
        prompts = [rng.integers(0, cfg.vocab_size, rng.integers(8, 33))
                   for _ in range(args.requests)]
        handles = [eng.generate(p, SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            eos_id=args.eos_id, seed=i))
            for i, p in enumerate(prompts)]
        if args.stream and handles:
            print("request[0] stream:", end=" ", flush=True)
            for tok in handles[0]:
                print(tok, end=" ", flush=True)
            print()
        results = [h.result(timeout=600) for h in handles]
        print("tokens of the first request:", results[0].tokens.tolist())
        print("metrics:", eng.metrics())
    finally:
        eng.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gector-base",
                    choices=["gector-base", "qwen2-0.5b",
                             "recurrentgemma-9b"])
    ap.add_argument("--smoke", action="store_true",
                    help="the small same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--ladder", type=int, nargs="*", default=None,
                    help="fire the load ladder at these NS instead")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-inflight", type=int, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=16,
                    help="decoder: tokens generated per request")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decoder: 0 = greedy")
    ap.add_argument("--top-k", type=int, default=None,
                    help="decoder: sample among the k likeliest tokens")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="decoder: stop a request at this token")
    ap.add_argument("--stream", action="store_true",
                    help="decoder: print the first request's tokens as "
                         "they arrive")
    ap.add_argument("--no-continuous", action="store_true",
                    help="decoder: batch-at-a-time worker (A/B baseline)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
    if args.arch in ("qwen2-0.5b", "recurrentgemma-9b"):
        _serve_decoder(args, cfg, rng)
    else:
        _serve_encoder(args, cfg, rng)


if __name__ == "__main__":
    main()
