"""Serving launcher of the port: stands up the engine, sends a burst of
random requests and prints the engine's metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --max-new-tokens 16 --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
  PYTHONPATH=src python -m repro_torch.launch.serve --ladder 1 4 16

``gector-base`` serves sentences in encoder mode with its edit-tag head;
``qwen2-0.5b``, ``stablelm-12b``, ``gemma2-27b``, ``recurrentgemma-9b``,
``xlstm-125m`` (recurrent states, no KV cache) and the MoE models
``qwen2-moe-a2.7b`` (29.3 GB in bf16, whole on one H100),
``moonshot-v1-16b-a3b`` (58 GB) and ``phi3.5-moe-42b-a6.6b`` (84 GB:
beyond one card) serve prompts in decoder mode through ``generate()``,
on the continuous scheduler over the KV pool (``--no-continuous``: batch
at a time), greedy or sampled at
``--temperature`` (and ``--top-k``) with per-request seeds, stopping at
``--eos-id``; ``--stream`` prints the first request's tokens as they
arrive. ``--ladder NS ...`` instead fires the paper's load ladder at the
engine (``core.loadtest.run_ladder``, one repeat) and prints its table.
Runs on the card; ``--device cpu --smoke`` runs the small config on the
CPU. Weights are random, drawn from ``--seed``, unless ``--ckpt`` names a
checkpoint (``training.checkpoint``, either package's): its ``params``
are served, a GECToR tree's ``encoder`` in decoder mode; in encoder mode
a GECToR tree's encoder with its heads where it has them (random heads
from ``--seed`` where it does not), and an LM tree as the encoder.
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
from repro_torch.training.checkpoint import restore

DECODER_ARCHS = ("qwen2-0.5b", "stablelm-12b", "gemma2-27b",
                 "recurrentgemma-9b", "qwen2-moe-a2.7b",
                 "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                 "xlstm-125m")


def _ladder(args, cfg, eng, rng) -> None:
    """The paper's ladder: NS simultaneous requests per cell, one repeat."""
    sentences = [rng.integers(0, cfg.vocab_size, rng.integers(8, 33))
                 for _ in range(max(args.requests, 32))]
    cells = run_ladder(eng, sentences, ladder=tuple(args.ladder), repeats=1)
    print(format_table(cells))


def _checkpoint(args):
    """The ``params`` tree of ``--ckpt`` on the device, or None."""
    if not args.ckpt:
        return None
    return restore(args.ckpt, device=args.device)["params"]


def _serve_encoder(args, cfg, rng):
    params = init_gector(cfg, TagVocab(64), args.seed, device=args.device)
    tree = _checkpoint(args)
    if tree is not None:
        params.update(tree if "encoder" in tree else {"encoder": tree})
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
        tags = [f.result(timeout=600) for f in futs]
        print("tags of the first request:", tags[0].tolist())
        print("metrics:", eng.metrics())
    finally:
        eng.close()


def _serve_decoder(args, cfg, rng):
    params = _checkpoint(args)
    if params is None:
        params = init_params(cfg, args.seed, device=args.device)
    elif "encoder" in params:            # a GECToR checkpoint
        params = params["encoder"]
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
                    choices=["gector-base", *DECODER_ARCHS])
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
    ap.add_argument("--ckpt", default=None,
                    help="serve this checkpoint's params")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
    if args.arch in DECODER_ARCHS:
        _serve_decoder(args, cfg, rng)
    else:
        _serve_encoder(args, cfg, rng)


if __name__ == "__main__":
    main()
