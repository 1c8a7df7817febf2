"""Deployment-lab launcher of the port: re-run the paper's provider x
machine grid against the port's serving engine and diff the result
against the paper.

  # the paper's grid: all 21 paper profiles, full-width GECToR-base on
  # the card
  PYTHONPATH=src python -m repro_torch.launch.experiment \\
      --ladder 1 2 4 8 16 32 64 128 256 512 --repeats 3 --max-batch 32

  # the small grid on the CPU: 2 profiles x (1, 2) ladder, smoke config
  PYTHONPATH=src python -m repro_torch.launch.experiment --smoke \\
      --device cpu

The counterpart of ``repro/launch/experiment.py``, with its flags and
defaults for the encoder grid. It differs in three ways: the configs are
full width on the card unless ``--smoke`` asks for the small ones
(``--device cpu`` runs on the CPU); the decoder scenarios (``--staggered``,
``--prefix-cache``, ``--quant``, ``--spec-decode``) raise
``NotImplementedError`` before any engine is built, because they serve
through the continuous decoder that ROADMAP Queue 1 items 6-10 port, and
the decoder-only knobs (``--arch``, ``--requests``, ``--gap``,
``--max-new-tokens``, ``--spec-k``, ``--segment-width``) and the A/B
pricers of those scenarios come with them; and the artifacts carry the
port's names, so a run never overwrites the JAX package's:

  EXPERIMENT_torch_grid.jsonl   one ExperimentRecord per (profile x
                                scenario)
  EXPERIMENT_torch_drift.json   drift_report(): measured $/1M sentences,
                                cheapest-SLO machine, GPU-vs-CPU premium and
                                the findings ledger, each diffed vs
                                core.analysis

Every profile runs on this host: a $/1M sentences figure prices this
host's throughput at the profile's list price (``deploy/runner.py``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.configs import get_config
from repro_torch.deploy.profiles import paper_profiles, profile_by_key
from repro_torch.deploy.report import drift_report, format_drift, write_report
from repro_torch.deploy.runner import (KIND_LADDER, KIND_STAGGERED,
                                       ExperimentRunner, WorkloadScenario,
                                       smoke_grid_profiles)
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServingEngine

GRID_FILE = "EXPERIMENT_torch_grid.jsonl"
DRIFT_FILE = "EXPERIMENT_torch_drift.json"


def check_scenarios(scenarios) -> None:
    """Raise ``NotImplementedError`` if any scenario is one the port cannot
    serve yet, naming the ROADMAP Queue 1 items they need. Every decoder
    scenario of the JAX factory runs the continuous decoder (ported) with
    ``prefill_chunk`` (item 7); ``_pc`` adds the prefix cache (item 8)
    and ``_sd`` speculative decoding (item 10)."""
    decoder = [s.name for s in scenarios if s.mode == "decoder"]
    if not decoder:
        return
    needs = ["item 7 (prefill_chunk)"]
    if any(n.endswith("_pc") for n in decoder):
        needs.append("item 8 (the prefix cache)")
    if any(n.endswith("_sd") for n in decoder):
        needs.append("item 10 (speculative decoding)")
    raise NotImplementedError(
        f"decoder scenarios {decoder} serve through the continuous decoder "
        f"with features the port does not have yet: ROADMAP Queue 1 "
        f"{', '.join(needs)}")


def make_engine_factory(args):
    """(scenario) -> (engine, sentences, sampling) for the encoder
    scenarios: GECToR-base (``--smoke``: its small config) without a head,
    as the JAX factory builds it, on ``args.device`` (default: the card),
    weights drawn from ``args.seed``; 64 sentences of 8 to
    ``bucket // 2 + 8`` tokens; every batch size of the bucket warmed up
    before the engine is returned."""
    def factory(scenario: WorkloadScenario):
        check_scenarios([scenario])
        cfg = get_config("gector-base", smoke=args.smoke)
        params = init_params(cfg, args.seed, device=args.device)
        quant = "int8" if scenario.name.endswith("_q8") else None
        eng = ServingEngine(cfg, params, EngineConfig(
            mode=scenario.mode, max_batch=args.max_batch,
            pad_buckets=(args.bucket,),
            max_new_tokens=scenario.max_new_tokens,
            max_inflight=args.max_inflight,
            weight_quant=quant, kv_quant=quant),
            device=args.device)
        rng = np.random.default_rng(args.seed)
        sentences = [rng.integers(0, cfg.vocab_size,
                                  (int(rng.integers(8, args.bucket // 2
                                                    + 8)),))
                     for _ in range(64)]
        # every batch size of the bucket, outside the measured windows
        eng.warmup()
        return eng, sentences, None
    return factory


def build_scenarios(args) -> list:
    scenarios = [WorkloadScenario(name="ladder", kind=KIND_LADDER,
                                  mode="encoder",
                                  ladder=tuple(args.ladder),
                                  repeats=args.repeats)]
    if args.staggered:
        scenarios.append(WorkloadScenario(
            name="staggered", kind=KIND_STAGGERED, mode="decoder"))
    # the JAX CLI's A/B pairs at equal offered load: prefix cache off vs
    # on, int8 weights + KV vs float, speculative vs plain decoding
    for flag, names in (("prefix_cache", ("staggered_shared",
                                          "staggered_shared_pc")),
                        ("quant", ("staggered_quant", "staggered_quant_q8")),
                        ("spec_decode", ("staggered_spec",
                                         "staggered_spec_sd"))):
        if getattr(args, flag):
            scenarios += [WorkloadScenario(
                name=name, kind=KIND_STAGGERED, mode="decoder")
                for name in names]
    return scenarios


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid: 2 profiles x (1,2) ladder on the small "
                         "config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--profiles", nargs="*", default=None,
                    metavar="PROV/MACHINE",
                    help="profile keys (e.g. AWS/C); default: smoke pair "
                         "with --smoke, all 21 paper profiles otherwise")
    ap.add_argument("--ladder", type=int, nargs="*", default=None)
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--staggered", action="store_true",
                    help="add the open-loop decoder scenario (not ported: "
                         "raises)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="add the shared-prompt staggered A/B pair (not "
                         "ported: raises)")
    ap.add_argument("--quant", action="store_true",
                    help="add the quantized-serving staggered A/B pair "
                         "(not ported: raises)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="add the speculative-decoding staggered A/B pair "
                         "(not ported: raises)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-inflight", type=int, default=None)
    ap.add_argument("--bucket", type=int, default=32,
                    help="pad bucket (and prompt-length ceiling)")
    ap.add_argument("--target-ns", type=int, default=None,
                    help="NS for the cheapest-SLO question (default: the "
                         "largest ladder cell actually run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)

    if args.smoke:
        args.ladder = args.ladder or [1, 2]
        args.repeats = args.repeats or 1
        default_profiles = smoke_grid_profiles()
    else:
        args.ladder = args.ladder or [1, 4, 16]
        args.repeats = args.repeats or 2
        default_profiles = paper_profiles()
    profiles = ([profile_by_key(k) for k in args.profiles]
                if args.profiles else list(default_profiles))
    scenarios = build_scenarios(args)
    check_scenarios(scenarios)          # before any engine is built

    os.makedirs(args.out_dir, exist_ok=True)
    grid_path = os.path.join(args.out_dir, GRID_FILE)
    drift_path = os.path.join(args.out_dir, DRIFT_FILE)

    # the factory already serves every batch shape; skip the runner's
    # generic single-request warmup so scenarios start immediately
    runner = ExperimentRunner(make_engine_factory(args), seed=args.seed,
                              warmup=False)
    records = runner.run_grid(profiles, scenarios, out_path=grid_path,
                              progress=lambda msg: print(f"[run] {msg}",
                                                         flush=True))
    report = drift_report(records, target_ns=args.target_ns)
    write_report(report, drift_path)
    print(f"[out] {grid_path} ({len(records)} records)")
    print(f"[out] {drift_path}")
    print(format_drift(report))


if __name__ == "__main__":
    main()
