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

  # the decoder scenarios on the card: staggered arrivals, the
  # prefix-cache, int8 and speculative A/B pairs, full-width Qwen2-0.5B
  PYTHONPATH=src python -m repro_torch.launch.experiment \\
      --staggered --prefix-cache --quant --spec-decode --arch qwen2-0.5b

The counterpart of ``repro/launch/experiment.py``, with its flags and
defaults. It differs in two ways: the configs are full width on the
card unless ``--smoke`` asks for the small ones (``--device cpu`` runs on
the CPU), and the artifacts carry the port's names, so a run never
overwrites the JAX package's:

  EXPERIMENT_torch_grid.jsonl   one ExperimentRecord per (profile x
                                scenario)
  EXPERIMENT_torch_drift.json   drift_report(): measured $/1M sentences,
                                cheapest-SLO machine, GPU-vs-CPU premium and
                                the findings ledger, each diffed vs
                                core.analysis; with ``--prefix-cache``,
                                ``--quant`` and ``--spec-decode`` also the
                                A/B pricers' cells

Every profile runs on this host: a $/1M sentences figure prices this
host's throughput at the profile's list price (``deploy/runner.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.loadtest import mixed_bucket_prompts
from repro_torch.deploy.profiles import paper_profiles, profile_by_key
from repro_torch.deploy.report import drift_report, format_drift, write_report
from repro_torch.deploy.runner import (KIND_LADDER, KIND_STAGGERED,
                                       ExperimentRunner, WorkloadScenario,
                                       smoke_grid_profiles)
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

GRID_FILE = "EXPERIMENT_torch_grid.jsonl"
DRIFT_FILE = "EXPERIMENT_torch_drift.json"
DECODER_ARCHS = ("qwen2-0.5b", "recurrentgemma-9b", "qwen2-moe-a2.7b")


def make_engine_factory(args):
    """(scenario) -> (engine, sentences, sampling), as the JAX factory
    builds them, on ``args.device`` (default: the card), weights drawn
    from ``args.seed``, every program warmed up before the engine is
    returned.

    Encoder scenarios serve GECToR-base (``--smoke``: its small config)
    without a head, 64 sentences of 8 to ``bucket // 2 + 8`` tokens.
    Decoder scenarios serve ``--arch`` through the continuous scheduler
    over two buckets ``(bucket // 2, bucket)``, prompts longer than
    ``max(bucket // 4, 8)`` tokens prefilling in chunks of that size:
    the mixed-bucket prompts (``staggered``, ``staggered_quant``, with
    ``_q8`` int8 weights and KV), or 64 prompts that repeat one system
    prompt of 3/4 of the bucket plus a unique suffix of 1 to bucket // 8
    tokens (``staggered_shared``, with ``_pc`` the prefix cache). The
    ``_sd`` scenario decodes speculatively, ``--spec-k`` proposals a
    round, self-drafted as in JAX: the draft is the target's first
    pattern period, sharing its embeddings and head."""
    def factory(scenario: WorkloadScenario):
        decoder = scenario.mode == "decoder"
        shared = scenario.name.startswith("staggered_shared")
        cfg = get_config(args.arch if decoder else "gector-base",
                         smoke=args.smoke)
        params = init_params(cfg, args.seed, device=args.device)
        sd = scenario.name.endswith("_sd")
        draft = self_draft(cfg, params) if sd else None
        buckets = ((args.bucket // 2, args.bucket) if decoder
                   else (args.bucket,))
        quant = "int8" if scenario.name.endswith("_q8") else None
        eng = ServingEngine(cfg, params, EngineConfig(
            mode=scenario.mode, max_batch=args.max_batch,
            pad_buckets=buckets,
            max_new_tokens=scenario.max_new_tokens,
            max_inflight=args.max_inflight,
            prefill_chunk=max(args.bucket // 4, 8) if decoder else None,
            segment_width=args.segment_width,
            prefix_cache=scenario.name.endswith("_pc"),
            weight_quant=quant, kv_quant=quant, spec_decode=sd,
            spec_k=args.spec_k), device=args.device, draft=draft)
        rng = np.random.default_rng(args.seed)
        if shared:
            sysprompt = rng.integers(0, cfg.vocab_size,
                                     (args.bucket * 3 // 4,))
            sentences = [np.concatenate([
                sysprompt,
                rng.integers(0, cfg.vocab_size,
                             (int(rng.integers(1, args.bucket // 8 + 1)),))])
                for _ in range(64)]
        elif decoder:
            sentences = mixed_bucket_prompts(buckets, 64, cfg.vocab_size,
                                             rng_seed=args.seed)
        else:
            sentences = [rng.integers(0, cfg.vocab_size,
                                      (int(rng.integers(8, args.bucket // 2
                                                        + 8)),))
                         for _ in range(64)]
        # every program of every bucket, staging pools and prefix stores
        # included, outside the measured windows
        eng.warmup()
        sampling = (SamplingParams(max_new_tokens=scenario.max_new_tokens)
                    if decoder else None)
        return eng, sentences, sampling
    return factory


def self_draft(cfg, params):
    """JAX's self-draft: (draft_cfg, draft_params), the target's first
    pattern period sharing its embeddings and head (views, no copy), so
    no second checkpoint is needed and the vocabulary is the target's."""
    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:1]
    dparams = dict(params)
    dparams["blocks"] = first(params["blocks"])
    return (dataclasses.replace(cfg, name=f"{cfg.name}-draft",
                                n_layers=len(cfg.pattern)), dparams)


def build_scenarios(args) -> list:
    scenarios = [WorkloadScenario(name="ladder", kind=KIND_LADDER,
                                  mode="encoder",
                                  ladder=tuple(args.ladder),
                                  repeats=args.repeats)]
    names = (["staggered"] if args.staggered else [])
    # the JAX CLI's A/B pairs at equal offered load: prefix cache off vs
    # on over shared-prompt traffic, int8 weights + KV vs float,
    # speculative vs plain decoding
    for flag, pair in (("prefix_cache", ("staggered_shared",
                                         "staggered_shared_pc")),
                       ("quant", ("staggered_quant", "staggered_quant_q8")),
                       ("spec_decode", ("staggered_spec",
                                        "staggered_spec_sd"))):
        if getattr(args, flag):
            names += pair
    return scenarios + [WorkloadScenario(
        name=name, kind=KIND_STAGGERED, mode="decoder",
        n_requests=args.requests, gap_s=args.gap,
        max_new_tokens=args.max_new_tokens) for name in names]


def _usd_per_1m(prof, rps) -> float:
    return prof["hourly_cost_usd"] / 3600.0 / max(rps, 1e-9) * 1e6


def prefix_cache_cells(records) -> list:
    """$/1M-requests for the staggered_shared A/B pair, per profile — the
    deploy-lab cell recording what the prefix cache is worth at equal
    offered load (same gap, same prompts; only the engine knob differs).
    JAX's pricer, field for field."""
    by_key = {}
    for rec in records:
        d = rec.to_dict() if hasattr(rec, "to_dict") else rec
        name = d["scenario"]["name"]
        if not name.startswith("staggered_shared"):
            continue
        prof, cell = d["profile"], d["cells"][0]
        rps = cell["requests_per_s"]
        by_key.setdefault(f"{prof['provider']}/{prof['machine']}", {})[
            "pc" if name.endswith("_pc") else "off"] = {
                "usd_per_1m_requests": _usd_per_1m(prof, rps),
                "requests_per_s": rps,
                "prefill_mean_s": cell["prefill_mean_s"]}
    out = []
    for key, pair in sorted(by_key.items()):
        if "off" not in pair or "pc" not in pair:
            continue
        off, pc = pair["off"], pair["pc"]
        out.append({
            "profile": key,
            "usd_per_1m_requests_off": off["usd_per_1m_requests"],
            "usd_per_1m_requests_pc": pc["usd_per_1m_requests"],
            "usd_drop_pct": 100.0 * (1 - pc["usd_per_1m_requests"]
                                     / max(off["usd_per_1m_requests"],
                                           1e-12)),
            "prefill_mean_off_s": off["prefill_mean_s"],
            "prefill_mean_pc_s": pc["prefill_mean_s"]})
    return out


def quant_cells(records) -> list:
    """$/1M-requests and resident-memory footprint for the staggered_quant
    A/B pair, per profile: the footprint is the record's engine
    ``weight_bytes`` plus the lanes' ``kv_bytes`` gauges of its engine
    window. JAX's pricer, field for field."""
    by_key = {}
    for rec in records:
        d = rec.to_dict() if hasattr(rec, "to_dict") else rec
        name = d["scenario"]["name"]
        if not name.startswith("staggered_quant"):
            continue
        prof, cell = d["profile"], d["cells"][0]
        rps = cell["requests_per_s"]
        lanes = d["engine_window"].get("lanes", {})
        footprint = (d["engine"]["weight_bytes"]
                     + sum(s.get("kv_bytes", 0) for s in lanes.values()))
        by_key.setdefault(f"{prof['provider']}/{prof['machine']}", {})[
            "q8" if name.endswith("_q8") else "off"] = {
                "usd_per_1m_requests": _usd_per_1m(prof, rps),
                "requests_per_s": rps,
                "footprint_bytes": footprint,
                "tokens_per_s": cell["tokens_per_s"]}
    out = []
    for key, pair in sorted(by_key.items()):
        if "off" not in pair or "q8" not in pair:
            continue
        off, q8 = pair["off"], pair["q8"]
        out.append({
            "profile": key,
            "usd_per_1m_requests_off": off["usd_per_1m_requests"],
            "usd_per_1m_requests_q8": q8["usd_per_1m_requests"],
            "usd_drop_pct": 100.0 * (1 - q8["usd_per_1m_requests"]
                                     / max(off["usd_per_1m_requests"],
                                           1e-12)),
            "footprint_bytes_off": off["footprint_bytes"],
            "footprint_bytes_q8": q8["footprint_bytes"],
            "footprint_ratio": off["footprint_bytes"]
                               / max(q8["footprint_bytes"], 1),
            "tokens_per_s_off": off["tokens_per_s"],
            "tokens_per_s_q8": q8["tokens_per_s"]})
    return out


def spec_decode_cells(records) -> list:
    """$/1M-requests and accept rate for the staggered_spec A/B pair, per
    profile: the accept rate is the record's engine window's
    ``spec_accepted`` over ``spec_proposed``, summed over lanes. JAX's
    pricer, field for field."""
    by_key = {}
    for rec in records:
        d = rec.to_dict() if hasattr(rec, "to_dict") else rec
        name = d["scenario"]["name"]
        if not name.startswith("staggered_spec"):
            continue
        prof, cell = d["profile"], d["cells"][0]
        rps = cell["requests_per_s"]
        lanes = d["engine_window"].get("lanes", {})
        prop = sum(s.get("spec_proposed", 0) for s in lanes.values())
        acc = sum(s.get("spec_accepted", 0) for s in lanes.values())
        by_key.setdefault(f"{prof['provider']}/{prof['machine']}", {})[
            "sd" if name.endswith("_sd") else "off"] = {
                "usd_per_1m_requests": _usd_per_1m(prof, rps),
                "requests_per_s": rps,
                "tokens_per_s": cell["tokens_per_s"],
                "accept_rate": acc / prop if prop else 0.0}
    out = []
    for key, pair in sorted(by_key.items()):
        if "off" not in pair or "sd" not in pair:
            continue
        off, sd = pair["off"], pair["sd"]
        out.append({
            "profile": key,
            "usd_per_1m_requests_off": off["usd_per_1m_requests"],
            "usd_per_1m_requests_sd": sd["usd_per_1m_requests"],
            "usd_drop_pct": 100.0 * (1 - sd["usd_per_1m_requests"]
                                     / max(off["usd_per_1m_requests"],
                                           1e-12)),
            "tokens_per_s_off": off["tokens_per_s"],
            "tokens_per_s_sd": sd["tokens_per_s"],
            "accept_rate": sd["accept_rate"]})
    return out


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
                    help="add the open-loop decoder scenario")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="add the shared-prompt staggered A/B pair "
                         "(prefix_cache off vs on) and report the "
                         "$/1M-requests drop per profile")
    ap.add_argument("--quant", action="store_true",
                    help="add the quantized-serving staggered A/B pair "
                         "(int8 weights + int8 KV vs float) and report "
                         "the per-profile footprint + $/1M-requests delta")
    ap.add_argument("--spec-decode", action="store_true",
                    help="add the speculative-decoding staggered A/B pair "
                         "(draft-and-verify vs plain decode) and report "
                         "the per-profile $/1M-requests delta plus the "
                         "measured accept rate")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per verify round for the "
                         "--spec-decode pair")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=DECODER_ARCHS,
                    help="decoder arch of the decoder scenarios")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gap", type=float, default=0.05)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-inflight", type=int, default=None)
    ap.add_argument("--bucket", type=int, default=32,
                    help="pad bucket (and prompt-length ceiling)")
    ap.add_argument("--segment-width", default="adaptive",
                    choices=("adaptive", "fixed"),
                    help="decoder decode-segment widths: occupancy-"
                         "adaptive tiers (default) or the fixed "
                         "max_batch-wide A/B baseline")
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
    if args.prefix_cache:
        report["prefix_cache"] = prefix_cache_cells(records)
    if args.quant:
        report["quant"] = quant_cells(records)
    if args.spec_decode:
        report["spec_decode"] = spec_decode_cells(records)
    write_report(report, drift_path)
    print(f"[out] {grid_path} ({len(records)} records)")
    print(f"[out] {drift_path}")
    print(format_drift(report))
    for cell in report.get("prefix_cache", []):
        print(f"prefix-cache {cell['profile']}: "
              f"${cell['usd_per_1m_requests_off']:.2f} -> "
              f"${cell['usd_per_1m_requests_pc']:.2f} per 1M requests "
              f"({cell['usd_drop_pct']:+.1f}% cheaper), prefill mean "
              f"{cell['prefill_mean_off_s']*1e3:.1f} -> "
              f"{cell['prefill_mean_pc_s']*1e3:.1f} ms")
    for cell in report.get("quant", []):
        print(f"quant {cell['profile']}: "
              f"${cell['usd_per_1m_requests_off']:.2f} -> "
              f"${cell['usd_per_1m_requests_q8']:.2f} per 1M requests "
              f"({cell['usd_drop_pct']:+.1f}%), footprint "
              f"{cell['footprint_bytes_off']} -> "
              f"{cell['footprint_bytes_q8']} bytes "
              f"({cell['footprint_ratio']:.2f}x smaller)")
    for cell in report.get("spec_decode", []):
        print(f"spec-decode {cell['profile']}: "
              f"${cell['usd_per_1m_requests_off']:.2f} -> "
              f"${cell['usd_per_1m_requests_sd']:.2f} per 1M requests "
              f"({cell['usd_drop_pct']:+.1f}%), "
              f"{cell['tokens_per_s_off']:.1f} -> "
              f"{cell['tokens_per_s_sd']:.1f} tok/s, accept rate "
              f"{cell['accept_rate']:.2f}")


if __name__ == "__main__":
    main()
