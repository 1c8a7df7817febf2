"""Experiment grid runner — the paper's protocol (Fig. 7) as a harness.

The paper's method: for each provider x machine environment, fire 2^N
concurrent sentences (N = 0..9) at the deployed service, repeat, record
real-time latency + hardware usage, then derive cost. This module runs
that grid against the live ``serving.Engine``: for every
(profile, scenario) pair it drives ``core.loadtest`` (closed-loop ladder
or open-loop staggered arrivals), attributes hardware telemetry
(``deploy.telemetry`` window) and engine counters (``engine.window()``)
to exactly that run, and emits one structured ``ExperimentRecord`` per
pair as JSONL — the artifact ``deploy.costs`` / ``deploy.report`` price
and diff against the paper.

Honesty note: the lab cannot provision AWS/GCP/Azure machines, so
every profile *executes on the local host* (in the port: one host with
one card); the profile contributes its spec + hourly price (the record
carries both the measured numbers and the host identity). Cross-profile
latency differences therefore reflect run noise, while cost differences
reflect the price book — exactly the separation the drift report reasons
about: a $/1M sentences figure prices the local host's throughput at the
profile's list price and says nothing of the profile's own machine. On
real fleets, point the same runner at one host per profile.

A copy of ``repro/deploy/runner.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.loadtest import run_ladder, run_staggered
from repro_torch.deploy.profiles import EnvironmentProfile
from repro_torch.deploy.telemetry import HardwareSampler

# v2: engine sub-dict gained weight_quant / kv_quant / weight_bytes (the
# quantized-serving A/B cells are self-describing)
SCHEMA_VERSION = 2

# every JSONL row carries exactly these top-level fields (tested)
RECORD_FIELDS = ("schema_version", "profile", "scenario", "engine",
                 "cells", "telemetry", "engine_window", "wall_s", "host",
                 "created_unix")

KIND_LADDER = "closed_ladder"
KIND_STAGGERED = "open_staggered"


@dataclasses.dataclass(frozen=True)
class WorkloadScenario:
    """One workload shape on the grid's scenario axis.

    ``closed_ladder``: the paper's burst protocol — NS simultaneous
    sentences per cell, ``repeats`` times. ``open_staggered``: one request
    every ``gap_s`` seconds (decoder engines; the regime continuous
    batching exists for).
    """
    name: str
    kind: str = KIND_LADDER
    mode: str = "encoder"              # engine mode this scenario needs
    ladder: Tuple[int, ...] = (1, 4, 16)
    repeats: int = 2
    n_requests: int = 8                # open_staggered only
    gap_s: float = 0.05
    max_new_tokens: int = 8            # decoder scenarios

    def to_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "mode": self.mode,
             "repeats": self.repeats}
        if self.kind == KIND_LADDER:
            d["ladder"] = list(self.ladder)
        else:
            d.update(n_requests=self.n_requests, gap_s=self.gap_s,
                     max_new_tokens=self.max_new_tokens)
        return d


@dataclasses.dataclass
class ExperimentRecord:
    """One (profile x scenario) measurement — one JSONL row."""
    profile: dict              # EnvironmentProfile.spec_dict()
    scenario: dict             # WorkloadScenario.to_dict()
    engine: dict               # mode / max_batch / continuous / buckets /
    #                            segment_width (see docs/DEPLOY_LAB.md)
    cells: List[dict]          # per-NS ladder cells or one staggered cell
    telemetry: dict            # TelemetryTimeline.summary() of the window
    engine_window: dict        # engine.window() for the run
    wall_s: float
    host: dict
    created_unix: float
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)


def host_info() -> dict:
    return {"hostname": platform.node(),   # distinguishes merged grids
            "platform": platform.platform(),
            "cpu_count": os.cpu_count(),
            "note": ("all profiles executed on this host; profile specs "
                     "supply the price book, not the silicon")}


def _ladder_cells(engine, sentences, scenario: WorkloadScenario,
                  rng_seed: int) -> List[dict]:
    cells = run_ladder(engine, sentences, ladder=scenario.ladder,
                       repeats=scenario.repeats, rng_seed=rng_seed,
                       warmup=False)
    return [{"ns": c.ns, "latency_s": c.latency_s,
             "latency_p95_s": c.latency_p95_s, "vcpu_pct": c.vcpu_pct,
             "ram_pct": c.ram_pct, "repeats": c.repeats,
             "sentences_per_s": c.ns / max(c.latency_s, 1e-9)}
            for c in cells]


def _staggered_cells(engine, sentences, scenario: WorkloadScenario,
                     sampling) -> List[dict]:
    prompts = [sentences[i % len(sentences)]
               for i in range(scenario.n_requests)]
    r = run_staggered(engine, prompts, gap_s=scenario.gap_s,
                      sampling=sampling)
    return [{"n_requests": r.n_requests, "gap_s": r.gap_s,
             "latency_p50_s": r.latency_p50_s,
             "latency_p95_s": r.latency_p95_s, "wall_s": r.wall_s,
             "total_tokens": r.total_tokens,
             "tokens_per_s": r.tokens_per_s,
             "requests_per_s": r.n_requests / max(r.wall_s, 1e-9),
             "queue_mean_s": r.queue_mean_s,
             "prefill_mean_s": r.prefill_mean_s,
             "decode_mean_s": r.decode_mean_s,
             "queue_p95_s": r.queue_p95_s}]


class ExperimentRunner:
    """Drives the (profile x scenario) grid against live engines.

    ``engine_factory(scenario)`` returns ``(engine, sentences, sampling)``
    — an engine whose mode matches ``scenario.mode``, the prompt pool, and
    (decoder scenarios) the ``SamplingParams`` for staggered requests. One
    engine is built per *scenario* and shared across the profile axis (the
    jit cache is per engine; profiles differ in price book, not silicon —
    see the module docstring), with ``engine.window()`` attributing
    counters to each profile's run.
    """

    def __init__(self, engine_factory: Callable, *, seed: int = 0,
                 telemetry_period_s: float = 0.05,
                 warmup: bool = True):
        self.engine_factory = engine_factory
        self.seed = seed
        self.telemetry_period_s = telemetry_period_s
        self.warmup = warmup

    def run_grid(self, profiles: Sequence[EnvironmentProfile],
                 scenarios: Sequence[WorkloadScenario],
                 out_path: Optional[str] = None,
                 progress: Optional[Callable[[str], None]] = None
                 ) -> List[ExperimentRecord]:
        records: List[ExperimentRecord] = []
        host = host_info()
        for scenario in scenarios:
            engine, sentences, sampling = self.engine_factory(scenario)
            try:
                if self.warmup:  # pay jit compile outside every window —
                    # every bucket and batch size, not just the first
                    # request's shape (a mixed-bucket scenario would
                    # otherwise compile mid-measurement)
                    engine.warmup()
                with HardwareSampler(self.telemetry_period_s) as hw:
                    for i, prof in enumerate(profiles):
                        if progress:
                            progress(f"{prof.key} x {scenario.name}")
                        engine.window()      # reset engine counters
                        hw.mark()            # reset telemetry window
                        t0 = time.perf_counter()
                        if scenario.kind == KIND_LADDER:
                            cells = _ladder_cells(engine, sentences,
                                                  scenario, self.seed + i)
                        elif scenario.kind == KIND_STAGGERED:
                            cells = _staggered_cells(engine, sentences,
                                                     scenario, sampling)
                        else:
                            raise ValueError(
                                f"unknown scenario kind {scenario.kind!r}")
                        wall = time.perf_counter() - t0
                        hw.sample_now()   # >=1 sample even for sub-period runs
                        tel = hw.window().summary()
                        if hw.evicted_samples:
                            # the ring overwrote samples at some point this
                            # grid: percentiles may cover only a tail
                            tel["evicted_samples_total"] = \
                                hw.evicted_samples
                        records.append(ExperimentRecord(
                            profile=prof.spec_dict(),
                            scenario=scenario.to_dict(),
                            engine=_engine_summary(engine),
                            cells=cells,
                            telemetry=tel,
                            engine_window=engine.window(),
                            wall_s=wall, host=host,
                            created_unix=time.time()))
            finally:
                engine.close()
        if out_path is not None:
            write_jsonl(records, out_path)
        return records


def _engine_summary(engine) -> dict:
    ec = engine.ec
    return {"mode": ec.mode, "max_batch": ec.max_batch,
            "pad_buckets": list(ec.pad_buckets),
            "continuous": bool(engine.continuous_active),
            "max_new_tokens": ec.max_new_tokens,
            "segment_width": ec.segment_width,
            "prefix_cache": bool(ec.prefix_cache),
            # weight/KV dtypes (None = bf16/f32 default path) + resident
            # weight bytes, so quant A/B grid cells are self-describing
            "weight_quant": ec.weight_quant,
            "kv_quant": ec.kv_quant,
            "weight_bytes": int(getattr(engine, "_weight_bytes", 0)),
            # draft-and-verify knobs, so spec A/B grid cells are
            # self-describing too
            "spec_decode": bool(ec.spec_decode),
            "spec_k": ec.spec_k}


def write_jsonl(records: Iterable[ExperimentRecord], path: str) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(rec.to_json() + "\n")


def read_jsonl(path: str) -> List[dict]:
    """Record dicts back from a JSONL artifact (costs/report input)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def records_as_dicts(records: Sequence) -> List[dict]:
    """Uniform dict view whether given ExperimentRecords or JSONL dicts."""
    return [r.to_dict() if isinstance(r, ExperimentRecord) else r
            for r in records]


def smoke_grid_profiles() -> Tuple[EnvironmentProfile, ...]:
    """The CI smoke pair: one CPU profile (the paper's capacity hero,
    AWS/C) and one GPU profile (AWS/G) so the cost report exercises both
    sides of the GPU-premium diff."""
    from repro_torch.deploy.profiles import profile
    return (profile("AWS", "C"), profile("AWS", "G"))
