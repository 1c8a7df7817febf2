"""Load-test client — the paper's simulation flow (Fig. 7) against our
engine: submit 2^N concurrent sentences (N = 0..9), repeat R times, record
latency plus host CPU%/RAM% sampled from /proc (the Prometheus role).

The /proc samplers live in ``repro_torch.deploy.telemetry`` (the deployment
lab's generalized ring-buffer sampler); this module imports the aggregate
``CpuSampler`` view back from there.

A copy of ``repro/core/loadtest.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.environments import NS_LADDER
from repro_torch.deploy.telemetry import CpuSampler, read_ram_pct  # noqa: F401


def _ram_pct() -> float:
    pct = read_ram_pct()
    return 0.0 if pct is None else pct


@dataclasses.dataclass
class LoadCell:
    ns: int
    latency_s: float        # mean completion wall time of the batch
    latency_p95_s: float
    vcpu_pct: float
    ram_pct: float
    repeats: int


def run_ladder(engine, sentences: Sequence[np.ndarray], *,
               ladder=NS_LADDER, repeats: int = 3,
               rng_seed: int = 0, warmup: bool = True) -> List[LoadCell]:
    """For each NS on the ladder: fire NS sentences simultaneously at the
    engine, wait for all, measure wall latency; repeat; tabulate — the
    paper's Tables 2-4 procedure (theirs: 10 repeats on real clouds)."""
    rng = np.random.default_rng(rng_seed)
    if warmup:  # exclude jit compilation from the first ladder cell
        engine.submit(sentences[0]).result(timeout=600)
        # drop the compile-laden warmup samples (wall latencies, batch
        # sizes, phase timings) and re-sync the window cursor — one
        # engine-owned definition of "discard", shared with the
        # deploy-lab factory and the benches
        discard = getattr(engine, "discard_samples", None)
        if discard is not None:
            discard()
    cells = []
    for ns in ladder:
        lats = []
        with CpuSampler() as cpu:
            for _ in range(repeats):
                idx = rng.integers(0, len(sentences), ns)
                batch = [sentences[i] for i in idx]
                t0 = time.perf_counter()
                futs = [engine.submit(s) for s in batch]
                for f in futs:
                    f.result(timeout=600)
                lats.append(time.perf_counter() - t0)
        cells.append(LoadCell(ns=ns, latency_s=float(np.mean(lats)),
                              latency_p95_s=float(np.percentile(lats, 95)),
                              vcpu_pct=cpu.mean, ram_pct=_ram_pct(),
                              repeats=repeats))
    return cells


def mixed_bucket_prompts(buckets: Sequence[int], n: int, vocab_size: int, *,
                         rng_seed: int = 0, min_len: int = 3) -> List:
    """Prompt pool spanning every pad bucket: prompt i pads to
    ``buckets[i % len(buckets)]`` (its length drawn from that bucket's
    exclusive band), so consecutive staggered arrivals alternate buckets —
    the mixed-length traffic shape the paper's corpus actually has, and
    the workload where multi-lane scheduling removes the cross-bucket
    head-of-line wait the single-set scheduler pays."""
    buckets = sorted(buckets)
    rng = np.random.default_rng(rng_seed)
    prompts = []
    for i in range(n):
        j = i % len(buckets)
        lo = buckets[j - 1] + 1 if j else min(min_len, buckets[0])
        prompts.append(rng.integers(0, vocab_size,
                                    (int(rng.integers(lo, buckets[j] + 1)),)))
    return prompts


@dataclasses.dataclass
class StaggeredResult:
    """Open-loop (staggered-arrival) load result: the per-request view the
    ladder's batch-synchronous cells can't give — including the mean
    queue/prefill/decode split each ``RequestTiming`` already carries, so a
    latency regression is attributable to a phase without re-running."""
    n_requests: int
    gap_s: float                  # inter-arrival gap (offered load knob)
    latency_p50_s: float
    latency_p95_s: float
    wall_s: float
    total_tokens: int
    queue_mean_s: float = 0.0     # phase split (means over requests)
    prefill_mean_s: float = 0.0
    decode_mean_s: float = 0.0
    queue_p95_s: float = 0.0      # the head-of-line tail specifically
    # per-request GenerationResults, request-arrival order — only kept
    # when run_staggered(keep_results=True): lets per-class analyses
    # (e.g. bench_segment_width's long-request split) reuse this runner
    # instead of re-implementing the open-loop arrival logic
    results: Optional[List] = None

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)


def run_staggered(engine, prompts: Sequence[np.ndarray], *, gap_s: float,
                  sampling=None, timeout: float = 600,
                  keep_results: bool = False) -> StaggeredResult:
    """Fire one generation request every ``gap_s`` seconds (open-loop
    arrivals, vs the ladder's closed-loop bursts) and measure per-request
    completion latency — the workload where step-level continuous batching
    beats batch-at-a-time: a request arriving mid-decode joins the
    in-flight batch instead of waiting behind it, and a short-budget row
    retires the step it finishes instead of riding out the batch. Decoder
    engines only (uses the v2 ``generate`` API). ``sampling`` is one
    ``SamplingParams`` for all requests or a per-prompt sequence."""
    t0 = time.perf_counter()
    handles = []
    per_req = (list(sampling) if isinstance(sampling, (list, tuple))
               else [sampling] * len(prompts))
    for i, p in enumerate(prompts):
        handles.append(engine.generate(p, per_req[i]))
        if i + 1 < len(prompts):
            time.sleep(gap_s)
    lats, total_tokens, timings, results = [], 0, [], []
    for h in handles:
        res = h.result(timeout=timeout)
        # per-request completion relative to ITS arrival, not the burst's
        lats.append(res.timing.total_s)
        timings.append(res.timing)
        total_tokens += len(res.tokens)
        results.append(res)
    wall = time.perf_counter() - t0
    return StaggeredResult(
        n_requests=len(prompts), gap_s=gap_s,
        latency_p50_s=float(np.percentile(lats, 50)),
        latency_p95_s=float(np.percentile(lats, 95)),
        wall_s=wall, total_tokens=total_tokens,
        queue_mean_s=float(np.mean([t.queue_s for t in timings])),
        prefill_mean_s=float(np.mean([t.prefill_s for t in timings])),
        decode_mean_s=float(np.mean([t.decode_s for t in timings])),
        queue_p95_s=float(np.percentile([t.queue_s for t in timings], 95)),
        results=results if keep_results else None)


def format_table(cells: List[LoadCell]) -> str:
    lines = ["NS    latency(s)  p95(s)   vCPU%   RAM%"]
    for c in cells:
        lines.append(f"{c.ns:<5d} {c.latency_s:>9.3f} {c.latency_p95_s:>8.3f}"
                     f" {c.vcpu_pct:>7.1f} {c.ram_pct:>6.1f}")
    return "\n".join(lines)
