"""Live cost accounting — the paper's Table-5 economics recomputed from
*measured* throughput instead of published latency tables.

``core.costmodel`` prices the paper's own numbers; this module prices
``ExperimentRecord`` data produced by ``deploy.runner``: US$ per million
sentences at each profile's measured best SLO-compliant operating point,
the cheapest machine that still meets the SLO at a target concurrency, and
the GPU-vs-CPU break-even (how much faster the GPU machine must measure
before its price premium inverts per-sentence). ``deploy.report`` diffs
each of these against the paper-side values.

All functions take plain record dicts (the JSONL rows), not runner
objects, so a report can be rebuilt from committed artifacts alone.

A copy of ``repro/deploy/costs.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.deploy.profiles import (LATENCY_SLO_S, EnvironmentProfile,
                                         profile_by_key)


def record_key(rec: dict) -> str:
    """The one definition of a record's 'PROVIDER/MACHINE' key (matches
    ``EnvironmentProfile.key`` and ``profile_by_key``)."""
    return rec["profile"]["provider"] + "/" + rec["profile"]["machine"]


def usd_per_million_sentences(sentences_per_s: float,
                              hourly_usd: float) -> float:
    """$/1M sentences from a measured rate at a profile's hourly price."""
    if sentences_per_s <= 0:
        return float("inf")
    return hourly_usd / 3600.0 / sentences_per_s * 1e6


def best_slo_point(cells: List[dict],
                   slo_s: float = LATENCY_SLO_S) -> Optional[dict]:
    """The highest-throughput ladder cell whose mean latency meets the SLO
    (the paper's 'best operating point'); None when every cell misses."""
    ok = [c for c in cells if c["latency_s"] <= slo_s]
    if not ok:
        return None
    return max(ok, key=lambda c: c["sentences_per_s"])


def measured_cost_table(records: List[dict],
                        slo_s: float = LATENCY_SLO_S) -> Dict[str, dict]:
    """Per profile key: measured $/1M sentences at the best SLO point.

    ``inf`` (None best point) means the profile never met the SLO in the
    grid — the paper's 'unviable deployment' verdict, priced accordingly.
    """
    out: Dict[str, dict] = {}
    for rec in records:
        if rec["scenario"]["kind"] != "closed_ladder":
            continue
        key = record_key(rec)
        best = best_slo_point(rec["cells"], slo_s)
        rate = best["sentences_per_s"] if best else 0.0
        usd = usd_per_million_sentences(
            rate, rec["profile"]["hourly_cost_usd"])
        prev = out.get(key)
        if prev is None or usd < prev["usd_per_1m_sentences"]:
            out[key] = {"usd_per_1m_sentences": usd,
                        "best_ns": best["ns"] if best else None,
                        "sentences_per_s": rate,
                        "hourly_cost_usd":
                            rec["profile"]["hourly_cost_usd"]}
    return out


def measured_max_ns_within_slo(cells: List[dict],
                               slo_s: float = LATENCY_SLO_S) -> int:
    """Largest ladder NS whose measured mean latency meets the SLO."""
    return max((c["ns"] for c in cells if c["latency_s"] <= slo_s),
               default=0)


def cheapest_slo_compliant(records: List[dict], *, target_ns: int = 1,
                           slo_s: float = LATENCY_SLO_S) -> Optional[str]:
    """Cheapest (hourly) profile in the grid that meets the SLO at
    >= target_ns concurrent sentences — the paper's POC feasibility
    question, answered from measurements."""
    feasible = []
    for rec in records:
        if rec["scenario"]["kind"] != "closed_ladder":
            continue
        if measured_max_ns_within_slo(rec["cells"], slo_s) >= target_ns:
            feasible.append((rec["profile"]["hourly_cost_usd"],
                             record_key(rec)))
    return min(feasible)[1] if feasible else None


def gpu_vs_cpu_premium(records: List[dict]) -> dict:
    """GPU-vs-CPU economics over the grid's profiles.

    * ``price_ratio``: mean GPU hourly price over mean CPU hourly price
      (the paper's '300% more expensive' axis — pure price book).
    * ``cost_per_sentence_ratio``: same ratio after dividing by measured
      throughput (the utilization-corrected number the paper couldn't
      compute); None unless the grid measured both kinds.
    * ``breakeven_speedup``: how much faster the GPU profiles must process
      sentences for their per-sentence cost to match the CPU profiles —
      exactly ``price_ratio`` by construction, reported for the drift
      report's narrative.
    """
    table = measured_cost_table(records)
    cpu, gpu = {}, {}
    for key, row in table.items():
        (gpu if profile_by_key(key).is_gpu else cpu)[key] = row

    def _mean(rows, field):
        vals = [r[field] for r in rows.values() if r[field] != float("inf")]
        return sum(vals) / len(vals) if vals else None

    price_cpu = _mean(cpu, "hourly_cost_usd")
    price_gpu = _mean(gpu, "hourly_cost_usd")
    cps_cpu = _mean(cpu, "usd_per_1m_sentences")
    cps_gpu = _mean(gpu, "usd_per_1m_sentences")
    price_ratio = (price_gpu / price_cpu
                   if price_cpu and price_gpu else None)
    return {"price_ratio": price_ratio,
            "cost_per_sentence_ratio": (cps_gpu / cps_cpu
                                        if cps_cpu and cps_gpu else None),
            "breakeven_speedup": price_ratio,
            "n_cpu_profiles": len(cpu), "n_gpu_profiles": len(gpu)}


def profile_price_ratio(profiles: List[EnvironmentProfile]) -> Optional[float]:
    """Mean-GPU / mean-CPU hourly price over a profile set (price book
    only — no measurements needed)."""
    cpu = [p.hourly_cost_usd for p in profiles if not p.is_gpu]
    gpu = [p.hourly_cost_usd for p in profiles if p.is_gpu]
    if not cpu or not gpu:
        return None
    return (sum(gpu) / len(gpu)) / (sum(cpu) / len(cpu))
