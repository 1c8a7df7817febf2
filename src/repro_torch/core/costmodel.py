"""Cost analysis reproducing the paper's Table-5-derived claims, plus
cost-efficiency metrics the paper implies but does not compute
(US$ per million sentences within the 2 s SLO).

Prices come from ``deploy.profiles`` (the single price book); the measured
counterparts of these static numbers are computed by ``deploy.costs`` from
live ``ExperimentRecord`` data and diffed in ``deploy.report``.

A copy of ``repro/core/costmodel.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.environments import (LATENCY_SLO_S, MACHINES,
                                           MEASURED, NS_LADDER, PROVIDERS,
                                           instance)


def gpu_cost_premium() -> Dict[str, float]:
    """Avg GPU (F,G) monthly cost over avg non-GPU (A-E), per provider and
    overall. The paper reports this as '300% more'; the arithmetic from its
    own Table 5 gives ~2.5x — both are recorded (see EXPERIMENTS.md)."""
    out = {}
    ratios = []
    for prov in PROVIDERS:
        cpu = np.mean([instance(prov, m).monthly_cost_usd for m in "ABCDE"])
        gpu = np.mean([instance(prov, m).monthly_cost_usd for m in "FG"])
        out[prov] = gpu / cpu
        ratios.append(gpu / cpu)
    out["overall"] = float(np.mean(ratios))
    return out


def machine_g_vs_f_premium() -> Dict[str, float]:
    """Paper: G costs 43%/35%/43% more than F (AWS/GCP/Azure)."""
    return {prov: instance(prov, "G").monthly_cost_usd
            / instance(prov, "F").monthly_cost_usd - 1.0
            for prov in PROVIDERS}


def machine_c_vs_e_saving() -> Dict[str, float]:
    """Paper: 'cost reduction around 50% for machine C concerning machine E'
    (driven by cache size). True for AWS; per-provider numbers returned."""
    return {prov: 1.0 - instance(prov, "C").monthly_cost_usd
            / instance(prov, "E").monthly_cost_usd
            for prov in PROVIDERS}


def max_ns_within_slo(provider: str, machine: str) -> int:
    """Largest NS whose measured latency meets the 2 s SLO."""
    best = 0
    for ns in NS_LADDER:
        if MEASURED[provider][machine][ns][0] <= LATENCY_SLO_S:
            best = ns
    return best


def cost_per_million_sentences() -> Dict[str, Dict[str, float]]:
    """Beyond-paper metric: US$/1M sentences at each machine's best
    SLO-compliant operating point (NS*/latency(NS*) sentences per second,
    monthly cost spread over a 730 h month)."""
    out: Dict[str, Dict[str, float]] = {}
    for prov in PROVIDERS:
        out[prov] = {}
        for mach in MACHINES:
            ns = max_ns_within_slo(prov, mach)
            if ns == 0:
                out[prov][mach] = float("inf")
                continue
            lat = MEASURED[prov][mach][ns][0]
            sent_per_s = ns / max(lat, 1e-6)
            usd_per_s = instance(prov, mach).hourly_cost_usd / 3600
            out[prov][mach] = usd_per_s / sent_per_s * 1e6
    return out


def cheapest_slo_compliant(target_ns: int = 32) -> Dict[str, str]:
    """Per provider: cheapest machine that meets the SLO at >= target_ns
    concurrent sentences (the paper's POC feasibility question)."""
    out = {}
    for prov in PROVIDERS:
        feasible = [(instance(prov, m).monthly_cost_usd, m)
                    for m in MACHINES
                    if max_ns_within_slo(prov, m) >= target_ns]
        out[prov] = min(feasible)[1] if feasible else None
    return out
