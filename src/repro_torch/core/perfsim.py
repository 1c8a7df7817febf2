"""Analytical performance model of the paper's 21 cloud scenarios.

The lab cannot provision AWS/GCP/Azure machines, so the paper's
*measurement* is reproduced as a calibrated model: for every machine we fit

    latency(NS) = t0 + NS**alpha / R          (R = sentences/s throughput)
    vcpu(NS)    = min(100, c0 + NS * beta)
    ram(NS)     = const

against the paper's own published cells (environments.MEASURED), then (a)
validate goodness-of-fit per machine, and (b) regress the fitted throughput
R against hardware features (vCPUs, cache GB, clock, GPU) to test the
paper's headline interpretation — cache size is the dominant non-GPU factor.

A copy of ``repro/core/perfsim.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.environments import (MACHINES, MEASURED, NS_LADDER,
                                           PROVIDERS, instance)


@dataclasses.dataclass
class MachineModel:
    provider: str
    machine: str
    t0: float
    rate: float          # sentences/s
    alpha: float
    cpu0: float
    cpu_slope: float
    ram_mean: float
    ram_std: float
    mape: float          # latency fit error

    def predict_latency(self, ns) -> np.ndarray:
        ns = np.asarray(ns, float)
        return self.t0 + ns ** self.alpha / self.rate

    def predict_vcpu(self, ns) -> np.ndarray:
        ns = np.asarray(ns, float)
        return np.minimum(100.0, self.cpu0 + ns * self.cpu_slope)

    def predict_ram(self, ns) -> np.ndarray:
        return np.full_like(np.asarray(ns, float), self.ram_mean)


def _fit_latency(ns: np.ndarray, lat: np.ndarray):
    """Grid over alpha; (t0, 1/R) by non-negative least squares on each."""
    best = None
    for alpha in np.linspace(0.5, 1.5, 41):
        X = np.stack([np.ones_like(ns), ns ** alpha], axis=1)
        coef, *_ = np.linalg.lstsq(X, lat, rcond=None)
        t0, inv_r = max(coef[0], 0.0), max(coef[1], 1e-6)
        pred = t0 + ns ** alpha * inv_r
        mape = float(np.mean(np.abs(pred - lat) / np.maximum(lat, 0.1)))
        if best is None or mape < best[0]:
            best = (mape, t0, 1.0 / inv_r, alpha)
    return best  # (mape, t0, rate, alpha)


def fit_machine(provider: str, machine: str) -> MachineModel:
    cells = MEASURED[provider][machine]
    ns = np.array(NS_LADDER, float)
    lat = np.array([cells[n][0] for n in NS_LADDER])
    cpu = np.array([cells[n][1] for n in NS_LADDER])
    ram = np.array([cells[n][2] for n in NS_LADDER])
    mape, t0, rate, alpha = _fit_latency(ns, lat)
    # cpu: fit on the unsaturated region only
    unsat = cpu < 95
    X = np.stack([np.ones(unsat.sum()), ns[unsat]], axis=1)
    coef, *_ = np.linalg.lstsq(X, cpu[unsat], rcond=None)
    return MachineModel(provider, machine, t0, rate, alpha,
                        float(max(coef[0], 0.0)), float(max(coef[1], 0.0)),
                        float(ram.mean()), float(ram.std()), mape)


def fit_all() -> Dict[str, Dict[str, MachineModel]]:
    return {p: {m: fit_machine(p, m) for m in MACHINES} for p in PROVIDERS}


def validation_summary(models=None) -> dict:
    models = models or fit_all()
    mapes = {f"{p}/{m}": models[p][m].mape
             for p in PROVIDERS for m in MACHINES}
    return {"per_machine_mape": mapes,
            "mean_mape": float(np.mean(list(mapes.values()))),
            "max_mape": float(np.max(list(mapes.values())))}


def throughput_feature_regression(models=None) -> dict:
    """Standardized OLS of log-throughput on (vcpus, cache, clock, gpu) over
    the 21 machines. The paper's claim predicts cache carries the largest
    standardized non-GPU coefficient."""
    models = models or fit_all()
    rows, y = [], []
    for p in PROVIDERS:
        for m in MACHINES:
            inst = instance(p, m)
            rows.append([inst.vcpus, inst.cache_gb or 0.0, inst.clock_ghz,
                         1.0 if inst.gpu else 0.0])
            y.append(np.log(models[p][m].rate))
    X = np.array(rows)
    y = np.array(y)
    mu, sd = X.mean(0), X.std(0) + 1e-9
    Xs = (X - mu) / sd
    Xs = np.concatenate([np.ones((len(y), 1)), Xs], axis=1)
    coef, res, *_ = np.linalg.lstsq(Xs, y, rcond=None)
    pred = Xs @ coef
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    names = ["intercept", "vcpus", "cache_gb", "clock_ghz", "gpu"]
    return {"coef": dict(zip(names, map(float, coef))),
            "r2": 1 - ss_res / ss_tot}


def cpu_only_feature_regression(models=None) -> dict:
    """Same regression restricted to the 15 CPU machines (A–E)."""
    models = models or fit_all()
    rows, y = [], []
    for p in PROVIDERS:
        for m in "ABCDE":
            inst = instance(p, m)
            rows.append([inst.vcpus, inst.cache_gb, inst.clock_ghz])
            y.append(np.log(models[p][m].rate))
    X = np.array(rows)
    y = np.array(y)
    mu, sd = X.mean(0), X.std(0) + 1e-9
    Xs = np.concatenate([np.ones((len(y), 1)), (X - mu) / sd], axis=1)
    coef, *_ = np.linalg.lstsq(Xs, y, rcond=None)
    pred = Xs @ coef
    r2 = 1 - float(np.sum((y - pred) ** 2)) / float(np.sum((y - y.mean()) ** 2))
    names = ["intercept", "vcpus", "cache_gb", "clock_ghz"]
    return {"coef": dict(zip(names, map(float, coef))), "r2": r2}
